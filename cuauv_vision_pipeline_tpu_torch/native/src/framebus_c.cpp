// C ABI for the framebus, consumed by the Python ctypes binding.
//
// Mirrors the reference's flat C API surface
// (lib/camera_message_framework_c.cpp:18-103): create/open/delete block,
// write single- and multi-plane frames, read into a reader-owned Frame,
// exported status constants and BLOCK_STUB — plus TPU-era additions:
// read_frame_into (zero-extra-copy into caller staging memory, e.g. a numpy
// array headed for jax.device_put), block introspection, and a configurable
// slot count. A process-global refcounted registry keeps Python from leaking
// or double-freeing blocks (reference keeps a name->Block "heap",
// camera_message_framework_c.cpp:11-16).

#include "framebus.hpp"

#include <cstring>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>

using framebus::Bus;
using framebus::Frame;
using framebus::PlaneWrite;

namespace {

struct Entry {
    std::unique_ptr<Bus> bus;
    int create_refs = 0;
    int open_refs = 0;
};

// Opaque per-accessor handle. Creator handles and reader handles share one
// underlying Bus per name, but are refcounted separately so that the last
// *creator* close performs teardown (deleted flag + unlink) even while
// in-process readers remain attached — matching the cross-process semantics.
struct BusHandle {
    Entry* entry = nullptr;
    std::string name;
    bool creator_ref = false;
};

std::mutex g_mutex;
std::unordered_map<std::string, Entry> g_registry;

BusHandle* acquire(const std::string& name, std::size_t max_entry, bool create,
                   std::uint32_t slot_count) {
    std::lock_guard<std::mutex> guard(g_mutex);
    auto it = g_registry.find(name);
    if (it == g_registry.end()) {
        try {
            Entry entry;
            entry.bus = create
                            ? std::make_unique<Bus>(name, max_entry, slot_count)
                            : std::make_unique<Bus>(name);
            it = g_registry.emplace(name, std::move(entry)).first;
        } catch (const std::exception&) {
            return nullptr;
        }
    } else if (create && it->second.bus->max_entry_size() != max_entry) {
        return nullptr; // size mismatch with the existing block
    }
    auto* handle = new (std::nothrow) BusHandle{};
    if (handle == nullptr) {
        return nullptr;
    }
    handle->entry = &it->second;
    handle->name = name;
    handle->creator_ref = create;
    (create ? it->second.create_refs : it->second.open_refs) += 1;
    return handle;
}

Bus* bus_of(BusHandle* handle) {
    return (handle && handle->entry) ? handle->entry->bus.get() : nullptr;
}

} // namespace

extern "C" {

const char* BLOCK_STUB_CSTR = "/dev/shm/auv_visiond_";
int SUCCESS = framebus::SUCCESS;
int NO_NEW_FRAME = framebus::NO_NEW_FRAME;
int FRAMEWORK_DELETED = framebus::FRAMEWORK_DELETED;
int FRAMEBUS_ERROR = framebus::ERROR;

// Plane descriptor matching the ctypes structs (see core/bindings/frame_bus.py).
typedef struct CFramePlaneWrite {
    size_t width;
    size_t height;
    size_t depth;
    size_t type_size;
    const unsigned char* data;
    const char* name;
} CFramePlaneWrite;

typedef struct CFramePlane {
    size_t width;
    size_t height;
    size_t depth;
    size_t type_size;
    size_t offset;
    char name[32];
} CFramePlane;

typedef struct CFrame {
    size_t width;  // primary (plane 0) dims kept for reference API parity
    size_t height;
    size_t depth;
    size_t type_size;
    uint64_t acquisition_time;
    uint64_t uid;
    void* data;
    size_t total_size;
    size_t plane_count;
    CFramePlane planes[8];
    Frame* impl; // owned native frame
} CFrame;

static void sync_cframe(CFrame* cf) {
    Frame* f = cf->impl;
    cf->acquisition_time = f->acquisition_time;
    cf->uid = f->uid;
    cf->data = f->data;
    cf->total_size = f->total_size;
    cf->plane_count = f->plane_count;
    for (std::uint32_t i = 0; i < f->plane_count && i < framebus::MAX_PLANE_CNT;
         ++i) {
        cf->planes[i].width = f->planes[i].width;
        cf->planes[i].height = f->planes[i].height;
        cf->planes[i].depth = f->planes[i].depth;
        cf->planes[i].type_size = f->planes[i].type_size;
        cf->planes[i].offset = f->planes[i].offset;
        std::memcpy(cf->planes[i].name, f->planes[i].name, 32);
    }
    if (f->plane_count > 0) {
        cf->width = f->planes[0].width;
        cf->height = f->planes[0].height;
        cf->depth = f->planes[0].depth;
        cf->type_size = f->planes[0].type_size;
    }
}

BusHandle* create_block(const char* direction, size_t max_entry_size_bytes) {
    return acquire(direction, max_entry_size_bytes, /*create=*/true,
                   framebus::DEFAULT_SLOT_CNT);
}

BusHandle* create_block_slots(const char* direction, size_t max_entry_size_bytes,
                              uint32_t slot_count) {
    return acquire(direction, max_entry_size_bytes, /*create=*/true, slot_count);
}

BusHandle* open_block(const char* direction) {
    return acquire(direction, 0, /*create=*/false, 0);
}

void delete_block(BusHandle* handle) {
    if (handle == nullptr) {
        return;
    }
    std::lock_guard<std::mutex> guard(g_mutex);
    auto it = g_registry.find(handle->name);
    if (it != g_registry.end() && &it->second == handle->entry) {
        Entry& entry = it->second;
        (handle->creator_ref ? entry.create_refs : entry.open_refs) -= 1;
        if (handle->creator_ref && entry.create_refs == 0 &&
            entry.bus->is_creator()) {
            // Last in-process creator ref: tear down now so attached readers
            // (in this process or others) observe FRAMEWORK_DELETED.
            entry.bus->mark_deleted();
        }
        if (entry.create_refs <= 0 && entry.open_refs <= 0) {
            g_registry.erase(it);
        }
    }
    delete handle;
}

int write_frame(BusHandle* handle, uint64_t acquisition_time, size_t width,
                size_t height, size_t depth, size_t type_size,
                const unsigned char* data) {
    Bus* block = bus_of(handle);
    if (block == nullptr) {
        return framebus::ERROR;
    }
    PlaneWrite plane{width, height, depth, type_size, data, nullptr};
    return block->write(acquisition_time, &plane, 1);
}

int write_frame_planes(BusHandle* handle, uint64_t acquisition_time,
                       const CFramePlaneWrite* planes, size_t plane_count) {
    Bus* block = bus_of(handle);
    if (block == nullptr || planes == nullptr) {
        return framebus::ERROR;
    }
    PlaneWrite native[framebus::MAX_PLANE_CNT];
    if (plane_count == 0 || plane_count > framebus::MAX_PLANE_CNT) {
        return framebus::ERROR;
    }
    for (size_t i = 0; i < plane_count; ++i) {
        native[i].width = planes[i].width;
        native[i].height = planes[i].height;
        native[i].depth = planes[i].depth;
        native[i].type_size = planes[i].type_size;
        native[i].data = planes[i].data;
        native[i].name = planes[i].name;
    }
    return block->write(acquisition_time, native, plane_count);
}

int read_frame(BusHandle* handle, CFrame* frame, bool block_thread) {
    Bus* block = bus_of(handle);
    if (block == nullptr || frame == nullptr || frame->impl == nullptr) {
        return framebus::ERROR;
    }
    int rc = block->read(*frame->impl, block_thread);
    if (rc == framebus::SUCCESS) {
        sync_cframe(frame);
    }
    return rc;
}

// Copy the newest frame's plane bytes straight into dst (metadata goes to
// `frame`, whose own buffer is untouched). `frame->data` is set to NULL to
// signal the payload lives in caller memory.
int read_frame_into(BusHandle* handle, CFrame* frame, unsigned char* dst,
                    size_t dst_capacity, bool block_thread) {
    Bus* block = bus_of(handle);
    if (block == nullptr || frame == nullptr || frame->impl == nullptr) {
        return framebus::ERROR;
    }
    int rc = block->read_into(*frame->impl, dst, dst_capacity, block_thread);
    if (rc == framebus::SUCCESS) {
        sync_cframe(frame);
        frame->data = nullptr;
    }
    return rc;
}

// Batched drain: copy up to max_frames unseen frames oldest-first, frame i
// at dst + i*stride; per-frame acquisition times land in out_acqs
// (uint64[max_frames]); *out_count receives the number read. Metadata in
// `frame` describes the shared batch layout; frame->data is NULL (payload
// in caller memory). Returns SUCCESS / NO_NEW_FRAME / FRAMEWORK_DELETED /
// ERROR like read_frame.
int read_frame_batch_into(BusHandle* handle, CFrame* frame,
                          unsigned char* dst, size_t stride,
                          uint32_t max_frames, uint64_t* out_acqs,
                          uint32_t* out_count, bool block_thread) {
    Bus* block = bus_of(handle);
    if (block == nullptr || frame == nullptr || frame->impl == nullptr) {
        return framebus::ERROR;
    }
    int rc = block->read_batch_into(*frame->impl, dst, stride, max_frames,
                                    out_acqs, out_count, block_thread);
    if (rc == framebus::SUCCESS) {
        sync_cframe(frame);
        frame->data = nullptr;
    }
    return rc;
}

CFrame* create_frame() {
    auto* cf = new (std::nothrow) CFrame{};
    if (cf == nullptr) {
        return nullptr;
    }
    cf->impl = new (std::nothrow) Frame{};
    if (cf->impl == nullptr) {
        delete cf;
        return nullptr;
    }
    return cf;
}

void delete_frame(CFrame* frame) {
    if (frame == nullptr) {
        return;
    }
    delete frame->impl;
    delete frame;
}

uint64_t frame_size(CFrame* frame) {
    return frame == nullptr ? 0 : frame->total_size;
}

// --- introspection (new in the rebuild) ---

size_t block_max_entry_size(BusHandle* handle) {
    Bus* block = bus_of(handle);
    return block ? block->max_entry_size() : 0;
}

uint32_t block_slot_count(BusHandle* handle) {
    Bus* block = bus_of(handle);
    return block ? block->slot_count() : 0;
}

uint64_t block_latest_uid(BusHandle* handle) {
    Bus* block = bus_of(handle);
    return block ? block->latest_uid() : 0;
}

} // extern "C"
