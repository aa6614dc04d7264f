// framebus implementation — see include/framebus.hpp for the design notes.
//
// Capability parity with the reference camera_message_framework
// (lib/camera_message_framework.cpp): create/open/delete lifecycle guarded by
// a global file lock (cmf.cpp:150,186), seqlock publish/consume
// (cmf.cpp:306-452), deleted-flag propagation (cmf.cpp:230-264), blocking
// reads with ~1 s timeout (cmf.cpp:379-414) — re-architected per-slot with a
// strict seqlock and futex wakeups.

#include "framebus.hpp"
#include "filelock.hpp"

#include <cerrno>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>

#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/time.h>
#include <unistd.h>

namespace framebus {

namespace {

long futex(std::atomic<std::uint32_t>* addr, int op, std::uint32_t val,
           const struct timespec* timeout) {
    return ::syscall(SYS_futex, reinterpret_cast<std::uint32_t*>(addr), op,
                     val, timeout, nullptr, 0);
}

std::size_t align_up(std::size_t v, std::size_t a) {
    return (v + a - 1) / a * a;
}

std::size_t slots_bytes(std::uint32_t slot_count) {
    return align_up(sizeof(SlotHeader) * slot_count, 128);
}

std::size_t total_map_size(std::size_t max_entry, std::uint32_t slot_count) {
    std::size_t header = align_up(sizeof(BusHeader), 64) + slots_bytes(slot_count);
    return align_up(header, 128) + align_up(max_entry, 128) * slot_count;
}

bool valid_type_size(std::size_t ts) {
    return ts == 1 || ts == 2 || ts == 4 || ts == 8;
}

} // namespace

Frame::~Frame() {
    std::free(data);
    data = nullptr;
    capacity = 0;
}

Bus::Bus(const std::string& direction, std::size_t max_entry_size_bytes,
         std::uint32_t slot_count)
    : _direction(direction), _filename(BLOCK_STUB + direction) {
    if (max_entry_size_bytes == 0) {
        throw std::runtime_error("framebus: max_entry_size must be positive");
    }
    if (slot_count < 3 || slot_count > MAX_SLOT_CNT) {
        throw std::runtime_error("framebus: slot_count must be in [3, 64]");
    }

    Filelock lock(GLOBAL_LOCK);

    // Attach if a live block already exists (same dedup-by-name semantics as
    // the reference create path, camera_message_framework_c.cpp:25-41).
    struct stat st{};
    if (::stat(_filename.c_str(), &st) == 0 &&
        st.st_size >= static_cast<off_t>(sizeof(BusHeader))) {
        int fd = ::open(_filename.c_str(), O_RDWR);
        if (fd < 0) {
            throw std::runtime_error("framebus: open failed for " + _filename);
        }
        void* base = ::mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE,
                            MAP_SHARED, fd, 0);
        ::close(fd);
        if (base == MAP_FAILED) {
            throw std::runtime_error("framebus: mmap failed for " + _filename);
        }
        auto* hdr = static_cast<BusHeader*>(base);
        if (hdr->magic == MAGIC && hdr->version == VERSION &&
            !hdr->deleted.load(std::memory_order_acquire)) {
            if (hdr->max_entry_size != max_entry_size_bytes) {
                ::munmap(base, st.st_size);
                throw std::runtime_error(
                    "framebus: block '" + direction +
                    "' exists with a different max_entry_size");
            }
            _header = hdr;
            _map_size = st.st_size;
            _slots = reinterpret_cast<SlotHeader*>(
                reinterpret_cast<unsigned char*>(base) +
                align_up(sizeof(BusHeader), 64));
            _data = reinterpret_cast<unsigned char*>(base) + hdr->data_offset;
            _creator = false; // attached; the original creator owns teardown
            return;
        }
        // Stale or deleted block: recycle the name.
        ::munmap(base, st.st_size);
        ::unlink(_filename.c_str());
    }

    std::size_t map_size = total_map_size(max_entry_size_bytes, slot_count);
    int fd = ::open(_filename.c_str(), O_CREAT | O_RDWR | O_EXCL, 0666);
    if (fd < 0) {
        throw std::runtime_error("framebus: create failed for " + _filename +
                                 ": " + std::string(::strerror(errno)));
    }
    if (::ftruncate(fd, map_size) != 0) {
        ::close(fd);
        ::unlink(_filename.c_str());
        throw std::runtime_error("framebus: ftruncate failed for " + _filename);
    }
    void* base =
        ::mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) {
        ::unlink(_filename.c_str());
        throw std::runtime_error("framebus: mmap failed for " + _filename);
    }

    std::memset(base, 0, align_up(sizeof(BusHeader), 64) + slots_bytes(slot_count));
    auto* hdr = new (base) BusHeader{};
    hdr->version = VERSION;
    hdr->slot_count = slot_count;
    hdr->max_entry_size = max_entry_size_bytes;
    hdr->data_offset =
        align_up(align_up(sizeof(BusHeader), 64) + slots_bytes(slot_count), 128);
    hdr->latest_uid.store(0, std::memory_order_relaxed);
    hdr->futex_word.store(0, std::memory_order_relaxed);
    hdr->deleted.store(0, std::memory_order_relaxed);

    _header = hdr;
    _map_size = map_size;
    _slots = reinterpret_cast<SlotHeader*>(
        reinterpret_cast<unsigned char*>(base) + align_up(sizeof(BusHeader), 64));
    _data = reinterpret_cast<unsigned char*>(base) + hdr->data_offset;
    _creator = true;

    // Publish the magic last so openers never see a half-initialized header.
    std::atomic_thread_fence(std::memory_order_release);
    hdr->magic = MAGIC;
    ::msync(base, sizeof(BusHeader), MS_ASYNC);
}

Bus::Bus(const std::string& direction)
    : _direction(direction), _filename(BLOCK_STUB + direction) {
    Filelock lock(GLOBAL_LOCK);

    struct stat st{};
    if (::stat(_filename.c_str(), &st) != 0 ||
        st.st_size < static_cast<off_t>(sizeof(BusHeader))) {
        throw std::runtime_error("framebus: no such block: " + direction);
    }
    int fd = ::open(_filename.c_str(), O_RDWR);
    if (fd < 0) {
        throw std::runtime_error("framebus: open failed for " + _filename);
    }
    void* base = ::mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED,
                        fd, 0);
    ::close(fd);
    if (base == MAP_FAILED) {
        throw std::runtime_error("framebus: mmap failed for " + _filename);
    }
    auto* hdr = static_cast<BusHeader*>(base);
    if (hdr->magic != MAGIC || hdr->version != VERSION) {
        ::munmap(base, st.st_size);
        throw std::runtime_error("framebus: invalid block file: " + _filename);
    }
    _header = hdr;
    _map_size = st.st_size;
    _slots = reinterpret_cast<SlotHeader*>(
        reinterpret_cast<unsigned char*>(base) + align_up(sizeof(BusHeader), 64));
    _data = reinterpret_cast<unsigned char*>(base) + hdr->data_offset;
    _creator = false;
}

Bus::Bus(Bus&& other) noexcept { *this = std::move(other); }

Bus& Bus::operator=(Bus&& other) noexcept {
    if (this != &other) {
        close();
        _direction = std::move(other._direction);
        _filename = std::move(other._filename);
        _creator = other._creator;
        _header = other._header;
        _slots = other._slots;
        _data = other._data;
        _map_size = other._map_size;
        other._header = nullptr;
        other._slots = nullptr;
        other._data = nullptr;
        other._map_size = 0;
        other._creator = false;
    }
    return *this;
}

Bus::~Bus() { close(); }

void Bus::mark_deleted() noexcept {
    if (_header == nullptr || !_creator) {
        return;
    }
    // Creator teardown: readers observe FRAMEWORK_DELETED and the name is
    // recycled (reference cmf.cpp:230-243).
    if (_header->deleted.exchange(1, std::memory_order_acq_rel) == 0) {
        _header->futex_word.fetch_add(1, std::memory_order_release);
        futex(&_header->futex_word, FUTEX_WAKE, INT32_MAX, nullptr);
        ::unlink(_filename.c_str());
    }
}

void Bus::close() noexcept {
    if (_header == nullptr) {
        return;
    }
    mark_deleted();
    ::munmap(static_cast<void*>(_header), _map_size);
    _header = nullptr;
    _slots = nullptr;
    _data = nullptr;
    _map_size = 0;
}

std::size_t Bus::max_entry_size() const noexcept {
    return _header ? _header->max_entry_size : 0;
}

std::uint32_t Bus::slot_count() const noexcept {
    return _header ? _header->slot_count : 0;
}

std::uint64_t Bus::latest_uid() const noexcept {
    return _header ? _header->latest_uid.load(std::memory_order_acquire) : 0;
}

int Bus::write(std::uint64_t acquisition_time, const PlaneWrite* planes,
               std::size_t plane_count) noexcept {
    if (_header == nullptr || planes == nullptr || plane_count == 0 ||
        plane_count > MAX_PLANE_CNT) {
        return ERROR;
    }
    if (_header->deleted.load(std::memory_order_acquire)) {
        return FRAMEWORK_DELETED;
    }

    // Layout planes contiguously; each plane *starts* 128-byte aligned, but
    // only the true end-of-data must fit (so a single-plane frame needs
    // exactly its nbytes, matching the reference's sizing contract).
    std::uint64_t offsets[MAX_PLANE_CNT];
    std::size_t end = 0;
    for (std::size_t i = 0; i < plane_count; ++i) {
        const PlaneWrite& p = planes[i];
        if (p.data == nullptr || !valid_type_size(p.type_size) || p.width == 0 ||
            p.height == 0 || p.depth == 0) {
            return ERROR;
        }
        offsets[i] = align_up(end, 128);
        end = offsets[i] + p.width * p.height * p.depth * p.type_size;
    }
    if (end > _header->max_entry_size) {
        return ERROR;
    }

    const std::uint64_t uid =
        _header->latest_uid.load(std::memory_order_relaxed) + 1;
    SlotHeader& slot = _slots[uid % _header->slot_count];
    unsigned char* dst =
        _data + static_cast<std::size_t>(uid % _header->slot_count) *
                    align_up(_header->max_entry_size, 128);

    // Seqlock write: odd seq covers BOTH metadata and data mutation.
    // Forcing the begin value odd (rather than assuming seq0 is even) makes
    // the protocol self-healing after a writer crashed mid-write and left
    // the slot odd: the successor re-odds, finishes even, and readers see a
    // consistent published slot again.
    const std::uint64_t seq0 = slot.seq.load(std::memory_order_relaxed);
    const std::uint64_t seq_begin = (seq0 + 1) | 1ull;
    slot.seq.store(seq_begin, std::memory_order_release);
    std::atomic_thread_fence(std::memory_order_release);

    slot.uid = uid;
    slot.acquisition_time = acquisition_time;
    slot.plane_count = static_cast<std::uint32_t>(plane_count);
    slot.total_size = 0;
    for (std::size_t i = 0; i < plane_count; ++i) {
        const PlaneWrite& p = planes[i];
        PlaneMeta& m = slot.planes[i];
        m.width = static_cast<std::uint32_t>(p.width);
        m.height = static_cast<std::uint32_t>(p.height);
        m.depth = static_cast<std::uint32_t>(p.depth);
        m.type_size = static_cast<std::uint32_t>(p.type_size);
        m.offset = offsets[i];
        std::memset(m.name, 0, PLANE_NAME_MAX_LEN);
        if (p.name != nullptr) {
            std::strncpy(m.name, p.name, PLANE_NAME_MAX_LEN - 1);
        }
        const std::size_t bytes = p.width * p.height * p.depth * p.type_size;
        std::memcpy(dst + offsets[i], p.data, bytes);
        slot.total_size = offsets[i] + bytes;
    }

    std::atomic_thread_fence(std::memory_order_release);
    slot.seq.store(seq_begin + 1, std::memory_order_release);

    // Publish, then wake any blocked readers.
    _header->latest_uid.store(uid, std::memory_order_release);
    _header->futex_word.fetch_add(1, std::memory_order_release);
    futex(&_header->futex_word, FUTEX_WAKE, INT32_MAX, nullptr);
    return SUCCESS;
}

int Bus::read(Frame& frame, bool block_thread, int timeout_ms) noexcept {
    return read_impl(frame, nullptr, 0, block_thread, timeout_ms);
}

int Bus::read_into(Frame& frame, void* dst, std::size_t dst_capacity,
                   bool block_thread, int timeout_ms) noexcept {
    if (dst == nullptr) {
        return ERROR;
    }
    return read_impl(frame, dst, dst_capacity, block_thread, timeout_ms);
}

int Bus::read_batch_into(Frame& frame, void* dst, std::size_t stride,
                         std::uint32_t max_frames, std::uint64_t* out_acqs,
                         std::uint32_t* out_count, bool block_thread,
                         int timeout_ms) noexcept {
    if (out_count != nullptr) {
        *out_count = 0;
    }
    if (_header == nullptr || dst == nullptr || max_frames == 0 ||
        out_count == nullptr || stride < _header->max_entry_size) {
        return ERROR;
    }

    // Wait phase: identical semantics to read().
    for (;;) {
        if (_header->deleted.load(std::memory_order_acquire)) {
            return FRAMEWORK_DELETED;
        }
        const std::uint32_t fw =
            _header->futex_word.load(std::memory_order_acquire);
        const std::uint64_t latest =
            _header->latest_uid.load(std::memory_order_acquire);
        if (latest != 0 && latest > frame.uid) {
            break;
        }
        if (!block_thread) {
            return NO_NEW_FRAME;
        }
        struct timespec ts{};
        ts.tv_sec = timeout_ms / 1000;
        ts.tv_nsec = static_cast<long>(timeout_ms % 1000) * 1000000L;
        long rc = futex(&_header->futex_word, FUTEX_WAIT, fw, &ts);
        if (rc != 0 && errno == ETIMEDOUT) {
            return NO_NEW_FRAME;
        }
    }

    const std::uint64_t latest =
        _header->latest_uid.load(std::memory_order_acquire);
    // Only the newest max_frames are wanted; older unseen uids are stale by
    // definition (latest-wins bus).
    std::uint64_t begin = frame.uid + 1;
    if (latest >= max_frames && begin < latest - max_frames + 1) {
        begin = latest - max_frames + 1;
    }

    std::uint32_t count = 0;
    bool have_layout = false;
    std::uint32_t layout_planes = 0;
    PlaneMeta layout[MAX_PLANE_CNT];
    std::uint64_t last_uid = frame.uid;
    std::uint64_t last_acq = 0;
    std::uint64_t last_total = 0;

    for (std::uint64_t u = begin; u <= latest && count < max_frames; ++u) {
        SlotHeader& slot = _slots[u % _header->slot_count];
        const unsigned char* src =
            _data + static_cast<std::size_t>(u % _header->slot_count) *
                        align_up(_header->max_entry_size, 128);

        const std::uint64_t s1 = slot.seq.load(std::memory_order_acquire);
        if (s1 & 1ull) {
            continue; // writer mid-publish on this slot (we got lapped)
        }
        std::atomic_thread_fence(std::memory_order_acquire);
        if (slot.uid != u) {
            continue; // slot recycled for a newer uid; this frame is gone
        }
        const std::uint64_t acq = slot.acquisition_time;
        const std::uint64_t total = slot.total_size;
        const std::uint32_t planes = slot.plane_count;
        PlaneMeta metas[MAX_PLANE_CNT];
        for (std::uint32_t i = 0; i < planes && i < MAX_PLANE_CNT; ++i) {
            metas[i] = slot.planes[i];
        }
        if (planes == 0 || planes > MAX_PLANE_CNT ||
            total > _header->max_entry_size) {
            continue; // torn metadata
        }
        if (have_layout) {
            bool same = planes == layout_planes;
            for (std::uint32_t i = 0; same && i < planes; ++i) {
                same = metas[i].width == layout[i].width &&
                       metas[i].height == layout[i].height &&
                       metas[i].depth == layout[i].depth &&
                       metas[i].type_size == layout[i].type_size &&
                       metas[i].offset == layout[i].offset;
            }
            if (!same) {
                break; // layout changed: end the batch before this frame
            }
        }

        unsigned char* out = static_cast<unsigned char*>(dst) +
                             static_cast<std::size_t>(count) * stride;
        std::memcpy(out, src, total);

        std::atomic_thread_fence(std::memory_order_acquire);
        const std::uint64_t s2 = slot.seq.load(std::memory_order_acquire);
        if (s1 != s2 || slot.uid != u) {
            continue; // torn copy (lapped mid-memcpy): drop this frame
        }

        if (!have_layout) {
            have_layout = true;
            layout_planes = planes;
            for (std::uint32_t i = 0; i < planes; ++i) {
                layout[i] = metas[i];
            }
        }
        if (out_acqs != nullptr) {
            out_acqs[count] = acq;
        }
        ++count;
        last_uid = u;
        last_acq = acq;
        last_total = total;
    }

    if (count == 0) {
        // everything in (frame.uid, latest] was torn/lapped — consume up to
        // latest so the caller retries cleanly on the next publish
        frame.uid = latest > frame.uid ? latest - 1 : frame.uid;
        return NO_NEW_FRAME;
    }
    frame.uid = last_uid;
    frame.acquisition_time = last_acq;
    frame.total_size = last_total;
    frame.plane_count = layout_planes;
    for (std::uint32_t i = 0; i < layout_planes; ++i) {
        frame.planes[i] = layout[i];
    }
    *out_count = count;
    return SUCCESS;
}

int Bus::read_impl(Frame& frame, void* ext_dst, std::size_t ext_capacity,
                   bool block_thread, int timeout_ms) noexcept {
    if (_header == nullptr) {
        return ERROR;
    }

    for (;;) {
        if (_header->deleted.load(std::memory_order_acquire)) {
            return FRAMEWORK_DELETED;
        }
        const std::uint32_t fw =
            _header->futex_word.load(std::memory_order_acquire);
        const std::uint64_t latest =
            _header->latest_uid.load(std::memory_order_acquire);
        if (latest != 0 && latest > frame.uid) {
            break; // fresh frame available
        }
        if (!block_thread) {
            return NO_NEW_FRAME;
        }
        struct timespec ts{};
        ts.tv_sec = timeout_ms / 1000;
        ts.tv_nsec = static_cast<long>(timeout_ms % 1000) * 1000000L;
        long rc = futex(&_header->futex_word, FUTEX_WAIT, fw, &ts);
        if (rc != 0 && errno == ETIMEDOUT) {
            return NO_NEW_FRAME;
        }
        // EAGAIN (futex word moved) / EINTR / wake: re-check the state.
    }

    // Seqlock consume with bounded retries: chase the newest published uid.
    for (int attempt = 0; attempt < 64; ++attempt) {
        const std::uint64_t uid =
            _header->latest_uid.load(std::memory_order_acquire);
        SlotHeader& slot = _slots[uid % _header->slot_count];
        const unsigned char* src =
            _data + static_cast<std::size_t>(uid % _header->slot_count) *
                        align_up(_header->max_entry_size, 128);

        const std::uint64_t s1 = slot.seq.load(std::memory_order_acquire);
        if (s1 & 1ull) {
            continue; // write in progress
        }
        std::atomic_thread_fence(std::memory_order_acquire);

        // Snapshot metadata.
        const std::uint64_t got_uid = slot.uid;
        const std::uint64_t acq = slot.acquisition_time;
        const std::uint64_t total = slot.total_size;
        const std::uint32_t planes = slot.plane_count;
        PlaneMeta metas[MAX_PLANE_CNT];
        for (std::uint32_t i = 0; i < planes && i < MAX_PLANE_CNT; ++i) {
            metas[i] = slot.planes[i];
        }
        if (planes == 0 || planes > MAX_PLANE_CNT ||
            total > _header->max_entry_size) {
            continue; // torn metadata; retry
        }

        unsigned char* dst;
        if (ext_dst != nullptr) {
            if (total > ext_capacity) {
                return ERROR;
            }
            dst = static_cast<unsigned char*>(ext_dst);
        } else {
            if (frame.capacity < total) {
                void* grown = std::realloc(frame.data, total);
                if (grown == nullptr) {
                    return ERROR;
                }
                frame.data = grown;
                frame.capacity = total;
            }
            dst = static_cast<unsigned char*>(frame.data);
        }
        std::memcpy(dst, src, total);

        std::atomic_thread_fence(std::memory_order_acquire);
        const std::uint64_t s2 = slot.seq.load(std::memory_order_acquire);
        if (s1 == s2 && slot.uid == got_uid) {
            frame.uid = got_uid;
            frame.acquisition_time = acq;
            frame.total_size = total;
            frame.plane_count = planes;
            for (std::uint32_t i = 0; i < planes; ++i) {
                frame.planes[i] = metas[i];
            }
            return SUCCESS;
        }
        // Torn read (the writer lapped this slot): retry against the newest.
    }
    // Pathological contention; behave like a miss rather than spinning.
    return NO_NEW_FRAME;
}

} // namespace framebus
