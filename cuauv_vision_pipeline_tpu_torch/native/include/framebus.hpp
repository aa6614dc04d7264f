// framebus — host-side lock-free shared-memory frame bus.
//
// TPU-native re-design of the reference's camera_message_framework
// (reference: lib/camera_message_framework.cpp, include/
// camera_message_framework.hpp). Same capability set — named /dev/shm block,
// single writer / many readers, latest-wins, writer never blocks, optional
// blocking read, multi-plane frames, deleted-flag teardown propagation — but
// a new architecture built for feeding a TPU:
//
//   * a strict per-slot seqlock (odd sequence = write in progress, data and
//     metadata both guarded) instead of the reference's v_a/v_b pair that
//     copies data before validating (SURVEY.md §5 "races");
//   * futex-based blocking reads (no robust-mutex EOWNERDEAD recovery path
//     needed; a dead reader cannot wedge the bus);
//   * configurable slot count (>= 3) so a batching reader can pull the
//     latest K frames for one host-to-device transfer;
//   * read_into() lands frame bytes directly in a caller-provided staging
//     buffer (e.g. a pinned numpy array destined for jax.device_put),
//     removing the reference's defensive second copy (core/base.py:761-768);
//   * 64-byte aligned slot headers and 128-byte aligned plane data for
//     efficient DMA/memcpy.
//
// Compatibility: block files keep the reference prefix /dev/shm/auv_visiond_
// and the SUCCESS / NO_NEW_FRAME / FRAMEWORK_DELETED status codes
// (reference include/camera_message_framework.hpp:17-30).
#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <string>

namespace framebus {

inline constexpr std::uint64_t MAGIC = 0x4652414d45425553ull; // "FRAMEBUS"
inline constexpr std::uint32_t VERSION = 1;

/// Default number of ring slots (reference BUFFER_CNT=3; one extra slot gives
/// the batching reader a deeper stable window).
inline constexpr std::uint32_t DEFAULT_SLOT_CNT = 4;
inline constexpr std::uint32_t MAX_SLOT_CNT = 64;

/// Maximum number of named planes per frame (reference MAX_PLANE_CNT=4;
/// superset to cover stereo+depth+normal+aux layouts).
inline constexpr std::size_t MAX_PLANE_CNT = 8;
inline constexpr std::size_t PLANE_NAME_MAX_LEN = 32;

inline constexpr int SUCCESS = 0;
inline constexpr int NO_NEW_FRAME = 1;
inline constexpr int FRAMEWORK_DELETED = 2;
inline constexpr int ERROR = -1;

inline const std::string BLOCK_STUB{"/dev/shm/auv_visiond_"};
inline const std::string GLOBAL_LOCK{"/dev/shm/auv_visiond.lock"};

struct PlaneMeta {
    std::uint32_t width = 0;
    std::uint32_t height = 0;
    std::uint32_t depth = 0;
    std::uint32_t type_size = 0; // bytes per element: 1, 2, 4 or 8
    std::uint64_t offset = 0;    // byte offset within the slot's data region
    char name[PLANE_NAME_MAX_LEN] = {};
};

/// Shared-memory slot header. `seq` is a classic seqlock: the writer bumps it
/// to odd before touching anything in the slot (metadata AND data), and to
/// even after; readers retry while odd or changed.
struct alignas(64) SlotHeader {
    std::atomic<std::uint64_t> seq;
    std::uint64_t uid;
    std::uint64_t acquisition_time; // epoch/monotonic milliseconds
    std::uint64_t total_size;       // bytes of plane data actually written
    std::uint32_t plane_count;
    std::uint32_t _pad0;
    PlaneMeta planes[MAX_PLANE_CNT];
};

struct alignas(64) BusHeader {
    std::uint64_t magic;
    std::uint32_t version;
    std::uint32_t slot_count;
    std::uint64_t max_entry_size; // bytes reserved for one frame's data
    std::uint64_t data_offset;    // byte offset of slot 0's data from mmap base
    std::atomic<std::uint64_t> latest_uid; // 0 = nothing published yet
    std::atomic<std::uint32_t> futex_word; // bumped+woken on every publish
    std::atomic<std::uint32_t> deleted;    // creator sets on teardown
    // SlotHeader[slot_count] follows at sizeof(BusHeader), then plane data.
};

/// Descriptor for one plane passed to write().
struct PlaneWrite {
    std::size_t width = 0;
    std::size_t height = 0;
    std::size_t depth = 0;
    std::size_t type_size = 0;
    const void* data = nullptr;
    const char* name = nullptr; // optional, NUL-terminated, may be nullptr
};

/// Reader-owned frame: metadata plus an owned, growable copy of the data.
struct Frame {
    std::uint64_t uid = 0; // last consumed uid; 0 = never read
    std::uint64_t acquisition_time = 0;
    std::uint64_t total_size = 0;
    std::uint32_t plane_count = 0;
    PlaneMeta planes[MAX_PLANE_CNT] = {};
    void* data = nullptr;      // owned (malloc/realloc'd by read())
    std::size_t capacity = 0;  // bytes allocated at data

    Frame() = default;
    Frame(const Frame&) = delete;
    Frame& operator=(const Frame&) = delete;
    ~Frame();
};

class Bus {
public:
    Bus() = delete;
    Bus(const Bus&) = delete;
    Bus& operator=(const Bus&) = delete;
    Bus(Bus&& other) noexcept;
    Bus& operator=(Bus&& other) noexcept;
    ~Bus();

    /// Create (or attach to an existing, size-compatible) block.
    /// Throws std::runtime_error on failure.
    Bus(const std::string& direction, std::size_t max_entry_size_bytes,
        std::uint32_t slot_count = DEFAULT_SLOT_CNT);

    /// Open an existing block; throws std::runtime_error if absent/invalid.
    explicit Bus(const std::string& direction);

    /// Publish a frame made of `plane_count` planes. Returns SUCCESS or
    /// FRAMEWORK_DELETED (never blocks; total plane bytes must fit
    /// max_entry_size or ERROR is returned).
    int write(std::uint64_t acquisition_time, const PlaneWrite* planes,
              std::size_t plane_count) noexcept;

    /// Copy the newest frame into `frame` (growing its buffer as needed).
    /// Uses frame.uid to detect staleness: returns NO_NEW_FRAME when nothing
    /// newer than frame.uid has been published. When `block_thread`, waits on
    /// the publish futex up to timeout_ms for a new frame.
    int read(Frame& frame, bool block_thread, int timeout_ms = 1000) noexcept;

    /// Like read(), but lands plane data directly in caller memory of
    /// dst_capacity bytes (metadata still goes to `frame`; frame.data is not
    /// touched). Returns ERROR if the frame doesn't fit.
    int read_into(Frame& frame, void* dst, std::size_t dst_capacity,
                  bool block_thread, int timeout_ms = 1000) noexcept;

    /// Batched drain for a reader running behind the writer: copy up to
    /// `max_frames` unseen frames (uids in (frame.uid, latest]),
    /// OLDEST-FIRST, frame i landing at dst + i*stride (dst holds
    /// max_frames*stride bytes; stride >= the block's max_entry_size).
    /// Per-frame acquisition times land in out_acqs[max_frames]. All frames
    /// of one batch share the plane layout of the batch's first frame — a
    /// mid-stream layout change ends the batch there (the next call resumes
    /// at the change). Frames the writer already overwrote (reader lapped by
    /// more than the ring depth) are skipped. Returns SUCCESS with
    /// *out_count >= 1, or NO_NEW_FRAME / FRAMEWORK_DELETED / ERROR. On
    /// success frame.uid advances to the newest frame read and frame's
    /// plane metadata describes the (shared) batch layout.
    int read_batch_into(Frame& frame, void* dst, std::size_t stride,
                        std::uint32_t max_frames, std::uint64_t* out_acqs,
                        std::uint32_t* out_count, bool block_thread,
                        int timeout_ms = 1000) noexcept;

    /// Creator teardown: set the deleted flag, wake blocked readers, and
    /// unlink the backing file so the name can be recycled. Idempotent;
    /// no-op for non-creators. Also performed by the destructor.
    void mark_deleted() noexcept;

    const std::string& direction() const noexcept { return _direction; }
    const std::string& filename() const noexcept { return _filename; }
    std::size_t max_entry_size() const noexcept;
    std::uint32_t slot_count() const noexcept;
    std::uint64_t latest_uid() const noexcept;
    bool is_creator() const noexcept { return _creator; }
    bool valid() const noexcept { return _header != nullptr; }

private:
    void close() noexcept;
    int read_impl(Frame& frame, void* dst, std::size_t dst_capacity,
                  bool block_thread, int timeout_ms) noexcept;

    std::string _direction;
    std::string _filename;
    bool _creator = false;
    BusHeader* _header = nullptr;
    SlotHeader* _slots = nullptr;
    unsigned char* _data = nullptr; // slot 0 data; slot i at i*max_entry_size
    std::size_t _map_size = 0;
};

} // namespace framebus
