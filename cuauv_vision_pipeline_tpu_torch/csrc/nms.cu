// Greedy fixed-budget NMS, one thread block per image (Hopper, sm_90a).
//
// Replaces the NMS loop of the JAX package's decode
// (cuauv_vision_pipeline_tpu/models/yolo/decode.py:150-206 nms_fixed), which
// XLA runs as one lax.fori_loop of max_det rounds inside the jitted graph:
// each round takes the argmax of the alive scores (the lowest index among
// equals), stops the picks if it is not > 0, and zeroes the pick and every
// alive candidate of its class (any class when class_aware is 0) whose IoU
// with it is >= iou_thresh.
//
// What bounds it on this card: not bytes (the pool is read once, ~14 KB at
// P = 512) nor operations (a few thousand IoUs), but the chain of dependent
// steps. A round-per-pick design pays two block-wide reductions and three
// barriers for each of the max_det picks. This one orders the pool once and
// walks it in chunks:
//
// * Order once. The greedy picks are the candidates met in (score desc,
//   index asc) order that are > 0 and that no earlier pick suppresses,
//   stopping at max_det. Each candidate gets the 48-bit key
//   score_bits << 16 | (0xFFFF - index) (0 for a score <= 0): for positive
//   floats the bit pattern orders as the value, and the index makes every
//   key unique. A pool whose positive scores already form a non-increasing
//   prefix (decode's pool, sorted by _top_pool) is in walk order as it is
//   and is walked in place; any other pool is ordered here, up to kBatch
//   candidates at a time: all of them, or the kBatch largest keys below the
//   last batch's found by a radix select (six 8-bit digits, a shared-memory
//   histogram each), then a bitonic sort of those keys in shared memory
//   (steps with a stride <= 32 stay inside one warp's 64 keys and need no
//   block barrier).
// * NaN. torch.argmax and jnp.argmax take NaN as the largest score, so the
//   plain loop picks the NaN in its first round, finds it not > 0 and picks
//   nothing in any round: a row holding a NaN score has no picks here too.
// * Chunked greedy. The ordered candidates go in chunks of 32. For each
//   chunk, in parallel over the block: (a) each candidate against every pick
//   so far (pick p in warp (p + 16) % 32, a ballot per warp), (b) the
//   chunk's 496 suppression bits i < j, rows w and 31 - w packed into warp
//   w < 16, so while there are at most 16 picks every thread computes at
//   most one IoU (a chunk costs one or two ProbIoU latencies, with all the
//   block's warps issuing them). One block barrier;
//   then every warp resolves the chunk alike from registers: a survivor of
//   (a) is kept unless an earlier kept one's row holds it, visiting only
//   survivors whose row is not empty (__ffs on the masks). The warp that
//   will test a pick writes its terms, so no second barrier is needed (the
//   masks alternate between two buffers by chunk). One block barrier per
//   chunk replaces three per pick. (Tried on the serving pool, and slower
//   there: testing the chunk's own pairs only among the survivors of (a),
//   a barrier apart; and per-warp queues of the same-class pairs: its
//   classes mostly agree, so a queue took two rounds of IoUs.)
// * On chip. Each batch's IoU terms (computed once per candidate, in the
//   plain version's order), classes and indices and the picks' terms stay in
//   shared memory; only more than kSharedPicks picks spill to a global
//   scratch the wrapper allocates. Picks are written out as they are made.
//
// Float semantics: the arithmetic is the plain version's
// (ops/cuda/nms_kernel.py _nms_geometry, _probiou_rows, _aabb_rows), operation
// for operation and in the same order, the pick as the first operand of the
// IoU, with torch's NaN rules for max/min and clamp. Built with --fmad=false
// (ops/cuda/_build.py), so no product is contracted into an FMA; an IoU near
// the threshold then compares exactly as in the plain version on the card.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kEps = static_cast<float>(1e-7);
constexpr float kInv12 = static_cast<float>(1.0 / 12.0);
constexpr float kMinUnion = static_cast<float>(1e-9);
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 1024;        // candidates ordered and walked at a time
constexpr int kSharedPicks = 1024;  // more picks than this keep their terms in global scratch
constexpr int kTerms = 6;
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum / torch.clamp: NaN in, NaN out
__device__ __forceinline__ float t_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// the walk order's key: larger is earlier; 0 for a score that is not > 0
__device__ __forceinline__ uint64_t key_of(const float* scores, int i) {
    const float s = scores[i];
    return s > 0.0f ? (static_cast<uint64_t>(__float_as_uint(s)) << 16) | (0xFFFFu - i) : 0;
}

__device__ __forceinline__ int index_of(uint64_t key) { return 0xFFFF - static_cast<int>(key & 0xFFFFu); }

// Per-candidate IoU terms, as _nms_geometry: ProbIoU the center, the
// covariance a, b, c and sqrt(max(ab - c^2, 0)); AABB the corners and area.
template <bool Rotated>
__device__ __forceinline__ void terms_of(const float* boxes, const float* angles, int j, float* g,
                                         int stride) {
    const float x1 = boxes[4 * j], y1 = boxes[4 * j + 1];
    const float x2 = boxes[4 * j + 2], y2 = boxes[4 * j + 3];
    if (Rotated) {
        const float w = x2 - x1, h = y2 - y1;
        const float w2 = w * w * kInv12, h2 = h * h * kInv12;
        const float t = angles[j];
        const float c = cosf(t), s = sinf(t);
        const float a = w2 * c * c + h2 * s * s;
        const float b = w2 * s * s + h2 * c * c;
        const float cc = (w2 - h2) * c * s;
        g[0] = (x1 + x2) * 0.5f;
        g[stride] = (y1 + y2) * 0.5f;
        g[2 * stride] = a;
        g[3 * stride] = b;
        g[4 * stride] = cc;
        g[5 * stride] = sqrtf(t_max(a * b - cc * cc, 0.0f));
    } else {
        g[0] = x1;
        g[stride] = y1;
        g[2 * stride] = x2;
        g[3 * stride] = y2;
        g[4 * stride] = t_max(x2 - x1, 0.0f) * t_max(y2 - y1, 0.0f);
        g[5 * stride] = 0.0f;
    }
}

__device__ __forceinline__ void load_terms(const float* g, int stride, float* t) {
#pragma unroll
    for (int q = 0; q < kTerms; ++q) t[q] = g[q * stride];
}

// IoU of the pick k (first operand, as the plain version's best) with j
template <bool Rotated>
__device__ __forceinline__ float iou(const float* k, const float* j) {
    if (Rotated) {
        const float sa = k[2] + j[2], sb = k[3] + j[3], sc = k[4] + j[4];
        const float dx = k[0] - j[0], dy = k[1] - j[1];
        const float det = sa * sb - sc * sc;
        const float denom = det + kEps;
        const float t1 = (sa * (dy * dy) + sb * (dx * dx)) / denom * 0.25f;
        const float t2 = sc * (j[0] - k[0]) * dy / denom * 0.5f;
        const float t3 = 0.5f * logf(det / (4.0f * k[5] * j[5] + kEps) + kEps);
        const float bd = t_clamp(t1 + t2 + t3, kEps, 100.0f);
        return 1.0f - sqrtf(1.0f - expf(-bd) + kEps);
    }
    const float x1 = t_max(k[0], j[0]), y1 = t_max(k[1], j[1]);
    const float x2 = t_min(k[2], j[2]), y2 = t_min(k[3], j[3]);
    const float inter = t_max(x2 - x1, 0.0f) * t_max(y2 - y1, 0.0f);
    return inter / t_max(k[4] + j[4] - inter, kMinUnion);
}

// keys[0, n) into descending order (n a power of two, n / 2 <= kThreads).
// Thread t swaps the pair (i, i + j), i = 2t - (t & (j - 1)): for j <= 32
// that pair lies in warp t / 32's own 64 keys, so two such steps in a row
// need only a warp barrier.
__device__ void bitonic_desc(uint64_t* keys, int n) {
    const int t = threadIdx.x;
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            if (t < n / 2) {
                const int i = 2 * t - (t & (j - 1));
                const uint64_t a = keys[i], b = keys[i + j];
                if ((a < b) == ((i & k) == 0)) {
                    keys[i] = b;
                    keys[i + j] = a;
                }
            }
            const int next = j > 1 ? j >> 1 : k;
            if (j <= 32 && next <= 32 && !(j == 1 && k == n)) {
                __syncwarp();
            } else {
                __syncthreads();
            }
        }
    }
}

// The want-th largest key among those below `bound` (a radix select over
// the 48-bit keys, 8 bits at a time from the top). Block-uniform result.
__device__ uint64_t select_key(const float* scores, int P, uint64_t bound, unsigned want,
                               unsigned* hist, uint64_t* s_prefix, unsigned* s_want) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    uint64_t prefix = 0;
    for (int shift = 40; shift >= 0; shift -= 8) {
        if (tid < 256) hist[tid] = 0;
        __syncthreads();
        const uint64_t high = shift == 40 ? 0 : ~0ull << (shift + 8);
        for (int i = tid; i < P; i += kThreads) {
            const uint64_t key = key_of(scores, i);
            if (key != 0 && key < bound && (key & high) == prefix)
                atomicAdd(&hist[(key >> shift) & 0xFF], 1u);
        }
        __syncthreads();
        if (warp == 0) {
            // lane l holds digits 255 - 8l down to 248 - 8l
            unsigned c[8], sum = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                c[q] = hist[255 - 8 * lane - q];
                sum += c[q];
            }
            unsigned incl = sum;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const unsigned o = __shfl_up_sync(kFull, incl, off);
                if (lane >= off) incl += o;
            }
            unsigned acc = incl - sum;
            if (acc < want && want <= incl) {
                for (int q = 0; q < 8; ++q) {
                    if (acc + c[q] >= want) {
                        *s_prefix = prefix | (static_cast<uint64_t>(255 - 8 * lane - q) << shift);
                        *s_want = want - acc;
                        break;
                    }
                    acc += c[q];
                }
            }
        }
        __syncthreads();
        prefix = *s_prefix;
        want = *s_want;
    }
    return prefix;
}

template <bool Rotated>
__global__ void __launch_bounds__(kThreads, 1)
nms_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
           const int* __restrict__ classes, const float* __restrict__ angles,
           int* __restrict__ pick_scratch, int* __restrict__ picked, uint8_t* __restrict__ valid,
           int P, int max_det, float iou_thresh, int class_aware, int batch, int keys_n,
           int pick_cap) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned hist[256];
    __shared__ unsigned warp_sum[kWarps], warp_flags[kWarps];
    __shared__ unsigned chunk_rows[2][32], chunk_prior[2][kWarps];  // by chunk parity
    __shared__ uint64_t s_prefix;
    __shared__ unsigned s_want;
    __shared__ int s_slot;

    const int img = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    boxes += static_cast<size_t>(img) * P * 4;
    scores += static_cast<size_t>(img) * P;
    classes += static_cast<size_t>(img) * P;
    if (Rotated) angles += static_cast<size_t>(img) * P;
    picked += static_cast<size_t>(img) * max_det;
    valid += static_cast<size_t>(img) * max_det;

    // shared: keys [keys_n], the batch's terms [6][batch], classes, indices;
    // then the picks' terms [6][pick_cap] and classes, unless they spill
    uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
    float* bt = reinterpret_cast<float*>(keys + keys_n);
    int* bcls = reinterpret_cast<int*>(bt + kTerms * batch);
    int* bidx = bcls + batch;
    int* pbase = pick_cap > kSharedPicks
                     ? pick_scratch + static_cast<size_t>(img) * (kTerms + 1) * pick_cap
                     : bidx + batch;
    float* pt = reinterpret_cast<float*>(pbase);
    int* pcls = pbase + kTerms * pick_cap;

    // One pass: positives, NaN, whether the positives form a non-increasing
    // prefix; and the terms of the first `batch` candidates in place (the
    // first batch when they do). Loads depend on the index only, so they
    // are all in flight at once.
    unsigned pos = 0, flags = 0;
    const auto scan = [&](float s, float prev) {
        if (s != s) flags |= 1u;
        if (s > 0.0f) {
            ++pos;
            if (!(prev >= s)) flags |= 2u;
        }
    };
    for (int i = tid; i < batch; i += kThreads) {
        const float s = scores[i];
        const float prev = i > 0 ? scores[i - 1] : INFINITY;
        terms_of<Rotated>(boxes, angles, i, bt + i, batch);
        bcls[i] = classes[i];
        bidx[i] = i;
        scan(s, prev);
    }
#pragma unroll 8
    for (int i = batch + tid; i < P; i += kThreads) scan(scores[i], scores[i - 1]);
    pos = __reduce_add_sync(kFull, pos);
    flags = __reduce_or_sync(kFull, flags);
    if (lane == 0) {
        warp_sum[warp] = pos;
        warp_flags[warp] = flags;
    }
    if (tid == 0) s_slot = 0;
    __syncthreads();
    flags = __reduce_or_sync(kFull, warp_flags[lane]);
    const int n_pos = (flags & 1u) ? 0 : static_cast<int>(__reduce_add_sync(kFull, warp_sum[lane]));
    const bool ordered = !(flags & 2u);
    const auto same = [&](int a, int b) { return !class_aware || a == b; };

    int np = 0, taken = 0, chunk = 0;  // the same in every warp
    uint64_t bound = ~0ull;  // unordered: the keys still to walk are below it
    while (np < max_det && taken < n_pos) {
        const int nb = min(batch, n_pos - taken);
        if (ordered) {
            if (taken > 0) {
                for (int r = tid; r < nb; r += kThreads) {
                    terms_of<Rotated>(boxes, angles, taken + r, bt + r, batch);
                    bcls[r] = classes[taken + r];
                    bidx[r] = taken + r;
                }
                __syncthreads();
            }
        } else {
            const uint64_t lo = n_pos - taken > batch
                                    ? select_key(scores, P, bound, batch, hist, &s_prefix, &s_want)
                                    : 1;
            int n2 = 1;
            while (n2 < nb) n2 <<= 1;
            for (int i = tid; i < P; i += kThreads) {
                const uint64_t key = key_of(scores, i);
                if (key >= lo && key < bound) keys[atomicAdd(&s_slot, 1) - taken] = key;
            }
            for (int r = nb + tid; r < n2; r += kThreads) keys[r] = 0;
            __syncthreads();
            bitonic_desc(keys, n2);
            bound = keys[nb - 1];
            for (int r = tid; r < nb; r += kThreads) {
                const int j = index_of(keys[r]);
                terms_of<Rotated>(boxes, angles, j, bt + r, batch);
                bcls[r] = classes[j];
                bidx[r] = j;
            }
            __syncthreads();
        }

        for (int c0 = 0; c0 < nb && np < max_det; c0 += 32, ++chunk) {
            const int n_in = min(32, nb - c0);
            unsigned* rows = chunk_rows[chunk & 1];
            unsigned* prior = chunk_prior[chunk & 1];
            const bool in = lane < n_in;
            float tj[kTerms];
            int cj = 0, jidx = 0;
            if (in) {
                load_terms(bt + c0 + lane, batch, tj);
                cj = bcls[c0 + lane];
                jidx = bidx[c0 + lane];
            }
            // (b) the chunk's 496 pairs i < j, in warps 0-15: warp w's lanes
            // l > w take row w (j = l), its lanes l < w row 31 - w (j = 31 - l)
            if (warp < 16) {
                const int i = lane > warp ? warp : 31 - warp;
                const int j = lane > warp ? lane : 31 - lane;
                bool hit = false;
                if (lane != warp && j < n_in && same(bcls[c0 + i], bcls[c0 + j])) {
                    float ti[kTerms], tk[kTerms];
                    load_terms(bt + c0 + i, batch, ti);
                    load_terms(bt + c0 + j, batch, tk);
                    hit = iou<Rotated>(ti, tk) >= iou_thresh;
                }
                const unsigned bits = __ballot_sync(kFull, hit);
                if (lane == 0) {
                    rows[warp] = bits & (kFull << (warp + 1));  // lanes > warp
                    rows[31 - warp] = __brev(bits & ((1u << warp) - 1));
                }
            }
            // (a) the picks so far, pick p in warp (p + 16) % 32, which wrote
            // its terms: warps 16-31 first
            bool sup = false;
            for (int p = (warp + 16) & 31; p < np; p += kWarps) {
                if (in && !sup && same(pcls[p], cj)) {
                    float tp[kTerms];
                    load_terms(pt + p, pick_cap, tp);
                    sup = iou<Rotated>(tp, tj) >= iou_thresh;
                }
            }
            const unsigned m = __ballot_sync(kFull, sup);
            if (lane == 0) prior[warp] = m;
            __syncthreads();
            // every warp resolves the chunk alike (so no second barrier), in
            // order: a survivor whose row is empty suppresses nothing, so
            // only the others are visited
            const unsigned removed = __reduce_or_sync(kFull, prior[lane]);
            const unsigned row = rows[lane];
            const unsigned reach = __ballot_sync(kFull, row != 0);
            unsigned keep = (n_in == 32 ? kFull : (1u << n_in) - 1) & ~removed;
            unsigned todo = keep & reach;
            while (todo != 0) {
                const int i = __ffs(todo) - 1;
                keep &= ~__shfl_sync(kFull, row, i);
                todo = keep & reach & ~((2u << i) - 1);
            }
            const int room = max_det - np;
            if (__popc(keep) > room) keep &= (2u << __fns(keep, 0, room)) - 1;
            if ((keep >> lane) & 1u) {
                const int slot = np + __popc(keep & ((1u << lane) - 1));
                if (((slot + 16) & 31) == warp) {  // the warp that tests against it
#pragma unroll
                    for (int q = 0; q < kTerms; ++q) pt[q * pick_cap + slot] = tj[q];
                    pcls[slot] = cj;
                    picked[slot] = jidx;
                    valid[slot] = 1;
                }
            }
            __syncwarp();
            np += __popc(keep);
        }
        taken += nb;
    }
    for (int r = np + tid; r < max_det; r += kThreads) {
        picked[r] = -1;
        valid[r] = 0;
    }
}

template <bool Rotated>
cudaError_t launch(const float* bx, const float* sc, const int* cl, const float* an, int* scratch,
                   int* pk, uint8_t* vd, int B, int P, int max_det, float iou_thresh,
                   int class_aware, int batch, int keys_n, int pick_cap, size_t smem,
                   cudaStream_t s) {
    static bool opted_in = false;  // once per process: the largest layout's bytes
    if (!opted_in) {
        const size_t most = kBatch * sizeof(uint64_t) + kBatch * (kTerms + 2) * sizeof(float) +
                            kSharedPicks * (kTerms + 1) * sizeof(float);
        const cudaError_t err = cudaFuncSetAttribute(
            nms_kernel<Rotated>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
        if (err != cudaSuccess) {
            cudaGetLastError();  // so the next launch's check does not report it again
            return err;
        }
        opted_in = true;
    }
    nms_kernel<Rotated><<<B, kThreads, smem, s>>>(bx, sc, cl, an, scratch, pk, vd, P, max_det,
                                                  iou_thresh, class_aware, batch, keys_n, pick_cap);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The picks whose IoU terms stay in shared memory; the wrapper allocates
// a [B, 7, min(max_det, P)] int32 scratch when min(max_det, P) exceeds it.
int nms_shared_picks() { return kSharedPicks; }

// boxes [B, P, 4] xyxy, scores [B, P], classes i32 [B, P], angles [B, P] or
// null (AABB IoU), pick scratch (see nms_shared_picks) or null; writes
// picked i32 [B, max_det] and valid u8 [B, max_det]. P <= 65536 (the keys'
// 16-bit index). Returns 0 or the CUDA error of the launch.
int nms_fixed(const void* boxes, const void* scores, const void* classes, const void* angles,
              void* pick_scratch, void* picked, void* valid, int B, int P, int max_det,
              float iou_thresh, int class_aware, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (B < 1 || P < 1 || P > 65536 || max_det < 1) return cudaErrorInvalidValue;
    const int batch = P < kBatch ? P : kBatch;
    int keys_n = 1;
    while (keys_n < batch) keys_n <<= 1;
    const int pick_cap = max_det < P ? max_det : P;
    if (pick_cap > kSharedPicks && pick_scratch == nullptr) return cudaErrorInvalidValue;
    size_t smem = keys_n * sizeof(uint64_t) + static_cast<size_t>(batch) * (kTerms + 2) * sizeof(float);
    if (pick_cap <= kSharedPicks) smem += static_cast<size_t>(pick_cap) * (kTerms + 1) * sizeof(float);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* bx = static_cast<const float*>(boxes);
    const auto* sc = static_cast<const float*>(scores);
    const auto* cl = static_cast<const int*>(classes);
    auto* scratch = static_cast<int*>(pick_scratch);
    auto* pk = static_cast<int*>(picked);
    auto* vd = static_cast<uint8_t*>(valid);
    if (angles != nullptr) {
        return launch<true>(bx, sc, cl, static_cast<const float*>(angles), scratch, pk, vd, B, P,
                            max_det, iou_thresh, class_aware, batch, keys_n, pick_cap, smem, s);
    }
    return launch<false>(bx, sc, cl, nullptr, scratch, pk, vd, B, P, max_det, iou_thresh,
                         class_aware, batch, keys_n, pick_cap, smem, s);
}

const char* nms_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
