// Greedy min-distance keypoint selection, one thread block (Hopper, sm_90a).
//
// Replaces the spacing fixpoint of the JAX package's detect_describe
// (cuauv_vision_pipeline_tpu/ops/feature.py:618-656), which XLA runs as a
// lax.while_loop inside the jitted graph. In eager torch each round of that
// loop would end in a host read of torch.any(...): a device-to-host sync in
// the middle of the bins chain, repeated a data-dependent number of times.
// Here the whole selection is one launch.
//
// Input: K candidates, strongest first (ys, xs int32, cand bool). Output:
// kept[i] iff cand[i] and no kept j < i lies closer than min_distance
// (dy^2 + dx^2 < min_d2) -- exactly the sequential greedy set. Integer
// arithmetic throughout (64-bit squares), so the result is exact.
//
// One block of min(K, 1024) threads (rounded up to a warp), a thread per
// candidate. In shared memory: the coordinates, and the conflict matrix as
// bit rows -- bit j of row i set iff j < i, cand[j] and the two are too close
// -- stored word-major (conf[w * K + i]) so a warp reads consecutive words.
// Then the fixpoint of the JAX loop, on bitsets: each round keeps every
// undecided candidate none of whose stronger conflicts is still alive
// (kept or undecided), then kills every undecided candidate with a kept
// stronger conflict; __syncthreads_or ends the loop when none is left
// undecided. Each round decides at least the strongest undecided candidate,
// and in practice a round decides most of them (rounds = depth of the
// conflict chains, a handful).
//
// Bound on this card: the K^2/2 distance tests (131k integer ops at K = 512)
// and the bytes (9 B per candidate read, 1 B written) take well under a
// microsecond; the kernel's time is the launch, the shared-memory fill and a
// few block barriers per round.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 1024;
constexpr int kMaxThreads = 1024;

__global__ void __launch_bounds__(kMaxThreads)
spacing_kernel(const int* __restrict__ ys, const int* __restrict__ xs,
               const uint8_t* __restrict__ cand, uint8_t* __restrict__ kept_out, int K,
               long long min_d2) {
    extern __shared__ uint32_t smem[];
    const int words = (K + 31) >> 5;
    uint32_t* conf = smem;                             // [words][K]
    uint32_t* kept = conf + static_cast<size_t>(words) * K;  // [words]
    uint32_t* dead = kept + words;                     // [words]: not a candidate, or killed
    int* sy = reinterpret_cast<int*>(dead + words);    // [K]
    int* sx = sy + K;                                  // [K]
    const int tid = threadIdx.x, nt = blockDim.x;

    for (int i = tid; i < K; i += nt) {
        sy[i] = ys[i];
        sx[i] = xs[i];
    }
    for (int w = tid; w < words; w += nt) {
        uint32_t not_cand = 0;
        for (int b = 0; b < 32; ++b) {
            const int j = (w << 5) + b;
            if (j >= K || !cand[j]) not_cand |= 1u << b;
        }
        kept[w] = 0;
        dead[w] = not_cand;
    }
    __syncthreads();

    // conflict rows: only the words up to row i's own (no j >= i conflicts)
    for (int i = tid; i < K; i += nt) {
        const long long yi = sy[i], xi = sx[i];
        const int wi = i >> 5;
        for (int w = 0; w <= wi; ++w) {
            const int j0 = w << 5;
            const int j1 = min(j0 + 32, i);
            uint32_t bits = 0;
            for (int j = j0; j < j1; ++j) {
                const long long dy = yi - sy[j], dx = xi - sx[j];
                if (dy * dy + dx * dx < min_d2) bits |= 1u << (j - j0);
            }
            conf[static_cast<size_t>(w) * K + i] = bits & ~dead[w];
        }
    }
    __syncthreads();

    bool more = true;
    while (more) {
        // keep: an undecided candidate with no alive stronger conflict
        for (int i = tid; i < K; i += nt) {
            const int wi = i >> 5;
            const uint32_t bit = 1u << (i & 31);
            if ((kept[wi] | dead[wi]) & bit) continue;
            uint32_t alive = 0;
            for (int w = 0; w <= wi; ++w) alive |= conf[static_cast<size_t>(w) * K + i] & ~dead[w];
            if (!alive) atomicOr(&kept[wi], bit);
        }
        __syncthreads();
        // kill: an undecided candidate with a kept stronger conflict
        int undecided = 0;
        for (int i = tid; i < K; i += nt) {
            const int wi = i >> 5;
            const uint32_t bit = 1u << (i & 31);
            if ((kept[wi] | dead[wi]) & bit) continue;
            uint32_t hit = 0;
            for (int w = 0; w <= wi; ++w) hit |= conf[static_cast<size_t>(w) * K + i] & kept[w];
            if (hit) {
                atomicOr(&dead[wi], bit);
            } else {
                undecided = 1;
            }
        }
        more = __syncthreads_or(undecided) != 0;
    }
    for (int i = tid; i < K; i += nt) kept_out[i] = (kept[i >> 5] >> (i & 31)) & 1u;
}

}  // namespace

extern "C" {

// ys, xs int32 [K], cand u8 [K] (0/1); writes kept u8 [K] (0/1).
// 1 <= K <= 1024. Returns 0 or the CUDA error of the launch.
int spacing_select(const void* ys, const void* xs, const void* cand, void* kept, int K,
                   long long min_d2, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    if (K < 1 || K > kMaxK) return cudaErrorInvalidValue;
    const int words = (K + 31) / 32;
    const size_t smem = (static_cast<size_t>(words) * K + 2 * words) * sizeof(uint32_t) +
                        2 * static_cast<size_t>(K) * sizeof(int);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(spacing_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    int threads = (K + 31) / 32 * 32;
    threads = threads > kMaxThreads ? kMaxThreads : threads;
    spacing_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ys), static_cast<const int*>(xs),
        static_cast<const uint8_t*>(cand), static_cast<uint8_t*>(kept), K, min_d2);
    return cudaGetLastError();
}

const char* spacing_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
