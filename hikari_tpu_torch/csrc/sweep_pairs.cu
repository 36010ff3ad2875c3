// Pair-grid treelet sweeps of the packet traversal, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the pair-grid sweep mode:
//   hikari_closest_pairs   <- _closest_pairs_kernel   (hikari_tpu/geometry/wavefront.py:773)
//   hikari_occlusion_pairs <- _occlusion_pairs_kernel (hikari_tpu/geometry/wavefront.py:827)
// both launched there by _sweep_chunks (wavefront.py:907) under HIKARI_SWEEP=pairs.
// The contract and the plain PyTorch versions these kernels are checked
// against are in hikari_tpu_torch/geometry/sweep_pairs.py.
//
// Design. One thread block of 1024 threads per (tile, treelet) pair, one
// thread per ray of the pair's tile: the pair grid's decomposition, which
// spreads a tile with a long segment over many SMs instead of walking it
// in one block as sweep_tiles.cu does. The whole pair list is one launch
// (the TPU's PAIR_CHUNK chunking, padding repeats and dynamic grid were
// scalar-memory limits and have no counterpart here). Blocks run in no
// order, so the TPU's sequential carry becomes shared state in device
// memory:
//
// * closest: a 64-bit word per lane, (key << 32) | rank, where rank is 0
//   for the carried-in key and p + 1 for pair p; each block merges its
//   per-lane minimum with atomicMin. Keys are positive int32 (t > 1e-4 for
//   a hit, a reach >= 0 for the carry), so the word orders by key and then
//   by rank: the earliest pair wins a tie, and a pair beats the carry only
//   when strictly smaller, which is the TPU's sequential rule. A last
//   kernel splits the words into (key, tr = tre[rank - 1] or tr_in).
// * occlusion: the int32 carry is updated in place; a block stores 1 on
//   the lanes it occludes (concurrent stores of 1 are benign).
//
// Each block reads its tile's current carry once at its start and skips
// the pair when tnear_bits >= max(key | 255) (closest) or >= the largest
// unoccluded reach (occlusion). Read concurrently, that threshold may lag
// or lead the sequential walk's, and it is still safe: it is formed from
// hits that exist, and a hit in a skipped pair has bits(t) >= tnear_bits >=
// the lane's key | 255 (or its reach). So occlusion equals the sequential
// walk exactly; the closest key and treelet differ only where two hits
// share a quantized t and the column (or the pair order) decides, which
// the kernel-vs-plain comparison bounds at >= 99.9% agreement of live
// lanes, the floor the tile sweep K1 is held to. To let the early-out
// bite, blocks are issued rank-major (every tile's nearest pair first,
// then every tile's second, ...; the wrapper computes that order), so a
// tile's far pairs start after its near pairs have merged.
//
// The hit test is _bw_block's (wavefront.py:713), not the tile sweeps':
// den clamped to 1e-20 where |den| < 1e-20, and |den| > 1e-20, u, v >=
// -eps, u + v <= 1 + eps, t > 1e-4 for a hit. The TPU's approximate
// reciprocal plus one Newton step (RECIP="newton") is an IEEE divide here.
//
// Bound. Per (ray, triangle) test ~20 FMAs, a few adds and compares and one
// IEEE divide against broadcast shared-memory reads, so the kernels are
// bound by the FP32 issue rate and the divide, like sweep_tiles.cu; device
// memory traffic is 12 KB of coefficients and one carry word per lane per
// swept pair. What the pair grid adds over the tile sweep is a block
// launch, a 12 KB stage and a block-wide max per pair, and the atomics.
//
// Build without --use_fast_math: the hit test relies on IEEE division and
// on NaN / inf failing every comparison.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int RAY_TILE = 1024;
constexpr int TREELET = 256;
constexpr int COL_MASK = 255;
constexpr float EPS = 1e-6f;
constexpr float T_MIN = 1e-4f;
constexpr float DEN_MIN = 1e-20f;
constexpr float MISS_T = 3.0e38f;
constexpr int ELEMWISE_THREADS = 256;

// Block-wide max of a non-negative int over the 32 warps of a 1024-thread
// block; every thread returns the result.
__device__ __forceinline__ int block_max(int v, int* s_warp, int* s_out) {
    v = __reduce_max_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x < 32) {
        int w = __reduce_max_sync(0xffffffffu, s_warp[threadIdx.x]);
        if (threadIdx.x == 0) *s_out = w;
    }
    __syncthreads();
    return *s_out;
}

// Copy treelet `t_id`'s coefficient block into shared memory.
__device__ __forceinline__ void stage(float4* s_coef, const float* coef, int t_id) {
    const float4* src = reinterpret_cast<const float4*>(coef) + (size_t)t_id * TREELET * 3;
    for (int i = threadIdx.x; i < TREELET * 3; i += RAY_TILE) s_coef[i] = src[i];
    __syncthreads();
}

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int64_t r) {
    return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

// _bw_block's t and hit predicate for one ray against triangle row (pn, pu, pv).
__device__ __forceinline__ bool hit_pairs(const Ray& r, const float4& pn, const float4& pu,
                                          const float4& pv, float& t) {
    const float num = pn.x * r.ox + pn.y * r.oy + pn.z * r.oz + pn.w;
    const float den = pn.x * r.dx + pn.y * r.dy + pn.z * r.dz;
    t = -num / (fabsf(den) < DEN_MIN ? DEN_MIN : den);
    const float u = (pu.x * r.ox + pu.y * r.oy + pu.z * r.oz + pu.w)
                    + t * (pu.x * r.dx + pu.y * r.dy + pu.z * r.dz);
    const float v = (pv.x * r.ox + pv.y * r.oy + pv.z * r.oz + pv.w)
                    + t * (pv.x * r.dx + pv.y * r.dy + pv.z * r.dz);
    // explicit compares: a NaN must reject the hit
    return (fabsf(den) > DEN_MIN) && (u >= -EPS) && (v >= -EPS) && (u + v <= 1.0f + EPS)
           && (t > T_MIN);
}

__global__ void init_best(const int* __restrict__ key_in,
                          unsigned long long* __restrict__ best, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) best[i] = (unsigned long long)(unsigned)key_in[i] << 32;
}

__global__ void __launch_bounds__(RAY_TILE)
closest_pairs_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const int* __restrict__ tre, const int* __restrict__ tn_bits,
                     const int* __restrict__ tile_of, const int* __restrict__ order,
                     const float* __restrict__ coef, unsigned long long* best) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int p = order[blockIdx.x];
    const int64_t r = (int64_t)tile_of[p] * RAY_TILE + threadIdx.x;
    // the freshest word in L2 (other blocks merge with atomics); an older
    // one only raises the threshold, which stays safe
    const int key = (int)(__ldcg(best + r) >> 32);
    // uniform over the block: either every thread returns or none does
    if (tn_bits[p] >= block_max(key | COL_MASK, s_warp, &s_thr)) return;
    stage(s_coef, coef, tre[p]);
    const Ray ray = load_ray(o, d, r);
    int kmin = INT_MAX;
#pragma unroll 4
    for (int j = 0; j < TREELET; ++j) {
        float t;
        const bool hit = hit_pairs(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t);
        const int bits = __float_as_int(hit ? t : MISS_T);
        kmin = min(kmin, (bits & ~COL_MASK) | j);
    }
    // <=: an equal key from a later pair must still give way to this one
    if (kmin <= key)
        atomicMin(best + r, ((unsigned long long)(unsigned)kmin << 32) | (unsigned)(p + 1));
}

__global__ void decode_best(const unsigned long long* __restrict__ best,
                            const int* __restrict__ tr_in, const int* __restrict__ tre,
                            int* __restrict__ key_out, int* __restrict__ tr_out, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned long long w = best[i];
    const unsigned rank = (unsigned)(w & 0xffffffffull);
    key_out[i] = (int)(w >> 32);
    tr_out[i] = rank == 0 ? tr_in[i] : tre[rank - 1];
}

__global__ void __launch_bounds__(RAY_TILE)
occlusion_pairs_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tmax_in, const int* __restrict__ tre,
                       const int* __restrict__ tn_bits, const int* __restrict__ tile_of,
                       const int* __restrict__ order, const float* __restrict__ coef,
                       int* occ) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int p = order[blockIdx.x];
    const int64_t r = (int64_t)tile_of[p] * RAY_TILE + threadIdx.x;
    const float tmax = tmax_in[r];
    const int oc = __ldcg(occ + r);
    // reach of the farthest unoccluded lane; bits(0.0f) = 0 once all are
    if (tn_bits[p] >= block_max(oc == 0 ? __float_as_int(tmax) : 0, s_warp, &s_thr)) return;
    stage(s_coef, coef, tre[p]);
    if (oc != 0) return;
    const Ray ray = load_ray(o, d, r);
    for (int j = 0; j < TREELET; ++j) {
        float t;
        if (hit_pairs(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t)
            && t < tmax) {
            occ[r] = 1;
            return;
        }
    }
}

inline unsigned elementwise_blocks(int64_t n) {
    return (unsigned)((n + ELEMWISE_THREADS - 1) / ELEMWISE_THREADS);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = cudaSuccess).
// best: (n_tiles * 1024,) 64-bit scratch; tile_of, order: (n_pairs,) from
// the wrapper's schedule.
int hikari_closest_pairs(const float* o, const float* d, const int* key_in, const int* tr_in,
                         const int* tre, const int* tn_bits, const int* tile_of,
                         const int* order, const float* coef, unsigned long long* best,
                         int* key_out, int* tr_out, int n_tiles, int n_pairs,
                         cudaStream_t stream) {
    const int64_t n = (int64_t)n_tiles * RAY_TILE;
    init_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(key_in, best, n);
    if (n_pairs > 0)
        closest_pairs_kernel<<<n_pairs, RAY_TILE, 0, stream>>>(
            o, d, tre, tn_bits, tile_of, order, coef, best);
    decode_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(
        best, tr_in, tre, key_out, tr_out, n);
    return (int)cudaGetLastError();
}

// occ holds the carried-in flags and is updated in place.
int hikari_occlusion_pairs(const float* o, const float* d, const float* tmax, const int* tre,
                           const int* tn_bits, const int* tile_of, const int* order,
                           const float* coef, int* occ, int n_tiles, int n_pairs,
                           cudaStream_t stream) {
    (void)n_tiles;
    if (n_pairs > 0)
        occlusion_pairs_kernel<<<n_pairs, RAY_TILE, 0, stream>>>(
            o, d, tmax, tre, tn_bits, tile_of, order, coef, occ);
    return (int)cudaGetLastError();
}

}  // extern "C"
