// Treelet sweeps of the packet traversal, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the main path:
//   hikari_closest_tiles   <- _closest_tiles_kernel   (hikari_tpu/geometry/wavefront.py:999)
//   hikari_occlusion_tiles <- _occlusion_tiles_kernel (hikari_tpu/geometry/wavefront.py:1052)
// both launched there by _sweep_tiles (wavefront.py:1098). The contract is
// stated in hikari_tpu_torch/geometry/sweep.py, which also holds the plain
// PyTorch versions these kernels are checked against.
//
// Design. One thread block of 1024 threads per 1024-ray tile, one thread
// per ray; the whole wavefront is one launch (the TPU's PAIR_CHUNK grid
// chunking was a scalar-memory limit and has no counterpart here). A
// block walks its tile's front-to-back pair segment. Per treelet it
// stages the 256 x 12 float32 coefficients (12 KB) in shared memory; every
// thread then reads the same triangle row at the same time, a broadcast
// with no bank conflicts. The loop condition compares the treelet's
// entry-distance bits with the tile threshold as int32, exactly as the TPU
// kernel does, and the threshold is a block-wide max after each treelet.
//
// Bound. Per (ray, triangle) pair the test is ~30 float32 operations plus
// one IEEE divide against 48 bytes of shared-memory reads that are
// broadcasts, so the kernel is bound by the FP32 issue rate and the divide;
// device memory traffic is 12 KB per visited treelet per tile. The TPU's
// 3-way bf16 split existed only for its bf16 matrix unit: here the affine
// form is evaluated directly in float32. The per-treelet barrier pair and
// the block reduction are the overhead a later version can hide with
// cp.async double buffering; this version is the simple one.
//
// Build without --use_fast_math: the hit test relies on IEEE division and
// on NaN / inf from den == 0 failing every comparison.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int RAY_TILE = 1024;
constexpr int TREELET = 256;
constexpr int COL_MASK = 255;
constexpr float EPS = 1e-6f;
constexpr float T_MIN = 1e-4f;
constexpr float MISS_T = 3.0e38f;

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

// Baldwin-Weber t, u, v of one ray against triangle row (pn, pu, pv).
struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ bool hit_t(const Ray& r, const float4& pn, const float4& pu,
                                      const float4& pv, float& t) {
    const float num = pn.x * r.ox + pn.y * r.oy + pn.z * r.oz + pn.w;
    const float den = pn.x * r.dx + pn.y * r.dy + pn.z * r.dz;
    t = -num / den;
    const float u = (pu.x * r.ox + pu.y * r.oy + pu.z * r.oz + pu.w)
                    + t * (pu.x * r.dx + pu.y * r.dy + pu.z * r.dz);
    const float v = (pv.x * r.ox + pv.y * r.oy + pv.z * r.oz + pv.w)
                    + t * (pv.x * r.dx + pv.y * r.dy + pv.z * r.dz);
    const float w = (1.0f + EPS) - (u + v);
    // explicit compares: fminf would drop a NaN that must reject the hit
    return (u >= -EPS) && (v >= -EPS) && (w >= -EPS) && (t > T_MIN);
}

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int64_t r) {
    return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

__global__ void __launch_bounds__(RAY_TILE)
closest_tiles_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const int* __restrict__ key_in, const int* __restrict__ tr_in,
                     const int* __restrict__ tre, const int* __restrict__ tn_bits,
                     const int* __restrict__ seg, const float* __restrict__ coef,
                     int* __restrict__ key_out, int* __restrict__ tr_out) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int64_t r = (int64_t)blockIdx.x * RAY_TILE + threadIdx.x;
    const Ray ray = load_ray(o, d, r);
    int key = key_in[r];
    int tr = tr_in[r];
    int thr = block_max(key | COL_MASK, s_warp, &s_thr);
    const int end = seg[blockIdx.x + 1];
    // thr and the pair index are uniform over the block, so every thread
    // takes the same trip count and the barriers inside are safe; the
    // barriers of block_max also order this iteration's shared-memory
    // reads before the next stage() overwrites them
    for (int p = seg[blockIdx.x]; p < end && tn_bits[p] < thr; ++p) {
        const int t_id = tre[p];
        stage(s_coef, coef, t_id);
        int kmin = INT_MAX;
#pragma unroll 4
        for (int j = 0; j < TREELET; ++j) {
            float t;
            const bool hit = hit_t(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t);
            const int bits = __float_as_int(hit ? t : MISS_T);
            kmin = min(kmin, (bits & ~COL_MASK) | j);
        }
        if (kmin < key) {  // strict: an earlier treelet wins a tie
            key = kmin;
            tr = t_id;
        }
        thr = block_max(key | COL_MASK, s_warp, &s_thr);
    }
    key_out[r] = key;
    tr_out[r] = tr;
}

__global__ void __launch_bounds__(RAY_TILE)
occlusion_tiles_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ tmax_in, const int* __restrict__ occ_in,
                       const int* __restrict__ tre, const int* __restrict__ tn_bits,
                       const int* __restrict__ seg, const float* __restrict__ coef,
                       int* __restrict__ occ_out) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int64_t r = (int64_t)blockIdx.x * RAY_TILE + threadIdx.x;
    const Ray ray = load_ray(o, d, r);
    const float tmax = tmax_in[r];
    int occ = occ_in[r];
    // reach of the farthest unoccluded lane; bits(0.0f) = 0 once all are
    int thr = block_max(occ == 0 ? __float_as_int(tmax) : 0, s_warp, &s_thr);
    const int end = seg[blockIdx.x + 1];
    for (int p = seg[blockIdx.x]; p < end && tn_bits[p] < thr; ++p) {
        stage(s_coef, coef, tre[p]);
        if (occ == 0) {
            for (int j = 0; j < TREELET; ++j) {
                float t;
                if (hit_t(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t)
                    && t < tmax) {
                    occ = 1;
                    break;
                }
            }
        }
        thr = block_max(occ == 0 ? __float_as_int(tmax) : 0, s_warp, &s_thr);
    }
    occ_out[r] = occ;
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess).
int hikari_closest_tiles(const float* o, const float* d, const int* key_in,
                         const int* tr_in, const int* tre, const int* tn_bits,
                         const int* seg, const float* coef, int* key_out, int* tr_out,
                         int n_tiles, cudaStream_t stream) {
    closest_tiles_kernel<<<n_tiles, RAY_TILE, 0, stream>>>(
        o, d, key_in, tr_in, tre, tn_bits, seg, coef, key_out, tr_out);
    return (int)cudaGetLastError();
}

int hikari_occlusion_tiles(const float* o, const float* d, const float* tmax,
                           const int* occ_in, const int* tre, const int* tn_bits,
                           const int* seg, const float* coef, int* occ_out,
                           int n_tiles, cudaStream_t stream) {
    occlusion_tiles_kernel<<<n_tiles, RAY_TILE, 0, stream>>>(
        o, d, tmax, occ_in, tre, tn_bits, seg, coef, occ_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
