// The pair-grid treelet sweep for Hopper (sm_90a): one device body for the
// flat sweeps, with the hit test as a template parameter.
//
// A source that includes this header names its hit test (a struct with a
// static `test(ray, pn, pu, pv, t)`) and instantiates launch_closest /
// launch_occlusion / grid_attributes with it. csrc/sweep_tiles.cu does so
// with the tile sweeps' lean test, csrc/sweep_pairs.cu with the pair-grid
// sweeps' clamped test; their head notes say which TPU kernels these
// replace and what bounds them. launch_pretest runs the pre-test alone, for
// the check against its PyTorch mirror.
//
// Decomposition. One block per (tile, treelet) pair, the whole pair list in
// one launch, started rank-major (the wrapper's pair_schedule: every tile's
// nearest pair first), so a tile with a long segment spreads over many SMs
// instead of walking it in one block. A block has 512 threads and each
// takes two neighbouring rays of the 1024-ray tile, so that two blocks fit
// on an SM (at most 64 registers a thread, 2 x 12 KB of shared memory): one
// block's 12 KB stage overlaps the other's arithmetic, and every triangle
// row read from shared memory (a warp broadcast) serves two rays. No
// block-wide reduction remains.
//
// Blocks run in no order, so the sequential walk's carry becomes state in
// device memory:
//
// * closest: a 64-bit word per lane, key << 32 | rank + 1, with rank the
//   pair's index in its tile's segment (p - seg[tile]) and low word 0 for
//   the carried-in key. Keys are non-negative int32 (a hit has t > 1e-4, a
//   reach is >= 0) and a carried-in key is at most MISS_KEY (a lane above it
//   would keep its key where the plain version writes its no-hit value; the
//   caller, geometry/wavefront.py, hands in 3.0e37 for a reach that is not
//   finite), so unsigned order is key order, and a lane lies in one tile,
//   whose pairs order by rank as by p. The minimum word is therefore the
//   sequential rule: within a treelet the key's column bits break a tie,
//   an earlier pair wins a tie between treelets, and a pair beats the carry
//   (whatever it is: a reach, an earlier pass's hit key, a dead lane's 255)
//   only when strictly smaller. rank + 1 fits: a pair list is indexed by
//   int32. Each block merges its per-lane best with atomicMin; a last kernel
//   splits the words into (key, tr = tre[seg[tile] + rank] or tr_in).
// * occlusion: the int32 flag is updated in place; a block stores 1 on the
//   lanes it occludes (concurrent stores of 1 are benign).
//
// Early-out. A hit in pair p lies at bits(t) >= tn_bits[p], the pair's
// conservative entry distance. A closest lane can still gain from the pair
// only while tn_bits[p] <= key | 255 (a hit beyond that has larger upper 24
// bits than the lane's key), an occlusion lane while it is unoccluded and
// tn_bits[p] < bits(tmax). A block reads its tile's carry once at its start
// and skips the pair, before staging, when no lane can gain; a warp with no
// such lane leaves after the stage. Read concurrently, the carry may be
// older or newer than the sequential walk's at that pair. The skip is exact
// all the same: the carry only falls, and never below the final result, so
// the pair that holds a lane's final word always has tn_bits <= the carry
// read | 255 and is never skipped. The closest sweep thus returns the
// minimum word over every listed pair, whatever the order of the blocks,
// and the occlusion sweep the union of the hits before each lane's reach.
// The walk of the plain version stops a tile at the first pair whose entry
// distance reaches the tile's threshold (a strict compare); a hit in a pair
// it left out has upper 24 key bits >= the lane's, so the two closest
// results differ only where two hits tie in the upper 24 bits of the key
// and the column decides, and the occlusion results not at all.
//
// The test. Almost every (ray, triangle) misses, so each first goes through
// a pre-test: the hit predicate multiplied through by |den| (no divide),
// loosened by 1/64 in u, v and the far limit of t and by half at T_MIN.
// den and num are rounded as the hit tests round them, so t |den| / |den|
// is their t to an ulp; the four dot products of u and v are 3-term FMAs in
// one fixed order. (With den and num as FMAs too, a ray grazing a plane at
// 1e-4 rad carried den's rounding error, over 1e-4, into t, and the
// pre-test refused hits near small triangles' edges.) It comes in two
// stages. The first is the u slab alone: it tells a triangle off the
// footprint of a warp's 64 rays, which the t range does not, and a warp
// none of whose rays passes it goes on to the next triangle. The second
// adds v, u + v and the t range. Only the few (ray, triangle) that pass
// both reach the instantiation's own test, which rounds as the plain
// version does and alone decides. NaN and inf from degenerate and padding
// rows fail every compare in both (explicit compares, no fminf; build
// without --use_fast_math). The pre-test's u and v then differ from the
// hit test's by a few ulps of their largest partial product, which the
// slack covers while au and t bu cancel by less than ~2^15 (an origin
// within ~1e4 triangle sizes); beyond that equality with the plain version
// is observed, not guaranteed.
//
// TMA and clusters have no use here: a stage is 12 KB read once per block.
// The tensor cores could take the dot products only as a 3xTF32 split, with
// the compares still on the FP32 pipes; that was not tried.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace sweep_grid {

constexpr int RAY_TILE = 1024;
constexpr int THREADS = 512;  // two rays a thread
constexpr int TREELET = 256;
constexpr int COL_MASK = 255;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-6f;
constexpr float T_MIN = 1e-4f;
constexpr int MISS_KEY = 0x7f61b1e6;  // bits(3.0e38f), the plain version's no-hit t
constexpr float PRE_MARGIN = 1.0f / 64.0f;    // the pre-test's slack in u and v
constexpr float PRE_T = 1.0f + 1.0f / 64.0f;  // and at the far limit of t
constexpr int ELEMWISE_THREADS = 256;

struct Ray {
    float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* o, const float* d, int64_t r) {
    return Ray{o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2]};
}

// The hit tests' arithmetic: every operation rounded on its own (no FMA
// contraction), in the order of the plain versions' sweep.affine.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ((x g.x + y g.y) + z g.z)
__device__ __forceinline__ float dot3(const float4& g, float x, float y, float z) {
    return add(add(mul(x, g.x), mul(y, g.y)), mul(z, g.z));
}

// Copy treelet t_id's coefficient block into shared memory.
__device__ __forceinline__ void stage(float4* s_coef, const float* coef, int t_id) {
    const float4* src = reinterpret_cast<const float4*>(coef) + (size_t)t_id * TREELET * 3;
    for (int i = threadIdx.x; i < TREELET * 3; i += THREADS) s_coef[i] = src[i];
    __syncthreads();
}

// The pre-test's dot products of u and v: FMAs in one fixed order.
__device__ __forceinline__ float fdot_o(const float4& g, const Ray& r) {
    return __fmaf_rn(r.ox, g.x, __fmaf_rn(r.oy, g.y, __fmaf_rn(r.oz, g.z, g.w)));
}

__device__ __forceinline__ float fdot_d(const float4& g, const Ray& r) {
    return __fmaf_rn(r.dx, g.x, __fmaf_rn(r.dy, g.y, __fmul_rn(r.dz, g.z)));
}

// The pre-test: u, v >= -eps, u + v <= 1 + 2 eps, T_MIN < t < t_hi / PRE_T
// multiplied through by |den| and loosened by PRE_MARGIN in u and v, a
// factor 2 at T_MIN and PRE_T at the far limit. den == 0 fails the two
// compares of t, a NaN every compare. The compares are joined by & and not
// &&: all are evaluated, no branch per lane.
struct Scaled {
    float nt, aden, su;  // t |den|, |den|, u |den|
};

// First stage, the u slab: |u - 1/2| <= 1/2 + eps + PRE_MARGIN. den and num
// are rounded as the hit tests round them, so that nt / |den| is their t to
// an ulp (see The test above).
__device__ __forceinline__ bool may_hit_u(const Ray& r, const float4& pn, const float4& pu,
                                          Scaled& s) {
    const float den = dot3(pn, r.dx, r.dy, r.dz);
    const float num = add(dot3(pn, r.ox, r.oy, r.oz), pn.w);
    s.aden = fabsf(den);
    // -num sign(den): num with its sign flipped where den's is clear
    s.nt = __int_as_float(__float_as_int(num) ^ (~__float_as_int(den) & 0x80000000));
    s.su = __fmaf_rn(s.nt, fdot_d(pu, r), __fmul_rn(fdot_o(pu, r), s.aden));
    return fabsf(__fmaf_rn(-0.5f, s.aden, s.su)) <= __fmul_rn(0.5f + EPS + PRE_MARGIN, s.aden);
}

// Second stage: v, u + v and the t range.
__device__ __forceinline__ bool may_hit_vt(const Ray& r, const float4& pv, float t_hi,
                                           const Scaled& s) {
    const float sv = __fmaf_rn(s.nt, fdot_d(pv, r), __fmul_rn(fdot_o(pv, r), s.aden));
    const float slack = __fmul_rn(EPS + PRE_MARGIN, s.aden);
    return (sv >= -slack) & (__fadd_rn(s.su, sv) <= __fadd_rn(s.aden, slack))
           & (s.nt > __fmul_rn(0.5f * T_MIN, s.aden)) & (s.nt < __fmul_rn(t_hi, s.aden));
}

static __global__ void init_best(const int* __restrict__ key_in,
                                 unsigned long long* __restrict__ best, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) best[i] = (unsigned long long)(unsigned)key_in[i] << 32;
}

// The pre-test's far limit for a lane that only a key below `below` can
// improve: such a hit has bits(t) <= (below - 1) | COL_MASK.
__device__ __forceinline__ float far_limit(int below) {
    return __fmul_rn(__int_as_float((below - 1) | COL_MASK), PRE_T);
}

template <class Hit>
__global__ void __launch_bounds__(THREADS, 2)
closest_grid_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const int* __restrict__ tre, const int* __restrict__ tn_bits,
                    const int* __restrict__ seg, const int* __restrict__ tile_of,
                    const int* __restrict__ order, const float* __restrict__ coef,
                    unsigned long long* best) {
    __shared__ float4 s_coef[TREELET * 3];
    const int p = order[blockIdx.x];
    const int tn = tn_bits[p];
    const int tile = tile_of[p];
    const int64_t r = (int64_t)tile * RAY_TILE + 2 * threadIdx.x;
    // the freshest words in L2 (other blocks merge with atomics)
    const unsigned long long w[2] = {__ldcg(best + r), __ldcg(best + r + 1)};
    const int kc[2] = {(int)(w[0] >> 32), (int)(w[1] >> 32)};
    const bool need = tn <= (kc[0] | COL_MASK) || tn <= (kc[1] | COL_MASK);
    // uniform over the block: either every thread returns or none does
    if (!__syncthreads_or(need)) return;
    stage(s_coef, coef, tre[p]);
    // no barrier follows: a warp with nothing to gain may leave
    if (!__any_sync(FULL, need)) return;
    const unsigned low = (unsigned)(p - seg[tile]) + 1u;
    const Ray ray[2] = {load_ray(o, d, r), load_ray(o, d, r + 1)};
    // only a key <= the carry can lower the word (an equal key from an
    // earlier pair does); the miss key caps it as the plain version's
    // no-hit value
    int kb[2];
    float t_hi[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        kb[k] = min(kc[k], MISS_KEY) + 1;
        t_hi[k] = far_limit(kb[k]);
    }
#pragma unroll 2
    for (int j = 0; j < TREELET; ++j) {
        const float4 pn = s_coef[3 * j], pu = s_coef[3 * j + 1];
        Scaled s[2];
        bool m[2] = {may_hit_u(ray[0], pn, pu, s[0]), may_hit_u(ray[1], pn, pu, s[1])};
        if (!__any_sync(FULL, m[0] | m[1])) continue;
        const float4 pv = s_coef[3 * j + 2];
        m[0] &= may_hit_vt(ray[0], pv, t_hi[0], s[0]);
        m[1] &= may_hit_vt(ray[1], pv, t_hi[1], s[1]);
        if (!__any_sync(FULL, m[0] | m[1])) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            float t;
            if (m[k] && Hit::test(ray[k], pn, pu, pv, t)) {
                const int key = (__float_as_int(t) & ~COL_MASK) | j;
                if (key < kb[k]) {
                    kb[k] = key;
                    t_hi[k] = far_limit(key);
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const unsigned long long word = ((unsigned long long)(unsigned)kb[k] << 32) | low;
        // a hit was found, and it orders before the word read
        if (kb[k] <= min(kc[k], MISS_KEY) && word < w[k]) atomicMin(best + r + k, word);
    }
}

// Split each word into (key, tr): the carried-in treelet where the low word
// is 0, else the treelet of the tile's pair of that rank.
static __global__ void decode_best(const unsigned long long* __restrict__ best,
                                   const int* __restrict__ tr_in, const int* __restrict__ tre,
                                   const int* __restrict__ seg, int* __restrict__ key_out,
                                   int* __restrict__ tr_out, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned long long w = best[i];
    const unsigned low = (unsigned)(w & 0xffffffffull);
    key_out[i] = (int)(w >> 32);
    tr_out[i] = low == 0 ? tr_in[i] : tre[seg[i / RAY_TILE] + (int)(low - 1)];
}

template <class Hit>
__global__ void __launch_bounds__(THREADS, 2)
occlusion_grid_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax_in, const int* __restrict__ tre,
                      const int* __restrict__ tn_bits, const int* __restrict__ tile_of,
                      const int* __restrict__ order, const float* __restrict__ coef,
                      int* occ) {
    __shared__ float4 s_coef[TREELET * 3];
    const int p = order[blockIdx.x];
    const int tn = tn_bits[p];
    const int64_t r = (int64_t)tile_of[p] * RAY_TILE + 2 * threadIdx.x;
    const float tmax[2] = {tmax_in[r], tmax_in[r + 1]};
    // unoccluded lanes that reach past the pair's entry distance
    bool live[2] = {__ldcg(occ + r) == 0 && tn < __float_as_int(tmax[0]),
                    __ldcg(occ + r + 1) == 0 && tn < __float_as_int(tmax[1])};
    if (!__syncthreads_or(live[0] || live[1])) return;
    stage(s_coef, coef, tre[p]);
    if (!__any_sync(FULL, live[0] || live[1])) return;
    const Ray ray[2] = {load_ray(o, d, r), load_ray(o, d, r + 1)};
    const float t_hi[2] = {__fmul_rn(tmax[0], PRE_T), __fmul_rn(tmax[1], PRE_T)};
#pragma unroll 2
    for (int j = 0; j < TREELET; ++j) {
        const float4 pn = s_coef[3 * j], pu = s_coef[3 * j + 1];
        Scaled s[2];
        bool m[2] = {static_cast<bool>(live[0] & may_hit_u(ray[0], pn, pu, s[0])),
                     static_cast<bool>(live[1] & may_hit_u(ray[1], pn, pu, s[1]))};
        if (!__any_sync(FULL, m[0] | m[1])) continue;
        const float4 pv = s_coef[3 * j + 2];
        m[0] &= may_hit_vt(ray[0], pv, t_hi[0], s[0]);
        m[1] &= may_hit_vt(ray[1], pv, t_hi[1], s[1]);
        if (!__any_sync(FULL, m[0] | m[1])) continue;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            float t;
            if (m[k] && Hit::test(ray[k], pn, pu, pv, t) && t < tmax[k]) {
                occ[r + k] = 1;
                live[k] = false;
            }
        }
        // the warp leaves once none of its lanes is live
        if (!__any_sync(FULL, live[0] | live[1])) break;
    }
}

inline unsigned elementwise_blocks(int64_t n) {
    return (unsigned)((n + ELEMWISE_THREADS - 1) / ELEMWISE_THREADS);
}

// The three launches of a closest sweep; returns cudaGetLastError().
// seg: (n_tiles + 1,) segment starts; tile_of, order: (n_pairs,) from the
// wrapper's schedule; best: (n_tiles * 1024,) 64-bit scratch.
template <class Hit>
int launch_closest(const float* o, const float* d, const int* key_in, const int* tr_in,
                   const int* tre, const int* tn_bits, const int* seg, const int* tile_of,
                   const int* order, const float* coef, unsigned long long* best,
                   int* key_out, int* tr_out, int n_tiles, int n_pairs, cudaStream_t stream) {
    const int64_t n = (int64_t)n_tiles * RAY_TILE;
    init_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(key_in, best, n);
    if (n_pairs > 0)
        closest_grid_kernel<Hit><<<n_pairs, THREADS, 0, stream>>>(
            o, d, tre, tn_bits, seg, tile_of, order, coef, best);
    decode_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(
        best, tr_in, tre, seg, key_out, tr_out, n);
    return (int)cudaGetLastError();
}

// occ holds the carried-in flags and is updated in place.
template <class Hit>
int launch_occlusion(const float* o, const float* d, const float* tmax, const int* tre,
                     const int* tn_bits, const int* tile_of, const int* order,
                     const float* coef, int* occ, int n_pairs, cudaStream_t stream) {
    if (n_pairs > 0)
        occlusion_grid_kernel<Hit><<<n_pairs, THREADS, 0, stream>>>(
            o, d, tmax, tre, tn_bits, tile_of, order, coef, occ);
    return (int)cudaGetLastError();
}

// The pre-test alone, both stages joined as the sweeps join them: out[r *
// 256 + j] = 1 where ray r may hit row j of one treelet's coefficients
// (256 x 12), with the far limit t_far[r] * PRE_T. A diagnostic: the
// sweeps never launch it.
static __global__ void pretest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                                      const float* __restrict__ t_far,
                                      const float* __restrict__ coef,
                                      unsigned char* __restrict__ out, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * TREELET) return;
    const int64_t r = i / TREELET;
    const float4* row = reinterpret_cast<const float4*>(coef) + 3 * (i % TREELET);
    const Ray ray = load_ray(o, d, r);
    Scaled s;
    const bool u = may_hit_u(ray, row[0], row[1], s);
    out[i] = u & may_hit_vt(ray, row[2], __fmul_rn(t_far[r], PRE_T), s);
}

inline int launch_pretest(const float* o, const float* d, const float* t_far, const float* coef,
                          unsigned char* out, int64_t n, cudaStream_t stream) {
    if (n > 0)
        pretest_kernel<<<elementwise_blocks(n * TREELET), ELEMWISE_THREADS, 0, stream>>>(
            o, d, t_far, coef, out, n);
    return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread and resident blocks per
// SM of the two sweep kernels, into out[0..2] (closest) and out[3..5]
// (occlusion).
template <class Hit>
int grid_attributes(int* out) {
    const void* kernels[2] = {reinterpret_cast<const void*>(closest_grid_kernel<Hit>),
                              reinterpret_cast<const void*>(occlusion_grid_kernel<Hit>)};
    for (int k = 0; k < 2; ++k) {
        cudaFuncAttributes a;
        cudaError_t err = cudaFuncGetAttributes(&a, kernels[k]);
        if (err != cudaSuccess) return (int)err;
        out[3 * k] = a.numRegs;
        out[3 * k + 1] = (int)a.localSizeBytes;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3 * k + 2], kernels[k],
                                                            THREADS, 0);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace sweep_grid
