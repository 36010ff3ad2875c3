// Instanced (two-level, TLAS/BLAS) treelet sweeps of the packet traversal,
// for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the instanced path:
//   hikari_closest_inst   <- _closest_inst_kernel   (hikari_tpu/geometry/instanced.py:146)
//   hikari_occlusion_inst <- _occlusion_inst_kernel (hikari_tpu/geometry/instanced.py:194)
// both launched there by _sweep_chunks_inst (instanced.py:230). The contract
// is stated in hikari_tpu_torch/geometry/sweep_inst.py, which also holds the
// plain PyTorch versions these kernels are checked against.
//
// Design: the pair grid of sweep_pairs.cu. One block per (tile, world
// treelet) pair, the whole pair list in one launch, issued rank-major (the
// wrapper's pair_schedule: every tile's nearest pair first), so a tile with
// a long segment spreads over many SMs instead of walking it in one block.
// A block has 512 threads and each takes two neighbouring rays of the
// 1024-ray tile, so that two blocks fit on an SM (at most 64 registers a
// thread): one block's 12 KB stage overlaps the other's arithmetic, and
// every triangle row read from shared memory (a warp broadcast) serves two
// rays. Per pair the block stages the shared object-space coefficient block
// coef[ti_obj[wt]] (256 x 12 float32) and the instance matrix
// inst_a[ti_inst[wt]] (4 x 4) and moves its rays into that instance's
// object space ([o,1] A and [d,0] A; directions stay unnormalised, so the
// object-space t is the world t).
//
// Blocks run in no order, so the TPU's sequential carry becomes state in
// device memory:
//
// * closest: a 64-bit word per lane, bits(t) << 32 | (rank * 256 + column +
//   1) with rank the pair's index in its tile's segment (p - seg[tile]); the
//   carried-in reach has low word 0. Hits have t > 1e-4 and reaches are >= 0,
//   and a lane lies in one tile, whose pairs order by rank as by p, so the
//   words order as (t, p, column), and their minimum is exactly the
//   sequential walk's result: within a treelet the lowest column wins a tie,
//   an earlier treelet wins a tie, and a pair beats the carry only when
//   strictly nearer. The field holds 2^24 pairs a tile, far above the world
//   treelets a tile can list (each at most once). Each block merges its
//   per-lane best with atomicMin; a last kernel re-evaluates the winner's
//   (lane, seg[tile] + rank, column) with the same device function and
//   writes (t, tri, b1, b2).
// * occlusion: the int32 flag is updated in place; a block stores 1 on the
//   lanes it occludes (concurrent stores of 1 are benign).
//
// Early-out. A hit in pair p lies at t >= the pair's conservative entry
// distance tn[p], so a lane can gain from pair p only when bits(tn[p]) <=
// bits(its current t) (closest) or < bits(tmax) while unoccluded
// (occlusion). A block reads its tile's carry once at its start and skips
// the pair (before staging) when no lane can gain, and a warp skips it when
// none of its lanes can. Read concurrently, the carry may be older or newer
// than the sequential walk's at that pair, and the skip is still exact: the
// carry only falls, and never below the final result, so a lane's final
// winning pair always has bits(tn) <= bits(the carry read) and is never
// skipped. The test is <= and not <, unlike K5's (sweep_pairs.cu), so that
// a pair whose hit would tie the carry in t is still swept: it may hold the
// earlier (p, column) that the tie needs. The occlusion skip is the
// sequential walk's own threshold applied per lane. The decomposition
// therefore gives the in-order walk's result, ties included, from the same
// per-pair hits (but see Rounding).
//
// Bound. The FP32 issue rate: per (ray, triangle) the pre-test below is ~39
// float32 instructions (four 3-term dot products as FMAs, den and num
// rounded singly, the scaled compares) against broadcast shared-memory reads; the per-pair transform
// adds 28 operations per ray, 1/256 of a pair's triangle work. The TPU
// split the transformed rays three ways into bf16 in-kernel
// (instanced.py:119) only for its bf16 matrix unit; here the affine form is
// evaluated directly in float32.
//
// Rounding. Unlike the flat sweeps, whose winner is re-resolved exactly
// afterwards, the instanced hit record is the affine form's own t, u, v:
// near a surface n.o and dw cancel, and u = au + t bu amplifies any change
// in t by bu, which is large on small triangles. So the record comes from
// hit_inst, which rounds every operation explicitly (__fmul_rn /
// __fadd_rn: no FMA contraction, an IEEE divide for t) in the order of the
// plain PyTorch version. hit_inst is ~50 operations and a divide, though,
// and almost every (ray, triangle) misses, so each is first put through
// may_hit: the same predicate multiplied through by |den| (no divide),
// loosened by 1/64 in u, v and the far limit of t and by half at T_MIN. Its
// den and num are rounded as hit_inst's (whose fourth terms, d.w n.w and
// o.w n.w, are +-0 and n.w for an affine instance), so t |den| / |den| is
// hit_inst's t to an ulp, and the dot products of u and v are FMAs in one
// fixed order. Only the (ray, triangle) combinations that pass it, a few
// per ray and treelet, reach hit_inst; both sweeps then decide, and the
// decode kernel re-evaluates, with hit_inst alone. may_hit's u and v differ
// from hit_inst's by a few ulps of their largest partial product, which the
// slack covers while au and t bu cancel by less than ~2^15 (the flat
// pre-test's argument, csrc/sweep_grid.cuh; its PyTorch mirror is
// sweep_inst.may_hit_plain, held against this function on the card by
// pretest_kernel). Beyond that range the kernels' equality with their plain
// versions is observed, not guaranteed; the checks' floor of 99.9%
// agreement covers it.
//
// Build without --use_fast_math: the hit test relies on IEEE division and on
// NaN / inf failing every comparison.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int RAY_TILE = 1024;
constexpr int THREADS = 512;  // two rays a thread
constexpr int TREELET = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-6f;
constexpr float T_MIN = 1e-4f;
constexpr float DEN_MIN = 1e-20f;
constexpr float MISS_T = 3.0e38f;
constexpr float PRE_MARGIN = 1.0f / 64.0f;  // the pre-test's slack in u and v
constexpr float PRE_T = 1.0f + 1.0f / 64.0f;  // and at the far limit of t
constexpr int ELEMWISE_THREADS = 256;

// Copy world treelet wt's coefficient block and instance matrix into shared
// memory.
__device__ __forceinline__ void stage(float4* s_coef, float4* s_a, const float* coef,
                                      const float* inst_a, const int* ti_obj,
                                      const int* ti_inst, int wt) {
    const float4* src = reinterpret_cast<const float4*>(coef) + (size_t)ti_obj[wt] * TREELET * 3;
    for (int i = threadIdx.x; i < TREELET * 3; i += THREADS) s_coef[i] = src[i];
    if (threadIdx.x < 4)
        s_a[threadIdx.x] = reinterpret_cast<const float4*>(inst_a)[(size_t)ti_inst[wt] * 4 + threadIdx.x];
    __syncthreads();
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// ((x a0 + y a1) + z a2), component c: three rows of A against a 3-vector.
#define XFORM3(vx, vy, vz, m, c) add(add(mul(vx, m[0].c), mul(vy, m[1].c)), mul(vz, m[2].c))

// Object-space [o,1] A (the fourth row added) and [d,0] A.
__device__ __forceinline__ float4 xform_point(float x, float y, float z, const float4* a) {
    return make_float4(add(XFORM3(x, y, z, a, x), a[3].x), add(XFORM3(x, y, z, a, y), a[3].y),
                       add(XFORM3(x, y, z, a, z), a[3].z), add(XFORM3(x, y, z, a, w), a[3].w));
}

__device__ __forceinline__ float4 xform_dir(float x, float y, float z, const float4* a) {
    return make_float4(XFORM3(x, y, z, a, x), XFORM3(x, y, z, a, y), XFORM3(x, y, z, a, z),
                       XFORM3(x, y, z, a, w));
}

// (((g.x x.x + g.y x.y) + g.z x.z) + g.w x.w)
__device__ __forceinline__ float dot4(const float4& g, const float4& x) {
    return add(add(add(mul(x.x, g.x), mul(x.y, g.y)), mul(x.z, g.z)), mul(x.w, g.w));
}

// Object-space [o,1] A and [d,0] A of one ray.
struct Ray4 {
    float4 o, d;
};

__device__ __forceinline__ Ray4 object_ray(const float* o, const float* d, int64_t r,
                                           const float4* a) {
    return Ray4{xform_point(o[3 * r], o[3 * r + 1], o[3 * r + 2], a),
                xform_dir(d[3 * r], d[3 * r + 1], d[3 * r + 2], a)};
}

// The instanced hit test (instanced.py:140-175): t, u, v of one ray against
// triangle row (pn, pu, pv), true on a hit.
__device__ __forceinline__ bool hit_inst(const Ray4& r, const float4& pn, const float4& pu,
                                         const float4& pv, float& t, float& u, float& v) {
    const float den = dot4(pn, r.d);
    const float aden = fabsf(den);
    t = __fdiv_rn(-dot4(pn, r.o), aden < DEN_MIN ? DEN_MIN : den);
    u = add(dot4(pu, r.o), mul(t, dot4(pu, r.d)));
    v = add(dot4(pv, r.o), mul(t, dot4(pv, r.d)));
    // explicit compares: a NaN in any of them rejects the hit
    return (aden > DEN_MIN) && (u >= -EPS) && (v >= -EPS) && (add(u, v) <= 1.0f + EPS)
           && (t > T_MIN);
}

// The pre-test's dot products of u and v with the object-space ray: FMAs in
// one fixed order, taking o.w = 1 and d.w = 0 (the instance matrices invert
// affine transforms, as the world boxes of instanced.py already assume).
__device__ __forceinline__ float fdot_o(const float4& g, const float4& o) {
    return __fmaf_rn(o.x, g.x, __fmaf_rn(o.y, g.y, __fmaf_rn(o.z, g.z, g.w)));
}

__device__ __forceinline__ float fdot_d(const float4& g, const float4& d) {
    return __fmaf_rn(d.x, g.x, __fmaf_rn(d.y, g.y, __fmul_rn(d.z, g.z)));
}

// The pre-test: hit_inst's predicate and t < t_hi / PRE_T multiplied
// through by |den| (no divide), u and v evaluated with FMAs, loosened by
// PRE_MARGIN in u and v, a factor 2 at T_MIN and PRE_T at the far limit.
// Only a ray and triangle that pass it go through hit_inst.
__device__ __forceinline__ bool may_hit(const Ray4& r, const float4& pn, const float4& pu,
                                        const float4& pv, float t_hi) {
    // hit_inst's den and num, their fourth terms left out (exact, see above)
    const float den = add(add(mul(r.d.x, pn.x), mul(r.d.y, pn.y)), mul(r.d.z, pn.z));
    const float num = add(add(add(mul(r.o.x, pn.x), mul(r.o.y, pn.y)), mul(r.o.z, pn.z)), pn.w);
    const float aden = fabsf(den);
    const float nt = den < 0.0f ? num : -num;  // t |den|
    const float su = __fmaf_rn(nt, fdot_d(pu, r.d), __fmul_rn(fdot_o(pu, r.o), aden));
    const float sv = __fmaf_rn(nt, fdot_d(pv, r.d), __fmul_rn(fdot_o(pv, r.o), aden));
    const float slack = __fmul_rn(EPS + PRE_MARGIN, aden);
    // explicit compares: a NaN in any of them rejects the pair
    return (su >= -slack) && (sv >= -slack) && (__fadd_rn(su, sv) <= __fadd_rn(aden, slack))
           && (nt > __fmul_rn(0.5f * T_MIN, aden)) && (nt < __fmul_rn(t_hi, aden));
}

// One ray's running best within a treelet.
struct Best {
    float t;
    int j;
};

__global__ void init_best(const float* __restrict__ t_in, unsigned long long* __restrict__ best,
                          int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) best[i] = (unsigned long long)(unsigned)__float_as_int(t_in[i]) << 32;
}

__global__ void __launch_bounds__(THREADS, 2)
closest_inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const int* __restrict__ tre, const int* __restrict__ tn_bits,
                    const int* __restrict__ seg, const int* __restrict__ tile_of,
                    const int* __restrict__ order, const int* __restrict__ ti_obj,
                    const int* __restrict__ ti_inst, const float* __restrict__ coef,
                    const float* __restrict__ inst_a, unsigned long long* best) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ float4 s_a[4];
    const int p = order[blockIdx.x];
    const int tn = tn_bits[p];
    const int tile = tile_of[p];
    const int64_t r = (int64_t)tile * RAY_TILE + 2 * threadIdx.x;
    // the freshest words in L2 (other blocks merge with atomics)
    const unsigned long long w[2] = {__ldcg(best + r), __ldcg(best + r + 1)};
    const int tc[2] = {(int)(w[0] >> 32), (int)(w[1] >> 32)};
    const bool need = tn <= tc[0] || tn <= tc[1];
    // uniform over the block: either every thread returns or none does
    if (!__syncthreads_or(need)) return;
    stage(s_coef, s_a, coef, inst_a, ti_obj, ti_inst, tre[p]);
    // no barrier follows: a warp with nothing to gain may leave
    if (!__any_sync(FULL, need)) return;
    const unsigned rank = (unsigned)(p - seg[tile]);
    Ray4 ray[2];
    Best b[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        ray[k] = object_ray(o, d, r + k, s_a);
        // only t <= the carry can win (a tie may hold an earlier pair);
        // MISS_T caps it as the plain version's no-hit value
        b[k] = Best{__int_as_float(tc[k] >= __float_as_int(MISS_T) ? __float_as_int(MISS_T)
                                                                  : tc[k] + 1), 0};
    }
    float t_hi[2] = {__fmul_rn(b[0].t, PRE_T), __fmul_rn(b[1].t, PRE_T)};
#pragma unroll 2
    for (int j = 0; j < TREELET; ++j) {
        const float4 pn = s_coef[3 * j], pu = s_coef[3 * j + 1], pv = s_coef[3 * j + 2];
        const bool m[2] = {may_hit(ray[0], pn, pu, pv, t_hi[0]),
                           may_hit(ray[1], pn, pu, pv, t_hi[1])};
        if (__any_sync(FULL, m[0] || m[1])) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                float t, u, v;
                // strict: the lowest column wins among equal t
                if (m[k] && hit_inst(ray[k], pn, pu, pv, t, u, v) && t < b[k].t) {
                    b[k] = Best{t, j};
                    t_hi[k] = __fmul_rn(t, PRE_T);
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const unsigned long long word =
            ((unsigned long long)(unsigned)__float_as_int(b[k].t) << 32)
            | (rank * TREELET + (unsigned)b[k].j + 1u);
        if (word < w[k]) atomicMin(best + r + k, word);
    }
}

// Split each word into the hit record: the winner's t, u, v re-evaluated by
// hit_inst for its (lane, pair seg[tile] + rank, column), as the sweep
// evaluated them.
__global__ void decode_best(const unsigned long long* __restrict__ best,
                            const float* __restrict__ o, const float* __restrict__ d,
                            const int* __restrict__ tre, const int* __restrict__ seg,
                            const int* __restrict__ ti_obj,
                            const int* __restrict__ ti_inst, const float* __restrict__ coef,
                            const float* __restrict__ inst_a, float* __restrict__ t_out,
                            int* __restrict__ tri_out, float* __restrict__ b1_out,
                            float* __restrict__ b2_out, int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const unsigned long long w = best[i];
    const unsigned low = (unsigned)(w & 0xffffffffull);
    t_out[i] = __int_as_float((int)(w >> 32));
    if (low == 0) {  // the carried-in reach: no hit
        tri_out[i] = -1;
        b1_out[i] = 0.0f;
        b2_out[i] = 0.0f;
        return;
    }
    const int p = seg[i / RAY_TILE] + (int)((low - 1) >> 8);
    const int j = (int)((low - 1) & (TREELET - 1));
    const int wt = tre[p];
    const float4* a4 = reinterpret_cast<const float4*>(inst_a) + (size_t)ti_inst[wt] * 4;
    const float4 a[4] = {a4[0], a4[1], a4[2], a4[3]};
    const float4* row =
        reinterpret_cast<const float4*>(coef) + ((size_t)ti_obj[wt] * TREELET + j) * 3;
    float t, u, v;
    hit_inst(object_ray(o, d, i, a), row[0], row[1], row[2], t, u, v);
    tri_out[i] = wt * TREELET + j;
    b1_out[i] = u;
    b2_out[i] = v;
}

__global__ void __launch_bounds__(THREADS, 2)
occlusion_inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax_in, const int* __restrict__ tre,
                      const int* __restrict__ tn_bits, const int* __restrict__ tile_of,
                      const int* __restrict__ order, const int* __restrict__ ti_obj,
                      const int* __restrict__ ti_inst, const float* __restrict__ coef,
                      const float* __restrict__ inst_a, int* occ) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ float4 s_a[4];
    const int p = order[blockIdx.x];
    const int tn = tn_bits[p];
    const int64_t r = (int64_t)tile_of[p] * RAY_TILE + 2 * threadIdx.x;
    const float tmax[2] = {tmax_in[r], tmax_in[r + 1]};
    // unoccluded lanes that reach past the pair's entry distance
    bool live[2] = {__ldcg(occ + r) == 0 && tn < __float_as_int(tmax[0]),
                    __ldcg(occ + r + 1) == 0 && tn < __float_as_int(tmax[1])};
    if (!__syncthreads_or(live[0] || live[1])) return;
    stage(s_coef, s_a, coef, inst_a, ti_obj, ti_inst, tre[p]);
    if (!__any_sync(FULL, live[0] || live[1])) return;
    Ray4 ray[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) ray[k] = object_ray(o, d, r + k, s_a);
    const float t_hi[2] = {__fmul_rn(tmax[0], PRE_T), __fmul_rn(tmax[1], PRE_T)};
#pragma unroll 2
    for (int j = 0; j < TREELET; ++j) {
        const float4 pn = s_coef[3 * j], pu = s_coef[3 * j + 1], pv = s_coef[3 * j + 2];
        // & and not &&: both sides evaluated, no branch per lane
        const bool m[2] = {static_cast<bool>(live[0] & may_hit(ray[0], pn, pu, pv, t_hi[0])),
                           static_cast<bool>(live[1] & may_hit(ray[1], pn, pu, pv, t_hi[1]))};
        if (__any_sync(FULL, m[0] || m[1])) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                float t, u, v;
                if (m[k] && hit_inst(ray[k], pn, pu, pv, t, u, v) && t < tmax[k]) {
                    occ[r + k] = 1;
                    live[k] = false;
                }
            }
            // the warp leaves once all its lanes are occluded
            if (!__any_sync(FULL, live[0] || live[1])) break;
        }
    }
}

// may_hit alone: out[r * 256 + j] = 1 where ray r, moved into object space
// by the instance matrix a (4 x 4), may hit row j of one treelet's
// coefficients (256 x 12), with the far limit t_far[r] * PRE_T. A
// diagnostic, for the check against its PyTorch mirror
// (sweep_inst.may_hit_plain): the sweeps never launch it.
__global__ void pretest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                               const float* __restrict__ t_far, const float* __restrict__ coef,
                               const float* __restrict__ inst_a, unsigned char* __restrict__ out,
                               int64_t n) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n * TREELET) return;
    const int64_t r = i / TREELET;
    const float4* a4 = reinterpret_cast<const float4*>(inst_a);
    const float4 a[4] = {a4[0], a4[1], a4[2], a4[3]};
    const float4* row = reinterpret_cast<const float4*>(coef) + 3 * (i % TREELET);
    out[i] = may_hit(object_ray(o, d, r, a), row[0], row[1], row[2],
                     __fmul_rn(t_far[r], PRE_T));
}

inline unsigned elementwise_blocks(int64_t n) {
    return (unsigned)((n + ELEMWISE_THREADS - 1) / ELEMWISE_THREADS);
}

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = cudaSuccess).
// seg: (n_tiles + 1,) segment starts; tile_of, order: (n_pairs,) from the
// wrapper's schedule; best: (n_tiles * 1024,) 64-bit scratch.
int hikari_closest_inst(const float* o, const float* d, const float* t_in, const int* tre,
                        const int* tn_bits, const int* seg, const int* tile_of,
                        const int* order, const int* ti_obj, const int* ti_inst,
                        const float* coef, const float* inst_a, unsigned long long* best,
                        float* t_out, int* tri_out, float* b1_out, float* b2_out, int n_tiles,
                        int n_pairs, cudaStream_t stream) {
    const int64_t n = (int64_t)n_tiles * RAY_TILE;
    init_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(t_in, best, n);
    if (n_pairs > 0)
        closest_inst_kernel<<<n_pairs, THREADS, 0, stream>>>(
            o, d, tre, tn_bits, seg, tile_of, order, ti_obj, ti_inst, coef, inst_a, best);
    decode_best<<<elementwise_blocks(n), ELEMWISE_THREADS, 0, stream>>>(
        best, o, d, tre, seg, ti_obj, ti_inst, coef, inst_a, t_out, tri_out, b1_out, b2_out,
        n);
    return (int)cudaGetLastError();
}

// occ holds the carried-in flags and is updated in place.
int hikari_occlusion_inst(const float* o, const float* d, const float* tmax, const int* tre,
                          const int* tn_bits, const int* tile_of, const int* order,
                          const int* ti_obj, const int* ti_inst, const float* coef,
                          const float* inst_a, int* occ, int n_pairs, cudaStream_t stream) {
    if (n_pairs > 0)
        occlusion_inst_kernel<<<n_pairs, THREADS, 0, stream>>>(
            o, d, tmax, tre, tn_bits, tile_of, order, ti_obj, ti_inst, coef, inst_a, occ);
    return (int)cudaGetLastError();
}

// The pre-test alone: see pretest_kernel. coef: one treelet (256 x 12);
// inst_a: one instance matrix (4 x 4); out: (n, 256) bytes.
int hikari_pretest_inst(const float* o, const float* d, const float* t_far, const float* coef,
                        const float* inst_a, unsigned char* out, int64_t n,
                        cudaStream_t stream) {
    if (n > 0)
        pretest_kernel<<<elementwise_blocks(n * TREELET), ELEMWISE_THREADS, 0, stream>>>(
            o, d, t_far, coef, inst_a, out, n);
    return (int)cudaGetLastError();
}

// Registers a thread, local (spill) bytes a thread and resident blocks per
// SM of the two sweep kernels, into out[0..2] (closest) and out[3..5]
// (occlusion).
int hikari_inst_attributes(int* out) {
    const void* kernels[2] = {reinterpret_cast<const void*>(closest_inst_kernel),
                              reinterpret_cast<const void*>(occlusion_inst_kernel)};
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

}  // extern "C"
