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
// Design: that of sweep_tiles.cu. One 1024-thread block per 1024-ray tile,
// one thread per ray, the whole wavefront in one launch; the block walks
// its tile's front-to-back segment of (tile, world treelet) pairs. Per pair
// it stages the shared object-space coefficient block coef[ti_obj[wt]]
// (256 x 12 float32, 12 KB) and the instance matrix inst_a[ti_inst[wt]]
// (4 x 4 float32, 64 B) in shared memory; every thread then moves its own
// ray into that instance's object space ([o,1] A and [d,0] A, once
// per pair since the instance changes from pair to pair) and reads each
// triangle row as a warp broadcast. Directions stay unnormalised, so the
// object-space t is the world t.
//
// Early-out. The TPU grid visits every pair and *skips* one whose entry
// distance bits reach the tile threshold (K3: max bits of the carried t;
// K4: max bits of tmax over unoccluded lanes). Along a segment the entry
// distances rise (the pair list is sorted front to back) and the threshold
// never rises (carried t only shrinks; lanes only become occluded), so once
// a pair is skipped every later pair of the segment is skipped too, and
// leaving the loop there is the same walk.
//
// Bound. ~50 float32 operations and one IEEE divide per (ray, triangle)
// against broadcast shared-memory reads, so the FP32 issue rate and the
// divide bound it; the per-pair transform adds 28 operations per ray, 1/256
// of a pair's triangle work. The TPU split the transformed rays three ways
// into bf16 in-kernel (instanced.py:119) only for its bf16 matrix unit; here
// the affine form is evaluated directly in float32.
//
// Rounding. Unlike the flat sweeps, whose winner is re-resolved exactly
// afterwards, the instanced hit record is the affine form's own t, u, v:
// near a surface n.o and dw cancel, and u = au + t bu amplifies any change
// in t by bu, which is large on small triangles. So every operation here is
// an explicitly rounded multiply or add (__fmul_rn / __fadd_rn: no FMA
// contraction) in the order of the plain PyTorch version, which makes the
// kernel and its plain version agree bit for bit. FMA contraction would
// save about a third of the arithmetic; it is left for a later version.
//
// Build without --use_fast_math: the hit test relies on IEEE division and on
// NaN / inf failing every comparison.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int RAY_TILE = 1024;
constexpr int TREELET = 256;
constexpr float EPS = 1e-6f;
constexpr float T_MIN = 1e-4f;
constexpr float DEN_MIN = 1e-20f;
constexpr float MISS_T = 3.0e38f;

// Block-wide max of an int over the 32 warps of a 1024-thread block; every
// thread returns the result.
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

// Copy world treelet wt's coefficient block and instance matrix into shared
// memory.
__device__ __forceinline__ void stage(float4* s_coef, float4* s_a, const float* coef,
                                      const float* inst_a, const int* ti_obj,
                                      const int* ti_inst, int wt) {
    const float4* src = reinterpret_cast<const float4*>(coef) + (size_t)ti_obj[wt] * TREELET * 3;
    for (int i = threadIdx.x; i < TREELET * 3; i += RAY_TILE) s_coef[i] = src[i];
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

__global__ void __launch_bounds__(RAY_TILE)
closest_inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ t_in, const int* __restrict__ tre,
                    const int* __restrict__ tn_bits, const int* __restrict__ seg,
                    const int* __restrict__ ti_obj, const int* __restrict__ ti_inst,
                    const float* __restrict__ coef, const float* __restrict__ inst_a,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ b1_out, float* __restrict__ b2_out) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ float4 s_a[4];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int64_t r = (int64_t)blockIdx.x * RAY_TILE + threadIdx.x;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    float t_best = t_in[r];
    int tri = -1;
    float b1 = 0.0f, b2 = 0.0f;
    int thr = block_max(__float_as_int(t_best), s_warp, &s_thr);
    const int end = seg[blockIdx.x + 1];
    // thr and p are uniform over the block: the barriers inside are safe,
    // and block_max's barriers order this pair's shared-memory reads before
    // the next stage() overwrites them
    for (int p = seg[blockIdx.x]; p < end && tn_bits[p] < thr; ++p) {
        const int wt = tre[p];
        stage(s_coef, s_a, coef, inst_a, ti_obj, ti_inst, wt);
        const Ray4 ray{xform_point(ox, oy, oz, s_a), xform_dir(dx, dy, dz, s_a)};
        float tb = MISS_T, ub = 0.0f, vb = 0.0f;
        int jb = 0;
#pragma unroll 4
        for (int j = 0; j < TREELET; ++j) {
            float t, u, v;
            // strict: the lowest column wins among equal t
            if (hit_inst(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t, u, v)
                && t < tb) {
                tb = t;
                ub = u;
                vb = v;
                jb = j;
            }
        }
        if (tb < t_best) {  // strict: an earlier treelet wins a tie
            t_best = tb;
            tri = wt * TREELET + jb;
            b1 = ub;
            b2 = vb;
        }
        thr = block_max(__float_as_int(t_best), s_warp, &s_thr);
    }
    t_out[r] = t_best;
    tri_out[r] = tri;
    b1_out[r] = b1;
    b2_out[r] = b2;
}

__global__ void __launch_bounds__(RAY_TILE)
occlusion_inst_kernel(const float* __restrict__ o, const float* __restrict__ d,
                      const float* __restrict__ tmax_in, const int* __restrict__ occ_in,
                      const int* __restrict__ tre, const int* __restrict__ tn_bits,
                      const int* __restrict__ seg, const int* __restrict__ ti_obj,
                      const int* __restrict__ ti_inst, const float* __restrict__ coef,
                      const float* __restrict__ inst_a, int* __restrict__ occ_out) {
    __shared__ float4 s_coef[TREELET * 3];
    __shared__ float4 s_a[4];
    __shared__ int s_warp[32];
    __shared__ int s_thr;
    const int64_t r = (int64_t)blockIdx.x * RAY_TILE + threadIdx.x;
    const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
    const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
    const float tmax = tmax_in[r];
    int occ = occ_in[r];
    // reach of the farthest unoccluded lane; bits(0.0f) = 0 once all are
    int thr = block_max(occ == 0 ? __float_as_int(tmax) : 0, s_warp, &s_thr);
    const int end = seg[blockIdx.x + 1];
    for (int p = seg[blockIdx.x]; p < end && tn_bits[p] < thr; ++p) {
        stage(s_coef, s_a, coef, inst_a, ti_obj, ti_inst, tre[p]);
        if (occ == 0) {
            const Ray4 ray{xform_point(ox, oy, oz, s_a), xform_dir(dx, dy, dz, s_a)};
            for (int j = 0; j < TREELET; ++j) {
                float t, u, v;
                if (hit_inst(ray, s_coef[3 * j], s_coef[3 * j + 1], s_coef[3 * j + 2], t, u, v)
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
int hikari_closest_inst(const float* o, const float* d, const float* t_in, const int* tre,
                        const int* tn_bits, const int* seg, const int* ti_obj,
                        const int* ti_inst, const float* coef, const float* inst_a,
                        float* t_out, int* tri_out, float* b1_out, float* b2_out,
                        int n_tiles, cudaStream_t stream) {
    closest_inst_kernel<<<n_tiles, RAY_TILE, 0, stream>>>(
        o, d, t_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a, t_out, tri_out,
        b1_out, b2_out);
    return (int)cudaGetLastError();
}

int hikari_occlusion_inst(const float* o, const float* d, const float* tmax,
                          const int* occ_in, const int* tre, const int* tn_bits,
                          const int* seg, const int* ti_obj, const int* ti_inst,
                          const float* coef, const float* inst_a, int* occ_out,
                          int n_tiles, cudaStream_t stream) {
    occlusion_inst_kernel<<<n_tiles, RAY_TILE, 0, stream>>>(
        o, d, tmax, occ_in, tre, tn_bits, seg, ti_obj, ti_inst, coef, inst_a, occ_out);
    return (int)cudaGetLastError();
}

}  // extern "C"
