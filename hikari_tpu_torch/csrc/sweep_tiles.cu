// Treelet sweeps of the packet traversal's default mode, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the main path:
//   hikari_closest_tiles   <- _closest_tiles_kernel   (hikari_tpu/geometry/wavefront.py:999)
//   hikari_occlusion_tiles <- _occlusion_tiles_kernel (hikari_tpu/geometry/wavefront.py:1052)
// both launched there by _sweep_tiles (wavefront.py:1098). The contract is
// stated in hikari_tpu_torch/geometry/sweep.py, which also holds the plain
// PyTorch versions these kernels are checked against.
//
// What bounds them. The FP32 instruction rate: a (ray, triangle) test is
// the affine form's t, u, v (six 3-term dot products, ~40 FLOP) against 48
// bytes of shared memory read as warp broadcasts; device memory traffic is
// 12 KB of coefficients per swept pair and a carry word per lane. The TPU
// kernel walks a tile's pair segment in one grid step after another and
// splits the rays three ways into bf16 for its matrix unit; neither has a
// counterpart here.
//
// What the design does about it (csrc/sweep_grid.cuh holds the body and
// argues each point; csrc/sweep_pairs.cu is the same body with the pair-grid
// sweeps' test): the pair grid spreads a tile's segment over the SMs
// (one 1024-thread block per tile left a serial tail and one resident block
// per SM); 512 threads of two rays put two blocks on an SM and drop the
// block-wide max and its barriers; a divide-free FMA pre-test in two
// stages rejects almost every (ray, triangle), most after ~19 instructions,
// and only its few candidates go through LeanHit below, which alone
// decides. The closest sweep's winner is re-resolved exactly by the caller
// (_resolve_hits), so its t is only ever a sort key quantised to 2^-16.
//
// Build without --use_fast_math: the hit test relies on IEEE division and
// on NaN / inf from den == 0 failing every comparison.

#include "sweep_grid.cuh"

namespace {

using sweep_grid::add;
using sweep_grid::dot3;
using sweep_grid::EPS;
using sweep_grid::mul;
using sweep_grid::Ray;
using sweep_grid::T_MIN;

// The tile sweeps' test (_bw_block_lean and _hit_mask_lean,
// hikari_tpu/geometry/wavefront.py:738, 764): no den clamp; every
// operation rounded on its own, in the order of the plain version
// (sweep._block_hit). Its "+ 0.0" on the direction's dot products is left
// out: it can only turn a -0 into +0, which changes the sign of an infinite
// t or of a zero term, and neither passes or fails a compare for it.
struct LeanHit {
    static __device__ __forceinline__ bool test(const Ray& r, const float4& pn,
                                                const float4& pu, const float4& pv,
                                                float& t) {
        const float num = add(dot3(pn, r.ox, r.oy, r.oz), pn.w);
        t = __fdiv_rn(-num, dot3(pn, r.dx, r.dy, r.dz));
        const float u = add(add(dot3(pu, r.ox, r.oy, r.oz), pu.w),
                            mul(t, dot3(pu, r.dx, r.dy, r.dz)));
        const float v = add(add(dot3(pv, r.ox, r.oy, r.oz), pv.w),
                            mul(t, dot3(pv, r.dx, r.dy, r.dz)));
        const float w = add(1.0f + EPS, -add(u, v));
        // explicit compares: fminf would drop a NaN that must reject the hit
        return (u >= -EPS) && (v >= -EPS) && (w >= -EPS) && (t > T_MIN);
    }
};

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = cudaSuccess); the
// arguments are those of sweep_grid::launch_closest / launch_occlusion.
int hikari_closest_tiles(const float* o, const float* d, const int* key_in,
                         const int* tr_in, const int* tre, const int* tn_bits,
                         const int* seg, const int* tile_of, const int* order,
                         const float* coef, unsigned long long* best, int* key_out,
                         int* tr_out, int n_tiles, int n_pairs, cudaStream_t stream) {
    return sweep_grid::launch_closest<LeanHit>(o, d, key_in, tr_in, tre, tn_bits, seg, tile_of,
                                               order, coef, best, key_out, tr_out, n_tiles,
                                               n_pairs, stream);
}

int hikari_occlusion_tiles(const float* o, const float* d, const float* tmax, const int* tre,
                           const int* tn_bits, const int* tile_of, const int* order,
                           const float* coef, int* occ, int n_pairs, cudaStream_t stream) {
    return sweep_grid::launch_occlusion<LeanHit>(o, d, tmax, tre, tn_bits, tile_of, order, coef,
                                                 occ, n_pairs, stream);
}

int hikari_tiles_attributes(int* out) { return sweep_grid::grid_attributes<LeanHit>(out); }

// The pre-test of the grid sweeps (K1/K2 and K5/K6) alone: see
// sweep_grid::launch_pretest.
int hikari_pretest_grid(const float* o, const float* d, const float* t_far, const float* coef,
                        unsigned char* out, int64_t n, cudaStream_t stream) {
    return sweep_grid::launch_pretest(o, d, t_far, coef, out, n, stream);
}

}  // extern "C"
