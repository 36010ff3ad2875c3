// Pair-grid treelet sweeps of the packet traversal, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the pair-grid sweep mode:
//   hikari_closest_pairs   <- _closest_pairs_kernel   (hikari_tpu/geometry/wavefront.py:773)
//   hikari_occlusion_pairs <- _occlusion_pairs_kernel (hikari_tpu/geometry/wavefront.py:827)
// both launched there by _sweep_chunks (wavefront.py:907) under HIKARI_SWEEP=pairs.
// The contract and the plain PyTorch versions these kernels are checked
// against are in hikari_tpu_torch/geometry/sweep_pairs.py.
//
// The TPU's pair grid and the tile sweeps differ in their hit test only,
// once both run on the pair grid of csrc/sweep_grid.cuh (one 512-thread
// block of two rays a thread per (tile, treelet) pair, two blocks per SM,
// the 64-bit carry word keyed on the rank in the tile's segment, the
// divide-free pre-test in two stages). So this file is that body
// instantiated with PairHit, the clamped test below; the header argues the
// decomposition, the early-out and the word order (which also covers the
// second pass of the banded closest hit, whose carry holds hit keys).
//
// What bounds them: the FP32 instruction rate, as for sweep_tiles.cu (the
// same pre-test rejects almost every (ray, triangle); PairHit costs what
// LeanHit does on the few that pass). The TPU's PAIR_CHUNK chunking,
// padding repeats and dynamic grid were scalar-memory limits and have no
// counterpart here.
//
// The pre-test stays conservative for PairHit: a PairHit hit has |den| >
// 1e-20 and computes t, u and v as LeanHit does, and its u + v <= 1 + eps
// lies inside LeanHit's 1 + 2 eps, so it is a LeanHit hit
// (tests/test_torch_tiles.py holds the pre-test's mirror to both tests'
// hits, |den| at the clamp included).
//
// Build without --use_fast_math: the hit test relies on IEEE division and
// on NaN / inf failing every comparison.

#include "sweep_grid.cuh"

namespace {

using sweep_grid::add;
using sweep_grid::dot3;
using sweep_grid::EPS;
using sweep_grid::mul;
using sweep_grid::Ray;
using sweep_grid::T_MIN;

constexpr float DEN_MIN = 1e-20f;
constexpr float ONE_EPS = 1.0f + EPS;  // float32(1 + 1e-6), the plain version's bound

// _bw_block's test (hikari_tpu/geometry/wavefront.py:713, predicate :812):
// den clamped to 1e-20 where |den| < 1e-20; a hit needs |den| > 1e-20, u, v
// >= -eps, u + v <= 1 + eps and t > 1e-4. Every operation rounded on its
// own, in the order of the plain version (sweep_pairs._block_hit_pairs), so
// the kernels take exactly the plain version's hits; the TPU's approximate
// reciprocal with one Newton step is an IEEE divide.
struct PairHit {
    static __device__ __forceinline__ bool test(const Ray& r, const float4& pn,
                                                const float4& pu, const float4& pv,
                                                float& t) {
        const float num = add(dot3(pn, r.ox, r.oy, r.oz), pn.w);
        const float den = dot3(pn, r.dx, r.dy, r.dz);
        const float aden = fabsf(den);
        t = __fdiv_rn(-num, aden < DEN_MIN ? DEN_MIN : den);
        const float u = add(add(dot3(pu, r.ox, r.oy, r.oz), pu.w),
                            mul(t, dot3(pu, r.dx, r.dy, r.dz)));
        const float v = add(add(dot3(pv, r.ox, r.oy, r.oz), pv.w),
                            mul(t, dot3(pv, r.dx, r.dy, r.dz)));
        // explicit compares: a NaN must reject the hit
        return (aden > DEN_MIN) && (u >= -EPS) && (v >= -EPS) && (add(u, v) <= ONE_EPS)
               && (t > T_MIN);
    }
};

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after its launches (0 = cudaSuccess); the
// arguments are those of sweep_grid::launch_closest / launch_occlusion.
int hikari_closest_pairs(const float* o, const float* d, const int* key_in,
                         const int* tr_in, const int* tre, const int* tn_bits,
                         const int* seg, const int* tile_of, const int* order,
                         const float* coef, unsigned long long* best, int* key_out,
                         int* tr_out, int n_tiles, int n_pairs, cudaStream_t stream) {
    return sweep_grid::launch_closest<PairHit>(o, d, key_in, tr_in, tre, tn_bits, seg, tile_of,
                                               order, coef, best, key_out, tr_out, n_tiles,
                                               n_pairs, stream);
}

int hikari_occlusion_pairs(const float* o, const float* d, const float* tmax, const int* tre,
                           const int* tn_bits, const int* tile_of, const int* order,
                           const float* coef, int* occ, int n_pairs, cudaStream_t stream) {
    return sweep_grid::launch_occlusion<PairHit>(o, d, tmax, tre, tn_bits, tile_of, order, coef,
                                                 occ, n_pairs, stream);
}

int hikari_pairs_attributes(int* out) { return sweep_grid::grid_attributes<PairHit>(out); }

}  // extern "C"
