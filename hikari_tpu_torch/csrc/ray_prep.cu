// The traversal driver's lane stage for Hopper (sm_90a): one launch a sweep.
//
// Replaces no TPU kernel: the JAX package runs this stage as XLA ops
// (hikari_tpu/geometry/wavefront.py: the world-exit clamp, the per-ray
// super-box pre-pass and ray_sort_keys), and the port's plain version,
// ray_prep_plain in hikari_tpu_torch/geometry/wavefront.py, as eager tensor
// operations: some 850 launches a sweep of 3.69 M lanes against 75 super
// boxes, most of them the pre-pass's (lanes, boxes, 3) temporaries. This
// kernel takes a lane's origin, direction, reach, activity and light group
// once, does every step in registers and writes the padded origin,
// direction, reach and sort key; wavefront.py states the contract, and the
// kernel equals the plain version bit for bit.
//
// What bounds it. FP32 operations: a lane with no early exit tests every
// super box, some 28 operations a box (two subtracts, two multiplies and a
// min and a max an axis, four reductions, the padded far distance and three
// compares), so 75 boxes at 3.69 M lanes are 7.7 G operations, over 132 SMs
// x 128 lanes x 1.98 GHz: <= 0.23 ms. Bytes: a lane reads 29-37 B (origin,
// direction, reach, activity, light group) and writes 36 (origin,
// direction, reach, int64 key), ~0.25 GB at 3.69 M lanes: ~0.08 ms at 3.35
// TB/s. The operations bind only while most lanes test most boxes.
//
// What the design does about it: one thread a lane; the super boxes are
// staged in shared memory in tiles of kBoxTile boxes (any number of tiles:
// bvh_super_boxes has no cap), which a warp reads at one address at a time;
// a lane stops at the first box that admits its segment, since the
// pre-pass is an OR, and a block stops loading tiles once none of its lanes
// is left to test; a lane whose reach is already +0 (inactive, or padding)
// tests no box. Bit for bit: every sum and product that torch rounds one
// operation at a time is a round-to-nearest intrinsic, never fused into an
// FMA; torch's scalar operands are the Python floats rounded to float32;
// 1.0 / x is the IEEE quotient; min and max propagate NaN as
// torch.minimum / amax do (the PTX .NaN forms), and a clamp keeps a NaN as
// torch.clamp does.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBoxTile = 128;  // super boxes a shared-memory tile

// the plain version's Python-float operands, as torch applies them to float32
constexpr float kFar = float(3.0e37);       // a non-finite reach
constexpr float kTinyD = float(1e-20);      // the smallest direction component
constexpr float kGrow = float(1.0001);
constexpr float kExitPad = float(1e-3);     // world-exit clamp
constexpr float kFarPad = float(1e-6);      // pre-pass: tn <= tf * 1.0001 + 1e-6
constexpr float kNear = float(1e-4);        // pre-pass: tf > 1e-4
constexpr float kReachPad = float(1e-4);    // pre-pass: tn <= t * 1.0001 + 1e-4
constexpr float kShrink = float(0.9999);    // a shadow ray's reach
constexpr float kMinExtent = float(1e-6);   // the world box's extent in the key
constexpr float kDirScale = 31.0f;          // direction Morton: 5 bits an axis
constexpr float kOrgScale = 63.0f;          // origin Morton: KEY_OBITS = 6 bits an axis
constexpr int kOriginBits = 18;             // 3 * KEY_OBITS
constexpr int kDirBits = 11;                // 29 - 18
constexpr long long kDeadKey = 0xFFFFFFFFll;
constexpr long long kMaxKey = 0xFFFFFFFEll;

__device__ __forceinline__ float min_nan(float a, float b) {
    float r;
    asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_keep_nan(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// x.long() & 0x3FF for x in [0, 63] or NaN: the truncation, and 0 for NaN,
// whose conversion keeps no low bits on the CPU or on the card
__device__ __forceinline__ uint32_t low_bits(float x) {
    return isnan(x) ? 0u : uint32_t((long long)x) & 0x3FFu;
}

// wavefront._morton10: 10 bits spread to 30
__device__ __forceinline__ uint32_t morton10(uint32_t x) {
    x &= 0x3FFu;
    x = (x | (x << 16)) & 0x030000FFu;
    x = (x | (x << 8)) & 0x0300F00Fu;
    x = (x | (x << 4)) & 0x030C30C3u;
    return (x | (x << 2)) & 0x09249249u;
}

// 1.0 / where(|d| < 1e-20, 1e-20, d) (the world-exit clamp) or, with sign,
// 1.0 / where(|d| < 1e-20, where(d < 0, -1e-20, 1e-20), d) (the pre-pass)
__device__ __forceinline__ float inv_dir(float d, bool keep_sign) {
    const float small = keep_sign && d < 0.0f ? -kTinyD : kTinyD;
    return __fdiv_rn(1.0f, fabsf(d) < kTinyD ? small : d);
}

__global__ void __launch_bounds__(kThreads)
    ray_prep_kernel(const float* __restrict__ o_in, const float* __restrict__ d_in,
                    const float* __restrict__ t_in, const unsigned char* __restrict__ active,
                    const int* __restrict__ group32, const long long* __restrict__ group64,
                    const float* __restrict__ world_lo, const float* __restrict__ world_hi,
                    const float* __restrict__ sup_lo, const float* __restrict__ sup_hi,
                    int n_super, long long n, int occlusion, int reverse,
                    float* __restrict__ o_out, float* __restrict__ d_out,
                    float* __restrict__ t_out, long long* __restrict__ key_out) {
    __shared__ float box_lo[3][kBoxTile];
    __shared__ float box_hi[3][kBoxTile];
    // n_pad is a multiple of kThreads: every thread owns a lane, padding
    // lanes (i >= n) included, and all of them reach the block's barriers
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    const bool real = i < n;
    // wavefront._pad_rays: padding lanes have o 0, d 1 and reach 0
    float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {1.0f, 1.0f, 1.0f}, t = 0.0f;
    if (real) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            o[a] = o_in[3 * i + a];
            d[a] = d_in[3 * i + a];
        }
        t = t_in[i];
        if (!isfinite(t)) t = kFar;
        const bool inactive = active != nullptr && !active[i];
        if (occlusion) {
            // prepare_occlusion: the active mask, the reversed segment, then 0.9999
            if (inactive) t = 0.0f;
            if (reverse) {
#pragma unroll
                for (int a = 0; a < 3; ++a) {
                    o[a] = __fadd_rn(o[a], __fmul_rn(d[a], t));
                    d[a] = -d[a];
                }
            }
            t = __fmul_rn(t, kShrink);
        } else {
            // _world_exit_clamp, then the active mask
            float t_exit = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const float inv = inv_dir(d[a], false);
                const float ta = __fmul_rn(__fsub_rn(world_lo[a], o[a]), inv);
                const float tb = __fmul_rn(__fsub_rn(world_hi[a], o[a]), inv);
                const float leave = max_nan(ta, tb);
                t_exit = a == 0 ? leave : min_nan(t_exit, leave);
            }
            const float ahead = isnan(t_exit) ? t_exit : fmaxf(t_exit, 0.0f);
            t = min_nan(t, __fadd_rn(__fmul_rn(ahead, kGrow), kExitPad));
            if (inactive) t = 0.0f;
        }
    }

    // _ray_super_cull: the segment [o, o + t d] against each super box
    bool pending = n_super > 0 && real && __float_as_uint(t) != 0u;
    const bool tested = pending;
    float inv[3], reach = 0.0f;
    if (pending) {
#pragma unroll
        for (int a = 0; a < 3; ++a) inv[a] = inv_dir(d[a], true);
        reach = __fadd_rn(__fmul_rn(t, kGrow), kReachPad);
    }
    for (int base = 0; base < n_super; base += kBoxTile) {
        // a barrier before the tile is overwritten, and the block's early out
        if (!__syncthreads_or(pending)) break;
        const int count = min(kBoxTile, n_super - base);
        for (int k = threadIdx.x; k < 3 * count; k += kThreads) {
            const int b = k / 3, a = k - 3 * b;
            box_lo[a][b] = sup_lo[3LL * base + k];
            box_hi[a][b] = sup_hi[3LL * base + k];
        }
        __syncthreads();
        if (!pending) continue;
        for (int b = 0; b < count; ++b) {
            float tn = 0.0f, tf = 0.0f;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const float t0 = __fmul_rn(__fsub_rn(box_lo[a][b], o[a]), inv[a]);
                const float t1 = __fmul_rn(__fsub_rn(box_hi[a][b], o[a]), inv[a]);
                const float lo = min_nan(t0, t1), hi = max_nan(t0, t1);
                tn = a == 0 ? lo : max_nan(tn, lo);
                tf = a == 0 ? hi : min_nan(tf, hi);
            }
            if (tn <= __fadd_rn(__fmul_rn(tf, kGrow), kFarPad) && tf > kNear && tn <= reach) {
                pending = false;
                break;
            }
        }
    }
    // no box admits the segment: the pre-pass zeroes its reach
    if (tested && pending) t = 0.0f;

#pragma unroll
    for (int a = 0; a < 3; ++a) {
        o_out[3 * i + a] = o[a];
        d_out[3 * i + a] = d[a];
    }
    t_out[i] = t;
    if (key_out == nullptr) return;

    // ray_sort_keys, the light group ahead of it, the clamp; dead lanes last
    long long key = kDeadKey;
    if (t > 0.0f) {
        const uint32_t octant = uint32_t(d[0] < 0.0f) | (uint32_t(d[1] < 0.0f) << 1) |
                                (uint32_t(d[2] < 0.0f) << 2);
        uint32_t dm = 0, om = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            const float di = clamp_keep_nan(__fmul_rn(fabsf(d[a]), kDirScale), 0.0f, kDirScale);
            dm |= morton10(low_bits(di)) << a;
            const float ext_raw = __fsub_rn(world_hi[a], world_lo[a]);
            const float ext = isnan(ext_raw) ? ext_raw : fmaxf(ext_raw, kMinExtent);
            const float q = clamp_keep_nan(__fdiv_rn(__fsub_rn(o[a], world_lo[a]), ext), 0.0f,
                                           1.0f);
            om |= morton10(low_bits(__fmul_rn(q, kOrgScale))) << a;
        }
        dm >>= 15 - kDirBits;
        om &= (1u << kOriginBits) - 1u;
        long long k = ((long long)octant << 29) | ((long long)om << kDirBits) | dm;
        if (group64 != nullptr) k = ((group64[i] & 63) << 26) | (k >> 6);
        if (group32 != nullptr) k = (((long long)group32[i] & 63) << 26) | (k >> 6);
        key = k < kMaxKey ? k : kMaxKey;
    }
    key_out[i] = key;
}

}  // namespace

extern "C" {

// The lane stage of one sweep over n_pad lanes (a multiple of 1024; n of
// them real): the arguments of ray_prep_kernel. active (n bools), group32 /
// group64 (n light ids, at most one of them), sup_lo / sup_hi (n_super
// boxes) and key_out may be null.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int hikari_ray_prep(const float* o, const float* d, const float* t_max,
                    const unsigned char* active, const int* group32, const long long* group64,
                    const float* world_lo, const float* world_hi, const float* sup_lo,
                    const float* sup_hi, int n_super, long long n, long long n_pad,
                    int occlusion, int reverse, float* o_out, float* d_out, float* t_out,
                    long long* key_out, cudaStream_t stream) {
    if (n < 0 || n_pad < n || n_pad % 1024 != 0 || n_super < 0 ||
        (n_super > 0 && (sup_lo == nullptr || sup_hi == nullptr)) ||
        (group32 != nullptr && group64 != nullptr) || (reverse && !occlusion))
        return cudaErrorInvalidValue;
    const long long blocks = n_pad / kThreads;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    if (n_pad == 0) return cudaSuccess;
    ray_prep_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
        o, d, t_max, active, group32, group64, world_lo, world_hi, sup_lo, sup_hi, n_super, n,
        occlusion, reverse, o_out, d_out, t_out, key_out);
    return cudaGetLastError();
}

// {registers a thread, spill bytes a thread (local memory), resident blocks
// per SM} of ray_prep_kernel, as the CUDA runtime reports them.
int hikari_ray_prep_attributes(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, ray_prep_kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ray_prep_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = int(attr.localSizeBytes);
    out[2] = blocks;
    return cudaSuccess;
}

}  // extern "C"
