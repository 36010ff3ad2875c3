// ZSobol sampler (pbrt-v4 ZSobolSampler) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws these samples in XLA ops
// (hikari_tpu/sampling/sobol.py), and the port's plain version,
// hikari_tpu_torch/sampling/sobol.py, runs the same steps as eager int64
// tensor operations, a few hundred launches for each dimension drawn. This
// kernel draws up to eight scrambled dimensions of one sampler call in one
// launch; sobol.py states the contract and holds the plain version that it
// equals bit for bit.
//
// What bounds it. Integer instructions: a lane reads its pixel and sample
// index (24 bytes) once and writes 4 bytes a dimension, but a dimension
// costs a MixBits (two 64-bit multiplies) for each base-4 digit of the
// Morton index and the FastOwen scramble, and a Sobol dimension 1 draw a
// pass over up to 52 generator-matrix rows: some 600 32-bit instructions a
// dimension at 1280x720 and 256 spp.
//
// What the design does about it: one thread a lane, everything in
// registers; the Morton index is formed once for all dimensions; the 24
// base-4 digit permutations are three 64-bit words in the instruction
// stream (a lane's permutation index differs from its neighbours', which a
// table in constant memory would serialise); Sobol dimension 0's matrix is
// the bit reversal (its rows are 1 << (31 - b), then 0), which FastOwen's
// first reversal undoes, so its draws read no row; the rows of dimension 1
// are in constant memory, read by every lane of a warp at the same
// address; reverse_bits32 is __brev. Every step is the plain version's, on
// uint64_t where that keeps int64 bits.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxDraws = 8;
constexpr int kMatrixSize = 52;
constexpr int kThreads = 256;
constexpr float kOneMinusEpsilon = 0x1.fffffep-1f;

// One scrambled dimension to draw: ZSobol dimension, Sobol dimension of the
// generator matrix (0 or 1), the 32-bit FastOwen seed, and where its value
// for lane i goes: out[i * stride].
struct Draw {
    unsigned long long dim;
    unsigned int seed;
    int sobol_dim;
    float* out;
    long long stride;
};

struct Draws {
    Draw d[kMaxDraws];
    int k;
};

// Generator matrix of Sobol dimension 1 (sobol_matrices_32.npy, row 1,
// columns [0, 52)).
__constant__ uint32_t kRows1[kMatrixSize] = {
    0x80000000u, 0xc0000000u, 0xa0000000u, 0xf0000000u, 0x88000000u, 0xcc000000u,
    0xaa000000u, 0xff000000u, 0x80800000u, 0xc0c00000u, 0xa0a00000u, 0xf0f00000u,
    0x88880000u, 0xcccc0000u, 0xaaaa0000u, 0xffff0000u, 0x80008000u, 0xc000c000u,
    0xa000a000u, 0xf000f000u, 0x88008800u, 0xcc00cc00u, 0xaa00aa00u, 0xff00ff00u,
    0x80808080u, 0xc0c0c0c0u, 0xa0a0a0a0u, 0xf0f0f0f0u, 0x88888888u, 0xccccccccu,
    0xaaaaaaaau, 0xffffffffu, 0x80000000u, 0xc0000000u, 0xa0000000u, 0xf0000000u,
    0x88000000u, 0xcc000000u, 0xaa000000u, 0xff000000u, 0x80800000u, 0xc0c00000u,
    0xa0a00000u, 0xf0f00000u, 0x88880000u, 0xcccc0000u, 0xaaaa0000u, 0xffff0000u,
    0x80008000u, 0xc000c000u, 0xa000a000u, 0xf000f000u};

// The 24 permutations of a base-4 digit (sobol.py _PERMUTATIONS), entry
// (p, d) in bits 2e and 2e + 1 of word e / 32, e = 4p + d.
constexpr unsigned char kPermutations[24][4] = {
    {0, 1, 2, 3}, {0, 1, 3, 2}, {0, 2, 1, 3}, {0, 2, 3, 1}, {0, 3, 2, 1}, {0, 3, 1, 2},
    {1, 0, 2, 3}, {1, 0, 3, 2}, {1, 2, 0, 3}, {1, 2, 3, 0}, {1, 3, 2, 0}, {1, 3, 0, 2},
    {2, 1, 0, 3}, {2, 1, 3, 0}, {2, 0, 1, 3}, {2, 0, 3, 1}, {2, 3, 0, 1}, {2, 3, 1, 0},
    {3, 1, 2, 0}, {3, 1, 0, 2}, {3, 2, 1, 0}, {3, 2, 0, 1}, {3, 0, 2, 1}, {3, 0, 1, 2},
};

constexpr uint64_t pack_permutations(int word) {
    uint64_t w = 0;
    for (int e = 32 * word; e < 32 * word + 32; ++e)
        w |= uint64_t(kPermutations[e / 4][e % 4]) << (2 * (e % 32));
    return w;
}

constexpr uint64_t kPerm0 = 0xb1e19c6c78d8b4e4ull;
constexpr uint64_t kPerm1 = 0x72d236c68d2d39c9ull;
constexpr uint64_t kPerm2 = 0x93634b1b87271e4eull;
static_assert(kPerm0 == pack_permutations(0) && kPerm1 == pack_permutations(1) &&
                  kPerm2 == pack_permutations(2),
              "packed permutation words differ from the table");

__device__ __forceinline__ uint32_t permuted(uint32_t p, uint32_t digit) {
    const uint32_t e = 4 * p + digit;
    const uint64_t w = e < 32 ? kPerm0 : (e < 64 ? kPerm1 : kPerm2);
    return uint32_t(w >> (2 * (e & 31))) & 3u;
}

// hashes.shr: a logical shift that gives 0 from 64 bits on
__device__ __forceinline__ uint64_t shr(uint64_t x, int s) { return s >= 64 ? 0 : x >> s; }

// hashes.mix_bits
__device__ __forceinline__ uint64_t mix_bits(uint64_t v) {
    v ^= v >> 31;
    v *= 0x7FB5D329728EA185ull;
    v ^= v >> 27;
    v *= 0x81DADEF4BC2DD44Dull;
    return v ^ (v >> 33);
}

// sobol._spread32: the 32 bits of x on the even bits of 64
__device__ __forceinline__ uint32_t spread16(uint32_t v) {
    v &= 0xFFFFu;
    v = (v ^ (v << 8)) & 0x00FF00FFu;
    v = (v ^ (v << 4)) & 0x0F0F0F0Fu;
    v = (v ^ (v << 2)) & 0x33333333u;
    return (v ^ (v << 1)) & 0x55555555u;
}

__device__ __forceinline__ uint64_t spread32(uint32_t x) {
    return (uint64_t(spread16(x >> 16)) << 32) | spread16(x);
}

// hashes.fast_owen_scramble on 32-bit values, given its input bit-reversed
__device__ __forceinline__ uint32_t fast_owen_reversed(uint32_t v, uint32_t seed) {
    v ^= v * 0x3D20ADEAu;
    v += seed;
    v *= (seed >> 16) | 1u;
    v ^= v * 0x05526C56u;
    v ^= v * 0x53A22864u;
    return __brev(v);
}

__global__ void __launch_bounds__(kThreads)
    zsobol_kernel(const long long* __restrict__ px, long long px_stride,
                  const long long* __restrict__ py, long long py_stride,
                  const long long* __restrict__ si, long long si_stride, long long n,
                  int log2_spp, int n_digits, int max_bits, Draws draws) {
    const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
    if (i >= n) return;
    // sobol.morton_index
    const uint64_t morton =
        (((spread32(uint32_t(py[i * py_stride])) << 1) | spread32(uint32_t(px[i * px_stride])))
         << log2_spp) |
        uint32_t(si[i * si_stride]);
    const int pow2 = log2_spp & 1;
    const uint32_t low_mask = max_bits >= 32 ? ~0u : (1u << max_bits) - 1u;
#pragma unroll 1
    for (int j = 0; j < draws.k; ++j) {
        const Draw& d = draws.d[j];
        // sobol.zsobol_get_sample_index
        const uint64_t dim_mix = 0x55555555ull * d.dim;
        uint64_t index = 0;
        for (int q = n_digits - 1; q >= pow2; --q) {
            const int shift = max(0, 2 * q - pow2);
            const uint32_t digit = uint32_t(shr(morton, shift)) & 3u;
            const uint64_t h = mix_bits(shr(morton, shift + 2) ^ dim_mix);
            index |= uint64_t(permuted(uint32_t((h >> 24) % 24), digit)) << shift;
        }
        if (pow2) index |= (morton & 1) ^ (mix_bits(shr(morton, 1) ^ dim_mix) & 1);
        // sobol.sobol_sample_u32, bit-reversed as FastOwen first takes it: dimension
        // 0's rows (1 << (31 - b), then 0) make its value the reversal of the low
        // min(max_bits, 32) bits of index
        uint32_t reversed = uint32_t(index) & low_mask;
        if (d.sobol_dim == 1) {
            uint32_t v = 0;
            for (int b = 0; b < max_bits; ++b)
                v ^= kRows1[b] & (0u - (uint32_t(index >> b) & 1u));
            reversed = __brev(v);
        }
        // sobol._finalize: the float nearest to the scrambled value, times 2^-32
        // (exact), clamped
        const uint32_t v = fast_owen_reversed(reversed, d.seed);
        const float u = __fmul_rn(__uint2float_rn(v), 0x1p-32f);
        d.out[i * d.stride] = fminf(u, kOneMinusEpsilon);
    }
}

}  // namespace

extern "C" {

// Draws k (<= 8) dimensions for n lanes (the arguments of zsobol_kernel;
// draw j from dims[j], sobol_dims[j], seeds[j] into outs[j] with stride
// out_strides[j]; these four arrays are host memory). Returns
// cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for arguments the kernel does not take.
int hikari_zsobol(const long long* px, long long px_stride, const long long* py,
                  long long py_stride, const long long* si, long long si_stride, long long n,
                  int log2_spp, int n_digits, int max_bits, int k,
                  const unsigned long long* dims, const int* sobol_dims,
                  const unsigned int* seeds, float* const* outs, const long long* out_strides,
                  cudaStream_t stream) {
    if (k < 1 || k > kMaxDraws || n < 0 || log2_spp < 0 || log2_spp >= 64 || n_digits < 0 ||
        n_digits > 32 || max_bits < 0 || max_bits > kMatrixSize)
        return cudaErrorInvalidValue;
    Draws draws{};
    draws.k = k;
    for (int j = 0; j < k; ++j) {
        if (sobol_dims[j] != 0 && sobol_dims[j] != 1) return cudaErrorInvalidValue;
        draws.d[j] = Draw{dims[j], seeds[j], sobol_dims[j], outs[j], out_strides[j]};
    }
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    zsobol_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(px, px_stride, py, py_stride, si,
                                                              si_stride, n, log2_spp, n_digits,
                                                              max_bits, draws);
    return cudaGetLastError();
}

// {registers a thread, spill bytes a thread (local memory), resident blocks
// per SM} of zsobol_kernel, as the CUDA runtime reports them.
int hikari_zsobol_attributes(int* out) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, zsobol_kernel);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, zsobol_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    out[0] = attr.numRegs;
    out[1] = int(attr.localSizeBytes);
    out[2] = blocks;
    return cudaSuccess;
}

}  // extern "C"
