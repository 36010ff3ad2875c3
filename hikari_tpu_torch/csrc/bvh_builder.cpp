// Native binned-SAH BVH builder (skip-link flat layout).
//
// Drop-in replacement for the numpy builder in geometry/bvh.py — the
// reference delegates BVH construction to a native package (Raycore.jl);
// this is our equivalent native runtime component. Called through ctypes;
// see geometry/bvh.py for the loader and the layout contract:
//   nodes in DFS pre-order; count==0 marks interior nodes; traversal
//   visits i+1 on hit and jumps to skip[i] on miss.
//
// Build: g++ -O3 -march=native -shared -fPIC bvh_builder.cpp -o libbvh.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct Node {
    float lo[3], hi[3];
    int32_t first, count;
    int64_t size;  // subtree size, patched post-build
};

struct Builder {
    const float* plo;
    const float* phi;
    std::vector<float> cent;   // (n, 3)
    std::vector<int32_t> idx;  // permutation being partitioned in place
    std::vector<Node> nodes;
    int leaf_size;

    void grow(int32_t begin, int32_t end, float* lo, float* hi) const {
        for (int k = 0; k < 3; ++k) {
            lo[k] = std::numeric_limits<float>::infinity();
            hi[k] = -std::numeric_limits<float>::infinity();
        }
        for (int32_t i = begin; i < end; ++i) {
            const float* l = plo + 3 * idx[i];
            const float* h = phi + 3 * idx[i];
            for (int k = 0; k < 3; ++k) {
                lo[k] = std::min(lo[k], l[k]);
                hi[k] = std::max(hi[k], h[k]);
            }
        }
    }

    // returns subtree size
    int64_t emit(int32_t begin, int32_t end) {
        size_t my = nodes.size();
        nodes.push_back(Node{});
        Node& n0 = nodes[my];
        grow(begin, end, n0.lo, n0.hi);
        n0.first = begin;
        n0.count = 0;

        int32_t cnt = end - begin;
        if (cnt <= leaf_size) {
            nodes[my].count = cnt;
            nodes[my].size = 1;
            return 1;
        }

        // centroid bounds
        double c_lo[3], c_hi[3];
        for (int k = 0; k < 3; ++k) {
            c_lo[k] = std::numeric_limits<double>::infinity();
            c_hi[k] = -std::numeric_limits<double>::infinity();
        }
        for (int32_t i = begin; i < end; ++i) {
            const float* c = cent.data() + 3 * idx[i];
            for (int k = 0; k < 3; ++k) {
                c_lo[k] = std::min(c_lo[k], (double)c[k]);
                c_hi[k] = std::max(c_hi[k], (double)c[k]);
            }
        }
        int axis = 0;
        double ext = -1;
        for (int k = 0; k < 3; ++k) {
            double e = c_hi[k] - c_lo[k];
            if (e > ext) { ext = e; axis = k; }
        }

        int32_t mid;
        if (ext < 1e-12) {
            mid = begin + cnt / 2;  // degenerate: index median
        } else {
            // binned SAH
            double scale = N_BINS * (1.0 - 1e-6) / ext;
            int32_t bin_count[N_BINS] = {0};
            double bin_lo[N_BINS][3], bin_hi[N_BINS][3];
            for (int b = 0; b < N_BINS; ++b)
                for (int k = 0; k < 3; ++k) {
                    bin_lo[b][k] = std::numeric_limits<double>::infinity();
                    bin_hi[b][k] = -std::numeric_limits<double>::infinity();
                }
            auto bin_of = [&](int32_t prim) {
                double c = cent[3 * prim + axis];
                int b = (int)((c - c_lo[axis]) * scale);
                return std::min(std::max(b, 0), N_BINS - 1);
            };
            for (int32_t i = begin; i < end; ++i) {
                int b = bin_of(idx[i]);
                ++bin_count[b];
                const float* l = plo + 3 * idx[i];
                const float* h = phi + 3 * idx[i];
                for (int k = 0; k < 3; ++k) {
                    bin_lo[b][k] = std::min(bin_lo[b][k], (double)l[k]);
                    bin_hi[b][k] = std::max(bin_hi[b][k], (double)h[k]);
                }
            }
            auto half_area = [](const double lo[3], const double hi[3]) {
                double d0 = std::max(hi[0] - lo[0], 0.0);
                double d1 = std::max(hi[1] - lo[1], 0.0);
                double d2 = std::max(hi[2] - lo[2], 0.0);
                return d0 * d1 + d1 * d2 + d2 * d0;
            };
            double area_l[N_BINS], area_r[N_BINS];
            {
                double rl[3], rh[3];
                for (int k = 0; k < 3; ++k) { rl[k] = bin_lo[0][k]; rh[k] = bin_hi[0][k]; }
                area_l[0] = half_area(rl, rh);
                for (int b = 1; b < N_BINS; ++b) {
                    for (int k = 0; k < 3; ++k) {
                        rl[k] = std::min(rl[k], bin_lo[b][k]);
                        rh[k] = std::max(rh[k], bin_hi[b][k]);
                    }
                    area_l[b] = half_area(rl, rh);
                }
                for (int k = 0; k < 3; ++k) { rl[k] = bin_lo[N_BINS-1][k]; rh[k] = bin_hi[N_BINS-1][k]; }
                area_r[N_BINS - 1] = half_area(rl, rh);
                for (int b = N_BINS - 2; b >= 0; --b) {
                    for (int k = 0; k < 3; ++k) {
                        rl[k] = std::min(rl[k], bin_lo[b][k]);
                        rh[k] = std::max(rh[k], bin_hi[b][k]);
                    }
                    area_r[b] = half_area(rl, rh);
                }
            }
            int best = -1;
            double best_cost = std::numeric_limits<double>::infinity();
            int64_t n_l = 0;
            for (int b = 0; b < N_BINS - 1; ++b) {
                n_l += bin_count[b];
                int64_t n_r = cnt - n_l;
                if (n_l == 0 || n_r == 0) continue;
                double cost = 2.0 * (area_l[b] * n_l + area_r[b + 1] * n_r);
                if (cost < best_cost) { best_cost = cost; best = b; }
            }
            if (best < 0) {
                // all in one bin: centroid median split
                std::nth_element(
                    idx.begin() + begin, idx.begin() + begin + cnt / 2,
                    idx.begin() + end,
                    [&](int32_t a, int32_t b) {
                        return cent[3 * a + axis] < cent[3 * b + axis];
                    });
                mid = begin + cnt / 2;
            } else {
                auto it = std::partition(
                    idx.begin() + begin, idx.begin() + end,
                    [&](int32_t prim) { return bin_of(prim) <= best; });
                mid = (int32_t)(it - idx.begin());
                if (mid == begin || mid == end) mid = begin + cnt / 2;
            }
        }

        int64_t sl = emit(begin, mid);
        int64_t sr = emit(mid, end);
        nodes[my].size = 1 + sl + sr;
        return nodes[my].size;
    }
};

}  // namespace

extern "C" {

// Returns node count, or -1 if out_capacity is too small (call again with a
// larger buffer). Outputs: lo/hi (cap,3) f32, first/count/skip (cap,) i32,
// prim_order (n,) i32.
int64_t hikari_build_bvh(
    const float* prim_lo, const float* prim_hi, int64_t n, int32_t leaf_size,
    float* out_lo, float* out_hi, int32_t* out_first, int32_t* out_count,
    int32_t* out_skip, int32_t* out_order, int64_t out_capacity) {
    Builder b;
    b.plo = prim_lo;
    b.phi = prim_hi;
    b.leaf_size = leaf_size;
    b.cent.resize(3 * n);
    for (int64_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k)
            b.cent[3 * i + k] = 0.5f * (prim_lo[3 * i + k] + prim_hi[3 * i + k]);
    b.idx.resize(n);
    for (int64_t i = 0; i < n; ++i) b.idx[i] = (int32_t)i;
    b.nodes.reserve(2 * n);
    b.emit(0, (int32_t)n);

    int64_t n_nodes = (int64_t)b.nodes.size();
    if (n_nodes > out_capacity) return -1;
    for (int64_t i = 0; i < n_nodes; ++i) {
        const Node& nd = b.nodes[i];
        std::memcpy(out_lo + 3 * i, nd.lo, 12);
        std::memcpy(out_hi + 3 * i, nd.hi, 12);
        out_first[i] = nd.first;
        out_count[i] = nd.count;
        out_skip[i] = (int32_t)(i + nd.size);
    }
    std::memcpy(out_order, b.idx.data(), n * 4);
    return n_nodes;
}

}  // extern "C"
