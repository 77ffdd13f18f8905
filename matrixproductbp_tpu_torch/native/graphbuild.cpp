// Native graph preprocessing for matrixproductbp_tpu_torch (a copy of the
// JAX package's native/graphbuild.cpp, built by the port's own loader).
//
// The BP runtime addresses messages through dense padded index arrays
// (graph.py); building them in pure Python is O(E) interpreter work, which
// dominates setup at the 1e5-node scale target (BASELINE.md).  This module
// provides the edge-id/CSC construction and the BFS partitioner as a small
// C library consumed via ctypes (no pybind11 in the image).
//
// Layout contract (must match graph.py):
//   * directed edges sorted by (dst, src) — the reference's CSC walk order
//     (src/mpbp.jl:218-235)
//   * in_edges[i] = the contiguous id range of edges with dst == i, slots in
//     ascending-src order; padded with E
//   * rev_edge[e] = id of the opposite directed edge
//
// Build: at first use, by matrixproductbp_tpu_torch/native/__init__.py
// (g++ -O3 -shared -fPIC) into matrixproductbp_tpu_torch/_build/.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Compute per-node degrees from unique undirected pairs; returns dmax.
int mpbp_graph_degrees(int32_t n, int64_t m, const int32_t* u,
                       const int32_t* v, int32_t* degree) {
    std::memset(degree, 0, sizeof(int32_t) * n);
    for (int64_t k = 0; k < m; ++k) {
        degree[u[k]] += 1;
        degree[v[k]] += 1;
    }
    int32_t dmax = 0;
    for (int32_t i = 0; i < n; ++i) dmax = std::max(dmax, degree[i]);
    return dmax;
}

// Build the directed-edge arrays. Inputs: n nodes, m unique undirected pairs
// (u[k], v[k]). Outputs are caller-allocated:
//   edge_src[2m], edge_dst[2m], rev_edge[2m],
//   in_edges[n*dmax] (pad 2m), in_mask[n*dmax], nbr[n*dmax] (pad n),
//   degree[n].
void mpbp_graph_build(int32_t n, int64_t m, const int32_t* u, const int32_t* v,
                      int32_t dmax, int32_t* edge_src, int32_t* edge_dst,
                      int32_t* rev_edge, int32_t* in_edges, uint8_t* in_mask,
                      int32_t* nbr, int32_t* degree) {
    const int64_t E = 2 * m;
    // sort directed edges by key dst * n + src
    std::vector<int64_t> keys(E);
    for (int64_t k = 0; k < m; ++k) {
        keys[2 * k] = (int64_t)v[k] * n + u[k];       // u -> v
        keys[2 * k + 1] = (int64_t)u[k] * n + v[k];   // v -> u
    }
    std::sort(keys.begin(), keys.end());
    std::vector<int64_t> indptr(n + 1, 0);
    for (int64_t e = 0; e < E; ++e) {
        int32_t d = (int32_t)(keys[e] / n);
        int32_t s = (int32_t)(keys[e] % n);
        edge_src[e] = s;
        edge_dst[e] = d;
        indptr[d + 1] += 1;
    }
    for (int32_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
    // rev lookup: binary search inside the (sorted-by-src) bucket of dst
    for (int64_t e = 0; e < E; ++e) {
        int32_t s = edge_src[e], d = edge_dst[e];
        // find edge (d -> s): bucket of node s, src == d
        const int64_t lo = indptr[s], hi = indptr[s + 1];
        const int64_t key = (int64_t)s * n + d;
        const int64_t* b = keys.data();
        int64_t pos = std::lower_bound(b + lo, b + hi, key) - b;
        rev_edge[e] = (int32_t)pos;
    }
    // slots
    for (int32_t i = 0; i < n; ++i) {
        degree[i] = (int32_t)(indptr[i + 1] - indptr[i]);
        for (int32_t k = 0; k < dmax; ++k) {
            const int64_t idx = (int64_t)i * dmax + k;
            if (k < degree[i]) {
                const int64_t e = indptr[i] + k;
                in_edges[idx] = (int32_t)e;
                in_mask[idx] = 1;
                nbr[idx] = edge_src[e];
            } else {
                in_edges[idx] = (int32_t)E;
                in_mask[idx] = 0;
                nbr[idx] = n;
            }
        }
    }
}

// Greedy balanced BFS partitioning (mirrors parallel/partition.py).
void mpbp_partition(int32_t n, int64_t E, const int32_t* edge_src,
                    const int32_t* edge_dst, int32_t nparts,
                    const int32_t* order, int32_t* part) {
    // CSR over out-neighbors (use directed edges: dst lists)
    std::vector<int64_t> indptr(n + 1, 0);
    for (int64_t e = 0; e < E; ++e) indptr[edge_dst[e] + 1] += 1;
    for (int32_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
    std::vector<int32_t> adj(E);
    std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
    for (int64_t e = 0; e < E; ++e) adj[fill[edge_dst[e]]++] = edge_src[e];

    for (int32_t i = 0; i < n; ++i) part[i] = -1;
    const int32_t target = (n + nparts - 1) / nparts;
    int32_t p = 0, count = 0;
    std::queue<int32_t> q;
    for (int32_t oi = 0; oi < n; ++oi) {
        int32_t seed = order[oi];
        if (part[seed] >= 0) continue;
        q.push(seed);
        while (!q.empty() && count < target) {
            int32_t vtx = q.front();
            q.pop();
            if (part[vtx] >= 0) continue;
            part[vtx] = p;
            ++count;
            for (int64_t j = indptr[vtx]; j < indptr[vtx + 1]; ++j)
                if (part[adj[j]] < 0) q.push(adj[j]);
        }
        while (!q.empty()) q.pop();
        if (count >= target) {
            p = std::min(p + 1, nparts - 1);
            count = 0;
        }
    }
    for (int32_t i = 0; i < n; ++i)
        if (part[i] < 0) part[i] = nparts - 1;
}

}  // extern "C"
