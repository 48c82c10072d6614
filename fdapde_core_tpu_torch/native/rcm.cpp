// Native reverse Cuthill-McKee ordering.
//
// Same semantics as the NumPy/Python BFS in parallel/reorder.py
// (component seeds in min-degree order, neighbors visited in
// increasing-degree order — ties broken by index via stable sort, final
// order reversed), without the per-node Python interpreter cost: the
// pure-Python BFS is the bottleneck at multi-million-dof scales where the
// reordering feeds the banded (DIA/halo) solver formats.
//
// Plain C ABI for ctypes binding; no Python.h dependency.

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// indptr: (n+1,) int64 CSR row pointers of the symmetrized adjacency
// (no self loops); indices: int64 column ids; perm_out: (n,) int64,
// perm_out[new] = old. Returns n on success.
int64_t rcm_order(const int64_t* indptr, const int64_t* indices, int64_t n,
                  int64_t* perm_out) {
    std::vector<uint8_t> visited(static_cast<size_t>(n), 0);
    std::vector<int64_t> seeds(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; ++i) seeds[static_cast<size_t>(i)] = i;
    auto degree = [&](int64_t u) { return indptr[u + 1] - indptr[u]; };
    std::stable_sort(seeds.begin(), seeds.end(),
                     [&](int64_t a, int64_t b) { return degree(a) < degree(b); });

    int64_t pos = 0;
    std::vector<int64_t> nbrs;
    for (int64_t s : seeds) {
        if (visited[static_cast<size_t>(s)]) continue;
        visited[static_cast<size_t>(s)] = 1;
        perm_out[pos++] = s;
        int64_t head = pos - 1;
        while (head < pos) {
            int64_t u = perm_out[head++];
            nbrs.clear();
            for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
                int64_t v = indices[e];
                if (!visited[static_cast<size_t>(v)]) {
                    visited[static_cast<size_t>(v)] = 1;
                    nbrs.push_back(v);
                }
            }
            std::stable_sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
                return degree(a) < degree(b);
            });
            for (int64_t v : nbrs) perm_out[pos++] = v;
        }
    }
    std::reverse(perm_out, perm_out + n);  // reverse CM
    return pos;
}

}  // extern "C"
