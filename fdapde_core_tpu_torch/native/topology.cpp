// Native host-side mesh topology kernel (a copy of the JAX package's
// native/topology.cpp).
//
// First-encounter unique numbering of sub-simplex keys: the exact semantics
// of the reference's hash-map edge/face extraction
// (fdaPDE-core's fdaPDE/geometry/triangulation.h:167-191) — ids are
// assigned 0,1,2,... in order of first appearance while scanning rows.
//
// The NumPy fallback (sort-based np.unique) is O(n log n) with several
// large temporaries; this open-addressing hash pass is O(n) and runs ~10x
// faster on 10M+-cell meshes, which matters because topology extraction is
// the dominant host preprocessing cost.
//
// Plain C ABI for ctypes binding; no Python.h dependency.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t hash_row(const int32_t* row, int k) {
    // FNV-1a over the k int32 components
    uint64_t h = 1469598103934665603ull;
    for (int i = 0; i < k; ++i) {
        uint64_t v = static_cast<uint32_t>(row[i]);
        for (int b = 0; b < 4; ++b) {
            h ^= (v >> (8 * b)) & 0xff;
            h *= 1099511628211ull;
        }
    }
    return h;
}

inline bool row_eq(const int32_t* a, const int32_t* b, int k) {
    return std::memcmp(a, b, sizeof(int32_t) * k) == 0;
}

}  // namespace

extern "C" {

// keys: (n_rows, k) int32, rows assumed already normalized (sorted within
// row by the caller). Outputs:
//   ids:  (n_rows,) int32 — id of each row (first-encounter numbering)
//   uniq: (n_rows, k) int32 buffer — unique rows, in id order (first
//         n_uniq rows valid)
// Returns n_uniq (>= 0) or -1 on failure.
int64_t first_encounter_unique(const int32_t* keys, int64_t n_rows, int32_t k,
                               int32_t* ids, int32_t* uniq) {
    if (n_rows <= 0) return 0;
    // open-addressing table of slots -> row id; capacity = power of two >= 2n
    uint64_t cap = 16;
    while (cap < static_cast<uint64_t>(2 * n_rows)) cap <<= 1;
    std::vector<int32_t> table(cap, -1);
    const uint64_t mask = cap - 1;

    int32_t n_uniq = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
        const int32_t* row = keys + r * k;
        uint64_t slot = hash_row(row, k) & mask;
        for (;;) {
            int32_t occupant = table[slot];
            if (occupant < 0) {  // new key: assign the next id
                table[slot] = n_uniq;
                std::memcpy(uniq + static_cast<int64_t>(n_uniq) * k, row,
                            sizeof(int32_t) * k);
                ids[r] = n_uniq;
                ++n_uniq;
                break;
            }
            if (row_eq(uniq + static_cast<int64_t>(occupant) * k, row, k)) {
                ids[r] = occupant;
                break;
            }
            slot = (slot + 1) & mask;
        }
    }
    return n_uniq;
}

// Sorted-row normalization helper: sorts each row of (n_rows, k) in place.
void sort_rows(int32_t* keys, int64_t n_rows, int32_t k) {
    for (int64_t r = 0; r < n_rows; ++r) {
        int32_t* row = keys + r * k;
        // insertion sort: k <= 4
        for (int i = 1; i < k; ++i) {
            int32_t v = row[i];
            int j = i - 1;
            while (j >= 0 && row[j] > v) {
                row[j + 1] = row[j];
                --j;
            }
            row[j + 1] = v;
        }
    }
}

}  // extern "C"
