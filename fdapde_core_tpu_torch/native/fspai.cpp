// Native FSPAI: factorized sparse approximate inverse of an SPD matrix (a
// copy of the JAX package's native/fspai.cpp).
//
// Same algorithm as linear_algebra/fspai.py (the reference's K-condition
// minimization with adaptive sparsity, fdaPDE/linear_algebra/fspai.h:42-271):
// per column k, `alpha` pattern-update steps each admitting up to `beta`
// candidates with tau > epsilon. The Python/NumPy version spends its time in
// per-column fancy-indexed solves; this version works on CSR arrays with
// dense scratch buffers and a small Cholesky, ~100x faster at n ~ 10^5.
//
// Plain C ABI for ctypes; CSR input (SPD, full pattern), COO output of the
// lower-triangular factor L with L L^T ~= A^{-1}.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// dense Cholesky solve of S y = b for small m x m S (row-major, overwritten)
bool chol_solve(std::vector<double>& S, std::vector<double>& y, int m) {
    // factorize S = L L^T in place (lower)
    for (int i = 0; i < m; ++i) {
        for (int j = 0; j <= i; ++j) {
            double sum = S[i * m + j];
            for (int p = 0; p < j; ++p) sum -= S[i * m + p] * S[j * m + p];
            if (i == j) {
                if (sum <= 0) return false;
                S[i * m + j] = std::sqrt(sum);
            } else {
                S[i * m + j] = sum / S[j * m + j];
            }
        }
    }
    // forward substitution L z = b
    for (int i = 0; i < m; ++i) {
        double sum = y[i];
        for (int p = 0; p < i; ++p) sum -= S[i * m + p] * y[p];
        y[i] = sum / S[i * m + i];
    }
    // back substitution L^T y = z
    for (int i = m - 1; i >= 0; --i) {
        double sum = y[i];
        for (int p = i + 1; p < m; ++p) sum -= S[p * m + i] * y[p];
        y[i] = sum / S[i * m + i];
    }
    return true;
}

}  // namespace

extern "C" {

// A in CSR: indptr (n+1), indices (nnz), values (nnz), symmetric full pattern.
// Outputs COO of L (column-compressed order): rows_out/cols_out/vals_out
// must have capacity n * (1 + alpha * beta). Returns nnz(L) or -1.
int64_t fspai_csr(const int64_t* indptr, const int32_t* indices,
                  const double* values, int64_t n, int32_t alpha, int32_t beta,
                  double epsilon, int32_t* rows_out, int32_t* cols_out,
                  double* vals_out) {
    // diagonal lookup + dense accumulators
    std::vector<double> diag(n, 0.0);
    for (int64_t i = 0; i < n; ++i)
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
            if (indices[p] == i) diag[i] = values[p];

    std::vector<double> lk(n, 0.0);   // dense current column of L
    std::vector<double> r(n, 0.0);    // residual A * lk
    std::vector<int32_t> touched;     // nonzero tracking for lk / r
    std::vector<int32_t> Jk;          // adaptive pattern (indices > k)
    std::vector<double> S, bk, yk;
    std::vector<std::pair<double, int32_t>> cand;
    int64_t out = 0;

    auto a_at = [&](int64_t row, int32_t col) -> double {
        for (int64_t p = indptr[row]; p < indptr[row + 1]; ++p)
            if (indices[p] == col) return values[p];
        return 0.0;
    };

    for (int64_t k = 0; k < n; ++k) {
        Jk.clear();
        double lkk = 1.0 / std::sqrt(std::max(diag[k], 1e-300));
        for (int step = 0; step <= alpha; ++step) {
            const int m = static_cast<int>(Jk.size());
            if (m > 0) {
                S.assign(m * m, 0.0);
                bk.assign(m, 0.0);
                for (int i = 0; i < m; ++i) {
                    for (int j = 0; j < m; ++j) S[i * m + j] = a_at(Jk[i], Jk[j]);
                    bk[i] = a_at(Jk[i], static_cast<int32_t>(k));
                }
                yk = bk;
                std::vector<double> Sf = S;
                if (!chol_solve(Sf, yk, m)) break;
                double dot = 0.0;
                for (int i = 0; i < m; ++i) dot += bk[i] * yk[i];
                lkk = 1.0 / std::sqrt(std::max(diag[k] - dot, 1e-300));
            }
            if (step == alpha) break;
            // candidate selection: residual r = A lk over the pattern's rows
            for (int32_t t : touched) { lk[t] = 0.0; r[t] = 0.0; }
            touched.clear();
            lk[k] = lkk;
            touched.push_back(static_cast<int32_t>(k));
            for (int i = 0; i < static_cast<int>(Jk.size()); ++i) {
                lk[Jk[i]] = -yk[i] * lkk;
                touched.push_back(Jk[i]);
            }
            // r = A * lk restricted to rows adjacent to the support
            for (int32_t c : touched) {
                double v = lk[c];
                for (int64_t p = indptr[c]; p < indptr[c + 1]; ++p) {
                    int32_t row = indices[p];
                    if (r[row] == 0.0 && row != k) {
                        // lazily track rows we write
                    }
                    r[row] += values[p] * v;
                }
            }
            cand.clear();
            for (int32_t c : touched) {
                for (int64_t p = indptr[c]; p < indptr[c + 1]; ++p) {
                    int32_t row = indices[p];
                    double rv = r[row];
                    if (row <= k || rv == 0.0) continue;
                    if (std::find(Jk.begin(), Jk.end(), row) != Jk.end()) continue;
                    double tau = rv * rv / diag[row];
                    if (tau > epsilon) cand.emplace_back(tau, row);
                    r[row] = 0.0;  // consume
                }
            }
            // clear remaining residual entries
            for (int32_t c : touched) {
                for (int64_t p = indptr[c]; p < indptr[c + 1]; ++p) r[indices[p]] = 0.0;
            }
            if (cand.empty()) break;
            std::sort(cand.begin(), cand.end(),
                      [](auto& a, auto& b) { return a.first > b.first; });
            cand.erase(std::unique(cand.begin(), cand.end(),
                                   [](auto& a, auto& b) { return a.second == b.second; }),
                       cand.end());
            const int take = std::min<int>(beta, static_cast<int>(cand.size()));
            for (int t = 0; t < take; ++t) Jk.push_back(cand[t].second);
            std::sort(Jk.begin(), Jk.end());
        }
        // emit column k
        rows_out[out] = static_cast<int32_t>(k);
        cols_out[out] = static_cast<int32_t>(k);
        vals_out[out] = lkk;
        ++out;
        for (int i = 0; i < static_cast<int>(Jk.size()); ++i) {
            rows_out[out] = Jk[i];
            cols_out[out] = static_cast<int32_t>(k);
            vals_out[out] = -yk[i] * lkk;
            ++out;
        }
        for (int32_t t : touched) { lk[t] = 0.0; r[t] = 0.0; }
        touched.clear();
    }
    return out;
}

}  // extern "C"
