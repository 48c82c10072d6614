// ELL sparse matrix-vector product y = A x over a slot-major (K, n) table.
//
// Replaces the TPU kernel fdapde_core_tpu/ops/pallas_gather_spmv.py _spmv
// (kernel _spmv_kernel): the same product, none of its routing. The TPU
// kernel gathers fast only within one 128-lane row, so it composes every
// gather out of two lane shuffles and a transpose, driven by precomputed
// routing tables (L1, L2M, VALS) plus a COO remainder, and needs
// |col - row| <= 16384. A Hopper thread reads any address of device memory,
// so this kernel reads the assembled ELL directly and takes any numbering:
//
//   y[i] = sum_k vals[k, i] * x[cols[k, i]],  k = 0 .. w(i) - 1, i in [0, n)
//
// with int32 cols in [0, n_src) (rectangular operators allowed). The table
// keeps JAX's layout, slot for slot: a row's real entries come first and
// its padding is (col = row, val = 0) up to K, the table's widest row.
//
// What bounds it on an H100: memory. Per row and slot read it streams
// sizeof(val) + 4 bytes of table and gathers one x; per row it writes one
// y. x (8-82 MB) mostly stays in the 50 MB L2, so the gathers cost L2
// rather than device-memory bandwidth; the table is the device-memory
// stream. A table padded to its widest row makes most of that stream
// padding: the P2 table is allocated at 49 slots for rows of at most ~28
// and reads 4.3 slots per stored entry, the `gendel` P1 table 1.9.
//
// Design: SELL-32 with no sort, in place. warp_w[g] is the width of the
// widest of rows 32 g .. 32 g + 31 (the caller's, computed once per
// pattern from cols alone, ops/gather_spmv.ell_warp_widths); each warp of
// one thread per row runs its slot loop to that width, so it reads only the
// slots its own rows use (1.13 slots per entry on P2), with no divergence
// and no second copy of the table. A slot past a row's own width but inside
// its warp's is padding and adds 0 x[row]. Consecutive threads read
// consecutive vals and cols of one slot (coalesced 128/256-byte
// transactions a warp). The slot loop is unrolled by 4: nothing in it
// stores, so the compiler issues four slots' table loads and their x
// gathers before the four multiply-adds (cuobjdump -sass shows it), and
// several gathers are in flight.
// Written out by hand with predicated loads (sell_rows_kernel's form) the
// same loop ran slower on the scrambled, P2 and gendel tables, and as
// unpredicated chunks of 4 plus a tail no faster overall (a sweep of loop
// forms on an H100). The table, read once, is read with streaming loads
// that leave L2 to x (the P2 table runs slower through the read-only
// path); x through the read-only path.
//
// Products are added in slot order with fused multiply-adds, and each y[i]
// is written once by one thread: no atomics, so the result is bitwise
// stable, and on finite x it equals the full-K loop (warp_w null) bitwise,
// since the slots it skips only add 0 x[row]. Accumulation is in the value
// type for float32 and float64; bfloat16 values are widened per product and
// summed in float32 with a float32 result (as _spmv_kernel does); float32
// values against a float64 x are widened per product and summed in float64
// (exactly the float64 product of the widened table, with no converted
// copy of it).
//
// C interface (bound with ctypes): ell_spmv_{f32,f64,bf16,f32_f64}(vals,
// cols, warp_w int32 or null (every row reads all K slots), x, y, K, n,
// stream); pointers and the stream are void*, K and n int64; returns
// cudaGetLastError() after the launch, 0 on success.
//
// ---------------------------------------------------------------------------
// Sliced ELL (SELL-C-sigma): y = A x and Y = A X under every SparseMatrix
// product (linear_algebra/sparse.py, ops/gather_spmv.SlicedELL).
//
// One (D, n) ELL pads every row to the longest: Psi^T of the regression,
// whose most crowded dof has 39 observations against a mean of 10.7, moves
// 3.65 slots per entry. Here rows are grouped into slices of kC = 32
// consecutive positions, and slice s is padded only to its own longest row
// slice_w[s]. Position p holds row perm[p] (perm null: p itself); a window
// sort puts rows of like length into one slice, and changes nothing else.
// Slice s is stored slot-major from slice_off[s]: slot q of lane l is entry
// slice_off[s] + q kC + l, so a warp's loads of one slot are 32 consecutive
// values (256 bytes in float64) and 32 consecutive columns. Shorter rows are
// padded with value 0, column 0; each row keeps its column order.
//
// Every (row, column) of the result is summed by one thread, slot after slot
// from slot 0, with fused multiply-adds: the operations of the (K, n) kernel
// above, in its order. So on finite x a row equals that kernel's row
// bitwise, a column of a block product equals the vector product of that
// column bitwise, each y is written once, and nothing depends on the launch
// (no atomics).
//
// X is read where it lies, through its two strides: the transposed view of a
// row-major (n_t, n_s) block as well as a row-major (27, 66,049) one. The
// table is read once per launch for all k columns (column tiles of one
// slice run side by side, so their repeated reads hit L2). Two mappings:
//
// - rows on lanes (sell_rows_kernel): a warp per slice, each lane its row,
//   J columns per thread. kUnroll slots' values and columns, then their
//   kUnroll x J gathers of x, are issued before any multiply-add, so the
//   short, scattered rows of Psi (3 entries) keep many loads in flight.
//   Vectors take J = 1 and read the table with streaming loads, which leave
//   L2 to x; blocks take J = kJ.
// - columns on lanes (sell_cols_kernel), for blocks whose columns are X's
//   unit-stride axis and at least 16 wide (a time factor on the (27, 66,049)
//   block, Psi^T on the (2,000, 27) one): a warp per (row, 32 consecutive
//   columns) reads each slot once (one broadcast), and gathers and writes up
//   to 256 consecutive bytes where lanes on rows would write 8 bytes each at
//   a stride of k; the 8 warps of a block share their X rows in L1.
//
// What bounds it: memory. The work needs each stored entry once (12 bytes
// in float64), X and Y once; x (4 MB for Psi's source, 14 MB for a
// space-time block) stays in the 50 MB L2, so its gathers cost L2 rather
// than device-memory bandwidth. Tensor cores and TMA have no part in a
// gather SpMV.
//
// C interface: sell_spmm_f32 / sell_spmm_f64 (vals, cols, slice_off int64,
// slice_w int32, perm int32 or null, n, x, x strides (row, column), y,
// y strides, k, stream); a vector is k = 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // rows per block (threadIdx.x)
constexpr int kC = 32;       // rows per warp_w entry / slice: the lanes of a warp
constexpr int kWarps = 8;    // sliced ELL: warps per block
constexpr int kUnroll = 4;   // sliced ELL: slots whose loads are issued together
constexpr int kJ = 4;        // rows mapping: columns per thread of a block product
constexpr int kRowsPerWarp = 2;  // columns mapping: row positions per warp

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A slot of the table: streaming loads for a vector product (read once),
// read-only cached loads for a block (read again by the other column tiles)
template <bool kStream, typename T>
__device__ __forceinline__ T table_load(const T* p) {
  if constexpr (kStream) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

template <bool kStream>
__device__ __forceinline__ __nv_bfloat16 table_load(const __nv_bfloat16* p) {
  const auto* raw = reinterpret_cast<const unsigned short*>(p);
  return __ushort_as_bfloat16(kStream ? __ldcs(raw) : __ldg(raw));
}

// V: stored value type; A: accumulation, x and y type. Block b covers rows
// b kBlock .. + kBlock - 1, thread t row b kBlock + t, so warp g of the
// table is one warp of the block.
template <typename V, typename A>
__global__ void __launch_bounds__(kBlock)
ell_spmv_kernel(const V* __restrict__ vals, const int32_t* __restrict__ cols,
                const int32_t* __restrict__ warp_w, const A* __restrict__ x,
                A* __restrict__ y, int64_t K, int64_t n) {
  const int64_t row = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n) return;
  const int64_t wk = warp_w == nullptr ? K : warp_w[row / kC];
  const int w = static_cast<int>(wk < K ? wk : K);
  const V* v = vals + row;
  const int32_t* c = cols + row;
  A acc = A(0);
#pragma unroll 4
  for (int k = 0; k < w; ++k) {
    const int64_t e = int64_t(k) * n;
    const A a = widen(table_load<true>(v + e));
    acc = fma(a, __ldg(x + table_load<true>(c + e)), acc);
  }
  y[row] = acc;
}

template <typename V, typename A>
int launch(const void* vals, const void* cols, const void* warp_w,
           const void* x, void* y, int64_t K, int64_t n, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  ell_spmv_kernel<V, A><<<static_cast<unsigned int>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const int32_t*>(warp_w), static_cast<const A*>(x),
      static_cast<A*>(y), K, n);
  return static_cast<int>(cudaGetLastError());
}

// rows on lanes: block b covers column tile b % n_tiles of slices
// (b / n_tiles) kWarps .. + kWarps - 1, one per warp
template <typename T, int J>
__global__ void __launch_bounds__(kC * kWarps)
sell_rows_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                 const int64_t* __restrict__ slice_off,
                 const int32_t* __restrict__ slice_w,
                 const int32_t* __restrict__ perm, int64_t n,
                 const T* __restrict__ x, int64_t sxr, int64_t sxc,
                 T* __restrict__ y, int64_t syr, int64_t syc, int64_t k,
                 int64_t n_tiles) {
  constexpr bool kStream = J == 1;
  const int64_t tile = blockIdx.x % n_tiles;
  const int64_t s = (blockIdx.x / n_tiles) * kWarps + threadIdx.x / kC;
  const int lane = threadIdx.x % kC;
  const int64_t p = s * kC + lane;
  if (p >= n) return;
  const int64_t row = perm == nullptr ? p : perm[p];
  const int w = slice_w[s];
  const T* v = vals + slice_off[s] + lane;
  const int32_t* c = cols + slice_off[s] + lane;
  const int64_t j0 = tile * J;
  const T* xj = x + j0 * sxc;
  const int nj = static_cast<int>(k - j0 < J ? k - j0 : J);
  T acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = T(0);
  for (int q0 = 0; q0 < w; q0 += kUnroll) {
    T a[kUnroll];
    int64_t at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = q0 + u < w;
      const int64_t e = int64_t(q0 + u) * kC;
      a[u] = live ? table_load<kStream>(v + e) : T(0);
      at[u] = live ? int64_t(table_load<kStream>(c + e)) * sxr : 0;
    }
    T xv[kUnroll][J];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        xv[u][j] = (q0 + u < w && j < nj) ? __ldg(xj + at[u] + j * sxc) : T(0);
      }
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u < w) acc[j] = fma(a[u], xv[u][j], acc[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (j < nj) y[row * syr + (j0 + j) * syc] = acc[j];
  }
}

// columns on lanes: block b covers columns (b % n_tiles) kC .. + kC - 1 of
// row positions (b / n_tiles) kWarps kRowsPerWarp .., interleaved over warps
template <typename T>
__global__ void __launch_bounds__(kC * kWarps)
sell_cols_kernel(const T* __restrict__ vals, const int32_t* __restrict__ cols,
                 const int64_t* __restrict__ slice_off,
                 const int32_t* __restrict__ slice_w,
                 const int32_t* __restrict__ perm, int64_t n,
                 const T* __restrict__ x, int64_t sxr, int64_t sxc,
                 T* __restrict__ y, int64_t syr, int64_t syc, int64_t k,
                 int64_t n_tiles) {
  const int64_t j = (blockIdx.x % n_tiles) * kC + threadIdx.x % kC;
  if (j >= k) return;
  const int64_t group = blockIdx.x / n_tiles;
  const int warp = threadIdx.x / kC;
  const T* xj = x + j * sxc;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int64_t p = (group * kRowsPerWarp + i) * kWarps + warp;
    if (p >= n) break;
    const int64_t s = p / kC;
    const int w = slice_w[s];
    const T* v = vals + slice_off[s] + p % kC;
    const int32_t* c = cols + slice_off[s] + p % kC;
    T acc = T(0);
    for (int q0 = 0; q0 < w; q0 += kUnroll) {
      T a[kUnroll];
      T xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool live = q0 + u < w;
        const int64_t e = int64_t(q0 + u) * kC;
        a[u] = live ? __ldg(v + e) : T(0);
        xv[u] = live ? __ldg(xj + int64_t(__ldg(c + e)) * sxr) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u < w) acc = fma(a[u], xv[u], acc);
      }
    }
    const int64_t row = perm == nullptr ? p : perm[p];
    y[row * syr + j * syc] = acc;
  }
}

template <typename T>
int launch_sell(const void* vals, const void* cols, const void* slice_off,
                const void* slice_w, const void* perm, int64_t n,
                const void* x, int64_t sxr, int64_t sxc, void* y, int64_t syr,
                int64_t syc, int64_t k, void* stream) {
  if (n == 0 || k == 0) return 0;
  const auto* V = static_cast<const T*>(vals);
  const auto* C = static_cast<const int32_t*>(cols);
  const auto* off = static_cast<const int64_t*>(slice_off);
  const auto* W = static_cast<const int32_t*>(slice_w);
  const auto* P = static_cast<const int32_t*>(perm);
  const auto* X = static_cast<const T*>(x);
  auto* Y = static_cast<T*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t slices = (n + kC - 1) / kC;
  const int64_t slice_groups = (slices + kWarps - 1) / kWarps;
  if (k == 1) {
    sell_rows_kernel<T, 1><<<static_cast<unsigned int>(slice_groups), kC * kWarps, 0, st>>>(
        V, C, off, W, P, n, X, sxr, sxc, Y, syr, syc, k, 1);
  } else if (sxc == 1 && 2 * k >= kC) {
    const int64_t tiles = (k + kC - 1) / kC;
    const int64_t row_groups = (n + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
    sell_cols_kernel<T><<<static_cast<unsigned int>(tiles * row_groups), kC * kWarps, 0, st>>>(
        V, C, off, W, P, n, X, sxr, sxc, Y, syr, syc, k, tiles);
  } else {
    const int64_t tiles = (k + kJ - 1) / kJ;
    sell_rows_kernel<T, kJ><<<static_cast<unsigned int>(tiles * slice_groups), kC * kWarps, 0, st>>>(
        V, C, off, W, P, n, X, sxr, sxc, Y, syr, syc, k, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals, const void* cols, const void* warp_w,
                 const void* x, void* y, int64_t K, int64_t n, void* stream) {
  return launch<float, float>(vals, cols, warp_w, x, y, K, n, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* warp_w,
                 const void* x, void* y, int64_t K, int64_t n, void* stream) {
  return launch<double, double>(vals, cols, warp_w, x, y, K, n, stream);
}

int ell_spmv_bf16(const void* vals, const void* cols, const void* warp_w,
                  const void* x, void* y, int64_t K, int64_t n, void* stream) {
  return launch<__nv_bfloat16, float>(vals, cols, warp_w, x, y, K, n, stream);
}

int ell_spmv_f32_f64(const void* vals, const void* cols, const void* warp_w,
                     const void* x, void* y, int64_t K, int64_t n,
                     void* stream) {
  return launch<float, double>(vals, cols, warp_w, x, y, K, n, stream);
}

int sell_spmm_f32(const void* vals, const void* cols, const void* slice_off,
                  const void* slice_w, const void* perm, int64_t n,
                  const void* x, int64_t sxr, int64_t sxc, void* y,
                  int64_t syr, int64_t syc, int64_t k, void* stream) {
  return launch_sell<float>(vals, cols, slice_off, slice_w, perm, n, x, sxr,
                            sxc, y, syr, syc, k, stream);
}

int sell_spmm_f64(const void* vals, const void* cols, const void* slice_off,
                  const void* slice_w, const void* perm, int64_t n,
                  const void* x, int64_t sxr, int64_t sxc, void* y,
                  int64_t syr, int64_t syc, int64_t k, void* stream) {
  return launch_sell<double>(vals, cols, slice_off, slice_w, perm, n, x, sxr,
                             sxc, y, syr, syc, k, stream);
}

}  // extern "C"
