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
//   y[i] = sum_k vals[k, i] * x[cols[k, i]],  k = 0 .. K-1, i in [0, n)
//
// with int32 cols in [0, n_src) (rectangular operators allowed) and padded
// slots holding val = 0.
//
// Design: one thread per row, the row on threadIdx.x, so consecutive
// threads read consecutive vals and cols of one slot (coalesced 128-byte
// transactions per warp). The K loop runs in registers; x is read through
// the read-only path (__ldg). Each y[i] is written exactly once by one
// thread: no atomics, so the result is bitwise stable from run to run.
// Accumulation is in the value type for float32 and float64; bfloat16
// values are widened per product and summed in float32 with a float32
// result (as _spmv_kernel does).
//
// What bounds it on an H100: memory. Per row and slot it streams
// sizeof(val) + 4 bytes of table and gathers one x; per row it writes one
// y. At n = 10.25M, K = 9 in float32 that is about 0.82 GB per call
// (0.74 GB of tables), 0.25 ms at 3.35 TB/s. The x gathers are scattered,
// but x (41 MB in float32, 82 MB in float64) mostly stays in the 50 MB L2,
// so they cost L2 bandwidth rather than device-memory bandwidth. Tensor
// cores and TMA have no part in it.
//
// C interface (bound with ctypes): pointers and the stream are void*, K and
// n int64; returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // rows per block (threadIdx.x)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V: stored value type; A: accumulation, x and y type
template <typename V, typename A>
__global__ void __launch_bounds__(kBlock)
ell_spmv_kernel(const V* __restrict__ vals, const int32_t* __restrict__ cols,
                const A* __restrict__ x, A* __restrict__ y, int64_t K,
                int64_t n) {
  const int64_t row = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n) return;
  const V* v = vals + row;
  const int32_t* c = cols + row;
  A acc = A(0);
#pragma unroll 4
  for (int64_t k = 0; k < K; ++k) {
    const A a = widen(v[k * n]);
    const int32_t j = c[k * n];
    acc += a * __ldg(x + j);
  }
  y[row] = acc;
}

template <typename V, typename A>
int launch(const void* vals, const void* cols, const void* x, void* y,
           int64_t K, int64_t n, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  ell_spmv_kernel<V, A><<<static_cast<unsigned int>(blocks), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(vals), static_cast<const int32_t*>(cols),
      static_cast<const A*>(x), static_cast<A*>(y), K, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ell_spmv_f32(const void* vals, const void* cols, const void* x, void* y,
                 int64_t K, int64_t n, void* stream) {
  return launch<float, float>(vals, cols, x, y, K, n, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* x, void* y,
                 int64_t K, int64_t n, void* stream) {
  return launch<double, double>(vals, cols, x, y, K, n, stream);
}

int ell_spmv_bf16(const void* vals, const void* cols, const void* x, void* y,
                  int64_t K, int64_t n, void* stream) {
  return launch<__nv_bfloat16, float>(vals, cols, x, y, K, n, stream);
}

}  // extern "C"
