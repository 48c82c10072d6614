// DIA (offset-diagonal) sparse matrix-vector product y = A x.
//
// Replaces the TPU kernel fdapde_core_tpu/ops/pallas_dia.py dia_spmv (kernel
// _kernel): the same product, none of its TPU layout rules. The TPU kernel
// needs n to be a multiple of its 64K-row tile, rounds the halo max |d_k| up
// to 128 lanes and caps it at one tile, pads a copy of x with that halo and
// brings each tile's x window in by a manual DMA. Here any n and any offsets
// work:
//
//   y[i] = sum_k data[k, i] * x[i + d_k],  k = 0 .. K-1, i in [0, n)
//
// with x taken as 0 outside [0, n) (data[k, i] * 0 is still added, so a
// non-finite entry propagates exactly as in the shift-and-add of
// linear_algebra/dia.py). The offsets are read from a small int64 array on
// the device, not from kernel arguments: a poorly numbered mesh gives
// hundreds of them.
//
// Design: one thread per row, the row on threadIdx.x, so consecutive threads
// read consecutive entries of one diagonal of the row-major (K, n) data
// (coalesced 128-byte transactions per warp). The K loop runs in registers,
// in increasing k; every thread of a warp reads the same offset (one
// broadcast), and x goes through the read-only path (__ldg): neighbouring
// rows read neighbouring x, so the K reads of x per row mostly hit L1/L2.
// Each y[i] is written exactly once by one thread and k runs in a fixed
// order: no atomics, so the result is bitwise stable from run to run.
// Accumulation is in the value type; k * n + i is computed in int64.
//
// What bounds it on an H100: memory. Per row it streams K entries of data,
// reads x once from device memory (the other K-1 reads are cache hits) and
// writes y once: (K + 2) * sizeof(T) bytes. At n = 10.25M, K = 7 in float32
// that is 369 MB per call, 0.110 ms at 3.35 TB/s; two operations per entry
// are far below the vector peak. Tensor cores and TMA have no part in it.
//
// C interface (bound with ctypes): pointers and the stream are void*, K and
// n int64; returns cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // rows per block (threadIdx.x)

template <typename T>
__global__ void __launch_bounds__(kBlock)
dia_spmv_kernel(const T* __restrict__ data, const int64_t* __restrict__ offsets,
                const T* __restrict__ x, T* __restrict__ y, int64_t K,
                int64_t n) {
  const int64_t row = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (row >= n) return;
  const T* a = data + row;
  const long long* d = reinterpret_cast<const long long*>(offsets);
  T acc = T(0);
  for (int64_t k = 0; k < K; ++k) {
    const int64_t j = row + __ldg(d + k);
    const T xj = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
    acc += a[k * n] * xj;
  }
  y[row] = acc;
}

template <typename T>
int launch(const void* data, const void* offsets, const void* x, void* y,
           int64_t K, int64_t n, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  dia_spmv_kernel<T><<<static_cast<unsigned int>(blocks), kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(data), static_cast<const int64_t*>(offsets),
      static_cast<const T*>(x), static_cast<T*>(y), K, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int dia_spmv_f32(const void* data, const void* offsets, const void* x, void* y,
                 int64_t K, int64_t n, void* stream) {
  return launch<float>(data, offsets, x, y, K, n, stream);
}

int dia_spmv_f64(const void* data, const void* offsets, const void* x, void* y,
                 int64_t K, int64_t n, void* stream) {
  return launch<double>(data, offsets, x, y, K, n, stream);
}

}  // extern "C"
