// Closed-form P1 local stiffness of the 2D Laplacian, three output modes.
//
// Replaces the TPU kernels of fdapde_core_tpu/ops/pallas_assembly.py:
//   K6 p1_stiffness_2d            (6, C) vertex coordinates -> (9, C)
//   K4 p1_stiffness_edges         (4, N) edge vectors      -> (6, N) packed
//   K5 p1_stiffness_edges_offdiag (4, N) edge vectors      -> (3, N) off-diagonal
// with the same arithmetic. For a cell with b = (y2-y3, y3-y1, y1-y2),
// c = (x3-x2, x1-x3, x2-x1) and det = (x2-x1)(y3-y1) - (x3-x1)(y2-y1),
//
//   A_ij = (b_i b_j + c_i c_j) * inv,   inv = 1 / (2 |det|)
//
// is the local matrix of the positive form int grad.grad. In edge form
// (u = p2 - p1, v = p3 - p1; K4 and K5 add eps to ux, as the TPU kernels do)
// b = (uy-vy, vy, -uy), c = (vx-ux, -vx, ux), det = ux vy - vx uy. A
// degenerate cell gives inf, as in the JAX package: there is no guard.
//
// Layout: structure of arrays with the cell axis last, so row r of cell c
// sits at r * C + c. The TPU kernels pad the cell axis to their tiles (C a
// multiple of 65536, L a multiple of 1024 rows of 128); here any C works and
// nothing is padded.
//
// Design: one thread per cell, the cell on threadIdx.x, so each warp reads
// and writes 128-byte runs of every row (coalesced); all arithmetic stays in
// registers; each output is written once (no atomics, bitwise stable).
//
// What bounds it on an H100: memory. Per cell it reads 6 (K6) or 4 (K4, K5)
// values and writes 9, 6 or 3: in float32 60, 40 and 28 bytes, in float64
// twice that, against ~25 flops a cell. At 3.35 TB/s, K6 on 1.04M cells in
// float64 needs 0.037 ms and on 20.48M cells in float32 0.367 ms; tensor
// cores and TMA have no part in it.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// cell count int64, eps a double; each entry point returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // cells per block (threadIdx.x)

enum Mode { kFull9 = 0, kPacked6 = 1, kOffdiag3 = 2 };

__device__ __forceinline__ float absval(float v) { return fabsf(v); }
__device__ __forceinline__ double absval(double v) { return fabs(v); }

// Writes the local matrix of one cell from its b, c coefficients and inv,
// in the row order of the mode: row-major 3x3; packed
// [a11, a12, a13, a22, a23, a33]; or [a12, a13, a23].
template <typename T, int kMode>
__device__ __forceinline__ void store(T* __restrict__ out, int64_t C, int64_t i,
                                      T b1, T b2, T b3, T c1, T c2, T c3,
                                      T inv) {
  const T a12 = (b1 * b2 + c1 * c2) * inv;
  const T a13 = (b1 * b3 + c1 * c3) * inv;
  const T a23 = (b2 * b3 + c2 * c3) * inv;
  if constexpr (kMode == kOffdiag3) {
    out[i] = a12;
    out[C + i] = a13;
    out[2 * C + i] = a23;
    return;
  }
  const T a11 = (b1 * b1 + c1 * c1) * inv;
  const T a22 = (b2 * b2 + c2 * c2) * inv;
  const T a33 = (b3 * b3 + c3 * c3) * inv;
  if constexpr (kMode == kPacked6) {
    out[i] = a11;
    out[C + i] = a12;
    out[2 * C + i] = a13;
    out[3 * C + i] = a22;
    out[4 * C + i] = a23;
    out[5 * C + i] = a33;
    return;
  }
  out[i] = a11;
  out[C + i] = a12;
  out[2 * C + i] = a13;
  out[3 * C + i] = a12;
  out[4 * C + i] = a22;
  out[5 * C + i] = a23;
  out[6 * C + i] = a13;
  out[7 * C + i] = a23;
  out[8 * C + i] = a33;
}

// K6: rows x1, y1, x2, y2, x3, y3 -> 9 rows
template <typename T>
__global__ void __launch_bounds__(kBlock)
p1_stiffness_2d_kernel(const T* __restrict__ xy, T* __restrict__ out,
                       int64_t C) {
  const int64_t i = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= C) return;
  const T x1 = xy[i], y1 = xy[C + i];
  const T x2 = xy[2 * C + i], y2 = xy[3 * C + i];
  const T x3 = xy[4 * C + i], y3 = xy[5 * C + i];
  const T det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1);
  const T inv = T(1) / (T(2) * absval(det));
  store<T, kFull9>(out, C, i, y2 - y3, y3 - y1, y1 - y2, x3 - x2, x1 - x3,
                   x2 - x1, inv);
}

// K4 (kPacked6) and K5 (kOffdiag3): rows ux, uy, vx, vy
template <typename T, int kMode>
__global__ void __launch_bounds__(kBlock)
p1_stiffness_edges_kernel(const T* __restrict__ e, T* __restrict__ out,
                          int64_t C, T eps) {
  const int64_t i = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= C) return;
  const T ux = e[i] + eps, uy = e[C + i];
  const T vx = e[2 * C + i], vy = e[3 * C + i];
  const T det = ux * vy - vx * uy;
  const T inv = T(1) / (T(2) * absval(det));
  store<T, kMode>(out, C, i, uy - vy, vy, -uy, vx - ux, -vx, ux, inv);
}

unsigned int blocks_for(int64_t C) {
  return static_cast<unsigned int>((C + kBlock - 1) / kBlock);
}

template <typename T>
int launch_2d(const void* xy, void* out, int64_t C, void* stream) {
  if (C > 0) {
    p1_stiffness_2d_kernel<T><<<blocks_for(C), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(xy), static_cast<T*>(out), C);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMode>
int launch_edges(const void* e, void* out, int64_t C, double eps,
                 void* stream) {
  if (C > 0) {
    p1_stiffness_edges_kernel<T, kMode><<<blocks_for(C), kBlock, 0,
                                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(e), static_cast<T*>(out), C, static_cast<T>(eps));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int p1_stiffness_2d_f32(const void* xy, void* out, int64_t C, void* stream) {
  return launch_2d<float>(xy, out, C, stream);
}

int p1_stiffness_2d_f64(const void* xy, void* out, int64_t C, void* stream) {
  return launch_2d<double>(xy, out, C, stream);
}

int p1_stiffness_edges_f32(const void* e, void* out, int64_t C, double eps,
                           void* stream) {
  return launch_edges<float, kPacked6>(e, out, C, eps, stream);
}

int p1_stiffness_edges_f64(const void* e, void* out, int64_t C, double eps,
                           void* stream) {
  return launch_edges<double, kPacked6>(e, out, C, eps, stream);
}

int p1_stiffness_edges_offdiag_f32(const void* e, void* out, int64_t C,
                                   double eps, void* stream) {
  return launch_edges<float, kOffdiag3>(e, out, C, eps, stream);
}

int p1_stiffness_edges_offdiag_f64(const void* e, void* out, int64_t C,
                                   double eps, void* stream) {
  return launch_edges<double, kOffdiag3>(e, out, C, eps, stream);
}

}  // extern "C"
