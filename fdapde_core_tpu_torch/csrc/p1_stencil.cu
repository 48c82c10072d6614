// Fused P1 -laplacian stencil assembly from node coordinate planes (2D).
//
// Replaces the TPU kernel fdapde_core_tpu/ops/pallas_assembly.py
// p1_stencil_layers_from_coords (with its helpers _coords_offdiag_planes and
// _stencil_rows_from_planes): same math, none of the TPU plumbing (manual DMA
// slabs, 8-row alignment, the 16-row prologue block, lane rolls).
//
// Mesh: node (i, j), i, j in [0, n], at X[i, j], Y[i, j]; quad (i, j),
// i, j in [0, n), splits into triangle A (a, b, a+1) and triangle B
// (b, b+1, a+1) with a = node (i, j), b = node (i+1, j). Each triangle's
// three off-diagonal local entries are (b_p b_q + c_p c_q) / (2 |det|), and 0
// where det == 0. The 7 stencil layers, in the order of
// ops/grid_assembly.GRID_OFFSETS2D, sum them per node exactly as
// grid_assembly._LAYER_SOURCES states; the centre is minus the sum of the
// other six (row-sum-zero identity of gradient-form stiffness).
//
// Design: gather form, one thread per output node (I, J), J on threadIdx.x so
// loads and stores coalesce. A thread reads its 3x3 node neighbourhood (index
// clamped to [0, n], so nothing beyond row or column n is ever read) and
// evaluates the six triangles that touch node (I, J): A of quad (I, J); A and
// B of quads (I, J-1) and (I-1, J); B of quad (I-1, J-1). Quads outside
// [0, n)^2 contribute 0 (a select, not a multiply, so junk cannot leak in as
// inf * 0). No atomics: every output is written by exactly one thread, so the
// result is bitwise stable from run to run.
//
// What bounds it on an H100: memory. Per node it reads 8 B of coordinates
// and writes 28 B of layers in f32 (16 B / 56 B in f64); at n = 3200 that is
// about 370 MB per call against 3.35 TB/s. The 9-point neighbourhood is
// re-read by neighbouring threads from L1/L2, so device-memory traffic stays
// near the 36 B/node minimum. Tensor cores and TMA have no part in it.
//
// A second entry point, p1_offdiag_planes_*, writes the six off-diagonal
// planes themselves (the first stage of the assembly, K3) from the same
// per-quad device function; see p1_offdiag_planes_kernel.
//
// C interface (bound with ctypes): pointers and the stream are void*, sizes
// and strides int64 (element units); returns cudaGetLastError() after the
// launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 128;  // columns J per block (threadIdx.x)
constexpr int kBlockY = 2;    // rows I per block (threadIdx.y)

__device__ __forceinline__ float abs_val(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_val(double v) { return fabs(v); }

__device__ __forceinline__ int64_t clamp_index(int64_t v, int64_t hi) {
  return v < 0 ? int64_t(0) : (v > hi ? hi : v);
}

// off-diagonal entries (a12, a13, a23) of the triangle with edge vectors
// u = p2 - p1, v = p3 - p1 (same expression order as the TPU kernel)
template <typename T>
__device__ __forceinline__ void offdiag(T ux, T uy, T vx, T vy,
                                        T& o12, T& o13, T& o23) {
  const T det = ux * vy - vx * uy;
  const T inv = det != T(0) ? T(1) / (T(2) * abs_val(det)) : T(0);
  const T b1 = uy - vy, b2 = vy, b3 = -uy;
  const T c1 = vx - ux, c2 = -vx, c3 = ux;
  o12 = (b1 * b2 + c1 * c2) * inv;
  o13 = (b1 * b3 + c1 * c3) * inv;
  o23 = (b2 * b3 + c2 * c3) * inv;
}

// both triangles of quad (i, j) from its 4 corner nodes:
// (x00, y00) = node (i, j), 10 = (i+1, j), 01 = (i, j+1), 11 = (i+1, j+1)
template <typename T>
struct Quad {
  T a12, a13, a23, b12, b13, b23;
};

template <typename T>
__device__ __forceinline__ Quad<T> quad(T x00, T y00, T x10, T y10,
                                        T x01, T y01, T x11, T y11,
                                        bool valid) {
  const T rx = x01 - x00, ry = y01 - y00;    // right edge at row i
  const T dx = x10 - x00, dy = y10 - y00;    // down edge
  const T rxn = x11 - x10, ryn = y11 - y10;  // right edge at row i+1
  Quad<T> q;
  offdiag(dx, dy, rx, ry, q.a12, q.a13, q.a23);                // A: u=down, v=right
  offdiag(rxn, ryn, rx - dx, ry - dy, q.b12, q.b13, q.b23);    // B
  if (!valid) {
    q.a12 = q.a13 = q.a23 = q.b12 = q.b13 = q.b23 = T(0);
  }
  return q;
}

template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
p1_stencil_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                  int64_t x_row_stride, int64_t y_row_stride, int64_t n,
                  T* __restrict__ out, int64_t layer_stride,
                  int64_t out_row_stride, int64_t col_tiles) {
  const int64_t m = n + 1;
  const int64_t tile = blockIdx.x;
  const int64_t I = (tile / col_tiles) * kBlockY + threadIdx.y;
  const int64_t J = (tile % col_tiles) * kBlockX + threadIdx.x;
  if (I >= m || J >= m) return;

  // 3x3 node neighbourhood, rows/columns clamped into [0, n]
  T x[3][3], y[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int64_t i = clamp_index(I - 1 + r, n);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int64_t j = clamp_index(J - 1 + c, n);
      x[r][c] = __ldg(X + i * x_row_stride + j);
      y[r][c] = __ldg(Y + i * y_row_stride + j);
    }
  }
  const bool row_up = I >= 1, row_dn = I < n;  // quad rows I-1 / I exist
  const bool col_lt = J >= 1, col_rt = J < n;  // quad columns J-1 / J exist

  // quad (I, J): corners at neighbourhood (1,1), (2,1), (1,2), (2,2)
  const Quad<T> q_c = quad(x[1][1], y[1][1], x[2][1], y[2][1],
                           x[1][2], y[1][2], x[2][2], y[2][2], row_dn && col_rt);
  // quad (I, J-1)
  const Quad<T> q_l = quad(x[1][0], y[1][0], x[2][0], y[2][0],
                           x[1][1], y[1][1], x[2][1], y[2][1], row_dn && col_lt);
  // quad (I-1, J)
  const Quad<T> q_u = quad(x[0][1], y[0][1], x[1][1], y[1][1],
                           x[0][2], y[0][2], x[1][2], y[1][2], row_up && col_rt);
  // quad (I-1, J-1)
  const Quad<T> q_ul = quad(x[0][0], y[0][0], x[1][0], y[1][0],
                            x[0][1], y[0][1], x[1][1], y[1][1], row_up && col_lt);

  // grid_assembly._LAYER_SOURCES
  const T L10 = q_c.a12 + q_l.b23;    // a12(I,J)   + b23(I,J-1)
  const T Lm10 = q_u.a12 + q_ul.b23;  // a12(I-1,J) + b23(I-1,J-1)
  const T L01 = q_c.a13 + q_u.b12;    // a13(I,J)   + b12(I-1,J)
  const T L0m1 = q_l.a13 + q_ul.b12;  // a13(I,J-1) + b12(I-1,J-1)
  const T Lm11 = q_u.a23 + q_u.b13;   // a23(I-1,J) + b13(I-1,J)
  const T L1m1 = q_l.a23 + q_l.b13;   // a23(I,J-1) + b13(I,J-1)
  const T L00 = -(L10 + Lm10 + L01 + L0m1 + Lm11 + L1m1);

  // layer order GRID_OFFSETS2D: (-1,0) (-1,1) (0,-1) (0,0) (0,1) (1,-1) (1,0)
  T* o = out + I * out_row_stride + J;
  o[0 * layer_stride] = Lm10;
  o[1 * layer_stride] = Lm11;
  o[2 * layer_stride] = L0m1;
  o[3 * layer_stride] = L00;
  o[4 * layer_stride] = L01;
  o[5 * layer_stride] = L1m1;
  o[6 * layer_stride] = L10;
}

// The six off-diagonal planes alone (K3): one thread per quad (i, j), j on
// threadIdx.x, reading the quad's 4 corners and writing
// out[p][i][j], p = a12, a13, a23, b12, b13, b23, as six coalesced (n, n)
// planes. Replaces fdapde_core_tpu/ops/pallas_assembly.py
// p1_offdiag_planes_from_coords, whose n % 128, block rows, DMA buffers,
// 8-row slabs and eps guard are TPU plumbing this kernel has no need of.
// Memory-bound: 2 (n+1)^2 coordinates in, 6 n^2 planes out.
template <typename T>
__global__ void __launch_bounds__(kBlockX * kBlockY)
p1_offdiag_planes_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                         int64_t x_row_stride, int64_t y_row_stride, int64_t n,
                         T* __restrict__ out, int64_t col_tiles) {
  const int64_t tile = blockIdx.x;
  const int64_t i = (tile / col_tiles) * kBlockY + threadIdx.y;
  const int64_t j = (tile % col_tiles) * kBlockX + threadIdx.x;
  if (i >= n || j >= n) return;
  const T* x0 = X + i * x_row_stride + j;  // node (i, j); (i+1, j) one row on
  const T* y0 = Y + i * y_row_stride + j;
  const Quad<T> q = quad(__ldg(x0), __ldg(y0),
                         __ldg(x0 + x_row_stride), __ldg(y0 + y_row_stride),
                         __ldg(x0 + 1), __ldg(y0 + 1),
                         __ldg(x0 + x_row_stride + 1), __ldg(y0 + y_row_stride + 1),
                         true);
  const int64_t plane = n * n;
  T* o = out + i * n + j;
  o[0 * plane] = q.a12;
  o[1 * plane] = q.a13;
  o[2 * plane] = q.a23;
  o[3 * plane] = q.b12;
  o[4 * plane] = q.b13;
  o[5 * plane] = q.b23;
}

template <typename T>
int launch_planes(const void* X, const void* Y, int64_t x_row_stride,
                  int64_t y_row_stride, int64_t n, void* out, void* stream) {
  const int64_t col_tiles = (n + kBlockX - 1) / kBlockX;
  const int64_t row_tiles = (n + kBlockY - 1) / kBlockY;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(static_cast<unsigned int>(col_tiles * row_tiles));
  p1_offdiag_planes_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y), x_row_stride,
      y_row_stride, n, static_cast<T*>(out), col_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* X, const void* Y, int64_t x_row_stride,
           int64_t y_row_stride, int64_t n, void* out, int64_t layer_stride,
           int64_t out_row_stride, void* stream) {
  const int64_t m = n + 1;
  const int64_t col_tiles = (m + kBlockX - 1) / kBlockX;
  const int64_t row_tiles = (m + kBlockY - 1) / kBlockY;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid(static_cast<unsigned int>(col_tiles * row_tiles));
  p1_stencil_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<const T*>(Y), x_row_stride,
      y_row_stride, n, static_cast<T*>(out), layer_stride, out_row_stride,
      col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int p1_stencil_layers_f32(const void* X, const void* Y, int64_t x_row_stride,
                          int64_t y_row_stride, int64_t n, void* out,
                          int64_t layer_stride, int64_t out_row_stride,
                          void* stream) {
  return launch<float>(X, Y, x_row_stride, y_row_stride, n, out, layer_stride,
                       out_row_stride, stream);
}

int p1_stencil_layers_f64(const void* X, const void* Y, int64_t x_row_stride,
                          int64_t y_row_stride, int64_t n, void* out,
                          int64_t layer_stride, int64_t out_row_stride,
                          void* stream) {
  return launch<double>(X, Y, x_row_stride, y_row_stride, n, out, layer_stride,
                        out_row_stride, stream);
}

int p1_offdiag_planes_f32(const void* X, const void* Y, int64_t x_row_stride,
                          int64_t y_row_stride, int64_t n, void* out,
                          void* stream) {
  return launch_planes<float>(X, Y, x_row_stride, y_row_stride, n, out, stream);
}

int p1_offdiag_planes_f64(const void* X, const void* Y, int64_t x_row_stride,
                          int64_t y_row_stride, int64_t n, void* out,
                          void* stream) {
  return launch_planes<double>(X, Y, x_row_stride, y_row_stride, n, out, stream);
}

}  // extern "C"
