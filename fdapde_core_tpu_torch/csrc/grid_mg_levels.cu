// The V-cycle's stages on the levels above the coarsest, as four kernels:
// the finer levels of ops/grid_mg.py GridMG._v.
//
// Replaces no TPU kernel. The JAX package writes these stages as array code
// (fdapde_core_tpu/ops/grid_mg.py GridMG._smooth, _v, _restrict, _prolong),
// which XLA fuses inside one program. Eager PyTorch runs them one layer at a
// time: a 9-point product is a cast, a multiply and an add per offset, so a
// level takes 116-156 launches and ~18 full-grid passes where one is enough,
// and the host, at ~15 us a launch, sets the V-cycle's pace. Here a level is
// seven launches (two Jacobi sweeps, the residual, the restriction, the
// prolongation, two sweeps):
//
//   jacobi    x' = x + (omega * dinv) * (b - A x), dinv = 1 / A's (0, 0) layer,
//             read from the layer inside the sweep; from x = 0 the first
//             sweep reads only that layer and b (x' = 0 + (omega * dinv) * b)
//   residual  r = b - A x
//   restrict  rc = P^T r, full weighting, coarse (I, J) <- fine (2I, 2J)
//   prolong   x = x + P e, bilinear; x is the V-cycle's own temporary and
//             is updated in place
//
// on an (m, m) grid with K <= 9 stencil layers, (A x)[i, j] =
// sum_k layers[k, i, j] x[i + di_k, j + dj_k] with |di_k|, |dj_k| <= 1 and x
// taken as 0 off the grid. The offsets come packed in one int64, 4 bits an
// offset: (di + 1) * 3 + (dj + 1) at bits 4k .. 4k + 3 (as in
// grid_coarse_cg.cu). Layers are stored in float32, float64 or bfloat16 and
// converted to the vector type as they are read (bfloat16 and float32 to
// float64 exactly, float64 to float32 rounded to nearest), as the plain
// stencil's .to(x.dtype) does.
//
// The arithmetic is the plain functions' (grid_mg._stencil, GridMG._smooth,
// _restrict, _prolong), step for step: each product is rounded and added in
// the order of the offsets, or of _restrict's and _prolong's nine terms (a
// then b, each in -1, 0, 1, zero terms off the grid or between coarse nodes
// included), with __fmul_rn / __fadd_rn (__dmul_rn / __dadd_rn) so that no
// multiply-add is contracted; 1 / d is a correctly rounded division, as
// torch's reciprocal is. So every stage is bitwise the plain stage on the
// card for the same input, and so is a whole V-cycle. The zero-start sweep
// adds its update to +0 as the plain sweep's zeros_like(b) does, so even
// the sign of a zero matches.
//
// Design. What bounds every stage on an H100 is bytes: per node a sweep
// reads K layer values, x and b and writes x' (K = 5 in float32: 32 bytes,
// 0.098 ms at 3.35 TB/s on 3201^2 nodes), and does ~2K operations. The
// sweep and the residual run a block on 128 consecutive nodes of one row
// (blockIdx.y the row), a thread a node: each layer, b and the output
// stream through coalesced, no thread divides to find its row, and x's
// eight neighbours come from the rows the neighbouring blocks read, through
// L1 and L2 (the read-only path), reaching device memory about once. The
// offsets are decoded once on the host into steps in x; K = 5 and K = 9
// are compile-time constants (any other K reads it at run time), and a
// node off the border reads its neighbours with no bounds test. The
// zero-start sweep and the restriction run a thread a node of the flat
// (coarse) grid, the prolongation a thread a coarse node for its four fine
// nodes (one thread a fine node ran 1.5x longer). One C call runs all nu
// sweeps of a smoothing, alternating between two buffers, so the host
// makes five calls a level. On 3201^2 f32 nodes (H100 80GB HBM3, 700 W)
// the sweep and the residual take 79-83 % of their bytes bound, the
// restriction ~73 %, the prolongation ~65 %: PERF.md section 6.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// rest int64 (omega a double); vectors (m, m) and layers (K, m, m),
// contiguous; ltype 0 float32, 1 float64, 2 bfloat16 layers. Each returns
// cudaErrorInvalidValue for an argument outside its domain (K outside
// [1, 9], m < 1 or m^2 over 2^31 - 1, m even where a coarse grid is
// implied, nu < 0 or no (0, 0) offset for a sweep, an unknown ltype), else
// cudaGetLastError() after its launches, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // a row kernel's block: 128 consecutive nodes of one row
constexpr int kFlatThreads = 256;  // a flat kernel's block: 256 consecutive nodes
constexpr int kMaxK = 9;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }

// a stored layer value in the vector type T; bfloat16 arrives as its raw bits
struct bf16_bits {
  uint16_t u;
};
template <typename T>
__device__ __forceinline__ T cvt(float v) { return static_cast<T>(v); }
template <>
__device__ __forceinline__ float cvt<float>(float v) { return v; }
template <typename T>
__device__ __forceinline__ T load(const float* p) { return cvt<T>(__ldg(p)); }
template <typename T>
__device__ __forceinline__ T load(const double* p);
template <>
__device__ __forceinline__ double load<double>(const double* p) { return __ldg(p); }
template <>
__device__ __forceinline__ float load<float>(const double* p) { return __double2float_rn(__ldg(p)); }
template <typename T>
__device__ __forceinline__ T load(const bf16_bits* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return cvt<T>(__uint_as_float(static_cast<unsigned int>(u) << 16));
}

// the offsets, decoded once on the host: layer k multiplies x[q + step[k]],
// node (i + di[k], j + dj[k]); kd is the (0, 0) layer's index (-1: none)
struct Stencil {
  int K, kd;
  int di[kMaxK], dj[kMaxK], step[kMaxK];
};

// (A x)[q] for node q = (i, j), the products added in the order of the
// offsets; the (0, 0) layer's value, converted, lands in *diag. kK: K as a
// compile-time constant, or 0 to read it from st. Nodes off the border read
// their neighbours unguarded; border nodes take x as 0 off the grid.
template <typename T, typename L, int kK>
__device__ __forceinline__ T stencil(const L* __restrict__ layers, const T* __restrict__ x,
                                     const Stencil& st, int64_t n, int m, int i, int j, int q,
                                     T* diag) {
  const int K = kK ? kK : st.K;
  const bool inside = i > 0 && j > 0 && i < m - 1 && j < m - 1;
  T y = T(0);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      const T l = load<T>(layers + k * n + q);
      if (k == st.kd) *diag = l;
      T v;
      if (inside) {
        v = __ldg(x + q + st.step[k]);
      } else {
        const int ii = i + st.di[k], jj = j + st.dj[k];
        v = (static_cast<unsigned>(ii) < static_cast<unsigned>(m) &&
             static_cast<unsigned>(jj) < static_cast<unsigned>(m))
                ? __ldg(x + q + st.step[k])
                : T(0);
      }
      const T t = mul(l, v);
      y = k == 0 ? t : add(y, t);
    }
  }
  return y;
}

// one Jacobi sweep: x_out = x + (omega * (1 / d)) * (b - A x); a thread a
// node, block (blockIdx.x, row blockIdx.y)
template <typename T, typename L, int kK>
__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const L* __restrict__ layers, const T* __restrict__ b, const T* __restrict__ x,
              T* __restrict__ x_out, Stencil st, int m, T omega) {
  const int i = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const int q = i * m + j;
  T d = T(1);
  const T y = stencil<T, L, kK>(layers, x, st, static_cast<int64_t>(m) * m, m, i, j, q, &d);
  x_out[q] = add(x[q], mul(mul(omega, div(T(1), d)), sub(b[q], y)));
}

// the first sweep from x = 0: x_out = 0 + (omega * (1 / d)) * b, reading
// only the (0, 0) layer and b; a thread a node over the flat grid
template <typename T, typename L>
__global__ void __launch_bounds__(kFlatThreads)
jacobi_zero_kernel(const L* __restrict__ diag, const T* __restrict__ b, T* __restrict__ x_out,
                   int n, T omega) {
  const int q = blockIdx.x * kFlatThreads + threadIdx.x;
  if (q >= n) return;
  x_out[q] = add(T(0), mul(mul(omega, div(T(1), load<T>(diag + q))), b[q]));
}

template <typename T, typename L, int kK>
__global__ void __launch_bounds__(kThreads)
residual_kernel(const L* __restrict__ layers, const T* __restrict__ b, const T* __restrict__ x,
                T* __restrict__ r, Stencil st, int m) {
  const int i = blockIdx.y, j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= m) return;
  const int q = i * m + j;
  T unused;
  r[q] = sub(b[q], stencil<T, L, kK>(layers, x, st, static_cast<int64_t>(m) * m, m, i, j, q,
                                     &unused));
}

// the weight of term (a, b) of the full-weighting and bilinear stencils
template <typename T>
__device__ __forceinline__ T weight(int a, int b) {
  return T((a == 0 ? 1.0 : 0.5) * (b == 0 ? 1.0 : 0.5));
}

// rc[I, J] = sum over a, b in (-1, 0, 1) of w_a w_b r[2I + a, 2J + b], r = 0
// off the (m, m) grid; mc = (m + 1) / 2; a thread a coarse node over the
// flat coarse grid
template <typename T>
__global__ void __launch_bounds__(kFlatThreads)
restrict_kernel(const T* __restrict__ r, T* __restrict__ rc, int m, int mc) {
  const int q = blockIdx.x * kFlatThreads + threadIdx.x;
  if (q >= mc * mc) return;
  const int I = q / mc, J = q - I * mc;
  T acc = T(0);
#pragma unroll
  for (int a = -1; a <= 1; ++a) {
#pragma unroll
    for (int b = -1; b <= 1; ++b) {
      const int i = 2 * I + a, j = 2 * J + b;
      const T v = (static_cast<unsigned>(i) < static_cast<unsigned>(m) &&
                   static_cast<unsigned>(j) < static_cast<unsigned>(m))
                      ? __ldg(r + i * m + j)
                      : T(0);
      const T t = mul(weight<T>(a, b), v);
      acc = (a == -1 && b == -1) ? t : add(acc, t);
    }
  }
  rc[q] = acc;
}

// x[i, j] += sum over a, b in (-1, 0, 1) of w_a w_b E[i + a, j + b], where
// E[p, q] = e[p / 2, q / 2] for p, q even on the grid and 0 elsewhere (the
// plain version's zero-filled upsampled grid), in place on x; a thread a
// coarse node (I, J), for the fine nodes (2I, 2J), (2I, 2J + 1),
// (2I + 1, 2J) and (2I + 1, 2J + 1) on the grid. Of a fine node's nine
// terms only those on even (p, q) are not +0, so each sum is written out
// as +0 plus its nonzero terms in the plain order. That is the plain sum's
// value bit for bit: a +0 term leaves a sum that is not -0 unchanged, and
// no partial sum here is -0 (the first is +0 + t, which is not -0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
prolong_kernel(const T* __restrict__ e, T* __restrict__ x, int m, int mc) {
  const int I = blockIdx.y, J = blockIdx.x * kThreads + threadIdx.x;
  if (J >= mc) return;
  const T h = T(0.5), f = T(0.25);
  const bool down = I + 1 < mc, right = J + 1 < mc;
  const T* e0 = e + I * mc + J;
  const T e00 = __ldg(e0);
  const T e01 = right ? __ldg(e0 + 1) : T(0);
  const T e10 = down ? __ldg(e0 + mc) : T(0);
  const T e11 = down && right ? __ldg(e0 + mc + 1) : T(0);
  T* x0 = x + (2 * I) * m + 2 * J;
  const T a00 = x0[0];
  const T a01 = right ? x0[1] : T(0);
  const T a10 = down ? x0[m] : T(0);
  const T a11 = down && right ? x0[m + 1] : T(0);
  x0[0] = add(a00, add(T(0), e00));  // the (0, 0) term, 1 * e exactly
  if (right) x0[1] = add(a01, add(add(T(0), mul(h, e00)), mul(h, e01)));
  if (down) {
    x0[m] = add(a10, add(add(T(0), mul(h, e00)), mul(h, e10)));
    if (right)
      x0[m + 1] = add(a11, add(add(add(add(T(0), mul(f, e00)), mul(f, e01)), mul(f, e10)),
                               mul(f, e11)));
  }
}

dim3 row_blocks(int64_t m, int64_t rows) {
  return dim3(static_cast<unsigned>((m + kThreads - 1) / kThreads), static_cast<unsigned>(rows));
}

bool valid_grid(int64_t K, int64_t m) {
  return K >= 0 && K <= kMaxK && m >= 1 && m * m <= INT32_MAX;
}

Stencil decode(int64_t K, int64_t m, int64_t code) {
  Stencil st{};
  st.K = static_cast<int>(K);
  st.kd = -1;
  for (int k = 0; k < K; ++k) {
    const int c = static_cast<int>((code >> (4 * k)) & 15);
    st.di[k] = c / 3 - 1;
    st.dj[k] = c % 3 - 1;
    st.step[k] = st.di[k] * static_cast<int>(m) + st.dj[k];
    if (c == 4 && st.kd < 0) st.kd = k;
  }
  return st;
}

// the launch of Kernel<T, L, kK> for K = 5, 9 or any other K, on (m, m)
template <typename T, typename L, template <typename, typename, int> class Launch, typename... A>
void by_k(int K, A... args) {
  if (K == 5)
    Launch<T, L, 5>::go(args...);
  else if (K == 9)
    Launch<T, L, 9>::go(args...);
  else
    Launch<T, L, 0>::go(args...);
}

template <typename T, typename L, int kK>
struct Sweep {
  static void go(const L* lay, const T* b, const T* x, T* out, const Stencil& st, int m, T omega,
                 cudaStream_t s) {
    jacobi_kernel<T, L, kK><<<row_blocks(m, m), kThreads, 0, s>>>(lay, b, x, out, st, m, omega);
  }
};

template <typename T, typename L, int kK>
struct Residual {
  static void go(const L* lay, const T* b, const T* x, T* r, const Stencil& st, int m,
                 cudaStream_t s) {
    residual_kernel<T, L, kK><<<row_blocks(m, m), kThreads, 0, s>>>(lay, b, x, r, st, m);
  }
};

template <typename T, typename L>
int smooth(const void* layers, const void* b, void* x0, void* x1, const Stencil& st, int m,
           T omega, int nu, bool zero, cudaStream_t stream) {
  // sweep s writes x1 for even s and x0 for odd s, reading the other
  const L* lay = static_cast<const L*>(layers);
  const T* bb = static_cast<const T*>(b);
  T* buf[2] = {static_cast<T*>(x0), static_cast<T*>(x1)};
  const int n = m * m;
  for (int s = 0; s < nu; ++s) {
    T* dst = buf[(s + 1) & 1];
    if (s == 0 && zero)
      jacobi_zero_kernel<T, L><<<(n + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0, stream>>>(
          lay + static_cast<int64_t>(st.kd) * n, bb, dst, n, omega);
    else
      by_k<T, L, Sweep>(st.K, lay, bb, static_cast<const T*>(buf[s & 1]), dst, st, m, omega,
                        stream);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int smooth_any(const void* layers, int64_t ltype, const void* b, void* x0, void* x1, int64_t K,
               int64_t m, int64_t code, double omega, int64_t nu, int64_t zero, void* stream) {
  if (!valid_grid(K, m) || K < 1 || nu < 0 || nu > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stencil st = decode(K, m, code);
  if (st.kd < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const T w = static_cast<T>(omega);
  const int mm = static_cast<int>(m), n_sweeps = static_cast<int>(nu);
  switch (ltype) {
    case 0: return smooth<T, float>(layers, b, x0, x1, st, mm, w, n_sweeps, zero != 0, s);
    case 1: return smooth<T, double>(layers, b, x0, x1, st, mm, w, n_sweeps, zero != 0, s);
    case 2: return smooth<T, bf16_bits>(layers, b, x0, x1, st, mm, w, n_sweeps, zero != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, typename L>
int residual(const void* layers, const void* b, const void* x, void* r, const Stencil& st, int m,
             cudaStream_t stream) {
  by_k<T, L, Residual>(st.K, static_cast<const L*>(layers), static_cast<const T*>(b),
                       static_cast<const T*>(x), static_cast<T*>(r), st, m, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int residual_any(const void* layers, int64_t ltype, const void* b, const void* x, void* r,
                 int64_t K, int64_t m, int64_t code, void* stream) {
  if (!valid_grid(K, m) || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Stencil st = decode(K, m, code);
  const auto s = static_cast<cudaStream_t>(stream);
  const int mm = static_cast<int>(m);
  switch (ltype) {
    case 0: return residual<T, float>(layers, b, x, r, st, mm, s);
    case 1: return residual<T, double>(layers, b, x, r, st, mm, s);
    case 2: return residual<T, bf16_bits>(layers, b, x, r, st, mm, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int restrict_to(const void* r, void* rc, int64_t m, void* stream) {
  if (!valid_grid(0, m) || m % 2 != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int mc = static_cast<int>((m + 1) / 2);
  restrict_kernel<T><<<(mc * mc + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(r),
                                                            static_cast<T*>(rc),
                                                            static_cast<int>(m), mc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int prolong_add(const void* e, void* x, int64_t m, void* stream) {
  if (!valid_grid(0, m) || m % 2 != 1) return static_cast<int>(cudaErrorInvalidValue);
  const int mc = static_cast<int>((m + 1) / 2);
  prolong_kernel<T><<<row_blocks(mc, mc), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(e), static_cast<T*>(x), static_cast<int>(m), mc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// nu Jacobi sweeps on b; sweep s writes x1 for even s and x0 for odd s,
// reading the other, so the result is in x1 for odd nu and in x0 for even nu;
// zero != 0: the first sweep starts from x = 0 and does not read x0
int grid_mg_smooth_f32(const void* layers, int64_t ltype, const void* b, void* x0, void* x1,
                       int64_t K, int64_t m, int64_t offset_code, double omega, int64_t nu,
                       int64_t zero, void* stream) {
  return smooth_any<float>(layers, ltype, b, x0, x1, K, m, offset_code, omega, nu, zero, stream);
}

int grid_mg_smooth_f64(const void* layers, int64_t ltype, const void* b, void* x0, void* x1,
                       int64_t K, int64_t m, int64_t offset_code, double omega, int64_t nu,
                       int64_t zero, void* stream) {
  return smooth_any<double>(layers, ltype, b, x0, x1, K, m, offset_code, omega, nu, zero, stream);
}

// r = b - A x
int grid_mg_residual_f32(const void* layers, int64_t ltype, const void* b, const void* x, void* r,
                         int64_t K, int64_t m, int64_t offset_code, void* stream) {
  return residual_any<float>(layers, ltype, b, x, r, K, m, offset_code, stream);
}

int grid_mg_residual_f64(const void* layers, int64_t ltype, const void* b, const void* x, void* r,
                         int64_t K, int64_t m, int64_t offset_code, void* stream) {
  return residual_any<double>(layers, ltype, b, x, r, K, m, offset_code, stream);
}

// rc ((m + 1) / 2, (m + 1) / 2) = P^T r, r (m, m), m odd
int grid_mg_restrict_f32(const void* r, void* rc, int64_t m, void* stream) {
  return restrict_to<float>(r, rc, m, stream);
}

int grid_mg_restrict_f64(const void* r, void* rc, int64_t m, void* stream) {
  return restrict_to<double>(r, rc, m, stream);
}

// x (m, m) += P e, e ((m + 1) / 2, (m + 1) / 2), m odd
int grid_mg_prolong_add_f32(const void* e, void* x, int64_t m, void* stream) {
  return prolong_add<float>(e, x, m, stream);
}

int grid_mg_prolong_add_f64(const void* e, void* x, int64_t m, void* stream) {
  return prolong_add<double>(e, x, m, stream);
}

}  // extern "C"
