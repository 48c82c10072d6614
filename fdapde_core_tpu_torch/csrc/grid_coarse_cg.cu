// Fixed-count conjugate gradients on a small 2D grid stencil, in one launch:
// the coarsest-level solve of the V-cycle (ops/grid_mg.py GridMG._coarse_solve).
//
// Replaces no TPU kernel. The JAX package writes this solve as array code
// (fdapde_core_tpu/ops/grid_mg.py GridMG._coarse_solve), which XLA compiles
// into one program. Eager PyTorch runs the same loop as ~43 launches an
// iteration on m^2 = 2,601 values each, so a 64-iteration solve is ~2,755
// dependent launches and the host sets the V-cycle's pace. Here one thread
// block runs every iteration:
//
//   x = 0, r = p = b, rr = <b, b>
//   n_iter times:
//     Ap = A p;  pAp = <p, Ap>;  alpha = pAp > 0 ? rr / pAp : 0
//     x = x + alpha p;  r = r - alpha Ap
//     rr' = <r, r>;  beta = rr > 0 ? rr' / rr : 0;  p = p beta + r;  rr = rr'
//
// on an (m, m) grid with K <= 9 stencil layers, (Ap)[i, j] =
// sum_k layers[k, i, j] p[i + di_k, j + dj_k] with |di_k|, |dj_k| <= 1 and p
// taken as 0 off the grid. The offsets come packed in one int64, 4 bits an
// offset: (di + 1) * 3 + (dj + 1) at bits 4k .. 4k + 3.
//
// The arithmetic is the plain loop's (grid_mg._coarse_cg): each product is
// rounded and added in the order of the offsets, with no fused
// multiply-add, so A p matches the plain stencil element by element for the
// same p, and the guarded divisions are _safe_div's. Sums accumulate in the
// vector type, as torch.sum does; only their order differs (below). There
// is no early exit and no scalar leaves the block.
//
// Design. Thread t owns grid points q = t + s * kThreads, s < P (a template
// constant, the smallest power of two that covers m^2; consecutive threads,
// consecutive points). It keeps x, r and Ap of its points in registers. p
// lives in shared memory as an (m + 2)^2 array with a zero halo, so a
// stencil read needs no bounds test. The layers are read each iteration
// through the read-only path: at m = 51, K = 9 they are 94 KB in float32 and
// 187 KB in float64, which the SM's L1 can hold beside the 11-22 KB of p
// (the kernel asks for the largest L1 share). Registers cannot hold them in
// float64: x, r, Ap and the layers of 2,601 points need 250 KB of the SM's
// 256 KB register file.
// A block sum is a warp butterfly (every lane ends with the same bits), one
// partial a warp in shared memory, a barrier, and every warp summing the
// partials by the same butterfly: all threads hold the same scalar after one
// barrier. The partials alternate between two buffers, so one barrier a sum
// is enough; with the barrier after p's update, an iteration takes three.
// The order of a sum is fixed, so a result is bitwise the same run to run.
//
// What bounds it on an H100: latency. An iteration moves ~K m^2 values
// through L1 and shared memory and does ~2 K m^2 operations on one SM
// (under a microsecond), then waits on two block sums and three barriers.
// Neither bytes nor operations are near a bound; the gain is the ~2,750
// launches, and the host time to issue them, that the loop no longer needs.
//
// C interface (bound with ctypes): pointers and the stream are void*, the
// rest int64; layers (K, m, m) and b, x (m, m), contiguous, one type. Returns
// cudaErrorInvalidValue for K outside [1, 9], m < 1, m^2 > kCap or
// n_iter < 0, else cudaGetLastError() after the launch, 0 on success.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// of 256, 512 and 1,024 threads the fastest at m = 51 in float32 (PERF.md)
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCap = 8192;  // largest m^2 (ops/grid_mg.py COARSE_KERNEL_CAP)
constexpr int kMaxK = 9;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = add(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// The block's sum of v, the same bits in every thread; part: kWarps slots
// that no thread reads between this call and the next but one.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? part[lane] : T(0));
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
grid_coarse_cg_kernel(const T* __restrict__ layers, const T* __restrict__ b,
                      T* __restrict__ x_out, int K, int m, int64_t code, int n_iter) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* parts = reinterpret_cast<T*>(smem);  // two buffers of kWarps partial sums
  T* p = parts + 2 * kWarps;              // (m + 2)^2, zero halo
  const int n = m * m, w = m + 2, t = threadIdx.x;

  int shift[kMaxK];  // offset k as a step in p
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    const int c = static_cast<int>((code >> (4 * k)) & 15);
    shift[k] = (c / 3 - 1) * w + (c % 3 - 1);
  }
  for (int i = t; i < w * w; i += kThreads) p[i] = T(0);
  __syncthreads();

  T x[P], r[P], Ap[P];
  int at[P];  // each point's index in p
  T acc = T(0);
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int q = t + s * kThreads;
    x[s] = r[s] = Ap[s] = T(0);
    at[s] = 0;
    if (q < n) {
      at[s] = (q / m + 1) * w + q % m + 1;
      r[s] = b[q];
      p[at[s]] = r[s];
      acc = add(acc, mul(r[s], r[s]));
    }
  }
  T rr = block_sum(acc, parts);  // its barrier also publishes p

  for (int it = 0; it < n_iter; ++it) {
    acc = T(0);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int q = t + s * kThreads;
      if (q < n) {
        const T* pq = p + at[s];
        T y = mul(__ldg(layers + q), pq[shift[0]]);
#pragma unroll
        for (int k = 1; k < kMaxK; ++k)
          if (k < K) y = add(y, mul(__ldg(layers + static_cast<int64_t>(k) * n + q), pq[shift[k]]));
        Ap[s] = y;
        acc = add(acc, mul(*pq, y));
      }
    }
    const T pAp = block_sum(acc, parts + kWarps);
    const T alpha = pAp > T(0) ? rr / pAp : T(0);
    acc = T(0);
#pragma unroll
    for (int s = 0; s < P; ++s) {
      if (t + s * kThreads < n) {
        x[s] = add(x[s], mul(alpha, p[at[s]]));
        r[s] = add(r[s], -mul(alpha, Ap[s]));
        acc = add(acc, mul(r[s], r[s]));
      }
    }
    const T rr_new = block_sum(acc, parts);
    const T beta = rr > T(0) ? rr_new / rr : T(0);
#pragma unroll
    for (int s = 0; s < P; ++s)
      if (t + s * kThreads < n) p[at[s]] = add(mul(p[at[s]], beta), r[s]);
    rr = rr_new;
    __syncthreads();
  }
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int q = t + s * kThreads;
    if (q < n) x_out[q] = x[s];
  }
}

// The kernel's attributes on the current device, set at its first launch there:
// the largest L1 share, and dynamic shared memory for the largest grid it takes
// (above 48 KB only by opting in). Later launches make no attribute call.
template <typename T, int P>
cudaError_t prepare(int device) {
  constexpr int kMaxDevices = 64;
  static std::atomic<bool> ready[kMaxDevices];
  if (device < kMaxDevices && ready[device].load()) return cudaSuccess;
  const auto kernel = grid_coarse_cg_kernel<T, P>;
  int m_max = 1;
  while ((m_max + 1) * (m_max + 1) <= kCap) ++m_max;
  const size_t bytes = (2 * kWarps + size_t(m_max + 2) * (m_max + 2)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxL1);
  if (err == cudaSuccess && bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess && device < kMaxDevices) ready[device].store(true);
  return err;
}

template <typename T, int P>
int run(const void* layers, const void* b, void* x, int K, int m, int64_t code, int n_iter,
        void* stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = prepare<T, P>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t bytes = (2 * kWarps + size_t(m + 2) * (m + 2)) * sizeof(T);
  grid_coarse_cg_kernel<T, P><<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(layers), static_cast<const T*>(b), static_cast<T*>(x), K, m, code,
      n_iter);
  return static_cast<int>(cudaGetLastError());
}

// run<T, P> with P the smallest power of two (from this P) with kThreads * P >= n
template <typename T, int P>
int dispatch(int n, const void* layers, const void* b, void* x, int K, int m, int64_t code,
             int n_iter, void* stream) {
  if constexpr (kThreads * P < kCap) {
    if (kThreads * P < n)
      return dispatch<T, 2 * P>(n, layers, b, x, K, m, code, n_iter, stream);
  }
  return run<T, P>(layers, b, x, K, m, code, n_iter, stream);
}

template <typename T>
int launch(const void* layers, const void* b, void* x, int64_t K, int64_t m, int64_t code,
           int64_t n_iter, void* stream) {
  if (K < 1 || K > kMaxK || m < 1 || m > kCap || m * m > kCap || n_iter < 0 || n_iter > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<T, 1>(static_cast<int>(m * m), layers, b, x, static_cast<int>(K),
                        static_cast<int>(m), code, static_cast<int>(n_iter), stream);
}

}  // namespace

extern "C" {

int grid_coarse_cg_f32(const void* layers, const void* b, void* x, int64_t K, int64_t m,
                       int64_t offset_code, int64_t n_iter, void* stream) {
  return launch<float>(layers, b, x, K, m, offset_code, n_iter, stream);
}

int grid_coarse_cg_f64(const void* layers, const void* b, void* x, int64_t K, int64_t m,
                       int64_t offset_code, int64_t n_iter, void* stream) {
  return launch<double>(layers, b, x, K, m, offset_code, n_iter, stream);
}

}  // extern "C"
