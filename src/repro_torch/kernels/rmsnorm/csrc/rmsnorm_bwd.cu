// RMSNorm backward for Hopper (sm_90a): dx and dw of y = x * r * w,
// r = rsqrt(mean(x^2) + eps), all in float32.
//
// The JAX package has no backward Pallas kernel: its training step
// differentiates `layers.rmsnorm` (src/repro/models/layers.py:18) by autodiff,
// outside any kernel. On the card the forward is the hand-written
// `rmsnorm.cu` (`_kernel`, src/repro/kernels/rmsnorm/rmsnorm.py:16), which
// autograd cannot see through, so its gradient is this kernel:
//   g = dy * w,   dx = r * g - x * r^3 * mean(g * x),   dw = sum over rows of dy * x * r.
// `dx` takes x's dtype, `dw` is float32 like w.
//
// Bound: bytes (x and dy read once, dx written once: ~25 MB at N 2048, d 3072
// in bf16). Design:
// * `rmsnorm_bwd_kernel`: a CTA of NT threads walks rows blockIdx.x,
//   blockIdx.x + gridDim.x, ...; thread t holds columns t, t + NT, ... of
//   the row (PER of them) in registers, reduces sum(x^2) and sum(g x) over
//   the CTA in one pass (warp shuffles, then shared memory), and writes dx
//   from those registers. Its share of dw stays in registers across its
//   rows, column by column, and goes to a float32 [gridDim.x, d] buffer of
//   partial sums at the end;
// * `rmsnorm_dw_kernel` sums the partials column by column, in block order.
// No atomics: two runs give equal bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_BLOCKS = 264;  // two CTAs on each of the 132 SMs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x, dy, dx [n, d]; w [d]; partial [gridDim.x, d]; d <= NT * PER
template <typename T, int NT, int PER>
__global__ void __launch_bounds__(NT)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int n, int d, float eps) {
  __shared__ float red[2][NT / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float wv[PER], dwv[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = t + i * NT;
    wv[i] = c < d ? w[c] : 0.f;
    dwv[i] = 0.f;
  }
  for (int row = blockIdx.x; row < n; row += gridDim.x) {
    const size_t off = (size_t)row * d;
    float xv[PER], gv[PER];
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + i * NT;
      const bool ok = c < d;
      xv[i] = ok ? to_f(x[off + c]) : 0.f;
      gv[i] = ok ? to_f(dy[off + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      ss = fmaf(xv[i], xv[i], ss);
      gx = fmaf(gv[i] * wv[i], xv[i], gx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
      gx += __shfl_xor_sync(0xffffffffu, gx, o);
    }
    if (lane == 0) red[0][warp] = ss, red[1][warp] = gx;
    __syncthreads();
    ss = 0.f, gx = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) ss += red[0][i], gx += red[1][i];
    __syncthreads();  // red is rewritten by the next row
    const float r = 1.f / sqrtf(ss / (float)d + eps);
    const float k = r * r * r * gx / (float)d;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = t + i * NT;
      if (c < d) {
        dx[off + c] = from_f<T>(r * gv[i] * wv[i] - xv[i] * k);
        dwv[i] = fmaf(gv[i] * xv[i], r, dwv[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = t + i * NT;
    if (c < d) partial[(size_t)blockIdx.x * d + c] = dwv[i];
  }
}

// dw[c] = sum over b < blocks of partial[b, c], in order
__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * d + c];
  dw[c] = s;
}

template <typename T, int NT>
int launch_nt(const void* x, const void* w, const void* dy, void* dx, float* partial, int n,
              int d, int blocks, float eps, cudaStream_t s) {
  const int per = (d + NT - 1) / NT;
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
#define RMS_BWD(PER) \
  rmsnorm_bwd_kernel<T, NT, PER><<<blocks, NT, 0, s>>>(xp, wp, gp, dp, partial, n, d, eps)
  if (per <= 1) RMS_BWD(1);
  else if (per <= 2) RMS_BWD(2);
  else if (per <= 4) RMS_BWD(4);
  else if (per <= 8) RMS_BWD(8);
  else if (per <= 16) RMS_BWD(16);
  else RMS_BWD(32);
#undef RMS_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// The float32 [blocks, d] scratch `rmsnorm_bwd_launch` needs, blocks =
// min(n, MAX_BLOCKS).
extern "C" int rmsnorm_bwd_blocks(int n) { return n < MAX_BLOCKS ? n : MAX_BLOCKS; }

// x, dy, dx: [n, d] contiguous, float32 (dtype 0) or bfloat16 (dtype 1); w:
// [d] float32; partial: float32 [rmsnorm_bwd_blocks(n), d] scratch. n >= 1,
// 1 <= d <= 32768. The first kernel, on `stream`: dx, and the partial sums of
// dw a block. Returns the launch's CUDA error code (0 on success).
extern "C" int rmsnorm_bwd_launch(const void* x, const void* w, const void* dy, void* dx,
                                  void* partial, int n, int d, int dtype, float eps,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || d > 32768 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  const int blocks = rmsnorm_bwd_blocks(n);
  float* pp = static_cast<float*>(partial);
  if (d <= 256 * 32)
    return dtype ? launch_nt<__nv_bfloat16, 256>(x, w, dy, dx, pp, n, d, blocks, eps, s)
                 : launch_nt<float, 256>(x, w, dy, dx, pp, n, d, blocks, eps, s);
  return dtype ? launch_nt<__nv_bfloat16, 1024>(x, w, dy, dx, pp, n, d, blocks, eps, s)
               : launch_nt<float, 1024>(x, w, dy, dx, pp, n, d, blocks, eps, s);
}

// The second kernel, after the first on `stream`: dw [d] float32, the sum of
// `rmsnorm_bwd_launch`'s partials for n rows, block by block in order.
extern "C" int rmsnorm_dw_launch(const void* partial, void* dw, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || d > 32768) return (int)cudaErrorInvalidValue;
  rmsnorm_dw_kernel<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                    static_cast<float*>(dw),
                                                    rmsnorm_bwd_blocks(n), d);
  return (int)cudaGetLastError();
}
