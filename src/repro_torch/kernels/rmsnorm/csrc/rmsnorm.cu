// RMSNorm and RMSNorm-with-residual for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels `_kernel` and `_kernel_res`
// (src/repro/kernels/rmsnorm/rmsnorm.py:16 and :24):
//   y = x * rsqrt(mean(x^2) + eps) * w      (float32 reduction, y in x's dtype)
//   s = x + res (float32); (rmsnorm(s), s)  (the residual variant)
//
// Bound: bytes. Each row is read, reduced and written once; at d = 3072 a
// row is 6 KB in bf16, so the kernel moves bytes at a few operations per
// byte. Design: one CTA per row (the Pallas grid's row tile becomes a CTA,
// the whole feature dim stays in one block), 16-byte vector loads when the
// row and the pointers allow them, a float32 sum of squares reduced with
// warp shuffles and one shared-memory pass, then a second pass over the row
// (from L2) that scales and writes. The residual variant writes the rounded
// sum in the first pass and normalises the unrounded one, as `_kernel_res`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC consecutive elements moved as one aligned access (16 bytes when
// VEC * sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Chunk {
  T v[VEC];
};

// Sum of `v` over the block (blockDim.x a multiple of 32, at most 1024);
// every thread gets the total.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? red[lane] : 0.f;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int VEC, bool RES>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                               const float* __restrict__ w, T* __restrict__ out,
                               T* __restrict__ res_out, int d, float eps) {
  using C = Chunk<T, VEC>;
  __shared__ float red[32];
  const size_t off = (size_t)blockIdx.x * d;
  const C* xr = reinterpret_cast<const C*>(x + off);
  const C* rr = RES ? reinterpret_cast<const C*>(res + off) : nullptr;
  const int nc = d / VEC;

  float ss = 0.f;
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const C xv = xr[c];
    C rv, sv;
    if (RES) rv = rr[c];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float f = to_f(xv.v[i]);
      if (RES) {
        f += to_f(rv.v[i]);
        sv.v[i] = from_f<T>(f);
      }
      ss = fmaf(f, f, ss);
    }
    if (RES) reinterpret_cast<C*>(res_out + off)[c] = sv;
  }
  const float var = block_sum(ss, red) / (float)d;
  const float r = 1.f / sqrtf(var + eps);

  C* orow = reinterpret_cast<C*>(out + off);
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const C xv = xr[c];
    C rv, ov;
    if (RES) rv = rr[c];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float f = to_f(xv.v[i]);
      if (RES) f += to_f(rv.v[i]);
      ov.v[i] = from_f<T>(f * r * w[c * VEC + i]);
    }
    orow[c] = ov;
  }
}

template <typename T, bool RES>
int launch_t(const void* x, const void* res, const void* w, void* out, void* res_out,
             int n, int d, bool vector, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = vector ? V : 1;
  int threads = (d / vec + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(res_out);
  if (vector)
    rmsnorm_kernel<T, V, RES><<<n, threads, 0, stream>>>(xp, rp, wp, op, sp, d, eps);
  else
    rmsnorm_kernel<T, 1, RES><<<n, threads, 0, stream>>>(xp, rp, wp, op, sp, d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x, res, out, res_out: [n, d] contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); w: [d] float32. res == NULL selects the plain variant. With
// `vector`, d must be a multiple of 16 / sizeof(T) and every pointer 16-byte
// aligned. Returns the launch's CUDA error code (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* res, const void* w, void* out,
                              void* res_out, int n, int d, int dtype, int vector,
                              float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool r = res != nullptr;
  if (dtype == 0)
    return r ? launch_t<float, true>(x, res, w, out, res_out, n, d, vector, eps, s)
             : launch_t<float, false>(x, res, w, out, res_out, n, d, vector, eps, s);
  if (dtype == 1)
    return r ? launch_t<__nv_bfloat16, true>(x, res, w, out, res_out, n, d, vector, eps, s)
             : launch_t<__nv_bfloat16, false>(x, res, w, out, res_out, n, d, vector, eps, s);
  return (int)cudaErrorInvalidValue;
}
