// RMSNorm and RMSNorm-with-residual for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels `_kernel` and `_kernel_res`
// (src/repro/kernels/rmsnorm/rmsnorm.py:16 and :24):
//   y = x * rsqrt(mean(x^2) + eps) * w      (float32 reduction, y in x's dtype)
//   s = x + res (float32); (rmsnorm(s), s)  (the residual variant)
//
// Bound: bytes. Each row is read, reduced and written once; at d = 3072 a
// row is 6 KB in bf16, a few operations per byte. Design, one pass over
// device memory:
// * a row belongs to `wpr` warps (one while the row fits in 16 16-byte
//   chunks a lane: d = 768, 3072 and 3584 in bf16), several rows to a CTA
//   of at most 256 threads. Each lane loads its chunks (16-byte vectors when
//   d and every pointer allow them, else single elements) into registers
//   before it uses any, so all of a row's loads are in flight at once;
// * the float32 sum of squares reduces with warp shuffles alone; only a row
//   spread over several warps adds one shared-memory step and a barrier;
// * the scale-and-write pass reads the row from registers, never again from
//   memory, and the float32 weight as 16-byte vectors (`float4`);
// * the launcher picks `wpr` and the rows per CTA from (N, d): with fewer
//   than 1024 rows (decode) a row spreads over more warps, about 4 chunks a
//   lane, one row to a CTA, so a few rows still reach several SMs;
// * a row wider than the registers hold (more than 16 chunks a lane at
//   8 warps: d > 32768 in bf16) reads its remainder once more, from L2.
// The residual variant writes the rounded sum x + res in the first pass and
// normalises the unrounded float32 one, as `_kernel_res`.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

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

// the VEC weights of chunk c: float4 loads when VEC is a multiple of 4 (the
// vector path, w 16-byte aligned)
template <int VEC>
__device__ __forceinline__ void load_w(const float* __restrict__ w, int c, float (&wv)[VEC]) {
  if constexpr (VEC % 4 == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w) + c * (VEC / 4);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = w4[i];
      wv[4 * i] = f.x;
      wv[4 * i + 1] = f.y;
      wv[4 * i + 2] = f.z;
      wv[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) wv[i] = w[c * VEC + i];
  }
}

// Make a chunk's words opaque to the compiler, so that the scale pass
// converts the packed chunk again instead of the compiler keeping every
// float32 value of the first pass live across the reduction (twice the
// registers in bf16, and half the CTAs on an SM).
template <typename C>
__device__ __forceinline__ void opaque(C& c) {
  if constexpr (sizeof(C) % 4 == 0) {
    uint32_t* u = reinterpret_cast<uint32_t*>(&c);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(C) / 4); ++i) asm volatile("" : "+r"(u[i]));
  }
}

// x (+ res) of one chunk in float32; with RES the rounded sum goes to `sv`
template <typename T, int VEC, bool RES>
__device__ __forceinline__ void sum_chunk(const Chunk<T, VEC>& xv, const Chunk<T, VEC>& rv,
                                          float (&f)[VEC], Chunk<T, VEC>& sv) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    f[i] = to_f(xv.v[i]);
    if (RES) {
      f[i] += to_f(rv.v[i]);
      sv.v[i] = from_f<T>(f[i]);
    }
  }
}

// One row per `wpr` warps, blockDim.x / (32 wpr) rows per CTA; each lane
// holds up to NCH chunks of its row in registers (chunks t, t + tpr, ...).
template <typename T, int VEC, int NCH, bool RES>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ w, T* __restrict__ out, T* __restrict__ res_out,
               int n, int d, int wpr, float eps) {
  using C = Chunk<T, VEC>;
  __shared__ float red[MAX_THREADS / 32];
  const int tpr = 32 * wpr;  // threads per row
  const int row = blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const int t = threadIdx.x % tpr;
  const bool live = row < n;  // a dead row's threads still reach the barrier
  const int nc = live ? d / VEC : 0;
  const size_t off = (size_t)(live ? row : 0) * d;
  const C* xr = reinterpret_cast<const C*>(x + off);
  const C* rr = RES ? reinterpret_cast<const C*>(res + off) : nullptr;
  C* orow = reinterpret_cast<C*>(out + off);
  C* srow = RES ? reinterpret_cast<C*>(res_out + off) : nullptr;

  C xv[NCH], rv[RES ? NCH : 1];
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = t + i * tpr;
    if (c < nc) {
      xv[i] = xr[c];
      if (RES) rv[i] = rr[c];
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = t + i * tpr;
    if (c < nc) {
      float f[VEC];
      C sv;
      sum_chunk<T, VEC, RES>(xv[i], rv[RES ? i : 0], f, sv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
      if (RES) srow[c] = sv;
    }
  }
  for (int c = t + NCH * tpr; c < nc; c += tpr) {  // past the registers
    const C xc = xr[c];
    C rc, sv;
    if (RES) rc = rr[c];
    float f[VEC];
    sum_chunk<T, VEC, RES>(xc, rc, f, sv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ss = fmaf(f[e], f[e], ss);
    if (RES) srow[c] = sv;
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (wpr > 1) {  // uniform over the CTA
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
    __syncthreads();
    const int w0 = threadIdx.x / tpr * wpr;
    ss = 0.f;
    for (int i = 0; i < wpr; ++i) ss += red[w0 + i];
  }
  const float r = 1.f / sqrtf(ss / (float)d + eps);

#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    opaque(xv[i]);
    if (RES) opaque(rv[RES ? i : 0]);
  }
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = t + i * tpr;
    if (c < nc) {
      float f[VEC], wv[VEC];
      C sv, ov;
      sum_chunk<T, VEC, RES>(xv[i], rv[RES ? i : 0], f, sv);
      load_w<VEC>(w, c, wv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) ov.v[e] = from_f<T>(f[e] * r * wv[e]);
      orow[c] = ov;
    }
  }
  for (int c = t + NCH * tpr; c < nc; c += tpr) {
    const C xc = xr[c];
    C rc, sv, ov;
    if (RES) rc = rr[c];
    float f[VEC], wv[VEC];
    sum_chunk<T, VEC, RES>(xc, rc, f, sv);
    load_w<VEC>(w, c, wv);
#pragma unroll
    for (int e = 0; e < VEC; ++e) ov.v[e] = from_f<T>(f[e] * r * wv[e]);
    orow[c] = ov;
  }
}

template <typename T, int VEC, bool RES>
int launch_v(const void* x, const void* res, const void* w, void* out, void* res_out, int n,
             int d, float eps, cudaStream_t stream) {
  const int nc = d / VEC;
  // chunks a lane may hold: 16 (one warp per row at the widths served), or
  // about 4 when there are few rows to spread over the SMs
  const int cap = n < 1024 ? 4 : 16;
  int wpr = 1;
  while (wpr < MAX_THREADS / 32 && (nc + 32 * wpr - 1) / (32 * wpr) > cap) wpr *= 2;
  const int per = (nc + 32 * wpr - 1) / (32 * wpr);
  const int rows = n < 1024 ? 1 : MAX_THREADS / 32 / wpr;  // rows per CTA
  const dim3 grid((n + rows - 1) / rows), block(rows * 32 * wpr);
  const T* xp = static_cast<const T*>(x);
  const T* rp = static_cast<const T*>(res);
  const float* wp = static_cast<const float*>(w);
  T* op = static_cast<T*>(out);
  T* sp = static_cast<T*>(res_out);
#define RMS_LAUNCH(NCH)                                                                    \
  rmsnorm_kernel<T, VEC, NCH, RES><<<grid, block, 0, stream>>>(xp, rp, wp, op, sp, n, d,   \
                                                               wpr, eps)
  if (per <= 1) RMS_LAUNCH(1);
  else if (per <= 2) RMS_LAUNCH(2);
  else if (per <= 4) RMS_LAUNCH(4);
  else if (per <= 8) RMS_LAUNCH(8);
  else if (per <= 12) RMS_LAUNCH(12);
  else RMS_LAUNCH(16);
#undef RMS_LAUNCH
  return (int)cudaGetLastError();
}

template <typename T, bool RES>
int launch_t(const void* x, const void* res, const void* w, void* out, void* res_out,
             int n, int d, bool vector, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (vector) return launch_v<T, V, RES>(x, res, w, out, res_out, n, d, eps, stream);
  return launch_v<T, 1, RES>(x, res, w, out, res_out, n, d, eps, stream);
}

}  // namespace

// x, res, out, res_out: [n, d] contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); w: [d] float32. res == NULL selects the plain variant. With
// `vector`, d must be a multiple of 16 / sizeof(T) and every pointer, w's
// too, 16-byte aligned. Returns the launch's CUDA error code (0 on success).
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
