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
// Bound: bytes (x and dy read once, dx written once: ~37.8 MB at N 2048, d
// 3072 in bf16, 11.3 us at 3.35 TB/s). Rows move as 16-byte chunks (8 bf16 or
// 4 float32) when d is a multiple of a chunk and x, dy and dx are 16-byte
// aligned, else element by element. Design:
// * `rmsnorm_bwd_kernel`, for rows of at most 384 chunks (d <= 3072 in bf16,
//   1536 in float32, 384 element by element): a CTA of two groups of NT
//   threads, each group one row at a time (rows blockIdx.x + gridDim.x
//   (2i + group)), each thread one chunk of x and dy in registers. The next
//   row's chunks are loaded before this row's reduction, so a group has two
//   rows in flight and an SM four. sum(x^2) and sum(g x) reduce as one
//   float2: warp shuffles, then one named barrier of the group a row over
//   reduction slots that alternate between rows (a slot is written again
//   two rows later, after every thread of the group has passed the barrier
//   between). dx is written from the registers. Each thread's share of dw
//   stays in registers across its rows; at the end the second group's is
//   added to the first's, in that order, and the CTA writes one float32
//   partial row of dw. Past 384 chunks a group would need 512 threads (1024
//   a CTA, at most 64 registers a thread), and holding 8 bf16 of two rows,
//   w and dw spills there;
// * `rmsnorm_bwd_wide_kernel`, for wider rows (up to d = 32768): 1024 threads
//   a row and nothing of the row held across the row's one barrier. The
//   second pass reads x and dy again (from L2: 132 CTAs hold at most 17 MB
//   of rows) and w (L1 / L2); the CTA's share of dw accumulates in shared
//   memory (float32 [d], each thread its own columns);
// * at most 132 CTAs (one an SM), so at most 132 partial rows of dw;
//   `rmsnorm_dw_kernel` sums them in a fixed order over d / 32 CTAs, 32
//   columns each: warp w of 8 sums partial rows w, w + 8, ..., then the
//   eight warps' sums are added in warp order.
// No atomics: two runs give equal bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_BLOCKS = 132;  // one CTA on each of the H100's 132 SMs
constexpr int MAX_HELD = 384;    // chunks of the widest row held in registers
constexpr int WIDE_NT = 1024;    // threads of the wide kernel
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of a row, moved as one load or store (16 bytes when VEC *
// sizeof(T) == 16)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Chunk {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Chunk<T, VEC> load_chunk(const T* p, bool ok) {
  Chunk<T, VEC> c;
  if (ok) {
    c = *reinterpret_cast<const Chunk<T, VEC>*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) c.v[i] = from_f<T>(0.f);
  }
  return c;
}

__device__ __forceinline__ float2 warp_sum2(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(FULL, v.x, o);
    v.y += __shfl_xor_sync(FULL, v.y, o);
  }
  return v;
}

// barrier `id` (1, 2, ...: 0 is __syncthreads') over `n` threads
__device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// x, dy, dx [n, d]; w [d]; partial [gridDim.x, d]; d / VEC <= NT
template <typename T, int VEC, int NT>
__global__ void __launch_bounds__(2 * NT, 1)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ partial,
                   int n, int d, float eps) {
  __shared__ float2 red[2][2][NT / 32];  // [group][row parity][warp]
  __shared__ float dw1[NT * VEC];        // the second group's share of dw
  const int grp = threadIdx.x / NT, t = threadIdx.x - grp * NT;
  const int lane = t & 31, warp = t >> 5;
  const bool live = t < d / VEC;  // this thread's chunk is in the row
  const int c0 = t * VEC;
  float wv[VEC], dwv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    wv[i] = live ? w[c0 + i] : 0.f;
    dwv[i] = 0.f;
  }
  const int stride = 2 * gridDim.x;
  int row = blockIdx.x + grp * gridDim.x;
  Chunk<T, VEC> xc = load_chunk<T, VEC>(x + (size_t)row * d + c0, live && row < n);
  Chunk<T, VEC> gc = load_chunk<T, VEC>(dy + (size_t)row * d + c0, live && row < n);
  for (int par = 0; row < n; row += stride, par ^= 1) {
    // the next row's chunks, in flight under this row's reduction
    const int next = row + stride;
    const Chunk<T, VEC> xn = load_chunk<T, VEC>(x + (size_t)next * d + c0, live && next < n);
    const Chunk<T, VEC> gn = load_chunk<T, VEC>(dy + (size_t)next * d + c0, live && next < n);
    float2 acc = make_float2(0.f, 0.f);  // sum(x^2), sum(g x)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xv = to_f(xc.v[i]);
      acc.x = fmaf(xv, xv, acc.x);
      acc.y = fmaf(to_f(gc.v[i]) * wv[i], xv, acc.y);
    }
    acc = warp_sum2(acc);
    if (lane == 0) red[grp][par][warp] = acc;
    group_sync(1 + grp, NT);
    acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) acc.x += red[grp][par][i].x, acc.y += red[grp][par][i].y;
    const float r = 1.f / sqrtf(acc.x / (float)d + eps);
    const float k = r * r * r * acc.y / (float)d;
    if (live) {
      Chunk<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = to_f(xc.v[i]), gv = to_f(gc.v[i]);
        out.v[i] = from_f<T>(r * gv * wv[i] - xv * k);
        dwv[i] = fmaf(gv * xv, r, dwv[i]);
      }
      *reinterpret_cast<Chunk<T, VEC>*>(dx + (size_t)row * d + c0) = out;
    }
    xc = xn;
    gc = gn;
  }
  if (grp == 1 && live) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dw1[c0 + i] = dwv[i];
  }
  __syncthreads();
  if (grp == 0 && live) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) partial[(size_t)blockIdx.x * d + c0 + i] = dwv[i] + dw1[c0 + i];
  }
}

// the same for rows of more than MAX_HELD chunks; dynamic shared memory:
// float [d], this CTA's share of dw
template <typename T, int VEC>
__global__ void __launch_bounds__(WIDE_NT)
rmsnorm_bwd_wide_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int n, int d, float eps) {
  extern __shared__ float dws[];
  __shared__ float2 red[2][WIDE_NT / 32];  // [row parity][warp]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, nc = d / VEC;
  for (int j = t; j < nc; j += WIDE_NT)
#pragma unroll
    for (int i = 0; i < VEC; ++i) dws[j * VEC + i] = 0.f;
  for (int row = blockIdx.x, par = 0; row < n; row += gridDim.x, par ^= 1) {
    const T* xr = x + (size_t)row * d;
    const T* gr = dy + (size_t)row * d;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int j = t; j < nc; j += WIDE_NT) {
      const Chunk<T, VEC> xc = load_chunk<T, VEC>(xr + j * VEC, true);
      const Chunk<T, VEC> gc = load_chunk<T, VEC>(gr + j * VEC, true);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = to_f(xc.v[i]);
        acc.x = fmaf(xv, xv, acc.x);
        acc.y = fmaf(to_f(gc.v[i]) * w[j * VEC + i], xv, acc.y);
      }
    }
    acc = warp_sum2(acc);
    if (lane == 0) red[par][warp] = acc;
    __syncthreads();
    acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < WIDE_NT / 32; ++i) acc.x += red[par][i].x, acc.y += red[par][i].y;
    const float r = 1.f / sqrtf(acc.x / (float)d + eps);
    const float k = r * r * r * acc.y / (float)d;
#pragma unroll 4
    for (int j = t; j < nc; j += WIDE_NT) {
      const Chunk<T, VEC> xc = load_chunk<T, VEC>(xr + j * VEC, true);
      const Chunk<T, VEC> gc = load_chunk<T, VEC>(gr + j * VEC, true);
      Chunk<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xv = to_f(xc.v[i]), gv = to_f(gc.v[i]);
        out.v[i] = from_f<T>(r * gv * w[j * VEC + i] - xv * k);
        dws[j * VEC + i] = fmaf(gv * xv, r, dws[j * VEC + i]);
      }
      *reinterpret_cast<Chunk<T, VEC>*>(dx + (size_t)row * d + j * VEC) = out;
    }
  }
  for (int j = t; j < nc; j += WIDE_NT)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      partial[(size_t)blockIdx.x * d + j * VEC + i] = dws[j * VEC + i];
}

// dw[c] = sum over b < blocks of partial[b, c]: 32 columns a CTA of 8 warps;
// warp w sums rows w, w + 8, ... in order, then the warps' sums in order
__global__ void __launch_bounds__(256)
rmsnorm_dw_kernel(const float* __restrict__ partial, float* __restrict__ dw, int blocks, int d) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < blocks; b += 8) s += partial[(size_t)b * d + c];
  part[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) tot += part[i][lane];
    dw[c] = tot;
  }
}

template <typename T, int VEC>
int launch_vec(const T* x, const float* w, const T* dy, T* dx, float* partial, int n, int d,
               int blocks, float eps, cudaStream_t s) {
  const int nc = d / VEC;
#define RMS_BWD(NT) \
  rmsnorm_bwd_kernel<T, VEC, NT><<<blocks, 2 * NT, 0, s>>>(x, w, dy, dx, partial, n, d, eps)
  if (nc <= 64) RMS_BWD(64);
  else if (nc <= 128) RMS_BWD(128);
  else if (nc <= 256) RMS_BWD(256);
  else if (nc <= MAX_HELD) RMS_BWD(MAX_HELD);
  else {
    auto kern = rmsnorm_bwd_wide_kernel<T, VEC>;
    const int smem = d * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<blocks, WIDE_NT, smem, s>>>(x, w, dy, dx, partial, n, d, eps);
  }
#undef RMS_BWD
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const void* w, const void* dy, void* dx, float* partial, int n,
             int d, int blocks, float eps, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const float* wp = static_cast<const float*>(w);
  const T* gp = static_cast<const T*>(dy);
  T* dp = static_cast<T*>(dx);
  const bool vector = d % V16 == 0 && ((uintptr_t)x | (uintptr_t)dy | (uintptr_t)dx) % 16 == 0;
  return vector ? launch_vec<T, V16>(xp, wp, gp, dp, partial, n, d, blocks, eps, s)
                : launch_vec<T, 1>(xp, wp, gp, dp, partial, n, d, blocks, eps, s);
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
  return dtype ? launch_t<__nv_bfloat16>(x, w, dy, dx, pp, n, d, blocks, eps, s)
               : launch_t<float>(x, w, dy, dx, pp, n, d, blocks, eps, s);
}

// The second kernel, after the first on `stream`: dw [d] float32, the sum of
// `rmsnorm_bwd_launch`'s partials for n rows, in a fixed order.
extern "C" int rmsnorm_dw_launch(const void* partial, void* dw, int n, int d, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || d > 32768) return (int)cudaErrorInvalidValue;
  rmsnorm_dw_kernel<<<(d + 31) / 32, 256, 0, s>>>(static_cast<const float*>(partial),
                                                  static_cast<float*>(dw),
                                                  rmsnorm_bwd_blocks(n), d);
  return (int)cudaGetLastError();
}
