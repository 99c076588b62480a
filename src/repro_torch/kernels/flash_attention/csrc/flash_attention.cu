// Causal flash attention (forward) for Hopper (sm_90a), GQA-aware.
//
// Replaces the JAX package's Pallas kernel `_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py:23, launched by
// `flash_attention_bhsd` with the GQA expansion of `ops.flash_attention`):
// online-softmax attention with a float32 running max `m`, sum `l` and
// accumulator, `-1e30` masking (query row i sees keys j <= i, top-left
// aligned) and the output `acc / max(l, 1e-30)` in q's dtype.
//
// Bound: operations at the path's shapes (S = 512, D = 128: ~128 FLOPs per
// byte moved, each q/k/v element used by a whole tile). This first version
// computes both products with scalar float32 FMAs out of shared memory, so
// it runs far below the tensor-core bound; `mma.sync`/`wgmma` tiles are
// later work. Design:
// * one CTA (256 threads, 16 x 16) per (batch * head, 64-row q tile); the
//   Pallas grid's sequential k axis becomes a loop inside the CTA, over
//   64-key tiles in ascending order from key 0. Key 0 is visible to every
//   row, so `m` is finite after the first tile and a masked entry adds
//   exp(-1e30 - m) = 0; tiles wholly above the diagonal are skipped;
// * q, k and v tiles are staged in shared memory as float32, k and q rows
//   padded by one word so the 16 threads of a row hit 16 banks;
// * each thread owns a 4 x 4 block of the score tile (rows ty + 16 i,
//   keys tx + 16 j) and the same 4 rows x DV/16 columns of the accumulator,
//   so a row's max and sum reduce over 16 lanes with shuffles;
// * the KV head is h / (H / KV): GQA reads the shared k/v rows in place,
//   never a broadcast copy;
// * keys past Skv (a ragged last tile) are loaded as zeros and masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max16(float v) {
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

size_t smem_bytes(int D, int DV) {
  return sizeof(float) * ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) +
                          (size_t)BK * DV + (size_t)BQ * (BK + 1));
}

// q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, DV], o [B, Sq, H, DV]
template <typename T, int DV>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int KV, int Sq, int Skv, int D, float scale,
                 int causal) {
  constexpr int NC = DV / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* Qs = smem;           // [BQ][DP]
  float* Ks = Qs + BQ * DP;   // [BK][DP]
  float* Vs = Ks + BK * DP;   // [BK][DV]
  float* Ps = Vs + BK * DV;   // [BQ][BK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e - r * D, qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? to_f(q[(((size_t)b * Sq + qi) * H + h) * D + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // keys at or past q0 + BQ are above the diagonal for every row of the tile
  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with Ks/Vs/Ps
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e - r * D, kj = k0 + r;
      Ks[r * DP + c] = kj < Skv ? to_f(k[(((size_t)b * Skv + kj) * KV + g) * D + c]) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += NT) {
      const int r = e / DV, c = e - r * DV, kj = k0 + r;
      Vs[r * DV + c] = kj < Skv ? to_f(v[(((size_t)b * Skv + kj) * KV + g) * DV + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Skv && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mn);
        Ps[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * DV + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int DV>
int launch_t(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
             int Sq, int Skv, int D, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, DV>;
  const size_t smem = smem_bytes(D, DV);
  // opt in to more than 48 KB of shared memory on every launch: the
  // attribute belongs to the current device, and the call is cheap and
  // allowed during stream capture
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), H, KV, Sq,
                                   Skv, D, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
              int Sq, int Skv, int D, int Dv, float scale, int causal, cudaStream_t s) {
  switch (Dv) {
    case 32: return launch_t<T, 32>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, s);
    case 64: return launch_t<T, 64>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, s);
    case 112: return launch_t<T, 112>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, s);
    case 128: return launch_t<T, 128>(q, k, v, o, B, H, KV, Sq, Skv, D, scale, causal, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv] contiguous, float32
// (dtype 0) or bfloat16 (dtype 1); o [B, Sq, H, Dv] of the same type.
// D, Dv in {32, 64, 112, 128}; H a multiple of KV; B * H <= 65535. Returns the
// launch's CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int KV, int Sq, int Skv, int D, int Dv,
                                      int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 32 && D != 64 && D != 112 && D != 128) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dv<float>(q, k, v, o, B, H, KV, Sq, Skv, D, Dv, scale, causal, s);
  if (dtype == 1)
    return launch_dv<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, D, Dv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
