// Flash attention backward for Hopper (sm_90a), GQA-aware: dQ, dK, dV.
//
// The JAX package has no backward Pallas kernel: it differentiates its
// attention (`attention_ref` / `flash_attention_jax`,
// src/repro/models/attention.py:34, :75) by autodiff, and so the training
// step's gradient of every attention layer runs outside any kernel there.
// On the card the forward is the hand-written `flash_attention.cu`, which
// autograd cannot see through, so its gradient is these two kernels. They
// compute the gradient of the forward's function: scores s = scale * q.k in
// float32, -1e30 masking (query row i sees keys j <= i with `causal`, top-left
// aligned), a float32 softmax, o = P v.
//
// Both recompute P = exp(scale * q.k - lse) in float32 from the log-sum-exp
// that the forward wrote (float32 [B, H, Sq]; +inf for a row that saw no key,
// whose P, and so its gradients, are 0), so no [Sq, Skv] matrix is stored:
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),   Delta = rowsum(dO * O),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// * `flash_bwd_dq_kernel`: one CTA per (64-row query tile, batch * head). It
//   computes Delta for its rows (and writes it out), then loops over the key
//   tiles (with `causal`, those that start at or before its last row),
//   accumulating dQ in registers;
// * `flash_bwd_dkdv_kernel`, launched after it on the same stream: one CTA
//   per (64-key tile, batch * KV head). It loops over the G query heads of
//   its group and over their query tiles (with `causal`, from the tile of its
//   first key on), reading Delta, and sums dK and dV for the whole group in
//   registers. Nothing crosses CTAs: there are no atomics, and two runs give
//   equal bits.
//
// Scalar float32 FMAs out of shared memory (256 threads, 16 x 16; each thread
// owns a 4 x 4 block of the 64 x 64 score tile and 4 rows x D/16 columns of
// its accumulators), for float32 and bfloat16 inputs alike (bf16 is widened
// on its way to shared memory; the gradients are rounded to the inputs'
// dtype at the end). D = Dv in {32, 64, 112, 128}. At Phi-4-mini's training
// shape (B 4, S 512, 24 / 8 heads, D 128, causal) the work is ~4.2e10 FLOP a
// call for ~0.05 GB of operands: bound by operations, and here by the scalar
// float32 rate, not the tensor cores'. A first, simple kernel: moving the
// products to `wgmma` is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// rows r0 .. r0 + 63 of a [rows, D] slab with row stride `stride` into a
// float tile of row pitch D + 1; rows past `rows` are zero
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int r0,
                                      int rows, int tid) {
  for (int e = tid; e < 64 * D; e += NT) {
    const int r = e / D, c = e - r * D, gr = r0 + r;
    dst[r * (D + 1) + c] = gr < rows ? to_f(src[(size_t)gr * stride + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * (size_t)64 * (D + 1) + (size_t)BQ * (BK + 1));
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * (size_t)64 * (D + 1) + 2 * (size_t)BK * (BQ + 1) + 2 * BQ);
}

// q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D]; lse, delta [B, H, Sq].
// grid (query tiles, B * H)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int H, int KV, int Sq, int Skv, float scale,
                    int causal) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][DP]
  float* dOs = Qs + BQ * DP;   // [BQ][DP]
  float* Ks = dOs + BQ * DP;   // [BK][DP]
  float* Vs = Ks + BK * DP;    // [BK][DP]
  float* dSs = Vs + BK * DP;   // [BQ][BK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, g = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const T* qg = q + ((size_t)b * Sq * H + h) * D;
  const T* og = o + ((size_t)b * Sq * H + h) * D;
  const T* dog = dout + ((size_t)b * Sq * H + h) * D;
  const T* kg = k + ((size_t)b * Skv * KV + g) * D;
  const T* vg = v + ((size_t)b * Skv * KV + g) * D;
  const size_t rowbase = ((size_t)b * H + h) * Sq;

  stage<T, D>(Qs, qg, qstride, q0, Sq, tid);
  stage<T, D>(dOs, dog, qstride, q0, Sq, tid);

  // Delta = rowsum(dO * O) of this thread's 4 rows, and their log-sum-exp
  float dl[4], ls[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    float acc = 0.f;
    if (qi < Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const size_t off = (size_t)qi * qstride + tx + 16 * c;
        acc = fmaf(to_f(dog[off]), to_f(og[off]), acc);
      }
    }
    dl[i] = row_sum16(acc);
    ls[i] = qi < Sq ? lse[rowbase + qi] : INFINITY;
    if (tx == 0 && qi < Sq) delta[rowbase + qi] = dl[i];
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // keys at or past q0 + BQ are above the diagonal for every row of the tile
  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / dSs
    stage<T, D>(Ks, kg, kstride, k0, Skv, tid);
    stage<T, D>(Vs, vg, kstride, k0, Skv, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * DP + d];
        dov[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * DP + d];
        vv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
        const float p = ok ? expf(s[i][j] * scale - ls[i]) : 0.f;
        dSs[(ty + 16 * i) * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4], kv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + (size_t)qi * qstride + ((size_t)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// k, v, dk, dv [B, Skv, KV, D]; q, dout [B, Sq, H, D]; lse, delta [B, H, Sq].
// grid (key tiles, B * KV)
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                      float scale, int causal) {
  constexpr int DP = D + 1, NC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;             // [BK][DP]
  float* Vs = Ks + BK * DP;     // [BK][DP]
  float* Qs = Vs + BK * DP;     // [BQ][DP]
  float* dOs = Qs + BQ * DP;    // [BQ][DP]
  float* Ps = dOs + BQ * DP;    // [BK][BQ + 1]: P^T
  float* dSs = Ps + BK * (BQ + 1);  // [BK][BQ + 1]: dS^T
  float* Ls = dSs + BK * (BQ + 1);  // [BQ] log-sum-exp
  float* Dl = Ls + BQ;              // [BQ] Delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / KV, g = blockIdx.y - b * KV, G = H / KV;
  const int k0 = blockIdx.x * BK;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const size_t kvoff = ((size_t)b * Skv * KV + g) * D;
  stage<T, D>(Ks, k + kvoff, kstride, k0, Skv, tid);
  stage<T, D>(Vs, v + kvoff, kstride, k0, Skv, tid);

  float adk[4][NC], adv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = adv[i][c] = 0.f;

  // rows before k0 see none of this tile's keys
  const int qbeg = causal ? k0 : 0;
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const size_t qoff = ((size_t)b * Sq * H + h) * D;
    const size_t rowbase = ((size_t)b * H + h) * Sq;
    for (int q0 = qbeg; q0 < Sq; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, D>(Qs, q + qoff, qstride, q0, Sq, tid);
      stage<T, D>(dOs, dout + qoff, qstride, q0, Sq, tid);
      if (tid < BQ) {
        const int qi = q0 + tid;
        Ls[tid] = qi < Sq ? lse[rowbase + qi] : INFINITY;
        Dl[tid] = qi < Sq ? delta[rowbase + qi] : 0.f;
      }
      __syncthreads();

      // s^T and dP^T: rows are this thread's keys, columns its queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = Ks[(ty + 16 * i) * DP + d];
          vv[i] = Vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = Qs[(tx + 16 * j) * DP + d];
          dov[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ql = tx + 16 * j, qpos = q0 + ql;
          const bool ok = qpos < Sq && kpos < Skv && (!causal || qpos >= kpos);
          const float p = ok ? expf(s[i][j] * scale - Ls[ql]) : 0.f;
          Ps[(ty + 16 * i) * (BQ + 1) + ql] = p;
          dSs[(ty + 16 * i) * (BQ + 1) + ql] = p * (dp[i][j] - Dl[ql]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4], dov[NC], qv[NC];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = Ps[(ty + 16 * i) * (BQ + 1) + qq];
          dsv[i] = dSs[(ty + 16 * i) * (BQ + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dov[c] = dOs[qq * DP + tx + 16 * c];
          qv[c] = Qs[qq * DP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            adv[i][c] = fmaf(pv[i], dov[c], adv[i][c]);
            adk[i][c] = fmaf(dsv[i], qv[c], adk[i][c]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
    const size_t off = kvoff + (size_t)kj * kstride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(adk[i][c] * scale);
      dv[off + tx + 16 * c] = from_f<T>(adv[i][c]);
    }
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int B, int H, int KV, int Sq, int Skv,
              float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_kernel<T, D>;
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((Sq + BQ - 1) / BQ, B * H), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), delta,
      H, KV, Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                int KV, int Sq, int Skv, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkdv_kernel<T, D>;
  constexpr size_t smem = dkdv_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((Skv + BK - 1) / BK, B * KV), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H, KV,
      Sq, Skv, scale, causal);
  return (int)cudaGetLastError();
}

bool dims_ok(int D) { return D == 32 || D == 64 || D == 112 || D == 128; }

}  // namespace

#define FLASH_BWD_DISPATCH(FN, ...)                                              \
  switch (D) {                                                                  \
    case 32: return dtype ? FN<__nv_bfloat16, 32>(__VA_ARGS__) : FN<float, 32>(__VA_ARGS__);    \
    case 64: return dtype ? FN<__nv_bfloat16, 64>(__VA_ARGS__) : FN<float, 64>(__VA_ARGS__);    \
    case 112: return dtype ? FN<__nv_bfloat16, 112>(__VA_ARGS__) : FN<float, 112>(__VA_ARGS__); \
    case 128: return dtype ? FN<__nv_bfloat16, 128>(__VA_ARGS__) : FN<float, 128>(__VA_ARGS__); \
  }                                                                             \
  return (int)cudaErrorInvalidValue;

// q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D] contiguous, float32
// (dtype 0) or bfloat16 (dtype 1); lse (read) and delta (written) float32
// [B, H, Sq]. D in {32, 64, 112, 128} (Dv == D); H a multiple of KV. Returns
// the launch's CUDA error code (0 on success).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   int B, int H, int KV, int Sq, int Skv, int D, int dtype,
                                   int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(D) || dtype < 0 || dtype > 1 || (Sq + BQ - 1) / BQ > 2147483647 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  FLASH_BWD_DISPATCH(launch_dq, q, k, v, o, dout, static_cast<const float*>(lse), dq,
                     static_cast<float*>(delta), B, H, KV, Sq, Skv, scale, causal, s)
}

// The dK / dV kernel: the same operands as `flash_bwd_dq_launch`, with the
// delta that it wrote (launch it after that call, on the same stream); dk, dv
// [B, Skv, KV, D] in the inputs' dtype.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
                                     int D, int dtype, int causal, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(D) || dtype < 0 || dtype > 1 || B * KV > 65535)
    return (int)cudaErrorInvalidValue;
  FLASH_BWD_DISPATCH(launch_dkdv, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dk, dv, B, H, KV, Sq, Skv, scale,
                     causal, s)
}
