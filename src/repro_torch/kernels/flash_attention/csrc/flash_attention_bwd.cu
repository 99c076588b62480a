// Flash attention backward for Hopper (sm_90a), GQA-aware: dQ, dK, dV.
//
// The JAX package has no backward Pallas kernel: it differentiates its
// attention (`attention_ref` / `flash_attention_jax`,
// src/repro/models/attention.py:34, :75) by autodiff, and so the training
// step's gradient of every attention layer runs outside any kernel there.
// On the card the forward is the hand-written `flash_attention.cu`, which
// autograd cannot see through, so its gradient is these kernels. They
// compute the gradient of the forward's function: scores s = scale * q.k in
// float32, -1e30 masking (query row i sees keys j <= i with `causal`, top-left
// aligned), a float32 softmax, o = P v.
//
// Every kernel recomputes P = exp(scale * q.k - lse) in float32 from the
// log-sum-exp that the forward wrote (float32 [B, H, Sq]; +inf for a row that
// saw no key, whose P, and so its gradients, are 0), so no [Sq, Skv] matrix
// is stored:
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),   Delta = rowsum(dO * O),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// Two kernels, launched in this order on one stream:
// * dQ: one CTA per (64-row query tile, batch * head). It computes Delta for
//   its rows (and writes it out), then loops over the key tiles (with
//   `causal`, those that start at or before its last row), accumulating dQ
//   in registers;
// * dK / dV: one CTA per (64-key tile, batch * KV head). It loops over the G
//   query heads of its group and over their query tiles (with `causal`,
//   from the tile of its first key on), reading Delta, and sums dK and dV
//   for the whole group in registers.
// Nothing crosses CTAs: there are no atomics, and two runs give equal bits.
// The dQ pass recomputes S and dP, so the pair runs seven products where a
// kernel with an atomic dQ runs five: the price of equal bits.
//
// One pair of kernels for each dtype (a dispatch, not a fallback).
//
// bfloat16: `flash_bwd_dq_wgmma_kernel` and `flash_bwd_dkdv_wgmma_kernel`,
// every product on the tensor cores through the forward's two `wgmma` forms
// (`wgmma.cuh`; bf16 operands, float32 accumulation). At Phi-4-mini's
// training shape (B 4, S 512, 24 / 8 heads, D 128, causal) the seven
// products are ~2.5e10 FLOP with the diagonal tiles whole, ~25 us at 989
// TFLOP/s, against ~67 MB of operands (20 us at 3.35 TB/s): bound by
// operations. Design:
// * one warpgroup (128 threads) a CTA, bf16 tiles of 64 rows in shared
//   memory in the 128-byte-swizzled layout, fed by `cp.async`; the tile the
//   CTA owns (Q and dO, or K and V) is loaded once, the tiles it walks go
//   through a two-stage ring, the next tile's copy running under this
//   tile's products. 96 KB at D = 128 (97 KB for dK / dV): two CTAs an SM;
// * dQ: S = Q K^T and dP = dO V^T (`wgmma_ss_n64`, all K-major), then in
//   registers P = 2^(S c - lse log2(e)) with c = scale log2(e) (one FFMA,
//   one ex2; a row whose lse is +inf gets P = 0) and dS = P (dP - Delta) in
//   float32, rounded to bf16 as the A fragment of dQ += dS K (`wgmma_rs`, K
//   through its MN-major descriptor). With `causal`, the grid's y counts
//   from the last query tile, so the tiles with the most keys start first;
//* dK / dV: S^T = K Q^T and dP^T = V dO^T (ss), P^T and dS^T in registers
//   (each thread's 16 query columns read their lse and Delta from shared
//   memory, copied with the tile), then dV += bf16(P^T) dO and dK +=
//   bf16(dS^T) Q (rs, dO and Q MN-major). The grid's y is the key tile, so
//   with `causal` the tiles with the most query tiles start first. dK and
//   dV hold 64 + 64 floats a thread at D = 128, S^T and dP^T 32 + 32;
// * causal: key tiles above a query tile's diagonal are never loaded; only
//   the tiles on the diagonal or past Sq / Skv are masked.
//
// float32: `flash_bwd_dq_kernel` and `flash_bwd_dkdv_kernel`, scalar float32
// FMAs out of shared memory (the tensor cores would compute in TF32, outside
// the float32 tolerance): 256 threads (16 x 16), each owning a 4 x 4 block of
// the 64 x 64 score tile and 4 rows x D/16 columns of its accumulators. No
// training path runs float32 attention on the card but the check against the
// CPU (`train_vs_cpu`).
//
// D = Dv in {32, 64, 112, 128}.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace wg {

constexpr int THREADS = 128;  // one warpgroup

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// a register A operand is read by the tensor cores until its group's
// wgmma.wait: keep it live to this point
template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A fragments of a 64 x 64 accumulator tile rounded to bf16: a[4kk ..
// 4kk + 3] are the A operand of rows x columns 16kk .. 16kk + 15
__device__ __forceinline__ void to_a_frags(const float (&f)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
}

// bytes of one bf16 tile of 64 rows
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes() { return TILE * padded<D>() * 2; }

// dQ: Q, dO, and K and V in a two-stage ring
template <int D>
constexpr size_t dq_smem() { return 6 * (size_t)tile_bytes<D>(); }

// dK / dV: K, V, Q and dO in a two-stage ring, and the ring's lse and Delta
template <int D>
constexpr size_t dkdv_smem() { return 6 * (size_t)tile_bytes<D>() + 4 * TILE * sizeof(float); }

// q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D]; lse, delta [B, H, Sq].
// grid (B * H, 64-row query tiles); c = scale * log2(e)
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          bf16* __restrict__ dq, float* __restrict__ delta, int H, int KV,
                          int Sq, int Skv, float c, float scale, int causal) {
  constexpr int NDC = D / 8;  // 16-byte chunks of a row
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_base = smem_u32(smem_raw), do_base = q_base + TB;
  const uint32_t k_base = do_base + TB, v_base = k_base + 2 * TB;

  const int tid = threadIdx.x, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
  const int r0 = (tid >> 5) * 16 + gr;  // this thread's rows r0 and r0 + 8 of the tile
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, g = h / (H / KV);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TILE;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D, koff = ((size_t)b * Skv * KV + g) * D;
  const bf16 *kg = k + koff, *vg = v + koff;
  const size_t rowbase = ((size_t)b * H + h) * Sq;
  // keys at or past q0 + TILE are above the diagonal for every row of the tile
  const int kend = causal ? min(Skv, q0 + TILE) : Skv;
  const int ntiles = (kend + TILE - 1) / TILE;

  load_tile<D, THREADS>(q_base, q + qoff, qstride, q0, Sq, tid);
  load_tile<D, THREADS>(do_base, dout + qoff, qstride, q0, Sq, tid);
  load_tile<D, THREADS>(k_base, kg, kstride, 0, Skv, tid);
  load_tile<D, THREADS>(v_base, vg, kstride, 0, Skv, tid);
  cp_async_commit();

  // while the copies fly: Delta = rowsum(dO * O) of this thread's two rows
  // (the row's 4 lanes split its 16-byte chunks), written out for dK / dV,
  // and -lse * log2(e) (-inf past Sq: P = 0)
  float dl[2], nb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    float acc = 0.f;
    if (qi < Sq) {
      const bf16* orow = o + qoff + (size_t)qi * qstride;
      const bf16* drow = dout + qoff + (size_t)qi * qstride;
#pragma unroll
      for (int i = 0; i < (NDC + 3) / 4; ++i) {
        const int ch = gc + 4 * i;
        if (ch < NDC) {
          const uint4 a = *reinterpret_cast<const uint4*>(orow + ch * 8);
          const uint4 d = *reinterpret_cast<const uint4*>(drow + ch * 8);
          const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
          const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 fa = __bfloat1622float2(pa[e]), fd = __bfloat1622float2(pd[e]);
            acc = fmaf(fd.x, fa.x, acc);
            acc = fmaf(fd.y, fa.y, acc);
          }
        }
      }
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    dl[j] = acc;
    nb[j] = qi < Sq ? -lse[rowbase + qi] * LOG2E : -INFINITY;
    if (gc == 0 && qi < Sq) delta[rowbase + qi] = acc;
  }

  // the dQ fragment: acc[4n + e] is row r0 + 8 (e / 2), column 8n + 2gc + e % 2
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    if (t + 1 < ntiles) {  // the next tile's copy runs under this tile's products
      load_tile<D, THREADS>(k_base + (st ^ 1) * TB, kg, kstride, (t + 1) * TILE, Skv, tid);
      load_tile<D, THREADS>(v_base + (st ^ 1) * TB, vg, kstride, (t + 1) * TILE, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();   // every group but the newest: tile t has landed
    fence_proxy_async();  // the copies' writes, visible to the tensor cores' reads
    __syncthreads();

    const int k0 = t * TILE;
    const uint32_t kb = k_base + st * TB, vb = v_base + st * TB;
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(q_base, kk), desc_k(kb, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(do_base, kk), desc_k(vb, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // a tile on the diagonal or past Skv
    const bool masked = (causal && k0 + TILE - 1 > q0) || k0 + TILE > Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], c, nb[j]));
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * gc + (i & 1), row = q0 + r0 + 8 * j;
        if (key >= Skv || (causal && key > row)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[j]);
    }
    uint32_t a[16];
    to_a_frags(dp, a);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_mn(kb, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    keep_regs(a);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    if (qi >= Sq) continue;
    bf16* row = dq + qoff + (size_t)qi * qstride + 2 * gc;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * j] * scale, acc[4 * n + 2 * j + 1] * scale);
  }
}

// k, v, dk, dv [B, Skv, KV, D]; q, dout [B, Sq, H, D]; lse, delta [B, H, Sq].
// grid (B * KV, 64-key tiles); c = scale * log2(e)
template <int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq,
                            int Skv, float c, float scale, int causal) {
  constexpr uint32_t TB = tile_bytes<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t k_base = smem_u32(smem_raw), v_base = k_base + TB;
  const uint32_t q_base = v_base + TB, do_base = q_base + 2 * TB;
  float* Ls = reinterpret_cast<float*>(smem_raw + 6 * TB);  // [2][TILE] lse
  float* Dl = Ls + 2 * TILE;                                // [2][TILE] Delta

  const int tid = threadIdx.x, lane = tid & 31, gr = lane >> 2, gc = lane & 3;
  const int r0 = (tid >> 5) * 16 + gr;  // this thread's keys r0 and r0 + 8 of the tile
  const int bkv = blockIdx.x, b = bkv / KV, g = bkv - b * KV, G = H / KV;
  const int k0 = blockIdx.y * TILE;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D;
  const size_t koff = ((size_t)b * Skv * KV + g) * D;
  // query tiles before the one holding k0 see none of this tile's keys
  const int qt0 = causal ? k0 / TILE : 0;
  const int nq = max(0, (Sq + TILE - 1) / TILE - qt0), nit = G * nq;

  load_tile<D, THREADS>(k_base, k + koff, kstride, k0, Skv, tid);
  load_tile<D, THREADS>(v_base, v + koff, kstride, k0, Skv, tid);
  // iteration it: query head g G + it / nq, query tile qt0 + it % nq
  auto load_q = [&](int it, int st) {
    const int h = g * G + it / nq, q0 = (qt0 + it % nq) * TILE;
    const size_t qoff = ((size_t)b * Sq * H + h) * D, rowbase = ((size_t)b * H + h) * Sq;
    load_tile<D, THREADS>(q_base + st * TB, q + qoff, qstride, q0, Sq, tid);
    load_tile<D, THREADS>(do_base + st * TB, dout + qoff, qstride, q0, Sq, tid);
    const int r = tid & (TILE - 1), qi = q0 + r;
    const float* src = (tid < TILE ? lse : delta) + rowbase + (qi < Sq ? qi : 0);
    cp_async4(smem_u32((tid < TILE ? Ls : Dl) + st * TILE + r), src, qi < Sq);
  };
  if (nit > 0) load_q(0, 0);
  cp_async_commit();

  // the dK and dV fragments: [4n + e] is key r0 + 8 (e / 2), column 8n + 2gc + e % 2
  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  fence_regs(adk);
  fence_regs(adv);

  for (int it = 0; it < nit; ++it) {
    const int st = it & 1;
    if (it + 1 < nit) load_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const int q0 = (qt0 + it % nq) * TILE;
    const uint32_t qb = q_base + st * TB, dob = do_base + st * TB;
    // S^T and dP^T: rows are this tile's keys, columns the query tile's rows
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, desc_k(k_base, kk), desc_k(qb, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(v_base, kk), desc_k(dob, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    // a tile on the diagonal or past Sq
    const bool masked = (causal && q0 < k0 + TILE - 1) || q0 + TILE > Sq;
    const float* ls = Ls + st * TILE;
    const float* dls = Dl + st * TILE;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int col = 8 * n + 2 * gc + e2;
        const float nbc = -ls[col] * LOG2E, dlc = dls[col];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = 4 * n + 2 * r + e2;
          float p = exp2_approx(fmaf(s[i], c, nbc));
          if (masked && (q0 + col >= Sq || (causal && k0 + r0 + 8 * r > q0 + col))) p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dlc);
        }
      }
    uint32_t pa[16], da[16];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    fence_regs(adk);
    fence_regs(adv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(adv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               desc_mn(dob, kk));
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(adk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
               desc_mn(qb, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(adk);
    fence_regs(adv);
    keep_regs(pa);
    keep_regs(da);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kj = k0 + r0 + 8 * j;
    if (kj >= Skv) continue;
    const size_t off = koff + (size_t)kj * kstride + 2 * gc;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(adk[4 * n + 2 * j] * scale, adk[4 * n + 2 * j + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(adv[4 * n + 2 * j], adv[4 * n + 2 * j + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int B, int H, int KV, int Sq, int Skv,
              float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dq_wgmma_kernel<D>;
  constexpr size_t smem = dq_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (Sq + TILE - 1) / TILE;
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3(B * H, ntiles), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, static_cast<bf16*>(dq),
      delta, H, KV, Sq, Skv, scale * LOG2E, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                int KV, int Sq, int Skv, float scale, int causal, cudaStream_t stream) {
  auto kern = flash_bwd_dkdv_wgmma_kernel<D>;
  constexpr size_t smem = dkdv_smem<D>();
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (Skv + TILE - 1) / TILE;
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3(B * KV, ntiles), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, KV, Sq, Skv, scale * LOG2E, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

bool dims_ok(int D) { return D == 32 || D == 64 || D == 112 || D == 128; }

}  // namespace

#define FLASH_BWD_DISPATCH(FN, ...)                                              \
  switch (D) {                                                                  \
    case 32: return dtype ? wg::FN<32>(__VA_ARGS__) : FN<float, 32>(__VA_ARGS__);    \
    case 64: return dtype ? wg::FN<64>(__VA_ARGS__) : FN<float, 64>(__VA_ARGS__);    \
    case 112: return dtype ? wg::FN<112>(__VA_ARGS__) : FN<float, 112>(__VA_ARGS__); \
    case 128: return dtype ? wg::FN<128>(__VA_ARGS__) : FN<float, 128>(__VA_ARGS__); \
  }                                                                             \
  return (int)cudaErrorInvalidValue;

// q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D] contiguous, float32
// (dtype 0, the scalar kernel) or bfloat16 (dtype 1, the wgmma kernel; every
// pointer 16-byte aligned); lse (read) and delta (written) float32 [B, H,
// Sq]. D in {32, 64, 112, 128} (Dv == D); H a multiple of KV. Returns the
// launch's CUDA error code (0 on success).
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
