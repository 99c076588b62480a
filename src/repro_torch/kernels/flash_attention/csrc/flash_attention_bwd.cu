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
// aligned; with `window` > 0 only keys with i - j < window, as
// src/repro/models/attention.py:47-48 / :134-135), a float32 softmax, o = P v.
//
// Every kernel recomputes P = exp(scale * q.k - lse) in float32 from the
// log-sum-exp that the forward wrote (float32 [B, H, Sq]; +inf for a row that
// saw no key, whose P, and so its gradients, are 0), so no [Sq, Skv] matrix
// is stored:
//   dV = P^T dO,   dP = dO V^T,   dS = P * (dP - Delta),   Delta = rowsum(dO * O),
//   dQ = scale * dS K,   dK = scale * dS^T Q.
// q, k, dq and dk carry the head dim D, v, o, dout and dv the head dim Dv.
// Two kernels, launched in this order on one stream:
// * dQ: one CTA per (query tile, batch * head). It computes Delta for its
//   rows (and writes it out), then loops over the key tiles that hold a key
//   some row sees (with `causal`, those that start at or before its last
//   row; with `window`, from the tile of key q0 - window + 1 on),
//   accumulating dQ in registers;
// * dK / dV: one CTA per (key tile, batch * KV head). It loops over the G
//   query heads of its group and over the query tiles that see one of its
//   keys (with `causal`, from the tile of its first key on; with `window`,
//   up to the tile of query k0 + 63 + window - 1), reading Delta, and sums
//   dK and dV for the whole group in registers.
// Only the tiles on the diagonal, on a window's edge or past Sq / Skv are
// masked. Nothing crosses CTAs: there are no atomics, and two runs give
// equal bits. The dQ pass recomputes S and dP, so the pair runs seven
// products where a kernel with an atomic dQ runs five: the price of equal
// bits.
//
// One pair of kernels for each dtype (a dispatch, not a fallback).
//
// bfloat16: every product on the tensor cores through the forward's two
// `wgmma` forms (`wgmma.cuh`; bf16 operands, float32 accumulation; P and dS
// rounded to bf16 in registers before the products that take them). The
// window is a template flag (`WINDOW`), so the instances without it compile
// as they did before it existed.
// * D = Dv in {32, 64, 112, 128}: `flash_bwd_dq_wgmma_kernel` and
//   `flash_bwd_dkdv_wgmma_kernel`, one warpgroup (128 threads) a CTA. At
//   Phi-4-mini's training shape (B 4, S 512, 24 / 8 heads, D 128, causal) the
//   seven products are ~2.5e10 FLOP with the diagonal tiles whole, ~25 us at
//   989 TFLOP/s, against ~67 MB of operands (20 us at 3.35 TB/s): bound by
//   operations. bf16 tiles of 64 rows in shared memory in the
//   128-byte-swizzled layout, fed by `cp.async`; the tile the CTA owns (Q
//   and dO, or K and V) is loaded once, the tiles it walks go through a
//   two-stage ring, the next tile's copy running under this tile's products.
//   96 KB at D = 128 (97 KB for dK / dV): two CTAs an SM. dQ: S = Q K^T and
//   dP = dO V^T (`wgmma_ss_n64`, all K-major), then in registers P = 2^(S c
//   - lse log2(e)) with c = scale log2(e) (one FFMA, one ex2; a row whose lse
//   is +inf gets P = 0) and dS = P (dP - Delta) in float32, rounded to bf16
//   as the A fragment of dQ += dS K (`wgmma_rs`, K through its MN-major
//   descriptor). With `causal`, the grid's y counts from the last query
//   tile, so the tiles with the most keys start first. dK / dV: S^T = K Q^T
//   and dP^T = V dO^T (ss), P^T and dS^T in registers (each thread's 16
//   query columns read their lse and Delta from shared memory, copied with
//   the tile), then dV += bf16(P^T) dO and dK += bf16(dS^T) Q (rs, dO and Q
//   MN-major). The grid's y is the key tile, so with `causal` the tiles with
//   the most query tiles start first. dK and dV hold 64 + 64 floats a thread
//   at D = 128, S^T and dP^T 32 + 32;
// * D = Dv = 256 (Gemma 3) and D = 192 with Dv = 128 (MLA):
//   `flash_bwd_dq_wide_kernel` and `flash_bwd_dkdv_wide_kernel`, two
//   warpgroups a CTA. One warpgroup cannot hold the accumulators: dK and dV
//   take 128 + 128 floats a thread at D = 256, 96 + 64 at 192 / 128, before
//   S^T and dP^T. Each warpgroup owns half of the output columns (dQ and dK:
//   128 columns, the second half of a D = 192 row running past the row into
//   columns it never stores, read from a tile padded to 256 columns; dV: Dv
//   / 2) and computes the whole S and dP (S^T and dP^T) tile itself, so both
//   warpgroups issue the same wgmmas on their own operands (no branch on the
//   warpgroup's index: ptxas serializes wgmmas on one, C7520). The shared
//   products are run twice: the price of the simple design. 192 / 193 KB at
//   D = 256, 136 / 137 KB at 192 / 128: one CTA an SM.
//
// float32: `flash_bwd_dq_kernel` and `flash_bwd_dkdv_kernel`, scalar float32
// FMAs out of shared memory (the tensor cores would compute in TF32, outside
// the float32 tolerance): 256 threads (16 x 16), each owning a BR/16 x BR/16
// block of the BR x BR score tile and BR/16 rows x D/16 (Dv/16) columns of
// its accumulators; BR = 64, or 32 at D = Dv = 256, where four 64-row float32
// tiles would take 263 KB of the SM's 227. The window is a template flag
// here too, so the instances without it run no window test. No training
// path runs float32 attention on the card but the checks against the CPU.
//
// D = Dv in {32, 64, 112, 128, 256}, or D = 192 with Dv = 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int NT = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// rows of a float32 tile: 64, or 32 where four 64-row tiles would not fit
template <int D, int DV>
__host__ __device__ constexpr int f32_rows() { return D + DV > 384 ? 32 : 64; }

// rows r0 .. r0 + ROWS - 1 of a [rows, COLS] slab with row stride `stride`
// into a float tile of row pitch COLS + 1; rows past `rows` are zero
template <typename T, int COLS, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t stride, int r0,
                                      int rows, int tid) {
  for (int e = tid; e < ROWS * COLS; e += NT) {
    const int r = e / COLS, c = e - r * COLS, gr = r0 + r;
    dst[r * (COLS + 1) + c] = gr < rows ? to_f(src[(size_t)gr * stride + c]) : 0.f;
  }
}

template <int D, int DV>
constexpr size_t dq_smem() {
  constexpr size_t BR = f32_rows<D, DV>();
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BR * (DV + 1) + BR * (BR + 1));
}

template <int D, int DV>
constexpr size_t dkdv_smem() {
  constexpr size_t BR = f32_rows<D, DV>();
  return sizeof(float) * (2 * BR * (D + 1) + 2 * BR * (DV + 1) + 2 * BR * (BR + 1) + 2 * BR);
}

// whether key kpos is visible to query qpos
template <bool WINDOW>
__device__ __forceinline__ bool visible(int qpos, int kpos, int causal, int window) {
  return (!causal || qpos >= kpos) && (!WINDOW || qpos - kpos < window);
}

// q, dq [B, Sq, H, D]; o, dout [B, Sq, H, DV]; k [B, Skv, KV, D]; v [B, Skv,
// KV, DV]; lse, delta [B, H, Sq]. grid (query tiles, B * H)
template <typename T, int D, int DV, bool WINDOW>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    float* __restrict__ delta, int H, int KV, int Sq, int Skv, float scale,
                    int causal, int window) {
  constexpr int BR = f32_rows<D, DV>(), RT = BR / 16;
  constexpr int DP = D + 1, DVP = DV + 1, NC = D / 16, NCV = DV / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // [BR][DP]
  float* dOs = Qs + BR * DP;    // [BR][DVP]
  float* Ks = dOs + BR * DVP;   // [BR][DP]
  float* Vs = Ks + BR * DP;     // [BR][DVP]
  float* dSs = Vs + BR * DVP;   // [BR][BR + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H, g = h / (H / KV);
  const int q0 = blockIdx.x * BR;
  const size_t qstride = (size_t)H * D, ostride = (size_t)H * DV;
  const size_t kstride = (size_t)KV * D, vstride = (size_t)KV * DV;
  const T* qg = q + ((size_t)b * Sq * H + h) * D;
  const T* og = o + ((size_t)b * Sq * H + h) * DV;
  const T* dog = dout + ((size_t)b * Sq * H + h) * DV;
  const T* kg = k + ((size_t)b * Skv * KV + g) * D;
  const T* vg = v + ((size_t)b * Skv * KV + g) * DV;
  const size_t rowbase = ((size_t)b * H + h) * Sq;

  stage<T, D, BR>(Qs, qg, qstride, q0, Sq, tid);
  stage<T, DV, BR>(dOs, dog, ostride, q0, Sq, tid);

  // Delta = rowsum(dO * O) of this thread's rows, and their log-sum-exp
  float dl[RT], ls[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + ty + 16 * i;
    float acc = 0.f;
    if (qi < Sq) {
#pragma unroll
      for (int c = 0; c < NCV; ++c) {
        const size_t off = (size_t)qi * ostride + tx + 16 * c;
        acc = fmaf(to_f(dog[off]), to_f(og[off]), acc);
      }
    }
    dl[i] = row_sum16(acc);
    ls[i] = qi < Sq ? lse[rowbase + qi] : INFINITY;
    if (tx == 0 && qi < Sq) delta[rowbase + qi] = dl[i];
  }

  float acc[RT][NC];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  // keys at or past q0 + BR are above the diagonal for every row of the
  // tile; keys at or before q0 - window are outside every row's window
  const int kend = causal ? min(Skv, q0 + BR) : Skv;
  const int kbeg = WINDOW ? max(0, q0 - window + 1) / BR * BR : 0;
  for (int k0 = kbeg; k0 < kend; k0 += BR) {
    __syncthreads();  // the previous tile's readers are done with Ks / Vs / dSs
    stage<T, D, BR>(Ks, kg, kstride, k0, Skv, tid);
    stage<T, DV, BR>(Vs, vg, vstride, k0, Skv, tid);
    __syncthreads();

    float s[RT][RT], dp[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) s[i][j] = dp[i][j] = 0.f;
    if constexpr (D == DV) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RT], dov[RT], kv[RT], vv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          qv[i] = Qs[(ty + 16 * i) * DP + d];
          dov[i] = dOs[(ty + 16 * i) * DVP + d];
        }
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          kv[j] = Ks[(tx + 16 * j) * DP + d];
          vv[j] = Vs[(tx + 16 * j) * DVP + d];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
          }
      }
    } else {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qv[RT], kv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
        for (int j = 0; j < RT; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll 4
      for (int d = 0; d < DV; ++d) {
        float dov[RT], vv[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) dov[i] = dOs[(ty + 16 * i) * DVP + d];
#pragma unroll
        for (int j = 0; j < RT; ++j) vv[j] = Vs[(tx + 16 * j) * DVP + d];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < RT; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = qpos < Sq && kpos < Skv && visible<WINDOW>(qpos, kpos, causal, window);
        const float p = ok ? expf(s[i][j] * scale - ls[i]) : 0.f;
        dSs[(ty + 16 * i) * (BR + 1) + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BR; ++kk) {
      float ds[RT], kv[NC];
#pragma unroll
      for (int i = 0; i < RT; ++i) ds[i] = dSs[(ty + 16 * i) * (BR + 1) + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    T* row = dq + (size_t)qi * qstride + ((size_t)b * Sq * H + h) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// k, dk [B, Skv, KV, D]; v, dv [B, Skv, KV, DV]; q [B, Sq, H, D]; dout [B,
// Sq, H, DV]; lse, delta [B, H, Sq]. grid (key tiles, B * KV)
template <typename T, int D, int DV, bool WINDOW>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int Sq, int Skv,
                      float scale, int causal, int window) {
  constexpr int BR = f32_rows<D, DV>(), RT = BR / 16;
  constexpr int DP = D + 1, DVP = DV + 1, NC = D / 16, NCV = DV / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // [BR][DP]
  float* Vs = Ks + BR * DP;         // [BR][DVP]
  float* Qs = Vs + BR * DVP;        // [BR][DP]
  float* dOs = Qs + BR * DP;        // [BR][DVP]
  float* Ps = dOs + BR * DVP;       // [BR][BR + 1]: P^T
  float* dSs = Ps + BR * (BR + 1);  // [BR][BR + 1]: dS^T
  float* Ls = dSs + BR * (BR + 1);  // [BR] log-sum-exp
  float* Dl = Ls + BR;              // [BR] Delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / KV, g = blockIdx.y - b * KV, G = H / KV;
  const int k0 = blockIdx.x * BR;
  const size_t qstride = (size_t)H * D, ostride = (size_t)H * DV;
  const size_t kstride = (size_t)KV * D, vstride = (size_t)KV * DV;
  const size_t koff = ((size_t)b * Skv * KV + g) * D, voff = ((size_t)b * Skv * KV + g) * DV;
  stage<T, D, BR>(Ks, k + koff, kstride, k0, Skv, tid);
  stage<T, DV, BR>(Vs, v + voff, vstride, k0, Skv, tid);

  float adk[RT][NC], adv[RT][NCV];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[i][c] = 0.f;
#pragma unroll
    for (int c = 0; c < NCV; ++c) adv[i][c] = 0.f;
  }

  // rows before k0 see none of this tile's keys; nor do rows at or past
  // k0 + BR - 1 + window
  const int qbeg = causal ? k0 : 0;
  const int qend = WINDOW ? min(Sq, k0 + BR - 1 + window) : Sq;
  for (int hh = 0; hh < G; ++hh) {
    const int h = g * G + hh;
    const size_t qoff = ((size_t)b * Sq * H + h) * D, ooff = ((size_t)b * Sq * H + h) * DV;
    const size_t rowbase = ((size_t)b * H + h) * Sq;
    for (int q0 = qbeg; q0 < qend; q0 += BR) {
      __syncthreads();  // the previous tile's readers are done
      stage<T, D, BR>(Qs, q + qoff, qstride, q0, Sq, tid);
      stage<T, DV, BR>(dOs, dout + ooff, ostride, q0, Sq, tid);
      if (tid < BR) {
        const int qi = q0 + tid;
        Ls[tid] = qi < Sq ? lse[rowbase + qi] : INFINITY;
        Dl[tid] = qi < Sq ? delta[rowbase + qi] : 0.f;
      }
      __syncthreads();

      // s^T and dP^T: rows are this thread's keys, columns its queries
      float s[RT][RT], dp[RT][RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) s[i][j] = dp[i][j] = 0.f;
      if constexpr (D == DV) {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[RT], vv[RT], qv[RT], dov[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            kv[i] = Ks[(ty + 16 * i) * DP + d];
            vv[i] = Vs[(ty + 16 * i) * DVP + d];
          }
#pragma unroll
          for (int j = 0; j < RT; ++j) {
            qv[j] = Qs[(tx + 16 * j) * DP + d];
            dov[j] = dOs[(tx + 16 * j) * DVP + d];
          }
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j) {
              s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
              dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
            }
        }
      } else {
#pragma unroll 4
        for (int d = 0; d < D; ++d) {
          float kv[RT], qv[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) kv[i] = Ks[(ty + 16 * i) * DP + d];
#pragma unroll
          for (int j = 0; j < RT; ++j) qv[j] = Qs[(tx + 16 * j) * DP + d];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j) s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
        }
#pragma unroll 4
        for (int d = 0; d < DV; ++d) {
          float vv[RT], dov[RT];
#pragma unroll
          for (int i = 0; i < RT; ++i) vv[i] = Vs[(ty + 16 * i) * DVP + d];
#pragma unroll
          for (int j = 0; j < RT; ++j) dov[j] = dOs[(tx + 16 * j) * DVP + d];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < RT; ++j) dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RT; ++j) {
          const int ql = tx + 16 * j, qpos = q0 + ql;
          const bool ok = qpos < Sq && kpos < Skv && visible<WINDOW>(qpos, kpos, causal, window);
          const float p = ok ? expf(s[i][j] * scale - Ls[ql]) : 0.f;
          Ps[(ty + 16 * i) * (BR + 1) + ql] = p;
          dSs[(ty + 16 * i) * (BR + 1) + ql] = p * (dp[i][j] - Dl[ql]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BR; ++qq) {
        float pv[RT], dsv[RT], dov[NCV], qv[NC];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          pv[i] = Ps[(ty + 16 * i) * (BR + 1) + qq];
          dsv[i] = dSs[(ty + 16 * i) * (BR + 1) + qq];
        }
#pragma unroll
        for (int c = 0; c < NCV; ++c) dov[c] = dOs[qq * DVP + tx + 16 * c];
#pragma unroll
        for (int c = 0; c < NC; ++c) qv[c] = Qs[qq * DP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int c = 0; c < NCV; ++c) adv[i][c] = fmaf(pv[i], dov[c], adv[i][c]);
#pragma unroll
          for (int c = 0; c < NC; ++c) adk[i][c] = fmaf(dsv[i], qv[c], adk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int kj = k0 + ty + 16 * i;
    if (kj >= Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dk[koff + (size_t)kj * kstride + tx + 16 * c] = from_f<T>(adk[i][c] * scale);
#pragma unroll
    for (int c = 0; c < NCV; ++c)
      dv[voff + (size_t)kj * vstride + tx + 16 * c] = from_f<T>(adv[i][c]);
  }
}

template <typename T, int D, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int B, int H, int KV, int Sq, int Skv,
              float scale, int causal, int window, cudaStream_t stream) {
  constexpr int BR = f32_rows<D, DV>();
  constexpr size_t smem = dq_smem<D, DV>();
  auto go = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((Sq + BR - 1) / BR, B * H), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq),
        delta, H, KV, Sq, Skv, scale, causal, window);
    return (int)cudaGetLastError();
  };
  return window ? go(flash_bwd_dq_kernel<T, D, DV, true>)
                : go(flash_bwd_dq_kernel<T, D, DV, false>);
}

template <typename T, int D, int DV>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                int KV, int Sq, int Skv, float scale, int causal, int window,
                cudaStream_t stream) {
  constexpr int BR = f32_rows<D, DV>();
  constexpr size_t smem = dkdv_smem<D, DV>();
  auto go = [&](auto kern) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<dim3((Skv + BR - 1) / BR, B * KV), NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), H,
        KV, Sq, Skv, scale, causal, window);
    return (int)cudaGetLastError();
  };
  return window ? go(flash_bwd_dkdv_kernel<T, D, DV, true>)
                : go(flash_bwd_dkdv_kernel<T, D, DV, false>);
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace wg {

constexpr int THREADS = 128;  // one warpgroup
constexpr int HALF = 128;     // dQ / dK columns of a warpgroup in the two-warpgroup kernels

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

// the two-warpgroup kernels: K (dQ) or Q (dK / dV) padded to 2 x HALF columns
template <int D, int DV>
constexpr size_t dq_wide_smem() {
  return tile_bytes<D>() + tile_bytes<DV>() + 2 * (size_t)tile_bytes<2 * HALF>() +
         2 * (size_t)tile_bytes<DV>();
}
template <int D, int DV>
constexpr size_t dkdv_wide_smem() {
  return dq_wide_smem<D, DV>() + 4 * TILE * sizeof(float);
}

// Delta = rowsum(dO * O) of a row over its DV columns (the two-warpgroup dQ
// kernel's; the one-warpgroup kernel keeps its own copy of this loop), the
// row's 4 lanes splitting its 16-byte chunks; 0 where !ok
template <int DV>
__device__ __forceinline__ float row_delta(const bf16* orow, const bf16* drow, bool ok,
                                           int gc) {
  constexpr int NDC = DV / 8;  // 16-byte chunks of a row
  float acc = 0.f;
  if (ok) {
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
  return acc;
}

// q, o, dout, dq [B, Sq, H, D]; k, v [B, Skv, KV, D]; lse, delta [B, H, Sq].
// grid (B * H, 64-row query tiles); c = scale * log2(e)
template <int D, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ o,
                          const bf16* __restrict__ dout, const float* __restrict__ lse,
                          bf16* __restrict__ dq, float* __restrict__ delta, int H, int KV,
                          int Sq, int Skv, float c, float scale, int causal, int window) {
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
  // keys at or past q0 + TILE are above the diagonal for every row of the
  // tile; keys at or before q0 - window are outside every row's window
  const int kend = causal ? min(Skv, q0 + TILE) : Skv;
  const int ntiles = (kend + TILE - 1) / TILE;
  const int t0 = WINDOW ? max(0, q0 - window + 1) / TILE : 0;

  load_tile<D, THREADS>(q_base, q + qoff, qstride, q0, Sq, tid);
  load_tile<D, THREADS>(do_base, dout + qoff, qstride, q0, Sq, tid);
  load_tile<D, THREADS>(k_base, kg, kstride, t0 * TILE, Skv, tid);
  load_tile<D, THREADS>(v_base, vg, kstride, t0 * TILE, Skv, tid);
  cp_async_commit();

  // while the copies fly: Delta of this thread's two rows, written out for
  // dK / dV, and -lse * log2(e) (-inf past Sq: P = 0)
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

  for (int t = t0; t < ntiles; ++t) {
    const int st = (t - t0) & 1;
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

    // a tile on the diagonal, on the window's edge or past Skv
    const bool masked = (causal && k0 + TILE - 1 > q0) ||
                        (WINDOW && q0 + TILE - 1 - k0 >= window) || k0 + TILE > Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], c, nb[j]));
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * gc + (i & 1), row = q0 + r0 + 8 * j;
        if (key >= Skv || (causal && key > row) || (WINDOW && row - key >= window)) p = 0.f;
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
template <int D, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdv_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq,
                            int Skv, float c, float scale, int causal, int window) {
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
  // query tiles before the one holding k0 see none of this tile's keys, nor
  // do those past the one holding query k0 + TILE - 1 + window - 1
  const int qt0 = causal ? k0 / TILE : 0;
  const int nq = max(0, (WINDOW ? min((Sq + TILE - 1) / TILE, (k0 + TILE + window - 2) / TILE + 1)
                                : (Sq + TILE - 1) / TILE) - qt0), nit = G * nq;

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

    // a tile on the diagonal, on the window's edge or past Sq
    const bool masked = (causal && q0 < k0 + TILE - 1) ||
                        (WINDOW && q0 + TILE - 1 - k0 >= window) || q0 + TILE > Sq;
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
          if (masked && (q0 + col >= Sq || (causal && k0 + r0 + 8 * r > q0 + col) ||
                         (WINDOW && q0 + col - (k0 + r0 + 8 * r) >= window)))
            p = 0.f;
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

// The two-warpgroup dQ kernel (D = Dv = 256, D = 192 with Dv = 128): q, dq
// [B, Sq, H, D]; o, dout [B, Sq, H, DV]; k [B, Skv, KV, D]; v [B, Skv, KV,
// DV]. Warpgroup w accumulates dQ's columns HALF w .. HALF w + HALF - 1 and
// computes the whole S and dP tile itself. grid (B * H, 64-row query tiles)
template <int D, int DV, bool WINDOW>
__global__ void __launch_bounds__(2 * THREADS, 1)
flash_bwd_dq_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ o,
                         const bf16* __restrict__ dout, const float* __restrict__ lse,
                         bf16* __restrict__ dq, float* __restrict__ delta, int H, int KV,
                         int Sq, int Skv, float c, float scale, int causal, int window) {
  constexpr int NTHR = 2 * THREADS;
  constexpr uint32_t QB = tile_bytes<D>(), OB = tile_bytes<DV>();
  constexpr uint32_t KB = tile_bytes<2 * HALF>(), VB = tile_bytes<DV>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t q_base = smem_u32(smem_raw), do_base = q_base + QB;
  const uint32_t k_base = do_base + OB, v_base = k_base + 2 * KB;

  const int tid = threadIdx.x, wgi = tid / THREADS, lane = tid & 31, gr = lane >> 2;
  const int gc = lane & 3;
  const int r0 = ((tid % THREADS) >> 5) * 16 + gr;  // this thread's rows r0 and r0 + 8
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, g = h / (H / KV);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TILE;
  const size_t qstride = (size_t)H * D, ostride = (size_t)H * DV;
  const size_t kstride = (size_t)KV * D, vstride = (size_t)KV * DV;
  const size_t qoff = ((size_t)b * Sq * H + h) * D, ooff = ((size_t)b * Sq * H + h) * DV;
  const bf16* kg = k + ((size_t)b * Skv * KV + g) * D;
  const bf16* vg = v + ((size_t)b * Skv * KV + g) * DV;
  const size_t rowbase = ((size_t)b * H + h) * Sq;
  const int kend = causal ? min(Skv, q0 + TILE) : Skv;
  const int ntiles = (kend + TILE - 1) / TILE;
  const int t0 = WINDOW ? max(0, q0 - window + 1) / TILE : 0;

  load_tile<D, NTHR>(q_base, q + qoff, qstride, q0, Sq, tid);
  load_tile<DV, NTHR>(do_base, dout + ooff, ostride, q0, Sq, tid);
  load_tile<D, NTHR>(k_base, kg, kstride, t0 * TILE, Skv, tid);
  load_tile<DV, NTHR>(v_base, vg, vstride, t0 * TILE, Skv, tid);
  cp_async_commit();

  float dl[2], nb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    const size_t ro = ooff + (size_t)(qi < Sq ? qi : 0) * ostride;
    dl[j] = row_delta<DV>(o + ro, dout + ro, qi < Sq, gc);
    nb[j] = qi < Sq ? -lse[rowbase + qi] * LOG2E : -INFINITY;
    if (wgi == 0 && gc == 0 && qi < Sq) delta[rowbase + qi] = dl[j];
  }

  // this warpgroup's dQ columns: acc[4n + e] is row r0 + 8 (e / 2), column
  // HALF wgi + 8n + 2gc + e % 2
  float acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);

  for (int t = t0; t < ntiles; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < ntiles) {
      load_tile<D, NTHR>(k_base + (st ^ 1) * KB, kg, kstride, (t + 1) * TILE, Skv, tid);
      load_tile<DV, NTHR>(v_base + (st ^ 1) * VB, vg, vstride, (t + 1) * TILE, Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();

    const int k0 = t * TILE;
    const uint32_t kb = k_base + st * KB, vb = v_base + st * VB;
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
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(do_base, kk), desc_k(vb, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = (causal && k0 + TILE - 1 > q0) ||
                        (WINDOW && q0 + TILE - 1 - k0 >= window) || k0 + TILE > Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1;
      float p = exp2_approx(fmaf(s[i], c, nb[j]));
      if (masked) {
        const int key = k0 + 8 * (i >> 2) + 2 * gc + (i & 1), row = q0 + r0 + 8 * j;
        if (key >= Skv || (causal && key > row) || (WINDOW && row - key >= window)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[j]);
    }
    uint32_t a[16];
    to_a_frags(dp, a);
    // this warpgroup's half of K's columns: two 64-column blocks on
    const uint32_t kh = kb + wgi * (HALF / 64) * 8192;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3], desc_mn(kh, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    keep_regs(a);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qi = q0 + r0 + 8 * j;
    if (qi >= Sq) continue;
    bf16* row = dq + qoff + (size_t)qi * qstride + HALF * wgi + 2 * gc;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
      if (HALF * wgi + 8 * n < D)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(acc[4 * n + 2 * j] * scale, acc[4 * n + 2 * j + 1] * scale);
  }
}

// The two-warpgroup dK / dV kernel: k, dk [B, Skv, KV, D]; v, dv [B, Skv,
// KV, DV]; q [B, Sq, H, D]; dout [B, Sq, H, DV]. Warpgroup w accumulates dK's
// columns HALF w .. HALF w + HALF - 1 and dV's DV / 2 w .. DV / 2 (w + 1) - 1,
// and computes the whole S^T and dP^T tile itself. grid (B * KV, 64-key tiles)
template <int D, int DV, bool WINDOW>
__global__ void __launch_bounds__(2 * THREADS, 1)
flash_bwd_dkdv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV, int Sq,
                           int Skv, float c, float scale, int causal, int window) {
  constexpr int NTHR = 2 * THREADS, DVH = DV / 2;  // dV columns of a warpgroup
  constexpr uint32_t KB = tile_bytes<D>(), VB = tile_bytes<DV>();
  constexpr uint32_t QB = tile_bytes<2 * HALF>(), OB = tile_bytes<DV>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t k_base = smem_u32(smem_raw), v_base = k_base + KB;
  const uint32_t q_base = v_base + VB, do_base = q_base + 2 * QB;
  float* Ls = reinterpret_cast<float*>(smem_raw + KB + VB + 2 * QB + 2 * OB);  // [2][TILE]
  float* Dl = Ls + 2 * TILE;                                                   // [2][TILE]

  const int tid = threadIdx.x, wgi = tid / THREADS, lane = tid & 31, gr = lane >> 2;
  const int gc = lane & 3;
  const int r0 = ((tid % THREADS) >> 5) * 16 + gr;  // this thread's keys r0 and r0 + 8
  const int bkv = blockIdx.x, b = bkv / KV, g = bkv - b * KV, G = H / KV;
  const int k0 = blockIdx.y * TILE;
  const size_t qstride = (size_t)H * D, ostride = (size_t)H * DV;
  const size_t kstride = (size_t)KV * D, vstride = (size_t)KV * DV;
  const size_t koff = ((size_t)b * Skv * KV + g) * D, voff = ((size_t)b * Skv * KV + g) * DV;
  const int qt0 = causal ? k0 / TILE : 0;
  const int qt1 = WINDOW ? min((Sq + TILE - 1) / TILE, (k0 + TILE + window - 2) / TILE + 1)
                         : (Sq + TILE - 1) / TILE;
  const int nq = max(0, qt1 - qt0), nit = G * nq;

  load_tile<D, NTHR>(k_base, k + koff, kstride, k0, Skv, tid);
  load_tile<DV, NTHR>(v_base, v + voff, vstride, k0, Skv, tid);
  auto load_q = [&](int it, int st) {
    const int h = g * G + it / nq, q0 = (qt0 + it % nq) * TILE;
    const size_t qoff = ((size_t)b * Sq * H + h) * D, ooff = ((size_t)b * Sq * H + h) * DV;
    const size_t rowbase = ((size_t)b * H + h) * Sq;
    load_tile<D, NTHR>(q_base + st * QB, q + qoff, qstride, q0, Sq, tid);
    load_tile<DV, NTHR>(do_base + st * OB, dout + ooff, ostride, q0, Sq, tid);
    if (tid < 2 * TILE) {
      const int r = tid & (TILE - 1), qi = q0 + r;
      const float* src = (tid < TILE ? lse : delta) + rowbase + (qi < Sq ? qi : 0);
      cp_async4(smem_u32((tid < TILE ? Ls : Dl) + st * TILE + r), src, qi < Sq);
    }
  };
  if (nit > 0) load_q(0, 0);
  cp_async_commit();

  // this warpgroup's dK and dV columns: [4n + e] is key r0 + 8 (e / 2),
  // column (HALF or DVH) wgi + 8n + 2gc + e % 2
  float adk[HALF / 2], adv[DVH / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) adk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DVH / 2; ++i) adv[i] = 0.f;
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
    const uint32_t qb = q_base + st * QB, dob = do_base + st * OB;
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
    for (int kk = 0; kk < DV / 16; ++kk)
      wgmma_ss_n64(dp, desc_k(v_base, kk), desc_k(dob, kk), kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);

    const bool masked = (causal && q0 < k0 + TILE - 1) ||
                        (WINDOW && q0 + TILE - 1 - k0 >= window) || q0 + TILE > Sq;
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
          const int i = 4 * n + 2 * r + e2, key = k0 + r0 + 8 * r;
          float p = exp2_approx(fmaf(s[i], c, nbc));
          if (masked && (q0 + col >= Sq || (causal && key > q0 + col) ||
                         (WINDOW && q0 + col - key >= window)))
            p = 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - dlc);
        }
      }
    uint32_t pa[16], da[16];
    to_a_frags(s, pa);
    to_a_frags(dp, da);
    // this warpgroup's halves of dO's and Q's columns
    const uint32_t doh = dob + wgi * (DVH / 64) * 8192, qh = qb + wgi * (HALF / 64) * 8192;
    fence_regs(adk);
    fence_regs(adv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(adv, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
               desc_mn(doh, kk));
#pragma unroll
    for (int kk = 0; kk < TILE / 16; ++kk)
      wgmma_rs(adk, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
               desc_mn(qh, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_regs(adk);
    fence_regs(adv);
    keep_regs(pa);
    keep_regs(da);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int kj = k0 + r0 + 8 * j;
    if (kj >= Skv) continue;
    bf16* krow = dk + koff + (size_t)kj * kstride + HALF * wgi + 2 * gc;
    bf16* vrow = dv + voff + (size_t)kj * vstride + DVH * wgi + 2 * gc;
#pragma unroll
    for (int n = 0; n < HALF / 8; ++n)
      if (HALF * wgi + 8 * n < D)
        *reinterpret_cast<__nv_bfloat162*>(krow + 8 * n) =
            __floats2bfloat162_rn(adk[4 * n + 2 * j] * scale, adk[4 * n + 2 * j + 1] * scale);
#pragma unroll
    for (int n = 0; n < DVH / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(vrow + 8 * n) =
          __floats2bfloat162_rn(adv[4 * n + 2 * j], adv[4 * n + 2 * j + 1]);
  }
}

// the two-warpgroup kernels take the head dims one warpgroup cannot hold
template <int D, int DV>
constexpr bool wide() { return D > 128 || DV > 128; }

// opt in to more than 48 KB of shared memory (on every launch: the
// attribute belongs to the current device) and check the grid's y
template <typename Kern>
int prepare(Kern kern, size_t smem, dim3 grid) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  return grid.y > 65535 ? (int)cudaErrorInvalidValue : 0;
}

template <int D, int DV>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, void* dq, float* delta, int B, int H, int KV, int Sq, int Skv,
              float scale, int causal, int window, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + TILE - 1) / TILE);
  auto go = [&](auto kern, size_t smem, int threads) {
    int err = prepare(kern, smem, grid);
    if (err != 0) return err;
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse,
        static_cast<bf16*>(dq), delta, H, KV, Sq, Skv, scale * LOG2E, scale, causal, window);
    return (int)cudaGetLastError();
  };
  if constexpr (wide<D, DV>()) {
    constexpr size_t smem = dq_wide_smem<D, DV>();
    return window ? go(flash_bwd_dq_wide_kernel<D, DV, true>, smem, 2 * THREADS)
                  : go(flash_bwd_dq_wide_kernel<D, DV, false>, smem, 2 * THREADS);
  } else {
    static_assert(D == DV, "one warpgroup takes D == Dv");
    return window ? go(flash_bwd_dq_wgmma_kernel<D, true>, dq_smem<D>(), THREADS)
                  : go(flash_bwd_dq_wgmma_kernel<D, false>, dq_smem<D>(), THREADS);
  }
}

template <int D, int DV>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dk, void* dv, int B, int H,
                int KV, int Sq, int Skv, float scale, int causal, int window,
                cudaStream_t stream) {
  const dim3 grid(B * KV, (Skv + TILE - 1) / TILE);
  auto go = [&](auto kern, size_t smem, int threads) {
    int err = prepare(kern, smem, grid);
    if (err != 0) return err;
    kern<<<grid, threads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), H, KV, Sq, Skv, scale * LOG2E, scale, causal, window);
    return (int)cudaGetLastError();
  };
  if constexpr (wide<D, DV>()) {
    constexpr size_t smem = dkdv_wide_smem<D, DV>();
    return window ? go(flash_bwd_dkdv_wide_kernel<D, DV, true>, smem, 2 * THREADS)
                  : go(flash_bwd_dkdv_wide_kernel<D, DV, false>, smem, 2 * THREADS);
  } else {
    static_assert(D == DV, "one warpgroup takes D == Dv");
    return window ? go(flash_bwd_dkdv_wgmma_kernel<D, true>, dkdv_smem<D>(), THREADS)
                  : go(flash_bwd_dkdv_wgmma_kernel<D, false>, dkdv_smem<D>(), THREADS);
  }
}

}  // namespace wg

// D = Dv in {32, 64, 112, 128, 256}, or D = 192 with Dv = 128
bool dims_ok(int D, int Dv) {
  return (D == Dv && (D == 32 || D == 64 || D == 112 || D == 128 || D == 256)) ||
         (D == 192 && Dv == 128);
}

}  // namespace

#define FLASH_BWD_CASE(FN, D_, DV_, ...) \
  return dtype ? wg::FN<D_, DV_>(__VA_ARGS__) : FN<float, D_, DV_>(__VA_ARGS__);

#define FLASH_BWD_DISPATCH(FN, ...)                                         \
  if (D == 192) { FLASH_BWD_CASE(FN, 192, 128, __VA_ARGS__) }              \
  switch (D) {                                                             \
    case 32: FLASH_BWD_CASE(FN, 32, 32, __VA_ARGS__)                       \
    case 64: FLASH_BWD_CASE(FN, 64, 64, __VA_ARGS__)                       \
    case 112: FLASH_BWD_CASE(FN, 112, 112, __VA_ARGS__)                    \
    case 128: FLASH_BWD_CASE(FN, 128, 128, __VA_ARGS__)                    \
    case 256: FLASH_BWD_CASE(FN, 256, 256, __VA_ARGS__)                    \
  }                                                                        \
  return (int)cudaErrorInvalidValue;

// q, dq [B, Sq, H, D]; o, dout [B, Sq, H, Dv]; k [B, Skv, KV, D]; v [B, Skv,
// KV, Dv] contiguous, float32 (dtype 0, the scalar kernel) or bfloat16 (dtype
// 1, the wgmma kernel; every pointer 16-byte aligned); lse (read) and delta
// (written) float32 [B, H, Sq]. D = Dv in {32, 64, 112, 128, 256}, or D = 192
// with Dv = 128; H a multiple of KV; window >= 0 (0: none; > 0 only with Sq
// == Skv). Returns the launch's CUDA error code (0 on success).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* dq, void* delta,
                                   int B, int H, int KV, int Sq, int Skv, int D, int Dv,
                                   int dtype, int causal, int window, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(D, Dv) || dtype < 0 || dtype > 1 || B * H > 65535 || window < 0 ||
      (window > 0 && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  FLASH_BWD_DISPATCH(launch_dq, q, k, v, o, dout, static_cast<const float*>(lse), dq,
                     static_cast<float*>(delta), B, H, KV, Sq, Skv, scale, causal, window, s)
}

// The dK / dV kernel: the same operands as `flash_bwd_dq_launch`, with the
// delta that it wrote (launch it after that call, on the same stream); dk
// [B, Skv, KV, D], dv [B, Skv, KV, Dv] in the inputs' dtype.
extern "C" int flash_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int H, int KV, int Sq, int Skv,
                                     int D, int Dv, int dtype, int causal, int window,
                                     float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(D, Dv) || dtype < 0 || dtype > 1 || B * KV > 65535 || window < 0 ||
      (window > 0 && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  FLASH_BWD_DISPATCH(launch_dkdv, q, k, v, dout, static_cast<const float*>(lse),
                     static_cast<const float*>(delta), dk, dv, B, H, KV, Sq, Skv, scale,
                     causal, window, s)
}
