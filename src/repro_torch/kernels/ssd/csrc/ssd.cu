// Mamba-2 SSD (state-space duality) chunked scan for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel `_kernel`
// (src/repro/kernels/ssd/ssd.py:21, launched by `ssd_bhqp` at :68) and
// computes `repro.models.ssm.ssd_chunked`'s function with the state carried
// in and out. For chunk c of Q steps, with cs the inclusive cumsum of dt*A
// (A = -exp(A_log)):
//   y_i   = sum_{j<=i} exp(cs_i - cs_j) dt_j (C_i . B_j) x_j     (intra)
//         + exp(cs_i) C_i . S_prev + D x_i                      (inter, skip)
//   S_new = exp(cs_Q) S_prev + sum_j exp(cs_Q - cs_j) dt_j B_j x_j^T
// Positions past S count as dt = 0 (decay 1, no contribution), so a ragged
// tail needs no padded copy and leaves the final state exact. Every input is
// read in place: x [B, S, H, P], dt [B, S, H], B and C [B, S, N] shared by
// all heads (the JAX wrapper broadcasts them to [BH, S, N]); y and the final
// state are written once, in float32.
//
// One kernel for each dtype (a dispatch, not a fallback).
//
// bfloat16: `ssd_tc_kernel`, the four products (C.B^T, M x, C.S_prev and
// the state update) on the tensor cores through `wgmma` (bf16 in, float32
// accumulate). At the serve paths' shapes it is bound by bytes: Mamba-2
// (B=4, S=512, H=24, P=64, N=128) moves ~23 MB, Zamba2 (H=112, N=64) ~97
// MB, most of it y in float32; the products at the bf16 peak take a
// fraction of that time. Measured (tools/model_kernels_chip.py, H100 80GB
// HBM3, 700 W): 0.030 ms for Mamba-2 and 0.083 ms for Zamba2, 4.3x and 2.9x
// the bound. Design:
// * precision: x, B and C are bf16, so C.B^T and every product with x as
//   one operand are exact. The three operands made in float32 (the masked
//   decay matrix M, the entering state S_prev, the weighted x w of the
//   update) enter as bf16 hi + bf16 lo, two products into one float32
//   accumulator (~16 bits of each; one bf16 or TF32 rounding misses the
//   1e-3 tolerance by 5-100x);
// * a CTA owns (batch, head, 64 columns of P) and scans its chunks in
//   order, the state [64 x N] in the accumulator registers of its update
//   (Mamba-2's 96 CTAs and Zamba2's 448 each fit 132 SMs in 1 and 3.4
//   waves). A chunk's C, B and x [128 rows] are staged by `cp.async` in the
//   128-byte-swizzled layout the wgmma descriptors read, zero past S, Q, N
//   and P, two stages deep: the next chunk's copies run under this chunk's
//   products (195 KB of shared memory at N = 128, 115 KB at N = 64);
// * two warpgroups split each chunk. The first keeps the state: S =
//   exp(cs_Q) S_prev + (x w)^T B, its A operand x read transposed by
//   ldmatrix and weighted by w_j = exp(cs_Q - cs_j) dt_j in registers, B
//   read MN-major, accumulated onto the decayed state in place; then the
//   upper half of y. The second takes the lower half. A half's y = M x +
//   exp(cs_i) C S_prev + D x: C.B^T of a 64 x 64 block (only blocks on or
//   below the diagonal) lands in the accumulator, the decay exp(cs_i -
//   cs_j) dt_j is applied there (below the diagonal as exp(cs_i - cs_63)
//   exp(cs_63 - cs_j) dt_j, each factor at most 1, no exponential per
//   element), and the accumulator layout is the A-operand layout of M x,
//   so M never touches shared memory. S_prev goes through shared memory
//   once per chunk, as hi and lo K-major tiles for C S_prev. Each wgmma
//   group pairs independent products (the state update with a C.B^T
//   block, M x with the next block's C.B^T or with C S_prev);
// * y is written once, as float2 per thread, and the final state once.
// Route: `wgmma`. `mma.sync` with `ldmatrix` measured 0.065 / 0.146 ms at
// its best: each warp re-read its operands from shared memory and stalled
// on each product's result, where `wgmma` reads them once per warpgroup.
//
// For training, each kernel has a second instance (template flag STATES)
// that also writes the state entering each chunk, float32 [B, nC, H, P, N],
// for the backward kernels (csrc/ssd_bwd.cu). A template flag and not a
// runtime branch: the serving instances compile exactly as before (a
// runtime branch on an optional output spilled the serving flash kernel).
//
// float32: `ssd_kernel`, scalar float32 FMAs out of shared memory (the
// tensor cores would round to TF32, outside the float32 tolerance). One CTA
// of 16 x 16 threads per (batch, head, P tile) loops over the chunks, the
// state tile [N, PT] resident in shared memory; B and C staged transposed
// as float32 [N][Q + 1]; one pass over n accumulates C.B^T and C.S_prev.
// No serve path runs the scan in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "ssd_wgmma.cuh"

namespace {

constexpr int NT = 256;  // 16 x 16 threads
constexpr int QMAX = 128, NMAX = 128;
constexpr int RQ = QMAX / 16, RN = NMAX / 16;  // rows per thread
constexpr unsigned FULL = 0xffffffffu;

size_t smem_floats(int Q, int N, int PT) {
  const size_t QS = Q + 1;
  const size_t cm = (size_t)N * QS > (size_t)Q * Q ? (size_t)N * QS : (size_t)Q * Q;
  return (size_t)N * QS   // Bt [N][Q + 1]
         + cm             // Ct [N][Q + 1], then M [Q][Q]
         + (size_t)Q * PT // xs [Q][PT]
         + (size_t)N * PT // state [N][PT]
         + 2 * (size_t)Q; // dt, cs
}

// x [B, S, H, P], dt [B, S, H], Bv / Cv [B, S, N], A_log / D [H], s0
// [B, H, P, N] or null; y [B, S, H, P], s_out [B, H, P, N]; all float32.
// With STATES, also the state entering each chunk, states [B, nC, H, P, N].
// Grid (B * H, ceil(P / PT)).
template <int PT, bool STATES>
__global__ void __launch_bounds__(NT)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ Bv, const float* __restrict__ Cv,
           const float* __restrict__ A_log,
           const float* __restrict__ Dp, const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ s_out, float* __restrict__ states, int S, int H, int P, int N,
           int Q) {
  constexpr int RP = PT / 16;  // P columns per thread
  extern __shared__ float smem[];
  const int QS = Q + 1;
  const int cm = N * QS > Q * Q ? N * QS : Q * Q;
  float* Bt = smem;         // [N][QS]
  float* CtM = Bt + N * QS; // Ct [N][QS], then M [Q][Q]
  float* xs = CtM + cm;     // [Q][PT]
  float* st = xs + Q * PT;  // [N][PT]
  float* dts = st + N * PT; // [Q]
  float* cs = dts + Q;      // [Q]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, h = blockIdx.x - b * H;
  const int p0 = blockIdx.y * PT;
  const float A = -expf(A_log[h]);
  const float Dh = Dp[h];

  // the entering state, transposed to [N][PT]
  for (int e = tid; e < N * PT; e += NT) {
    const int pp = e / N, n = e - pp * N, p = p0 + pp;
    st[n * PT + pp] =
        (s0 != nullptr && p < P) ? s0[(((size_t)b * H + h) * P + p) * N + n] : 0.f;
  }

  const int nC = (S + Q - 1) / Q;
  for (int c = 0; c < nC; ++c) {
    const int c0 = c * Q;
    __syncthreads();  // the previous chunk's readers are done with the staging
    if constexpr (STATES) {  // st holds the state entering chunk c until its update
      float* sc = states + ((size_t)(b * nC + c) * H + h) * P * N;
      for (int e = tid; e < N * PT; e += NT) {
        const int pp = e / N, n = e - pp * N, p = p0 + pp;
        if (p < P) sc[(size_t)p * N + n] = st[n * PT + pp];
      }
    }
    for (int j = tid; j < Q; j += NT) {
      const int s = c0 + j;
      dts[j] = s < S ? dt[((size_t)b * S + s) * H + h] : 0.f;
    }
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N, s = c0 + j;
      const size_t g = ((size_t)b * S + s) * N + n;
      Bt[n * QS + j] = s < S ? Bv[g] : 0.f;
      CtM[n * QS + j] = s < S ? Cv[g] : 0.f;
    }
    for (int e = tid; e < Q * PT; e += NT) {
      const int j = e / PT, pp = e - j * PT, s = c0 + j, p = p0 + pp;
      xs[e] = (s < S && p < P) ? x[(((size_t)b * S + s) * H + h) * P + p] : 0.f;
    }
    __syncthreads();

    // inclusive cumsum of dt * A over the chunk: warp 0, 32 steps at a time
    if (tid < 32) {
      float carry = 0.f;
      for (int j0 = 0; j0 < Q; j0 += 32) {
        const int j = j0 + tid;
        float v = j < Q ? dts[j] * A : 0.f;
        for (int off = 1; off < 32; off <<= 1) {
          const float u = __shfl_up_sync(FULL, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (j < Q) cs[j] = v;
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();

    // one pass over n: C.B^T (rows ty + 16 a, columns tx + 16 b) and the
    // inter-chunk C.S_prev (rows ty + 16 a, P columns tx + 16 b)
    float cb[RQ][RQ], yv[RQ][RP];
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
#pragma unroll
      for (int k = 0; k < RQ; ++k) cb[a][k] = 0.f;
#pragma unroll
      for (int k = 0; k < RP; ++k) yv[a][k] = 0.f;
    }
    for (int n = 0; n < N; ++n) {
      float cv[RQ], bv[RQ], sv[RP];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + 16 * a;
        cv[a] = i < Q ? CtM[n * QS + i] : 0.f;
        bv[a] = (tx + 16 * a) < Q ? Bt[n * QS + tx + 16 * a] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RP; ++k) sv[k] = st[n * PT + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
#pragma unroll
        for (int k = 0; k < RQ; ++k) cb[a][k] = fmaf(cv[a], bv[k], cb[a][k]);
#pragma unroll
        for (int k = 0; k < RP; ++k) yv[a][k] = fmaf(cv[a], sv[k], yv[a][k]);
      }
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a;
      const float e = i < Q ? expf(cs[i]) : 0.f;
#pragma unroll
      for (int k = 0; k < RP; ++k) yv[a][k] *= e;
    }
    __syncthreads();  // every thread is done reading C and S_prev

    // M[i][j] = exp(cs_i - cs_j) dt_j (C_i . B_j) for j <= i, else 0
    float* M = CtM;
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a;
      if (i >= Q) continue;
#pragma unroll
      for (int k = 0; k < RQ; ++k) {
        const int j = tx + 16 * k;
        if (j < Q) M[i * Q + j] = j <= i ? expf(cs[i] - cs[j]) * dts[j] * cb[a][k] : 0.f;
      }
    }

    // the state update: this thread's entries (n = ty + 16 a, p = tx + 16 k)
    const float cs_tot = cs[Q - 1];
    float su[RN][RP];
#pragma unroll
    for (int a = 0; a < RN; ++a)
#pragma unroll
      for (int k = 0; k < RP; ++k) su[a][k] = 0.f;
    for (int j = 0; j < Q; ++j) {
      const float wj = expf(cs_tot - cs[j]) * dts[j];
      float xv[RP];
#pragma unroll
      for (int k = 0; k < RP; ++k) xv[k] = xs[j * PT + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < RN; ++a) {
        const int n = ty + 16 * a;
        const float bw = n < N ? Bt[n * QS + j] * wj : 0.f;
#pragma unroll
        for (int k = 0; k < RP; ++k) su[a][k] = fmaf(bw, xv[k], su[a][k]);
      }
    }
    const float g = expf(cs_tot);
#pragma unroll
    for (int a = 0; a < RN; ++a) {
      const int n = ty + 16 * a;
      if (n >= N) continue;
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        float* sp = &st[n * PT + tx + 16 * k];
        *sp = fmaf(g, *sp, su[a][k]);
      }
    }
    __syncthreads();  // M is complete

    // y = intra (M x) + inter + D x, rows past S and columns past P unwritten
    for (int j = 0; j < Q; ++j) {
      float xv[RP];
#pragma unroll
      for (int k = 0; k < RP; ++k) xv[k] = xs[j * PT + tx + 16 * k];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + 16 * a;
        const float m = i < Q ? M[i * Q + j] : 0.f;
#pragma unroll
        for (int k = 0; k < RP; ++k) yv[a][k] = fmaf(m, xv[k], yv[a][k]);
      }
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a, s = c0 + i;
      if (i >= Q || s >= S) continue;
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const int pp = tx + 16 * k, p = p0 + pp;
        if (p < P)
          y[(((size_t)b * S + s) * H + h) * P + p] = fmaf(Dh, xs[i * PT + pp], yv[a][k]);
      }
    }
  }

  __syncthreads();
  for (int e = tid; e < N * PT; e += NT) {
    const int pp = e / N, n = e - pp * N, p = p0 + pp;
    if (p < P) s_out[(((size_t)b * H + h) * P + p) * N + n] = st[n * PT + pp];
  }
}

template <bool STATES>
int launch_scalar(int PT, const float* x, const float* dt, const float* Bv, const float* Cv,
                  const float* A_log, const float* D, const float* s0, float* y,
                  float* s_out, float* states, int B, int S, int H, int P, int N, int Q,
                  cudaStream_t stream) {
  auto kern = PT == 16   ? ssd_kernel<16, STATES>
              : PT == 32 ? ssd_kernel<32, STATES>
                         : ssd_kernel<64, STATES>;
  if (PT != 16 && PT != 32 && PT != 64) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(Q, N, PT) * sizeof(float);
  // opt in to more than 48 KB on every launch (the attribute is per device)
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (P + PT - 1) / PT);
  kern<<<grid, NT, smem, stream>>>(x, dt, Bv, Cv, A_log, D, s0, y, s_out, states, S, H, P, N,
                                   Q);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WG = 128;          // threads of a warpgroup
constexpr int THREADS = 2 * WG;  // two warpgroups
constexpr int ROWS = 128;        // chunk rows staged (Q <= 128, zero past Q)
constexpr int PT = 64;           // P columns per CTA
constexpr float LOG2E = 1.4426950408889634f;

// s = C B^T of the 64 x 64 block (row half hf, column block cb)
template <int NB>
__device__ __forceinline__ void cbt(float (&s)[32], uint32_t Cs, uint32_t Bs, int hf, int cb) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(s, desc_k(Cs, ROWS, 64 * hf, kk), desc_k(Bs, ROWS, 64 * cb, kk), kk > 0);
}

// M = s o exp(cs_i - cs_j) dt_j (j <= i, else 0) as the A fragments of M x,
// split into hi + lo: A fragment kk holds columns 16 kk .. 16 kk + 15 of the
// block, its registers q = (column half, row half); row: the thread's first
// accumulator row of the block's row half. A diagonal block (hf == cb)
// takes cs2 = cs log2(e) and dt and masks j > i; the block below it takes
// exp2(cs2_i - cs2_63) from the caller (`erow`, both rows) and
// exp2(cs2_63 - cs2_j) dt_j from `ecol`: each factor at most 1, and no
// exponential per element
__device__ __forceinline__ void decay(const float (&s)[32], uint32_t (&mhi)[4][4],
                                      uint32_t (&mlo)[4][4], const float* cs2,
                                      const float* dts, const float* ecol,
                                      const float (&erow)[2], int hf, int cb, int row,
                                      int gc) {
  const int ib = 64 * hf + row, jb = 64 * cb + 2 * gc;
  const float csi[2] = {cs2[ib], cs2[ib + 8]};
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = 2 * kk + (q >> 1), hr = q & 1;
      const int i = ib + 8 * hr, j = jb + 8 * t;
      const float* sv = s + 4 * t + 2 * hr;
      float v[2];
      if (hf != cb) {
        const float2 ec = *reinterpret_cast<const float2*>(ecol + j);
        v[0] = sv[0] * erow[hr] * ec.x;
        v[1] = sv[1] * erow[hr] * ec.y;
      } else {
        const float2 cj = *reinterpret_cast<const float2*>(cs2 + j);
        const float2 dj = *reinterpret_cast<const float2*>(dts + j);
        v[0] = j <= i ? sv[0] * exp2_approx(csi[hr] - cj.x) * dj.x : 0.f;
        v[1] = j + 1 <= i ? sv[1] * exp2_approx(csi[hr] - cj.y) * dj.y : 0.f;
      }
      split(v[0], v[1], mhi[kk][q], mlo[kk][q]);
    }
}

// y (+)= M x over the 64 rows of column block cb of x (MN-major), hi then lo
__device__ __forceinline__ void mx(float (&y)[32], const uint32_t (&mhi)[4][4],
                                   const uint32_t (&mlo)[4][4], uint32_t xs, int cb,
                                   bool first) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs(y, mhi[kk], desc_mn(xs, ROWS, 4 * cb + kk), !(first && kk == 0));
    wgmma_rs(y, mlo[kk], desc_mn(xs, ROWS, 4 * cb + kk));
  }
}

// z = C S_prev for the row half hf, S_prev K-major [PT x N] as hi then lo
template <int NB>
__device__ __forceinline__ void cs_prev(float (&z)[32], uint32_t Cs, uint32_t sp_hi,
                                        uint32_t sp_lo, int hf) {
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(z, desc_k(Cs, ROWS, 64 * hf, kk), desc_k(sp_hi, PT, 0, kk), kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk)
    wgmma_ss(z, desc_k(Cs, ROWS, 64 * hf, kk), desc_k(sp_lo, PT, 0, kk), 1);
}

// 64 rows of y = M x + exp(cs_i) z + D x, written once: y from the half's
// first row, es and x (swizzled, bytes) likewise; rows: the half's rows in S
__device__ __forceinline__ void write_y(float* y, const float (&yacc)[32], const float (&z)[32],
                                        const float* es, const unsigned char* gx, float Dh,
                                        int b, int h, int S, int H, int P, int p0, int c0,
                                        int rows, int row, int gc) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row + 8 * hr;
    if (i >= rows) continue;
    const float e_i = es[i];
    float* yrow = y + (((size_t)b * S + c0 + i) * H + h) * P;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int p = p0 + 8 * t + 2 * gc;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(gx + swz(ROWS, i, t) + 4 * gc));
      const float v0 = fmaf(Dh, xv.x, fmaf(e_i, z[4 * t + 2 * hr], yacc[4 * t + 2 * hr]));
      const float v1 = fmaf(Dh, xv.y, fmaf(e_i, z[4 * t + 2 * hr + 1], yacc[4 * t + 2 * hr + 1]));
      if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<float2*>(yrow + p) = make_float2(v0, v1);
      } else {
        if (p < P) yrow[p] = v0;
        if (p + 1 < P) yrow[p + 1] = v1;
      }
    }
  }
}

// Shared memory of one CTA, in bytes: two stages of C and B [ROWS x 64 NB]
// and x [ROWS x 64] bf16 and dt [ROWS]; S_prev hi, lo [PT x 64 NB] bf16;
// cs log2(e), w, exp(cs) [ROWS], column block 0's decays [64] and four
// segment sums. NB 64-column blocks of N.
constexpr size_t smem_bytes(int NB) {
  return 2 * (2 * (2 * ROWS * 64 * NB + ROWS * 64) + 4 * ROWS) + 2 * 2 * PT * 64 * NB +
         3 * 4 * ROWS + 64 * 4 + 16;
}

// x [B, S, H, P], Bv / Cv [B, S, N] bf16; dt [B, S, H], A_log / D [H], s0
// [B, H, P, N] (or null) float32; y [B, S, H, P], s_out [B, H, P, N] float32;
// with STATES also states [B, nC, H, P, N] float32, the state entering each
// chunk. N <= 64 NB. A CTA of two warpgroups owns (batch, head, 64 columns
// of P) and scans its chunks in order; the next chunk's copies run under
// this chunk's products. Grid: B * H * ceil(P / 64) CTAs.
template <int NB, bool STATES>
__global__ void __launch_bounds__(THREADS, 1)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const bf16* __restrict__ Bv, const bf16* __restrict__ Cv,
              const float* __restrict__ A_log, const float* __restrict__ Dp,
              const float* __restrict__ s0, float* __restrict__ y, float* __restrict__ s_out,
              float* __restrict__ states, int S, int H, int P, int N, int Q, int vec) {
  constexpr int NS = 32 * NB;                     // state registers: [64 x 64 NB] / 128
  constexpr uint32_t CB_BYTES = ROWS * 128 * NB;  // one of C, B
  constexpr uint32_t STAGE_BYTES = 2 * CB_BYTES + ROWS * 128;
  constexpr uint32_t SP_BYTES = PT * 128 * NB;    // one of S_prev hi, lo
  const int nC = (S + Q - 1) / Q, nPT = (P + PT - 1) / PT;

  // 1024-byte alignment: the swizzle repeats every 1024 bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sp_hi = base + 2 * STAGE_BYTES, sp_lo = sp_hi + SP_BYTES;
  float* dts0 = reinterpret_cast<float*>(smem_raw + 2 * STAGE_BYTES + 2 * SP_BYTES);
  float* cs2 = dts0 + 2 * ROWS;  // inclusive cumsum of dt * A, times log2(e)
  float* ws = cs2 + ROWS;        // exp(cs_last - cs_j) dt_j
  float* es = ws + ROWS;         // exp(cs_i)
  float* ecol = es + ROWS;       // exp(cs_63 - cs_j) dt_j, j < 64
  float* seg = ecol + 64;        // sums of dt * A over 32 steps

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid / WG;
  const int gr = lane >> 2, gc = lane & 3;  // accumulator row, column pair
  const int row = 16 * (warp & 3) + gr;     // the thread's first row of a 64-row tile
  const int bh = blockIdx.x / nPT, pt = blockIdx.x - bh * nPT;
  const int b = bh / H, h = bh - b * H, p0 = pt * PT;
  const float A = -expf(A_log[h]);
  const float Dh = Dp[h];
  const size_t PN = (size_t)P * N;

  // the state [64 P rows x 64 NB N columns], float32, held by the first
  // warpgroup in the accumulator layout of (x w)^T B: st[4 t + e] is P row
  // row + 8 (e / 2), N column 8 t + 2 gc + e % 2
  float st[NS];
#pragma unroll
  for (int t = 0; t < NS / 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + row + 8 * (e >> 1), n = 8 * t + 2 * gc + (e & 1);
      st[4 * t + e] = wg == 0 && s0 != nullptr && p < P && n < N
                          ? s0[bh * PN + (size_t)p * N + n] : 0.f;
    }

  // chunk c's C, B, x and dt into stage sg, zero past S, Q, N and P
  auto stage = [&](int c, int sg) {
    const uint32_t Cs = base + sg * STAGE_BYTES, Bs = Cs + CB_BYTES, xs = Bs + CB_BYTES;
    const int c0 = c * Q, rows = min(Q, S - c0);
    if (vec) {  // 16-byte chunk k of row i, THREADS / (8 NB) rows at a time
      const int k = tid % (8 * NB);
      for (int i = tid / (8 * NB); i < ROWS; i += THREADS / (8 * NB)) {
        const bool ok = i < rows && 8 * k < N;
        const size_t g = ok ? ((size_t)b * S + c0 + i) * N + 8 * k : 0;
        cp_async16(Cs + swz(ROWS, i, k), Cv + g, ok);
        cp_async16(Bs + swz(ROWS, i, k), Bv + g, ok);
      }
      const int kx = tid & 7;
      for (int i = tid >> 3; i < ROWS; i += THREADS / 8) {
        const bool ok = i < rows && p0 + 8 * kx < P;
        const size_t g = ok ? (((size_t)b * S + c0 + i) * H + h) * P + p0 + 8 * kx : 0;
        cp_async16(xs + swz(ROWS, i, kx), x + g, ok);
      }
    } else {  // N or P not a multiple of 8, or an operand not 16-byte aligned
      const bf16 zero = __float2bfloat16(0.f);
      unsigned char* gC = smem_raw + sg * STAGE_BYTES;
      for (int e = tid; e < ROWS * 64 * NB; e += THREADS) {
        const int i = e / (64 * NB), n = e - i * (64 * NB);
        const bool ok = i < rows && n < N;
        const size_t g = ((size_t)b * S + c0 + i) * N + n;
        const uint32_t off = swz(ROWS, i, n >> 3) + 2 * (n & 7);
        *reinterpret_cast<bf16*>(gC + off) = ok ? Cv[g] : zero;
        *reinterpret_cast<bf16*>(gC + CB_BYTES + off) = ok ? Bv[g] : zero;
      }
      for (int e = tid; e < ROWS * 64; e += THREADS) {
        const int i = e >> 6, pp = e & 63;
        const bool ok = i < rows && p0 + pp < P;
        *reinterpret_cast<bf16*>(gC + 2 * CB_BYTES + swz(ROWS, i, pp >> 3) + 2 * (pp & 7)) =
            ok ? x[(((size_t)b * S + c0 + i) * H + h) * P + p0 + pp] : zero;
      }
    }
    float* dts = dts0 + sg * ROWS;
    for (int j = tid; j < ROWS; j += THREADS) {
      const bool ok = j < rows;
      cp_async4(smem_u32(dts + j), dt + (ok ? ((size_t)b * S + c0 + j) * H + h : 0), ok);
    }
    cp_async_commit();
  };

  stage(0, 0);
#pragma unroll 1
  for (int c = 0; c < nC; ++c) {
    const int sg = c & 1, c0 = c * Q, rows = min(Q, S - c0);
    const uint32_t Cs = base + sg * STAGE_BYTES, Bs = Cs + CB_BYTES, xs = Bs + CB_BYTES;
    const unsigned char* gx = smem_raw + sg * STAGE_BYTES + 2 * CB_BYTES;
    const float* dts = dts0 + sg * ROWS;
    // the other stage was last read in chunk c - 1, before its closing barrier
    if (c + 1 < nC) stage(c + 1, sg ^ 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait<1>();      // every group but the newest: chunk c has landed
    __syncthreads();

    // the inclusive cumsum of dt * A on the first warpgroup: warp w scans
    // steps 32 w .. 32 w + 31, then adds the sums of the segments before
    // it; from it the decays (cs in log2 units, the state-update weights
    // w, exp(cs_i), column block 0's exp(cs_63 - cs_j) dt_j). Meanwhile the
    // first warpgroup writes S_prev as bf16 hi + lo (K-major [P x N])
    float cj = 0.f, dtj = 0.f;
    if (wg == 0) {
      dtj = dts[tid];
      float v = dtj * A;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) seg[warp] = v;
      cj = v;
      if constexpr (STATES) {  // st: the state entering chunk c
        float* sc = states + ((size_t)(b * nC + c) * H + h) * PN;
#pragma unroll
        for (int t = 0; t < NS / 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = p0 + row + 8 * (e >> 1), n = 8 * t + 2 * gc + (e & 1);
            if (p < P && n < N) sc[(size_t)p * N + n] = st[4 * t + e];
          }
      }
#pragma unroll
      for (int t = 0; t < NS / 4; ++t)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t off = swz(PT, row + 8 * hr, t) + 4 * gc;
          uint32_t hi, lo;
          split(st[4 * t + 2 * hr], st[4 * t + 2 * hr + 1], hi, lo);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sp_hi + off), "r"(hi) : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sp_lo + off), "r"(lo) : "memory");
        }
    }
    __syncthreads();  // the segment sums
    if (wg == 0) {
      float before = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) before += w < warp ? seg[w] : 0.f;
      const float last = seg[0] + seg[1] + seg[2] + seg[3], mid = seg[0] + seg[1];
      cj += before;
      cs2[tid] = cj * LOG2E;
      ws[tid] = expf(last - cj) * dtj;
      es[tid] = expf(cj);
      if (tid < 64) ecol[tid] = exp2_approx((mid - cj) * LOG2E) * dtj;
    }
    fence_proxy_async();  // copies and S_prev, visible to the tensor cores
    __syncthreads();

    // y = M x + exp(cs_i) C S_prev + D x, M = (C B^T) o decay, by 64 x 64
    // blocks (row half hf, column block cb <= hf): C B^T in the accumulator
    // s, the decay exp(cs_i - cs_j) dt_j (j <= i) applied in registers, and
    // the accumulator layout is the A-operand layout of M x, so M, split
    // into hi + lo, never touches shared memory. Each wgmma group pairs
    // independent products. The first warpgroup takes the state, block
    // (0, 0) and the upper half of y; the second blocks (1, 0) and (1, 1)
    // and the lower half.
    float s[32], yacc[32], z[32];
    uint32_t mhi[4][4], mlo[4][4];
    if (wg == 0) {
      // the state: S = exp(cs_Q) S_prev + (x w)^T B, onto the decayed state
      // in place. The A operand is x read transposed by ldmatrix, weighted
      // by w_j and split into hi + lo in registers; B is read MN-major
      const float g = es[ROWS - 1];
#pragma unroll
      for (int i = 0; i < NS; ++i) st[i] *= g;
      uint32_t xa_hi[ROWS / 16][4], xa_lo[ROWS / 16][4];
#pragma unroll
      for (int kb = 0; kb < ROWS / 16; ++kb) {
        uint32_t xa[4];
        const int r = 16 * kb + (lane & 7) + (lane >> 4) * 8;
        ldsm4t(xa, xs + swz(ROWS, r, 2 * warp + ((lane >> 3) & 1)));
        const int j = 16 * kb + 2 * gc;
        const float2 w0 = *reinterpret_cast<const float2*>(ws + j);
        const float2 w8 = *reinterpret_cast<const float2*>(ws + j + 8);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 v = unpack(xa[k]), w = k < 2 ? w0 : w8;
          split(v.x * w.x, v.y * w.y, xa_hi[kb][k], xa_lo[kb][k]);
        }
      }
      fence_regs(st);
      fence_regs(xa_hi);
      fence_regs(xa_lo);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < ROWS / 16; ++kb) {
        wgmma_rs(st, xa_hi[kb], desc_mn(Bs, ROWS, kb));
        wgmma_rs(st, xa_lo[kb], desc_mn(Bs, ROWS, kb));
      }
      cbt<NB>(s, Cs, Bs, 0, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(xa_hi);
      fence_regs(xa_lo);
      fence_regs(s);
      const float erow[2] = {0.f, 0.f};  // unused on the diagonal
      decay(s, mhi, mlo, cs2, dts, ecol, erow, 0, 0, row, gc);
      fence_regs(mhi);
      fence_regs(mlo);
      wgmma_fence();
      mx(yacc, mhi, mlo, xs, 0, true);
      cs_prev<NB>(z, Cs, sp_hi, sp_lo, 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(mhi);
      fence_regs(mlo);
      fence_regs(yacc);
      fence_regs(z);
      write_y(y, yacc, z, es, gx, Dh, b, h, S, H, P, p0, c0, rows, row, gc);
    } else {
      wgmma_fence();
      cbt<NB>(s, Cs, Bs, 1, 0);
      wgmma_commit();
      const float c63 = cs2[63];
      const float erow[2] = {exp2_approx(cs2[64 + row] - c63), exp2_approx(cs2[72 + row] - c63)};
      wgmma_wait<0>();
      fence_regs(s);
      decay(s, mhi, mlo, cs2, dts, ecol, erow, 1, 0, row, gc);
      fence_regs(mhi);
      fence_regs(mlo);
      wgmma_fence();
      mx(yacc, mhi, mlo, xs, 0, true);
      cbt<NB>(s, Cs, Bs, 1, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(mhi);
      fence_regs(mlo);
      fence_regs(yacc);
      decay(s, mhi, mlo, cs2, dts, ecol, erow, 1, 1, row, gc);
      fence_regs(mhi);
      fence_regs(mlo);
      wgmma_fence();
      mx(yacc, mhi, mlo, xs, 1, false);
      cs_prev<NB>(z, Cs, sp_hi, sp_lo, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(mhi);
      fence_regs(mlo);
      fence_regs(yacc);
      fence_regs(z);
      write_y(y + (size_t)64 * H * P, yacc, z, es + 64, gx + 64 * 128, Dh, b, h, S, H, P, p0,
              c0, rows - 64, row, gc);
    }
    __syncthreads();  // every warp is done with this stage, S_prev and the decays
  }

  if (wg == 0) {
#pragma unroll
    for (int t = 0; t < NS / 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + row + 8 * (e >> 1), n = 8 * t + 2 * gc + (e & 1);
        if (p < P && n < N) s_out[bh * PN + (size_t)p * N + n] = st[4 * t + e];
      }
  }
}

template <int NB, bool STATES>
int launch(const bf16* x, const float* dt, const bf16* Bv, const bf16* Cv,
           const float* A_log, const float* D, const float* s0, float* y, float* s_out,
           float* states, int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_tc_kernel<NB, STATES>;
  const long long grid = (long long)B * H * ((P + PT - 1) / PT);
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes(NB);
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bv) |
        reinterpret_cast<uintptr_t>(Cv)) & 15) == 0;
  const int vec = aligned && N % 8 == 0 && P % 8 == 0;
  kern<<<(unsigned)grid, THREADS, smem, stream>>>(x, dt, Bv, Cv, A_log, D, s0, y, s_out,
                                                  states, S, H, P, N, Q, vec);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Shared memory of one CTA, in bytes: the float32 kernel's for chunk Q,
// state width N and P tile PT.
extern "C" size_t ssd_smem_bytes(int Q, int N, int PT) {
  return smem_floats(Q, N, PT) * sizeof(float);
}

// Dynamic shared memory of one CTA of the bfloat16 kernel, in bytes, at state
// width N.
extern "C" size_t ssd_tc_smem_bytes(int N) { return tc::smem_bytes(N <= 64 ? 1 : 2); }

// x [B, S, H, P], Bv / Cv [B, S, N] contiguous, float32 (dtype 0, the
// scalar kernel) or bfloat16 (dtype 1, the tensor-core kernel); dt [B, S, H],
// A_log / D [H], s0 [B, H, P, N] (or null: zeros) float32; y [B, S, H, P] and
// s_out [B, H, P, N] float32; states [B, nC, H, P, N] float32 or null (the
// serving instances, which write no states). 1 <= Q <= 128, N <= 128. PT:
// the float32 kernel's P columns per CTA (16, 32 or 64; the bfloat16
// kernel's are 64). Returns the launch's CUDA error code.
extern "C" int ssd_launch(const void* x, const void* dt, const void* Bv, const void* Cv,
                          const void* A_log, const void* D, const void* s0, void* y,
                          void* s_out, void* states, int B, int S, int H, int P, int N, int Q,
                          int PT, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > QMAX || N < 1 || N > NMAX) return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  float* sts = static_cast<float*>(states);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* bf = static_cast<const float*>(Bv);
    const float* cf = static_cast<const float*>(Cv);
    return sts ? launch_scalar<true>(PT, xf, dtf, bf, cf, al, dp, s0f, yf, so, sts, B, S, H, P,
                                     N, Q, s)
               : launch_scalar<false>(PT, xf, dtf, bf, cf, al, dp, s0f, yf, so, sts, B, S, H,
                                      P, N, Q, s);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  using tc::bf16;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bv);
  const bf16* cb = static_cast<const bf16*>(Cv);
  if (sts)
    return N <= 64 ? tc::launch<1, true>(xb, dtf, bb, cb, al, dp, s0f, yf, so, sts, B, S, H, P,
                                         N, Q, s)
                   : tc::launch<2, true>(xb, dtf, bb, cb, al, dp, s0f, yf, so, sts, B, S, H, P,
                                         N, Q, s);
  return N <= 64 ? tc::launch<1, false>(xb, dtf, bb, cb, al, dp, s0f, yf, so, sts, B, S, H, P,
                                        N, Q, s)
                 : tc::launch<2, false>(xb, dtf, bb, cb, al, dp, s0f, yf, so, sts, B, S, H, P,
                                        N, Q, s);
}
