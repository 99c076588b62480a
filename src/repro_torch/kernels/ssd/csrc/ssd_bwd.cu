// The gradient of the Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// The JAX package has no backward kernel: it differentiates
// `repro.models.ssm.ssd_chunked` (src/repro/models/ssm.py:82), the function
// of the Pallas kernel `_kernel` (src/repro/kernels/ssd/ssd.py:21), by
// autodiff. These kernels compute that gradient from the forward's inputs,
// the output gradient dy (float32) and the state entering each chunk, which
// the forward's STATES instance wrote (csrc/ssd.cu). For chunk c of Q steps,
// cs the inclusive cumsum of dt A, L_ij = exp(cs_i - cs_j) (j <= i), S_prev
// the state entering the chunk and G the gradient of the state leaving it:
//   G entering    = exp(cs_Q) G + sum_i exp(cs_i) dy_i C_i^T
//   dx_j          = sum_i L_ij dt_j (C_i . B_j) dy_i + D dy_j + exp(cs_Q - cs_j) dt_j G B_j
//   dC_i          = sum_h [sum_j E_ij B_j + exp(cs_i) dy_i^T S_prev]
//   dB_j          = sum_h [sum_i E_ij C_i + exp(cs_Q - cs_j) dt_j x_j^T G]
//                   with E_ij = L_ij dt_j (dy_i . x_j)
//   d cs          from every exponential, summed backward over the chunk
//                 into d(dt A): ddt += d(dt A) A, dA_log = sum d(dt A) dt A
//   dD            = sum dy . x
// (ref.py's `ssd_chunked_bwd_ref` is the same passes in PyTorch.) Positions
// past S count as dt = 0, as in the forward, and get no gradient.
//
// Three kernels, in order on one stream, no atomics (two runs are
// bit-equal), in one of two designs by dtype (a dispatch, not a fallback).
//
// bfloat16, on the tensor cores through `wgmma` (bf16 in, float32
// accumulate; helpers shared with the forward in ssd_wgmma.cuh):
// * `ssd_bwd_state_tc_kernel`: the reverse scan per (batch, head, 64
//   columns of N), G [64 x 64] in the accumulator registers of G = exp(cs_Q)
//   G + (exp(cs) o dy)^T C, as the forward's first warpgroup carries its
//   state; the A operand made in registers from dy (float32) and split into
//   bf16 hi + lo, C read MN-major; a chunk's C, dy and dt staged by
//   `cp.async` two stages deep. Writes G leaving each chunk in bf16 (the
//   chunk pass reads it as one bf16 operand), <G, S_prev> per chunk, and G
//   entering chunk 0. Bound by dy's and the states' bytes: ~55% of HBM's
//   rate at Zamba2's shape;
// * `ssd_bwd_chunk_tc_kernel`: one CTA of two warpgroups per (batch, chunk,
//   group of GH heads), GH = ceil(B nC H / SMs) (Mamba-2's 3, Zamba2's 14:
//   128 CTAs). The heads share B and C, so dC_i = sum_h [sum_j E_ij B_j +
//   es_i dy_i^T S_prev] and dB_j = sum_h [sum_i E_ij C_i + wq_j x_j^T G] are
//   products whose K dimension runs over the group's heads too: each sits
//   in one accumulator that the group's heads, in order, add to. Per head,
//   in 64 x 64 and 64 x 32 blocks (blocks wholly above or below the
//   diagonal skipped where no barrier follows), each warpgroup owning 64
//   rows: Z = (es o dy) S_prev
//   (U_i = C_i . Z_i), E = L dt_j o dy x^T into dC += Z + E B; then B G^T
//   (dx's inter term and W_j), B C^T and x dy^T in accumulators whose rows
//   are j, so that the masked M^T = L dt_j o B C^T and E^T = L dt_j o x dy^T
//   are the A operands of dx = M^T dy and dB += E^T C (and wq o x of dB +=
//   (wq o x) G) without touching shared memory, as the forward's `decay` /
//   `mx` do; the sums of R = L o B C^T o x dy^T for d cs from the same
//   registers. dy and S_prev enter as bf16 hi + lo tiles, the products made
//   in float32 (E, M^T, es o dy, wq o x) as hi + lo A fragments (M^T's lo
//   times dy's lo dropped), G as bf16: tests/test_torch_ssd_bwd_tensorcore_
//   numerics.py emulates this arithmetic against JAX and keeps each lo term
//   whose loss would bring a gradient within 3x of the 1e-2 tolerance. At N
//   = 128 dC and dB [128 x N] would take 128 of a thread's registers
//   together, so the heads are walked twice (dC, then dB, dx and the rest);
//   at N <= 64 once. Each head's x, dy, S_prev and G are staged anew (a
//   copy of the next head's under this head's products measured no
//   faster); B and C once per CTA. d cs is summed backward by four warps'
//   shuffles; dx is written once in bf16; dB and dC once per group as
//   float32 partials, 8.4 / 16.8 MB at Zamba2's / Mamba-2's shape against
//   117 / 50 MB for a partial per head. 229-255 registers a thread, no
//   spill, one CTA an SM; most of its time is each head's chain of
//   products, waits and barriers (~16 us a head at Zamba2's shape, of which
//   the head's products, counted, take about a quarter at the bf16 peak);
// * `ssd_bwd_reduce_kernel`: the groups' dB and dC partials summed in order,
//   dD and dA_log over batch and chunks.
//
// float32, scalar FMAs out of shared memory (the tensor cores would round
// to TF32, outside the float32 tolerance; no training path runs float32
// but the CPU gates):
// * `ssd_bwd_state_kernel`: the reverse scan over chunks per (batch, head,
//   64 columns of P), G [P x N] in registers as the forward carries its
//   state; writes G leaving each chunk, float32 [B, nC, H, P, N], and G
//   entering chunk 0 (the entering state's gradient);
// * `ssd_bwd_chunk_kernel`: one CTA per (batch, chunk, head). C.B^T and
//   dy.x^T [Q x Q] in registers, then the masked L dt_j C.B^T and E in
//   shared memory; dx, dt and the head's partial dB, dC, dD and dA_log,
//   B, C, S_prev and G staged 32 state columns at a time;
// * `ssd_bwd_reduce_kernel`: dB and dC summed over the heads, dD and
//   dA_log over batch and chunks, each in a fixed order.
//
// Bound (B 4, S 512, Q 128, P 64, bf16 x, B, C; float32 dy and states): by
// bytes, x, dy, dt, B, C and the states read once and dx, dt, dB, dC
// written once: ~40 MB for Mamba-2 (H 24, N 128) and ~148 MB for Zamba2
// (H 112, N 64), 12 and 44 us at 3.35 TB/s. The products, counted once (the
// heads share B and C, so C.B^T and E's products with B and C once per
// chunk), are 4.1 and 11.3 GFLOP: 4 and 11 us at the bf16 tensor-core
// peak. The bf16 kernels run ~3x that count (the hi + lo terms, C B^T and x
// dy^T twice at N = 128, the blocks above the diagonal) and move the
// states, G, the staged operands per head and the partials on top of the
// bound's bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>

#include "ssd_wgmma.cuh"

namespace {

constexpr int NT = 256;               // 16 x 16 threads
constexpr int QMAX = 128, NMAX = 128, PMAX = 64;
constexpr int RQ = QMAX / 16;         // chunk rows per thread
constexpr int RN = NMAX / 16;         // state columns per thread (state kernel)
constexpr int RP = PMAX / 16;         // P columns per thread
constexpr int NL = 32, NLS = NL + 1;  // the chunk kernel's tile of N, its row stride
constexpr int RL = NL / 16;           // tile columns per thread
constexpr unsigned FULL = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(bf16* p, float v) { *p = __float2bfloat16(v); }

// the sum over a warp, every lane getting it (a fixed butterfly order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// cs = inclusive cumsum of dt * A over the chunk; by one warp
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cs, float A, int Q,
                                             int lane) {
  float carry = 0.f;
  for (int j0 = 0; j0 < Q; j0 += 32) {
    const int j = j0 + lane;
    float v = j < Q ? dts[j] * A : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += u;
    }
    v += carry;
    if (j < Q) cs[j] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
}

// dt of chunk rows [0, Q), zero past the chunk's valid rows
__device__ __forceinline__ void load_dt(float* dts, const float* dt, int b, int S, int H, int h,
                                        int c0, int rows, int Q, int tid) {
  for (int j = tid; j < Q; j += NT)
    dts[j] = j < rows ? dt[((size_t)b * S + c0 + j) * H + h] : 0.f;
}

size_t state_smem_floats(int Q, int N) {
  return (size_t)N * (Q + 1) + (size_t)Q * PMAX + 2 * (size_t)Q;
}

// dy [B, S, H, P], dt [B, S, H], A_log [H], dfin [B, H, P, N] or null
// (float32); Cv [B, S, N]; gout [B, nC, H, P, N] the gradient of the state
// leaving each chunk, ds0 [B, H, P, N] or null the gradient of the state
// entering chunk 0. Grid (B * H, ceil(P / 64)); G [64 x N] in registers:
// P row ty + 16 k, N column tx + 16 a.
__global__ void __launch_bounds__(NT)
ssd_bwd_state_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                     const float* __restrict__ Cv, const float* __restrict__ A_log,
                     const float* __restrict__ dfin, float* __restrict__ gout,
                     float* __restrict__ ds0, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int QS = Q + 1;
  float* Ct = smem;             // [N][QS] C transposed
  float* dys = Ct + N * QS;     // [Q][PMAX] exp(cs_i) dy_i
  float* dts = dys + Q * PMAX;  // [Q]
  float* cs = dts + Q;          // [Q]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, p0 = blockIdx.y * PMAX;
  const int nC = (S + Q - 1) / Q;
  const float A = -expf(A_log[h]);
  const size_t PN = (size_t)P * N;

  float g[RN][RP];
#pragma unroll
  for (int a = 0; a < RN; ++a)
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      const int p = p0 + ty + 16 * k, n = tx + 16 * a;
      g[a][k] = dfin != nullptr && p < P && n < N ? dfin[bh * PN + (size_t)p * N + n] : 0.f;
    }
  for (int c = nC - 1; c >= 0; --c) {
    const int c0 = c * Q, rows = min(Q, S - c0);
    float* gc = gout + ((size_t)(b * nC + c) * H + h) * PN;
#pragma unroll
    for (int a = 0; a < RN; ++a)
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const int p = p0 + ty + 16 * k, n = tx + 16 * a;
        if (p < P && n < N) gc[(size_t)p * N + n] = g[a][k];
      }
    __syncthreads();  // the previous chunk's readers are done with the staging
    load_dt(dts, dt, b, S, H, h, c0, rows, Q, tid);
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N;
      Ct[n * QS + j] = j < rows ? Cv[((size_t)b * S + c0 + j) * N + n] : 0.f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, cs, A, Q, tid);
    __syncthreads();
    for (int e = tid; e < Q * PMAX; e += NT) {
      const int j = e / PMAX, p = p0 + e - j * PMAX;
      dys[e] = j < rows && p < P ? dy[(((size_t)b * S + c0 + j) * H + h) * P + p] * expf(cs[j])
                                 : 0.f;
    }
    __syncthreads();
    const float gt = expf(cs[Q - 1]);
#pragma unroll
    for (int a = 0; a < RN; ++a)
#pragma unroll
      for (int k = 0; k < RP; ++k) g[a][k] *= gt;
    for (int j = 0; j < Q; ++j) {
      float cv[RN], dv[RP];
#pragma unroll
      for (int a = 0; a < RN; ++a) {
        const int n = tx + 16 * a;
        cv[a] = n < N ? Ct[n * QS + j] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RP; ++k) dv[k] = dys[j * PMAX + ty + 16 * k];
#pragma unroll
      for (int a = 0; a < RN; ++a)
#pragma unroll
        for (int k = 0; k < RP; ++k) g[a][k] = fmaf(cv[a], dv[k], g[a][k]);
    }
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int a = 0; a < RN; ++a)
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const int p = p0 + ty + 16 * k, n = tx + 16 * a;
        if (p < P && n < N) ds0[bh * PN + (size_t)p * N + n] = g[a][k];
      }
  }
}

size_t chunk_smem_floats(int Q, int P) {
  const size_t QS = Q + 1;
  return 2 * (size_t)P * QS      // xt, dyt
         + (size_t)Q * QS        // QQ
         + 2 * (size_t)Q * NLS   // Bs, Cs
         + 2 * (size_t)P * NLS   // Sp, Gt
         + 48 * (size_t)Q        // red
         + NT                    // part
         + 9 * (size_t)Q;        // dts, cs, es, eq, wq, dcs, dtd, dd, wdt
}

// one N tile of the chunk's B and C, [Q][NLS], zero past the valid rows and N
__device__ __forceinline__ void load_bc(float* Bs, float* Cs, const float* Bv, const float* Cv,
                                        int b, int S, int N, int c0, int rows, int Q, int n0,
                                        int tid) {
  for (int e = tid; e < Q * NL; e += NT) {
    const int j = e / NL, nn = e - j * NL, n = n0 + nn;
    const bool ok = j < rows && n < N;
    const size_t g = ((size_t)b * S + c0 + j) * N + n;
    Bs[j * NLS + nn] = ok ? Bv[g] : 0.f;
    Cs[j * NLS + nn] = ok ? Cv[g] : 0.f;
  }
}

// x [B, S, H, P], Bv / Cv [B, S, N] (T); dt [B, S, H], A_log / D [H],
// states and gout [B, nC, H, P, N] (the state entering each chunk, its
// gradient leaving it), dy [B, S, H, P] float32. Writes dx [B, S, H, P] (T),
// ddt [B, S, H], and the head's partials dBp / dCp [B, nC, H, Q, N] and
// dDp / dAp [B, nC, H] (float32). One CTA per (batch, chunk, head), heads
// fastest: the CTAs of one chunk read its B and C from L2. Threads (ty, tx)
// of 16 x 16 own chunk rows ty + 16 a and columns tx + 16 k.
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Bv, const float* __restrict__ Cv,
                     const float* __restrict__ A_log, const float* __restrict__ Dp,
                     const float* __restrict__ states, const float* __restrict__ gout,
                     const float* __restrict__ dy, float* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dBp,
                     float* __restrict__ dCp, float* __restrict__ dDp,
                     float* __restrict__ dAp, int S, int H, int P, int N, int Q) {
  extern __shared__ float smem[];
  const int QS = Q + 1;
  float* xt = smem;           // [P][QS] x transposed
  float* dyt = xt + P * QS;   // [P][QS] dy transposed
  float* QQ = dyt + P * QS;   // [Q][QS] L dt_j (C_i . B_j), then E
  float* Bs = QQ + Q * QS;    // [Q][NLS] an N tile of B
  float* Cs = Bs + Q * NLS;   // [Q][NLS] of C
  float* Sp = Cs + Q * NLS;   // [P][NLS] of the entering state
  float* Gt = Sp + P * NLS;   // [P][NLS] of G leaving the chunk
  float* red = Gt + P * NLS;  // [3][16][Q] per-thread partial sums
  float* part = red + 48 * Q; // [NT] partial sums of <G, S_prev>
  float* dts = part + NT;     // [Q] dt
  float* cs = dts + Q;        // [Q] inclusive cumsum of dt A
  float* es = cs + Q;         // [Q] exp(cs_i)
  float* eq = es + Q;         // [Q] exp(cs_Q - cs_j)
  float* wq = eq + Q;         // [Q] exp(cs_Q - cs_j) dt_j
  float* dcs = wq + Q;        // [Q] d cs
  float* dtd = dcs + Q;       // [Q] dt's direct terms
  float* dd = dtd + Q;        // [Q] dy_i . x_i
  float* wdt = dd + Q;        // [Q] W_j dt_j

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4, lane = tid & 31;
  const int bch = blockIdx.x, h = bch % H, bc = bch / H;
  const int nC = (S + Q - 1) / Q, b = bc / nC, c = bc - b * nC;
  const int c0 = c * Q, rows = min(Q, S - c0);
  const float A = -expf(A_log[h]), Dh = Dp[h];
  const size_t PN = (size_t)P * N;
  const float* sprev = states + (size_t)bch * PN;
  const float* gleave = gout + (size_t)bch * PN;

  load_dt(dts, dt, b, S, H, h, c0, rows, Q, tid);
  for (int e = tid; e < Q * P; e += NT) {
    const int j = e / P, p = e - j * P;
    const size_t g = (((size_t)b * S + c0 + j) * H + h) * P + p;
    xt[p * QS + j] = j < rows ? x[g] : 0.f;
    dyt[p * QS + j] = j < rows ? dy[g] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    chunk_cumsum(dts, cs, A, Q, lane);
    __syncwarp();
    for (int j = lane; j < Q; j += 32) {
      es[j] = expf(cs[j]);
      eq[j] = expf(cs[Q - 1] - cs[j]);
      wq[j] = eq[j] * dts[j];
    }
  }

  // C.B^T: cb[a][k] = C_i . B_j, i = ty + 16 a, j = tx + 16 k
  float cb[RQ][RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int k = 0; k < RQ; ++k) cb[a][k] = 0.f;
  for (int n0 = 0; n0 < N; n0 += NL) {
    __syncthreads();  // the previous tile's readers are done (and cs is visible)
    load_bc(Bs, Cs, Bv, Cv, b, S, N, c0, rows, Q, n0, tid);
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < NL; ++nn) {
      float cv[RQ], bv[RQ];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + 16 * a, j = tx + 16 * a;
        cv[a] = i < Q ? Cs[i * NLS + nn] : 0.f;
        bv[a] = j < Q ? Bs[j * NLS + nn] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int k = 0; k < RQ; ++k) cb[a][k] = fmaf(cv[a], bv[k], cb[a][k]);
    }
  }

  // dy.x^T: dxv[a][k] = dy_i . x_j
  float dxv[RQ][RQ];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int k = 0; k < RQ; ++k) dxv[a][k] = 0.f;
  for (int p = 0; p < P; ++p) {
    float dv[RQ], xv[RQ];
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a, j = tx + 16 * a;
      dv[a] = i < Q ? dyt[p * QS + i] : 0.f;
      xv[a] = j < Q ? xt[p * QS + j] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int k = 0; k < RQ; ++k) dxv[a][k] = fmaf(dv[a], xv[k], dxv[a][k]);
  }

  // the masked products: QQ = L dt_j (C_i . B_j) for dx; the sums of T =
  // L dt_j (C_i . B_j)(dy_i . x_j) over j (d cs_i, +) and over i (d cs_j,
  // -), and of T / dt_j over i (dt_j's direct term)
  {
    float rowT[RQ], colT[RQ], colR[RQ];
#pragma unroll
    for (int a = 0; a < RQ; ++a) rowT[a] = colT[a] = colR[a] = 0.f;
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a;
      if (i >= Q) continue;
#pragma unroll
      for (int k = 0; k < RQ; ++k) {
        const int j = tx + 16 * k;
        if (j >= Q) continue;
        float m = 0.f;
        if (j <= i) {
          const float L = expf(cs[i] - cs[j]);
          const float R = L * cb[a][k] * dxv[a][k], T_ = R * dts[j];
          rowT[a] += T_;
          colT[k] += T_;
          colR[k] += R;
          m = L * dts[j] * cb[a][k];
        }
        QQ[i * QS + j] = m;
      }
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int i = ty + 16 * a, j = tx + 16 * a;
      if (i < Q) red[tx * Q + i] = rowT[a];
      if (j < Q) {
        red[(16 + ty) * Q + j] = colT[a];
        red[(32 + ty) * Q + j] = colR[a];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += NT) {
    float r = 0.f, cT = 0.f, cR = 0.f, d = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      r += red[t * Q + i];
      cT += red[(16 + t) * Q + i];
      cR += red[(32 + t) * Q + i];
    }
    for (int p = 0; p < P; ++p) d = fmaf(dyt[p * QS + i], xt[p * QS + i], d);
    dcs[i] = r - cT;
    dtd[i] = cR;
    dd[i] = d;
  }

  // dx's intra-chunk and skip terms: j = ty + 16 a, p = tx + 16 k
  float acc[RQ][RP];
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int k = 0; k < RP; ++k) acc[a][k] = 0.f;
  for (int i = 0; i < Q; ++i) {
    float m[RQ], dv[RP];
#pragma unroll
    for (int a = 0; a < RQ; ++a) {
      const int j = ty + 16 * a;
      m[a] = j < Q ? QQ[i * QS + j] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      const int p = tx + 16 * k;
      dv[k] = p < P ? dyt[p * QS + i] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < RQ; ++a)
#pragma unroll
      for (int k = 0; k < RP; ++k) acc[a][k] = fmaf(m[a], dv[k], acc[a][k]);
  }
#pragma unroll
  for (int a = 0; a < RQ; ++a)
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      const int j = ty + 16 * a, p = tx + 16 * k;
      if (j < Q && p < P) acc[a][k] = fmaf(Dh, dyt[p * QS + j], acc[a][k]);
    }
  __syncthreads();  // every thread is done reading QQ

  // QQ = E = L dt_j (dy_i . x_j), for dB and dC (i = ty + 16 a, j = tx + 16 k)
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int i = ty + 16 * a;
    if (i >= Q) continue;
#pragma unroll
    for (int k = 0; k < RQ; ++k) {
      const int j = tx + 16 * k;
      if (j < Q) QQ[i * QS + j] = j <= i ? expf(cs[i] - cs[j]) * dts[j] * dxv[a][k] : 0.f;
    }
  }

  // by tiles of N: dx's inter-chunk term, dC and dB (this head's part), and
  // the sums that d cs needs
  float u[RQ], w[RQ], gs = 0.f;
#pragma unroll
  for (int a = 0; a < RQ; ++a) u[a] = w[a] = 0.f;
  float* dCh = dCp + (size_t)bch * Q * N;
  float* dBh = dBp + (size_t)bch * Q * N;
  for (int n0 = 0; n0 < N; n0 += NL) {
    __syncthreads();  // E is complete; the previous tile's readers are done
    load_bc(Bs, Cs, Bv, Cv, b, S, N, c0, rows, Q, n0, tid);
    for (int e = tid; e < P * NL; e += NT) {
      const int p = e / NL, nn = e - p * NL, n = n0 + nn;
      Sp[p * NLS + nn] = n < N ? sprev[(size_t)p * N + n] : 0.f;
      Gt[p * NLS + nn] = n < N ? gleave[(size_t)p * N + n] : 0.f;
    }
    __syncthreads();
    // dx_j += exp(cs_Q - cs_j) dt_j G B_j (j = ty + 16 a, p = tx + 16 k)
#pragma unroll 4
    for (int nn = 0; nn < NL; ++nn) {
      float bw[RQ], gv[RP];
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int j = ty + 16 * a;
        bw[a] = j < Q ? wq[j] * Bs[j * NLS + nn] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const int p = tx + 16 * k;
        gv[k] = p < P ? Gt[p * NLS + nn] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int k = 0; k < RP; ++k) acc[a][k] = fmaf(bw[a], gv[k], acc[a][k]);
    }
    // dC_i = sum_j E_ij B_j + exp(cs_i) dy_i^T S_prev (i = ty + 16 a, n = tx + 16 k)
    {
      float dc[RQ][RL], z[RQ][RL];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int k = 0; k < RL; ++k) dc[a][k] = z[a][k] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float e[RQ], bv[RL];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          const int i = ty + 16 * a;
          e[a] = i < Q ? QQ[i * QS + j] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RL; ++k) bv[k] = Bs[j * NLS + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
#pragma unroll
          for (int k = 0; k < RL; ++k) dc[a][k] = fmaf(e[a], bv[k], dc[a][k]);
      }
      for (int p = 0; p < P; ++p) {
        float dv[RQ], sv[RL];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          const int i = ty + 16 * a;
          dv[a] = i < Q ? dyt[p * QS + i] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RL; ++k) sv[k] = Sp[p * NLS + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
#pragma unroll
          for (int k = 0; k < RL; ++k) z[a][k] = fmaf(dv[a], sv[k], z[a][k]);
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int i = ty + 16 * a;
        if (i >= Q) continue;
#pragma unroll
        for (int k = 0; k < RL; ++k) {
          const int nn = tx + 16 * k, n = n0 + nn;
          u[a] = fmaf(Cs[i * NLS + nn], z[a][k], u[a]);
          if (i < rows && n < N) dCh[(size_t)i * N + n] = fmaf(es[i], z[a][k], dc[a][k]);
        }
      }
    }
    // dB_j = sum_i E_ij C_i + exp(cs_Q - cs_j) dt_j x_j^T G (j = ty + 16 a)
    {
      float db[RQ][RL], yv[RQ][RL];
#pragma unroll
      for (int a = 0; a < RQ; ++a)
#pragma unroll
        for (int k = 0; k < RL; ++k) db[a][k] = yv[a][k] = 0.f;
      for (int i = 0; i < Q; ++i) {
        float e[RQ], cv[RL];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          const int j = ty + 16 * a;
          e[a] = j < Q ? QQ[i * QS + j] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RL; ++k) cv[k] = Cs[i * NLS + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
#pragma unroll
          for (int k = 0; k < RL; ++k) db[a][k] = fmaf(e[a], cv[k], db[a][k]);
      }
      for (int p = 0; p < P; ++p) {
        float xv[RQ], gv[RL];
#pragma unroll
        for (int a = 0; a < RQ; ++a) {
          const int j = ty + 16 * a;
          xv[a] = j < Q ? xt[p * QS + j] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < RL; ++k) gv[k] = Gt[p * NLS + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < RQ; ++a)
#pragma unroll
          for (int k = 0; k < RL; ++k) yv[a][k] = fmaf(xv[a], gv[k], yv[a][k]);
      }
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int j = ty + 16 * a;
        if (j >= Q) continue;
#pragma unroll
        for (int k = 0; k < RL; ++k) {
          const int nn = tx + 16 * k, n = n0 + nn;
          w[a] = fmaf(Bs[j * NLS + nn], yv[a][k], w[a]);
          if (j < rows && n < N) dBh[(size_t)j * N + n] = fmaf(wq[j], yv[a][k], db[a][k]);
        }
      }
    }
    for (int e = tid; e < P * NL; e += NT) {
      const int p = e / NL, nn = e - p * NL;
      gs = fmaf(Gt[p * NLS + nn], Sp[p * NLS + nn], gs);
    }
  }

  // dx, written once
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int j = ty + 16 * a;
    if (j >= rows) continue;
#pragma unroll
    for (int k = 0; k < RP; ++k) {
      const int p = tx + 16 * k;
      if (p < P) put(dx + (((size_t)b * S + c0 + j) * H + h) * P + p, acc[a][k]);
    }
  }
  // U_i = exp(cs_i) C_i . (dy_i^T S_prev) and W_j = exp(cs_Q - cs_j) B_j .
  // (x_j^T G): their sums over the 16 threads of a row, in order
#pragma unroll
  for (int a = 0; a < RQ; ++a) {
    const int i = ty + 16 * a;
    if (i < Q) {
      red[tx * Q + i] = u[a];
      red[(16 + tx) * Q + i] = w[a];
    }
  }
  part[tid] = gs;
  __syncthreads();
  for (int i = tid; i < Q; i += NT) {
    float uu = 0.f, ww = 0.f;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      uu += red[t * Q + i];
      ww += red[(16 + t) * Q + i];
    }
    const float U = es[i] * uu, W = eq[i] * ww;
    dcs[i] += U - W * dts[i];
    dtd[i] += W;
    wdt[i] = W * dts[i];
  }
  __syncthreads();
  if (tid < 32) {
    // d cs_Q: exp(cs_Q) <G, S_prev> + sum_j W_j dt_j; then d(dt A)_k = sum
    // over i >= k of d cs_i (d cs_Q reaches every k), from the chunk's end
    float v = 0.f, ws = 0.f;
    for (int t = lane; t < NT; t += 32) v += part[t];
    for (int i = lane; i < Q; i += 32) ws += wdt[i];
    float carry = expf(cs[Q - 1]) * warp_sum(v) + warp_sum(ws);
    float dA = 0.f, dDs = 0.f;
    for (int j0 = ((Q - 1) / 32) * 32; j0 >= 0; j0 -= 32) {
      const int k = j0 + lane;
      float s = k < Q ? dcs[k] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(FULL, s, off);
        if (lane + off < 32) s += t;
      }
      s += carry;
      if (k < rows) ddt[((size_t)b * S + c0 + k) * H + h] = fmaf(s, A, dtd[k]);
      if (k < Q) dA = fmaf(s, dts[k], dA);
      carry = __shfl_sync(FULL, s, 0);
    }
    for (int i = lane; i < Q; i += 32) dDs += dd[i];
    dA = warp_sum(dA);
    dDs = warp_sum(dDs);
    if (lane == 0) {
      dAp[bch] = dA * A;
      dDp[bch] = dDs;
    }
  }
}

// dB / dC [B, S, N] (T) = the partials [B, nC, NP, Q, N] (one per head, or
// per group of heads) summed in order; dD / dA_log [H] = the partials [B,
// nC, H] summed over (b, c) in order (by the first CTA). One thread per (b,
// s, n).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dDp, const float* __restrict__ dAp,
                      T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dD,
                      float* __restrict__ dA_log, int B, int S, int H, int NP, int N, int Q) {
  const int nC = (S + Q - 1) / Q;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx < (size_t)B * S * N) {
    const int n = (int)(idx % N);
    const size_t bs = idx / N;
    const int s = (int)(bs % S), b = (int)(bs / S), c = s / Q, i = s - c * Q;
    const size_t step = (size_t)Q * N;
    const size_t base = (size_t)(b * nC + c) * NP * step + (size_t)i * N + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < NP; ++h) {
      sb += dBp[base + h * step];
      sc += dCp[base + h * step];
    }
    put(dB + idx, sb);
    put(dC + idx, sc);
  }
  if (blockIdx.x == 0) {
    for (int h = threadIdx.x; h < H; h += NT) {
      float sd = 0.f, sa = 0.f;
      for (int bc = 0; bc < B * nC; ++bc) {
        sd += dDp[(size_t)bc * H + h];
        sa += dAp[(size_t)bc * H + h];
      }
      dD[h] = sd;
      dA_log[h] = sa;
    }
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

bool bad_shape(int B, int S, int H, int P, int N, int Q) {
  return B < 1 || S < 1 || H < 1 || P < 1 || P > PMAX || N < 1 || N > NMAX || Q < 1 ||
         Q > QMAX;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace tc {

constexpr int WG = 128;     // threads of a warpgroup
constexpr int ROWS = 128;   // chunk rows staged (Q <= 128, zero past Q)
constexpr int PT = 64;      // P rows or columns staged (P <= 64, zero past P)
constexpr int DYS = 68;     // the state kernel's float32 dy row stride: conflict-free A reads
constexpr int GMAX = 16;    // heads of a group, at most
constexpr float LOG2E = 1.4426950408889634f;

// v, opaque to the compiler: a shared-memory base taken anew in each block
// of a loop, so that ptxas does not hoist every descriptor made from it out
// of the loop and hold them all in registers
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]; A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// rows r < ROWS_T of a bf16 matrix (row r at g + r * ld; `nrows` rows and
// `ncols` columns valid) into a swizzled tile of ROWS_T rows x 64 NBT
// columns at shared address `dst` (`dstg` its generic pointer), zero past
// both: by `cp.async` (vec: ncols % 8 == 0 and g, ld 16-byte aligned) or
// element by element. NTHR threads share the copies.
template <int ROWS_T, int NBT, int NTHR>
__device__ __forceinline__ void tile_bf16(uint32_t dst, unsigned char* dstg, const bf16* g,
                                          size_t ld, int nrows, int ncols, bool vec, int tid) {
  if (vec) {
    for (int e = tid; e < ROWS_T * 8 * NBT; e += NTHR) {
      const int r = e / (8 * NBT), k = e - r * (8 * NBT);
      const bool ok = r < nrows && 8 * k < ncols;
      cp_async16(dst + swz(ROWS_T, r, k), g + (ok ? r * ld + 8 * k : 0), ok);
    }
  } else {  // not unrolled: the chunk pass has no registers to spare
#pragma unroll 1
    for (int e = tid; e < ROWS_T * 64 * NBT; e += NTHR) {
      const int r = e / (64 * NBT), n = e - r * (64 * NBT);
      *reinterpret_cast<bf16*>(dstg + swz(ROWS_T, r, n >> 3) + 2 * (n & 7)) =
          r < nrows && n < ncols ? g[r * ld + n] : __float2bfloat16(0.f);
    }
  }
}

// The same for a float32 matrix, split into two bf16 tiles hi and lo (generic
// pointers) as `split` does; vec: ncols % 8 == 0 and g, ld 16-byte aligned.
// `load` brings a thread's 8-column chunks into registers, `store` splits
// and writes them, so that a caller can have
// several tiles' loads in flight before the first store.
template <int ROWS_T, int NBT, int NTHR>
struct SplitTile {
  static constexpr int IT = ROWS_T * 8 * NBT / NTHR;  // 8-column chunks per thread
  static_assert(IT * NTHR == ROWS_T * 8 * NBT, "whole chunks per thread");
  float v[IT][8];

  __device__ __forceinline__ void load(const float* g, size_t ld, int nrows, int ncols,
                                       bool vec, int tid) {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = tid + it * NTHR, r = e / (8 * NBT), k = e - r * (8 * NBT);
      if (vec) {
        const bool ok = r < nrows && 8 * k < ncols;
        const float4* src = reinterpret_cast<const float4*>(g + (ok ? r * ld + 8 * k : 0));
        const float4 a = ok ? __ldg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 b = ok ? __ldg(src + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[it][0] = a.x, v[it][1] = a.y, v[it][2] = a.z, v[it][3] = a.w;
        v[it][4] = b.x, v[it][5] = b.y, v[it][6] = b.z, v[it][7] = b.w;
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          v[it][u] = r < nrows && 8 * k + u < ncols ? g[r * ld + 8 * k + u] : 0.f;
      }
    }
  }

  __device__ __forceinline__ void store(unsigned char* hi, unsigned char* lo, int tid) const {
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int e = tid + it * NTHR, r = e / (8 * NBT), k = e - r * (8 * NBT);
      uint4 h, l;
      split(v[it][0], v[it][1], h.x, l.x);
      split(v[it][2], v[it][3], h.y, l.y);
      split(v[it][4], v[it][5], h.z, l.z);
      split(v[it][6], v[it][7], h.w, l.w);
      *reinterpret_cast<uint4*>(hi + swz(ROWS_T, r, k)) = h;
      *reinterpret_cast<uint4*>(lo + swz(ROWS_T, r, k)) = l;
    }
  }
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (a, b) at p and p + 1 of a row of `n` values from column `col` (even):
// one 8-byte or 4-byte store where the pair is whole and aligned
__device__ __forceinline__ void put2(float* p, float a, float b, int col, int n) {
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (col < n) p[0] = a;
    if (col + 1 < n) p[1] = b;
  }
}
__device__ __forceinline__ void put2(bf16* p, float a, float b, int col, int n) {
  if (col + 1 < n && (n & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    if (col < n) p[0] = __float2bfloat16(a);
    if (col + 1 < n) p[1] = __float2bfloat16(b);
  }
}

// The reverse state scan. Shared memory: two stages of C [ROWS x 64] bf16
// (swizzled), dy [ROWS][DYS] float32 and dt [ROWS] (padded to 1 KB); cs and
// exp(cs) [ROWS]; 8 floats of sums.
constexpr uint32_t STATE_STAGE = ROWS * 128 + ROWS * DYS * 4 + 1024;
constexpr size_t STATE_SMEM = 2 * STATE_STAGE + 2 * ROWS * 4 + 8 * 4;

// dy [B, S, H, P], dt [B, S, H], A_log [H], dfin [B, H, P, N] or null, states
// [B, nC, H, P, N] (the state entering each chunk) float32; Cv [B, S, N]
// bf16. Writes gout [B, nC, H, P, N] bf16, the gradient of the state leaving
// each chunk, gs [B, nC, H, 2], <G leaving, S entering> over each 64
// columns of N, float32, and ds0 [B, H, P, N] float32 (or null), the
// gradient of the state entering chunk 0. One warpgroup per (batch, head, 64
// columns of N: G's columns evolve apart), the chunks in reverse order: G
// [64 P rows x 64 N columns] in the accumulator registers of G = exp(cs_Q) G
// + (exp(cs) o dy)^T C, g[4 t + e] its P row row + 8 (e / 2) and N column n0
// + 8 t + 2 gc + e % 2. The A operand (exp(cs) o dy)^T is made in registers
// from dy in float32 and split into bf16 hi + lo; C is read MN-major. The
// next chunk's C, dy and dt are copied by `cp.async` under this chunk's
// products; the states for <G, S> are loaded before this chunk's wait.
__global__ void __launch_bounds__(WG)
ssd_bwd_state_tc_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                        const bf16* __restrict__ Cv, const float* __restrict__ A_log,
                        const float* __restrict__ dfin, const float* __restrict__ states,
                        bf16* __restrict__ gout, float* __restrict__ gs, float* __restrict__ ds0,
                        int S, int H, int P, int N, int Q, int vec) {
  constexpr int NS = 32;
  constexpr uint32_t CB_BYTES = ROWS * 128;
  const int nC = (S + Q - 1) / Q;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  float* cs = reinterpret_cast<float*>(smem_raw + 2 * STATE_STAGE);  // [ROWS]
  float* es = cs + ROWS;                                             // [ROWS] exp(cs_j)
  float* seg = es + ROWS;  // [4] segment sums of dt A, [4] warp sums of <G, S_prev>
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, gc = lane & 3, row = 16 * warp + gr;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, n0 = 64 * blockIdx.y;
  const float A = -expf(A_log[h]);
  const size_t PN = (size_t)P * N;

  float g[NS];
#pragma unroll
  for (int t = 0; t < NS / 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = row + 8 * (e >> 1), n = n0 + 8 * t + 2 * gc + (e & 1);
      g[4 * t + e] = dfin != nullptr && p < P && n < N ? dfin[bh * PN + (size_t)p * N + n] : 0.f;
    }

  // chunk c's C (columns n0 ..), dy and dt into stage sg, zero past S, Q, N and P
  auto stage = [&](int c, int sg) {
    const uint32_t Cs = base + sg * STATE_STAGE, dys = Cs + CB_BYTES;
    unsigned char* gC = smem_raw + sg * STATE_STAGE;
    float* dyf = reinterpret_cast<float*>(gC + CB_BYTES);
    float* dts = dyf + ROWS * DYS;
    const int c0 = c * Q, rows = min(Q, S - c0);
    tile_bf16<ROWS, 1, WG>(Cs, gC, Cv + ((size_t)b * S + c0) * N + n0, N, rows, N - n0, vec, tid);
    const float* dyc = dy + (((size_t)b * S + c0) * H + h) * P;
    const size_t ld = (size_t)H * P;
    if (vec) {  // 16-byte chunk k (4 floats) of row i, 16 a row
      for (int e = tid; e < ROWS * 16; e += WG) {
        const int i = e >> 4, k = e & 15;
        const bool ok = i < rows && 4 * k < P;
        cp_async16(dys + (i * DYS + 4 * k) * 4, dyc + (ok ? i * ld + 4 * k : 0), ok);
      }
    } else {
      for (int e = tid; e < ROWS * PT; e += WG) {
        const int i = e / PT, p = e - i * PT;
        dyf[i * DYS + p] = i < rows && p < P ? dyc[i * ld + p] : 0.f;
      }
    }
    for (int j = tid; j < ROWS; j += WG) {
      const bool ok = j < rows;
      cp_async4(smem_u32(dts + j), dt + (ok ? ((size_t)b * S + c0 + j) * H + h : 0), ok);
    }
    cp_async_commit();
  };

  stage(nC - 1, 0);
#pragma unroll 1
  for (int it = 0; it < nC; ++it) {
    const int c = nC - 1 - it, sg = it & 1;
    const uint32_t Cs = base + sg * STATE_STAGE;
    const float* dyf = reinterpret_cast<const float*>(smem_raw + sg * STATE_STAGE + CB_BYTES);
    const float* dts = dyf + ROWS * DYS;
    const size_t off = ((size_t)(b * nC + c) * H + h) * PN;
    // the state entering chunk c at G's positions, for <G, S_prev>
    float sp[NS];
#pragma unroll
    for (int t = 0; t < NS / 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = row + 8 * (e >> 1), n = n0 + 8 * t + 2 * gc + (e & 1);
        sp[4 * t + e] = p < P && n < N ? states[off + (size_t)p * N + n] : 0.f;
      }
    // the other stage was last read in the previous iteration, before its closing barrier
    if (c > 0) stage(c - 1, sg ^ 1);
    else cp_async_commit();  // an empty group keeps the count
    cp_async_wait<1>();      // every group but the newest: chunk c has landed
    fence_proxy_async();     // the copies, visible to the tensor cores
    __syncthreads();

    // the cumsum of dt A: warp w scans steps 32 w .. 32 w + 31; meanwhile G
    // leaving chunk c goes out (bf16) with its dot with the state entering c
    float v = dts[tid] * A;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) seg[warp] = v;
    float dot = 0.f;
#pragma unroll
    for (int t = 0; t < NS / 4; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = row + 8 * hr, n = n0 + 8 * t + 2 * gc;
        const float g0 = g[4 * t + 2 * hr], g1 = g[4 * t + 2 * hr + 1];
        dot = fmaf(g0, sp[4 * t + 2 * hr], fmaf(g1, sp[4 * t + 2 * hr + 1], dot));
        if (p < P && n < N) put2(gout + off + (size_t)p * N + n, g0, g1, n, N);
      }
    dot = warp_sum(dot);
    if (lane == 0) seg[4 + warp] = dot;
    __syncthreads();
    float before = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) before += w < warp ? seg[w] : 0.f;
    v += before;
    cs[tid] = v;
    es[tid] = expf(v);
    if (tid == 0)
      gs[((size_t)(b * nC + c) * H + h) * 2 + blockIdx.y] = ((seg[4] + seg[5]) + seg[6]) + seg[7];
    __syncthreads();

    // G = exp(cs_Q) G + (exp(cs) o dy)^T C: the A fragment kb holds steps
    // 16 kb .. 16 kb + 15, its registers q = (step half, P row half)
    const float decay = expf(cs[ROWS - 1]);
    uint32_t ah[ROWS / 16][4], al[ROWS / 16][4];
#pragma unroll
    for (int kb = 0; kb < ROWS / 16; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = row + 8 * (q & 1), j = 16 * kb + 8 * (q >> 1) + 2 * gc;
        split(es[j] * dyf[j * DYS + p], es[j + 1] * dyf[(j + 1) * DYS + p], ah[kb][q],
              al[kb][q]);
      }
#pragma unroll
    for (int i = 0; i < NS; ++i) g[i] *= decay;
    fence_regs(g);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < ROWS / 16; ++kb) {
      wgmma_rs(g, ah[kb], desc_mn(Cs, ROWS, kb));
      wgmma_rs(g, al[kb], desc_mn(Cs, ROWS, kb));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(g);
    fence_regs(ah);
    fence_regs(al);
    __syncthreads();  // every warp is done with this stage
  }
  if (ds0 != nullptr) {
#pragma unroll
    for (int t = 0; t < NS / 4; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int p = row + 8 * hr, n = n0 + 8 * t + 2 * gc;
        if (p < P && n < N)
          put2(ds0 + bh * PN + (size_t)p * N + n, g[4 * t + 2 * hr], g[4 * t + 2 * hr + 1], n, N);
      }
  }
}

// The chunk pass's shared memory, byte offsets: C, B [ROWS x 64 NB]; x, dy
// hi, dy lo [ROWS x 64]; S_prev hi, lo and G [PT x 64 NB], all bf16 and
// swizzled; then float32 dt, cs log2(e), exp(cs), exp(cs_Q - cs), exp(cs_Q -
// cs) dt, and the per-step sums rsum, W, dd [ROWS] each, 16 segment sums,
// the group's A, D and <G, S_prev> [GMAX] each, the eight warps' column sums red
// [8][ROWS] and the group's U [GMAX][ROWS].
template <int NB>
struct ChunkSmem {
  static constexpr uint32_t CB = ROWS * 128 * NB, XT = ROWS * 128, SP = PT * 128 * NB;
  static constexpr uint32_t C = 0, B = CB, X = 2 * CB, DYH = X + XT, DYL = DYH + XT,
                            SH = DYL + XT, SL = SH + SP, G = SL + SP, F = G + SP;
  static constexpr size_t bytes = F + 4 * (8 * ROWS + 16 + 3 * GMAX + 8 * ROWS + GMAX * ROWS);
};

// x [B, S, H, P], Bv / Cv [B, S, N] bf16; dt [B, S, H], A_log / D [H], states
// [B, nC, H, P, N] float32; gout [B, nC, H, P, N] bf16 and gs [B, nC, H, 2]
// (the state kernel's); dy [B, S, H, P] float32. Writes dx [B, S, H, P]
// bf16, ddt [B, S, H], dDp / dAp [B, nC, H] and the group's dBp / dCp [B,
// nC, ceil(H / GH), Q, N] float32. One CTA of two warpgroups per (batch,
// chunk, group of GH heads), each warpgroup owning 64 rows of every [Q x .]
// product: dC's rows i, then dx's and dB's rows j. C B^T, B G^T and every
// product with B, C or x as an operand are exact in bf16; dy, S_prev and the
// operands made in float32 (E, M^T, exp(cs) o dy, wq o x) enter as bf16 hi +
// lo; G enters as bf16 (its lo term is below the tolerance). dC and dB sum
// the group's heads in their accumulators: with TWO_PASS (N > 64, where
// both would not fit the registers) one pass over the heads for dC, then
// one for dB, dx and the rest.
template <int NB, bool TWO_PASS, bool VEC>
__global__ void __launch_bounds__(2 * WG, 1)
ssd_bwd_chunk_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                        const bf16* __restrict__ Bv, const bf16* __restrict__ Cv,
                        const float* __restrict__ A_log, const float* __restrict__ Dp,
                        const float* __restrict__ states, const bf16* __restrict__ gout,
                        const float* __restrict__ gs, const float* __restrict__ dy,
                        bf16* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ dBp,
                        float* __restrict__ dCp, float* __restrict__ dDp,
                        float* __restrict__ dAp, int S, int H, int P, int N, int Q, int GH) {
  using L = ChunkSmem<NB>;
  constexpr int NS = 32 * NB;  // registers of a [64 x 64 NB] accumulator
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm = smem_raw;
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t Cs = base + L::C, Bs = base + L::B, xs = base + L::X, dyh = base + L::DYH,
                 dyl = base + L::DYL, sh = base + L::SH, sl = base + L::SL, gt = base + L::G;
  float* dts = reinterpret_cast<float*>(smem_raw + L::F);
  float* cs2 = dts + ROWS;   // cs log2(e)
  float* es = cs2 + ROWS;    // exp(cs_i)
  float* eq = es + ROWS;     // exp(cs_Q - cs_j)
  float* wq = eq + ROWS;     // exp(cs_Q - cs_j) dt_j
  float* rsum = wq + ROWS;   // sum_i R_ij
  float* wv = rsum + ROWS;   // W_j
  float* dd = wv + ROWS;     // dy_j . x_j
  float* seg = dd + ROWS;    // [16] segment sums
  float* hA = seg + 16;      // [GMAX] A of the group's heads
  float* hD = hA + GMAX;     // [GMAX] D
  float* hG = hD + GMAX;     // [GMAX] <G, S_prev>
  float* red = hG + GMAX;    // [8][ROWS] each warp's sums of T = R dt_j over its rows j
  float* Us = red + 8 * ROWS;  // [GMAX][ROWS] U_i of the group's heads

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = tid / WG;
  const int gr = lane >> 2, gc = lane & 3;
  const int row = 16 * (warp & 3) + gr;  // the thread's first row of a 64-row tile
  const int R0 = 64 * wg;                // the warpgroup's rows of the chunk
  const int nC = (S + Q - 1) / Q, ng = (H + GH - 1) / GH;
  const int grp = blockIdx.x % ng, bc = blockIdx.x / ng, b = bc / nC, c = bc - b * nC;
  const int c0 = c * Q, rows = min(Q, S - c0);
  const int h0 = grp * GH, h1 = min(H, h0 + GH);
  const size_t PN = (size_t)P * N, ldx = (size_t)H * P;
  auto x_of = [&](int h) { return ((size_t)b * S + c0) * H * P + (size_t)h * P; };
  auto s_of = [&](int h) { return ((size_t)(b * nC + c) * H + h) * PN; };

  // the decays of the head in slot hl from dt (dtv: the thread's step's;
  // dts holds them): the cumsum of dt A by the first warpgroup, a step a
  // thread; then every thread's tile writes made visible to the tensor cores
  auto decays = [&](int hl, float dtv) {
    float v = 0.f;
    if (tid < ROWS) {
      v = dtv * hA[hl];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(FULL, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) seg[warp] = v;
    }
    __syncthreads();
    if (tid < ROWS) {
      float before = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) before += w < warp ? seg[w] : 0.f;
      v += before;
      const float last = ((seg[0] + seg[1]) + seg[2]) + seg[3];
      cs2[tid] = v * LOG2E;
      es[tid] = expf(v);
      eq[tid] = expf(last - v);
      wq[tid] = eq[tid] * dtv;
    }
    fence_proxy_async();  // the tiles written by the threads, visible to the tensor cores
    __syncthreads();
  };

  // head h's x, dy (hi + lo), dt and, as asked, S_prev (hi + lo) and G,
  // every global load in flight before the first store; then its decays
  auto stage_head = [&](int h, bool withS, bool withG) {
    const size_t xo = x_of(h), so = s_of(h);
    __syncthreads();  // the previous head's readers are done
    tile_bf16<ROWS, 1, 2 * WG>(xs, sm + L::X, x + xo, ldx, rows, P, VEC, tid);
    if (withG) tile_bf16<PT, NB, 2 * WG>(gt, sm + L::G, gout + so, N, P, N, VEC, tid);
    cp_async_commit();
    const float dtv = tid < rows ? dt[((size_t)b * S + c0 + tid) * H + h] : 0.f;
    SplitTile<ROWS, 1, 2 * WG> dyt;
    SplitTile<PT, NB, 2 * WG> spt;
    dyt.load(dy + xo, ldx, rows, P, VEC, tid);
    if (withS) spt.load(states + so, N, P, N, VEC, tid);
    if (tid < ROWS) dts[tid] = dtv;
    dyt.store(sm + L::DYH, sm + L::DYL, tid);
    if (withS) spt.store(sm + L::SH, sm + L::SL, tid);
    cp_async_wait<0>();
    __syncthreads();
    decays(h - h0, dtv);
  };

  // dC += Z + E B for the head in slot hl, Z = (exp(cs) o dy) S_prev, E =
  // L dt_j o dy x^T; U_i = C_i . Z_i into Us. The warpgroup's rows are i.
  auto phase_c = [&](float (&dC)[NS], int hl) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = R0 + row + 8 * (q & 1);
        const uint32_t off = swz(ROWS, i, 2 * kk + (q >> 1)) + 4 * gc;
        const float2 hv = unpack(lds32(sm + L::DYH + off)), lv = unpack(lds32(sm + L::DYL + off));
        const float e = es[i];
        split((hv.x + lv.x) * e, (hv.y + lv.y) * e, ah[kk][q], al[kk][q]);
      }
    float z[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) z[k] = 0.f;
    fence_regs(z);
    fence_regs(ah);
    fence_regs(al);
    const uint32_t shq = opaque(sh), slq = opaque(sl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs(z, ah[kk], desc_mn(shq, PT, kk));
      wgmma_rs(z, al[kk], desc_mn(shq, PT, kk));
      wgmma_rs(z, ah[kk], desc_mn(slq, PT, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(z);
    fence_regs(ah);
    fence_regs(al);
    float u[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < NS / 4; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float2 cv = unpack(lds32(sm + L::C + swz(ROWS, R0 + row + 8 * hr, t) + 4 * gc));
        u[hr] = fmaf(z[4 * t + 2 * hr], cv.x, fmaf(z[4 * t + 2 * hr + 1], cv.y, u[hr]));
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      u[hr] += __shfl_xor_sync(FULL, u[hr], 1);
      u[hr] += __shfl_xor_sync(FULL, u[hr], 2);
      if (gc == 0) Us[hl * ROWS + R0 + row + 8 * hr] = u[hr];
    }
#pragma unroll
    for (int k = 0; k < NS; ++k) dC[k] += z[k];
    // E by 64 x 64 blocks: rows i of this warpgroup, columns j of block q.
    // The first warpgroup's block q = 1 lies above the diagonal, all zero: in
    // one pass it is skipped (the first warpgroup goes on to the second
    // phase meanwhile); in two, where a barrier follows, computed
#pragma unroll 1
    for (int q = 0; q <= (TWO_PASS ? 1 : wg); ++q) {
      const uint32_t dyhq = opaque(dyh), dylq = opaque(dyl), xq = opaque(xs), Bq = opaque(Bs);
      float s[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_k(dyhq, ROWS, R0, kk), desc_k(xq, ROWS, 64 * q, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss(s, desc_k(dylq, ROWS, R0, kk), desc_k(xq, ROWS, 64 * q, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      uint32_t eh[4][4], el[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int t = 2 * kk + (qq >> 1), hr = qq & 1;
          const int i = R0 + row + 8 * hr, j = 64 * q + 8 * t + 2 * gc;
          const float ci = cs2[i];
          const float v0 = j <= i ? s[4 * t + 2 * hr] * exp2_approx(ci - cs2[j]) * dts[j] : 0.f;
          const float v1 =
              j + 1 <= i ? s[4 * t + 2 * hr + 1] * exp2_approx(ci - cs2[j + 1]) * dts[j + 1] : 0.f;
          split(v0, v1, eh[kk][qq], el[kk][qq]);
        }
      fence_regs(dC);
      fence_regs(eh);
      fence_regs(el);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dC, eh[kk], desc_mn(Bq, ROWS, 4 * q + kk));
        wgmma_rs(dC, el[kk], desc_mn(Bq, ROWS, 4 * q + kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dC);
      fence_regs(eh);
      fence_regs(el);
    }
  };

  // dB += (wq o x) G + E^T C and dx = wq_j B_j G^T + D dy + M^T dy for head h
  // (slot hl), M^T = L dt_j o B C^T and E^T = L dt_j o x dy^T; W, rsum, dd
  // and the column sums of T into shared memory. The warpgroup's rows are j.
  auto phase_b = [&](float (&dB)[NS], int h, int hl) {
    float y[32];
    {
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = R0 + row + 8 * (q & 1);
          const float2 xv = unpack(lds32(sm + L::X + swz(ROWS, j, 2 * kk + (q >> 1)) + 4 * gc));
          const float w = wq[j];
          split(xv.x * w, xv.y * w, ah[kk][q], al[kk][q]);
        }
      const uint32_t Bq = opaque(Bs), gq = opaque(gt);
      fence_regs(dB);
      fence_regs(ah);
      fence_regs(al);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss(y, desc_k(Bq, ROWS, R0, kk), desc_k(gq, PT, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs(dB, ah[kk], desc_mn(gq, PT, kk));
        wgmma_rs(dB, al[kk], desc_mn(gq, PT, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(dB);
      fence_regs(ah);
      fence_regs(al);
    }
    // W_j = exp(cs_Q - cs_j) x_j . (B G^T)_j; then dx = wq_j (B G^T) + D dy
    const float Dh = hD[hl];
    float wp[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int j = R0 + row + 8 * hr;
        const uint32_t off = swz(ROWS, j, t) + 4 * gc;
        const float2 xv = unpack(lds32(sm + L::X + off));
        const float2 hv = unpack(lds32(sm + L::DYH + off)), lv = unpack(lds32(sm + L::DYL + off));
        float& y0 = y[4 * t + 2 * hr];
        float& y1 = y[4 * t + 2 * hr + 1];
        wp[hr] = fmaf(y0, xv.x, fmaf(y1, xv.y, wp[hr]));
        y0 = fmaf(Dh, hv.x + lv.x, wq[j] * y0);
        y1 = fmaf(Dh, hv.y + lv.y, wq[j] * y1);
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      wp[hr] += __shfl_xor_sync(FULL, wp[hr], 1);
      wp[hr] += __shfl_xor_sync(FULL, wp[hr], 2);
      const int j = R0 + row + 8 * hr;
      if (gc == 0) wv[j] = eq[j] * wp[hr];
    }
    // by 64 x 32 blocks: rows j of this warpgroup, columns i of block qb;
    // 32 columns keep the block's accumulators and A fragments within the
    // registers. The second warpgroup's blocks qb < 2 lie below the diagonal,
    // all zero: skipped in one pass (with the first phase's skipped block,
    // each warpgroup runs 6 of the 12 blocks' worth of products a head),
    // computed in two
    float rs[2] = {0.f, 0.f};
#pragma unroll 1
    for (int qb = TWO_PASS ? 0 : 2 * wg; qb < 4; ++qb) {
      uint32_t Bq = opaque(Bs), Cq = opaque(Cs), xq = opaque(xs), dyhq = opaque(dyh),
               dylq = opaque(dyl);
      float s1[16], s2[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk)
        wgmma_ss_n32(s1, desc_k(Bq, ROWS, R0, kk), desc_k(Cq, ROWS, 32 * qb, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(s2, desc_k(xq, ROWS, R0, kk), desc_k(dyhq, ROWS, 32 * qb, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n32(s2, desc_k(xq, ROWS, R0, kk), desc_k(dylq, ROWS, 32 * qb, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s1);
      fence_regs(s2);
      // R = L o B C^T o x dy^T: its sums over i (rs) and, times dt_j, over
      // the warp's rows j (into red); s1 becomes M^T = L dt_j o B C^T, s2
      // E^T = L dt_j o x dy^T
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float ct[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = R0 + row + 8 * hr, i = 32 * qb + 8 * t + 2 * gc;
          const float dj = dts[j], cj = cs2[j];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * t + 2 * hr + e;
            const float lw = i + e >= j ? exp2_approx(cs2[i + e] - cj) : 0.f;
            const float r = lw * s1[k] * s2[k];
            rs[hr] += r;
            ct[e] = hr == 0 ? r * dj : fmaf(r, dj, ct[e]);
            if (i + e == j) dd[j] = s2[k];
            s1[k] *= lw * dj;
            s2[k] *= lw * dj;
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = ct[e];
          v += __shfl_xor_sync(FULL, v, 4);
          v += __shfl_xor_sync(FULL, v, 8);
          v += __shfl_xor_sync(FULL, v, 16);
          if (gr == 0) red[warp * ROWS + 32 * qb + 8 * t + 2 * gc + e] = v;
        }
      }
      uint32_t mh[2][4], ml[2][4], eh[2][4], el[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const int k = 4 * (2 * kk + (qq >> 1)) + 2 * (qq & 1);
          split(s1[k], s1[k + 1], mh[kk][qq], ml[kk][qq]);
          split(s2[k], s2[k + 1], eh[kk][qq], el[kk][qq]);
        }
      fence_regs(y);
      fence_regs(dB);
      fence_regs(mh);
      fence_regs(ml);
      fence_regs(eh);
      fence_regs(el);
      dyhq = opaque(dyh), dylq = opaque(dyl), Cq = opaque(Cs);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        wgmma_rs(y, mh[kk], desc_mn(dyhq, ROWS, 2 * qb + kk));
        wgmma_rs(y, mh[kk], desc_mn(dylq, ROWS, 2 * qb + kk));
        wgmma_rs(y, ml[kk], desc_mn(dyhq, ROWS, 2 * qb + kk));
        wgmma_rs(dB, eh[kk], desc_mn(Cq, ROWS, 2 * qb + kk));
        wgmma_rs(dB, el[kk], desc_mn(Cq, ROWS, 2 * qb + kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(y);
      fence_regs(dB);
      fence_regs(mh);
      fence_regs(ml);
      fence_regs(eh);
      fence_regs(el);
    }
    // dx, written once; sum_i R_ij
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = R0 + row + 8 * hr;
      rs[hr] += __shfl_xor_sync(FULL, rs[hr], 1);
      rs[hr] += __shfl_xor_sync(FULL, rs[hr], 2);
      if (gc == 0) rsum[j] = rs[hr];
      if (j >= rows) continue;
      bf16* o = dx + ((size_t)b * S + c0 + j) * ldx + (size_t)h * P;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int p = 8 * t + 2 * gc;
        if (p < P) put2(o + p, y[4 * t + 2 * hr], y[4 * t + 2 * hr + 1], p, P);
      }
    }
  };

  // head h (slot hl): d cs from the sums, summed backward over the chunk by
  // the first warpgroup, a warp to each 32 steps (each warp's suffix sums,
  // then the later warps' totals), in a fixed order; ddt, and the partials
  // of dA_log and dD
  auto finish = [&](int h, int hl) {
    __syncthreads();  // every warp's sums are in shared memory
    if (wg != 0) return;
    const float A = hA[hl];
    const int k = 32 * warp + lane;
    float colT = 0.f;  // the first warpgroup's warps reach every column, the second's i >= 64
    for (int w = 0; w < (k < 64 ? 4 : 8); ++w) colT += red[w * ROWS + k];
    const float dk = dts[k];
    // dt_k sum_i R_ki rounded alone, as each T = R dt was: the two sums of
    // one step's T (a chunk of one step) then cancel exactly, as the plain
    // backward's do
    float s = colT - __fmul_rn(dk, rsum[k]) + Us[hl * ROWS + k] - wv[k] * dk;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_down_sync(FULL, s, off);
      if (lane + off < 32) s += t;
    }
    const float ws = warp_sum(wv[k] * dk), dDs = warp_sum(dd[k]);
    if (lane == 0) {
      seg[warp] = s;  // the warp's total
      seg[4 + warp] = ws;
      seg[12 + warp] = dDs;
    }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the first warpgroup's warps
    // d cs_Q: exp(cs_Q) <G, S_prev> + sum_j W_j dt_j reaches every step;
    // then the later warps' steps
    float carry = es[ROWS - 1] * hG[hl] + (((seg[4] + seg[5]) + seg[6]) + seg[7]);
    for (int w = 3; w > warp; --w) carry += seg[w];
    s += carry;
    if (k < rows) ddt[((size_t)b * S + c0 + k) * H + h] = fmaf(s, A, rsum[k] + wv[k]);
    const float dA = warp_sum(s * dk);
    if (lane == 0) seg[8 + warp] = dA;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    if (tid == 0) {
      dAp[(size_t)(b * nC + c) * H + h] = (((seg[8] + seg[9]) + seg[10]) + seg[11]) * A;
      dDp[(size_t)(b * nC + c) * H + h] = ((seg[12] + seg[13]) + seg[14]) + seg[15];
    }
  };

  // a [Q x N] partial of the group from the warpgroup's accumulator (its
  // address made here: hoisted above the heads' loop, it was spilled)
  auto write_part = [&](float* part, const float (&acc)[NS]) {
    float* o = part + (size_t)opaque(bc * ng + grp) * Q * N;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int i = R0 + row + 8 * hr;
      if (i >= rows) continue;
#pragma unroll
      for (int t = 0; t < NS / 4; ++t) {
        const int n = 8 * t + 2 * gc;
        if (n < N) put2(o + (size_t)i * N + n, acc[4 * t + 2 * hr], acc[4 * t + 2 * hr + 1], n, N);
      }
    }
  };

  // the chunk's B and C, once (landed by the first head's wait); the group's
  // A, D and <G, S_prev> (visible from the first head's barriers on)
  tile_bf16<ROWS, NB, 2 * WG>(Cs, sm + L::C, Cv + ((size_t)b * S + c0) * N, N, rows, N, VEC, tid);
  tile_bf16<ROWS, NB, 2 * WG>(Bs, sm + L::B, Bv + ((size_t)b * S + c0) * N, N, rows, N, VEC, tid);
  cp_async_commit();
  if (tid < h1 - h0) {
    const int h = h0 + tid;
    const float* g2 = gs + ((size_t)(b * nC + c) * H + h) * 2;
    hA[tid] = -expf(A_log[h]);
    hD[tid] = Dp[h];
    hG[tid] = N > 64 ? g2[0] + g2[1] : g2[0];
  }
  if constexpr (TWO_PASS) {
    {
      float dC[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) dC[k] = 0.f;
#pragma unroll 1
      for (int h = h0; h < h1; ++h) {
        stage_head(h, true, false);
        phase_c(dC, h - h0);
      }
      write_part(dCp, dC);
    }
    float dB[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) dB[k] = 0.f;
#pragma unroll 1
    for (int h = h0; h < h1; ++h) {
      stage_head(h, false, true);
      phase_b(dB, h, h - h0);
      finish(h, h - h0);
    }
    write_part(dBp, dB);
  } else {
    float dC[NS], dB[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) dC[k] = dB[k] = 0.f;
#pragma unroll 1
    for (int h = h0; h < h1; ++h) {
      stage_head(h, true, true);
      phase_c(dC, h - h0);
      phase_b(dB, h, h - h0);
      finish(h, h - h0);
    }
    write_part(dCp, dC);
    write_part(dBp, dB);
  }
}

}  // namespace tc

}  // namespace

// Each launcher: dtype 0 float32 (the scalar kernels), 1 bfloat16 (the
// tensor-core kernels: x, Bv, Cv, dx, dB, dC and gout in bf16); everything
// else float32; contiguous; P <= 64, N <= 128, 1 <= Q <= 128. Returns the
// launch's CUDA error code.

namespace {
bool aligned16(std::initializer_list<const void*> ps) {
  uintptr_t a = 0;
  for (const void* p : ps) a |= reinterpret_cast<uintptr_t>(p);
  return (a & 15) == 0;
}
}  // namespace

// the reverse scan: gout [B, nC, H, P, N] (float32, or bf16 for dtype 1);
// dfin and ds0 may be null; for dtype 1 also gs [B, nC, H, 2] = <G leaving,
// state entering> each chunk over N's columns 0-63 and 64-127, from states
// [B, nC, H, P, N]
extern "C" int ssd_bwd_state_launch(const void* dy, const void* dt, const void* Cv,
                                    const void* A_log, const void* dfin, const void* states,
                                    void* gout, void* gs, void* ds0, int B, int S, int H, int P,
                                    int N, int Q, int dtype, void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* dyf = static_cast<const float*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* df = static_cast<const float*>(dfin);
  float* d0 = static_cast<float*>(ds0);
  int err;
  if (dtype == 0) {
    const size_t smem = state_smem_floats(Q, N) * sizeof(float);
    const dim3 grid(B * H, (P + PMAX - 1) / PMAX);
    auto kern = ssd_bwd_state_kernel;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<grid, NT, smem, st>>>(dyf, dtf, static_cast<const float*>(Cv), al, df,
                                 static_cast<float*>(gout), d0, S, H, P, N, Q);
    return (int)cudaGetLastError();
  }
  const bf16* cb = static_cast<const bf16*>(Cv);
  const float* sf = static_cast<const float*>(states);
  bf16* go = static_cast<bf16*>(gout);
  float* gsf = static_cast<float*>(gs);
  const int vec = aligned16({dy, Cv}) && N % 8 == 0 && P % 4 == 0;
  auto kern = tc::ssd_bwd_state_tc_kernel;
  if ((err = set_smem(kern, tc::STATE_SMEM)) != 0) return err;
  kern<<<dim3(B * H, (N + 63) / 64), tc::WG, tc::STATE_SMEM, st>>>(dyf, dtf, cb, al, df, sf, go,
                                                                    gsf, d0, S, H, P, N, Q, vec);
  return (int)cudaGetLastError();
}

// the pass per chunk: dx, ddt, dDp / dAp [B, nC, H] and the partials dBp /
// dCp: [B, nC, H, Q, N] one per head (dtype 0), or [B, nC, ceil(H / GH), Q,
// N] one per group of GH <= 16 heads (dtype 1, which also reads gs)
extern "C" int ssd_bwd_chunk_launch(const void* x, const void* dt, const void* Bv,
                                    const void* Cv, const void* A_log, const void* D,
                                    const void* states, const void* gout, const void* gs,
                                    const void* dy, void* dx, void* ddt, void* dBp, void* dCp,
                                    void* dDp, void* dAp, int B, int S, int H, int P, int N,
                                    int Q, int GH, int dtype, void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nC = (S + Q - 1) / Q;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  const float* sf = static_cast<const float*>(states);
  const float* dyf = static_cast<const float*>(dy);
  float* ddtf = static_cast<float*>(ddt);
  float* bp = static_cast<float*>(dBp);
  float* cp = static_cast<float*>(dCp);
  float* Dpp = static_cast<float*>(dDp);
  float* Ap = static_cast<float*>(dAp);
  int err;
  if (dtype == 0) {
    const size_t smem = chunk_smem_floats(Q, P) * sizeof(float);
    const long long grid = (long long)B * nC * H;
    if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
    auto kern = ssd_bwd_chunk_kernel;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<(unsigned)grid, NT, smem, st>>>(
        static_cast<const float*>(x), dtf, static_cast<const float*>(Bv),
        static_cast<const float*>(Cv), al, dp, sf, static_cast<const float*>(gout), dyf,
        static_cast<float*>(dx), ddtf, bp, cp, Dpp, Ap, S, H, P, N, Q);
    return (int)cudaGetLastError();
  }
  if (GH < 1 || GH > tc::GMAX) return (int)cudaErrorInvalidValue;
  const long long grid = (long long)B * nC * ((H + GH - 1) / GH);
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* bb = static_cast<const bf16*>(Bv);
  const bf16* cb = static_cast<const bf16*>(Cv);
  const bf16* gb = static_cast<const bf16*>(gout);
  const float* gsf = static_cast<const float*>(gs);
  bf16* dxb = static_cast<bf16*>(dx);
  // VEC (16-byte copies) where every row of every operand is 16-byte aligned;
  // a template flag: the element copies' code in the same instance made
  // ptxas spill
  const bool vec = aligned16({x, Bv, Cv, gout, dy, states}) && N % 8 == 0 && P % 8 == 0;
  auto kern = N <= 64 ? (vec ? tc::ssd_bwd_chunk_tc_kernel<1, false, true>
                             : tc::ssd_bwd_chunk_tc_kernel<1, false, false>)
                      : (vec ? tc::ssd_bwd_chunk_tc_kernel<2, true, true>
                             : tc::ssd_bwd_chunk_tc_kernel<2, true, false>);
  const size_t smem = N <= 64 ? tc::ChunkSmem<1>::bytes : tc::ChunkSmem<2>::bytes;
  if ((err = set_smem(kern, smem)) != 0) return err;
  kern<<<(unsigned)grid, 2 * tc::WG, smem, st>>>(xb, dtf, bb, cb, al, dp, sf, gb, gsf, dyf, dxb,
                                                 ddtf, bp, cp, Dpp, Ap, S, H, P, N, Q, GH);
  return (int)cudaGetLastError();
}

// the sums over partials and chunks: dB, dC [B, S, N] from NP partials a
// chunk (dBp, dCp [B, nC, NP, Q, N]), dD, dA_log [H] from dDp, dAp [B, nC, H]
extern "C" int ssd_bwd_reduce_launch(const void* dBp, const void* dCp, const void* dDp,
                                     const void* dAp, void* dB, void* dC, void* dD,
                                     void* dA_log, int B, int S, int H, int NP, int N, int Q,
                                     int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || NP < 1 || N < 1 || N > NMAX || Q < 1 || Q > QMAX ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long blocks = ((long long)B * S * N + NT - 1) / NT;
  if (blocks >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(dBp);
  const float* cp = static_cast<const float*>(dCp);
  const float* Dpp = static_cast<const float*>(dDp);
  const float* Ap = static_cast<const float*>(dAp);
  float* dDf = static_cast<float*>(dD);
  float* dAf = static_cast<float*>(dA_log);
  if (dtype == 0)
    ssd_bwd_reduce_kernel<float><<<(unsigned)blocks, NT, 0, st>>>(
        bp, cp, Dpp, Ap, static_cast<float*>(dB), static_cast<float*>(dC), dDf, dAf, B, S, H,
        NP, N, Q);
  else
    ssd_bwd_reduce_kernel<bf16><<<(unsigned)blocks, NT, 0, st>>>(
        bp, cp, Dpp, Ap, static_cast<bf16*>(dB), static_cast<bf16*>(dC), dDf, dAf, B, S, H, NP,
        N, Q);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one CTA of the float32 state and chunk kernels,
// and of the bf16 ones at state width N, in bytes.
extern "C" size_t ssd_bwd_state_smem_bytes(int Q, int N) {
  return state_smem_floats(Q, N) * sizeof(float);
}
extern "C" size_t ssd_bwd_chunk_smem_bytes(int Q, int P) {
  return chunk_smem_floats(Q, P) * sizeof(float);
}
extern "C" size_t ssd_bwd_tc_smem_bytes(int N, int chunk_pass) {
  if (chunk_pass) return N <= 64 ? tc::ChunkSmem<1>::bytes : tc::ChunkSmem<2>::bytes;
  return tc::STATE_SMEM;
}

// The heads of a group, at most.
extern "C" int ssd_bwd_max_group() { return tc::GMAX; }
