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
// bit-equal):
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
// Scalar float32 FMAs out of shared memory, for bfloat16 and float32 inputs
// alike (bf16 values are widened on load; gradients rounded once on store).
//
// Bound (B 4, S 512, Q 128, P 64, bf16 x, B, C; float32 dy and states): by
// bytes, x, dy, dt, B, C and the states read once and dx, dt, dB, dC
// written once: ~40 MB for Mamba-2 (H 24, N 128) and ~148 MB for Zamba2
// (H 112, N 64), 12 and 44 us at 3.35 TB/s. The products, counted once (the
// heads share B and C, so C.B^T and E's products with B and C once per
// chunk), are 4.1 and 11.3 GFLOP: 4 and 11 us at the bf16 tensor-core
// peak, but 62 and 170 us at the 67 TFLOP/s of scalar float32, and these
// kernels repeat C.B^T and the products with B and C per head (8.8 and 24
// GFLOP). So they are bound by operations, several times over the bytes;
// moving the Q x Q products onto `wgmma` as the forward's `ssd_tc_kernel`
// does is the redesign that would close it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

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

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
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
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_state_kernel(const float* __restrict__ dy, const float* __restrict__ dt,
                     const T* __restrict__ Cv, const float* __restrict__ A_log,
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
      Ct[n * QS + j] = j < rows ? ld(Cv + ((size_t)b * S + c0 + j) * N + n) : 0.f;
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
template <typename T>
__device__ __forceinline__ void load_bc(float* Bs, float* Cs, const T* Bv, const T* Cv, int b,
                                        int S, int N, int c0, int rows, int Q, int n0,
                                        int tid) {
  for (int e = tid; e < Q * NL; e += NT) {
    const int j = e / NL, nn = e - j * NL, n = n0 + nn;
    const bool ok = j < rows && n < N;
    const size_t g = ((size_t)b * S + c0 + j) * N + n;
    Bs[j * NLS + nn] = ok ? ld(Bv + g) : 0.f;
    Cs[j * NLS + nn] = ok ? ld(Cv + g) : 0.f;
  }
}

// x [B, S, H, P], Bv / Cv [B, S, N] (T); dt [B, S, H], A_log / D [H],
// states and gout [B, nC, H, P, N] (the state entering each chunk, its
// gradient leaving it), dy [B, S, H, P] float32. Writes dx [B, S, H, P] (T),
// ddt [B, S, H], and the head's partials dBp / dCp [B, nC, H, Q, N] and
// dDp / dAp [B, nC, H] (float32). One CTA per (batch, chunk, head), heads
// fastest: the CTAs of one chunk read its B and C from L2. Threads (ty, tx)
// of 16 x 16 own chunk rows ty + 16 a and columns tx + 16 k.
template <typename T>
__global__ void __launch_bounds__(NT, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const T* __restrict__ Bv, const T* __restrict__ Cv,
                     const float* __restrict__ A_log, const float* __restrict__ Dp,
                     const float* __restrict__ states, const float* __restrict__ gout,
                     const float* __restrict__ dy, T* __restrict__ dx,
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
    xt[p * QS + j] = j < rows ? ld(x + g) : 0.f;
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

// dB / dC [B, S, N] (T) = the partials [B, nC, H, Q, N] summed over heads in
// order; dD / dA_log [H] = the partials [B, nC, H] summed over (b, c) in
// order (by the first CTA). One thread per (b, s, n).
template <typename T>
__global__ void __launch_bounds__(NT)
ssd_bwd_reduce_kernel(const float* __restrict__ dBp, const float* __restrict__ dCp,
                      const float* __restrict__ dDp, const float* __restrict__ dAp,
                      T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dD,
                      float* __restrict__ dA_log, int B, int S, int H, int N, int Q) {
  const int nC = (S + Q - 1) / Q;
  const size_t idx = (size_t)blockIdx.x * NT + threadIdx.x;
  if (idx < (size_t)B * S * N) {
    const int n = (int)(idx % N);
    const size_t bs = idx / N;
    const int s = (int)(bs % S), b = (int)(bs / S), c = s / Q, i = s - c * Q;
    const size_t step = (size_t)Q * N;
    const size_t base = (size_t)(b * nC + c) * H * step + (size_t)i * N + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < H; ++h) {
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

}  // namespace

// Each launcher: dtype 0 float32, 1 bfloat16 (x, Bv, Cv, dx, dB, dC);
// everything else float32; contiguous; P <= 64, N <= 128, 1 <= Q <= 128.
// Returns the launch's CUDA error code.

// the reverse scan: gout [B, nC, H, P, N]; dfin and ds0 may be null
extern "C" int ssd_bwd_state_launch(const void* dy, const void* dt, const void* Cv,
                                    const void* A_log, const void* dfin, void* gout,
                                    void* ds0, int B, int S, int H, int P, int N, int Q,
                                    int dtype, void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = state_smem_floats(Q, N) * sizeof(float);
  const dim3 grid(B * H, (P + PMAX - 1) / PMAX);
  const float* dyf = static_cast<const float*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* df = static_cast<const float*>(dfin);
  float* go = static_cast<float*>(gout);
  float* d0 = static_cast<float*>(ds0);
  int err;
  if (dtype == 0) {
    auto kern = ssd_bwd_state_kernel<float>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<grid, NT, smem, st>>>(dyf, dtf, static_cast<const float*>(Cv), al, df, go, d0, S, H,
                                 P, N, Q);
  } else {
    auto kern = ssd_bwd_state_kernel<bf16>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<grid, NT, smem, st>>>(dyf, dtf, static_cast<const bf16*>(Cv), al, df, go, d0, S, H,
                                 P, N, Q);
  }
  return (int)cudaGetLastError();
}

// the pass per chunk: dx, ddt and the per-head partials dBp / dCp [B, nC, H,
// Q, N], dDp / dAp [B, nC, H]
extern "C" int ssd_bwd_chunk_launch(const void* x, const void* dt, const void* Bv,
                                    const void* Cv, const void* A_log, const void* D,
                                    const void* states, const void* gout, const void* dy,
                                    void* dx, void* ddt, void* dBp, void* dCp, void* dDp,
                                    void* dAp, int B, int S, int H, int P, int N, int Q,
                                    int dtype, void* stream) {
  if (bad_shape(B, S, H, P, N, Q) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = chunk_smem_floats(Q, P) * sizeof(float);
  const long long grid = (long long)B * ((S + Q - 1) / Q) * H;
  if (grid >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  const float* sf = static_cast<const float*>(states);
  const float* gf = static_cast<const float*>(gout);
  const float* dyf = static_cast<const float*>(dy);
  float* ddtf = static_cast<float*>(ddt);
  float* bp = static_cast<float*>(dBp);
  float* cp = static_cast<float*>(dCp);
  float* Dpp = static_cast<float*>(dDp);
  float* Ap = static_cast<float*>(dAp);
  int err;
  if (dtype == 0) {
    auto kern = ssd_bwd_chunk_kernel<float>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<(unsigned)grid, NT, smem, st>>>(
        static_cast<const float*>(x), dtf, static_cast<const float*>(Bv),
        static_cast<const float*>(Cv), al, dp, sf, gf, dyf, static_cast<float*>(dx), ddtf, bp,
        cp, Dpp, Ap, S, H, P, N, Q);
  } else {
    auto kern = ssd_bwd_chunk_kernel<bf16>;
    if ((err = set_smem(kern, smem)) != 0) return err;
    kern<<<(unsigned)grid, NT, smem, st>>>(
        static_cast<const bf16*>(x), dtf, static_cast<const bf16*>(Bv),
        static_cast<const bf16*>(Cv), al, dp, sf, gf, dyf, static_cast<bf16*>(dx), ddtf, bp,
        cp, Dpp, Ap, S, H, P, N, Q);
  }
  return (int)cudaGetLastError();
}

// the sums over heads and chunks: dB, dC [B, S, N], dD, dA_log [H]
extern "C" int ssd_bwd_reduce_launch(const void* dBp, const void* dCp, const void* dDp,
                                     const void* dAp, void* dB, void* dC, void* dD,
                                     void* dA_log, int B, int S, int H, int N, int Q,
                                     int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || N < 1 || N > NMAX || Q < 1 || Q > QMAX ||
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
        N, Q);
  else
    ssd_bwd_reduce_kernel<bf16><<<(unsigned)blocks, NT, 0, st>>>(
        bp, cp, Dpp, Ap, static_cast<bf16*>(dB), static_cast<bf16*>(dC), dDf, dAf, B, S, H, N,
        Q);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one CTA of each of the first two kernels, in bytes.
extern "C" size_t ssd_bwd_state_smem_bytes(int Q, int N) {
  return state_smem_floats(Q, N) * sizeof(float);
}
extern "C" size_t ssd_bwd_chunk_smem_bytes(int Q, int P) {
  return chunk_smem_floats(Q, P) * sizeof(float);
}
