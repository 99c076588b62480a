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
// tail needs no padded copy and leaves the final state exact.
//
// Bound: bytes at the serve paths' shapes. Mamba-2 (B=4, S=512, H=24, P=64,
// N=128, bf16 x) moves ~23 MB per launch, Zamba2 (H=112, N=64) ~97 MB, most
// of it y written in float32; the products need ~2 GFLOP / ~5 GFLOP, far
// below the tensor cores' share of that time. Design:
// * the Pallas grid (BH, n_chunks) carries the state in VMEM across its
//   sequential chunk axis; CUDA blocks run in no order, so one CTA owns a
//   (batch, head, P tile) and loops over the chunks itself, the state tile
//   [N, PT] float32 resident in shared memory from the first chunk to the
//   last. P columns of the state and of y are independent, so P may split
//   over CTAs (PT = 16, 32 or 64: the narrowest tile that covers P, else
//   the widest that fits shared memory). At P = 64 one tile covers P: 96
//   CTAs for Mamba-2 (a split would recompute C.B^T per tile, on a second
//   wave, since one CTA fills an SM's shared memory), 448 for Zamba2;
// * every input is read once, in place: x [B, S, H, P], dt [B, S, H],
//   B and C [B, S, N] shared by all heads (the JAX wrapper broadcasts them
//   to [BH, S, N]); y is written once, and the final state once;
// * per chunk, B and C are staged transposed as float32 [N][Q + 1] (the
//   pad keeps the transposing stores free of bank conflicts), x as
//   [Q][PT]; one pass over n accumulates C.B^T (an 8 x 8 register tile per
//   thread) and C.S_prev (the inter-chunk term) together; the masked
//   decay matrix M then overwrites C's staging area, exp evaluated only
//   where j <= i;
// * scalar float32 FMAs throughout; `mma.sync`/`wgmma` tiles are later
//   work. Bytes stay the bound: C.B^T is recomputed per (head, P tile), a
//   few MFLOP per chunk on data already in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;  // 16 x 16 threads
constexpr int QMAX = 128, NMAX = 128;
constexpr int RQ = QMAX / 16, RN = NMAX / 16;  // rows per thread
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

size_t smem_floats(int Q, int N, int PT) {
  const size_t QS = Q + 1;
  const size_t cm = (size_t)N * QS > (size_t)Q * Q ? (size_t)N * QS : (size_t)Q * Q;
  return (size_t)N * QS   // Bt [N][Q + 1]
         + cm             // Ct [N][Q + 1], then M [Q][Q]
         + (size_t)Q * PT // xs [Q][PT]
         + (size_t)N * PT // state [N][PT]
         + 2 * (size_t)Q; // dt, cs
}

// x [B, S, H, P] (T), dt [B, S, H] f32, Bv / Cv [B, S, N] (T), A_log / D [H]
// f32, s0 [B, H, P, N] f32 or null; y [B, S, H, P] f32, s_out [B, H, P, N] f32.
// Grid (B * H, ceil(P / PT)).
template <typename T, int PT>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ Bv,
           const T* __restrict__ Cv, const float* __restrict__ A_log,
           const float* __restrict__ Dp, const float* __restrict__ s0, float* __restrict__ y,
           float* __restrict__ s_out, int S, int H, int P, int N, int Q) {
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
    for (int j = tid; j < Q; j += NT) {
      const int s = c0 + j;
      dts[j] = s < S ? dt[((size_t)b * S + s) * H + h] : 0.f;
    }
    for (int e = tid; e < Q * N; e += NT) {
      const int j = e / N, n = e - j * N, s = c0 + j;
      const size_t g = ((size_t)b * S + s) * N + n;
      Bt[n * QS + j] = s < S ? to_f(Bv[g]) : 0.f;
      CtM[n * QS + j] = s < S ? to_f(Cv[g]) : 0.f;
    }
    for (int e = tid; e < Q * PT; e += NT) {
      const int j = e / PT, pp = e - j * PT, s = c0 + j, p = p0 + pp;
      xs[e] = (s < S && p < P) ? to_f(x[(((size_t)b * S + s) * H + h) * P + p]) : 0.f;
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

template <typename T, int PT>
int launch_t(const void* x, const float* dt, const void* Bv, const void* Cv,
             const float* A_log, const float* D, const float* s0, float* y, float* s_out,
             int B, int S, int H, int P, int N, int Q, cudaStream_t stream) {
  auto kern = ssd_kernel<T, PT>;
  const size_t smem = smem_floats(Q, N, PT) * sizeof(float);
  // opt in to more than 48 KB on every launch (the attribute is per device)
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (P + PT - 1) / PT);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(x), dt, static_cast<const T*>(Bv),
                                   static_cast<const T*>(Cv), A_log, D, s0, y, s_out, S, H,
                                   P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pt(int PT, const void* x, const float* dt, const void* Bv, const void* Cv,
              const float* A_log, const float* D, const float* s0, float* y, float* s_out,
              int B, int S, int H, int P, int N, int Q, cudaStream_t s) {
  switch (PT) {
    case 16: return launch_t<T, 16>(x, dt, Bv, Cv, A_log, D, s0, y, s_out, B, S, H, P, N, Q, s);
    case 32: return launch_t<T, 32>(x, dt, Bv, Cv, A_log, D, s0, y, s_out, B, S, H, P, N, Q, s);
    case 64: return launch_t<T, 64>(x, dt, Bv, Cv, A_log, D, s0, y, s_out, B, S, H, P, N, Q, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shared memory of one CTA, in bytes, for chunk Q, state width N and P tile PT.
extern "C" size_t ssd_smem_bytes(int Q, int N, int PT) {
  return smem_floats(Q, N, PT) * sizeof(float);
}

// x [B, S, H, P], Bv / Cv [B, S, N] contiguous, float32 (dtype 0) or bfloat16
// (dtype 1); dt [B, S, H], A_log / D [H], s0 [B, H, P, N] (or null: zeros)
// float32; y [B, S, H, P] and s_out [B, H, P, N] float32. 1 <= Q <= 128,
// N <= 128, PT in {16, 32, 64}. Returns the launch's CUDA error code.
extern "C" int ssd_launch(const void* x, const void* dt, const void* Bv, const void* Cv,
                          const void* A_log, const void* D, const void* s0, void* y,
                          void* s_out, int B, int S, int H, int P, int N, int Q, int PT,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > QMAX || N < 1 || N > NMAX) return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* al = static_cast<const float*>(A_log);
  const float* dp = static_cast<const float*>(D);
  const float* s0f = static_cast<const float*>(s0);
  float* yf = static_cast<float*>(y);
  float* so = static_cast<float*>(s_out);
  if (dtype == 0)
    return launch_pt<float>(PT, x, dtf, Bv, Cv, al, dp, s0f, yf, so, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return launch_pt<__nv_bfloat16>(PT, x, dtf, Bv, Cv, al, dp, s0f, yf, so, B, S, H, P, N,
                                    Q, s);
  return (int)cudaErrorInvalidValue;
}
