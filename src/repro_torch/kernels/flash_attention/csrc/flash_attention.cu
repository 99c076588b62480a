// Causal flash attention (forward) for Hopper (sm_90a), GQA-aware, with a
// sliding-window mode.
//
// Replaces the JAX package's Pallas kernel `_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py:23, launched by
// `flash_attention_bhsd` with the GQA expansion of `ops.flash_attention`):
// online-softmax attention with a float32 running max `m`, sum `l` and
// accumulator, `-1e30` masking (query row i sees keys j <= i, top-left
// aligned) and the output `acc / max(l, 1e-30)` in q's dtype. The KV head of
// query head h is h / (H / KV): GQA reads the shared k/v rows in place, never
// a broadcast copy. `window > 0` adds the mask of the JAX package's
// `flash_attention_jax` (src/repro/models/attention.py:134): row i sees only
// keys with i - j < window (Sq == Skv), and the key tiles outside every
// row's window are never loaded (its `_block_pairs`, :67).
//
// A row may see no key of the first tiles it visits (the window's left
// edge, and the rows of the second half of a CTA's first tile), so its
// running max is still -1e30 there. Such a row adds P = 0: P is taken as
// exp(s - 0) rather than exp(s - m) while m == -1e30, as FA2 does, so that
// no result rests on -1e30 - (-1e30) cancelling. Every row sees at least its
// own key, so its max is finite when the loop ends.
//
// For training, either kernel also writes each row's log-sum-exp, float32
// [B, H, Sq] (`lse`: m * scale + log(l), +inf for a row that saw no key),
// when the caller passes a buffer for it; the backward kernels
// (`flash_attention_bwd.cu`) recompute P from it. The store is a template
// flag (`LSE`), instantiated only at the backward's head dims (D = Dv <=
// 128, D = Dv = 256 and D = 192 with Dv = 128): serving's launch, with no
// buffer, runs the instance without it,
// whose code is the forward-only kernel's (a runtime branch on the pointer
// cost the bf16 kernel at D = Dv = 128 its last registers: 255 and 16 bytes
// of spill stores, against 254 and none).
//
// One kernel for each dtype (a dispatch, not a fallback).
//
// bfloat16: `flash_wgmma_kernel`, both products on the tensor cores through
// `wgmma` (bf16 operands, float32 accumulation). At the serve paths' shapes
// (B = 4, S = 512, D = 128) it is bound by bytes: q, k, v and o move ~34 MB,
// 0.010 ms at 3.35 TB/s, against 0.0065 ms for the products at 989 TFLOP/s.
// Design:
// * a CTA owns 128 query rows of one (batch, head) as two 64-row halves, so
//   every K/V tile it loads, and every wgmma B operand, serves 128 rows. Up
//   to D = Dv = 128 one warpgroup (4 warps) holds both halves, each warp 16
//   rows of each half; at D = Dv = 256 each half has a warpgroup of its own
//   (256 threads, 128 accumulators a thread), since two halves' 256-column
//   accumulators would not fit 255 registers. The grid's x is batch * head,
//   its y the query tile; with `causal` blockIdx.y counts from the last
//   tile, so the tiles with the most keys start first;
// * shared memory holds bf16 tiles in the 128-byte-swizzled layout that the
//   wgmma descriptors read (64-column blocks of 64 rows x 128 bytes, chunk
//   c of row r at c ^ (r % 8); D = 112 pads to two blocks). The Q tile is
//   loaded once; 64-key K and V tiles go through a two-stage ring by
//   `cp.async` (16 bytes a thread, rows past Skv zero-filled), the next
//   tile's copy running under this tile's products; `fence.proxy.async`
//   makes the copies visible to the tensor cores. 96 KB at D = Dv = 128:
//   two CTAs to an SM, which is also all that ~250 registers a thread allow;
//   192 KB at D = Dv = 256, one CTA an SM. MLA's D = 192 (128 columns
//   without and 64 with the rotary embedding) with Dv = 128 is the
//   one-warpgroup kernel with three 64-column blocks of Q and K (12 K-steps
//   of Q K^T; the registers are D = 128's): 128 KB, one CTA an SM;
// * S = Q K^T: `wgmma.m64n64k16`, Q and K both K-major from shared memory,
//   one per half and 16 columns of D. The online softmax runs on the
//   accumulator fragments in registers: a row's max and sum reduce over the
//   4 lanes that hold the row (`shfl_xor` 1, 2), exponentials in base 2
//   with the scale folded into one FFMA. P is rounded to bf16 in registers
//   (the fragment layout of S is the A-operand layout of P V) and never goes
//   through shared memory; `l` sums the unrounded float32 P;
// * P V: `wgmma.m64nDVk16` with P from registers and V through an MN-major
//   (transposed) descriptor of the same row-major tile;
// * causal and window: key tiles wholly above the diagonal, or wholly left
//   of the first row's window, are never loaded; the first half of a
//   one-warpgroup CTA skips the products of a tile past its last row; only
//   the tiles on the diagonal, at a window's edge or past Skv are masked.
//
// float32: `flash_fwd_kernel`, scalar float32 FMAs out of shared memory (the
// tensor cores would compute in TF32, outside the float32 tolerance). One
// CTA of 256 threads (16 x 16) per (64-row q tile, batch * head); each thread
// owns a 4 x 4 block of the score tile and 4 rows x DV/16 accumulator
// columns; q, k, v staged as float32, k and q rows padded by one word
// (209 KB at D = Dv = 256, 145 KB at D = 192 and Dv = 128). No serve path
// runs attention in float32 on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64, BK = 64, NT = 256;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

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
template <typename T, int DV, bool LSE>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Sq, int Skv,
                 int D, float scale, int causal, int window) {
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

  // keys at or past q0 + BQ are above the diagonal for every row of the tile;
  // keys at or before q0 - window are outside every row's window
  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  const int kbeg = window ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kbeg; k0 < kend; k0 += BK) {
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
        const bool ok = kpos < Skv && (!causal || qpos >= kpos) &&
                        (!window || qpos - kpos < window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - mn);
      const float sub = mn == NEG_INF ? 0.f : mn;  // a row that has seen no key adds 0
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - sub);
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
    if (LSE && tx == 0)  // m is of the scaled scores here
      lse[((size_t)b * H + h) * Sq + qi] = m[i] == NEG_INF ? INFINITY : m[i] + logf(l[i]);
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * Sq + qi) * H + h) * DV;
#pragma unroll
    for (int c = 0; c < NC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int DV>
int launch_t(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int KV, int Sq, int Skv, int D, float scale, int causal, int window,
             cudaStream_t stream) {
  auto kern = lse != nullptr ? flash_fwd_kernel<T, DV, true> : flash_fwd_kernel<T, DV, false>;
  const size_t smem = smem_bytes(D, DV);
  // opt in to more than 48 KB of shared memory on every launch: the
  // attribute belongs to the current device, and the call is cheap and
  // allowed during stream capture
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                   static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV,
                                   Sq, Skv, D, scale, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dv(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
              int KV, int Sq, int Skv, int D, int Dv, float scale, int causal, int w,
              cudaStream_t s) {
  switch (Dv) {
    case 32: return launch_t<T, 32>(q, k, v, o, lse, B, H, KV, Sq, Skv, D, scale, causal, w, s);
    case 64: return launch_t<T, 64>(q, k, v, o, lse, B, H, KV, Sq, Skv, D, scale, causal, w, s);
    case 112:
      return launch_t<T, 112>(q, k, v, o, lse, B, H, KV, Sq, Skv, D, scale, causal, w, s);
    case 128:
      return launch_t<T, 128>(q, k, v, o, lse, B, H, KV, Sq, Skv, D, scale, causal, w, s);
    case 256:
      return launch_t<T, 256>(q, k, v, o, lse, B, H, KV, Sq, Skv, D, scale, causal, w, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores

namespace wg {

constexpr int BM = 64;        // query rows of a half; a CTA owns two halves
constexpr int BN = 64;        // keys per K/V tile
constexpr int THREADS = 128;  // one warpgroup
constexpr float LN2 = 0.6931471805599453f;

template <int D, int DV>
constexpr size_t smem_bytes() {
  return sizeof(bf16) *
         (2 * (size_t)BM * padded<D>() + 2 * (size_t)BN * (padded<D>() + padded<DV>()));
}

// warpgroups of a CTA: one for both halves, or one a half where two halves'
// accumulators would not fit the registers
template <int DV>
constexpr int warpgroups() { return DV > 128 ? 2 : 1; }

// q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, DV], o [B, Sq, H, DV];
// grid (B * H, 128-row query tiles); window 0 means none
template <int D, int DV, bool LSE, int NWG = warpgroups<DV>()>
__global__ void __launch_bounds__(THREADS * NWG, 2 / NWG)
flash_wgmma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                   int H, int KV, int Sq, int Skv, float scale_log2, int causal, int window) {
  constexpr int NTHR = THREADS * NWG, HPW = 2 / NWG;  // threads; halves a warpgroup
  constexpr int NKT = BN / 8, NVT = DV / 8, BMR = 2 * BM;
  constexpr int DP = padded<D>(), DVP = padded<DV>();
  constexpr uint32_t QH = BM * DP * 2, KST = BN * DP * 2, VST = BN * DVP * 2;  // bytes
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // 2 halves x [BM x DP]
  bf16* Ks = Qs + BMR * DP;                      // [2][BN x DP]
  bf16* Vs = Ks + 2 * BN * DP;                   // [2][BN x DVP]

  const int tid = threadIdx.x, wgi = tid / THREADS, warp = (tid % THREADS) >> 5;
  const int lane = tid & 31, gr = lane >> 2, gc = lane & 3;  // fragment row group, column pair
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, g = h / (H / KV);
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BMR;
  const int r0 = warp * 16;  // this warp's first row in each of its halves

  const bf16* qg = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kg = k + ((size_t)b * Skv * KV + g) * D;
  const bf16* vg = v + ((size_t)b * Skv * KV + g) * DV;
  const size_t qstride = (size_t)H * D, kstride = (size_t)KV * D, vstride = (size_t)KV * DV;
  // keys at or past q0 + BMR are above the diagonal for every row of the
  // tile; keys at or before q0 - window are outside every row's window
  const int kend = causal ? min(Skv, q0 + BMR) : Skv;
  const int ntiles = (kend + BN - 1) / BN;
  const int t0 = window ? max(0, q0 - window + 1) / BN : 0;
  const uint32_t q_base = smem_u32(Qs), k_base = smem_u32(Ks), v_base = smem_u32(Vs);

  load_tile<D, NTHR>(q_base, qg, qstride, q0, Sq, tid);
  load_tile<D, NTHR>(q_base + QH, qg, qstride, q0 + BM, Sq, tid);
  load_tile<D, NTHR>(k_base, kg, kstride, t0 * BN, Skv, tid);
  load_tile<DV, NTHR>(v_base, vg, vstride, t0 * BN, Skv, tid);
  cp_async_commit();

  // per half of this warpgroup (half wgi * HPW + j): the accumulator
  // fragment (acc[j][4n + e] is row r0 + gr + 8 (e / 2) of the half, column
  // 8n + 2gc + e % 2: the wgmma D layout; s likewise over the tile's 64
  // keys), the running max of the raw scores and this lane's share of the
  // row sums
  float acc[HPW][DV / 2];
#pragma unroll
  for (int j = 0; j < HPW; ++j)
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[j][i] = 0.f;
  float m[HPW][2], l[HPW][2];
#pragma unroll
  for (int j = 0; j < HPW; ++j) m[j][0] = m[j][1] = NEG_INF, l[j][0] = l[j][1] = 0.f;
#pragma unroll
  for (int j = 0; j < HPW; ++j) fence_regs(acc[j]);

  for (int t = t0; t < ntiles; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < ntiles) {  // the next tile's copy runs under this tile's products
      // at D = 192 the thread index is opaque in each tile: hoisted out of
      // the key loop, the offsets of K's 12 copies a thread spill the
      // one-warpgroup kernel (255 registers, 200 bytes; 250 and none so)
      int ti = tid;
      if constexpr (NWG == 1 && D > 128) asm volatile("" : "+r"(ti));
      load_tile<D, NTHR>(k_base + (st ^ 1) * KST, kg, kstride, (t + 1) * BN, Skv, ti);
      load_tile<DV, NTHR>(v_base + (st ^ 1) * VST, vg, vstride, (t + 1) * BN, Skv, ti);
    }
    cp_async_commit();
    cp_async_wait<1>();   // every group but the newest: tile t has landed
    fence_proxy_async();  // the copies' writes, visible to the tensor cores' reads
    __syncthreads();

    const int k0 = t * BN;
    // with causal, the first half of a one-warpgroup CTA sees nothing of a
    // tile past its last row and skips its products. Every other half runs
    // every tile of the range: the only tiles it does not see are the
    // second half's first tile in window mode and, at D = 256, the first
    // half's last one, whose scores are all masked and add P = 0; a branch
    // on the warpgroup's index would put the wgmmas on a path ptxas takes as
    // divergent, and serializes (C7520)
    const bool live0 = NWG == 2 || !causal || k0 <= q0 + BM - 1;
    const uint32_t kb = k_base + st * KST, vb = v_base + st * VST;
    float s[HPW][BN / 2];
#pragma unroll
    for (int j = 0; j < HPW; ++j)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[j][i] = 0.f;
    // every non-wgmma definition of an accumulator register lands before the
    // fence, or ptxas serializes the wgmmas
#pragma unroll
    for (int j = 0; j < HPW; ++j) fence_regs(s[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int j = 0; j < HPW; ++j)
        if (j > 0 || live0)
          wgmma_ss_n64(s[j], desc_k(q_base + (wgi * HPW + j) * QH, kk), desc_k(kb, kk),
                       kk > 0);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < HPW; ++j) fence_regs(s[j]);

#pragma unroll
    for (int j = 0; j < HPW; ++j) {
      if (j == 0 && !live0) continue;
      const int lo = q0 + (wgi * HPW + j) * BM;
      // a tile on the diagonal, at a window's edge or past Skv
      const bool masked = (causal && k0 + BN - 1 > lo) ||
                          (window && lo + BM - 1 - k0 >= window) || k0 + BN > Skv;
      if (masked) {  // the raw scores: row r sees keys klo[r] < key <= khi[r]
        int klo[2], khi[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = lo + r0 + gr + 8 * r;
          khi[r] = causal ? min(row, Skv - 1) : Skv - 1;
          klo[r] = window ? row - window : -1;
        }
#pragma unroll
        for (int n = 0; n < NKT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * gc + (e & 1);
            if (key <= klo[e >> 1] || key > khi[e >> 1]) s[j][4 * n + e] = NEG_INF;
          }
      }
      float mx[2] = {m[j][0], m[j][1]};
#pragma unroll
      for (int n = 0; n < NKT; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][4 * n], s[j][4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][4 * n + 2], s[j][4 * n + 3]));
      }
      float alpha[2], nb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        alpha[r] = exp2_approx((m[j][r] - mx[r]) * scale_log2);
        m[j][r] = mx[r];
        // a row that has seen no key yet adds P = 2^(-1e30 c) = 0
        nb[r] = mx[r] == NEG_INF ? 0.f : -mx[r] * scale_log2;
      }
      // P = 2^(s * scale * log2(e) - m * scale * log2(e)): one FFMA, one ex2
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[j][i] = exp2_approx(fmaf(s[j][i], scale_log2, nb[(i >> 1) & 1]));
        rs[(i >> 1) & 1] += s[j][i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[j][r] = l[j][r] * alpha[r] + rs[r];
#pragma unroll
      for (int n = 0; n < NVT; ++n) {
        acc[j][4 * n] *= alpha[0];
        acc[j][4 * n + 1] *= alpha[0];
        acc[j][4 * n + 2] *= alpha[1];
        acc[j][4 * n + 3] *= alpha[1];
      }
    }

    // acc += P V, P rounded to bf16 in registers: S's column tiles 2kk and
    // 2kk + 1 are the A fragment of keys 16kk .. 16kk + 15
#pragma unroll
    for (int j = 0; j < HPW; ++j) fence_regs(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < HPW; ++j) {
        if (j == 0 && !live0) continue;
        wgmma_rs(acc[j], pack_bf16(s[j][8 * kk], s[j][8 * kk + 1]),
                 pack_bf16(s[j][8 * kk + 2], s[j][8 * kk + 3]),
                 pack_bf16(s[j][8 * kk + 4], s[j][8 * kk + 5]),
                 pack_bf16(s[j][8 * kk + 6], s[j][8 * kk + 7]), desc_mn(vb, kk));
      }
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < HPW; ++j) fence_regs(acc[j]);
    __syncthreads();  // every warp is done with stage st before it is refilled
  }

#pragma unroll
  for (int j = 0; j < HPW; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[j][r];
      lr += __shfl_xor_sync(FULL, lr, 1);
      lr += __shfl_xor_sync(FULL, lr, 2);
      const int qi = q0 + (wgi * HPW + j) * BM + r0 + gr + 8 * r;
      if (qi >= Sq) continue;
      if (LSE && gc == 0)  // m is of the raw scores here
        lse[((size_t)b * H + h) * Sq + qi] =
            m[j][r] == NEG_INF ? INFINITY : m[j][r] * (scale_log2 * LN2) + logf(lr);
      const float inv = 1.f / fmaxf(lr, 1e-30f);
      bf16* orow = o + (((size_t)b * Sq + qi) * H + h) * DV + 2 * gc;
#pragma unroll
      for (int n = 0; n < NVT; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
            acc[j][4 * n + 2 * r] * inv, acc[j][4 * n + 2 * r + 1] * inv);
    }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
           int KV, int Sq, int Skv, float scale, int causal, int window, cudaStream_t stream) {
  auto kern = flash_wgmma_kernel<D, DV, false>;
  if (lse != nullptr) {  // the log-sum-exp only at the backward's head dims
    if constexpr ((D == DV && D <= 128) || (D == 256 && DV == 256) || (D == 192 && DV == 128))
      kern = flash_wgmma_kernel<D, DV, true>;
    else return (int)cudaErrorInvalidValue;
  }
  constexpr size_t smem = smem_bytes<D, DV>();
  // opt in to more than 48 KB of shared memory on every launch, as the
  // scalar kernel does
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (Sq + 2 * BM - 1) / (2 * BM);
  if (ntiles > 65535) return (int)cudaErrorInvalidValue;
  kern<<<dim3(B * H, ntiles), THREADS * warpgroups<DV>(), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, H, KV, Sq, Skv, scale * LOG2E, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dv(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
              int KV, int Sq, int Skv, int Dv, float scale, int causal, int w, cudaStream_t s) {
  switch (Dv) {
    case 32: return launch<D, 32>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
    case 64: return launch<D, 64>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
    case 112: return launch<D, 112>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
    case 128: return launch<D, 128>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int H,
             int KV, int Sq, int Skv, int D, int Dv, float scale, int causal, int w,
             cudaStream_t s) {
  switch (D) {
    case 32: return launch_dv<32>(q, k, v, o, lse, B, H, KV, Sq, Skv, Dv, scale, causal, w, s);
    case 64: return launch_dv<64>(q, k, v, o, lse, B, H, KV, Sq, Skv, Dv, scale, causal, w, s);
    case 112:
      return launch_dv<112>(q, k, v, o, lse, B, H, KV, Sq, Skv, Dv, scale, causal, w, s);
    case 128:
      return launch_dv<128>(q, k, v, o, lse, B, H, KV, Sq, Skv, Dv, scale, causal, w, s);
    case 192: return launch<192, 128>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
    case 256: return launch<256, 256>(q, k, v, o, lse, B, H, KV, Sq, Skv, scale, causal, w, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace wg

// D and Dv in {32, 64, 112, 128} in any pair, or one of the pairs built
// alone: D = Dv = 256 (Gemma 3), D = 192 with Dv = 128 (MLA)
bool head_dims_ok(int D, int Dv) {
  auto any = [](int d) { return d == 32 || d == 64 || d == 112 || d == 128; };
  return (any(D) && any(Dv)) || (D == 256 && Dv == 256) || (D == 192 && Dv == 128);
}

}  // namespace

// q [B, Sq, H, D], k [B, Skv, KV, D], v [B, Skv, KV, Dv] contiguous, float32
// (dtype 0, the scalar kernel) or bfloat16 (dtype 1, the wgmma kernel; every
// pointer 16-byte aligned); o [B, Sq, H, Dv] of the same type. D, Dv in
// {32, 64, 112, 128}, or D = Dv = 256, or D = 192 with Dv = 128; H a
// multiple of KV; B * H <= 65535;
// window >= 0 (0: none; > 0 only with Sq == Skv). `lse`, when not NULL, gets
// each row's log-sum-exp of its scaled scores, float32 [B, H, Sq] (+inf for a
// row that saw no key): the backward kernels' input; with bf16 only at the
// backward's head dims (D = Dv <= 128, D = Dv = 256, D = 192 with Dv = 128).
// Returns the launch's CUDA error code (0
// on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int KV, int Sq, int Skv, int D,
                                      int Dv, int dtype, int causal, int window, float scale,
                                      void* stream) {
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!head_dims_ok(D, Dv) || window < 0 || (window > 0 && Sq != Skv))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_dv<float>(q, k, v, o, ls, B, H, KV, Sq, Skv, D, Dv, scale, causal, window, s);
  if (dtype == 1)
    return wg::launch_d(q, k, v, o, ls, B, H, KV, Sq, Skv, D, Dv, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
