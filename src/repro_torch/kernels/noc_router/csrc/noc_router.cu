// FlooNoC router cycle for Hopper (sm_90a): the two per-cycle kernels.
//
// Replaces the Pallas router-cycle kernels of the JAX package:
//   * noc_arb_kernel   <- src/repro/kernels/noc_router/noc_router.py
//                         `_arb_kernel` (plain version: ref.arb_decisions)
//   * noc_apply_kernel <- src/repro/kernels/noc_router/noc_router.py
//                         `_apply_kernel` (plain version: ref.apply_phase,
//                         i.e. link_inputs + sent_mask + fused apply_cycle)
// Both are held bit for bit against the plain PyTorch versions in
// src/repro_torch/kernels/noc_router/ref.py.
//
// Design. One simulated cycle is two launches on the caller's stream. The
// launch boundary is the arb -> link barrier: link acceptance depends on
// the *downstream* router's post-pop input space, so every router's
// `in_space` must be visible fabric-wide before any link decision. Two
// launches work at any mesh size (a one-CTA-per-channel design does not:
// at 32x32 `in_buf` alone is 287 KB per channel, over the 227 KB a block
// can hold in shared memory).
//
// Bound on an H100. Both kernels do a few integer operations per byte, so
// bytes bound them: at a 32x32 mesh the apply phase reads and rewrites
// both FIFO buffers, about 3.4 MB per cycle, ~1 us at 3.35 TB/s; the arb
// phase moves ~1.3 MB. At these sizes launch latency dominates; making
// them fast (fusing cycles, keeping state on chip) is later work.
//
// Layouts (all int32 unless noted, C-contiguous):
//   in_buf  [C, R, P, Din, NF]   out_buf [C, R, P, Dout, NF]
//   in_cnt, out_cnt, rr, wh      [C, R, P]
//   route [R, E]; link_src, link_dst [R, P, 2]; port_ep [R, P]
//   ep_space [C, E] bool; arb_pop, granted, in_space [C, R, P] bool
//   chosen [C, R, P, NF]

#include <cuda_runtime.h>
#include <stdint.h>

#define NF 7
#define F_DST 0
#define F_LAST 4
#define MAX_P 16

// JAX's `%` on integers is a floor modulo; C++'s `%` truncates toward
// zero and is negative for a negative operand (pin - rr_ptr < 0).
__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Round-robin output arbitration for one (channel, router): P input heads
// against P output ports, all from the cycle-start snapshot.
__global__ void noc_arb_kernel(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_cnt, const int* __restrict__ rr,
    const int* __restrict__ wh, const int* __restrict__ route,
    bool* __restrict__ arb_pop, bool* __restrict__ granted,
    int* __restrict__ chosen, int* __restrict__ rr_out,
    int* __restrict__ wh_out, bool* __restrict__ in_space,
    int C, int R, int P, int Din, int Dout, int E) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C * R) return;
  int r = t % R;
  int base = t * P;  // (c * R + r) * P

  int req[MAX_P];
  bool pop[MAX_P];
  for (int pin = 0; pin < P; ++pin) {
    const int* head = in_buf + (size_t)(base + pin) * Din * NF;
    // Clamping: the reference gathers route[r, clip(dst, 0, None)], and
    // JAX's gather fills (never matches) a destination past the table.
    // Dead heads (count 0) hold stale contents and request nothing.
    int dst = max(head[F_DST], 0);
    int port = dst < E ? route[(size_t)r * E + dst] : -1;
    req[pin] = in_cnt[base + pin] > 0 ? port : -1;
    pop[pin] = false;
  }

  for (int pout = 0; pout < P; ++pout) {
    int lock = wh[base + pout];
    int ptr = rr[base + pout];
    bool space = out_cnt[base + pout] < Dout;  // no same-cycle fall-through
    int best = 0, winner = 0;
    for (int pin = 0; pin < P; ++pin) {
      bool elig = req[pin] == pout && (lock < 0 || lock == pin) && space;
      int score = elig ? floor_mod(pin - ptr, P) : P + 1;
      // Winner choice: the first minimum over input ports; a strict `<`
      // leaves ties with the lowest index, as the reference's unrolled
      // first-min does.
      if (pin == 0 || score < best) {
        best = score;
        winner = pin;
      }
    }
    bool g = best <= P;
    // `chosen` is the winner's head whether or not the port was granted
    // (winner 0 when nothing is eligible), exactly as the reference gathers
    const int* wh_head = in_buf + (size_t)(base + winner) * Din * NF;
    int* ch = chosen + (size_t)(base + pout) * NF;
    for (int f = 0; f < NF; ++f) ch[f] = wh_head[f];
    granted[base + pout] = g;
    rr_out[base + pout] = g ? (winner + 1) % P : ptr;
    // Tail release: a granted tail flit frees the wormhole lock; a granted
    // body flit locks the output to its input port.
    bool is_tail = wh_head[F_LAST] > 0;
    wh_out[base + pout] = g ? (is_tail ? -1 : winner) : lock;
    if (g) pop[winner] = true;
  }

  for (int pin = 0; pin < P; ++pin) {
    arb_pop[base + pin] = pop[pin];
    // space after this cycle's arb pops (a slot freed this cycle is reusable)
    in_space[base + pin] = (in_cnt[base + pin] - (pop[pin] ? 1 : 0)) < Din;
  }
}

// Fused pop-then-push of one FIFO, written to a separate output buffer.
// Dead slots: every slot d takes buf[min(d + pop, D - 1)] unless it is the
// push target, which is the reference's general form and, for D == 2,
// exactly its direct-select form (slot 0 <- buf[pop], slot 1 <- buf[1]).
__device__ __forceinline__ int fifo_update(
    const int* __restrict__ buf, int* __restrict__ out, int cnt, bool pop,
    bool push, const int* flit, int D) {
  int cnt1 = cnt - (pop ? 1 : 0);
  int tail = clampi(cnt1, 0, D - 1);
  for (int d = 0; d < D; ++d) {
    const int* src = (push && d == tail) ? flit : buf + min(d + (pop ? 1 : 0), D - 1) * NF;
    for (int f = 0; f < NF; ++f) out[d * NF + f] = src[f];
  }
  return cnt1 + (push ? 1 : 0);
}

// Link resolution + FIFO update for one (channel, router, port).
//
// Write race: a thread reads *other* routers' output heads (link_inputs)
// and post-pop input space (sent_mask) while those routers update their
// own FIFOs in the same launch. So nothing is written in place: the new
// buffers and counts go to separate output tensors (ping-pong), and every
// read below is of the cycle-start snapshot or the arb scratch.
__global__ void noc_apply_kernel(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_buf, const int* __restrict__ out_cnt,
    const bool* __restrict__ arb_pop, const bool* __restrict__ granted,
    const int* __restrict__ chosen, const bool* __restrict__ in_space,
    const int* __restrict__ link_src, const int* __restrict__ link_dst,
    const int* __restrict__ port_ep, const bool* __restrict__ ep_space,
    int* __restrict__ new_in_buf, int* __restrict__ new_in_cnt,
    int* __restrict__ new_out_buf, int* __restrict__ new_out_cnt,
    int C, int R, int P, int Din, int Dout, int E) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= C * R * P) return;
  int p = t % P;
  int r = (t / P) % R;
  int c = t / (P * R);
  int rp = r * P + p;
  size_t chan = (size_t)c * R * P;

  // ---- input side: link_inputs, then fused fifo_update of in_buf ----
  // Clamping: src coordinates are clipped into range before the gather,
  // as the reference does; have_up masks the missing links.
  int src_r = link_src[rp * 2], src_p = link_src[rp * 2 + 1];
  size_t up = chan + clampi(src_r, 0, R - 1) * P + clampi(src_p, 0, P - 1);
  bool up_valid = src_r >= 0 && out_cnt[up] > 0;
  bool accept = up_valid && in_space[t];
  new_in_cnt[t] = fifo_update(in_buf + (size_t)t * Din * NF,
                              new_in_buf + (size_t)t * Din * NF, in_cnt[t],
                              arb_pop[t], accept,
                              out_buf + up * Dout * NF, Din);

  // ---- output side: sent_mask, then fused fifo_update of out_buf ----
  bool out_valid = out_cnt[t] > 0;
  int dst_r = link_dst[rp * 2], dst_p = link_dst[rp * 2 + 1];
  size_t down = chan + clampi(dst_r, 0, R - 1) * P + clampi(dst_p, 0, P - 1);
  bool sent_link = dst_r >= 0 && out_valid && in_space[down];
  int pe = port_ep[rp];
  bool sent_ep = pe >= 0 && out_valid &&
                 ep_space[(size_t)c * E + clampi(pe, 0, E - 1)];
  new_out_cnt[t] = fifo_update(out_buf + (size_t)t * Dout * NF,
                               new_out_buf + (size_t)t * Dout * NF,
                               out_cnt[t], sent_link || sent_ep, granted[t],
                               chosen + (size_t)t * NF, Dout);
}

static const int kThreads = 128;

extern "C" int noc_arb_launch(
    const void* in_buf, const void* in_cnt, const void* out_cnt,
    const void* rr, const void* wh, const void* route, void* arb_pop,
    void* granted, void* chosen, void* rr_out, void* wh_out, void* in_space,
    int C, int R, int P, int Din, int Dout, int E, void* stream) {
  int n = C * R;
  int blocks = (n + kThreads - 1) / kThreads;
  noc_arb_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)in_buf, (const int*)in_cnt, (const int*)out_cnt,
      (const int*)rr, (const int*)wh, (const int*)route, (bool*)arb_pop,
      (bool*)granted, (int*)chosen, (int*)rr_out, (int*)wh_out,
      (bool*)in_space, C, R, P, Din, Dout, E);
  return (int)cudaGetLastError();
}

extern "C" int noc_apply_launch(
    const void* in_buf, const void* in_cnt, const void* out_buf,
    const void* out_cnt, const void* arb_pop, const void* granted,
    const void* chosen, const void* in_space, const void* link_src,
    const void* link_dst, const void* port_ep, const void* ep_space,
    void* new_in_buf, void* new_in_cnt, void* new_out_buf, void* new_out_cnt,
    int C, int R, int P, int Din, int Dout, int E, void* stream) {
  int n = C * R * P;
  int blocks = (n + kThreads - 1) / kThreads;
  noc_apply_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)in_buf, (const int*)in_cnt, (const int*)out_buf,
      (const int*)out_cnt, (const bool*)arb_pop, (const bool*)granted,
      (const int*)chosen, (const bool*)in_space, (const int*)link_src,
      (const int*)link_dst, (const int*)port_ep, (const bool*)ep_space,
      (int*)new_in_buf, (int*)new_in_cnt, (int*)new_out_buf,
      (int*)new_out_cnt, C, R, P, Din, Dout, E);
  return (int)cudaGetLastError();
}
