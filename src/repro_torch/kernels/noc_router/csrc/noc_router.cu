// FlooNoC router cycle for Hopper (sm_90a): per-cycle and fused kernels.
//
// Replaces the Pallas router kernels of the JAX package
// (src/repro/kernels/noc_router/noc_router.py):
//   * noc_arb_kernel   <- `_arb_kernel` (V = 1) and `_arb_kernel_vc`
//                         (V > 1); plain version: ref.arb_decisions
//   * noc_apply_kernel <- `_apply_kernel` (its `n_vcs` argument covers
//                         both; its `fused` argument both FIFO modes, the
//                         fast step's fused update and the naive step's
//                         pop then push); plain version: ref.apply_phase,
//                         i.e. link_inputs + sent_mask + apply_cycle
//   * noc_fused_cluster_kernel <- `_fused_kernel` (V = 1) and
//                         `_fused_kernel_vc` (V > 1); plain version:
//                         ref.router_cycles_scan. noc_fused_global_kernel
//                         runs the same window for a channel whose state
//                         does not fit a 16-CTA cluster's shared memory.
//   * noc_arb_offload_kernel <- `_arb_kernel_offload` (any V); plain
//                         version: ref.offload_decisions (multicast fork,
//                         reduction ALU, emission pre-emption). Its merged
//                         decisions feed the same noc_apply_kernel.
// All are held bit for bit against the plain PyTorch versions in
// src/repro_torch/kernels/noc_router/ref.py.
//
// Design. One simulated cycle is two phases. The phase boundary is the
// arb -> link barrier: link acceptance depends on the *downstream*
// router's post-pop input space, so every router's `in_space` must be
// visible fabric-wide before any link decision. The per-cycle path makes
// each phase its own launch, which works at any mesh size. All three
// per-cycle kernels give a warp 32 / P whole routers, a lane per slot
// (`SlotLane`): each lane loads its own slot, requests and pop masks are
// warp shuffles and segmented reductions over the router's lanes, a
// wire's VC choice is a ballot over the port group's lanes, and the
// stores of a warp are contiguous (the apply kernel's FIFO rows go through
// shared memory to be written coalesced).
//
// The fused window runs N cycles in one launch. Like the Pallas kernel,
// which keeps a channel's carry in VMEM across its loop, it keeps the
// channel's fabric state on chip for the whole window: one thread-block
// cluster per channel, each CTA owning a contiguous range of routers whose
// state sits in its shared memory (loaded once with cp.async, written back
// once). A warp holds whole routers, one lane per slot, so arbitration's
// request exchange and pop masks are warp shuffles and the per-router
// phases need only `__syncwarp()`. The apply phase reads other routers'
// output heads and counts and post-pop input space, possibly in another
// CTA, through distributed shared memory (`mapa` + `ld.shared::cluster`);
// one cluster barrier per cycle separates arbitration from those reads.
// The output side, which other routers read, ping-pongs between two
// copies; the input side, read only by its own router's warp, updates in
// place after the warp has read its operands. (One copy of both sides,
// updated in place behind a second cluster barrier per cycle, measured
// slower; PERF.md.) `fused_plan` in noc_router.py sizes the cluster
// (1-16 CTAs) from the shared memory a CTA needs; a channel too large for
// 16 CTAs runs noc_fused_global_kernel: one CTA per channel, state in
// global memory, ping-ponging between the outputs and a scratch set.
//
// Bound on an H100. All kernels do a few integer operations per byte, so
// bytes bound them: at a 32x32 mesh the apply phase reads and rewrites
// both FIFO buffers, about 3.4 MB per cycle, ~1 us at 3.35 TB/s. The
// per-cycle kernels are launch-latency bound at these sizes: what is left
// above an empty launch is their chains of dependent loads, which the
// lane-per-slot shape cuts to two levels in the apply kernel (own slot and
// tables, then one remote load per side). The fused
// window reads and writes the state once, so its bytes are a small floor;
// what sets its time is the cluster barrier and the dependent shared and
// L2 loads (the route lookup) of each cycle.
//
// Layouts (all int32 unless noted, C-contiguous; P counts slots, P = Pp*V):
//   in_buf  [C, R, P, Din, NF]   out_buf [C, R, P, Dout, NF]
//   in_cnt, out_cnt, rr, wh      [C, R, P]
//   route [R, E]; link_src, link_dst [R, Pp, 2]; port_ep [R, P]
//   vc_out [R, P, Pp] (V > 1 only, else null); ep_attach [E, 2]
//   ep_space [C, E] bool; arb_pop, granted, in_space [C, R, P] bool
//   chosen [C, R, P, NF]
//   eg [C, E, Q, NF], eg_ready [C, E, Q], eg_head, eg_cnt [C, E]
//   offload: fork_out [R, G, P] bool; red_parent, red_need [R, G];
//   red_acc [C, R, G, NRED]; red_got [C, R, G, P] bool

#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define NF 7
#define F_DST 0
#define F_SRC 1
#define F_KIND 2
#define F_TXN 3
#define F_LAST 4
#define F_TS 5
#define F_META 6
#define MAX_P 32
#define FULL_MASK 0xffffffffu
// collective offload: flit kinds and the reduction-ALU slot layout
#define KIND_MC 6
#define KIND_RED 7
#define NRED 6
#define A_VAL 0
#define A_CNT 1
#define A_NLAST 2
#define A_TXN 3
#define A_TS 4
#define A_SRC 5

// JAX's `%` on integers is a floor modulo; C++'s `%` truncates toward
// zero and is negative for a negative operand (pin - rr_ptr < 0).
__device__ __forceinline__ int floor_mod(int a, int m) {
  return ((a % m) + m) % m;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// int32 subtraction with the two's-complement wraparound JAX computes
// (signed overflow is undefined in C++, so it runs on uint32_t).
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 4 bytes from global to shared memory, asynchronously (cp.async).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               :: "r"(smem_addr(dst)), "l"(__cvta_generic_to_global(src))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Round-robin output arbitration for one (channel, router) `cr = c*R + r`:
// P input heads against P output slots, all from the cycle-start snapshot,
// by one thread. Only noc_fused_global_kernel calls it (a channel's
// routers spread over one CTA's threads); the per-cycle noc_arb_kernel
// runs the same decisions a lane per slot.
__device__ __forceinline__ void arb_router(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_cnt, const int* __restrict__ rr,
    const int* __restrict__ wh, const int* __restrict__ route,
    const int* __restrict__ vc_out, bool* __restrict__ arb_pop,
    bool* __restrict__ granted, int* __restrict__ chosen,
    int* __restrict__ rr_out, int* __restrict__ wh_out,
    bool* __restrict__ in_space, int cr, int r, int P, int Din, int Dout,
    int E, int V) {
  int base = cr * P;
  int req[MAX_P];
  bool pop[MAX_P];
  for (int pin = 0; pin < P; ++pin) {
    const int* head = in_buf + (size_t)(base + pin) * Din * NF;
    // Clamping: the reference gathers route[r, clip(dst, 0, None)], and
    // JAX's gather fills a destination past the table with INT_MIN.
    // Dead heads (count 0) hold stale contents and request nothing.
    int dst = max(head[F_DST], 0);
    int port = dst < E ? route[(size_t)r * E + dst] : INT_MIN;
    if (V > 1) {
      // Dateline VC switching: the physical out port expands to slot
      // phys * V + vc_out[r, pin, clip(phys)], in int32 wraparound as JAX
      // computes it (INT_MIN * 2 wraps to 0). Signed overflow is undefined
      // in C++, so the multiply runs on uint32_t.
      int Pp = P / V;
      int vout = vc_out[((size_t)r * P + pin) * Pp + clampi(port, 0, Pp - 1)];
      port = (int)((uint32_t)port * (uint32_t)V + (uint32_t)vout);
    }
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

// The wire between slot group `a` (V consecutive slots) and slot group `b`
// moves one flit per cycle: VC u of it is eligible when a's head on u is
// valid and b's input FIFO on u has space, and the lowest eligible VC wins.
// True iff that winner is VC v. With V == 1 this is the plain link test.
__device__ __forceinline__ bool lowest_vc_wins(
    const int* __restrict__ out_cnt, const bool* __restrict__ in_space,
    size_t a, size_t b, int v) {
  for (int u = 0; u <= v; ++u) {
    if (out_cnt[a + u] > 0 && in_space[b + u]) return u == v;
  }
  return false;
}

// Link resolution + FIFO update for one (channel, router, slot), by one
// thread. Only noc_fused_global_kernel calls it (a channel's slots spread
// over one CTA's threads); the per-cycle noc_apply_kernel runs the same
// decisions a lane per slot.
//
// Write race: a thread reads *other* routers' output heads (link_inputs)
// and post-pop input space (sent_mask) while those routers update their
// own FIFOs in the same phase. So nothing is written in place: the new
// buffers and counts go to separate tensors (ping-pong), and every read
// below is of the cycle-start snapshot or the arb scratch. The link
// tables are physical: slot p = pp * V + v uses row pp = p / V.
__device__ __forceinline__ void apply_slot(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_buf, const int* __restrict__ out_cnt,
    const bool* __restrict__ arb_pop, const bool* __restrict__ granted,
    const int* __restrict__ chosen, const bool* __restrict__ in_space,
    const int* __restrict__ link_src, const int* __restrict__ link_dst,
    const int* __restrict__ port_ep, const bool* __restrict__ ep_space,
    int* __restrict__ new_in_buf, int* __restrict__ new_in_cnt,
    int* __restrict__ new_out_buf, int* __restrict__ new_out_cnt,
    int c, int r, int p, int R, int P, int Din, int Dout, int E, int V) {
  int Pp = P / V, pp = p / V, v = p % V;
  int lp = r * Pp + pp;
  size_t chan = (size_t)c * R * P;
  size_t t = chan + (size_t)r * P + p;
  size_t group = chan + (size_t)r * P + pp * V;  // my slots of port pp

  // ---- input side: link_inputs, then fused fifo_update of in_buf ----
  // Clamping: src coordinates are clipped into range before the gather,
  // as the reference does; a missing link (src_r < 0) accepts nothing.
  int src_r = link_src[lp * 2], src_p = link_src[lp * 2 + 1];
  size_t up = chan + (size_t)clampi(src_r, 0, R - 1) * P + clampi(src_p, 0, Pp - 1) * V;
  bool accept = src_r >= 0 && lowest_vc_wins(out_cnt, in_space, up, group, v);
  new_in_cnt[t] = fifo_update(in_buf + t * Din * NF, new_in_buf + t * Din * NF,
                              in_cnt[t], arb_pop[t], accept,
                              out_buf + (up + v) * Dout * NF, Din);

  // ---- output side: sent_mask, then fused fifo_update of out_buf ----
  // The link leg recomputes the downstream wire's VC choice from the
  // upstream side (same snapshot, same winner); endpoints attach at VC0
  // slots, so the endpoint leg is slot-level as it is.
  int dst_r = link_dst[lp * 2], dst_p = link_dst[lp * 2 + 1];
  size_t down = chan + (size_t)clampi(dst_r, 0, R - 1) * P + clampi(dst_p, 0, Pp - 1) * V;
  bool sent_link = dst_r >= 0 && lowest_vc_wins(out_cnt, in_space, group, down, v);
  bool out_valid = out_cnt[t] > 0;
  int pe = port_ep[(size_t)r * P + p];
  bool sent_ep = pe >= 0 && out_valid &&
                 ep_space[(size_t)c * E + clampi(pe, 0, E - 1)];
  new_out_cnt[t] = fifo_update(out_buf + t * Dout * NF,
                               new_out_buf + t * Dout * NF, out_cnt[t],
                               sent_link || sent_ep, granted[t],
                               chosen + t * NF, Dout);
}

// A lane of the per-cycle arbitration kernels. With P slots a warp holds
// 32 / P whole routers: lane sub * P + p is slot p of router `cr`, the
// warp's sub-th. Lanes past the last whole router (sub >= 32 / P) and the
// routers past C * R in the last warp are not `live`: they run every
// shuffle (their source lanes wrap into the warp), but load and write
// nothing. Every shuffle and vote names the full warp: a `__reduce_*_sync`
// over each router's own member mask serialises over the warp's distinct
// masks (PERF.md, section 6).
struct SlotLane {
  int p, base, cr, r;
  bool live;
  unsigned group;  // the lanes of my router
};

static const int kArbThreads = 128;  // four warps a CTA

__device__ __forceinline__ SlotLane slot_lane(int C, int R, int P) {
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int rpw = 32 / P, sub = lane / P;
  SlotLane s;
  s.p = lane - sub * P;
  s.base = sub * P;
  s.cr = warp * rpw + sub;
  s.live = sub < rpw && s.cr < C * R;
  s.r = s.cr % R;
  s.group = P == 32 ? FULL_MASK : ((1u << P) - 1u) << s.base;
  return s;
}

// Segmented reductions over each router's lanes base .. base + P - 1, the
// result at every lane of the router: shuffles down in log steps, a lane
// taking its partner only while the partner is in its router (so lane
// base ends with the whole router's), then a broadcast from lane base.
__device__ __forceinline__ uint32_t seg_or(uint32_t v, const SlotLane& s, int P) {
  for (int d = 1; d < P; d <<= 1) {
    const uint32_t o = __shfl_down_sync(FULL_MASK, v, d);
    if (s.p + d < P) v |= o;
  }
  return __shfl_sync(FULL_MASK, v, s.base);
}

// The first-minimum round-robin winner over the eligible inputs `m` (bit
// pin): the lowest score (pin - ptr) floor-mod P is the first eligible pin
// at or after the pointer, cyclically; 0 when nothing is eligible.
__device__ __forceinline__ int rr_winner(uint32_t m, int ptr, int P) {
  const uint32_t late = m & (FULL_MASK << floor_mod(ptr, P));
  return late ? __ffs(late) - 1 : (m ? __ffs(m) - 1 : 0);
}

// Round-robin output arbitration (ref.arb_decisions), a lane per slot: as
// input p the lane computes its head's request, as output p its winner
// over the router's requests (shuffled in); the granted winners' bits are
// OR-ed over the router's lanes into the pop mask, and `chosen` is the
// winner's head, shuffled from the winner's lane.
__global__ void __launch_bounds__(kArbThreads) noc_arb_kernel(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_cnt, const int* __restrict__ rr,
    const int* __restrict__ wh, const int* __restrict__ route,
    const int* __restrict__ vc_out, bool* __restrict__ arb_pop,
    bool* __restrict__ granted, int* __restrict__ chosen,
    int* __restrict__ rr_out, int* __restrict__ wh_out,
    bool* __restrict__ in_space, int C, int R, int P, int Din, int Dout,
    int E, int V) {
  const SlotLane s = slot_lane(C, R, P);
  const size_t t = (size_t)s.cr * P + s.p;
  int head[NF], cnt = 0, lock = -1, ptr = 0, req = -1;
  bool space = false;
#pragma unroll
  for (int f = 0; f < NF; ++f) head[f] = 0;
  if (s.live) {
    // every head, live or dead: `chosen` is the winner's head even when
    // nothing was granted (winner 0), stale contents included
    const int* h = in_buf + t * Din * NF;
#pragma unroll
    for (int f = 0; f < NF; ++f) head[f] = h[f];
    cnt = in_cnt[t];
    lock = wh[t];
    ptr = rr[t];
    space = out_cnt[t] < Dout;  // no same-cycle fall-through
    // Clamping: the reference gathers route[r, clip(dst, 0, None)], and
    // JAX's gather fills a destination past the table with INT_MIN.
    const int dst = max(head[F_DST], 0);
    int port = dst < E ? __ldg(route + (size_t)s.r * E + dst) : INT_MIN;
    if (V > 1) {
      // Dateline VC switching: the physical out port expands to slot
      // phys * V + vc_out[r, pin, clip(phys)], in int32 wraparound as JAX
      // computes it (INT_MIN * 2 wraps to 0; the multiply runs on uint32_t).
      const int Pp = P / V;
      const int vout = __ldg(vc_out + ((size_t)s.r * P + s.p) * Pp + clampi(port, 0, Pp - 1));
      port = (int)((uint32_t)port * (uint32_t)V + (uint32_t)vout);
    }
    req = cnt > 0 ? port : -1;  // dead heads request nothing
  }
  // as output p: the inputs that request me and may take me
  uint32_t m = 0;
  for (int pin = 0; pin < P; ++pin)
    m |= (__shfl_sync(FULL_MASK, req, (s.base + pin) & 31) == s.p ? 1u : 0u) << pin;
  if (lock >= 0) m &= lock < P ? 1u << lock : 0u;
  if (!space) m = 0;
  const int winner = rr_winner(m, ptr, P);
  const bool g = m != 0;
  const uint32_t pops = seg_or(g ? 1u << winner : 0u, s, P);
  int ch[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) ch[f] = __shfl_sync(FULL_MASK, head[f], (s.base + winner) & 31);
  if (s.live) {
    const bool pop = (pops >> s.p) & 1u;
    arb_pop[t] = pop;
    // space after this cycle's arb pops (a slot freed this cycle is reusable)
    in_space[t] = (cnt - (pop ? 1 : 0)) < Din;
    granted[t] = g;
    rr_out[t] = g ? (winner + 1 == P ? 0 : winner + 1) : ptr;
    // Tail release: a granted tail flit frees the wormhole lock; a granted
    // body flit locks the output to its input port.
    wh_out[t] = g ? (ch[F_LAST] > 0 ? -1 : winner) : lock;
#pragma unroll
    for (int f = 0; f < NF; ++f) chosen[t * NF + f] = ch[f];
  }
}

// A warp's span of n ints in global memory, read with consecutive lanes on
// consecutive ints into shared memory. With ROUNDS > 0 (n <= 32 * ROUNDS)
// each lane loads its ROUNDS words into registers (`load`; plain loads,
// one 128-byte request each) and parks them (`park`) once they are needed;
// with ROUNDS 0 (any n) `load` copies them with cp.async and `park` does
// nothing (4-byte cp.async copies are slow to dispatch: PERF.md, section 6).
template <int ROUNDS>
struct WarpSpan {
  int w[ROUNDS > 0 ? ROUNDS : 1];

  __device__ __forceinline__ void load(int* dst, const int* __restrict__ src, int n,
                                       int lane) {
    if (ROUNDS) {
#pragma unroll
      for (int i = 0; i < ROUNDS; ++i)
        w[i] = i * 32 + lane < n ? src[i * 32 + lane] : 0;
    } else {
      for (int k = lane; k < n; k += 32) cp_async4(dst + k, src + k);
    }
  }

  __device__ __forceinline__ void park(int* dst, int n, int lane) const {
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i)
      if (i * 32 + lane < n) dst[i * 32 + lane] = w[i];
  }
};

// n ints from shared to global memory by a warp, consecutive lanes on
// consecutive ints: at most 32 * ROUNDS of them, unrolled (ROUNDS 0: any n).
template <int ROUNDS>
__device__ __forceinline__ void warp_store(int* __restrict__ dst, const int* src, int n,
                                           int lane) {
  if (ROUNDS) {
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i)
      if (i * 32 + lane < n) dst[i * 32 + lane] = src[i * 32 + lane];
  } else {
    for (int k = lane; k < n; k += 32) dst[k] = src[k];
  }
}

// Pop-then-push of one FIFO's D rows in place (D = DC, or `d` when DC is
// 0): row r takes row r + 1 on a pop, and the push target (row
// clip(cnt - pop, 0, D - 1)) takes the flit. The modes differ in row
// D - 1 on a pop that does not push there: `fused` (fifo_update's general
// form) keeps it; unfused (fifo_pop's roll, then fifo_push) moves the old
// head there. Ascending r reads only rows not yet written, except the old
// head, which row 0 overwrites first: the unfused mode keeps it in
// registers (`fused` is uniform over a launch, so the fused mode skips the
// load without divergence). Returns the new count.
template <int DC>
__device__ __forceinline__ int fifo_rows(int* rows, int d, int cnt, bool pop, bool push,
                                         const int* flit, bool fused) {
  const int D = DC ? DC : d;
  const int c1 = cnt - (pop ? 1 : 0), tail = clampi(c1, 0, D - 1);
  int head[NF];
  if (pop && !fused) {
#pragma unroll
    for (int f = 0; f < NF; ++f) head[f] = rows[f];
  }
#pragma unroll
  for (int r = 0; r < D; ++r) {
    if (push && r == tail) {
#pragma unroll
      for (int f = 0; f < NF; ++f) rows[r * NF + f] = flit[f];
    } else if (pop && r + 1 < D) {
#pragma unroll
      for (int f = 0; f < NF; ++f) rows[r * NF + f] = rows[(r + 1) * NF + f];
    } else if (pop && !fused) {  // r == D - 1: the roll's wrapped head
#pragma unroll
      for (int f = 0; f < NF; ++f) rows[r * NF + f] = head[f];
    }
  }
  return c1 + (push ? 1 : 0);
}

// Link resolution + FIFO update (ref.apply_phase, fused or unfused), a
// lane per slot as in noc_arb_kernel. The warp's live slots are contiguous in every
// [C, R, P, ...] array (lane j holds the warp's j-th slot), so:
//  1. each lane loads its table rows, its counts and arb scratch and its
//     `chosen`, and the warp reads its old FIFO rows, both sides, with
//     consecutive lanes on consecutive ints (WarpSpan), all independent;
//  2. each lane makes one remote load per side for its own VC v: the
//     upstream output count out_cnt[up + v] and the downstream post-pop
//     in_space[down + v] (plus, speculatively, the upstream head: its
//     clamped address is always valid, and it is pushed only on accept);
//  3. a wire's lowest-eligible-VC choice needs VCs u <= v of the port
//     group: one ballot per side gives every lane its group's eligibility
//     bits (the own-side halves, my in_space and my out_cnt > 0, are the
//     group lanes' own loads, so nothing is reloaded);
//  4. the old rows go to the warp's span of shared memory; each lane pops
//     and pushes its slot's rows there in place (fifo_rows in the mode
//     `fused` names, a runtime argument: it only picks row D - 1's source
//     on a pop, and is uniform over the launch, so one instantiation a
//     depth serves both modes; dead slots included), and the warp writes
//     its spans back coalesced.
// Unused lanes and a ragged last warp's routers take part in the ballots
// and copy nothing. Nothing is written in place: every read is of the
// cycle-start snapshot or the arb scratch. DIN and DOUT fix the depths at
// compile time, which holds the old rows in registers and unrolls the
// copies and the row updates (0: taken from the arguments).
template <int DIN, int DOUT>
__global__ void __launch_bounds__(kArbThreads) noc_apply_kernel(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_buf, const int* __restrict__ out_cnt,
    const bool* __restrict__ arb_pop, const bool* __restrict__ granted,
    const int* __restrict__ chosen, const bool* __restrict__ in_space,
    const int* __restrict__ link_src, const int* __restrict__ link_dst,
    const int* __restrict__ port_ep, const bool* __restrict__ ep_space,
    int* __restrict__ new_in_buf, int* __restrict__ new_in_cnt,
    int* __restrict__ new_out_buf, int* __restrict__ new_out_cnt,
    int C, int R, int P, int din, int dout, int E, int V, int fused) {
  extern __shared__ __align__(16) int apply_smem[];
  const int Din = DIN ? DIN : din, Dout = DOUT ? DOUT : dout;
  const SlotLane s = slot_lane(C, R, P);
  const int lane = threadIdx.x & 31;
  const int fin = Din * NF, fout = Dout * NF;
  const size_t t = (size_t)s.cr * P + s.p;
  const int Pp = P / V, pp = s.p / V, v = s.p - pp * V;
  int src_r = -1, src_p = 0, dst_r = -1, dst_p = 0, pe = -1, icnt = 0, ocnt = 0;
  bool pop_in = false, grant = false, space = false;
  int ch[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) ch[f] = 0;
  if (s.live) {
    const int* ls = link_src + (size_t)(s.r * Pp + pp) * 2;
    const int* ld = link_dst + (size_t)(s.r * Pp + pp) * 2;
    src_r = __ldg(ls);
    src_p = __ldg(ls + 1);
    dst_r = __ldg(ld);
    dst_p = __ldg(ld + 1);
    pe = __ldg(port_ep + (size_t)s.r * P + s.p);
    icnt = in_cnt[t];
    ocnt = out_cnt[t];
    pop_in = arb_pop[t];
    grant = granted[t];
    space = in_space[t];
#pragma unroll
    for (int f = 0; f < NF; ++f) ch[f] = chosen[t * NF + f];
  }

  // the warp's live slots, slot0 .. slot0 + ns - 1, and their old rows
  int* s_in = apply_smem + (threadIdx.x >> 5) * 32 * (fin + fout);
  int* s_out = s_in + 32 * fin;
  const int rpw = 32 / P, cr0 = s.cr - lane / P;
  const int ns = max(0, min(rpw, C * R - cr0)) * P;
  const size_t slot0 = (size_t)cr0 * P;
  WarpSpan<DIN * NF> old_in;
  WarpSpan<DOUT * NF> old_out;
  old_in.load(s_in, in_buf + slot0 * fin, ns * fin, lane);
  old_out.load(s_out, out_buf + slot0 * fout, ns * fout, lane);

  // Clamping: link coordinates are clipped into range before the gather,
  // as the reference does; a missing link (row < 0) moves nothing.
  int up_cnt = 0, flit[NF];
  bool dn_space = false, ep_ok = false;
#pragma unroll
  for (int f = 0; f < NF; ++f) flit[f] = 0;
  if (s.live) {
    const size_t chan = (size_t)(s.cr - s.r) * P;  // c * R * P
    const size_t up = chan + (size_t)clampi(src_r, 0, R - 1) * P + clampi(src_p, 0, Pp - 1) * V + v;
    const size_t down = chan + (size_t)clampi(dst_r, 0, R - 1) * P + clampi(dst_p, 0, Pp - 1) * V + v;
    up_cnt = out_cnt[up];
    dn_space = in_space[down];
#pragma unroll
    for (int f = 0; f < NF; ++f) flit[f] = out_buf[up * fout + f];
    // endpoints attach at VC0 slots, so the endpoint leg is slot-level
    if (pe >= 0) ep_ok = ep_space[(size_t)(s.cr / R) * E + clampi(pe, 0, E - 1)];
  }
  // VC u of a wire is eligible when the upstream head on u is valid and the
  // downstream input u has space; the lowest eligible VC wins. My group's
  // bits sit at lanes lane - v .. lane - v + V - 1; I win if, of u <= v,
  // only bit v is set.
  const uint32_t in_elig = __ballot_sync(FULL_MASK, src_r >= 0 && up_cnt > 0 && space);
  const uint32_t out_elig = __ballot_sync(FULL_MASK, dst_r >= 0 && ocnt > 0 && dn_space);
  const uint32_t upto = (2u << v) - 1u, me = 1u << v;
  const bool accept = ((in_elig >> (lane - v)) & upto) == me;
  const bool sent = ((out_elig >> (lane - v)) & upto) == me || (ocnt > 0 && ep_ok);

  old_in.park(s_in, ns * fin, lane);
  old_out.park(s_out, ns * fout, lane);
  cp_async_wait_all();
  __syncwarp();  // the warp's old rows are all in shared memory
  if (s.live) {
    new_in_cnt[t] = fifo_rows<DIN>(s_in + lane * fin, Din, icnt, pop_in, accept, flit, fused);
    new_out_cnt[t] = fifo_rows<DOUT>(s_out + lane * fout, Dout, ocnt, sent, grant, ch, fused);
  }
  __syncwarp();  // the warp's rows are final
  warp_store<DIN * NF>(new_in_buf + slot0 * fin, s_in, ns * fin, lane);
  warp_store<DOUT * NF>(new_out_buf + slot0 * fout, s_out, ns * fout, lane);
}

// Collective-offload arbitration (ref.offload_decisions), a lane per slot
// as in noc_arb_kernel. All decisions come from the cycle-start snapshot.
//
//  1. Each lane classifies its head: multicast, reduction or unicast; its
//     group g_of (addresses are E + g; anything else clamps into [0, G-1]);
//     its request as a uint32_t mask (P <= 32 slots): a unicast head its
//     routed slot, a multicast head its group's fork row.
//  2. Reduction ALU, one pass over the G groups in order with all of a
//     router's lanes in step (G is not bounded: nothing is sized by it). A
//     group on the tree is `full` once its count reaches `red_need`; it
//     emits into its parent slot if that slot has output space and no
//     wormhole lock (both shuffled from the parent's lane), and no lower
//     group took the port this cycle (the reference's `cumsum == 1`;
//     `emit_mask`). A RED head of group g at a slot that has not
//     contributed to the current beat is taken when the group is not full
//     or is emitting this cycle; the accumulator sums F_META and the count
//     (int32 wrap) and max-merges the rest over the router's lanes, 0
//     standing in for the lanes that take nothing, and zero-clears on
//     emission. The parent's lane keeps the emitted accumulator.
//  3. Arbitration over the request masks, emission-owned ports not
//     eligible: the first-min round-robin winner per output. A multicast
//     head fires only if it won every requested branch; grants won by a
//     multicast head that did not fire are cancelled (their rr/wh stay).
//     Emissions are merged into `granted` / `chosen` after the rr/wh
//     updates, as the reference does.
__global__ void __launch_bounds__(kArbThreads) noc_arb_offload_kernel(
    const int* __restrict__ in_buf, const int* __restrict__ in_cnt,
    const int* __restrict__ out_cnt, const int* __restrict__ rr,
    const int* __restrict__ wh, const int* __restrict__ route,
    const int* __restrict__ vc_out, const bool* __restrict__ fork_out,
    const int* __restrict__ red_parent, const int* __restrict__ red_need,
    const int* __restrict__ red_acc, const bool* __restrict__ red_got,
    bool* __restrict__ arb_pop, bool* __restrict__ granted,
    int* __restrict__ chosen, int* __restrict__ rr_out,
    int* __restrict__ wh_out, bool* __restrict__ in_space,
    int* __restrict__ red_acc_out, bool* __restrict__ red_got_out, int C,
    int R, int P, int Din, int Dout, int E, int V, int G) {
  const SlotLane s = slot_lane(C, R, P);
  const size_t t = (size_t)s.cr * P + s.p;
  const size_t rg = (size_t)s.r * G, crg = (size_t)s.cr * G;
  int head[NF], cnt = 0, oc = 0, lock = -1, ptr = 0, g_of = 0;
  bool is_mc = false, is_red = false, uni = false;
  uint32_t req = 0;
#pragma unroll
  for (int f = 0; f < NF; ++f) head[f] = 0;
  if (s.live) {
    const int* h = in_buf + t * Din * NF;  // dead heads too: see noc_arb_kernel
#pragma unroll
    for (int f = 0; f < NF; ++f) head[f] = h[f];
    cnt = in_cnt[t];
    oc = out_cnt[t];
    lock = wh[t];
    ptr = rr[t];
    g_of = clampi(wrap_sub(head[F_DST], E), 0, G - 1);
    if (cnt > 0) {
      is_mc = head[F_KIND] == KIND_MC;
      is_red = head[F_KIND] == KIND_RED;
      uni = !is_mc && !is_red;
    }
    if (uni) {
      // the destination is clipped into the table before the lookup
      int port = __ldg(route + (size_t)s.r * E + clampi(head[F_DST], 0, E - 1));
      if (V > 1) {
        const int Pp = P / V;
        const int vout = __ldg(vc_out + ((size_t)s.r * P + s.p) * Pp + clampi(port, 0, Pp - 1));
        port = (int)((uint32_t)port * (uint32_t)V + (uint32_t)vout);
      }
      if (port >= 0 && port < P) req = 1u << port;
    }
    if (is_mc) {
      const bool* fork = fork_out + (rg + g_of) * P;
      for (int pout = 0; pout < P; ++pout) req |= (fork[pout] ? 1u : 0u) << pout;
    }
  }

  // ---- the reduction ALU ----
  uint32_t emit_mask = 0;
  bool red_pop = false;
  int emit_g = 0, emit_acc[NRED];  // at the parent's lane: what it emits
#pragma unroll
  for (int f = 0; f < NRED; ++f) emit_acc[f] = 0;
  for (int g = 0; g < G; ++g) {
    int need = 0, par = -1, acc[NRED];
    bool got = false;
#pragma unroll
    for (int f = 0; f < NRED; ++f) acc[f] = 0;
    if (s.live) {
      need = red_need[rg + g];
      par = red_parent[rg + g];
#pragma unroll
      for (int f = 0; f < NRED; ++f) acc[f] = red_acc[(crg + g) * NRED + f];
      got = red_got[(crg + g) * P + s.p];
    }
    const bool on_tree = need > 0;
    const bool full = on_tree && acc[A_CNT] >= need;
    const int pc = clampi(par, 0, P - 1);
    const int par_cnt = __shfl_sync(FULL_MASK, oc, (s.base + pc) & 31);
    const int par_lock = __shfl_sync(FULL_MASK, lock, (s.base + pc) & 31);
    const bool emitting = full && par >= 0 && par_cnt < Dout && par_lock < 0 &&
                          !((emit_mask >> pc) & 1u);
    if (emitting) {
      emit_mask |= 1u << pc;
      if (s.p == pc) {
        emit_g = g;
#pragma unroll
        for (int f = 0; f < NRED; ++f) emit_acc[f] = acc[f];
      }
    }
    const bool accept = on_tree && (!full || emitting);
    const bool take = is_red && g_of == g && !got && accept;
    red_pop = red_pop || take;
    // the router's contributions: F_META summed on uint32_t, the count, and
    // the maxima of the other fields with 0 for the lanes that take nothing
    uint32_t sum = take ? (uint32_t)head[F_META] : 0u;
    int mx[4] = {0, 0, 0, 0};  // A_NLAST, A_TXN, A_TS, A_SRC
    if (take) {
      mx[0] = wrap_sub(1, head[F_LAST]);
      mx[1] = head[F_TXN];
      mx[2] = head[F_TS];
      mx[3] = head[F_SRC];
    }
    const uint32_t takers = __ballot_sync(FULL_MASK, take);
    if (takers) {  // warp-uniform: a warp with no taker adds and maxes zeros
      for (int d = 1; d < P; d <<= 1) {
        const uint32_t o = __shfl_down_sync(FULL_MASK, sum, d);
        int om[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) om[k] = __shfl_down_sync(FULL_MASK, mx[k], d);
        if (s.p + d < P) {
          sum += o;
#pragma unroll
          for (int k = 0; k < 4; ++k) mx[k] = max(mx[k], om[k]);
        }
      }
      sum = __shfl_sync(FULL_MASK, sum, s.base);
#pragma unroll
      for (int k = 0; k < 4; ++k) mx[k] = __shfl_sync(FULL_MASK, mx[k], s.base);
    }
    const uint32_t n = __popc(takers & s.group);
    int out[NRED];
    out[A_VAL] = (int)((emitting ? 0u : (uint32_t)acc[A_VAL]) + sum);
    out[A_CNT] = (int)((emitting ? 0u : (uint32_t)acc[A_CNT]) + n);
    out[A_NLAST] = max(emitting ? 0 : acc[A_NLAST], mx[0]);
    out[A_TXN] = max(emitting ? 0 : acc[A_TXN], mx[1]);
    out[A_TS] = max(emitting ? 0 : acc[A_TS], mx[2]);
    out[A_SRC] = max(emitting ? 0 : acc[A_SRC], mx[3]);
    if (s.live) {
      red_got_out[(crg + g) * P + s.p] = (got && !emitting) || take;
      // the router's lanes share the accumulator's fields: lane p writes f = p mod P
#pragma unroll
      for (int f = 0; f < NRED; ++f)
        if (f % P == s.p) red_acc_out[(crg + g) * NRED + f] = out[f];
    }
  }

  // ---- arbitration with multicast fork requests ----
  uint32_t m = 0;  // as output p: the inputs that request me and may take me
  for (int pin = 0; pin < P; ++pin)
    m |= ((__shfl_sync(FULL_MASK, req, (s.base + pin) & 31) >> s.p) & 1u) << pin;
  if (lock >= 0) m &= lock < P ? 1u << lock : 0u;
  const bool emit = (emit_mask >> s.p) & 1u;  // a reduction emission owns the port
  if (oc >= Dout || emit) m = 0;
  const int winner = rr_winner(m, ptr, P);
  const bool granted0 = m != 0;
  uint32_t win = 0;  // as input p: the outputs I won
  for (int pout = 0; pout < P; ++pout)
    win |= (__shfl_sync(FULL_MASK, granted0 ? winner : -1, (s.base + pout) & 31) == s.p
                ? 1u : 0u) << pout;
  const bool fire = is_mc && req != 0 && (req & ~win) == 0;
  const bool pop = red_pop || fire || (uni && win != 0);
  const int wkind = __shfl_sync(FULL_MASK, (is_mc ? 1 : 0) | (fire ? 2 : 0),
                                (s.base + winner) & 31);
  const bool g = granted0 && (!(wkind & 1) || (wkind & 2));
  int ch[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) ch[f] = __shfl_sync(FULL_MASK, head[f], (s.base + winner) & 31);
  if (s.live) {
    arb_pop[t] = pop;
    in_space[t] = (cnt - (pop ? 1 : 0)) < Din;
    granted[t] = g || emit;
    rr_out[t] = g ? (winner + 1 == P ? 0 : winner + 1) : ptr;
    wh_out[t] = g ? (ch[F_LAST] > 0 ? -1 : winner) : lock;
    if (emit) {
      // the combined flit stays group-addressed for the next hop
      ch[F_DST] = E + emit_g;
      ch[F_SRC] = emit_acc[A_SRC];
      ch[F_KIND] = KIND_RED;
      ch[F_TXN] = emit_acc[A_TXN];
      ch[F_LAST] = wrap_sub(1, emit_acc[A_NLAST]);
      ch[F_TS] = emit_acc[A_TS];
      ch[F_META] = emit_acc[A_VAL];
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) chosen[t * NF + f] = ch[f];
  }
}

// Operands of the global-memory fused window. `*0` are the inputs (never
// written); the ten state outputs double as one half of the ping-pong pair,
// `s_*` is the other half; `arb_*` is the per-cycle arbitration scratch.
struct FusedArgs {
  const int *in_buf0, *in_cnt0, *out_buf0, *out_cnt0, *rr0, *wh0;
  const int *eg0, *eg_ready0, *eg_head0, *eg_cnt0;
  const int *route, *vc_out, *link_src, *link_dst, *port_ep, *ep_attach;
  const bool* ep_space;
  int *in_buf, *in_cnt, *out_buf, *out_cnt, *rr, *wh;
  int *eg, *eg_ready, *eg_head, *eg_cnt;
  int* ep_flit;
  bool *ep_valid, *req_waiting;
  int *s_in_buf, *s_in_cnt, *s_out_buf, *s_out_cnt, *s_rr, *s_wh;
  bool *arb_pop, *granted, *in_space;
  int* chosen;
  int R, P, Din, Dout, E, Q, V, cycle0, N;
};
static const int kFusedPtrs = 40;  // pointer members of FusedArgs, in order
static_assert(offsetof(FusedArgs, R) == kFusedPtrs * sizeof(void*),
              "FusedArgs: pointers first, then the ints");

static const int kFusedThreads = 512;

// N fabric cycles of one channel (blockIdx.x), each ref.fused_cycle_body,
// with the state in global memory (for a channel too large for a cluster's
// shared memory): deliveries and req_waiting from the cycle-start snapshot,
// arbitration, apply into the other half of the ping-pong pair, then egress
// injection (skipped on the window's last cycle). Cycle i writes the
// outputs when N - 1 - i is even, so the last cycle lands in them.
__global__ void __launch_bounds__(kFusedThreads) noc_fused_global_kernel(FusedArgs a) {
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int R = a.R, P = a.P, E = a.E, Q = a.Q, N = a.N;
  const int Din = a.Din, Dout = a.Dout, V = a.V;
  const size_t nstate = (size_t)R * P, ceq = (size_t)c * E * Q;

  // the egress queues: contents pass through, head/count are updated below
  for (size_t k = tid; k < (size_t)E * Q * NF; k += nt)
    a.eg[ceq * NF + k] = a.eg0[ceq * NF + k];
  for (size_t k = tid; k < (size_t)E * Q; k += nt)
    a.eg_ready[ceq + k] = a.eg_ready0[ceq + k];
  for (int e = tid; e < E; e += nt) {
    a.eg_head[c * E + e] = a.eg_head0[c * E + e];
    a.eg_cnt[c * E + e] = a.eg_cnt0[c * E + e];
  }
  __syncthreads();

  for (int i = 0; i < N; ++i) {
    bool to_out = (N - 1 - i) % 2 == 0;
    bool from_out = (N - i) % 2 == 0;  // where cycle i - 1 wrote
    const int* in_buf = i == 0 ? a.in_buf0 : (from_out ? a.in_buf : a.s_in_buf);
    const int* in_cnt = i == 0 ? a.in_cnt0 : (from_out ? a.in_cnt : a.s_in_cnt);
    const int* out_buf = i == 0 ? a.out_buf0 : (from_out ? a.out_buf : a.s_out_buf);
    const int* out_cnt = i == 0 ? a.out_cnt0 : (from_out ? a.out_cnt : a.s_out_cnt);
    const int* rr = i == 0 ? a.rr0 : (from_out ? a.rr : a.s_rr);
    const int* wh = i == 0 ? a.wh0 : (from_out ? a.wh : a.s_wh);
    int* n_in_buf = to_out ? a.in_buf : a.s_in_buf;
    int* n_in_cnt = to_out ? a.in_cnt : a.s_in_cnt;
    int* n_out_buf = to_out ? a.out_buf : a.s_out_buf;
    int* n_out_cnt = to_out ? a.out_cnt : a.s_out_cnt;
    int* n_rr = to_out ? a.rr : a.s_rr;
    int* n_wh = to_out ? a.wh : a.s_wh;

    // 1. deliveries and req_waiting (cycle-start snapshot), arbitration
    for (int e = tid; e < E; e += nt) {
      size_t at = ((size_t)c * R + a.ep_attach[e * 2]) * P + a.ep_attach[e * 2 + 1];
      size_t o = ((size_t)c * N + i) * E + e;
      bool waiting = out_cnt[at] > 0;
      for (int f = 0; f < NF; ++f) a.ep_flit[o * NF + f] = out_buf[at * Dout * NF + f];
      a.ep_valid[o] = waiting && a.ep_space[(size_t)c * E + e];
      a.req_waiting[o] = waiting;
    }
    for (int r = tid; r < R; r += nt)
      arb_router(in_buf, in_cnt, out_cnt, rr, wh, a.route, a.vc_out,
                 a.arb_pop, a.granted, a.chosen, n_rr, n_wh, a.in_space,
                 c * R + r, r, P, Din, Dout, E, V);
    __syncthreads();

    // 2. link resolution and FIFO updates into the other buffer half
    for (size_t k = tid; k < nstate; k += nt)
      apply_slot(in_buf, in_cnt, out_buf, out_cnt, a.arb_pop, a.granted,
                 a.chosen, a.in_space, a.link_src, a.link_dst, a.port_ep,
                 a.ep_space, n_in_buf, n_in_cnt, n_out_buf, n_out_cnt, c,
                 (int)(k / P), (int)(k % P), R, P, Din, Dout, E, V);
    __syncthreads();

    // 3. egress injection: each endpoint pushes its ready head onto its
    //    attach port (ports are unique per endpoint, and port_ep is their
    //    inverse, so the reference's per-port pull is this per-endpoint push)
    if (i < N - 1) {
      for (int e = tid; e < E; e += nt) {
        int h = a.eg_head[c * E + e], cnt = a.eg_cnt[c * E + e];
        bool want = cnt > 0 && a.eg_ready[ceq + (size_t)e * Q + h] <= a.cycle0 + i;
        size_t at = ((size_t)c * R + a.ep_attach[e * 2]) * P + a.ep_attach[e * 2 + 1];
        int ic = n_in_cnt[at];
        if (want && ic < Din) {
          const int* src = a.eg + (ceq + (size_t)e * Q + h) * NF;
          for (int f = 0; f < NF; ++f) n_in_buf[(at * Din + ic) * NF + f] = src[f];
          n_in_cnt[at] = ic + 1;
          a.eg_head[c * E + e] = (h + 1) % Q;
          a.eg_cnt[c * E + e] = cnt - 1;
        }
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The fused window on a thread-block cluster (one cluster per channel).

#define NO_LINK 0xffffffffu  // a slot's remote address where it has no link

// Operands of the cluster window: the inputs (`*0`, never written), the
// shared tables, the ten state outputs and the per-cycle endpoint outputs.
// Each CTA owns routers [rank * Rc, min(R, (rank + 1) * Rc)); each warp
// lane is one slot of a router, a warp holding 32 / P routers, K router
// groups per warp.
struct ClusterArgs {
  const int *in_buf0, *in_cnt0, *out_buf0, *out_cnt0, *rr0, *wh0;
  const int *eg0, *eg_ready0, *eg_head0, *eg_cnt0;
  const int *route, *vc_out, *link_src, *link_dst, *port_ep, *ep_attach;
  const bool* ep_space;
  int *in_buf, *in_cnt, *out_buf, *out_cnt, *rr, *wh;
  int *eg, *eg_ready, *eg_head, *eg_cnt;
  int* ep_flit;
  bool *ep_valid, *req_waiting;
  int R, P, Din, Dout, E, Q, V, cycle0, N, Rc, K;
};
static const int kClusterPtrs = 30;  // pointer members of ClusterArgs
static_assert(offsetof(ClusterArgs, R) == kClusterPtrs * sizeof(void*),
              "ClusterArgs: pointers first, then the ints");
static const int kClusterMaxThreads = 768;  // 24 warps: up to 85 registers

// Byte offsets of a CTA's shared-memory arrays for S = Rc * P slots. Every
// CTA of a cluster has the same layout, so a slot's offset in its owner's
// memory is the same expression everywhere. The output side and in_space,
// which other CTAs read, have two copies (ping-pong). fused_plan
// (noc_router.py) mirrors this arithmetic; the launcher checks that the
// two agree.
struct SmemLayout {
  size_t in_buf, out_buf, in_cnt, out_cnt, rr, wh, up_cnt, up_head, dn_space,
      ep_at, egh, egc, egf, egr, vc, dec, in_space, flags, total;
};

__host__ __device__ inline size_t take16(size_t& at, size_t bytes) {
  size_t o = at;
  at += (bytes + 15) / 16 * 16;
  return o;
}

__host__ __device__ inline SmemLayout smem_layout(int S, int Din, int Dout,
                                                  int V, int Pp) {
  SmemLayout m;
  const int copies = 2;
  size_t at = 0, s = (size_t)S;
  m.in_buf = take16(at, s * Din * NF * 4);
  m.out_buf = take16(at, copies * s * Dout * NF * 4);
  m.in_cnt = take16(at, s * 4);
  m.out_cnt = take16(at, copies * s * 4);
  m.rr = take16(at, s * 4);
  m.wh = take16(at, s * 4);
  // addresses (copy 0) of the upstream slot group's first output count, of
  // the upstream slot's output head and of the downstream slot group's
  // first in_space: shared::cta when this CTA owns the router (flags 4 and
  // 8), else shared::cluster; NO_LINK where the port has no link
  m.up_cnt = take16(at, s * 4);
  m.up_head = take16(at, s * 4);
  m.dn_space = take16(at, s * 4);
  m.ep_at = take16(at, s * 4);  // the endpoint attached here (ep_attach), or -1
  m.egh = take16(at, s * 4);    // that endpoint's egress head and count,
  m.egc = take16(at, s * 4);
  m.egf = take16(at, s * NF * 4);  // its head entry and ready stamp,
  m.egr = take16(at, s * 4);       // copied in ahead of their use
  m.vc = take16(at, V > 1 ? s * Pp * 4 : 0);  // vc_out[r, p, :]
  m.dec = take16(at, s);        // arbitration: 0x80 granted, 0x40 popped, winner
  m.in_space = take16(at, copies * s);
  m.flags = take16(at, s);      // 1: a port_ep endpoint with ep_space, 2: ep_attach's,
                                // 4: upstream local, 8: downstream local
  m.total = at;
  return m;
}

__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int cluster_ctas() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return (int)r;
}

// A cluster barrier in two halves: every thread of every CTA arrives
// (release: its shared and global writes become visible cluster-wide),
// may do work that reads nothing another CTA writes, then waits (acquire).
// A one-CTA cluster takes the block barrier at the arrival.
__device__ __forceinline__ void cluster_arrive(int ctas) {
  if (ctas == 1) {
    __syncthreads();
  } else {
    __syncwarp();
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }
}

__device__ __forceinline__ void cluster_wait(int ctas) {
  if (ctas > 1) asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync(int ctas) {
  cluster_arrive(ctas);
  cluster_wait(ctas);
}

// The address of the same shared-memory location in CTA `rank`.
__device__ __forceinline__ uint32_t in_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ int ld_cluster(uint32_t addr) {
  int v;
  asm volatile("ld.shared::cluster.s32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ int ld_cluster_u8(uint32_t addr) {
  unsigned v;
  asm volatile("ld.shared::cluster.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return (int)v;
}

// A load from this CTA's shared memory (`local`) or another's.
__device__ __forceinline__ int ld_any(uint32_t addr, bool local) {
  if (local) {
    int v;
    asm volatile("ld.shared.s32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return v;
  }
  return ld_cluster(addr);
}

__device__ __forceinline__ int ld_any_u8(uint32_t addr, bool local) {
  if (local) {
    unsigned v;
    asm volatile("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
    return (int)v;
  }
  return ld_cluster_u8(addr);
}

// n ints from src to dst by the block, four loads in flight per thread;
// 16 bytes at a time where both ends are 16-byte aligned
__device__ __forceinline__ void copy_ints(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          size_t n, int tid, int nt) {
  if (((uintptr_t)dst | (uintptr_t)src) % 16 == 0) {
    const size_t n4 = n / 4;
    int4* d4 = (int4*)dst;
    const int4* s4 = (const int4*)src;
    size_t k = tid;
    for (; k + 3 * (size_t)nt < n4; k += 4 * (size_t)nt) {
      const int4 a0 = s4[k], a1 = s4[k + nt], a2 = s4[k + 2 * nt], a3 = s4[k + 3 * nt];
      d4[k] = a0;
      d4[k + nt] = a1;
      d4[k + 2 * nt] = a2;
      d4[k + 3 * nt] = a3;
    }
    for (; k < n4; k += nt) d4[k] = s4[k];
    for (k = n4 * 4 + tid; k < n; k += nt) dst[k] = src[k];
    return;
  }
  size_t k = tid;
  for (; k + 3 * (size_t)nt < n; k += 4 * (size_t)nt) {
    const int a0 = src[k], a1 = src[k + nt], a2 = src[k + 2 * nt], a3 = src[k + 3 * nt];
    dst[k] = a0;
    dst[k + nt] = a1;
    dst[k + 2 * nt] = a2;
    dst[k + 3 * nt] = a3;
  }
  for (; k < n; k += nt) dst[k] = src[k];
}

__device__ __forceinline__ size_t min_size(size_t a, size_t b) { return a < b ? a : b; }

// The entry `h` of endpoint e's egress queue (flit and ready stamp) into a
// slot's shared copy, asynchronously: it is waited for one cycle later.
__device__ __forceinline__ void fetch_egress(int* egf, int* egr,
                                             const ClusterArgs& a, size_t entry) {
  for (int f = 0; f < NF; ++f) cp_async4(egf + f, a.eg0 + entry * NF + f);
  cp_async4(egr, a.eg_ready0 + entry);
}

// N fabric cycles of channel blockIdx.x / cluster size, each
// ref.fused_cycle_body, with the channel's state in the cluster's shared
// memory. Per cycle:
//  1. arbitration, local to each router's warp: lane p computes input p's
//     request, then, as output p, the first-min round-robin winner over the
//     router's requests (shuffled in); the granted winners' bits are OR-ed
//     across the router's lanes into the pop mask. rr/wh update in place
//     (only their own lane reads them); in_space goes to the copy other
//     CTAs read this cycle;
//  2. cluster barrier, arrival: every router's post-pop in_space is
//     published. Before the wait each lane reads what its own router holds
//     (the winner's head, its counts, the own side of both links) and
//     delivers the attached endpoint's head;
//  3. after the wait, the upstream output counts and head and the
//     downstream in_space (through distributed shared memory when the
//     router is another CTA's); then (after __syncwarp) pop/push the
//     input FIFO in place, inject the endpoint's ready egress head (not on
//     the window's last cycle; the next entry is copied in asynchronously),
//     and pop/push the output FIFO into the other copy.
// A CTA writes output copy i % 2 ^ 1 in cycle i
// while others read copy i % 2; it can reach cycle i + 1's writes to copy
// i % 2 only after the barrier of cycle i + 1, which every CTA reaches
// after its cycle-i reads. in_space alternates the same way. DIN and DOUT
// fix the FIFO depths at compile time (0: taken from the arguments).
template <int DIN, int DOUT>
__global__ void __launch_bounds__(kClusterMaxThreads, 1)
    noc_fused_cluster_kernel(ClusterArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, P = a.P, E = a.E, Q = a.Q;
  const int Din = DIN ? DIN : a.Din, Dout = DOUT ? DOUT : a.Dout;
  const int V = a.V, N = a.N, Rc = a.Rc, K = a.K;
  const int ctas = cluster_ctas(), rank = cluster_rank();
  const int c = blockIdx.x / ctas;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int S = Rc * P, Pp = P / V;
  const int r0 = rank * Rc;
  const int nr = max(0, min(R, r0 + Rc) - r0), ns = nr * P;
  const int fin = Din * NF, fout = Dout * NF;
  const SmemLayout L = smem_layout(S, Din, Dout, V, Pp);
  int* s_in = (int*)(smem + L.in_buf);
  int* s_out = (int*)(smem + L.out_buf);
  int* s_ic = (int*)(smem + L.in_cnt);
  int* s_oc = (int*)(smem + L.out_cnt);
  int* s_rr = (int*)(smem + L.rr);
  int* s_wh = (int*)(smem + L.wh);
  uint32_t* s_upc = (uint32_t*)(smem + L.up_cnt);
  uint32_t* s_uph = (uint32_t*)(smem + L.up_head);
  uint32_t* s_dns = (uint32_t*)(smem + L.dn_space);
  int* s_epat = (int*)(smem + L.ep_at);
  int* s_egh = (int*)(smem + L.egh);
  int* s_egc = (int*)(smem + L.egc);
  int* s_egf = (int*)(smem + L.egf);
  int* s_egr = (int*)(smem + L.egr);
  int* s_vc = (int*)(smem + L.vc);
  uint8_t* s_dec = smem + L.dec;
  uint8_t* s_isp = smem + L.in_space;
  uint8_t* s_flags = smem + L.flags;
  const size_t g0 = ((size_t)c * R + r0) * P;  // this CTA's first slot
  const size_t ce = (size_t)c * E, ceq = ce * Q;
  // byte strides between the two copies of what other CTAs read
  const uint32_t cnt_copy = (uint32_t)S * 4, buf_copy = (uint32_t)S * fout * 4;

  // ---- the state in, the tables of each slot ----
  for (int k = tid; k < ns * fin; k += nt) cp_async4(s_in + k, a.in_buf0 + g0 * fin + k);
  for (int k = tid; k < ns * fout; k += nt) cp_async4(s_out + k, a.out_buf0 + g0 * fout + k);
  for (int k = tid; k < ns; k += nt) {
    cp_async4(s_ic + k, a.in_cnt0 + g0 + k);
    cp_async4(s_oc + k, a.out_cnt0 + g0 + k);
    cp_async4(s_rr + k, a.rr0 + g0 + k);
    cp_async4(s_wh + k, a.wh0 + g0 + k);
  }
  if (V > 1)
    for (int k = tid; k < ns * Pp; k += nt) cp_async4(s_vc + k, a.vc_out + (size_t)r0 * P * Pp + k);
  for (int t = tid; t < ns; t += nt) {
    const int r = r0 + t / P, p = t % P, v = p % V;
    const size_t lp = ((size_t)r * Pp + p / V) * 2;
    // clamped into range as the reference gathers; a missing link is -1
    const int src_r = a.link_src[lp], src_p = a.link_src[lp + 1];
    const int dst_r = a.link_dst[lp], dst_p = a.link_dst[lp + 1];
    const int pe = a.port_ep[(size_t)r * P + p];
    int fl = 0, e = -1;
    if (pe >= 0) {
      // port_ep is ep_attach's inverse (attach slots are unique): the
      // endpoint of this port is served by this slot's lane if it attaches
      // here; its egress head entry comes in asynchronously
      const int pc = min(pe, E - 1);
      const int ar = a.ep_attach[pc * 2], ap = a.ep_attach[pc * 2 + 1];
      const int h = a.eg_head0[ce + pc], cq = a.eg_cnt0[ce + pc];
      const bool ep_ok = a.ep_space[ce + pc];
      fl = ep_ok ? 1 : 0;
      if (pe < E && ar == r && ap == p) {
        e = pe;
        fl |= ep_ok ? 2 : 0;
        s_egh[t] = h;
        s_egc[t] = cq;
        fetch_egress(s_egf + t * NF, s_egr + t, a, ceq + (size_t)e * Q + h);
      }
    }
    s_upc[t] = s_uph[t] = s_dns[t] = NO_LINK;
    if (src_r >= 0) {
      const int up = clampi(src_r, 0, R - 1) * P + clampi(src_p, 0, Pp - 1) * V;
      const int ru = up / S, lu = up - ru * S;
      const uint32_t cnt = smem_addr(s_oc + lu);
      const uint32_t head = smem_addr(s_out + (size_t)(lu + v) * fout);
      s_upc[t] = ru == rank ? cnt : in_rank(cnt, ru);
      s_uph[t] = ru == rank ? head : in_rank(head, ru);
      fl |= ru == rank ? 4 : 0;
    }
    if (dst_r >= 0) {
      const int dn = clampi(dst_r, 0, R - 1) * P + clampi(dst_p, 0, Pp - 1) * V;
      const int rd = dn / S;
      const uint32_t space = smem_addr(s_isp + (dn - rd * S));
      s_dns[t] = rd == rank ? space : in_rank(space, rd);
      fl |= rd == rank ? 8 : 0;
    }
    s_epat[t] = e;
    s_flags[t] = (uint8_t)fl;
  }
  // the egress queues pass through, split over the cluster; the attached
  // endpoints' heads and counts are written again by their lanes at the end
  // (after the last cluster barrier, so those writes land last)
  {
    const size_t n = (size_t)E * Q, chunk = ((n + ctas - 1) / ctas + 3) / 4 * 4;
    const size_t lo = min_size((size_t)rank * chunk, n), hi = min_size(lo + chunk, n);
    copy_ints(a.eg + (ceq + lo) * NF, a.eg0 + (ceq + lo) * NF, (hi - lo) * NF, tid, nt);
    copy_ints(a.eg_ready + ceq + lo, a.eg_ready0 + ceq + lo, hi - lo, tid, nt);
    const int echunk = (E + ctas - 1) / ctas;
    for (int e = rank * echunk + tid; e < min(E, (rank + 1) * echunk); e += nt) {
      const int h = a.eg_head0[ce + e], cq = a.eg_cnt0[ce + e];
      a.eg_head[ce + e] = h;
      a.eg_cnt[ce + e] = cq;
    }
  }
  cp_async_wait_all();
  cluster_sync(ctas);  // every CTA's state is in before any remote read

  const int rpw = 32 / P;  // routers per warp
  const int sub = lane / P, p = lane % P, v = p % V, base = sub * P;
  const int gofs = (p / V) * V;  // my router's first slot of port p / V
  int cur = 0;  // the output copy holding the cycle-start snapshot
  for (int i = 0; i < N; ++i) {
    const int par = i & 1;
    const int* oc = s_oc + cur * S;
    const int* ob = s_out + (size_t)cur * S * fout;
    uint8_t* isp = s_isp + par * S;

    // ---- 1. arbitration (this router's lanes only) ----
    for (int k = 0; k < K; ++k) {
      const int lr = (k * nwarps + warp) * rpw + sub;
      const bool live = sub < rpw && lr < nr;
      const int t = lr * P + p;
      int req = -1, cnt = 0, lock = -1, ptr = 0, q = 0;
      bool space = false;
      if (live) {
        const int r = r0 + lr;
        cnt = s_ic[t];
        // Dead heads (count 0) hold stale contents and request nothing; a
        // destination past the table reads JAX's INT_MIN gather fill.
        const int dst = max(s_in[t * fin + F_DST], 0);
        int port = dst < E ? __ldg(a.route + (size_t)r * E + dst) : INT_MIN;
        if (V > 1) {
          const int vout = s_vc[t * Pp + clampi(port, 0, Pp - 1)];
          port = (int)((uint32_t)port * (uint32_t)V + (uint32_t)vout);
        }
        req = cnt > 0 ? port : -1;
        lock = s_wh[t];
        ptr = s_rr[t];
        q = floor_mod(-ptr, P);  // score of input pin: (pin - ptr) mod P
        space = oc[t] < Dout;
      }
      int best = 0, winner = 0;
      for (int pin = 0; pin < P; ++pin) {
        const int rq = __shfl_sync(FULL_MASK, req, (base + pin) & 31);
        const bool elig = rq == p && (lock < 0 || lock == pin) && space;
        const int s = pin + q >= P ? pin + q - P : pin + q;
        const int score = elig ? s : P + 1;
        if (pin == 0 || score < best) {  // first minimum, as the reference
          best = score;
          winner = pin;
        }
      }
      const bool g = live && best <= P;
      const unsigned bit = g ? 1u << winner : 0u;
      unsigned pops = 0;
      for (int j = 0; j < P; ++j) pops |= __shfl_sync(FULL_MASK, bit, (base + j) & 31);
      if (live) {
        const bool tail = s_in[(lr * P + winner) * fin + F_LAST] > 0;
        s_rr[t] = g ? (winner + 1 == P ? 0 : winner + 1) : ptr;
        s_wh[t] = g ? (tail ? -1 : winner) : lock;
        const bool pop = (pops >> p) & 1u;
        s_dec[t] = (uint8_t)((g ? 0x80 : 0) | (pop ? 0x40 : 0) | winner);
        isp[t] = (cnt - (pop ? 1 : 0)) < Din;
      }
    }
    cluster_arrive(ctas);

    // ---- 2. link resolution and FIFO updates ----
    const int nxt = cur ^ 1;
    int* noc = s_oc + nxt * S;
    int* nob = s_out + (size_t)nxt * S * fout;
    for (int k = 0; k < K; ++k) {
      const int lr = (k * nwarps + warp) * rpw + sub;
      const bool live = sub < rpw && lr < nr;
      const int t = lr * P + p;
      const int gb = lr * P + gofs;
      bool accept = false, sent = false;
      int flit[NF], chosen[NF];
      int icnt = 0, ocnt = 0, dec = 0, e = -1, fl = 0;
      unsigned in_ok = 0, out_ok = 0;  // by VC u <= v: my input space, my output valid
      if (live) {
        icnt = s_ic[t];
        ocnt = oc[t];
        dec = s_dec[t];
        fl = s_flags[t];
        for (int u = 0; u <= v; ++u) {
          in_ok |= (isp[gb + u] ? 1u : 0u) << u;
          out_ok |= (oc[gb + u] > 0 ? 1u : 0u) << u;
        }
        if ((fl & 1) && ocnt > 0) sent = true;  // to the endpoint
        // `chosen` is the winner's head (stale when nothing was granted)
        const int* wh_head = s_in + (lr * P + (dec & 31)) * fin;
#pragma unroll
        for (int f = 0; f < NF; ++f) chosen[f] = wh_head[f];
        e = s_epat[t];
        if (e >= 0) {  // deliveries and req_waiting: the cycle-start snapshot
          const size_t o = ((size_t)c * N + i) * E + e;
#pragma unroll
          for (int f = 0; f < NF; ++f) a.ep_flit[o * NF + f] = ob[(size_t)t * fout + f];
          a.ep_valid[o] = ocnt > 0 && (fl & 2);
          a.req_waiting[o] = ocnt > 0;
        }
      }
      if (k == 0) cluster_wait(ctas);
      if (live) {
        // the wire from upstream: VC u is eligible when the upstream head on
        // u is valid and my input u has space; the lowest eligible VC wins
        const uint32_t upc = s_upc[t];
        if (upc != NO_LINK) {
          for (int u = 0; u <= v; ++u) {
            if (((in_ok >> u) & 1u) && ld_any(upc + cur * cnt_copy + 4 * u, fl & 4) > 0) {
              accept = u == v;
              break;
            }
          }
          if (accept) {
            const uint32_t head = s_uph[t] + cur * buf_copy;
#pragma unroll
            for (int f = 0; f < NF; ++f) flit[f] = ld_any(head + 4 * f, fl & 4);
          }
        }
        // the wire downstream, decided from my side with the same snapshot
        const uint32_t dns = s_dns[t];
        if (dns != NO_LINK) {
          for (int u = 0; u <= v; ++u) {
            if (((out_ok >> u) & 1u) && ld_any_u8(dns + par * S + u, fl & 8)) {
              sent = sent || u == v;
              break;
            }
          }
        }
      }
      __syncwarp();  // the router's lanes have read each other's heads
      if (live) {
        // input FIFO in place: slot d takes slot min(d + pop, D - 1) unless
        // it is the push target (ascending d reads only slots not yet written)
        int* ib = s_in + t * fin;
        const bool pop_in = dec & 0x40;
        const int c1 = icnt - (pop_in ? 1 : 0), tail = clampi(c1, 0, Din - 1);
#pragma unroll
        for (int d = 0; d < Din; ++d) {
          if (accept && d == tail) {
#pragma unroll
            for (int f = 0; f < NF; ++f) ib[d * NF + f] = flit[f];
          } else if (pop_in) {
            const int sd = min(d + 1, Din - 1);
#pragma unroll
            for (int f = 0; f < NF; ++f) ib[d * NF + f] = ib[sd * NF + f];
          }
        }
        int nic = c1 + (accept ? 1 : 0);
        // egress injection: the endpoint's ready head onto its attach slot
        if (e >= 0 && i < N - 1) {
          cp_async_wait_all();  // the head entry fetched when it became head
          const int h = s_egh[t], cq = s_egc[t];
          const bool want = cq > 0 && s_egr[t] <= a.cycle0 + i;
          if (want && nic < Din) {
#pragma unroll
            for (int f = 0; f < NF; ++f) ib[nic * NF + f] = s_egf[t * NF + f];
            nic += 1;
            const int h1 = h + 1 == Q ? 0 : h + 1;
            s_egh[t] = h1;
            s_egc[t] = cq - 1;
            fetch_egress(s_egf + t * NF, s_egr + t, a, ceq + (size_t)e * Q + h1);
          }
        }
        s_ic[t] = nic;
        // output FIFO into the other copy
        const bool grant = dec & 0x80;
        const int* o0 = ob + (size_t)t * fout;
        int* o1 = nob + (size_t)t * fout;
        const int c2 = ocnt - (sent ? 1 : 0), otail = clampi(c2, 0, Dout - 1);
#pragma unroll
        for (int d = 0; d < Dout; ++d) {
          if (grant && d == otail) {
#pragma unroll
            for (int f = 0; f < NF; ++f) o1[d * NF + f] = chosen[f];
          } else {
            const int sd = min(d + (sent ? 1 : 0), Dout - 1);
#pragma unroll
            for (int f = 0; f < NF; ++f) o1[d * NF + f] = o0[sd * NF + f];
          }
        }
        noc[t] = c2 + (grant ? 1 : 0);
      }
    }
    cur = nxt;
    __syncwarp();  // the next arbitration reads the router's other slots
  }

  // no CTA leaves while another may read its memory; then the state out
  cluster_sync(ctas);
  const int* ob = s_out + (size_t)cur * S * fout;
  copy_ints(a.in_buf + g0 * fin, s_in, (size_t)ns * fin, tid, nt);
  copy_ints(a.out_buf + g0 * fout, ob, (size_t)ns * fout, tid, nt);
  copy_ints(a.in_cnt + g0, s_ic, ns, tid, nt);
  copy_ints(a.out_cnt + g0, s_oc + cur * S, ns, tid, nt);
  copy_ints(a.rr + g0, s_rr, ns, tid, nt);
  copy_ints(a.wh + g0, s_wh, ns, tid, nt);
  for (int k = tid; k < ns; k += nt) {
    const int e = s_epat[k];
    if (e >= 0) {
      a.eg_head[ce + e] = s_egh[k];
      a.eg_cnt[ce + e] = s_egc[k];
    }
  }
  cp_async_wait_all();  // no copy into shared memory outlives the block
}

// CTAs of a per-cycle arbitration or apply launch: 32 / P routers a warp,
// four warps a CTA.
static int arb_blocks(int C, int R, int P) {
  const long rpw = 32 / P, warps = ((long)C * R + rpw - 1) / rpw;
  return (int)((warps * 32 + kArbThreads - 1) / kArbThreads);
}

extern "C" int noc_arb_launch(
    const void* in_buf, const void* in_cnt, const void* out_cnt,
    const void* rr, const void* wh, const void* route, const void* vc_out,
    void* arb_pop, void* granted, void* chosen, void* rr_out, void* wh_out,
    void* in_space, int C, int R, int P, int Din, int Dout, int E, int V,
    void* stream) {
  noc_arb_kernel<<<arb_blocks(C, R, P), kArbThreads, 0, (cudaStream_t)stream>>>(
      (const int*)in_buf, (const int*)in_cnt, (const int*)out_cnt,
      (const int*)rr, (const int*)wh, (const int*)route,
      (const int*)vc_out, (bool*)arb_pop, (bool*)granted, (int*)chosen,
      (int*)rr_out, (int*)wh_out, (bool*)in_space, C, R, P, Din, Dout, E, V);
  return (int)cudaGetLastError();
}

extern "C" int noc_apply_launch(
    const void* in_buf, const void* in_cnt, const void* out_buf,
    const void* out_cnt, const void* arb_pop, const void* granted,
    const void* chosen, const void* in_space, const void* link_src,
    const void* link_dst, const void* port_ep, const void* ep_space,
    void* new_in_buf, void* new_in_cnt, void* new_out_buf, void* new_out_cnt,
    int C, int R, int P, int Din, int Dout, int E, int V, int fused, void* stream) {
  // each warp's old and new FIFO rows, both sides: 14 KB a CTA at depth 2
  // (every configuration's default, fixed at compile time), any depth else
  static size_t allowed = 48 * 1024;
  const size_t smem = (size_t)kArbThreads * (Din + Dout) * NF * sizeof(int);
  const auto kernel = Din == 2 && Dout == 2 ? noc_apply_kernel<2, 2> : noc_apply_kernel<0, 0>;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        noc_apply_kernel<0, 0>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = smem;
  }
  kernel<<<arb_blocks(C, R, P), kArbThreads, smem, (cudaStream_t)stream>>>(
      (const int*)in_buf, (const int*)in_cnt, (const int*)out_buf,
      (const int*)out_cnt, (const bool*)arb_pop, (const bool*)granted,
      (const int*)chosen, (const bool*)in_space, (const int*)link_src,
      (const int*)link_dst, (const int*)port_ep, (const bool*)ep_space,
      (int*)new_in_buf, (int*)new_in_cnt, (int*)new_out_buf,
      (int*)new_out_cnt, C, R, P, Din, Dout, E, V, fused);
  return (int)cudaGetLastError();
}

// `ptrs` holds the 20 pointer operands of noc_arb_offload_kernel in order,
// `dims` (C, R, P, Din, Dout, E, V, G).
extern "C" int noc_arb_offload_launch(void* const* ptrs, const int* dims,
                                      void* stream) {
  const int C = dims[0], R = dims[1], P = dims[2], Din = dims[3];
  const int Dout = dims[4], E = dims[5], V = dims[6], G = dims[7];
  noc_arb_offload_kernel<<<arb_blocks(C, R, P), kArbThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int*)ptrs[0], (const int*)ptrs[1], (const int*)ptrs[2],
      (const int*)ptrs[3], (const int*)ptrs[4], (const int*)ptrs[5],
      (const int*)ptrs[6], (const bool*)ptrs[7], (const int*)ptrs[8],
      (const int*)ptrs[9], (const int*)ptrs[10], (const bool*)ptrs[11],
      (bool*)ptrs[12], (bool*)ptrs[13], (int*)ptrs[14], (int*)ptrs[15],
      (int*)ptrs[16], (bool*)ptrs[17], (int*)ptrs[18], (bool*)ptrs[19], C,
      R, P, Din, Dout, E, V, G);
  return (int)cudaGetLastError();
}

// `ptrs` holds the kFusedPtrs pointers of FusedArgs in declaration order,
// `dims` (C, R, P, Din, Dout, E, Q, V, cycle0, N).
extern "C" int noc_fused_global_launch(void* const* ptrs, const int* dims,
                                       void* stream) {
  FusedArgs a;
  memcpy(&a, ptrs, kFusedPtrs * sizeof(void*));
  int C = dims[0];
  a.R = dims[1]; a.P = dims[2]; a.Din = dims[3]; a.Dout = dims[4];
  a.E = dims[5]; a.Q = dims[6]; a.V = dims[7]; a.cycle0 = dims[8];
  a.N = dims[9];
  noc_fused_global_kernel<<<C, kFusedThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The plan of a cluster launch: `dims` (C, R, P, Din, Dout, E, Q, V, cycle0,
// N, cluster, Rc, threads, K, smem). Errors of the plan itself are
// returned as 1000 + a reason.
enum { kPlanSmem = 1001, kPlanShape = 1002 };

static int check_plan(const int* d) {
  const int R = d[1], P = d[2], Din = d[3], Dout = d[4], V = d[7];
  const int cl = d[10], Rc = d[11], threads = d[12], K = d[13];
  if (cl < 1 || cl > 16 || Rc < 1 || (long)cl * Rc < R || P < 1 || P > MAX_P ||
      V < 1 || P % V || threads < 32 || threads > kClusterMaxThreads ||
      threads % 32 || K < 1)
    return kPlanShape;
  const int groups = (Rc + 32 / P - 1) / (32 / P);  // router groups of a warp
  if ((long)(threads / 32) * K < groups) return kPlanShape;
  if (smem_layout(Rc * P, Din, Dout, V, P / V).total != (size_t)d[14]) return kPlanSmem;
  return 0;
}

// The kernel of a plan: depths of 2 (every configuration's default) fixed
// at compile time, or any depths.
typedef void (*ClusterKernel)(ClusterArgs);
static int kernel_index(const int* d) { return d[3] == 2 && d[4] == 2 ? 1 : 0; }
static const ClusterKernel kClusterKernels[2] = {noc_fused_cluster_kernel<0, 0>,
                                                 noc_fused_cluster_kernel<2, 2>};

static void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           const int* d, void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(d[0] * d[10]));
  cfg->blockDim = dim3((unsigned)d[12]);
  cfg->dynamicSmemBytes = (size_t)d[14];
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)d[10];
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Allow the plan's shared memory (never lowering what an earlier plan was
// allowed) and cluster size, then ask how many of its clusters the card can
// place at once (`*clusters`; 0: none).
extern "C" int noc_fused_cluster_prepare(const int* dims, int* clusters) {
  static int allowed[2] = {0, 0};
  int err = check_plan(dims);
  if (err) return err;
  const int ki = kernel_index(dims), smem = dims[14];
  const void* fn = (const void*)kClusterKernels[ki];
  if (smem > allowed[ki]) {
    err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    allowed[ki] = smem;
  }
  if (dims[10] > 8) {
    err = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dims, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, fn, &cfg);
}

// `ptrs` holds the kClusterPtrs pointers of ClusterArgs in declaration
// order; `dims` as for noc_fused_cluster_prepare, which must have accepted
// the plan first.
extern "C" int noc_fused_cluster_launch(void* const* ptrs, const int* dims,
                                        void* stream) {
  int err = check_plan(dims);
  if (err) return err;
  ClusterArgs a;
  memcpy(&a, ptrs, kClusterPtrs * sizeof(void*));
  a.R = dims[1]; a.P = dims[2]; a.Din = dims[3]; a.Dout = dims[4];
  a.E = dims[5]; a.Q = dims[6]; a.V = dims[7]; a.cycle0 = dims[8];
  a.N = dims[9]; a.Rc = dims[11]; a.K = dims[13];
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, dims, stream);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kClusterKernels[kernel_index(dims)], a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
