#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of the FlooNoC reproduction on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch`` (``nvcc`` for ``sm_90a``,
one compiler per source, all at once): the router cycle, flash attention
and its backward, RMSNorm (with its backward), the SSD scan and its
backward, and the paged KV gather. Holds each kernel against
its plain PyTorch version on the card, drives the simulator's main path
through the port's entry points (``build_sim`` / ``run`` / ``stats``), the
paper's figures through ``repro_torch.benchmarks`` and the model stack's
serving paths (``Engine.generate`` on Phi-4-mini, Mamba-2, Zamba2,
Llama-4-Scout, Gemma 3 4B, DeepSeek-V2, Qwen2-VL and SeamlessM4T) and
its training paths (``Trainer.run`` on Phi-4-mini, Mamba-2 and Zamba2,
through the backward kernels), and checks what comes out:

1. the card (``nvidia-smi``) and the kernels' build time;
2. the arb and apply kernels bit-identical to the plain version on random
   consistent snapshots at 8x4 (R=32), 32x32 (R=1024) and 7x1 (R=7: the
   arb kernel's last warp holds 3 of its 6 routers), depths 2 and 4; the
   same at ``n_vcs=2`` on the 8x4 and 32x32 tori and Occamy (28 slots), at
   ``n_vcs=6`` on the 8x4 torus (30 slots), and on synthetic tables of 32
   slots (32 ports, and 16 ports at ``n_vcs=2``); the fused window (N = 1,
   4, 16; V = 1, 2) against N plain cycles with random circular egress
   queues, on the 8x4 and 32x32 fabrics,
   a 23x19 mesh whose routers split unevenly over an 8-CTA cluster, and a
   48x48 torus too large for a 16-CTA cluster (the global-memory kernel);
   at every arb / apply shape above and after the offload arb kernel (9),
   the apply kernel's unfused FIFO mode (the naive step's pop then push)
   bit-equal to ``apply_phase(fused=False)``, dead slots included, its
   inputs untouched (``kernels_vs_plain_unfused``);
3. the paper's 8x4 compute mesh: the GPU state after 1200 cycles equal,
   leaf for leaf, to the same run on the CPU; Fig. 7 (22 / 26 / 58
   cycles); the golden stat pins of the 4x2 mesh;
4. the 32x32 scaling point (uniform 8 kB x 4 DMA reads, 200 cycles): GPU
   state equal to CPU state, ms per simulated cycle, kernel and plain
   times, peak device memory;
   at both sizes also the router cycle's and the endpoint phases' share of
   a step, and the device's busy share under ``torch.profiler``;
5. super-steps: the 8x4 mesh at ``fused_cycles=4`` (300 cycles,
   ``SUPER_CYCLES``, cut from 1200: GPU state equal to CPU state, one
   fused launch per 4 cycles, ms per cycle beside k = 1);
6. the 8x4 torus at ``n_vcs=2``, one cycle per step and at
   ``fused_cycles=4`` (300 cycles each, cut from 1200; the naive step's
   torus cell too): GPU state equal to CPU state, ms per cycle, the VC
   arb/apply kernels timed on the per-cycle run's state (the simulator
   profiles cover ``PROFILE_STEPS`` = 6 steps, 3 for the super-steps and
   the all-reduce, cut from 20 and 10, and the timing turns
   ``TURN_CYCLES`` = 48 cycles, cut from 100; ``time_budget`` holds each
   cut's seconds in the run against the training phases');
7. the 8x1 ring: wedged at ``n_vcs=1`` (nothing delivered in 1100
   cycles, more than the drain takes), drained at ``n_vcs=2`` with the
   GPU state equal to CPU state;
8. the 32x32 torus at ``n_vcs=2``, one cycle per step and at
   ``fused_cycles=4`` (200 cycles each): GPU state equal to CPU state, ms
   per cycle, peak device memory; VC and fused kernel times against their
   plain versions and bounds (each fused time with its plan: cluster size,
   shared memory and threads per CTA, layout and kernel; the global-memory
   kernel's time on the same state; and the per-cycle arb + apply pair at
   the same shape);
9. in-network collective offload (``collective_offload=True``): the
   offload arb kernel against its plain version on random snapshots with
   random reduction-ALU state (8x4 mesh and torus, 32x32 mesh, Occamy's 28
   slots, the 7x1 mesh; 40 groups on the 8x4 mesh and torus); the
   in-fabric all-reduce (16 kB, 2 streams) on the 8x4 mesh and the 8x4
   torus at ``n_vcs=2`` and the offloaded tree multicast (16 kB, 4
   streams) on the 8x4 mesh, each delivering exactly its
   ``expect_rx`` at the CPU run's completion cycle (693 / 673 / 278) with
   the GPU state equal to the CPU's (the all-reduces run 720 cycles,
   ``OFFLOAD_CYCLES``, cut from 1 000, the naive one too; the multicast 300,
   cut from 450); the all-reduce on the 32x32 mesh for
   150 cycles, cut from 200 (state against CPU, ms per cycle, peak device memory); the
   offload arb kernel's time against its plain version and bound; the
   8x4 all-reduce's layer split and device profile from cycle 400;
9b. the naive reference step (``step_impl="naive"``): the 8x4 mesh under
   ``main_8x4``'s workload (1200 cycles), the 32x32 scaling point (200),
   the 8x4 torus at ``n_vcs=2`` (``SUPER_CYCLES``) and the in-fabric
   all-reduce on the 8x4 mesh (delivering exactly ``expect_rx`` at cycle 693), each with one
   arb and one unfused apply launch a cycle and no fused-mode apply; the
   card state equal to the CPU's naive state leaf for leaf and, under
   ``canonical_state(scrub=True)``, to the fast cell's card state; Fig. 7
   (22 / 26 / 58) under naive; ms per cycle beside the fast cell's, and
   fast against naive in turns on the 8x4 mesh;
10. the model stack (``kernels_vs_plain_model``, ``serve_*_vs_cpu``,
   ``serve_*``, ``profile_serve_*``, ``kernel_times_model``): the
   flash-attention kernel against its plain version at the serve paths'
   shapes (B=4, S=512, bf16: H=24, KV=8, D=128; H=KV=32, D=112; H=40,
   KV=8, D=128), the
   ``tests/test_kernels.py`` sweep shapes in float32 and bf16, a ragged
   S=520, Dv != D, a ragged D=112, partial and single-row tiles (S = 1,
   63, 64, 65, 129), every (D, Dv) in bf16 and Sq != Skv, and the sliding
   window and D = 256 in both dtypes (Gemma 3's B=4, S=2048, H=8, KV=4,
   D=256 with window 1024 and without, a window below one tile at a ragged
   S, one not a multiple of 64, a ragged S, the left edge alone), and
   DeepSeek-V2's MLA prefill (B=4, S=512, H=KV=128, D=192, Dv=128; a ragged
   S=520 and S=1) in both dtypes, Qwen2-VL's prefill (B=4, S=512, H=64,
   KV=8, D=128, causal) and SeamlessM4T's (B=4, S=512, H=KV=16, D=64: the
   encoder and the cross-attention non-causal, the decoder's
   self-attention causal, and a ragged cross-attention of Sq=300 against
   Skv=512) in both dtypes; both RMSNorm
   variants at N = 4 and 2048, d = 3072 and 5120, at N = 1, 5 and 2047,
   d = 768 and 3584, with a weight at an odd element offset and at d = 100,
   at d = 2560 (N = 8192 and 4), at d = 1536, 512, 8192 and 1024 (N = 2048
   and 4), float32 and bf16; the SSD kernel (y and final state) at
   the sweep shapes in float32 and bf16, the Mamba-2 (H=24, P=64, N=128)
   and Zamba2 (H=112, N=64) path shapes (B=4, S=512, Q=128, bf16), a ragged
   S=520, an entering state, and in bf16 Q=100, P=40, N=72 (off the
   tensor-core kernel's tiles), N = 16 and 4, and S = 1; inputs untouched. Card against CPU (one
   prompt, 4 greedy steps: logits within ``LOGIT_TOL``, tokens equal where
   the CPU's top-2 margin exceeds it): Phi-4-mini at full width and 2
   layers (400 tokens), Mamba-2-130m at full width and depth (512 tokens),
   Zamba2-7B at full width and 7 layers (one superblock, one shared
   attention, one trailing layer; 256 tokens, two chunks), Llama-4-Scout
   at full width and 2 layers (120 tokens; bf16 and float32 under the
   routing rule: float32 routes every token alike in every layer, bf16
   only near-ties may route differently, logits and tokens compared at
   the positions routed alike, ``serve_llama4_scout_vs_cpu``), Gemma 3 at
   full width and 7 layers (one superblock, one trailing local layer; a
   1 500-token prompt padded to 2048, so the rings hold pads as the
   engine's do, ``serve_gemma3_4b_vs_cpu``), DeepSeek-V2 at full width and
   2 layers (the dense first layer and one MoE layer, both MLA; 120 tokens;
   bf16 and float32 under the routing rule, ``serve_deepseek_v2_vs_cpu``),
   Qwen2-VL at full width and 2 layers (400 tokens padded to 512, random
   patch embeddings in the first 256 slots on both sides,
   ``serve_qwen2_vl_vs_cpu``), SeamlessM4T whole (random frames [1, 512,
   1024] on both sides, a 400-token decoder prompt,
   ``serve_seamless_vs_cpu``); one
   Llama-4-Scout MoE layer at full width in float32 with capacity factor
   0.25 on the card and the CPU (``dropped_frac`` 0.75 on both, routing
   equal, output within ``MOE_TOL``), and in bf16 with no host
   synchronisation inside (``moe_drop_vs_cpu``). Each model at full width
   through ``Engine.generate``, at full depth but for Llama-4-Scout (12 of
   48 layers, ``LLAMA4_LAYERS``, DeepSeek-V2, 8 of 60,
   ``DEEPSEEK_LAYERS``, and Qwen2-VL, 32 of 80, ``QWEN2VL_LAYERS``: the
   whole models do not fit the card) and Zamba2
   (27 of 81, ``ZAMBA2_LAYERS``: the run's time limit): 4 prompts
   (Phi-4-mini, Llama-4-Scout, DeepSeek-V2, Qwen2-VL and SeamlessM4T
   300-500 tokens, Mamba-2 and Zamba2 512 each, Gemma 3 2048 each, no pad
   tail; Qwen2-VL's first 256 slots the engine's zero patch stub, on a
   16 x 16 grid; SeamlessM4T's encoder fed the engine's zero frames [4,
   512, 1024]), 16 greedy tokens, twice (identical
   tokens; launch counts exact: per prefill / decode step Phi-4-mini 32 /
   0 flash and 65 / 65 RMSNorm, Mamba-2 24 / 0 SSD and 25 / 25 RMSNorm,
   Zamba2 (27 of 81 layers, ``ZAMBA2_LAYERS``) 27 / 0 SSD, 4 / 0 flash and
   36 / 36 RMSNorm, Llama-4-Scout
   12 / 0 flash and 25 / 25 RMSNorm, Gemma 3 34 / 0 flash (29 windowed)
   and 69 / 69 RMSNorm, DeepSeek-V2 8 / 0 flash (D=192, Dv=128) and 33 / 33
   RMSNorm (ln1, q_norm, kv_norm, ln2 a layer, the final norm), Qwen2-VL
   32 / 0 flash and 65 / 65 RMSNorm, SeamlessM4T 36 / 0 flash (12 encoder,
   12 self- and 12 cross-attention at D=64) and 62 / 37 RMSNorm (encoder 2
   a layer and its final norm, decoder 3 a layer and the final norm); 15
   decode steps), all logits finite,
   prefill ms, decode ms per step, tokens/s, peak device memory, and the
   device's busy share of one prefill and one decode step
   (``torch.profiler``); Llama-4-Scout's and DeepSeek-V2's decode step
   beside its bytes bound (every weight but the routed experts, which count
   as far as that step's tokens pick them; the dense first layer's MLP;
   the K/V or MLA's compressed cache read and written), Gemma 3's and
   Qwen2-VL's beside theirs (every weight a decode step reads and each
   layer's valid K/V read once), SeamlessM4T's beside its own (the decoder's
   weights and the embedding, not the encoder's; the self-attention's K/V
   and the cross-attention's ``ck`` / ``cv`` over ``enc_len``); each
   kernel's time at
   the paths' shapes beside its bound, its plain version and one PyTorch
   call where there is one (``library_ms``: ``scaled_dot_product_attention``,
   ``rms_norm``; none computes the SSD scan), flash attention also at
   Llama-4-Scout's 40 / 8 heads, at Gemma 3's shape with its window
   (bound over the visible pairs only; SDPA given the band as a boolean
   mask, the backend it picks named) and without, at DeepSeek-V2's MLA
   shape, at Qwen2-VL's 64 / 8 heads and at SeamlessM4T's D=64, non-causal
   (bound over all S x S pairs) and causal (SDPA's backend named), RMSNorm
   also at Mamba-2's, Zamba2's, Llama-4-Scout's, Gemma 3's, DeepSeek-V2's,
   Qwen2-VL's and SeamlessM4T's widths (N = 2048, d = 768, 3584, 5120,
   1536, 512, 8192 and 1024; N = 8192, d = 2560);
10b. training on the card (``kernels_vs_plain_train_*``, ``train_vs_cpu``,
   ``train_ssm_vs_cpu``, ``train_resume_card``, ``serve_int8_cache_vs_cpu``,
   ``train_phi4_mini``, ``train_mamba2_130m``, ``train_zamba2_7b``,
   ``train_families_vs_cpu``, ``moe_grouped_bwd``, ``train_gemma3_4b``,
   ``train_deepseek_v2``, ``train_seamless_m4t``, ``kernel_times_train``):
   the backward kernels (flash attention's dQ and
   dK / dV, RMSNorm's dx / dw) against the autograd of their plain
   versions in float32 and bf16 (flash at Phi-4-mini's B 4, S 512, 24 / 8
   heads, D 128, at Zamba2's 32 / 32 heads, D 112, at D 32 and 112, S = 1,
   63, 65, 129 and a ragged 520, G =
   1, 3 and 8, non-causal with Sq != Skv; at the training shapes of Gemma
   3 (B 2, S 2048, 8 / 4 heads, D 256, window 1024 and global), MLA (B 4,
   S 512, 128 / 128 heads, D 192, Dv 128) and SeamlessM4T (B 4, S 512, 16 /
   16 heads, D 64: not causal, causal, and the cross-attention over 768
   keys); windows at D 32, 64, 112, 128 (not causal), 256 and with MLA, a
   window of 1, D 256 and MLA not causal with Sq != Skv; RMSNorm at d 3072
   and 128, N 2048, 5 and 1, and d 100), inputs untouched, two runs
   bit-equal, the forward's log-sum-exp against ``logsumexp``; the SSD scan's three
   backward kernels against the plain backward ``ssd_chunked_bwd_ref``
   within ``SSD_GRAD_REL`` of each gradient's largest value (Mamba-2's and
   Zamba2's B 4 x 512 shapes, a ragged S, an entering state with a
   final-state gradient, a shape off every tile, the narrow test shape;
   float32 and bf16), two runs bit-equal, the forward's ``STATES``
   instance bit-equal to the serving one; Phi-4-mini at full width
   and 2 layers, Mamba-2 130M whole and Zamba2 at full width and 7 layers
   (one superblock, one trailing layer) trained 2 float32 steps each
   (``CPU_GATE_STEPS``, cut from 3 for Phi-4-mini and Mamba-2) on
   the card and the CPU from the same parameters (losses, grad norms, each
   leaf's first gradient, parameters); a reduced Granite's
   resume on the card (restored tensors bit-equal, losses as straight
   through); 16 decode steps from an empty int8 KV cache on card and CPU;
   the whole Phi-4-mini (32 layers, bf16, remat) trained 8 steps through
   ``Trainer.run`` on B 4 x 512 tokens (launches per step exact: 64 flash
   forward, 32 dQ and 32 dK / dV, 129 RMSNorm forward and 65 backward; ms
   per step, the forward / backward / ``adamw_update`` split, busy share,
   peak memory, every loss finite), and so the whole Mamba-2 130M (per
   step 48 SSD forward, 24 of each SSD backward kernel, 49 / 25 RMSNorm)
   and Zamba2 at 27 of 81 layers (``ZAMBA2_LAYERS``; 54 SSD forward, 27 of
   each backward kernel, 8 flash forward at D 112, 4 dQ and 4 dK / dV, 71
   / 36 RMSNorm); Gemma 3 at full width and D 256 with 2 layers (one
   windowed, the window cut to 128; one global), DeepSeek-V2 at full width
   with 2 layers and 8 of its experts, SeamlessM4T at full width with 2 + 2
   layers, trained 2 float32 steps on the card and the CPU
   (``train_families_vs_cpu``, as ``train_vs_cpu``); the MoE backward at
   DeepSeek-V2's expert shape (``moe_grouped_bwd``: the grouped product's
   bf16 autograd against a float32 loop over the experts, the whole
   ``moe_block`` in bf16 under ``set_sync_debug_mode("error")`` against its
   float32 autograd, at the config's capacity and with three quarters
   dropped); the whole Gemma 3 4B on B 2 x 2048 tokens (68 flash forward,
   34 dQ and 34 dK / dV at D 256, 29 of each windowed; 137 / 69 RMSNorm),
   DeepSeek-V2 at full width and 2 of 60 layers (``DEEPSEEK_TRAIN_LAYERS``:
   the dense first layer and one MoE layer, 4.8e9 parameters; 4 flash
   forward, 2 dQ and 2 dK / dV at D 192 / Dv 128; 17 / 9 RMSNorm) and the
   whole SeamlessM4T (72 flash forward, 36 dQ and 36 dK / dV at D 64;
   122 / 62 RMSNorm) through ``train_model``; the backward kernels' times
   beside their bounds, the plain autograd's and the library's backward
   (cuDNN SDPA, a window as a boolean band mask; ``F.rms_norm``): flash
   attention's in bf16 (the ``wgmma`` kernels, on the training paths) at
   every training path's shape and in float32 (the scalar kernels, on
   ``train_vs_cpu``'s and ``train_families_vs_cpu``'s paths), named apart
   in the ``kernels`` line; the SSD backward's at Mamba-2's and Zamba2's
   shapes beside the plain backward (no PyTorch call computes it);
11. the paged KV gather (``kernels_vs_plain_kv_gather``,
   ``kernel_times_kv_gather``): the kernel bit-equal to its plain version
   at ``tests/test_kernels.py``'s sweep shapes in float32, bf16 and int32
   (int32 and int64 tables), at Phi-4-mini's serving shape (a pool of 512
   pages of 16 tokens x 2048 K|V values in bf16, 4 sequences of 512 tokens,
   a shuffled table with one id repeated) and on a pool that is not 16-byte
   aligned; an id out of range raises; the entry point
   ``repro_torch.kernels.kv_gather.kv_gather`` once at the serving shape,
   counted; its time, plain time, ``index_select`` time and bound at the
   serving shape. Then the paper's figures (``figures_smoke_vs_cpu``):
   every ``repro_torch.benchmarks`` module in ``--smoke`` mode on the card
   and on the CPU, each row equal on both and to the JAX package's rows in
   ``src/repro_torch/benchmarks/jax_rows.json``; and ``fig10_rob``, the
   default-mode Fig. 10 module on the card (3 x 720 cycles on the 4x4
   mesh, ``FIG10_CYCLES``, cut from 4 000: each run completes by cycle
   688), rows and footer equal to the JAX package's, ms per cycle;
11b. the batched sweep and the design-space exploration: the per-cycle
   arb, apply and offload arb kernels against their plain versions on
   random snapshots of B x C = 12 channels (``kernels_vs_plain_sweep``;
   8x4 mesh V = 1, 8x4 torus V = 2, the all-reduce's offload groups);
   ``sweep_8x4``: ``run_sweep`` on ``preset("mesh", big=True)`` over uniform
   1 / 4 / 16 / 32 kB x 4 DMA reads, B = 4 as one state, 600 cycles,
   router launches equal to one configuration's, each configuration's state
   equal to its own sequential run on the card and configuration 0's to
   the CPU's, batched and single ms per cycle and their ratio;
   ``dse_smoke``: ``run_dse(default_grid(smoke=True))`` on the card, the
   frontier artifact equal byte for byte to the JAX package's
   (``src/repro_torch/benchmarks/dse_smoke_jax.json``), wall seconds;
   ``ddp_demo``: ``noc_explore --workload ddp`` on the mesh (the gradient
   all-reduce of ``llama4-scout-17b-a16e`` reduced) through
   ``ml_traffic.validate_phase`` on the card, counted, equal to the CPU's;
12. one JSON line listing every kernel and mode (launches on its main
   path, mismatch, times, bounds; the flash kernel's MLA instance, D=192
   with Dv=128, and its D=64 instance (SeamlessM4T) rows of their own, and
   so the flash backward's two-warpgroup instances at D=256 (Gemma 3) and
   D=192 / Dv=128 (MLA) and its D=64 instance; the
   per-cycle kernels' rows also the
   launch floor: an empty kernel's time at the same grid, timed the same
   way in the same run; the unfused apply mode's rows its launches on the
   naive paths and the fused mode's time beside its own).

Each main path runs with the launch counts set to 0 just before it and
checked just after.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero; it exits non-zero without a CUDA device too.
Needs one card and the CUDA toolkit; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate, and the float32 rate outside
# the tensor cores, used as the ceiling for 32-bit scalar integer operations
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

# stats() of the 4x2 mesh mixed uniform run, 1200 cycles (the JAX package's
# golden pins in tests/test_noc_channels.py)
GOLDEN = {
    "beats_rcvd": [64, 64, 64, 64, 64, 64, 64, 64, 0, 0],
    "dma_done": [4, 4, 4, 4, 4, 4, 4, 4, 0, 0],
    "narrow_lat_cnt": [58, 59, 59, 58, 58, 59, 59, 58],
    "narrow_lat_sum": [1574.0, 1498.0, 1500.0, 1529.0, 1600.0, 1496.0,
                       1513.0, 1625.0, 0.0, 0.0],
    "n_sent": [60, 60, 60, 60, 60, 60, 60, 60, 0, 0],
    "ni_stalls": [118, 73, 93, 99, 143, 120, 81, 181, 0, 0],
    "last_rx": [164, 128, 192, 143, 179, 164, 170, 202, 0, 0],
    "first_rx": [40, 18, 26, 22, 44, 22, 22, 40, -1, -1],
}


def check(cond, what):
    """Fail the run (non-zero exit) unless ``cond`` holds."""
    if not cond:
        raise AssertionError(what)


_T0 = time.perf_counter()


def phase(name, **fields):
    """One line of the phase's results, with the seconds since the script
    started."""
    fields["elapsed_s"] = round(time.perf_counter() - _T0, 1)
    print(f"[{name}] " + json.dumps(fields, default=float), flush=True)


# ---------------------------------------------------------------------------
# inputs


def random_snapshot(rng, tables, C, depth):
    """Random consistent channel-batched state on the given tables: counts
    within depth, stale dead slots, locked and free wormholes, full
    buffers, destinations past the table."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import F_DST, F_LAST, NF

    R, E = tables.route.shape
    P = tables.port_ep.shape[1]
    s = (C, R, P)

    def flits():
        f = rng.integers(-50, 50, s + (depth, NF)).astype(np.int32)
        f[..., F_DST] = rng.integers(-2, E + 2, s + (depth,))
        f[..., F_LAST] = rng.integers(0, 2, s + (depth,))
        return f

    wh = rng.integers(-1, P, s).astype(np.int32)
    wh[rng.random(s) < 0.5] = -1
    return dict(in_buf=flits(), in_cnt=rng.integers(0, depth + 1, s),
                out_buf=flits(), out_cnt=rng.integers(0, depth + 1, s),
                rr_ptr=rng.integers(0, P, s), wh_lock=wh,
                ep_space=rng.random((C, E)) < 0.7)


def synthetic_tables(rng, R, E, ports, V, dev):
    """Random routing and wiring tables of ``ports`` physical ports at
    ``n_vcs=V``, for slot counts no topology of the port reaches (32):
    routes biased to port 0, links missing on 30% of the ports, unique
    endpoint attach slots with ``port_ep`` their inverse, a random
    dateline table."""
    import numpy as np
    import torch

    route = rng.integers(0, ports, (R, E))
    route[:, : E // 3] = 0

    def links():
        t = np.stack([rng.integers(0, R, (R, ports)), rng.integers(0, ports, (R, ports))], -1)
        t[rng.random((R, ports)) < 0.3] = -1
        return t

    at = rng.permutation(R * ports)[:E]
    ep_attach = np.stack([at // ports, at % ports * V], -1)
    port_ep = np.full((R, ports * V), -1)
    port_ep[ep_attach[:, 0], ep_attach[:, 1]] = np.arange(E)
    i32 = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)
    vc_out = rng.integers(0, V, (R, ports * V, ports)) if V > 1 else None
    return SimpleNamespace(route=i32(route), link_src=i32(links()), link_dst=i32(links()),
                           port_ep=i32(port_ep), ep_attach=i32(ep_attach), n_vcs=V,
                           vc_out=None if vc_out is None else i32(vc_out))


def to_device(d, dev):
    import numpy as np
    import torch

    return {k: torch.as_tensor(v if v.dtype == bool else v.astype(np.int32),
                               device=dev) for k, v in d.items()}


def mesh_workload(TT, topo, transfer_kb, narrow_rate):
    """Uniform DMA reads plus uniform narrow requests on every tile."""
    import numpy as np

    wl = TT.dma_workload(topo, "uniform", transfer_kb=transfer_kb, n_txns=4)
    if narrow_rate:
        E, nt = topo.n_endpoints, topo.meta["n_tiles"]
        nr = np.zeros((E,), np.float32)
        nr[:nt] = narrow_rate
        nd = np.full((E,), -1, np.int32)
        nd[:nt] = -2
        wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    return wl


# ---------------------------------------------------------------------------
# the kernels against their plain version


def max_abs_err(want, got):
    """Largest |difference| over matching tensors (0 when bit-identical)."""
    err = 0
    for a, b in zip(want, got):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def compare_kernels(snap, tables, seen=None):
    """Each kernel and the whole cycle against the plain version, on the
    card, in the tables' VC mode: ``{"arb": err, "apply": err, "cycle":
    err, "apply_unfused": err, "cycle_unfused": err}`` (the apply kernel
    in both FIFO modes; the unfused mode also checked to leave its inputs
    as they were). ``seen`` (a dict, if given) counts the cases and those
    on which the unfused result differs from the fused one (the modes
    really differ there)."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    s, t = snap, tables
    vc = dict(vc_out=t.vc_out, n_vcs=t.n_vcs)
    depth_out = s["out_buf"].shape[-2]
    arb_args = (s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                s["wh_lock"], t.route)
    arb_k = K.arb_cuda(*arb_args, depth_out=depth_out, **vc)
    arb_p = ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)
    app_args = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"])
    tab = (t.link_src, t.link_dst, t.port_ep, s["ep_space"])
    app_k = K.apply_cuda(*app_args, arb_p, *tab, n_vcs=t.n_vcs)
    app_p = ref.apply_phase(*app_args, arb_p, *tab, fused=True, n_vcs=t.n_vcs)
    cyc_args = (*app_args, s["rr_ptr"], s["wh_lock"], t.route, t.link_src,
                t.link_dst, t.port_ep, t.ep_attach, s["ep_space"])
    cyc_k = K.router_cycle_cuda(*cyc_args, **vc)
    cyc_p = ref.router_cycle_reference(*cyc_args, fused=True, **vc)
    inputs = [*app_args, *arb_p, *tab]
    before = [a.clone() for a in inputs]
    unf_k = K.apply_cuda(*app_args, arb_p, *tab, n_vcs=t.n_vcs, fused=False)
    unf_p = ref.apply_phase(*app_args, arb_p, *tab, fused=False, n_vcs=t.n_vcs)
    ucyc_k = K.router_cycle_cuda(*cyc_args, **vc, fused=False)
    ucyc_p = ref.router_cycle_reference(*cyc_args, fused=False, **vc)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(before, inputs)),
          "the unfused apply kernel modified its inputs")
    if seen is not None:
        seen["cases"] += 1
        seen["differs_from_fused"] += any(
            not torch.equal(a, b) for a, b in zip(app_p, unf_p))
    return {"arb": max_abs_err(arb_p, arb_k),
            "apply": max_abs_err(app_p, app_k),
            "cycle": max_abs_err(cyc_p, cyc_k),
            "apply_unfused": max_abs_err(unf_p, unf_k),
            "cycle_unfused": max_abs_err(ucyc_p, ucyc_k)}


def random_egress(rng, C, E, Q, cycle0, N):
    """Random circular egress queues: counts 0..Q (empty and full), heads
    anywhere, ready stamps before, inside and after the window."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import F_DST, NF

    eg = rng.integers(-50, 50, (C, E, Q, NF)).astype(np.int32)
    eg[..., F_DST] = rng.integers(0, E, (C, E, Q))
    return dict(eg=eg,
                eg_ready=rng.integers(cycle0 - 3, cycle0 + N + 3, (C, E, Q)),
                eg_head=rng.integers(0, Q, (C, E)),
                eg_cnt=rng.integers(0, Q + 1, (C, E)))


STATE = ("in_buf", "in_cnt", "out_buf", "out_cnt", "rr_ptr", "wh_lock")
EGRESS = ("eg", "eg_ready", "eg_head", "eg_cnt")


def fused_args(state, egress, tables, ep_space, cycle0, N):
    """Positional arguments of ``router_cycles_fused_cuda`` and the plain
    ``router_cycles_scan``."""
    t = tables
    return (*(state[k] for k in STATE), *(egress[k] for k in EGRESS),
            t.route, t.link_src, t.link_dst, t.port_ep, t.ep_attach, ep_space,
            cycle0, N)


def compare_fused(snap, egress, tables, cycle0, N):
    """One launch of the fused window (as the wrapper plans it) against N
    plain cycles on the card; also checks that the kernel leaves its inputs
    as they were."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    args = fused_args(snap, egress, tables, snap["ep_space"], cycle0, N)
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    before = [a.clone() for a in args[:10]]
    got = K.router_cycles_fused_cuda(*args, **vc)
    want = ref.router_cycles_scan(*args, **vc)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(before, args)),
          "the fused kernel modified its inputs")
    return max_abs_err(want, got)


def random_offload(rng, snap, tables):
    """Random reduction-ALU state for a numpy snapshot on offload tables,
    whose input heads it turns into group-addressed multicast and
    reduction heads in part (in place). Full ALU slots and unlocked parent
    slots are made common, so emissions, shared parents and contested
    ports occur."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import (
        A_CNT, F_DST, F_KIND, KIND_MC, KIND_RED, NRED)

    C, R, P = snap["in_cnt"].shape
    E = tables.route.shape[1]
    G = tables.n_groups
    need = tables.red_need.cpu().numpy()
    parent = tables.red_parent.cpu().numpy()
    heads = snap["in_buf"][..., 0, :]
    roll = rng.random((C, R, P))
    heads[..., F_KIND] = np.where(roll < 0.3, KIND_MC,
                                  np.where(roll < 0.6, KIND_RED,
                                           heads[..., F_KIND]))
    heads[..., F_DST] = np.where(roll < 0.65,
                                 E + rng.integers(0, 2 * G + 1, roll.shape),
                                 heads[..., F_DST])
    acc = rng.integers(-9, 9, (C, R, G, NRED)).astype(np.int32)
    acc[..., A_CNT] = np.where(rng.random((C, R, G)) < 0.7,
                               need + rng.integers(0, 2, (C, R, G)),
                               rng.integers(0, 4, (C, R, G)))
    for c in range(C):
        r, g = np.nonzero((rng.random((R, G)) < 0.6) & (parent >= 0))
        snap["wh_lock"][c, r, parent[r, g]] = -1
    return dict(red_acc=acc, red_got=rng.random((C, R, G, P)) < 0.3)


def offload_cases(snap, red, tables, granted):
    """How often a snapshot reaches the offload cases that matter,
    recomputed in numpy: ports two can-emit groups want (shared parent),
    emissions onto a port some head requests (contested), and ports where
    a multicast win was cancelled (a head eligible, nothing granted)."""
    import numpy as np

    from repro_torch.kernels.noc_router.ref import (
        A_CNT, F_DST, F_KIND, KIND_MC, KIND_RED)

    s = {k: v.cpu().numpy() for k, v in snap.items()}
    tb = {k: getattr(tables, k).cpu().numpy() for k in
          ("route", "fork_out", "red_parent", "red_need")}
    C, R, P = s["in_cnt"].shape
    E, G, V = tb["route"].shape[1], tables.n_groups, tables.n_vcs
    dout = s["out_buf"].shape[-2]
    h = s["in_buf"][..., 0, :]
    valid = s["in_cnt"] > 0
    is_mc = valid & (h[..., F_KIND] == KIND_MC)
    uni = valid & ~is_mc & (h[..., F_KIND] != KIND_RED)
    g_of = np.clip(h[..., F_DST] - E, 0, G - 1)
    need, par = tb["red_need"], tb["red_parent"]
    full = (need > 0) & (red["red_acc"].cpu().numpy()[..., A_CNT] >= need)
    pc = np.broadcast_to(np.clip(par, 0, P - 1), (C, R, G))
    can = (full & (par >= 0)
           & np.take_along_axis(s["out_cnt"] < dout, pc, -1)
           & (np.take_along_axis(s["wh_lock"], pc, -1) < 0))
    wants = (pc[..., None] == np.arange(P)) & can[..., None]
    emit_port = wants.any(-2)
    r_idx = np.arange(R)[:, None]
    port = tb["route"][r_idx, np.clip(h[..., F_DST], 0, E - 1)]
    if V > 1:
        vc_out = tables.vc_out.cpu().numpy()
        port = port * V + vc_out[r_idx, np.arange(P),
                                 np.clip(port, 0, P // V - 1)]
    req = ((uni[..., None] & (port[..., None] == np.arange(P)))
           | (is_mc[..., None] & tb["fork_out"][r_idx, g_of]))
    lock = s["wh_lock"][..., None, :]
    elig = (req & ((lock < 0) | (lock == np.arange(P)[:, None]))
            & (s["out_cnt"] < dout)[..., None, :] & ~emit_port[..., None, :])
    return {"shared_parent": int((wants.sum(-2) >= 2).sum()),
            "contested_emission": int((emit_port & req.any(-2)).sum()),
            "cancelled_mc_win": int((elig.any(-2)
                                     & ~granted.cpu().numpy()).sum())}


def compare_offload(snap, red, tables):
    """The offload arb kernel and the offload cycle (offload arb + apply)
    against the plain version on the card; checks that the kernels leave
    their inputs as they were. Returns ``({"arb": err, "cycle": err},
    the cases reached)``."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    s, t = snap, tables
    E = t.route.shape[1]
    off = dict(fork_out=t.fork_out, red_parent=t.red_parent,
               red_need=t.red_need, red_acc=red["red_acc"],
               red_got=red["red_got"], n_endpoints=E, vc_out=t.vc_out,
               n_vcs=t.n_vcs)
    depth_out = s["out_buf"].shape[-2]
    arb_args = (s["in_buf"], s["in_cnt"], s["out_cnt"], s["rr_ptr"],
                s["wh_lock"], t.route)
    inputs = [*s.values(), *red.values()]
    before = [a.clone() for a in inputs]
    arb_k, acc_k, got_k = K.arb_offload_cuda(*arb_args, depth_out=depth_out,
                                             **off)
    arb_p, acc_p, got_p = ref.offload_decisions(*arb_args,
                                                depth_out=depth_out, **off)
    cyc = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"], s["rr_ptr"],
           s["wh_lock"], t.route, t.link_src, t.link_dst, t.port_ep,
           t.ep_attach, s["ep_space"])
    cyc_k = K.router_cycle_offload_cuda(*cyc, **off)
    cyc_p = ref.router_cycle_offload_reference(
        *cyc[:6], red["red_acc"], red["red_got"], *cyc[6:11], t.fork_out,
        t.red_parent, t.red_need, s["ep_space"], n_endpoints=E, fused=True,
        vc_out=t.vc_out, n_vcs=t.n_vcs)
    # the unfused apply mode on the offload arb kernel's decisions, and the
    # naive offload cycle
    app = (s["in_buf"], s["in_cnt"], s["out_buf"], s["out_cnt"])
    tab = (t.link_src, t.link_dst, t.port_ep, s["ep_space"])
    unf_k = K.apply_cuda(*app, arb_k, *tab, n_vcs=t.n_vcs, fused=False)
    unf_p = ref.apply_phase(*app, arb_p, *tab, fused=False, n_vcs=t.n_vcs)
    ucyc_k = K.router_cycle_offload_cuda(*cyc, **off, fused=False)
    ucyc_p = ref.router_cycle_offload_reference(
        *cyc[:6], red["red_acc"], red["red_got"], *cyc[6:11], t.fork_out,
        t.red_parent, t.red_need, s["ep_space"], n_endpoints=E, fused=False,
        vc_out=t.vc_out, n_vcs=t.n_vcs)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(before, inputs)),
          "the offload kernels modified their inputs")
    errs = {"arb": max_abs_err((*arb_p, acc_p, got_p), (*arb_k, acc_k, got_k)),
            "cycle": max_abs_err(cyc_p, cyc_k),
            "apply_unfused": max_abs_err(unf_p, unf_k),
            "cycle_unfused": max_abs_err(ucyc_p, ucyc_k)}
    return errs, offload_cases(s, red, t, arb_p.granted)


def graph_ms(fn, reps=50, rounds=7):
    """Device time of one ``fn()`` call: ``reps`` calls captured into a CUDA
    graph, replayed back to back, timed with CUDA events; median over
    ``rounds`` replays."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm up the allocator outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def eager_ms(fn, reps=200):
    """Wall time of one eager ``fn()`` call from Python, launch overhead
    included (CUDA events around a loop, after a warm-up)."""
    import torch

    for _ in range(5):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# an empty kernel behind a C launcher: the launch floor of a grid
EMPTY_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""
_EMPTY = []  # the loaded probe library, once built


def build_empty_kernel():
    """Compile the launch-floor probe (not part of the port) with the
    kernels' ``nvcc`` flags and load it; the library outlives its
    temporary directory."""
    import ctypes

    from repro_torch.kernels.build import NVCC_FLAGS, nvcc

    with tempfile.TemporaryDirectory() as tmp:
        src, so = Path(tmp) / "empty.cu", Path(tmp) / "empty.so"
        src.write_text(EMPTY_KERNEL)
        subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(so), str(src)], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(str(so))
    lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    _EMPTY[:] = [lib]


def launch_floor_ms(blocks, threads=128):
    """Device time of an empty kernel launched at this grid, timed as the
    kernels are (``graph_ms``): the least a launch of that grid costs."""
    import torch

    if not _EMPTY:
        build_empty_kernel()
    lib = _EMPTY[0]

    def launch():
        err = lib.empty_launch(blocks, threads, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty kernel launch failed: CUDA error {err}")

    return graph_ms(launch)


def arb_blocks(C, R, P):
    """CTAs of a per-cycle arbitration or apply launch (``arb_blocks`` in
    the source): 32 // P routers a warp, four warps of 32 lanes a CTA."""
    warps = -(-C * R // (32 // P))
    return -(-warps * 32 // 128)


def kernel_bytes(st, tables, ep_space):
    """Bytes each per-cycle kernel must move on this state, each input read
    once and each output written once. The arb phase reads only the input
    heads and the route (and, with VCs, ``vc_out``) entries of the heads
    that are live; the link tables are physical."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    E = ep_space.shape[-1]
    V = tables.n_vcs
    n = C * R * P
    live_heads = int((st.in_cnt > 0).sum())
    arb = (n * NF * 4 + 4 * n * 4 + live_heads * 4 * (1 if V == 1 else 2)
           + 3 * n + n * NF * 4 + 2 * n * 4)  # pop/grant/space, chosen, rr/wh
    apply = (2 * n * (Din + Dout) * NF * 4  # both buffers read + rewritten
             + 4 * n * 4  # counts in and out
             + 3 * n + n * NF * 4  # arb scratch
             + R * (P // V) * 2 * 4 * 2 + R * P * 4 + C * E)  # tables, ep_space
    return {"arb": arb, "apply": apply}


def kernel_ops(st):
    """Scalar integer operations of each per-cycle kernel (counted
    generously): the arb lanes score P inputs for each of P outputs, the
    apply lane moves (Din + Dout) * NF words."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    return {"arb": C * R * (P * P * 12 + P * (NF + 12)),
            "apply": C * R * P * ((Din + Dout) * NF * 3 + 40)}


def fused_bytes(st, egress, tables, N):
    """Bytes of one fused window: state, queues and tables read once, state
    and the per-cycle outputs written once."""
    C, R, P, Din, NF = st.in_buf.shape
    Dout = st.out_buf.shape[3]
    _, E, Q, _ = egress["eg"].shape
    Pp = P // tables.n_vcs
    state = C * R * P * ((Din + Dout) * NF + 4) * 4
    queues = C * E * (Q * (NF + 1) + 2) * 4
    table = (R * E + R * Pp * 4 + R * P + E * 2) * 4 + C * E
    if tables.vc_out is not None:
        table += R * P * Pp * 4
    per_cycle = C * N * E * (NF * 4 + 2)
    return 2 * (state + queues) + table + per_cycle


def bound(nbytes, nops, ops_per_s=SCALAR_OPS_PER_S):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_kernels(st, tables, ep_space):
    """Per-cycle kernel and plain-version times on one state (device time
    per call), plus the least time the card could take."""
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    depth_out = st.out_buf.shape[-2]
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    arb_args = (st.in_buf, st.in_cnt, st.out_cnt, st.rr_ptr, st.wh_lock,
                tables.route)
    arb = ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)
    app_args = (st.in_buf, st.in_cnt, st.out_buf, st.out_cnt, arb,
                tables.link_src, tables.link_dst, tables.port_ep, ep_space)
    V = tables.n_vcs
    saved = dict(K.LAUNCHES)
    out = {
        "arb": {"ms": graph_ms(lambda: K.arb_cuda(*arb_args, depth_out=depth_out, **vc)),
                "plain_ms": graph_ms(lambda: ref.arb_decisions(*arb_args, depth_out=depth_out, **vc)),
                "eager_ms": eager_ms(lambda: K.arb_cuda(*arb_args, depth_out=depth_out, **vc))},
        "apply": {"ms": graph_ms(lambda: K.apply_cuda(*app_args, n_vcs=V)),
                  "plain_ms": graph_ms(lambda: ref.apply_phase(*app_args, fused=True, n_vcs=V)),
                  "eager_ms": eager_ms(lambda: K.apply_cuda(*app_args, n_vcs=V))},
        "apply_unfused": {
            "ms": graph_ms(lambda: K.apply_cuda(*app_args, n_vcs=V, fused=False)),
            "plain_ms": graph_ms(lambda: ref.apply_phase(*app_args, fused=False, n_vcs=V)),
            "eager_ms": eager_ms(lambda: K.apply_cuda(*app_args, n_vcs=V, fused=False))},
    }
    K.LAUNCHES.update(saved)  # timing launches are not main-path launches
    C, R, P = st.in_cnt.shape
    floor = launch_floor_ms(arb_blocks(C, R, P))  # the kernels' one grid
    for v in out.values():
        v["launch_floor_ms"] = floor
    out["apply_unfused"]["fused_mode_ms"] = out["apply"]["ms"]
    nbytes, nops = kernel_bytes(st, tables, ep_space), kernel_ops(st)
    # the unfused mode moves the same rows as the fused one
    nbytes["apply_unfused"], nops["apply_unfused"] = nbytes["apply"], nops["apply"]
    for k, v in out.items():
        b_ms, b_by = bound(nbytes[k], nops[k])
        v.update(bytes=nbytes[k], ops=nops[k], bound_ms=b_ms, bound_by=b_by)
    return out


def fused_kernel_name(plan):
    """The CUDA kernel a fused plan runs."""
    return ("noc_fused_cluster_kernel" if plan.kernel == "cluster"
            else "noc_fused_global_kernel")


def plan_fields(plan):
    """A fused plan's fields for a phase line (the cluster kernel's layout
    is ping-pong: PERF.md, PR 19)."""
    return {"kernel": fused_kernel_name(plan), "cluster": plan.cluster,
            "smem_bytes_per_cta": plan.smem_bytes,
            "layout": "pingpong" if plan.kernel == "cluster" else "global",
            "threads": plan.threads, "slots_per_thread": plan.slots_per_thread}


def time_fused(st, eps, tables, ep_space, cycle0, pair, N=4):
    """Device time of one fused window of N cycles (the main path's k) on
    a simulator state, its plan, its plain version's time, the
    global-memory kernel's time on the same state, and the bound; per launch
    and per simulated cycle, beside the per-cycle arb + apply pair's time
    at the same shape (``pair``: ``time_kernels`` of this run)."""
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    state = {k: getattr(st, k) for k in STATE}
    egress = {k: getattr(eps, k) for k in EGRESS}
    args = fused_args(state, egress, tables, ep_space, cycle0, N)
    vc = dict(vc_out=tables.vc_out, n_vcs=tables.n_vcs)
    C, R, P, Din = st.in_buf.shape[:4]
    plan = K.fused_plan(R, P, Din, st.out_buf.shape[3], tables.n_vcs)
    saved = dict(K.LAUNCHES)
    ms = graph_ms(lambda: K.router_cycles_fused_cuda(*args, **vc), reps=20)
    plain = graph_ms(lambda: ref.router_cycles_scan(*args, **vc), reps=5)
    eager = eager_ms(lambda: K.router_cycles_fused_cuda(*args, **vc), reps=50)
    global_ms = graph_ms(
        lambda: K.router_cycles_fused_cuda(*args, **vc, plan=K.global_plan(R)),
        reps=5)
    K.LAUNCHES.update(saved)
    nbytes = fused_bytes(st, egress, tables, N)
    nops = N * sum(kernel_ops(st).values())
    b_ms, b_by = bound(nbytes, nops)
    pair_ms = pair["arb"]["ms"] + pair["apply"]["ms"]
    return {"n_cycles": N, "ms": ms, "plain_ms": plain, "eager_ms": eager,
            "ms_per_cycle": ms / N, "per_cycle_pair_ms": pair_ms,
            "beats_pair": ms / N < pair_ms, "global_kernel_ms": global_ms,
            **plan_fields(plan), "bytes": nbytes, "ops": nops,
            "bound_ms": b_ms, "bound_by": b_by}


def offload_bytes(st, tables):
    """Bytes the offload arb kernel must move on this state, each input
    read once and each output written once: the input heads, counters,
    pointers and locks; the route (and ``vc_out``) entries of the live
    unicast heads and the fork rows of the live multicast heads; the
    group tables and the ALU state in; the decisions and the ALU state
    out."""
    from repro_torch.kernels.noc_router.ref import F_KIND, KIND_MC, KIND_RED

    C, R, P, Din, NF = st.in_buf.shape
    G = tables.n_groups
    n = C * R * P
    heads = st.in_buf[..., 0, :]
    live = st.in_cnt > 0
    mc = int((live & (heads[..., F_KIND] == KIND_MC)).sum())
    uni = int((live & (heads[..., F_KIND] != KIND_MC)
               & (heads[..., F_KIND] != KIND_RED)).sum())
    alu = C * R * G * (st.red_acc.shape[-1] * 4 + P)  # red_acc + red_got
    reads = (n * NF * 4 + 4 * n * 4 + uni * 4 * (1 if tables.n_vcs == 1 else 2)
             + mc * P + R * G * 8 + alu)
    writes = 3 * n + n * NF * 4 + 2 * n * 4 + alu
    return reads + writes


def time_offload(st, tables):
    """Device time of one offload arb launch and of its plain version on
    a simulator state (CUDA graph, median of 7), plus the least time the
    card could take."""
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.noc_router import ref

    C, R, P = st.in_cnt.shape
    args = (st.in_buf, st.in_cnt, st.out_cnt, st.rr_ptr, st.wh_lock,
            tables.route)
    kw = dict(depth_out=st.out_buf.shape[-2], fork_out=tables.fork_out,
              red_parent=tables.red_parent, red_need=tables.red_need,
              red_acc=st.red_acc, red_got=st.red_got,
              n_endpoints=tables.route.shape[1], vc_out=tables.vc_out,
              n_vcs=tables.n_vcs)
    saved = dict(K.LAUNCHES)
    out = {"ms": graph_ms(lambda: K.arb_offload_cuda(*args, **kw)),
           "plain_ms": graph_ms(lambda: ref.offload_decisions(*args, **kw)),
           "eager_ms": eager_ms(lambda: K.arb_offload_cuda(*args, **kw)),
           "launch_floor_ms": launch_floor_ms(arb_blocks(C, R, P))}
    K.LAUNCHES.update(saved)  # timing launches are not main-path launches
    nbytes = offload_bytes(st, tables)
    nops = C * R * (P * P * 12 + P * (st.in_buf.shape[-1] + 12)
                    + tables.n_groups * P * 12)
    b_ms, b_by = bound(nbytes, nops)
    out.update(bytes=nbytes, ops=nops, bound_ms=b_ms, bound_by=b_by)
    return out


def layer_times(eng, sim, st, n=100):
    """Host-clock ms of one router cycle alone and of one whole step on the
    card (each over ``n`` calls from state ``st``, synchronised at the
    end); the endpoint phases take the difference. Per-cycle steps only."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K

    saved = dict(K.LAUNCHES)
    space = torch.ones((sim.params.n_channels, sim.topo.n_endpoints),
                       dtype=torch.bool, device=sim.device)
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.fabric_cycle(st.fabric, sim.tables, space,
                             fused_fifo=sim.params.fast)
        torch.cuda.synchronize()
        fabric_ms = (time.perf_counter() - t0) / n * 1e3
        c0, s = int(st.cycle), st
        t0 = time.perf_counter()
        for i in range(n):
            s, _ = sim.step(s, c0 + i)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n * 1e3
    K.LAUNCHES.update(saved)
    return {"step_ms": step_ms, "router_cycle_ms": fabric_ms,
            "endpoint_phases_ms": step_ms - fabric_ms}


def device_profile(sim, st, step_ms, n=20):
    """Device activity of ``n`` (super-)steps under ``torch.profiler``:
    kernels per simulated cycle, device time per cycle, the busy share of
    an unprofiled step (``step_ms`` per simulated cycle) and the kernels
    that take most device time. ``None`` where the profiler reports no
    device activity."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.noc_router import noc_router as K

    saved = dict(K.LAUNCHES)
    cyc, s = int(st.cycle), st
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            s, _, k = sim._advance(s, cyc)
            cyc += k
        torch.cuda.synchronize()
    K.LAUNCHES.update(saved)
    cycles = cyc - int(st.cycle)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return {"device_events": 0, "busy_share": None}
    by_name = collections.Counter()
    for e in dev:
        by_name[e.name[:60]] += e.time_range.elapsed_us()
    dev_us = sum(by_name.values()) / cycles
    return {"device_events_per_cycle": len(dev) / cycles,
            "device_us_per_cycle": dev_us,
            "busy_share": dev_us / (step_ms * 1e3),
            "top_us_per_cycle": {k: v / cycles for k, v in by_name.most_common(6)}}


# ---------------------------------------------------------------------------
# the main path


def states_equal(a, b):
    """Leaf-for-leaf equality of two port SimStates: the differing leaves."""
    import numpy as np

    from repro_torch import convert

    na, nb = convert.sim_state_to_numpy(a), convert.sim_state_to_numpy(b)
    check(set(na) == set(nb), "state leaves differ")
    return [k for k in na if na[k].dtype != nb[k].dtype
            or not np.array_equal(na[k], nb[k])]


def naive_vs_fast(TS, name, naive, cpu_state, fast):
    """A naive card run (``(sim, state)``) held against the same run on the
    CPU leaf for leaf, and against the fast cell's card run (``(sim,
    state)``) under ``canonical_state(scrub=True)``; raises on a
    difference."""
    bad = states_equal(naive[1], cpu_state)
    check(not bad, f"{name} GPU state differs from CPU state in {bad}")
    bad = states_equal(TS.canonical_state(*naive, scrub=True),
                       TS.canonical_state(*fast, scrub=True))
    check(not bad, f"{name} canonical state differs from the fast run's in {bad}")
    check(not naive[1].eps.eg_head.any() and not naive[1].eps.mq_head.any(),
          f"{name}: a naive queue's head left slot 0")


def expected_launches(params, n):
    """Launches of each kernel and mode that ``n`` cycles must make: one
    arb (the offload arb under ``collective_offload``) and one apply per
    cycle (the unfused mode on the naive step), or one fused window per
    ``fused_cycles``, in the params' VC mode, and none of any other."""
    from repro_torch.kernels.noc_router import noc_router as K

    want = dict.fromkeys(K.LAUNCHES, 0)
    k, V = params.fused_cycles, params.n_vcs
    if k == 1:
        arb = "arb_offload" if params.collective_offload else "arb"
        want.update({K.mode(arb, V): n, K.mode(K.apply_mode(params.fast), V): n})
    else:
        want[K.mode("fused", V)] = n // k
    return want


def run_counted(TS, sim, n, state=None):
    """``TS.run`` on the card with the launch counts set to 0 just before
    and read just after, held against ``expected_launches``."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K

    torch.cuda.synchronize()
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    t0 = time.perf_counter()
    st = TS.run(sim, n, state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    want = expected_launches(sim.params, n)
    check(launches == want, f"expected launches {want}, got {launches}")
    return st, dt, launches


def offload_run(name, otopo, V, sched, n, mid, done_at=None, step_impl="fast", uncut=None):
    """One offloaded collective on the card through ``build_sim`` /
    ``run`` (two counted runs: ``mid`` cycles, then the rest), held
    against the same run on the CPU; with ``done_at`` also the
    exactly-once delivery and the completion cycle; with ``uncut`` (the
    horizon ``n`` was cut from) its seconds noted in ``CUTS``. Returns the
    state at ``mid``, the sim, the launch counts and the final state."""
    import numpy as np
    import torch

    from repro_torch.core.noc import collective_traffic as CT
    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc.params import NocParams

    op = NocParams(collective_offload=True, n_vcs=V, step_impl=step_impl)
    owl = CT.to_workload(otopo, sched)
    groups = sched.meta["groups"]
    osim = TS.build_sim(otopo, op, owl, groups=groups)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    st_mid, dt1, l1 = run_counted(TS, osim, mid)
    st, dt2, l2 = run_counted(TS, osim, n - mid, st_mid)
    peak_ = torch.cuda.max_memory_allocated()
    launches = {k: l1[k] + l2[k] for k in l1}
    csim = TS.build_sim(otopo, op, owl, groups=groups, device="cpu")
    t0 = time.perf_counter()
    cst = TS.run(csim, n)
    dt_cpu = time.perf_counter() - t0
    bad = states_equal(st, cst)
    check(not bad, f"{name} GPU state differs from CPU state in {bad}")
    out = TS.stats(osim, st)
    done = CT.measured_cycles(out, otopo)
    cpu_done = CT.measured_cycles(TS.stats(csim, cst), otopo)
    exact = bool(np.array_equal(out["rx_bursts"], sched.expect_rx))
    if uncut:
        note_cut(name, dt1 + dt2 + dt_cpu, n, uncut)
    phase(name, cycles=n, n_vcs=V, groups=len(groups),
          beats=sched.meta["beats"], launches=launches,
          gpu_ms_per_cycle=(dt1 + dt2) / n * 1e3,
          cpu_ms_per_cycle=dt_cpu / n * 1e3, gpu_state_equals_cpu=True,
          completion_cycle=done, cpu_completion_cycle=cpu_done,
          analytical_cycles=CT.analytical_cycles(sched, op, otopo),
          rx_bursts_equal_expect_rx=exact,
          beats_rcvd=int(out["beats_rcvd"].sum()),
          beats_sent=int(out["beats_sent"].sum()), peak_device_bytes=peak_,
          peak_above_earlier_phases_bytes=peak_ - held)
    check(out["beats_sent"].sum() > 0, f"{name} moved no wide beats")
    if done_at is not None:
        check(exact, f"{name}: rx_bursts differ from expect_rx")
        check(done == cpu_done == done_at,
              f"{name} completes at {done} (CPU {cpu_done}), "
              f"expected {done_at}")
    return st_mid, osim, launches, st


def ring_workload(TT_epm, topo, beats=64):
    """Every tile of the 8x1 torus sends one write burst three hops east:
    the wrap ring's wormhole cycle (``tests/test_noc_vc.py``)."""
    import numpy as np

    E = topo.n_endpoints
    wl = TT_epm.idle_workload(E, n_tiles=E)
    dst = np.array([[(x + 3) % E] for x in range(E)], np.int32)
    return dataclasses.replace(wl, dma_dst=dst,
                               dma_txns=np.ones((E, 1), np.int32),
                               dma_beats=beats, dma_write=True)


def narrow_latency(TS, TT_epm, topo, src, dst, cycles=380, params=None):
    """Mean narrow round-trip latency src -> dst at zero load, on the card
    (``params``: default ``NocParams()``)."""
    import numpy as np

    E = topo.n_endpoints
    wl = TT_epm.idle_workload(E, n_tiles=topo.meta["n_tiles"])
    nr = np.zeros((E,), np.float32)
    nr[src] = 0.02
    nd = np.full((E,), -1, np.int32)
    nd[src] = dst
    wl = dataclasses.replace(wl, narrow_rate=nr, narrow_dst=nd)
    sim = TS.build_sim(topo, params or TS.NocParams(), wl)
    st, _, _ = run_counted(TS, sim, cycles)
    out = TS.stats(sim, st)
    check(out["narrow_lat_cnt"][src] > 5, "too few narrow round trips")
    return float(out["narrow_lat_mean"][src])


# ---------------------------------------------------------------------------
# the model stack: Phi-4-mini (dense GQA), Mamba-2 (SSM) and Zamba2 (hybrid)
# served through the flash-attention, RMSNorm and SSD kernels

# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12
# the horizon of super_8x4, torus_vc_8x4, torus_8x4 and naive_torus_vc_8x4,
# and the steps a simulator profile covers: cut from 1 200 cycles (to 600,
# then to 300 for the Gemma 3, DeepSeek-V2 and SeamlessM4T training phases)
# and 20 / 10 steps to pay for the training phases within the run's time
# limit; each run still moves wide and narrow traffic, its state equal to
# the CPU's
SUPER_CYCLES, SUPER_CYCLES_UNCUT = 300, 1200
PROFILE_STEPS, PROFILE_STEPS_UNCUT = 6, 20
# each turn of the k1 / k4 and fast / naive timing (k = 4 needs a multiple of 4)
TURN_CYCLES, TURN_CYCLES_UNCUT = 48, 100
# the 8x4 all-reduce runs' horizon (fast, torus at n_vcs=2, naive): cut from
# 1 000 cycles to pay for the training phases; each completes by 693
OFFLOAD_CYCLES, OFFLOAD_CYCLES_UNCUT = 720, 1000
# the offloaded tree multicast's horizon, cut from 450 for the same reason;
# it completes by 278
MULTICAST_CYCLES, MULTICAST_CYCLES_UNCUT = 300, 450
# the 32x32 all-reduce's horizon (its offload arb timed at cycle 100, as
# before the cut), cut from 200
BIG_OFFLOAD_CYCLES, BIG_OFFLOAD_CYCLES_UNCUT = 150, 200
# each of Fig. 10's three runs (the module's ``_completion``): cut from its
# 4 000 cycles, for the same reason; each completes by cycle 688, so its
# rows equal the 4 000-cycle rows
FIG10_CYCLES, FIG10_CYCLES_UNCUT = 720, 4000
# the float32 card-against-CPU gates of Phi-4-mini (``train_vs_cpu``) and
# Mamba-2 (``train_ssm_vs_cpu``): steps, cut from 3 for the same reason
# (every check still holds two steps: the losses and grad norms of each,
# every leaf's first gradient, the parameters after the last update)
CPU_GATE_STEPS, CPU_GATE_STEPS_UNCUT = 2, 3
# each cut cell's seconds in this run at its cut size, beside its uncut
# size and the seconds the cut saved, estimated in proportion to the size
# (for a profile, whose set-up does not shrink, an upper estimate)
CUTS = {}


def note_cut(name, seconds, size, uncut):
    """Record a cut cell's measured ``seconds`` at ``size`` (cut from
    ``uncut``) in ``CUTS``."""
    CUTS[name] = {"seconds": seconds, "size": size, "uncut_size": uncut,
                  "saved_estimate_s": seconds * (uncut / size - 1)}


def cut_profile(name, sim, st, step_ms, n):
    """``device_profile`` over ``n`` steps (``PROFILE_STEPS`` or half of it,
    cut from 20 or 10), its seconds noted in ``CUTS``."""
    t0 = time.perf_counter()
    out = device_profile(sim, st, step_ms, n=n)
    note_cut(name, time.perf_counter() - t0, n,
             PROFILE_STEPS_UNCUT * n // PROFILE_STEPS)
    return out


def cut_run(name, TS, sim, build_cpu):
    """The card's ``run_counted`` and the CPU's run of ``SUPER_CYCLES``
    (cut from ``SUPER_CYCLES_UNCUT``), their seconds noted in ``CUTS``.
    Returns (card state, card seconds, launches, CPU state)."""
    st, dt, launches = run_counted(TS, sim, SUPER_CYCLES)
    t0 = time.perf_counter()
    st_cpu = TS.run(build_cpu(), SUPER_CYCLES)
    note_cut(name, dt + time.perf_counter() - t0, SUPER_CYCLES, SUPER_CYCLES_UNCUT)
    return st, dt, launches, st_cpu


def timing_turns(name, TS, sims):
    """ms per cycle of each of ``sims`` run ``TURN_CYCLES`` from a fresh
    state, in turn (cut from ``TURN_CYCLES_UNCUT``; seconds in ``CUTS``)."""
    turns = []
    for s_ in sims:
        _, t_, _ = run_counted(TS, s_, TURN_CYCLES)
        turns.append(t_ / TURN_CYCLES * 1e3)
    note_cut(name, sum(turns) * TURN_CYCLES / 1e3, TURN_CYCLES, TURN_CYCLES_UNCUT)
    return turns


# kernel vs plain version (atol, rtol): float32 sums in another order
# (attention: exp and row sums of up to 520 keys); bf16 one output rounding,
# as tests/test_kernels.py
ATTN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (3e-2, 3e-2)}
RMS_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (3e-2, 3e-2)}
# SSD kernel vs plain: y and the final state are float32 for either input
# dtype, so both take the float32 tolerance of tests/test_kernels.py's SSD
# sweep (sums of up to Q * N products in another order, over up to 5 chunks;
# in bf16 the tensor-core kernel's float32 operands go in as two bf16 terms,
# ~16 bits each: tests/test_torch_ssd_tensorcore_numerics.py)
SSD_TOL = (1e-3, 1e-3)
# card vs CPU logits, both bf16: the two sides round bf16 at other places
# (cuBLAS vs the CPU's matrix products, the kernels vs the plain versions), a
# few bf16 ulps of logits of size ~5
LOGIT_TOL = 0.1
RMS_EPS = 1e-5
# RMSNorm widths of the serve paths beside Phi-4-mini's 3072: Mamba-2, Zamba2,
# Llama-4-Scout (and DeepSeek-V2's d_model), Gemma 3, DeepSeek-V2's q_norm
# and kv_norm, Qwen2-VL, SeamlessM4T
RMS_WIDTHS = (768, 3584, 5120, 2560, 1536, 512, 8192, 1024)
PHI4, MAMBA2, ZAMBA2 = "phi4-mini-3.8b", "mamba2-130m", "zamba2-7b"
GEMMA3 = "gemma3-4b"
LLAMA4 = "llama4-scout-17b-a16e"
# Llama-4-Scout served at full width, cut to 12 of its 48 layers: the whole
# model (~106.7 B parameters, ~213 GB in bf16) does not fit an 80 GB card;
# 12 layers of ~4.40 GB and the 2.07 GB embedding are ~55 GB
LLAMA4_LAYERS = 12
# DeepSeek-V2 served at full width, cut to 8 of its 60 layers (the dense first
# layer and 7 MoE layers: 2.867e10 parameters, 57.33 GB in bf16): the whole
# model (~235 B parameters, ~470 GB) does not fit an 80 GB card
DEEPSEEK = "deepseek-v2-236b"
DEEPSEEK_LAYERS = 8
DEEPSEEK_TRAIN_LAYERS = 2  # train_deepseek_v2: the dense first layer and one MoE layer
# Qwen2-VL served at full width, cut to 32 of its 80 layers (2.940e10
# parameters, 58.80 GB in bf16): the whole model (~71.5 B parameters, ~143
# GB) does not fit an 80 GB card. SeamlessM4T (0.750e9 parameters) is served
# whole
QWEN2VL, SEAMLESS = "qwen2-vl-72b", "seamless-m4t-medium"
QWEN2VL_LAYERS = 32
# an encoder-decoder's cache leaves of the encoder's length, written once by
# the prefill
CROSS_CACHE = ("ck", "cv", "enc_out")
# Zamba2 served at full width, cut to 27 of its 81 layers (4 superblocks of 6
# Mamba-2 layers with the shared attention after each, 3 trailing) to keep
# the whole run within its time limit once Gemma 3's phases were added
ZAMBA2_LAYERS = 27
# the routing rule of a MoE model, card against CPU: in float32 every token
# is routed alike in every layer; in bf16 a token may go to another expert
# only where its router margin (the k-th probability less the next, on the
# CPU) is below ROUTE_MARGIN in the first layer that differs, at most
# MAX_FLIP_SHARE of the positions may, and logits and tokens are compared
# at the positions routed alike
ROUTE_MARGIN = 1e-2
MAX_FLIP_SHARE = 0.05
# one MoE layer at full width in float32, card against CPU (capacity factor
# 0.25): sums of 5 120- and 8 192-term products in another order on outputs
# of size ~1 (TF32 off)
MOE_TOL = (1e-4, 1e-4)
# Llama-4-Scout card against CPU logits: float32 as LOGIT_TOL; bf16 wider
# than Phi-4-mini's: each layer also rounds the routed and the shared
# expert's SwiGLU products of 8 192 and the MoE sum to bf16, and on the CPU
# alone the bf16 logits of the 2-layer model lie up to ~0.09 from its
# float32 logits (of size up to ~7.3), so two bf16 runs may lie ~0.2 apart
MOE_LOGIT_TOL = {"float32": LOGIT_TOL, "bfloat16": 0.25}


def randn(rng, shape, dtype, dev):
    """Seeded normal numbers (numpy) as a ``dtype`` tensor on ``dev``."""
    import numpy as np
    import torch

    return torch.as_tensor(rng.standard_normal(shape, np.float32)).to(dev, dtype)


def close_err(got, want, tol):
    """(max |got - want|, every element within atol + rtol * |want|)."""
    atol, rtol = tol
    d = (got.float() - want.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * want.float().abs()).all())


def ssd_inputs(rng, B, S, H, P, N, dtype, dev, init=False):
    """The SSD sweep's input distributions (tests/test_kernels.py): x, dt
    (post-softplus; / 20 with an entering state, so that it survives the
    chunks), B, C, A_log, D, and the state (None unless ``init``)."""
    import torch
    import torch.nn.functional as F

    x = randn(rng, (B, S, H, P), dtype, dev) * 0.5
    dt = F.softplus(randn(rng, (B, S, H), torch.float32, dev)) / (20 if init else 1)
    Bv, Cv = (randn(rng, (B, S, N), dtype, dev) * 0.5 for _ in range(2))
    A_log = randn(rng, (H,), torch.float32, dev) * 0.2
    D = torch.ones(H, device=dev)
    s0 = randn(rng, (B, H, P, N), torch.float32, dev) if init else None
    return x, dt, Bv, Cv, A_log, D, s0


def compare_model_kernels(dev):
    """Flash attention, RMSNorm (both variants) and the SSD scan against
    their plain versions on the card, inputs checked untouched. Returns the
    max error of each kernel at the serve paths' shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
    from repro_torch.kernels.ssd import ssd as SK
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    rng = np.random.default_rng(14)
    edge_rng = np.random.default_rng(17)  # the edge cases', so rng's draws stay as they were
    llama4_rng = np.random.default_rng(19)  # Llama-4-Scout's shapes, likewise
    gemma_rng = np.random.default_rng(25)  # Gemma 3's shapes and the window cases, likewise
    mla_rng = np.random.default_rng(29)  # DeepSeek-V2's MLA shapes and widths, likewise
    vlm_rng = np.random.default_rng(35)  # Qwen2-VL's and SeamlessM4T's, likewise
    bf, f32 = "bfloat16", "float32"
    dt = {bf: torch.bfloat16, f32: torch.float32}
    # (label, B, Sq, H, KV, D, Dv, dtype, causal, Skv[, window])
    cases = [("path", 4, 512, 24, 8, 128, 128, bf, True, 512),
             ("zamba2_path", 4, 512, 32, 32, 112, 112, bf, True, 512),
             ("llama4_path", 4, 512, 40, 8, 128, 128, bf, True, 512)]
    for d_ in (f32, bf):
        cases += [("sweep", 1, 128, 2, 2, 64, 64, d_, True, 128),
                  ("sweep", 2, 256, 4, 2, 64, 64, d_, True, 256),
                  ("sweep_mqa", 1, 128, 8, 1, 32, 32, d_, True, 128),
                  ("ragged", 1, 520, 24, 8, 128, 128, d_, True, 520),
                  ("dv_ne_d", 2, 200, 4, 2, 128, 64, d_, True, 200),
                  ("d112_ragged", 2, 130, 4, 2, 112, 112, d_, True, 130)]
        # partial and single-row tiles
        cases += [("edge_s", 2, S, 4, 2, 64, 64, d_, True, S) for S in (1, 63, 64, 65, 129)]
    # every (D, Dv) the wrapper admits, non-causal where D < Dv
    dims = sorted({*FK.HEAD_DIMS, *(d for pair in FK.PAIRS for d in pair)})
    cases += [("head_dims", 1, 100, 4, 2, D, Dv, bf, D >= Dv, 100)
              for D in dims for Dv in dims if FK.admits(D, Dv)]
    cases += [("sq_ne_skv", 2, 70, 4, 2, 128, 128, bf, c, 130) for c in (True, False)]
    # Gemma 3's prefill shapes (local layers: window 1024; global layers: D =
    # 256 alone), a window below one tile at a ragged S, a window that is not
    # a multiple of 64, ragged S, and the left edge alone (non-causal)
    for d_ in (bf, f32):
        cases += [("gemma3_window", 4, 2048, 8, 4, 256, 256, d_, True, 2048, 1024),
                  ("gemma3_global", 4, 2048, 8, 4, 256, 256, d_, True, 2048, 0),
                  ("window_lt_tile", 2, 300, 4, 2, 256, 256, d_, True, 300, 40),
                  ("window_not_x64", 2, 520, 4, 2, 128, 128, d_, True, 520, 100),
                  ("window_ragged_s", 1, 257, 4, 2, 64, 64, d_, True, 257, 64),
                  ("window_noncausal", 2, 200, 4, 2, 64, 64, d_, False, 200, 48)]
    # DeepSeek-V2's MLA prefill (128 heads, each its own KV head, D = 192 of
    # 128 + 64 rotary columns, Dv = 128), a ragged S and a single row
    for d_ in (bf, f32):
        cases += [("mla_path", 4, 512, 128, 128, 192, 128, d_, True, 512),
                  ("mla_ragged", 1, 520, 128, 128, 192, 128, d_, True, 520),
                  ("mla_s1", 2, 1, 128, 128, 192, 128, d_, True, 1)]
    # Qwen2-VL's prefill (64 query heads in groups of 8); SeamlessM4T's (16
    # heads of their own, D = 64): the encoder's and the cross-attention's
    # non-causal attention, the decoder's causal self-attention, and a
    # ragged decoder against the encoder's 512 frames
    for d_ in (bf, f32):
        cases += [("qwen2vl_path", 4, 512, 64, 8, 128, 128, d_, True, 512),
                  ("seamless_noncausal", 4, 512, 16, 16, 64, 64, d_, False, 512),
                  ("seamless_causal", 4, 512, 16, 16, 64, 64, d_, True, 512),
                  ("seamless_cross_ragged", 4, 300, 16, 16, 64, 64, d_, False, 512)]
    errs, rows = {}, []
    for label, B, S, H, KV, D, Dv, d_, causal, Skv, *win in cases:
        window = win[0] if win else 0
        gen = (edge_rng if label in ("edge_s", "head_dims", "sq_ne_skv") else
               llama4_rng if label == "llama4_path" else
               gemma_rng if label.startswith(("gemma3", "window")) else
               mla_rng if label.startswith("mla") else
               vlm_rng if label.startswith(("qwen2vl", "seamless")) else rng)
        q, k, v = (randn(gen, sh, dt[d_], dev) for sh in
                   ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv)))
        keep = [t.clone() for t in (q, k, v)]
        got = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, ok = close_err(got, attention_ref(q, k, v, causal=causal, window=window),
                            ATTN_TOL[d_])
        same = all(torch.equal(a, b) for a, b in zip(keep, (q, k, v)))
        rows.append({"case": label, "shape": [B, S, H, KV, D, Dv], "skv": Skv,
                     "causal": causal, "window": window, "dtype": d_, "max_abs_err": err,
                     "tol": ATTN_TOL[d_]})
        check(ok and bool(torch.isfinite(got).all()),
              f"flash attention disagrees with plain ({label}, {d_}): {err}")
        check(same, "the flash-attention kernel modified its inputs")
        if label == "path":
            errs["flash_attention"] = err
        if label == "zamba2_path":
            errs["flash_attention_d112"] = err
        if label == "llama4_path":
            errs["flash_attention_llama4"] = err
        if label in ("gemma3_window", "gemma3_global") and d_ == bf:
            errs["flash_attention_" + label] = err
        if label == "mla_path" and d_ == bf:
            errs["flash_attention_mla"] = err
        if label == "qwen2vl_path" and d_ == bf:
            errs["flash_attention_qwen2vl"] = err
        if label.startswith("seamless") and d_ == bf:
            errs["flash_attention_seamless"] = max(errs.get("flash_attention_seamless", 0.0), err)
    # (N, d, weight at an odd element offset): the path widths (3072 Phi-4-mini,
    # 768 Mamba-2, 3584 Zamba2, 5120 Llama-4-Scout at its prefill and decode
    # rows), row counts off the rows-per-CTA grid, the scalar path (odd width;
    # unaligned weight)
    rms_cases = [(N, 3072, False) for N in (4, 2048)]
    rms_cases += [(N, d, False) for d in (768, 3584) for N in (1, 5, 2047)]
    rms_cases += [(5, 3072, True), (2047, 768, True), (5, 100, False), (2047, 100, False)]
    rms_cases += [(2048, 5120, False), (4, 5120, False)]
    rms_cases += [(8192, 2560, False), (4, 2560, False)]  # Gemma 3's prefill and decode rows
    # DeepSeek-V2's q_norm and kv_norm (its ln1, ln2 and final norm are 5120's)
    rms_cases += [(N, d, False) for d in (1536, 512) for N in (2048, 4)]
    # Qwen2-VL's and SeamlessM4T's widths, prefill and decode rows
    rms_cases += [(N, d, False) for d in (8192, 1024) for N in (2048, 4)]
    for i, (N, d, odd_w) in enumerate(rms_cases):
        gen = (rng if i < 2 else llama4_rng if d == 5120 else gemma_rng if d == 2560
               else mla_rng if d in (1536, 512) else vlm_rng if d in (8192, 1024)
               else edge_rng)
        for d_ in (f32, bf):
            x, r = randn(gen, (N, d), dt[d_], dev), randn(gen, (N, d), dt[d_], dev)
            w = randn(gen, (d + odd_w,), torch.float32, dev) * 0.1 + 1
            w = w[odd_w:]  # a view at element offset 1: 4-byte, not 16-byte, aligned
            keep = [t.clone() for t in (x, r, w)]
            out = RK.rmsnorm_cuda(x, w, RMS_EPS)
            out_r, s_ = RK.rmsnorm_cuda(x, w, RMS_EPS, res2=r)
            torch.cuda.synchronize()
            e1, ok1 = close_err(out, rmsnorm_ref(x, w, RMS_EPS), RMS_TOL[d_])
            want_o, want_s = rmsnorm_residual_ref(x, r, w, RMS_EPS)
            e2, ok2 = close_err(out_r, want_o, RMS_TOL[d_])
            e3, ok3 = close_err(s_, want_s, RMS_TOL[d_])
            rows.append({"case": "rmsnorm", "shape": [N, d], "dtype": d_,
                         "weight_offset": int(odd_w),
                         "max_abs_err": e1, "residual_max_abs_err": max(e2, e3),
                         "tol": RMS_TOL[d_]})
            check(ok1 and ok2 and ok3, f"RMSNorm disagrees with plain ({N}, {d}, {d_})")
            check(all(torch.equal(a, b) for a, b in zip(keep, (x, r, w))),
                  "the RMSNorm kernel modified its inputs")
            if N == 2048 and d == 3072 and d_ == bf:
                errs["rmsnorm"], errs["rmsnorm_residual"] = e1, max(e2, e3)
            if d in RMS_WIDTHS and not odd_w and d_ == bf:  # the other paths' widths
                key = f"rmsnorm_d{d}"
                errs[key] = max(errs.get(key, 0.0), e1)
    ssd_cases = []  # (label, B, S, H, P, N, chunk, dtype, entering state)
    for d_ in (f32, bf):
        ssd_cases += [("ssd_sweep", 1, 64, 2, 16, 8, 16, d_, False),
                      ("ssd_sweep", 2, 128, 3, 16, 8, 32, d_, False),
                      ("ssd_sweep", 1, 128, 1, 32, 16, 64, d_, False)]
    ssd_cases += [("ssd_mamba2_path", 4, 512, 24, 64, 128, 128, bf, False),
                  ("ssd_zamba2_path", 4, 512, 112, 64, 64, 128, bf, False),
                  ("ssd_ragged", 2, 520, 24, 64, 128, 128, bf, False),
                  ("ssd_state_init", 2, 200, 24, 64, 128, 128, bf, True)]
    # off the bf16 kernel's tiles (zero padding of Q, P and N), narrow states
    # (N 4 stages element by element), a single step
    ssd_cases += [("ssd_pad_q100_p40_n72", 1, 300, 3, 40, 72, 100, bf, False),
                  ("ssd_n16", 2, 128, 4, 64, 16, 128, bf, False),
                  ("ssd_n4", 2, 130, 4, 64, 4, 128, bf, False),
                  ("ssd_s1", 2, 1, 4, 64, 128, 128, bf, False)]
    for label, B, S, H, P, N, Q, d_, init in ssd_cases:
        ins = ssd_inputs(rng, B, S, H, P, N, dt[d_], dev, init)
        x, dt_, Bv, Cv, A_log, D, s0 = ins
        keep = [None if t is None else t.clone() for t in ins]
        y, st = SK.ssd_cuda(x, dt_, Bv, Cv, A_log, D, Q, s0)
        torch.cuda.synchronize()
        want_y, want_s = ssd_chunked_ref(x, dt_, A_log, Bv, Cv, D, Q, s0)
        ey, oky = close_err(y, want_y, SSD_TOL)
        es, oks = close_err(st, want_s, SSD_TOL)
        rows.append({"case": label, "shape": [B, S, H, P, N, Q], "dtype": d_,
                     "max_abs_err": ey, "state_max_abs_err": es,
                     "max_abs_y": float(want_y.abs().max()), "tol": SSD_TOL})
        check(oky and oks, f"SSD disagrees with plain ({label}, {d_}): {ey}, {es}")
        check(all(a is b or torch.equal(a, b) for a, b in zip(keep, ins)),
              "the SSD kernel modified its inputs")
        if label == "ssd_mamba2_path":
            errs["ssd"] = max(ey, es)
        if label == "ssd_zamba2_path":
            errs["ssd_zamba2"] = max(ey, es)
    phase("kernels_vs_plain_model", cases=rows)
    return errs


# the backward kernels against the autograd of the plain versions on the
# same inputs: float32 sums in another order (scores over up to 520 keys, D
# up to 128; dw sums 2048 rows of values ~1), bf16 gradients rounded to bf16
# on both sides (and the kernel's Delta from the bf16 output, the plain one
# from the unrounded softmax)
ATTN_GRAD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (5e-2, 5e-2)}
LSE_TOL = (2e-3, 1e-4)  # the forward's float32 log-sum-exp against logsumexp
RMS_GRAD_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (3e-2, 3e-2)}
# the bf16 gradients also against float32 autograd on the same bf16 inputs
# (upcast), as max |kernel - float32| / max |float32| per tensor: the
# kernels compute in float32 and round each gradient to bf16 once (2^-9
# of its size), so a dropped tile or head shows far above this
GRAD_BF16_REL = 1e-2


# the training paths' flash backward shapes in ``compare_train_kernels``,
# by the error key of their ``kernels`` row
TRAIN_FLASH_GROUPS = {"phi4_train": "flash_attention_bwd", "zamba2_train": "flash_attention_bwd",
                      "gemma3_train": "flash_attention_bwd_gemma3",
                      "mla_train": "flash_attention_bwd_mla",
                      "seamless_train": "flash_attention_bwd_seamless"}


def plain_attention_grads(q, k, v, dout, causal, window=0):
    """(out, dq, dk, dv) of the plain attention by autograd."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref

    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        out = attention_ref(*leaves, causal=causal, window=window)
        out.backward(dout)
    return (out.detach(), *(t.grad for t in leaves))


def plain_lse(q, k, causal, window=0):
    """The float32 log-sum-exp [B, H, Sq] of the scaled, masked scores."""
    import torch

    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Sq, KV, H // KV, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * D ** -0.5
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    vis = (i >= j) if causal else torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if window:
        vis = vis & (i - j < window)
    s = s.masked_fill(~vis, float("-inf"))
    return torch.logsumexp(s, -1).reshape(B, H, Sq)


def rel_err(got, want):
    """max |got - want| / max |want| in float32; None where ``want`` is all
    zero (attention over one key has dq = dk = 0), which the absolute
    tolerance alone holds."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / scale if scale > 0 else None


def rel_ok(err):
    """Whether a ``rel_err`` reading is within ``GRAD_BF16_REL``."""
    return err is None or err <= GRAD_BF16_REL


def compare_train_kernels(dev):
    """The backward kernels (flash attention's dQ and dK / dV, RMSNorm's dx
    / dw) against the autograd of their plain versions on the card, float32
    and bf16 (bf16 also against float32 autograd on the upcast inputs,
    within ``GRAD_BF16_REL`` of each tensor's largest value), inputs checked
    untouched, two runs bit-equal; the forward's
    log-sum-exp against ``logsumexp``, its output with the log-sum-exp equal
    to the output without. Returns the max error of each at Phi-4-mini's
    training shapes."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    rng = np.random.default_rng(41)
    bf, f32 = "bfloat16", "float32"
    dt = {bf: torch.bfloat16, f32: torch.float32}
    # (label, dtype, B, Sq, H, KV, D, causal, Skv[, Dv, window])
    cases = []
    for d_ in (bf, f32):
        cases += [("phi4_train", d_, 4, 512, 24, 8, 128, True, 512),
                  ("zamba2_train", d_, 4, 512, 32, 32, 112, True, 512),
                  ("reduced_d32", d_, 2, 64, 4, 2, 32, True, 64),
                  ("d112", d_, 2, 130, 4, 2, 112, True, 130),
                  ("ragged", d_, 1, 520, 24, 8, 128, True, 520),
                  ("noncausal_sq_ne_skv", d_, 2, 300, 8, 4, 64, False, 512),
                  ("noncausal_sq_gt_skv", d_, 1, 130, 4, 2, 64, False, 70)]
        cases += [("edge_s", d_, 2, S, 4, 2, 64, True, S) for S in (1, 63, 65, 129)]
        cases += [(f"group_{H // KV}", d_, 2, 200, H, KV, 64, True, 200)
                  for H, KV in ((4, 4), (6, 2), (8, 1))]
        # the training paths of Gemma 3 (D 256, window 1024 and global), MLA
        # (D 192, Dv 128) and SeamlessM4T (D 64: the encoder, the decoder's
        # self-attention, the cross-attention over 768 frames)
        cases += [("gemma3_train_window", d_, 2, 2048, 8, 4, 256, True, 2048, 256, 1024),
                  ("gemma3_train_global", d_, 2, 2048, 8, 4, 256, True, 2048, 256, 0),
                  ("mla_train", d_, 4, 512, 128, 128, 192, True, 512, 128, 0),
                  ("seamless_train_encoder", d_, 4, 512, 16, 16, 64, False, 512),
                  ("seamless_train_self", d_, 4, 512, 16, 16, 64, True, 512),
                  ("seamless_train_cross", d_, 4, 512, 16, 16, 64, False, 768)]
        # windows at every width, ragged edges, the pairs in groups
        cases += [("window_d32", d_, 1, 96, 4, 2, 32, True, 96, 32, 32),
                  ("window_d64", d_, 2, 300, 8, 4, 64, True, 300, 64, 100),
                  ("window_d112", d_, 1, 200, 4, 2, 112, True, 200, 112, 70),
                  ("window_d128_noncausal", d_, 1, 200, 4, 2, 128, False, 200, 128, 50),
                  ("window_d256_ragged", d_, 1, 200, 4, 2, 256, True, 200, 256, 70),
                  ("window_1", d_, 1, 130, 4, 2, 256, True, 130, 256, 1),
                  ("d256_noncausal_sq_ne_skv", d_, 1, 100, 4, 2, 256, False, 170, 256, 0),
                  ("mla_ragged_group_4", d_, 1, 129, 8, 2, 192, True, 129, 128, 0),
                  ("mla_window", d_, 1, 200, 4, 4, 192, True, 200, 128, 64),
                  ("mla_noncausal_sq_gt_skv", d_, 1, 130, 4, 2, 192, False, 70, 128, 0)]
    errs, rows = {}, []
    for label, d_, B, S, H, KV, D, causal, Skv, *rest in cases:
        Dv, window = rest if rest else (D, 0)
        q, k, v = (randn(rng, sh, dt[d_], dev) for sh in
                   ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv)))
        dout = randn(rng, (B, S, H, Dv), dt[d_], dev)
        keep = [t.clone() for t in (q, k, v, dout)]
        out, lse = FK.flash_attention_cuda(q, k, v, causal=causal, window=window, lse=True)
        plain_out = FK.flash_attention_cuda(q, k, v, causal=causal, window=window)
        runs = [FK.flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=causal,
                                            window=window) for _ in range(2)]
        torch.cuda.synchronize()
        _, dq_p, dk_p, dv_p = plain_attention_grads(q, k, v, dout, causal, window)
        tol = ATTN_GRAD_TOL[d_]
        row = {"case": label, "shape": [B, S, H, KV, D, Dv], "skv": Skv,
               "causal": causal, "window": window, "dtype": d_, "tol": tol}
        ok_all = True
        for name, got, want in zip(("dq", "dk", "dv"), runs[0], (dq_p, dk_p, dv_p)):
            err, ok = close_err(got, want, tol)
            row[name] = err
            ok_all &= ok and bool(torch.isfinite(got).all())
        if d_ == bf:  # against float32 autograd on the same (upcast) inputs
            _, *want32 = plain_attention_grads(*(t.float() for t in (q, k, v, dout)), causal,
                                               window)
            for name, got, want in zip(("dq", "dk", "dv"), runs[0], want32):
                row[name + "_rel_f32"] = rel_err(got, want)
                ok_all &= rel_ok(row[name + "_rel_f32"])
            row["rel_f32_tol"] = GRAD_BF16_REL
        lse_err, lse_ok = close_err(lse, plain_lse(q, k, causal, window), LSE_TOL)
        row["lse"] = lse_err
        rows.append(row)
        check(ok_all, f"flash attention's backward disagrees with plain ({label}, {d_}): {row}")
        check(lse_ok, f"flash attention's log-sum-exp disagrees ({label}, {d_}): {lse_err}")
        check(torch.equal(out, plain_out), "the forward's output changed with the lse")
        check(all(torch.equal(a, b) for a, b in zip(*runs)),
              f"two runs of flash attention's backward differ ({label}, {d_})")
        check(all(torch.equal(a, b) for a, b in zip(keep, (q, k, v, dout))),
              "the flash-attention backward modified its inputs")
        group = TRAIN_FLASH_GROUPS.get(label.rsplit("_", 1)[0] if label.startswith(
            ("gemma3", "seamless")) else label)
        if group is not None:
            for name in ("dq", "dk", "dv"):
                key = f"{group}_{d_}"
                errs[key] = max(errs.get(key, 0.0), row[name])
        del q, k, v, dout, keep, out, runs, dq_p, dk_p, dv_p
    torch.cuda.empty_cache()
    phase("kernels_vs_plain_train_flash", cases=rows)

    rows = []
    # (N, d): Phi-4-mini's training rows (B 4 x 512) and decode-sized ones at
    # d 3072, the reduced configs' d 128, and a d that no vector divides
    rms_cases = [(2048, 3072), (5, 3072), (1, 3072), (2048, 128), (5, 128), (1, 128),
                 (7, 100)]
    for d_ in (bf, f32):
        for N, d in rms_cases:
            x = randn(rng, (N, d), dt[d_], dev)
            w = 1 + 0.1 * randn(rng, (d,), torch.float32, dev)
            dy = randn(rng, (N, d), dt[d_], dev)
            keep = [t.clone() for t in (x, w, dy)]
            runs = [RK.rmsnorm_bwd_cuda(x, w, dy, RMS_EPS) for _ in range(2)]
            torch.cuda.synchronize()
            xl, wl = (t.detach().clone().requires_grad_(True) for t in (x, w))
            with torch.enable_grad():
                rmsnorm_ref(xl, wl, RMS_EPS).backward(dy)
            tol = RMS_GRAD_TOL[d_]
            ex, okx = close_err(runs[0][0], xl.grad, tol)
            ew, okw = close_err(runs[0][1], wl.grad, tol)
            row = {"N": N, "d": d, "dtype": d_, "dx": ex, "dw": ew, "tol": tol}
            if d_ == bf:  # against float32 autograd on the same (upcast) inputs
                xf, wf = x.float().requires_grad_(True), w.clone().requires_grad_(True)
                with torch.enable_grad():
                    rmsnorm_ref(xf, wf, RMS_EPS).backward(dy.float())
                row.update(dx_rel_f32=rel_err(runs[0][0], xf.grad),
                           dw_rel_f32=rel_err(runs[0][1], wf.grad), rel_f32_tol=GRAD_BF16_REL)
                okx &= rel_ok(row["dx_rel_f32"])
                okw &= rel_ok(row["dw_rel_f32"])
            rows.append(row)
            check(okx and okw and bool(torch.isfinite(runs[0][0]).all()),
                  f"RMSNorm's backward disagrees with plain ({N}, {d}, {d_}): {row}")
            check(runs[0][0].dtype == x.dtype and runs[0][1].dtype == torch.float32,
                  "RMSNorm's backward returned the wrong dtypes")
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"two runs of RMSNorm's backward differ ({N}, {d}, {d_})")
            check(all(torch.equal(a, b) for a, b in zip(keep, (x, w, dy))),
                  "the RMSNorm backward modified its inputs")
            if (N, d) == (2048, 3072):
                errs[f"rmsnorm_bwd_{d_}"] = max(ex, ew)
    phase("kernels_vs_plain_train_rmsnorm", cases=rows)
    return errs


# the SSD scan's backward kernels against ``ssd_chunked_bwd_ref``: max |kernel
# - plain| / max |plain| of each gradient. float32: the same float32
# algorithm, sums in another order (dA_log sums terms over every position
# that cancel); bf16: the kernels compute in float32 on the same bf16 inputs
# and round dx, dB and dC to bf16 once (2^-9 of their size)
SSD_GRAD_REL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_GRADS = ("dx", "ddt", "dA_log", "dBv", "dCv", "dD", "dstate_init")


def ssd_bwd_inputs(rng, B, S, H, P, N, Q, dtype, dev, init=False, fin=False):
    """``ssd_inputs`` plus the forward's states (its ``states=True``
    launch), a float32 output gradient and, with ``fin``, a float32
    final-state gradient."""
    import torch

    from repro_torch.kernels.ssd import ssd as SK

    x, dt, Bv, Cv, A_log, D, s0 = ssd_inputs(rng, B, S, H, P, N, dtype, dev, init)
    _, _, states = SK.ssd_cuda(x, dt, Bv, Cv, A_log, D, Q, s0, states=True)
    dy = randn(rng, (B, S, H, P), torch.float32, dev)
    dfin = randn(rng, (B, H, P, N), torch.float32, dev) if fin else None
    return x, dt, Bv, Cv, A_log, D, s0, states, dy, dfin


def compare_train_ssd(dev):
    """The SSD scan's three backward kernels against the plain backward
    ``ssd_chunked_bwd_ref`` on the card, float32 and bf16, within
    ``SSD_GRAD_REL`` of each gradient's largest value: at Mamba-2's and
    Zamba2's training shapes (B 4 x 512, Q 128, P 64; H 24, N 128 and H 112,
    N 64), a ragged S, an entering state with a final-state gradient, a shape
    off every tile, the narrow test shape and, in bf16, heads that the
    chunk pass's groups do not divide (with P and N off the 16-byte
    copies); two runs bit-equal, inputs
    untouched; the forward's STATES instance bit-equal to the serving
    instance in y and the final state. Returns the largest absolute error
    at the path shapes by dtype, and (``_rel``) the largest relative one."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd import ssd as SK
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    rng = np.random.default_rng(44)
    bf, f32 = "bfloat16", "float32"
    dts = {bf: torch.bfloat16, f32: torch.float32}
    cases = []  # (label, B, S, H, P, N, Q, dtype, entering state, final gradient)
    for d_ in (bf, f32):
        cases += [("mamba2_train", 4, 512, 24, 64, 128, 128, d_, False, False),
                  ("zamba2_train", 4, 512, 112, 64, 64, 128, d_, False, False),
                  ("ragged", 1, 520, 24, 64, 128, 128, d_, False, False),
                  ("state_init_final", 2, 200, 24, 64, 128, 128, d_, True, True),
                  ("off_tile_q100_p40_n72", 2, 300, 3, 40, 72, 100, d_, False, True),
                  ("narrow_p16_n16_q32", 2, 100, 3, 16, 16, 32, d_, True, False)]
    # bf16: heads in groups of ceil(B nC H / SMs) = 6 on 132 SMs, the last
    # group of 3; P and N off the 16-byte copies
    cases.append(("group_rem_h45_p36_n44", 4, 500, 45, 36, 44, 128, bf, False, True))
    rows, errs = [], {}
    for label, B, S, H, P, N, Q, d_, init, fin in cases:
        x, dt, Bv, Cv, A_log, D, s0, states, dy, dfin = ssd_bwd_inputs(
            rng, B, S, H, P, N, Q, dts[d_], dev, init, fin)
        keep = [t.clone() for t in (x, dt, Bv, Cv, A_log, D, states, dy)]
        y0, f0 = SK.ssd_cuda(x, dt, Bv, Cv, A_log, D, Q, s0)
        y1, f1, states1 = SK.ssd_cuda(x, dt, Bv, Cv, A_log, D, Q, s0, states=True)
        runs = [SK.ssd_bwd_cuda(x, dt, Bv, Cv, A_log, D, Q, states, dy, dfin, want_dstate=init)
                for _ in range(2)]
        torch.cuda.synchronize()
        want = ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, Q, s0, dy, dfin)
        row = {"case": label, "shape": [B, S, H, P, N, Q], "dtype": d_,
               "state_init": init, "final_grad": fin, "tol_rel": SSD_GRAD_REL[d_]}
        ok = True
        for name, got, w in zip(SSD_GRADS, runs[0], want):
            if w is None:
                ok &= got is None
                continue
            row[name] = rel_err(got, w)
            ok &= (row[name] is None or row[name] <= SSD_GRAD_REL[d_]) and bool(
                torch.isfinite(got).all())
        rows.append(row)
        check(ok, f"the SSD backward disagrees with the plain backward ({label}, {d_}): {row}")
        check(runs[0][0].dtype == x.dtype and runs[0][3].dtype == x.dtype
              and runs[0][1].dtype == torch.float32, "the SSD backward's dtypes")
        check(all(a is None and b is None or torch.equal(a, b) for a, b in zip(*runs)),
              f"two runs of the SSD backward differ ({label}, {d_})")
        check(torch.equal(y0, y1) and torch.equal(f0, f1) and torch.equal(states, states1),
              f"the STATES forward differs from the serving forward ({label}, {d_})")
        check(all(torch.equal(a, b) for a, b in zip(keep, (x, dt, Bv, Cv, A_log, D, states, dy))),
              "the SSD backward modified its inputs")
        if label.endswith("_train"):
            key = f"ssd_bwd_{d_}"
            errs[key + "_rel"] = max(errs.get(key + "_rel", 0.0),
                                     *(row[n] for n in SSD_GRADS if n in row))
            errs[key] = max(errs.get(key, 0.0), *(
                float((got.float() - w).abs().max())
                for got, w in zip(runs[0], want) if w is not None))
    phase("kernels_vs_plain_train_ssd", cases=rows)
    return errs


def ssd_bwd_bound(B, S, H, P, N, Q, itemsize):
    """Least time of the SSD scan's gradient (S a multiple of Q, no entering
    state): x, dt, B, C, dy (float32) and the forward's states (float32)
    read once, dx, dt, dB and dC written once; or the products at the bf16
    tensor-core peak, each counted once: per (batch, chunk) C.B^T's causal
    pairs and the head-summed E's products with B and with C, per head dy.x^T
    and dx's intra term over the causal pairs, dx's inter term, dy^T S_prev,
    x^T G and the state gradient's update. Also that count at the scalar
    float32 rate, which the kernels run at."""
    nC = S // Q
    pairs = Q * (Q + 1) // 2
    flops = 2 * B * nC * (3 * pairs * N + H * (2 * pairs * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P * itemsize + B * S * H * P * 4 + 2 * B * S * H * 4
              + 4 * B * S * N * itemsize + 2 * H * 4 + B * nC * H * P * N * 4)
    return {**bound_fields(nbytes, flops, BF16_FLOPS_PER_S),
            "ops_ms_at_scalar_f32": flops / SCALAR_OPS_PER_S * 1e3}


def backward_ms(out, inputs, grad, reps=10):
    """Device time of one backward through autograd's recorded graph of
    ``out`` (built once, kept with ``retain_graph``): after a warm-up,
    ``reps`` eager calls queued behind a spinning kernel
    (``torch.cuda._sleep``), so that the host has enqueued them all before
    the first runs and the CUDA events around them see the device's time
    alone, as a CUDA graph's replay does for the kernels' own times."""
    import torch

    def fn():
        return torch.autograd.grad(out, inputs, grad, retain_graph=True)

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)  # ~0.1 s of spinning while the host enqueues
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def attn_pairs(Sq, Skv, window=0, causal=True):
    """The (q, k) pairs attention computes: causal (Sq == Skv), row i sees
    min(i + 1, window) keys; not causal, every key, or with a window (Sq ==
    Skv) the keys j > i - window."""
    if causal:
        return visible_pairs(Sq, window)
    if not window or window >= Sq:
        return Sq * Skv
    return Sq * Sq - (Sq - window) * (Sq - window + 1) // 2


def attn_bwd_bound(B, S, H, KV, D, itemsize, ops_per_s, *, Dv=None, Skv=None, window=0,
                   causal=True):
    """Least time of attention's backward: five products over the visible
    (q, k) pairs (``attn_pairs``: S over D and dP over Dv recomputed, dV over
    Dv, dK and dQ over D) at ``ops_per_s``, or q, k, v, o, dO and the
    log-sum-exp read once and dQ, dK, dV written once at the memory rate,
    whichever is larger. ``S`` is the queries' length, ``Skv`` (S if None)
    the keys'; ``Dv`` (D if None) the values' head dim."""
    Dv, Skv = Dv or D, Skv or S
    flops = 2 * (3 * D + 2 * Dv) * attn_pairs(S, Skv, window, causal) * B * H
    nbytes = (B * (S * H + Skv * KV) * (2 * D + 2 * Dv) * itemsize + B * H * S * 4)
    return bound_fields(nbytes, flops, ops_per_s)


def time_train_ssd(dev):
    """The SSD scan's three backward kernels at Mamba-2's and Zamba2's
    training shapes (B 4 x 512, Q 128, P 64, bf16; Mamba-2's also in
    float32, ``train_ssm_vs_cpu``'s dtype), together and each alone (its
    inputs left in place by a run of the launches before it), beside the
    plain backward ``ssd_chunked_bwd_ref`` and the bound; no PyTorch call
    computes the scan's gradient (``library_ms`` None). Returns the rows."""
    import numpy as np
    import torch

    from repro_torch.kernels.ssd import ssd as SK
    from repro_torch.kernels.ssd.ref import ssd_chunked_bwd_ref

    rng = np.random.default_rng(45)
    out = {}
    for key, H, N, dt_ in (("ssd_bwd", 24, 128, torch.bfloat16),
                           ("ssd_bwd_zamba2", 112, 64, torch.bfloat16),
                           ("ssd_bwd_f32", 24, 128, torch.float32)):
        x, dt, Bv, Cv, A_log, D, _, states, dy, _ = ssd_bwd_inputs(
            rng, 4, 512, H, 64, N, 128, dt_, dev)
        item = 2 if dt_ == torch.bfloat16 else 4
        launches, _ = SK.ssd_bwd_launches(x, dt, Bv, Cv, A_log, D, 128, states, dy)
        for _, fn in launches:  # each kernel's inputs in place before it runs alone
            fn()
        out[key] = {
            "ms": graph_ms(lambda: SK.ssd_bwd_cuda(x, dt, Bv, Cv, A_log, D, 128, states, dy),
                           reps=10),
            "kernels_alone_ms": {name: graph_ms(fn, reps=10) for name, fn in launches},
            "plain_ms": graph_ms(lambda: ssd_chunked_bwd_ref(x, dt, A_log, Bv, Cv, D, 128,
                                                             None, dy), reps=3),
            "library_ms": None, **ssd_bwd_bound(4, 512, H, 64, N, 128, item),
            "shape": f"B=4, S=512, H={H}, P=64, N={N}, Q=128, "
                     f"{'bf16' if item == 2 else 'float32'}"}
        del x, dt, Bv, Cv, states, dy
    torch.cuda.empty_cache()
    return out


def time_attn_bwd(rng, dev, B, S, H, KV, D, *, Dv=None, Skv=None, window=0, causal=True,
                  dtype="bfloat16", reps=5):
    """Flash attention's backward (dQ + dK / dV) at one shape on random
    inputs: the kernels' time (CUDA graph), the plain version's autograd
    backward and SDPA's backward through autograd (a window as a boolean
    band mask: cuDNN has no window mode; timed alone, never called by the
    port) with the backend it dispatches to, and the bound (bf16 at the
    tensor-core peak, float32 at the scalar rate)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref

    Dv, Skv = Dv or D, Skv or S
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    q, k, v, dout = (randn(rng, sh, dt, dev) for sh in
                     ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv), (B, S, H, Dv)))
    o, lse = FK.flash_attention_cuda(q, k, v, causal=causal, window=window, lse=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        plain_out = attention_ref(*leaves, causal=causal, window=window)
    lt = [t.detach().transpose(1, 2).contiguous().requires_grad_(True) for t in (q, k, v)]
    kw = {"enable_gqa": True}
    if window:
        i = torch.arange(S, device=dev)[:, None]
        j = torch.arange(Skv, device=dev)[None, :]
        kw["attn_mask"] = ((i >= j) if causal else (i == i)) & (i - j < window)
    else:
        kw["is_causal"] = causal
    with torch.enable_grad():
        lib_out = F.scaled_dot_product_attention(*lt, **kw)
    choice = SDPBackend(torch._fused_sdp_choice(*lt, **kw))
    item = 2 if dt == torch.bfloat16 else 4
    shape = (f"B={B}, Sq={S}, Skv={Skv}, H={H}, KV={KV}, D={D}, Dv={Dv}, "
             f"{'bf16' if item == 2 else 'float32'}, {'causal' if causal else 'not causal'}"
             + (f", window {window}" if window else ""))
    row = {
        "ms": graph_ms(lambda: FK.flash_attention_bwd_cuda(q, k, v, o, dout, lse, causal=causal,
                                                           window=window), reps=reps),
        "plain_ms": backward_ms(plain_out, leaves, dout, reps=reps),
        "library_ms": backward_ms(lib_out, lt, dout.transpose(1, 2).contiguous(), reps=reps),
        "library_backend": choice.name,
        **attn_bwd_bound(B, S, H, KV, D, item,
                         BF16_FLOPS_PER_S if item == 2 else SCALAR_OPS_PER_S,
                         Dv=Dv, Skv=Skv, window=window, causal=causal),
        "shape": shape}
    del q, k, v, dout, o, lse, leaves, lt, plain_out, lib_out
    torch.cuda.empty_cache()
    return row


# the training paths' backward shapes beyond Phi-4-mini's and Zamba2's:
# (key, B, S, H, KV, D, keyword arguments of ``time_attn_bwd``)
TRAIN_ATTN_SHAPES = (
    ("flash_attention_bwd_gemma3_window", 2, 2048, 8, 4, 256, {"window": 1024}),
    ("flash_attention_bwd_gemma3_global", 2, 2048, 8, 4, 256, {}),
    ("flash_attention_bwd_mla", 4, 512, 128, 128, 192, {"Dv": 128}),
    ("flash_attention_bwd_seamless", 4, 512, 16, 16, 64, {"causal": False}),
    ("flash_attention_bwd_seamless_causal", 4, 512, 16, 16, 64, {}),
    ("flash_attention_bwd_seamless_cross", 4, 512, 16, 16, 64, {"causal": False, "Skv": 768}),
    # float32, at ``train_families_vs_cpu``'s shapes (1 x 256 tokens)
    ("flash_attention_bwd_f32_gemma3", 1, 256, 8, 4, 256,
     {"window": 128, "dtype": "float32"}),
    ("flash_attention_bwd_f32_mla", 1, 256, 128, 128, 192, {"Dv": 128, "dtype": "float32"}),
    ("flash_attention_bwd_f32_seamless", 1, 256, 16, 16, 64,
     {"causal": False, "dtype": "float32"}),
)


def time_train_kernels(dev):
    """The backward kernels at the training paths' shapes: flash
    attention's dQ + dK / dV (``time_attn_bwd``) at Phi-4-mini's B 4, S 512,
    24 / 8 heads, D 128 in bf16 (the ``wgmma`` kernels) and in float32 (the
    scalar kernels), at Zamba2's 32 / 32 heads, D 112, and at
    ``TRAIN_ATTN_SHAPES``; RMSNorm's backward at N 2048, d 3072 in bf16:
    kernel, the plain version's autograd backward, and the backward of one
    PyTorch call through autograd (``F.rms_norm``; timed alone, never called
    by the port), with the bound; then ``time_train_ssd``'s rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    rng = np.random.default_rng(43)
    bf = torch.bfloat16
    out = {"flash_attention_bwd_zamba2": time_attn_bwd(rng, dev, 4, 512, 32, 32, 112),
           "flash_attention_bwd": time_attn_bwd(rng, dev, 4, 512, 24, 8, 128),
           "flash_attention_bwd_f32": time_attn_bwd(rng, dev, 4, 512, 24, 8, 128,
                                                    dtype="float32")}
    for key, B, S, H, KV, D, kw in TRAIN_ATTN_SHAPES:
        out[key] = time_attn_bwd(rng, dev, B, S, H, KV, D, **kw)
    N, d = 2048, 3072
    x, dy = (randn(rng, (N, d), bf, dev) for _ in range(2))
    w = 1 + 0.1 * randn(rng, (d,), torch.float32, dev)
    xl, wl = (t.clone().requires_grad_(True) for t in (x, w))
    xb, wb = x.clone().requires_grad_(True), w.to(bf).requires_grad_(True)
    with torch.enable_grad():
        plain_y = rmsnorm_ref(xl, wl, RMS_EPS)
        lib_y = F.rms_norm(xb, (d,), wb, RMS_EPS)
    out["rmsnorm_bwd"] = {
        "ms": graph_ms(lambda: RK.rmsnorm_bwd_cuda(x, w, dy, RMS_EPS)),
        "plain_ms": backward_ms(plain_y, (xl, wl), dy),
        "library_ms": backward_ms(lib_y, (xb, wb), dy),
        # x and dy read, dx written (bf16); w read and dw written (float32)
        **bound_fields(3 * N * d * 2 + 2 * d * 4, 8 * N * d),
        "shape": f"N={N}, d={d}, bf16"}
    out.update(time_train_ssd(dev))
    phase("kernel_times_train", **out)
    return out


# ---------------------------------------------------------------------------
# training on the card (Phi-4-mini): card against CPU, resume, the whole model

TRAIN_LOSS_RTOL = 1e-4  # float32 card vs CPU: sums in another order, 2 layers
# float32 card vs CPU: each leaf's step-0 gradient, max |card - CPU| / max |CPU|
TRAIN_GRAD_REL = 1e-4
TRAIN_PARAM_MEAN_ATOL = 1e-6  # the parameters' mean |card - CPU| after 2 steps
RESUME_LOSS_RTOL = 1e-3  # bf16 parameters: resumed against straight, on the card
TRAIN_STEPS = 8  # train_phi4_mini's steps; ms per step is the median of steps 2-8
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=100)


def trainer_from(cfg, dcfg, steps, device, init, rt=None, first_grads=None):
    """A ``Trainer`` of ``cfg`` on ``device`` whose ``init_state`` loads the
    float32 parameters ``init`` (``params_to_numpy`` layout); with a dict
    ``first_grads``, each parameter's gradient of the first step is copied
    into it by name as autograd accumulates it."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(cfg, dcfg, TrainerConfig(steps=steps, log_every=0,
                                          opt=AdamWConfig(**TRAIN_OPT)),
                 rt=rt, device=device)

    def keep(name):
        def hook(q):
            if name not in first_grads:
                first_grads[name] = q.grad.detach().clone()
        return hook

    def init_state():
        p = M.params_from_numpy(cfg, init, device=device).float()
        for name, q in p.named_parameters():
            q.requires_grad_(True)
            if first_grads is not None:
                q.register_post_accumulate_grad_hook(keep(name))
        return p, adamw_init(dict(p.named_parameters()))

    tr.init_state = init_state
    return tr


_PHI4_2L = []  # the 2-layer Phi-4-mini's initial parameters, made once


def phi4_two_layers():
    """(Phi-4-mini at full width cut to 2 layers, its float32 initial
    parameters in ``params_to_numpy`` layout, seeded), shared by
    ``train_vs_cpu`` and ``serve_int8_cache_vs_cpu``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    cfg = get_config(PHI4).replace(n_layers=2)
    if not _PHI4_2L:  # drawn on the card (fast), carried to the host once
        gen = torch.Generator(device="cuda").manual_seed(5)
        _PHI4_2L.append(M.params_to_numpy(cfg, M.init_params(cfg, gen, device="cuda")))
    return cfg, _PHI4_2L[0]


def train_card_vs_cpu(dev, cfg, init, steps, seed):
    """``cfg`` in float32 from the same initial parameters ``init`` on the
    card and the CPU: ``Trainer.run`` for ``steps`` steps on 1 x 256 tokens
    of ``SyntheticLM`` (``seed``). Per step the loss and grad norm within
    ``TRAIN_LOSS_RTOL``; each leaf's gradient of the first step within
    ``TRAIN_GRAD_REL`` of that leaf's largest value (the tight check of
    every gradient, a norm weight's as the embedding's); after the last step every parameter within ``steps``
    Adam steps (``2 steps lr``, a loose sanity bound: Adam moves each
    element about ``lr`` a step whatever its gradient's size, and a
    near-zero gradient whose float32 sign differs moves the two sides a
    step apart) and their mean difference within ``TRAIN_PARAM_MEAN_ATOL``.
    The CPU runs without remat (the same numbers, less work) on a thread
    beside the card's run. Returns (the phase's fields, the card run's
    launches)."""
    import torch

    from repro_torch.runtime import Runtime

    t0 = time.perf_counter()
    dcfg = data_config(cfg, 256, 1, seed)
    seconds = {}
    grads = {"cuda": {}, "cpu": {}}

    def train(device, rt):
        t1 = time.perf_counter()
        params, _, hist = trainer_from(cfg, dcfg, steps, device, init, rt=rt,
                                       first_grads=grads[device]).run(resume=False)
        seconds[device] = time.perf_counter() - t1
        return params, hist

    for c in launch_counters():  # the card's launches (the CPU runs the plain versions)
        c.update(dict.fromkeys(c, 0))
    with ThreadPoolExecutor(1) as pool:  # the CPU's run beside the card's
        cpu_run = pool.submit(train, "cpu", Runtime(remat=False))
        pg, hg = train("cuda", None)
        pc, hc = cpu_run.result()
    launches = {k: v for c in launch_counters() for k, v in c.items()}
    rows = []
    for a, b in zip(hg, hc):
        rows.append({k: [a[k], b[k]] for k in ("loss", "grad_norm")})
        for k in ("loss", "grad_norm"):
            check(abs(a[k] - b[k]) <= TRAIN_LOSS_RTOL * abs(b[k]),
                  f"{cfg.name} card vs CPU: step {a['step']} {k} card {a[k]} CPU {b[k]}")
    check(set(grads["cuda"]) == set(grads["cpu"]) == {k for k, _ in pc.named_parameters()},
          f"{cfg.name} card vs CPU: a parameter got no gradient on one side")
    rel = {}
    for k in sorted(grads["cpu"]):  # on the card, one leaf at a time
        a, b = grads["cuda"].pop(k), grads["cpu"].pop(k).to(dev)
        err = rel_err(a, b)
        rel[k] = float(a.abs().max()) if err is None else err
    worst_leaf = max(rel, key=rel.get)
    check(rel[worst_leaf] <= TRAIN_GRAD_REL,
          f"{cfg.name} card vs CPU: step 0's gradient of {worst_leaf} differs by "
          f"{rel[worst_leaf]} of its largest value")
    worst, total, n = 0.0, 0.0, 0
    with torch.no_grad():  # on the card: the CPU's parameters carried over
        for (k, a), (_, b) in zip(pg.named_parameters(), pc.named_parameters()):
            d = (a - b.to(a.device)).abs()
            worst, total, n = max(worst, float(d.max())), total + float(d.double().sum()), n + d.numel()
    mean = total / n
    del pg, pc
    torch.cuda.empty_cache()
    check(worst <= 2 * steps * TRAIN_OPT["lr"] and mean <= TRAIN_PARAM_MEAN_ATOL,
          f"{cfg.name} card vs CPU: parameters differ by {worst} (mean {mean})")
    fields = dict(layers=cfg.n_layers, d_model=cfg.d_model, params=int(n),
                  tokens=256, steps=steps, dtype="float32", steps_card_cpu=rows,
                  grad_rel_by_leaf=rel, grad_rel_worst=[worst_leaf, rel[worst_leaf]],
                  param_max_abs_diff=worst, param_mean_abs_diff=mean,
                  tol={"loss_rtol": TRAIN_LOSS_RTOL, "grad_rel": TRAIN_GRAD_REL,
                       "param_max": 2 * steps * TRAIN_OPT["lr"],
                       "param_mean": TRAIN_PARAM_MEAN_ATOL},
                  launches={k: v for k, v in launches.items() if v},
                  seconds=time.perf_counter() - t0, seconds_by_part=seconds)
    return fields, launches


def note_gate_cut(name, fields):
    """A card-against-CPU gate cut to ``CPU_GATE_STEPS`` steps in ``CUTS``:
    the CPU run's seconds (the longer side, run beside the card's, and the
    part that grows with the steps)."""
    note_cut(name, fields["seconds_by_part"]["cpu"], CPU_GATE_STEPS, CPU_GATE_STEPS_UNCUT)


def train_vs_cpu(dev):
    """Phi-4-mini at full width, 2 layers, float32: ``train_card_vs_cpu``
    for ``CPU_GATE_STEPS`` steps (the CPU's seconds noted in ``CUTS``).
    Returns the card run's launches: the float32 backward kernels' main
    path."""
    t0 = time.perf_counter()
    cfg, init = phi4_two_layers()
    init_s = time.perf_counter() - t0
    fields, launches = train_card_vs_cpu(dev, cfg, init, CPU_GATE_STEPS, 5)
    fields["seconds_by_part"]["init"] = init_s
    note_gate_cut("train_vs_cpu", fields)
    phase("train_vs_cpu", **fields)
    return launches


def train_ssm_vs_cpu(dev):
    """Mamba-2 130M whole (``CPU_GATE_STEPS`` steps, the CPU's seconds
    noted in ``CUTS``) and Zamba2 7B at full width cut to 7 layers (one
    superblock of 6 Mamba-2 layers and the shared attention block, one
    trailing layer; 2 steps), float32: ``train_card_vs_cpu``
    from seeded initial parameters drawn on the card. Returns the card
    runs' launches by model: the float32 SSD backward's main path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    out, launches = {}, {}
    for key, cfg, steps, seed in (("mamba2_130m", get_config(MAMBA2), CPU_GATE_STEPS, 47),
                                  ("zamba2_7b_7_layers", get_config(ZAMBA2).replace(n_layers=7),
                                   2, 48)):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        init = M.params_to_numpy(cfg, M.init_params(cfg, gen, device="cuda"))
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        out[key], launches[key] = train_card_vs_cpu(dev, cfg, init, steps, seed)
        out[key]["seconds_by_part"]["init"] = init_s
        if key == "mamba2_130m":
            note_gate_cut("train_ssm_vs_cpu[mamba2_130m]", out[key])
        del init
    phase("train_ssm_vs_cpu", **out)
    return launches


def train_resume_card(dev):
    """``granite-8b`` ``reduced()`` on the card, in the trainer's own bf16
    parameters (a checkpoint restores into the schema's dtypes, as JAX's
    does): 6 steps straight against 3 steps, a checkpoint, a restore into a
    fresh ``Trainer`` and 3 more steps. The restored tensors equal the saved
    ones bit for bit; the float32 losses within ``RESUME_LOSS_RTOL`` (cuBLAS
    and the embedding's backward need not be deterministic, and a sum a
    rounding apart may round an updated bf16 parameter to its neighbour)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config("granite-8b").reduced()
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=6)

    def trainer(steps, **kw):
        return Trainer(cfg, dcfg, TrainerConfig(steps=steps, log_every=0, seed=6,
                                                opt=AdamWConfig(**TRAIN_OPT), **kw), device=dev)

    _, _, straight = trainer(6).run(resume=False)
    with tempfile.TemporaryDirectory() as d:
        first = trainer(3, ckpt_every=3, ckpt_dir=d)
        p3, o3, h1 = first.run(resume=False)
        second = trainer(6, ckpt_dir=d)
        rp, ro = second.restore(3)
        same = all(torch.equal(a, b) for a, b in zip(p3.parameters(), rp.parameters()))
        same &= all(torch.equal(o3[k][n], ro[k][n]) for k in ("m", "v") for n in o3[k])
        same &= torch.equal(o3["step"], ro["step"])
        check(same, "train_resume_card: the restored state differs from the saved one")
        _, _, h2 = second.run(resume=True)
    resumed = h1 + h2
    check([h["step"] for h in resumed] == list(range(6)), "train_resume_card: steps")
    for a, b in zip(resumed, straight):
        check(abs(a["loss"] - b["loss"]) <= RESUME_LOSS_RTOL * abs(b["loss"]),
              f"train_resume_card: step {a['step']} loss {a['loss']} vs {b['loss']}")
    phase("train_resume_card", model=cfg.name, steps=6, restored_bit_equal=True,
          losses_resumed=[h["loss"] for h in resumed], losses_straight=[h["loss"] for h in straight])


def serve_int8_cache_vs_cpu(dev):
    """Phi-4-mini at full width, 2 layers, float32: 16 decode steps from an
    empty int8 KV cache (``init_cache(..., quant=True)``, len 0) on the card
    and on the CPU, the same tokens (the CPU's greedy choices) on both.
    Logits within ``LOGIT_TOL``; the cached int8 values within 1 (a key a
    float32 rounding from a half rounds the other way); the first layer's
    scales within float32 rounding (rtol 1e-5), the second layer's within
    rtol 1e-2 (decode attends over the dequantised cache in bf16, as JAX
    does, so a scale a float32 rounding apart may round to the neighbouring
    bf16, 2^-8 apart, and the second layer's keys carry that)."""
    import numpy as np
    import torch

    from repro_torch.models import model as M

    cfg, init = phi4_two_layers()
    pc = M.params_from_numpy(cfg, init, device="cpu").float()
    pg = M.params_from_numpy(cfg, init, device=dev).float()
    B, n = 2, 16
    caches = {d: M.init_cache(cfg, B, n, device=d, quant=True) for d in ("cpu", "cuda")}
    tok = torch.as_tensor(np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 1)))
    worst = 0.0
    with torch.no_grad():
        for i in range(n):
            lc, caches["cpu"] = M.decode_step(cfg, pc, caches["cpu"], tok)
            lg, caches["cuda"] = M.decode_step(cfg, pg, caches["cuda"], tok.to(dev))
            err = float((lg.float().cpu() - lc).abs().max())
            worst = max(worst, err)
            check(err <= LOGIT_TOL and bool(torch.isfinite(lg).all()),
                  f"serve_int8_cache_vs_cpu: step {i} logits differ by {err}")
            tok = lc[:, -1].argmax(-1, keepdim=True)
    codes, scales = 0, [0.0] * cfg.n_layers
    for kind in ("k", "v"):
        a, b = caches["cuda"]["blocks"][kind].cpu().int(), caches["cpu"]["blocks"][kind].int()
        check(caches["cuda"]["blocks"][kind].dtype == torch.int8, "the cache is not int8")
        codes = max(codes, int((a - b).abs().max()))
        sa = caches["cuda"]["blocks"][kind + "_scale"].cpu()
        sb = caches["cpu"]["blocks"][kind + "_scale"]
        rel = ((sa - sb).abs() / sb.abs().clamp(min=1e-30)).amax(dim=(1, 2, 3))
        scales = [max(x, float(r)) for x, r in zip(scales, rel)]
    check(codes <= 1 and scales[0] <= 1e-5 and max(scales) <= 1e-2,
          f"serve_int8_cache_vs_cpu: int8 codes differ by {codes}, scales by {scales}")
    phase("serve_int8_cache_vs_cpu", layers=cfg.n_layers, d_model=cfg.d_model, batch=B,
          decode_steps=n, dtype="float32", max_logit_diff=worst, logit_tol=LOGIT_TOL,
          max_int8_code_diff=codes, max_scale_rel_diff_by_layer=scales,
          cache_len=int(caches["cuda"]["len"][0]))


def data_config(cfg, S, B, seed):
    """``SyntheticLM``'s settings for ``cfg``: B x S tokens, and a vision
    model's patch embeddings or an encoder-decoder's S frames (the front
    end's stub inputs) at its width."""
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B, seed=seed,
                      modality=cfg.modality, d_model=cfg.d_model,
                      frontend_tokens=cfg.frontend_tokens)


def train_model(dev, name, cfg, want, B=4, S=512):
    """``cfg`` (full width, bf16) trained ``TRAIN_STEPS`` steps through
    ``Trainer.run`` on B x S tokens of ``SyntheticLM``, remat on: ms per
    step (median of steps 2-8) and tokens/s, the synchronised split into
    forward, backward and ``adamw_update``, the device's busy share of one
    step under ``torch.profiler``, exact launches per step of every model
    kernel (``want``: the launches a step makes, by ``LAUNCHES`` key; every
    other key 0), peak memory, the model FLOPs and the optimizer's bytes
    beside their times at the card's peaks. Every loss finite, no step
    skipped. The phase ``name``; returns the run's launches."""
    import statistics as st_

    import torch

    from repro_torch.models import model as M
    from repro_torch.train.trainer import Trainer, TrainerConfig

    t0 = time.perf_counter()
    tr = Trainer(cfg, data_config(cfg, S, B, 7), TrainerConfig(steps=TRAIN_STEPS, log_every=0),
                 device=dev)
    tr.time_phases = True
    phases = []
    real_step = tr.step

    def step(params, opt, batch):
        out = real_step(params, opt, batch)
        phases.append(dict(tr.last_phases))
        return out

    tr.step = step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in launch_counters():
        c.update(dict.fromkeys(c, 0))
    t1 = time.perf_counter()
    params, opt, hist = tr.run(resume=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {k: v for c in launch_counters() for k, v in c.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = TRAIN_STEPS
    expect = {k: want.get(k, 0) * n for k in launches}
    check(launches == expect and set(want) <= set(launches),
          f"{name} launches {launches}, expected {expect}")
    check(all(torch.isfinite(torch.tensor(h["loss"])) for h in hist),
          f"{name}: a non-finite loss in {[h['loss'] for h in hist]}")
    check(tr.nan_guard.total_skipped == 0, f"{name} skipped a step")
    steady = phases[1:]  # steps 2-8
    ms = st_.median(h["time_s"] for h in hist[1:]) * 1e3
    split = {k: st_.median(p[k] for p in steady) for k in steady[0]}
    # one more step under the profiler (autograd on), counters restored
    batch = tr._device_batch(tr.source.batch_for_step(n))
    t1 = time.perf_counter()
    tr.step(params, opt, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) * 1e3
    prof = call_profile(lambda: tr.step(params, opt, tr._device_batch(
        tr.source.batch_for_step(n + 1))), step_ms, grad=True)
    n_params = M.count_params(cfg)
    flops = 6 * n_params * B * S
    opt_bytes = n_params * (2 + 2 + 2 + 4 * 4)  # p read + written, g read, m and v r + w
    phase(name, layers=cfg.n_layers, d_model=cfg.d_model, params=n_params, batch=B,
          seq_len=S, steps=n, dtype="bfloat16", remat=True,
          ms_per_step=ms, tokens_per_s=B * S / ms * 1e3, split_ms=split,
          step_ms_all=[sum(p.values()) for p in phases], wall_s=wall,
          losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
          launches_per_step={k: v / n for k, v in launches.items() if v},
          peak_memory_gb=peak, profile=prof,
          model_flops=flops, model_flops_ms_at_989=flops / BF16_FLOPS_PER_S * 1e3,
          optimizer_bytes=opt_bytes, optimizer_bytes_ms_at_3_35=opt_bytes / HBM_BYTES_PER_S * 1e3,
          seconds=time.perf_counter() - t0)
    del params, opt, tr
    torch.cuda.empty_cache()
    return launches


def attn_train_launches(n_attn, norms_in, norms_out=1):
    """A step's launches of an attention model under remat: each of the
    ``n_attn`` attention calls in its layers twice forward and its dQ and dK
    / dV once; each of the ``norms_in`` norms in its layers twice forward,
    the ``norms_out`` outside them (the final norms) once, each once
    backward."""
    norms = norms_in + norms_out
    return {"flash_attention": 2 * n_attn, "flash_attention_bwd_dq": n_attn,
            "flash_attention_bwd_dkdv": n_attn, "rmsnorm": 2 * norms_in + norms_out,
            "rmsnorm_bwd": norms, "rmsnorm_bwd_dw": norms}


def train_phi4_mini(dev):
    """The whole Phi-4-mini (32 layers) through ``train_model``: per step
    64 flash forward (remat), 32 dQ and 32 dK / dV, 129 RMSNorm forward and
    65 backward."""
    from repro_torch.configs import get_config

    cfg = get_config(PHI4)
    L = cfg.n_layers
    return train_model(dev, "train_phi4_mini", cfg, attn_train_launches(L, 2 * L))


def train_gemma3_4b(dev):
    """The whole Gemma 3 4B (34 layers, 29 with the 1024-token window, D
    256, 8 / 4 heads) through ``train_model`` on B 2 x 2048 tokens, so the
    window masks on its path: per step 68 flash forward, 34 dQ and 34 dK /
    dV (the two-warpgroup kernels, 29 windowed), 137 RMSNorm forward and 69
    backward (two norms a layer)."""
    from repro_torch.configs import get_config

    cfg = get_config(GEMMA3)
    L = cfg.n_layers
    return train_model(dev, "train_gemma3_4b", cfg, attn_train_launches(L, 2 * L), B=2, S=2048)


def train_deepseek_v2(dev):
    """DeepSeek-V2 at full width, ``DEEPSEEK_TRAIN_LAYERS`` (2) of 60 layers:
    the dense first layer and one MoE layer (160 routed experts of d_ff 1536,
    top-6, 2 shared), MLA at D 192 / Dv 128, 4.8e9 parameters (the whole
    model's parameters, gradients and m / v would not fit the card), through
    ``train_model``: per step 4 flash forward, 2 dQ and 2 dK / dV (the
    two-warpgroup kernels), four norms a layer (two of them MLA's latent
    norms). The MoE backward is ``torch._grouped_mm``'s autograd."""
    from repro_torch.configs import get_config

    cfg = get_config(DEEPSEEK).replace(n_layers=DEEPSEEK_TRAIN_LAYERS)
    L = cfg.n_layers
    return train_model(dev, "train_deepseek_v2", cfg, attn_train_launches(L, 4 * L))


def train_seamless_m4t(dev):
    """The whole SeamlessM4T-medium (12 encoder and 12 decoder layers, D 64,
    16 / 16 heads) through ``train_model`` on B 4 x 512 tokens with 512
    frames: per step 72 flash forward (the encoder's not causal, the
    decoder's self-attention causal, its cross-attention not causal), 36 dQ
    and 36 dK / dV, two norms an encoder layer and three a decoder layer, the
    encoder's and the decoder's final norms."""
    from repro_torch.configs import get_config

    cfg = get_config(SEAMLESS)
    Le, Ld = cfg.n_enc_layers, cfg.n_dec_layers
    return train_model(dev, "train_seamless_m4t", cfg,
                       attn_train_launches(Le + 2 * Ld, 2 * Le + 3 * Ld, 2))


def train_families_vs_cpu(dev):
    """Gemma 3 at full width and D 256, 2 layers (one windowed, one global,
    the window cut to 128 so that it masks at 256 tokens); DeepSeek-V2 at
    full attention and expert widths, 2 layers (dense, then MoE) with 8 of
    its 160 experts (top-6, 2 shared: the CPU's float32 copy of 160 would
    not fit the host); SeamlessM4T at full width with 2 encoder and 2
    decoder layers: ``train_card_vs_cpu`` for 2 steps each, float32, from
    seeded initial parameters drawn on the card. Returns the card runs'
    launches by model: the float32 backward kernels at D 256 (windowed and
    not), D 192 / Dv 128 and D 64."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    out, launches = {}, {}
    for key, cfg, seed in (
            ("gemma3_4b_2_layers", get_config(GEMMA3).replace(
                n_layers=2, local_global_period=2, sliding_window=128), 51),
            ("deepseek_v2_2_layers_8_experts", get_config(DEEPSEEK).replace(
                n_layers=2, n_experts=8), 52),
            ("seamless_m4t_2_2_layers", get_config(SEAMLESS).replace(
                n_layers=2, n_enc_layers=2, n_dec_layers=2), 53)):
        t0 = time.perf_counter()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        init = M.params_to_numpy(cfg, M.init_params(cfg, gen, device="cuda"))
        torch.cuda.empty_cache()
        init_s = time.perf_counter() - t0
        out[key], launches[key] = train_card_vs_cpu(dev, cfg, init, 2, seed)
        out[key]["seconds_by_part"]["init"] = init_s
        del init
    phase("train_families_vs_cpu", **out)
    return launches


def ssm_train_launches(L, n_attn):
    """A step's launches of a Mamba-2 (``n_attn`` 0) or hybrid model of ``L``
    Mamba-2 layers and ``n_attn`` applications of the shared attention block
    under remat: each layer's SSD forward (STATES) twice and its three
    backward kernels once; each application's flash forward twice and dQ,
    dK / dV once; every layer norm twice forward (one a Mamba-2 layer, two
    an attention block), the final norm once, each once backward."""
    norms = L + 2 * n_attn
    return {"ssd": 2 * L, "ssd_bwd_state": L, "ssd_bwd_chunk": L, "ssd_bwd_reduce": L,
            "flash_attention": 2 * n_attn, "flash_attention_bwd_dq": n_attn,
            "flash_attention_bwd_dkdv": n_attn, "rmsnorm": 2 * norms + 1,
            "rmsnorm_bwd": norms + 1, "rmsnorm_bwd_dw": norms + 1}


def train_mamba2_130m(dev):
    """The whole Mamba-2 130M (24 layers) through ``train_model``."""
    from repro_torch.configs import get_config

    cfg = get_config(MAMBA2)
    return train_model(dev, "train_mamba2_130m", cfg, ssm_train_launches(cfg.n_layers, 0))


def train_zamba2_7b(dev):
    """Zamba2 7B at full width, ``ZAMBA2_LAYERS`` (27) of 81 layers: four
    superblocks of 6 Mamba-2 layers, each followed by the tied shared
    attention block (D 112, 32 / 32 heads), and 3 trailing layers; 2.43e9
    parameters (the whole model's parameters, gradients and m / v would not
    fit the card), through ``train_model``."""
    from repro_torch.configs import get_config

    cfg = get_config(ZAMBA2).replace(n_layers=ZAMBA2_LAYERS)
    n_attn = cfg.n_layers // cfg.shared_attn_period
    return train_model(dev, "train_zamba2_7b", cfg, ssm_train_launches(cfg.n_layers, n_attn))


def greedy_trace(M, cfg, p, toks, lens, n, force=None, extra=None):
    """Prefill (the batch's ``extra`` entries beside the tokens: a front
    end's patch embeddings or frames), then ``n`` greedy decode steps (fed
    ``force``'s tokens when given). Returns the logits of the last valid
    position and of each step ([n + 1] x [B, V], float32 on the CPU) and the
    tokens [B, n + 1]."""
    import torch

    B, S = toks.shape
    logits, cache = M.prefill(cfg, p, {"tokens": toks, **(extra or {})}, pad_to=S + n + 1)
    cache["len"] = lens
    cur = logits[torch.arange(B, device=toks.device), lens.long() - 1]
    out_logits, out_toks = [], []
    for i in range(n + 1):
        out_logits.append(cur.float().cpu())
        tok = cur.argmax(-1) if force is None else force[:, i].to(toks.device)
        out_toks.append(tok.cpu())
        if i < n:
            lg, cache = M.decode_step(cfg, p, cache, tok[:, None])
            cur = lg[:, 0]
    return out_logits, torch.stack(out_toks, 1)


def serve_vs_cpu(dev, name, cfg, prompt_len, seed, extra=None):
    """``cfg`` (full width, random weights drawn on the card from seed 0 and
    copied to the CPU) on the card against the CPU (plain versions): one
    prompt of ``prompt_len`` tokens, padded as
    the engine pads it, with the batch entries ``extra(S)`` gives for the
    padded length S (CPU tensors, copied to the card), and 4 greedy decode
    steps (the card teacher-forced with the CPU's tokens); logits within
    ``LOGIT_TOL`` and tokens equal wherever the CPU's top-2 margin exceeds
    it."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.engine import pad_prompts

    p_gpu = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, prompt_len).tolist()
    n = 4
    t0 = time.perf_counter()
    toks, lens = pad_prompts([prompt], "cpu")
    ext = {} if extra is None else extra(toks.shape[1])
    want, cpu_toks = greedy_trace(M, cfg, p_cpu, toks, lens, n, extra=ext)
    cpu_s = time.perf_counter() - t0
    toks_g, lens_g = pad_prompts([prompt], dev)
    got, _ = greedy_trace(M, cfg, p_gpu, toks_g, lens_g, n, force=cpu_toks,
                          extra={k: v.to(dev) for k, v in ext.items()})
    errs, checked, equal = [], 0, 0
    for g, w in zip(got, want):
        errs.append(float((g - w).abs().max()))
        top2 = w.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > LOGIT_TOL
        checked += int(sure.sum())
        equal += int((g.argmax(-1) == w.argmax(-1))[sure].sum())
    phase(name, layers=cfg.n_layers, d_model=cfg.d_model,
          prompt_tokens=len(prompt), padded_to=int(toks.shape[1]), decode_steps=n,
          extra_inputs={k: list(v.shape) for k, v in ext.items()},
          max_abs_logit_err=errs, tol=LOGIT_TOL,
          max_abs_logit=float(max(w.abs().max() for w in want)),
          tokens_checked=checked, tokens_equal=equal, cpu_s=cpu_s)
    check(all(np.isfinite(errs)) and max(errs) <= LOGIT_TOL,
          f"{name}: card logits differ from the CPU's by {max(errs)}")
    check(equal == checked, f"{name}: greedy tokens differ: {equal} of {checked}")
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


@contextlib.contextmanager
def routing_recorded():
    """Within the block, each call of the port's ``models.moe.moe_block``
    first appends to the list yielded its routing, recomputed from the same
    input and router: the top-k expert ids [T, k] and each token's router
    margin [T] (the k-th probability less the next one), on the CPU."""
    import torch

    from repro_torch.models import moe as MOE

    records, inner = [], MOE.moe_block

    def recorded(p, x, *, cfg, **kw):
        probs = torch.softmax(MOE.router_logits(x.reshape(-1, x.shape[-1]), p["router"]), -1)
        k = cfg.moe_top_k
        top = torch.topk(probs, k + 1, dim=-1)
        records.append((top.indices[:, :k].cpu(),
                        (top.values[:, k - 1] - top.values[:, k]).cpu()))
        return inner(p, x, cfg=cfg, **kw)

    MOE.moe_block = recorded
    try:
        yield records
    finally:
        MOE.moe_block = inner


def routing_agreement(got, want, n_layers, exact):
    """The card's routing records (``models.moe``: top-k ids and margin a
    MoE layer and call) against the CPU's: per call, per position, whether
    every layer routed it alike. ``exact`` (float32) demands every position;
    otherwise a position routed differently must have had a CPU margin below
    ``ROUTE_MARGIN`` in the first layer that differs, and at most
    ``MAX_FLIP_SHARE`` of the positions may. Returns (agree per call,
    positions routed differently, layer decisions below the margin)."""
    import numpy as np

    check(len(got) == len(want), f"{len(got)} routing records on the card, {len(want)} on the CPU")
    agree, flips, near = [], 0, 0
    for c in range(0, len(want), n_layers):
        same = np.stack([(np.sort(g[0].numpy(), -1) == np.sort(w[0].numpy(), -1)).all(-1)
                         for g, w in zip(got[c:c + n_layers], want[c:c + n_layers])])
        margin = np.stack([w[1].numpy() for w in want[c:c + n_layers]])  # [layers, T]
        near += int((margin < ROUTE_MARGIN).sum())
        ok = same.all(0)
        bad = np.nonzero(~ok)[0]
        first = np.argmin(same[:, bad], axis=0)
        check(exact and not len(bad) or not exact and (margin[first, bad] < ROUTE_MARGIN).all(),
              f"routing differs at positions {bad.tolist()} (margins "
              f"{margin[first, bad].tolist()}; float32: {exact})")
        flips += len(bad)
        agree.append(ok)
    total = sum(a.size for a in agree)
    check(flips <= MAX_FLIP_SHARE * total,
          f"{flips} of {total} positions routed differently on the card")
    return agree, flips, near


def moe_serve_vs_cpu(dev, name, cfg, prompt_len, seed):
    """A MoE ``cfg`` (full width, random weights drawn on the card from seed
    0 and copied to the CPU) on the card against the CPU, as
    ``serve_vs_cpu`` (one prompt, 4 decode steps, the card teacher-forced
    with the CPU's tokens) in bf16 and in float32 (the same weights,
    widened), under the routing rule (``routing_agreement``): logits within
    ``MOE_LOGIT_TOL[dtype]`` at each step whose position was routed alike in
    every layer, tokens equal there where the CPU's top-2 margin exceeds
    it."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.engine import pad_prompts

    L = cfg.n_layers - cfg.first_k_dense
    n = 4
    p_gpu = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size, prompt_len).tolist()
    toks, lens = pad_prompts([prompt], "cpu")
    toks_g, lens_g = pad_prompts([prompt], dev)
    last = int(lens[0]) - 1
    legs, failed = {}, []
    for dtype in ("bfloat16", "float32"):
        if dtype == "float32":
            p_cpu, p_gpu = p_cpu.float(), p_gpu.float()
        tol = MOE_LOGIT_TOL[dtype]
        t0 = time.perf_counter()
        with routing_recorded() as r_cpu:
            want, cpu_toks = greedy_trace(M, cfg, p_cpu, toks, lens, n)
        cpu_s = time.perf_counter() - t0
        with routing_recorded() as r_gpu:
            got, _ = greedy_trace(M, cfg, p_gpu, toks_g, lens_g, n, force=cpu_toks)
        agree, flips, near = routing_agreement(r_gpu, r_cpu, L, dtype == "float32")
        # the prefill's logits are its last valid position's
        routed = [bool(agree[0][last])] + [bool(a[0]) for a in agree[1:]]
        errs, checked, equal = [], 0, 0
        for g, w, ok in zip(got, want, routed):
            if not ok:
                continue
            errs.append(float((g - w).abs().max()))
            top2 = w.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]) > tol
            checked += int(sure.sum())
            equal += int((g.argmax(-1) == w.argmax(-1))[sure].sum())
        legs[dtype] = dict(max_abs_logit_err=errs, tol=tol, steps_compared=len(errs),
                           max_abs_logit=float(max(w.abs().max() for w in want)),
                           positions_routed_differently=flips,
                           decisions_below_margin=near,
                           positions=sum(a.size for a in agree),
                           tokens_checked=checked, tokens_equal=equal, cpu_s=cpu_s)
        if not (len(errs) >= n and all(np.isfinite(errs)) and max(errs) <= tol):
            failed.append(f"{dtype}: card logits differ from the CPU's: {errs}")
        if equal != checked:
            failed.append(f"{dtype}: greedy tokens differ: {equal} of {checked}")
    phase(name, layers=cfg.n_layers, d_model=cfg.d_model, experts=cfg.n_experts,
          top_k=cfg.moe_top_k, prompt_tokens=len(prompt), padded_to=int(toks.shape[1]),
          decode_steps=n, route_margin=ROUTE_MARGIN, max_flip_share=MAX_FLIP_SHARE, **legs)
    check(not failed, f"{name}: {failed}")
    del p_cpu, p_gpu
    torch.cuda.empty_cache()


def moe_drop_vs_cpu(dev, cfg, B=4, S=128):
    """One MoE layer of ``cfg`` at full width in float32 with capacity
    factor 0.25 (three quarters of the assignments past capacity), on the
    card and on the CPU: routing equal, ``dropped_frac`` equal, the output
    within ``MOE_TOL``. Then the same layer in its serving dtypes (bf16, the
    router float32) on the card under ``torch.cuda.set_sync_debug_mode
    ("error")``: no host read inside the layer (the float32 grouped product
    is PyTorch's fallback, which reads the offsets; bf16 is one kernel)."""
    import copy

    import numpy as np
    import torch

    from repro_torch.models import moe as MOE
    from repro_torch.models.spec import init_tree

    p_bf = init_tree(MOE.moe_schema(cfg), torch.Generator(device=dev).manual_seed(3), dev)
    p_gpu = copy.deepcopy(p_bf).float()
    p_cpu = copy.deepcopy(p_gpu).to("cpu")
    x = randn(np.random.default_rng(14), (B, S, cfg.d_model), torch.float32, "cpu")
    t0 = time.perf_counter()
    with routing_recorded() as r_cpu:
        want, aux_w = MOE.moe_block(p_cpu, x, cfg=cfg, capacity_factor=0.25)
    cpu_s = time.perf_counter() - t0
    with routing_recorded() as r_gpu:
        got, aux_g = MOE.moe_block(p_gpu, x.to(dev), cfg=cfg, capacity_factor=0.25)
    routing_agreement(r_gpu, r_cpu, 1, True)
    del p_gpu, p_cpu
    xb = x.to(dev, torch.bfloat16)
    MOE.moe_block(p_bf, xb, cfg=cfg, capacity_factor=0.25)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        MOE.moe_block(p_bf, xb, cfg=cfg, capacity_factor=0.25)
        MOE.moe_block(p_bf, xb[:, :1], cfg=cfg)  # a decode step's shape
    finally:
        torch.cuda.set_sync_debug_mode("default")
    err, ok = close_err(got.cpu(), want, MOE_TOL)
    dropped = (float(aux_g["dropped_frac"]), float(aux_w["dropped_frac"]))
    phase("moe_drop_vs_cpu", d_model=cfg.d_model, experts=cfg.n_experts, tokens=B * S,
          capacity_factor=0.25,
          rows=MOE.capacity_rows(0.25, B * S, cfg.moe_top_k, cfg.n_experts),
          dropped_frac=dropped, max_abs_err=err, tol=MOE_TOL,
          max_abs_out=float(want.abs().max()),
          aux_card={k: float(v) for k, v in aux_g.items()},
          aux_cpu={k: float(v) for k, v in aux_w.items()}, cpu_s=cpu_s,
          bf16_no_host_sync=True)
    check(dropped[0] == dropped[1] == 0.75, f"moe_drop_vs_cpu: dropped {dropped}")
    check(ok, f"moe_drop_vs_cpu: card output differs from the CPU's by {err}")
    del p_bf
    torch.cuda.empty_cache()


MOE_GRAD_REL = 1e-2  # bf16 against float32: of each gradient's largest value


def moe_grouped_bwd(dev):
    """The MoE backward on the card at DeepSeek-V2's expert shape (160
    experts, d 5120, d_ff 1536; 2048 tokens, top-6). First the grouped
    SwiGLU product alone: ``torch._grouped_mm``'s bf16 autograd (the weight
    gradients' groups run over the rows) against a float32 loop over the
    experts under plain autograd, on the same (upcast) inputs, every
    gradient within ``MOE_GRAD_REL`` of its largest value. Then the whole
    ``moe_block`` (float32 router, softmax and top-k, the stable sort, the
    capacity rows, the grouped products, the float32 ``index_add_`` combine,
    the shared experts, the aux losses) forward and backward in bf16 under
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing read back to the
    host), at the config's capacity factor and at 0.25 (three quarters
    dropped), against the same layer's float32 autograd on the upcast
    parameters, every gradient within ``MOE_GRAD_REL``."""
    import copy

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.spec import init_tree

    t0 = time.perf_counter()
    cfg = get_config(DEEPSEEK)
    E, d, k, T = cfg.n_experts, cfg.d_model, cfg.moe_top_k, 2048
    gen = torch.Generator(device=dev).manual_seed(57)
    p_bf = init_tree(MOE.moe_schema(cfg), gen, dev)
    # the grouped product alone: each token's top-6 of random scores, the
    # rows sorted by expert
    eid = torch.rand((T, E), generator=gen, device=dev).topk(k, -1).indices.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    offs = torch.cumsum(torch.bincount(eid, minlength=E), 0).to(torch.int32)
    x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
    xg = x[order // k]
    dy = torch.randn((T * k, d), generator=gen, device=dev).to(torch.bfloat16)
    ws = [p_bf[n].detach().requires_grad_(True) for n in ("w1", "w3", "w2")]
    xl = xg.clone().requires_grad_(True)
    with torch.enable_grad():
        y = torch._grouped_mm(F.silu(torch._grouped_mm(xl, ws[0], offs=offs))
                              * torch._grouped_mm(xl, ws[1], offs=offs), ws[2], offs=offs)
        y.backward(dy)
    got = {"y": y.detach(), "dx": xl.grad, "dw1": ws[0].grad, "dw3": ws[1].grad,
           "dw2": ws[2].grad}
    w32 = [w.detach().float().requires_grad_(True) for w in ws]
    x32 = xg.float().requires_grad_(True)
    ends = [0] + offs.tolist()
    with torch.enable_grad():
        y32 = torch.cat([
            (F.silu(x32[a:b] @ w32[0][e]) * (x32[a:b] @ w32[1][e])) @ w32[2][e]
            for e, (a, b) in enumerate(zip(ends[:-1], ends[1:]))])
        y32.backward(dy.float())
    want = {"y": y32.detach(), "dx": x32.grad, "dw1": w32[0].grad, "dw3": w32[1].grad,
            "dw2": w32[2].grad}
    grouped = {n: rel_err(got[n], want[n]) for n in got}
    del ws, xl, y, y32, x32, got, want, xg, dy
    for w in w32:
        w.grad = None
    torch.cuda.empty_cache()

    # the whole layer: bf16 under the sync check, then float32
    xb = torch.randn((4, T // 4, d), generator=gen, device=dev).to(torch.bfloat16)
    dout = torch.randn((4, T // 4, d), generator=gen, device=dev).to(torch.bfloat16)
    p32 = copy.deepcopy(p_bf).float()

    def layer_grads(p, x_, cf, sync_check=False):
        leaves = dict(p.named_parameters())
        for t in leaves.values():
            t.requires_grad_(True)
            t.grad = None
        xl_ = x_.detach().clone().requires_grad_(True)
        if sync_check:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.enable_grad():
                out, aux = MOE.moe_block(p, xl_, cfg=cfg, capacity_factor=cf)
                loss = ((out.float() * dout.float()).sum() + aux["lb_loss"] + aux["router_z"])
                loss.backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        grads = {"dx": xl_.grad, **{n: t.grad for n, t in leaves.items()}}
        for t in leaves.values():
            t.grad = None
        return grads, float(aux["dropped_frac"])

    block = {}
    for cf in (None, 0.25):
        gb, drop_b = layer_grads(p_bf, xb, cf, sync_check=True)
        g32, drop_32 = layer_grads(p32, xb.float(), cf)
        check(drop_b == drop_32, f"moe_grouped_bwd: dropped {drop_b} in bf16, {drop_32} in float32")
        block[f"capacity_factor_{cf or cfg.moe_capacity_factor}"] = {
            "dropped_frac": drop_b, **{n: rel_err(gb[n], g32[n]) for n in gb}}
        del gb, g32
        torch.cuda.empty_cache()
    del p_bf, p32, w32
    torch.cuda.empty_cache()
    worst = max(v for rows in (grouped, *block.values()) for n, v in rows.items()
                if n != "dropped_frac" and v is not None)
    phase("moe_grouped_bwd", experts=E, d_model=d, d_ff=cfg.moe_d_ff, tokens=T, top_k=k,
          grouped_rel_f32=grouped, moe_block_rel_f32=block, tol=MOE_GRAD_REL,
          bf16_no_host_sync=True, seconds=time.perf_counter() - t0)
    check(worst <= MOE_GRAD_REL, f"moe_grouped_bwd: a bf16 gradient is {worst} of its "
          "largest value from float32")
    return worst


def moe_decode_bound(cfg, params, cache, tokens):
    """Bytes one decode step of the MoE ``cfg`` must move, counted for this
    step's data: every weight but the routed experts read once (the
    parameter tree's bytes less the routed experts': the tied embedding,
    read for the logits, the norms, each layer's attention weights, GQA's
    or MLA's, the ``first_k_dense`` dense layers' MLPs, the routers and the
    shared experts), the routed experts this step's B tokens pick (read
    once each), the cache (``cache_step_bytes``: K / V, or MLA's ``ckv`` /
    ``krope``), the embedding rows read and the logits written. Its
    operations: the products of every weight read but the routed experts
    with the B tokens, and of the top-k experts each token picks. Runs one
    decode step with routing recorded (on a copy of the cache). Returns
    the bound fields and the experts read a layer."""
    import copy

    from repro_torch.models import model as M

    with routing_recorded() as routing:
        M.decode_step(cfg, params, copy.deepcopy(cache), tokens)
    experts = [len(set(e.reshape(-1).tolist())) for e, _ in routing]
    d, ff, V = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.vocab_size
    B = tokens.shape[0]
    other = [t for name, t in params.named_parameters()
             if not name.endswith(("moe.w1", "moe.w2", "moe.w3"))]
    other_bytes = sum(t.numel() * t.element_size() for t in other)
    expert_bytes = 3 * d * ff * 2  # one routed expert's w1, w3 and w2 in bf16
    kv_read, kv_written = cache_step_bytes(cache)
    nbytes = (other_bytes + expert_bytes * sum(experts) + kv_read + kv_written
              + B * d * 2 + B * V * 4)
    nops = 2 * B * (sum(t.numel() for t in other) + len(experts) * cfg.moe_top_k * 3 * d * ff)
    return {**bound_fields(nbytes, nops, BF16_FLOPS_PER_S),
            "bound_bytes": nbytes, "routed_experts_read_per_layer": experts,
            "other_weight_bytes": other_bytes, "kv_bytes_read": kv_read,
            "kv_bytes_written": kv_written}


def ddp_demo(dev):
    """``noc_explore --workload ddp`` on the mesh: the gradient all-reduce of
    ``llama4-scout-17b-a16e`` (reduced; its bytes from the MoE parameter
    count) through ``ml_traffic.validate_phase`` on the card, counted, and
    on the CPU: measured cycles, model estimate and delivery equal, every
    byte delivered; the step report beside them."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.noc import ml_traffic as ML
    from repro_torch.core.noc import collective_traffic as CT
    from repro_torch.core.noc.spec import preset

    topo, params = preset("mesh").lower()
    cfg = get_config(LLAMA4).reduced()
    par_kw, tokens = ML.DEMO_SPECS["ddp"]
    (ph,) = ML.compile_traffic(cfg, ML.ParallelismSpec(**par_kw), topo,
                               tokens_per_device=tokens, sim_cap_kb=16, workloads=["ddp"])
    counts = router_launches_reset()
    t0 = time.perf_counter()
    got = ML.validate_phase(topo, ph, params, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    want = ML.validate_phase(topo, ph, params, device="cpu")
    cycles = int(CT.analytical_cycles(ph.sim_schedule, params, topo) * 1.5) + 500
    check(launches == expected_launches(params, cycles),
          f"ddp demo launches {launches}, expected {expected_launches(params, cycles)}")
    check(got == want and got["delivered"], f"ddp demo on the card {got}, on the CPU {want}")
    phase("ddp_demo", model=cfg.name, params=cfg.n_params(), fabric=topo.name,
          cycles=cycles, launches=launches, card=got, cpu=want,
          step_report=ML.step_report([ph], params, topo), wall_s=wall,
          ms_per_cycle=wall / cycles * 1e3)
    return launches


def launch_counters():
    """The ``LAUNCHES`` dicts of the model kernels (flash attention,
    RMSNorm, SSD)."""
    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.ssd import ssd as SK

    return (FK.LAUNCHES, RK.LAUNCHES, SK.LAUNCHES)


def call_profile(fn, wall_ms, grad=False):
    """Device activity of one ``fn()`` call under ``torch.profiler`` (with
    ``grad``, autograd on, as a training step runs): device events, device
    time, the busy share of an unprofiled call (``wall_ms``) and the kernels
    that take most device time. ``None`` where the profiler reports no
    device activity."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    saved = [dict(c) for c in launch_counters()]
    with contextlib.nullcontext() if grad else torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for c, s in zip(launch_counters(), saved):
        c.update(s)
    by_name = collections.Counter()
    n_events = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] += e.time_range.elapsed_us()
            n_events += 1
    if not n_events:
        return {"device_events": 0, "busy_share": None}
    dev_us = sum(by_name.values())
    return {"device_events": n_events, "device_us": dev_us,
            "busy_share": dev_us / (wall_ms * 1e3),
            "top_us": dict(by_name.most_common(6))}


def serve_model(dev, name, cfg, prompts, per_prefill, per_decode, n_new=16,
                decode_bound=None):
    """``cfg`` at full width (and depth, unless the caller cut it) through
    ``Engine.generate``: the prompts (right-padded to a power of two),
    ``n_new`` greedy tokens, twice, each run's kernel launches checked
    against one prefill's (``per_prefill``) and ``n_new - 1`` decode steps'
    (``per_decode``); then the same prefill and decode steps one by one,
    timed and counted. ``decode_bound(cfg, params, cache, tokens)``, when
    given, adds a decode step's bound to the line. Returns the generate
    run's kernel launches."""
    import numpy as np
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve.engine import frontend_stub, pad_prompts

    def counts():
        return {k: v for c in launch_counters() for k, v in c.items()}

    def reset():
        torch.cuda.synchronize()
        for c in launch_counters():
            c.update(dict.fromkeys(c, 0))

    def expect(n_prefill, n_decode):
        return {k: n_prefill * per_prefill.get(k, 0) + n_decode * per_decode.get(k, 0)
                for k in counts()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in params.parameters())
    eng = Engine(cfg, params, scfg=ServeConfig(max_new_tokens=n_new))
    runs = []
    for _ in range(2):
        reset()
        t0 = time.perf_counter()
        outs = eng.generate(prompts)
        torch.cuda.synchronize()
        runs.append((outs, time.perf_counter() - t0, counts()))
    (outs, gen1_s, launches), (outs2, gen2_s, launches2) = runs
    # one prefill and a decode step after each new token but the last
    want = expect(1, n_new - 1)
    check(launches == want == launches2, f"{name}: generate launched {launches} / "
          f"{launches2}, expected {want}")
    check(outs == outs2, f"{name}: two greedy runs gave different tokens")
    check(all(len(o) == n_new and all(0 <= t < cfg.vocab_size for t in o) for o in outs),
          f"{name}: generate returned malformed tokens")

    # the same work one call at a time: prefill, then the decode steps fed
    # the engine's tokens, each checked against the engine and timed
    toks, lens = pad_prompts(prompts, dev)
    B, S = toks.shape
    batch = {"tokens": toks, **frontend_stub(cfg, B, S, dev)}  # the engine's batch
    reset()
    t0 = time.perf_counter()
    logits, cache = M.prefill(cfg, params, batch, pad_to=S + n_new + 1)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    check(counts() == expect(1, 0), f"{name}: prefill launched {counts()}")
    finite = bool(torch.isfinite(logits).all())
    cache["len"] = lens
    cur = logits[torch.arange(B, device=dev), lens.long() - 1]
    del logits
    gen = torch.tensor(outs, device=dev)  # [B, n_new]
    agree = bool((cur.argmax(-1) == gen[:, 0]).all())
    step_ms = []
    for i in range(n_new - 1):
        reset()
        t0 = time.perf_counter()
        lg, cache = M.decode_step(cfg, params, cache, gen[:, i:i + 1])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        check(counts() == expect(0, 1), f"{name}: decode step launched {counts()}")
        finite &= bool(torch.isfinite(lg).all())
        agree &= bool((lg[:, 0].argmax(-1) == gen[:, i + 1]).all())
    peak = torch.cuda.max_memory_allocated()
    decode_ms = statistics.median(step_ms)
    prof_prefill = call_profile(lambda: M.prefill(
        cfg, params, batch, pad_to=S + n_new + 1), prefill_ms)
    prof_decode = call_profile(lambda: M.decode_step(
        cfg, params, cache, gen[:, -1:]), decode_ms)
    bound = {} if decode_bound is None else decode_bound(cfg, params, cache, gen[:, -1:])

    def nbytes(tree, kind):
        """Bytes of the cache's leaves of one ``kind``: "kv" (K/V or MLA's),
        "cross" (an encoder-decoder's ``ck`` / ``cv`` and ``enc_out``) or
        "ssm" (the rest, but the lengths)."""
        total = 0
        for k, v in tree.items():
            if isinstance(v, dict):
                total += nbytes(v, kind)
            elif k not in ("len", "enc_len") and kind == (
                    "kv" if k in M.SEQ_DIM else "cross" if k in CROSS_CACHE else "ssm"):
                total += v.numel() * v.element_size()
        return total

    phase(name, layers=cfg.n_layers, d_model=cfg.d_model, batch=B,
          **({"enc_layers": cfg.n_enc_layers, "dec_layers": cfg.n_dec_layers}
             if cfg.family == "encdec" else {}),
          prompt_tokens=[len(p_) for p_ in prompts], padded_to=S, new_tokens=n_new,
          frontend_stub={k: list(v.shape) for k, v in batch.items() if k != "tokens"},
          launches_per_generate=launches, tokens_identical_two_runs=True,
          steps_reproduce_engine_tokens=agree, logits_finite=finite,
          init_s=init_s, generate_s=[gen1_s, gen2_s], prefill_ms=prefill_ms,
          decode_ms_per_step=decode_ms, decode_ms_per_step_all=step_ms,
          decode_tokens_per_s=B / decode_ms * 1e3,
          generate_tokens_per_s=B * n_new / gen2_s,
          weight_bytes=weight_bytes, kv_cache_bytes=nbytes(cache, "kv"),
          cross_cache_bytes=nbytes(cache, "cross"), ssm_cache_bytes=nbytes(cache, "ssm"),
          peak_device_bytes=peak, peak_above_earlier_phases_bytes=peak - held,
          **({"decode_step_bound": bound} if bound else {}))
    phase("profile_" + name, prefill=prof_prefill, decode_step=prof_decode)
    check(finite, f"{name}: non-finite logits")
    check(agree, f"{name}: one-call-at-a-time steps do not reproduce the engine's tokens")
    del params, cache, eng
    torch.cuda.empty_cache()
    return launches


def serve_models(dev):
    """The eight serving paths at full width (and depth, but for
    Llama-4-Scout's ``LLAMA4_LAYERS``, Zamba2's ``ZAMBA2_LAYERS``,
    DeepSeek-V2's ``DEEPSEEK_LAYERS`` and Qwen2-VL's ``QWEN2VL_LAYERS``),
    each
    driven with the launch counts
    set to 0 just before it and read just after. Returns each path's
    generate launches."""
    import numpy as np

    from repro_torch.configs import get_config

    out = {}
    cfg = get_config(PHI4)
    L = cfg.n_layers
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(300, 501, 4)]
    # ln1 and ln2 of each layer, then the final norm
    out["serve_phi4_mini"] = serve_model(dev, "serve_phi4_mini", cfg, prompts,
                                         {"flash_attention": L, "rmsnorm": 2 * L + 1},
                                         {"rmsnorm": 2 * L + 1})
    # equal 512-token prompts: no pad tail for the SSM state to absorb
    cfg = get_config(MAMBA2)
    L = cfg.n_layers
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, 512).tolist() for _ in range(4)]
    out["serve_mamba2_130m"] = serve_model(dev, "serve_mamba2_130m", cfg, prompts,
                                           {"ssd": L, "rmsnorm": L + 1},
                                           {"rmsnorm": L + 1})
    cfg = get_config(ZAMBA2).replace(n_layers=ZAMBA2_LAYERS)
    L, n_attn = cfg.n_layers, cfg.n_layers // cfg.shared_attn_period
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, 512).tolist() for _ in range(4)]
    norms = L + 2 * n_attn + 1  # each SSM layer's, ln1 and ln2 per attention, final
    out["serve_zamba2_7b"] = serve_model(dev, "serve_zamba2_7b", cfg, prompts,
                                         {"ssd": L, "flash_attention": n_attn,
                                          "rmsnorm": norms}, {"rmsnorm": norms})
    # full width, cut to LLAMA4_LAYERS of 48 layers (the whole model does not
    # fit the card); the earlier models are freed
    cfg = get_config(LLAMA4).replace(n_layers=LLAMA4_LAYERS)
    L = cfg.n_layers
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(300, 501, 4)]
    out["serve_llama4_scout"] = serve_model(dev, "serve_llama4_scout", cfg, prompts,
                                            {"flash_attention": L, "rmsnorm": 2 * L + 1},
                                            {"rmsnorm": 2 * L + 1},
                                            decode_bound=moe_decode_bound)
    # Gemma 3 4B whole: 4 prompts of 2048 tokens, twice the window, so the
    # prefill masks the window in 29 of its 34 layers and the decode steps
    # wrap every ring
    cfg = get_config(GEMMA3)
    L = cfg.n_layers
    rng = np.random.default_rng(27)
    prompts = [rng.integers(0, cfg.vocab_size, 2048).tolist() for _ in range(4)]
    out["serve_gemma3_4b"] = serve_model(dev, "serve_gemma3_4b", cfg, prompts,
                                         {"flash_attention": L, "rmsnorm": 2 * L + 1},
                                         {"rmsnorm": 2 * L + 1},
                                         decode_bound=dense_decode_bound)
    # DeepSeek-V2 at full width, cut to DEEPSEEK_LAYERS of 60 layers: MLA
    # attention (flash at D = 192, Dv = 128 in each prefill layer; the
    # absorbed decode over the compressed cache), ln1, q_norm, kv_norm and
    # ln2 in each layer, then the final norm
    cfg = get_config(DEEPSEEK).replace(n_layers=DEEPSEEK_LAYERS)
    L = cfg.n_layers
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(300, 501, 4)]
    out["serve_deepseek_v2"] = serve_model(dev, "serve_deepseek_v2", cfg, prompts,
                                           {"flash_attention": L, "rmsnorm": 4 * L + 1},
                                           {"rmsnorm": 4 * L + 1},
                                           decode_bound=moe_decode_bound)
    # Qwen2-VL at full width, cut to QWEN2VL_LAYERS of 80 layers: the
    # engine's zero patch stub in the first 256 slots (a 16 x 16 grid of
    # M-RoPE positions), then the text
    cfg = get_config(QWEN2VL).replace(n_layers=QWEN2VL_LAYERS)
    L = cfg.n_layers
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(300, 501, 4)]
    out["serve_qwen2_vl"] = serve_model(dev, "serve_qwen2_vl", cfg, prompts,
                                        {"flash_attention": L, "rmsnorm": 2 * L + 1},
                                        {"rmsnorm": 2 * L + 1},
                                        decode_bound=dense_decode_bound)
    # SeamlessM4T whole: the encoder over the engine's zero frames (as many
    # as the padded prompt's tokens), then the decoder; flash in each encoder
    # layer and in each decoder layer's self- and cross-attention, two norms
    # an encoder layer and three a decoder layer, each stack's final norm.
    # Decode runs the decoder alone
    cfg = get_config(SEAMLESS)
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_dec_layers
    rng = np.random.default_rng(38)
    prompts = [rng.integers(0, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(300, 501, 4)]
    out["serve_seamless_m4t"] = serve_model(
        dev, "serve_seamless_m4t", cfg, prompts,
        {"flash_attention": n_enc + 2 * n_dec, "rmsnorm": 2 * n_enc + 1 + 3 * n_dec + 1},
        {"rmsnorm": 3 * n_dec + 1}, decode_bound=encdec_decode_bound)
    return out


def visible_pairs(S, window=0):
    """The (q, k) pairs that causal attention over S positions computes:
    row i sees min(i + 1, window) keys (i + 1 without a window)."""
    W = min(window or S, S)
    return W * (W + 1) // 2 + (S - W) * W


def cache_step_bytes(cache):
    """(bytes a decode step reads from the cache, bytes it writes there):
    each layer's K / V (or MLA's ``ckv`` / ``krope``) over each sequence's
    valid prefix with the new slot (a ring: at most its slots) read once,
    and the new slot written."""
    from repro_torch.models.model import SEQ_DIM

    lens = cache["len"].tolist()
    read = written = 0

    def walk(tree):
        nonlocal read, written
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif key in SEQ_DIM:
                sd = SEQ_DIM[key]
                layers = v.shape[:sd - 1].numel()  # the stacked layers, before B
                slot = v.shape[sd + 1:].numel() * v.element_size()  # one sequence's
                read += layers * sum(min(n + 1, v.shape[sd]) for n in lens) * slot
                written += layers * len(lens) * slot

    walk({k: v for k, v in cache.items() if k != "len"})
    return read, written


def step_weights(params, skip=()):
    """(bytes, count) of the parameters but those under the top-level keys
    in ``skip``."""
    ws = [t for name, t in params.named_parameters() if name.split(".")[0] not in skip]
    return sum(t.numel() * t.element_size() for t in ws), sum(t.numel() for t in ws)


def dense_decode_bound(cfg, params, cache, tokens):
    """A dense decode step's least time: every weight it reads once (the
    tied embedding too, for the unembed; a vision model's ``patch_proj``
    only in the prefill) and the cache read and written
    (``cache_step_bytes``), at the memory rate. The products (2 x weights
    x B) are far below it."""
    B = tokens.shape[0]
    weight_bytes, n_weights = step_weights(params, skip=("patch_proj",))
    kv_read, kv_written = cache_step_bytes(cache)
    nbytes = weight_bytes + kv_read + kv_written
    return {"weight_bytes": weight_bytes, "kv_bytes_read": kv_read,
            "kv_bytes_written": kv_written,
            **bound_fields(nbytes, 2 * n_weights * B, BF16_FLOPS_PER_S)}


def encdec_decode_bound(cfg, params, cache, tokens):
    """An encoder-decoder's decode step's least time: the weights it reads
    once (the decoder's blocks, the final norm and the tied embedding; one
    ``dec_pos`` row a sequence; not the encoder, ``frame_proj`` or
    ``enc_pos``), the self-attention's K/V read and written
    (``cache_step_bytes``) and the cross-attention's ``ck`` / ``cv`` read
    over each sequence's ``enc_len``, at the memory rate. The products (2 x
    weights x B) are far below it."""
    B = tokens.shape[0]
    weight_bytes, n_weights = step_weights(
        params, skip=("frame_proj", "enc_pos", "dec_pos", "enc_blocks", "enc_final_norm"))
    weight_bytes += B * cfg.d_model * params["dec_pos"].element_size()
    kv_read, kv_written = cache_step_bytes(cache)
    ck = cache["dec_blocks"]["ck"]  # [layers, B, S_enc, KV, D]
    row = ck.shape[0] * ck.shape[3] * ck.shape[4] * ck.element_size()  # a position's, all layers
    cross_read = 2 * row * sum(cache["enc_len"].tolist())
    nbytes = weight_bytes + kv_read + kv_written + cross_read
    return {"weight_bytes": weight_bytes, "kv_bytes_read": kv_read,
            "kv_bytes_written": kv_written, "cross_kv_bytes_read": cross_read,
            **bound_fields(nbytes, 2 * n_weights * B, BF16_FLOPS_PER_S)}


def attn_bound(B, S, H, KV, D, Dv, itemsize, window=0, causal=True):
    """Least time of causal attention (with a sliding window, only the
    pairs inside it; not causal, all S x S pairs): the visible (q, k)
    pairs' two products at the bf16 tensor-core peak, or q, k, v read once
    and the output written once at the memory rate, whichever is larger."""
    pairs = visible_pairs(S, window) if causal else S * S
    flops = 2 * (D + Dv) * pairs * B * H
    nbytes = B * S * (H * D + KV * D + KV * Dv + H * Dv) * itemsize
    return bound_fields(nbytes, flops, BF16_FLOPS_PER_S)


def ssd_bound(B, S, H, P, N, Q, itemsize):
    """Least time of the SSD scan (S a multiple of Q, no entering state):
    x, dt, B, C, A_log and D read once, y and the final state written once
    in float32; or the products at the bf16 tensor-core peak: C.B^T's
    causal pairs once per (batch, chunk) (the heads share B and C), and per
    head the masked M x, C.S_prev (chunks after the first) and the state
    update, whichever is larger."""
    nC = S // Q
    pairs = Q * (Q + 1) // 2
    flops = 2 * B * (nC * pairs * N + H * (nC * pairs * P + (2 * nC - 1) * Q * N * P))
    nbytes = (B * S * H * P * itemsize + B * S * H * 4 + 2 * B * S * N * itemsize
              + 2 * H * 4 + B * S * H * P * 4 + B * H * P * N * 4)
    return bound_fields(nbytes, flops, BF16_FLOPS_PER_S)


def bound_fields(nbytes, nops, ops_per_s=SCALAR_OPS_PER_S):
    """``bound`` as the ``bound_ms`` / ``bound_by`` fields of a row."""
    return dict(zip(("bound_ms", "bound_by"), bound(nbytes, nops, ops_per_s)))


def top_kernel(fn):
    """The device kernel that takes most of one ``fn()`` call's time under
    ``torch.profiler`` (``None`` where it records no device activity)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:80]] += e.time_range.elapsed_us()
    return by_name.most_common(1)[0][0] if by_name else None


def time_model_kernels(dev):
    """Each kernel at the serve paths' shapes: kernel, plain version and one
    PyTorch call where there is one (the yardstick the port never calls),
    with the bound."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend

    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref
    from repro_torch.kernels.ssd import ssd as SK
    from repro_torch.kernels.ssd.ref import ssd_chunked_ref

    rng = np.random.default_rng(7)
    bf = torch.bfloat16
    out = {}
    for key, B, S, H, KV, D in (("flash_attention", 4, 512, 24, 8, 128),
                                ("flash_attention_d112", 4, 512, 32, 32, 112),
                                ("flash_attention_llama4", 4, 512, 40, 8, 128)):
        q, k, v = (randn(rng, sh, bf, dev) for sh in
                   ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # [B, heads, S, D]
        out[key] = {
            "ms": graph_ms(lambda: FK.flash_attention_cuda(q, k, v), reps=20),
            "plain_ms": graph_ms(lambda: attention_ref(q, k, v), reps=20),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), reps=20),
            **attn_bound(B, S, H, KV, D, D, 2),
            "shape": f"B={B}, S={S}, H={H}, KV={KV}, D=Dv={D}, bf16, causal"}
    # Gemma 3's prefill (B 4, S 2048, 8 / 4 heads of 256): its local layers'
    # window of 1024 (SDPA's yardstick takes the band as a boolean mask) and
    # its global layers
    gemma_rng = np.random.default_rng(26)  # rng's draws stay as they were
    B, S, H, KV, D = 4, 2048, 8, 4, 256
    q, k, v = (randn(gemma_rng, sh, bf, dev) for sh in
               ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    pos = torch.arange(S, device=dev)
    dist = pos[:, None] - pos[None, :]  # query position less key position
    for key, window in (("flash_attention_gemma3_window", 1024),
                        ("flash_attention_gemma3_global", 0)):
        sdpa_kw = {"attn_mask": (dist >= 0) & (dist < window)} if window else {"is_causal": True}

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True, **sdpa_kw)

        # the backend SDPA dispatches these inputs to, and the kernel it ran
        choice = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, enable_gqa=True, **sdpa_kw))
        out[key] = {
            "ms": graph_ms(lambda: FK.flash_attention_cuda(q, k, v, window=window), reps=10),
            "plain_ms": graph_ms(lambda: attention_ref(q, k, v, window=window), reps=3),
            "library_ms": graph_ms(sdpa, reps=10), "library_backend": choice.name,
            "library_kernel": top_kernel(sdpa),
            **attn_bound(B, S, H, KV, D, D, 2, window),
            "shape": f"B={B}, S={S}, H={H}, KV={KV}, D=Dv={D}, bf16, causal, "
                     f"window {window or 'none'}"}
    # DeepSeek-V2's MLA prefill: 128 heads, each its own KV head, D = 192
    # (128 + 64 rotary columns), Dv = 128; SDPA takes k's and v's head dims
    # as they are
    mla_rng = np.random.default_rng(30)  # rng's draws stay as they were
    B, S, H, D, Dv = 4, 512, 128, 192, 128
    q, k = (randn(mla_rng, (B, S, H, D), bf, dev) for _ in range(2))
    v = randn(mla_rng, (B, S, H, Dv), bf, dev)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    choice = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=True))
    out["flash_attention_mla"] = {
        "ms": graph_ms(lambda: FK.flash_attention_cuda(q, k, v), reps=10),
        "plain_ms": graph_ms(lambda: attention_ref(q, k, v), reps=3),
        "library_ms": graph_ms(sdpa, reps=10), "library_backend": choice.name,
        "library_kernel": top_kernel(sdpa), **attn_bound(B, S, H, H, D, Dv, 2),
        "shape": f"B={B}, S={S}, H=KV={H}, D={D}, Dv={Dv}, bf16, causal"}
    # Qwen2-VL's prefill (64 query heads in groups of 8, causal) and
    # SeamlessM4T's (16 heads of their own at D = 64: the encoder and the
    # cross-attention not causal, the decoder's self-attention causal)
    vlm_rng = np.random.default_rng(36)  # rng's draws stay as they were
    for key, B, S, H, KV, D, causal in (
            ("flash_attention_qwen2vl", 4, 512, 64, 8, 128, True),
            ("flash_attention_seamless", 4, 512, 16, 16, 64, False),
            ("flash_attention_seamless_causal", 4, 512, 16, 16, 64, True)):
        q, k, v = (randn(vlm_rng, sh, bf, dev) for sh in
                   ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)

        choice = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, is_causal=causal,
                                                    enable_gqa=True))
        out[key] = {
            "ms": graph_ms(lambda: FK.flash_attention_cuda(q, k, v, causal=causal), reps=20),
            "plain_ms": graph_ms(lambda: attention_ref(q, k, v, causal=causal), reps=5),
            "library_ms": graph_ms(sdpa, reps=20), "library_backend": choice.name,
            **attn_bound(B, S, H, KV, D, D, 2, causal=causal),
            "shape": f"B={B}, S={S}, H={H}, KV={KV}, D=Dv={D}, bf16, "
                     f"{'causal' if causal else 'not causal'}"}
    d, B, S = 3072, 4, 512
    w = randn(rng, (d,), torch.float32, dev) * 0.1 + 1
    wb = w.to(bf)
    for N, tag in ((B * S, ""), (B, "_decode")):
        x, r = randn(rng, (N, d), bf, dev), randn(rng, (N, d), bf, dev)
        row = N * d * 2
        out["rmsnorm" + tag] = {
            "ms": graph_ms(lambda: RK.rmsnorm_cuda(x, w, RMS_EPS)),
            "plain_ms": graph_ms(lambda: rmsnorm_ref(x, w, RMS_EPS)),
            "library_ms": graph_ms(lambda: F.rms_norm(x, (d,), wb, RMS_EPS)),
            **bound_fields(2 * row + d * 4, 4 * N * d), "shape": f"N={N}, d={d}, bf16"}
        out["rmsnorm_residual" + tag] = {
            "ms": graph_ms(lambda: RK.rmsnorm_cuda(x, w, RMS_EPS, res2=r)),
            "plain_ms": graph_ms(lambda: rmsnorm_residual_ref(x, r, w, RMS_EPS)),
            "library_ms": None,
            **bound_fields(4 * row + d * 4, 5 * N * d), "shape": f"N={N}, d={d}, bf16"}
    # the other serve paths' widths, prefill rows: Mamba-2 768, Zamba2 3584,
    # Llama-4-Scout 5120 (4 x 512 rows), Gemma 3 2560 (4 x 2048 rows),
    # DeepSeek-V2's q_norm 1536 and kv_norm 512, Qwen2-VL 8192 and
    # SeamlessM4T 1024 (4 x 512 rows)
    width_rng = np.random.default_rng(17)  # rng's draws for SSD stay as they were
    for dw in RMS_WIDTHS:
        N = B * S * (4 if dw == 2560 else 1)
        x = randn(width_rng, (N, dw), bf, dev)
        ww = randn(width_rng, (dw,), torch.float32, dev) * 0.1 + 1
        wwb = ww.to(bf)
        out[f"rmsnorm_d{dw}"] = {
            "ms": graph_ms(lambda: RK.rmsnorm_cuda(x, ww, RMS_EPS)),
            "plain_ms": graph_ms(lambda: rmsnorm_ref(x, ww, RMS_EPS)),
            "library_ms": graph_ms(lambda: F.rms_norm(x, (dw,), wwb, RMS_EPS)),
            **bound_fields(2 * N * dw * 2 + dw * 4, 4 * N * dw),
            "shape": f"N={N}, d={dw}, bf16"}
    # no single PyTorch call computes the scan: library_ms is None
    for key, H, N in (("ssd", 24, 128), ("ssd_zamba2", 112, 64)):
        x, dt, Bv, Cv, A_log, D, _ = ssd_inputs(rng, B, S, H, 64, N, bf, dev)
        out[key] = {
            "ms": graph_ms(lambda: SK.ssd_cuda(x, dt, Bv, Cv, A_log, D, 128), reps=20),
            "plain_ms": graph_ms(lambda: ssd_chunked_ref(x, dt, A_log, Bv, Cv, D, 128),
                                 reps=5),
            "library_ms": None, **ssd_bound(B, S, H, 64, N, 128, 2),
            "shape": f"B={B}, S={S}, H={H}, P=64, N={N}, Q=128, bf16 x / B / C"}
    phase("kernel_times_model", **out)
    return out


# ---------------------------------------------------------------------------
# the paged KV gather, and the paper's figures through repro_torch.benchmarks

# (n_pages, page, KVD, B, max_pages): tests/test_kernels.py's sweep shapes,
# and Phi-4-mini's per-layer K|V page (2 x 8 KV heads x 128 = 2048 values
# a token, 16 tokens a page) for 4 sequences of 512 tokens in a 512-page pool
KV_SWEEP = ((10, 8, 32, 3, 4), (64, 16, 128, 2, 8))
KV_SERVING = (512, 16, 2048, 4, 32)
KV_MAIN_PATH = ("none (no path of either package calls it; entry point "
                "`repro_torch.kernels.kv_gather.kv_gather`)")


def kv_inputs(rng, n_pages, page, KVD, B, mp, dtype, dev, shuffled=False):
    """A page pool and a [B, mp] int32 table on ``dev``. ``shuffled``: a
    permutation of the pool's ids with its last slot repeating the first,
    else uniform random ids (repeats likely), as the sweep's."""
    import numpy as np
    import torch

    if dtype == torch.int32:
        pages = torch.as_tensor(rng.integers(0, 100, (n_pages, page, KVD), dtype=np.int32))
    else:
        pages = torch.as_tensor(rng.standard_normal((n_pages, page, KVD), np.float32))
    if shuffled:
        table = rng.permutation(n_pages)[:B * mp].astype(np.int32)
        table[-1] = table[0]
    else:
        table = rng.integers(0, n_pages, B * mp, dtype=np.int32)
    return pages.to(dev, dtype), torch.as_tensor(table.reshape(B, mp)).to(dev)


def compare_kv_gather(dev):
    """The KV gather kernel bit-equal to its plain version at the sweep
    shapes (float32, bfloat16, int32; int32 and int64 tables), the serving
    shape and a page pool that is not 16-byte aligned; inputs untouched;
    an id out of range raises. Then the entry point once at the serving
    shape, counted. Returns (max error, entry-point launches)."""
    import numpy as np
    import torch

    from repro_torch.kernels.kv_gather import kv_gather
    from repro_torch.kernels.kv_gather.kv_gather import LAUNCHES, kv_gather_cuda
    from repro_torch.kernels.kv_gather.ref import kv_gather_ref

    rng = np.random.default_rng(16)
    cases = [(shape, dt_, False) for shape in KV_SWEEP
             for dt_ in (torch.float32, torch.bfloat16, torch.int32)]
    cases.append((KV_SERVING, torch.bfloat16, True))
    rows, worst = [], 0.0
    for shape, dt_, shuffled in cases:
        pages, table = kv_inputs(rng, *shape, dt_, dev, shuffled)
        keep = (pages.clone(), table.clone())
        want = kv_gather_ref(pages, table)
        for tab in (table, table.to(torch.int64)):
            got = kv_gather_cuda(pages, tab)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            check(torch.equal(got, want), f"KV gather disagrees with plain at {shape}, {dt_}")
            worst = max(worst, err)
        check(torch.equal(pages, keep[0]) and torch.equal(table, keep[1]),
              "the KV gather kernel modified its inputs")
        rows.append({"shape": list(shape), "dtype": str(dt_).removeprefix("torch."),
                     "table": "shuffled, one id repeated" if shuffled else "random",
                     "max_abs_err": err})
    flat = torch.arange(10 * 8 * 33 + 1, dtype=torch.float32, device=dev)
    odd = flat[1:].view(10, 8, 33)  # 4-byte aligned, rows of 1056 bytes
    table = torch.tensor([[3, 1, 3], [9, 0, 2]], dtype=torch.int32, device=dev)
    check(torch.equal(kv_gather_cuda(odd, table), kv_gather_ref(odd, table)),
          "KV gather disagrees with plain on an unaligned pool")
    rows.append({"shape": [10, 8, 33, 2, 3], "dtype": "float32",
                 "table": "pool at a 4-byte offset", "max_abs_err": 0.0})
    raised = False
    try:
        kv_gather(odd, torch.tensor([[0, 10]], dtype=torch.int32, device=dev))
    except ValueError:
        raised = True
    check(raised, "an out-of-range page id did not raise")
    # the entry point at the serving shape, counted
    pages, table = kv_inputs(rng, *KV_SERVING, torch.bfloat16, dev, True)
    torch.cuda.synchronize()
    LAUNCHES["kv_gather"] = 0
    got = kv_gather(pages, table)
    torch.cuda.synchronize()
    launches = LAUNCHES["kv_gather"]
    check(launches == 1, f"the KV gather entry point launched {launches} kernels")
    check(torch.equal(got, kv_gather_ref(pages, table)), "the KV gather entry point")
    phase("kernels_vs_plain_kv_gather", cases=rows, out_of_range_raises=raised,
          entry_point_launches=launches)
    return worst, launches


def time_kv_gather(dev, pools=6):
    """The KV gather at the serving shape: the kernel (launch alone, ids
    not checked), the plain version and ``index_select`` + ``reshape``,
    each cycling over ``pools`` pools with their own tables, so that the
    pages come from device memory and not from the 50 MB L2. Bound: the
    table, the distinct pages that the table names and the output, at the
    memory rate."""
    import numpy as np
    import torch

    from repro_torch.kernels.kv_gather.kv_gather import kv_gather_cuda
    from repro_torch.kernels.kv_gather.ref import kv_gather_ref

    rng = np.random.default_rng(17)
    n_pages, page, KVD, B, mp = KV_SERVING
    ins = [kv_inputs(rng, *KV_SERVING, torch.bfloat16, dev, True) for _ in range(pools)]

    def turns(fn):
        i = [0]

        def call():
            i[0] += 1
            return fn(*ins[i[0] % pools])
        return call

    row = page * KVD * 2
    distinct = len(torch.unique(ins[0][1]))
    out = {
        "ms": graph_ms(turns(kv_gather_cuda), reps=60),
        "plain_ms": graph_ms(turns(kv_gather_ref), reps=60),
        "library_ms": graph_ms(turns(lambda p, t: p.index_select(0, t.reshape(-1)).reshape(
            B, mp * page, KVD)), reps=60),
        **bound_fields(B * mp * 4 + distinct * row + B * mp * row, 0),
        "shape": (f"pool {n_pages} x {page} x {KVD} bf16, B={B}, max_pages={mp}, "
                  f"{distinct} distinct ids, {pools} pools in turn"),
    }
    phase("kernel_times_kv_gather", **out)
    return out


def figure_rows(rows):
    """Rows as ``jax_rows.json`` stores them: name, derived, target, ok,
    numpy scalars through ``str``."""
    return json.loads(json.dumps([{k: r[k] for k in ("name", "derived", "target", "ok")}
                                  for r in rows], default=str))


def jax_rows():
    return json.loads((ROOT / "src/repro_torch/benchmarks/jax_rows.json").read_text())


def router_launches_reset():
    """Set the router kernels' launch counts to 0 (after the card is idle)."""
    import torch

    from repro_torch.kernels.noc_router import noc_router as K

    torch.cuda.synchronize()
    K.LAUNCHES.update(dict.fromkeys(K.LAUNCHES, 0))
    return K.LAUNCHES


def figures_smoke(dev):
    """Every module of ``repro_torch.benchmarks`` in ``--smoke`` mode on the
    card (router launch counts from 0, read after) and on the CPU: each
    row equal on both devices and to the JAX package's smoke rows."""
    import torch

    from repro_torch.benchmarks.run import MODULES, bench_rows
    from repro_torch.core.noc.params import NocParams

    want = jax_rows()["smoke"]
    counts = router_launches_reset()
    t0 = time.perf_counter()
    gpu = {name: bench_rows(mod, False, True, dev) for name, mod in MODULES}
    torch.cuda.synchronize()
    gpu_s = time.perf_counter() - t0
    launches = dict(counts)
    t0 = time.perf_counter()
    cpu = {name: bench_rows(mod, False, True, "cpu") for name, mod in MODULES}
    cpu_s = time.perf_counter() - t0
    n_rows = 0
    for name, _ in MODULES:
        g, c = figure_rows(gpu[name]), figure_rows(cpu[name])
        check(g == c, f"{name}: smoke rows differ between card and CPU: {g} vs {c}")
        check(g == want[name]["rows"], f"{name}: smoke rows differ from the JAX rows: {g}")
        n_rows += len(g)
    # fig7 300, fig8 600, fig10 800 and fig11 1200 cycles, one step each
    cycles = 300 + 600 + 800 + 1200
    check(launches == expected_launches(NocParams(), cycles),
          f"figure smoke launches {launches}")
    phase("figures_smoke_vs_cpu", modules=len(MODULES), rows=n_rows, cycles=cycles,
          launches=launches, gpu_s=gpu_s, cpu_s=cpu_s, equal_to_jax_rows=True)
    return launches


def figure_fig10(dev):
    """The default-mode Fig. 10 module on the card (three runs on the 4x4
    mesh, each ``FIG10_CYCLES``, cut from 4 000, and the area rows),
    counted: rows equal to the JAX package's 4 000-cycle rows, every target
    met."""
    import functools

    import torch

    from repro_torch.benchmarks import fig10_rob
    from repro_torch.benchmarks.run import bench_rows
    from repro_torch.core.noc.params import NocParams

    counts = router_launches_reset()
    t0 = time.perf_counter()
    full = fig10_rob._completion
    fig10_rob._completion = functools.partial(full, cycles=FIG10_CYCLES)
    try:
        rows = bench_rows(fig10_rob, False, False, dev)
    finally:
        fig10_rob._completion = full
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    note_cut("fig10_rob", wall, FIG10_CYCLES, FIG10_CYCLES_UNCUT)
    launches = dict(counts)
    got, want = figure_rows(rows), jax_rows()["default"]["fig10_rob"]
    check(got == want["rows"], f"Fig. 10 rows differ from the JAX rows: {got}")
    cycles = 3 * FIG10_CYCLES
    check(launches == expected_launches(NocParams(), cycles), f"Fig. 10 launches {launches}")
    checked = [r for r in rows if r["ok"] is not None]
    footer = (f"# paper-validation: {sum(bool(r['ok']) for r in checked)}/{len(checked)} "
              "targets matched")
    check(footer == want["footer"], f"Fig. 10 footer {footer}")
    phase("fig10_rob", cycles=cycles, launches=launches, seconds=wall,
          ms_per_cycle=wall / cycles * 1e3, footer=footer, equal_to_jax_rows=True,
          rows={r["name"]: r["derived"] for r in rows})
    return launches


# ---------------------------------------------------------------------------
# the batched sweep and the design-space exploration

SWEEP_KB = (1, 4, 16, 32)  # the explorer's pattern sweep: uniform, 4 transfers each
# cut from 1 200 to hold the whole run within its time limit
SWEEP_CYCLES = 600


def sweep_kernels(rng, dev):
    """The per-cycle kernels at a batched sweep's grid: random snapshots of
    B x C = 4 x 3 = 12 channels over one fabric's tables, V = 1 (8x4 mesh)
    and V = 2 (8x4 torus), and the offload arb kernel on the 8x4 mesh's
    all-reduce groups, each against its plain version (the apply kernel in
    both FIFO modes). Returns the largest error per ``LAUNCHES`` key."""
    from repro_torch.core.noc import collective_traffic as CT
    from repro_torch.core.noc.engine import make_tables
    from repro_torch.core.noc.topology import build_mesh, build_torus
    from repro_torch.kernels.noc_router import noc_router as K

    BC = 4 * 3
    errs = {}
    for name, topo, V in (("mesh 8x4", build_mesh(nx=4, ny=8), 1),
                          ("torus 8x4", build_torus(nx=4, ny=8), 2)):
        tables = make_tables(topo, n_vcs=V, device=dev)
        for depth in (2, 4):
            e = compare_kernels(to_device(random_snapshot(rng, tables, BC, depth), dev),
                                tables)
            phase("kernels_vs_plain_sweep", fabric=name, channels=BC, n_vcs=V,
                  depth=depth, max_abs_err=e)
            check(max(e.values()) == 0, f"kernel disagrees with plain at B x C: {e}")
            for k, key in (("arb", K.mode("arb", V)), ("apply", K.mode("apply", V))):
                errs[key] = max(errs.get(key, 0), e[k], e["cycle"])
            key = K.mode("apply_unfused", V)
            errs[key] = max(errs.get(key, 0), e["apply_unfused"], e["cycle_unfused"])
    topo = build_mesh(nx=4, ny=8)
    groups = CT.all_reduce(topo, data_kb=16, streams=2, algo="infabric").meta["groups"]
    tables = make_tables(topo, groups=groups, device=dev)
    raw = random_snapshot(rng, tables, BC, 2)
    red = random_offload(rng, raw, tables)
    e, seen = compare_offload(to_device(raw, dev), to_device(red, dev), tables)
    phase("kernels_vs_plain_sweep", fabric="mesh 8x4", channels=BC, groups=len(groups),
          depth=2, max_abs_err=e, cases=seen)
    check(max(e.values()) == 0, f"offload kernel disagrees with plain at B x C: {e}")
    errs["arb_offload"] = max(e["arb"], e["cycle"])
    errs["apply_unfused"] = max(errs["apply_unfused"], e["apply_unfused"],
                                e["cycle_unfused"])
    return errs


def sweep_8x4(dev):
    """``run_sweep`` on ``preset("mesh", big=True)`` (the paper's 8x4
    compute mesh) over the explorer's uniform 1 / 4 / 16 / 32 kB x 4 DMA
    reads, B = 4 as one state for ``SWEEP_CYCLES``, counted: the router kernels
    launched as for one configuration; each configuration's state equal,
    leaf for leaf, to its own sequential run on the card, and
    configuration 0's to the CPU's. Prints the batched and the single
    configuration's ms per cycle and their ratio."""
    import torch

    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc import traffic as TT
    from repro_torch.core.noc.spec import preset

    topo, params = preset("mesh", big=True).lower()
    wls = [TT.dma_workload(topo, "uniform", transfer_kb=kb, n_txns=4) for kb in SWEEP_KB]
    n = SWEEP_CYCLES
    sim = TS.build_sim(topo, params, wls[0], device=dev)
    counts = router_launches_reset()
    t0 = time.perf_counter()
    swept = TS.run_sweep(sim, wls, n)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    launches = dict(counts)
    check(launches == expected_launches(params, n),
          f"sweep launches {launches}, one configuration makes "
          f"{expected_launches(params, n)}")
    single_s = []
    for i, wl in enumerate(wls):
        st, dt, _ = run_counted(TS, TS.build_sim(topo, params, wl, device=dev), n)
        single_s.append(dt)
        bad = states_equal(swept[i], st)
        check(not bad, f"sweep configuration {i} differs from its own run in {bad}")
    cpu = TS.run(TS.build_sim(topo, params, wls[0], device="cpu"), n)
    bad = states_equal(swept[0], cpu)
    check(not bad, f"sweep configuration 0 differs from the CPU run in {bad}")
    done = [int(TS.stats(sim, st)["dma_done"].sum()) for st in swept]
    check(all(d > 0 for d in done), f"a sweep configuration completed nothing: {done}")
    batched_ms = batched_s / n * 1e3
    single_ms = statistics.mean(single_s) / n * 1e3
    phase("sweep_8x4", configurations=len(wls), transfer_kb=list(SWEEP_KB), cycles=n,
          launches=launches, batched_ms_per_cycle=batched_ms,
          single_ms_per_cycle=single_ms,
          single_ms_per_cycle_each=[t / n * 1e3 for t in single_s],
          batched_over_single=batched_ms / single_ms,
          states_equal_sequential=True, config0_equals_cpu=True, dma_done=done)
    return launches


def dse_smoke(dev):
    """``run_dse(default_grid(smoke=True))`` on the card, counted: the
    frontier artifact, dumped as the explorer writes it, equal byte for
    byte to the JAX package's (``dse_smoke_jax.json``). Prints wall
    seconds."""
    import torch

    from repro_torch.core.noc import dse
    from repro_torch.core.noc.params import NocParams

    specs = dse.default_grid(smoke=True)
    jobs = dse.build_jobs(specs)
    counts = router_launches_reset()
    t0 = time.perf_counter()
    results = dse.run_dse(specs, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts)
    art = dse.frontier_artifact(results, grid="smoke")
    got = json.dumps(art, indent=1, sort_keys=True)
    want = (ROOT / "src/repro_torch/benchmarks/dse_smoke_jax.json").read_text()
    check(got == want, "DSE smoke artifact differs from the JAX package's")
    cycles = [max(dse._wl_cycles_budget(wl) for _, _, wl in m) for _, _, m in jobs]
    want_l = dict.fromkeys(launches, 0)
    for (_, params, _), c in zip(jobs, cycles):
        for k, v in expected_launches(params, c).items():
            want_l[k] += v
    check(launches == want_l, f"DSE launches {launches}, expected {want_l}")
    phase("dse_smoke", points=len(specs), groups=len(jobs), cycles=cycles,
          launches=launches, wall_s=wall, delivered=art["n_delivered"],
          frontier=art["frontier"], equal_to_jax_artifact=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import convert
    from repro_torch.core.noc import endpoints as epm
    from repro_torch.core.noc import engine as eng
    from repro_torch.core.noc import sim as TS
    from repro_torch.core.noc import collective_traffic as CT
    from repro_torch.core.noc import traffic as TT
    from repro_torch.core.noc.engine import make_tables
    from repro_torch.core.noc.params import NocParams
    from repro_torch.core.noc.topology import build_mesh, build_occamy, build_torus
    from repro_torch.kernels.flash_attention import flash_attention as FK
    from repro_torch.kernels.noc_router import noc_router as K
    from repro_torch.kernels.rmsnorm import rmsnorm as RK
    from repro_torch.kernels.ssd import ssd as SK

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    # float32 matrix products in full float32, as the plain versions' einsums
    # are compared with the kernels (PyTorch's default, set here: TF32 keeps
    # about three decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # ---- 1. card + build --------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    # the package exports its entry point under the module's own name
    KG = importlib.import_module("repro_torch.kernels.kv_gather.kv_gather")
    libs = (K.LIBRARY, FK.LIBRARY, FK.BWD_LIBRARY, RK.LIBRARY, SK.LIBRARY, SK.BWD_LIBRARY,
            KG.LIBRARY)
    fresh = [not lib.path().exists() for lib in libs]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs) + 1) as pool:  # one nvcc per source, together
        probe = pool.submit(build_empty_kernel)
        built = list(pool.map(lambda lib: lib.build(), libs))
        probe.result()
    build_s = time.perf_counter() - t0
    phase("card", nvidia_smi=card, torch=torch.__version__, tf32=False,
          cuda=torch.version.cuda, libraries=[str(so.relative_to(ROOT)) for so in built],
          built_now=fresh, build_s=build_s)

    # ---- 2. kernels vs plain on random snapshots --------------------------
    errs = dict.fromkeys(K.LAUNCHES, 0)
    rng = np.random.default_rng(0)
    unfused_rows = []  # the apply kernel's unfused mode, at every case below
    unfused_seen = {"cases": 0, "differs_from_fused": 0}

    def note_unfused(case, e, V):
        """Record a case's unfused-mode errors (the apply kernel alone on
        the plain decisions, and the naive router cycle)."""
        key = K.mode("apply_unfused", V)
        errs[key] = max(errs[key], e["apply_unfused"], e["cycle_unfused"])
        unfused_rows.append({**case, "apply": e["apply_unfused"],
                             "cycle": e["cycle_unfused"]})
    for nx, ny in ((4, 8), (32, 32), (7, 1)):
        tables = make_tables(build_mesh(nx=nx, ny=ny), device=dev)
        for depth in (2, 4):
            snap = to_device(random_snapshot(rng, tables, 3, depth), dev)
            e = compare_kernels(snap, tables, unfused_seen)
            phase("kernels_vs_plain", mesh=f"{nx}x{ny}",
                  R=int(tables.route.shape[0]), depth=depth, max_abs_err=e)
            check(max(e.values()) == 0, f"kernel disagrees with plain: {e}")
            errs["arb"] = max(errs["arb"], e["arb"], e["cycle"])
            errs["apply"] = max(errs["apply"], e["apply"], e["cycle"])
            note_unfused({"fabric": f"mesh {nx}x{ny}", "depth": depth}, e, 1)

    # ---- 2b. the VC modes (V = 2): tori 8x4, 32x32 and 8x1, Occamy's 28
    # slots; V = 6 on the 8x4 torus (30 slots: one router a warp)
    vc_cases = [(f"torus {nx}x{ny}", build_torus(nx=nx, ny=ny), 2, depth)
                for nx, ny in ((4, 8), (32, 32), (8, 1)) for depth in (2, 4)]
    vc_cases += [("occamy", build_occamy(), 2, 2), ("torus 4x8", build_torus(nx=4, ny=8), 6, 2)]
    for name, vtopo, V, depth in vc_cases:
        tables = make_tables(vtopo, n_vcs=V, device=dev)
        snap = to_device(random_snapshot(rng, tables, 3, depth), dev)
        e = compare_kernels(snap, tables, unfused_seen)
        phase("kernels_vs_plain_vc", fabric=name, R=int(tables.route.shape[0]),
              slots=int(tables.port_ep.shape[1]), n_vcs=V, depth=depth, max_abs_err=e)
        check(max(e.values()) == 0, f"VC kernel disagrees with plain: {e}")
        errs["arb_vc"] = max(errs["arb_vc"], e["arb"], e["cycle"])
        errs["apply_vc"] = max(errs["apply_vc"], e["apply"], e["cycle"])
        note_unfused({"fabric": name, "n_vcs": V, "depth": depth}, e, V)

    # ---- 2b'. 32 slots, the most a warp holds: synthetic tables -------------
    for ports, V in ((32, 1), (16, 2)):
        tables = synthetic_tables(rng, 11, 40, ports, V, dev)
        snap = to_device(random_snapshot(rng, tables, 3, 2), dev)
        e = compare_kernels(snap, tables, unfused_seen)
        phase("kernels_vs_plain_32_slots", R=11, ports=ports, n_vcs=V, depth=2,
              max_abs_err=e)
        check(max(e.values()) == 0, f"32-slot kernel disagrees with plain: {e}")
        arb, app = K.mode("arb", V), K.mode("apply", V)
        errs[arb] = max(errs[arb], e["arb"], e["cycle"])
        errs[app] = max(errs[app], e["apply"], e["cycle"])
        note_unfused({"fabric": f"synthetic 32 slots ({ports} ports)", "n_vcs": V,
                      "depth": 2}, e, V)

    # ---- 2c. the fused window against N plain cycles ------------------------
    # the 8x4 and 32x32 fabrics; a 23x19 mesh split unevenly over 8 CTAs;
    # a 48x48 torus past a 16-CTA cluster (the global-memory kernel)
    Q = NocParams().egress_depth
    fused_cases = [((build_mesh if V == 1 else build_torus)(nx=nx, ny=ny), V,
                    (1, 4, 16)) for nx, ny in ((4, 8), (32, 32)) for V in (1, 2)]
    fused_cases += [(build_mesh(nx=23, ny=19), 1, (1, 4, 16)),
                    (build_torus(nx=48, ny=48), 2, (1, 4))]
    for ftopo, V, n_list in fused_cases:
        tables = make_tables(ftopo, n_vcs=V, device=dev)
        R, P = tables.port_ep.shape
        plan = K.fused_plan(R, P, 2, 2, V)
        for N in n_list:
            snap = to_device(random_snapshot(rng, tables, 3, 2), dev)
            egress = to_device(random_egress(rng, 3, ftopo.n_endpoints, Q,
                                             1000, N), dev)
            err = compare_fused(snap, egress, tables, 1000, N)
            phase("fused_vs_plain", fabric=ftopo.name, R=int(R),
                  n_vcs=V, n_cycles=N, max_abs_err=err, **plan_fields(plan),
                  ranges=[plan.ranges[0], plan.ranges[-1]])
            check(err == 0, f"fused kernel disagrees with plain: {err}")
            key = K.mode("fused", V)
            errs[key] = max(errs[key], err)

    # ---- 2d. the offload arb kernel with random reduction-ALU state --------
    # tables: the in-fabric all-reduce's groups (one tree, so they share
    # every parent port; 2 streams, or 39 for 40 groups) plus a multicast
    # group rooted elsewhere; the 7x1 mesh's arb warps are ragged
    reached = dict.fromkeys(("shared_parent", "contested_emission",
                             "cancelled_mc_win"), 0)
    mesh8x4, torus8x4 = build_mesh(nx=4, ny=8), build_torus(nx=4, ny=8)
    for name, otopo, V, streams in (("mesh 8x4", mesh8x4, 1, 2),
                                    ("torus 8x4", torus8x4, 2, 2),
                                    ("mesh 32x32", build_mesh(nx=32, ny=32), 1, 2),
                                    ("occamy", build_occamy(), 2, 2),
                                    ("mesh 7x1", build_mesh(nx=7, ny=1), 1, 2),
                                    ("mesh 8x4", mesh8x4, 1, 39),
                                    ("torus 8x4", torus8x4, 2, 39)):
        groups = (CT.all_reduce(otopo, data_kb=40 if streams > 2 else 16,
                                streams=streams, algo="infabric").meta["groups"]
                  + CT.multicast(otopo, root=1, offload=True).meta["groups"])
        tables = make_tables(otopo, n_vcs=V, groups=groups, device=dev)
        for depth in (2, 4):
            raw = random_snapshot(rng, tables, 3, depth)
            red = random_offload(rng, raw, tables)
            e, seen = compare_offload(to_device(raw, dev), to_device(red, dev),
                                      tables)
            phase("kernels_vs_plain_offload", fabric=name,
                  R=int(tables.route.shape[0]),
                  slots=int(tables.port_ep.shape[1]), groups=len(groups),
                  depth=depth, max_abs_err=e, cases=seen)
            check(max(e.values()) == 0,
                  f"offload kernel disagrees with plain: {e}")
            key = K.mode("arb_offload", V)
            errs[key] = max(errs[key], e["arb"], e["cycle"])
            reached = {k: reached[k] + seen[k] for k in reached}
            note_unfused({"fabric": name, "n_vcs": V, "depth": depth,
                          "after": "offload arb", "groups": len(groups)}, e, V)
    check(all(reached.values()), f"offload cases not all reached: {reached}")
    phase("kernels_vs_plain_unfused", rows=unfused_rows, **unfused_seen)
    check(all(r["apply"] == r["cycle"] == 0 for r in unfused_rows),
          "the unfused apply mode disagrees with plain")
    check(unfused_seen["differs_from_fused"] > 0,
          "the unfused mode never differed from the fused one")

    # ---- 3. main path on the paper's 8x4 mesh -----------------------------
    topo = build_mesh(nx=4, ny=8)
    wl = mesh_workload(TT, topo, transfer_kb=8, narrow_rate=0.05)
    sim = TS.build_sim(topo, NocParams(), wl)
    st_gpu, dt, main_launches = run_counted(TS, sim, 1200)
    out = TS.stats(sim, st_gpu)
    check(out["beats_rcvd"].sum() > 0 and out["narrow_lat_cnt"].sum() > 0,
          "8x4 main path moved no traffic")
    sim_cpu = TS.build_sim(topo, NocParams(), wl, device="cpu")
    t0 = time.perf_counter()
    st_cpu = TS.run(sim_cpu, 1200)
    dt_cpu = time.perf_counter() - t0
    bad = states_equal(st_gpu, st_cpu)
    check(not bad, f"8x4 GPU state differs from CPU state in {bad}")
    ms_8x4 = dt / 1200 * 1e3
    phase("main_8x4", cycles=1200, launches=main_launches,
          gpu_ms_per_cycle=ms_8x4, cpu_ms_per_cycle=dt_cpu / 1200 * 1e3,
          gpu_state_equals_cpu=True, wide_util=float(out["wide_util"]),
          narrow_lat_mean=float(out["narrow_lat_mean"].mean()))
    timing_8x4 = time_kernels(st_gpu.fabric, sim.tables,
                              torch.ones((3, topo.n_endpoints), dtype=torch.bool,
                                         device=dev))
    phase("kernel_times_8x4", **timing_8x4)
    layers_8x4 = layer_times(eng, sim, st_gpu)
    phase("layers_8x4", **layers_8x4)
    phase("profile_8x4", **cut_profile("profile_8x4", sim, st_gpu, layers_8x4["step_ms"],
                                       PROFILE_STEPS))

    lat = {d: narrow_latency(TS, epm, topo, 0, d) for d in (1, 2, 3, 31)}
    phase("fig7_8x4", latency=lat)
    check(lat[1] == 22.0 and lat[31] == 58.0, f"Fig. 7 latencies {lat}")
    check(lat[2] - lat[1] == 4.0 and lat[3] - lat[2] == 4.0,
          f"Fig. 7 per-hop step {lat}")

    gtopo = build_mesh(nx=4, ny=2)
    gsim = TS.build_sim(gtopo, NocParams(),
                        mesh_workload(TT, gtopo, transfer_kb=1,
                                      narrow_rate=0.05))
    gst, _, _ = run_counted(TS, gsim, 1200)
    gout = TS.stats(gsim, gst)
    got = {"beats_rcvd": gout["beats_rcvd"],
           "dma_done": gout["dma_done"].sum(axis=-1),
           "narrow_lat_cnt": gout["narrow_lat_cnt"],
           "narrow_lat_sum": gst.eps.lat_sum.cpu().numpy(),
           "n_sent": gst.eps.n_sent.cpu().numpy(),
           "ni_stalls": gout["ni_stalls"], "last_rx": gout["last_rx"],
           "first_rx": gout["first_rx"]}
    wrong = [k for k, v in GOLDEN.items()
             if not np.array_equal(np.asarray(got[k]), np.asarray(v, got[k].dtype))]
    phase("golden_4x2", cycles=1200, pins=len(GOLDEN), wrong=wrong)
    check(not wrong, f"golden pins differ: {wrong}")

    # ---- 4. the 32x32 scaling point ----------------------------------------
    btopo = build_mesh(nx=32, ny=32)
    bwl = mesh_workload(TT, btopo, transfer_kb=8, narrow_rate=0.0)
    bsim = TS.build_sim(btopo, NocParams(), bwl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bst, bdt, big_launches = run_counted(TS, bsim, 200)
    peak = torch.cuda.max_memory_allocated()
    bsim_cpu = TS.build_sim(btopo, NocParams(), bwl, device="cpu")
    t0 = time.perf_counter()
    bst_cpu = TS.run(bsim_cpu, 200)
    bdt_cpu = time.perf_counter() - t0
    bad = states_equal(bst, bst_cpu)
    check(not bad, f"32x32 GPU state differs from CPU state in {bad}")
    bout = TS.stats(bsim, bst)
    check(bout["beats_rcvd"].sum() > 0, "32x32 run moved no wide beats")
    state_bytes = sum(v.nbytes for v in
                      convert.sim_state_to_numpy(bst).values())
    phase("scale_32x32", cycles=200, launches=big_launches,
          gpu_ms_per_cycle=bdt / 200 * 1e3, cpu_ms_per_cycle=bdt_cpu / 200 * 1e3,
          gpu_state_equals_cpu=True, state_bytes=state_bytes,
          peak_device_bytes=peak, beats_rcvd=int(bout["beats_rcvd"].sum()))
    timing_32 = time_kernels(bst.fabric, bsim.tables,
                             torch.ones((3, btopo.n_endpoints),
                                        dtype=torch.bool, device=dev))
    phase("kernel_times_32x32", **timing_32)
    layers_32 = layer_times(eng, bsim, bst, n=50)
    phase("layers_32x32", **layers_32)
    phase("profile_32x32", **cut_profile("profile_32x32", bsim, bst, layers_32["step_ms"],
                                         PROFILE_STEPS))

    # ---- 5. super-steps: the 8x4 mesh at fused_cycles=4 ------------------
    sp = NocParams(fused_cycles=4)
    ssim = TS.build_sim(topo, sp, wl)
    sst, sdt, super_launches, sst_cpu = cut_run(
        "super_8x4", TS, ssim, lambda: TS.build_sim(topo, sp, wl, device="cpu"))
    bad = states_equal(sst, sst_cpu)
    check(not bad, f"super_8x4 GPU state differs from CPU state in {bad}")
    sout = TS.stats(ssim, sst)
    check(sout["beats_rcvd"].sum() > 0, "super_8x4 moved no wide beats")
    ms_super = sdt / SUPER_CYCLES * 1e3
    phase("super_8x4", cycles=SUPER_CYCLES, fused_cycles=4, launches=super_launches,
          gpu_ms_per_cycle=ms_super, k1_gpu_ms_per_cycle=ms_8x4,
          gpu_state_equals_cpu=True, wide_util=float(sout["wide_util"]))
    # k = 1 against k = 4 in turns (k1, k4, k4, k1), TURN_CYCLES each from
    # a fresh state: the host's speed drifts within a call
    turns = timing_turns("k1_vs_k4_8x4", TS, (sim, ssim, ssim, sim))
    phase("k1_vs_k4_8x4", order="k1,k4,k4,k1", gpu_ms_per_cycle=turns)
    phase("profile_super_8x4", **cut_profile("profile_super_8x4", ssim, sst, ms_super,
                                             PROFILE_STEPS // 2))
    ones = lambda T: torch.ones((3, T.n_endpoints), dtype=torch.bool, device=dev)
    fused_8x4 = time_fused(sst.fabric, sst.eps, ssim.tables, ones(topo), SUPER_CYCLES,
                           timing_8x4)
    phase("kernel_times_fused_8x4", **fused_8x4)
    fused_32 = time_fused(bst.fabric, bst.eps, bsim.tables, ones(btopo), 200,
                          timing_32)
    phase("kernel_times_fused_32x32", **fused_32)

    # ---- 6. the 8x4 torus with dateline VCs, per cycle and in super-steps --
    ttopo = build_torus(nx=4, ny=8)
    twl = mesh_workload(TT, ttopo, transfer_kb=8, narrow_rate=0.05)
    vp = NocParams(n_vcs=2)
    vsim = TS.build_sim(ttopo, vp, twl)
    vst, vdt, vc_launches, vst_cpu = cut_run(
        "torus_vc_8x4", TS, vsim, lambda: TS.build_sim(ttopo, vp, twl, device="cpu"))
    bad = states_equal(vst, vst_cpu)
    check(not bad, f"torus_vc_8x4 GPU state differs from CPU state in {bad}")
    vout = TS.stats(vsim, vst)
    check(vout["beats_rcvd"].sum() > 0 and vout["narrow_lat_cnt"].sum() > 0,
          "torus_vc_8x4 moved no traffic")
    ms_vc = vdt / SUPER_CYCLES * 1e3
    phase("torus_vc_8x4", cycles=SUPER_CYCLES, n_vcs=2, fused_cycles=1,
          launches=vc_launches, gpu_ms_per_cycle=ms_vc,
          gpu_state_equals_cpu=True, wide_util=float(vout["wide_util"]),
          narrow_lat_mean=float(vout["narrow_lat_mean"].mean()))
    layers_vc = layer_times(eng, vsim, vst)
    phase("layers_torus_vc_8x4", **layers_vc)
    vc_8x4 = time_kernels(vst.fabric, vsim.tables, ones(ttopo))
    phase("kernel_times_vc_8x4", **vc_8x4)

    tp = NocParams(n_vcs=2, fused_cycles=4)
    tsim = TS.build_sim(ttopo, tp, twl)
    tst, tdt, torus_launches, tst_cpu = cut_run(
        "torus_8x4", TS, tsim, lambda: TS.build_sim(ttopo, tp, twl, device="cpu"))
    bad = states_equal(tst, tst_cpu)
    check(not bad, f"torus_8x4 GPU state differs from CPU state in {bad}")
    tout = TS.stats(tsim, tst)
    check(tout["beats_rcvd"].sum() > 0 and tout["narrow_lat_cnt"].sum() > 0,
          "torus_8x4 moved no traffic")
    ms_torus = tdt / SUPER_CYCLES * 1e3
    phase("torus_8x4", cycles=SUPER_CYCLES, n_vcs=2, fused_cycles=4,
          launches=torus_launches, gpu_ms_per_cycle=ms_torus,
          gpu_state_equals_cpu=True, wide_util=float(tout["wide_util"]),
          narrow_lat_mean=float(tout["narrow_lat_mean"].mean()))
    phase("profile_torus_8x4", **cut_profile("profile_torus_8x4", tsim, tst, ms_torus,
                                             PROFILE_STEPS // 2))
    fused_vc_8x4 = time_fused(tst.fabric, tst.eps, tsim.tables, ones(ttopo),
                              SUPER_CYCLES, vc_8x4)
    phase("kernel_times_fused_vc_8x4", **fused_vc_8x4)

    # ---- 7. the 8x1 ring: wedged without VCs, drained with two ------------
    rtopo = build_torus(nx=8, ny=1)
    rwl = ring_workload(epm, rtopo)
    rsim1 = TS.build_sim(rtopo, NocParams(), rwl)
    # 1000 + 100 cycles (4000, then 2000, until the run's time limit forced
    # the cuts): the ring with two VCs drains in 1000
    rst, _, _ = run_counted(TS, rsim1, 1000)
    mid = int(rst.eps.beats_rcvd.sum())
    rst, _, _ = run_counted(TS, rsim1, 100, rst)
    wedged = (int(rst.eps.rx_bursts.sum()) == 0
              and int(rst.eps.beats_rcvd.sum()) == mid)
    check(wedged, "the VC-less 8x1 ring did not wedge")
    rsim2 = TS.build_sim(rtopo, NocParams(n_vcs=2), rwl)
    rsim2_cpu = TS.build_sim(rtopo, NocParams(n_vcs=2), rwl, device="cpu")
    rst2 = rst2_cpu = None
    ring_launches, ring_s = dict.fromkeys(K.LAUNCHES, 0), 0.0
    for _ in range(8):  # up to 4000 cycles, in steps of 500
        rst2, dt, got = run_counted(TS, rsim2, 500, rst2)
        rst2_cpu = TS.run(rsim2_cpu, 500, rst2_cpu)
        ring_launches = {k: ring_launches[k] + got[k] for k in got}
        ring_s += dt
        if int(rst2.eps.rx_bursts.sum()) == rtopo.n_endpoints:
            break
    ring_cycles = int(rst2.cycle)
    bad = states_equal(rst2, rst2_cpu)
    check(not bad, f"ring_8x1 (n_vcs=2) GPU state differs from CPU state in {bad}")
    drained = (int(rst2.eps.rx_bursts.sum()) == rtopo.n_endpoints
               and int(rst2.eps.beats_rcvd.sum())
               == rtopo.n_endpoints * rwl.dma_beats)
    phase("ring_8x1", vc1_cycles=1100, vc1_beats_rcvd=mid,
          vc1_rx_bursts=int(rst.eps.rx_bursts.sum()), vc1_wedged=wedged,
          vc2_cycles=ring_cycles, vc2_rx_bursts=int(rst2.eps.rx_bursts.sum()),
          vc2_drained=drained, vc2_launches=ring_launches,
          vc2_gpu_state_equals_cpu=True,
          vc2_gpu_ms_per_cycle=ring_s / ring_cycles * 1e3)
    check(drained, "the 8x1 ring with n_vcs=2 did not drain")

    # ---- 8. the 32x32 torus with dateline VCs, per cycle and in super-steps
    gtor = build_torus(nx=32, ny=32)
    gwl = mesh_workload(TT, gtor, transfer_kb=8, narrow_rate=0.0)
    gsim_v = TS.build_sim(gtor, vp, gwl)
    gst_v, gvdt, gv_launches = run_counted(TS, gsim_v, 200)
    gst_v_cpu = TS.run(TS.build_sim(gtor, vp, gwl, device="cpu"), 200)
    bad = states_equal(gst_v, gst_v_cpu)
    check(not bad, f"32x32 torus (k=1) GPU state differs from CPU state in {bad}")
    check(TS.stats(gsim_v, gst_v)["beats_rcvd"].sum() > 0,
          "32x32 torus (k=1) moved no wide beats")
    phase("scale_32x32_torus_vc", cycles=200, n_vcs=2, fused_cycles=1,
          launches=gv_launches, gpu_ms_per_cycle=gvdt / 200 * 1e3,
          gpu_state_equals_cpu=True)
    vc_32 = time_kernels(gst_v.fabric, gsim_v.tables, ones(gtor))
    phase("kernel_times_vc_32x32", **vc_32)
    del gsim_v, gst_v  # out of the k = 4 run's peak device memory

    gsim_t = TS.build_sim(gtor, tp, gwl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gst_t, gdt, gt_launches = run_counted(TS, gsim_t, 200)
    gpeak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    gst_cpu = TS.run(TS.build_sim(gtor, tp, gwl, device="cpu"), 200)
    gdt_cpu = time.perf_counter() - t0
    bad = states_equal(gst_t, gst_cpu)
    check(not bad, f"32x32 torus GPU state differs from CPU state in {bad}")
    gout = TS.stats(gsim_t, gst_t)
    check(gout["beats_rcvd"].sum() > 0, "32x32 torus moved no wide beats")
    ms_gtor = gdt / 200 * 1e3
    phase("scale_32x32_torus", cycles=200, n_vcs=2, fused_cycles=4,
          launches=gt_launches, gpu_ms_per_cycle=ms_gtor,
          cpu_ms_per_cycle=gdt_cpu / 200 * 1e3, gpu_state_equals_cpu=True,
          peak_device_bytes=gpeak, beats_rcvd=int(gout["beats_rcvd"].sum()))
    phase("profile_32x32_torus", **device_profile(gsim_t, gst_t, ms_gtor, n=5))
    fused_vc_32 = time_fused(gst_t.fabric, gst_t.eps, gsim_t.tables,
                             ones(gtor), 200, vc_32)
    phase("kernel_times_fused_vc_32x32", **fused_vc_32)

    # ---- 9. in-network collective offload -----------------------------------
    ar = lambda t: CT.all_reduce(t, data_kb=16, streams=2, algo="infabric")
    ar_mid, ar_sim, ar_launches, ar_end = offload_run(
        "allreduce_infabric_8x4", topo, 1, ar(topo), OFFLOAD_CYCLES, 400, done_at=693,
        uncut=OFFLOAD_CYCLES_UNCUT)
    offload_8x4 = time_offload(ar_mid.fabric, ar_sim.tables)
    phase("kernel_times_offload_8x4", at_cycle=400, **offload_8x4)
    layers_ar = layer_times(eng, ar_sim, ar_mid)
    phase("layers_allreduce_infabric_8x4", from_cycle=400, **layers_ar)
    phase("profile_allreduce_infabric_8x4", from_cycle=400,
          **cut_profile("profile_allreduce_infabric_8x4", ar_sim, ar_mid,
                        layers_ar["step_ms"], PROFILE_STEPS // 2))
    offload_run("multicast_tree_8x4", topo, 1,
                CT.multicast(topo, data_kb=16, streams=4, offload=True),
                MULTICAST_CYCLES, 150, done_at=278, uncut=MULTICAST_CYCLES_UNCUT)
    tar_mid, tar_sim, tar_launches, _ = offload_run(
        "allreduce_infabric_torus_vc_8x4", ttopo, 2, ar(ttopo), OFFLOAD_CYCLES, 400,
        done_at=673, uncut=OFFLOAD_CYCLES_UNCUT)
    offload_vc_8x4 = time_offload(tar_mid.fabric, tar_sim.tables)
    phase("kernel_times_offload_vc_8x4", at_cycle=400, **offload_vc_8x4)
    big_mid, big_sim, _, _ = offload_run(
        "scale_32x32_allreduce_infabric", btopo, 1, ar(btopo), BIG_OFFLOAD_CYCLES, 100,
        uncut=BIG_OFFLOAD_CYCLES_UNCUT)
    offload_32 = time_offload(big_mid.fabric, big_sim.tables)
    phase("kernel_times_offload_32x32", at_cycle=100, **offload_32)

    # ---- 9b. the naive reference step (step_impl="naive") ------------------
    # the fast paths' cells again on the naive step: the apply kernel's
    # unfused mode once a cycle; card state equal to the CPU's naive state
    # and, under canonical_state(scrub=True), to the fast cell's card state
    naive = NocParams(step_impl="naive")
    nsim = TS.build_sim(topo, naive, wl)
    nst, ndt, naive_launches = run_counted(TS, nsim, 1200)
    nsim_cpu = TS.build_sim(topo, naive, wl, device="cpu")
    t0 = time.perf_counter()
    nst_cpu = TS.run(nsim_cpu, 1200)
    ndt_cpu = time.perf_counter() - t0
    naive_vs_fast(TS, "naive_8x4", (nsim, nst), nst_cpu, (sim, st_gpu))
    nout = TS.stats(nsim, nst)
    ms_naive = ndt / 1200 * 1e3
    # fast against naive in turns (fast, naive, naive, fast), TURN_CYCLES
    # each from a fresh state: the host's speed drifts within a call
    turns = timing_turns("fast_vs_naive_8x4", TS, (sim, nsim, nsim, sim))
    nlat = {d: narrow_latency(TS, epm, topo, 0, d, params=naive) for d in (1, 2, 31)}
    phase("naive_8x4", cycles=1200, launches=naive_launches,
          gpu_ms_per_cycle=ms_naive, main_8x4_gpu_ms_per_cycle=ms_8x4,
          cpu_ms_per_cycle=ndt_cpu / 1200 * 1e3, gpu_state_equals_cpu=True,
          canonical_equals_main_8x4=True, fast_vs_naive_order="fast,naive,naive,fast",
          fast_vs_naive_gpu_ms_per_cycle=turns, fig7_latency=nlat,
          wide_util=float(nout["wide_util"]),
          narrow_lat_mean=float(nout["narrow_lat_mean"].mean()))
    check(nlat == {1: 22.0, 2: 26.0, 31: 58.0}, f"Fig. 7 latencies under naive {nlat}")
    layers_naive = layer_times(eng, nsim, nst)
    phase("layers_naive_8x4", **layers_naive)
    phase("profile_naive_8x4", **cut_profile("profile_naive_8x4", nsim, nst,
                                             layers_naive["step_ms"], PROFILE_STEPS))

    nbsim = TS.build_sim(btopo, naive, bwl)
    nbst, nbdt, naive_big_launches = run_counted(TS, nbsim, 200)
    t0 = time.perf_counter()
    nbst_cpu = TS.run(TS.build_sim(btopo, naive, bwl, device="cpu"), 200)
    nbdt_cpu = time.perf_counter() - t0
    naive_vs_fast(TS, "naive_32x32", (nbsim, nbst), nbst_cpu, (bsim, bst))
    phase("naive_32x32", cycles=200, launches=naive_big_launches,
          gpu_ms_per_cycle=nbdt / 200 * 1e3,
          scale_32x32_gpu_ms_per_cycle=bdt / 200 * 1e3,
          cpu_ms_per_cycle=nbdt_cpu / 200 * 1e3, gpu_state_equals_cpu=True,
          canonical_equals_scale_32x32=True,
          beats_rcvd=int(TS.stats(nbsim, nbst)["beats_rcvd"].sum()))
    del nbsim, nbst, nbst_cpu

    nvp = NocParams(step_impl="naive", n_vcs=2)
    nvsim = TS.build_sim(ttopo, nvp, twl)
    nvst, nvdt, naive_vc_launches, nvst_cpu = cut_run(
        "naive_torus_vc_8x4", TS, nvsim, lambda: TS.build_sim(ttopo, nvp, twl, device="cpu"))
    naive_vs_fast(TS, "naive_torus_vc_8x4", (nvsim, nvst), nvst_cpu, (vsim, vst))
    phase("naive_torus_vc_8x4", cycles=SUPER_CYCLES, n_vcs=2, launches=naive_vc_launches,
          gpu_ms_per_cycle=nvdt / SUPER_CYCLES * 1e3, torus_vc_8x4_gpu_ms_per_cycle=ms_vc,
          gpu_state_equals_cpu=True, canonical_equals_torus_vc_8x4=True,
          wide_util=float(TS.stats(nvsim, nvst)["wide_util"]))

    _, nar_sim, naive_ar_launches, nar_end = offload_run(
        "naive_allreduce_infabric_8x4", topo, 1, ar(topo), OFFLOAD_CYCLES, 400,
        done_at=693, step_impl="naive", uncut=OFFLOAD_CYCLES_UNCUT)
    bad = states_equal(TS.canonical_state(nar_sim, nar_end, scrub=True),
                       TS.canonical_state(ar_sim, ar_end, scrub=True))
    check(not bad, f"naive_allreduce_infabric_8x4 canonical state differs from the "
                   f"fast run's in {bad}")
    phase("naive_allreduce_infabric_8x4_vs_fast", canonical_equals_fast=True)

    # ---- 10. the model stack: Phi-4-mini, Mamba-2 and Zamba2 served ---------
    from repro_torch.configs import get_config

    model_errs = compare_model_kernels(dev)
    serve_vs_cpu(dev, "serve_phi4_mini_vs_cpu", get_config(PHI4).replace(n_layers=2),
                 400, 5)
    serve_vs_cpu(dev, "serve_mamba2_130m_vs_cpu", get_config(MAMBA2), 512, 8)
    # one superblock of 6 SSM layers, the shared attention once, one trailing
    # layer; 256 tokens are two chunks, so the state's carry is exercised
    serve_vs_cpu(dev, "serve_zamba2_7b_vs_cpu", get_config(ZAMBA2).replace(n_layers=7),
                 256, 9)
    # Llama-4-Scout at full width, cut to 2 layers; one MoE layer past capacity
    moe_serve_vs_cpu(dev, "serve_llama4_scout_vs_cpu",
                     get_config(LLAMA4).replace(n_layers=2), 120, 13)
    moe_drop_vs_cpu(dev, get_config(LLAMA4))
    # Gemma 3 at full width, cut to 7 layers (one superblock of 5 local and 1
    # global layer, one trailing local layer); a ragged prompt of 1 500
    # tokens padded to 2048, so the prefill ring holds pads (the engine's
    # quirk, on both sides) and the 4 decode steps write into it
    serve_vs_cpu(dev, "serve_gemma3_4b_vs_cpu", get_config(GEMMA3).replace(n_layers=7),
                 1500, 28)
    # DeepSeek-V2 at full width, cut to 2 layers: the dense first layer and
    # one MoE layer, both with MLA (4.83e9 parameters)
    moe_serve_vs_cpu(dev, "serve_deepseek_v2_vs_cpu",
                     get_config(DEEPSEEK).replace(n_layers=2), 120, 32)
    # Qwen2-VL at full width, cut to 2 layers (3.07e9 parameters): 400 tokens
    # padded to 512, random patch embeddings in the first 256 slots on both
    # sides; SeamlessM4T whole, random frames [1, 512, 1024] on both sides
    # and a 400-token decoder prompt

    def stub(name, seed, shape):
        """The batch entry ``name``: bf16 normal numbers of ``shape(S)``."""
        return lambda S: {name: randn(np.random.default_rng(seed), shape(S), torch.bfloat16,
                                      "cpu")}

    qwen = get_config(QWEN2VL).replace(n_layers=2)
    serve_vs_cpu(dev, "serve_qwen2_vl_vs_cpu", qwen, 400, 39, extra=stub(
        "patch_embeds", 40, lambda S: (1, min(qwen.frontend_tokens, S), qwen.d_model)))
    seamless = get_config(SEAMLESS)
    serve_vs_cpu(dev, "serve_seamless_vs_cpu", seamless, 400, 41,
                 extra=stub("frames", 42, lambda S: (1, S, seamless.d_model)))
    serve_launches = serve_models(dev)
    model_times = time_model_kernels(dev)

    # ---- 10b. training on the card: the backward kernels, Phi-4-mini --------
    t_train = time.perf_counter()
    new_s = {}  # the seconds of the SSM training phases

    def timed(name, fn):
        t1 = time.perf_counter()
        out = fn(dev)
        new_s[name] = time.perf_counter() - t1
        return out

    train_errs = compare_train_kernels(dev)
    train_errs.update(timed("kernels_vs_plain_train_ssd", compare_train_ssd))
    serve_launches["train_vs_cpu"] = train_vs_cpu(dev)
    for key, launches in timed("train_ssm_vs_cpu", train_ssm_vs_cpu).items():
        serve_launches[f"train_ssm_vs_cpu[{key}]"] = launches
    train_resume_card(dev)
    serve_int8_cache_vs_cpu(dev)
    serve_launches["train_phi4_mini"] = train_phi4_mini(dev)
    serve_launches["train_mamba2_130m"] = timed("train_mamba2_130m", train_mamba2_130m)
    serve_launches["train_zamba2_7b"] = timed("train_zamba2_7b", train_zamba2_7b)
    # Gemma 3, DeepSeek-V2 (MLA and MoE) and SeamlessM4T
    families_s = {}

    def timed_family(name, fn):
        t1 = time.perf_counter()
        out = fn(dev)
        families_s[name] = time.perf_counter() - t1
        return out
    for key, launches in timed_family("train_families_vs_cpu", train_families_vs_cpu).items():
        serve_launches[f"train_families_vs_cpu[{key}]"] = launches
    train_errs["moe_grouped_bwd"] = timed_family("moe_grouped_bwd", moe_grouped_bwd)
    for name, fn in (("train_gemma3_4b", train_gemma3_4b),
                     ("train_deepseek_v2", train_deepseek_v2),
                     ("train_seamless_m4t", train_seamless_m4t)):
        serve_launches[name] = timed_family(name, fn)
    train_times = timed_family("kernel_times_train", time_train_kernels)
    train_s = time.perf_counter() - t_train
    phase("train_phases", seconds=train_s)

    # ---- 11. the paged KV gather; the paper's figures through the port ----
    kv_err, kv_launches = compare_kv_gather(dev)
    kv_times = time_kv_gather(dev)
    figure_launches = {"figures_smoke": figures_smoke(dev), "fig10_rob": figure_fig10(dev)}

    # ---- 11b. the batched sweep and the design-space exploration ----------
    for key, e in sweep_kernels(rng, dev).items():
        errs[key] = max(errs[key], e)
    sweep_launches = {"sweep_8x4": sweep_8x4(dev), "dse_smoke": dse_smoke(dev),
                      "ddp_demo": ddp_demo(dev)}

    # ---- 12. the kernels line ----------------------------------------------
    src = "src/repro_torch/kernels/noc_router/csrc/noc_router.cu"
    tpu = "src/repro/kernels/noc_router/noc_router.py:"
    rows = [  # (LAUNCHES key, kernel, TPU kernel line, main-path launches,
              #  8x4 timing, 32x32 timing, 8x4 shape)
        ("arb", "noc_arb_kernel", 72, main_launches, timing_8x4["arb"],
         timing_32["arb"], "8x4 mesh, C=3, R=32, P=5, D=2"),
        ("apply", "noc_apply_kernel", 172, main_launches, timing_8x4["apply"],
         timing_32["apply"], "8x4 mesh, C=3, R=32, P=5, D=2"),
        ("arb_vc", "noc_arb_kernel[n_vcs=2]", 93, vc_launches,
         vc_8x4["arb"], vc_32["arb"], "8x4 torus, C=3, R=32, P=10 slots, D=2"),
        ("apply_vc", "noc_apply_kernel[n_vcs=2]", 172, vc_launches,
         vc_8x4["apply"], vc_32["apply"],
         "8x4 torus, C=3, R=32, P=10 slots, D=2"),
        ("fused", fused_8x4["kernel"], 414, super_launches, fused_8x4,
         fused_32, "8x4 mesh, C=3, R=32, P=5, D=2, window N=4"),
        ("fused_vc", fused_vc_8x4["kernel"] + "[n_vcs=2]", 419, torus_launches,
         fused_vc_8x4, fused_vc_32,
         "8x4 torus, C=3, R=32, P=10 slots, D=2, window N=4"),
        ("arb_offload", "noc_arb_offload_kernel", 120, ar_launches,
         offload_8x4, offload_32,
         "8x4 mesh, C=3, R=32, P=5, D=2, G=2 (in-fabric all-reduce)"),
        ("arb_offload_vc", "noc_arb_offload_kernel[n_vcs=2]", 120,
         tar_launches, offload_vc_8x4, None,
         "8x4 torus, C=3, R=32, P=10 slots, D=2, G=2 (in-fabric all-reduce)"),
        ("apply_unfused", "noc_apply_kernel[unfused]", 172, naive_launches,
         timing_8x4["apply_unfused"], timing_32["apply_unfused"],
         "8x4 mesh, C=3, R=32, P=5, D=2 (main_8x4's state)"),
        ("apply_unfused_vc", "noc_apply_kernel[unfused, n_vcs=2]", 172,
         naive_vc_launches, vc_8x4["apply_unfused"], vc_32["apply_unfused"],
         "8x4 torus, C=3, R=32, P=10 slots, D=2 (torus_vc_8x4's state)"),
    ]
    # the naive paths that launch the unfused mode, per LAUNCHES key
    naive_paths = {
        "apply_unfused": {"naive_8x4": naive_launches,
                          "naive_32x32": naive_big_launches,
                          "naive_allreduce_infabric_8x4": naive_ar_launches},
        "apply_unfused_vc": {"naive_torus_vc_8x4": naive_vc_launches}}
    # the naive paths launch the other kernels once a cycle too
    naive_others = {"arb": ("naive_8x4", "naive_32x32"), "arb_vc": ("naive_torus_vc_8x4",),
                    "arb_offload": ("naive_allreduce_infabric_8x4",)}
    naive_counts = {"naive_8x4": naive_launches, "naive_32x32": naive_big_launches,
                    "naive_torus_vc_8x4": naive_vc_launches,
                    "naive_allreduce_infabric_8x4": naive_ar_launches}
    kernels = []
    for key, name, line, launches, t8, t32, shape in rows:
        check(launches[key] > 0, f"{name} was not launched on its main path")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": f"{tpu}{line}", "launches": launches[key],
            "max_abs_err": errs[key], "ms": t8["ms"], "plain_ms": t8["plain_ms"],
            "bound_ms": t8["bound_ms"], "bound_by": t8["bound_by"],
            "library_ms": None, "shape": shape,
            "scale_32x32": None if t32 is None else {
                k_: t32[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "launch_floor_ms", "kernel", "cluster")
                if k_ in t32},
        })
        if "launch_floor_ms" in t8:  # the per-cycle rows: an empty launch's time
            kernels[-1]["launch_floor_ms"] = t8["launch_floor_ms"]
        for path, counts in sweep_launches.items():  # B x C channels as one state
            if counts[key]:
                kernels[-1][f"{path}_launches"] = counts[key]
        if key in ("apply", "apply_vc"):  # the collective cells launch it too
            kernels[-1]["offload_path_launches"] = (ar_launches if key == "apply"
                                                    else tar_launches)[key]
        if key in naive_paths:  # its paths, and the fused mode's time beside
            kernels[-1]["naive_path_launches"] = {
                path: counts[key] for path, counts in naive_paths[key].items()}
            kernels[-1]["fused_mode_ms"] = t8["fused_mode_ms"]
            kernels[-1]["scale_32x32"]["fused_mode_ms"] = t32["fused_mode_ms"]
        if key in naive_others:
            kernels[-1]["naive_path_launches"] = {
                path: naive_counts[path][key] for path in naive_others[key]}
        if "cluster" in t8:  # the fused rows: the plan, the pair, PR 12's kernel
            kernels[-1].update({k_: t8[k_] for k_ in (
                "cluster", "smem_bytes_per_cta", "layout", "threads",
                "per_cycle_pair_ms", "global_kernel_ms")})
    model_src = "src/repro_torch/kernels/{0}/csrc/{0}.cu"
    model_tpu = "src/repro/kernels/{0}/{0}.py:{1}"
    by_path = {path: {k: n for k, n in counts.items() if n}
               for path, counts in serve_launches.items()}
    # (kernel, its timing and error key, package, TPU kernel line, paths
    #  whose launches it counts); max_abs_err is the largest over the paths'
    #  shapes, each path shape's also beside its time
    model_rows = (
        ("flash_attention_kernel", "flash_attention", "flash_attention", 23,
         ("serve_phi4_mini", "serve_llama4_scout", "serve_gemma3_4b", "serve_qwen2_vl",
          "train_phi4_mini", "train_gemma3_4b")),
        ("flash_attention_kernel[D=112]", "flash_attention_d112", "flash_attention", 23,
         ("serve_zamba2_7b", "train_zamba2_7b")),
        ("flash_attention_kernel[D=192,Dv=128]", "flash_attention_mla", "flash_attention", 23,
         ("serve_deepseek_v2", "train_deepseek_v2")),
        ("flash_attention_kernel[D=64]", "flash_attention_seamless", "flash_attention", 23,
         ("serve_seamless_m4t", "train_seamless_m4t")),
        ("rmsnorm_kernel", "rmsnorm", "rmsnorm", 16,
         ("serve_phi4_mini", "serve_mamba2_130m", "serve_zamba2_7b", "serve_llama4_scout",
          "serve_gemma3_4b", "serve_deepseek_v2", "serve_qwen2_vl", "serve_seamless_m4t",
          "train_phi4_mini", "train_mamba2_130m", "train_zamba2_7b", "train_gemma3_4b",
          "train_deepseek_v2", "train_seamless_m4t")),
        ("rmsnorm_residual_kernel", "rmsnorm_residual", "rmsnorm", 24, ()),
        ("ssd_tc_kernel", "ssd", "ssd", 21, ("serve_mamba2_130m", "train_mamba2_130m")),
        ("ssd_tc_kernel[zamba2]", "ssd_zamba2", "ssd", 21,
         ("serve_zamba2_7b", "train_zamba2_7b")),
    )
    for name, key, pkg, line, paths in model_rows:
        t = model_times[key]
        count = key
        for tag in ("_d112", "_zamba2", "_mla", "_seamless"):
            count = count.removesuffix(tag)
        launches = {path: serve_launches[path][count] for path in paths}
        for path, n in launches.items():
            check(n > 0, f"{name} was not launched on its main path {path}")
        err = model_errs[key]
        if key == "flash_attention":
            err = max(err, *(model_errs[f"flash_attention_{k_}"] for k_ in (
                "llama4", "gemma3_window", "gemma3_global", "qwen2vl")))
        if key == "rmsnorm":
            err = max(err, *(model_errs[f"rmsnorm_d{dw}"] for dw in RMS_WIDTHS))
        kernels.append({
            "name": name, "route": "cuda", "source": model_src.format(pkg),
            "replaces": model_tpu.format(pkg, line), "launches": sum(launches.values()),
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "shape": t["shape"],
            **({"library_backend": t["library_backend"]} if "library_backend" in t else {}),
            "main_path": launches or
                         "none (the serve paths round x + a before their norms)",
            "decode": None if key + "_decode" not in model_times else {
                k_: model_times[key + "_decode"][k_] for k_ in
                ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        })
        if key == "rmsnorm":  # the Mamba-2, Zamba2, Llama-4, Gemma 3 and DeepSeek-V2 widths
            kernels[-1]["other_widths"] = [
                {**model_times[f"rmsnorm_d{dw}"], "max_abs_err": model_errs[f"rmsnorm_d{dw}"]}
                for dw in RMS_WIDTHS]
        if key == "flash_attention":  # Llama-4-Scout's 40 / 8 heads; Gemma 3's D = 256
            kernels[-1]["llama4_shape"] = {**model_times["flash_attention_llama4"],
                                           "max_abs_err": model_errs["flash_attention_llama4"]}
            kernels[-1]["qwen2vl_shape"] = {**model_times["flash_attention_qwen2vl"],
                                            "max_abs_err": model_errs["flash_attention_qwen2vl"]}
            kernels[-1]["gemma3_shape"] = {
                k_: {**model_times[f"flash_attention_gemma3_{k_}"],
                     "max_abs_err": model_errs[f"flash_attention_gemma3_{k_}"]}
                for k_ in ("window", "global")}
        if key == "flash_attention_seamless":  # the decoder's causal self-attention
            kernels[-1]["causal_shape"] = model_times["flash_attention_seamless_causal"]
    # the backward kernels: no TPU kernel; each computes the gradient of a
    # JAX function that the JAX package differentiates by autodiff. The
    # flash backward is a dispatch by dtype: bf16 on the training path, the
    # scalar float32 kernels on the float32 check against the CPU
    flash_bwd = ("flash_attention/csrc/flash_attention_bwd.cu",
                 "src/repro/models/attention.py:75",
                 ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"))
    ssd_bwd = ("ssd/csrc/ssd_bwd.cu", "src/repro/models/ssm.py:82",
               ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_reduce"))
    # the SSD backward is likewise a dispatch by dtype
    ssd_bwd_tc = "ssd_bwd_state_tc_kernel + ssd_bwd_chunk_tc_kernel + ssd_bwd_reduce_kernel"
    ssd_bwd_f32 = "ssd_bwd_state_kernel + ssd_bwd_chunk_kernel + ssd_bwd_reduce_kernel"
    # the SSD backward's float32 instances run on train_ssm_vs_cpu's paths
    ssd_f32_paths = [p_ for p_ in serve_launches if p_.startswith("train_ssm_vs_cpu")]
    family_f32_paths = [p_ for p_ in serve_launches if p_.startswith("train_families_vs_cpu")]
    wide_bwd = "flash_bwd_dq_wide_kernel + flash_bwd_dkdv_wide_kernel (bf16)"
    for name, key, err, paths, (source, grad_of, counts) in (
            ("flash_bwd_dq_wgmma_kernel + flash_bwd_dkdv_wgmma_kernel (bf16)",
             "flash_attention_bwd", train_errs["flash_attention_bwd_bfloat16"],
             ("train_phi4_mini", "train_zamba2_7b"), flash_bwd),
            (wide_bwd + " [D=Dv=256, window 1024 and global]", "flash_attention_bwd_gemma3_window",
             train_errs["flash_attention_bwd_gemma3_bfloat16"], ("train_gemma3_4b",), flash_bwd),
            (wide_bwd + " [D=192, Dv=128]", "flash_attention_bwd_mla",
             train_errs["flash_attention_bwd_mla_bfloat16"], ("train_deepseek_v2",), flash_bwd),
            ("flash_bwd_dq_wgmma_kernel + flash_bwd_dkdv_wgmma_kernel (bf16) [D=64]",
             "flash_attention_bwd_seamless", train_errs["flash_attention_bwd_seamless_bfloat16"],
             ("train_seamless_m4t",), flash_bwd),
            ("flash_bwd_dq_kernel + flash_bwd_dkdv_kernel (float32)", "flash_attention_bwd_f32",
             max(train_errs[f"flash_attention_bwd{g}_float32"]
                 for g in ("", "_gemma3", "_mla", "_seamless")),
             ("train_vs_cpu", "train_ssm_vs_cpu[zamba2_7b_7_layers]", *family_f32_paths),
             flash_bwd),
            ("rmsnorm_bwd_kernel (rmsnorm_bwd_wide_kernel past 384 chunks) + rmsnorm_dw_kernel",
             "rmsnorm_bwd", max(train_errs["rmsnorm_bwd_bfloat16"],
                                train_errs["rmsnorm_bwd_float32"]),
             ("train_phi4_mini", "train_mamba2_130m", "train_zamba2_7b", "train_gemma3_4b",
              "train_deepseek_v2", "train_seamless_m4t"),
             ("rmsnorm/csrc/rmsnorm_bwd.cu", "src/repro/models/layers.py:18",
              ("rmsnorm_bwd", "rmsnorm_bwd_dw"))),
            (ssd_bwd_tc + " (bf16)", "ssd_bwd", train_errs["ssd_bwd_bfloat16"],
             ("train_mamba2_130m",), ssd_bwd),
            (ssd_bwd_tc + " (bf16) [zamba2]", "ssd_bwd_zamba2",
             train_errs["ssd_bwd_bfloat16"], ("train_zamba2_7b",), ssd_bwd),
            (ssd_bwd_f32 + " (float32)", "ssd_bwd_f32", train_errs["ssd_bwd_float32"],
             tuple(ssd_f32_paths), ssd_bwd)):
        t = train_times[key]
        main = {path: {c: serve_launches[path][c] for c in counts} for path in paths}
        for path, by in main.items():
            check(all(n > 0 for n in by.values()),
                  f"{name} was not launched on its main path {path}: {by}")
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/kernels/" + source,
            "replaces": grad_of,
            "launches": sum(n for by in main.values() for n in by.values()),
            "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "main_path": main,
            "gradient_of": grad_of + " (JAX autodiff; no backward Pallas kernel)",
            **({"library_backend": t["library_backend"]} if "library_backend" in t else {}),
            **({"ops_ms_at_scalar_f32": t["ops_ms_at_scalar_f32"]}
               if "ops_ms_at_scalar_f32" in t else {}),
        })
        if key == "flash_attention_bwd":  # train_zamba2_7b's shape
            kernels[-1]["zamba2_shape"] = train_times["flash_attention_bwd_zamba2"]
        if key == "flash_attention_bwd_gemma3_window":  # the global layers' shape
            kernels[-1]["global_shape"] = train_times["flash_attention_bwd_gemma3_global"]
        if key == "flash_attention_bwd_seamless":  # the decoder's self- and cross-attention
            kernels[-1]["causal_shape"] = train_times["flash_attention_bwd_seamless_causal"]
            kernels[-1]["cross_shape"] = train_times["flash_attention_bwd_seamless_cross"]
        if key == "flash_attention_bwd_f32":  # train_families_vs_cpu's shapes
            kernels[-1]["family_shapes"] = {
                g: train_times[f"flash_attention_bwd_f32_{g}"]
                for g in ("gemma3", "mla", "seamless")}
        if key.startswith("ssd_bwd"):  # the tolerance's measure: of each gradient's largest value
            kernels[-1]["kernels_alone_ms"] = t["kernels_alone_ms"]
            kernels[-1]["max_rel_err"] = train_errs[("ssd_bwd_float32_rel" if "float32" in name
                                                     else "ssd_bwd_bfloat16_rel")]
    kernels.append({
        "name": "kv_gather_kernel", "route": "cuda",
        "source": "src/repro_torch/kernels/kv_gather/csrc/kv_gather.cu",
        "replaces": "src/repro/kernels/kv_gather/kv_gather.py:17", "launches": kv_launches,
        "max_abs_err": kv_err, "ms": kv_times["ms"], "plain_ms": kv_times["plain_ms"],
        "bound_ms": kv_times["bound_ms"], "bound_by": kv_times["bound_by"],
        "library_ms": kv_times["library_ms"], "shape": kv_times["shape"],
        "main_path": KV_MAIN_PATH,
    })
    by_path.update({path: {k: n for k, n in counts.items() if n}
                    for path, counts in {**figure_launches, **sweep_launches,
                                         **naive_counts}.items()})
    phase("launches_by_path", **by_path)
    # the training phases' seconds against the cuts' estimated savings, both
    # from this run
    saved = sum(c["saved_estimate_s"] for c in CUTS.values())
    phase("time_budget", train_phases_s=train_s, cuts_saved_estimate_s=saved,
          cuts_seconds_now=sum(c["seconds"] for c in CUTS.values()),
          covered=saved >= train_s, cuts=CUTS, ssm_training_phases_s=new_s,
          families_training_phases_s=families_s)
    phase("total", seconds=time.perf_counter() - t_start)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
