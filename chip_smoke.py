#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases, each fatal on failure:
  1. card and build: print the card's name and power limit, build every
     CUDA kernel of the port with nvcc from the sources in this checkout;
  2. each kernel against its plain PyTorch version at the main paths'
     shapes, with its time, its plain version's time, one library call's
     time and its bound (CUDA events); then at the other configs' shapes:
     paged GQA at yi-6b's and mistral-nemo-12b's heads (32 of 128 over 4
     and 8 kv heads) and zamba2-1.2b's (16 slots, 32 of 64 over 32, G 1),
     the exit head at their vocab widths (zamba2's 32,000 on 16 rows),
     flash attention at starcoder2-3b's (8192 tokens, 24 / 2 heads of
     128, window 4096) and zamba2-1.2b's (2 x 2048 tokens, 32 / 32 heads
     of 64, causal); the exit head at xlstm-350m's [16, 1024] x [1024,
     50,304] and the int8 pair on its fp32 mLSTM memory [10,240, 512];
     paged GQA at qwen2-vl-2b's 12 heads of 128 over 2 (G 6), the exit
     head at its [16, 1536] x [1536, 151,936] and at whisper-base's odd
     pitch [16, 512] x [512, 51,865], flash at qwen2-vl-2b's forward (2 x
     2048, causal) and without a mask at whisper-base's encoder (16 x
     1,500) and cross-attention (16 x 448 against 1,500); paged GQA at
     llama4-maverick's 40 heads of 128 over 8 (G 5), the exit head at its
     [16, 5120] x [5120, 202,048] and flash at its forward (2 x 2048, 40
     / 8 heads of 128, causal);
  3. small-input references: granite-3-2b-smoke, deepseek-v3-671b-smoke,
     yi-6b-smoke, mistral-nemo-12b-smoke, zamba2-1.2b-smoke,
     xlstm-350m-smoke, qwen2-vl-2b-smoke and llama4-maverick-400b-a17b-
     smoke (bf16 and W8A8 experts) paged decode, starcoder2-3b-
     smoke on its contiguous ring past the window and whisper-base-smoke
     on its contiguous cache over primed cross rows, on the card (kernels)
     against the same weights on the CPU (plain versions); the forward
     also for qwen2-vl-2b-smoke with patches, whisper-base-smoke with
     frames and llama4-maverick-smoke with W8A8 experts;
  4. the main path at full width: granite-3-2b (40 layers, random seeded
     weights) serving a Poisson trace through ``serve_poisson`` with the
     paged KV arena and depth-segmented decode; both kernels' launch counts
     must go up, and each kernel is held against its plain version again on
     inputs captured from that run;
  4b. async decode windows at full width: granite-3-2b cut in depth to
     16 layers, paged, 16 slots, monolithic steps.  (a) A closed loop of 16 requests (prompts 16-64
     tokens, max_new 64) through the eager sync poll, then through windows
     of 8 steps (one CUDA graph of one step, captured once, replayed 8
     times a window): tokens bit-identical (a top-2 tie under 1e-2 is the
     only excuse), one capture, and 16 paged-attention launches per decode
     step the card ran in each; (b) the same loop again with every decode
     poll under ``torch.cuda.set_sync_debug_mode("error")`` (the ring wait
     is an event wait); (c) sampled decode at T 0.7: two runs from the
     same generator seed give the same in-vocabulary tokens; (d) a Poisson
     run of 32 requests at 16 req/s (prompts 16-64, max_new 64) through
     ``serve_poisson``, sync segmented and then async, with tok/s, p50/p95
     and host and readback ms per decode step; then ``profile_decode``
     splits a decode step into host and device time, sync and windowed;
  5. the tiered path at full width: granite-3-2b behind the cloud/edge/
     device cluster with an edge outage mid-trace, once through
     ``serve_tiered_poisson`` (contiguous arenas, handoff chosen per link)
     and once through ``TieredServingCluster`` with paged arenas and a
     forced int8 handoff; every request must complete, in-flight slots must
     migrate, and all four kernels must launch during the second run; the
     int8 kernels are held against their plain versions again on a leaf
     captured from a live export; a third run takes the first's trace
     through async decode windows of 4 in every tier pool, whose windows
     in flight must be drained before the outage export;
  6. the deepseek-v3 path at full width, cut to 4 layers (3 dense, 1 MoE
     with 256 experts): ``serve_poisson`` with the paged arena, the prefix
     cache and segmented decode; the paged-MLA and exit-head kernels must
     launch and are held again on live inputs, one live MoE input's
     capacity drops are recounted on the host, a closed loop of 16
     requests (max_new 8 to 24) runs through async decode windows with
     tokens equal to the sync monolithic poll's, ``profile_decode``
     splits a decode step into host and device time, and one
     ``Model.forward`` over 2 x 256 tokens runs MLA and the MoE forward;
  7. the full-sequence forward at full width: granite-3-2b (40 layers)
     through ``Model.forward`` on 8 x 2048 tokens (one flash-attention
     launch per layer), ``resilient_forward`` with every block alive (equal
     to the forward) and with block 0 dead, and the forward's greedy tokens
     against the decode replay of ``Model.prefill`` on 2 x 128 tokens,
     measured on an fp32 forward; the plain-attention forward must pass
     that check and a planted fault (P in fp8 before P V) must fail it;
  8. multi-model pools and speculative pairs at full width, each model
     cut in depth to 8 layers: (a) one
     ``MultiModelScheduler`` serving granite-3-2b, yi-6b and
     mistral-nemo-12b (seeds 0, 1, 2) through ``serve_multi_poisson``, 6
     Poisson requests round-robin, paged and segmented, 8 slots a model;
     each model's streams must equal a dedicated scheduler's bit for bit
     and both kernels must launch for every model; (b) a ``SpecPair`` at k
     4, granite-3-2b drafting for itself with shared params and with a
     draft seeded 7, streams bit-identical to the target-only monolithic
     greedy pool, acceptance at least 2.5 with shared params; (c) the
     tiered cluster over a ``ModelGroup`` with ``spec_draft``, where every
     request must route speculative, match target-only greedy, and feed
     its measured acceptance (at least 4 at k 6) back to the router;
  9. the hybrid family and the engine at full width: zamba2-1.2b cut in
     depth to 14 Mamba2 layers (of 38), one shared attention block at 2
     sites (of 6), random seeded weights.  (a) ``serve_poisson``, paged and segmented, 16 slots, 24
     requests at 8 req/s, prompts 32-128 (a quarter sharing a prefix that
     must never hit: the arena has no prefix cache), 16 new: the paged-GQA
     (G 1) and exit-head (V 32,000) counts must rise and each kernel is
     held against its plain version on a live input; ``profile_decode``
     and the Mamba layers' share of a step's device time.  (b) a closed
     loop of 24 requests on 8 slots (slots reused, state rows reset; rows
     finishing mid-window), sync monolithic then windows of 8: tokens
     equal (a top-2 tie under 1e-2 the only excuse), one capture.  (c) one
     ``Model.forward`` over 2 x 2048 tokens (2 flash launches) and its
     argmax against the decode replay on 2 x 256.  (d) ``ServingEngine``:
     ``generate`` on 8 x 64 prompts equal to the scheduler bit for bit,
     the tiered engine equal to the single pool, and an adaptive async
     engine whose threshold moves up with one capture;
 10. the xLSTM family at full width: xlstm-350m cut in depth to 12
     layers (10 mLSTM and 2 sLSTM, of 20 and 4), random seeded weights;
     fp32 state rows a slot and no pool at all.  (a) ``serve_poisson``, paged and segmented, 16
     slots, 16 requests at 8 req/s, prompts 24-96 (a quarter sharing a
     prefix that must never hit), 16 new: both exit probes (V 50,304)
     launch and each is held against its plain version on a live input;
     ``profile_decode`` and the mLSTM and sLSTM layers' shares of a
     step's device time.  (b) a closed loop of 16 requests on 8 slots,
     sync monolithic then windows of 8: tokens equal (a top-2 tie under
     1e-2 the only excuse), one capture, and each slot's last occupant's
     state rows equal the sync poll's bit for bit.  (c) one
     ``Model.forward`` over 2 x 2048 tokens, and layer 0's chunked mLSTM
     against its recurrence on 2 x 512 tokens, with a planted control (the
     second chunk without its carried state) that must fail.  (d) a live
     slot exported from a 16-slot paged arena and imported into another,
     raw (the stream continues bit for bit) and int8 (every leaf and scale
     equal to the plain quantizer's on the live leaf, dequantized bit for
     bit, the stream complete).
 11. M-RoPE and vision-patch inputs at full width: qwen2-vl-2b (cut in
     depth to 10 layers of 28; d_model 1536, 12 / 2 heads of 128, vocab
     151,936, random seeded weights).  (a) ``serve_poisson``, paged and
     segmented, 16 slots, 12 requests at 8 req/s, prompts 24-96 (a quarter
     sharing a prefix), 12 new: paged GQA at G 6 and both exit probes
     (V 151,936) launch and each is held against its plain version on a
     live input; ``profile_decode``.  (b) a closed loop of 12 requests on
     8 slots, sync monolithic then windows of 8: tokens equal (a top-2 tie
     under 1e-2 the only excuse), one capture.  (c) one ``Model.forward``
     over 2 x 2048 tokens whose first 1,024 positions a row are patch
     embeddings (a 32 x 32 M-RoPE grid): one flash launch a layer, a live
     call held against the plain version, every logit finite.
 12. the encoder-decoder family at full width: whisper-base (6 encoder +
     6 decoder layers, d_model 512, 8 heads of 64, 1,500 frames, vocab
     51,865, random seeded weights, nothing cut; contiguous arenas, each
     request with seeded 0.02 N(0, 1) frames).  (a) ``serve_poisson``,
     segmented, 16 slots, 16 requests at 8 req/s, prompts 16-64, 16 new:
     each admission encodes its slots' frames (flash without a mask at 16
     x 1,500) into the cross rows; the exit probes (odd pitch, V 51,865)
     and the encoder's flash are held on live inputs; ``profile_decode``.
     (b) a closed loop of 16 requests on 8 slots, sync monolithic then
     windows of 8, so 8 requests enter freed slots after the capture:
     tokens equal (the tie rule), one capture, and the last occupants'
     cross rows equal the sync poll's bit for bit.  (c) one
     ``Model.forward`` over 16 x 448 decoder tokens and 16 x 1,500 frames:
     18 flash launches (the encoder's, the decoder's causal self-attention
     and its cross-attention against 1,500 keys), one live call of each
     held against the plain version.  (d) a live slot migrated between
     16-slot contiguous arenas, raw (bit for bit) and int8 (every leaf and
     scale, the cross rows' too, equal to the plain quantizer's).  (e) the
     batch mode's ``serve`` (``ServingEngine.generate(frames=)``) equal to
     a dedicated scheduler bit for bit.
 13. llama4 pair units and W8A8 experts: llama4-maverick-400b-a17b at its
     published widths (d_model 5120, 40 / 8 heads of 128, vocab 202,048,
     dense d_ff 16,384, 128 experts of 8,192 top-1 plus a shared one),
     cut in depth only to 4 layers, two pair units, the exit at 2;
     random seeded weights, 72.6 GB of bf16, quantized in place to about
     40.4 GB (32.2 GB of int8 experts).  (a) One live MoE layer on 16
     tokens of 0.5 N(0, 1), bf16 experts then W8A8: relative error under
     0.05, each of the three W8A8 products bit-exact against its plain
     version, the kernel timed against the plain version and against
     ``torch.bmm`` in bf16 on the same shapes.  (b) ``serve_poisson`` on
     the quantized tree, paged and segmented, 16 slots, 16 requests at 8
     req/s, prompts 16-64 (a quarter sharing a prefix), 16 new: paged GQA
     (G 5), the exit probe (V 202,048) and the W8A8 kernel launch, each
     held against its plain version on a live input; one live MoE input's
     capacity drops recounted on the host; ``profile_decode``.  (c) a
     closed loop of 16 requests on 8 slots, sync monolithic then windows
     of 8: tokens equal (the tie rule), one capture.  (d) one
     ``Model.forward`` over 2 x 2048 tokens: one flash launch a layer, a
     live flash call and a live W8A8 call (C 40) held against their plain
     versions, every logit finite.  (e) a live pair slot migrated between
     16-slot paged arenas, raw (bit for bit) and int8 (every leaf and
     scale equal to the plain quantizer's).
 14. training with the flash backward kernel (csrc/flash_attention_bwd.cu,
     which replaces no Pallas kernel: the reference differentiates its jnp
     ``_sdpa``).  (a) the backward kernel against its plain version at
     granite-3-2b's training shape (q [4, 1024, 32, 64], 8 kv heads,
     causal), the same with window 256, whisper-base's unmasked cross
     shape (q [16, 448, 8, 64] against [16, 1500, 8, 64]) and qwen2-vl-2b's
     head dim 128 ([2, 2048, 12, 128], 2 kv heads, G split over blocks):
     the forward's output the same bits with and without its log-sum-exp,
     that log-sum-exp within 1e-3 of the plain one, dq, dk and dv within
     2e-2 of max(1, |plain|), two backward calls the same bits, a planted
     control (the kernels given a zero o, so D = 0 and dS = P o dP)
     failing that, and each timed three times interleaved with SDPA's
     backward (granite's forward also with and without the
     log-sum-exp).  (b)
     granite-3-2b at full width (40 layers, random seeded weights) through
     ``launch.train.train``: 5 AdamW steps of 4 x 1024 tokens with the
     BranchyNet joint loss; finite losses and grad norms, 40 forward and
     40 backward flash launches a step, no plain attention; a step timed
     by CUDA events and under ``torch.profiler``, the vocab heads and the
     optimizer timed apart.  (c) a 4-layer cut at full width on
     2 x 2048: every leaf's gradient through the kernels within 5e-2
     relative L2 of the same step's through plain attention (a pass that
     launches no flash kernel), and the planted control (4 backward
     launches) failing that.  (d)
     ``examples/torch/train_100m.py``: 200 steps of 8 x 256, the loss
     below 0.8x its first, the final checkpoint restored bit for bit, and
     a run resumed from the step-100 checkpoint within 1e-3 of the
     uninterrupted losses.  (e) ``quickstart.py``,
     ``resilient_inference.py`` (its assertion holds) and
     ``collaborative_serving.py`` on the card, with their launch counts.
 15. the analyzer's runtime guards and cost check (``repro_torch.
     analysis``).  (a) granite-3-2b at full width cut to 16 layers,
     paged with the prefix cache, 16 slots, async windows of 8: two waves
     of 8 requests over two shared 32-token prefixes (the second wave
     hits them) under ``SlotAudit`` after every poll, and the second
     wave's decode polls, after the first wave's capture, under
     ``no_recompile`` (bound 0), ``guard_polling`` (sync debug mode
     "error") and ``guard_sync_budget`` (bound 1); tokens equal to an
     unguarded pool's.  (b) granite-3-2b cut to 8 layers as the draft and
     the target of a tiered cluster whose device tier dies mid-trace (a
     slot migrates, a request completes through the speculative bridge,
     the drain requeues the rest) under ``SlotAudit``.  (c) the CST001 cost check at full width (40
     layers, 16 slots, max_len 256; a paged segmented and a contiguous
     monolithic arena, paged attention launching): each arena's
     measured and analytic FLOPs per token and their ratio, inside
     ``costcheck.TOLERANCE``; and the smoke audit stack counting the
     same FLOPs on the card as on the CPU.  (d) planted controls that
     must fail: a live page's refcount bumped (``SlotAudit``), an extra
     ``.item()`` in a poll (``guard_sync_budget``), a cache leaf rebound
     under the built window (``no_recompile``), the analytic cost scaled
     by 4 (CST001).  (e) paged GQA, paged MLA and both exit-head
     instances launched from a second host thread (each sets its
     shared-memory attribute on every launch) with the main thread's
     bits.
 16. collaborative execution over a world of ranks (``launch.mesh``:
     gloo, one process a rank, both on this card; every kernel built by
     phase 1 before any rank starts).  (a) Staged execution
     (``core.hierarchy.staged_forward``) of granite-3-2b at full width
     and depth (40 layers, its exit moved to layer 20 so the two scan
     blocks split 20/20; staged execution runs no exit), random seeded
     weights, on two ranks (pod 2): each rank makes only its stage's
     blocks (and the embedding and head its stage reads); a batch of 4 x
     1024 tokens, one warm-up, then a raw and an int8 boundary run.  Raw:
     the logits equal the parent's one-process ``Model.forward`` on the
     same weights bit for bit (sha256 of the bytes).  Int8: the
     boundary's (q, scale) equal ``ref.quantize_rows_ref`` and the landed
     activation ``ref.dequantize_rows_ref`` bit for bit, and the logits
     differ from the raw ones by more than 0 and less than 1.0 (the
     reference's own bounds).  (b) The expert-parallel MoE
     (``moe_ffn(..., ShardCtx(mesh))``) of one llama4-maverick layer at
     full width (128 experts of 8192, d_model 5120, W8A8) on two ranks
     (model 2), each making and quantizing only its 64 experts, on 2 x
     2048 tokens, against the parent's single-device layer made after
     the ranks exit (y within 2e-2 of max(1, |ref|), aux within 1e-3).
     Each rank's launches, wall time (after a warm-up call) and peak
     memory are printed.
 17. the tooling (``launch.dryrun``, ``op_cost``, ``profile_pair``): (a)
     ``dryrun_one`` on meta for granite-3-2b decode_32k on the 256-chip
     mesh and deepseek-v3-671b train_4k on the 512-chip mesh: status,
     per-device argument GB, ``fits_80gb``, counted flops and bytes a
     device, bottleneck; (b) ``profile_pair`` granite-3-2b prefill_32k
     on this card at 8 x 2048 (phase 7's forward, every output kept), (c)
     its decode step at 16 rows over a cache of 4,096: each counted
     under ``op_cost``, timed warm by CUDA events, its busy share by
     ``torch.profiler``, its bound and ``mfu``; every share at most 1.05
     (a count above what the card did fails); (d) ``profile_pair
     --staged`` raw and int8 at phase 16 (a)'s 4 x 1024 (40 layers split
     20/20) on two gloo ranks: each rank's collective bytes equal phase
     16's (boundary 16,777,216 raw and 8,404,992 int8, the logits'
     broadcast 805,355,520), and rows 4-6 launch.  The phase stays under
     90 s.
Phase 2 also holds the flash-attention kernel against its plain version,
and phase 3 the smoke-width ``Model.forward`` on the card against the CPU.
Phase 2 times the paged GQA and paged MLA kernels, the exit head (at
both widths, naming the instance each takes) and flash attention three
times each, interleaved with their library calls, and prints each one's
median and spread; phases 4 and 6 time the paged kernels the same way on
the live call they capture, at the lengths serving reaches.  The int8
kernels (no library call computes either) are timed three times each on
two copies of the granite-3-2b slot leaf and of a deepseek-v3 c_kv slot
leaf [124928, 512], and phase 5 times them on its live export leaf; every
int8 line names the instance the plan picks.
Prints the per-kernel JSON line, then as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when CUDA is unavailable or the port's sources are not beside this file.
"""
import argparse
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
sys.path.insert(0, SRC)
# one H100 SXM's published peaks at 700 W (NVIDIA data sheet, dense), one
# source for the port: HBM bytes/s and bf16 tensor-core FLOP/s, and int8
# tensor-core OP/s.  Without the port beside this file the import fails
# and the script exits non-zero before it prints a result.
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW, INT8_PEAK, PEAK_FLOPS)

PEAKS = (HBM_BW, PEAK_FLOPS)

PAGED_TOL = 1e-2   # bf16 output: both accumulate in fp32 and round once;
                   # one bf16 ulp of |out| < 2 is at most 2^-7 = 0.0078
ENT_TOL = 1e-3     # fp32 entropy (~log V = 10.8) from fp32 sums over
                   # D = 2048 products taken in another order
# the int8 kernels are held bit for bit: the same formula, one IEEE
# division and one rounding per element, and no sum whose order can differ
LOGIT_TOL = 3e-2   # logits are bf16 matmul results: cuBLAS and the CPU
                   # round a few bf16 ulps (2^-7 at |logit| ~ 1) apart
MLA_TOL = 1e-3     # fp32 latent context from the same bf16 inputs: only
                   # the order of fp32 sums over R + Hr = 576 products and
                   # the softmax terms differs; outputs are convex
                   # combinations of latents |c| < 5
ROUTE_TIE = 1e-2   # router probabilities closer than this are a tie: the
                   # card's and the CPU's bf16 hidden states differ by an
                   # ulp, which may flip such a top-k choice
FLASH_TOL = 1e-2   # of max(1, |plain|): bf16 output, both accumulate in
                   # fp32 and round once, so they may sit one bf16 ulp apart
                   # (2^-6 > 1e-2 where |out| >= 2: rows that see few keys);
                   # the kernel also rounds P to bf16 for P V
EXIT_TOL = 2 * LOGIT_TOL   # smoke exit logits: the exit head's W is drawn
                   # at 1/sqrt(D), 3x the embedding's 0.02 at D 256, so its
                   # logits and their ulps are ~3x larger, but it reads the
                   # hidden state after one layer, not all of them (as
                   # tests/test_torch_forward.py holds them)
AUX_TOL = 1e-2     # MoE aux loss (~1): fp32 means of router probabilities
                   # taken from bf16 hidden states an ulp apart
RESILIENT_TOL = 1e-3   # all blocks alive: a * y + (1 - a) * x is y exactly
LOGIT_TIE = 1e-2   # top-2 logits closer than this are an argmax tie
REPLAY_TIE = 5e-2  # ... in phase 7's forward-vs-replay check, which
                   # measures the gap between the two paths' choices on an
                   # fp32 forward: at 40 bf16 layers every sound path
                   # (kernel forward, plain-attention forward, decode
                   # replay) sits up to ~0.09 from the fp32 logits (std
                   # 0.9), and the plain-attention forward and the replay
                   # flip argmax at fp32 gaps up to ~0.04.  The check cannot
                   # see a flip where the fp32 top-2 gap is under this (it
                   # prints that share), so REPLAY_ACC is added
REPLAY_ACC = 1.25  # a forward's mean deviation from the fp32 forward may
                   # exceed the decode replay's by at most this factor: the
                   # sound forwards read about 1.0, the planted control
                   # (P rounded to fp8 before P V) about 2.6 (PERF.md keeps
                   # each run's readings); the control must fail the check


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def depth_cut(cfg, layers, exits, **kw):
    """``cfg`` at its published widths, cut in depth to ``layers`` layers
    with exit heads after ``exits`` (and any other field in ``kw``), named
    ``<name>-<layers>l``.  The serving phases after the main path run such
    cuts: their host time grows with every layer, and what they check
    (pools, windows, handoffs, routing) does not depend on depth."""
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-{layers}l", num_layers=layers,
        exits=dataclasses.replace(cfg.exits, exit_layers=exits), **kw)


def device_ms(torch, fn, args_list, iters=20):
    """Device time of one call, from CUDA events around ``iters`` calls
    queued behind a sleep kernel (so host enqueue time is not counted)."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    e0.record()
    for i in range(iters):
        fn(*args_list[i % len(args_list)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def interleaved_ms(torch, kernel, library, args_list, rounds=3, iters=20,
                   lib_args=None):
    """A redesigned kernel and its library call, each timed ``rounds``
    times in turns (library, kernel, kernel, library, ...): the median and
    the spread (max - min) of each, and every reading.  ``lib_args`` are
    the library call's own arguments where they differ; with no library
    call (``library`` None) the kernel alone, ``rounds`` times."""
    fns = {"kernel": kernel, "library": library}
    args = {"kernel": args_list, "library": lib_args or args_list}
    order = [n for n in ("library", "kernel") if fns[n] is not None]
    times = {name: [] for name in order}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(device_ms(torch, fns[name], args[name],
                                         iters))
    return {name: {"median": sorted(t)[len(t) // 2],
                   "spread": max(t) - min(t), "ms": t}
            for name, t in times.items()}


def live_timing(torch, kernel, library, args_list, lib_args, bound_by):
    """A kernel on a call captured from a serving run, interleaved with its
    library call: both medians and spreads, and the call's bound."""
    spread = interleaved_ms(torch, kernel, library, args_list,
                            lib_args=lib_args)
    return {"shapes": [list(t.shape) for t in args_list[0]],
            "ms": spread["kernel"]["median"],
            "library_ms": spread["library"]["median"],
            "bound_ms": bound_by[0], "bound_by": bound_by[1],
            "spread": spread}


def print_spread(label, spread):
    for name, r in spread.items():
        print(f"  {label} {name}: median {r['median']:.4f} ms, spread "
              f"{r['spread']:.4f} ms over {len(r['ms'])} interleaved runs "
              f"{[round(t, 4) for t in r['ms']]}")


def bound(nbytes, ops, ops_peak=PEAKS[1]):
    """Least time in ms for the work, and what sets it (``ops_peak``: the
    rate of the operations' type, bf16 unless said)."""
    t_bytes, t_ops = nbytes / PEAKS[0], ops / ops_peak
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def paged_bound(args):
    q, pk, _, _, pos = args
    _, _, nq, hd = q.shape
    page, nkv = pk.shape[1], pk.shape[2]
    pages = int((pos.long() // page + 1).sum())
    tokens = int((pos.long() + 1).sum())
    nbytes = (2 * q.numel() * 2 + pages * page * nkv * hd * 2 * 2
              + pages * 4 + pos.numel() * 4)
    return bound(nbytes, 4 * nq * hd * tokens)


def exit_bound(x, w):
    t, d = x.shape
    v = w.shape[1]
    return bound(x.numel() * 2 + w.numel() * 2 + t * 4, 2 * t * d * v)


def mla_bound(args):
    ql, qr, pc, _, _, pos = args
    b, _, n, r = ql.shape
    hr = qr.shape[3]
    page = pc.shape[1]
    pages = int((pos.long() // page + 1).sum())
    tokens = int((pos.long() + 1).sum())
    nbytes = ((ql.numel() + qr.numel()) * 2 + pages * page * (r + hr) * 2
              + b * n * r * 4 + pages * 4 + pos.numel() * 4)
    return bound(nbytes, 2 * n * (r + hr + r) * tokens)


def quant_bound(x):
    t, d = x.shape
    return bound(x.numel() * x.element_size() + t * d + 4 * t, 4 * t * d)


def dequant_bound(q, out_dtype_bytes):
    t, d = q.shape
    return bound(t * d + 4 * t + t * d * out_dtype_bytes, t * d)


def w8a8_bound(aq, a_s, wq, w_s):
    """Bytes: aq, wq and both scales read once, the fp32 output written
    once; operations: 2 per multiply-add of every capacity row (the
    kernel computes them all), at the int8 peak."""
    e, c, k = aq.shape
    n = wq.shape[2]
    nbytes = aq.numel() + wq.numel() + 4 * (a_s.numel() + w_s.numel()) \
        + 4 * e * c * n
    return bound(nbytes, 2 * e * c * k * n, INT8_PEAK)


def bits_equal(torch, a, b):
    """Bitwise equality of two tensors of one dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    if a.dtype in view:
        a, b = a.view(view[a.dtype]), b.view(view[b.dtype])
    return bool(torch.equal(a, b))


def int8_instances(x, out_dtype_bytes):
    """The instances the plan picks for quantizing ``x`` [..., D] and for
    dequantizing its q to an output of ``out_dtype_bytes`` (the wrappers'
    outputs are fresh, hence aligned)."""
    from repro_torch.kernels import feature_compress as fc
    x = x.reshape(-1, x.shape[-1])
    t, d = x.shape
    return {"quantize": fc.plan(t, d, x.element_size(),
                                (x.data_ptr(),))["instance"],
            "dequantize": fc.plan(t, d, out_dtype_bytes, (0,),
                                  kernel="dequantize")["instance"]}


def check_quant_pair(torch, ops, ref, x, out_dtype, label):
    """Both int8 kernels against their plain versions on ``x``; fails on
    any bit that differs.  Returns the max abs difference (0.0)."""
    inst = int8_instances(x, torch.tensor([], dtype=out_dtype)
                          .element_size())
    q, s = ops.compress_rows(x)
    qr, sr = ref.quantize_rows_ref(x)
    y = ops.decompress_rows(q, s, dtype=out_dtype)
    yr = ref.dequantize_rows_ref(qr, sr, out_dtype)
    torch.cuda.synchronize()
    ok = (bits_equal(torch, q, qr) and bits_equal(torch, s, sr)
          and bits_equal(torch, y, yr))
    err = max((q.int() - qr.int()).abs().max().item() if q.numel() else 0,
              (s - sr).abs().max().item() if s.numel() else 0.0,
              (y.float() - yr.float()).abs().max().item() if y.numel()
              else 0.0)
    print(f"  {label} {tuple(x.shape)} {x.dtype} -> {out_dtype}: "
          f"{'bit-exact' if ok else 'MISMATCH'} (max abs diff {err:.3e}); "
          f"instances {inst}")
    if not ok:
        bad = (q != qr).nonzero()[:5].tolist()
        fail(f"int8 kernels disagree with their plain versions on {label}: "
             f"first differing q entries {bad}")
    return float(err)


def entropy_library(torch):
    def call(x, w):
        logp = torch.log_softmax(torch.matmul(x, w).float(), dim=-1)
        return -(logp.exp() * logp).sum(-1)
    return call


def flash_bound(make_mask, q, k, causal, window):
    """Bytes: q, k, v read once, o written once; operations: 4 H per
    unmasked (query, key) pair (two products), per sequence and head."""
    b, sq, nq, h = q.shape
    pairs = int(make_mask(sq, k.shape[1], causal=causal,
                          window=window).sum())
    return bound((2 * q.numel() + 2 * k.numel()) * 2, 4 * h * pairs * b * nq)


def flash_inputs(torch, gen, b, s, nq, nkv, h, sets=1):
    return [tuple(torch.randn(b, s, n, h, generator=gen, device="cuda")
                  .bfloat16() for n in (nq, nkv, nkv)) for _ in range(sets)]


def check_flash(torch, ops, ref, args, causal, window, label):
    """The kernel against its plain version; returns the max abs error."""
    got = ops.flash_attention(*args, causal=causal, window=window)
    want = ref.flash_attention_ref(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    scaled = (diff / want.float().abs().clamp(min=1)).max().item()
    print(f"flash_attention {label} q {tuple(args[0].shape)} k "
          f"{tuple(args[1].shape)} causal {causal} window {window}: "
          f"max_abs_err {err:.3e}, of max(1, |plain|) {scaled:.3e} (tol "
          f"{FLASH_TOL})")
    if not torch.isfinite(got.float()).all() or not scaled <= FLASH_TOL:
        fail(f"flash_attention disagrees with its plain version ({label})")
    return err


def sdpa_flash(F):
    """The library yardstick for flash attention: one causal
    scaled_dot_product_attention call on the BHSD views of the same
    tensors, GQA left to the library."""
    def call(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
    return call


def main(argv=None):
    ap = argparse.ArgumentParser(description="chip smoke of the port")
    ap.add_argument("--json", default="",
                    help="also write the results to this file")
    args = ap.parse_args(argv)
    t_script = time.time()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "kernels",
                                       "csrc", "paged_attention.cu")):
        fail(f"the port's sources are not under {SRC}")
    sys.path.insert(0, SRC)
    from repro_torch.kernels import (build, exit_head, ops, paged_attention,
                                     paged_mla, ref)
    from repro_torch.launch import kernel_ab as ab
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models.attention import make_mask
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build -------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; bounds use H100 SXM peaks "
          f"{PEAKS[0] / 1e12:.2f} TB/s, {PEAKS[1] / 1e12:.0f} TFLOP/s bf16")
    t0 = time.time()
    logs = build.build_all()
    print(f"build: {time.time() - t0:.1f}s for {sorted(logs) or 'none'} "
          f"(nvcc, sm_90a)")
    for kname, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{kname}] {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {}
    walls = {}
    t_lap = [t_script]

    def lap(phase):
        now = time.time()
        walls[phase] = now - t_lap[0]
        t_lap[0] = now
        print(f"phase {phase} wall time {walls[phase]:.1f}s")
    lap("1")

    # ---- phase 2: kernels vs plain at main-path shapes ----------------
    # paged GQA: 16 slots, 32/8 heads of 64, pages of 16, pos up to 2047
    sets = ab.paged_inputs(gen, 16, 32, 8, 64, 16, 128, 2048, 4)
    a = sets[0]
    got = ops.paged_gqa_attention(*a)
    want = ref.paged_gqa_attention_ref(*a)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    plan = paged_attention.plan(16, 8, 128, paged_mla.sm_count("cuda"),
                                64)
    print(f"paged_gqa_attention: max_abs_err {err:.3e} (tol {PAGED_TOL}); "
          f"plan {plan}")
    if not math.isfinite(err) or err > PAGED_TOL:
        fail(f"paged_gqa_attention disagrees with its plain version: {err}")
    prep, sdpa = ab.sdpa_gathered()
    lib_args = [prep(*st) for st in sets]
    lib_out = sdpa(*lib_args[0]).transpose(1, 2)
    lib_err = (lib_out.float() - want.float()).abs().max().item()
    bound_ms, by = paged_bound(a)
    spread = interleaved_ms(torch, ops.paged_gqa_attention, sdpa, sets,
                            lib_args=lib_args)
    print_spread("paged_gqa_attention", spread)
    results["paged_gqa_attention"] = {
        "max_abs_err": err, "ms": spread["kernel"]["median"],
        "plain_ms": device_ms(torch, ref.paged_gqa_attention_ref, sets),
        "library_ms": spread["library"]["median"],
        "bound_ms": bound_ms, "bound_by": by, "spread": spread,
        "plan": plan}
    print(f"  sdpa yardstick agrees to {lib_err:.3e}; "
          f"{json.dumps(results['paged_gqa_attention'])}")
    del sets, lib_args

    # paged MLA: deepseek-v3 at full width, 16 slots, 128 heads, R 512,
    # Hr 64, pages of 16, positions up to 2047
    scale = 1.0 / math.sqrt(128 + 64)
    sets = ab.mla_inputs(gen, 16, 128, 512, 64, 16, 128, 2048, 4)
    a = sets[0]
    got = ops.paged_mla_attention(*a, scale=scale)
    want = ref.paged_mla_attention_ref(*a, scale=scale)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    plan = paged_mla.plan(16, 128, 128, paged_mla.sm_count("cuda"))
    print(f"paged_mla_attention: max_abs_err {err:.3e} (tol {MLA_TOL}); "
          f"plan {plan}")
    if not math.isfinite(err) or err > MLA_TOL:
        fail(f"paged_mla_attention disagrees with its plain version: {err}")
    prep, sdpa = ab.sdpa_mla_gathered(scale)
    lib_args = [prep(*st) for st in sets]
    lib_err = (sdpa(*lib_args[0]).float() - want).abs().max().item()
    bound_ms, by = mla_bound(a)

    def mla(*t):
        return ops.paged_mla_attention(*t, scale=scale)

    def mla_plain(*t):
        return ref.paged_mla_attention_ref(*t, scale=scale)
    spread = interleaved_ms(torch, mla, sdpa, sets, lib_args=lib_args)
    print_spread("paged_mla_attention", spread)
    results["paged_mla_attention"] = {
        "max_abs_err": err, "ms": spread["kernel"]["median"],
        "plain_ms": device_ms(torch, mla_plain, sets),
        "library_ms": spread["library"]["median"],
        "bound_ms": bound_ms, "bound_by": by, "spread": spread,
        "plan": plan}
    print(f"  sdpa yardstick agrees to {lib_err:.3e}; "
          f"{json.dumps(results['paged_mla_attention'])}")
    del sets, lib_args

    # exit head: T = 16 slots, D = 2048, V = 49155 (odd pitch)
    x = torch.randn(16, 2048, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(2048, 49155, generator=gen, device="cuda")
         / math.sqrt(2048)).bfloat16()
    got = ops.exit_head_entropy(x, w)
    want = ref.exit_head_entropy_ref(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    lib_exit = build.library("exit_head")
    print(f"exit_head_entropy: max_abs_err {err:.3e} (tol {ENT_TOL}), "
          f"entropy ~{want.mean().item():.3f}, instance "
          f"{exit_head.plan(16, 2048, 49155, w.data_ptr())['instance']}; "
          f"pass-1 blocks per SM: aligned "
          f"{lib_exit.repro_exit_head_blocks_per_sm(1)}, odd pitch "
          f"{lib_exit.repro_exit_head_blocks_per_sm(0)}")
    if not math.isfinite(err) or err > ENT_TOL:
        fail(f"exit_head_entropy disagrees with its plain version: {err}")
    lib = entropy_library(torch)
    bound_ms, by = exit_bound(x, w)
    spread = interleaved_ms(torch, ops.exit_head_entropy, lib, [(x, w)])
    print_spread("exit_head_entropy granite", spread)
    results["exit_head_entropy"] = {
        "max_abs_err": err, "ms": spread["kernel"]["median"],
        "plain_ms": device_ms(torch, ref.exit_head_entropy_ref, [(x, w)]),
        "library_ms": spread["library"]["median"],
        "bound_ms": bound_ms, "bound_by": by, "spread": spread,
        "instance": exit_head.plan(16, 2048, 49155,
                                   w.data_ptr())["instance"]}
    print(f"  {json.dumps(results['exit_head_entropy'])}")
    del x, w
    # ... and at deepseek-v3's widths: D = 7168, V = 129280 (W 1.85 GB)
    x = torch.randn(16, 7168, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(7168, 129280, generator=gen, device="cuda")
         / math.sqrt(7168)).bfloat16()
    got = ops.exit_head_entropy(x, w)
    want = ref.exit_head_entropy_ref(x, w)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    print(f"exit_head_entropy at D 7168, V 129280: max_abs_err {err:.3e} "
          f"(tol {ENT_TOL}), instance "
          f"{exit_head.plan(16, 7168, 129280, w.data_ptr())['instance']}")
    if not math.isfinite(err) or err > ENT_TOL:
        fail(f"exit_head_entropy disagrees with its plain version at "
             f"deepseek-v3 widths: {err}")
    bound_ms, by = exit_bound(x, w)
    spread = interleaved_ms(torch, ops.exit_head_entropy, lib, [(x, w)],
                            iters=10)
    print_spread("exit_head_entropy deepseek-v3", spread)
    exit_ds = {"max_abs_err": err, "ms": spread["kernel"]["median"],
               "plain_ms": device_ms(torch, ref.exit_head_entropy_ref,
                                     [(x, w)], iters=5),
               "library_ms": spread["library"]["median"],
               "bound_ms": bound_ms, "bound_by": by, "spread": spread,
               "instance": exit_head.plan(16, 7168, 129280,
                                          w.data_ptr())["instance"]}
    print(f"  {json.dumps(exit_ds)}")
    del x, w

    # int8 handoff kernels: one full-width granite-3-2b slot leaf at 2048
    # tokens (40 layers x 128 pages x 16 tokens x 8 kv heads rows of 64),
    # a deepseek-v3 c_kv slot leaf (61 layers x 128 pages x 16 tokens rows
    # of 512), one row per hidden state at [4096, 2048] fp32, a zero row,
    # a ragged D in fp32 and bf16, and a view 2 bytes off 16
    print("int8 handoff kernels against their plain versions "
          "(tolerance: bit-exact)")
    leaves = [torch.randn(40 * 128 * 16 * 8, 64, generator=gen,
                          device="cuda").bfloat16() for _ in range(2)]
    ckvs = [torch.randn(61 * 128 * 16, 512, generator=gen,
                        device="cuda").bfloat16() for _ in range(2)]
    hid = torch.randn(4096, 2048, generator=gen, device="cuda") \
        * torch.rand(4096, 1, generator=gen, device="cuda") * 8
    zero = torch.zeros(3, 64, device="cuda").bfloat16()
    zero[1] = torch.randn(64, generator=gen, device="cuda").bfloat16()
    ragged = torch.randn(777, 100, generator=gen, device="cuda")
    buf = torch.randn(777 * 64 + 1, generator=gen, device="cuda").bfloat16()
    offset = buf[1:].view(777, 64)
    q_err = max(check_quant_pair(torch, ops, ref, leaves[0], torch.bfloat16,
                                 "slot leaf"),
                check_quant_pair(torch, ops, ref, ckvs[0], torch.bfloat16,
                                 "deepseek-v3 c_kv leaf"),
                check_quant_pair(torch, ops, ref, hid, torch.float32,
                                 "hidden rows"),
                check_quant_pair(torch, ops, ref, zero, torch.bfloat16,
                                 "zero rows"),
                check_quant_pair(torch, ops, ref, ragged, torch.bfloat16,
                                 "D = 100"),
                check_quant_pair(torch, ops, ref, ragged.bfloat16(),
                                 torch.float32, "D = 100 bf16"),
                check_quant_pair(torch, ops, ref, offset, torch.bfloat16,
                                 "view 2 bytes off 16"))
    qz, sz = ops.compress_rows(zero)
    if not (bool((qz[0] == 0).all()) and bool((qz[2] == 0).all())
            and sz[0].item() == sz[2].item() == torch.tensor(1e-8).item()):
        fail("a zero row must quantize to q = 0 with scale exactly 1e-8")

    def dequant(q, s):
        return ops.decompress_rows(q, s, dtype=torch.bfloat16)

    def dequant_plain(q, s):
        return ref.dequantize_rows_ref(q, s, torch.bfloat16)
    for kname in ("quantize_rows", "dequantize_rows"):
        results[kname] = {"max_abs_err": q_err, "library_ms": None}
    # each timed three times on two copies of a leaf (the granite leaf is
    # 84 MB, so every call reads from HBM past the 50 MB L2)
    for label, xs in (("granite", leaves), ("deepseek_c_kv", ckvs)):
        qs = [ops.compress_rows(x) for x in xs]
        inst = int8_instances(xs[0], 2)
        timed = {}
        for kname, fn, plain, call_args, bnd in (
                ("quantize_rows", ops.compress_rows, ref.quantize_rows_ref,
                 [(x,) for x in xs], quant_bound(xs[0])),
                ("dequantize_rows", dequant, dequant_plain, qs,
                 dequant_bound(qs[0][0], 2))):
            spread = interleaved_ms(torch, fn, None, call_args)
            print_spread(f"{kname} {label} {tuple(xs[0].shape)}", spread)
            timed[kname] = {
                "shape": list(xs[0].shape), "ms": spread["kernel"]["median"],
                "plain_ms": device_ms(torch, plain, call_args[:1], iters=5),
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "spread": spread["kernel"],
                "instance": inst[kname.split("_")[0]]}
        for kname, r in timed.items():
            if label == "granite":
                results[kname].update(r)
            else:
                results[kname][label] = r
            print(f"  {kname} {label} {json.dumps(r)}")
        del qs
    int8_xlstm_rows(torch, ops, ref, gen, results)
    print("  library_ms: none (no single PyTorch call computes either "
          "function)")
    del leaves, ckvs, hid, buf, offset

    # flash attention: phase 7's shape (granite-3-2b's 32/8 heads of 64,
    # 8 x 2048 tokens, causal), a ragged sliding-window case and a
    # non-causal G 1 case at head dim 128
    sets = flash_inputs(torch, gen, 8, 2048, 32, 8, 64, sets=2)
    f_err = check_flash(torch, ops, ref, sets[0], True, 0, "main path")
    f_err = max(f_err, check_flash(
        torch, ops, ref, flash_inputs(torch, gen, 2, 1000, 32, 8, 64)[0],
        True, 256, "ragged, window"))
    f_err = max(f_err, check_flash(
        torch, ops, ref, flash_inputs(torch, gen, 2, 512, 16, 16, 128)[0],
        False, 0, "non-causal, G 1, H 128"))
    lib = sdpa_flash(F)
    lib_err = (lib(*sets[0]).float() - ref.flash_attention_ref(
        *sets[0]).float()).abs().max().item()
    bound_ms, by = flash_bound(make_mask, sets[0][0], sets[0][1], True, 0)

    def flash(q, k, v):
        return ops.flash_attention(q, k, v, causal=True)

    def flash_plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True)
    spread = interleaved_ms(torch, flash, lib, sets)
    print_spread("flash_attention", spread)
    results["flash_attention"] = {
        "max_abs_err": f_err, "ms": spread["kernel"]["median"],
        "plain_ms": device_ms(torch, flash_plain, sets, iters=4),
        "library_ms": spread["library"]["median"],
        "bound_ms": bound_ms, "bound_by": by, "spread": spread}
    print(f"  sdpa yardstick agrees to {lib_err:.3e}; "
          f"{json.dumps(results['flash_attention'])}")
    del sets
    # ... and each kernel at the shapes of the dense configs phase 8 serves
    slice_shapes(torch, F, ops, ref, ab, gen, results, make_mask)

    lap("2")

    # ---- phase 3: small-input references, card vs CPU -----------------
    check_smoke_vs_cpu(torch, "granite-3-2b-smoke")
    check_smoke_vs_cpu(torch, "deepseek-v3-671b-smoke")
    for arch in ("yi-6b-smoke", "starcoder2-3b-smoke",
                 "mistral-nemo-12b-smoke", "zamba2-1.2b-smoke",
                 "xlstm-350m-smoke", "qwen2-vl-2b-smoke",
                 "whisper-base-smoke", "llama4-maverick-400b-a17b-smoke"):
        check_smoke_vs_cpu(torch, arch)
    check_smoke_vs_cpu(torch, "llama4-maverick-400b-a17b-smoke", w8a8=True)
    check_forward_vs_cpu(torch, "granite-3-2b-smoke", long_mode=False)
    check_forward_vs_cpu(torch, "granite-3-2b-smoke", long_mode=True)
    check_forward_vs_cpu(torch, "deepseek-v3-671b-smoke", long_mode=False)
    check_forward_vs_cpu(torch, "xlstm-350m-smoke", long_mode=False)
    check_forward_vs_cpu(torch, "qwen2-vl-2b-smoke", long_mode=False)
    check_forward_vs_cpu(torch, "whisper-base-smoke", long_mode=False)
    check_forward_vs_cpu(torch, "llama4-maverick-400b-a17b-smoke",
                         long_mode=False, w8a8=True)

    lap("3")

    # ---- phase 4: the main path at full width -------------------------
    captured = {}
    orig = {"paged_gqa_attention": ops.paged_gqa_attention,
            "exit_head_entropy": ops.exit_head_entropy}

    def capturing(kname, every):
        calls = [0]

        def wrapper(*a, **kw):
            calls[0] += 1
            if calls[0] % every == 0 and kw.get("scale") is None:
                # pools change in place later: copy them; weights do not
                captured[kname] = tuple(
                    t.clone() if t.numel() * t.element_size() < 2 ** 26
                    else t for t in a)
            return orig[kname](*a, **kw)
        return wrapper

    ops.paged_gqa_attention = capturing("paged_gqa_attention", 997)
    ops.exit_head_entropy = capturing("exit_head_entropy", 53)
    print("main path: granite-3-2b, 40 layers, random weights (seed 0), "
          "paged + segmented, 16 slots, 32 requests, prompts 32-128 tokens")
    print("  random weights give near-flat logits (normalized entropy ~1), "
          "so exits at threshold 0.5 will rarely fire; both probes still "
          "run on every decode step")
    ops.reset_launches()
    t0 = time.time()
    stats = serve_poisson(
        "granite-3-2b", rate=16.0, n_requests=32, slots=16,
        prompt_len=128, max_new=32, threshold=0.5, paged=True,
        page_size=16, segmented=True, prefix_share=0.25, prefix_len=64,
        seed=0, device="cuda", quiet=True)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    wall = time.time() - t0
    ops.paged_gqa_attention = orig["paged_gqa_attention"]
    ops.exit_head_entropy = orig["exit_head_entropy"]
    print(f"  launches during the main path: {launches} ({wall:.1f}s "
          f"including model init and warm-up)")
    for kname in ("paged_gqa_attention", "exit_head_entropy"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    outs = stats.pop("outputs")
    if len(outs) != 32 or any(len(o) != 32 for o in outs):
        fail("not every request produced max_new tokens")
    if any(not (0 <= t < 49155) for o in outs for t in o):
        fail("token out of vocabulary range")
    print(f"  tokens {stats['tokens']}, sustained "
          f"{stats['sustained_tok_s']:.2f} tok/s, p50 "
          f"{stats['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{stats['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{stats['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{stats['prefix_hit_tokens']}, chunks skipped "
          f"{stats['prefill_chunks_skipped']}")
    print(f"  exit stats {stats['exit_stats']}; stage calls "
          f"{stats['stage_calls']}")
    if stats["prefix_hit_tokens"] <= 0:
        fail("the shared prefix never hit the prefix cache")

    main_launches = launches
    # each kernel again on inputs captured from the live run
    for kname, tol, plain in (
            ("paged_gqa_attention", PAGED_TOL, ref.paged_gqa_attention_ref),
            ("exit_head_entropy", ENT_TOL, ref.exit_head_entropy_ref)):
        if kname not in captured:
            fail(f"no live call of {kname} was captured")
        a = captured[kname]
        got = orig[kname](*a).float()
        want = plain(*a).float()
        err = (got - want).abs().max().item()
        shapes = [tuple(t.shape) for t in a]
        print(f"  live {kname} {shapes}: max_abs_err {err:.3e} (tol {tol})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"{kname} disagrees with its plain version on live inputs")
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)
    # the paged kernel's time on the live call: the lengths serving reaches
    a = captured["paged_gqa_attention"]
    prep, sdpa = ab.sdpa_gathered()
    live = live_timing(torch, orig["paged_gqa_attention"], sdpa, [a],
                       [prep(*a)], paged_bound(a))
    live["plan"] = paged_attention.plan(a[0].shape[0], a[1].shape[2],
                                        a[3].shape[1],
                                        paged_mla.sm_count("cuda"),
                                        a[0].shape[3])
    results["paged_gqa_attention"]["live"] = live
    print(f"  live paged_gqa_attention timing: {json.dumps(live)}")

    lap("4")

    # ---- phase 4b: async decode windows at full width ----------------
    del captured, a
    gc.collect()
    torch.cuda.empty_cache()
    windows = run_async(torch, ops)
    lap("4b")

    # ---- phase 5: the tiered path at full width ----------------------
    gc.collect()
    torch.cuda.empty_cache()
    tiered, tier_launches = run_tiered(torch, ops, ref, results)
    lap("5")

    # ---- phase 6: deepseek-v3 at full width, 4 layers ---------------
    gc.collect()
    torch.cuda.empty_cache()
    ds, ds_launches = run_deepseek(torch, ops, ref, results, exit_ds)
    lap("6")

    # ---- phase 7: the full-sequence forward at full width ------------
    gc.collect()
    torch.cuda.empty_cache()
    fwd, fwd_launches = run_forward(torch, ops)
    lap("7")

    # ---- phase 8: multi-model pools and speculative pairs -------------
    gc.collect()
    torch.cuda.empty_cache()
    multi, multi_launches = run_multi(torch, ops)

    # ---- phase 9: the hybrid zamba2 family and the engine -------------
    gc.collect()
    torch.cuda.empty_cache()
    z2, z2_launches = run_zamba2(torch, ops, ref, results)

    # ---- phase 10: the xLSTM family -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    xl, xl_launches = run_xlstm(torch, ops, ref, results)

    # ---- phase 11: M-RoPE and vision-patch inputs (qwen2-vl-2b) -------
    gc.collect()
    torch.cuda.empty_cache()
    qv, qv_launches = run_qwen2_vl(torch, ops, ref, results)

    # ---- phase 12: the encoder-decoder family (whisper-base) ----------
    gc.collect()
    torch.cuda.empty_cache()
    wh, wh_launches = run_whisper(torch, ops, ref, results)

    # ---- phase 13: llama4 pair units and W8A8 experts -----------------
    gc.collect()
    torch.cuda.empty_cache()
    l4, l4_launches = run_llama4(torch, ops, ref, results)

    # ---- phase 14: training with the flash backward kernel ------------
    gc.collect()
    torch.cuda.empty_cache()
    tr, tr_launches = run_training(torch, ops, ref, results)

    # ---- phase 15: the analyzer's guards and cost check ---------------
    gc.collect()
    torch.cuda.empty_cache()
    guards, guard_launches = run_guards(torch, ops)

    # ---- phase 16: staged pods and the expert-parallel MoE ------------
    gc.collect()
    torch.cuda.empty_cache()
    collab, collab_launches = run_collab(torch, card_line)

    # ---- phase 17: the dry run, operation counts and profiles ----------
    gc.collect()
    torch.cuda.empty_cache()
    tooling, tooling_launches = run_tooling(torch, card_line)

    replaces = {
        "paged_gqa_attention": ("src/repro_torch/kernels/csrc/"
                                "paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:82"),
        "paged_mla_attention": ("src/repro_torch/kernels/csrc/paged_mla.cu",
                                "src/repro/kernels/paged_attention.py:162"),
        "exit_head_entropy": ("src/repro_torch/kernels/csrc/exit_head.cu",
                              "src/repro/kernels/exit_head.py:55"),
        "quantize_rows": ("src/repro_torch/kernels/csrc/feature_compress.cu",
                          "src/repro/kernels/feature_compress.py:34"),
        "dequantize_rows": ("src/repro_torch/kernels/csrc/"
                            "feature_compress.cu",
                            "src/repro/kernels/feature_compress.py:60"),
        "flash_attention": ("src/repro_torch/kernels/csrc/"
                            "flash_attention.cu",
                            "src/repro/kernels/attention.py:71"),
        # no Pallas kernel: the reference's int8 dot_general (XLA)
        "w8a8_expert_matmul": ("src/repro_torch/kernels/csrc/w8a8_expert.cu",
                               "src/repro/models/ffn.py:164"),
        # no Pallas kernel: the reference differentiates its jnp _sdpa
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/"
                                "flash_attention_bwd.cu",
                                "src/repro/models/attention.py:79"),
    }
    # launches: each kernel's count on the path that carries it (phase 4
    # for GQA attention and the exit probe, phase 5's int8 run for the
    # handoff, phase 6 for paged MLA, phase 7's timed forward for flash
    # attention, phase 13's serving run for the W8A8 expert GEMM); the
    # exit head's deepseek-v3 numbers (phase 2 at its widths, phase 6's
    # launches) ride along under "deepseek"
    path_launches = dict(main_launches)
    path_launches["quantize_rows"] = tier_launches["quantize_rows"]
    path_launches["dequantize_rows"] = tier_launches["dequantize_rows"]
    path_launches["paged_mla_attention"] = ds_launches["paged_mla_attention"]
    path_launches["flash_attention"] = fwd_launches["flash_attention"]
    path_launches["w8a8_expert_matmul"] = \
        l4_launches["serve"]["w8a8_expert_matmul"]
    path_launches["flash_attention_bwd"] = \
        tr_launches["train"]["flash_attention_bwd"]
    exit_ds["launches"] = ds_launches["exit_head_entropy"]
    kernels = []
    for kname, r in results.items():
        source, repl = replaces[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": repl, "launches": path_launches[kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
        if kname == "exit_head_entropy":
            kernels[-1]["instance"] = r["instance"]
            kernels[-1]["deepseek"] = exit_ds
        if kname in ("quantize_rows", "dequantize_rows"):
            for key in ("instance", "spread", "deepseek_c_kv", "live",
                        "xlstm_c"):
                kernels[-1][key] = r[key]
        if "shapes" in r:
            kernels[-1]["shapes"] = r["shapes"]
        kernels[-1]["phase8_launches"] = {
            part: n[kname] for part, n in multi_launches.items()}
        kernels[-1]["phase9_launches"] = {
            part: n[kname] for part, n in z2_launches.items()}
        kernels[-1]["phase10_launches"] = {
            part: n[kname] for part, n in xl_launches.items()}
        kernels[-1]["phase11_launches"] = {
            part: n[kname] for part, n in qv_launches.items()}
        kernels[-1]["phase12_launches"] = {
            part: n[kname] for part, n in wh_launches.items()}
        kernels[-1]["phase13_launches"] = {
            part: n[kname] for part, n in l4_launches.items()}
        kernels[-1]["phase14_launches"] = {
            part: n[kname] for part, n in tr_launches.items()}
        kernels[-1]["phase15_launches"] = {
            part: n[kname] for part, n in guard_launches.items()}
        kernels[-1]["phase16_launches"] = {
            part: n[kname] for part, n in collab_launches.items()}
        kernels[-1]["phase17_launches"] = {
            part: n[kname] for part, n in tooling_launches.items()}
        if kname in ("w8a8_expert_matmul", "flash_attention_bwd"):
            kernels[-1]["pallas_counterpart"] = None
        if kname == "flash_attention_bwd":
            kernels[-1]["other_shapes"] = r["other_shapes"]
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card_line, "kernels": kernels,
                       "script_s": time.time() - t_script,
                       "phase_wall_s": walls,
                       "serve": stats, "async_decode": windows,
                       "tiered": tiered, "deepseek": ds, "forward": fwd,
                       "multi": multi, "zamba2": z2, "xlstm": xl,
                       "qwen2_vl": qv, "whisper": wh, "llama4": l4,
                       "training": tr, "guards": guards,
                       "collab": collab, "tooling": tooling},
                      f, indent=1)
    print(f"chip_smoke: every phase passed in {time.time() - t_script:.1f}s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def int8_xlstm_rows(torch, ops, ref, gen, results):
    """Rows 4a / 5a: both int8 kernels on the mLSTM matrix memory of
    xlstm-350m's largest block (5 layers x 4 heads x 512 rows of 512,
    fp32), back to fp32: bit-exact against their plain versions, then
    timed three times each on two copies."""
    mems = [torch.randn(5 * 4 * 512, 512, generator=gen, device="cuda")
            * 0.05 for _ in range(2)]
    err = check_quant_pair(torch, ops, ref, mems[0], torch.float32,
                           "xlstm mLSTM C")
    qs = [ops.compress_rows(x) for x in mems]
    inst = int8_instances(mems[0], 4)

    def dequant32(q, s):
        return ops.decompress_rows(q, s, dtype=torch.float32)

    def dequant32_plain(q, s):
        return ref.dequantize_rows_ref(q, s, torch.float32)
    for kname, fn, plain, call_args, bnd in (
            ("quantize_rows", ops.compress_rows, ref.quantize_rows_ref,
             [(x,) for x in mems], quant_bound(mems[0])),
            ("dequantize_rows", dequant32, dequant32_plain, qs,
             dequant_bound(qs[0][0], 4))):
        spread = interleaved_ms(torch, fn, None, call_args)
        print_spread(f"{kname} xlstm_c {tuple(mems[0].shape)}", spread)
        r = {"shape": list(mems[0].shape), "dtype": "float32",
             "max_abs_err": err, "ms": spread["kernel"]["median"],
             "plain_ms": device_ms(torch, plain, call_args[:1], iters=5),
             "bound_ms": bnd[0], "bound_by": bnd[1],
             "spread": spread["kernel"],
             "instance": inst[kname.split("_")[0]]}
        results[kname]["xlstm_c"] = r
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)
        print(f"  {kname} xlstm_c {json.dumps(r)}")


def slice_shapes(torch, F, ops, ref, ab, gen, results, make_mask):
    """Phase 2 at the shapes the other configs give the kernels (yi-6b,
    mistral-nemo-12b, starcoder2-3b and zamba2-1.2b at their published
    widths): each kernel against its plain version, then timed three times
    interleaved with its library call.  Adds a sub-row per shape under
    ``results[kernel]["shapes"]``."""
    from repro_torch.kernels import exit_head, paged_attention, paged_mla
    prep, sdpa = ab.sdpa_gathered()
    # paged GQA, pages of 16, pos < 2048: 8 slots of 32 heads of 128 over
    # 4 and 8 kv heads, zamba2's shared attention (row 1c): 16 slots of 32
    # heads of 64 over 32 kv heads (G 1), qwen2-vl-2b's (row 1d): 16
    # slots of 12 heads of 128 over 2 (G 6), and llama4-maverick's (row
    # 1e): 16 slots of 40 heads of 128 over 8 (G 5), and Zamba2-7B's
    # sites (row 1f): 32 slots of 32 heads of 224 over 32 (G 1)
    for label, b, nq, nkv, hd in (("yi-6b", 8, 32, 4, 128),
                                  ("mistral-nemo-12b", 8, 32, 8, 128),
                                  ("zamba2-1.2b", 16, 32, 32, 64),
                                  ("qwen2-vl-2b", 16, 12, 2, 128),
                                  ("llama4-maverick", 16, 40, 8, 128),
                                  ("zamba2-7b-instruct", 32, 32, 32, 224)):
        sets = ab.paged_inputs(gen, b, nq, nkv, hd, 16, 128, 2048, 4)
        a = sets[0]
        got = ops.paged_gqa_attention(*a)
        want = ref.paged_gqa_attention_ref(*a)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        plan = paged_attention.plan(b, nkv, 128, paged_mla.sm_count("cuda"),
                                    hd)
        print(f"paged_gqa_attention {label} q {tuple(a[0].shape)} Nkv {nkv}:"
              f" max_abs_err {err:.3e} (tol {PAGED_TOL}); plan {plan}")
        if not math.isfinite(err) or err > PAGED_TOL:
            fail(f"paged_gqa_attention disagrees with its plain version at "
                 f"{label}'s shape: {err}")
        lib_args = [prep(*st) for st in sets]
        spread = interleaved_ms(torch, ops.paged_gqa_attention, sdpa, sets,
                                lib_args=lib_args)
        print_spread(f"paged_gqa_attention {label}", spread)
        bound_ms, by = paged_bound(a)
        row = {"q": list(a[0].shape), "pool": list(a[1].shape),
               "max_abs_err": err, "ms": spread["kernel"]["median"],
               "plain_ms": device_ms(torch, ref.paged_gqa_attention_ref,
                                     sets),
               "library_ms": spread["library"]["median"],
               "bound_ms": bound_ms, "bound_by": by, "plan": plan}
        results["paged_gqa_attention"].setdefault("shapes", {})[label] = row
        results["paged_gqa_attention"]["max_abs_err"] = max(
            results["paged_gqa_attention"]["max_abs_err"], err)
        print(f"  {json.dumps(row)}")
        del sets, lib_args
    # the exit head's aligned instance at the vocab widths of yi-6b and
    # mistral-nemo-12b (8 rows), and of zamba2-1.2b's, xlstm-350m's and
    # qwen2-vl-2b's and llama4-maverick's probes (16 rows, rows 2c, 2d,
    # 2e and 2g); its odd-pitch instance at whisper-base's (row 2f)
    lib = entropy_library(torch)
    for label, t, d, v in (("yi-6b", 8, 4096, 64000),
                           ("mistral-nemo-12b", 8, 5120, 131072),
                           ("zamba2-1.2b", 16, 2048, 32000),
                           ("xlstm-350m", 16, 1024, 50304),
                           ("qwen2-vl-2b", 16, 1536, 151936),
                           ("whisper-base", 16, 512, 51865),
                           ("llama4-maverick", 16, 5120, 202048)):
        x = torch.randn(t, d, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(d, v, generator=gen, device="cuda")
             / math.sqrt(d)).bfloat16()
        got = ops.exit_head_entropy(x, w)
        want = ref.exit_head_entropy_ref(x, w)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        inst = exit_head.plan(t, d, v, w.data_ptr())["instance"]
        print(f"exit_head_entropy {label} [{t}, {d}] x [{d}, {v}]: max_abs_err "
              f"{err:.3e} (tol {ENT_TOL}), instance {inst}")
        if not math.isfinite(err) or err > ENT_TOL:
            fail(f"exit_head_entropy disagrees with its plain version at "
                 f"{label}'s widths: {err}")
        spread = interleaved_ms(torch, ops.exit_head_entropy, lib, [(x, w)],
                                iters=10)
        print_spread(f"exit_head_entropy {label}", spread)
        bound_ms, by = exit_bound(x, w)
        row = {"x": list(x.shape), "w": list(w.shape), "max_abs_err": err,
               "ms": spread["kernel"]["median"],
               "plain_ms": device_ms(torch, ref.exit_head_entropy_ref,
                                     [(x, w)], iters=5),
               "library_ms": spread["library"]["median"],
               "bound_ms": bound_ms, "bound_by": by, "instance": inst}
        results["exit_head_entropy"].setdefault("shapes", {})[label] = row
        results["exit_head_entropy"]["max_abs_err"] = max(
            results["exit_head_entropy"]["max_abs_err"], err)
        print(f"  {json.dumps(row)}")
        del x, w
    # flash at starcoder2-3b's shape: 24 query heads over 2 kv heads of
    # 128 (G 12), 8192 tokens, causal, window 4096; the library call is
    # SDPA with the same boolean mask
    sets = flash_inputs(torch, gen, 1, 8192, 24, 2, 128, sets=2)
    window = 4096
    err = check_flash(torch, ops, ref, sets[0], True, window,
                      "starcoder2-3b")
    mask = make_mask(8192, 8192, causal=True, window=window).cuda()

    def flash(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=window)

    def flash_plain(q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=True, window=window)

    def lib_flash(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)
    lib_err = (lib_flash(*sets[0]).float()
               - flash_plain(*sets[0]).float()).abs().max().item()
    spread = interleaved_ms(torch, flash, lib_flash, sets, iters=10)
    print_spread("flash_attention starcoder2-3b", spread)
    bound_ms, by = flash_bound(make_mask, sets[0][0], sets[0][1], True,
                               window)
    row = {"q": list(sets[0][0].shape), "kv": list(sets[0][1].shape),
           "window": window, "max_abs_err": err,
           "ms": spread["kernel"]["median"],
           "plain_ms": device_ms(torch, flash_plain, sets, iters=2),
           "library_ms": spread["library"]["median"],
           "bound_ms": bound_ms, "bound_by": by}
    results["flash_attention"].setdefault("shapes", {})["starcoder2-3b"] = row
    results["flash_attention"]["max_abs_err"] = max(
        results["flash_attention"]["max_abs_err"], err)
    print(f"  sdpa (boolean mask) agrees to {lib_err:.3e}; "
          f"{json.dumps(row)}")
    del sets, mask
    flash_shapes(torch, F, ops, ref, gen, results, make_mask)


def flash_shapes(torch, F, ops, ref, gen, results, make_mask):
    """Rows 6b-6f: flash at zamba2-1.2b's shared attention (2 x 2048
    tokens, 32 query heads of 64 over 32, G 1, causal), at phase 11's
    forward (qwen2-vl-2b, 2 x 2048 tokens, 12 query heads of 128 over 2,
    causal), without a mask at phase 12's (whisper-base, 8 heads of
    64): the encoder's self-attention over 1,500 frames (1,500 = 11 x 128
    + 92: a ragged last key tile) and the decoder's cross-attention, 448
    queries against the 1,500 encoder rows, and at phase 13's forward
    (llama4-maverick, 2 x 2048 tokens, 40 query heads of 128 over 8, G 5,
    causal).  The library call is SDPA (``enable_gqa``; causal, or no
    mask)."""
    b, s_dec = WH_FWD
    t_enc = 1500
    for label, qs, kvs, nq, nkv, hd, causal in (
            ("zamba2-1.2b", (2, 2048), (2, 2048), 32, 32, 64, True),
            ("qwen2-vl-2b", (2, 2048), (2, 2048), 12, 2, 128, True),
            ("whisper-base encoder", (b, t_enc), (b, t_enc), 8, 8, 64, False),
            ("whisper-base cross", (b, s_dec), (b, t_enc), 8, 8, 64, False),
            ("llama4-maverick", (2, 2048), (2, 2048), 40, 8, 128, True)):
        sets = [tuple(torch.randn(*sh, n, hd, generator=gen, device="cuda")
                      .bfloat16() for sh, n in ((qs, nq), (kvs, nkv),
                                                (kvs, nkv)))
                for _ in range(2)]
        err = check_flash(torch, ops, ref, sets[0], causal, 0, label)

        def flash(q, k, v, causal=causal):
            return ops.flash_attention(q, k, v, causal=causal)

        def flash_plain(q, k, v, causal=causal):
            return ref.flash_attention_ref(q, k, v, causal=causal)

        def lib(q, k, v, causal=causal):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True).transpose(1, 2)
        lib_err = (lib(*sets[0]).float()
                   - flash_plain(*sets[0]).float()).abs().max().item()
        spread = interleaved_ms(torch, flash, lib, sets, iters=10)
        print_spread(f"flash_attention {label}", spread)
        bound_ms, by = flash_bound(make_mask, sets[0][0], sets[0][1], causal,
                                   0)
        row = {"q": list(sets[0][0].shape), "kv": list(sets[0][1].shape),
               "causal": causal, "window": 0, "max_abs_err": err,
               "ms": spread["kernel"]["median"],
               "plain_ms": device_ms(torch, flash_plain, sets, iters=2),
               "library_ms": spread["library"]["median"],
               "bound_ms": bound_ms, "bound_by": by}
        results["flash_attention"]["shapes"][label] = row
        results["flash_attention"]["max_abs_err"] = max(
            results["flash_attention"]["max_abs_err"], err)
        print(f"  sdpa agrees to {lib_err:.3e}; {json.dumps(row)}")
        del sets


ASYNC_R = 8            # decode steps a window (phase 4b)
ASYNC_SLOTS = 16
ASYNC_MAX_NEW = 64     # closed loop; the Poisson run takes 64 too
ASYNC_LAYERS = 16      # phase 4b's depth cut (exits after 5 and 10)


def tie_gap(torch, model, params, prompt, got, want, frames=None):
    """First position where two greedy streams of one prompt differ, and
    the fp32 gap there between the two tokens' logits of a batch-1 decode
    replay (``Model.prefill``) of ``want``'s stream; an encdec request's
    replay decodes over cross rows primed from its ``frames``."""
    k = next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)
    seq = list(prompt) + list(want[:k])
    toks = torch.tensor([seq], dtype=torch.long, device="cuda")
    if frames is None:
        logits, _ = model.prefill(params, {"tokens": toks})
        row = logits[0, -1].float()
    else:
        from repro_torch.serving import prime_whisper_cross_cache
        cache = model.init_decode_cache(1, len(seq))
        prime_whisper_cross_cache(model, params, cache, torch.as_tensor(
            frames, device="cuda")[None].bfloat16())
        for t in range(len(seq)):
            row, _, _ = model.decode_step(params, cache, toks[:, t:t + 1], t)
        row = row[0].float()
    return k, float(row[want[k]] - row[got[k]])


def closed_loop(torch, ops, sched, prompts, max_new, *, rng=None,
                guard=False):
    """Admit every prompt in one prefill poll, then poll the decode to the
    end (``guard``: under ``set_sync_debug_mode("error")``).  Returns the
    requests, the decode steps the card ran (sync: committed steps; async:
    the window's warm-up steps and replays), the launch counts of the
    decode polls and their wall time."""
    from repro_torch.serving.scheduler import Request
    reqs = [Request(tokens=p, max_new=max_new, req_id=j)
            for j, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.set_rng(rng)
    sched.prefill_poll()
    if sched._pending is not None or sched.queue:
        fail("closed loop: the prompts were not all admitted at once")

    def device_steps():
        if sched.cfg.async_decode:
            return 0 if sched._window is None else sched._window.steps_run
        return sched._step_idx

    torch.cuda.synchronize()
    ops.reset_launches()
    steps0 = device_steps()
    t0 = time.perf_counter()
    if guard:
        torch.cuda.set_sync_debug_mode("error")
    try:
        while sched.has_work:
            sched.poll()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return reqs, device_steps() - steps0, dict(ops.LAUNCHES), wall


def run_async(torch, ops):
    """Phase 4b (see the module docstring).  Returns its summary."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               SchedulerConfig)
    cfg = depth_cut(get_config("granite-3-2b"), ASYNC_LAYERS, (5, 10))
    model = Model(cfg, device="cuda")
    params = model.init(0)
    layers = cfg.num_layers
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65)))
               for _ in range(ASYNC_SLOTS)]
    max_len = 64 + ASYNC_MAX_NEW

    def pool(async_decode, **kw):
        return ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=ASYNC_SLOTS, max_len=max_len, prefill_chunk=16,
            exit_threshold=0.5, segmented=False, paged=True,
            async_decode=async_decode, readback_interval=ASYNC_R, **kw),
            device="cuda")

    print(f"async decode: granite-3-2b at full width, cut to {layers} "
          f"layers, random weights (seed "
          f"0), paged, {ASYNC_SLOTS} slots, monolithic steps, windows of "
          f"{ASYNC_R}; closed loop of {len(prompts)} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"max_new {ASYNC_MAX_NEW}")
    out = {"readback_interval": ASYNC_R}

    def check_launches(label, steps, launches):
        want = layers * steps
        got = launches["paged_gqa_attention"]
        print(f"  {label}: {steps} decode steps on the card, paged_gqa "
              f"launches {got} ({layers} x steps = {want})")
        if got != want:
            fail(f"{label}: {got} paged-attention launches, expected {want}")

    # (a) sync monolithic, then windows: the same tokens
    s_sync = pool(False)
    r_sync, steps, launches, wall = closed_loop(
        torch, ops, s_sync, prompts, ASYNC_MAX_NEW)
    check_launches("(a) sync", steps, launches)
    want = [list(r.out_tokens) for r in r_sync]
    out["sync"] = {"decode_steps": steps, "wall_s": wall,
                   "ms_per_step": wall / steps * 1e3}
    del s_sync
    s_win = pool(True)
    r_win, steps, launches, wall = closed_loop(
        torch, ops, s_win, prompts, ASYNC_MAX_NEW)
    check_launches("(a) async", steps, launches)
    w = s_win._window
    out["async"] = {"device_steps": steps, "wall_s": wall,
                    "ms_per_step": wall / s_win._step_idx * 1e3,
                    "committed_steps": s_win._step_idx,
                    "replays": w.replays, "warmup_steps": w.warmup_steps,
                    "per_replay_launches": w.per_replay,
                    "peak_tokens_in_flight": s_win.peak_tokens_in_flight}
    print(f"  (a) decode wall {out['sync']['wall_s']:.2f} s sync "
          f"({out['sync']['ms_per_step']:.2f} ms a step) against "
          f"{wall:.2f} s async ({out['async']['ms_per_step']:.2f} ms a "
          f"committed step; {w.replays} replays, {w.warmup_steps} warm-up "
          f"steps, launches a replay {w.per_replay})")
    if s_win.jit_cache_sizes() != {"decode_window": 1}:
        fail(f"decode window built {s_win.jit_cache_sizes()}, not once")
    ties = []
    for p, r, ws in zip(prompts, r_win, want):
        got = list(r.out_tokens)
        if len(got) != ASYNC_MAX_NEW:
            fail(f"async request {r.req_id}: {len(got)} tokens")
        if got != ws:
            k, gap = tie_gap(torch, model, params, p, got, ws)
            print(f"  request {r.req_id} differs at token {k}: fp32 top-2 "
                  f"gap {gap:.3e}")
            ties.append({"req": r.req_id, "token": k, "gap": gap})
            if not 0.0 <= gap < LOGIT_TIE:
                fail("async tokens differ from the sync poll's (no tie)")
    out["ties"] = ties
    print(f"  (a) tokens: {len(prompts) - len(ties)} of {len(prompts)} "
          f"requests bit-identical to the sync poll, {len(ties)} ties")

    # (b) the same loop with every decode poll under the sync guard
    r_b, steps, launches, wall = closed_loop(
        torch, ops, s_win, prompts, ASYNC_MAX_NEW, guard=True)
    if [list(r.out_tokens) for r in r_b] != [list(r.out_tokens)
                                              for r in r_win]:
        fail("(b) tokens differ from (a)'s async run")
    if s_win.jit_cache_sizes() != {"decode_window": 1}:
        fail("(b) the window was captured again")
    check_launches("(b) async under set_sync_debug_mode('error')", steps,
                   launches)
    out["guarded"] = {"wall_s": wall, "device_steps": steps}
    del s_win

    # (c) sampled decode: one generator seed, twice
    s_t = pool(True, temperature=0.7)
    short = [p[:16] for p in prompts]
    runs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(7)
        r_c, _, _, _ = closed_loop(torch, ops, s_t, short, ASYNC_MAX_NEW,
                                   rng=gen)
        runs.append([list(r.out_tokens) for r in r_c])
    if runs[0] != runs[1]:
        fail("(c) the same generator seed gave different samples")
    if any(len(o) != ASYNC_MAX_NEW or not all(0 <= t < cfg.vocab_size
                                              for t in o) for o in runs[0]):
        fail("(c) a sampled stream is short or out of the vocabulary")
    distinct = len({t for o in runs[0] for t in o})
    print(f"  (c) T 0.7: two runs from seed 7 identical, "
          f"{sum(map(len, runs[0]))} tokens in range, {distinct} distinct")
    out["sampled"] = {"tokens": sum(map(len, runs[0])), "distinct": distinct}
    del s_t
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the Poisson run, sync segmented and then async
    out["poisson"] = {}
    for label, kw in (("sync segmented", dict(segmented=True)),
                      ("async", dict(async_decode=True,
                                     readback_interval=ASYNC_R))):
        st = serve_poisson(cfg, rate=16.0, n_requests=32,
                           slots=ASYNC_SLOTS, prompt_len=64,
                           max_new=ASYNC_MAX_NEW,
                           threshold=0.5, paged=True, seed=0, params=params,
                           device="cuda", quiet=True, **kw)
        outs = st.pop("outputs")
        if len(outs) != 32 or any(len(o) != ASYNC_MAX_NEW for o in outs):
            fail(f"(d) {label}: not every request produced "
                 f"{ASYNC_MAX_NEW} tokens")
        n = max(1, st["decode_steps"])
        st["host_ms_per_decode_step"] = (st["host_ms"]
                                         - st["prefill_ms"]) / n
        st["readback_ms_per_decode_step"] = st["wait_ms"] / n
        print(f"  (d) {label}: {st['sustained_tok_s']:.2f} tok/s, p50 "
              f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
              f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
              f"{st['makespan_s']:.2f} s; {st['decode_steps']} decode steps: "
              f"host {st['host_ms_per_decode_step']:.2f} ms and readback "
              f"wait {st['readback_ms_per_decode_step']:.2f} ms a step; "
              f"prefill {st['prefill_ms'] / 1e3:.2f} s; builds "
              f"{st['jit_cache_sizes']}")
        out["poisson"][label] = st

    # one decode step's host/device split, sync and windowed
    out["profile"] = {}
    for label, kw in (("sync segmented", dict(steps=8)),
                      ("async", dict(steps=32, async_decode=True,
                                     readback_interval=ASYNC_R))):
        prof = profile_decode(cfg, slots=ASYNC_SLOTS,
                              prompt_len=64, params=params, **kw)
        print(f"  profile {label}: host {prof['wall_ms_per_step']:.2f} ms, "
              f"device {prof['device_ms_per_step']:.3f} ms, busy "
              f"{prof['device_busy_share'] * 100:.1f} %, "
              f"{prof['cuda_kernels_per_step']:.0f} kernels a step, "
              f"{prof['graph_replays']} graph replays")
        out["profile"][label] = prof
    return out


TIER_TRACE = dict(rate=100.0, n_requests=8, base_slots=2, prompt_len=12,
                  max_new=8, seed=0)


def run_tiered(torch, ops, ref, results):
    """Phase 5: granite-3-2b at full width behind the tiered cluster with
    an edge outage, twice (see the module docstring).  Returns the two
    runs' summaries and the launch counts of the int8 run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import Scenario
    from repro_torch.launch.serve import poisson_trace, serve_tiered_poisson
    from repro_torch.models import Model
    from repro_torch.serving.cluster import ClusterConfig, TieredServingCluster
    cfg = get_config("granite-3-2b")
    model = Model(cfg, device="cuda")
    params = model.init(0)
    tr = TIER_TRACE
    print(f"tiered path: granite-3-2b, 40 layers, random weights (seed 0), "
          f"{tr['n_requests']} requests, prompts {tr['prompt_len'] // 4}-"
          f"{tr['prompt_len']} tokens, max_new {tr['max_new']}, cloud pool "
          f"{tr['base_slots']} slots; latencies below are modelled by the "
          f"planners' tier profiles (virtual clocks), not measured")
    summaries = {}

    def summarize(label, st, wall, launches):
        mig = st["migration"]
        tok_s = st["tokens"] / wall
        print(f"  {label}: routes {st['route_counts']} splits "
              f"{st['splits']}, dead {st.get('dead_tiers')}, migration "
              f"{json.dumps(mig)}")
        print(f"    bytes moved {mig['bytes_moved']:.0f} of raw "
              f"{mig['bytes_raw']:.0f}; measured wall {wall:.2f} s, "
              f"{st['tokens']} tokens, {tok_s:.2f} tok/s (host clock); "
              f"modelled virtual p50 {st['p50_latency_s'] * 1e3:.1f} ms, "
              f"p95 {st['p95_latency_s'] * 1e3:.1f} ms; launches {launches}")
        if st["completed"] != tr["n_requests"]:
            fail(f"{label}: {st['completed']} of {tr['n_requests']} "
                 f"requests completed")
        if st.get("dead_tiers") != ["edge"]:
            fail(f"{label}: dead tiers {st.get('dead_tiers')}, not ['edge']")
        if mig["outage_migrations"] < 1:
            fail(f"{label}: no slot migrated off the dead tier")
        if any(len(o) != tr["max_new"] for o in st["outputs"]) or any(
                not (0 <= t < cfg.vocab_size) for o in st["outputs"]
                for t in o):
            fail(f"{label}: a request's tokens are missing or out of range")
        summaries[label] = {"wall_s": wall, "tokens": st["tokens"],
                            "tok_s": tok_s, "route_counts":
                            st["route_counts"], "migration": mig,
                            "virtual_p50_s": st["p50_latency_s"],
                            "virtual_p95_s": st["p95_latency_s"],
                            "launches": launches}

    # run 1: the normal entry point (contiguous arenas, handoff per link)
    ops.reset_launches()
    t0 = time.time()
    st = serve_tiered_poisson("granite-3-2b", scenario="tier-outage",
                              params=params, device="cuda", quiet=True,
                              **tr)
    torch.cuda.synchronize()
    summarize("run 1 serve_tiered_poisson (contiguous, kv_handoff auto)",
              st, time.time() - t0, dict(ops.LAUNCHES))

    # run 2: paged arenas and a forced int8 handoff, on the same trace
    rs = np.random.RandomState(tr["seed"])
    arrivals, lengths = poisson_trace(rs, tr["rate"], tr["n_requests"],
                                      tr["prompt_len"])
    prompts = [rs.randint(0, cfg.vocab_size, int(n)) for n in lengths]
    max_len = tr["prompt_len"] + tr["max_new"]
    max_len += (-max_len) % 16
    captured = {}
    orig = {"compress_rows": ops.compress_rows,
            "decompress_rows": ops.decompress_rows}

    def capture(kname):
        def wrapper(*a, **kw):
            if kname not in captured and a[0].numel():
                captured[kname] = (tuple(t.clone() for t in a), kw)
            return orig[kname](*a, **kw)
        return wrapper
    ops.compress_rows = capture("compress_rows")
    ops.decompress_rows = capture("decompress_rows")
    cluster = TieredServingCluster(
        model, params, Scenario.tier_outage("edge", at=0.03),
        plan_cfg=cfg,
        cfg=ClusterConfig(base_slots=tr["base_slots"], max_len=max_len,
                          prefill_chunk=tr["prompt_len"], kv_handoff="int8",
                          paged=True,
                          page_size=16))
    crs = [cluster.submit(p, max_new=tr["max_new"], arrival=float(a))
           for p, a in zip(prompts, arrivals)]
    ops.reset_launches()
    t0 = time.time()
    cluster.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ops.LAUNCHES)
    ops.compress_rows = orig["compress_rows"]
    ops.decompress_rows = orig["decompress_rows"]
    st = cluster.stats()
    st["outputs"] = [list(cr.req.out_tokens) for cr in crs]
    st["tokens"] = sum(len(o) for o in st["outputs"])
    summarize("run 2 TieredServingCluster (paged, kv_handoff int8)", st,
              wall, launches)
    if st["migration"]["compressed"] < 1:
        fail("run 2: no handoff went through the int8 kernels")
    for kname in ("paged_gqa_attention", "exit_head_entropy",
                  "quantize_rows", "dequantize_rows"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the tiered path")
    if "compress_rows" not in captured:
        fail("no live export was captured")
    (x,), _ = captured["compress_rows"]
    err = check_quant_pair(torch, ops, ref, x, x.dtype, "live export leaf")
    # both kernels timed on the live leaf (after the run's counts were
    # read), each with its own bound
    x2 = x.reshape(-1, x.shape[-1])
    q2, s2 = ops.compress_rows(x2)
    inst = int8_instances(x2, x.element_size())
    for kname, fn, args, bnd in (
            ("quantize_rows", ops.compress_rows, [(x2,)], quant_bound(x2)),
            ("dequantize_rows",
             lambda q, s: ops.decompress_rows(q, s, dtype=x.dtype),
             [(q2, s2)], dequant_bound(q2, x.element_size()))):
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)
        spread = interleaved_ms(torch, fn, None, args)
        results[kname]["live"] = {
            "shape": list(x2.shape), "dtype": str(x.dtype),
            "ms": spread["kernel"]["median"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "spread": spread["kernel"],
            "instance": inst[kname.split("_")[0]]}
        print(f"  live {kname} timing: {json.dumps(results[kname]['live'])}")
    del cluster

    # run 3: the same trace with async decode windows in every tier pool
    # (a CUDA graph each); a pool's windows in flight are drained
    # (_sync_pool) before a slot leaves it
    drains = []
    orig_sync = TieredServingCluster._sync_pool

    def counting_sync(self, tr):
        if tr.sched.cfg.async_decode:
            drains.append((tr.name, len(tr.sched._win_q)))
        return orig_sync(self, tr)
    TieredServingCluster._sync_pool = counting_sync
    ops.reset_launches()
    t0 = time.time()
    try:
        st = serve_tiered_poisson("granite-3-2b", scenario="tier-outage",
                                  params=params, device="cuda", quiet=True,
                                  async_decode=True, readback_interval=4,
                                  **tr)
    finally:
        TieredServingCluster._sync_pool = orig_sync
    torch.cuda.synchronize()
    summarize("run 3 serve_tiered_poisson (async windows of 4)", st,
              time.time() - t0, dict(ops.LAUNCHES))
    edge = [n for name, n in drains if name == "edge"]
    print(f"  run 3: _sync_pool calls (tier, windows in flight) {drains}; "
          f"decode-window builds {st['jit_cache_sizes']}")
    if not edge:
        fail("run 3: the edge pool was not drained before its outage export")
    if any(v.get("decode_window", 0) > 1
           for v in st["jit_cache_sizes"].values()):
        fail("run 3: a tier pool captured its decode window more than once")
    summaries["run 3 serve_tiered_poisson (async windows of 4)"][
        "sync_pool_calls"] = drains
    del model, params
    return summaries, launches


def record_routes(ffn, log):
    """Wrap the MoE router so every call appends (device type, idx, probs)
    to ``log``; returns the original for restoring."""
    orig = ffn._route

    def route(x2d, w, k):
        out = orig(x2d, w, k)
        log.append((x2d.device.type, out[1].cpu(), out[2].cpu()))
        return out
    ffn._route = route
    return orig


def check_smoke_vs_cpu(torch, arch, w8a8=False):
    """A smoke-width paged decode: the card (kernels, cuBLAS) against the
    CPU (plain versions) on the same weights and inputs.  A row whose MoE
    routing differs between the two is left out of the logits check, and
    must be a router tie (probabilities within ROUTE_TIE).  A sliding-window
    model (no paged arena) decodes on its contiguous ring instead, from
    positions that have wrapped around it; an encoder-decoder model on its
    contiguous cache, whose cross rows each side primes from the same
    frames (the card's encoder runs flash without a mask).  ``w8a8``
    quantizes the experts first (the W8A8 kernel against the CPU's int32
    sum); a model with no exit (llama4-maverick-smoke: its exit would
    split a pair unit) skips the probe."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model, ffn
    from repro_torch.models.attention import PagedKV
    from repro_torch.models.common import tree_map
    from repro_torch.serving import prime_whisper_cross_cache
    cfg = get_config(arch)
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    p_cpu = cpu.init(0)
    if w8a8:
        ffn.quantize_model_moe(p_cpu)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    w0 = ops.LAUNCHES["w8a8_expert_matmul"]
    b, page, pps = 4, 16, 4
    n_pages = b * pps
    g = torch.Generator().manual_seed(1)
    tbl = torch.randperm(n_pages, generator=g).to(torch.int32).reshape(b, pps)
    ring = cfg.attention == "sliding"
    encdec = cfg.family == "encdec"
    if ring:
        c_cpu = cpu.init_decode_cache(b, 4 * cfg.sliding_window)
        c_gpu = gpu.init_decode_cache(b, 4 * cfg.sliding_window)
        pos = torch.tensor([0, 60, 70, 130], dtype=torch.int32)
    elif encdec:
        c_cpu = cpu.init_decode_cache(b, 64)
        c_gpu = gpu.init_decode_cache(b, 64)
        frames = 0.02 * torch.randn(b, cfg.encdec.encoder_seq_len,
                                    cfg.d_model, generator=g).bfloat16()
        prime_whisper_cross_cache(cpu, p_cpu, c_cpu, frames)
        prime_whisper_cross_cache(gpu, p_gpu, c_gpu, frames.cuda())
        pos = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    else:
        c_cpu = cpu.init_decode_cache_paged(b, n_pages, page)
        c_gpu = gpu.init_decode_cache_paged(b, n_pages, page)
        pos = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    worst = worst_ent = 0.0
    log = []
    orig = record_routes(ffn, log)
    flips = compared = 0
    for _ in range(8):
        toks = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
        mask = torch.ones(b, dtype=torch.bool)
        del log[:]
        contiguous = ring or encdec
        lc, _, _ = cpu.decode_step(
            p_cpu, c_cpu, toks, pos,
            paged=None if contiguous else PagedKV(tbl, mask))
        lg, _, _ = gpu.decode_step(
            p_gpu, c_gpu, toks.cuda(), pos.cuda(),
            paged=None if contiguous else PagedKV(tbl.cuda(), mask.cuda()))
        keep = torch.ones(b, dtype=torch.bool)
        host = [r for r in log if r[0] == "cpu"]
        card = [r for r in log if r[0] == "cuda"]
        for (_, hi, hp), (_, ci, _) in zip(host, card):
            for row in (hi != ci).any(1).nonzero()[:, 0].tolist():
                gap = (hp[row][hi[row].long()]
                       - hp[row][ci[row].long()]).abs().max().item()
                if gap >= ROUTE_TIE:
                    fail(f"{arch}: the card routes row {row} to "
                         f"{ci[row].tolist()}, the CPU to {hi[row].tolist()}"
                         f" (probability gap {gap:.3e}, not a tie)")
                keep[row] = False
                flips += 1
        compared += int(keep.sum())
        worst = max(worst, (lg.cpu() - lc)[keep].abs().max().item())
        if cpu.n_exits:
            x = cpu.embed_decode_tokens(p_cpu, toks)
            ec = cpu.exit_probe_entropy(p_cpu, 0, x)
            eg = gpu.exit_probe_entropy(p_gpu, 0, x.cuda())
            worst_ent = max(worst_ent, (eg.cpu() - ec).abs().max().item())
        pos = pos + 1
    ffn._route = orig
    torch.cuda.synchronize()
    if w8a8 and ops.LAUNCHES["w8a8_expert_matmul"] <= w0:
        fail(f"{arch}: the W8A8 kernel did not launch")
    arena = "ring" if ring else "primed contiguous" if encdec else "paged"
    arena += " W8A8" if w8a8 else ""
    print(f"smoke reference {arch} (card vs CPU, 8 {arena} decode steps): "
          f"logits max_abs_err {worst:.3e} over {compared} rows (tol "
          f"{LOGIT_TOL}; {flips} rows left out at router ties), probe "
          f"entropy {worst_ent:.3e} (tol {ENT_TOL})")
    if worst > LOGIT_TOL or worst_ent > ENT_TOL or compared < 24:
        fail(f"the card disagrees with the CPU on {arch}")


def check_forward_vs_cpu(torch, arch, long_mode, w8a8=False):
    """The smoke-width ``Model.forward`` on 2 x 128 tokens: the card (flash
    kernel, cuBLAS) against the CPU (plain versions) on the same weights.
    Logits and MTP logits within LOGIT_TOL, exit logits within EXIT_TOL
    (all rows: the exit head sits before the MoE layer), the MoE aux loss within
    AUX_TOL.  Every router call is recorded; a token row whose routing
    differs must be a router tie, and it is left out with every row whose
    kept assignments moved because of it (capacity order); the MTP block
    attends over the sequence, so it also leaves out the later positions
    of that sequence.  A vlm batch carries 0.02 N(0, 1) patch embeddings
    in its first positions, an encdec batch frames of the same scale.
    ``w8a8`` quantizes the experts first."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model, ffn
    from repro_torch.models.common import tree_map
    cfg = get_config(arch)
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    p_cpu = cpu.init(0)
    if w8a8:
        ffn.quantize_model_moe(p_cpu)
    p_gpu = tree_map(lambda t: t.cuda(), p_cpu)
    b, s = 2, 128
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    extra = {"vlm": ("patch_embeds", cfg.frontend_tokens),
             "encdec": ("frames", cfg.encdec.encoder_seq_len)}
    if cfg.family in extra:
        key, n = extra[cfg.family]
        batch[key] = 0.02 * torch.randn(b, n, cfg.d_model,
                                        generator=g).bfloat16()
    log = []
    orig = record_routes(ffn, log)
    want = cpu.forward(p_cpu, batch, long_mode=long_mode)
    got = gpu.forward(p_gpu, {k: t.cuda() for k, t in batch.items()},
                      long_mode=long_mode)
    torch.cuda.synchronize()
    ffn._route = orig
    keep = torch.ones(b * s, dtype=torch.bool)
    keep_mtp = torch.ones(b * s, dtype=torch.bool)
    host = [r for r in log if r[0] == "cpu"]
    card = [r for r in log if r[0] == "cuda"]
    flips = 0
    aux_want = 0.0
    for call, ((_, hi, hp), (_, ci, _)) in enumerate(zip(host, card)):
        rows = (hi != ci).any(1).nonzero()[:, 0].tolist()
        for row in rows:
            gap = (hp[row][hi[row].long()]
                   - hp[row][ci[row].long()]).abs().max().item()
            if gap >= ROUTE_TIE:
                fail(f"{arch}: the card routes row {row} to "
                     f"{ci[row].tolist()}, the CPU to {hi[row].tolist()} "
                     f"(probability gap {gap:.3e}, not a tie)")
        m = cfg.moe
        cap = ffn._capacity(hi.shape[0], m.num_experts, m.top_k,
                            m.capacity_factor)
        kept = [ffn._slots(i, 0, m.num_experts, cap)[1] for i in (hi, ci)]
        rows += (kept[0] != kept[1]).any(1).nonzero()[:, 0].tolist()
        flips += len(set(rows))
        if call == 0:                 # the model's MoE layer: its aux
            aux_want = ffn._aux_loss(hp, ci, m.num_experts).item()
            for row in rows:
                keep[row] = False
                keep_mtp[row:row - row % s + s] = False
        else:                         # the MTP block's MoE layer
            keep_mtp[rows] = False
    err = (got.logits.cpu() - want.logits).reshape(b * s, -1)[keep]
    err = err.abs().max().item()
    exit_err = max([(g.cpu() - w).abs().max().item()
                    for g, w in zip(got.exit_logits, want.exit_logits)],
                   default=0.0)
    line = (f"smoke forward {arch}{' long_mode' if long_mode else ''}"
            f"{' W8A8' if w8a8 else ''} "
            f"(card vs CPU, {b} x {s} tokens): logits max_abs_err "
            f"{err:.3e} over {int(keep.sum())} rows (tol {LOGIT_TOL}; "
            f"{flips} rows left out at router ties), exit logits "
            f"{exit_err:.3e} (tol {EXIT_TOL})")
    ok = err <= LOGIT_TOL and exit_err <= EXIT_TOL \
        and int(keep.sum()) >= b * s // 2
    if cfg.mtp_depth:
        mtp_err = (got.mtp_logits.cpu() - want.mtp_logits).reshape(
            b * s, -1)[keep_mtp].abs().max().item()
        aux_err = abs(got.aux_loss.item() - aux_want)
        line += (f", mtp logits {mtp_err:.3e} over {int(keep_mtp.sum())} "
                 f"rows, aux {got.aux_loss.item():.5f} vs "
                 f"{want.aux_loss.item():.5f} (under the card's routing "
                 f"{aux_want:.5f}; tol {AUX_TOL})")
        ok = ok and mtp_err <= LOGIT_TOL and aux_err <= AUX_TOL \
            and int(keep_mtp.sum()) >= s // 2
    print(line)
    if not ok or not torch.isfinite(got.logits).all():
        fail(f"the card's forward disagrees with the CPU's on {arch}")


def deepseek_cut(get_config):
    """deepseek-v3 at its published widths (arXiv:2412.19437), cut in depth
    to 4 layers: 3 dense (first_dense_layers as published) and 1 MoE with
    256 experts; one exit head after layer 3; no MTP (it feeds only
    ``Model.forward``, never decode)."""
    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, name="deepseek-v3-671b-4l", num_layers=4, mtp_depth=0,
        exits=dataclasses.replace(cfg.exits, exit_layers=(3,),
                                  entropy_threshold=0.5))


# the live call of each kernel (and of the MoE layer) that phase 6 captures
CAP_EVERY = (301, 17, 97)
DS_TRACE = dict(rate=8.0, n_requests=24, slots=16, prompt_len=128,
                max_new=16, threshold=0.5, paged=True, page_size=16,
                segmented=True, prefix_share=0.25, prefix_len=64, seed=0)


def run_deepseek(torch, ops, ref, results, exit_ds):
    """Phase 6 (see the module docstring).  Returns a summary and the
    launch counts of the serving run."""
    from repro_torch.kernels import paged_mla
    from repro_torch.launch import kernel_ab as ab
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model, ffn
    from repro_torch.models.common import tree_leaves
    cfg = deepseek_cut(get_config)
    m = cfg.moe
    tr = DS_TRACE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    torch.cuda.synchronize()
    init_s = time.time() - t0
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    peak = torch.cuda.max_memory_allocated()
    print(f"deepseek-v3 path: {cfg.name}, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, R {cfg.kv_lora_rank}, Hr "
          f"{cfg.qk_rope_head_dim}, {cfg.num_layers} layers (3 dense, 1 MoE:"
          f" {m.num_experts} experts top-{m.top_k} + {m.num_shared_experts} "
          f"shared, capacity factor {m.capacity_factor}), vocab "
          f"{cfg.vocab_size}, exit after layer 3; random weights (seed 0)")
    print(f"  init {init_s:.1f}s: params {pbytes / 1e9:.2f} GB, peak device "
          f"memory after init {peak / 1e9:.2f} GB "
          f"(torch.cuda.max_memory_allocated)")

    captured = {}
    orig = {"paged_mla_attention": ops.paged_mla_attention,
            "exit_head_entropy": ops.exit_head_entropy,
            "moe_ffn": ffn.moe_ffn}
    calls = {k: 0 for k in orig}

    def capturing(kname, every, mod):
        def wrapper(*a, **kw):
            calls[kname] += 1
            if calls[kname] % every == 0:
                # small inputs change in place later: copy them; the
                # weights (exit head W, router) do not
                captured[kname] = (tuple(
                    t.clone() if isinstance(t, torch.Tensor)
                    and t.numel() * t.element_size() < 2 ** 26 else t
                    for t in a), kw)
            return orig[kname](*a, **kw)
        setattr(mod, kname, wrapper)
    capturing("paged_mla_attention", CAP_EVERY[0], ops)
    capturing("exit_head_entropy", CAP_EVERY[1], ops)
    capturing("moe_ffn", CAP_EVERY[2], ffn)
    ops.reset_launches()
    t0 = time.time()
    stats = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                          n_requests=tr["n_requests"], rate=tr["rate"],
                          slots=tr["slots"], prompt_len=tr["prompt_len"],
                          max_new=tr["max_new"], threshold=tr["threshold"],
                          paged=tr["paged"], page_size=tr["page_size"],
                          segmented=tr["segmented"],
                          prefix_share=tr["prefix_share"],
                          prefix_len=tr["prefix_len"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    wall = time.time() - t0
    ops.paged_mla_attention = orig["paged_mla_attention"]
    ops.exit_head_entropy = orig["exit_head_entropy"]
    ffn.moe_ffn = orig["moe_ffn"]
    outs = stats.pop("outputs")
    print(f"  served {tr['n_requests']} requests at {tr['rate']} req/s, "
          f"prompts {tr['prompt_len'] // 4}-{tr['prompt_len']} tokens "
          f"({tr['prefix_share']:.2f} sharing a {tr['prefix_len']}-token "
          f"prefix), {tr['max_new']} new tokens, {tr['slots']} slots, paged "
          f"+ segmented: {wall:.1f}s including warm-up")
    print(f"  tokens {stats['tokens']}, sustained "
          f"{stats['sustained_tok_s']:.2f} tok/s, p50 "
          f"{stats['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{stats['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{stats['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{stats['prefix_hit_tokens']}, chunks skipped "
          f"{stats['prefill_chunks_skipped']}; launches {launches}")
    print(f"  exit stats {stats['exit_stats']}; stage calls "
          f"{stats['stage_calls']}")
    if len(outs) != tr["n_requests"] or any(len(o) != tr["max_new"]
                                             for o in outs):
        fail("deepseek-v3: not every request produced max_new tokens")
    if any(not (0 <= t < cfg.vocab_size) for o in outs for t in o):
        fail("deepseek-v3: token out of vocabulary range")
    if stats["prefix_hit_tokens"] <= 0:
        fail("deepseek-v3: the shared prefix never hit the prefix cache")
    for kname in ("paged_mla_attention", "exit_head_entropy"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the deepseek-v3 path")

    # both kernels again on inputs captured from the live run
    for kname, tol, plain, res in (
            ("paged_mla_attention", MLA_TOL, ref.paged_mla_attention_ref,
             results["paged_mla_attention"]),
            ("exit_head_entropy", ENT_TOL, ref.exit_head_entropy_ref,
             exit_ds)):
        if kname not in captured:
            fail(f"no live call of {kname} was captured")
        a, kw = captured[kname]
        got = orig[kname](*a, **kw).float()
        want = plain(*a, **kw).float()
        err = (got - want).abs().max().item()
        shapes = [tuple(t.shape) for t in a]
        print(f"  live {kname} {shapes}: max_abs_err {err:.3e} (tol {tol})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"{kname} disagrees with its plain version on live "
                 f"deepseek-v3 inputs")
        res["max_abs_err"] = max(res["max_abs_err"], err)
    # the paged kernel's time on the live call: the lengths serving reaches
    a, kw = captured["paged_mla_attention"]
    prep, sdpa = ab.sdpa_mla_gathered(kw["scale"])

    def mla(*t):
        return orig["paged_mla_attention"](*t, **kw)
    live = live_timing(torch, mla, sdpa, [a], [prep(*a)], mla_bound(a))
    live["plan"] = paged_mla.plan(a[0].shape[0], a[0].shape[2],
                                  a[4].shape[1], paged_mla.sm_count("cuda"))
    results["paged_mla_attention"]["live"] = live
    print(f"  live paged_mla_attention timing: {json.dumps(live)}")

    # one live MoE input's routing, recomputed on the host
    if "moe_ffn" not in captured:
        fail("no live MoE call was captured")
    (lp_moe, h, *_), _ = captured["moe_ffn"]
    x2d = h.reshape(-1, h.shape[-1])
    t_tok = x2d.shape[0]
    cap = ffn._capacity(t_tok, m.num_experts, m.top_k, m.capacity_factor)
    _, idx_host, _ = ffn._route(x2d.cpu(), lp_moe["router"].cpu(), m.top_k)
    _, kept = ffn._slots(idx_host, 0, m.num_experts, cap)
    _, idx_card, _ = ffn._route(x2d, lp_moe["router"], m.top_k)
    same = bool(torch.equal(idx_card.cpu(), idx_host))
    dropped = int((~kept).sum())
    print(f"  live MoE input [{t_tok}, {x2d.shape[1]}]: capacity {cap} rows "
          f"per expert; the host's routing drops {dropped} of "
          f"{t_tok * m.top_k} assignments; the card routes "
          f"{'identically' if same else 'differently'}")
    del captured, lp_moe, h, x2d

    # async decode windows (one CUDA graph of the monolithic step) against
    # the sync monolithic poll, closed loop on the same weights
    windows = run_deepseek_async(torch, ops, model, params)

    # one decode step's host/device split, on the same weights
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=128, steps=4,
                          seed=tr["seed"], params=params)
    print(f"  profile_decode (16 slots, 128-token prompts, 4 steps): host "
          f"wall {prof['wall_ms_per_step']:.2f} ms/step, device "
          f"{prof['device_ms_per_step']:.2f} ms/step, busy "
          f"{prof['device_busy_share'] * 100:.1f} %, "
          f"{prof['cuda_kernels_per_step']:.0f} CUDA kernels/step; top "
          f"{[(k['name'][:40], round(k['ms_per_step'], 3)) for k in prof['top_kernels'][:5]]}")
    print(f"  the port's kernels a step: "
          f"{[(k['name'][:48], round(k['ms_per_step'], 4), k['calls_per_step']) for k in prof['port_kernels']]}")
    # the full-sequence forward on the same weights: MLA and the MoE
    # forward (capacity drops at 512 tokens) at 128 heads
    toks = torch.randint(0, cfg.vocab_size, (2, 256), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(tr["seed"]))
    model.forward(params, {"tokens": toks})           # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    out = model.forward(params, {"tokens": toks})
    torch.cuda.synchronize()
    fwd_s = time.time() - t0
    finite = bool(torch.isfinite(out.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in out.exit_logits)
    print(f"  Model.forward 2 x 256 tokens: {fwd_s * 1e3:.1f} ms (host "
          f"clock, ends in a synchronize), aux loss "
          f"{out.aux_loss.item():.5f}, logits {tuple(out.logits.shape)} "
          f"finite: {finite}")
    if not finite or not math.isfinite(out.aux_loss.item()):
        fail("deepseek-v3: the forward's logits or aux loss are not finite")
    fwd = {"tokens": 512, "ms": fwd_s * 1e3, "aux_loss": out.aux_loss.item()}
    del out
    summary = {"config": cfg.name, "init_s": init_s, "param_bytes": pbytes,
               "peak_bytes_after_init": peak, "serve": stats,
               "wall_s": wall, "launches": launches,
               "moe_live": {"tokens": t_tok, "capacity": cap,
                            "dropped": dropped,
                            "assignments": t_tok * m.top_k,
                            "card_routes_same": same},
               "profile_decode": prof, "forward": fwd, "async": windows}
    del model, params
    return summary, launches


MULTI_ARCHS = ("granite-3-2b", "yi-6b", "mistral-nemo-12b")
MULTI_LAYERS = 8       # phase 8's depth cut of each (exits after 3, 6)
MULTI_TRACE = dict(rate=8.0, n_requests=6, slots=8, prompt_len=96,
                   max_new=16, threshold=0.5, prefill_chunk=16,
                   max_prefill_chunks=2, paged=True, page_size=16,
                   segmented=True, seed=0)
SPEC_TRACE = dict(slots=8, requests=8, prompt=(32, 64), max_new=16, k=4)
BRIDGE_TRACE = dict(requests=4, prompt=(6, 12), max_new=16, k=6)


def _first_diff(torch, model, params, prompt, got, want):
    """A printable note of where two greedy streams first differ."""
    if len(got) != len(want):
        return f"{len(got)} tokens, expected {len(want)}"
    k, gap = tie_gap(torch, model, params, prompt, got, want)
    return f"token {k} differs, fp32 top-2 gap {gap:.3e}"


def run_multi(torch, ops):
    """Phase 8: multi-model pools and speculative pairs at full width (see
    the module docstring).  Returns its summary and each part's launch
    counts."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import Scenario
    from repro_torch.launch.serve import serve_multi_poisson
    from repro_torch.models import Model
    from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                     ModelGroup, Request, SchedulerConfig,
                                     SpecPair, TieredServingCluster)
    from repro_torch.models.common import tree_leaves
    t_phase = time.time()
    out, launches = {}, {}
    gb = 1e9

    # (a) one pool serving three dense models
    tr = MULTI_TRACE
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cuts = [depth_cut(get_config(a), MULTI_LAYERS, (3, 6))
            for a in MULTI_ARCHS]
    names = tuple(c.name for c in cuts)
    entries = []
    for i, c in enumerate(cuts):
        m = Model(c, device="cuda")
        entries.append((c.name, m, m.init(tr["seed"] + i)))
    group = ModelGroup(entries)
    del entries, m
    torch.cuda.synchronize()
    pbytes = {e.name: sum(t.numel() * t.element_size()
                          for t in tree_leaves(e.params)) for e in group}
    print(f"multi-model pool: {', '.join(MULTI_ARCHS)} at their published "
          f"widths, cut to {MULTI_LAYERS} layers each, random weights "
          f"(seeds 0, 1, 2), params "
          f"{ {k: round(v / gb, 2) for k, v in pbytes.items()} } GB, init "
          f"{time.time() - t0:.1f}s; paged (page {tr['page_size']}) + "
          f"segmented, threshold {tr['threshold']}, {tr['slots']} slots a "
          f"model, pool-wide prefill budget {tr['max_prefill_chunks']} "
          f"chunks a poll; {tr['n_requests']} Poisson requests at "
          f"{tr['rate']} req/s, round-robin, prompts {tr['prompt_len'] // 4}"
          f"-{tr['prompt_len']} tokens, {tr['max_new']} new tokens")
    keys = ("paged_gqa_attention", "exit_head_entropy")
    per_model = {a: dict.fromkeys(keys, 0) for a in names}
    orig_poll = ContinuousBatchScheduler.poll

    def attributed(self, *a, **kw):
        before = dict(ops.LAUNCHES)
        rep = orig_poll(self, *a, **kw)
        for k in keys:
            per_model[self.model.cfg.name][k] += ops.LAUNCHES[k] - before[k]
        return rep
    ContinuousBatchScheduler.poll = attributed
    ops.reset_launches()
    t0 = time.time()
    try:
        st = serve_multi_poisson(names, group=group, device="cuda",
                                 quiet=True, **tr)
    finally:
        ContinuousBatchScheduler.poll = orig_poll
    torch.cuda.synchronize()
    launches["pool"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    for arch, ms in st["models"].items():
        print(f"  {arch}: {ms['tokens']} tokens, {ms['tok_s']:.2f} tok/s, "
              f"p50 {ms['p50_latency_s'] * 1e3:.0f} ms, p95 "
              f"{ms['p95_latency_s'] * 1e3:.0f} ms; launches "
              f"{per_model[arch]}")
        if any(v <= 0 for v in per_model[arch].values()):
            fail(f"phase 8 (a): a kernel was not launched for {arch}")
    print(f"  pool: {st['sustained_tok_s']:.2f} tok/s over "
          f"{st['makespan_s']:.2f} s, {st['polls']} polls, host "
          f"{st['host_ms_per_poll']:.1f} ms a poll; {wall:.1f}s with warm-up"
          f"; launches {launches['pool']}")
    if len(st["outputs"]) != tr["n_requests"] or any(
            len(o) != tr["max_new"] for o in st["outputs"]):
        fail("phase 8 (a): not every request produced max_new tokens")
    # each model's streams against a dedicated single-model scheduler fed
    # the same requests at once
    max_len = tr["prompt_len"] + tr["max_new"]
    max_len += (-max_len) % tr["page_size"]
    t0 = time.time()
    for e in group:
        ded = ContinuousBatchScheduler(e.model, e.params, SchedulerConfig(
            n_slots=tr["slots"], max_len=max_len,
            prefill_chunk=tr["prefill_chunk"],
            exit_threshold=tr["threshold"],
            max_prefill_chunks_per_step=tr["max_prefill_chunks"],
            paged=True, page_size=tr["page_size"], segmented=True),
            device="cuda")
        idx = [j for j, m in enumerate(st["request_models"]) if m == e.name]
        reqs = [Request(tokens=np.asarray(st["prompts"][j]),
                        max_new=tr["max_new"], req_id=j) for j in idx]
        for r in reqs:
            ded.submit(r)
        ded.run()
        for j, r in zip(idx, reqs):
            if list(r.out_tokens) != st["outputs"][j]:
                fail(f"phase 8 (a): {e.name} request {j} differs from its "
                     f"dedicated scheduler's: " + _first_diff(
                         torch, e.model, e.params, st["prompts"][j],
                         st["outputs"][j], list(r.out_tokens)))
        del ded
    print(f"  every stream bit-identical to a dedicated scheduler of its "
          f"model ({time.time() - t0:.1f}s); peak device memory "
          f"{torch.cuda.max_memory_allocated() / gb:.2f} GB")
    st.pop("prompts")
    out["pool"] = dict(st, launches_per_model=per_model,
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       param_bytes=pbytes)
    del group, st
    gc.collect()
    torch.cuda.empty_cache()

    # (b) SpecPair at k 4: granite-3-2b drafting for itself
    sp = SPEC_TRACE
    cfg = cuts[0]
    model = Model(cfg, device="cuda")
    params = model.init(0)
    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(sp["prompt"][0],
                                                            sp["prompt"][1]
                                                            + 1)))
               for _ in range(sp["requests"])]
    pcfg = SchedulerConfig(n_slots=sp["slots"], max_len=96,
                           prefill_chunk=16, exit_threshold=0.0,
                           segmented=False, paged=True, page_size=16)

    def submit(sched, prompts, max_new):
        reqs = [Request(tokens=p, max_new=max_new, req_id=j)
                for j, p in enumerate(prompts)]
        for r in reqs:
            sched.submit(r)
        return reqs
    target_only = ContinuousBatchScheduler(model, params, pcfg,
                                           device="cuda")
    reqs = submit(target_only, prompts, sp["max_new"])
    target_only.run()
    want = [list(r.out_tokens) for r in reqs]
    del target_only
    print(f"speculative pair: granite-3-2b target and draft at full width, "
          f"{cfg.num_layers} layers, "
          f"k {sp['k']}, {sp['slots']} slots, {sp['requests']} requests, "
          f"prompts {min(map(len, prompts))}-{max(map(len, prompts))} "
          f"tokens, {sp['max_new']} new tokens, paged, against the "
          f"target-only monolithic greedy pool")
    out["spec"] = {}
    for label, seed in (("shared params", None), ("draft seed 7", 7)):
        dparams = params if seed is None else model.init(seed)
        pair = SpecPair(ModelGroup([("draft", model, dparams),
                                    ("target", model, params)]), pcfg,
                        k=sp["k"])
        reqs = submit(pair, prompts, sp["max_new"])
        torch.cuda.synchronize()
        ops.reset_launches()
        rounds = wall_r = host_r = 0
        t0 = time.perf_counter()
        while pair.has_work:
            tp = time.perf_counter()
            rep = pair.poll()
            if rep.spec_rounds and not rep.prefill_chunks:
                rounds += 1
                wall_r += time.perf_counter() - tp
                host_r += rep.host_ms
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"spec {label}"] = dict(ops.LAUNCHES)
        for j, r in enumerate(reqs):
            if list(r.out_tokens) != want[j]:
                fail(f"phase 8 (b) {label}: request {j} differs from "
                     f"target-only greedy: " + _first_diff(
                         torch, model, params, prompts[j],
                         list(r.out_tokens), want[j]))
        ss = pair.spec_stats()
        res = dict(ss, wall_s=wall, decode_rounds=rounds,
                   wall_ms_per_round=wall_r / max(1, rounds) * 1e3,
                   host_ms_per_round=host_r / max(1, rounds),
                   launches=launches[f"spec {label}"])
        print(f"  {label}: streams bit-identical; {ss['rounds']:.0f} rounds, "
              f"{ss['slot_rounds']:.0f} slot-rounds, {ss['committed']:.0f} "
              f"committed, acceptance {ss['acceptance_len']:.3f}; "
              f"{wall:.2f} s, {res['wall_ms_per_round']:.1f} ms wall and "
              f"{res['host_ms_per_round']:.1f} ms host a round (rounds "
              f"without prefill); launches {res['launches']}")
        if res["launches"]["paged_gqa_attention"] <= 0:
            fail(f"phase 8 (b) {label}: paged attention was not launched")
        if seed is None and ss["acceptance_len"] < 2.5:
            fail(f"phase 8 (b): shared-param acceptance "
                 f"{ss['acceptance_len']:.3f} < 2.5")
        for pool in pair.pools.values():
            if pool.page_alloc.free_count + len(pool.prefix_cache) \
                    != pool.page_alloc.n_pages:
                fail(f"phase 8 (b) {label}: pages leaked")
        out["spec"][label] = res
        del pair, dparams

    # (c) the tiered cluster's speculative bridge
    bt = BRIDGE_TRACE
    group = ModelGroup([("small", model, params), ("big", model, params)])
    cl = TieredServingCluster(
        group, scenario=Scenario.high_rtt_access(),
        plan_cfg={"small": get_config("granite-3-2b"),
                  "big": get_config("deepseek-v3-671b")},
        cfg=ClusterConfig(base_slots=8, max_len=32, prefill_chunk=16,
                          exit_threshold=0.0, paged=True, page_size=16,
                          spec_draft="small", spec_k=bt["k"]))
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(bt["prompt"][0],
                                                            bt["prompt"][1]
                                                            + 1)))
               for _ in range(bt["requests"])]
    crs = [cl.submit(p.copy(), max_new=bt["max_new"], arrival=0.05 * j,
                     model="big") for j, p in enumerate(prompts)]
    ops.reset_launches()
    t0 = time.time()
    cl.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches["bridge"] = dict(ops.LAUNCHES)
    target_only = ContinuousBatchScheduler(model, params, dataclasses.replace(
        pcfg, max_len=32), device="cuda")
    reqs = submit(target_only, prompts, bt["max_new"])
    target_only.run()
    for j, (cr, r) in enumerate(zip(crs, reqs)):
        if not cr.done or cr.decision.paradigm != "speculative":
            fail(f"phase 8 (c): request {j} routed "
                 f"{cr.decision.paradigm}, not speculative")
        if list(cr.req.out_tokens) != list(r.out_tokens):
            fail(f"phase 8 (c): request {j} differs from target-only "
                 f"greedy: " + _first_diff(torch, model, params, prompts[j],
                                          list(cr.req.out_tokens),
                                          list(r.out_tokens)))
    st = cl.stats()
    sp_st = st["speculative"]
    print(f"tiered speculative bridge: granite-3-2b ({cfg.num_layers} "
          f"layers) drafting on the device "
          f"tier for granite-3-2b on the cloud tier (planned as "
          f"granite-3-2b / deepseek-v3-671b), Scenario.high_rtt_access, k "
          f"{bt['k']}, {bt['requests']} requests: routes "
          f"{st['route_counts']}, {sp_st['rounds']} rounds, acceptance "
          f"{sp_st['acceptance_len']:.3f}, router.spec_accept "
          f"{cl.router.spec_accept:.3f}, modelled virtual p50 "
          f"{sp_st['p50_latency_s'] * 1e3:.1f} ms; measured wall "
          f"{wall:.2f} s; launches {launches['bridge']}")
    if sp_st["acceptance_len"] < 4.0 \
            or cl.router.spec_accept != sp_st["acceptance_len"]:
        fail("phase 8 (c): acceptance below 4, or not fed back to the "
             "router")
    if launches["bridge"]["paged_gqa_attention"] <= 0:
        fail("phase 8 (c): paged attention was not launched")
    out["bridge"] = {"wall_s": wall, "route_counts": st["route_counts"],
                     "speculative": sp_st,
                     "spec_accept": cl.router.spec_accept,
                     "launches": launches["bridge"]}
    del cl, group, model, params, target_only
    out["wall_s"] = time.time() - t_phase
    print(f"phase 8 wall time {out['wall_s']:.1f}s")
    return out, launches


DS_ASYNC = dict(slots=16, requests=16, max_new=24, readback_interval=8)


def run_deepseek_async(torch, ops, model, params):
    """Phase 6's deepseek-v3 through async decode windows: a closed loop of
    16 requests (prompts 16-64 tokens, max_new from 8 to 24, so rows leave
    the window's chain at different steps and the MoE's capacity sees
    frozen rows) through the eager sync monolithic poll, then through
    windows of 8; the tokens must be equal (a top-2 tie under LOGIT_TIE is
    the only excuse).  Returns the two runs' numbers."""
    import numpy as np
    from repro_torch.serving.scheduler import (ContinuousBatchScheduler,
                                               Request, SchedulerConfig)
    cfg, d = model.cfg, DS_ASYNC
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65)))
               for _ in range(d["requests"])]
    max_news = [8 + (j * 16) // (d["requests"] - 1)
                for j in range(d["requests"])]
    out, streams = {}, {}
    for label, async_decode in (("sync", False), ("async", True)):
        sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=d["slots"], max_len=96, prefill_chunk=16,
            exit_threshold=0.5, segmented=False, paged=True,
            async_decode=async_decode,
            readback_interval=d["readback_interval"]), device="cuda")
        reqs = [Request(tokens=p, max_new=n, req_id=j)
                for j, (p, n) in enumerate(zip(prompts, max_news))]
        for r in reqs:
            sched.submit(r)
        sched.prefill_poll()
        if sched._pending is not None or sched.queue:
            fail("deepseek-v3 async: the prompts were not all admitted")
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        while sched.has_work:
            sched.poll()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        streams[label] = [list(r.out_tokens) for r in reqs]
        out[label] = {"wall_s": wall, "committed_steps": sched._step_idx,
                      "launches": dict(ops.LAUNCHES),
                      "builds": sched.jit_cache_sizes()}
        if async_decode:
            w = sched._window
            out[label].update(replays=w.replays, captures=w.captures,
                              per_replay=w.per_replay)
        del sched
    ties = []
    for j, (got, want) in enumerate(zip(streams["async"], streams["sync"])):
        if len(got) != max_news[j]:
            fail(f"deepseek-v3 async request {j}: {len(got)} tokens")
        if got != want:
            k, gap = tie_gap(torch, model, params, prompts[j], got, want)
            print(f"  async request {j} differs at token {k}: fp32 top-2 "
                  f"gap {gap:.3e}")
            ties.append({"req": j, "token": k, "gap": gap})
            if not 0.0 <= gap < LOGIT_TIE:
                fail("deepseek-v3: async tokens differ from the sync "
                     "monolithic poll's (no tie)")
    out["ties"] = ties
    if out["async"]["captures"] != 1:
        fail(f"deepseek-v3 async: {out['async']['captures']} captures")
    if out["async"]["launches"]["paged_mla_attention"] <= 0:
        fail("deepseek-v3 async: no paged-MLA launch in the windows")
    print(f"  async windows of {d['readback_interval']}: "
          f"{d['requests'] - len(ties)} of {d['requests']} streams "
          f"bit-identical to the sync monolithic poll, {len(ties)} ties; "
          f"decode {out['sync']['wall_s']:.2f} s sync against "
          f"{out['async']['wall_s']:.2f} s async ({out['async']['replays']} "
          f"replays, one capture; launches a replay "
          f"{out['async']['per_replay']})")
    return out


Z2_TRACE = dict(rate=8.0, n_requests=24, slots=16, prompt_len=128,
                max_new=16, threshold=0.5, paged=True, page_size=16,
                segmented=True, prefix_share=0.25, prefix_len=64, seed=0)
Z2_LOOP = dict(requests=24, slots=8, readback_interval=8)
Z2_LAYERS = 14         # phase 9's depth cut: shared attention after 6 and
                       # 12 (2 sites), exits there too, as 12 and 24 of 38
Z2_FWD = (2, 2048)         # phase 9 (c)'s forward; its replay readings take
Z2_REPLAY = 128            # the first 128 tokens of each row, the SSD check
Z2_SSD = 512               # the first 512
SSD_TOL = 2e-2     # of max(1, |ref|): bf16 mixer outputs of two orders of
                   # fp32 arithmetic (the chunked dual and the recurrence),
                   # rounded once each; as tests/test_torch_hybrid.py
SSD_STATE_TOL = 5e-3   # of max(1, |ref|): fp32 final states summed from
                       # bf16 conv outputs (x, B) that the two paths round
                       # from taps added in another order, so some sit one
                       # bf16 ulp (2^-8 relative) apart (6.6e-4 at full
                       # width on the CPU)


def layer_kernels(torch, cfg, kind, lp, slots):
    """One decode layer of ``kind`` at ``slots`` rows: its kernel time
    under ``torch.profiler`` (the union of its device operations'
    intervals, as ``profile_decode`` reads a step's), its kernel count,
    its time between CUDA events (gaps between its kernels included) and
    its four longest kernels."""
    from repro_torch.launch import device_trace
    from repro_torch.models import blocks as B
    cache = B.init_layer_cache(cfg, kind, slots, 0, "cuda")
    x = torch.randn(slots, 1, cfg.d_model, device="cuda").bfloat16()
    keep = torch.ones(slots, dtype=torch.bool, device="cuda")

    def layer(x, cache):
        return B.decode_layer(cfg, kind, lp, x, cache, 0, 0,
                              write_mask=keep)
    event_ms = device_ms(torch, layer, [(x, cache)], iters=20)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(10):
            layer(x, cache)
        torch.cuda.synchronize()
    dev_ops = device_trace.device_ops(prof)
    top = sorted(device_trace.by_name(dev_ops).items(),
                 key=lambda kv: -kv[1]["s"])[:4]
    return {"kernel_ms": device_trace.busy_s(dev_ops) * 1e2,
            "kernels": len(dev_ops) / 10, "event_ms": event_ms,
            "top": [(n[:40], round(d["s"] * 1e2, 4)) for n, d in top]}


def sync_vs_windows(torch, ops, model, params, loop, phase):
    """A closed loop of ``loop["requests"]`` requests (prompts 16-64,
    max_new 8-24, seed 2) on ``loop["slots"]`` paged slots (an encdec
    model: contiguous ones, each request with 0.02 N(0, 1) frames), so
    slots are reused and rows finish mid-window: the sync monolithic poll,
    then windows of ``loop["readback_interval"]``.  Fails unless every
    stream is full length and equal to the sync one (a first difference
    excused only at a top-2 tie of a batch-1 replay) with one capture, and
    unless the arena holds a prefix cache exactly when every cache leaf
    is pool-backed.  Returns the summary and, per run, each slot's last
    occupant and a copy of the arena's leaves."""
    import numpy as np
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    cfg = model.cfg
    rs = np.random.RandomState(2)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(16, 65)))
               for _ in range(loop["requests"])]
    max_news = [int(rs.randint(8, 25)) for _ in range(loop["requests"])]
    paged = cfg.family != "encdec"
    frames = [None] * len(prompts)
    if not paged:
        frames = [0.02 * rs.randn(cfg.encdec.encoder_seq_len, cfg.d_model)
                  .astype(np.float32) for _ in prompts]
    out, streams, last, arenas = {}, {}, {}, {}
    for label, async_decode in (("sync", False), ("async", True)):
        sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=loop["slots"], max_len=96, prefill_chunk=16,
            exit_threshold=0.5, segmented=False, paged=paged,
            async_decode=async_decode,
            readback_interval=loop["readback_interval"]), device="cuda")
        if (sched.prefix_cache is not None) != (
                paged and model.all_cache_paged()):
            fail(f"phase {phase} (b): the arena's prefix cache is "
                 f"{sched.prefix_cache}, but every leaf pool-backed is "
                 f"{paged and model.all_cache_paged()}")
        reqs = [Request(tokens=p, max_new=n, req_id=j, frames=f)
                for j, (p, n, f) in enumerate(zip(prompts, max_news,
                                                  frames))]
        for r in reqs:
            sched.submit(r)
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        while sched.has_work:
            sched.poll()
        torch.cuda.synchronize()
        streams[label] = [list(r.out_tokens) for r in reqs]
        last[label] = {r.slot: r.req_id for r in reqs}   # admission: FIFO
        arenas[label] = [t.clone() for t in tree_leaves(sched.cache)]
        out[f"loop_{label}"] = {"wall_s": time.perf_counter() - t0,
                                "committed_steps": sched._step_idx,
                                "admitted": sched.n_admitted,
                                "launches": dict(ops.LAUNCHES),
                                "builds": sched.jit_cache_sizes()}
        if async_decode:
            w = sched._window
            out["loop_async"].update(replays=w.replays, captures=w.captures,
                                     per_replay=w.per_replay)
        del sched
    ties = []
    for j, (got, want) in enumerate(zip(streams["async"], streams["sync"])):
        if len(got) != max_news[j]:
            fail(f"phase {phase} (b) request {j}: {len(got)} tokens")
        if got == want:
            continue
        # a first difference must sit at a top-2 tie of a batch-1 replay,
        # either way round
        k, gap = tie_gap(torch, model, params, prompts[j], got, want,
                         frames[j])
        print(f"  (b) request {j} differs at token {k}: fp32 top-2 gap "
              f"{gap:.3e}")
        if not abs(gap) < LOGIT_TIE:
            fail(f"phase {phase} (b) request {j}: tokens differ (no tie)")
        ties.append({"req": j, "token": k, "gap": gap})
    out["loop_ties"] = ties
    if out["loop_async"]["captures"] != 1:
        fail(f"phase {phase} (b): {out['loop_async']['captures']} captures")
    return out, last, arenas


def run_zamba2(torch, ops, ref, results):
    """Phase 9 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import Scenario
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model
    from repro_torch.models import blocks as B
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig, ServeConfig,
                                     ServingEngine)
    t_phase = time.time()
    cfg = depth_cut(get_config("zamba2-1.2b"), Z2_LAYERS, (6, 12))
    tr = Z2_TRACE
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    slot_state = sum(t[:, 0].numel() * t.element_size() for t in tree_leaves(
        model.init_decode_cache_paged(1, 1, 16)["blocks"]))
    print(f"hybrid path: zamba2-1.2b (arXiv:2411.15242) at its published "
          f"widths, cut in depth: {cfg.num_layers} Mamba2 layers, d_model {cfg.d_model}, "
          f"state {cfg.ssm.state_size}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"shared-attention heads of {cfg.resolved_head_dim} at "
          f"{len(B.shared_attn_sites(cfg))} sites, vocab {cfg.vocab_size}, "
          f"exits after layers {cfg.exits.exit_layers}; random weights "
          f"(seed 0, {pbytes / 1e9:.2f} GB), state rows "
          f"{slot_state / 1e6:.1f} MB a slot")
    out = {"param_bytes": pbytes, "state_bytes_per_slot": slot_state}
    launches = {}

    # (a) serve_poisson, paged and segmented; live kernel inputs captured
    captured = {}
    orig = {"paged_gqa_attention": ops.paged_gqa_attention,
            "exit_head_entropy": ops.exit_head_entropy}
    calls = dict.fromkeys(orig, 0)

    def capturing(kname, every):
        def wrapper(*a, **kw):
            calls[kname] += 1
            if calls[kname] % every == 0 and kw.get("scale") is None:
                captured[kname] = tuple(
                    t.clone() if t.numel() * t.element_size() < 2 ** 26
                    else t for t in a)
            return orig[kname](*a, **kw)
        setattr(ops, kname, wrapper)
    capturing("paged_gqa_attention", 211)
    capturing("exit_head_entropy", 13)
    ops.reset_launches()
    t0 = time.time()
    st = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                       n_requests=tr["n_requests"], rate=tr["rate"],
                       slots=tr["slots"], prompt_len=tr["prompt_len"],
                       max_new=tr["max_new"], threshold=tr["threshold"],
                       paged=tr["paged"], page_size=tr["page_size"],
                       segmented=tr["segmented"],
                       prefix_share=tr["prefix_share"],
                       prefix_len=tr["prefix_len"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    for kname, fn in orig.items():
        setattr(ops, kname, fn)
    outs = st.pop("outputs")
    print(f"  (a) served {tr['n_requests']} requests at {tr['rate']} req/s, "
          f"prompts {tr['prompt_len'] // 4}-{tr['prompt_len']} tokens "
          f"({tr['prefix_share']:.2f} sharing a {tr['prefix_len']}-token "
          f"prefix), {tr['max_new']} new, {tr['slots']} slots, paged + "
          f"segmented, threshold {tr['threshold']}: {wall:.1f}s with "
          f"warm-up; {st['sustained_tok_s']:.2f} tok/s, p50 "
          f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{st['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}; launches {launches['serve']}")
    if len(outs) != tr["n_requests"] or any(
            len(o) != tr["max_new"] or not all(0 <= t < cfg.vocab_size
                                               for t in o) for o in outs):
        fail("phase 9 (a): a stream is short or out of the vocabulary")
    if st["prefix_hit_tokens"] or st["prefill_chunks_skipped"]:
        fail("phase 9 (a): a hybrid arena skipped prefill through a prefix")
    for kname in orig:
        if launches["serve"][kname] <= 0:
            fail(f"phase 9 (a): {kname} was not launched")
        if kname not in captured:
            fail(f"phase 9 (a): no live call of {kname} was captured")
    for kname, tol, plain in (
            ("paged_gqa_attention", PAGED_TOL, ref.paged_gqa_attention_ref),
            ("exit_head_entropy", ENT_TOL, ref.exit_head_entropy_ref)):
        a = captured[kname]
        got = orig[kname](*a).float()
        err = (got - plain(*a).float()).abs().max().item()
        print(f"  live {kname} {[tuple(t.shape) for t in a]}: max_abs_err "
              f"{err:.3e} (tol {tol})")
        if not torch.isfinite(got).all() or err > tol:
            fail(f"phase 9 (a): {kname} disagrees with its plain version "
                 f"on live zamba2 inputs")
        results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                            err)
    del captured
    out["serve"] = st
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=128, steps=4,
                          seed=tr["seed"], params=params)
    # the Mamba layers' share of a step's device time: one mamba decode
    # layer at 16 slots under the same profiler (the union of its kernels'
    # intervals, as profile_decode reads a step's), times the layer count;
    # and the layer's time between CUDA events, gaps between its kernels
    # included
    cell = layer_kernels(torch, cfg, "mamba",
                         tree_map(lambda t: t[0], params["blocks"][0]),
                         tr["slots"])
    layer_ms, event_ms = cell["kernel_ms"], cell["event_ms"]
    mamba_ms = layer_ms * cfg.num_layers
    share = mamba_ms / prof["device_ms_per_step"]
    print(f"  profile_decode (16 slots, 128-token prompts, 4 steps): host "
          f"wall {prof['wall_ms_per_step']:.2f} ms/step, device "
          f"{prof['device_ms_per_step']:.3f} ms/step, busy "
          f"{prof['device_busy_share'] * 100:.1f} %, "
          f"{prof['cuda_kernels_per_step']:.0f} CUDA kernels/step; one "
          f"mamba decode layer {layer_ms:.4f} ms of kernels "
          f"({cell['kernels']:.0f} kernels; {event_ms:.4f} ms between CUDA "
          f"events) x {cfg.num_layers} = {mamba_ms:.3f} ms, "
          f"{share * 100:.1f} % of the step's device time; the port's "
          f"kernels a step "
          f"{[(k['name'][:40], round(k['ms_per_step'], 4), k['calls_per_step']) for k in prof['port_kernels']]}")
    out["profile_decode"] = prof
    out["mamba_layer"] = cell
    out["mamba_share"] = share

    # (b) closed loop on 8 slots: slots reused (state rows reset), rows
    # finishing mid-window; the sync monolithic poll, then windows of 8
    lo = Z2_LOOP
    loop, _, _ = sync_vs_windows(torch, ops, model, params, lo, 9)
    out.update(loop)
    ties = loop["loop_ties"]
    launches["loop"] = out["loop_async"]["launches"]
    if out["loop_async"]["launches"]["paged_gqa_attention"] <= 0:
        fail("phase 9 (b): no paged-attention launch in the windows")
    print(f"  (b) closed loop of {lo['requests']} requests on {lo['slots']} "
          f"slots (prompts 16-64, max_new 8-24): "
          f"{lo['requests'] - len(ties)} streams bit-identical to the sync "
          f"monolithic poll, {len(ties)} ties; one capture; "
          f"{out['loop_sync']['wall_s']:.2f} s sync against "
          f"{out['loop_async']['wall_s']:.2f} s with windows of "
          f"{lo['readback_interval']} ({out['loop_async']['replays']} "
          f"replays, launches a replay {out['loop_async']['per_replay']})")

    # (c) one Model.forward over 2 x 2048 tokens, then its argmax against
    # the decode replay on the first 256 tokens of each row
    b, s = Z2_FWD
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    model.forward(params, {"tokens": toks})           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    e0.record()
    fwd = model.forward(params, {"tokens": toks})
    e1.record()
    torch.cuda.synchronize()
    launches["forward"] = dict(ops.LAUNCHES)
    dev_ms = e0.elapsed_time(e1)
    finite = bool(torch.isfinite(fwd.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in fwd.exit_logits)
    n_sites = len(B.shared_attn_sites(cfg))
    print(f"  (c) Model.forward {b} x {s} tokens: {dev_ms:.1f} ms device "
          f"(CUDA events), {b * s / dev_ms * 1e3:.0f} tokens/s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, finite "
          f"{finite}; launches {launches['forward']}")
    if not finite:
        fail("phase 9 (c): the forward's logits are not finite")
    if launches["forward"]["flash_attention"] != n_sites:
        fail(f"phase 9 (c): {launches['forward']['flash_attention']} flash "
             f"launches, not one a shared-attention site ({n_sites})")
    del fwd
    # the chunked SSD against the O(1) recurrence at full width: layer 0's
    # mixer on real normed embeddings, 2 x 512 tokens (two chunks, so the
    # scan across chunks is read); a planted fault, the second chunk run
    # without its carried state, must fail the same check
    from repro_torch.models import ssm
    from repro_torch.models.common import apply_norm
    lp0 = tree_map(lambda t: t[0], params["blocks"][0])
    xs = apply_norm(cfg.norm, model.embed_decode_tokens(
        params, toks[:, :Z2_SSD]), lp0["ln"])
    y_fwd, st_fwd = ssm.mamba2_forward(cfg, lp0["mamba"], xs)
    st, cv = ssm.init_mamba2_state(cfg, b, "cuda")
    ys = []
    for t in range(Z2_SSD):
        y, st, cv = ssm.mamba2_decode(cfg, lp0["mamba"], xs[:, t:t + 1], st,
                                      cv)
        ys.append(y)
    y_dec = torch.cat(ys, dim=1).float()

    def rel(a, w):
        return ((a.float() - w).abs() / w.abs().clamp(min=1)).max().item()
    half = Z2_SSD // 2
    y_cut, _ = ssm.mamba2_forward(cfg, lp0["mamba"], xs[:, half:])
    ssd = {"y_err": rel(y_fwd, y_dec), "state_err": rel(st_fwd, st),
           "control_err": rel(y_cut, y_dec[:, half:])}
    print(f"  (c) Mamba2 layer 0, chunked SSD vs the recurrence ({b} x "
          f"{Z2_SSD} tokens, chunks of {cfg.ssm.chunk_size}): outputs "
          f"{ssd['y_err']:.3e} of max(1, |ref|) (tol {SSD_TOL}), final state "
          f"{ssd['state_err']:.3e} (tol {SSD_STATE_TOL}); control (second "
          f"chunk without its carried state) {ssd['control_err']:.3e}, must "
          f"exceed {SSD_TOL}")
    if not (ssd["y_err"] <= SSD_TOL and ssd["state_err"] <= SSD_STATE_TOL):
        fail("phase 9 (c): the chunked SSD disagrees with the recurrence")
    if not ssd["control_err"] > SSD_TOL:
        fail("phase 9 (c): the SSD check passes a planted fault")
    del xs, y_fwd, y_dec, y_cut, ys
    # the forward against the decode replay, measured on an fp32 forward:
    # reported, not gated (at 38 random-weight Mamba2 layers every bf16
    # path sits far from the fp32 forward, and a planted attention fault
    # reads the same; PERF.md, PR 20)
    small = {"tokens": toks[:, :Z2_REPLAY]}
    got = model.forward(params, small).logits
    replay, _ = model.prefill(params, small)
    kernel = ops.flash_attention
    ops.flash_attention = (lambda q, k, v, causal=True, window=0:
                           ref.flash_attention_ref(q, k, v, causal=causal,
                                                   window=window))
    exact = model.forward(tree_map(lambda t: t.float(), params),
                          small).logits
    ops.flash_attention = kernel
    a_f, a_r = got.argmax(-1), replay.argmax(-1)
    gap = (exact.gather(-1, a_f[..., None])
           - exact.gather(-1, a_r[..., None])).abs()[..., 0]
    flips = int((a_f != a_r).sum())
    hard = int((gap >= REPLAY_TIE).sum())
    max_diff = (got - replay).abs().max().item()
    dev_f = (got - exact).abs().mean().item()
    dev_r = (replay - exact).abs().mean().item()
    print(f"  (c) forward vs decode replay ({b} x {Z2_REPLAY} tokens): "
          f"logits max abs diff {max_diff:.3e}; argmax differs at {flips} "
          f"of {a_f.numel()} positions, {hard} at fp32 gaps >= "
          f"{REPLAY_TIE}; mean deviation from the fp32 forward {dev_f:.4f} "
          f"(forward) and {dev_r:.4f} (replay), ratio {dev_f / dev_r:.3f}")
    if not (math.isfinite(max_diff) and torch.isfinite(exact).all()):
        fail("phase 9 (c): the replay or the fp32 forward is not finite")
    out["forward"] = {"tokens": b * s, "device_ms": dev_ms, "ssd": ssd,
                      "replay_max_diff": max_diff, "flips": flips,
                      "hard_flips": hard, "dev_forward": dev_f,
                      "dev_replay": dev_r}
    del got, replay, exact

    # (d) the engine: generate == a scheduler run, tiered == single pool,
    # and an adaptive async engine keeps one capture
    prompts = np.random.RandomState(3).randint(0, cfg.vocab_size, (8, 64))
    eng = ServingEngine(model, params, ServeConfig(exit_threshold=0.5))
    ops.reset_launches()
    gen = eng.generate(prompts, max_new=16)
    launches["engine"] = dict(ops.LAUNCHES)
    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=8, max_len=80, exit_threshold=0.5), device="cuda")
    reqs = [Request(tokens=p, max_new=16) for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.run()
    if gen.tolist() != [r.out_tokens for r in reqs]:
        fail("phase 9 (d): ServingEngine.generate differs from the "
             "scheduler on the same prompts")
    del sched
    # the tiered engine: each row is served whole by one tier's pool (the
    # raw handoff keeps a migrated row's bits), so it must equal, bit for
    # bit, a dedicated scheduler of that pool's shape fed the same rows.
    # Against the single pool (8 slots of 80) it is compared too: pools of
    # other shapes take other cuBLAS kernels, whose sums differ in the
    # last bit, and 38 bf16 Mamba2 layers amplify that (PERF.md, PR 20)
    tiered = ServingEngine(model, params, ServeConfig(exit_threshold=0.5),
                           scenario=Scenario.default())
    cl = tiered._ensure_cluster(64 + 16)
    served = []
    clear = cl.clear_completed

    def recording_clear():
        served.extend(cr for cr in cl.requests if cr.done)
        clear()
    cl.clear_completed = recording_clear
    got = tiered.generate(prompts, max_new=16)      # served: row order
    if len(served) != 8 or any(cr.req.out_tokens != g for cr, g in
                               zip(served, got.tolist())):
        fail("phase 9 (d): the tiered engine did not serve every row")
    same_single = sum(a == b for a, b in zip(got.tolist(), gen.tolist()))
    per_tier = {}
    for cr in served:
        if cr.migrations or cr.final_tier != cr.decision.tier:
            fail("phase 9 (d): a row migrated; its pool shape is not one")
        per_tier.setdefault(cr.final_tier, []).append(cr)
    for tier, crs in per_tier.items():
        ded = ContinuousBatchScheduler(model, params, cl.tiers[tier].sched.cfg,
                                       device="cuda")
        reqs = [Request(tokens=np.asarray(cr.req.tokens), max_new=16)
                for cr in crs]
        for r in reqs:
            ded.submit(r)
        ded.run()
        if [r.out_tokens for r in reqs] != [cr.req.out_tokens for cr in crs]:
            fail(f"phase 9 (d): the tiered engine's {tier} rows differ from "
                 f"a dedicated pool of that tier's shape")
        del ded
    shapes = {t: (cl.tiers[t].sched.cfg.n_slots, cl.cfg.max_len)
              for t in per_tier}
    ada = ServingEngine(model, params, ServeConfig(
        exit_threshold=0.5, async_decode=True, readback_interval=8))
    ada.enable_adaptive(0.01, update_every=4)
    got_a = ada.generate(prompts, max_new=16)
    builds = next(iter(ada._scheds.values())).jit_cache_sizes()
    thr = ada.controller.threshold
    print(f"  (d) ServingEngine.generate 8 x 64 prompts, 16 new: equal to "
          f"the scheduler bit for bit; tiered (Scenario.default, raw "
          f"handoff, routes {tiered.route_counts}, pools (slots, max_len) "
          f"{shapes}): every row equal to a dedicated pool of its tier's "
          f"shape, {same_single} of 8 rows equal to the single pool; "
          f"adaptive async engine: threshold 0.5 -> {thr:.4f}, builds "
          f"{builds}, tokens equal to the segmented engine's: "
          f"{got_a.tolist() == gen.tolist()}; exit stats "
          f"{ada.exit_stats()}")
    if not thr > 0.5 or builds != {"decode_window": 1}:
        fail("phase 9 (d): the adaptive threshold did not move up with one "
             "capture")
    out["engine"] = {"routes": tiered.route_counts, "tier_shapes": shapes,
                     "tiered_rows_equal_single_pool": same_single,
                     "threshold": thr,
                     "builds": builds,
                     "async_equals_sync": got_a.tolist() == gen.tolist()}
    del eng, tiered, cl, ada, model, params
    out["wall_s"] = time.time() - t_phase
    print(f"phase 9 wall time {out['wall_s']:.1f}s")
    return out, launches


XL_TRACE = dict(rate=8.0, n_requests=16, slots=16, prompt_len=96,
                max_new=16, threshold=0.5, paged=True, page_size=16,
                segmented=True, prefix_share=0.25, prefix_len=32, seed=0)
XL_LOOP = dict(requests=16, slots=8, readback_interval=8)
XL_LAYERS = 12         # phase 10's depth cut: sLSTM at 5 and 11, exits
                       # after 4 and 8 (of 24: sLSTM at 5, 11, 17, 23)
XL_FWD = (2, 2048)         # phase 10 (c)'s forward (8 chunks of 256)
XL_GATE = 512              # the mLSTM gate's tokens a row (two chunks)
MLSTM_TOL = 2e-2   # of max(1, |ref|): bf16 cell outputs of the chunked
                   # dual and of the recurrence, rounded once each; the
                   # reference's own test (tests/test_model_units.py)
MLSTM_STATE_TOL = 5e-3   # of max(1, |ref|): the final fp32 C and n, summed
                         # from bf16 k and v that the two paths' GEMMs (M
                         # 1024 and M 2) round one ulp apart here and there
                         # (5.1e-4 / 1.8e-4 at full width on the CPU)
XL_MIGRATE = dict(requests=4, slots=16, max_len=128, max_new=24, polls=10)


def run_xlstm(torch, ops, ref, results):
    """Phase 10 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model, xlstm
    from repro_torch.models.common import apply_norm, tree_leaves, tree_map
    t_phase = time.time()
    cfg = depth_cut(get_config("xlstm-350m"), XL_LAYERS, (4, 8))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, slstm_layers=(5, 11)))
    tr = XL_TRACE
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    kinds = model.scan_block_kinds()
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    slot_state = sum(t[:, 0].numel() * t.element_size() for t in tree_leaves(
        model.init_decode_cache_paged(1, 1, 16)["blocks"]))
    _, d_in, heads, p = xlstm._dims(cfg)
    n_m = sum(s[2] for s in model.plan if s[0] == "scan" and s[1] == "mlstm")
    print(f"xLSTM path: xlstm-350m (arXiv:2405.04517) at its published "
          f"widths, cut in depth: {cfg.num_layers} layers ({n_m} mLSTM, sLSTM at "
          f"{cfg.ssm.slstm_layers}), d_model {cfg.d_model}, {heads} heads "
          f"of {p} (d_in {d_in}), vocab {cfg.vocab_size}, exits after "
          f"layers {cfg.exits.exit_layers}; random weights (seed 0, "
          f"{pbytes / 1e9:.2f} GB), state rows {slot_state / 2 ** 20:.1f} "
          f"MiB a slot, no attention and no pool")
    out = {"param_bytes": pbytes, "state_bytes_per_slot": slot_state}
    launches = {}

    # (a) serve_poisson, paged and segmented; live exit-head inputs
    captured = {}
    weights = set()
    kernel = ops.exit_head_entropy
    calls = [0]

    def capturing(x, w):
        calls[0] += 1
        weights.add(w.data_ptr())
        if calls[0] % 13 == 0:
            captured[w.data_ptr()] = (x.clone(), w)
        return kernel(x, w)
    ops.exit_head_entropy = capturing
    ops.reset_launches()
    t0 = time.time()
    st = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                       n_requests=tr["n_requests"], rate=tr["rate"],
                       slots=tr["slots"], prompt_len=tr["prompt_len"],
                       max_new=tr["max_new"], threshold=tr["threshold"],
                       paged=tr["paged"], page_size=tr["page_size"],
                       segmented=tr["segmented"],
                       prefix_share=tr["prefix_share"],
                       prefix_len=tr["prefix_len"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    ops.exit_head_entropy = kernel
    outs = st.pop("outputs")
    print(f"  (a) served {tr['n_requests']} requests at {tr['rate']} req/s, "
          f"prompts {tr['prompt_len'] // 4}-{tr['prompt_len']} tokens "
          f"({tr['prefix_share']:.2f} sharing a {tr['prefix_len']}-token "
          f"prefix), {tr['max_new']} new, {tr['slots']} slots, paged + "
          f"segmented, threshold {tr['threshold']}: {wall:.1f}s with "
          f"warm-up; {st['sustained_tok_s']:.2f} tok/s, p50 "
          f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{st['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}; launches {launches['serve']}")
    if len(outs) != tr["n_requests"] or any(
            len(o) != tr["max_new"] or not all(0 <= t < cfg.vocab_size
                                               for t in o) for o in outs):
        fail("phase 10 (a): a stream is short or out of the vocabulary")
    if st["prefix_hit_tokens"] or st["prefill_chunks_skipped"]:
        fail("phase 10 (a): an xLSTM arena skipped prefill through a prefix")
    if launches["serve"]["exit_head_entropy"] <= 0 \
            or len(weights) != model.n_exits:
        fail(f"phase 10 (a): {launches['serve']['exit_head_entropy']} "
             f"exit-head launches over {len(weights)} heads, not both")
    if len(captured) != model.n_exits:
        fail("phase 10 (a): no live call of each exit probe was captured")
    for x, w in captured.values():
        got = kernel(x, w).float()
        err = (got - ref.exit_head_entropy_ref(x, w).float()).abs().max() \
            .item()
        print(f"  live exit_head_entropy [{tuple(x.shape)}, "
              f"{tuple(w.shape)}]: max_abs_err {err:.3e} (tol {ENT_TOL})")
        if not torch.isfinite(got).all() or err > ENT_TOL:
            fail("phase 10 (a): exit_head_entropy disagrees with its plain "
                 "version on live xLSTM inputs")
        results["exit_head_entropy"]["max_abs_err"] = max(
            results["exit_head_entropy"]["max_abs_err"], err)
    del captured
    out["serve"] = st
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=64, steps=4,
                          seed=tr["seed"], params=params)
    # each cell kind's share of a step's device time: one decode layer of
    # it at 16 slots, times its layer count
    cells = {}
    for kind in ("mlstm", "slstm"):
        lp = tree_map(lambda t: t[0], params["blocks"][kinds.index(kind)])
        cells[kind] = layer_kernels(torch, cfg, kind, lp, tr["slots"])
        cells[kind]["layers"] = sum(s[2] for s in model.plan
                                    if s[0] == "scan" and s[1] == kind)
        cells[kind]["share"] = (cells[kind]["kernel_ms"]
                                * cells[kind]["layers"]
                                / prof["device_ms_per_step"])
    print(f"  profile_decode (16 slots, 64-token prompts, 4 steps): host "
          f"wall {prof['wall_ms_per_step']:.2f} ms/step, device "
          f"{prof['device_ms_per_step']:.3f} ms/step, busy "
          f"{prof['device_busy_share'] * 100:.1f} %, "
          f"{prof['cuda_kernels_per_step']:.0f} CUDA kernels/step; the "
          f"port's kernels a step "
          f"{[(k['name'][:40], round(k['ms_per_step'], 4), k['calls_per_step']) for k in prof['port_kernels']]}")
    for kind, c in cells.items():
        print(f"  one {kind} decode layer at 16 slots: {c['kernel_ms']:.4f} "
              f"ms of kernels ({c['kernels']:.0f} kernels; "
              f"{c['event_ms']:.4f} ms between CUDA events) x "
              f"{c['layers']} = {c['kernel_ms'] * c['layers']:.3f} ms, "
              f"{c['share'] * 100:.1f} % of the step's device time; top "
              f"{c['top']}")
    out["profile_decode"] = prof
    out["cells"] = cells

    # (b) closed loop on 8 slots: slots reused (state rows zeroed), rows
    # finishing mid-window; the sync monolithic poll, then windows of 8
    lo = XL_LOOP
    loop, last, arenas = sync_vs_windows(torch, ops, model, params, lo, 10)
    out.update(loop)
    ties = loop["loop_ties"]
    launches["loop"] = out["loop_async"]["launches"]
    # the graph stores the state rows: with equal streams, a request that
    # is its slot's last occupant in both runs ends with the same state
    # rows bit for bit (the windows free slots at other polls, so the
    # same request may sit in another slot)
    slot_of = {lab: {j: sl for sl, j in m.items()} for lab, m in last.items()}
    finals = sorted(set(slot_of["sync"]) & set(slot_of["async"]))
    same_state = bool(finals) and all(
        bits_equal(torch, a[:, slot_of["sync"][j]], b[:, slot_of["async"][j]])
        for j in finals for a, b in zip(arenas["sync"], arenas["async"]))
    if not ties and not same_state:
        fail("phase 10 (b): the windows' state rows differ from the sync "
             "poll's")
    out["loop_state_equal"] = same_state
    del arenas
    prof_w = profile_decode(cfg, slots=lo["slots"], prompt_len=64, steps=8,
                            seed=tr["seed"], params=params,
                            async_decode=True,
                            readback_interval=lo["readback_interval"])
    prof_s = profile_decode(cfg, slots=lo["slots"], prompt_len=64, steps=4,
                            seed=tr["seed"], params=params)
    out["profile_windows"] = {"sync": prof_s, "windows": prof_w}
    print(f"  (b) closed loop of {lo['requests']} requests on {lo['slots']} "
          f"slots (prompts 16-64, max_new 8-24): "
          f"{lo['requests'] - len(ties)} streams bit-identical to the sync "
          f"monolithic poll, {len(ties)} ties; one capture; the state rows "
          f"of {len(finals)} last occupants equal the sync poll's: "
          f"{same_state}; "
          f"{out['loop_sync']['wall_s']:.2f} s sync against "
          f"{out['loop_async']['wall_s']:.2f} s with windows of "
          f"{lo['readback_interval']} ({out['loop_async']['replays']} "
          f"replays, launches a replay {out['loop_async']['per_replay']}); "
          f"profile_decode at {lo['slots']} slots: sync step "
          f"{prof_s['wall_ms_per_step']:.2f} ms host, "
          f"{prof_s['device_ms_per_step']:.3f} ms device "
          f"({prof_s['device_busy_share'] * 100:.1f} % busy, "
          f"{prof_s['cuda_kernels_per_step']:.0f} kernels), windowed step "
          f"{prof_w['wall_ms_per_step']:.2f} ms host, "
          f"{prof_w['device_ms_per_step']:.3f} ms device "
          f"({prof_w['device_busy_share'] * 100:.1f} % busy)")

    # (c) one Model.forward over 2 x 2048 tokens (8 chunks of 256; the
    # sLSTM layers step 2048 times each)
    b, s = XL_FWD
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    model.forward(params, {"tokens": toks[:, :512]})   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    fwd = model.forward(params, {"tokens": toks})
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches["forward"] = dict(ops.LAUNCHES)
    dev_ms = e0.elapsed_time(e1)
    finite = bool(torch.isfinite(fwd.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in fwd.exit_logits)
    peak = torch.cuda.max_memory_allocated()
    print(f"  (c) Model.forward {b} x {s} tokens: {dev_ms:.1f} ms between "
          f"CUDA events ({host_s:.2f} s host), "
          f"{b * s / dev_ms * 1e3:.0f} tokens/s, peak {peak / 1e9:.2f} GB, "
          f"logits {tuple(fwd.logits.shape)}, {len(fwd.exit_logits)} exit "
          f"logits, finite {finite}; launches {launches['forward']}")
    if not finite or tuple(fwd.logits.shape) != (b, s, cfg.vocab_size) \
            or len(fwd.exit_logits) != model.n_exits:
        fail("phase 10 (c): the forward's logits are not finite or "
             "misshapen")
    if any(launches["forward"].values()):
        fail("phase 10 (c): the xLSTM forward launched a port kernel")
    del fwd
    # the chunked mLSTM against its recurrence at full width: layer 0's
    # cell on real normed embeddings, 2 x 512 tokens (two chunks, so the
    # loop across chunks is read); a planted fault, the second chunk run
    # without its carried state, must fail the same check
    lp0 = tree_map(lambda t: t[0], params["blocks"][0])
    xs = apply_norm(cfg.norm, model.embed_decode_tokens(
        params, toks[:, :XL_GATE]), lp0["ln"])
    y_fwd, (c_fwd, n_fwd) = xlstm.mlstm_forward(cfg, lp0["mlstm"], xs)
    state = xlstm.init_mlstm_state(cfg, b, "cuda")
    ys = []
    for t in range(XL_GATE):
        y, state = xlstm.mlstm_decode(cfg, lp0["mlstm"], xs[:, t:t + 1],
                                      state)
        ys.append(y)
    y_dec = torch.cat(ys, dim=1).float()

    def rel(a, w):
        return ((a.float() - w).abs() / w.abs().clamp(min=1)).max().item()
    half = XL_GATE // 2
    y_cut, _ = xlstm.mlstm_forward(cfg, lp0["mlstm"], xs[:, half:])
    gate = {"y_err": rel(y_fwd, y_dec), "c_err": rel(c_fwd, state[0]),
            "n_err": rel(n_fwd, state[1]),
            "control_err": rel(y_cut, y_dec[:, half:])}
    print(f"  (c) mLSTM layer 0, chunked dual vs the recurrence ({b} x "
          f"{XL_GATE} tokens, chunks of {cfg.ssm.chunk_size}): outputs "
          f"{gate['y_err']:.3e} of max(1, |ref|) (tol {MLSTM_TOL}), final C "
          f"{gate['c_err']:.3e} and n {gate['n_err']:.3e} (tol "
          f"{MLSTM_STATE_TOL}); control (second chunk without its carried "
          f"state) {gate['control_err']:.3e}, must exceed {MLSTM_TOL}")
    if not (gate["y_err"] <= MLSTM_TOL and gate["c_err"] <= MLSTM_STATE_TOL
            and gate["n_err"] <= MLSTM_STATE_TOL):
        fail("phase 10 (c): the chunked mLSTM disagrees with the recurrence")
    if not gate["control_err"] > MLSTM_TOL:
        fail("phase 10 (c): the mLSTM check passes a planted fault")
    out["forward"] = {"tokens": b * s, "event_ms": dev_ms, "host_s": host_s,
                      "peak_bytes": peak, "gate": gate}
    del xs, y_fwd, y_dec, y_cut, ys, state, c_fwd, n_fwd

    # (d) a live slot migrated between two 16-slot paged arenas, raw and
    # int8
    out["migrate"], launches["migrate"] = migrate_live_slot(
        torch, ops, ref, model, params, XL_MIGRATE, 10)
    del model, params
    out["wall_s"] = time.time() - t_phase
    print(f"phase 10 wall time {out['wall_s']:.1f}s")
    return out, launches


QV_TRACE = dict(rate=8.0, n_requests=12, slots=16, prompt_len=96,
                max_new=12, threshold=0.5, paged=True, page_size=16,
                segmented=True, prefix_share=0.25, prefix_len=32, seed=0)
QV_LOOP = dict(requests=12, slots=8, readback_interval=8)
QV_LAYERS = 10         # phase 11's depth cut (exits after 3 and 6)
QV_FWD = (2, 2048)         # phase 11 (c)'s forward
QV_PATCHES = 1024          # ... of which the patch positions a row


def live_capture(torch, ops, names, every):
    """Wrap the kernels ``names`` of ``ops`` so that the first and then
    every ``every``-th call of each kind keeps a copy of its small inputs
    (kinds: each exit head's weight; flash's causal flag and lengths; one
    for paged GQA).  Returns (captured {key: (args, kwargs)}, the
    unwrapped kernels, restore())."""
    orig = {n: getattr(ops, n) for n in names}
    captured, calls = {}, {}

    def kind(name, a, kw):
        if name in ("exit_head_entropy", "w8a8_expert_matmul"):
            return a[1 if name == "exit_head_entropy" else 2].data_ptr()
        if name == "flash_attention":
            return (kw.get("causal", True), a[0].shape[1], a[1].shape[1])
        return 0

    def wrap(name):
        def call(*a, **kw):
            key = (name, kind(name, a, kw))
            calls[key] = calls.get(key, 0) + 1
            if calls[key] % every == 1 or every == 1:
                captured[key] = (tuple(
                    t.clone() if t.numel() * t.element_size() < 2 ** 26
                    else t for t in a), kw)
            return orig[name](*a, **kw)
        return call
    for n in names:
        setattr(ops, n, wrap(n))

    def restore():
        for n in names:
            setattr(ops, n, orig[n])
    return captured, orig, restore


def hold_live(torch, ref, captured, orig, results, phase):
    """Each captured live call against its plain version: paged GQA within
    PAGED_TOL, the exit probe within ENT_TOL, flash within FLASH_TOL of
    max(1, |plain|), the W8A8 expert GEMM bit for bit.  Returns {name:
    [shapes, ...]}."""
    plain = {"paged_gqa_attention": (ref.paged_gqa_attention_ref, PAGED_TOL),
             "exit_head_entropy": (ref.exit_head_entropy_ref, ENT_TOL),
             "flash_attention": (ref.flash_attention_ref, FLASH_TOL),
             "w8a8_expert_matmul": (ref.w8a8_expert_matmul_ref, 0.0)}
    seen = {}
    for (name, _), (a, kw) in captured.items():
        fn, tol = plain[name]
        got = orig[name](*a, **kw).float()
        want = fn(*a, **kw).float()
        diff = (got - want).abs()
        err = diff.max().item()
        scaled = err
        if name == "flash_attention":
            scaled = (diff / want.abs().clamp(min=1)).max().item()
        shapes = [list(t.shape) for t in a]
        of = (f", of max(1, |plain|) {scaled:.3e}"
              if name == "flash_attention" else "")
        print(f"  live {name} {shapes} {kw}: max_abs_err {err:.3e}{of} "
              f"(tol {tol})")
        if name == "w8a8_expert_matmul" and not bits_equal(torch, got, want):
            scaled = float("inf")
        if not torch.isfinite(got).all() or not scaled <= tol:
            fail(f"phase {phase}: {name} disagrees with its plain version "
                 f"on live inputs {shapes}")
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           err)
        seen.setdefault(name, []).append(shapes)
    return seen


def run_qwen2_vl(torch, ops, ref, results):
    """Phase 11 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves
    t_phase = time.time()
    cfg = depth_cut(get_config("qwen2-vl-2b"), QV_LAYERS, (3, 6))
    tr = QV_TRACE
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"vision-language path: qwen2-vl-2b (arXiv:2409.12191) at its "
          f"published widths, cut in depth: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim} (G {cfg.num_heads // cfg.num_kv_heads}),"
          f" vocab {cfg.vocab_size}, M-RoPE, exits after layers "
          f"{cfg.exits.exit_layers}; random weights (seed 0, "
          f"{pbytes / 1e9:.2f} GB)")
    out = {"param_bytes": pbytes}
    launches = {}

    # (a) serve_poisson, paged and segmented; live kernel inputs
    captured, orig, restore = live_capture(
        torch, ops, ("paged_gqa_attention", "exit_head_entropy"), 97)
    ops.reset_launches()
    t0 = time.time()
    st = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                       n_requests=tr["n_requests"], rate=tr["rate"],
                       slots=tr["slots"], prompt_len=tr["prompt_len"],
                       max_new=tr["max_new"], threshold=tr["threshold"],
                       paged=tr["paged"], page_size=tr["page_size"],
                       segmented=tr["segmented"],
                       prefix_share=tr["prefix_share"],
                       prefix_len=tr["prefix_len"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    restore()
    outs = st.pop("outputs")
    print(f"  (a) served {tr['n_requests']} requests at {tr['rate']} req/s, "
          f"prompts {tr['prompt_len'] // 4}-{tr['prompt_len']} tokens "
          f"({tr['prefix_share']:.2f} sharing a {tr['prefix_len']}-token "
          f"prefix), {tr['max_new']} new, {tr['slots']} slots, paged + "
          f"segmented: {wall:.1f}s with warm-up; "
          f"{st['sustained_tok_s']:.2f} tok/s, p50 "
          f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{st['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}; launches {launches['serve']}")
    if len(outs) != tr["n_requests"] or any(
            len(o) != tr["max_new"] or not all(0 <= t < cfg.vocab_size
                                               for t in o) for o in outs):
        fail("phase 11 (a): a stream is short or out of the vocabulary")
    for kname in ("paged_gqa_attention", "exit_head_entropy"):
        if launches["serve"][kname] <= 0:
            fail(f"phase 11 (a): {kname} was not launched")
    out["live"] = hold_live(torch, ref, captured, orig, results, "11 (a)")
    if len(out["live"].get("exit_head_entropy", [])) != model.n_exits or \
            "paged_gqa_attention" not in out["live"]:
        fail("phase 11 (a): no live call of each kernel was captured")
    del captured
    out["serve"] = st
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=64, steps=4,
                          seed=tr["seed"], params=params)
    out["profile_decode"] = prof
    print_profile(prof, "16 slots, 64-token prompts, 4 steps")

    # (b) closed loop on 8 slots: sync monolithic, then windows of 8
    loop, _, _ = sync_vs_windows(torch, ops, model, params, QV_LOOP, 11)
    out.update(loop)
    launches["loop"] = out["loop_async"]["launches"]
    print(f"  (b) closed loop of {QV_LOOP['requests']} requests on "
          f"{QV_LOOP['slots']} paged slots (prompts 16-64, max_new 8-24): "
          f"{QV_LOOP['requests'] - len(loop['loop_ties'])} streams "
          f"bit-identical to the sync monolithic poll, "
          f"{len(loop['loop_ties'])} ties; one capture; "
          f"{out['loop_sync']['wall_s']:.2f} s sync against "
          f"{out['loop_async']['wall_s']:.2f} s with windows of "
          f"{QV_LOOP['readback_interval']} (launches a replay "
          f"{out['loop_async']['per_replay']})")

    # (c) Model.forward on 2 x 2048 tokens, the first 1,024 of each row
    # 0.02 N(0, 1) patch embeddings (a 32 x 32 M-RoPE grid)
    b, s = QV_FWD
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                                     generator=g),
             "patch_embeds": (0.02 * torch.randn(
                 b, QV_PATCHES, cfg.d_model, device="cuda", generator=g))
             .bfloat16()}
    model.forward(params, {"tokens": batch["tokens"][:, :256],
                           "patch_embeds": batch["patch_embeds"][:, :64]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, orig, restore = live_capture(torch, ops, ("flash_attention",),
                                           cfg.num_layers)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    fwd = model.forward(params, batch)
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches["forward"] = dict(ops.LAUNCHES)
    restore()
    dev_ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(fwd.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in fwd.exit_logits)
    print(f"  (c) Model.forward {b} x {s} tokens ({QV_PATCHES} patch "
          f"positions a row): {dev_ms:.1f} ms between CUDA events "
          f"({host_s:.2f} s host), {b * s / dev_ms * 1e3:.0f} tokens/s, peak "
          f"{peak / 1e9:.2f} GB, logits {tuple(fwd.logits.shape)}, "
          f"{len(fwd.exit_logits)} exit logits, finite {finite}; launches "
          f"{launches['forward']}")
    if not finite or tuple(fwd.logits.shape) != (b, s, cfg.vocab_size) \
            or len(fwd.exit_logits) != model.n_exits:
        fail("phase 11 (c): the forward's logits are not finite or "
             "misshapen")
    if launches["forward"]["flash_attention"] != cfg.num_layers:
        fail(f"phase 11 (c): {launches['forward']['flash_attention']} flash "
             f"launches, not {cfg.num_layers}")
    del fwd
    live = hold_live(torch, ref, captured, orig, results, "11 (c)")
    out["forward"] = {"tokens": b * s, "patches": QV_PATCHES,
                      "event_ms": dev_ms, "host_s": host_s,
                      "tokens_s": b * s / dev_ms * 1e3, "peak_bytes": peak,
                      "live_flash": live.get("flash_attention")}
    del model, params, captured, batch
    out["wall_s"] = time.time() - t_phase
    print(f"phase 11 wall time {out['wall_s']:.1f}s")
    return out, launches


def print_profile(prof, label):
    print(f"  profile_decode ({label}): host wall "
          f"{prof['wall_ms_per_step']:.2f} ms/step, device "
          f"{prof['device_ms_per_step']:.3f} ms/step, busy "
          f"{prof['device_busy_share'] * 100:.1f} %, "
          f"{prof['cuda_kernels_per_step']:.0f} CUDA kernels/step; the "
          f"port's kernels a step "
          f"{[(k['name'][:40], round(k['ms_per_step'], 4), k['calls_per_step']) for k in prof['port_kernels']]}")


WH_TRACE = dict(rate=8.0, n_requests=16, slots=16, prompt_len=64,
                max_new=16, threshold=0.5, segmented=True, seed=0)
WH_LOOP = dict(requests=16, slots=8, readback_interval=8)
WH_FWD = (16, 448)         # phase 12 (c): 16 rows of 448 decoder tokens
WH_MIGRATE = dict(requests=4, slots=16, max_len=128, max_new=24, polls=10)
WH_BATCH = (8, 32, 16)     # phase 12 (e): prompts, prompt length, max_new


def run_whisper(torch, ops, ref, results):
    """Phase 12 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import draw_frames, serve, serve_poisson
    from repro_torch.models import Model
    from repro_torch.models.common import tree_leaves
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    t_phase = time.time()
    cfg = get_config("whisper-base")
    tr = WH_TRACE
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    ec = cfg.encdec
    cross_bytes = 2 * cfg.num_layers * ec.encoder_seq_len * cfg.d_model * 2
    print(f"encoder-decoder path: whisper-base (arXiv:2212.04356) at its "
          f"published widths, nothing cut: {ec.num_encoder_layers} encoder "
          f"+ {cfg.num_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads of {cfg.resolved_head_dim}, "
          f"{ec.encoder_seq_len} frames, vocab {cfg.vocab_size}, exits "
          f"after layers {cfg.exits.exit_layers}; random weights (seed 0, "
          f"{pbytes / 1e6:.0f} MB), cross rows "
          f"{cross_bytes / 2 ** 20:.1f} MiB a slot, contiguous arenas")
    out = {"param_bytes": pbytes, "cross_bytes_per_slot": cross_bytes}
    launches = {}

    # (a) serve_poisson on the contiguous arena, segmented; each admission
    # encodes its slots' frames (flash without a mask at 16 x 1,500)
    captured, orig, restore = live_capture(
        torch, ops, ("exit_head_entropy", "flash_attention"), 13)
    ops.reset_launches()
    t0 = time.time()
    st = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                       n_requests=tr["n_requests"], rate=tr["rate"],
                       slots=tr["slots"], prompt_len=tr["prompt_len"],
                       max_new=tr["max_new"], threshold=tr["threshold"],
                       segmented=tr["segmented"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    restore()
    outs = st.pop("outputs")
    print(f"  (a) served {tr['n_requests']} requests with frames at "
          f"{tr['rate']} req/s, prompts {tr['prompt_len'] // 4}-"
          f"{tr['prompt_len']} tokens, {tr['max_new']} new, {tr['slots']} "
          f"contiguous slots, segmented: {wall:.1f}s with warm-up; "
          f"{st['sustained_tok_s']:.2f} tok/s, p50 "
          f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{st['makespan_s']:.2f} s; launches {launches['serve']}")
    if len(outs) != tr["n_requests"] or any(
            len(o) != tr["max_new"] or not all(0 <= t < cfg.vocab_size
                                               for t in o) for o in outs):
        fail("phase 12 (a): a stream is short or out of the vocabulary")
    if launches["serve"]["exit_head_entropy"] <= 0 \
            or launches["serve"]["flash_attention"] <= 0 \
            or launches["serve"]["paged_gqa_attention"]:
        fail(f"phase 12 (a): launches {launches['serve']}: the exit probe "
             f"and the encoder's flash must launch, paged GQA must not")
    out["live"] = hold_live(torch, ref, captured, orig, results, "12 (a)")
    if len(out["live"].get("exit_head_entropy", [])) != model.n_exits or \
            "flash_attention" not in out["live"]:
        fail("phase 12 (a): no live call of each kernel was captured")
    del captured
    out["serve"] = st
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=64, steps=4,
                          seed=tr["seed"], params=params)
    out["profile_decode"] = prof
    print_profile(prof, "16 contiguous slots, 64-token prompts, 4 steps")

    # (b) closed loop on 8 contiguous slots, slots re-admitted with other
    # frames after the capture: sync monolithic, then windows of 8
    loop, last, arenas = sync_vs_windows(torch, ops, model, params,
                                         WH_LOOP, 12)
    out.update(loop)
    ties = loop["loop_ties"]
    launches["loop"] = out["loop_async"]["launches"]
    # a request that is its slot's last occupant in both runs ends with
    # the same cross rows bit for bit (primed from its frames, the rows
    # encoded alone), whichever slot it sat in
    slot_of = {lab: {j: sl for sl, j in m.items()} for lab, m in last.items()}
    finals = sorted(set(slot_of["sync"]) & set(slot_of["async"]))
    leaves = tree_leaves(model.init_decode_cache(1, 1, device="meta"))
    cross = [i for i, t in enumerate(leaves)
             if t.shape[2] == ec.encoder_seq_len]
    same_cross = bool(finals) and all(
        bits_equal(torch, arenas["sync"][i][:, slot_of["sync"][j]],
                   arenas["async"][i][:, slot_of["async"][j]])
        for j in finals for i in cross)
    readmitted = WH_LOOP["requests"] - WH_LOOP["slots"]
    if not ties and not same_cross:
        fail("phase 12 (b): the windows' cross rows differ from the sync "
             "poll's")
    out["loop_cross_equal"] = same_cross
    del arenas
    print(f"  (b) closed loop of {WH_LOOP['requests']} requests on "
          f"{WH_LOOP['slots']} contiguous slots ({readmitted} admitted into "
          f"freed slots after the capture; prompts 16-64, max_new 8-24): "
          f"{WH_LOOP['requests'] - len(ties)} streams bit-identical to the "
          f"sync monolithic poll, {len(ties)} ties; one capture; the cross "
          f"rows of {len(finals)} last occupants equal the sync poll's: "
          f"{same_cross}; {out['loop_sync']['wall_s']:.2f} s sync against "
          f"{out['loop_async']['wall_s']:.2f} s with windows of "
          f"{WH_LOOP['readback_interval']} (launches a replay "
          f"{out['loop_async']['per_replay']})")

    # (c) Model.forward: 16 rows of 1,500 frames through the encoder and
    # 448 decoder tokens (whisper's decoder context)
    b, s = WH_FWD
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                                     generator=g),
             "frames": (0.02 * torch.randn(b, ec.encoder_seq_len,
                                           cfg.d_model, device="cuda",
                                           generator=g)).bfloat16()}
    model.forward(params, {"tokens": batch["tokens"][:2, :64],
                           "frames": batch["frames"][:2]})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, orig, restore = live_capture(torch, ops, ("flash_attention",),
                                           1)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    fwd = model.forward(params, batch)
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches["forward"] = dict(ops.LAUNCHES)
    restore()
    dev_ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(fwd.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in fwd.exit_logits)
    n_flash = ec.num_encoder_layers + 2 * cfg.num_layers
    print(f"  (c) Model.forward {b} x {s} tokens over {b} x "
          f"{ec.encoder_seq_len} frames: {dev_ms:.1f} ms between CUDA "
          f"events ({host_s:.2f} s host), {b * s / dev_ms * 1e3:.0f} decoder "
          f"tokens/s, peak {peak / 1e9:.2f} GB, logits "
          f"{tuple(fwd.logits.shape)}, finite {finite}; launches "
          f"{launches['forward']}")
    if not finite or tuple(fwd.logits.shape) != (b, s, cfg.vocab_size) \
            or len(fwd.exit_logits) != model.n_exits:
        fail("phase 12 (c): the forward's logits are not finite or "
             "misshapen")
    if launches["forward"]["flash_attention"] != n_flash:
        fail(f"phase 12 (c): {launches['forward']['flash_attention']} flash "
             f"launches, not {n_flash}")
    del fwd
    # one live call of each kind: the encoder's (1,500 x 1,500, no mask),
    # the decoder's causal self-attention and its cross-attention
    if len(captured) != 3:
        fail(f"phase 12 (c): flash ran at {sorted(captured)}, not the "
             f"three kinds")
    live = hold_live(torch, ref, captured, orig, results, "12 (c)")
    out["forward"] = {"tokens": b * s, "frames": b * ec.encoder_seq_len,
                      "event_ms": dev_ms, "host_s": host_s,
                      "tokens_s": b * s / dev_ms * 1e3, "peak_bytes": peak,
                      "live_flash": live["flash_attention"]}
    del captured, batch

    # (d) a live slot migrated between two 16-slot contiguous arenas, raw
    # and int8, its cross rows included
    out["migrate"], launches["migrate"] = migrate_live_slot(
        torch, ops, ref, model, params, WH_MIGRATE, 12)

    # (e) the CLI's batch mode: ServingEngine.generate(frames=) through
    # ``serve``, against a dedicated scheduler of the same shape on the
    # same seeded prompts and frames
    nb, plen, max_new = WH_BATCH
    ops.reset_launches()
    t0 = time.time()
    got, stats = serve(cfg, nb, plen, max_new, params=params, seed=3,
                       device="cuda", quiet=True)
    wall = time.time() - t0
    launches["engine"] = dict(ops.LAUNCHES)
    rs = np.random.RandomState(3)
    prompts = rs.randint(0, cfg.vocab_size, (nb, plen)).astype(np.int32)
    frames = draw_frames(rs, cfg, nb)
    sched = ContinuousBatchScheduler(model, params, SchedulerConfig(
        n_slots=nb, max_len=plen + max_new, exit_threshold=0.5),
        device="cuda")
    reqs = [Request(tokens=p, max_new=max_new, frames=f)
            for p, f in zip(prompts, frames)]
    for r in reqs:
        sched.submit(r)
    sched.run()
    want = [list(r.out_tokens) for r in reqs]
    equal = got.tolist() == want
    print(f"  (e) serve() batch mode ({nb} prompts of {plen} tokens with "
          f"frames, {max_new} new) through ServingEngine: {wall:.2f} s, "
          f"equal to a dedicated scheduler bit for bit: {equal}; exit "
          f"stats {stats}; launches {launches['engine']}")
    if not equal:
        fail("phase 12 (e): the engine's tokens differ from the scheduler's")
    out["engine"] = {"wall_s": wall, "equal": equal, "exit_stats": stats}
    del model, params, sched
    out["wall_s"] = time.time() - t_phase
    print(f"phase 12 wall time {out['wall_s']:.1f}s")
    return out, launches


def migrate_live_slot(torch, ops, ref, model, params, mg, phase, part="d"):
    """A live slot exported from one ``mg["slots"]``-slot arena (paged; an
    encdec model's contiguous, each request with seeded frames) after
    ``mg["polls"]`` polls and imported into another, raw (the stream must
    continue bit for bit) and int8 (every leaf and scale must equal the
    plain quantizer's on the live leaf and dequantize bit for bit, the
    stream must complete); an encdec snapshot must hold every decoder
    layer's cross rows whole.  ``part`` is the step's letter in the
    phase's output.  Returns the summary and the launches (the
    comparisons' own not counted)."""
    import numpy as np
    from repro_torch.launch.serve import draw_frames
    from repro_torch.serving import (ContinuousBatchScheduler, Request,
                                     SchedulerConfig)
    cfg = model.cfg
    paged = cfg.family != "encdec"
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, cfg.vocab_size, int(rs.randint(16, 49)))
               for _ in range(mg["requests"])]
    frames = [draw_frames(rs, cfg) for _ in prompts]

    def arena():
        return ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=mg["slots"], max_len=mg["max_len"], prefill_chunk=16,
            exit_threshold=0.5, paged=paged), device="cuda")

    def submit(sched):
        reqs = [Request(tokens=p, max_new=mg["max_new"], req_id=j, frames=f)
                for j, (p, f) in enumerate(zip(prompts, frames))]
        for r in reqs:
            sched.submit(r)
        return reqs
    ded = arena()
    submit(ded)
    ded.run()
    want = {r.req_id: list(r.out_tokens) for r in ded.completed}
    del ded
    mig = {}
    ops.reset_launches()
    for label in ("raw", "int8"):
        src, dst = arena(), arena()
        reqs = submit(src)
        for _ in range(mg["polls"]):
            src.poll()
        r = reqs[0]
        if r.done or not src.active[r.slot]:
            fail(f"phase {phase} ({part}): request 0 is not live after "
                 f"{mg['polls']} polls")
        snap = src.export_slot(r.slot, compress=label == "int8")
        shapes = [list(q.shape) for q in snap.payload]
        if not paged:
            cross = [cfg.encdec.encoder_seq_len, cfg.num_kv_heads,
                     cfg.resolved_head_dim]
            if sum(sh[0] for sh in shapes if sh[1:] == cross) \
                    != 2 * cfg.num_layers:
                fail(f"phase {phase} ({part}): the snapshot holds no whole "
                     f"cross rows of every decoder layer ({shapes})")
        if label == "int8":
            # the comparisons' launches are not the path's
            counted = dict(ops.LAUNCHES)
            raw = src.export_slot(r.slot)
            leaves = 0
            for q, sc, a in zip(snap.payload, snap.scales, raw.payload):
                a = a.cuda()
                qr, sr = ref.quantize_rows_ref(a.reshape(-1, a.shape[-1]))
                if sc is None or not (
                        bits_equal(torch, q.cuda().reshape(qr.shape), qr)
                        and bits_equal(torch, sc.cuda().reshape(sr.shape),
                                       sr)):
                    fail(f"phase {phase} ({part}): an int8 leaf or scale "
                         f"differs from the plain quantizer on the live leaf")
                yk = ops.decompress_rows(q.cuda(), sc.cuda(), dtype=a.dtype)
                yr = ref.dequantize_rows_ref(qr, sr, a.dtype)
                if not bits_equal(torch, yk.reshape(yr.shape), yr):
                    fail(f"phase {phase} ({part}): dequantize_rows differs "
                         f"from its plain version on the live payload")
                leaves += 1
            mig["int8_leaves"] = leaves
            mig["int8_shapes"] = shapes
            ops.LAUNCHES.update(counted)
            del raw
        mig[f"{label}_bytes"] = snap.payload_bytes
        src.release_slot(r.slot)
        dst.import_slot(snap)
        dst.run()
        src.run()
        if label == "raw" and r.out_tokens != want[0]:
            fail(f"phase {phase} ({part}): the raw migration's stream differs "
                 f"from the unmigrated run")
        if len(r.out_tokens) != mg["max_new"] or not all(
                0 <= t < cfg.vocab_size for t in r.out_tokens):
            fail(f"phase {phase} ({part}): the {label} migration's stream is "
                 f"short or out of the vocabulary")
        mig[f"{label}_equal"] = r.out_tokens == want[0]
        mig[f"{label}_others_equal"] = all(
            list(x.out_tokens) == want[x.req_id] for x in reqs[1:])
        del src, dst
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    if launches["quantize_rows"] <= 0 or launches["dequantize_rows"] <= 0:
        fail(f"phase {phase} ({part}): the int8 kernels did not launch")
    print(f"  ({part}) migration of a live slot between {mg['slots']}-slot "
          f"{'paged' if paged else 'contiguous'} arenas: raw "
          f"{mig['raw_bytes'] / 2 ** 20:.1f} MiB"
          f"{'' if paged else ' (cross rows whole)'}, stream bit-identical "
          f"to the unmigrated run; int8 {mig['int8_bytes'] / 2 ** 20:.1f} "
          f"MiB, {mig['int8_leaves']} leaves and scales bit-identical to "
          f"the plain quantizer, dequantized bit-identically, stream "
          f"complete (equal to the unmigrated one: {mig['int8_equal']}); "
          f"the other streams of the source unchanged: "
          f"{mig['raw_others_equal']} / {mig['int8_others_equal']}; "
          f"launches {launches}")
    return mig, launches


L4_TRACE = dict(rate=8.0, n_requests=16, slots=16, prompt_len=64,
                max_new=16, threshold=0.5, paged=True, page_size=16,
                segmented=True, prefix_share=0.25, prefix_len=32, seed=0)
L4_LOOP = dict(requests=16, slots=8, readback_interval=8)
L4_FWD = (2, 2048)         # phase 13 (d)'s forward
L4_MIGRATE = dict(requests=4, slots=16, max_len=128, max_new=24, polls=10)
W8A8_REL = 0.05    # bf16-vs-W8A8 relative error of a MoE layer's output:
#                    the bound of the reference's own
#                    test_w8a8_expert_matmul_close_to_bf16


def llama4_cut(get_config):
    """llama4-maverick at its published widths (hf:meta-llama/Llama-4-
    Scout-17B-16E family card, as the reference config names it), cut in
    depth only to 4 layers: two pair units of a dense layer (d_ff 16,384)
    and a MoE layer (128 experts of 8,192, top-1, one shared); the exit
    at 2, the boundary between the units (one inside a unit would be
    dropped)."""
    cfg = get_config("llama4-maverick-400b-a17b")
    return dataclasses.replace(
        cfg, name="llama4-maverick-400b-a17b-4l", num_layers=4,
        exits=dataclasses.replace(cfg.exits, exit_layers=(2,),
                                  entropy_threshold=0.5))


def w8a8_rows(torch, ops, ref, calls, labels):
    """The W8A8 kernel on live calls: bit-exact against its plain version,
    then timed against it and against ``torch.bmm`` in bf16 on the same
    shapes (the dispatched rows and the experts dequantized to bf16: what
    the unquantized path runs).  Returns a row per label."""
    rows = {}
    for label, a in zip(labels, calls):
        aq, a_s, wq, w_s = a
        got = ops.w8a8_expert_matmul(*a)
        want = ref.w8a8_expert_matmul_ref(*a)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want):
            fail(f"phase 13 (a): w8a8_expert_matmul differs from its plain "
                 f"version on the live {label} product")
        del got, want
        w_bf = torch.empty(wq.shape, dtype=torch.bfloat16, device="cuda")
        for i in range(wq.shape[0]):           # one expert's fp32 at a time
            w_bf[i] = (wq[i].float() * w_s[i]).bfloat16()
        a_bf = (aq.float() * a_s).bfloat16()
        spread = interleaved_ms(torch, ops.w8a8_expert_matmul, torch.bmm,
                                [a], lib_args=[(a_bf, w_bf)], iters=10)
        print_spread(f"w8a8_expert_matmul llama4 {label}", spread)
        bound_ms, by = w8a8_bound(*a)
        rows[label] = {
            "aq": list(aq.shape), "wq": list(wq.shape), "max_abs_err": 0.0,
            "ms": spread["kernel"]["median"],
            "plain_ms": device_ms(torch, ref.w8a8_expert_matmul_ref, [a],
                                  iters=3),
            "library_ms": spread["library"]["median"],
            "bound_ms": bound_ms, "bound_by": by, "spread": spread}
        brief = {k: v for k, v in rows[label].items() if k != "spread"}
        print(f"  {json.dumps(brief)}")
        del w_bf, a_bf
    return rows


def run_llama4(torch, ops, ref, results):
    """Phase 13 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_decode import profile_decode
    from repro_torch.launch.serve import serve_poisson
    from repro_torch.models import Model, ffn
    from repro_torch.models.common import tree_leaves, tree_map
    t_phase = time.time()
    cfg = llama4_cut(get_config)
    m = cfg.moe
    tr = L4_TRACE

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model = Model(cfg, device="cuda")
    params = model.init(tr["seed"])
    torch.cuda.synchronize()
    init_s = time.time() - t0
    bf16_bytes = nbytes(params)
    print(f"llama4 path: {cfg.name} at its published widths ({cfg.source}"
          f" family card), cut in depth to {cfg.num_layers} layers = "
          f"{len(model.plan) - model.n_exits} pair units: d_model "
          f"{cfg.d_model}, {cfg.num_heads} / {cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim} (G {cfg.num_heads // cfg.num_kv_heads}),"
          f" dense d_ff {cfg.d_ff}, {m.num_experts} experts of "
          f"{m.d_ff_expert} top-{m.top_k} + {m.num_shared_experts} shared, "
          f"vocab {cfg.vocab_size}, exit after layer "
          f"{cfg.exits.exit_layers}; random weights (seed 0): "
          f"{bf16_bytes / 1e9:.2f} GB bf16, init {init_s:.1f}s")
    out = {"init_s": init_s, "bf16_bytes": bf16_bytes}
    launches = {}

    # (a) one live MoE layer on 16 tokens of 0.5 N(0, 1): bf16 experts,
    # then the same layer after quantize_model_moe
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (0.5 * torch.randn(1, 16, cfg.d_model, device="cuda",
                           generator=g)).bfloat16()
    lp = tree_map(lambda a: a[0], params["blocks"][0]["b"]["moe"])
    y_bf, _ = ffn.moe_ffn(lp, x, cfg)
    del lp                        # a view would keep the bf16 leaves alive
    t0 = time.time()
    ffn.quantize_model_moe(params)
    torch.cuda.synchronize()
    quant_s = time.time() - t0
    q_bytes = nbytes(params)
    peak = torch.cuda.max_memory_allocated()
    int8_bytes = sum(t.numel() for t in tree_leaves(params)
                     if t.dtype == torch.int8)
    lpq = tree_map(lambda a: a[0], params["blocks"][0]["b"]["moe"])
    calls = []
    orig_w8a8 = ops.w8a8_expert_matmul

    def rec(*a):
        calls.append(a)
        return orig_w8a8(*a)
    ops.w8a8_expert_matmul = rec
    n0 = ops.LAUNCHES["w8a8_expert_matmul"]
    y_q, _ = ffn.moe_ffn(lpq, x, cfg)
    torch.cuda.synchronize()
    ops.w8a8_expert_matmul = orig_w8a8
    rel = ((y_q.float() - y_bf.float()).norm()
           / y_bf.float().norm()).item()
    print(f"  (a) quantize_model_moe in place: {quant_s:.1f}s, "
          f"{q_bytes / 1e9:.2f} GB after ({int8_bytes / 1e9:.2f} GB int8 "
          f"experts), peak device memory {peak / 1e9:.2f} GB; one MoE layer "
          f"on 16 tokens: bf16 vs W8A8 relative error {rel:.4f} (bound "
          f"{W8A8_REL}), {len(calls)} W8A8 launches")
    if len(calls) != 3 or ops.LAUNCHES["w8a8_expert_matmul"] != n0 + 3:
        fail("phase 13 (a): the W8A8 layer did not launch the kernel for "
             "its three products")
    if not (0 < rel < W8A8_REL and torch.isfinite(y_q.float()).all()):
        fail(f"phase 13 (a): bf16 vs W8A8 relative error {rel}")
    rows = w8a8_rows(torch, ops, ref, [calls[0], calls[2]],
                     ["gate", "down"])
    gate = rows["gate"]
    results["w8a8_expert_matmul"] = {
        k: gate[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                             "bound_ms", "bound_by")}
    results["w8a8_expert_matmul"]["shapes"] = rows
    out.update(quant_s=quant_s, q_bytes=q_bytes, int8_bytes=int8_bytes,
               peak_bytes=peak, rel_err=rel)
    del calls, lpq, x, y_bf, y_q

    # (b) serve_poisson on the quantized tree, paged and segmented; live
    # kernel inputs and one live MoE input captured
    captured, orig, restore = live_capture(
        torch, ops, ("paged_gqa_attention", "exit_head_entropy",
                     "w8a8_expert_matmul"), 97)
    orig_moe, moe_calls, moe_live = ffn.moe_ffn, [0], []

    def moe_capture(lp_moe, h, c, *rest):
        moe_calls[0] += 1
        if moe_calls[0] == 97:
            moe_live.append((lp_moe, h.clone()))
        return orig_moe(lp_moe, h, c, *rest)
    ffn.moe_ffn = moe_capture
    ops.reset_launches()
    t0 = time.time()
    st = serve_poisson(cfg, params=params, device="cuda", quiet=True,
                       n_requests=tr["n_requests"], rate=tr["rate"],
                       slots=tr["slots"], prompt_len=tr["prompt_len"],
                       max_new=tr["max_new"], threshold=tr["threshold"],
                       paged=tr["paged"], page_size=tr["page_size"],
                       segmented=tr["segmented"],
                       prefix_share=tr["prefix_share"],
                       prefix_len=tr["prefix_len"], seed=tr["seed"])
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    restore()
    ffn.moe_ffn = orig_moe
    outs = st.pop("outputs")
    print(f"  (b) served {tr['n_requests']} requests at {tr['rate']} req/s, "
          f"prompts {tr['prompt_len'] // 4}-{tr['prompt_len']} tokens "
          f"({tr['prefix_share']:.2f} sharing a {tr['prefix_len']}-token "
          f"prefix), {tr['max_new']} new, {tr['slots']} slots, paged + "
          f"segmented, W8A8 experts: {wall:.1f}s with warm-up; "
          f"{st['sustained_tok_s']:.2f} tok/s, p50 "
          f"{st['p50_latency_s'] * 1e3:.0f} ms, p95 "
          f"{st['p95_latency_s'] * 1e3:.0f} ms, makespan "
          f"{st['makespan_s']:.2f} s, prefix_hit_tokens "
          f"{st['prefix_hit_tokens']}; launches {launches['serve']}")
    print(f"  exit stats {st['exit_stats']}; stage calls "
          f"{st['stage_calls']}")
    if len(outs) != tr["n_requests"] or any(
            len(o) != tr["max_new"] or not all(0 <= t < cfg.vocab_size
                                               for t in o) for o in outs):
        fail("phase 13 (b): a stream is short or out of the vocabulary")
    for kname in ("paged_gqa_attention", "exit_head_entropy",
                  "w8a8_expert_matmul"):
        if launches["serve"][kname] <= 0:
            fail(f"phase 13 (b): {kname} was not launched")
    out["live"] = hold_live(torch, ref, captured, orig, results, "13 (b)")
    if len(out["live"].get("w8a8_expert_matmul", [])) != 3 * 2 or \
            len(out["live"].get("exit_head_entropy", [])) != 1 or \
            "paged_gqa_attention" not in out["live"]:
        fail("phase 13 (b): no live call of each kernel (and of each W8A8 "
             "product) was captured")
    del captured
    # one live MoE input's routing and capacity drops, recounted on the host
    if not moe_live:
        fail("phase 13 (b): no live MoE call was captured")
    lp_moe, h = moe_live[0]
    x2d = h.reshape(-1, h.shape[-1])
    t_tok = x2d.shape[0]
    cap = ffn._capacity(t_tok, m.num_experts, m.top_k, m.capacity_factor)
    _, idx_host, _ = ffn._route(x2d.cpu(), lp_moe["router"].cpu(), m.top_k)
    _, kept = ffn._slots(idx_host, 0, m.num_experts, cap)
    _, idx_card, _ = ffn._route(x2d, lp_moe["router"], m.top_k)
    same = bool(torch.equal(idx_card.cpu(), idx_host))
    dropped = int((~kept).sum())
    print(f"  live MoE input [{t_tok}, {x2d.shape[1]}]: capacity {cap} rows "
          f"per expert ({m.num_experts * cap} rows computed); the host's "
          f"routing drops {dropped} of {t_tok * m.top_k} assignments; the "
          f"card routes {'identically' if same else 'differently'}")
    out["moe_live"] = {"tokens": t_tok, "capacity": cap, "dropped": dropped,
                       "card_routes_same": same}
    del moe_live, lp_moe, h, x2d
    out["serve"] = st
    prof = profile_decode(cfg, slots=tr["slots"], prompt_len=64, steps=4,
                          seed=tr["seed"], params=params)
    out["profile_decode"] = prof
    print_profile(prof, "16 slots, 64-token prompts, 4 steps")

    # (c) closed loop on 8 slots: sync monolithic, then windows of 8
    loop, _, _ = sync_vs_windows(torch, ops, model, params, L4_LOOP, 13)
    out.update(loop)
    launches["loop"] = out["loop_async"]["launches"]
    per = out["loop_async"]["per_replay"]
    print(f"  (c) closed loop of {L4_LOOP['requests']} requests on "
          f"{L4_LOOP['slots']} paged slots (prompts 16-64, max_new 8-24): "
          f"{L4_LOOP['requests'] - len(loop['loop_ties'])} streams "
          f"bit-identical to the sync monolithic poll, "
          f"{len(loop['loop_ties'])} ties; one capture; "
          f"{out['loop_sync']['wall_s']:.2f} s sync against "
          f"{out['loop_async']['wall_s']:.2f} s with windows of "
          f"{L4_LOOP['readback_interval']} (launches a replay {per})")
    if per["w8a8_expert_matmul"] != 3 * 2 or \
            per["paged_gqa_attention"] != cfg.num_layers:
        fail(f"phase 13 (c): a replay launches {per}, not 6 W8A8 and "
             f"{cfg.num_layers} paged-GQA kernels")

    # (d) Model.forward on 2 x 2048 tokens
    b, s = L4_FWD
    g = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=g)
    model.forward(params, {"tokens": toks[:, :256]})          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    captured, orig, restore = live_capture(
        torch, ops, ("flash_attention", "w8a8_expert_matmul"),
        cfg.num_layers)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    e0.record()
    fwd = model.forward(params, {"tokens": toks})
    e1.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches["forward"] = dict(ops.LAUNCHES)
    restore()
    dev_ms = e0.elapsed_time(e1)
    fpeak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(fwd.logits).all()) and all(
        bool(torch.isfinite(e).all()) for e in fwd.exit_logits) \
        and math.isfinite(fwd.aux_loss.item())
    print(f"  (d) Model.forward {b} x {s} tokens: {dev_ms:.1f} ms between "
          f"CUDA events ({host_s:.2f} s host), {b * s / dev_ms * 1e3:.0f} "
          f"tokens/s, peak {fpeak / 1e9:.2f} GB, logits "
          f"{tuple(fwd.logits.shape)}, {len(fwd.exit_logits)} exit logits, "
          f"aux {fwd.aux_loss.item():.5f}, finite {finite}; launches "
          f"{launches['forward']}")
    if not finite or tuple(fwd.logits.shape) != (b, s, cfg.vocab_size) \
            or len(fwd.exit_logits) != model.n_exits:
        fail("phase 13 (d): the forward's logits are not finite or "
             "misshapen")
    if launches["forward"]["flash_attention"] != cfg.num_layers:
        fail(f"phase 13 (d): {launches['forward']['flash_attention']} flash "
             f"launches, not {cfg.num_layers}")
    del fwd
    live = hold_live(torch, ref, captured, orig, results, "13 (d)")
    if not live.get("flash_attention") or \
            len(live.get("w8a8_expert_matmul", [])) != 6:
        fail("phase 13 (d): no live flash or W8A8 call was captured")
    out["forward"] = {"tokens": b * s, "event_ms": dev_ms, "host_s": host_s,
                      "tokens_s": b * s / dev_ms * 1e3, "peak_bytes": fpeak,
                      "live": live}
    del captured, toks

    # (e) a live pair slot migrated between 16-slot paged arenas
    mig, launches["migrate"] = migrate_live_slot(torch, ops, ref, model,
                                                 params, L4_MIGRATE, 13,
                                                 part="e")
    if mig["int8_leaves"] != 4 * len(model.scan_block_kinds()):
        fail(f"phase 13 (e): {mig['int8_leaves']} int8 leaves, not a (k, v) "
             f"of each layer of each pair unit")
    out["migrate"] = mig
    del model, params
    out["wall_s"] = time.time() - t_phase
    print(f"phase 13 wall time {out['wall_s']:.1f}s")
    return out, launches


FWD_BATCH = (8, 2048)      # phase 7's forward
REPLAY_BATCH = (2, 128)    # each of the two token sets of its consistency
                           # check against the decode replay


def run_forward(torch, ops):
    """Phase 7 (see the module docstring).  Returns a summary and the
    launch counts of the timed forward."""
    from repro_torch.launch import device_trace
    from repro_torch.configs import get_config
    from repro_torch.core.resilience import n_scan_blocks, resilient_forward
    from repro_torch.models import Model
    from repro_torch.kernels import ref
    from repro_torch.models.attention import make_mask
    from repro_torch.models.common import tree_leaves, tree_map
    cfg = get_config("granite-3-2b")

    def plain_flash(q, k, v, *, causal=True, window=0):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    model = Model(cfg, device="cuda")
    params = model.init(0)
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    b, s = FWD_BATCH
    toks = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(0))
    batch = {"tokens": toks}
    print(f"forward path: granite-3-2b, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab_size}, random weights "
          f"(seed 0, {pbytes / 1e9:.2f} GB); Model.forward on {b} x {s} "
          f"tokens")
    model.forward(params, batch)                      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.time()
    e0.record()
    out = model.forward(params, batch)
    e1.record()
    torch.cuda.synchronize()
    host_s = time.time() - t0
    launches = dict(ops.LAUNCHES)
    dev_ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated()
    full = out.logits
    finite = bool(torch.isfinite(full).all()) and all(
        bool(torch.isfinite(e).all()) for e in out.exit_logits)
    print(f"  host {host_s * 1e3:.1f} ms (ends in a synchronize), device "
          f"{dev_ms:.1f} ms (CUDA events around the forward), "
          f"{b * s / host_s:.0f} tokens/s; peak device memory "
          f"{peak / 1e9:.2f} GB; logits {tuple(full.shape)} and "
          f"{len(out.exit_logits)} exit logits finite: {finite}; launches "
          f"{launches}")
    if not finite:
        fail("the full-width forward's logits are not finite")
    if launches["flash_attention"] != cfg.num_layers:
        fail(f"flash_attention launched {launches['flash_attention']} "
             f"times in one forward, not once per layer "
             f"({cfg.num_layers})")
    del out

    # one more forward under torch.profiler: device busy share and the
    # kernels that take the most device time
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        model.forward(params, batch)
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    # device time: the union of the operations' intervals
    dev_ops = device_trace.device_ops(prof)
    per = device_trace.by_name(dev_ops)
    kern_ms = device_trace.busy_s(dev_ops) * 1e3
    flash_ms = sum(d["s"] for n, d in per.items()
                   if "flash_fwd_kernel" in n) * 1e3
    top = [{"name": n[:60], "ms": d["s"] * 1e3, "calls": d["launches"]}
           for n, d in sorted(per.items(), key=lambda kv: -kv[1]["s"])[:8]]
    print(f"  torch.profiler forward: wall {prof_s * 1e3:.1f} ms, device "
          f"kernels {kern_ms:.1f} ms (busy {kern_ms / (prof_s * 1e3) * 100:.1f}"
          f" %), {len(dev_ops)} CUDA kernels, flash "
          f"attention {flash_ms:.2f} ms; top {[(t['name'][:40], round(t['ms'], 2), t['calls']) for t in top]}")
    profile = {"wall_ms": prof_s * 1e3, "kernel_ms": kern_ms,
               "flash_ms": flash_ms,
               "kernels": len(dev_ops), "top": top}

    # resilient_forward: all alive equals the forward; block 0 dead
    n = n_scan_blocks(model)
    logits, exits = resilient_forward(model, params, batch,
                                      torch.ones(n, device="cuda"))
    del exits
    alive_err = (logits - full).abs().max().item()
    del logits
    dead = torch.ones(n, device="cuda")
    dead[0] = 0.0
    logits, exits = resilient_forward(model, params, batch, dead)
    del exits
    dead_finite = bool(torch.isfinite(logits).all())
    dead_diff = (logits - full).abs().max().item()
    del logits, full
    print(f"  resilient_forward over {n} blocks: all alive max_abs_err "
          f"{alive_err:.3e} against Model.forward (tol {RESILIENT_TOL}); "
          f"block 0 dead: finite {dead_finite}, max diff {dead_diff:.3f}")
    if alive_err > RESILIENT_TOL:
        fail("resilient_forward with every block alive is not the forward")
    if not dead_finite or dead_diff <= 1e-4:
        fail("resilient_forward with block 0 dead is not a finite bypass")

    # the forward's greedy tokens against the decode replay (prefill), an
    # independent path, on two sets of 2 x 128 of the tokens; an fp32
    # forward (weights upcast, plain attention) measures how far each path
    # sits from exact arithmetic.  The plain-attention forward must pass
    # the check as well, and a planted fault (P rounded to fp8 before P V)
    # must fail it
    def fp8_p_flash(q, k, v, *, causal=True, window=0):
        bq, sq, nq, hd = q.shape
        nkv = k.shape[2]
        mask = make_mask(sq, sq, causal=causal, window=window,
                         device=q.device)
        sc = torch.einsum("bsngh,btnh->bngst",
                          q.reshape(bq, sq, nkv, nq // nkv, hd).float(),
                          k.float()) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~mask, ref.NEG_INF), dim=-1)
        out = torch.einsum("bngst,btnh->bsngh",
                           p.to(torch.float8_e4m3fn).float(), v.float())
        return out.reshape(bq, sq, nq, hd).to(q.dtype)

    def against_replay(small):
        fwd = model.forward(params, small).logits
        t0 = time.time()
        replay, _ = model.prefill(params, small)
        torch.cuda.synchronize()
        replay_s = time.time() - t0
        kernel = ops.flash_attention
        ops.flash_attention = plain_flash
        plain = model.forward(params, small).logits
        exact = model.forward(tree_map(lambda t: t.float(), params),
                              small).logits
        ops.flash_attention = fp8_p_flash
        control = model.forward(params, small).logits
        ops.flash_attention = kernel
        a_r = replay.argmax(-1)
        rep_dev = (replay - exact).abs()
        top2 = exact.topk(2, dim=-1).values
        top2 = top2[..., 0] - top2[..., 1]
        out = {"replay_s": replay_s,
               "max_diff": (fwd - replay).abs().max().item(),
               "top2_gap_median": top2.median().item(),
               "share_under_logit_tie": (top2 < LOGIT_TIE).float().mean()
               .item(),
               "share_under_replay_tie": (top2 < REPLAY_TIE).float().mean()
               .item(),
               "replay_max_dev": rep_dev.max().item(),
               "replay_mean_dev": rep_dev.mean().item()}
        print(f"  forward vs decode replay ({tuple(small['tokens'].shape)} "
              f"tokens, replay {replay_s:.1f} s): logits max abs diff "
              f"{out['max_diff']:.3e}; fp32 top-2 gap median "
              f"{out['top2_gap_median']:.4f}, under {LOGIT_TIE} at "
              f"{out['share_under_logit_tie'] * 100:.1f} % of positions, "
              f"under {REPLAY_TIE} at "
              f"{out['share_under_replay_tie'] * 100:.1f} % (where the "
              f"argmax check cannot see a flip); decode replay vs the fp32 "
              f"forward: max {out['replay_max_dev']:.4f}, mean "
              f"{out['replay_mean_dev']:.5f}")
        for n, x in (("forward", fwd), ("plain-attention forward", plain),
                     ("control", control)):
            a = x.argmax(-1)
            gap = (exact.gather(-1, a[..., None])
                   - exact.gather(-1, a_r[..., None])).abs()[..., 0]
            dev = (x - exact).abs()
            c = {"flips": int((a != a_r).sum()),
                 "hard": int((gap >= REPLAY_TIE).sum()),
                 "flip_gaps": sorted(round(g, 4)
                                     for g in gap[a != a_r].tolist()),
                 "max_dev": dev.max().item(), "mean_dev": dev.mean().item(),
                 "ratio": dev.mean().item() / out["replay_mean_dev"]}
            c["passes"] = c["hard"] == 0 and c["ratio"] <= REPLAY_ACC
            out[n] = c
            print(f"    {n}{' (P in fp8 before P V)' * (n == 'control')}: "
                  f"argmax differs from the replay's at {c['flips']} "
                  f"positions, at fp32 gaps {c['flip_gaps']}: {c['hard']} "
                  f"at >= {REPLAY_TIE} (tol 0); vs the fp32 forward max "
                  f"{c['max_dev']:.4f}, mean {c['mean_dev']:.5f}, "
                  f"{c['ratio']:.3f}x the replay's (tol {REPLAY_ACC}); "
                  f"passes {c['passes']}")
        return out

    rb, rs = REPLAY_BATCH
    checks = [against_replay({"tokens": toks[i:i + rb, :rs]})
              for i in (0, rb)]
    for c in checks:
        if not math.isfinite(c["max_diff"]) or not c["forward"]["passes"]:
            fail("the forward disagrees with the decode replay beyond bf16 "
                 "noise")
        if not c["plain-attention forward"]["passes"]:
            fail("the plain-attention forward fails the replay check: the "
                 "check is tighter than bf16 noise")
        if c["control"]["passes"]:
            fail("the replay check passes a planted attention fault")
    summary = {"config": cfg.name, "batch": [b, s], "param_bytes": pbytes,
               "host_ms": host_s * 1e3, "device_ms": dev_ms,
               "tokens_per_s": b * s / host_s, "peak_bytes": peak,
               "launches": launches, "resilient_alive_err": alive_err,
               "resilient_dead_diff": dead_diff, "against_replay": checks,
               "profile": profile}
    del model, params
    return summary, launches


# ---- phase 14: training with the flash backward kernel -----------------
LSE_TOL = 1e-3     # absolute, fp32: the forward's log-sum-exp against the
                   # plain one (the kernel's exp2 is the MUFU approximation,
                   # its scores sum in another order)
BWD_TOL = 2e-2     # of max(1, |plain|): bf16 dq, dk, dv; the kernel feeds
                   # P and dS to the tensor cores in bf16 (2^-9 relative
                   # each) and sums in fp32 in another order than the plain
                   # backward's fp32 einsums
GRAD_GATE = 5e-2   # relative L2 error per leaf between a step's gradients
                   # through the kernels and through plain attention (fp32
                   # scores, autograd): both round every bf16 activation
                   # and gradient alike except inside attention, where the
                   # kernel's bf16 P and dS add 2^-9 relative per term; the
                   # CPU tests hold the port to the reference at the same
                   # limit (PERF.md §2)
RESUME_RTOL = 1e-3  # a resumed step's loss against the uninterrupted run's
TRAIN_BATCH = (4, 1024)    # (b)'s granite-3-2b batch
TRAIN_STEPS = 5
GATE_BATCH = (2, 2048)     # (c)'s 4-layer cut
T100 = dict(steps=200, ckpt_every=100)   # (d): examples/torch/train_100m.py


def flash_bwd_bound(make_mask, q, k, causal, window):
    """Bytes: q, k, v, o, dO (bf16) and the forward's log-sum-exp (fp32)
    read once, dq, dk and dv written once; operations: 10 H per unmasked
    (query, key) pair (the five products), per sequence and query head,
    at the bf16 peak.  The kernels' second S and dP (seven products for
    the work's five) are not counted."""
    b, sq, nq, h = q.shape
    pairs = int(make_mask(sq, k.shape[1], causal=causal,
                          window=window).sum())
    return bound((4 * q.numel() + 4 * k.numel()) * 2 + 4 * b * nq * sq,
                 10 * h * pairs * b * nq)


def check_flash_bwd(torch, ops, ref, gen, label, shape):
    """(a) for one shape: the forward's output with and without its
    log-sum-exp (the same bits) and that log-sum-exp against the plain one
    (LSE_TOL), the kernels against the plain backward, a second call (the
    same bits), the planted control (the kernels given a zero o, so D =
    rowsum(dO o O) = 0 and dS = P o dP) against the same, and the kernels
    timed three times interleaved with SDPA's backward."""
    from repro_torch.launch.kernel_ab import sdpa_bwd
    from repro_torch.models.attention import make_mask
    b, sq, skv, nq, nkv, h, causal, window = shape

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").bfloat16()
    q, k, v = rnd(b, sq, nq, h), rnd(b, skv, nkv, h), rnd(b, skv, nkv, h)
    do = rnd(b, sq, nq, h)
    o, lse = ops.flash_attention_with_lse(q, k, v, causal=causal,
                                          window=window)
    o_same = torch.equal(o, ops.flash_attention(q, k, v, causal=causal,
                                                window=window))
    lse_err = (lse - ref.flash_attention_lse_ref(
        q, k, causal=causal, window=window)).abs().max().item()
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                  window=window)
    again = ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                    window=window)
    same = all(torch.equal(a, c) for a, c in zip(got, again))
    del again
    want = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window)
    bad = ops.flash_attention_bwd(q, k, v, torch.zeros_like(o), do, lse,
                                  causal=causal, window=window)
    torch.cuda.synchronize()

    def scaled(a, w):
        return ((a.float() - w.float()).abs()
                / w.float().abs().clamp(min=1)).max().item()
    err = max((a.float() - w.float()).abs().max().item()
              for a, w in zip(got, want))
    rel = max(scaled(a, w) for a, w in zip(got, want))
    ctrl = max(scaled(a, w) for a, w in zip(bad, want))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in got)
    print(f"flash_attention_bwd {label} q {tuple(q.shape)} k "
          f"{tuple(k.shape)} causal {causal} window {window}: max_abs_err "
          f"{err:.3e}, of max(1, |plain|) {rel:.3e} (tol {BWD_TOL}); "
          f"planted control (no D) {ctrl:.3e}; two calls the same bits "
          f"{same}; the forward's O the same bits with its log-sum-exp "
          f"{o_same}, which is {lse_err:.3e} from the plain one (tol "
          f"{LSE_TOL})")
    if not finite or not rel <= BWD_TOL:
        fail(f"flash_attention_bwd disagrees with its plain version "
             f"({label})")
    if not ctrl > BWD_TOL:
        fail(f"the backward check passes a planted fault ({label})")
    if not same:
        fail(f"flash_attention_bwd gives other bits on a second call "
             f"({label})")
    if not o_same:
        fail(f"the flash forward's O changes with its log-sum-exp output "
             f"({label})")
    if not lse_err <= LSE_TOL:
        fail(f"the flash forward's log-sum-exp disagrees with the plain "
             f"one ({label})")
    del got, want, bad

    def kernel(q, k, v, o, do, lse):
        return ops.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                       window=window)

    def plain(q, k, v, o, do, lse):
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse,
                                           causal=causal, window=window)
    lib = sdpa_bwd(q, k, v, do, causal, window)
    spread = interleaved_ms(torch, kernel, lambda: lib(),
                            [(q, k, v, o, do, lse)], lib_args=[()])
    print_spread(f"flash_attention_bwd {label}", spread)
    bnd = flash_bwd_bound(make_mask, q, k, causal, window)
    row = {"shapes": [list(t.shape) for t in (q, k, v, o, do)],
           "causal": causal, "window": window, "max_abs_err": err,
           "max_err_of_plain": rel, "control_err": ctrl,
           "lse_err": lse_err, "same_bits": same,
           "ms": spread["kernel"]["median"],
           "plain_ms": device_ms(torch, plain, [(q, k, v, o, do, lse)],
                                 iters=2),
           "library_ms": spread["library"]["median"], "bound_ms": bnd[0],
           "bound_by": bnd[1], "spread": spread}
    print(f"  {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f}"
          f" ms, SDPA backward {row['library_ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
          f"{row['bound_ms'] / row['ms'] * 100:.1f} % of it)")
    if label == "granite":
        # the forward at the training shape, with and without the
        # log-sum-exp, in turns
        def fwd_lse(q, k, v):
            return ops.flash_attention_with_lse(q, k, v, causal=causal,
                                                window=window)

        def fwd(q, k, v):
            return ops.flash_attention(q, k, v, causal=causal, window=window)
        fspread = interleaved_ms(torch, fwd_lse, fwd, [(q, k, v)])
        row["forward_ms"] = {"with_lse": fspread["kernel"]["median"],
                             "without": fspread["library"]["median"]}
        print(f"  {label}: the forward {row['forward_ms']['with_lse']:.4f} "
              f"ms with its log-sum-exp, {row['forward_ms']['without']:.4f}"
              f" ms without")
    return row


def rel_l2(torch, got, want):
    """||got - want|| / ||want|| over one leaf, in fp32."""
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp(min=1e-30)).item()


def run_training(torch, ops, ref, results):
    """Phase 14 (see the module docstring).  Returns a summary and the
    launch counts of each part."""
    import importlib.util
    import shutil
    from repro_torch.launch import device_trace
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import batch_for_model
    from repro_torch.launch.kernel_ab import BWD_SHAPES
    from repro_torch.launch.train import train
    from repro_torch.models import Model, blocks
    from repro_torch.models.common import (softmax_cross_entropy,
                                           tree_leaves, tree_map, unembed)
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      apply_updates, compute_loss,
                                      init_optimizer, latest_checkpoint,
                                      make_train_step, restore_checkpoint)
    t_phase = time.time()
    out, launches = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(14)

    # (a) the backward kernel against its plain version, timed
    rows = {label: check_flash_bwd(torch, ops, ref, gen, label, shape)
            for label, shape in BWD_SHAPES.items()}
    main_row = dict(rows["granite"])
    main_row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    main_row["other_shapes"] = {k: {kk: r[kk] for kk in (
        "shapes", "causal", "window", "max_abs_err", "max_err_of_plain",
        "control_err", "lse_err", "same_bits", "ms", "plain_ms",
        "library_ms", "bound_ms", "bound_by")}
        for k, r in rows.items() if k != "granite"}
    results["flash_attention_bwd"] = main_row
    out["bwd_rows"] = {k: {kk: v for kk, v in r.items() if kk != "spread"}
                       for k, r in rows.items()}
    gc.collect()
    torch.cuda.empty_cache()

    # (b) granite-3-2b at full width: the training entry point, 5 steps
    cfg = get_config("granite-3-2b")
    b, s = TRAIN_BATCH
    plain_calls = [0]
    orig_plain = (ref.flash_attention_ref, ref.flash_attention_bwd_ref)

    def counting(fn):
        def wrapper(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapper
    print(f"training path: granite-3-2b, {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size},"
          f" exits {cfg.exits.exit_layers}; launch.train.train, "
          f"{TRAIN_STEPS} AdamW steps of {b} x {s} tokens (BranchyNet "
          f"joint loss), random weights (seed 0)")
    ref.flash_attention_ref = counting(orig_plain[0])
    ref.flash_attention_bwd_ref = counting(orig_plain[1])
    hist = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.time()
    params, _ = train("granite-3-2b", TRAIN_STEPS, b, s, device="cuda",
                      history=hist, log_every=1)
    torch.cuda.synchronize()
    launches["train"] = dict(ops.LAUNCHES)
    train_s = time.time() - t0
    ref.flash_attention_ref, ref.flash_attention_bwd_ref = orig_plain
    peak_train = torch.cuda.max_memory_allocated()
    pbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    nparams = sum(t.numel() for t in tree_leaves(params))
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    print(f"  {nparams / 1e9:.3f}B params ({pbytes / 1e9:.2f} GB); "
          f"{train_s:.1f} s including init; per step host ms "
          f"{[round(h['step_s'] * 1e3, 1) for h in hist]}; losses "
          f"{[round(h['loss'], 4) for h in hist]}; grad norms "
          f"{[round(h['grad_norm'], 3) for h in hist]}; peak device memory "
          f"{peak_train / 1e9:.2f} GB; launches {launches['train']}; plain "
          f"attention calls {plain_calls[0]}")
    if not finite or len(hist) != TRAIN_STEPS:
        fail("phase 14 (b): a loss or grad norm is not finite")
    for kname in ("flash_attention", "flash_attention_bwd"):
        if launches["train"][kname] != cfg.num_layers * TRAIN_STEPS:
            fail(f"phase 14 (b): {kname} launched "
                 f"{launches['train'][kname]} times, not once a layer a step")
    if plain_calls[0]:
        fail("phase 14 (b): plain attention ran on the card")
    out["train"] = {"params": nparams, "param_bytes": pbytes,
                    "wall_s": train_s, "history": hist,
                    "peak_bytes": peak_train}

    # ... each step timed by CUDA events (the same batch again), one step
    # profiled, and the step's parts: the three vocab heads, the
    # optimizer, the attention backward
    model = Model(cfg, device="cuda")
    ocfg = OptimizerConfig(lr=3e-4, warmup_steps=10, total_steps=TRAIN_STEPS)
    step_fn = make_train_step(model, ocfg)
    opt = init_optimizer(params)
    batch = batch_for_model(cfg, InputShape("p14", s, b, "train"), 0,
                            device="cuda")

    def timed_step():
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        e0.record()
        step_fn(params, opt, batch)
        e1.record()
        torch.cuda.synchronize()
        return {"host_ms": (time.time() - t0) * 1e3,
                "device_ms": e0.elapsed_time(e1),
                "peak_bytes": torch.cuda.max_memory_allocated()}
    steps = [timed_step() for _ in range(2)]
    step = steps[-1]
    step["tokens_per_s"] = b * s / (step["host_ms"] / 1e3)
    print(f"  a step by CUDA events: {[round(t['device_ms'], 1) for t in steps]}"
          f" ms device, {[round(t['host_ms'], 1) for t in steps]} ms host, "
          f"{step['tokens_per_s']:.0f} tokens/s, peak "
          f"{step['peak_bytes'] / 1e9:.2f} GB")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        prof_s = time.time() - t0
    # device time: the union of the operations' intervals
    dev_ops = device_trace.device_ops(prof)
    per = device_trace.by_name(dev_ops)
    kern_ms = device_trace.busy_s(dev_ops) * 1e3

    def named(*keys):
        return sum(d["s"] for n, d in per.items()
                   if any(kk in n for kk in keys)) * 1e3
    top = [{"name": n[:60], "ms": d["s"] * 1e3, "calls": d["launches"]}
           for n, d in sorted(per.items(), key=lambda kv: -kv[1]["s"])[:10]]
    profile = {"wall_ms": prof_s * 1e3, "kernel_ms": kern_ms,
               "busy": kern_ms / (prof_s * 1e3),
               "flash_fwd_ms": named("flash_fwd_kernel"),
               "flash_bwd_ms": named("flash_bwd_"),
               "flash_bwd_parts_ms": {
                   part: named(f"flash_bwd_{part}_kernel")
                   for part in ("prep", "dq", "dkv", "sum")},
               "kernels": len(dev_ops), "top": top}
    bwd_parts = {k2: round(v2, 3)
                 for k2, v2 in profile["flash_bwd_parts_ms"].items()}
    print(f"  torch.profiler step: wall {prof_s * 1e3:.1f} ms, device "
          f"kernels {kern_ms:.1f} ms (busy {profile['busy'] * 100:.1f} %), "
          f"{profile['kernels']} kernels; flash forward "
          f"{profile['flash_fwd_ms']:.2f} ms, flash backward "
          f"{profile['flash_bwd_ms']:.2f} ms {bwd_parts}; top "
          f"{[(t['name'][:40], round(t['ms'], 2), t['calls']) for t in top]}")

    def events_ms(fn, reps=3):
        fn()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps
    hid = (torch.randn(b, s, cfg.d_model, generator=gen, device="cuda")
           .bfloat16().requires_grad_())
    labels = batch["labels"]
    heads = [(lambda x: unembed(x, params["embed"]), [params["embed"]])] + [
        (lambda x, e=e: blocks.exit_head_logits(cfg, e, x), tree_leaves(e))
        for e in params["exit_heads"]]

    def vocab_heads():
        for head, ws in heads:
            for w in ws:
                w.requires_grad_(True)
            ce = softmax_cross_entropy(head(hid), labels)
            torch.autograd.grad(ce, [hid] + ws)
            for w in ws:
                w.requires_grad_(False)
    vocab_ms = events_ms(vocab_heads)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device="cuda").to(p.dtype) * 1e-3,
                     params)
    opt_ms = events_ms(lambda: apply_updates(ocfg, params, grads, opt))
    del grads, hid
    parts = {"vocab_heads_ms": vocab_ms, "optimizer_ms": opt_ms,
             "flash_bwd_ms": profile["flash_bwd_ms"],
             "flash_fwd_ms": profile["flash_fwd_ms"]}
    print(f"  parts of a step (CUDA events): the 3 vocab heads' forward, "
          f"CE and backward {vocab_ms:.1f} ms, apply_updates {opt_ms:.1f} "
          f"ms; attention backward {profile['flash_bwd_ms']:.1f} ms and "
          f"forward {profile['flash_fwd_ms']:.1f} ms (profiler)")
    out["train"].update(step=step, steps=steps, profile=profile, parts=parts)

    del params, opt, batch, model, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the gradient gate: a 4-layer cut at full width, kernel vs plain
    cut = dataclasses.replace(
        cfg, name="granite-3-2b-4l", num_layers=4,
        exits=dataclasses.replace(cfg.exits, exit_layers=(2,)))
    model = Model(cut, device="cuda")
    params = model.init(0)
    gb, gs = GATE_BATCH
    batch = batch_for_model(cut, InputShape("gate", gs, gb, "train"), 0,
                            device="cuda")
    leaves = tree_leaves(params)
    paths = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k2 in t:
                walk(t[k2], f"{pre}/{k2}")
        elif isinstance(t, (list, tuple)):
            for i, v2 in enumerate(t):
                walk(v2, f"{pre}/{i}")
        else:
            paths.append(pre)
    walk(params, "")

    def plain_attention(q, k, v, *, causal=True, window=0):
        return orig_plain[0](q, k, v, causal=causal, window=window)
    kernel_fwd, kernel_bwd = ops.flash_attention, ops.flash_attention_bwd

    def bwd_without_d(q, k, v, o, do, lse, **kw):
        return kernel_bwd(q, k, v, torch.zeros_like(o), do, lse, **kw)

    def gradients(label):
        for p in leaves:
            p.requires_grad_(True)
        ops.reset_launches()
        loss, _ = compute_loss(model, params, batch, tcfg=TrainConfig())
        g = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        for p in leaves:
            p.requires_grad_(False)
        counted = dict(ops.LAUNCHES)
        print(f"  {label}: loss {loss.item():.5f}, launches "
              f"{ {k2: counted[k2] for k2 in ('flash_attention', 'flash_attention_bwd')} }")
        return loss.item(), g, counted
    loss_k, g_kernel, launches["gate"] = gradients("kernels")
    ops.flash_attention = plain_attention
    loss_p, g_plain, counted_p = gradients("plain attention (the yardstick)")
    ops.flash_attention = kernel_fwd
    ops.flash_attention_bwd = bwd_without_d
    loss_c, g_ctrl, counted_c = gradients(
        "planted control (backward without D)")
    ops.flash_attention_bwd = kernel_bwd
    errs = {p: rel_l2(torch, a, w) for p, a, w in zip(paths, g_kernel,
                                                       g_plain)}
    ctrl = {p: rel_l2(torch, a, w) for p, a, w in zip(paths, g_ctrl,
                                                       g_plain)}
    worst = max(errs, key=errs.get)
    worst_c = max(ctrl, key=ctrl.get)
    print(f"  gate over {len(paths)} leaves: worst relative L2 "
          f"{errs[worst]:.3e} at {worst} (tol {GRAD_GATE}); planted control "
          f"worst "
          f"{ctrl[worst_c]:.3e} at {worst_c}; top kernel leaves "
          f"{sorted(errs.items(), key=lambda kv: -kv[1])[:4]}")
    for label, counted in (("kernels", launches["gate"]),
                           ("planted control", counted_c)):
        if counted["flash_attention_bwd"] != cut.num_layers:
            fail(f"phase 14 (c): {label}: the backward kernel did not run "
                 "once a layer")
    if counted_p["flash_attention"] or counted_p["flash_attention_bwd"]:
        fail("phase 14 (c): the yardstick ran the flash kernels")
    if not errs[worst] <= GRAD_GATE:
        fail("phase 14 (c): the kernels' gradients disagree with plain "
             "attention's")
    if not ctrl[worst_c] > GRAD_GATE:
        fail("phase 14 (c): the gradient gate passes a planted fault")
    out["gate"] = {"batch": [gb, gs], "losses": [loss_k, loss_p, loss_c],
                   "worst": [worst, errs[worst]],
                   "control_worst": [worst_c, ctrl[worst_c]],
                   "errors": errs}
    del params, batch, g_kernel, g_plain, g_ctrl, leaves, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) examples/torch/train_100m.py on the card, a checkpoint, a resume
    def example(name):
        spec = importlib.util.spec_from_file_location(
            f"torch_example_{name}",
            os.path.join(HERE, "examples", "torch", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    t100 = example("train_100m")
    ckpt = os.path.join(HERE, "build", "phase14_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    n, half = T100["steps"], T100["ckpt_every"]
    h1 = []
    ops.reset_launches()
    t0 = time.time()
    params, _ = t100.main(["--steps", str(n), "--ckpt-every", str(half),
                           "--ckpt", os.path.join(ckpt, "a"), "--device",
                           "cuda"], history=h1)
    torch.cuda.synchronize()
    run_s = time.time() - t0
    launches["train_100m"] = dict(ops.LAUNCHES)
    first, last = h1[0]["loss"], h1[-1]["loss"]
    print(f"  train_100m: {n} steps in {run_s:.1f} s (two checkpoints "
          f"written), loss {first:.4f} -> {last:.4f} ({last / first:.3f}x; "
          f"must be < 0.8), median step "
          f"{sorted(h['step_s'] for h in h1)[n // 2] * 1e3:.1f} ms host")
    if not last < 0.8 * first:
        fail("phase 14 (d): the 100M model's loss did not fall below 0.8x")
    final = latest_checkpoint(os.path.join(ckpt, "a"))
    back = restore_checkpoint(final, {"params": params})["params"]
    same = all(bits_equal(torch, x, y) for x, y in
               zip(tree_leaves(back), tree_leaves(params)))
    del back, params
    os.makedirs(os.path.join(ckpt, "b"))
    shutil.copy(os.path.join(ckpt, "a", f"ckpt_{half:08d}.npz"),
                os.path.join(ckpt, "b"))
    h2 = []
    t0 = time.time()
    t100.main(["--steps", str(n), "--ckpt-every", str(10 * n), "--ckpt",
               os.path.join(ckpt, "b"), "--device", "cuda"], history=h2)
    resume_s = time.time() - t0
    dev = max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
              for x, y in zip(h2, h1[half:]))
    print(f"  restored final checkpoint bit-identical: {same}; resumed from "
          f"step {half}: {len(h2)} steps in {resume_s:.1f} s, losses within "
          f"{dev:.2e} relative of the uninterrupted run (tol {RESUME_RTOL})")
    shutil.rmtree(ckpt, ignore_errors=True)
    if not same:
        fail("phase 14 (d): a restored tensor differs from the saved one")
    if len(h2) != n - half or not dev <= RESUME_RTOL:
        fail("phase 14 (d): the resumed run departs from the uninterrupted")
    out["train_100m"] = {"steps": n, "wall_s": run_s, "first_loss": first,
                         "last_loss": last, "resume_s": resume_s,
                         "resume_dev": dev,
                         "losses": [h["loss"] for h in h1],
                         "step_ms": [h["step_s"] * 1e3 for h in h1]}
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the other three examples on the card
    out["examples"] = {}
    for name in ("quickstart", "resilient_inference",
                 "collaborative_serving"):
        ops.reset_launches()
        t0 = time.time()
        res = example(name).main(["--device", "cuda"])
        torch.cuda.synchronize()
        launches[name] = dict(ops.LAUNCHES)
        wall = time.time() - t0
        print(f"  {name}: {wall:.1f} s; launches "
              f"{ {k2: v2 for k2, v2 in launches[name].items() if v2} }")
        out["examples"][name] = {"wall_s": wall}
        if name == "quickstart":
            out["examples"][name]["losses"] = [res["losses"][0],
                                               res["losses"][-1]]
        if name == "resilient_inference":
            out["examples"][name]["ce"] = res
    for name, kname in (("quickstart", "flash_attention_bwd"),
                        ("resilient_inference", "flash_attention_bwd"),
                        ("collaborative_serving", "exit_head_entropy")):
        if launches[name][kname] <= 0:
            fail(f"phase 14 (e): {name} launched no {kname}")
    out["wall_s"] = time.time() - t_phase
    print(f"phase 14 wall time {out['wall_s']:.1f}s")
    return out, launches


GUARD_LAYERS = 16      # phase 15 (a)'s depth cut (exits after 5 and 10)
GUARD_WAVES = 2        # ... two waves of 8 requests on 16 slots
GUARD_MAX_NEW = 48     # six windows of 8 a request
BRIDGE_LAYERS = 8      # phase 15 (b)'s draft/target cut (exits after 3, 6)
# phase 15 (b)'s trace: granite-3-2b as the draft ("small") and the target
# ("big") behind a high-RTT access link, the routes priced with
# granite-3-2b's and deepseek-v3's published configs, paged arenas and a
# bridge at k 4; two requests for the target first (routed to the
# speculative bridge), then four for the draft model on the device tier,
# which dies at 1.6 s of virtual time with a slot in flight (prompts of
# 8-16 tokens from seed 3, max_new 10, 0.05 s apart: a slot migrates, the
# bridge completes one request and the drain requeues the rest onto the
# surviving tiers)
BRIDGE_MODELS = ("big", "big", "small", "small", "small", "small")
BRIDGE_OUTAGE = ("device", 1.6)
BRIDGE_SEED = 3


def run_guards(torch, ops):
    """Phase 15: the analyzer's runtime guards and cost check on the card
    (see the module docstring).  Returns its summary and the launch counts
    of (a), (b) and (c)."""
    import numpy as np
    from repro_torch.analysis import (TOLERANCE, GuardError, SlotAudit,
                                      build_audit_stack, check_cost_graphs,
                                      guard_polling, guard_sync_budget,
                                      no_recompile)
    from repro_torch.configs import get_config
    from repro_torch.core import Scenario, TierOutage, paradigms
    from repro_torch.launch import kernel_ab as ab
    from repro_torch.models import Model
    from repro_torch.serving import (ClusterConfig, ContinuousBatchScheduler,
                                     ModelGroup, Request, SchedulerConfig,
                                     TieredServingCluster)
    t_phase = time.time()
    out, launches = {}, {}

    # (a) granite at full width, cut in depth, paged with the prefix cache,
    # async windows of 8, two waves of 8 requests sharing two prefixes
    cfg = depth_cut(get_config("granite-3-2b"), GUARD_LAYERS, (5, 10))
    model = Model(cfg, device="cuda")
    params = model.init(0)
    rs = np.random.RandomState(15)
    prefixes = [rs.randint(0, cfg.vocab_size, 32) for _ in range(2)]
    waves = [[np.concatenate([prefixes[j % 2], rs.randint(
        0, cfg.vocab_size, int(rs.randint(8, 33)))]) for j in range(8)]
        for _ in range(GUARD_WAVES)]

    def pool():
        return ContinuousBatchScheduler(model, params, SchedulerConfig(
            n_slots=16, max_len=112, prefill_chunk=16, exit_threshold=0.5,
            segmented=False, paged=True, page_size=16, prefix_cache=True,
            async_decode=True, readback_interval=8),
            device="cuda")

    def admit(s, w):
        reqs = [Request(tokens=p, max_new=GUARD_MAX_NEW, req_id=8 * w + j)
                for j, p in enumerate(waves[w])]
        for r in reqs:
            s.submit(r)
        while s.queue or s._pending is not None:
            s.prefill_poll()
        return reqs

    print(f"guards: granite-3-2b at full width cut to {cfg.num_layers} "
          f"layers, paged + prefix cache, 16 slots, windows of 8; "
          f"{GUARD_WAVES} waves of 8 requests over two 32-token prefixes, "
          f"max_new {GUARD_MAX_NEW}")
    plain = pool()
    want = []
    for w in range(GUARD_WAVES):
        reqs = admit(plain, w)
        while plain.has_work:
            plain.poll()
        want += [list(r.out_tokens) for r in reqs]
    del plain
    s = pool()
    controls = {}
    ops.reset_launches()
    t0 = time.time()
    with SlotAudit(s) as audit:
        got = admit(s, 0)
        while s.has_work:              # the first window's capture
            s.poll()
        got += admit(s, 1)
        stats = []
        with no_recompile(s), guard_polling(s), \
                guard_sync_budget(s, bound=1) as st:
            s.poll()                   # a fresh dispatch
            s.poll()                   # one from the carry, the first ring
        stats.append(dict(st))
        # (d) planted: one live page's refcount bumped
        slot = int(np.nonzero(s.active)[0][0])
        pg = int(s._tbl[slot, 0])
        s.page_alloc.refcount[pg] += 1
        try:
            audit.check()
            fail("phase 15 (d): SlotAudit passed a bumped page refcount")
        except GuardError as e:
            controls["refcount"] = str(e).splitlines()[1].strip()
        finally:
            s.page_alloc.refcount[pg] -= 1
        # (d) planted: one .item() more in a poll that reads a ring
        served = s.poll

        def planted(*a, **kw):
            rep = served(*a, **kw)
            s._counters.sum().item()
            return rep
        s.poll = planted
        try:
            with guard_sync_budget(s, bound=1):
                s.poll()
            fail("phase 15 (d): guard_sync_budget passed a poll with an "
                 "extra .item()")
        except GuardError as e:
            controls["item"] = str(e)
        finally:
            s.poll = served
        with no_recompile(s), guard_polling(s), \
                guard_sync_budget(s, bound=1) as st:
            while s.has_work:
                s.poll()
        stats.append(dict(st))
    torch.cuda.synchronize()
    launches["serve"] = dict(ops.LAUNCHES)
    wall = time.time() - t0
    # (d) planted: layer 0's K pool rebound under the built window
    blocks = s.cache["blocks"]
    first = blocks[0]
    try:
        with no_recompile(s):
            blocks[0] = (first[0].clone(),) + tuple(first[1:])
        fail("phase 15 (d): no_recompile passed a rebound cache leaf")
    except GuardError as e:
        controls["rebind"] = str(e)[:160]
    finally:
        blocks[0] = first
    toks = [list(r.out_tokens) for r in got]
    polls = sum(x["polls"] for x in stats)
    out["serve"] = {"wall_s": wall, "audited_polls": audit.polls,
                    "guarded_polls": polls,
                    "syncs": sum(x["syncs"] for x in stats),
                    "max_per_poll": max(x["max_per_poll"] for x in stats),
                    "prefix_hit_tokens": s.prefix_hit_tokens,
                    "builds": s.jit_cache_sizes()}
    print(f"  (a) {json.dumps(out['serve'])}; launches "
          f"{ {k: v for k, v in launches['serve'].items() if v} }")
    if toks != want:
        fail("phase 15 (a): the guarded run's tokens differ from an "
             "unguarded pool's")
    if any(len(t) != GUARD_MAX_NEW for t in toks):
        fail("phase 15 (a): a request is short")
    if audit.polls <= 0 or polls <= 0 or out["serve"]["syncs"] < 1 \
            or out["serve"]["max_per_poll"] > 1:
        fail("phase 15 (a): the guards saw no poll or no ring readback")
    if s.prefix_hit_tokens <= 0:
        fail("phase 15 (a): the second wave hit no shared prefix")
    if s.jit_cache_sizes() != {"decode_window": 1}:
        fail(f"phase 15 (a): builds {s.jit_cache_sizes()}")
    if launches["serve"]["paged_gqa_attention"] <= 0:
        fail("phase 15 (a): paged attention was not launched")
    del s, model, params
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the tiered cluster with a migration and the speculative bridge
    cut = depth_cut(get_config("granite-3-2b"), BRIDGE_LAYERS, (3, 6))
    bm = Model(cut, device="cuda")
    bp = bm.init(0)
    sc = dataclasses.replace(Scenario.high_rtt_access(),
                             outages=(TierOutage(*BRIDGE_OUTAGE),))
    cl = TieredServingCluster(
        ModelGroup([("small", bm, bp), ("big", bm, bp)]), scenario=sc,
        plan_cfg={"small": get_config("granite-3-2b"),
                  "big": get_config("deepseek-v3-671b")},
        cfg=ClusterConfig(base_slots=2, max_len=48, prefill_chunk=8,
                          exit_threshold=0.0, spec_draft="small", spec_k=4,
                          paged=True, page_size=16))
    rs = np.random.RandomState(BRIDGE_SEED)
    lens = rs.randint(8, 17, len(BRIDGE_MODELS))
    crs = [cl.submit(rs.randint(0, cut.vocab_size, int(n)), max_new=10,
                     arrival=0.05 * i, model=m)
           for i, (n, m) in enumerate(zip(lens, BRIDGE_MODELS))]
    ops.reset_launches()
    t0 = time.time()
    with SlotAudit(cl) as audit_b:
        cl.run()
    torch.cuda.synchronize()
    launches["cluster"] = dict(ops.LAUNCHES)
    st_b = cl.stats()
    spec = st_b.get("speculative", {})
    out["cluster"] = {"wall_s": time.time() - t0,
                      "audited_polls": audit_b.polls,
                      "routes": st_b["route_counts"],
                      "dead": st_b.get("dead_tiers"),
                      "migrations": st_b["migration"]["outage_migrations"],
                      "requeued": st_b["migration"]["requeued"],
                      "speculative_completed": spec.get(
                          "requests_completed", 0)}
    print(f"  (b) granite-3-2b cut to {cut.num_layers} layers as draft and "
          f"target, device outage at {BRIDGE_OUTAGE[1]} s: "
          f"{json.dumps(out['cluster'])}")
    if not all(cr.done and len(cr.req.out_tokens) == 10 for cr in crs):
        fail("phase 15 (b): a cluster request did not complete")
    if out["cluster"]["migrations"] < 1 \
            or out["cluster"]["speculative_completed"] < 1 \
            or audit_b.polls <= 0:
        fail("phase 15 (b): no migration, no bridge request or no audit")
    if launches["cluster"]["paged_gqa_attention"] <= 0:
        fail("phase 15 (b): paged attention was not launched")
    del cl, bm, bp
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the cost check at full width, kernels launching
    full = get_config("granite-3-2b")
    fm = Model(full, device="cuda")
    fp = fm.init(0)

    def arena(**kw):
        return ContinuousBatchScheduler(fm, fp, SchedulerConfig(
            n_slots=16, max_len=256, prefill_chunk=16, **kw), device="cuda")
    stack = {"paged": arena(paged=True, page_size=16, prefix_cache=True),
             "monolithic": arena(segmented=False), "_model": fm}
    ops.reset_launches()
    findings, ratios = check_cost_graphs(stack)
    torch.cuda.synchronize()
    launches["cost"] = dict(ops.LAUNCHES)
    for key, r in ratios.items():
        print(f"  (c) {key}: measured {r['measured_flops_per_token']:.6e} "
              f"FLOPs/token (kernels {r['kernel_flops_per_token']:.6e}), "
              f"analytic {r['analytic_flops_per_token']:.6e}, ratio "
              f"{r['ratio']:.4f}")
    out["cost"] = ratios
    if findings or not all(TOLERANCE[0] <= r["ratio"] <= TOLERANCE[1]
                           for r in ratios.values()):
        fail(f"phase 15 (c): cost ratios outside {TOLERANCE}")
    if launches["cost"]["paged_gqa_attention"] != full.num_layers:
        fail(f"phase 15 (c): {launches['cost']['paged_gqa_attention']} "
             f"paged-attention launches, not {full.num_layers}")
    # (d) planted: the analytic cost scaled by 4
    real = paradigms.analytic_step_cost

    def scaled(c, b, n):
        a = real(c, b, n)
        return dataclasses.replace(a, flops_per_token=4 * a.flops_per_token)
    paradigms.analytic_step_cost = scaled
    try:
        tripped, _ = check_cost_graphs(stack)
    finally:
        paradigms.analytic_step_cost = real
    if sorted({f.rule for f in tripped}) != ["CST001"] \
            or len(tripped) != len(ratios):
        fail("phase 15 (d): CST001 did not fire on every arena of a "
             "scaled analytic cost")
    controls["cost"] = tripped[0].message
    del stack, fm, fp
    gc.collect()
    torch.cuda.empty_cache()
    # ... and the smoke audit stack counts the same on the card as here
    # on the CPU (each kernel's formula against its plain version's aten
    # products)
    card = check_cost_graphs(build_audit_stack("cuda"))[1]
    host = check_cost_graphs(build_audit_stack("cpu"))[1]
    same = {k: card[k]["measured_flops_per_token"]
            == host[k]["measured_flops_per_token"] for k in host}
    print(f"  (c) smoke audit stack, card vs CPU FLOPs/token equal: {same}")
    if set(card) != set(host) or not all(same.values()):
        fail("phase 15 (c): a stage counts differently on the card")
    out["controls"] = controls
    print(f"  (d) planted controls all failed as they must: "
          f"{json.dumps(controls)[:600]}")

    # (e) the serving kernels launched from a second host thread
    calls = ab.serving_calls(torch.Generator(device="cuda").manual_seed(15))
    main_out = {k: fn() for k, fn in calls.items()}
    torch.cuda.synchronize()
    thread_out, errors = ab.launch_in_thread(calls)
    if errors:
        fail(f"phase 15 (e): a launch from a second thread failed: {errors}")
    bits = {k: bool(torch.equal(thread_out[k], main_out[k])) for k in calls}
    print(f"  (e) launched from a second host thread, bits equal to the "
          f"main thread's: {bits}")
    if not all(bits.values()):
        fail("phase 15 (e): a second thread's launch gave other bits")
    out["second_thread"] = bits
    out["wall_s"] = time.time() - t_phase
    print(f"phase 15 wall time {out['wall_s']:.1f}s")
    return out, launches


COLLAB_TOKENS = (4, 1024)      # phase 16 (a)'s batch
COLLAB_SPLIT = 20              # ... its exit (block boundary) layer
COLLAB_MOE_TOKENS = (2, 2048)  # phase 16 (b)'s x
COLLAB_MOE_TOL = 2e-2          # PERF.md section 2's W8A8 MoE gate
COLLAB_AUX_TOL = 1e-3


def _sum_launches(counts):
    total = {}
    for c in counts:
        for k, n in c.items():
            total[k] = total.get(k, 0) + n
    return total


def run_collab(torch, card_line):
    """Phase 16 (see the module docstring).  Returns a summary and the
    launch counts each part's ranks report, summed over the ranks."""
    import hashlib
    import shutil
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import Model, ffn
    t_phase = time.time()
    out, launches = {"card": card_line}, {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_collab_")

    def world(job):
        path = os.path.join(tmp, f"{job['name']}_jobs.pt")
        torch.save([job], path)
        t0 = time.time()
        run_world(2, "repro_torch.launch.collab:run_jobs", path, tmp,
                  threads=0)
        wall = time.time() - t0
        return [torch.load(os.path.join(tmp, f"{job['name']}.{r}.pt"),
                           weights_only=False) for r in (0, 1)], wall

    # (a) staged granite-3-2b, 20/20 over two pods
    cfg = depth_cut(get_config("granite-3-2b"), 40, (COLLAB_SPLIT,))
    tokens = torch.randint(0, cfg.vocab_size, COLLAB_TOKENS,
                           generator=torch.Generator().manual_seed(16))
    ranks, world_s = world(dict(
        kind="staged", name="staged", mesh=dict(pod=2), device="cuda",
        cfg=cfg, stages=[0, 1], seed=0, batch={"tokens": tokens},
        runs=[False, True], warmup=True))
    for o in ranks:
        raw, comp = o["runs"]
        print(f"  (a) rank {o['rank']} (pod {o['coords']['pod']}): blocks "
              f"{o['blocks']}, {o['param_bytes'] / 1e9:.2f} GB of weights "
              f"made in {o['init_s']:.1f}s, peak {o['peak_bytes'] / 1e9:.2f}"
              f" GB; raw run {raw['wall_ms']:.1f} ms, int8 run "
              f"{comp['wall_ms']:.1f} ms")
        for label, run in (("raw", raw), ("int8", comp)):
            for h in run["handoffs"]:
                print(f"      {label} boundary after block {h['block']}: "
                      f"{h['side']} {h['bytes']} bytes in {h['ms']:.2f} ms")
            print(f"      {label} launches {run['launches']}")
    model = Model(cfg, device="cuda")
    params = model.init(0)
    t0 = time.time()
    want = model.forward(params, {"tokens": tokens.cuda()}).logits
    torch.cuda.synchronize()
    fwd_ms = (time.time() - t0) * 1e3
    digest = hashlib.sha256(want.cpu().contiguous().view(torch.uint8)
                            .numpy().tobytes()).hexdigest()
    del model, params, want
    gc.collect()
    torch.cuda.empty_cache()
    raw_equal = all(o["runs"][0]["digest"] == digest for o in ranks)
    d_int8 = [o["compressed_vs_raw"] for o in ranks]
    sends = [h for o in ranks for h in o["runs"][1]["handoffs"]
             if h["side"] == "send"]
    recvs = [h for o in ranks for h in o["runs"][1]["handoffs"]
             if h["side"] == "recv"]
    raw_h = {h["side"]: h for o in ranks for h in o["runs"][0]["handoffs"]
             if h["side"] != "head"}
    heads = [h["ms"] for o in ranks for r in o["runs"]
             for h in r["handoffs"] if h["side"] == "head"]
    print(f"  (a) staged granite-3-2b ({cfg.num_layers} layers, blocks "
          f"{COLLAB_SPLIT}/{cfg.num_layers - COLLAB_SPLIT}) on "
          f"{COLLAB_TOKENS[0]} x {COLLAB_TOKENS[1]} tokens, world of 2 in "
          f"{world_s:.1f}s: raw logits == one-process forward "
          f"({fwd_ms:.1f} ms) bit for bit: {raw_equal}; boundary raw "
          f"{raw_h['send']['bytes']} bytes (send {raw_h['send']['ms']:.2f} "
          f"+ land {raw_h['recv']['ms']:.2f} ms), int8 {sends[0]['bytes']} "
          f"bytes (quantize + send {sends[0]['ms']:.2f} + land and "
          f"dequantize {recvs[0]['ms']:.2f} ms); logits broadcast "
          f"{min(heads):.1f}-{max(heads):.1f} ms; int8 vs raw logits max "
          f"{max(d_int8):.4f}")
    if not all(r["finite"] for o in ranks for r in o["runs"]):
        fail("phase 16 (a): staged logits are not finite")
    if not raw_equal:
        fail("phase 16 (a): the raw staged logits differ from the "
             "one-process forward")
    if not (len(sends) == len(recvs) == 1 and sends[0]["q_equal"]
            and sends[0]["scale_equal"] and recvs[0]["x_equal"]):
        fail("phase 16 (a): the int8 boundary differs from the plain "
             "quantizer / dequantizer")
    if not all(0.0 < d < 1.0 for d in d_int8):
        fail(f"phase 16 (a): int8 vs raw logits {d_int8} outside (0, 1)")
    launches["staged_raw"] = _sum_launches(o["runs"][0]["launches"]
                                           for o in ranks)
    launches["staged_int8"] = _sum_launches(o["runs"][1]["launches"]
                                            for o in ranks)
    for part in ("staged_raw", "staged_int8"):
        if launches[part]["flash_attention"] != cfg.num_layers:
            fail(f"phase 16 (a): {launches[part]['flash_attention']} flash "
                 f"launches in {part}, not {cfg.num_layers}")
    if (launches["staged_int8"]["quantize_rows"] != 1
            or launches["staged_int8"]["dequantize_rows"] != 1):
        fail("phase 16 (a): the int8 boundary did not launch the int8 pair")
    out["staged"] = {
        "world_s": world_s, "forward_ms": fwd_ms, "raw_equal": raw_equal,
        "broadcast_ms": heads,
        "int8_vs_raw": d_int8,
        "ranks": [dict({k: o[k] for k in (
            "rank", "coords", "blocks", "param_bytes", "init_s",
            "peak_bytes", "compressed_vs_raw")}, runs=[
                {k: r[k] for k in ("compress", "wall_ms", "launches",
                                   "handoffs")} for r in o["runs"]])
            for o in ranks]}

    # (b) one llama4-maverick MoE layer, W8A8, 64 experts a rank
    lcfg = get_config("llama4-maverick-400b-a17b")
    x = (0.5 * torch.randn(*COLLAB_MOE_TOKENS, lcfg.d_model,
                           generator=torch.Generator().manual_seed(17))
         ).bfloat16()
    ranks, world_s = world(dict(
        kind="moe", name="moe", mesh=dict(model=2), device="cuda",
        cfg=lcfg, x=x, seed=13, w8a8=True, warmup=True))
    for o in ranks:
        print(f"  (b) rank {o['rank']} (model {o['coords']['model']}): "
              f"{o['local_experts']} experts made and quantized in "
              f"{o['init_s']:.1f}s, peak {o['peak_bytes'] / 1e9:.2f} GB; "
              f"layer {o['wall_ms']:.1f} ms after a warm-up call, its "
              f"bf16 combine all_reduce alone {o['combine_ms']:.1f} ms; "
              f"launches {o['launches']}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    full = ffn.init_moe_layer(lcfg, 13, "cuda", w8a8=True)
    torch.cuda.synchronize()
    full_init_s = time.time() - t0
    ffn.moe_ffn(full, x.cuda(), lcfg)                 # warm-up
    torch.cuda.synchronize()
    t0 = time.time()
    y1, aux1 = ffn.moe_ffn(full, x.cuda(), lcfg)
    torch.cuda.synchronize()
    full_ms = (time.time() - t0) * 1e3
    parent_peak = torch.cuda.max_memory_allocated()
    y1, aux1 = y1.float().cpu(), float(aux1)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    errs = [float((o["y"].float() - y1).abs().max()) for o in ranks]
    within = all(bool(((o["y"].float() - y1).abs()
                       <= COLLAB_MOE_TOL * y1.abs().clamp(min=1.0)).all())
                 for o in ranks)
    aux_err = max(abs(float(o["aux"]) - aux1) for o in ranks)
    print(f"  (b) expert-parallel llama4 MoE layer ({lcfg.moe.num_experts} "
          f"experts of {lcfg.moe.d_ff_expert}, W8A8) on "
          f"{COLLAB_MOE_TOKENS[0]} x {COLLAB_MOE_TOKENS[1]} tokens, world "
          f"of 2 in {world_s:.1f}s; single-device layer made in "
          f"{full_init_s:.1f}s, {full_ms:.1f} ms, parent peak "
          f"{parent_peak / 1e9:.2f} GB: y max abs err {max(errs):.3e}, aux "
          f"err {aux_err:.3e}")
    if not within or aux_err >= COLLAB_AUX_TOL:
        fail(f"phase 16 (b): the expert-parallel layer is off the "
             f"single-device one: y {errs}, aux {aux_err}")
    if not all(o["local_experts"] == lcfg.moe.num_experts // 2
               and o["launches"]["w8a8_expert_matmul"] == 3 for o in ranks):
        fail("phase 16 (b): a rank did not hold half the experts or did "
             "not launch the W8A8 GEMM for its three products")
    launches["moe_ep"] = _sum_launches(o["launches"] for o in ranks)
    out["moe"] = {"world_s": world_s, "full_init_s": full_init_s,
                  "full_ms": full_ms, "parent_peak_bytes": parent_peak,
                  "y_max_abs_err": errs, "aux_err": aux_err,
                  "ranks": [{k: o[k] for k in (
                      "rank", "coords", "local_experts", "init_s",
                      "wall_ms", "combine_ms", "peak_bytes", "launches")}
                      for o in ranks]}
    shutil.rmtree(tmp, ignore_errors=True)
    for kname in ("quantize_rows", "dequantize_rows", "flash_attention",
                  "w8a8_expert_matmul"):
        by_part = {p: n[kname] for p, n in launches.items()}
        print(f"  launches of {kname} by part: {by_part}")
    out["wall_s"] = time.time() - t_phase
    print(f"phase 16 wall time {out['wall_s']:.1f}s")
    return out, launches


TOOLING_MAX_SHARE = 1.05    # profile_pair's: a count above the card's work
TOOLING_WALL_S = 90.0       # phase 17's time budget
# phase 16's per-rank bytes at 4 x 1024 tokens of granite-3-2b: the
# boundary [4, 1024, 2048] bf16 raw, int8 rows plus fp32 row scales, and
# the logits [4, 1024, 49,155] fp32
TOOLING_BOUNDARY = {"raw": 4 * 1024 * 2048 * 2,
                    "int8": 4 * 1024 * (2048 + 4)}
TOOLING_BROADCAST = 4 * 1024 * 49155 * 4


def run_tooling(torch, card_line):
    """Phase 17 (see the module docstring).  Returns a summary and the
    kernel launches of each part's counted run."""
    from repro_torch.launch import dryrun, profile_pair
    t_phase = time.time()
    out, launches = {"card": card_line}, {}

    # (a) the dry run on meta
    out["dryrun"] = []
    for arch, shape, mesh in (("granite-3-2b", "decode_32k", "single"),
                              ("deepseek-v3-671b", "train_4k", "multi")):
        t0 = time.time()
        r = dryrun.dryrun_one(arch, shape, mesh, save=False)
        if r["status"] != "ok":
            fail(f"phase 17 (a): dry run of {arch} {shape} {mesh}: {r}")
        rl = r["roofline"]
        print(f"  (a) dryrun {arch} {shape} {mesh} ({r['chips']} chips, "
              f"{time.time() - t0:.1f}s on meta): {r['status']}, arguments "
              f"{r['argument_bytes'] / 1e9:.2f} GB a device "
              f"{r['argument_bytes_per_device']}, fits_80gb "
              f"{r['fits_80gb']} (arguments only); a device: flops "
              f"{rl['hlo_flops']:.4e}, bytes {rl['hlo_bytes']:.4e}, "
              f"bottleneck {rl['bottleneck']}, model/counted "
              f"{rl['useful_flops_ratio']:.3f}")
        out["dryrun"].append({k: r[k] for k in (
            "arch", "shape", "mesh", "status", "chips", "argument_bytes",
            "argument_bytes_per_device", "fits_80gb", "roofline")})

    # (b) the forward and (c) the decode step, on this card
    for part, shape, batch, seq in (("prefill", "prefill_32k", 8, 2048),
                                    ("decode", "decode_32k", 16, 4096)):
        r = profile_pair.profile_step("granite-3-2b", shape, batch=batch,
                                      seq=seq)
        label = "(b)" if part == "prefill" else "(c)"
        print(f"  {label} {card_line}: device {r['device_ms']:.3f} ms, "
              f"busy {r['busy']:.3f}, bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']}, share {r['share']:.4f}, mfu "
              f"{r['mfu']:.4f}, peak {r['peak_bytes'] / 1e9:.2f} GB")
        if not (math.isfinite(r["share"]) and 0 < r["share"]
                <= TOOLING_MAX_SHARE):
            fail(f"phase 17 {label}: share {r['share']} outside (0, "
                 f"{TOOLING_MAX_SHARE}]")
        launches[part] = r["launches"]
        out[part] = {k: v for k, v in r.items() if k != "top_bytes"}
        out[part]["top_bytes"] = [[label_, b] for label_, (b, _) in
                                  r["top_bytes"]]
        gc.collect()
        torch.cuda.empty_cache()
    if launches["prefill"]["flash_attention"] != 40:
        fail(f"phase 17 (b): {launches['prefill']['flash_attention']} flash "
             "launches in the counted forward, not 40")

    # (d) staged raw and int8 on two ranks
    st = profile_pair.profile_staged("granite-3-2b", "prefill_32k",
                                     ["raw", "int8"], batch=4, seq=1024)
    for o in st["ranks"]:
        for run in o["runs"]:
            got = (run["collective"]["collective-permute"],
                   run["collective"]["broadcast"])
            want = (TOOLING_BOUNDARY[run["mode"]], TOOLING_BROADCAST)
            print(f"  (d) rank {o['rank']} {run['mode']}: boundary "
                  f"{got[0]:.0f} B, broadcast {got[1]:.0f} B (phase 16: "
                  f"{want[0]}, {want[1]}); flops {run['flops']:.4e}, bytes "
                  f"{run['bytes']:.4e}, {run['wall_ms']:.1f} ms")
            if got != want:
                fail(f"phase 17 (d): rank {o['rank']} {run['mode']} "
                     f"collective bytes {got}, phase 16 recorded {want}")
    for i, mode in enumerate(("raw", "int8")):
        launches["staged_" + mode] = _sum_launches(
            o["runs"][i]["launches"] for o in st["ranks"])
    out["staged"] = st
    int8 = launches["staged_int8"]
    rows = {"quantize_rows": int8["quantize_rows"],
            "dequantize_rows": int8["dequantize_rows"],
            "flash_attention": launches["prefill"]["flash_attention"]}
    print(f"  rows 4-6 launched: {rows}; staged launches "
          f"{launches['staged_raw']} / {int8}")
    if rows["quantize_rows"] != 1 or rows["dequantize_rows"] != 1:
        fail(f"phase 17 (d): the int8 boundary launched {rows}")
    out["wall_s"] = time.time() - t_phase
    print(f"phase 17 wall time {out['wall_s']:.1f}s")
    if out["wall_s"] > TOOLING_WALL_S:
        fail(f"phase 17 took {out['wall_s']:.1f}s, over "
             f"{TOOLING_WALL_S}s")
    return out, launches


if __name__ == "__main__":
    main()
