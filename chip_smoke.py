#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line (any failure exits nonzero):

1. build   — nvcc builds every CUDA kernel of the FastEGNN serving and
             training paths and the LM prefill from
             ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. swa_kernel — the LM slice's two sliding-window attention kernels
             against their plain version (the port of
             ``_chunked_attention``) at gemma3-12b's prefill shape (B = 1,
             S = 8,192, 16 heads over 8 KV heads, D = 256): the bf16
             kernel (``wgmma`` + TMA) on bf16 inputs, the f32 kernel
             (3xTF32 ``mma.sync``) on f32, each with a bitwise repeat;
             CUDA-event times of each kernel, the plain version and the
             SDPA yardstick in its dtype, and each kernel's device time
             (``torch.profiler``), for the SWA (window 1,024) and the
             global (causal) layer; and a planted fault, each kernel with
             the window one too wide, which must land outside its
             tolerance.  It runs first: after the
             FastEGNN phases ``torch.profiler`` recorded no device
             activity for these calls on an H100.
3. kernels — each of the six kernels (edge and virtual forward, edge and
             virtual backward, MMD cross sum and gradient) against its
             plain PyTorch version on the card, with CUDA-event times of
             kernel and plain version and a bitwise repeat check.  The
             four FastEGNN kernels run at the serving shapes (N = 8,192
             nodes, 8,192 x 32 edge slots of a fluid scene built at
             r + skin, hidden 64, C = 3), each with a planted fault (one
             live slot's mask zeroed, one node's mask flipped, in the
             kernel's call only) that must land outside the tolerance, and
             a second bound at the TF32 tensor-core rate (their products
             run as 3xTF32).  The MMD pair runs batched, as the trainer
             calls it, at the train step's shape (B = 4 scenes of 7,800
             particles in 8,192-node buckets) and at Fluid113K's (B = 1,
             113,000 particles in a 131,072 bucket): also each graph alone
             against its row of the batch (bitwise), the host time of the
             wrapper alone, a planted fault (one live node's mask
             flipped), and the host time of the MMD term of a train step,
             batched and graph by graph; and ``kernels.ops.
             mmd_loss_kernel`` (Eq. 10 of one graph over the pair) on the
             train batch's first graph against its plain version, loss
             and gradients, one launch of each kernel, a planted fault
             (one node masked out).  Every kernel also gets the
             device kernels one call launches, with their device times
             (``torch.profiler``): one a call for each of the MMD pair.
             The identity-gate branch of the edge pathway (RF, SchNet) is
             two more rows, edge_identity and edge_identity_bwd, at the
             serving shapes in SchNet's form (Dh = 64, rel raw) with an
             ``rf_form`` reading (Dh = 1, inv1p) each: against the plain
             versions, a bitwise repeat, a planted fault (one live slot's
             mask zeroed), times, the device kernels a call and the bound.
             The FastEGNN rows again at hidden 32 (the Table I model's
             layer: every reference entry point's width) go into each
             row's ``hidden32`` entry.
   widths  — #1 to #4 and the identity pair (SchNet's and RF's forms)
             alone on the serve Verlet list at every width of
             WIDTH_CASES: 16, 24, 32, 48, 64, 96, 128, 226 (the widest the
             reference's budget admits at N = 8,192) and Dh 24 / H1 40 / M
             56; #1 and #2 at 512 on a 100-node graph.  Each against its
             plain version (ATOL / RTOL, GATOL / GRTOL), a bitwise repeat
             and a planted fault; at widths 32 and 128 two CTA counts,
             bitwise equal (the edge backward's weight gradients, whose
             order follows its CTA count, within the tolerance); events and
             device times and the bounds per width, and the route each
             took (w32, w64: the compiled widths, the rest padded up to
             them; panel: above 64).  Each row of the kernels line carries
             them in its ``widths`` entry.
   widths_bf16 — the same kernels with ``precision='bf16'`` at every
             width of BF_WIDTH_CASES (16, 32, 48, 64, 128, 226: the
             compiled widths, padded ones and the panel path) against
             their bf16 plain versions (``kernels.ref.*_bf16``, the
             Pallas kernels' casts): compare_bf16 (relative L2, elementwise
             two bf16 roundings, the virtual forward's sums), a bitwise
             repeat, the planted fault, two CTA counts at CTA_WIDTHS, and
             engaged (some output BF_ENGAGED away from the f32 kernel's);
             times and bounds (h, x and the weights at 2 bytes, the bf16
             and TF32 rates).  Each FastEGNN row of the kernels line
             carries its width-64 reading as ``bf16`` (its hidden32 entry
             the width-32 one) and all of them as ``widths_bf16``.
   bf16_edge — the bf16 kernels on bf16 tiles (#1, #2, the identity
             backward in SchNet's and RF's forms, #3, #4): device ms at 64
             and 32 from widths_bf16 and, for #1 to #4, the CTAs an SM
             the card holds (two at least), beside the figures before
             their redesign (BF_EDGE_PARENT).
   identity_f32 — the identity pair in f32 on its tile route (Dh and
             H1 up to 64: tile products for the projection and the
             backward's node pass): device ms and the split by kernel of
             the forward and the backward in SchNet's and RF's forms at
             hidden 64 and 32, from the kernels phase's rows, beside the
             figures before (IDN_F32_PARENT).
   identity_fwd — the identity forward on its edge-parallel tile pass
             (idn_fwd_tiles, Dh and H1 up to 64), f32 (the kernels
             phase's rows) and bf16 (widths_bf16), SchNet's and RF's
             forms at 64 and 32: device ms and its µs split (the
             projection, which also writes the CSR by-products, and the
             tile pass) beside the figures before (IDN_FWD_PARENT).
4. serve  — a full-width FastEGNN (random weights from a seed) behind
             ``RolloutService`` with max_batch 4: four 7,800-particle
             fluid scenes, 20 steps each, the Verlet lists rebuilt on the
             card (``data/cell_list.py``, the service's default).  Checks
             every frame, the kernel launch counts, the first frame
             against the plain path, and that the served engine rebuilt
             on the device with no coordinate fetch and no edge upload.
             Then the same scenes through ``BatchedRolloutEngine`` with
             the kernels for a few steps, device against host rebuilds:
             trajectories bitwise equal, seconds a rebuild of each mode,
             and the device build of the four slots alone (CUDA events).
5. scale   — one forward step of a 113,000-particle scene (bucket
             131,072) through ``predict_fn``, timed, and one step profiled
             (device time, idle share, top kernels); the scene's graph is
             also built on the card, bitwise against the host build,
             timed (CUDA events) with its peak memory.
   simulate — ``python -m repro_torch.launch.simulate --n 7800 --steps
             20 --use-kernel`` in a process of its own: exit 0, steps/s,
             and from its output the reference's model (2 layers, hidden
             32, C = 3, s_dim 16) served by the kernels: no plain
             dispatch, edge and virtual launches, all on the w32 route.
   zoo     — every registry model (linear, mpnn, egnn, rf, schnet, tfn,
             fast_egnn, fast_rf, fast_schnet, fast_tfn) at full width
             (4 layers, hidden 64, C = 3 and s_dim 64 for the fast_*
             ones; random weights from seed 0) with ``use_kernel=True``,
             beside a plain pipeline with the same weights: ``predict_fn``
             on the four serve scenes batched as serve batches them,
             within FRAME_TOL of the plain path (relative to the largest
             coordinate where that exceeds 1), with the exact dispatch
             (kernel / plain, the reference's rule) and kernel launch
             counts; one ``RolloutService`` request (one scene, ZOO_STEPS
             steps, Verlet lists rebuilt on the card): finite frames,
             rebuild mode "device", no coordinate or edge bytes; one
             ``Pipeline.fit`` epoch on the train scenes (batch 4), its
             first step's loss, gradients and update against the plain
             path's, ms a step both ways and the kernel launches a step.
6. train   — a full-width FastEGNN (random weights from seed 0) trained
             with ``use_kernel=True`` through ``Pipeline.fit`` for 2 epochs
             on 6 + 2 fluid scenes of 7,800 particles (batch 4, so the
             second training batch is mask-padded), lam_mmd 0.03 over every
             node.  Checks every loss, the launch counts of every kernel,
             the first step's loss, gradients and update against a
             ``use_kernel=False`` pipeline on the card, and that the same
             first step run twice is bitwise equal; times a train step.
   hidden32 — the reference's hidden-32 entry points: the Table I model
             (3 layers, hidden 32, C = 3, s_dim 32, lam_mmd 0.03) a few
             train steps, its first step against the plain path and
             bitwise repeatable; the simulate model (2 layers, hidden 32,
             s_dim 16) through ``BatchedRolloutEngine`` on the serve
             scenes, 20 steps at ZOO_DT: every step's frame within
             FRAME_TOL of the plain path's step from the same state, the
             first frame of a free-running plain rollout too (later ones
             are read: random weights amplify the gap, and a pair at the
             cutoff flips), and no steady-state fetch (the serve phase
             gates that too); FastEGNN with the kernels E(3)-equivariant
             (rotated and translated input, output within EQUIV_TOL) at
             hidden 32 and 64.
   bf16    — the bf16 mode of the same paths, each beside its f32 phase
             and with its weights (phase_serve_bf16, the scale line's
             ``bf16`` entry, phase_zoo_bf16, phase_train_bf16,
             phase_hidden32_bf16): ``precision='bf16'``, training at
             ``loss_scale`` BF_LOSS_SCALE; every frame and loss finite,
             exact launch counts with every FastEGNN kernel call counted
             in bf16 (``precision_launches``), no steady-state fetch;
             against the f32 kernel path within relative L2 BF_MODEL_L2:
             the first served frame, the 113K step's frame, each zoo
             model's prediction (RF and SchNet also a train step) and
             each first train step's gradient leaves; the bf16 first step
             bitwise repeatable; ms a step and serve p50 beside f32's.
   dist    — DistEGNN on ``torch.distributed``: DIST_RANKS ranks,
             processes of their own (``chip_smoke.py --dist-rank``), all
             on cuda:0 over gloo (NCCL takes one rank a GPU), FastEGNN
             defaults with the kernels, through ``build_pipeline(mesh=
             ...)``.  (a) The scale phase's 113,000-particle scene in 2
             random shards: the overlapped and serialized forwards bitwise
             equal, the kernel path within ATOL / RTOL of the plain path
             on the same shard and through the same sums, the virtual
             state equal on both ranks, #1 and #3 launched once a layer;
             each rank's forward ms (CUDA events) and peak memory.  (b)
             One train step on the train phase's first 4 scenes in 2
             shards (the other 2 dropped with a warning): a finite loss,
             equal on both ranks, parameters equal across ranks (a digest
             of every leaf), the schedules bitwise, gradients within
             GATOL / GRTOL of the plain path's, #1-#6 launches a rank;
             ms a step.  (c) A one-rank mesh against the single-device
             pipeline on the 113K scene: bitwise, with both forwards'
             ms and peak memory.  (d) ``Pipeline.rollout`` on the 2-rank
             mesh (``DistRolloutEngine``): the 113K scene, DIST_ROLLOUT_
             STEPS steps at R / SKIN / DT in [0, BOX), device rebuilds on
             each shard: both ranks' trajectories bitwise equal, device ==
             host (synchronous) rebuilds bitwise, the first frame within
             FRAME_TOL of a ``use_kernel=False`` mesh rollout (later ones
             read: random weights amplify the gap), no coordinate, edge or
             steady-state bytes in device mode, and #1 / #3 launched once
             a layer for every step computed; each rank's ms a step,
             rebuilds and their ms, ``cell_cap``, bytes fetched and peak
             memory.  (e) A one-rank mesh's rollout against the
             single-device ``Pipeline.rollout`` on the same scene,
             ONE_RANK_ROLLOUT_STEPS steps: bitwise.  Two ranks on one card
             time contention and collective latency, not scaling.
   data    — the data plane: a streamed fit (``Pipeline.make_batches``
             streams with worker threads, prefetch and a layout cache;
             one epoch of ``Pipeline.fit``) at FastEGNN defaults with the
             kernels, on nbody (DATA_NODES particles, r = ∞, h_in 1) and
             on protein (the paper's 855 residues, r = 10, h_in 4), the
             seed-0 init scaled by DATA_WEIGHT_SCALE: every loss finite,
             #1-#6 launch counts exact, the first step's loss, gradients
             and update within the train phase's limits of the plain path
             and bitwise repeatable, and a warm layout cache building
             nothing; ms a step.

The FastEGNN tensors are then freed, and the LM slice (gemma3-12b, random
weights from seed 0) runs:

7. lm_parity — gemma3-12b at full width and 6 layers (one 5:1 pattern),
             f32, B = 1, S = 2,048: ``forward`` with the kernel against
             ``forward(use_kernel=False)`` on the card, every logit within
             1e-4 of the largest, 6 launches of the f32 kernel, and a
             planted fault (the SWA window one too wide) outside that
             limit.
8. lm_prefill — gemma3-12b at full width and depth (48 layers), bf16
             weights built on the card, B = 1, S = 8,192: finite logits,
             48 launches, all of the bf16 tensor-core kernel, wall time,
             tokens/s, peak memory, a profile, and
             the relative L2 of the last position's logits against a
             plain-attention forward, beside the same for the plain path
             with one weight moved by one bf16 ulp (the model's
             own bf16 sensitivity at this depth; neither is gated).
9. lm_serve — the port's ``launch/serve.py`` path on the same weights:
             batch 4, prompt 16, 32 greedy tokens, then a run of
             1,000 + 40 tokens so that the SWA ring buffers wrap; cache
             footprint (exact), tokens/s and 0 kernel launches.  The first
             run's tokens are replayed through ``decode_step``: each
             generated token is the replay's argmax where logits are
             finite, logits are finite wherever the virtual-token state
             is, and that state (with random weights it overflows, as the
             reference's does) first turns non-finite inside the window
             the reference shows; tokens/s over the finite steps.
10. lm_parity_full — the bf16 weights freed, gemma3-12b at full depth in
             f32 for weight seeds 0 and 1, S = 8,192: the last position's
             logits of the kernel path against the plain path's within a
             limit set between these sound readings and a planted fault's
             (which must exceed it), 48 launches of the f32 kernel each.
    lm_decode_f32 — seed 0's f32 weights replay the served tokens: the
             virtual-token state overflows inside the same window and
             within one step of the bf16 replay.
11. lm_families — the LM stack's attention family, one line a config
             (FAMILIES: olmoe-1b-7b, deepseek-v2-lite-16b, granite-20b,
             llama3-405b, whisper-small, llama-3.2-vision-11b), each at
             its published widths with random weights, freed before the
             next: (a) f32 at the fewest layers that hold a cross layer
             (2; llama-vision 5) and FAMILY_PARITY_S tokens (whisper 448
             over its 1,500 frames): ``forward`` with the kernel against
             ``use_kernel=False``, every logit within 1e-4 of the largest,
             aux within 1e-5, one f32 launch per self-, encoder and
             cross-attention; the bf16 forward of the same weights (one
             bf16 launch per call) within relative L2 0.1 of it.  (b)
             bf16 weights built on the card at full depth (llama3-405b: 4
             of 126 layers, its ``reduced``): a B = 1 prefill of 8,192
             tokens (whisper: 448) with one bf16 launch per attention
             call, wall s, tokens/s, peak memory; then ``serve.run`` at
             batch 4, 16 + 32 tokens: tokens/s, the exact cache footprint,
             one launch per cross layer and step (and the encoder's).
             (c) whisper and llama-vision: ``decode_step`` with the kernel
             against ``use_kernel=False`` over 6 teacher-forced steps at
             batch 4, each from one shared cache (the cross layers' one
             query a row over T keys), with (a)'s weights and depth: f32
             within 1e-4 of each row's largest logit, bf16 within
             relative L2 0.1 a row, one launch per cross layer and step.
    lm_family_kernels — the attention kernel alone at the families' new
             forms (FAMILY_FORMS: MLA's 192 / 128 causal at 8,192;
             whisper's cross-attention, 448 over 1,500, and encoder,
             1,500 not causal; llama-vision's cross-attention, 8,192 over
             1,601; both cross-attentions as decode gives them, batch 4 of
             one query), bf16 and f32, against its plain version with a
             bitwise repeat, CUDA-event and device ms beside the plain
             version, SDPA and the bound; they join the two #7 rows of
             the kernels line as ``forms``.
12. lm_recurrent — the recurrent family, one line a config (RECURRENT:
             zamba2-1.2b, xlstm-125m), each at its published widths with
             random weights, freed before the next.  zamba2: (a) f32 at
             ZAMBA_PARITY_LAYERS layers (five Mamba2 and the first shared
             layer) and FAMILY_PARITY_S tokens, ``forward`` with the
             kernel against ``use_kernel=False``, every logit within 1e-4
             of the largest, one f32 launch of #7; the bf16 forward of the
             same weights (one bf16 launch) within relative L2 0.1 of it.
             xlstm: (b) XLSTM_CARD_LAYERS layers (mLSTM, sLSTM) and
             XLSTM_CARD_S tokens, the card's f32 logits against the same
             weights' forward on the CPU, within 1e-4 of the largest.
             Both: (c) f32 decode against forward, module by module
             (Mamba2 at zamba2's widths, at its SSD chunk and at
             MODULE_SMALL_CHUNK; mLSTM and sLSTM at xlstm's), MODULE_TOKENS
             tokens a row, MODULE_BATCH rows, within 1e-4 (the reference's
             own limit); (d) bf16 weights built on the card at full depth:
             a B = 1 prefill of PREFILL_S tokens, one bf16 launch of #7 per
             shared layer (zamba2 6, xlstm 0), wall s, tokens/s, peak
             memory, and zamba2's profile (xlstm's token-by-token
             recurrences, ~30 s, timed in the counted run alone); (e)
             ``serve.run`` at batch 4, 16 + 32 tokens: tokens/s, the exact
             cache footprint (f32 recurrent states), 0 launches in decode,
             and the first step whose logits are not finite (reported, not
             gated: random weights' virtual-token state overflows at
             depth, in the reference as here).
    lm_recurrent_kernels — #7 alone at zamba2's form (32 heads of 64,
             causal, 8,192 tokens), bf16 and f32, as lm_family_kernels
             does it; it joins the #7 rows' ``forms``.
13. lm_train — LM training (``training/lm.py``), no kernel launched (the
             plain attention, which the reference differentiates too):
             (a) every config's ``reduced()`` variant at TRAIN_B x
             TRAIN_S, one step (``value_and_grad``, then Adam) on the card
             against the same weights' step on the CPU, f32 (loss within
             TRAIN_LOSS_RTOL relative, each gradient leaf within
             TRAIN_GRAD_TOL of its largest |value|) and bf16 (each leaf's
             relative L2 within TRAIN_BF16_L2), and a planted fault (one
             label changed, on the card only) outside; (b) TRAIN_RUNS at
             their published widths with seed-0 f32 weights built on the
             card: olmoe's gradients at init (aux share, every router's
             gradient norm > 0) and gemma3's chunked loss against its
             dense one at the same weights (the loss within
             CHUNK_LOSS_RTOL, gradients at the bound argued beside it;
             each loss form's extra peak memory), then TRAIN_STEPS Adam
             steps twice from the seed's weights for each loss form (ms a
             step, tokens/s, peak memory; losses finite and falling, the
             repeat within TRAIN_REPEAT_RTOL), xlstm's parameters and Adam
             state through a checkpoint round trip, bitwise; (c) the
             launcher's LM mode (LAUNCH_ARGS): 3 step lines and the
             reduced config's parameter count.

Then it prints the card's name and power limit, the per-kernel summary,
and last ``{"ok": true, "device": {...}}``.  It needs CUDA and a checkout
of the repository around it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# serving configuration: FastEGNN defaults at Water-3D scale
R, SKIN, DT, STEPS, BOX = 0.035, 0.01, 0.005, 20, 1.0
N_PARTICLES, NODE_CAP, EDGES_PER_NODE = 7800, 8192, 32
SCALE_PARTICLES, SCALE_CAP = 113_000, 131_072
MAX_BATCH, LAYERS = 4, 4
# kernel vs plain version, elementwise: |k - p| <= ATOL + RTOL * |p|
# (f32; the two sum in different orders)
ATOL, RTOL = 1e-5, 1e-4
# gradients vs their plain versions, relative to each output's largest
# magnitude: |k - p| <= GATOL * max|p| + GRTOL * |p| (the JAX package's
# own _assert_tree_close)
GATOL, GRTOL = 5e-5, 1e-3
# first served frame vs the plain path after 4 layers (periodic distance)
FRAME_TOL = 1e-4
# serve scenes through BatchedRolloutEngine, device against host rebuilds
REBUILD_STEPS = 6
# widths phase: (Dh, H1, M) of the edge pair (virtual pair: Dh, hid = H1;
# identity: H1) on the serve Verlet list, from the compiled widths (32,
# 64) through zero-padded ones (16, 24, 48, 24-40-56) to the panel path
# (96, 128, 226: the widest the reference's budget admits at N = 8,192)
WIDTH_CASES = ((16, 16, 16), (24, 24, 24), (32, 32, 32), (48, 48, 48),
               (64, 64, 64), (96, 96, 96), (128, 128, 128), (226, 226, 226),
               (24, 40, 56))
# and the edge pair at 512 on a 100-node graph (the budget admits 749 there)
WIDE_NODES, WIDE_WIDTH = 100, 512
# widths at which two CTA counts run, bitwise equal
CTA_WIDTHS = (32, 128)
# the bf16 mode of #1-#4 and the identity pair (precision='bf16': bf16
# operands of every product, f32 sums) against its bf16 plain version
# (kernels.ref.*_bf16, the Pallas kernels' casts) on the card: per output
# relative L2 <= BF_L2, and elementwise within two bf16 roundings of each
# other, |k - p| <= BF_KRTOL |p| + BF_KATOL max|p| (the two round the same
# values, but a different f32 summation order may tip a rounding, and a
# tip moves every later sum that takes the rounded value); BF_KATOL sits
# between the sound readings and the planted faults': on an H100 the
# widths phase's largest sound reading was 9.1e-4, the smallest fault's
# 8.9e-3 (PERF.md section 6)
BF_L2, BF_KRTOL, BF_KATOL = 1e-3, 2.0 ** -7, 3e-3
# the virtual forward's dz_sum and ms_sum, f32 sums of unrounded terms over
# every node: relative L2 <= BF_SUM_L2.  Its planted fault (one node's
# mask flipped) moves them by one term of 8,192, far inside two bf16
# roundings of the sum (relative L2 2.5e-4 to 2.9e-4 on an H100), while
# a tipped rounding upstream moves one node's term by a bf16 ulp
BF_SUM_L2 = 5e-5
# the bf16 kernel must differ from the f32 kernel (a kernel that ignores
# the flag fails): relative L2 of some output >= BF_ENGAGED
BF_ENGAGED = 1e-4
# the widths of the bf16 widths phase (every route: w32, w64, padded up
# to them, panel), two CTA counts at CTA_WIDTHS
BF_WIDTH_CASES = ((16, 16, 16), (32, 32, 32), (48, 48, 48), (64, 64, 64),
                  (128, 128, 128), (226, 226, 226))
# the bf16 kernels redesigned on bf16 tiles, before their redesign: the
# edge pair (#1, #2), the identity backward (SchNet's and RF's forms) and
# the virtual pair (#3, #4): CTAs an SM and device ms on the serve Verlet
# list at widths 64 and 32, as PERF.md section 6 records them (NVIDIA
# H100 80GB HBM3, 700 W); the bf16_edge line prints the redesigned
# kernels' beside them, and needs two CTAs an SM of #1 to #4
BF_EDGE_PARENT = {
    "edge_pathway_fused": {"ctas_per_sm": {"64": 2, "32": 2},
                           "device_ms": {"64": 0.0689, "32": 0.0379}},
    "edge_pathway_bwd_fused": {"ctas_per_sm": {"64": 1, "32": 2},
                               "device_ms": {"64": 0.306, "32": 0.135}},
    "edge_identity_bwd": {"device_ms": {"64": 0.834, "32": 0.404}},
    "edge_identity_bwd_rf": {"device_ms": {"64": 0.161, "32": 0.126}},
    "virtual_pathway_fused": {"ctas_per_sm": {"64": 1, "32": "not measured"},
                              "device_ms": {"64": 0.0326, "32": 0.0168}},
    "virtual_pathway_bwd_fused": {"ctas_per_sm": {"64": 1,
                                                  "32": "not measured"},
                                  "device_ms": {"64": 0.0823, "32": 0.0436}}}
# the identity pair in f32 before its tile route: device ms of the kernels
# phase's rows at hidden 64 and 32 (SchNet's form; "_rf": RF's), as
# PERF.md section 6 records them (NVIDIA H100 80GB HBM3, 700 W); the
# identity_f32 line prints the tile route's beside them
IDN_F32_PARENT = {
    "edge_identity": {"64": 0.0383, "32": 0.0221},
    "edge_identity_rf": {"64": 0.0290, "32": 0.0227},
    "edge_identity_bwd": {"64": 0.1495, "32": 0.101},
    "edge_identity_bwd_rf": {"64": 0.107, "32": 0.0918}}
# the identity forward before its edge-parallel tile pass (a warp a
# receiver row): device ms of the kernels phase's rows (f32) and of
# widths_bf16 (bf16) at widths 64 and 32, SchNet's form and RF's ("_rf"),
# as PERF.md section 6 records them (PR 25; NVIDIA H100 80GB HBM3, 700 W);
# the identity_fwd line prints the tile pass's beside them
IDN_FWD_PARENT = {
    "f32": {"edge_identity": {"64": 0.0296, "32": 0.0210},
            "edge_identity_rf": {"64": 0.0283, "32": 0.0236}},
    "bf16": {"edge_identity": {"64": 0.0317, "32": 0.0236},
             "edge_identity_rf": {"64": 0.0344, "32": "not measured"}}}
# bf16 model path against the f32 kernel path: relative L2 of the first
# served frame, of each leaf of the first step's gradients and of each zoo
# model's prediction (DESIGN.md section 9.3; the reference's
# test_bf16_grads_finite_and_close)
BF_MODEL_L2 = 0.1
# ... per gradient leaf whose f32 norm is at least BF_SMALL_LEAF of the
# largest leaf's; a smaller leaf is a cancelling sum at rounding level
# (the phi_Z stacks while z sits at the centre of mass: bf16 rounding of
# x - z_c breaks the cancellation), held instead to BF_SMALL_LEAF of the
# largest leaf's norm, absolutely
BF_SMALL_LEAF = 1e-4
# the bf16 train step's static loss scale (the reference's
# tests/test_fused_backward.py: test_loss_scale_grads_invariant)
BF_LOSS_SCALE = 1024.0
# hidden32 phase: the reference's Table I model (benchmarks/common.py: 3
# layers, hidden 32, C = 3, s_dim = hidden, lam_mmd 0.03) and its simulate
# model (launch/simulate.py: 2 layers, hidden 32, C = 3, s_dim 16)
TABLE1 = dict(n_layers=3, hidden=32, n_virtual=3, s_dim=32)
SIMULATE = dict(n_layers=2, hidden=32, n_virtual=3, s_dim=16)
H32_FIT_STEPS = 3
# E(3) equivariance of FastEGNN with the kernels (Proposition IV.1)
EQUIV_TOL = 2e-3
# zoo: every registry model; steps of its one-scene RolloutService request
ZOO = ("linear", "mpnn", "egnn", "rf", "schnet", "tfn", "fast_egnn",
       "fast_rf", "fast_schnet", "fast_tfn")
ZOO_STEPS = 10
# the request's finite-difference timestep: RF adds the re-estimated
# velocity (x' - x) / dt to its update as it is, so at the serve's DT the
# random weights' velocities (up to BOX / DT) overflow FastRF's virtual
# coordinates within a few steps, as the reference's would; at dt 1 the
# velocity is the last step's displacement
ZOO_DT = 1.0
# the hidden32 rollout's timestep: the zoo's (ZOO_DT), at which the random
# weights' finite-difference velocities stay bounded over its 20 steps
H32_DT = ZOO_DT
# the dispatch of one forward of one layer with use_kernel=True, the
# reference's rule: where its Pallas kernel runs, the CUDA kernel does;
# where it runs jnp (FastRF's zero-width virtual block), the plain path
ZOO_DISPATCH = {
    "linear": {}, "tfn": {}, "mpnn": {"edge_kernel": 1},
    "egnn": {"edge_kernel": 1}, "rf": {"edge_kernel": 1},
    "schnet": {"edge_kernel": 1},
    "fast_egnn": {"edge_kernel": 1, "virtual_kernel": 1},
    "fast_schnet": {"edge_kernel": 1, "virtual_kernel": 1},
    "fast_rf": {"edge_kernel": 1, "virtual_plain": 1},
    "fast_tfn": {"virtual_kernel": 1}}
# which edge kernel a layer of each model launches
ZOO_EDGE_KERNEL = {"mpnn": "edge_pathway_fused", "egnn": "edge_pathway_fused",
                   "fast_egnn": "edge_pathway_fused", "rf": "edge_identity",
                   "schnet": "edge_identity", "fast_rf": "edge_identity",
                   "fast_schnet": "edge_identity"}
# training: 6 train + 2 validation scenes, batch 4, 2 epochs
TRAIN_SCENES, VAL_SCENES, TRAIN_BATCH, EPOCHS = 6, 2, 4, 2
LAM_MMD, MMD_SIGMA, MMD_CHANNELS = 0.03, 1.5, 3
# dist phase: DistEGNN ranks, all on cuda:0 over gloo (NCCL takes one rank
# a GPU), and how long they may take
DIST_RANKS, DIST_TIMEOUT_S = 2, 600
# dist phase (d): Pipeline.rollout on the mesh, steps on the 113K scene;
# (e): the one-rank mesh against the single-device rollout
DIST_ROLLOUT_STEPS, ONE_RANK_ROLLOUT_STEPS = 10, 6
# data phase: a streamed fit on each dataset (nodes: the launcher's
# default for nbody, the paper's 855-residue AdK for protein); 8 train
# samples (2 batches) and 2 validation samples (a mask-padded batch)
DATA_SAMPLES, DATA_VAL = 10, 2
DATA_NODES = {"nbody": 100, "protein": 855}
# ... with the seed-0 init scaled by this: at full scale the random
# 4-layer, hidden-64 model's forward is non-finite on the protein chain
# (coordinates tens of Å apart; the JAX package's own init gives NaN there
# too) and reaches 3e7 on nbody; at 0.3 protein's first step is so badly
# conditioned that its f32 gradients stray ~1e-3 of a leaf's largest
# entry from an f64 computation of the same step (the f64 reading below)
DATA_WEIGHT_SCALE = 0.2
# first-step update compared where |g| >= SMALL_GRAD x the leaf's largest
SMALL_GRAD = 1e-2
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) and
# bf16 tensor-core (f32 accumulate) FLOP/s
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
# TF32 tensor-core peak (dense); the FastEGNN edge and virtual kernels run
# every 64x64 product as three TF32 MMAs (3xTF32), so their tensor-core
# bound counts 3x the FLOP at this rate
TF32_FLOPS = 495e12
# LM slice: gemma3-12b, attention at the prefill's shape
LM_ARCH = "gemma3_12b"
PARITY_LAYERS, PARITY_S = 6, 2048
PREFILL_S = 8192
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 16, 32
WRAP_PROMPT, WRAP_GEN = 1000, 40  # prompt + gen > window: the rings wrap
# bf16 attention, kernel vs plain version: both compute in f32 and round
# once, in different summation orders, so they may land one bf16 rounding
# apart: |k - p| <= 2^-7 |p| (one bf16 ulp at |p|) + 1e-3 (near 0)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
# lm_parity (f32): |k - p| <= LOGIT_TOL * max|p| + LOGIT_TOL * |p|
LOGIT_TOL = 1e-4
# lm_parity_full (f32, 48 layers, S = 8,192, last position): the kernel
# path's max|k - p| / max|p| for each weight seed must not exceed
# FULL_LOGIT_TOL, and the same reading of a planted fault (the SWA window
# one too wide) must exceed it.  On an H100 the sound readings were 7.1e-5
# (seed 0) and 3.1e-5 (seed 1) with the f32 kernel on the f32 units, and
# 6.9e-5 and 7.0e-5 with it on the tensor cores (3xTF32), the fault's
# 0.111 in both: the limit sits near the geometric mean of the largest
# sound reading and the fault's, 43x above the one and 37x below the
# other.
FULL_SEEDS = (0, 1)
FULL_LOGIT_TOL = 3e-3
# decode with random weights: the virtual-token state (one read added per
# layer and per step, as in the reference) grows ~10^2.4 a step until it
# overflows; the JAX reference at 48 layers turns non-finite at step 15 at
# d_model 256 and 512 over several seeds (tests/test_torch_lm_deep.py).
# The card's first non-finite step, bf16 and f32, must lie in this window
# (inclusive), and the two within one step of each other.
VT_OVERFLOW_STEPS = (13, 16)
# lm_families: the LM stack's attention family, each config at its
# published widths.  Parity in f32 at FAMILY_PARITY_S tokens (whisper: its
# decoder's 448, over its 1,500 frames) and the fewest layers that hold a
# cross layer (2, llama-vision's 5); then bf16 weights at full depth (but
# llama3-405b: 4 of its 126 layers, its 'reduced') for a PREFILL_S prefill
# (whisper: 448 decoder tokens) and serve.run at SERVE_BATCH x (SERVE_PROMPT
# + SERVE_GEN).  The bf16 forward with the f32 weights against the f32
# kernel forward within relative L2 FAMILY_BF16_L2 (DESIGN.md section 9.3's
# bf16 bound: bf16 roundings tip some tokens' MoE routing)
FAMILIES = ("olmoe_1b_7b", "deepseek_v2_lite_16b", "granite_20b",
            "llama3_405b", "whisper_small", "llama_3_2_vision_11b")
FAMILY_DEPTH = {"llama3_405b": 4}
FAMILY_PARITY_S, WHISPER_S = 1024, 448
FAMILY_BF16_L2 = 0.1
# decode with the kernel against use_kernel=False (the cross-attention
# configs: one query a row over the encoder's / image tokens, a batch of
# SERVE_BATCH): this many teacher-forced steps, each from one shared
# cache, with the parity run's weights and depth, f32 (LOGIT_TOL of each
# row's largest logit) and bf16 (each row's relative L2 within
# FAMILY_BF16_L2).  Not at full depth: there the random weights' virtual-
# token state grows until whisper's 12 layers round its cross-attention
# away (rows bitwise equal) or tip a row (relative L2 0.54 at step 5) on
# an H100; the kernel at decode's shapes is held alone (FAMILY_FORMS)
DECODE_CMP_STEPS = 6
# the attention kernel alone at the families' new forms (full heads; B = 1
# unless ``b`` says otherwise): MLA's widths (192 / 128, causal, 8,192
# tokens), whisper's cross-attention (448 decoder tokens over 1,500 frames)
# and encoder (1,500 frames, not causal), llama-vision's cross-attention
# (8,192 tokens over 1,601 image tokens), and both cross-attentions as
# decode gives them (SERVE_BATCH rows of one query); ``launches`` from the
# runs of ``arch`` that ``stages`` names (bf16, f32; by default its prefill
# and its f32 parity run), by the wrapper's form key
FAMILY_FORMS = {
    "mla": dict(arch="deepseek_v2_lite_16b", h=16, kv=16, d=192, dv=128,
                s=8192, t=8192, causal=True),
    "whisper_cross": dict(arch="whisper_small", h=12, kv=12, d=64, dv=64,
                          s=448, t=1500, causal=False),
    "whisper_encoder": dict(arch="whisper_small", h=12, kv=12, d=64, dv=64,
                            s=1500, t=1500, causal=False),
    "vision_cross": dict(arch="llama_3_2_vision_11b", h=32, kv=8, d=128,
                         dv=128, s=8192, t=1601, causal=False),
    "whisper_decode_cross": dict(arch="whisper_small", b=SERVE_BATCH, h=12,
                                 kv=12, d=64, dv=64, s=1, t=1500,
                                 causal=False,
                                 stages=("serve", "decode_f32")),
    "vision_decode_cross": dict(arch="llama_3_2_vision_11b", b=SERVE_BATCH,
                                h=32, kv=8, d=128, dv=128, s=1, t=1601,
                                causal=False,
                                stages=("serve", "decode_f32")),
}

# lm_recurrent: zamba2-1.2b and xlstm-125m at their published widths.
# zamba2's f32 parity at its first ZAMBA_PARITY_LAYERS layers (the first
# shared layer is layer 5) and FAMILY_PARITY_S tokens (a multiple of its
# SSD chunk); xlstm's card against the CPU at XLSTM_CARD_LAYERS (mLSTM,
# sLSTM) and XLSTM_CARD_S tokens; decode against forward per module over
# MODULE_TOKENS tokens and MODULE_BATCH rows at MODULE_TOL (atol and rtol,
# the reference's own tests/test_nn.py limit), Mamba2 also at
# MODULE_SMALL_CHUNK so that its forward crosses chunk boundaries
RECURRENT = ("zamba2_1_2b", "xlstm_125m")
ZAMBA_PARITY_LAYERS = 6
XLSTM_CARD_LAYERS, XLSTM_CARD_S = 2, 256
MODULE_TOKENS, MODULE_BATCH, MODULE_SMALL_CHUNK = 128, 2, 32
MODULE_TOL = 1e-4
# the attention kernel alone at zamba2's shared attention (32 heads of 64,
# causal, the prefill's length); launches from zamba2's bf16 prefill and
# f32 parity run
RECURRENT_FORMS = {
    "zamba2_shared": dict(arch="zamba2_1_2b", h=32, kv=32, d=64, dv=64,
                          s=PREFILL_S, t=PREFILL_S, causal=True),
}
# lm_train phase.  Card against CPU: every config's reduced() variant at
# TRAIN_B x TRAIN_S, one step (training.lm.value_and_grad, then Adam);
# f32: loss within TRAIN_LOSS_RTOL relative, each gradient leaf within
# TRAIN_GRAD_TOL of its largest |value|; bf16: each leaf's relative L2 <=
# TRAIN_BF16_L2 (DESIGN.md section 9.3)
TRAIN_B, TRAIN_S = 2, 32
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL, TRAIN_BF16_L2 = 1e-5, 1e-3, 0.1
# the published-width runs: TRAIN_STEPS Adam steps (lr TRAIN_LR, clip
# TRAIN_CLIP) on one fixed batch, bf16 compute over f32 masters, each run
# twice from the seed's weights (losses within TRAIN_REPEAT_RTOL): (arch,
# layers (None: all), B, S, loss chunks)
TRAIN_STEPS, TRAIN_LR, TRAIN_CLIP, TRAIN_REPEAT_RTOL = 4, 1e-4, 1.0, 1e-5
TRAIN_RUNS = (("xlstm_125m", None, 2, 256, (0,)),
              ("olmoe_1b_7b", 2, 2, 1024, (0,)),
              ("gemma3_12b", 6, 1, 2048, (0, 512)))
# gemma3's chunked loss against its dense one at the same weights: the
# loss within CHUNK_LOSS_RTOL (the reference's own rtol); each gradient
# leaf within relative L2 (n_chunks + 1 + n_layers) * BF16_U.  Argument:
# both paths accumulate every product in f32 and differ only in bf16
# roundings (unit roundoff u = 2^-8).  The head's gradient h^T dlogits is
# rounded once in the dense path (u); the chunked path rounds each
# chunk's product (u of a partial, u of the sum over all of them) and
# each of the n_chunks - 1 bf16 additions autograd makes (u each): at
# most (n_chunks + 1) u between them.  dhidden = dlogits head^T is one
# product a row either way, but cuBLAS may tile M = chunk and M = S
# differently, so its rounding may flip by one ulp; each layer's
# backward re-rounds that perturbed cotangent in bf16 once more (one u
# a layer).
CHUNK_LOSS_RTOL, BF16_U = 2e-5, 2.0 ** -8
# the launcher on the card: launch/train.py lm, reduced xlstm-125m
LAUNCH_ARGS = ["lm", "--arch", "xlstm-125m", "--steps", "3", "--batch",
               "2", "--seq", "64"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 15, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(got, want) -> dict:
    """Max abs / relative error of kernel outputs against the plain ones,
    and whether every element is inside the stated tolerance."""
    import torch

    err, rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max() / w.abs().max().clamp(min=1e-30)))
        ok &= bool(torch.all(d <= ATOL + RTOL * w.abs()))
    return {"max_abs_err": err, "max_rel_err": rel, "within_tol": ok}


def compare_grads(got, want) -> dict:
    """Gradient outputs against the plain ones, each relative to its own
    largest magnitude (GATOL / GRTOL)."""
    import torch

    err, rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        if not w.numel():  # e.g. FastRF's zero-width feature update
            continue
        d = (g - w).abs()
        scale = float(w.abs().max()) + 1e-6
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max()) / scale)
        ok &= bool(torch.all(d <= GATOL * scale + GRTOL * w.abs()))
    return {"max_abs_err": err, "max_rel_err": rel, "within_tol": ok}


def rel_l2(got, want) -> float:
    import torch

    d = float(torch.linalg.vector_norm((got - want).double()))
    return d / max(float(torch.linalg.vector_norm(want.double())), 1e-30)


def compare_bf16(got, want, sums=()) -> dict:
    """bf16 kernel outputs against the bf16 plain version's: each
    output's relative L2 (BF_L2; the outputs at ``sums``: BF_SUM_L2) and
    every element within BF_KRTOL |p| + BF_KATOL max|p|; ``atol_needed``:
    the smallest BF_KATOL each element would pass with (the readings
    BF_KATOL is set between)."""
    import torch

    err, l2, need, ok, per = 0.0, 0.0, 0.0, True, []
    for i, (g, w) in enumerate(zip(got, want)):
        if not w.numel():
            per.append(0.0)
            continue
        d = (g - w).abs()
        scale = float(w.abs().max()) + 1e-30
        err = max(err, float(d.max()))
        per.append(rel_l2(g, w))
        l2 = max(l2, per[-1])
        need = max(need, float((d - BF_KRTOL * w.abs()).max()) / scale)
        ok &= bool(torch.all(d <= BF_KRTOL * w.abs() + BF_KATOL * scale))
        ok &= per[-1] <= (BF_SUM_L2 if i in sums else BF_L2)
    return {"max_abs_err": err, "max_rel_l2": l2, "rel_l2_per_output": per,
            "atol_needed": need, "within_tol": ok}


def repeat_equal(a, b) -> bool:
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bound_ms(n_bytes: float, flops: float,
             peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_f = n_bytes / HBM_BPS, flops / peak
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def tensor_core_fields(fn, n_bytes: float, flops: float) -> dict:
    """For the FastEGNN edge and virtual kernels (3xTF32 products): the
    bound at the TF32 tensor-core rate (3 x the FLOP), and
    :func:`device_fields`."""
    tc_ms, tc_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
    return dict(bound_3xtf32_ms=tc_ms, bound_3xtf32_by=tc_by,
                **device_fields(fn))


def device_fields(fn) -> dict:
    """The device kernels one call of ``fn`` launches, with their device
    times and the sum of those (``device_ms``)."""
    k_n, k_us = device_kernels_per_call(fn)
    return dict(kernels_per_call=k_n, kernels_us=k_us,
                device_ms=(sum(k_us.values()) / 1e3 if k_us
                           else "not measured"))


def device_kernels_per_call(fn) -> tuple:
    """The device kernels (and copies) that one call of ``fn`` launches,
    read from ``torch.profiler``: their number and each one's device time
    in microseconds; ("not measured", {}) if the profiler sees none.  A
    marker kernel (``torch.cuda._sleep``) runs first in the session and is
    left out: on an H100, after other work on the card, a session missed
    its first kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "spin" not in e.key]
    n = sum(e.count for e in events)
    if not n:
        return "not measured", {}
    return n, {e.key[:48]: dev_us(e) for e in events}


# ------------------------------------------------------------------ phases
def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, info in libs.items()}
    return {"phase": "build", "seconds": secs,
            "libraries": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                          for k, v in libs.items()},
            "ptxas": ptxas, "gpu": gpu_line()}


def make_scenes(n_scenes: int, n_particles: int, seed: int = 0) -> list:
    from repro_torch.data.fluid import generate_fluid_dataset

    return [(s.x0, s.v0, s.h) for s in
            generate_fluid_dataset(n_scenes, n_particles=n_particles,
                                   seed=seed)]


def host_graph(x0, node_cap: int, r_build: float):
    """The host build of one scene's Verlet list at ``r_build``: padded
    ``(senders, receivers, edge_mask)``, CSR ``indptr`` and the live edge
    count (numpy)."""
    import numpy as np

    from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                               radius_graph,
                                               sort_edges_by_receiver)

    snd, rcv = sort_edges_by_receiver(*radius_graph(x0, r_build))
    sp, rp, em = pad_edges(snd, rcv, node_cap * EDGES_PER_NODE, x0)
    n_edges = int(np.count_nonzero(em))
    return sp, rp, em, csr_indptr(rp, n_edges, node_cap), n_edges


def serving_graph(x0, node_cap: int, r_build: float, r_step: float, dev):
    """Padded Verlet list of one scene at ``r_build`` with the step mask
    at ``r_step`` applied (holes where candidates lie outside r)."""
    import numpy as np
    import torch

    from repro_torch.data.radius_graph import pad_nodes
    from repro_torch.rollout.engine import _step_edge_masks

    sp, rp, em, indptr, n_edges = host_graph(x0, node_cap, r_build)
    xp, nm = pad_nodes(x0, node_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x, sp, rp, em, nm = t(xp), t(sp), t(rp), t(em), t(nm)
    keep = _step_edge_masks(x, sp, rp, em, float(np.float32(r_step) ** 2),
                            0.0).to(torch.float32)
    return x, sp, rp, keep, nm, t(indptr), n_edges


def phase_kernels(pipe, scenes, dev) -> tuple[dict, list]:
    import torch

    from repro_torch.pipeline import build_pipeline

    line, rows = kernel_rows(pipe, scenes[0], dev)
    mmd, host = mmd_rows(scenes, dev)
    line["mmd_loss_kernel"] = lk = host.pop("mmd_loss_kernel")
    line["mmd_objective_host_us"] = host
    if not (lk["loss"]["within_tol"] and lk["grads"]["within_tol"]
            and not lk["planted_fault"]["within_tol"]
            and lk["launches"] == {"mmd_cross_sum": 1,
                                   "mmd_cross_grads": 1}):
        raise AssertionError(f"mmd_loss_kernel disagrees with its plain "
                             f"version, launches otherwise than once each, "
                             f"or its planted fault lands inside: "
                             f"{json.dumps(lk)}")
    # the FastEGNN kernels again at hidden 32 (every reference entry
    # point's width), the Table I model's layer
    narrow = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                            generator=torch.Generator().manual_seed(0),
                            **TABLE1)
    _, rows32 = kernel_rows(narrow, scenes[0], dev)
    line["hidden32"] = rows32
    rows += mmd
    for row in rows + rows32:
        for r in (row, row.get("fluid113k", row), row.get("rf_form", row)):
            ok = r["within_tol"] and r["bitwise_repeatable"]
            if "batched_equals_singles" in r:  # the MMD pair: one launch
                ok &= (r["batched_equals_singles"]
                       and r["kernels_per_call"] in (1, "not measured"))
            if not ok:
                raise AssertionError(f"kernel {row['name']} disagrees with "
                                     f"its plain version, is not repeatable "
                                     f"or batch-independent, or launches "
                                     f"more than one kernel a call: "
                                     f"{json.dumps(line)}")
            if r.get("planted_fault", {}).get("within_tol"):
                raise AssertionError(f"kernel {row['name']}: the planted "
                                     f"fault lands inside the tolerance: "
                                     f"{json.dumps(line)}")
    return line, rows


def kernel_rows(pipe, scene, dev) -> tuple[dict, list]:
    """The kernels phase's readings at the serving shapes, unchecked."""
    import torch

    from repro_torch.core.virtual_nodes import (init_virtual_coords,
                                                masked_com,
                                                virtual_global_message)
    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.kernels.ops import (unpack_edge_params,
                                         unpack_virtual_block)
    from repro_torch.models.egnn import edge_spec

    x, snd, _rcv, em, nm, indptr, n_edges = serving_graph(
        scene[0], NODE_CAP, R + SKIN, R, dev)
    n, hid, c = NODE_CAP, pipe.cfg.hidden, pipe.cfg.n_virtual
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((n, hid), generator=gen, device=dev)
    lp = pipe.params["layers"][0]
    spec = edge_spec(pipe.cfg.coord_clamp)
    hk, ws = unpack_edge_params({"phi1": lp["phi1"], "gate": lp["phi_xr"]},
                                h, spec)
    kw = dict(gate_mode=spec.gate, rel_mode=spec.rel,
              clamp=float(spec.coord_clamp))
    e_args = (x, hk, snd, em, indptr, *ws)
    z = init_virtual_coords(x, nm, c) + 0.05 * torch.randn(
        (c, 3), generator=gen, device=dev)
    s = pipe.params["s_init"]
    mv = virtual_global_message(z, masked_com(x, nm))
    w = unpack_virtual_block(lp["virtual"], s, mv, hid)
    v_args = (x, h, z, nm, w["w1h"], w["w1d"], w["const1"], w["w2"], w["b2"],
              w["wg1"], w["bg1"], w["wg2"], w["wz1"], w["bz1"], w["wz2"])

    rows = []
    with torch.no_grad():
        # edge forward
        run = lambda: edge_message.edge_pathway_fused(*e_args, **kw)
        got, again = run(), run()
        want = edge_message.edge_pathway_plain(*e_args, **kw)
        cmp_e = compare(got, want)
        cmp_e["bitwise_repeatable"] = repeat_equal(got, again)
        # planted fault: one live slot's mask zeroed in the kernel's call only
        live_slots = torch.nonzero(em[:n_edges]).flatten()
        em_bad = em.clone()
        em_bad[live_slots[live_slots.numel() // 2]] = 0.0
        cmp_e["planted_fault"] = compare(edge_message.edge_pathway_fused(
            *e_args[:3], em_bad, *e_args[4:], **kw), want)
        del got, again, want
        live = int(live_slots.numel())
        e_bytes = (n * (3 + hid) * 4 + n_edges * 8 + (n + 1) * 4
                   + (4 * hid * hid + 5 * hid) * 4 + n * (3 + hid + 1) * 4)
        # the function's own work: h·W1r and h·W1s once per node, then per
        # live edge msg = ·W2 and the gate's ·Wg1 and ·wg2
        e_flops = (n * 2 * (2 * hid * hid)
                   + live * (2 * 2 * hid * hid + 2 * hid))
        b_ms, b_by = bound_ms(e_bytes, e_flops)
        rows.append(dict(
            name="edge_pathway_fused", route="cuda",
            source="src/repro_torch/csrc/edge_message.cu",
            replaces="src/repro/kernels/edge_message.py:396",
            ms=cuda_ms(run),
            plain_ms=cuda_ms(
                lambda: edge_message.edge_pathway_plain(*e_args, **kw), 10, 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **tensor_core_fields(run, e_bytes, e_flops),
            shapes=dict(n=n, slots=int(snd.shape[0]), n_edges=n_edges,
                        live_edges=live, hidden=hid), **cmp_e))
        # virtual forward
        run = lambda: virtual_message.virtual_pathway_fused(*v_args)
        got, again = run(), run()
        want = virtual_message.virtual_pathway_plain(*v_args)
        cmp_v = compare(got, want)
        cmp_v["bitwise_repeatable"] = repeat_equal(got, again)
        # planted fault: one node's mask flipped in the kernel's call only
        nm_bad = nm.clone()
        nm_bad[0] = 1.0 - nm_bad[0]
        cmp_v["planted_fault"] = compare(virtual_message.virtual_pathway_fused(
            *v_args[:3], nm_bad, *v_args[4:]), want)
        del got, again, want
        v_bytes = (n * (3 + hid + 1) * 4 + c * (4 * hid * hid + 7 * hid + 3) * 4
                   + n * (3 + hid) * 4 + c * (3 + hid) * 4)
        v_flops = n * c * (4 * 2 * hid * hid + 4 * hid)
        b_ms, b_by = bound_ms(v_bytes, v_flops)
        rows.append(dict(
            name="virtual_pathway_fused", route="cuda",
            source="src/repro_torch/csrc/virtual_message.cu",
            replaces="src/repro/kernels/virtual_message.py:91",
            ms=cuda_ms(run),
            plain_ms=cuda_ms(
                lambda: virtual_message.virtual_pathway_plain(*v_args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            **tensor_core_fields(run, v_bytes, v_flops),
            shapes=dict(n=n, channels=c, hidden=hid), **cmp_v))
        rows += backward_rows(e_args, kw, v_args, n_edges, live, gen, dev)
        rows += identity_rows(x, snd, em, indptr, n_edges, live, gen, dev,
                              hid)
    line = {"phase": "kernels",
            "tolerance": {"values": {"atol": ATOL, "rtol": RTOL},
                          "grads_relative_to_max": {"atol": GATOL,
                                                    "rtol": GRTOL}},
            "kernels": rows}
    return line, rows


def backward_rows(e_args, kw, v_args, n_edges, live, gen, dev) -> list:
    """The edge and virtual backward kernels against their plain versions
    on the serving inputs."""
    import torch

    from repro_torch.data.radius_graph import csr_sender_perm
    from repro_torch.kernels import edge_message, virtual_message

    x, _h, snd = e_args[0], e_args[1], e_args[2]
    n, hid = x.shape[0], e_args[1].shape[1]
    z = v_args[2]
    c = z.shape[0]
    f4 = 4
    w_edge = (4 * hid * hid + 5 * hid) * f4  # W1r W1s W2 Wg1 + rows
    rows = []
    # edge backward: the sender permutation of the slots [0, n_edges)
    perm, sptr = csr_sender_perm(snd.cpu().numpy(), n_edges, n)
    sperm = torch.zeros_like(snd)
    sperm[:perm.size] = torch.from_numpy(perm).to(dev)
    sptr = torch.from_numpy(sptr).to(dev)
    deg = edge_message.edge_pathway_fused(*e_args, **kw)[2].contiguous()
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, hid), generator=gen, device=dev)
    eb = (*e_args[:5], sperm, sptr, *e_args[5:], deg, g_dx, g_mh)
    run = lambda: edge_message.edge_pathway_bwd_fused(*eb, **kw)
    plain = lambda: edge_message.edge_pathway_bwd_plain(*e_args, g_dx, g_mh,
                                                        **kw)
    got, again, want = run(), run(), plain()
    cmp = compare_grads(got, want)
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    # planted fault: one live slot's mask zeroed in the kernel's call only
    live_slots = torch.nonzero(eb[3][:n_edges]).flatten()
    em_bad = eb[3].clone()
    em_bad[live_slots[live_slots.numel() // 2]] = 0.0
    bad = (*eb[:3], em_bad, *eb[4:])
    cmp["planted_fault"] = compare_grads(
        edge_message.edge_pathway_bwd_fused(*bad, **kw), want)
    del got, again, want
    # reads x, h, the live slots' snd/em/sperm, indptr, sptr, weights, deg
    # and both cotangents once; writes gx, gh and the weight grads
    e_bytes = (n * (3 + hid) * f4 + 3 * n_edges * f4 + 2 * (n + 1) * f4
               + w_edge + n * (1 + 3 + hid) * f4 + n * (3 + hid) * f4
               + w_edge)
    # six 64x64 products per live edge (.W2 and .Wg1 recomputed, the
    # cotangents through Wg1^T and W2^T, the W2 and Wg1 outer products) and
    # six per node (h.W1r, h.W1s, G.W1r^T, S.W1s^T, the W1r / W1s outer
    # products over the per-node sums of g_pre1)
    e_flops = (live + n) * 6 * 2 * hid * hid
    b_ms, b_by = bound_ms(e_bytes, e_flops)
    rows.append(dict(
        name="edge_pathway_bwd_fused", route="cuda",
        source="src/repro_torch/csrc/edge_message_bwd.cu",
        replaces="src/repro/kernels/edge_message.py:661",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, 10, 2), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        **tensor_core_fields(run, e_bytes, e_flops),
        shapes=dict(n=n, slots=int(snd.shape[0]), n_edges=n_edges,
                    live_edges=live, hidden=hid), **cmp))
    # virtual backward
    cots = (torch.randn((n, 3), generator=gen, device=dev),
            torch.randn((n, hid), generator=gen, device=dev),
            torch.randn((c, 3), generator=gen, device=dev),
            torch.randn((c, hid), generator=gen, device=dev))
    run = lambda: virtual_message.virtual_pathway_bwd_fused(*v_args, *cots)
    plain = lambda: virtual_message.virtual_pathway_bwd_plain(*v_args, *cots)
    got, again, want = run(), run(), plain()
    cmp = compare_grads(got, want)
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    # planted fault: one node's mask flipped in the kernel's call only
    nm_bad = v_args[3].clone()
    nm_bad[0] = 1.0 - nm_bad[0]
    bad = (*v_args[:3], nm_bad, *v_args[4:])
    cmp["planted_fault"] = compare_grads(
        virtual_message.virtual_pathway_bwd_fused(*bad, *cots), want)
    del got, again, want
    w_virt = c * (4 * hid * hid + 7 * hid) * f4
    v_bytes = (n * (3 + hid + 1) * f4 + c * 3 * f4 + w_virt
               + n * (3 + hid) * f4 + c * (3 + hid) * f4
               + n * (3 + hid) * f4 + c * 3 * f4 + w_virt)
    # per node and channel eight 64x64 matvecs (four recomputed, four
    # cotangents) and four outer products
    v_flops = n * c * 12 * 2 * hid * hid
    b_ms, b_by = bound_ms(v_bytes, v_flops)
    rows.append(dict(
        name="virtual_pathway_bwd_fused", route="cuda",
        source="src/repro_torch/csrc/virtual_message_bwd.cu",
        replaces="src/repro/kernels/virtual_message.py:234",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, 10, 2), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        **tensor_core_fields(run, v_bytes, v_flops),
        shapes=dict(n=n, channels=c, hidden=hid), **cmp))
    return rows


def identity_rows(x, snd, em, indptr, n_edges, live, gen, dev,
                  d: int = 64) -> list:
    """The identity-gate edge kernels (#1 and #2's identity branch) on the
    serving Verlet list at hidden ``d``: SchNet's form (Dh = H1 = d, rel
    raw) in the row, RF's (Dh = 1, a zero feature column, rel inv1p) in
    its ``rf_form``; weights drawn as the models draw them (clamp 100, as
    theirs)."""
    import torch

    from repro_torch.core.mlp import init_mlp
    from repro_torch.data.radius_graph import csr_sender_perm
    from repro_torch.kernels import edge_message
    from repro_torch.kernels.ops import unpack_edge_params
    from repro_torch.models import rf, schnet

    n = x.shape[0]
    perm, sptr = csr_sender_perm(snd.cpu().numpy(), n_edges, n)
    sperm = torch.zeros_like(snd)
    sperm[:perm.size] = torch.from_numpy(perm).to(dev)
    sptr = torch.from_numpy(sptr).to(dev)
    live_slots = torch.nonzero(em[:n_edges]).flatten()
    em_bad = em.clone()
    em_bad[live_slots[live_slots.numel() // 2]] = 0.0
    wgen = torch.Generator().manual_seed(5)
    forms = {
        "schnet": (schnet.edge_spec(100.0),
                   init_mlp(wgen, [2 * d + 1, d, 1], final_bias=False,
                            device=dev),
                   torch.randn((n, d), generator=gen, device=dev)),
        "rf": (rf.edge_spec(100.0),
               init_mlp(wgen, [1, d, 1], final_bias=False, device=dev),
               torch.zeros((n, 0), device=dev))}
    out = {}
    for form, (spec, phi, h) in forms.items():
        hk, ws = unpack_edge_params({"phi1": phi}, h, spec)
        dh = hk.shape[1]
        kw = dict(gate_mode="identity", rel_mode=spec.rel,
                  clamp=float(spec.coord_clamp))
        args = (x, hk, snd, em, indptr, *ws)
        bad = (x, hk, snd, em_bad, indptr, *ws)
        fwd = lambda a=args: edge_message.edge_pathway_fused(*a, **kw)
        fplain = lambda: edge_message.edge_pathway_plain(*args, **kw)
        got, again, want = fwd(), fwd(), fplain()
        f = compare(got, want)
        f["bitwise_repeatable"] = repeat_equal(got, again)
        f["planted_fault"] = compare(fwd(bad), want)
        deg = want[2].contiguous()
        g_dx = torch.randn((n, 3), generator=gen, device=dev)
        g_mh = torch.randn((n, 1), generator=gen, device=dev)
        bwd = lambda a=args: edge_message.edge_pathway_bwd_fused(
            *a[:5], sperm, sptr, *a[5:], deg, g_dx, g_mh, **kw)
        bplain = lambda: edge_message.edge_pathway_bwd_plain(
            *args, g_dx, g_mh, **kw)
        gk, gk2, gp = bwd(), bwd(), bplain()
        b = compare_grads(gk, gp)
        b["bitwise_repeatable"] = repeat_equal(gk, gk2)
        b["planted_fault"] = compare_grads(bwd(bad), gp)
        del got, again, want, gk, gk2, gp
        w_bytes = (2 * dh * d + 3 * d + 1) * 4  # W1r W1s w1d b1 w2 b2
        # the function's own work: per node P = h.W1r and Q = h.W1s;
        # per live edge d2 (8), pre1 (4 x 64: three adds and the d2
        # product), SiLU (4 x 64), the dot with w2 (2 x 64), the gate,
        # the direction and the three sums (12)
        f_flops = n * 4 * dh * d + live * (8 + 10 * d + 12)
        f_bytes = (n * (3 + dh) * 4 + n_edges * 8 + (n + 1) * 4 + w_bytes
                   + n * 5 * 4)
        # backward: the forward again, then per live edge g_pre1 (2 + 3
        # per column: w2, SiLU'), g_d2's dot (2), the W2, w1d and b1
        # partials (5), the receiver and sender sums (2) a column; per
        # node gh (G.W1r^T + S.W1s^T) and the W1r / W1s partials
        b_flops = (f_flops + live * (14 * d + 30) + n * 8 * dh * d)
        b_bytes = (n * (3 + dh) * 4 + 3 * n_edges * 4 + 2 * (n + 1) * 4
                   + w_bytes + n * 5 * 4 + n * (3 + dh) * 4 + w_bytes)
        for tag, cmp, run, plain, n_bytes, flops in (
                ("fwd", f, fwd, fplain, f_bytes, f_flops),
                ("bwd", b, bwd, bplain, b_bytes, b_flops)):
            b_ms, b_by = bound_ms(n_bytes, flops)
            cmp.update(ms=cuda_ms(run), plain_ms=cuda_ms(plain, 10, 2),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None,
                       **device_fields(run),
                       shapes=dict(n=n, slots=int(snd.shape[0]),
                                   n_edges=n_edges, live_edges=live, dh=dh,
                                   h1=d, m=1, rel=spec.rel))
            out[(form, tag)] = cmp
    rows = []
    for tag, name, src_line in (("fwd", "edge_identity", 321),
                                ("bwd", "edge_identity_bwd", 539)):
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/edge_identity.cu",
            replaces=f"src/repro/kernels/edge_message.py:{src_line}",
            **out[("schnet", tag)], rf_form=out[("rf", tag)]))
    return rows


def mmd_inputs(xs, node_cap: int, gen, dev):
    """The MMD kernels' inputs for scenes ``xs`` padded to ``node_cap``:
    x (B,N,3), z (B,C,3) at each scene's centre of mass plus noise, the
    node masks (B,N) and a cotangent (B,)."""
    import numpy as np
    import torch

    from repro_torch.core.virtual_nodes import init_virtual_coords
    from repro_torch.data.radius_graph import pad_nodes

    pads = [pad_nodes(np.asarray(x, np.float32), node_cap) for x in xs]
    x = torch.from_numpy(np.stack([p[0] for p in pads])).to(dev)
    nm = torch.from_numpy(np.stack([p[1] for p in pads])).to(dev)
    z = torch.stack([init_virtual_coords(x[b], nm[b], MMD_CHANNELS)
                     for b in range(len(xs))])
    z = z + 0.05 * torch.randn(z.shape, generator=gen, device=dev)
    g = 0.5 + torch.rand((len(xs),), generator=gen, device=dev)
    return x.contiguous(), z.contiguous(), nm, g


def host_us(fn, reps: int = 200) -> float:
    """Median host time of one call of ``fn`` in microseconds, the device
    idle before each call (the wrapper alone: no synchronise inside)."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def mmd_reading(x, z, nm, g, live: int) -> dict:
    """Both MMD kernels on one batch: against their plain versions, a
    bitwise repeat, each graph alone against its row of the batch
    (bitwise), a planted fault (graph 0's node ``live // 2`` masked out in
    the kernel's call only), CUDA-event, device and host times and the
    device kernels a call."""
    import torch

    from repro_torch.kernels import mmd_rbf

    b, n = nm.shape
    c = z.shape[1]
    bad = nm.clone()
    bad[0, live // 2] = 1.0 - bad[0, live // 2]
    sig = dict(sigma=MMD_SIGMA)
    cases = {
        "mmd_cross_sum": (
            lambda m=nm, sl=slice(None): (mmd_rbf.mmd_cross_sum(
                x[sl], z[sl], m[sl], **sig),),
            lambda: (mmd_rbf.mmd_cross_sum_plain(x, z, nm, **sig),),
            compare,
            # reads x, mask, z once, writes the sums; per live node and
            # channel: 3 sub, 3 mul, 2 add, 1 scale, 1 exp, 1 mul, 1 add
            b * n * 16 + b * c * 12 + b * 4, b * live * c * 12),
        "mmd_cross_grads": (
            lambda m=nm, sl=slice(None): mmd_rbf.mmd_cross_grads(
                x[sl], z[sl], m[sl], g[sl], **sig),
            lambda: mmd_rbf.mmd_cross_grads_plain(x, z, nm, g, **sig),
            compare_grads,
            # ... and g, writing dx and dz; the kernel value as above,
            # then 3 mul-adds into dx and 3 into dz
            b * n * 16 + b * c * 12 + b * 4 + b * n * 12 + b * c * 12,
            b * live * c * 24),
    }
    out = {}
    for name, (run, plain, cmp_fn, n_bytes, flops) in cases.items():
        got, again, want = run(), run(), plain()
        r = cmp_fn(got, want)
        r["bitwise_repeatable"] = repeat_equal(got, again)
        singles = [run(sl=slice(k, k + 1)) for k in range(b)]
        r["batched_equals_singles"] = all(
            torch.equal(t[k:k + 1], s) for k, one in enumerate(singles)
            for t, s in zip(got, one))
        r["planted_fault"] = cmp_fn(run(bad), want)
        b_ms, b_by = bound_ms(n_bytes, flops)
        r.update(ms=cuda_ms(run, 50, 5), plain_ms=cuda_ms(plain),
                 host_us=host_us(run), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, **device_fields(run),
                 shapes=dict(b=b, n=n, live=live, channels=c,
                             sigma=MMD_SIGMA))
        out[name] = r
    return out


def mmd_objective_host_us(x, z, nm) -> dict:
    """Host time of the MMD term's forward and backward as a train step
    runs it (``mmd_loss`` with the kernels, the gradient to z), for the
    batch in one call and, as before the trainer batched it, graph by
    graph."""
    import torch

    from repro_torch.core.mmd import mmd_loss

    zg = z.clone().requires_grad_(True)
    loss = lambda zz, xx, mm: mmd_loss(zz, xx, mm, sigma=MMD_SIGMA,
                                       use_kernel=True)
    batched = lambda: torch.autograd.grad(loss(zg, x, nm).sum(), zg)
    per_slot = lambda: torch.autograd.grad(
        sum(loss(zg[b], x[b], nm[b]) for b in range(x.shape[0])), zg)
    return {"batched": host_us(batched, 50),
            "per_slot": host_us(per_slot, 50), "graphs": int(x.shape[0])}


def mmd_loss_kernel_reading(x, z, nm) -> dict:
    """``kernels.ops.mmd_loss_kernel`` (Eq. 10 of one graph, its cross term
    through #5 and #6) on graph 0 of the train batch against its plain
    version (``core.mmd.mmd_loss``, the plain pair) on the card: the loss
    (ATOL / RTOL) and its gradients to z and x (GATOL / GRTOL), the
    launches of one forward and backward (one of each kernel), CUDA-event
    ms of both, and a planted fault (node ``N_PARTICLES // 2`` masked out
    in the kernel's call only), which must land outside the gradients'
    tolerance."""
    import torch

    from repro_torch.core.mmd import mmd_loss
    from repro_torch.kernels import mmd_rbf
    from repro_torch.kernels.ops import mmd_loss_kernel

    x0, z0, m0 = x[0], z[0], nm[0]

    def run(fn, mask=m0):
        zz = z0.clone().requires_grad_(True)
        xx = x0.clone().requires_grad_(True)
        loss = fn(zz, xx, mask)
        return (loss.detach(),) + torch.autograd.grad(loss, (zz, xx))

    kernel = lambda zz, xx, mm: mmd_loss_kernel(zz, xx, mm, sigma=MMD_SIGMA)
    plain = lambda zz, xx, mm: mmd_loss(zz, xx, mm, sigma=MMD_SIGMA)
    mmd_rbf.reset_launches()
    got = run(kernel)
    launches = {"mmd_cross_sum": mmd_rbf.sum_launches,
                "mmd_cross_grads": mmd_rbf.grad_launches}
    want = run(plain)
    bad = m0.clone()
    bad[N_PARTICLES // 2] = 0.0
    return {"loss": compare(got[:1], want[:1]),
            "grads": compare_grads(got[1:], want[1:]),
            "planted_fault": compare_grads(run(kernel, bad)[1:], want[1:]),
            "launches": launches, "ms": cuda_ms(lambda: run(kernel)),
            "plain_ms": cuda_ms(lambda: run(plain)),
            "nodes": int(m0.sum()), "bucket": int(m0.numel())}


def mmd_rows(scenes, dev) -> tuple[list, dict]:
    """The MMD pair (#5 cross sum, #6 cross gradient), batched as the
    trainer calls it: at the train step's shape (the four 7,800-particle
    scenes in one batch of 8,192-node buckets) and at Fluid113K's (B = 1,
    113,000 particles in a 131,072 bucket); and the MMD term's host time
    in a train step.  One node's fault is 1e-5 of a 113,000-node sum,
    under the value tolerance's rtol, so the cross sum's planted fault is
    gated at the train shape only."""
    import numpy as np
    import torch

    from repro_torch.data.fluid import simulate_fluid

    gen = torch.Generator(device=dev).manual_seed(3)
    args = mmd_inputs([s[0] for s in scenes], NODE_CAP, gen, dev)
    with torch.no_grad():
        train = mmd_reading(*args, N_PARTICLES)
        xs, _ = simulate_fluid(np.random.default_rng(0), SCALE_PARTICLES, 1)
        big = mmd_reading(*mmd_inputs([xs[0]], SCALE_CAP, gen, dev),
                          SCALE_PARTICLES)
    big["mmd_cross_sum"]["planted_fault_ungated"] = big["mmd_cross_sum"].pop(
        "planted_fault")
    rows = [dict(name=name, route="cuda",
                 source="src/repro_torch/csrc/mmd_rbf.cu",
                 replaces=f"src/repro/kernels/mmd_rbf.py:{line}",
                 **train[name], fluid113k=big[name])
            for name, line in (("mmd_cross_sum", 46),
                               ("mmd_cross_grads", 102))]
    host = mmd_objective_host_us(*args[:3])
    host["mmd_loss_kernel"] = mmd_loss_kernel_reading(*args[:3])
    return rows, host


def phase_serve(pipe, plain, scenes, dev) -> dict:
    import numpy as np

    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.rollout import BatchedRolloutEngine
    from repro_torch.serving import RolloutService, ServiceConfig

    cfg = ServiceConfig(max_batch=MAX_BATCH, window_s=1.0, queue_cap=16,
                        edge_cap_per_node=EDGES_PER_NODE)
    submit = dict(r=R, skin=SKIN, dt=DT, wrap_box=BOX)
    with RolloutService(pipe, config=cfg) as warm:  # first-use set-up
        x, v, h = scenes[0]
        warm.submit(x, v, h, 2, **submit).result()

    edge_message.reset_launches()
    virtual_message.reset_launches()
    t0 = time.perf_counter()
    with RolloutService(pipe, config=cfg) as svc:
        handles = [svc.submit(x, v, h, STEPS, **submit) for x, v, h in scenes]
        streams = [[f.copy() for f in hd.frames()] for hd in handles]
    wall = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches}
    m = svc.metrics()
    (served,) = [svc._programs._lru.get(k) for k in svc._programs.keys()]
    tel = served._tel
    rebuild = {"rebuild_mode": served.rebuild_mode,
               "coord_d2h_bytes": tel.coord_d2h,
               "edge_h2d_bytes": tel.edge_h2d,
               "steady_state_d2h_bytes": tel.steady_d2h,
               "discarded_steps": served._discarded,
               "cell_overflows": served._cell_overflows,
               "cell_cap": served._cell_cap}
    if (served.rebuild_mode != "device" or tel.coord_d2h or tel.edge_h2d
            or tel.steady_d2h):
        raise AssertionError(f"serve did not rebuild on the device with no "
                             f"coordinate fetch, no edge upload and no "
                             f"steady-state fetch: {rebuild}")

    for j, frames in enumerate(streams):
        if len(frames) != STEPS:
            raise AssertionError(f"stream {j}: {len(frames)}/{STEPS} frames")
        if not all(np.isfinite(f).all() for f in frames):
            raise AssertionError(f"stream {j}: non-finite frame")
    # a step each, and one each for the steps a chunk computed past a
    # failed skin check and dropped
    want = LAYERS * MAX_BATCH * (m["batches"] * STEPS + served._discarded)
    for name, got in launches.items():
        if got != want:
            raise AssertionError(f"{name}: {got} launches, expected {want} "
                                 f"({m['batches']} batches x {LAYERS} layers "
                                 f"x {MAX_BATCH} slots x {STEPS} steps + "
                                 f"{served._discarded} dropped)")
    eng = BatchedRolloutEngine(
        plain.predict_fn, batch_size=MAX_BATCH, node_cap=NODE_CAP,
        edge_cap=NODE_CAP * EDGES_PER_NODE, r=R, skin=SKIN, dt=DT,
        wrap_box=BOX, device=dev)
    ref = eng.run(plain.params, scenes, 1).trajectories
    d = max(float(np.max(np.minimum(np.abs(s[0] - t[0]),
                                    BOX - np.abs(s[0] - t[0]))))
            for s, t in zip(streams, ref))
    if not d <= FRAME_TOL:
        raise AssertionError(f"first frame differs from the plain path by "
                             f"{d} > {FRAME_TOL}")
    return {"phase": "serve", "scenes": len(scenes),
            "particles": [int(s[0].shape[0]) for s in scenes],
            "steps": STEPS, "batches": m["batches"],
            "occupancy": m["occupancy_hist"], "launches": launches,
            "launches_expected": want, "first_frame_max_err": d,
            "frame_tol": FRAME_TOL, "latency_p50_s": m["latency_p50_s"],
            "latency_p99_s": m["latency_p99_s"],
            "scenes_per_s": len(scenes) / wall,
            "compute_mean_s": m["compute_mean_s"],
            "mean_step_s": m["compute_mean_s"] / STEPS,
            "rebuilds": m["rebuilds"], "rebuild_waits": m["rebuild_waits"],
            "rebuild_mean_s": m["rebuild_mean_s"],
            "rebuild_share": m["rebuild_mean_s"] / m["compute_mean_s"],
            **rebuild, "wall_s": wall,
            "device_vs_host": rebuild_modes(pipe, scenes, dev)}


def rebuild_modes(pipe, scenes, dev) -> dict:
    """The serve scenes through ``BatchedRolloutEngine`` with the kernels
    for REBUILD_STEPS steps, once with device and once with host rebuilds:
    the trajectories must be bitwise equal, the device run must fetch no
    coordinates and upload no edges; each mode's seconds a rebuild (host
    clock, the flags' or coordinates' fetch included).  Also the device
    build of the four slots alone (``device_radius_build`` +
    ``device_csr``), CUDA events, median of 5."""
    import numpy as np
    import torch

    from repro_torch.data.cell_list import device_csr, device_radius_build
    from repro_torch.rollout import BatchedRolloutEngine

    out, trajs = {}, {}
    for mode in ("device", "host"):
        eng = BatchedRolloutEngine(
            pipe.predict_fn, batch_size=MAX_BATCH, node_cap=NODE_CAP,
            edge_cap=NODE_CAP * EDGES_PER_NODE, r=R, skin=SKIN, dt=DT,
            wrap_box=BOX, rebuild_mode=mode, device=dev)
        t0 = time.perf_counter()
        res = eng.run(pipe.params, scenes, REBUILD_STEPS)
        wall = time.perf_counter() - t0
        trajs[mode] = res.trajectories
        out[mode] = {"rebuilds": res.rebuild_count,
                     "rebuild_s": res.rebuild_s,
                     "rebuild_mean_s": res.rebuild_s / max(1,
                                                           res.rebuild_count),
                     "coord_d2h_bytes": res.coord_d2h_bytes,
                     "edge_h2d_bytes": res.edge_h2d_bytes,
                     "cell_overflows": res.cell_overflows,
                     "rebuild_waits": res.rebuild_waits, "wall_s": wall}
        if mode == "device":
            out[mode]["cell_cap"] = eng._cell_cap
            g = eng._g
            kw = dict(r_build=R + SKIN, edge_cap=eng.edge_cap,
                      cell_cap=eng._cell_cap)

            def build():
                db = device_radius_build(g.x, g.node_mask, **kw)
                return device_csr(db.receivers, db.edge_mask, NODE_CAP)

            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out["device_build_ms"] = cuda_ms(build, reps=5, warm=1)
            out["device_build_peak_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
    dv = out["device"]
    if dv["rebuilds"] < 2 or dv["coord_d2h_bytes"] or dv["edge_h2d_bytes"] \
            or dv["rebuild_waits"]:
        raise AssertionError(f"device rebuilds: {dv}")
    if out["host"]["rebuilds"] != dv["rebuilds"] or not all(
            np.array_equal(a, b) for a, b in zip(trajs["device"],
                                                 trajs["host"])):
        raise AssertionError("device and host rebuilds gave different "
                             "trajectories")
    out["bitwise_equal"] = True
    out["steps"] = REBUILD_STEPS
    return out


def _scale_scene():
    """The 113,000-particle scene of the scale and dist phases."""
    import numpy as np

    from repro_torch.data.fluid import simulate_fluid

    xs, _ = simulate_fluid(np.random.default_rng(0), SCALE_PARTICLES, 1)
    return xs[0].astype(np.float32)


def phase_scale(pipe, dev, bpipe=None) -> dict:
    """One 113K-particle step (see the module docstring); with ``bpipe``
    (the same model in bf16) also its step, timed and profiled, with every
    FastEGNN kernel call in bf16 and its frame within BF_MODEL_L2 of the
    f32 step's."""
    import torch

    from repro_torch.core.graph import GeometricGraph

    t0 = time.perf_counter()
    x0 = _scale_scene()
    x, snd, rcv, em, nm, indptr, n_edges = serving_graph(
        x0, SCALE_CAP, R, R, dev)
    build_s = time.perf_counter() - t0
    device_build = scale_device_build(x0, dev)
    n = SCALE_CAP
    g = GeometricGraph(
        x=x[None], v=torch.zeros_like(x)[None],
        h=nm[None, :, None].clone(), senders=snd[None], receivers=rcv[None],
        edge_attr=torch.zeros((1, snd.shape[0], 0), device=dev),
        node_mask=nm[None], edge_mask=em[None])
    lay = (indptr[None], torch.tensor([n_edges], device=dev))
    step = lambda: pipe.predict_fn(pipe.params, g, lay)
    out = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if tuple(out.shape) != (1, n, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"scale step gave shape {tuple(out.shape)} or "
                             f"non-finite values")
    res = {"phase": "scale", "particles": SCALE_PARTICLES, "node_cap": n,
           "edges": n_edges, "live_edges": int((em[:n_edges] != 0).sum()),
           "graph_build_s": build_s, "device_build": device_build,
           "step_ms_median": 1e3 * statistics.median(times),
           "step_ms_min": 1e3 * min(times),
           "profile_step": profile_step(step)}
    if bpipe is not None:
        from repro_torch.kernels import edge_message, virtual_message

        bstep = lambda: bpipe.predict_fn(bpipe.params, g, lay)
        edge_message.reset_launches()
        virtual_message.reset_launches()
        bout = bstep()
        torch.cuda.synchronize()
        prec = precision_counts()
        btimes, ftimes = [], []
        for _ in range(5):  # in turns with the f32 step
            for fn, ts in ((bstep, btimes), (step, ftimes)):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t)
        keep = nm[None, :, None]
        b = {"step_ms_median": 1e3 * statistics.median(btimes),
             "f32_step_ms_median": 1e3 * statistics.median(ftimes),
             "frame_rel_l2_vs_f32": rel_l2(bout * keep, out * keep),
             "displacement_rel_l2_vs_f32": rel_l2((bout - x[None]) * keep,
                                                  (out - x[None]) * keep),
             "precision_launches": prec, "profile_step": profile_step(bstep)}
        res["bf16"] = b
        if not (bool(torch.isfinite(bout).all())
                and b["frame_rel_l2_vs_f32"] < BF_MODEL_L2
                and _only_bf16(prec, LAYERS, LAYERS)):
            raise AssertionError(f"scale_bf16 failed: {json.dumps(res)}")
    return res


def scale_device_build(x0, dev) -> dict:
    """The 113K-particle graph built on the card (``device_radius_build``
    + ``device_csr``), bitwise against the host build, timed with CUDA
    events (median of 5), with its peak device memory above what was
    allocated before."""
    import numpy as np
    import torch

    from repro_torch.data.cell_list import (auto_cell_cap, cell_occupancy,
                                            device_csr, device_radius_build)
    from repro_torch.data.radius_graph import pad_nodes

    t0 = time.perf_counter()
    sp, rp, em, indptr, n_edges = host_graph(x0, SCALE_CAP, R)
    host_s = time.perf_counter() - t0
    xp, nm = pad_nodes(x0, SCALE_CAP)
    x, nm = torch.from_numpy(xp).to(dev), torch.from_numpy(nm).to(dev)
    occ = cell_occupancy(x0, R)
    kw = dict(r_build=R, edge_cap=SCALE_CAP * EDGES_PER_NODE,
              cell_cap=min(SCALE_CAP, auto_cell_cap(occ)))

    def build():
        db = device_radius_build(x, nm, **kw)
        return db, device_csr(db.receivers, db.edge_mask, SCALE_CAP)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    db, (d_indptr, d_n_edges) = build()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    equal = {"senders": np.array_equal(db.senders.cpu().numpy(), sp),
             "receivers": np.array_equal(db.receivers.cpu().numpy(), rp),
             "edge_mask": np.array_equal(db.edge_mask.cpu().numpy(), em),
             "indptr": np.array_equal(d_indptr.cpu().numpy(), indptr),
             "n_edges": int(d_n_edges) == n_edges}
    if bool(db.overflow) or not all(equal.values()):
        raise AssertionError(f"113K device build differs from the host "
                             f"build: {equal}, overflow {bool(db.overflow)}")
    return {"bitwise_equal": True, "occupancy": occ,
            "cell_cap": kw["cell_cap"],
            "candidates": SCALE_CAP * 27 * kw["cell_cap"],
            "ms_median": cuda_ms(build, reps=5, warm=1),
            "peak_bytes": peak, "host_build_s": host_s}


def phase_simulate() -> dict:
    """``python -m repro_torch.launch.simulate`` in a process of its own
    on the card: it must exit 0; its steps/s from its output."""
    import os
    import re

    cmd = [sys.executable, "-m", "repro_torch.launch.simulate", "--n",
           str(N_PARTICLES), "--steps", str(STEPS), "--use-kernel"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=600, cwd=str(ROOT))
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"simulate exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    rate = re.search(r"\(([0-9.]+) steps/s", out.stdout)
    if rate is None:
        raise AssertionError(f"simulate printed no steps/s: {out.stdout}")
    # the reference's model, served by the kernels: its dispatch counts,
    # kernel launches and the compiled width the kernels ran
    model = re.search(r"model: (.*)", out.stdout)
    counts = {k: int(v) for k, v in re.findall(
        r"(edge_kernel|edge_plain|virtual_kernel|virtual_plain|edge|virtual)"
        r"=(\d+)", out.stdout)}
    routes = re.search(r"routes: edge (\S+) virtual (\S+)", out.stdout)
    res = {"phase": "simulate", "cmd": " ".join(cmd[1:]),
           "steps_per_s": float(rate.group(1)), "process_s": wall,
           "model": model.group(1) if model else None, "dispatch": counts,
           "routes": routes.groups() if routes else None,
           "output": out.stdout.strip().splitlines()}
    want_model = ("layers={n_layers} hidden={hidden} n_virtual={n_virtual} "
                  "s_dim={s_dim}".format(**SIMULATE))
    if not (res["model"] == want_model and counts.get("edge_plain") == 0
            and counts.get("virtual_plain") == 0
            and counts.get("edge_kernel", 0) > 0
            and counts.get("edge", 0) > 0 and counts.get("virtual", 0) > 0
            and routes and all(r.startswith("w32:") for r in routes.groups())):
        raise AssertionError(f"simulate did not serve the reference's model "
                             f"through the kernels: {json.dumps(res)}")
    return res


def zoo_kwargs(name: str) -> dict:
    """Full width: 4 layers, hidden 64, h_in 1; the fast_* ones keep the
    registry's C = 3 and s_dim 64 (the reference's launch/train.py)."""
    from repro_torch.models.registry import REGISTRY

    kw = dict(h_in=1, n_layers=LAYERS, hidden=64, s_dim=64)
    return {k: v for k, v in kw.items()
            if k in REGISTRY[name].make_config._fields}


def serve_batch(scenes, dev):
    """The serve scenes as serve batches them: one (B, NODE_CAP) graph of
    the Verlet lists at R + SKIN with the step mask at R, and its CSR
    layout ``(indptr, n_edges)``."""
    import numpy as np
    import torch

    from repro_torch.core.graph import GeometricGraph
    from repro_torch.data.radius_graph import pad_nodes

    parts = []
    for x0, v0, h in scenes:
        x, sp, rp, em, nm, indptr, n_edges = serving_graph(
            x0, NODE_CAP, R + SKIN, R, dev)
        t = lambda a: torch.from_numpy(
            np.ascontiguousarray(pad_nodes(a, NODE_CAP)[0])).to(dev)
        parts.append((x, t(v0), t(h), sp, rp, nm, em, indptr, n_edges))
    st = lambda i: torch.stack([p[i] for p in parts])
    b, e = len(parts), parts[0][3].shape[0]
    g = GeometricGraph(x=st(0), v=st(1), h=st(2), senders=st(3),
                       receivers=st(4),
                       edge_attr=torch.zeros((b, e, 0), device=dev),
                       node_mask=st(5), edge_mask=st(6))
    return g, (st(7), torch.tensor([p[8] for p in parts], device=dev))


def zoo_launch_counts() -> dict:
    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message

    return {"edge_pathway_fused": edge_message.launches,
            "edge_identity": edge_message.identity_launches,
            "virtual_pathway_fused": virtual_message.launches,
            "edge_pathway_bwd_fused": edge_message.bwd_launches,
            "edge_identity_bwd": edge_message.identity_bwd_launches,
            "virtual_pathway_bwd_fused": virtual_message.bwd_launches,
            "mmd_cross_sum": mmd_rbf.sum_launches,
            "mmd_cross_grads": mmd_rbf.grad_launches}


def zoo_expected(name: str, fwd: int, bwd: int = 0, mmd: int = 0) -> dict:
    """The launches of ``fwd`` forwards and ``bwd`` backwards of one layer
    of ``name`` (and ``mmd`` MMD steps), every other count 0."""
    want = {k: 0 for k in zoo_launch_counts()}
    edge = ZOO_EDGE_KERNEL.get(name)
    if edge is not None:
        want[edge] = fwd
        want[{"edge_pathway_fused": "edge_pathway_bwd_fused",
              "edge_identity": "edge_identity_bwd"}[edge]] = bwd
    if "virtual_kernel" in ZOO_DISPATCH[name]:
        want["virtual_pathway_fused"] = fwd
        want["virtual_pathway_bwd_fused"] = bwd
    want["mmd_cross_sum"] = want["mmd_cross_grads"] = mmd
    return want


def zoo_model(name, g, lay, scene, tr, va, tc, dev) -> dict:
    """One registry model through predict, serve and fit (phase_zoo)."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import message_passing as mp
    from repro_torch.pipeline import build_pipeline
    from repro_torch.serving import RolloutService, ServiceConfig

    kw = zoo_kwargs(name)
    pipe = build_pipeline(name, device=dev, use_kernel=True, train_cfg=tc,
                          generator=torch.Generator().manual_seed(0), **kw)
    plain = build_pipeline(name, device=dev, train_cfg=tc,
                           params=pipe.params, **kw)
    b = g.x.shape[0]
    # 1. predict_fn on the serve batch, kernel path against plain path
    reset_all_launches()
    mp.reset_dispatch_counts()
    xk = pipe.predict_fn(pipe.params, g, lay)
    torch.cuda.synchronize()
    dispatch, launches = mp.dispatch_counts(), zoo_launch_counts()
    xp = plain.predict_fn(plain.params, g, None)
    real = g.node_mask[..., None] > 0
    scale = float(torch.where(real, xp.abs(), 0.0).max())
    err = float(torch.where(real, (xk - xp).abs(), 0.0).max())
    predict = {"max_abs_err": err, "max_abs_coord": scale,
               "tol": FRAME_TOL * max(1.0, scale),
               "finite": bool(torch.isfinite(xk).all()),
               "dispatch": dispatch, "launches": launches}
    want_d = {k: v * LAYERS * b for k, v in ZOO_DISPATCH[name].items()}
    want_l = zoo_expected(name, LAYERS * b)
    del xk, xp
    # 2. one RolloutService request, Verlet lists rebuilt on the card
    cfg = ServiceConfig(max_batch=1, queue_cap=4,
                        edge_cap_per_node=EDGES_PER_NODE)
    reset_all_launches()
    t0 = time.perf_counter()
    with RolloutService(pipe, config=cfg, model=name) as svc:
        hd = svc.submit(*scene, ZOO_STEPS, r=R, skin=SKIN, dt=ZOO_DT,
                        wrap_box=BOX)
        frames = [f.copy() for f in hd.frames()]
    serve_s = time.perf_counter() - t0
    serve_launches = zoo_launch_counts()
    (served,) = [svc._programs._lru.get(k) for k in svc._programs.keys()]
    tel = served._tel
    serve = {"steps": len(frames), "wall_s": serve_s,
             "finite": all(bool(np.isfinite(f).all()) for f in frames),
             "rebuild_mode": served.rebuild_mode,
             "rebuilds": svc.metrics()["rebuilds"],
             "coord_d2h_bytes": tel.coord_d2h, "edge_h2d_bytes": tel.edge_h2d,
             "steady_state_d2h_bytes": tel.steady_d2h,
             "discarded_steps": served._discarded,
             "launches": serve_launches}
    # 3. one fit epoch; its first step against the plain path
    first, step_s = first_step(pipe, plain, tr[0], tc, reps=2)
    reset_all_launches()
    t0 = time.perf_counter()
    res = pipe.fit(tr, va)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = zoo_launch_counts()
    steps = len(tr)
    train_passes, eval_passes = steps * TRAIN_BATCH, len(va) * TRAIN_BATCH
    losses = [h[k] for h in res.history for k in ("train_loss", "val_mse")]
    identity = (fit_launches["edge_identity"]
                + fit_launches["edge_identity_bwd"])
    fit = {"steps": steps, "history": res.history, "fit_s": fit_s,
           "first_step": first, "step_ms_kernel": 1e3 * step_s["kernel"],
           "step_ms_plain": 1e3 * step_s["plain"],
           "identity_launches_per_step": identity / steps,
           "launches": fit_launches}
    out = {"model": name, "cfg": pipe.cfg._asdict(), "predict": predict,
           "serve": serve, "fit": fit}
    checks = {
        "predict_close": predict["finite"] and err <= predict["tol"],
        "dispatch": dispatch == want_d,
        "predict_launches": launches == want_l,
        "serve": (serve["steps"] == ZOO_STEPS and serve["finite"]
                  and served.rebuild_mode == "device"
                  and not tel.coord_d2h and not tel.edge_h2d
                  and not tel.steady_d2h),
        "serve_launches": serve_launches == zoo_expected(
            name, LAYERS * (ZOO_STEPS + served._discarded)),
        "first_step": first["ok"],
        "fit_finite": all(math.isfinite(v) for v in losses),
        "fit_launches": fit_launches == zoo_expected(
            name, LAYERS * (train_passes + eval_passes),
            LAYERS * train_passes,
            steps if name == "fast_egnn" and tc.lam_mmd > 0 else 0)}
    out["checks"] = checks
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"zoo {name} failed {failed}: "
                             f"{json.dumps(out, default=str)}")
    return out


def phase_zoo(scenes, tr, va, dev) -> dict:
    """Every registry model at full width with the kernels: predict,
    serve, fit (see the module docstring)."""
    from repro_torch.training.trainer import TrainConfig

    t0 = time.perf_counter()
    g, lay = serve_batch(scenes, dev)
    tc = TrainConfig(epochs=1, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
                     mmd_sample=None)
    models = {name: zoo_model(name, g, lay, scenes[0], tr, va, tc, dev)
              for name in ZOO}
    return {"phase": "zoo", "models": models, "layers": LAYERS,
            "scenes": len(scenes), "serve_steps": ZOO_STEPS,
            "frame_tol": FRAME_TOL, "seconds": time.perf_counter() - t0}


class _GradsOut:
    """An optimizer stand-in whose update returns the gradients, so a
    train step exposes them."""

    def update(self, grads, state, params):
        return grads, state


def _update_close(got, want, grads) -> dict:
    """Parameters after one Adam step, kernel path against plain path, per
    leaf relative to its largest magnitude (GATOL / GRTOL), on the entries
    whose gradient is at least SMALL_GRAD of the gradient tolerance's
    scale (the leaf's largest gradient + 1e-6, as in compare_grads).  The
    step moves an entry by lr·g/(|g| + eps), which carries the gradient's
    own relative error; the gradient tolerance leaves that error unbounded
    for entries far below its scale, so those are counted and left out
    here (every gradient entry is compared before, at GATOL / GRTOL)."""
    from repro_torch.training.optim import tree_leaves

    worst, ok, skipped, total = 0.0, True, 0, 0
    for g, w, gr in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(grads)):
        if not w.numel():
            continue
        keep = gr.abs() >= SMALL_GRAD * (float(gr.abs().max()) + 1e-6)
        skipped += int((~keep).sum())
        total += keep.numel()
        scale = float(w.abs().max()) + 1e-6
        d = (g - w).abs() * keep
        worst = max(worst, float(d.max()) / scale)
        ok &= bool((d <= GATOL * scale + GRTOL * w.abs()).all())
    return {"max_rel_err": worst, "within_tol": ok,
            "entries_compared": total - skipped, "entries": total}


def profile_step(fn, watch: str = "") -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (the
    profiler's own overhead included), the device time summed over
    kernels, the idle share and the kernels that take the most device
    time; with ``watch``, also the launches and device time of the
    kernels whose name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only: a host op's "self device time" repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:12]
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy_ms if events else "not measured",
           "idle_share": 1 - busy_ms / wall_ms if events else "not measured",
           "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top}}
    if watch:
        seen = [e for e in events if watch in e.key]
        out[f"{watch}kernels"] = {"launches": sum(e.count for e in seen),
                                  "device_ms": sum(map(dev_us, seen)) / 1e3}
    return out


def first_step(pipe, plain, batch, tc, reps: int = 3) -> tuple[dict, dict]:
    """One train step from the same weights, kernel path twice and plain
    path once: the losses (ATOL / RTOL), the gradients (compare_grads),
    the updated parameters (_update_close) and whether the kernel path
    repeats bitwise; then the median host time of a step each way
    (seconds)."""
    import torch

    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import build_train_step

    p0 = pipe.params
    k1, _, mk = pipe.train_step(p0, pipe.opt.init(p0), batch)
    k2, _, _ = pipe.train_step(p0, pipe.opt.init(p0), batch)
    pl, _, mp = plain.train_step(p0, plain.opt.init(p0), batch)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(tree_leaves(k1), tree_leaves(k2)))
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    loss_ok = abs(loss_k - loss_p) <= ATOL + RTOL * abs(loss_p)
    grads = [build_train_step(pp.apply_full, pp.cfg, tc, _GradsOut())[0](
        p0, None, batch)[0] for pp in (pipe, plain)]
    gcmp = compare_grads(tree_leaves(grads[0]), tree_leaves(grads[1]))
    upd = _update_close(k1, pl, grads[1])
    step_s = {}
    for name, pp in (("kernel", pipe), ("plain", plain)):
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            pp.train_step(p0, pp.opt.init(p0), batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        step_s[name] = statistics.median(times)
    # ``ok`` leaves the repeat out: a plain gather's backward (the zoo's
    # cfconv and TFN paths) adds on the card in no fixed order
    ok = loss_ok and gcmp["within_tol"] and upd["within_tol"]
    return ({"loss_kernel": loss_k, "loss_plain": loss_p,
             "loss_within_tol": loss_ok, "grads": gcmp, "params": upd,
             "bitwise_repeatable": bitwise, "ok": ok}, step_s)


def train_batches(dev) -> tuple:
    """The 6 + 2 fluid scenes of the train and zoo phases as layout-
    carrying batches of TRAIN_BATCH on the card, and the seconds taken."""
    from repro_torch.data.fluid import generate_fluid_dataset
    from repro_torch.data.loader import dataset_to_batches

    t0 = time.perf_counter()
    data = generate_fluid_dataset(TRAIN_SCENES + VAL_SCENES,
                                  n_particles=N_PARTICLES)
    tr, va = (dataset_to_batches(d, TRAIN_BATCH, r=R, with_layout=True,
                                 device=dev)
              for d in (data[:TRAIN_SCENES], data[TRAIN_SCENES:]))
    if not (len(tr) == 2 and tr[1].sample_mask is not None):
        raise AssertionError("expected a full and a mask-padded train batch")
    return tr, va, time.perf_counter() - t0


def phase_train(dev, tr, va, data_s) -> dict:
    import math

    import torch

    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.trainer import TrainConfig

    tc = TrainConfig(epochs=EPOCHS, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
                     mmd_sample=None)
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          train_cfg=tc,
                          generator=torch.Generator().manual_seed(0))
    plain = build_pipeline("fast_egnn", device=dev, train_cfg=tc,
                           params=pipe.params)
    first, step_s = first_step(pipe, plain, tr[0], tc)
    loss_k, loss_p = first["loss_kernel"], first["loss_plain"]
    p0 = pipe.params
    prof = profile_step(lambda: pipe.train_step(p0, pipe.opt.init(p0), tr[0]),
                        watch="mmd_")

    for mod in (edge_message, virtual_message, mmd_rbf):
        mod.reset_launches()
    t0 = time.perf_counter()
    res = pipe.fit(tr, va)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches,
                "edge_pathway_bwd_fused": edge_message.bwd_launches,
                "virtual_pathway_bwd_fused": virtual_message.bwd_launches,
                "mmd_cross_sum": mmd_rbf.sum_launches,
                "mmd_cross_grads": mmd_rbf.grad_launches}
    steps = EPOCHS * len(tr)
    train_passes = steps * TRAIN_BATCH  # slots, padded ones included
    eval_passes = EPOCHS * len(va) * TRAIN_BATCH
    # the MMD pair: one batched call of each a train step
    want = {"edge_pathway_fused": LAYERS * (train_passes + eval_passes),
            "virtual_pathway_fused": LAYERS * (train_passes + eval_passes),
            "edge_pathway_bwd_fused": LAYERS * train_passes,
            "virtual_pathway_bwd_fused": LAYERS * train_passes,
            "mmd_cross_sum": steps, "mmd_cross_grads": steps}
    losses = [h[k] for h in res.history for k in ("train_loss", "val_mse")]
    out = {"phase": "train", "particles": N_PARTICLES,
           "scenes": {"train": TRAIN_SCENES, "val": VAL_SCENES},
           "batch": TRAIN_BATCH, "epochs": EPOCHS, "steps": steps,
           "lam_mmd": LAM_MMD, "mmd_sample": None,
           "n_edges": [int(b.layout[1].max()) for b in tr],
           "data_s": data_s, "history": res.history,
           "first_step": first,
           "step_ms_kernel": 1e3 * step_s["kernel"],
           "step_ms_plain": 1e3 * step_s["plain"], "profile_kernel_step": prof,
           "fit_s": fit_s, "launches": launches, "launches_expected": want}
    if not all(math.isfinite(v) for v in losses + [loss_k, loss_p]):
        raise AssertionError(f"non-finite loss: {json.dumps(out)}")
    if launches != want:
        raise AssertionError(f"launch counts differ: {json.dumps(out)}")
    if not (first["ok"] and first["bitwise_repeatable"]):
        raise AssertionError(f"first step disagrees: {json.dumps(out)}")
    return out


# ------------------------------------------------------------ widths phase
def _width_key(dh: int, h1: int, m: int) -> str:
    return str(dh) if dh == h1 == m else f"{dh}-{h1}-{m}"


def _width_flops(kind: str, n: int, live: int, c: int, dh: int, h1: int,
                 m: int) -> float:
    """The function's own FLOP at widths (Dh, H1, M) (virtual: hid = H1),
    as the kernels phase counts them at 64."""
    if kind == "edge_fwd":  # h.W1r, h.W1s; per live edge .W2, .Wg1, .wg2
        return n * 2 * 2 * dh * h1 + live * (2 * h1 * m + 2 * m * h1
                                             + 2 * h1)
    if kind == "edge_bwd":  # six products per live edge and per node
        return live * 6 * 2 * h1 * m + n * 6 * 2 * dh * h1
    if kind == "virtual_fwd":
        return n * c * (2 * dh * h1 + 3 * 2 * h1 * h1 + 4 * h1)
    if kind == "virtual_bwd":  # recompute, cotangents, outer products
        return n * c * 2 * (3 * dh * h1 + 9 * h1 * h1)
    if kind == "identity_fwd":
        return n * 4 * dh * h1 + live * (8 + 10 * h1 + 12)
    return (n * 4 * dh * h1 + live * (8 + 10 * h1 + 12)  # identity_bwd
            + live * (14 * h1 + 30) + n * 8 * dh * h1)


def _width_bytes(kind: str, n: int, n_edges: int, c: int, dh: int, h1: int,
                 m: int, hw: int = 4) -> float:
    """Each input read once and each output written once, f32; h, x, z
    and the weights at ``hw`` bytes (2: the bf16 mode's operands)."""
    f = 4
    graph = n * 3 * hw + n_edges * 2 * f + (n + 1) * f
    if kind.startswith("edge"):
        w = (2 * dh * h1 + 3 * h1 + h1 * m + m + m * h1 + h1) * hw
        io = graph + n * dh * hw + w + n * (3 + m + 1) * f
        return io if kind == "edge_fwd" else 2 * io + n_edges * f
    if kind.startswith("identity"):
        w = (2 * dh * h1 + 3 * h1 + 1) * hw
        io = graph + n * dh * hw + w + n * 5 * f
        return io if kind == "identity_fwd" else 2 * io + n_edges * f
    w = c * (dh * h1 + 3 * h1 * h1 + 7 * h1) * hw  # virtual
    io = n * (3 * hw + dh * hw + f) + c * 3 * hw + w + n * (3 + h1) * f \
        + c * (3 + h1) * f
    return io if kind == "virtual_fwd" else 2 * io


def _reading(run, plain, fault, cmp, kind, shape, tensor_core: bool,
             cta=None, f32=None) -> dict:
    """One kernel at one width: against its plain version (``cmp``), a
    bitwise repeat, a planted fault, CUDA-event and device times, bounds;
    ``cta``: a run with another CTA count, bitwise equal (or, for the edge
    backward's weight gradients, within the tolerance).  ``f32``: for a
    bf16 reading, the f32 kernel on the same inputs: the bf16 mode must be
    engaged (an output BF_ENGAGED away from it), plain_ms is timed, and
    the bounds count h, x and the weights at 2 bytes, the FLOP at the bf16
    rate and (``bound_tf32_ms``) at the TF32 rate."""
    got, again, want = run(), run(), plain()
    r = cmp(got, want)
    r["bitwise_repeatable"] = repeat_equal(got, again)
    bad = cmp(fault(), want)
    r["planted_fault_caught"] = not bad["within_tol"]
    if f32 is not None:
        r["fault_atol_needed"] = bad["atol_needed"]
        r["fault_rel_l2_per_output"] = bad["rel_l2_per_output"]
        r["vs_f32_rel_l2"] = max(rel_l2(a, b) for a, b in zip(got, f32())
                                 if b.numel())
        r["engaged"] = r["vs_f32_rel_l2"] >= BF_ENGAGED
    if cta is not None:
        other = cta()
        r["cta_max_diff"] = [float((a - b).abs().max()) for a, b in
                             zip(got, other)]
        if kind == "edge_bwd":  # gx, gh bitwise; the weights' partials
            r["cta_counts_equal"] = (repeat_equal(got[:2], other[:2])
                                     and cmp(other, want)["within_tol"])
        else:
            r["cta_counts_equal"] = repeat_equal(got, other)
    del got, again, want
    n, live, n_edges = shape[:3]
    flops = _width_flops(kind, n, live, *shape[3:])
    if f32 is not None:
        n_bytes = _width_bytes(kind, n, n_edges, *shape[3:], hw=2)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_FLOPS)
        r.update(ms=cuda_ms(run, 5, 1), plain_ms=cuda_ms(plain, 3, 1),
                 bound_ms=b_ms, bound_by=b_by,
                 bound_tf32_ms=bound_ms(n_bytes, flops, TF32_FLOPS)[0],
                 library_ms=None, **device_fields(run))
        return r
    n_bytes = _width_bytes(kind, n, n_edges, *shape[3:])
    b_ms, b_by = bound_ms(n_bytes, flops)
    r.update(ms=cuda_ms(run, 5, 1), bound_ms=b_ms, bound_by=b_by)
    if tensor_core:
        r.update(tensor_core_fields(run, n_bytes, flops))
    else:
        r.update(device_fields(run))
    return r


def _width_weights(gen, dh, h1, m, dev):
    import torch

    r = lambda *s, sc: sc * torch.randn(s, generator=gen, device=dev)
    sc1 = (2 * dh + 1) ** -0.5
    return [r(dh, h1, sc=sc1), r(dh, h1, sc=sc1), r(1, h1, sc=0.3),
            r(1, h1, sc=0.1), r(h1, m, sc=h1 ** -0.5), r(1, m, sc=0.1),
            r(m, h1, sc=m ** -0.5), r(1, h1, sc=0.1),
            r(h1, 1, sc=h1 ** -0.5)]


def _graph_operands(x, snd, em, indptr, n_edges, dev):
    """The sender permutation and a copy of ``em`` with one live slot
    zeroed (the planted fault)."""
    import torch

    from repro_torch.data.radius_graph import csr_sender_perm

    n = x.shape[0]
    perm, sptr = csr_sender_perm(snd.cpu().numpy(), n_edges, n)
    sperm = torch.zeros_like(snd)
    sperm[:perm.size] = torch.from_numpy(perm).to(dev)
    live = torch.nonzero(em[:n_edges]).flatten()
    em_bad = em.clone()
    em_bad[live[live.numel() // 2]] = 0.0
    return (sperm, torch.from_numpy(sptr).to(dev)), em_bad, int(live.numel())


def edge_width_readings(x, snd, em, indptr, n_edges, dh, h1, m, dev,
                        identity=True, cta=False, precision="f32") -> dict:
    """#1 and #2 (gate 'mlp', FastEGNN's rel and clamp) and, if asked, the
    identity pair in SchNet's form (Dh, H1) and RF's (Dh = 1) at these
    widths on this graph; in ``precision`` ('bf16': against the bf16 plain
    versions, compare_bf16, and the f32 kernels)."""
    import torch

    from repro_torch.kernels import edge_message as em_mod

    gen = torch.Generator(device=dev).manual_seed(dh * 1000 + h1 + m)
    n = x.shape[0]
    sender, em_bad, live = _graph_operands(x, snd, em, indptr, n_edges, dev)
    out = {"route": em_mod.kernel_route(dh, h1, m)}
    forms = [("edge", "mlp", "raw", 100.0, dh, m)]
    if identity:
        forms += [("identity", "identity", "raw", 100.0, dh, 1),
                  ("identity_rf", "identity", "inv1p", 100.0, 1, 1)]
    for name, gate, rel, clamp, fdh, fm in forms:
        ws = _width_weights(gen, fdh, h1, fm, dev)
        if gate == "identity":
            ws[6:] = [torch.zeros(1, 1, device=dev)] * 3
        h = (torch.randn((n, fdh), generator=gen, device=dev)
             if name != "identity_rf"
             else torch.zeros(n, 1, device=dev))
        kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp,
                  precision=precision)
        kw32 = dict(kw, precision="f32")
        args = [x, h, snd, em, indptr, *ws]
        bad = [x, h, snd, em_bad, indptr, *ws]
        g_dx = torch.randn((n, 3), generator=gen, device=dev)
        g_mh = torch.randn((n, fm), generator=gen, device=dev)
        fwd = lambda a=args, k=kw: em_mod.edge_pathway_fused(*a, **k)
        fplain = lambda: em_mod.edge_pathway_plain(*args, **kw)
        deg = fplain()[2].contiguous()
        bwd = lambda a=args, k=kw: em_mod.edge_pathway_bwd_fused(
            *a[:5], *sender, *a[5:], deg, g_dx, g_mh, **k)
        bplain = lambda: em_mod.edge_pathway_bwd_plain(*args, g_dx, g_mh,
                                                       deg=deg, **kw)
        bf = precision != "f32"
        fcmp, bcmp = ((compare_bf16, compare_bf16) if bf
                      else (compare, compare_grads))
        ctas = ("EDGE_FWD_CTAS", "EDGE_BWD_CTAS") if gate != "identity" \
            else ("IDENTITY_CTAS", "IDENTITY_CTAS")

        def other(fn, attr, value):
            def go():
                old = getattr(em_mod, attr)
                setattr(em_mod, attr, value)
                try:
                    return fn()
                finally:
                    setattr(em_mod, attr, old)
            return go

        tc = gate != "identity"
        kshape = (n, live, n_edges, 3, fdh, h1, fm)
        kind = "edge" if tc else "identity"
        out[name] = {
            "fwd": _reading(fwd, fplain, lambda: fwd(bad), fcmp,
                            f"{kind}_fwd", kshape, tc,
                            other(fwd, ctas[0], 61) if cta else None,
                            (lambda: fwd(args, kw32)) if bf else None),
            "bwd": _reading(bwd, bplain, lambda: bwd(bad), bcmp,
                            f"{kind}_bwd", kshape, tc,
                            other(bwd, ctas[1], 97) if cta else None,
                            (lambda: bwd(args, kw32)) if bf else None)}
        torch.cuda.empty_cache()
    return out


def virtual_width_readings(x, nm, dh, hid, dev, precision="f32") -> dict:
    """#3 and #4 at Dh, hid on the serve scene's nodes (C = 3), in
    ``precision`` (as edge_width_readings)."""
    import torch

    from repro_torch.kernels import virtual_message as vm

    gen = torch.Generator(device=dev).manual_seed(dh * 1000 + hid)
    n, c = x.shape[0], 3
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
    args = [x, r(n, dh), x[:c] + 0.05 * r(c, 3), nm,
            r(c, dh, hid, sc=dh ** -0.5), r(c, hid, sc=0.3),
            r(c, hid, sc=0.3), r(c, hid, hid, sc=hid ** -0.5),
            r(c, hid, sc=0.1), r(c, hid, hid, sc=hid ** -0.5),
            r(c, hid, sc=0.1), r(c, hid, 1, sc=hid ** -0.5),
            r(c, hid, hid, sc=hid ** -0.5), r(c, hid, sc=0.1),
            r(c, hid, 1, sc=hid ** -0.5)]
    bad = list(args)
    bad[3] = nm.clone()
    bad[3][0] = 1.0 - bad[3][0]
    cots = (r(n, 3), r(n, hid), r(c, 3), r(c, hid))
    shape = (n, 0, 0, c, dh, hid, hid)
    p = precision
    fwd = lambda a=args, p=p: vm.virtual_pathway_fused(*a, precision=p)
    bwd = lambda a=args, p=p: vm.virtual_pathway_bwd_fused(*a, *cots,
                                                           precision=p)
    bf = precision != "f32"
    out = {"route": vm.kernel_route(dh, hid),
           "fwd": _reading(fwd, lambda: vm.virtual_pathway_plain(
               *args, precision=p), lambda: fwd(bad),
               (lambda g, w: compare_bf16(g, w, sums=(2, 3))) if bf
               else compare, "virtual_fwd", shape, True,
               f32=(lambda: fwd(args, "f32")) if bf else None),
           "bwd": _reading(bwd, lambda: vm.virtual_pathway_bwd_plain(
               *args, *cots, precision=p), lambda: bwd(bad),
               compare_bf16 if bf else compare_grads, "virtual_bwd", shape,
               True, f32=(lambda: bwd(args, "f32")) if bf else None)}
    torch.cuda.empty_cache()
    return out


def _width_ok(readings) -> bool:
    """Every reading within its tolerance, repeatable, its fault caught,
    its CTA counts equal and (bf16) the bf16 mode engaged."""
    if isinstance(readings, dict):
        if "within_tol" in readings:
            return (readings["within_tol"] and readings["bitwise_repeatable"]
                    and readings["planted_fault_caught"]
                    and readings.get("cta_counts_equal", True)
                    and readings.get("engaged", True))
        return all(_width_ok(v) for k, v in readings.items()
                   if k != "route")
    return True


def phase_widths(scene, dev) -> dict:
    """#1 to #4 and the identity pair alone at every width of
    WIDTH_CASES on the serve Verlet list (N = 8,192), and #1 / #2 at
    WIDE_WIDTH on a WIDE_NODES-node graph."""
    import numpy as np
    import torch

    from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                               radius_graph,
                                               sort_edges_by_receiver)

    t0 = time.perf_counter()
    x, snd, _rcv, em, nm, indptr, n_edges = serving_graph(
        scene[0], NODE_CAP, R + SKIN, R, dev)
    cases = {}
    with torch.no_grad():
        for dh, h1, m in WIDTH_CASES:
            cta = h1 in CTA_WIDTHS and dh == h1 == m
            cases[_width_key(dh, h1, m)] = {
                "edge_pair": edge_width_readings(x, snd, em, indptr, n_edges,
                                                 dh, h1, m, dev, cta=cta),
                "virtual_pair": virtual_width_readings(x, nm, dh, h1, dev)}
        rng = np.random.default_rng(0)
        xs = rng.uniform(0.0, 1.0, (WIDE_NODES, 3)).astype(np.float32)
        s, rc = sort_edges_by_receiver(*radius_graph(xs, 0.3))
        sp, rp, ems = pad_edges(s, rc, 2 * s.size, xs)
        ems[::7] = 0.0  # holes in the live slots
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        w = WIDE_WIDTH
        cases[f"{w}@{WIDE_NODES}"] = {"edge_pair": edge_width_readings(
            t(xs), t(sp), t(ems), t(csr_indptr(rp, s.size, WIDE_NODES)),
            s.size, w, w, w, dev, identity=False)}
    out = {"phase": "widths", "tolerance": {"atol": ATOL, "rtol": RTOL,
                                            "grad_atol": GATOL,
                                            "grad_rtol": GRTOL},
           "n": NODE_CAP, "slots": int(snd.shape[0]), "n_edges": n_edges,
           "cases": cases, "seconds": time.perf_counter() - t0}
    if not _width_ok(cases):
        raise AssertionError(f"a width case failed: {json.dumps(out)}")
    return out


def phase_widths_bf16(scene, dev) -> dict:
    """The bf16 mode of #1 to #4 and the identity pair alone at every
    width of BF_WIDTH_CASES on the serve Verlet list: against the bf16
    plain versions (compare_bf16), a bitwise repeat, the planted fault,
    two CTA counts at CTA_WIDTHS, engaged against the f32 kernels; times
    and bounds."""
    import torch

    t0 = time.perf_counter()
    x, snd, _rcv, em, nm, indptr, n_edges = serving_graph(
        scene[0], NODE_CAP, R + SKIN, R, dev)
    cases = {}
    with torch.no_grad():
        for dh, h1, m in BF_WIDTH_CASES:
            cta = h1 in CTA_WIDTHS
            cases[_width_key(dh, h1, m)] = {
                "edge_pair": edge_width_readings(
                    x, snd, em, indptr, n_edges, dh, h1, m, dev, cta=cta,
                    precision="bf16"),
                "virtual_pair": virtual_width_readings(x, nm, dh, h1, dev,
                                                       precision="bf16")}
    out = {"phase": "widths_bf16",
           "tolerance": {"rel_l2": BF_L2, "rtol": BF_KRTOL,
                         "atol_of_max": BF_KATOL,
                         "virtual_sums_rel_l2": BF_SUM_L2,
                         "engaged": BF_ENGAGED},
           "n": NODE_CAP, "slots": int(snd.shape[0]), "n_edges": n_edges,
           "cases": cases, "seconds": time.perf_counter() - t0}
    if not _width_ok(cases):
        raise AssertionError(f"a bf16 width case failed: {json.dumps(out)}")
    return out


def bf16_edge_line(widths_bf16: dict) -> dict:
    """The bf16 kernels redesigned on bf16 tiles (BF_EDGE_PARENT: the edge
    pair, the identity backward in SchNet's and RF's forms, #3, #4): device
    ms at 64 and 32 (the widths_bf16 phase's readings) and, for #1 to #4,
    the CTAs an SM (as the card reports them for the kernels' registers
    and shared memory), beside the parent's."""
    from repro_torch.kernels import build
    from repro_torch.kernels import edge_message as em_mod
    from repro_torch.kernels import virtual_message as vm

    occ = {"edge_pathway_fused": build.load(
               "edge_message", em_mod._bind).edge_fwd_occupancy,
           "edge_pathway_bwd_fused": build.load(
               "edge_message_bwd", em_mod._bind_bwd).edge_bwd_occupancy,
           "virtual_pathway_fused": build.load(
               "virtual_message", vm._bind).virtual_fwd_occupancy,
           "virtual_pathway_bwd_fused": build.load(
               "virtual_message_bwd", vm._bind_bwd).virtual_bwd_occupancy}
    # each kernel's reading in a widths_bf16 case: (pair, form, pass)
    where = {"edge_pathway_fused": ("edge_pair", "edge", "fwd"),
             "edge_pathway_bwd_fused": ("edge_pair", "edge", "bwd"),
             "edge_identity_bwd": ("edge_pair", "identity", "bwd"),
             "edge_identity_bwd_rf": ("edge_pair", "identity_rf", "bwd"),
             "virtual_pathway_fused": ("virtual_pair", None, "fwd"),
             "virtual_pathway_bwd_fused": ("virtual_pair", None, "bwd")}
    out = {"phase": "bf16_edge", "gpu": gpu_line(), "kernels": {}}
    for name, (pair, form, kind) in where.items():
        row = {"device_ms": {}, "parent": BF_EDGE_PARENT[name]}
        for w in ("64", "32"):
            r = widths_bf16["cases"][w][pair]
            row["device_ms"][w] = (r[form] if form else r)[kind]["device_ms"]
        if name in occ:
            row["ctas_per_sm"] = {w: occ[name](int(w), 1)
                                  for w in ("64", "32")}
        out["kernels"][name] = row
    if min(v for k in out["kernels"].values()
           for v in k.get("ctas_per_sm", {}).values()) < 2:
        raise AssertionError(f"a bf16 kernel on bf16 tiles fits fewer than "
                             f"two CTAs an SM: {json.dumps(out)}")
    return out


def identity_f32_line(kline: dict) -> dict:
    """The identity pair in f32 on its tile route (IDN_F32_PARENT): device
    ms and the split by kernel (µs) of the kernels phase's rows at hidden
    64 and 32, SchNet's form and RF's, beside the figures before."""
    rows = {"64": {r["name"]: r for r in kline["kernels"]},
            "32": {r["name"]: r for r in kline["hidden32"]}}
    out = {"phase": "identity_f32", "gpu": gpu_line(), "kernels": {}}
    for key, parent in IDN_F32_PARENT.items():
        name = key.removesuffix("_rf")
        got = {w: (rs[name]["rf_form"] if key.endswith("_rf") else rs[name])
               for w, rs in rows.items()}
        out["kernels"][key] = {
            "device_ms": {w: r["device_ms"] for w, r in got.items()},
            "kernels_us": {w: r["kernels_us"] for w, r in got.items()},
            "parent_device_ms": parent}
    return out


def identity_fwd_line(kline: dict, widths_bf16: dict) -> dict:
    """The identity forward on its tile pass (IDN_FWD_PARENT): device ms
    and the µs split by kernel -- the projection (with the CSR
    by-products: rowof, ctarow) and the tile pass -- in f32 (the kernels
    phase's rows at hidden 64 and 32) and bf16 (widths_bf16 at 64 and 32),
    SchNet's form and RF's, beside the figures before."""
    def split(kernels_us: dict) -> dict:
        out = {"projection_and_by_products": 0.0, "tile_pass": 0.0,
               "other": 0.0}
        for name, us in kernels_us.items():
            key = ("tile_pass" if "idn_fwd_tiles" in name else
                   "projection_and_by_products"
                   if "padded_proj" in name or "idn_proj" in name
                   else "other")
            out[key] += us
        return out

    rows = {"64": {r["name"]: r for r in kline["kernels"]},
            "32": {r["name"]: r for r in kline["hidden32"]}}
    out = {"phase": "identity_fwd", "gpu": gpu_line(), "kernels": {}}
    for prec, table in IDN_FWD_PARENT.items():
        for key, parent in table.items():
            got = {}
            for w in ("64", "32"):
                if prec == "f32":
                    r = rows[w]["edge_identity"]
                    r = r["rf_form"] if key.endswith("_rf") else r
                else:
                    form = "identity_rf" if key.endswith("_rf") else "identity"
                    r = widths_bf16["cases"][w]["edge_pair"][form]["fwd"]
                got[w] = r
            out["kernels"][f"{prec}/{key}"] = {
                "device_ms": {w: r["device_ms"] for w, r in got.items()},
                "split_us": {w: split(r["kernels_us"])
                             for w, r in got.items()},
                "parent_device_ms": parent}
    return out


# ------------------------------------------------------------- bf16 phases
def _periodic_rel_l2(got, want, base=None) -> float:
    """Relative L2 of frames ``got`` against ``want`` (numpy, wrapped in
    [0, BOX)) by periodic differences; with ``base`` (the frames' start),
    of the displacements from it instead."""
    import numpy as np

    wrap = lambda d: (d + BOX / 2) % BOX - BOX / 2
    d = wrap(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    ref = (np.asarray(want, np.float64) if base is None
           else wrap(np.asarray(want, np.float64)
                     - np.asarray(base, np.float64)))
    return float(np.linalg.norm(d) / max(np.linalg.norm(ref), 1e-30))


def precision_counts() -> dict:
    """The FastEGNN kernels' calls per precision (forward and backward,
    every route) since the last reset."""
    from repro_torch.kernels import edge_message, virtual_message

    return {"edge": dict(edge_message.precision_launches),
            "virtual": dict(virtual_message.precision_launches)}


def _only_bf16(counts: dict, edge: int, virtual: int) -> bool:
    """The kernels ran ``edge`` / ``virtual`` calls, every one bf16."""
    want = {"edge": {"bf16": edge} if edge else {},
            "virtual": {"bf16": virtual} if virtual else {}}
    return counts == want


def phase_serve_bf16(pipe, scenes, serve32, dev) -> dict:
    """The serve phase's path with ``precision='bf16'`` (the same
    weights): four scenes, STEPS steps, device rebuilds; every frame
    finite, exact launch counts all in bf16, no steady-state fetch, the
    first frame against the f32 kernel path's (relative L2 of the frames,
    BF_MODEL_L2; that of the displacements is read), and the serve p50
    beside the f32 serve phase's."""
    import numpy as np

    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.rollout import BatchedRolloutEngine
    from repro_torch.serving import RolloutService, ServiceConfig

    t_phase = time.perf_counter()
    bpipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                           precision="bf16", params=pipe.params)
    cfg = ServiceConfig(max_batch=MAX_BATCH, window_s=1.0, queue_cap=16,
                        edge_cap_per_node=EDGES_PER_NODE)
    submit = dict(r=R, skin=SKIN, dt=DT, wrap_box=BOX)
    with RolloutService(bpipe, config=cfg) as warm:
        x, v, h = scenes[0]
        warm.submit(x, v, h, 2, **submit).result()
    edge_message.reset_launches()
    virtual_message.reset_launches()
    t0 = time.perf_counter()
    with RolloutService(bpipe, config=cfg) as svc:
        handles = [svc.submit(x, v, h, STEPS, **submit) for x, v, h in scenes]
        streams = [[f.copy() for f in hd.frames()] for hd in handles]
    wall = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches}
    prec = precision_counts()
    m = svc.metrics()
    (served,) = [svc._programs._lru.get(k) for k in svc._programs.keys()]
    tel = served._tel
    want = LAYERS * MAX_BATCH * (m["batches"] * STEPS + served._discarded)
    eng = BatchedRolloutEngine(
        pipe.predict_fn, batch_size=MAX_BATCH, node_cap=NODE_CAP,
        edge_cap=NODE_CAP * EDGES_PER_NODE, r=R, skin=SKIN, dt=DT,
        wrap_box=BOX, device=dev)
    ref = eng.run(pipe.params, scenes, 1).trajectories
    first = np.stack([s[0] for s in streams])
    f32 = np.stack([t[0] for t in ref])
    x0 = np.stack([sc[0] for sc in scenes])
    out = {"phase": "serve_bf16", "steps": STEPS, "batches": m["batches"],
           "launches": launches, "launches_expected": want,
           "precision_launches": prec,
           "rebuild_mode": served.rebuild_mode,
           "coord_d2h_bytes": tel.coord_d2h, "edge_h2d_bytes": tel.edge_h2d,
           "steady_state_d2h_bytes": tel.steady_d2h,
           "discarded_steps": served._discarded,
           "first_frame_rel_l2_vs_f32": _periodic_rel_l2(first, f32),
           "first_step_displacement_rel_l2_vs_f32": _periodic_rel_l2(
               first, f32, x0),
           "rel_l2_limit": BF_MODEL_L2,
           "latency_p50_s": m["latency_p50_s"],
           "latency_p99_s": m["latency_p99_s"],
           "f32_latency_p50_s": serve32["latency_p50_s"],
           "mean_step_s": m["compute_mean_s"] / STEPS,
           "f32_mean_step_s": serve32["mean_step_s"],
           "rebuilds": m["rebuilds"], "rebuild_mean_s": m["rebuild_mean_s"],
           "rebuild_share": m["rebuild_mean_s"] / m["compute_mean_s"],
           "cell_cap": served._cell_cap, "wall_s": wall,
           "seconds": time.perf_counter() - t_phase}
    finite = all(len(fr) == STEPS and all(np.isfinite(f).all() for f in fr)
                 for fr in streams)
    if not (finite and all(v == want for v in launches.values())
            and _only_bf16(prec, want, want)
            and served.rebuild_mode == "device" and not tel.coord_d2h
            and not tel.edge_h2d and not tel.steady_d2h
            and out["first_frame_rel_l2_vs_f32"] < BF_MODEL_L2):
        raise AssertionError(f"serve_bf16 failed: {json.dumps(out)}")
    return out


def _grads_rel_l2(pa, pb, batch, tca, tcb) -> dict:
    """Pipeline ``pa``'s first-step gradients (train config ``tca``)
    against ``pb``'s, from ``pa``'s weights, per leaf: the relative L2
    (BF_MODEL_L2) of every leaf whose ``pb`` gradient holds at least
    BF_SMALL_LEAF of the largest leaf's norm; the rest (cancelling sums
    at rounding level: the phi_Z stacks while z sits at the centre of
    mass, unused leaves) must lie within BF_SMALL_LEAF of that norm
    absolutely.  ``ok``: all of them."""
    import torch

    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import build_train_step

    grads = [tree_leaves(build_train_step(p.apply_full, p.cfg, tc,
                                          _GradsOut())[0](
        pa.params, None, batch)[0]) for p, tc in ((pa, tca), (pb, tcb))]
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))
    top = max(norm(b) for b in grads[1])
    l2, small = [], []
    for a, b in zip(*grads):
        if norm(b) >= BF_SMALL_LEAF * top:
            l2.append(norm(a - b) / norm(b))
        else:
            small.append(norm(a - b) / top)
    return {"rel_l2": l2, "rel_l2_max": max(l2), "small_leaves": len(small),
            "small_leaves_dev_max": max(small, default=0.0),
            "ok": max(l2) < BF_MODEL_L2
            and max(small, default=0.0) <= BF_SMALL_LEAF}


def bf16_first_step(bpipe, fpipe, batch, tcb, tcf, reps: int = 3) -> dict:
    """The first train step in bf16 against f32 (both with the kernels,
    the same weights): per-leaf gradient relative L2 (BF_MODEL_L2), the
    bf16 step bitwise repeatable, and ms a step each way, taken in
    turns."""
    import math

    import torch

    from repro_torch.training.optim import tree_leaves

    p0 = bpipe.params
    k1, _, mk = bpipe.train_step(p0, bpipe.opt.init(p0), batch)
    k2, _, _ = bpipe.train_step(p0, bpipe.opt.init(p0), batch)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(tree_leaves(k1), tree_leaves(k2)))
    gcmp = _grads_rel_l2(bpipe, fpipe, batch, tcb, tcf)
    times = {"bf16": [], "f32": []}
    for _ in range(reps):
        for name, pp in (("bf16", bpipe), ("f32", fpipe), ):
            t = time.perf_counter()
            pp.train_step(p0, pp.opt.init(p0), batch)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t)
    loss = float(mk["loss"])
    return {"loss": loss, "grads": gcmp, "bitwise_repeatable": bitwise,
            "step_ms_bf16": 1e3 * statistics.median(times["bf16"]),
            "step_ms_f32": 1e3 * statistics.median(times["f32"]),
            "ok": math.isfinite(loss) and gcmp["ok"] and bitwise}


def phase_train_bf16(dev, tr, va) -> dict:
    """The train phase's path with ``precision='bf16'`` and
    ``loss_scale=BF_LOSS_SCALE``: the first step against the f32 kernel
    path's (per-leaf gradient relative L2 < BF_MODEL_L2, bitwise repeat,
    ms a step both ways), then Pipeline.fit for EPOCHS epochs: finite
    losses, exact launch counts, every FastEGNN kernel call in bf16."""
    import math

    import torch

    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.trainer import TrainConfig

    t_phase = time.perf_counter()
    kw = dict(epochs=EPOCHS, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
              mmd_sample=None)
    tcb, tcf = TrainConfig(loss_scale=BF_LOSS_SCALE, **kw), TrainConfig(**kw)
    bpipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                           precision="bf16", train_cfg=tcb,
                           generator=torch.Generator().manual_seed(0))
    fpipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                           train_cfg=tcf, params=bpipe.params)
    first = bf16_first_step(bpipe, fpipe, tr[0], tcb, tcf)
    for mod in (edge_message, virtual_message, mmd_rbf):
        mod.reset_launches()
    t0 = time.perf_counter()
    res = bpipe.fit(tr, va)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches,
                "edge_pathway_bwd_fused": edge_message.bwd_launches,
                "virtual_pathway_bwd_fused": virtual_message.bwd_launches,
                "mmd_cross_sum": mmd_rbf.sum_launches,
                "mmd_cross_grads": mmd_rbf.grad_launches}
    steps = EPOCHS * len(tr)
    passes = LAYERS * (steps + EPOCHS * len(va)) * TRAIN_BATCH
    bwd = LAYERS * steps * TRAIN_BATCH
    want = {"edge_pathway_fused": passes, "virtual_pathway_fused": passes,
            "edge_pathway_bwd_fused": bwd, "virtual_pathway_bwd_fused": bwd,
            "mmd_cross_sum": steps, "mmd_cross_grads": steps}
    prec = precision_counts()
    losses = [h[k] for h in res.history for k in ("train_loss", "val_mse")]
    out = {"phase": "train_bf16", "loss_scale": BF_LOSS_SCALE,
           "history": res.history, "first_step": first, "fit_s": fit_s,
           "launches": launches, "launches_expected": want,
           "precision_launches": prec, "rel_l2_limit": BF_MODEL_L2,
           "seconds": time.perf_counter() - t_phase}
    if not (all(math.isfinite(v) for v in losses) and launches == want
            and _only_bf16(prec, passes + bwd, passes + bwd)
            and first["ok"]):
        raise AssertionError(f"train_bf16 failed: {json.dumps(out)}")
    return out


def phase_hidden32_bf16(dev, tr) -> dict:
    """The Table I model (hidden 32: the w32 route) H32_FIT_STEPS train
    steps in bf16 at BF_LOSS_SCALE: the first against the f32 kernel
    path's, as train_bf16, then the steps: finite losses, exact launch
    counts, all bf16."""
    import math

    import torch

    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.trainer import TrainConfig

    t_phase = time.perf_counter()
    kw = dict(lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA, mmd_sample=None)
    tcb, tcf = TrainConfig(loss_scale=BF_LOSS_SCALE, **kw), TrainConfig(**kw)
    bpipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                           precision="bf16", train_cfg=tcb,
                           generator=torch.Generator().manual_seed(0),
                           **TABLE1)
    fpipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                           train_cfg=tcf, params=bpipe.params, **TABLE1)
    first = bf16_first_step(bpipe, fpipe, tr[0], tcb, tcf)
    for mod in (edge_message, virtual_message, mmd_rbf):
        mod.reset_launches()
    p, st = bpipe.params, bpipe.opt.init(bpipe.params)
    losses = []
    for i in range(H32_FIT_STEPS):
        p, st, mt = bpipe.train_step(p, st, tr[i % len(tr)])
        losses.append(float(mt["loss"]))
    n = TABLE1["n_layers"] * H32_FIT_STEPS * TRAIN_BATCH
    launches = {"edge_pathway_fused": edge_message.launches,
                "edge_pathway_bwd_fused": edge_message.bwd_launches,
                "virtual_pathway_fused": virtual_message.launches,
                "virtual_pathway_bwd_fused": virtual_message.bwd_launches}
    prec = precision_counts()
    routes = {"edge": dict(edge_message.route_launches),
              "virtual": dict(virtual_message.route_launches)}
    out = {"phase": "hidden32_bf16", "model": TABLE1,
           "steps": H32_FIT_STEPS, "losses": losses, "first_step": first,
           "launches": launches, "precision_launches": prec,
           "routes": routes, "seconds": time.perf_counter() - t_phase}
    if not (all(math.isfinite(v) for v in losses) and first["ok"]
            and all(v == n for v in launches.values())
            and _only_bf16(prec, 2 * n, 2 * n)
            and routes == {"edge": {"w32": 2 * n},
                           "virtual": {"w32": 2 * n}}):
        raise AssertionError(f"hidden32_bf16 failed: {json.dumps(out)}")
    return out


def phase_zoo_bf16(scenes, tr, dev) -> dict:
    """Every registry model whose layers reach #1-#4 or the identity pair
    (ZOO_DISPATCH), with the kernels in bf16 and in f32 (the same weights):
    predict_fn on the serve batch, the bf16 prediction within relative L2
    BF_MODEL_L2 of the f32 one (the displacements' relative L2 is read),
    the kernel launches exact and all bf16; for RF and SchNet (the identity
    pair's backward) also one bf16 train step at BF_LOSS_SCALE: a finite
    loss and exact bf16 launches, its gradients' distance from the f32
    step's read (not gated: SchNet's coordinate head reads 0.21 on three
    leaves, the bf16 mode's own rounding of coordinates near 0.5, whose
    ulp is 1/6 of the particle spacing; the kernels agree with their bf16
    plain versions, widths_bf16)."""
    import math

    import torch

    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.trainer import TrainConfig

    kw = dict(lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA, mmd_sample=None)
    tcb, tcf = TrainConfig(loss_scale=BF_LOSS_SCALE, **kw), TrainConfig(**kw)

    t_phase = time.perf_counter()
    g, lay = serve_batch(scenes, dev)
    b = g.x.shape[0]
    models = {}
    ok = True
    for name in ZOO:
        d = ZOO_DISPATCH[name]
        if not ("edge_kernel" in d or "virtual_kernel" in d):
            continue
        fp = build_pipeline(name, device=dev, use_kernel=True,
                            generator=torch.Generator().manual_seed(0),
                            **zoo_kwargs(name))
        bp = build_pipeline(name, device=dev, use_kernel=True,
                            precision="bf16", params=fp.params,
                            **zoo_kwargs(name))
        with torch.no_grad():
            want = fp.predict_fn(fp.params, g, lay)
            edge_message.reset_launches()
            virtual_message.reset_launches()
            got = bp.predict_fn(bp.params, g, lay)
            torch.cuda.synchronize()
        launches = {k: v for k, v in zoo_launch_counts().items() if v}
        prec = precision_counts()
        n_e = LAYERS * b if "edge_kernel" in d else 0
        n_v = LAYERS * b if "virtual_kernel" in d else 0
        exp = {k: v for k, v in zoo_expected(name, LAYERS * b).items() if v}
        nm = g.node_mask[..., None]
        r = {"pred_rel_l2_vs_f32": rel_l2(got * nm, want * nm),
             "displacement_rel_l2_vs_f32": rel_l2((got - g.x) * nm,
                                                  (want - g.x) * nm),
             "finite": bool(torch.isfinite(got).all()),
             "launches": launches, "launches_expected": exp,
             "precision_launches": prec}
        r["ok"] = (r["finite"] and r["pred_rel_l2_vs_f32"] < BF_MODEL_L2
                   and launches == exp and _only_bf16(prec, n_e, n_v))
        if name in ("rf", "schnet"):
            bt = build_pipeline(name, device=dev, use_kernel=True,
                                precision="bf16", params=fp.params,
                                train_cfg=tcb, **zoo_kwargs(name))
            ft = build_pipeline(name, device=dev, use_kernel=True,
                                params=fp.params, train_cfg=tcf,
                                **zoo_kwargs(name))
            for mod in (edge_message, virtual_message, mmd_rbf):
                mod.reset_launches()
            _, _, mt = bt.train_step(bt.params, bt.opt.init(bt.params),
                                     tr[0])
            torch.cuda.synchronize()
            tl = {k: v for k, v in zoo_launch_counts().items() if v}
            tprec = precision_counts()
            gcmp = _grads_rel_l2(bt, ft, tr[0], tcb, tcf)
            ne = LAYERS * TRAIN_BATCH
            texp = {k: v for k, v in zoo_expected(name, ne, ne).items() if v}
            r["train_step"] = {"loss": float(mt["loss"]),
                               "grads": gcmp,
                               "launches": tl, "launches_expected": texp,
                               "precision_launches": tprec}
            r["ok"] &= (math.isfinite(float(mt["loss"])) and tl == texp
                        and _only_bf16(tprec, 2 * ne, 0))
            del bt, ft
        ok &= r["ok"]
        models[name] = r
        del fp, bp, want, got
        torch.cuda.empty_cache()
    out = {"phase": "zoo_bf16", "models": models,
           "rel_l2_limit": BF_MODEL_L2,
           "seconds": time.perf_counter() - t_phase}
    if not ok:
        raise AssertionError(f"zoo_bf16 failed: {json.dumps(out)}")
    return out


def width_subentries(widths: dict, keep=("max_abs_err", "ms", "device_ms",
                                          "bound_ms", "bound_3xtf32_ms"),
                     forms=("edge", "identity")) -> dict:
    """Per kernel row of the kernels line, its readings at each width
    (the identity rows: the ``forms[1]`` form)."""
    rows = {"edge_pathway_fused": ("edge_pair", "edge", "fwd"),
            "edge_pathway_bwd_fused": ("edge_pair", "edge", "bwd"),
            "virtual_pathway_fused": ("virtual_pair", None, "fwd"),
            "virtual_pathway_bwd_fused": ("virtual_pair", None, "bwd"),
            "edge_identity": ("edge_pair", forms[1], "fwd"),
            "edge_identity_bwd": ("edge_pair", forms[1], "bwd")}
    out = {}
    for row, (pair, form, d) in rows.items():
        sub = {}
        for key, case in widths["cases"].items():
            c = case.get(pair)
            part = c if c is None or form is None else c.get(form)
            if part is None:
                continue
            sub[key] = dict(route=c["route"],
                            **{k: part[d][k] for k in keep if k in part[d]})
        out[row] = sub
    return out


# ----------------------------------------------------------- hidden32 phase
def phase_hidden32(scenes, tr, va, dev) -> dict:
    """The reference's hidden-32 entry points on the card: the Table I
    model's fit (first step against the plain path, bitwise repeatable),
    the simulate model's rollouts through BatchedRolloutEngine against the
    plain path with no steady-state fetch, and FastEGNN's E(3)
    equivariance with the kernels at hidden 32 and 64."""
    import math

    import numpy as np
    import torch

    from repro_torch.core.equivariant import (apply_e3, apply_o3,
                                              random_orthogonal)
    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.rollout import BatchedRolloutEngine
    from repro_torch.training.trainer import TrainConfig

    t0 = time.perf_counter()
    tc = TrainConfig(epochs=1, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
                     mmd_sample=None)
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          train_cfg=tc,
                          generator=torch.Generator().manual_seed(0),
                          **TABLE1)
    plain = build_pipeline("fast_egnn", device=dev, train_cfg=tc,
                           params=pipe.params, **TABLE1)
    first, step_s = first_step(pipe, plain, tr[0], tc)
    edge_message.reset_launches()
    virtual_message.reset_launches()
    p, st = pipe.params, pipe.opt.init(pipe.params)
    losses = []
    for k in range(H32_FIT_STEPS):
        p, st, mt = pipe.train_step(p, st, tr[k % len(tr)])
        losses.append(float(mt["loss"]))
    fit = {"model": TABLE1, "lam_mmd": LAM_MMD, "first_step": first,
           "step_ms_kernel": 1e3 * step_s["kernel"],
           "step_ms_plain": 1e3 * step_s["plain"], "losses": losses,
           "launches": {
               "edge_pathway_bwd_fused": edge_message.bwd_launches,
               "virtual_pathway_bwd_fused": virtual_message.bwd_launches},
           "routes": {"edge": dict(edge_message.route_launches),
                      "virtual": dict(virtual_message.route_launches)}}
    del pipe, plain

    # the simulate model: the serve scenes, 20 steps, both paths; every
    # step of the kernel rollout also runs the plain path on the same
    # graph (its one-step error, gated), and the plain path rolls out on
    # its own (the free-running gap, read)
    sim = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                         generator=torch.Generator().manual_seed(0),
                         **SIMULATE)
    sim_plain = build_pipeline("fast_egnn", device=dev, params=sim.params,
                               **SIMULATE)
    step_errs = []

    def paired(params, g, lay):
        xk = sim.predict_fn(params, g, lay)
        xp = sim_plain.predict_fn(params, g, lay)
        step_errs.append(float((xk - xp)[g.node_mask > 0].abs().max()))
        return xk

    runs = {}
    for name, fn in (("kernel", paired), ("plain", sim_plain.predict_fn)):
        eng = BatchedRolloutEngine(
            fn, batch_size=MAX_BATCH, node_cap=NODE_CAP,
            edge_cap=NODE_CAP * EDGES_PER_NODE, r=R, skin=SKIN, dt=H32_DT,
            wrap_box=BOX, device=dev)
        edge_message.reset_launches()
        virtual_message.reset_launches()
        t1 = time.perf_counter()
        res = eng.run(sim.params, scenes, STEPS)
        runs[name] = (res, time.perf_counter() - t1,
                      dict(edge_message.route_launches),
                      dict(virtual_message.route_launches),
                      {"edge_pathway_fused": edge_message.launches,
                       "virtual_pathway_fused": virtual_message.launches})
    res_k, res_p = runs["kernel"][0], runs["plain"][0]
    # periodic distance of every frame, the largest over scenes per step
    per_step = np.max([np.max(np.minimum(np.abs(a - b), BOX - np.abs(a - b)),
                              axis=(1, 2))
                       for a, b in zip(res_k.trajectories,
                                       res_p.trajectories)], axis=0)
    rollout = {"model": SIMULATE, "scenes": len(scenes), "steps": STEPS,
               "dt": H32_DT, "frame_tol": FRAME_TOL,
               "max_step_err": max(step_errs), "model_calls": len(step_errs),
               "free_running_err_by_step": [float(v) for v in per_step],
               "steady_state_d2h_bytes": res_k.steady_state_d2h_bytes,
               "d2h_bytes": res_k.d2h_bytes,
               "rebuilds": res_k.rebuild_count,
               "chunk_calls": res_k.chunk_calls,
               "discarded_steps": res_k.discarded_steps,
               "s_kernel": runs["kernel"][1], "s_plain": runs["plain"][1],
               "launches": runs["kernel"][4],
               "routes": {"edge": runs["kernel"][2],
                          "virtual": runs["kernel"][3]}}
    del sim, sim_plain, runs

    # E(3): rotate and translate the serve batch's first scene
    equiv = {}
    batch = serve_batch(scenes[:1], dev)
    gen = torch.Generator().manual_seed(5)
    rot = random_orthogonal(gen, device="cpu").to(dev)
    shift = (3.0 * torch.randn((3,), generator=gen)).to(dev)
    for hid in (32, 64):
        pp = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                            generator=torch.Generator().manual_seed(1),
                            n_layers=LAYERS, hidden=hid, n_virtual=3,
                            s_dim=hid)
        g, lay = batch
        with torch.no_grad():
            x1 = pp.predict_fn(pp.params, g, lay)
            gt = g._replace(x=apply_e3(g.x, rot, shift),
                            v=apply_o3(g.v, rot))
            x2 = pp.predict_fn(pp.params, gt, lay)
        real = g.node_mask > 0
        err = float((x2 - apply_e3(x1, rot, shift))[real].abs().max())
        scale = float(x1[real].abs().max())
        equiv[str(hid)] = {"max_abs_err": err, "scale": scale,
                           "within_tol": err <= EQUIV_TOL * (1.0 + scale)}
        del pp
    out = {"phase": "hidden32", "fit": fit, "rollout": rollout,
           "equivariance": {"tol": EQUIV_TOL, "hidden": equiv},
           "seconds": time.perf_counter() - t0}
    ok = (first["ok"] and first["bitwise_repeatable"]
          and all(math.isfinite(v) for v in losses)
          and fit["routes"]["edge"].keys() == {"w32"}
          and fit["routes"]["virtual"].keys() == {"w32"}
          and max(step_errs) <= FRAME_TOL and per_step[0] <= FRAME_TOL
          and res_k.steady_state_d2h_bytes == 0
          and rollout["routes"]["edge"].keys() == {"w32"}
          and all(e["within_tol"] for e in equiv.values()))
    if not ok:
        raise AssertionError(f"hidden32 phase failed: {json.dumps(out)}")
    return out


# -------------------------------------------------------------- dist phase
def _scene_sample(x0):
    """The 113K scene as a raw sample (zero velocity, feature 1, its own
    coordinates as the target), for ``Pipeline.make_batches``."""
    import numpy as np

    from repro_torch.data.fluid import FluidSample

    return FluidSample(x0, np.zeros_like(x0),
                       np.ones((x0.shape[0], 1), np.float32), x0)


def _forward_reading(fn) -> dict:
    """CUDA-event ms (median of 5 after a warm call), and the peak device
    memory of one call above what was allocated before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"ms": cuda_ms(fn, reps=5, warm=1), "peak_bytes": peak - base,
            "peak_total_bytes": peak}


def _param_digest(tree) -> str:
    import hashlib

    from repro_torch.training.optim import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _leaves_equal(a, b) -> bool:
    import torch

    from repro_torch.training.optim import tree_leaves

    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                   tree_leaves(b)))


def _collective_us(mesh) -> dict:
    """Host µs of one blocking rank-order sum over the axis (median of
    20, synchronised), at the CoM's size (3 + 1 floats) and the aggregate's
    (C x (3 + hidden) + 1)."""
    import torch

    from repro_torch.core.collectives import sum_across

    out = {}
    for n in (4, MMD_CHANNELS * (3 + 64) + 1):
        t = torch.ones(n, device=mesh.device)
        times = []
        for _ in range(25):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sum_across(t, mesh)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        out[str(n)] = 1e6 * statistics.median(times[5:])
    return out


def dist_rank(rank: int, port: int, out: str) -> None:
    """One DistEGNN rank of the dist phase (a process of its own, all
    ranks on cuda:0 over gloo): its readings go to ``out`` as JSON."""
    import warnings

    import torch

    from repro_torch.distributed.dist_egnn import (build_dist_apply,
                                                   build_dist_loss,
                                                   dist_value_and_grad,
                                                   make_gnn_mesh)
    from repro_torch.launch.mesh import init_distributed
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.trainer import TrainConfig

    backend = init_distributed(f"localhost:{port}", DIST_RANKS, rank)
    mesh = make_gnn_mesh(DIST_RANKS)
    res = {"rank": rank, "backend": backend, "device": str(mesh.device)}
    # (a) the 113K scene in DIST_RANKS random shards, FastEGNN defaults
    t0 = time.perf_counter()
    pipe = build_pipeline("fast_egnn", mesh=mesh, use_kernel=True,
                          generator=torch.Generator().manual_seed(0))
    ser = build_pipeline("fast_egnn", mesh=mesh, use_kernel=True,
                         overlap_sync=False, params=pipe.params)
    plain = build_pipeline("fast_egnn", mesh=mesh, params=pipe.params)
    [sb] = pipe.make_batches([_scene_sample(_scale_scene())], 1, r=R)
    torch.cuda.synchronize()
    res["shard_build_s"] = time.perf_counter() - t0
    res["shard"] = {"node_cap": sb.x.shape[1],
                    "nodes": int(sb.node_mask.sum()),
                    "edge_cap": sb.senders.shape[1],
                    "edges": int(sb.layout[1][0])}
    p = pipe.params
    reset_all_launches()
    x_ov = pipe.predict(p, sb)
    torch.cuda.synchronize()
    res["forward_launches"] = all_launch_counts()
    x_ser = ser.predict(p, sb)
    x_plain = plain.predict(p, sb)
    with torch.no_grad():
        _, vs = build_dist_apply(pipe.cfg, mesh)(p, sb)
    res["forward"] = {
        "schedules_bitwise": bool(torch.equal(x_ov, x_ser)),
        "finite": bool(torch.isfinite(x_ov).all()),
        "vs_plain": compare([x_ov], [x_plain]),
        "z": vs.z.cpu().double().tolist(), "s_digest": _param_digest(vs.s),
        "overlapped": _forward_reading(lambda: pipe.predict(p, sb)),
        "serialized": _forward_reading(lambda: ser.predict(p, sb))}
    del x_plain, plain
    res["collective_us"] = _collective_us(mesh)
    # (b) one train step on the train phase's scenes in DIST_RANKS shards
    from repro_torch.data.fluid import generate_fluid_dataset

    data = generate_fluid_dataset(TRAIN_SCENES + VAL_SCENES,
                                  n_particles=N_PARTICLES)
    tc = TrainConfig(lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA, mmd_sample=None)
    tpipe = build_pipeline("fast_egnn", mesh=mesh, use_kernel=True,
                           train_cfg=tc,
                           generator=torch.Generator().manual_seed(0))
    tser = build_pipeline("fast_egnn", mesh=mesh, use_kernel=True,
                          overlap_sync=False, train_cfg=tc,
                          params=tpipe.params)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        batches = tpipe.make_batches(data[:TRAIN_SCENES], TRAIN_BATCH, r=R)
    batch, p0 = batches[0], tpipe.params
    reset_all_launches()
    p1, _, m1 = tpipe.train_step(p0, tpipe.opt.init(p0), batch)
    torch.cuda.synchronize()
    launches = all_launch_counts()
    p1s, _, m1s = tser.train_step(p0, tser.opt.init(p0), batch)
    grads = {}
    for name, cfg in (("kernel", tpipe.cfg),
                      ("plain", tpipe.cfg._replace(use_kernel=False))):
        grads[name] = dist_value_and_grad(
            build_dist_loss(cfg, mesh, LAM_MMD, MMD_SIGMA), p0, batch, mesh)
    from repro_torch.training.optim import tree_leaves

    res["train"] = {
        "batches": len(batches), "scenes": TRAIN_BATCH,
        "dropped_warning": [str(w.message) for w in rec
                            if "dropping" in str(w.message)],
        "loss": float(m1["loss"]), "loss_serialized": float(m1s["loss"]),
        "schedules_bitwise": bool(m1["loss"] == m1s["loss"]
                                  and _leaves_equal(p1, p1s)),
        "params_digest": _param_digest(p1), "launches": launches,
        "loss_plain": float(grads["plain"][0]),
        "grads_vs_plain": compare_grads(tree_leaves(grads["kernel"][1]),
                                        tree_leaves(grads["plain"][1])),
        "step_ms": cuda_ms(lambda: tpipe.train_step(
            p0, tpipe.opt.init(p0), batch), reps=3, warm=1)}
    del tpipe, tser, batches, batch, grads, p1, p1s
    torch.cuda.empty_cache()
    res["rollout"] = dist_rollout_reading(pipe, mesh)
    with open(out, "w") as fh:
        json.dump(res, fh)


def _traj_digest(traj) -> str:
    import hashlib

    return hashlib.sha256(traj.tobytes()).hexdigest()


def dist_rollout_reading(pipe, mesh) -> dict:
    """(d) ``Pipeline.rollout`` on the mesh: the 113K scene, DIST_ROLLOUT_
    STEPS steps at R / SKIN / DT in [0, BOX), device rebuilds, then the
    same with synchronous host rebuilds and through a ``use_kernel=False``
    mesh pipeline; this rank's readings."""
    import numpy as np
    import torch

    from repro_torch.pipeline import build_pipeline

    x0 = _scale_scene()
    state = (x0, np.zeros_like(x0), np.ones((x0.shape[0], 1), np.float32))
    kw = dict(r=R, skin=SKIN, dt=DT, wrap_box=BOX, rebuild_mode="device")
    p, n = pipe.params, DIST_ROLLOUT_STEPS

    def timed(steps: int):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.rollout(p, state, steps, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the first run sizes and pins the engine's capacities (host radius
    # graph of the shard, every shard's densest cell); a step's ms is the
    # difference of an n-step and a 1-step run on the pinned engine
    _, setup_s = timed(1)
    _, one_s = timed(1)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_all_launches()
    dev_res, wall = timed(n)
    launches = all_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    eng = pipe._rollout_engines.get(pipe._rollout_engines.keys()[-1])
    t0 = time.perf_counter()
    host_kw = dict(kw, rebuild_mode="host", async_rebuild=False)
    host_res = pipe.rollout(p, state, n, **host_kw)
    host_wall = time.perf_counter() - t0
    plain = build_pipeline("fast_egnn", mesh=mesh, params=p)
    t0 = time.perf_counter()
    plain_res = plain.rollout(p, state, n, **kw)
    plain_wall = time.perf_counter() - t0
    d = np.abs(dev_res.trajectory.astype(np.float64)
               - plain_res.trajectory)
    per_step = np.max(np.minimum(d, BOX - d), axis=(1, 2))
    computed = n + dev_res.discarded_steps
    rebuilds = dev_res.rebuild_count
    return {
        "steps": n, "steps_computed": computed, "nodes": int(x0.shape[0]),
        "shard": {"node_cap": eng.node_cap, "edge_cap": eng.edge_cap,
                  "nodes": int(eng._n_real)},
        "traj_digest": _traj_digest(dev_res.trajectory),
        "finite": bool(np.isfinite(dev_res.trajectory).all()),
        "device_equals_host": bool(np.array_equal(
            dev_res.trajectory, host_res.trajectory, equal_nan=True)),
        "rebuild_steps": dev_res.rebuild_steps,
        "host_rebuild_steps": host_res.rebuild_steps,
        "rebuilds": rebuilds, "rebuild_ms": 1e3 * dev_res.rebuild_s,
        "rebuild_ms_mean": 1e3 * dev_res.rebuild_s / max(rebuilds, 1),
        "rebuild_share": dev_res.rebuild_s / (wall - one_s),
        "cell_cap": eng._cell_cap, "cell_overflows": dev_res.cell_overflows,
        "d2h_bytes": dev_res.d2h_bytes,
        "coord_d2h_bytes": dev_res.coord_d2h_bytes,
        "edge_h2d_bytes": dev_res.edge_h2d_bytes,
        "steady_state_d2h_bytes": dev_res.steady_state_d2h_bytes,
        "chunk_calls": dev_res.chunk_calls,
        "first_run_s": setup_s, "one_step_run_s": one_s, "run_s": wall,
        "ms_per_step": 1e3 * (wall - one_s) / (computed - 1),
        # these two runs include their first list's build (host mode: the
        # shard's numpy radius graph; plain: a new engine's sizing pass)
        "host_mode_run_s": host_wall,
        "host_mode_rebuild_ms_mean": 1e3 * host_res.rebuild_s
        / max(host_res.rebuild_count, 1),
        "plain_run_s": plain_wall,
        "peak_bytes": peak - base, "peak_total_bytes": peak,
        "launches": launches,
        "vs_plain": {"first_frame_max_err": float(per_step[0]),
                     "per_step_max_err": per_step.tolist(),
                     "within_tol": bool(per_step[0] <= FRAME_TOL),
                     "plain_rebuild_steps": plain_res.rebuild_steps}}


def rollout_launches(reading: dict) -> dict:
    """The kernel launches a rank's rollout must count: #1 and #3 once a
    layer for every step computed (kept or dropped past a failed skin
    check), nothing else."""
    want = {k: 0 for k in all_launch_counts()}
    want.update(edge_pathway_fused=LAYERS * reading["steps_computed"],
                virtual_pathway_fused=LAYERS * reading["steps_computed"])
    return want


def phase_dist(dev, scale: dict) -> dict:
    """DistEGNN on the card: a one-rank mesh against the single-device
    pipeline on the 113K scene, its forward and its rollout; then
    DIST_RANKS ranks (processes of their own) sharing cuda:0 over gloo
    (see the module docstring)."""
    import math
    import os
    import tempfile

    import torch

    from repro_torch.distributed.dist_egnn import make_gnn_mesh
    from repro_torch.launch.mesh import free_port
    from repro_torch.pipeline import build_pipeline

    # (c) a one-rank mesh (no process group) against the single-device
    # pipeline on the 113K scene, both through the kernels
    sample = _scene_sample(_scale_scene())
    single = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                            generator=torch.Generator().manual_seed(0))
    mesh1 = build_pipeline("fast_egnn", mesh=make_gnn_mesh(1),
                           use_kernel=True, params=single.params)
    [gb] = single.make_batches([sample], 1, r=R)
    [sb] = mesh1.make_batches([sample], 1, r=R)
    want = single.predict(single.params, gb)
    got = mesh1.predict(single.params, sb)
    one_rank = {"bitwise": bool(torch.equal(got, want)),
                "single": _forward_reading(
                    lambda: single.predict(single.params, gb)),
                "mesh1": _forward_reading(
                    lambda: mesh1.predict(single.params, sb))}
    del gb, sb, want, got
    torch.cuda.empty_cache()
    # (e) the one-rank mesh's Pipeline.rollout (DistRolloutEngine) against
    # the single-device one on the same scene, device rebuilds
    import numpy as np

    state = (sample.x0, sample.v0, sample.h)
    kw = dict(r=R, skin=SKIN, dt=DT, wrap_box=BOX)
    t0 = time.perf_counter()
    ws = single.rollout(single.params, state, ONE_RANK_ROLLOUT_STEPS, **kw)
    single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gs = mesh1.rollout(single.params, state, ONE_RANK_ROLLOUT_STEPS, **kw)
    mesh1_s = time.perf_counter() - t0
    one_rank["rollout"] = {
        "steps": ONE_RANK_ROLLOUT_STEPS,
        "bitwise": bool(np.array_equal(gs.trajectory, ws.trajectory,
                                       equal_nan=True)
                        and gs.rebuild_steps == ws.rebuild_steps),
        "finite": bool(np.isfinite(gs.trajectory).all()),
        "rebuild_steps": gs.rebuild_steps, "rebuild_mode": gs.rebuild_mode,
        "single_s": single_s, "mesh1_s": mesh1_s}
    del single, mesh1, ws, gs
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="dist_smoke_")
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-rank",
         str(r), str(port), os.path.join(tmp, f"rank{r}.json")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(DIST_RANKS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"dist rank {r} exited {p.returncode}:\n"
                                 f"{so[-2000:]}\n{se[-4000:]}")
    ranks = []
    for r in range(DIST_RANKS):
        with open(os.path.join(tmp, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    backend_lines = [ln for so, _ in outs for ln in so.splitlines()
                     if "torch.distributed backend" in ln]
    L, B = LAYERS, TRAIN_BATCH
    want_fwd = {k: 0 for k in all_launch_counts()}
    want_fwd.update(edge_pathway_fused=L, virtual_pathway_fused=L)
    want_step = dict(want_fwd, edge_pathway_fused=L * B,
                     virtual_pathway_fused=L * B,
                     edge_pathway_bwd_fused=L * B,
                     virtual_pathway_bwd_fused=L * B, mmd_cross_sum=1,
                     mmd_cross_grads=1)
    checks = {
        "backend_gloo_cuda0": all(r["backend"] == "gloo"
                                  and r["device"] == "cuda:0"
                                  for r in ranks),
        "forward_schedules_bitwise": all(r["forward"]["schedules_bitwise"]
                                         for r in ranks),
        "forward_finite": all(r["forward"]["finite"] for r in ranks),
        "forward_kernel_vs_plain": all(
            r["forward"]["vs_plain"]["within_tol"] for r in ranks),
        "virtual_state_equal_across_ranks": all(
            r["forward"]["z"] == ranks[0]["forward"]["z"]
            and r["forward"]["s_digest"] == ranks[0]["forward"]["s_digest"]
            for r in ranks),
        "forward_launches": all(r["forward_launches"] == want_fwd
                                for r in ranks),
        "train_loss_finite": all(math.isfinite(r["train"]["loss"])
                                 for r in ranks),
        "train_loss_equal_across_ranks": all(
            r["train"]["loss"] == ranks[0]["train"]["loss"] for r in ranks),
        "train_params_equal_across_ranks": all(
            r["train"]["params_digest"] == ranks[0]["train"]["params_digest"]
            for r in ranks),
        "train_schedules_bitwise": all(r["train"]["schedules_bitwise"]
                                       for r in ranks),
        "train_grads_kernel_vs_plain": all(
            r["train"]["grads_vs_plain"]["within_tol"] for r in ranks),
        "train_launches": all(r["train"]["launches"] == want_step
                              for r in ranks),
        "train_dropped_warning": all(len(r["train"]["dropped_warning"]) == 1
                                     for r in ranks),
        "one_rank_mesh_bitwise": one_rank["bitwise"],
        "one_rank_rollout_bitwise": one_rank["rollout"]["bitwise"],
        "one_rank_rollout_finite": one_rank["rollout"]["finite"],
        "rollout_finite": all(r["rollout"]["finite"] for r in ranks),
        "rollout_equal_across_ranks": all(
            r["rollout"]["traj_digest"] == ranks[0]["rollout"]["traj_digest"]
            for r in ranks),
        "rollout_device_equals_host": all(
            r["rollout"]["device_equals_host"] for r in ranks),
        "rollout_kernel_vs_plain": all(
            r["rollout"]["vs_plain"]["within_tol"] for r in ranks),
        "rollout_device_rebuilds_move_nothing": all(
            r["rollout"]["coord_d2h_bytes"] == 0
            and r["rollout"]["edge_h2d_bytes"] == 0
            and r["rollout"]["steady_state_d2h_bytes"] == 0
            for r in ranks),
        "rollout_launches": all(
            r["rollout"]["launches"] == rollout_launches(r["rollout"])
            for r in ranks)}
    for r in ranks:
        r["forward"].pop("z")
    res = {"phase": "dist", "ranks": DIST_RANKS, "wall_s": wall,
           "backend_lines": backend_lines, "per_rank": ranks,
           "one_rank_mesh": one_rank,
           "single_device_113k_step_ms_median": scale["step_ms_median"],
           "launches_expected": {"forward": want_fwd, "train_step":
                                 want_step},
           "checks": checks, "gpu": gpu_line()}
    if not all(checks.values()):
        raise AssertionError(f"dist phase failed: {json.dumps(res)}")
    return res


def f64_reading(pipe, plain, batch, tc) -> dict:
    """How far the first step's f32 gradients, kernel and plain path, lie
    from the plain path's in f64 on the same inputs: the step's own f32
    conditioning, for reading the kernel-vs-plain comparison (largest
    error over the leaves, relative to the leaf's largest f64 entry)."""
    import torch

    from repro_torch.training.optim import tree_leaves, tree_map
    from repro_torch.training.trainer import build_train_step

    def grads(pp, params, b):
        step = build_train_step(pp.apply_full, pp.cfg, tc, _GradsOut())[0]
        return tree_leaves(step(params, None, b)[0])

    wide = lambda t: t.double() if t.is_floating_point() else t
    b64 = batch._replace(
        graph=type(batch.graph)(*(wide(t) for t in batch.graph)),
        x_target=wide(batch.x_target),
        sample_mask=None if batch.sample_mask is None
        else wide(batch.sample_mask))
    want = grads(plain, tree_map(wide, pipe.params), b64)

    def err(got):
        return max(float((g.double() - w).abs().max())
                   / (float(w.abs().max()) + 1e-6)
                   for g, w in zip(got, want) if w.numel())

    out = {"kernel_max_rel_err": err(grads(pipe, pipe.params, batch)),
           "plain_max_rel_err": err(grads(plain, pipe.params, batch))}
    torch.cuda.synchronize()
    return out


def phase_data(dev) -> dict:
    """A streamed fit on nbody and on protein through the data plane: the
    launcher's datasets (``launch.train.dataset``), ``Pipeline.
    make_batches`` streams (worker threads, prefetch on, a layout cache)
    and ``Pipeline.fit``, FastEGNN defaults with the kernels."""
    import math
    import tempfile

    import torch

    from repro_torch.data import layout_cache
    from repro_torch.launch.train import dataset
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.optim import tree_map
    from repro_torch.training.trainer import TrainConfig

    out, ok = {"phase": "data", "weight_scale": DATA_WEIGHT_SCALE}, True
    for name in ("nbody", "protein"):
        t0 = time.perf_counter()
        data, r, h_in = dataset(name, DATA_SAMPLES, DATA_NODES[name])
        gen_s = time.perf_counter() - t0
        n_tr = DATA_SAMPLES - DATA_VAL
        tc = TrainConfig(epochs=1, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
                         mmd_sample=None)
        pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                              h_in=h_in, train_cfg=tc,
                              generator=torch.Generator().manual_seed(0))
        pipe.params = tree_map(lambda t: t * DATA_WEIGHT_SCALE, pipe.params)
        plain = build_pipeline("fast_egnn", device=dev, h_in=h_in,
                               train_cfg=tc, params=pipe.params)
        cache = tempfile.mkdtemp(prefix=f"layout_cache_{name}_")
        kw = dict(r=r, prefetch=2, num_workers=4, cache_dir=cache)
        layout_cache.reset_cache_stats()
        tr = pipe.make_batches(data[:n_tr], TRAIN_BATCH, **kw)
        va = pipe.make_batches(data[n_tr:], TRAIN_BATCH, **kw)
        first, step_s = first_step(pipe, plain, tr[0], tc)
        first["f64"] = f64_reading(pipe, plain, tr[0], tc)
        reset_all_launches()
        t0 = time.perf_counter()
        res = pipe.fit(tr, va)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = all_launch_counts()
        cold = layout_cache.cache_stats()
        layout_cache.reset_cache_stats()
        for d in (data[:n_tr], data[n_tr:]):
            pipe.make_batches(d, TRAIN_BATCH, **kw).materialize()
        warm = layout_cache.cache_stats()
        train_passes = len(tr) * TRAIN_BATCH  # padded slots included
        eval_passes = len(va) * TRAIN_BATCH
        want = {k: 0 for k in launches}
        want.update(
            edge_pathway_fused=LAYERS * (train_passes + eval_passes),
            virtual_pathway_fused=LAYERS * (train_passes + eval_passes),
            edge_pathway_bwd_fused=LAYERS * train_passes,
            virtual_pathway_bwd_fused=LAYERS * train_passes,
            mmd_cross_sum=len(tr), mmd_cross_grads=len(tr))
        losses = [h[k] for h in res.history
                  for k in ("train_loss", "val_mse")]
        checks = {
            "losses_finite": all(math.isfinite(v) for v in losses + [
                first["loss_kernel"], first["loss_plain"]]),
            "launches": launches == want,
            "first_step_vs_plain": first["ok"],
            "first_step_bitwise": first["bitwise_repeatable"],
            "warm_cache_builds_nothing": warm["builds"] == 0
            and warm["hits"] > 0}
        out[name] = {
            "samples": {"train": n_tr, "val": DATA_VAL},
            "nodes": DATA_NODES[name], "r": r, "h_in": h_in,
            "batch": TRAIN_BATCH, "batches": [len(tr), len(va)],
            "edges": [int(b.layout[1].max()) for b in tr],
            "generate_s": gen_s, "history": res.history,
            "first_step": first, "step_ms_kernel": 1e3 * step_s["kernel"],
            "step_ms_plain": 1e3 * step_s["plain"],
            "fit_s": fit_s, "fit_ms_per_step": 1e3 * fit_s / len(tr),
            "launches": launches, "launches_expected": want,
            "layout_cache": {"cold": cold, "warm": warm},
            "checks": checks}
        ok &= all(checks.values())
        del pipe, plain, tr, va
        torch.cuda.empty_cache()
    out["gpu"] = gpu_line()
    if not ok:
        raise AssertionError(f"data phase failed: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- LM slice
def _attention_close(got, want) -> dict:
    """Kernel against plain attention: f32 at ATOL / RTOL, bf16 within one
    bf16 rounding (BF16_ATOL / BF16_RTOL), both compared in f32."""
    import torch

    g, w = got.float(), want.float()
    d = (g - w).abs()
    atol, rtol = ((BF16_ATOL, BF16_RTOL) if want.dtype == torch.bfloat16
                  else (ATOL, RTOL))
    return {"max_abs_err": float(d.max()),
            "max_rel_err": float(d.max() / w.abs().max().clamp(min=1e-30)),
            "within_tol": bool(torch.all(d <= atol + rtol * w.abs()))}


def visible_pairs(s: int, causal: bool, window) -> int:
    """(q, k) pairs the mask keeps in one head of length ``s``."""
    total = 0
    for q in range(s):
        lo = 0 if window is None else max(0, q - window + 1)
        hi = q if causal else s - 1
        total += hi - lo + 1
    return total


def swa_rows(cfg, dev) -> tuple[dict, list]:
    """Both SWA kernels at the prefill's shapes, the sliding-window layer
    (window ``cfg.window``) and the global (causal) layer: the bf16
    kernel (``wgmma``) on bf16 inputs and the f32 kernel (3xTF32
    ``mma.sync``) on the same values in f32, each against the plain
    version in its dtype, with a bitwise repeat, timed beside the plain
    version and SDPA, and its device kernels a call read with
    ``torch.profiler``; then a planted fault, each kernel with the window
    one too wide, against the plain version at the true window."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention

    b, s, h, kv, d = 1, PREFILL_S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
               for n in (h, kv, kv))
    pos = torch.arange(s, device=dev)
    qi = pos[:, None]
    layers = {}
    with torch.no_grad():
        for name, window in (("swa", cfg.window), ("global", None)):
            out = {"window": window}
            for dt in (torch.bfloat16, torch.float32):
                tag = "bf16" if dt == torch.bfloat16 else "f32"
                args = (q.to(dt), k.to(dt), v.to(dt))
                run = lambda w=window: swa_attention.attention(
                    *args, causal=True, window=w)
                plain = lambda: swa_attention.chunked_attention(
                    *args, pos, pos, causal=True, window=window,
                    q_chunk=cfg.q_chunk)
                got, again, want = run(), run(), plain()
                cmp = _attention_close(got, want)
                cmp["bitwise_repeatable"] = torch.equal(got, again)
                if window is not None:
                    cmp["fault_window_plus_1"] = _attention_close(
                        run(window + 1), want)
                out[tag] = cmp
                del got, again, want
                out[f"ms_{tag}"] = cuda_ms(run, 10, 2)
                dev_f = device_fields(run)
                for key in ("kernels_per_call", "device_ms"):
                    out[f"{key}_{tag}"] = dev_f[key]
                out[f"plain_ms_{tag}"] = cuda_ms(plain, 5, 1)
                sq, sk, sv = (a.transpose(1, 2) for a in args)
                if window is None:
                    lib = lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, is_causal=True, enable_gqa=True)
                else:
                    band = (pos[None, :] <= qi) & (pos[None, :]
                                                   > qi - window)
                    lib = lambda: F.scaled_dot_product_attention(
                        sq, sk, sv, attn_mask=band, enable_gqa=True)
                out[f"library_ms_{tag}"] = cuda_ms(lib, 10, 2)
            pairs = visible_pairs(s, True, window)
            flops = 4 * d * pairs * h * b
            n_bytes = b * s * (2 * h + 2 * kv) * d  # q, k, v, o: elements
            out["pairs_per_head"] = pairs
            out["gflop"] = flops / 1e9
            # bf16 at the tensor-core rate, f32 at the f32 (non-tensor) rate
            out["bound_ms_bf16"], out["bound_by_bf16"] = bound_ms(
                2 * n_bytes, flops, BF16_FLOPS)
            out["bound_ms_f32"], out["bound_by_f32"] = bound_ms(4 * n_bytes,
                                                                flops)
            # the f32 kernel's products run as 3xTF32 on the tensor cores
            out["bound_3xtf32_ms_f32"], out["bound_3xtf32_by_f32"] = bound_ms(
                4 * n_bytes, 3 * flops, TF32_FLOPS)
            out["speedup_bf16_over_f32"] = out["ms_f32"] / out["ms_bf16"]
            layers[name] = out
    line = {"phase": "swa_kernel",
            "shape": dict(b=b, s=s, h=h, kv=kv, d=d),
            "tolerance": {"f32": {"atol": ATOL, "rtol": RTOL},
                          "bf16": {"atol": BF16_ATOL, "rtol": BF16_RTOL}},
            **layers}
    for name in layers:
        for tag in ("bf16", "f32"):
            c = layers[name][tag]
            if not (c["within_tol"] and c["bitwise_repeatable"]):
                raise AssertionError(f"SWA kernel ({name}, {tag}) disagrees "
                                     f"with its plain version: "
                                     f"{json.dumps(line)}")
    for tag in ("bf16", "f32"):
        if layers["swa"][tag]["fault_window_plus_1"]["within_tol"]:
            raise AssertionError(f"the planted fault (window + 1) lands "
                                 f"inside the {tag} tolerance: "
                                 f"{json.dumps(line)}")
    rows = []
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "device_ms", "kernels_per_call", "bound_3xtf32_ms")
    for tag, name, src in (("bf16", "swa_attention", "swa_attention_wgmma"),
                           ("f32", "swa_attention_f32", "swa_attention")):
        per = lambda lay: {k: lay[f"{k}_{tag}"] for k in keys
                           if f"{k}_{tag}" in lay}
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}.cu",
            replaces="src/repro/kernels/swa_attention.py:70",
            max_abs_err=layers["swa"][tag]["max_abs_err"],
            **per(layers["swa"]),
            global_layer={"max_abs_err": layers["global"][tag]["max_abs_err"],
                          **per(layers["global"])}))
    return line, rows


def all_launch_counts() -> dict:
    from repro_torch.kernels import (edge_message, mmd_rbf, swa_attention,
                                     virtual_message)

    return {"edge_pathway_fused": edge_message.launches,
            "virtual_pathway_fused": virtual_message.launches,
            "edge_pathway_bwd_fused": edge_message.bwd_launches,
            "virtual_pathway_bwd_fused": virtual_message.bwd_launches,
            "edge_identity": edge_message.identity_launches,
            "edge_identity_bwd": edge_message.identity_bwd_launches,
            "mmd_cross_sum": mmd_rbf.sum_launches,
            "mmd_cross_grads": mmd_rbf.grad_launches,
            "swa_attention": swa_attention.wgmma_launches,
            "swa_attention_f32": (swa_attention.launches
                                  - swa_attention.wgmma_launches)}


def reset_all_launches() -> None:
    from repro_torch.kernels import (edge_message, mmd_rbf, swa_attention,
                                     virtual_message)

    for mod in (edge_message, virtual_message, mmd_rbf, swa_attention):
        mod.reset_launches()


def _expect_launches(phase: str, counts: dict, bf16: int = 0,
                     f32: int = 0) -> None:
    """Only the SWA kernels launch in the LM phases: ``bf16`` times the
    tensor-core kernel, ``f32`` times the f32 one."""
    want = {k: 0 for k in counts}
    want.update(swa_attention=bf16, swa_attention_f32=f32)
    if counts != want:
        raise AssertionError(f"{phase}: launch counts {counts}, expected "
                             f"{want}")


def lm_f32_weights(cfg, seed: int, dev):
    import torch

    from repro_torch.archs.model import init_arch

    return init_arch(torch.Generator(device=dev).manual_seed(seed), cfg,
                     device=dev, dtype=torch.float32)


def parity_reading(params, cfg, tok, last_only: bool, fault: bool) -> dict:
    """f32 ``forward`` with the kernel against ``use_kernel=False`` on the
    card: all logits or (``last_only``, to keep the (S, V) logits out of
    memory) the last position's.  ``fault``: also the kernel path with the
    SWA layers' window one too wide (a planted off-by-one), against the
    same plain logits — where a faulty kernel would read."""
    import dataclasses

    import torch

    from repro_torch.archs.model import forward, lm_head_weights

    def run(c, use_kernel: bool):
        out, _ = forward(params, c, tok, dtype=torch.float32,
                         return_hidden=last_only, use_kernel=use_kernel)
        if last_only:
            out = out[:, -1] @ lm_head_weights(params, c, torch.float32)
        return out

    with torch.no_grad():
        reset_all_launches()
        t = time.perf_counter()
        got = run(cfg, True)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t
        launches = all_launch_counts()
        t = time.perf_counter()
        want = run(cfg, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        scale = float(want.abs().max())
        d = (got - want).abs()
        out = {"kernel_forward_s": kernel_s, "plain_forward_s": plain_s,
               "max_abs_err": float(d.max()), "max_abs_logit": scale,
               "max_err_over_max_logit": float(d.max()) / scale,
               "rel_l2": float((got - want).norm() / want.norm()),
               "elementwise_within_logit_tol": bool(torch.all(
                   d <= LOGIT_TOL * scale + LOGIT_TOL * want.abs())),
               "finite": bool(torch.isfinite(got).all()),
               "launches": launches}
        del got, d
        if fault:
            wide = dataclasses.replace(cfg, window=cfg.window + 1)
            bad = run(wide, True)
            d = (bad - want).abs()
            out["fault_window_plus_1_max_err_over_max_logit"] = float(
                d.max()) / scale
            out["fault_elementwise_within_logit_tol"] = bool(torch.all(
                d <= LOGIT_TOL * scale + LOGIT_TOL * want.abs()))
            del bad, d
        del want
    return out


def phase_lm_parity(dev) -> dict:
    """gemma3-12b at full width and PARITY_LAYERS (one 5:1 pattern), f32,
    random weights from seed 0, S = PARITY_S: every logit of the kernel
    path within LOGIT_TOL of the plain path's (elementwise, against the
    largest), PARITY_LAYERS launches, and the planted fault outside it."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch

    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=PARITY_LAYERS,
                              blocks=full.blocks[:PARITY_LAYERS],
                              ffns=full.ffns[:PARITY_LAYERS])
    t0 = time.perf_counter()
    params = lm_f32_weights(cfg, 0, dev)
    tok = torch.randint(0, cfg.vocab, (1, PARITY_S), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = parity_reading(params, cfg, tok, last_only=False, fault=True)
    del params
    torch.cuda.empty_cache()
    out = {"phase": "lm_parity", "arch": cfg.name, "layers": PARITY_LAYERS,
           "pattern": list(cfg.blocks), "dtype": "float32", "batch": 1,
           "seq": PARITY_S, "compared": "all", "init_s": init_s, **r,
           "tolerance": {"atol_x_max": LOGIT_TOL, "rtol": LOGIT_TOL}}
    _expect_launches("lm_parity", r["launches"], f32=PARITY_LAYERS)
    if not (r["elementwise_within_logit_tol"] and r["finite"]
            and not r["fault_elementwise_within_logit_tol"]):
        raise AssertionError(f"lm_parity: kernel forward differs from the "
                             f"plain one, or the planted fault does not: "
                             f"{json.dumps(out)}")
    return out


def phase_lm_prefill(params, cfg, dev) -> dict:
    import torch

    from repro_torch.archs.model import forward

    tok = torch.randint(0, cfg.vocab, (1, PREFILL_S), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    with torch.no_grad():
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        logits, _ = forward(params, cfg, tok)
        torch.cuda.synchronize()
        launches = all_launch_counts()
        peak = torch.cuda.max_memory_allocated()  # before the check's temps
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        last = logits[:, -1].clone()
        del logits
        times = []
        for _ in range(4):  # a warm-up, then 3 timed
            torch.cuda.synchronize()
            t = time.perf_counter()
            forward(params, cfg, tok)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        wall = statistics.median(times[1:])
        prof = profile_step(lambda: forward(params, cfg, tok))

        def plain_last():
            out, _ = forward(params, cfg, tok, use_kernel=False)
            return out[:, -1].clone()

        torch.cuda.synchronize()
        t = time.perf_counter()
        plain = plain_last()
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        # control: the plain path with one weight (layer 0's wq[7, 7]) moved
        # by one bf16 ulp
        bits = params["layers"][0]["attn"]["wq"][7, 7:8].view(torch.int16)
        bits += 1
        plain_ulp = plain_last()
        bits -= 1
    torch.cuda.empty_cache()
    rel = lambda a, b: float((a - b).norm() / b.norm())
    out = {"phase": "lm_prefill", "arch": cfg.name, "layers": cfg.n_layers,
           "dtype": "bfloat16", "batch": 1, "seq": PREFILL_S,
           "logits_shape": shape, "finite": finite, "launches": launches,
           "wall_s_median": wall, "wall_s": times[1:],
           "tokens_per_s": PREFILL_S / wall, "allocated_before_bytes": before,
           "peak_memory_bytes": peak, "plain_attention_wall_s": plain_s,
           "last_logits_rel_l2_kernel_vs_plain": rel(last, plain),
           "last_logits_rel_l2_plain_vs_plain_1ulp_wq": rel(plain_ulp,
                                                            plain),
           "note": "bf16 at depth 48 with random weights: one bf16 ulp "
                   "anywhere moves the last logits by as much as the "
                   "attention's summation order does (the control), so "
                   "neither is gated; lm_parity_full holds the kernel to "
                   "the plain path at this depth and length in f32",
           "profile": prof}
    _expect_launches("lm_prefill", launches, bf16=cfg.n_layers)
    if not finite:
        raise AssertionError(f"lm_prefill: non-finite logits: "
                             f"{json.dumps(out)}")
    return out


def expected_cache_bytes(cfg, batch: int, cap: int) -> int:
    """bf16 K and V and int32 positions per layer (a ring of the window
    for SWA layers), plus the bf16 virtual-token state."""
    total = 0
    for kind in cfg.blocks:
        c = min(cfg.window, cap) if kind == "swa" else cap
        total += batch * c * (2 * cfg.n_kv_heads * cfg.head_dim * 2 + 4)
    return total + batch * cfg.n_virtual_tokens * cfg.d_virtual * 2


def decode_trace(params, cfg, seq, dtype, dev) -> dict:
    """Teacher-force ``seq`` (B, T) through ``decode_step`` in ``dtype``
    from an empty cache of capacity T.  Per step: the greedy token, whether
    the logits are finite, log10 of the virtual-token state's largest
    |value| (inf or nan once it is not finite), and the step's time between
    CUDA events around ``decode_step`` (the host issues the step's ops
    while the device waits, so this is the step's wall time)."""
    import math

    import torch

    from repro_torch.archs.model import decode_step, init_cache

    b, steps = seq.shape
    seq = seq.to(dev)
    cache = init_cache(cfg, b, steps, dtype=dtype, device=dev)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(steps)]
    greedy, lf, vmax = [], [], []
    with torch.no_grad():
        for t in range(steps):
            ev[t][0].record()
            logits, cache = decode_step(
                params, cfg, cache, seq[:, t],
                torch.full((b,), t, dtype=torch.int32, device=dev),
                dtype=dtype)
            ev[t][1].record()
            greedy.append(torch.argmax(logits, dim=-1))
            lf.append(torch.isfinite(logits).all())
            vmax.append(cache.vt.float().abs().amax())
    torch.cuda.synchronize()
    vmax = torch.stack(vmax).tolist()
    vt_finite = [math.isfinite(v) for v in vmax]
    return {"greedy": torch.stack(greedy, dim=1).cpu(),
            "logits_finite": torch.stack(lf).tolist(),
            "vt_finite": vt_finite,
            "log10_max_vt": [math.log10(v) if f and v > 0 else None
                             for v, f in zip(vmax, vt_finite)],
            "first_vt_nonfinite": next(
                (t for t, f in enumerate(vt_finite) if not f), None),
            "step_ms": [a.elapsed_time(z) for a, z in ev]}


def phase_lm_serve(params, cfg, dev) -> tuple[dict, dict]:
    """The port's serve path on the prefill's weights: batch 4, prompt 16,
    32 greedy tokens, then 1,000 + 40 so the SWA rings wrap; exact cache
    footprint and 0 kernel launches for both.  The first run's prompt and
    generated tokens are then replayed through ``decode_step``: every
    generated token must be the replay's argmax where the logits are
    finite, the logits finite wherever the virtual-token state is, and
    that state's first non-finite step inside VT_OVERFLOW_STEPS (with
    random weights it overflows, as the reference's does)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import serve

    runs = []
    for prompt, gen in ((SERVE_PROMPT, SERVE_GEN), (WRAP_PROMPT, WRAP_GEN)):
        text = io.StringIO()
        reset_all_launches()
        with contextlib.redirect_stdout(text):
            res = serve.run(params, cfg, batch=SERVE_BATCH, prompt_len=prompt,
                            gen=gen, device=dev)
        launches = all_launch_counts()
        want_bytes = expected_cache_bytes(cfg, SERVE_BATCH, prompt + gen)
        run = {k: v for k, v in res.items() if k not in ("prompt",
                                                          "generated")}
        run.update(launches=launches, cache_bytes_expected=want_bytes,
                   generated_row0=res["generated"][0].tolist(),
                   printout=text.getvalue().splitlines())
        runs.append(run)
        _expect_launches("lm_serve", launches)
        if res["cache_bytes"] != want_bytes:
            raise AssertionError(f"lm_serve: cache footprint: "
                                 f"{json.dumps(run)}")
        if not runs[1:]:
            seq = torch.cat([res["prompt"], res["generated"]], dim=1)
    tr = decode_trace(params, cfg, seq, torch.bfloat16, dev)
    p, steps = SERVE_PROMPT, seq.shape[1]
    first = tr["first_vt_nonfinite"]
    lf, vf = tr["logits_finite"], tr["vt_finite"]
    n_fin = first if first is not None else steps
    replay = {
        "steps": steps, "first_vt_nonfinite": first,
        "steps_logits_finite": sum(lf),
        "logits_finite_where_vt_finite": all(l or not v
                                             for l, v in zip(lf, vf)),
        "generated_match_replay": all(
            torch.equal(tr["greedy"][:, t], seq[:, t + 1])
            for t in range(p - 1, steps - 1) if lf[t]),
        "log10_max_vt": tr["log10_max_vt"],
        "tokens_per_s_finite_steps": (
            SERVE_BATCH * n_fin / (sum(tr["step_ms"][:n_fin]) / 1e3)
            if n_fin else None),
        "tokens_per_s_all_steps": SERVE_BATCH * steps / (
            sum(tr["step_ms"]) / 1e3),
        "step_ms": tr["step_ms"]}
    out = {"phase": "lm_serve", "window": cfg.window, "runs": runs,
           "replay_bf16": replay, "vt_overflow_steps": list(VT_OVERFLOW_STEPS)}
    lo, hi = VT_OVERFLOW_STEPS
    if not (replay["logits_finite_where_vt_finite"] and lf[0]
            and replay["generated_match_replay"]
            and first is not None and lo <= first <= hi):
        raise AssertionError(f"lm_serve failed: {json.dumps(out)}")
    from repro_torch.archs.model import decode_step, init_cache

    cache = init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN, device=dev)
    zeros = torch.zeros((SERVE_BATCH,), dtype=torch.int32, device=dev)
    with torch.no_grad():
        out["profile_decode_step"] = profile_step(
            lambda: decode_step(params, cfg, cache, zeros, zeros))
    return out, {"seq": seq, "first_vt_nonfinite": first}


def phase_lm_full_f32(cfg, dev, served) -> tuple[dict, dict]:
    """gemma3-12b at full width and depth in f32, random weights from each
    of FULL_SEEDS, S = PREFILL_S: the last position's logits of the kernel
    path against the plain path's within FULL_LOGIT_TOL of the largest,
    48 launches, and seed 0's planted fault above that limit.  With seed
    0's weights (the bf16 model's before rounding) the served sequence is
    replayed through ``decode_step`` in f32: its virtual-token state must
    overflow inside VT_OVERFLOW_STEPS and within one step of the bf16
    replay's."""
    import torch

    tok = torch.randint(0, cfg.vocab, (1, PREFILL_S), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    seeds, trace = {}, None
    for seed in FULL_SEEDS:
        t0 = time.perf_counter()
        params = lm_f32_weights(cfg, seed, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        r = parity_reading(params, cfg, tok, last_only=True,
                           fault=seed == FULL_SEEDS[0])
        seeds[str(seed)] = {"init_s": init_s, **r}
        if seed == FULL_SEEDS[0]:
            trace = decode_trace(params, cfg,
                                 served["seq"][:, :VT_OVERFLOW_STEPS[1] + 1],
                                 torch.float32, dev)
        del params
        torch.cuda.empty_cache()
    sound = max(r["max_err_over_max_logit"] for r in seeds.values())
    fault = seeds[str(FULL_SEEDS[0])][
        "fault_window_plus_1_max_err_over_max_logit"]
    parity = {"phase": "lm_parity_full", "arch": cfg.name,
              "layers": cfg.n_layers, "dtype": "float32", "batch": 1,
              "seq": PREFILL_S, "compared": "last position", "seeds": seeds,
              "limit_max_err_over_max_logit": FULL_LOGIT_TOL,
              "sound_max": sound, "fault_reading": fault}
    first, first_bf16 = trace["first_vt_nonfinite"], served[
        "first_vt_nonfinite"]
    lf, vf = trace["logits_finite"], trace["vt_finite"]
    decode = {"phase": "lm_decode_f32", "arch": cfg.name, "seed": 0,
              "steps": len(lf), "first_vt_nonfinite": first,
              "first_vt_nonfinite_bf16": first_bf16,
              "logits_finite_where_vt_finite": all(l or not v
                                                   for l, v in zip(lf, vf)),
              "log10_max_vt": trace["log10_max_vt"],
              "step_ms": trace["step_ms"],
              "vt_overflow_steps": list(VT_OVERFLOW_STEPS)}
    for r in seeds.values():
        _expect_launches("lm_parity_full", r["launches"], f32=cfg.n_layers)
    lo, hi = VT_OVERFLOW_STEPS
    if not (sound <= FULL_LOGIT_TOL < fault
            and all(r["finite"] for r in seeds.values())):
        raise AssertionError(f"lm_parity_full: the kernel path is not "
                             f"within the limit, or the planted fault is: "
                             f"{json.dumps([parity, decode])}")
    if not (decode["logits_finite_where_vt_finite"] and first is not None
            and lo <= first <= hi and abs(first - first_bf16) <= 1):
        raise AssertionError(f"lm_decode_f32 failed: {json.dumps(decode)}")
    return parity, decode


def family_cut(cfg, n_layers: int):
    """``cfg`` at its published widths and its first ``n_layers`` layers
    (and at most as many encoder layers)."""
    import dataclasses

    return dataclasses.replace(
        cfg, n_layers=n_layers, blocks=cfg.blocks[:n_layers],
        ffns=cfg.ffns[:n_layers],
        encoder_layers=min(cfg.encoder_layers, n_layers))


def attention_calls(cfg) -> int:
    """Attention calls of one prefill: every self-attention (zamba2's shared
    layers included; Mamba2, mLSTM and sLSTM have none), encoder layer and
    cross-attention layer."""
    return (sum(k in ("attn", "swa", "mla", "shared_attn")
                for k in cfg.blocks) + cfg.encoder_layers
            + sum(cfg.has_cross(i) for i in range(cfg.n_layers)))


def family_inputs(cfg, s: int, dev, seed: int) -> tuple:
    """Tokens (1, s) and the modality input the config reads (whisper's
    frame embeddings, llama-vision's patch embeddings), from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    tok = torch.randint(0, cfg.vocab, (1, s), device=dev, generator=gen)
    mod = {}
    if cfg.has_encoder:
        mod["audio"] = torch.randn((1, cfg.n_audio_frames, cfg.d_model),
                                   generator=gen, device=dev)
    elif cfg.cross_attn_every > 0:
        mod["images"] = torch.randn((1, cfg.n_image_tokens, cfg.d_model),
                                    generator=gen, device=dev)
    return tok, mod


def family_cache_bytes(cfg, batch: int, cap: int) -> int:
    """bf16 caches: K and V (or MLA's latent and rope key) and int32
    positions per attention layer, the recurrent layers' f32 states, the
    virtual-token state, and the encoder states or image embeddings
    cross-attention reads."""
    total = 0
    d, ssm = cfg.d_model, cfg.ssm
    p = 2 * d // cfg.n_heads  # mLSTM's head width: pf 2
    mamba_heads = ssm.expand * d // ssm.head_dim
    for kind in cfg.blocks:
        if kind == "mamba2":  # f32 state (H, P, N) and conv tail (3, C)
            total += batch * 4 * (
                mamba_heads * ssm.head_dim * ssm.d_state
                + 3 * (ssm.expand * d + 2 * ssm.d_state))
        elif kind == "mlstm":  # f32 C (H, P, P), n (H, P), m (H)
            total += batch * 4 * cfg.n_heads * (p * p + p + 1)
        elif kind == "slstm":  # f32 c, n, m (d each)
            total += batch * 4 * 3 * d
        elif kind == "mla":
            total += batch * cap * (2 * (cfg.mla.kv_lora + cfg.mla.d_rope)
                                    + 4)
        else:
            total += batch * cap * (2 * cfg.n_kv_heads * cfg.head_dim * 2
                                    + 4)
    total += batch * cfg.n_virtual_tokens * cfg.d_virtual * 2
    if cfg.has_encoder:
        total += batch * cfg.n_audio_frames * cfg.d_model * 2
    elif cfg.cross_attn_every > 0:
        total += batch * cfg.n_image_tokens * cfg.d_model * 2
    return total


def family_parity(full, dev, n: int = 2) -> dict:
    """f32 weights (seed 0) at full width and ``n`` layers, or the fewest
    beyond that hold a cross layer: ``forward`` with the kernel against
    ``use_kernel=False`` (every logit within LOGIT_TOL of the largest, aux
    within 1e-5), one f32 launch per attention call; then the bf16 forward
    with the same weights (one bf16 launch per call) against the f32
    kernel path within FAMILY_BF16_L2; and :func:`family_decode_parity` in
    f32 and bf16."""
    import torch

    from repro_torch.archs.model import forward
    from repro_torch.kernels import swa_attention

    while not any(full.has_cross(i) for i in range(n)) and \
            full.cross_attn_every > 0:
        n += 1
    cfg = family_cut(full, n)
    s = WHISPER_S if cfg.has_encoder else FAMILY_PARITY_S
    params = lm_f32_weights(cfg, 0, dev)
    tok, mod = family_inputs(cfg, s, dev, seed=1)
    with torch.no_grad():
        reset_all_launches()
        t = time.perf_counter()
        got, aux = forward(params, cfg, tok, dtype=torch.float32, **mod)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t
        launches = all_launch_counts()
        forms = dict(swa_attention.form_launches)
        want, aux_plain = forward(params, cfg, tok, dtype=torch.float32,
                                  use_kernel=False, **mod)
        scale = float(want.abs().max())
        d = (got - want).abs()
        out = {"layers": n, "encoder_layers": cfg.encoder_layers,
               "seq": s, "attention_calls": attention_calls(cfg),
               "kernel_forward_s": kernel_s,
               "max_abs_err": float(d.max()), "max_abs_logit": scale,
               "max_err_over_max_logit": float(d.max()) / scale,
               "elementwise_within_logit_tol": bool(torch.all(
                   d <= LOGIT_TOL * scale + LOGIT_TOL * want.abs())),
               "aux": float(aux), "aux_abs_err": abs(float(aux - aux_plain)),
               "finite": bool(torch.isfinite(got).all()),
               "launches": launches, "form_launches": forms}
        del d, want
        reset_all_launches()
        bf, _ = forward(params, cfg, tok, dtype=torch.bfloat16, **mod)
        out["bf16_launches"] = all_launch_counts()
        out["bf16_rel_l2_vs_f32"] = rel_l2(bf.float(), got)
        del bf, got
    out["decode"] = {tag: family_decode_parity(params, cfg, dt, dev)
                     for tag, dt in (("f32", torch.float32),
                                     ("bf16", torch.bfloat16))}
    del params
    torch.cuda.empty_cache()
    return out


def family_decode_parity(params, cfg, dtype, dev) -> dict | None:
    """``decode_step`` with the kernel against ``use_kernel=False`` on the
    card, for a config with cross layers (None for the others: their
    decode launches no kernel): SERVE_BATCH rows over serve.run's
    modality inputs (the encoder's states through the kernel for whisper),
    DECODE_CMP_STEPS random tokens (seed 2) teacher-forced.  Each step
    forks the plain path's cache, steps the fork with the kernel and the
    cache itself without it, so a step's reading is its own: with two
    caches the bf16 roundings of whisper's 12 random-weight layers
    compounded from 0.03 to 1.3 relative L2 in 6 steps on an H100.  Only
    the cross layers launch the kernel there, one query a row over T keys.
    Per step and row: f32, every logit within LOGIT_TOL of the row's
    largest; bf16, the relative L2 within FAMILY_BF16_L2."""
    import torch

    from repro_torch.archs.model import decode_step, encode_audio, init_cache
    from repro_torch.kernels import swa_attention
    from repro_torch.launch.serve import modality_inputs

    n_cross = sum(cfg.has_cross(i) for i in range(cfg.n_layers))
    if not n_cross:
        return None
    b, n = SERVE_BATCH, DECODE_CMP_STEPS
    with torch.no_grad():
        mod = modality_inputs(cfg, b, dev)
        enc = (encode_audio(params, cfg, mod["audio"], dtype)
               if cfg.has_encoder else mod["images"].to(dtype))
        tok = torch.randint(0, cfg.vocab, (b, n),
                            generator=torch.Generator().manual_seed(2)).to(dev)
        cache = init_cache(cfg, b, n, enc_out=enc, dtype=dtype, device=dev)
        fork = lambda c: c._replace(layers=tuple(
            {k: type(kv)(*(x.clone() for x in kv)) for k, kv in e.items()}
            for e in c.layers), vt=None if c.vt is None else c.vt.clone())
        errs, l2s, finite, within = [], [], True, True
        launches, forms = {}, {}
        for t in range(n):
            pos = torch.full((b,), t, dtype=torch.int32, device=dev)
            reset_all_launches()
            got, _ = decode_step(params, cfg, fork(cache), tok[:, t], pos,
                                 dtype=dtype)
            torch.cuda.synchronize()
            for k, v in all_launch_counts().items():
                launches[k] = launches.get(k, 0) + v
            for k, v in swa_attention.form_launches.items():
                forms[k] = forms.get(k, 0) + v
            want, cache = decode_step(params, cfg, cache, tok[:, t], pos,
                                      dtype=dtype, use_kernel=False)
            finite &= bool(torch.isfinite(got).all()
                           and torch.isfinite(want).all())
            d = (got - want).abs()
            scale = want.abs().amax(dim=-1, keepdim=True)
            errs.append(float((d / scale).max()))
            l2s.append([rel_l2(got[i], want[i]) for i in range(b)])
            if dtype == torch.float32:
                within &= bool(torch.all(
                    d <= LOGIT_TOL * scale + LOGIT_TOL * want.abs()))
            else:
                within &= max(l2s[-1]) <= FAMILY_BF16_L2
        del cache, enc
    return {"dtype": str(dtype).removeprefix("torch."), "batch": b,
            "steps": n, "cross_layers": n_cross,
            "max_err_over_row_max_logit": errs, "rel_l2_per_row": l2s,
            "finite": finite, "within_limit": within,
            "launches": launches, "form_launches": forms}


def family_full(cfg, dev, runs: int = 3, profile: bool = False) -> dict:
    """bf16 weights built on the card at full width and depth: a B = 1
    prefill of PREFILL_S tokens (whisper: WHISPER_S over its frames), one
    bf16 launch per attention call, then ``runs`` more, timed (the first
    a warm-up where there are several; with none, the counted run is the
    timed one), and with ``profile`` one under :func:`profile_step`; then
    serve.run at SERVE_BATCH x
    (SERVE_PROMPT + SERVE_GEN) with the exact cache footprint and one
    launch per cross layer and step (and the encoder's)."""
    import contextlib
    import io

    import torch

    from repro_torch.archs.model import forward, init_arch
    from repro_torch.kernels import swa_attention
    from repro_torch.launch import serve
    from repro_torch.training.optim import tree_leaves

    t0 = time.perf_counter()
    params = init_arch(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    s = WHISPER_S if cfg.has_encoder else PREFILL_S
    tok, mod = family_inputs(cfg, s, dev, seed=1)
    with torch.no_grad():
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_all_launches()
        t = time.perf_counter()
        logits, aux = forward(params, cfg, tok, **mod)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = all_launch_counts()
        forms = dict(swa_attention.form_launches)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits).all())
        shape = list(logits.shape)
        del logits
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            forward(params, cfg, tok, **mod)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = (profile_step(lambda: forward(params, cfg, tok, **mod))
                if profile else None)
    times = times[1:] or times or [first_s]  # without the warm-up
    wall = statistics.median(times)
    out.update(prefill={
        "batch": 1, "seq": s, "logits_shape": shape, "finite": finite,
        "aux": float(aux), "launches": launches, "form_launches": forms,
        "attention_calls": attention_calls(cfg), "first_run_s": first_s,
        "wall_s": times, "wall_s_median": wall, "tokens_per_s": s / wall,
        "allocated_before_bytes": before, "peak_memory_bytes": peak,
        "profile": prof})
    text = io.StringIO()
    reset_all_launches()
    with contextlib.redirect_stdout(text):
        res = serve.run(params, cfg, batch=SERVE_BATCH,
                        prompt_len=SERVE_PROMPT, gen=SERVE_GEN, device=dev)
    steps = SERVE_PROMPT + SERVE_GEN
    n_cross = sum(cfg.has_cross(i) for i in range(cfg.n_layers))
    out["serve"] = {
        **{k: v for k, v in res.items() if k not in ("prompt", "generated")},
        "launches": all_launch_counts(),
        "form_launches": dict(swa_attention.form_launches),
        "cache_bytes_expected": family_cache_bytes(cfg, SERVE_BATCH, steps),
        "attention_launches_expected": n_cross * steps,
        "encoder_launches_expected": cfg.encoder_layers,
        "generated_row0": res["generated"][0].tolist(),
        "generated_in_vocab": bool(int(res["generated"].max()) < cfg.vocab),
        "printout": text.getvalue().splitlines()}
    del params
    torch.cuda.empty_cache()
    return out


def phase_lm_family(aid: str, dev) -> dict:
    """One config of the attention family: :func:`family_parity`, then
    :func:`family_full`; fails on a count, limit or footprint missed."""
    from repro_torch.configs import get_arch

    full = get_arch(aid)
    depth = FAMILY_DEPTH.get(aid, full.n_layers)
    cfg = family_cut(full, depth)
    t0 = time.perf_counter()
    par = family_parity(full, dev)
    big = family_full(cfg, dev)
    line = {"phase": "lm_families", "arch": full.name, "layers": depth,
            "published_layers": full.n_layers,
            "reduced": ([f"{depth} of {full.n_layers} layers"]
                        if depth < full.n_layers else []),
            "parity_f32": par, **big, "seconds": time.perf_counter() - t0,
            "tolerance": {"atol_x_max": LOGIT_TOL, "rtol": LOGIT_TOL,
                          "aux_atol": 1e-5, "bf16_rel_l2": FAMILY_BF16_L2,
                          "decode_f32_atol_x_row_max": LOGIT_TOL,
                          "decode_bf16_row_rel_l2": FAMILY_BF16_L2}}
    _expect_launches(f"lm_families {aid} parity", par["launches"],
                     f32=par["attention_calls"])
    _expect_launches(f"lm_families {aid} parity bf16", par["bf16_launches"],
                     bf16=par["attention_calls"])
    pre, srv = big["prefill"], big["serve"]
    _expect_launches(f"lm_families {aid} prefill", pre["launches"],
                     bf16=pre["attention_calls"])
    _expect_launches(f"lm_families {aid} serve", srv["launches"],
                     bf16=(srv["attention_launches_expected"]
                           + srv["encoder_launches_expected"]))
    for tag, dec in par["decode"].items():
        if dec is not None:
            _expect_launches(f"lm_families {aid} decode {tag}",
                             dec["launches"],
                             **{tag: dec["cross_layers"] * dec["steps"]})
            if not (dec["finite"] and dec["within_limit"]):
                raise AssertionError(f"lm_families {aid}: decode {tag} with "
                                     f"the kernel is not within the limit "
                                     f"of its plain path: {json.dumps(line)}")
    ok = (par["elementwise_within_logit_tol"] and par["finite"]
          and par["aux_abs_err"] <= 1e-5
          and par["bf16_rel_l2_vs_f32"] <= FAMILY_BF16_L2
          and pre["finite"]
          and srv["cache_bytes"] == srv["cache_bytes_expected"]
          and srv["attention_launches"] == srv["attention_launches_expected"]
          and srv["encoder_launches"] == srv["encoder_launches_expected"]
          and srv["generated_in_vocab"])
    if not ok:
        raise AssertionError(f"lm_families {aid} failed: {json.dumps(line)}")
    return line


def family_form_rows(dev, families: dict, forms: dict = FAMILY_FORMS,
                     phase: str = "lm_family_kernels") -> tuple[dict, dict]:
    """The attention kernel alone at ``forms``, bf16 and f32 (the same
    values), against its plain version in its dtype with a bitwise repeat,
    timed (CUDA events; device ms from ``torch.profiler``) beside the
    plain version and SDPA (``library_ms``: None where SDPA refuses the
    form), with the bound (q, k, v and o once; 2 (D + Dv)
    FLOP per visible pair at the bf16 tensor-core / f32 rate; for f32
    also ``bound_3xtf32_ms``, 3x the FLOP at the TF32 tensor-core rate,
    as the f32 kernel runs its products) and the launches of that form in
    the runs of ``arch`` that the form's ``stages`` name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import swa_attention

    readings, rows = {}, {"bf16": {}, "f32": {}}
    with torch.no_grad():
        for name, f in forms.items():
            gen = torch.Generator(device=dev).manual_seed(3)
            b = f.get("b", 1)
            r = lambda n, length, d: torch.randn((b, length, n, d),
                                                 generator=gen, device=dev)
            q32 = r(f["h"], f["s"], f["d"])
            k32, v32 = r(f["kv"], f["t"], f["d"]), r(f["kv"], f["t"], f["dv"])
            qp = torch.arange(f["s"], device=dev)
            kp = torch.arange(f["t"], device=dev)
            key = swa_attention.form(f["d"], f["dv"], f["s"], f["t"],
                                     f["causal"])
            pairs = (visible_pairs(f["s"], True, None) if f["causal"]
                     else f["s"] * f["t"])
            flops = 2 * (f["d"] + f["dv"]) * pairs * f["h"] * b
            elems = b * (f["s"] * f["h"] * (f["d"] + f["dv"])
                         + f["t"] * f["kv"] * (f["d"] + f["dv"]))
            stages = f.get("stages", ("prefill", "parity_f32"))
            out = {"form": key, "shape": {k: v for k, v in f.items()
                                          if k not in ("arch", "stages")},
                   "gflop": flops / 1e9}
            for tag, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
                run = lambda: swa_attention.attention(q, k, v,
                                                      causal=f["causal"])
                plain = lambda: swa_attention.chunked_attention(
                    q, k, v, qp, kp, causal=f["causal"], window=None)
                got, again, want = run(), run(), plain()
                cmp = _attention_close(got, want)
                cmp["bitwise_repeatable"] = torch.equal(got, again)
                del got, again, want
                sq, sk, sv = (a.transpose(1, 2) for a in (q, k, v))
                lib = lambda: F.scaled_dot_product_attention(
                    sq, sk, sv, is_causal=f["causal"], enable_gqa=True)
                try:
                    lib_ms = cuda_ms(lib, 10, 2)
                except RuntimeError as err:  # SDPA's yardstick only
                    lib_ms, cmp["library_error"] = None, str(err)[:200]
                peak = BF16_FLOPS if tag == "bf16" else F32_FLOPS
                b_ms, b_by = bound_ms(elems * (2 if tag == "bf16" else 4),
                                      flops, peak)
                if tag == "f32":
                    cmp["bound_3xtf32_ms"] = bound_ms(
                        elems * 4, 3 * flops, TF32_FLOPS)[0]
                stage = stages[tag == "f32"]
                counts = families[f["arch"]][stage]["form_launches"]
                dev_f = device_fields(run)
                out[tag] = dict(
                    cmp, ms=cuda_ms(run, 10, 2),
                    device_ms=dev_f["device_ms"],
                    kernels_per_call=dev_f["kernels_per_call"],
                    plain_ms=cuda_ms(plain, 5, 1), library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, launches=counts.get(key, 0))
                rows[tag][name] = dict(out[tag], name=name)
            readings[name] = out
    line = {"phase": phase, "forms": readings,
            "tolerance": {"f32": {"atol": ATOL, "rtol": RTOL},
                          "bf16": {"atol": BF16_ATOL, "rtol": BF16_RTOL}}}
    for name, out in readings.items():
        for tag in ("bf16", "f32"):
            c = out[tag]
            if not (c["within_tol"] and c["bitwise_repeatable"]
                    and c["launches"] > 0):
                raise AssertionError(f"attention kernel at {name} ({tag}) "
                                     f"disagrees with its plain version or "
                                     f"never ran on the main path: "
                                     f"{json.dumps(line)}")
    return line, rows


def _held(got, want, tol: float) -> dict:
    """``got`` against ``want`` elementwise: |g - w| <= tol + tol |w|."""
    import torch

    d = (got - want).abs()
    return {"max_abs_err": float(d.max()), "max_abs": float(want.abs().max()),
            "finite": bool(torch.isfinite(got).all()
                           and torch.isfinite(want).all()),
            "within_tol": bool(torch.all(d <= tol + tol * want.abs()))}


def xlstm_card_vs_cpu(full, dev) -> dict:
    """xlstm at its published widths and XLSTM_CARD_LAYERS layers (mLSTM,
    sLSTM), f32 weights (seed 0) built on the card: the card's logits for
    XLSTM_CARD_S tokens against the same weights' forward on the CPU (the
    recurrences are plain PyTorch on both; no kernel to hold), every logit
    within LOGIT_TOL of the largest, and no launch; the card's bf16
    forward against its f32 (relative L2, reported)."""
    import torch

    from repro_torch.archs.model import forward
    from repro_torch.training.optim import tree_map

    cfg = family_cut(full, XLSTM_CARD_LAYERS)
    params = lm_f32_weights(cfg, 0, dev)
    tok, _ = family_inputs(cfg, XLSTM_CARD_S, dev, seed=1)
    with torch.no_grad():
        reset_all_launches()
        t = time.perf_counter()
        got, _ = forward(params, cfg, tok, dtype=torch.float32)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        launches = all_launch_counts()
        bf, _ = forward(params, cfg, tok)
        bf_l2 = rel_l2(bf.float(), got)
        del bf
        cpu = tree_map(lambda t: t.cpu(), params)
        t = time.perf_counter()
        want, _ = forward(cpu, cfg, tok.cpu(), dtype=torch.float32)
        cpu_s = time.perf_counter() - t
    got = got.cpu()
    scale = float(want.abs().max())
    d = (got - want).abs()
    out = {"layers": list(cfg.blocks), "seq": XLSTM_CARD_S,
           "card_forward_s": card_s, "cpu_forward_s": cpu_s,
           "cpu_threads": torch.get_num_threads(),
           "max_abs_err": float(d.max()), "max_abs_logit": scale,
           "max_err_over_max_logit": float(d.max()) / scale,
           "elementwise_within_logit_tol": bool(torch.all(
               d <= LOGIT_TOL * scale + LOGIT_TOL * want.abs())),
           "finite": bool(torch.isfinite(got).all()),
           "bf16_rel_l2_vs_f32": bf_l2, "launches": launches}
    del params, cpu
    torch.cuda.empty_cache()
    return out


def _decode_run(step, x, state) -> tuple:
    """Every token of ``x`` (B, T, d) through ``step(x_t, state)``: the
    outputs (B, T, d) and the ms a token."""
    import torch

    outs = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(x.shape[1]):
        y, state = step(x[:, i:i + 1], state)
        outs.append(y)
    torch.cuda.synchronize()
    return torch.cat(outs, 1), 1e3 * (time.perf_counter() - t) / x.shape[1]


def module_decode_parity(cfg, dev) -> dict:
    """The reference's decode-against-forward contract (its
    tests/test_nn.py), module by module on the card in f32 at ``cfg``'s
    published widths: MODULE_TOKENS tokens of random inputs (seed 4) for
    MODULE_BATCH rows, one decode step a token from an empty state against
    the forward over all of them, within MODULE_TOL (atol and rtol).
    Mamba2 (zamba2) at its SSD chunk and at MODULE_SMALL_CHUNK; mLSTM and
    sLSTM (xlstm)."""
    import torch

    from repro_torch.nn import ssm, xlstm

    gen = torch.Generator(device=dev).manual_seed(4)
    b, n, d = MODULE_BATCH, MODULE_TOKENS, cfg.d_model
    out = {}
    with torch.no_grad():
        x = torch.randn((b, n, d), generator=gen, device=dev)
        if "mamba2" in cfg.blocks:
            md = ssm.mamba2_dims(d, d_state=cfg.ssm.d_state,
                                 head_dim=cfg.ssm.head_dim,
                                 expand=cfg.ssm.expand)
            p = ssm.init_mamba2(gen, md, device=dev)
            dec, ms = _decode_run(
                lambda xt, c: ssm.mamba2_decode(p, xt, c, md), x,
                ssm.init_mamba2_cache(b, md, device=dev))
            for c in (cfg.ssd_chunk, MODULE_SMALL_CHUNK):
                out[f"mamba2_chunk_{c}"] = dict(_held(
                    dec, ssm.mamba2_forward(p, x, md, c), MODULE_TOL),
                    decode_ms_per_token=ms)
        if "mlstm" in cfg.blocks:
            xd = xlstm.xlstm_dims(d, cfg.n_heads)
            p = xlstm.init_mlstm(gen, xd, device=dev)
            dec, ms = _decode_run(
                lambda xt, st: xlstm.mlstm_decode(p, xt, st, xd), x,
                xlstm.init_mlstm_state(b, xd, device=dev))
            out["mlstm"] = dict(_held(dec, xlstm.mlstm_forward(p, x, xd),
                                      MODULE_TOL), decode_ms_per_token=ms)
            p = xlstm.init_slstm(gen, xd, device=dev)
            dec, ms = _decode_run(
                lambda xt, st: xlstm.slstm_decode(p, xt, st), x,
                xlstm.init_slstm_state(b, d, device=dev))
            out["slstm"] = dict(_held(dec, xlstm.slstm_forward(p, x),
                                      MODULE_TOL), decode_ms_per_token=ms)
    torch.cuda.empty_cache()
    return out


def phase_lm_recurrent(aid: str, dev) -> dict:
    """One config of the recurrent family at its published widths: zamba2's
    kernel path against the plain one (:func:`family_parity` at
    ZAMBA_PARITY_LAYERS layers), or xlstm's card against the CPU
    (:func:`xlstm_card_vs_cpu`); :func:`module_decode_parity`; then
    :func:`family_full` at full depth (xlstm's prefill timed in its
    counted run alone: its token-by-token recurrences take ~30 s).  Fails
    on a count, limit or footprint missed."""
    from repro_torch.configs import get_arch

    full = get_arch(aid)
    shared = full.blocks.count("shared_attn")
    t0 = time.perf_counter()
    line = {"phase": "lm_recurrent", "arch": full.name,
            "layers": full.n_layers, "published_layers": full.n_layers,
            "reduced": [], "blocks": {k: full.blocks.count(k)
                                      for k in sorted(set(full.blocks))}}
    if shared:
        line["parity_f32"] = par = family_parity(full, dev,
                                                 ZAMBA_PARITY_LAYERS)
        _expect_launches(f"lm_recurrent {aid} parity", par["launches"],
                         f32=par["attention_calls"])
        _expect_launches(f"lm_recurrent {aid} parity bf16",
                         par["bf16_launches"], bf16=par["attention_calls"])
        ok = (par["attention_calls"] == 1
              and par["elementwise_within_logit_tol"] and par["finite"]
              and par["bf16_rel_l2_vs_f32"] <= FAMILY_BF16_L2)
    else:
        line["card_vs_cpu_f32"] = cvc = xlstm_card_vs_cpu(full, dev)
        _expect_launches(f"lm_recurrent {aid} card", cvc["launches"])
        ok = cvc["elementwise_within_logit_tol"] and cvc["finite"]
    line["decode_vs_forward"] = mods = module_decode_parity(full, dev)
    ok &= all(r["within_tol"] and r["finite"] for r in mods.values())
    line.update(family_full(full, dev, runs=3 if shared else 0,
                            profile=bool(shared)))
    pre, srv = line["prefill"], line["serve"]
    _expect_launches(f"lm_recurrent {aid} prefill", pre["launches"],
                     bf16=shared)
    _expect_launches(f"lm_recurrent {aid} serve", srv["launches"])
    line["seconds"] = time.perf_counter() - t0
    line["tolerance"] = {"atol_x_max": LOGIT_TOL, "rtol": LOGIT_TOL,
                         "bf16_rel_l2": FAMILY_BF16_L2,
                         "module_decode_atol": MODULE_TOL,
                         "module_decode_rtol": MODULE_TOL}
    ok &= (pre["attention_calls"] == shared and pre["finite"]
           and srv["cache_bytes"] == srv["cache_bytes_expected"]
           and srv["attention_launches"] == 0 and srv["generated_in_vocab"])
    if not ok:
        raise AssertionError(f"lm_recurrent {aid} failed: {json.dumps(line)}")
    return line


# ---------------------------------------------------------- lm_train phase
def train_inputs(cfg, b: int, s: int, seed: int) -> dict:
    """A (b, s) batch of random tokens and their random labels (+ the
    whisper / vlm stubs), from a CPU generator seeded ``seed``, on the
    CPU."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab, (b, s), generator=gen),
           "labels": torch.randint(0, cfg.vocab, (b, s), generator=gen)}
    if cfg.has_encoder:
        out["audio"] = torch.randn((b, cfg.n_audio_frames, cfg.d_model),
                                   generator=gen)
    if cfg.cross_attn_every:
        out["images"] = torch.randn((b, cfg.n_image_tokens, cfg.d_model),
                                    generator=gen)
    return out


def example_stream(cfg, b: int, s: int, seed: int) -> dict:
    """The reference example's synthetic stream (examples/train_lm_100m.py):
    an order-2 stream over min(V, 1,024) tokens, from a CPU generator."""
    import torch

    vocab = min(cfg.vocab, 1024)
    base = torch.randint(0, vocab, (b, s + 1),
                         generator=torch.Generator().manual_seed(seed))
    prev = base[:, :-1]
    toks = base.clone()
    toks[:, 1:] = (prev * 31 + torch.roll(prev, 1, dims=1) * 7 + 11) % vocab
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def one_step(params, cfg, batch, dtype) -> tuple:
    """The step ``make_train_step`` takes, in its two parts: the loss and
    gradients (``training.lm.value_and_grad``), then one Adam update from
    a fresh state.  Returns (loss, gradient leaves, updated leaves) on the
    CPU."""
    from repro_torch.training.lm import value_and_grad
    from repro_torch.training.optim import Adam, tree_leaves

    opt = Adam(lr=TRAIN_LR, grad_clip=TRAIN_CLIP)
    loss, _, grads = value_and_grad(params, cfg, batch, dtype=dtype)
    new, _ = opt.update(grads, opt.init(params), params)
    cpu = lambda tree: [t.float().cpu() for t in tree_leaves(tree)]
    return float(loss), cpu(grads), cpu(new)


def step_held(got, want, dtype) -> dict:
    """A card step against the CPU's: f32, the loss (TRAIN_LOSS_RTOL) and
    every gradient leaf (TRAIN_GRAD_TOL of its largest |value|); bf16, each
    leaf's relative L2 (TRAIN_BF16_L2)."""
    import torch

    (gl, gg, gp), (wl, wg, wp) = got, want
    out = {"loss": gl, "loss_cpu": wl, "loss_rel": abs(gl - wl) / abs(wl),
           "finite": all(bool(torch.isfinite(g).all()) for g in gg),
           "grad_max_rel_l2": max(rel_l2(g, w) for g, w in zip(gg, wg)),
           "step_max_abs_diff": max(float((g - w).abs().max())
                                    for g, w in zip(gp, wp))}
    if dtype == torch.float32:
        errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                for g, w in zip(gg, wg)]
        out["grad_max_err_over_leaf_max"] = max(errs)
        out["within_tol"] = (out["loss_rel"] <= TRAIN_LOSS_RTOL and all(
            bool(torch.all((g - w).abs() <= TRAIN_GRAD_TOL * w.abs().max()))
            for g, w in zip(gg, wg)))
    else:
        out["within_tol"] = out["grad_max_rel_l2"] <= TRAIN_BF16_L2
    out["within_tol"] &= out["finite"]
    return out


def train_card_vs_cpu(aid: str, dev) -> dict:
    """One config's reduced() variant: the card's step against the CPU's in
    f32 and bf16 (seed-0 weights built on the CPU, seed-1 batch), and a
    planted fault: one label changed, on the card only (f32)."""
    import torch

    from repro_torch.archs.model import init_arch
    from repro_torch.configs import get_arch
    from repro_torch.training.optim import tree_map

    cfg = get_arch(aid).reduced()
    cpu_p = init_arch(torch.Generator().manual_seed(0), cfg, device="cpu")
    card_p = tree_map(lambda t: t.to(dev), cpu_p)
    batch = train_inputs(cfg, TRAIN_B, TRAIN_S, 1)
    on_card = lambda b: {k: v.to(dev) for k, v in b.items()}
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        want = one_step(cpu_p, cfg, batch, dt)
        out[name] = step_held(one_step(card_p, cfg, on_card(batch), dt),
                              want, dt)
        if name == "f32":
            bad = dict(batch, labels=batch["labels"].clone())
            bad["labels"][0, 0] = (bad["labels"][0, 0] + 1) % cfg.vocab
            out["planted_fault"] = step_held(
                one_step(card_p, cfg, on_card(bad), dt), want, dt)
    return out


def train_run(cfg, batch: dict, dev, chunk: int = 0) -> tuple:
    """TRAIN_STEPS steps of ``make_train_step`` from the seed-0 f32 weights
    (built on the card) on ``batch``, bf16 compute: each step's loss, nll,
    aux and ms (a host clock around the step and its synchronise), tokens
    a second over the steps after the first, and the peak memory.  Returns
    (reading, params, Adam state)."""
    import dataclasses

    import torch

    from repro_torch.training.lm import make_train_step
    from repro_torch.training.optim import Adam

    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    batch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm_f32_weights(cfg, 0, dev)
    opt = Adam(lr=TRAIN_LR, grad_clip=TRAIN_CLIP)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    r = {"loss": [], "nll": [], "aux": [], "ms": []}
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        r["ms"].append(1e3 * (time.perf_counter() - t))
        for k in ("loss", "nll", "aux"):
            r[k].append(float(m[k]))
    tokens = batch["tokens"].numel()
    r["ms_per_step"] = statistics.median(r["ms"][1:])
    r["tokens_per_s"] = tokens / (r["ms_per_step"] / 1e3)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["finite_and_falling"] = (all(map(math.isfinite, r["loss"]))
                               and r["loss"][-1] < r["loss"][0])
    return r, params, state


def checkpoint_round_trip(params, state) -> dict:
    """Parameters and Adam state through ``save_checkpoint`` and
    ``restore_checkpoint`` in a temporary directory: bitwise, dtypes
    and devices kept; seconds and bytes."""
    import os
    import tempfile

    import torch

    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.optim import tree_leaves

    tree = {"params": params, "opt": state}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.npz")
        t = time.perf_counter()
        save_checkpoint(path, tree, {"steps": TRAIN_STEPS})
        save_s = time.perf_counter() - t
        n_bytes = os.path.getsize(path)
        t = time.perf_counter()
        back, meta = restore_checkpoint(path, tree)
        load_s = time.perf_counter() - t
    bitwise = meta == {"steps": TRAIN_STEPS} and all(
        a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
        for a, b in zip(tree_leaves(back), tree_leaves(tree)))
    return {"bitwise": bitwise, "save_s": save_s, "load_s": load_s,
            "bytes": n_bytes}


def train_grads_at_init(cfg, batch: dict, dev, chunks) -> dict:
    """``value_and_grad`` at the seed-0 weights (bf16), once for each loss
    chunk of ``chunks``: the peak memory it adds, the loss and aux, every
    MoE layer's router gradient norm, and for a second chunk each
    gradient leaf against the first's (relative L2) and the loss's
    relative difference."""
    import dataclasses

    import torch

    from repro_torch.training.lm import value_and_grad
    from repro_torch.training.optim import tree_leaves

    params = lm_f32_weights(cfg, 0, dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    out, first = {}, None
    for chunk in chunks:
        c = dataclasses.replace(cfg, loss_chunk=chunk)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, parts, grads = value_and_grad(params, c, batch)
        r = {"peak_gb_above_start":
             (torch.cuda.max_memory_allocated() - base) / 1e9,
             "loss": float(loss), "aux": float(parts["aux"]),
             "aux_share": 0.01 * float(parts["aux"]) / float(loss),
             "router_grad_norms": [
                 float(torch.linalg.vector_norm(lp["ffn"]["router"]))
                 for lp in grads["layers"] if "router" in lp.get("ffn", {})]}
        if first is None:
            first = (r["loss"], tree_leaves(grads))
        else:
            r["loss_rel_vs_dense"] = abs(r["loss"] - first[0]) / first[0]
            r["grad_max_rel_l2_vs_dense"] = max(
                rel_l2(g, w) for g, w in zip(tree_leaves(grads), first[1]))
        out[str(chunk)] = r
        del grads
    del params, first
    torch.cuda.empty_cache()
    return out


def train_published(aid: str, layers, b: int, s: int, chunks, dev) -> dict:
    """One config at its published widths (its first ``layers`` layers):
    for MoE or more than one loss chunk the gradients at init
    (:func:`train_grads_at_init`), then for each
    loss chunk two runs of :func:`train_run` from the same weights; the
    first run of the first chunk's state also round-trips a checkpoint
    (xlstm)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.training.optim import tree_leaves

    full = get_arch(aid)
    cfg = full if layers is None else family_cut(full, layers)
    batch = (example_stream(cfg, b, s, 1) if aid == "xlstm_125m"
             else train_inputs(cfg, b, s, 1))
    out = {"arch": full.name, "layers": cfg.n_layers,
           "published_layers": full.n_layers, "batch": b, "seq": s}
    if cfg.moe is not None or len(chunks) > 1:
        out["grads_at_init"] = train_grads_at_init(cfg, batch, dev, chunks)
    for chunk in chunks:
        runs = []
        for i in range(2):
            r, params, state = train_run(cfg, batch, dev, chunk)
            if i == 0:
                r["params"] = sum(t.numel() for t in tree_leaves(params))
                if aid == "xlstm_125m":
                    out["checkpoint"] = checkpoint_round_trip(params, state)
            del params, state
            torch.cuda.empty_cache()
            runs.append(r)
        runs[1] = {"loss": runs[1]["loss"], "ms_per_step":
                   runs[1]["ms_per_step"], "repeat_max_rel": max(
                       abs(a - w) / abs(w) for a, w in
                       zip(runs[1]["loss"], runs[0]["loss"]))}
        out[f"chunk_{chunk}"] = runs
    return out


def launcher_reading() -> dict:
    """``launch/train.py`` LM mode on the card (LAUNCH_ARGS, in this
    process): its step lines, and its parameter line against the count of
    the reduced config's weights built on the CPU."""
    import contextlib
    import io

    import torch

    from repro_torch.archs.model import init_arch
    from repro_torch.configs import get_arch
    from repro_torch.launch import train as launch
    from repro_torch.training.optim import tree_leaves

    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        launch.main(LAUNCH_ARGS)
    secs = time.perf_counter() - t
    lines = buf.getvalue().splitlines()
    cfg = get_arch("xlstm-125m").reduced()
    n = sum(t.numel() for t in tree_leaves(
        init_arch(torch.Generator().manual_seed(0), cfg, device="cpu")))
    steps = [ln for ln in lines if ln.startswith("step ")]
    return {"lines": lines, "seconds": secs, "params": n,
            "ok": (lines[0] == f"{cfg.name}: {n/1e6:.1f}M params"
                   and len(steps) == 3 and all(
                       math.isfinite(float(ln.split()[3])) for ln in steps))}


def phase_lm_train(dev) -> dict:
    """LM training on the card: (a) every config's reduced() step against
    the CPU's (f32 and bf16) with a planted fault; (b) TRAIN_RUNS at their
    published widths: gradients at init (olmoe's router gradients and aux
    share; gemma3's chunked loss against its dense one), 4-step runs twice
    each (finite, falling, repeated), xlstm's checkpoint round trip; (c)
    the launcher's LM mode.  No kernel launches (training runs the plain
    attention).  Fails on any limit missed."""
    from repro_torch.configs import _ARCH_IDS

    t0 = time.perf_counter()
    reset_all_launches()
    line = {"phase": "lm_train", "gpu": gpu_line(),
            "card_vs_cpu": {aid: train_card_vs_cpu(aid, dev)
                            for aid in _ARCH_IDS}}
    line["card_vs_cpu_s"] = time.perf_counter() - t0
    line["runs"] = {aid: train_published(aid, layers, b, s, chunks, dev)
                    for aid, layers, b, s, chunks in TRAIN_RUNS}
    line["launcher"] = launcher_reading()
    line["launches"] = all_launch_counts()
    line["seconds"] = time.perf_counter() - t0
    line["tolerance"] = {"loss_rtol": TRAIN_LOSS_RTOL,
                         "grad_atol_x_leaf_max": TRAIN_GRAD_TOL,
                         "bf16_rel_l2": TRAIN_BF16_L2,
                         "repeat_rtol": TRAIN_REPEAT_RTOL,
                         "chunk_loss_rtol": CHUNK_LOSS_RTOL}
    _expect_launches("lm_train", line["launches"])
    bad = []
    for aid, r in line["card_vs_cpu"].items():
        if not (r["f32"]["within_tol"] and r["bf16"]["within_tol"]):
            bad.append(f"{aid}: card against CPU")
        if r["planted_fault"]["within_tol"]:
            bad.append(f"{aid}: planted fault inside")
    for aid, r in line["runs"].items():
        for key in [k for k in r if k.startswith("chunk_")]:
            first, second = r[key]
            if not first["finite_and_falling"]:
                bad.append(f"{aid} {key}: losses not finite and falling")
            if second["repeat_max_rel"] > TRAIN_REPEAT_RTOL:
                bad.append(f"{aid} {key}: the repeat differs")
    olmoe = line["runs"]["olmoe_1b_7b"]["grads_at_init"]["0"]
    if not (olmoe["router_grad_norms"]
            and min(olmoe["router_grad_norms"]) > 0):
        bad.append("olmoe: a router gets no gradient")
    gemma = line["runs"]["gemma3_12b"]
    for chunk, r in gemma["grads_at_init"].items():
        if chunk == "0":
            continue
        n_chunks = -(-gemma["seq"] // int(chunk))
        r["grad_bound"] = (n_chunks + 1 + gemma["layers"]) * BF16_U
        if not (r["loss_rel_vs_dense"] <= CHUNK_LOSS_RTOL
                and r["grad_max_rel_l2_vs_dense"] <= r["grad_bound"]):
            bad.append(f"gemma3 chunk {chunk} against dense")
    if not line["runs"]["xlstm_125m"]["checkpoint"]["bitwise"]:
        bad.append("xlstm checkpoint round trip")
    if not line["launcher"]["ok"]:
        bad.append("launcher")
    if bad:
        raise AssertionError(f"lm_train failed ({bad}): {json.dumps(line)}")
    return line


def main() -> int:
    if sys.argv[1:2] == ["--dist-rank"]:  # a rank of the dist phase
        sys.path.insert(0, str(SRC))
        dist_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return 0
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: no src/repro_torch beside this script — run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.configs import get_arch
    from repro_torch.pipeline import build_pipeline

    dev = torch.device("cuda")
    emit(phase_build())
    cfg = get_arch(LM_ARCH)
    line, lm_rows = swa_rows(cfg, dev)
    emit(line)
    t0 = time.perf_counter()
    scenes = make_scenes(MAX_BATCH, N_PARTICLES)
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          generator=torch.Generator().manual_seed(0))
    plain = build_pipeline("fast_egnn", device=dev, params=pipe.params)
    emit({"phase": "setup", "scenes_s": time.perf_counter() - t0,
          "cfg": pipe.cfg._asdict()})
    kline, rows = phase_kernels(pipe, scenes, dev)
    emit(kline)
    emit(identity_f32_line(kline))
    widths = phase_widths(scenes[0], dev)
    emit(widths)
    widths_bf16 = phase_widths_bf16(scenes[0], dev)
    emit(widths_bf16)
    emit(bf16_edge_line(widths_bf16))
    emit(identity_fwd_line(kline, widths_bf16))
    serve = phase_serve(pipe, plain, scenes, dev)
    emit(serve)
    serve_bf16 = phase_serve_bf16(pipe, scenes, serve, dev)
    emit(serve_bf16)
    scale = phase_scale(pipe, dev, build_pipeline(
        "fast_egnn", device=dev, use_kernel=True, precision="bf16",
        params=pipe.params))
    emit(scale)
    emit(phase_simulate())
    tr, va, data_s = train_batches(dev)
    zoo = phase_zoo(scenes, tr, va, dev)
    emit(zoo)
    zoo_bf16 = phase_zoo_bf16(scenes, tr, dev)
    emit(zoo_bf16)
    train = phase_train(dev, tr, va, data_s)
    emit(train)
    train_bf16 = phase_train_bf16(dev, tr, va)
    emit(train_bf16)
    hidden32 = phase_hidden32(scenes, tr, va, dev)
    emit(hidden32)
    hidden32_bf16 = phase_hidden32_bf16(dev, tr)
    emit(hidden32_bf16)
    emit(phase_dist(dev, scale))
    emit(phase_data(dev))
    del tr, va
    for row in rows:  # forward kernels: the serve run; the rest: training
        if row["name"] in ("edge_identity", "edge_identity_bwd"):
            # SchNet's serve request and fit; RF's for the rf_form
            run = "serve" if row["name"] == "edge_identity" else "fit"
            for r, m in ((row, "schnet"), (row["rf_form"], "rf")):
                r["launches"] = zoo["models"][m][run]["launches"][row["name"]]
            continue
        row["launches"] = serve["launches"].get(row["name"],
                                                train["launches"][row["name"]])

    # the LM slice: free the FastEGNN phases' tensors first
    del pipe, plain, scenes
    torch.cuda.empty_cache()
    from repro_torch.archs.model import init_arch

    emit(phase_lm_parity(dev))
    t0 = time.perf_counter()
    params = init_arch(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    from repro_torch.training.optim import tree_leaves

    emit({"phase": "lm_setup", "arch": cfg.name,
          "init_s": time.perf_counter() - t0,
          "param_bytes": sum(t.numel() * t.element_size()
                             for t in tree_leaves(params))})
    prefill = phase_lm_prefill(params, cfg, dev)
    emit(prefill)
    line, served = phase_lm_serve(params, cfg, dev)
    emit(line)
    del params
    torch.cuda.empty_cache()
    full, decode = phase_lm_full_f32(cfg, dev, served)
    emit(full)
    emit(decode)
    # the attention family: each config, then the kernel at its new forms
    families = {}
    for aid in FAMILIES:
        line = phase_lm_family(aid, dev)
        emit(line)
        families[aid] = {"prefill": line["prefill"],
                         "parity_f32": line["parity_f32"],
                         "serve": line["serve"],
                         "decode_f32": line["parity_f32"]["decode"]["f32"]}
    line, form_rows = family_form_rows(dev, families)
    emit(line)
    # the recurrent family, then the kernel at zamba2's shared attention
    recurrent = {}
    for aid in RECURRENT:
        line = phase_lm_recurrent(aid, dev)
        emit(line)
        recurrent[aid] = {"prefill": line["prefill"],
                          "parity_f32": line.get("parity_f32")}
    line, rec_rows = family_form_rows(dev, recurrent, RECURRENT_FORMS,
                                      "lm_recurrent_kernels")
    emit(line)
    emit(phase_lm_train(dev))
    for tag in form_rows:
        form_rows[tag].update(rec_rows[tag])
    # the bf16 kernel's launches: the bf16 prefill; the f32 kernel's: the
    # f32 prefill of lm_parity_full (seed 0)
    swa_bf16, swa_f32 = lm_rows
    swa_bf16["launches"] = prefill["launches"]["swa_attention"]
    swa_f32["launches"] = full["seeds"][str(FULL_SEEDS[0])]["launches"][
        "swa_attention_f32"]
    # ... and its readings at the families' forms
    for row, tag in ((swa_bf16, "bf16"), (swa_f32, "f32")):
        row["forms"] = {
            name: dict({k: r[k] for k in ("launches", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by",
                                          "bound_3xtf32_ms", "library_ms",
                                          "device_ms") if k in r},
                       name=f"{row['name']}[{name}]", route="cuda",
                       source=row["source"], replaces=row["replaces"])
            for name, r in form_rows[tag].items()}
    rows += lm_rows
    # the hidden-32 readings: launches from the hidden32 phase's rollout
    # (forwards) and fit (backwards)
    h32_launches = {**hidden32["rollout"]["launches"],
                    **hidden32["fit"]["launches"]}
    h32_rows = {r["name"]: dict(r, launches=h32_launches.get(r["name"]))
                for r in kline["hidden32"]}
    width_rows = width_subentries(widths)
    # the bf16 mode: each FastEGNN row's reading at width 64 (its hidden32
    # entry's at 32) from widths_bf16, launches from the bf16 phases
    bf_keep = ("max_abs_err", "max_rel_l2", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms", "bound_tf32_ms", "kernels_per_call",
               "device_ms")
    at = lambda w, forms: width_subentries(
        {"cases": {w: widths_bf16["cases"][w]}}, bf_keep, forms)
    bf_rows = {w: at(w, ("edge", "identity")) for w in ("64", "32")}
    bf_rf = {w: at(w, ("edge", "identity_rf")) for w in ("64", "32")}
    # forwards: the serve run's; backwards: the fit's
    bf_launches = {**train_bf16["launches"], **serve_bf16["launches"]}
    h32b = hidden32_bf16["launches"]
    zl = {m: zoo_bf16["models"][m] for m in ("schnet", "rf")}
    bf_width_rows = width_subentries(widths_bf16, bf_keep)
    print(gpu_line(), flush=True)
    # every row: the contract's keys; the SWA rows also their global
    # layer's numbers
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "global_layer", "bound_3xtf32_ms", "kernels_per_call",
            "device_ms", "host_us")
    # the MMD pair: also its readings at Fluid113K's size; the identity
    # kernels at RF's form; the FastEGNN kernels at hidden 32 and at every
    # width of the widths phase
    for row in rows:
        name = row["name"]
        if name in h32_rows:
            row["hidden32"] = h32_rows[name]
        if name in width_rows:
            row["widths"] = width_rows[name]
            row["widths_bf16"] = bf_width_rows[name]
            for w, target in (("64", row), ("32", row.get("hidden32"))):
                if target is None:
                    continue
                entry = dict(bf_rows[w][name][w], name=name, route="cuda",
                             source=row["source"], replaces=row["replaces"])
                if name.startswith("edge_identity"):
                    # the bf16 zoo: SchNet's / RF's predict (forward) and
                    # train step (backward)
                    run = lambda m: (zl[m] if name == "edge_identity"
                                     else zl[m]["train_step"])
                    entry["launches"] = (run("schnet")["launches"][name]
                                         if w == "64" else None)
                    entry["rf_form"] = dict(
                        bf_rf[w][name][w],
                        launches=run("rf")["launches"][name]
                        if w == "64" else None)
                else:
                    entry["launches"] = (bf_launches.get(name) if w == "64"
                                         else h32b.get(name))
                target["bf16"] = entry
    subs = ("fluid113k", "rf_form", "hidden32")
    for row in rows:
        for sub in subs:
            if sub in row:
                row[sub] = {k: row[sub][k] for k in keys + ("bf16",)
                            if k in row[sub]}
    emit({"kernels": [{k: row[k] for k in keys + subs
                       + ("bf16", "widths", "widths_bf16", "forms")
                       if k in row}
                      for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
