#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mpi_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the
port's paths and checks what comes out:

* serving: the flagship decoder LM through ``generate`` (the
  flash-decode kernel);
* training: ten AdamW steps of the flagship LM at full width and depth
  through ``make_train_step`` (the flash forward and the two FA-2 backward
  kernels, kernel 2 computing delta itself), one more with ``remat`` and
  one with ``grad_accum=2``, and one float32 step with flash attention
  against dense attention;
* the device collective layer: 8 ranks on the card, as on the 8 cards of
  an HGX H100 node, all-reduce the flagship's whole gradient (float32 and
  bf16), all-gather its bf16 parameters from eighths, and hand a bf16
  activation around the ring and along a partial pattern (the single-pass
  all-reduce, ring all-gather and send/receive kernels);
* the device MPI driver: helloworld (8 ranks) and bounce (2 ranks) through
  ``run_main``, then 8 rank threads all-reduce the flagship's gradient
  through ``mpi_tpu_torch.allreduce`` on the tree route and on the ring
  route (the all-reduce kernel), and the functional layer
  (``parallel.collectives``) all-gathers the bf16 parameters and shifts an
  activation around the ring (the all-gather and send/receive kernels);
* long context: ring attention over 8 sp ranks on the card, in both
  layouts, held against one flash-attention call over the whole sequence
  of 8192; the long-context flagship (4 layers, seq 8192, remat) trained
  through ``make_train_step`` with flash, ring, zigzag and Ulysses
  attention (the flash kernels per chunk, the send/receive kernel for each
  hop); and cache-parallel decode over 8 shards of a cache of 8192 (the
  flash-decode kernel's cluster path), held against one call over the
  whole cache;
* data-parallel training: the flagship over 8 dp ranks on the card through
  ``make_train_step(cfg, mesh=...)``, plain dp (the all-reduce kernel on
  the ranks' gradient bucket), ZeRO-1 (its reduce-scatter, and the
  all-gather kernel for the parameters) and FSDP (the all-gather kernel
  before each block), held against the single-device step, against each
  other bit for bit, and against a faulty control;
* tensor-parallel training: the flagship over 8 tp ranks on the card
  (Megatron's reductions on the all-reduce kernel), held against the
  single-device step and against a faulty control, every copy the kernel
  writes bitwise the same; adafactor and sgd on the warmup-cosine schedule
  on one device and under tp 8; and a (dp 2, sp 2, tp 2) step with zigzag
  ring attention, FSDP against plain dp bit for bit; adafactor under
  ZeRO-1 and FSDP against plain dp bit for bit;
* pipeline-parallel training: the flagship over 4 pp stages of a
  ``("pp",)`` mesh on the card, 4 microbatches (the flash kernels in each
  stage, the send/receive kernel for each hop), with and without
  ``remat_stage``, and over 8 stages × 8 microbatches, held against the
  single-device step and against a faulty control;
* compiled halos: 50 Jacobi sweeps of a 16384² float32 grid over a (2, 4)
  ``("row", "col")`` mesh, Dirichlet and periodic, and of a rod of 2^28
  cells over 8 ranks (the send/receive kernel for each halo), bitwise the
  dense sweep of the whole tensor;
* Mixture of Experts: the flagship with 8 experts a block, top-2 routing,
  served through ``generate`` (the flash-decode kernel; teacher-forced
  against dense decode, int8 weights against bf16), ten AdamW steps on
  one device (the flash kernels), one float32 step with flash against
  dense attention (the routing decisions that differ counted), and three
  steps over ``("dp", "ep")`` meshes of (1, 8) and (2, 4) ranks (the
  experts' partial outputs summed on the all-reduce kernel), over
  ``("dp", "ep", "tp")`` meshes of (1, 4, 2) and (2, 2, 2) ranks (each
  expert's d_ff split over tp, the ep × tp partials summed in one launch),
  and under ZeRO-1 and FSDP on (4, 2) and (2, 2, 2) (the all-gather kernel
  too), held against the single-device step and against faulty controls,
  every copy the kernel writes bitwise the same, ZeRO-1 and FSDP bitwise
  plain dp's;
* speculative decoding: the flagship through ``generate_lookahead``
  (prompt lookup, 6 drafted tokens a verify forward, a 3-token key) on a
  repetitive and a random prompt at batch 8 and 1, which launches no
  kernel (the verify forwards and the prefill take the dense cached
  attention): bf16 tokens greedy under a teacher-forced forward, float32
  tokens equal to ``generate``'s on the flash-decode kernel but at a
  printed near-tie, an accept-all control that must fail both checks, and
  ms per token beside ``generate``'s;
* LoRA fine-tuning: rank-8 q/v adapters over the flagship's frozen base,
  ten AdamW steps (the flash kernels) and three over 8 tp ranks (the
  all-reduce kernel too), the trained merged tree served through
  ``generate`` (the flash-decode kernel; teacher-forced against dense
  decode, int8 weights): the base keeps every bit and gets no gradient,
  the merged tree's loss is the next step's, fresh adapters leave the
  forward bitwise the base's, flash against dense attention with a faulty
  control that must miss, and ms per step beside the full step's;
* the Vision Transformer: ViT-B/16 (196 patches, 12 heads of 64, 12
  layers, 1000 classes) through ``forward_vit`` on a batch of 64 images
  and ten AdamW steps through ``make_vit_train_step`` (the flash kernels'
  non-causal grid), and three steps over a (dp 2, sp 2, tp 2) rank mesh
  on the card (the all-reduce kernel for the tp reductions): the kernels
  at its shape timed (phase 1 holds them against their plain versions
  there), the bf16 logits against float32 dense, float32 logits flash
  against dense and the position symmetry, each with a causal control
  that must miss, a remat step, a float32 step flash against dense, the mesh
  against one device with a faulty control, ms per batch and per step;
* the state-space LM: the LRU LM at the width the JAX package measures it
  (vocab 8192, d_model 1024, 8 layers, d_state 256, d_ff 4096) through
  ``ssm_forward`` at batch 8, seq 1024, and greedy ``ssm_decode`` of 128
  tokens after a prompt of 128 in bf16 and float32 (no kernel: the
  recurrence is a plain doubling scan and an O(1) state a step), and
  ``ssm_forward_sp`` at seq 8192 over 8 sp ranks on the card (the
  send/receive kernel for every hop of the sharded linear scan, 7 a
  layer): kernel 7 at the scan's summary shape against its plain version,
  the sharded scan against the whole sequence's (rank 0's chunk bitwise)
  with a wrong-way control, the prefill against sequential steps, float32
  tokens greedy under a teacher-forced forward with a zeroed-state
  control, the sp forward against one device in float32 and bf16 with a
  carry-dropped control, ms per token and per forward;
* the state-space LM trained: ten bf16 AdamW steps through
  ``make_ssm_train_step`` at the same width, batch 8, seq 1024 (no
  kernel), and three over 8 dp ranks on the card (the all-reduce kernel on
  the (8, 92,321,792) float32 gradient bucket, once a step): the kernel at
  that bucket bitwise its plain version and timed, dp against one device
  in float32 and bf16 with a faulty control (rank 0's gradient alone), ms
  a step, tokens/s and MFU, a profiled step of each, and the trained tree
  decoded;
* the trainer's I/O: a seeded 64 MiB uint16 corpus, the flagship
  trained from it through ``train.main --corpus`` for six steps with an
  async checkpoint every three (``data.py``'s loader and native gather,
  ``utils/checkpoint.py``), on one device and over 8 dp ranks under FSDP
  (the flash kernels, and the all-gather and all-reduce kernels), then
  resumed from step 3 with ``--resume`` into a state drawn from another
  seed: its losses equal the uninterrupted run's within the gap between
  two uninterrupted runs (bitwise when the card repeats a run), and two
  controls (the optimizer's state dropped, the stream restarted at step
  0) miss; each save's cost to the step loop and its write time, the
  checkpoint's bytes against the state's, the gather's time per batch,
  ms/step from the corpus against the synthetic stream, and
  ``torch.sum`` at the tp and ep partial shapes;

then times the paths and the kernels, and prints:

* a ``{"kernels": [...]}`` line: for each kernel its route, source, the TPU
  kernel it replaces, its launches on its path (kernels 5-7: in the
  driver's phase; kernels 1-4 and 7 also ``long_context_launches``, on the
  long-context phase; every kernel ``sharded_launches``, on the
  data-parallel phase, ``tp_launches``, on the tensor-parallel phase,
  ``pipeline_launches``, on the pipeline phase, ``halo_launches``, on
  the halo phase, ``moe_launches``, on the Mixture-of-Experts phase, and
  ``speculative_launches``, on the speculative phase,
  ``lora_launches``, on the LoRA phase, ``vit_launches``, on the ViT
  phase, ``ssm_launches``, on the state-space phase, and
  ``ssm_train_launches``, on the state-space training phase, and
  ``io_launches``, on the trainer's I/O phase, checked against the count
  worked out from the code),
  its largest error against the plain version, and
  its time beside its bound, the plain version's time and one PyTorch
  library call's time;
* the card's name and power limit as ``nvidia-smi`` gives them;
* as the last line ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero and prints no result.
It also exits non-zero when no CUDA device is available. It imports neither
JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense) for the bound of each kernel.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}

# Decode kernel against plain version. float32: summation order only.
# bfloat16: p is rounded to bf16 at each key group's running max in the
# kernel and at the global max in the plain version, and the output is
# rounded to bf16 (one ulp is 2**-8 relative), so out gets a bf16-sized
# tolerance; lse is float32 in both and differs by summation order.
KERNEL_TOL = {
    "torch.float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5)},
    "torch.bfloat16": {"out": (2e-2, 1e-2), "lse": (1e-3, 1e-5)},
}
# Flash kernels against plain versions, (atol, rtol). float32: the kernels
# sum in another order than cuBLAS; out and lse get 1e-5, the gradients,
# sums over up to 1024 rows, 1e-4. bfloat16: the forward kernel rounds p
# to bf16 at each key tile's running max where the plain version rounds it
# at the row's global max, and every output is bf16, so out and the
# gradients get 2e-2; lse is float32 in both and gets 1e-3.
FLASH_TOL = {
    "torch.float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                      "grad": (1e-4, 1e-4)},
    "torch.bfloat16": {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-3),
                       "grad": (2e-2, 2e-2)},
}
# delta = rowsum(dout * out), computed by kernel 2 in float32 from the
# stored values as the plain version does: summation order only.
DELTA_TOL = (1e-5, 1e-5)
# The bf16 kernels on wgmma: each must hold HGMMA in its SASS, and ptxas
# must give the two backward kernels no spill.
WGMMA_KERNELS = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                 "flash_bwd_dkv_wgmma_kernel")
# Teacher-forced decode, flash against dense, float32 logits after 8
# layers: both are float32 end to end and differ by summation order.
SLICE_LOGITS_ATOL = 1e-3
SLICE_LOGITS_RTOL = 1e-3
# One float32 training step at flagship width and depth, flash attention
# against dense: summation order only, compounded through 8 layers and
# their backward. The loss gets rtol 1e-5; each gradient leaf may differ
# by at most 1e-3 of its largest element.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-3
# remat recomputes the same forward: the loss of its first step must equal
# the plain step's to rounding.
REMAT_LOSS_RTOL = 1e-5
# Collective kernels against their plain versions: tolerance 0. The
# all-gather and send/receive kernels take the plain versions' hops in the
# same order; the all-reduce kernel is one pass that folds in the ring's
# order, rounded at each fold, as the plain version's hops do. The float32
# all-reduce against contribs.sum(0): each is a sum of the n contributions
# in some order, within (n - 1) u sum|x_i| of the exact sum (u = 2**-24),
# so they differ by at most 2 (n - 1) u sum|x_i|; the check allows
# 2 n u sum|x_i| for the second-order terms.
RING_RANKS = 8
RING_SUM_TOL_U = 2 * RING_RANKS

# About 100 ms of GPU clock cycles: longer than the host takes to enqueue
# one timed run of launches (checked: the run fails if it is not). Each
# timed run stays under ~1000 launches, CUDA's queue of pending launches,
# past which the host would wait for the sleeping stream.
SLEEP_CYCLES = 200_000_000

# Long context. Ring attention against one whole-sequence flash call:
# float32 differs by summation order only (the forward 1e-5; the
# gradients, sums over up to 8192 rows, 1e-4, as FLASH_TOL); bf16 gets
# FLASH_TOL's bf16 tolerances (2e-2): the ring casts a float32 merge of
# bf16 chunk outputs and gradients once, the whole call rounds p at each
# key tile. The first- and second-step losses of the four impls, bf16
# activations: each rounds attention at other points, and they differed
# from flash's by at most 1.6e-5 relative (NVIDIA H100 80GB HBM3, 700 W);
# two faulty rings (each merge keeping the newest chunk; the causal skip
# off) moved the first by 4.8e-4 and 8.6e-4 and the second by 3.5e-2 and
# 3.5e-3. LONG_LOSS_RTOL sits between them, and the phase checks that
# the controls still fall outside it.
LONG_SEQ = 8192
LONG_LAYERS = 4
LONG_SP = 8
LONG_TOL = {
    "torch.float32": {"out": (1e-5, 1e-5), "grad": (1e-4, 1e-4)},
    "torch.bfloat16": {"out": (2e-2, 2e-2), "grad": (2e-2, 2e-2)},
}
LONG_LOSS_RTOL = 1e-4
LONG_STEPS = 5
LONG_IMPLS = ("flash", "ring_flash", "zigzag_flash", "ulysses_flash")
CACHE_SHARDS = 8

# Data-parallel training (phase 9): the flagship over 8 dp ranks on the
# card, plain dp, ZeRO-1 and FSDP against the single-device step and
# against each other, from one seeded state and batch.
DP_RANKS = 8
DP_STEPS = 3
DP_TIMED_STEPS = 3
# Plain dp against the single-device step. Each dp rank runs its own row of
# the batch, so cuBLAS and the flash kernels see batch 1 where the single
# step sees 8 and bf16 rounds elsewhere, and the ranks' mean loss and the
# ring's fold order differ from the whole batch's mean. Measured (NVIDIA
# H100 80GB HBM3, 700 W): relative loss gaps 0, 2.6e-6, 4.4e-6 over the
# three steps; the faulty control (rank 0's gradient alone) missed plain
# dp's step-2 loss by 2.8e-2. DP_LOSS_RTOL sits between them: 23 times the
# sound gap, 276 times under the control's miss.
DP_LOSS_RTOL = 1e-4
# ||p_dp - p_one|| / ||p_one - p_0|| over every leaf after DP_STEPS steps:
# the parameters' gap relative to how far the steps moved them. AdamW's
# first update is about lr·sign(g), so a bf16 rounding flip of a small
# gradient's sign moves its element by 2 lr. Measured (same card): 0.018
# sound, 1.23 for the control. DP_PARAM_REL sits between them.
DP_PARAM_REL = 1e-1
# Tensor-parallel training (phase 10): the flagship over 8 tp ranks of a
# ("tp",) mesh on the card (one head, 512 of d_ff and 1024 of vocab a
# rank) against the single-device step of phase 9, from the same seeded
# state and batch, TP_STEPS steps each.
TP_RANKS = 8
TP_STEPS = 3
TP_TIMED_STEPS = 3
# tp 8 against one device: the loss gap relative to one device's loss,
# and the parameters' gap ||p_tp - p_one|| / ||p_one - p_0|| as in
# DP_PARAM_REL. Each tp rank's product is rounded to bf16 before the
# float32 sum where one device rounds the whole product once, and AdamW's
# first update is about lr·sign(g). Measured (NVIDIA H100 80GB HBM3, 700
# W): loss gaps 1.2e-5 to 2.0e-5 (AdamW), up to 2.7e-5 (adafactor and sgd
# at rate 1e-2), parameter gaps 0.071 (AdamW), 0.041, 0.0077; the faulty
# control (each tp reduction keeping rank 0's partial alone) missed by
# 0.22 to 0.31 in the loss and 1.41 in the parameters. Each tolerance sits
# between them (TP_LOSS_RTOL 37 times the largest sound gap and 220 times
# under the control's least; TP_PARAM_REL 4.2 times and 4.7 times), and
# the phase checks that the control still falls outside both.
TP_LOSS_RTOL = 1e-3
TP_PARAM_REL = 3e-1
# The rate of (d)'s adafactor and sgd runs, examples/train.py's.
TP_OPT_LR = 1e-2
# The composition step: 2 layers, seq 2048, batch 4, zigzag_flash over a
# (dp 2, sp 2, tp 2) mesh, fsdp against plain dp.
COMPOSE = dict(layers=2, seq=2048, batch=4, steps=2)
# Pipeline-parallel training (phase 11): the flagship over PP_STAGES pp
# ranks of a ("pp",) mesh on the card (2 layers a stage), PP_MICRO
# microbatches of 2 rows (the JAX package's default count), against phase
# 9's single-device step from the same seeded state and batch.
PP_STAGES = 4
PP_MICRO = 4
PP_STEPS = 3
PP_TIMED_STEPS = 3
# pp 4 against one device: the loss gap relative to one device's loss,
# and the parameters' gap ||p_pp - p_one|| / ||p_one - p_0|| as in
# DP_PARAM_REL. A stage runs 2 rows through cuBLAS and the flash kernels
# where one device runs 8, so bf16 rounds at other points, and AdamW's
# first update is about lr·sign(g): the causes of plain dp's gaps, so the
# same values, set before the first run on the card. Measured (NVIDIA
# H100 80GB HBM3, 700 W): loss gaps 0, 2.3e-6, 1.0e-5 and a parameter gap
# of 0.0183 (remat_stage the same bits; pp 8 x 8's first loss exact); the
# faulty control (a stage one step late) missed by 1.4e-2 to 4.1e-2 in the
# loss and 1.25 in the parameters. PP_LOSS_RTOL sits 10 times over the
# largest sound gap and 138 times under the control's least, PP_PARAM_REL
# 5.5 times over and 12 times under, and the phase checks that the
# control still falls outside both.
PP_LOSS_RTOL = 1e-4
PP_PARAM_REL = 1e-1
# Compiled halos (phase 12): a HALO_GRID² float32 grid over (2, 4) ranks
# and a rod of HALO_ROD float32 cells over 8, 1 GiB each, HALO_SWEEPS
# Jacobi sweeps, held bit for bit against the dense sweep.
HALO_GRID = 16384
HALO_ROD = 2 ** 28
HALO_SWEEPS = 50

# The Mixture-of-Experts flagship (phase 13): the flagship with
# MOE_EXPERTS experts a block, top-MOE_TOP_K routing, capacity factor
# MOE_CAPACITY; expert parallelism over (dp, ep) meshes of MOE_EP_MESHES
# ranks on the card, MOE_EP_STEPS steps each, against the single-device
# step from the same seeded state and batch.
MOE_EXPERTS = 8
MOE_TOP_K = 2
MOE_CAPACITY = 1.25
MOE_EP_MESHES = ((1, 8), (2, 4))
MOE_EP_STEPS = 3
# (d): each expert's d_ff over tp beside ep, ("dp", "ep", "tp") meshes;
# (e): ZeRO-1 and FSDP with experts, (mesh, mode) over ("dp", "ep"[, "tp"]):
# (4, 2) is the JAX package's own fsdp mesh for the MoE
# (tests/test_models.py:479-494), where every leaf of the flagship has a
# dimension divisible by 4, so zero1 and fsdp must give plain dp's bits.
MOE_TP_MESHES = ((1, 4, 2), (2, 2, 2))
MOE_ZERO_RUNS = (((4, 2), "dp"), ((4, 2), "zero1"), ((4, 2), "fsdp"),
                 ((2, 2, 2), "fsdp"))
# ep against one device: the loss gap relative to one device's loss, and
# the parameters' gap ||p_ep - p_one|| / ||p_one - p_0|| as in
# DP_PARAM_REL. Each ep rank's experts' output is rounded to bf16 before
# the float32 sum over the ranks where one device rounds the combine
# once, the (2, 4) ranks run 4 rows through cuBLAS and the flash kernels
# where one device runs 8, a bf16 rounding difference near a tie flips a
# token's expert, and AdamW's first update is about lr·sign(g) on 537 M
# expert weights. Measured (NVIDIA H100 80GB HBM3, 700.00 W): loss gaps
# 2.7e-5 to 4.9e-4 and parameter gaps 0.294 (1, 8) and 0.289 (2, 4); the
# faulty control (the experts' partial outputs reduced to rank 0's alone)
# missed by 1.7e-3, 1.2e-2, 3.5e-2 in the loss and 1.22 in the
# parameters. Each tolerance sits about halfway between on a log scale
# (EP_LOSS_RTOL 2.1 times the largest sound gap of (c) and 1.7 times under
# the control's least; EP_PARAM_REL 2.0 times over and 2.0 times under),
# and the phase checks that the control still falls outside both. (d) and
# (e) are held to the same two limits, each with a faulty control of its
# own (tp coordinate 0's partials alone, 1.89e-3 to 6.4e-3 and 1.149;
# rank 0's gradient alone in the reduce-scatter, 7.0e-3 and 5.0e-2 after
# the first loss, 1.130) that must fall outside them. Their sound gaps
# (same card): the first loss, from the same parameters, 3.0e-5 to 5.3e-5
# with 1335-2659 of 131,072 routing choices flipped (twice as many where
# tp splits each expert's output into two bf16 partials; (4, 2)'s 1337 as
# (c)'s); the third 1.1e-4 to 9.8e-4 and the parameters 0.292 to 0.355,
# the divergence of two sign-like AdamW updates, in no order of dp or
# flips ((2, 2, 2), the most flips, 1.1e-4; (1, 4, 2), dp 1, 8.5e-4; (4,
# 2) 9.8e-4). EP_LOSS_RTOL sits 1.02 times over that (4, 2) gap and 1.9
# times under (d)'s control; EP_PARAM_REL 1.7 times over and 1.9 under.
EP_LOSS_RTOL = 1e-3
EP_PARAM_REL = 6e-1
# One float32 step of the MoE flagship, flash against dense attention:
# summation order, as TRAIN_LOSS_RTOL, plus any routing decision a
# rounding difference flips near a tie or at a full buffer's last slot.
# Measured (same card): a gap of 9.9e-8 with no decision of 131,072
# changed; 1e-4 leaves room for a few flips.
MOE_F32_LOSS_RTOL = 1e-4

# Speculative decoding (phase 14): generate_lookahead at the flagship's
# widths and depth on a config of its own whose max_seq holds the draft's
# overhang (phase 5's cfg keeps 256: kernel 4's reported row is read at
# its n_valid 255), with serve.py's defaults: SPEC_DRAFT_LEN drafted tokens
# verified a forward, an SPEC_NGRAM-token lookup key. Prompts from a seed:
# each row an SPEC_PHRASE-token phrase tiled to PROMPT_LEN (as
# examples/serve.py builds its prompt), and uniformly random rows.
SPEC_DRAFT_LEN = 6
SPEC_NGRAM = 3
SPEC_PHRASE = 8
SPEC_REPEATS = 3
# float32, TF32 off: generate (kernel 4 on each one-query step) and the
# speculative path (dense attention over m + 1 queries) differ by summation
# order alone, so their tokens are equal unless two logits sit within
# rounding of each other. A first divergence passes only where one
# teacher-forced float32 dense forward of the shared prefix puts both
# diverging tokens within SPEC_FP32_TIE of the row's largest logit:
# SLICE_LOGITS_ATOL, the float32 logit gap phase 3 allows between kernel 4
# and dense decode.
SPEC_FP32_TIE = 1e-3
# bf16: every token of both outputs, the speculative path's and
# generate's, must be greedy under one teacher-forced bf16 dense forward of
# prompt + output: its logit within SPEC_BF16_TIE of its row's largest.
# The three paths round activations to bf16 at other points (one query, m +
# 1 queries over a cache, the whole sequence at once) through 8 layers,
# and the logits, about N(0, 1) over 8192 tokens (a largest near 3.8),
# are bf16 (one ulp is 2**-6 between 2 and 4).
SPEC_BF16_TIE = 0.25

# LoRA fine-tuning (phase 15): rank-LORA_RANK adapters on wq and wv,
# alpha LORA_ALPHA, AdamW at LORA_LR (examples/train.py --lora's rate)
# over the flagship training configuration's frozen base, from one seeded
# base, one seeded set of adapters and one seeded batch.
LORA_RANK = 8
LORA_ALPHA = 16.0
LORA_LR = 1e-2
LORA_STEPS = 10
LORA_TP_STEPS = 3
LORA_TIMED_STEPS = 5
LORA_REPEATS = 3
# The merged tree's loss against the next step's, which merges the same
# adapters inside the step: tests/test_lora.py's rel 1e-5 (the same
# products on the same inputs; 0 expected).
LORA_MERGE_RTOL = 1e-5
# LoRA steps with the flash kernels against the same steps with dense
# attention, bf16 activations, over the first LORA_DENSE_STEPS of (b)'s
# steps: the two round attention at other points, and AdamW at 1e-2 turns
# a flipped sign of a tiny adapter gradient into a 2e-2 move, so the two
# trajectories part as they go. Measured (NVIDIA H100 80GB HBM3, 700.00
# W): relative gaps 4.1e-6, 3.4e-6, 3.1e-5 over steps 0-2, growing to
# 8.5e-5 by step 4 and 1.2e-2 by step 9; the faulty control (each delta
# scaled by rank / alpha, a quarter of alpha / rank's at rank 8, alpha 16;
# step 0 equal by construction, B = 0) missed dense by 1.4e-2 and 4.9e-3
# at steps 1-2 and by 1.5e-3 to 1.8e-2 over steps 1-9. So ten steps cannot
# tell the control from rounding, and three can: LORA_LOSS_RTOL sits 13
# times over the largest sound gap of steps 0-2 and 12 times under the
# control's least of steps 1-2, and the phase checks that the control
# still falls outside it. That the parting is rounding and not a kernel
# fault, (d)'s float32 witness shows (TF32 off, the same LORA_STEPS steps
# at LORA_LR): flash against dense within TRAIN_LOSS_RTOL at every step
# (measured: 2.8e-6 at most, the control 1.2e-3 at least from step 1),
# and the adapter gradients at the tenth step's adapters, which hold the
# size of kernels 2-3's gradients, within TRAIN_GRAD_REL of each leaf's
# largest (measured 1.4e-5, the control's 1.2).
LORA_DENSE_STEPS = 3
LORA_LOSS_RTOL = 4e-4

# The Vision Transformer (phase 16): ViT-B/16 as Dosovitskiy et al. 2020
# publish it (Table 1, "ViT-Base"): 224 x 224 x 3 images in patches of 16
# (196 patches), d_model 768, 12 heads of 64, 12 layers, d_ff 3072, 1000
# classes, nothing cut; the repo's ViT mean-pools the patches (no class
# token). bf16 over float32 masters, flash attention, AdamW at VIT_LR
# (make_vit_train_step's default), one seeded batch of VIT_BATCH images.
VIT = dict(image_size=224, patch_size=16, channels=3, n_classes=1000,
           d_model=768, n_heads=12, n_layers=12, d_ff=3072)
VIT_BATCH = 64
VIT_LR = 1e-3
VIT_STEPS = 10
VIT_MESH_STEPS = 3
VIT_TIMED = 5
VIT_REPEATS = 3
# Float32 logits (TF32 off), flash against dense attention: both float32
# end to end, they differ by summation order over 12 layers; the causal
# control differs in what it computes. The position symmetry (zeroed
# position table, patch rows permuted): tests/test_vit.py's tolerance, the
# permutation moving only the summation order of attention and the pool.
VIT_LOGITS_TOL = (1e-4, 1e-4)
VIT_SYMMETRY_TOL = (1e-5, 1e-4)
# The main path's bf16 flash logits against float32 dense: bf16 rounds
# every activation (8 bits of mantissa) through 12 layers. Measured
# (NVIDIA H100 80GB HBM3, 700.00 W): max |diff| 0.0201 on logits of
# |max| 2.77; the float32 causal control 1.96. The limit sits 5 times
# over the sound gap and 20 times under the control's.
VIT_BF16_LOGITS_ATOL = 0.1
# The (dp 2, sp 2, tp 2) mesh's three steps against one device's: bf16
# activations rounded at other points (the tp partials summed in float32,
# then rounded once) part the two, and AdamW grows the parting. Measured
# (NVIDIA H100 80GB HBM3, 700.00 W): relative loss gaps 3.3e-5, 6.0e-5,
# 1.09e-4 over steps 0-2, parameter gap 0.058; the faulty control (rank
# 0's partials for each sum) 1.57e-2, 2.19e-3, 3.05e-2 and 1.23. Each limit
# sits between the two, 3.7 and 5.2 times over the sound gaps and 5.5 and
# 4.1 times under the control's least (phase 10's TP_LOSS_RTOL, 1e-3,
# would sit 2.2 times under it).
VIT_MESH_LOSS_RTOL = 4e-4
VIT_MESH_PARAM_REL = 0.3

# The state-space LM (phase 17) at the width the JAX package measures it
# (bench.py:476-497 measure_ssm): vocab 8192, d_model 1024, 8 layers,
# d_state 256, d_ff 4096, batch 8, seq 1024, a prompt of 128 and 128 new
# tokens; bf16 compute (measure_ssm's choice on the TPU) over float32
# masters, the recurrence in complex64. The sp path at the long-context
# phase's seq 8192 over 8 sp ranks, batch 8. Nothing cut.
SSM = dict(vocab=8192, d_model=1024, n_layers=8, d_state=256, d_ff=4096)
SSM_SEQ = 1024
SSM_SP = 8
SSM_SP_SEQ = 8192
SSM_REPEATS = 3
# The sharded scan at (8, 8192, 256) complex64, |a| in [0.4, 0.99), against
# the whole sequence's doubling scan: the chunk scans and the carry fold
# combine in another tree than the whole scan's 13 rounds, so float32
# rounding parts them by ulps of |x|; rank 0's chunk is the local scan bit
# for bit. Measured (NVIDIA H100 80GB HBM3, 700.00 W): 9.5e-7 on |x| up to
# 10.1; the wrong-way control 8.68.
SSM_SCAN_TOL = (1e-4, 1e-4)
# Float32 (TF32 off): the sp forward against one device, and sequential
# steps against the scan (states, last logits): tests/test_ssm.py's 3e-3
# and 2e-3; a decoded token within SSM_FP32_TIE of its teacher-forced
# row's largest logit (a near-tie printed when it is not the argmax).
SSM_SP_TOL = (3e-3, 3e-3)
SSM_STEP_TOL = (2e-3, 2e-3)
SSM_FP32_TIE = 2e-3
# bf16: the recurrence's float32 rounding flips a bf16 rounding of y here
# and there, and the flips travel through 8 layers. Relative L2 gap
# ||got - want|| / ||want|| of the logits (and of the states), bf16's own
# scale (one bf16 step is 2**-8 relative). Measured (NVIDIA H100 80GB
# HBM3, 700.00 W): prefill against steps 7.7e-3 (states), 8.7e-3 (logits);
# sp against one device 7.4e-3, the carry-dropped control 8.2e-2: the
# limit sits 2.7 times over the sound gap and 4.1 times under the
# control's (float32: 9.8e-6 against the control's 4.78).
SSM_BF16_STEP_REL = 2e-2
SSM_BF16_SP_REL = 2e-2

# The state-space LM trained (phase 18) at SSM's width and measure_ssm's
# batch and seq (bench.py:476-557): tokens (BATCH, SSM_SEQ + 1) from numpy's
# default_rng(0), as measure_ssm draws them, AdamW at make_ssm_train_step's
# 1e-3, bf16 compute over float32 masters (the recurrence in complex64);
# the dp step over SSM_DP ranks on the card, the same batch, its
# (8, 92,321,792) float32 gradient bucket summed by one kernel-6 launch.
# Nothing cut.
SSM_TRAIN_STEPS = 10
SSM_DP = 8
SSM_DP_STEPS = 3
SSM_TIMED_STEPS = 2
SSM_TRAIN_REPEATS = 3
# dp 8 against one device over SSM_DP_STEPS steps from the same parameters:
# the largest relative loss gap and the parameters' gap ||p_dp - p_one|| /
# ||p_one - p_0||. The ranks' gradients are summed in the ring's order
# where one device sums the batch in one mean, and each rank's products
# run on 1024 tokens where one device's run on 8192, so the last bits
# differ; AdamW's first update is about lr · sign(g), so a tiny gradient
# element that rounds to the other sign moves 2 lr the other way, and the
# parameters' gap carries that: the losses weigh more. Measured (NVIDIA
# H100 80GB HBM3, 700.00 W): float32 3.3e-7 and 5.5e-5, bf16 2.1e-4 and
# 0.054; the control (rank 0's gradient alone) 0.157 on the second loss
# and 1.21 in both. Each limit sits 10-30 times over its sound gap and
# 78-15700 times under the control's (the bf16 parameter limit 3.7 times
# over and 6 times under).
SSM_DP_LOSS_RTOL = {"float32": 1e-5, "bf16": 2e-3}
SSM_DP_PARAM_REL = {"float32": 1e-3, "bf16": 0.2}

# Phase 19, the trainer's I/O: the flagship trained through train.main from
# a seeded corpus of IO_CORPUS_TOKENS uint16 ids (64 MiB) for IO_STEPS
# steps, an async checkpoint every IO_EVERY steps, on one device and over
# IO_DP dp ranks under FSDP; then resumed from step IO_EVERY. The resumed
# losses must equal the uninterrupted run's within the gap between two
# uninterrupted runs, measured in the same call: 0.0 (bitwise) when the
# card repeats a run bit for bit, as the port's kernels and cuBLAS at
# fixed shapes do. The gather is timed over IO_GATHER_BATCHES batches.
IO_CORPUS_TOKENS = 32 * 2 ** 20
IO_STEPS = 6
IO_EVERY = 3
IO_DP = 8
IO_GATHER_BATCHES = 50
# (8, 8,388,608) and (4, 4,194,304) float32: the tp and ep partials that
# kernel 6 sums in phases 10 and 13 (PERF.md's row 6 has its times there).
PARTIAL_SHAPES = ((8, 8388608), (4, 4194304))

N_REQUESTS = 3
BATCH = 8
PROMPT_LEN = 128
NEW_TOKENS = 128
TRAIN_STEPS = 10


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def sass_counts(lib, opcode: str) -> dict:
    """{function: lines that hold ``opcode``} over the ``Function :``
    sections of ``cuobjdump -sass`` of the built library ``lib``."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


def ptxas_report(log: str) -> dict:
    """{entry function: (registers, spill store bytes, spill load bytes)}
    from nvcc's ``-Xptxas -v`` output."""
    import re

    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = [None, 0, 0]
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def named(report: dict, kernel: str) -> dict:
    """The entries of ``report`` whose (mangled) name holds ``kernel``."""
    return {k: v for k, v in report.items() if kernel in k}


def kernel_ms(fn, sets, reps):
    """Device ms per call of ``fn`` over ``reps`` calls, cycling ``sets``
    of arguments, after a warm-up, with CUDA events."""
    import torch

    for args in sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # Hold the stream busy while the host enqueues the launches, so the
    # events time the launches back to back on the card and not the
    # Python that issues them.
    sleep = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t_host = time.perf_counter()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    t_host = (time.perf_counter() - t_host) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(sleep.elapsed_time(start) > t_host,
          f"host enqueue ({t_host} ms) outlasted the busy stream "
          f"({sleep.elapsed_time(start)} ms): the timing would be the "
          f"host's")
    return start.elapsed_time(end) / reps


def call_ms(fn, args, reps):
    """Median device ms of single calls of ``fn(*args)``, each between two
    CUDA events, after a warm-up: for a call that waits for the device
    inside it, which kernel_ms's busy stream cannot hold."""
    import statistics

    import torch

    fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes, n_ops, dtype):
    """(bound ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate for ``dtype``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_work(b, s, t, h, hk, d, elt, causal):
    """{kernel: (bytes, operations)} that kernels 1-3 need for these
    inputs: each input read once and each output written once (kernel 2
    also reads out and writes delta, which it computes); 2 d operations
    per product for every (query, key) pair the mask keeps."""
    pairs = sum(min(r + 1, t) for r in range(s)) if causal else s * t
    product = 2 * d * pairs * b * h
    q_bytes = b * s * h * d * elt
    kv_bytes = b * t * hk * d * elt
    rows = 4 * b * h * s  # one float32 row vector (lse or delta)
    return {
        "flash_fwd": (2 * q_bytes + 2 * kv_bytes + rows, 2 * product),
        "flash_bwd_dq": (4 * q_bytes + 2 * kv_bytes + 2 * rows,
                         3 * product),
        "flash_bwd_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * rows,
                          4 * product),
    }


# Phase 1's shapes of kernels 1-3, (b, s, t, h, hk, d, causal).
FLASH_SHAPES = [
    (8, 1024, 1024, 8, 8, 128, True),   # flagship
    (8, 1024, 1024, 8, 2, 128, True),   # GQA, kv 2
    (8, 1024, 1024, 8, 1, 128, True),   # MQA, kv 1
    (8, 1024, 1024, 8, 8, 128, False),  # non-causal
    (4, 1000, 1000, 8, 8, 128, True),   # no multiple of any tile
    (4, 512, 512, 16, 4, 64, True),     # head_dim 64
    (4, 512, 768, 8, 2, 128, False),    # s != t: a ring chunk
    # The long-context chunks (phase 8: seq 8192 over 8 sp ranks, the
    # ranks of a range folded into the batch): zigzag's past case (s > t),
    # its future case (s < t) and its causal self blocks.
    (8, 1024, 512, 8, 8, 128, False),
    (8, 512, 1024, 8, 8, 128, False),
    (8, 512, 512, 8, 8, 128, True),
    # The data-parallel chunks (phase 9): each of 8 dp ranks runs its own
    # row of the flagship batch; the composition step's zigzag over sp 2
    # at seq 2048, 2 rows a dp rank (1 or 2 chunks folded into the batch).
    (1, 1024, 1024, 8, 8, 128, True),
    (2, 1024, 512, 8, 8, 128, False),
    (2, 512, 1024, 8, 8, 128, False),
    (4, 512, 512, 8, 8, 128, False),
    (4, 512, 512, 8, 8, 128, True),
    (8193, 64, 64, 8, 8, 64, True),     # b * h = 65544 > grid y's 65535
]
# ViT-B/16's attention (phase 16): 196 patches, 12 heads of 64, non-causal,
# batch 64. The last query tile holds 68 of kernel 1's 128 rows and 4 of
# the backward's 64.
VIT_FLASH_SHAPE = (64, 196, 196, 12, 12, 64, False)


def check_flash_kernels(dev, gen, shapes=(*FLASH_SHAPES, VIT_FLASH_SHAPE)):
    """Kernels 1-3 against their plain versions on the card at each of
    ``shapes``, kernel 2 both computing delta itself (the flagship's
    backward) and with delta given (the ring's backward). Returns the
    largest |kernel - plain| of each kernel over every case, and the same
    for each shape: ({kernel: err}, {shape: {kernel: err}})."""
    import torch

    from mpi_tpu_torch.ops.attention import (_delta,
                                             flash_attention_bwd_plain,
                                             flash_attention_fwd_plain,
                                             flash_bwd_dq,
                                             flash_bwd_dq_delta,
                                             flash_chunk_bwd, flash_fwd)

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    by_shape = {shape: dict.fromkeys(worst, 0.0) for shape in shapes}
    worst_delta = 0.0
    n_cmp = 0
    for shape in shapes:
        b, s, t, h, hk, d, causal = shape
        for dtype in (torch.float32, torch.bfloat16):
            tol = FLASH_TOL[str(dtype)]
            q, g = (torch.randn(b, s, h, d, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            k, v = (torch.randn(b, t, hk, d, generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            where = (f"b={b} s={s} t={t} h={h} hk={hk} d={d} "
                     f"causal={causal} {dtype}")
            out, lse = flash_fwd(q, k, v, causal)
            ref, ref_lse = flash_attention_fwd_plain(q, k, v, causal)
            # Both backward sides take the plain forward's rows.
            got = flash_chunk_bwd(q, k, v, ref, ref_lse, g, causal)
            want = flash_attention_bwd_plain(q, k, v, ref, ref_lse, g,
                                             causal)
            # Kernel 2 again, for its delta: within DELTA_TOL of the plain
            # rowsum, and dq bitwise the first call's (no atomics).
            dq2, delta = flash_bwd_dq_delta(q, k, v, g, ref_lse, ref, causal)
            want_delta = _delta(ref, g)
            # Kernel 2 with delta given, as the ring's backward calls it.
            dq3 = flash_bwd_dq(q, k, v, g, ref_lse, want_delta, causal)
            torch.cuda.synchronize()
            check(torch.equal(dq2, got[0]),
                  f"kernel 2 gave two dq at {where}")
            check(torch.allclose(delta, want_delta, atol=DELTA_TOL[0],
                                 rtol=DELTA_TOL[1]),
                  f"kernel 2 delta differs from plain by "
                  f"{(delta - want_delta).abs().max().item()} at {where}")
            worst_delta = max(worst_delta,
                              (delta - want_delta).abs().max().item())
            pairs = [("out", "flash_fwd", out, ref, tol["out"]),
                     ("lse", None, lse, ref_lse, tol["lse"]),
                     ("dq", "flash_bwd_dq", got[0], want[0], tol["grad"]),
                     ("dq, delta given", "flash_bwd_dq", dq3, want[0],
                      tol["grad"]),
                     ("dk", "flash_bwd_dkv", got[1], want[1], tol["grad"]),
                     ("dv", "flash_bwd_dkv", got[2], want[2], tol["grad"])]
            for name, kernel, x, w, (atol, rtol) in pairs:
                check(x.dtype == w.dtype and x.shape == w.shape,
                      f"{name} {x.dtype} {tuple(x.shape)} at {where}")
                err = (x.float() - w.float()).abs().max().item()
                check(torch.allclose(x.float(), w.float(), atol=atol,
                                     rtol=rtol),
                      f"flash kernel {name} differs from plain by {err} at "
                      f"{where}")
                if kernel:
                    worst[kernel] = max(worst[kernel], err)
                    by_shape[shape][kernel] = max(by_shape[shape][kernel],
                                                  err)
            n_cmp += 1
            del q, g, k, v, out, lse, ref, ref_lse, got, want, dq2, dq3
            del delta
    print(f"flash kernels vs plain: {n_cmp} cases (out, lse, dq, dq with "
          f"delta given, dk, dv, delta each; dq bitwise equal over two "
          f"calls) pass; max |err| "
          f"{worst}, delta {worst_delta!r} (tolerances {FLASH_TOL}, delta "
          f"{DELTA_TOL})")
    return worst, by_shape


def train_slice(dev):
    """Ten AdamW steps of the flagship at full width and depth on one
    fixed batch, then one step with remat and one with grad_accum=2.
    Returns (launches of each flash kernel over the ten steps, ms per
    step after the first)."""
    import numpy as np
    import torch

    from mpi_tpu_torch.models import make_train_step
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.train import flagship_train_config

    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    cfg = flagship_train_config()
    batch, seq = 8, cfg.max_seq - 1
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, seq + 1))).to(dev)
    init_state, step = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    check(all(x.device.type == "cuda" and x.dtype == torch.float32
              for x in state["opt"].param_groups[0]["params"]),
          "train state is not float32 masters on the card")

    for w in kernels:
        w.launches = 0
    losses = []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for i in range(TRAIN_STEPS):
        before = [w.launches for w in kernels]
        state, loss = step(state, tokens)
        got = [w.launches - c for w, c in zip(kernels, before)]
        check(got == [cfg.n_layers] * 3,
              f"step {i}: flash kernels 1, 2, 3 launched {got} times, want "
              f"{cfg.n_layers} each")
        losses.append(loss)
        if i == 0:
            start.record()  # the first step is the warm-up
    end.record()
    torch.cuda.synchronize()
    launches = [w.launches for w in kernels]
    ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    print(f"trained {TRAIN_STEPS} steps at batch {batch} x seq {seq}, "
          f"{cfg.n_layers} layers: losses {losses}; flash kernel launches "
          f"{launches} = {TRAIN_STEPS} steps x {cfg.n_layers} layers")
    del state

    # remat: the same first step from the same seeded state, with kernel 1
    # run again for each layer in the backward.
    _, rstep = make_train_step(flagship_train_config(remat=True))
    rstate = init_state(torch.Generator().manual_seed(0))
    before = [w.launches for w in kernels]
    rstate, rloss = rstep(rstate, tokens)
    torch.cuda.synchronize()
    got = [w.launches - c for w, c in zip(kernels, before)]
    check(got == [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers],
          f"remat step launched kernels 1, 2, 3 {got} times, want "
          f"{[2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]}")
    rloss = float(rloss)
    check(abs(rloss - losses[0]) <= REMAT_LOSS_RTOL * abs(losses[0]),
          f"remat loss {rloss} differs from {losses[0]}")
    print(f"remat step: loss {rloss!r} (plain step {losses[0]!r}); kernel "
          f"launches {got}")

    _, astep = make_train_step(cfg, grad_accum=2)
    before = [w.launches for w in kernels]
    rstate, aloss = astep(rstate, tokens)
    torch.cuda.synchronize()
    got = [w.launches - c for w, c in zip(kernels, before)]
    check(got == [2 * cfg.n_layers] * 3 and bool(torch.isfinite(aloss)),
          f"grad_accum=2 step: launches {got}, loss {float(aloss)}")
    print(f"grad_accum=2 step: loss {float(aloss)!r}; kernel launches "
          f"{got}")
    return launches, ms


def kernel_group(name: str) -> str:
    """The group a profiled device kernel's time is counted under."""
    low = name.lower()
    if "flash_" in low:
        return "flash attention kernels 1-3"
    if "sendrecv" in low:
        return "send/receive kernel 7"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matrix products (cuBLAS)"
    if "multi_tensor_apply" in low:
        return "AdamW (foreach)"
    if "allreduce_kernel" in low:
        return "all-reduce kernel 6"
    if "allgather_kernel" in low:
        return "all-gather kernel 5"
    return "elementwise, reductions, copies"


def profile_steps(run, n, label, step_ms, card):
    """Where a step's device time goes: torch.profiler over ``n`` calls of
    ``run`` (one step each; the caller has warmed it up), device time by
    kernel and by group. The profiler slows the host, so the busy share is
    also given against ``step_ms``, the step's time measured without it.
    Returns ``{"groups": {group: (ms, launches) per step}, "busy": busy
    share of the step without the profiler, "launches": per step}``, or
    None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end) / n
    # Kernels only: a user annotation (Optimizer.step) spans kernels that
    # are counted on their own.
    kernels = [(e.self_device_time_total / 1e3 / n, e.count / n, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and
               e.self_device_time_total > 0 and
               not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"{label} profile: the profiler saw no device time; "
              f"breakdown not measured")
        return None
    busy = sum(ms for ms, _, _ in kernels)
    groups = {}
    for ms, count, name in kernels:
        g = groups.setdefault(kernel_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += count
    print(f"{label} profile (torch.profiler, {n} steps after a warm-up; "
          f"profiling slows the host): {window!r} ms per step window, "
          f"{busy!r} ms of kernels, device busy share {busy / window!r} "
          f"of the profiled window and {busy / step_ms!r} of the "
          f"{step_ms!r} ms step measured without the profiler, "
          f"{sum(c for _, c, _ in kernels)!r} kernel launches per step  "
          f"[{card}]")
    for name, (ms, count) in sorted(groups.items(), key=lambda x: -x[1][0]):
        print(f"  {name}: {ms!r} ms per step, {count!r} launches")
    for ms, count, name in sorted(kernels, reverse=True)[:12]:
        print(f"    {ms!r} ms, {count!r} launches: {name[:110]}")
    return {"groups": {k: tuple(v) for k, v in groups.items()},
            "busy": busy / step_ms,
            "launches": sum(c for _, c, _ in kernels)}


def train_profile(dev, card, step_ms):
    """The flagship training step through :func:`profile_steps`: two steps
    after a warm-up."""
    import numpy as np
    import torch

    from mpi_tpu_torch.models import make_train_step
    from mpi_tpu_torch.train import flagship_train_config

    cfg = flagship_train_config()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    init_state, step = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    step(state, tokens)
    profile_steps(lambda: step(state, tokens), 2, "train step", step_ms,
                  card)


def flash_vs_dense(dev):
    """One float32 forward and backward at flagship width and depth from
    one seeded state, with flash attention and with dense attention: the
    loss and every gradient must agree."""
    import numpy as np
    import torch

    from mpi_tpu_torch.models import init_params, loss_fn
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.train import flagship_train_config

    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 8192, (8, 1025))).to(dev)
    results = []
    for impl in ("flash", "dense"):
        cfg = flagship_train_config(dtype=torch.float32,
                                    attention_impl=impl)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg)
        loss.backward()
        results.append((loss.item(), [x.grad for x in leaves]))
        del params, leaves, loss
    (lf, gf), (ld, gd) = results
    check(np.isfinite(lf) and abs(lf - ld) <= TRAIN_LOSS_RTOL * abs(ld),
          f"float32 flash loss {lf} vs dense {ld}")
    worst = 0.0
    for i, (a, b) in enumerate(zip(gf, gd)):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        check(bool(torch.isfinite(a).all()) and rel <= TRAIN_GRAD_REL,
              f"gradient leaf {i}: flash vs dense differ by {rel} of its "
              f"largest element")
        worst = max(worst, rel)
    print(f"float32 step, flash vs dense: loss {lf!r} vs {ld!r}; "
          f"{len(gf)} gradient leaves agree, worst max|diff|/max|grad| "
          f"{worst!r} (limit {TRAIN_GRAD_REL})")


def time_flash_kernels(dev, gen, card, b, s, h, d, causal):
    """Kernels 1-3 at (b, s, h, d), bf16: each kernel's, its plain
    version's and SDPA's times (ms) beside the bound, then the whole bf16
    backward (kernel 2 with delta, then kernel 3) against SDPA's backward.
    Returns ({kernel: row}, the input sets)."""
    import torch

    from mpi_tpu_torch.ops.attention import (_bwd_plain, _delta,
                                             flash_attention_fwd_plain,
                                             flash_bwd_dkv, flash_bwd_dq_delta,
                                             flash_fwd)

    dtype = torch.bfloat16
    # Two sets of inputs (each past the 50 MB L2 at the shapes timed here)
    # alternate, so each launch reads its inputs from device memory, as a
    # training step does.
    sets = []
    for _ in range(2):
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        out, lse = flash_fwd(q, k, v, causal)
        sets.append((q, k, v, g, lse, _delta(out, g), out))
    work = flash_work(b, s, s, h, h, d, 2, causal)
    # Kernel 2 as the main path calls it, computing delta from out; its
    # plain version is the plain backward and the plain delta.
    fns = {
        "flash_fwd": (lambda q, k, v, g, lse, dl, o:
                      flash_fwd(q, k, v, causal),
                      lambda q, k, v, g, lse, dl, o:
                      flash_attention_fwd_plain(q, k, v, causal)),
        "flash_bwd_dq": (lambda q, k, v, g, lse, dl, o:
                         flash_bwd_dq_delta(q, k, v, g, lse, o, causal),
                         lambda q, k, v, g, lse, dl, o:
                         _bwd_plain(q, k, v, g, lse, _delta(o, g), causal)),
        "flash_bwd_dkv": (lambda q, k, v, g, lse, dl, o:
                          flash_bwd_dkv(q, k, v, g, lse, dl, causal),
                          lambda q, k, v, g, lse, dl, o:
                          _bwd_plain(q, k, v, g, lse, dl, causal)),
    }

    sdpa_fwd_ms, sdpa_bwd = sdpa_ms(sets, causal, 50)
    where = f"b={b} s={s} h={h} d={d} {dtype} " + \
        ("causal" if causal else "non-causal")
    rows = {}
    for name, (fn, plain) in fns.items():
        ms = kernel_ms(fn, sets, 50)
        plain_ms = kernel_ms(plain, sets, 4)
        bound_ms, bound_by = bound(*work[name], dtype)
        lib = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib)
        n_bytes, n_ops = work[name]
        print(f"{name} {where}: kernel {ms * 1e3!r} us, plain "
              f"{plain_ms * 1e3!r} us, sdpa "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv)'}"
              f" {lib * 1e3!r} us; bound {bound_ms * 1e3!r} us by "
              f"{bound_by} ({n_ops} operations, {n_bytes} bytes); "
              f"{n_ops / ms / 1e9!r} TFLOP/s, {bound_ms / ms!r} of the "
              f"bound, {ms / lib!r} of sdpa  [{card}]")
    report_backward(where, sets, sdpa_bwd, work, causal, card)
    return rows, sets


def sdpa_ms(sets, causal, reps):
    """SDPA, the yardstick, on ``sets`` of flash inputs: (forward ms, its
    backward's ms, one autograd call that computes dq, dk and dv
    together)."""
    import torch
    import torch.nn.functional as F

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal)

    graphs = []
    for q, k, v, g, *_ in sets:
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        graphs.append((sdpa(*leaves), leaves, g.transpose(1, 2)))
    fwd = kernel_ms(lambda q, k, v, *_: sdpa(q, k, v), sets, reps)
    bwd = kernel_ms(lambda o, leaves, g: torch.autograd.grad(
        o, leaves, g, retain_graph=True), graphs, reps)
    return fwd, bwd


def report_backward(where, sets, sdpa_bwd, work, causal, card):
    """The whole bf16 backward (kernel 2 with delta, then kernel 3) on
    ``sets`` against SDPA's backward time ``sdpa_bwd``."""
    import torch

    from mpi_tpu_torch.ops.attention import flash_chunk_bwd

    ms = kernel_ms(lambda q, k, v, g, lse, dl, o:
                   flash_chunk_bwd(q, k, v, o, lse, g, causal), sets, 50)
    n_bytes = work["flash_bwd_dq"][0] + work["flash_bwd_dkv"][0]
    n_ops = work["flash_bwd_dq"][1] + work["flash_bwd_dkv"][1]
    bound_ms, bound_by = bound(n_bytes, n_ops, torch.bfloat16)
    print(f"flash backward (kernel 2 with delta, then kernel 3) {where}: "
          f"{ms * 1e3!r} us, sdpa backward (dq, dk, dv) "
          f"{sdpa_bwd * 1e3!r} us, ratio {ms / sdpa_bwd!r}; bound "
          f"{bound_ms * 1e3!r} us by {bound_by}; "
          f"{n_ops / ms / 1e9!r} TFLOP/s over 7 products  [{card}]")


def flash_times(dev, gen, card):
    """Each flash kernel at the flagship training shape: kernel, plain
    version and SDPA times (ms) and the bound; then the whole bf16
    backward (kernel 2 with delta, then kernel 3) against SDPA's backward
    at the flagship shape and at one sequence of 8192."""
    import torch

    from mpi_tpu_torch.ops.attention import _delta, flash_bwd_dq, flash_fwd

    h, d, dtype = 8, 128, torch.bfloat16
    rows, sets = time_flash_kernels(dev, gen, card, 8, 1024, h, d, True)
    given_ms = kernel_ms(lambda q, k, v, g, lse, dl, o:
                         flash_bwd_dq(q, k, v, g, lse, dl, True), sets, 50)
    print(f"flash_bwd_dq with delta given (no out read, no delta write): "
          f"kernel {given_ms * 1e3!r} us  [{card}]")
    del sets

    # Kernel 1, and the whole backward, at long context, where each block
    # runs many tiles and its fill and drain weigh little: one sequence of
    # 8192.
    q, k, v, g = (torch.randn(1, 8192, h, d, generator=gen,
                              device=dev).to(dtype) for _ in range(4))
    out, lse = flash_fwd(q, k, v, True)
    sets = [(q, k, v, g, lse, _delta(out, g), out)]
    long_ms = kernel_ms(lambda q, k, v, *_: flash_fwd(q, k, v, True), sets,
                        20)
    long_sdpa, long_sdpa_bwd = sdpa_ms(sets, True, 20)
    long_work = flash_work(1, 8192, 8192, h, h, d, 2, True)
    n_ops = long_work["flash_fwd"][1]
    print(f"flash_fwd b=1 s=8192 h={h} d={d} {dtype} causal: kernel "
          f"{long_ms * 1e3!r} us, sdpa forward {long_sdpa * 1e3!r} us; "
          f"{n_ops / long_ms / 1e9!r} TFLOP/s  [{card}]")
    report_backward(f"b=1 s=8192 h={h} d={d} {dtype} causal", sets,
                    long_sdpa_bwd, long_work, True, card)
    return rows


def bits_equal(a, b) -> bool:
    """Bitwise equal, NaNs compared by position (a bf16 NaN's payload is
    the kernel's rounding instruction's in one and PyTorch's in the
    other)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    if a.is_floating_point():
        nan = torch.isnan(a)
        if bool(nan.any()) or bool(torch.isnan(b).any()):
            if not torch.equal(nan, torch.isnan(b)):
                return False
            a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    return torch.equal(a.view(ints), b.view(ints))


def max_abs_diff(a, b) -> float:
    """max |a - b| in float32, NaN against NaN counted as 0."""
    return (a.float() - b.float()).abs_().nan_to_num_(0.0).max().item()


def check_ring_kernels(dev, gen):
    """Kernels 5-7 against their plain versions on the card, bitwise, on
    the cases of tests/test_torch_ring_kernel.py. Returns the largest
    |kernel - plain| of each kernel over every case."""
    import torch

    from mpi_tpu_torch.ops.ring_collectives import (
        ring_allgather, ring_allgather_plain, ring_allreduce,
        ring_allreduce_plain, ring_allreduce_sharded)
    from mpi_tpu_torch.parallel import make_mesh, sendrecv, sendrecv_plain

    worst = {"ring_allreduce": 0.0, "ring_allgather": 0.0, "sendrecv": 0.0}
    n_cmp = 0

    def agree(got, want, where):
        nonlocal n_cmp
        torch.cuda.synchronize()
        check(bits_equal(got, want), f"{where}: kernel differs from plain")
        kernel = where.split()[0].replace("_sharded", "")
        worst[kernel] = max(worst[kernel], max_abs_diff(got, want))
        n_cmp += 1

    def contribs(n, rows, inner, op, dtype):
        if op == "prod":  # keep the product of n factors in range
            x = torch.rand(n, rows, inner, generator=gen, device=dev) + 0.5
        else:
            x = torch.randn(n, rows, inner, generator=gen, device=dev)
        return x.to(dtype)

    floats = (torch.float32, torch.bfloat16)
    for n in (2, 4, 8):
        mesh = make_mesh(devices=[dev] * n)
        # (rows, inner) (2, 3): element-wide path; (512, 8): 16-byte path.
        for dtype in floats:
            for rows, inner in ((2, 3), (512, 8)):
                for op in ("sum", "max", "min", "prod"):
                    x = contribs(n, rows * n, inner, op, dtype)
                    agree(ring_allreduce(x, mesh, op),
                          ring_allreduce_plain(x, op),
                          f"ring_allreduce n={n} {op} {dtype} "
                          f"{tuple(x.shape)}")
        for dtype in (*floats, torch.float16, torch.int32):
            for rows, inner in ((3, 2), (1024, 8)):
                x = (torch.randn(rows * n, inner, generator=gen, device=dev)
                     * 100).to(dtype)
                agree(ring_allgather(x, mesh), ring_allgather_plain(x, n),
                      f"ring_allgather n={n} {dtype} {tuple(x.shape)}")
    mesh = make_mesh(devices=[dev] * 4)
    for dtype in floats:
        x = contribs(4, 5, 3, "sum", dtype)  # m = 5 pads to 8
        agree(ring_allreduce_sharded(x, mesh),
              ring_allreduce_plain(torch.cat([x, x.new_zeros(4, 3, 3)],
                                             dim=1))[0, :5],
              f"ring_allreduce_sharded padding {dtype}")
        for op in ("max", "min"):
            x = contribs(4, 8, 3, op, dtype)
            x[2, 3, 1] = float("nan")
            got = ring_allreduce(x, mesh, op)
            check(bool(torch.isnan(got[:, 3, 1]).all()),
                  f"ring_allreduce {op} {dtype} lost a NaN")
            agree(got, ring_allreduce_plain(x, op),
                  f"ring_allreduce {op} {dtype} with a NaN")
    n = RING_RANKS
    mesh = make_mesh(devices=[dev] * n)
    patterns = {"ring": [(r, (r + 1) % n) for r in range(n)],
                "reverse ring": [(r, (r - 1) % n) for r in range(n)],
                "partial": [(0, 4), (4, 0), (2, 3)],
                "self pair": [(1, 1), (0, 5), (5, 0), (6, 7)]}
    for name, perm in patterns.items():
        for dtype in floats:
            for block in ((8, 128), (3, 5)):
                x = torch.randn(n, *block, generator=gen,
                                device=dev).to(dtype)
                agree(sendrecv(x, mesh, perm), sendrecv_plain(x, perm),
                      f"sendrecv {name} {dtype} {tuple(x.shape)}")
    print(f"ring kernels vs plain: {n_cmp} cases bitwise equal (all-reduce "
          f"n 2/4/8 x sum/max/min/prod x float32/bf16 x 2 layouts, padding, "
          f"NaN; all-gather x 4 dtypes; send/receive x 4 patterns); max "
          f"|err| {worst}")
    return worst


def ring_slice(dev, card):
    """The device collective layer at full size: 8 ranks on the card
    all-reduce the flagship's whole gradient (float32, then bf16),
    all-gather its bf16 parameters from eighths, and hand a bf16 activation
    of (8, 1024, 1024) per rank around the ring and along a partial pattern.
    Checks every result, then times each kernel beside its bound, its plain
    version and one PyTorch call. Returns ({kernel: launches}, {kernel:
    row}, {kernel: max |kernel - plain|})."""
    import torch

    from mpi_tpu_torch.models import init_params
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.ops.ring_collectives import (
        ring_allgather, ring_allgather_plain, ring_allreduce,
        ring_allreduce_plain)
    from mpi_tpu_torch.parallel import (exchange_sharded, make_mesh,
                                        sendrecv, sendrecv_plain,
                                        sendrecv_sharded)
    from mpi_tpu_torch.train import flagship_train_config

    n = RING_RANKS
    mesh = make_mesh(devices=[dev] * n)
    gen = torch.Generator(device=dev).manual_seed(6)
    leaves = tree_leaves(init_params(flagship_train_config(), gen, dev))
    m = sum(x.numel() for x in leaves)  # values of the flattened gradient
    del leaves
    grads32 = torch.randn(n, m, generator=gen, device=dev)
    grads16 = torch.randn(n, m, generator=gen, device=dev).to(torch.bfloat16)
    shards = torch.randn(m, generator=gen, device=dev).to(torch.bfloat16)
    acts = torch.randn(n * 8, 1024, 1024, generator=gen,
                       device=dev).to(torch.bfloat16)
    ring = [(r, (r + 1) % n) for r in range(n)]
    partial = [(0, 4), (4, 0), (2, 3)]

    wrappers = {"ring_allreduce": ring_allreduce,
                "ring_allgather": ring_allgather, "sendrecv": sendrecv}
    for w in wrappers.values():
        w.launches = 0
    red32 = ring_allreduce(grads32, mesh)
    red16 = ring_allreduce(grads16, mesh)
    gathered = ring_allgather(shards, mesh)
    hand_ring = sendrecv_sharded(acts, mesh, ring)
    hand_partial = sendrecv_sharded(acts, mesh, partial)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    check(launches == {"ring_allreduce": 2, "ring_allgather": 1,
                       "sendrecv": 2},
          f"collective launches {launches}: want one per collective")

    errs = {}

    def agree(name, got, want, what):
        check(bits_equal(got, want), f"{what} differs from its plain version")
        errs[name] = max(errs.get(name, 0.0), max_abs_diff(got, want))

    for red, x in ((red32, grads32), (red16, grads16)):
        agree("ring_allreduce", red, ring_allreduce_plain(x),
              f"ring all-reduce {x.dtype}")
        check(bits_equal(red, red[:1].expand_as(red)),
              f"ring all-reduce {x.dtype}: ranks hold different results")
    ref = grads32.sum(0)
    tol = RING_SUM_TOL_U * 2.0 ** -24 * grads32.abs().sum(0)
    diff = (red32[0] - ref).abs()
    check(bool(torch.isfinite(red32).all()) and bool((diff <= tol).all()),
          f"float32 ring all-reduce vs sum(0): worst |diff| / tol "
          f"{(diff / tol).max().item()}")
    worst = (diff / tol).max().item()
    del ref, tol, diff
    agree("ring_allgather", gathered, ring_allgather_plain(shards, n),
          "ring all-gather")
    check(all(bits_equal(gathered[r], shards) for r in range(n)),
          "ring all-gather: a rank's copy is not the parameters")
    blocks = acts.reshape(n, -1)
    for hand, perm in ((hand_ring, ring), (hand_partial, partial)):
        agree("sendrecv", hand.reshape(n, -1), sendrecv_plain(blocks, perm),
              f"sendrecv {perm}")
        check(bits_equal(hand, exchange_sharded(acts, mesh, perm)),
              f"sendrecv {perm} differs from exchange")
    print(f"collectives at full size, {n} ranks on one card: all-reduce of "
          f"{m} values per rank (the flagship's gradient) in float32 and "
          f"bf16, all-gather of {m // n} bf16 values per rank, send/receive "
          f"of a bf16 (8, 1024, 1024) block per rank (ring and {partial}); "
          f"every result bitwise equal to its plain version; float32 "
          f"all-reduce vs sum(0): worst |diff| {worst!r} of the allowed "
          f"{RING_SUM_TOL_U} u sum|x|; max |kernel - plain| {errs}; "
          f"launches {launches}")
    del red32, red16, gathered, hand_ring, hand_partial

    def report(name, label, ms, plain_ms, lib_ms, lib_name, least, moved,
               n_ops, dtype):
        bound_ms, bound_by = bound(least, n_ops, dtype)
        print(f"{name} {label}: kernel {ms * 1e3!r} us, plain "
              f"{plain_ms * 1e3!r} us, {lib_name} {lib_ms * 1e3!r} us; bound "
              f"{bound_ms * 1e3!r} us by {bound_by} ({least} bytes read "
              f"once and written once); the kernel moves {moved} bytes, "
              f"{moved / ms / 1e9!r} TB/s  [{card}]")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=lib_ms)

    rows = {}
    for x in (grads32, grads16):
        e = x.element_size()
        # sum(0) writes one copy of the result; the all-reduce writes n.
        # One product with a matrix of ones writes every rank's copy: the
        # same work, in one PyTorch call. At this size the call waits for
        # the device before it returns, so it is timed call by call.
        ones = torch.ones(n, n, dtype=x.dtype, device=dev)
        same_ms = call_ms(lambda c: ones @ c.reshape(n, -1), (x,), 5)
        row = report(
            "ring_allreduce", f"sum {n} ranks x {m} {x.dtype}",
            kernel_ms(lambda c: ring_allreduce(c, mesh), [(x,)], 10),
            kernel_ms(ring_allreduce_plain, [(x,)], 3),
            kernel_ms(lambda c: torch.sum(c, 0), [(x,)], 10),
            "torch.sum(contribs, 0)", 2 * n * m * e, 2 * n * m * e,
            (n - 1) * m, x.dtype)
        print(f"ring_allreduce sum {n} ranks x {m} {x.dtype}: same-work "
              f"yardstick torch.ones({n}, {n}) @ contribs.reshape({n}, -1) "
              f"{same_ms * 1e3!r} us (median of 5 single calls; every "
              f"rank's copy, where sum(0) writes one)  [{card}]")
        rows.setdefault("ring_allreduce", row)  # the float32 row
        del ones
    del grads32, grads16
    e = shards.element_size()
    least = (m + n * m) * e  # the kernel moves exactly these bytes
    rows["ring_allgather"] = report(
        "ring_allgather", f"{n} ranks x {m // n} {shards.dtype}",
        kernel_ms(lambda x: ring_allgather(x, mesh), [(shards,)], 20),
        kernel_ms(lambda x: ring_allgather_plain(x, n), [(shards,)], 5),
        kernel_ms(lambda x: x.repeat(n), [(shards,)], 20),
        f"x.repeat({n})", least, least, 0, shards.dtype)
    row = rows["ring_allgather"]
    print(f"ring_allgather {n} ranks x {m // n} {shards.dtype}: "
          f"{least / row['ms'] / 1e9!r} TB/s of least bytes, "
          f"{row['bound_ms'] / row['ms']!r} of the bound  [{card}]")
    block = blocks[0].numel() * blocks.element_size()
    senders = torch.tensor([(d - 1) % n for d in range(n)], device=dev)
    rows["sendrecv"] = report(
        "sendrecv", f"ring, {n} ranks x (8, 1024, 1024) {acts.dtype}",
        kernel_ms(lambda x: sendrecv_sharded(x, mesh, ring), [(acts,)], 50),
        kernel_ms(lambda x: sendrecv_plain(x.reshape(n, -1), ring),
                  [(acts,)], 20),
        kernel_ms(lambda x: x.reshape(n, -1).index_select(0, senders),
                  [(acts,)], 50),
        "index_select", 2 * n * block, 2 * n * block, 0, acts.dtype)
    report("sendrecv", f"partial {partial}",
           kernel_ms(lambda x: sendrecv_sharded(x, mesh, partial), [(acts,)],
                     50),
           kernel_ms(lambda x: sendrecv_plain(x.reshape(n, -1), partial),
                     [(acts,)], 20),
           float("nan"), "no library call", (len(partial) + n) * block,
           (len(partial) + n) * block, 0, acts.dtype)
    return launches, rows, errs


def driver_slice(dev, card):
    """The device MPI driver on the card, through the entry points a user
    calls: helloworld (8 ranks) and bounce (2 ranks) through ``run_main``;
    8 rank threads all-reducing the flagship's whole gradient through
    ``mpi_tpu_torch.allreduce``, float32 then bf16, on the default tree
    route and on the ring route (``RING_MIN_BYTES`` lowered for it: kernel
    6); and the functional layer, ``parallel.collectives.allgather``
    (kernel 5) of the bf16 parameters from eighths and ``pshift`` (kernel
    7) of a bf16 activation per rank. The launch counters are set to 0
    before and read after. Checks every result, then times the same device
    work called directly beside each route. Returns {kernel: launches}."""
    import contextlib
    import io

    import torch

    import mpi_tpu_torch as M
    from mpi_tpu_torch import collectives_generic as tgen
    from mpi_tpu_torch.backends.cuda import run_spmd
    from mpi_tpu_torch.examples import bounce, helloworld
    from mpi_tpu_torch.models import init_params
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.ops.ring_collectives import (
        ring_allgather, ring_allgather_plain, ring_allreduce,
        ring_allreduce_plain, ring_allreduce_ranks)
    from mpi_tpu_torch.parallel import collectives as C
    from mpi_tpu_torch.parallel import make_mesh, sendrecv, sendrecv_plain
    from mpi_tpu_torch.train import flagship_train_config

    n = RING_RANKS
    wrappers = {"ring_allreduce": ring_allreduce,
                "ring_allgather": ring_allgather, "sendrecv": sendrecv}
    for w in wrappers.values():
        w.launches = 0

    # 1. helloworld, 8 ranks on the card: each rank reports its device.
    def hello():
        return (helloworld.main(), M.registered().device(),
                torch.cuda.current_device())

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out = M.run_main(hello, ["--mpi-ranks", str(n)])
    printed = text.getvalue().count("Hello to rank")
    check([o[0] for o in out] ==
          [[f"Hello to rank {r} from rank {s}" for s in range(n)]
           for r in range(n)] and printed == n * n,
          f"helloworld: {printed} greetings printed, want {n * n}")
    check(all(o[1].type == "cuda" and o[1].index == o[2] for o in out),
          f"helloworld ranks ran on {[(str(o[1]), o[2]) for o in out]}: "
          f"want each on a CUDA device, that device its thread's current "
          f"one")
    print(f"helloworld through run_main, {n} ranks on {dev}: {n * n} "
          f"greetings, each checked")

    # 2. bounce, 2 ranks: it checks every echo itself.
    with contextlib.redirect_stdout(io.StringIO()):
        res = M.run_main(lambda: bounce.main([]), ["--mpi-ranks", "2"])[0]
    check(res["device"].startswith("cuda") and res["sizes"] == bounce.SIZES,
          f"bounce ran on {res['device']} over sizes {res['sizes']}")
    for size, b_us, t_us in zip(res["sizes"], res["bytes_us"],
                                res["tensor_us"]):
        print(f"bounce 2 ranks, size {size}: bytes {b_us!r} us, float64 "
              f"tensor on {res['device']} {t_us!r} us, mean round trip of "
              f"{res['reps']} (host clock)  [{card}]")

    # 3. The gradient all-reduce through the driver, on each route.
    gen = torch.Generator(device=dev).manual_seed(7)
    leaves = tree_leaves(init_params(flagship_train_config(), gen, dev))
    m = sum(x.numel() for x in leaves)  # values of the flattened gradient
    del leaves
    calls = 10

    def through_driver(xs):
        """Each of n rank threads all-reduces its row of ``xs`` once, then
        ``calls`` times between two CUDA events on rank 0's stream.
        Returns (every rank's last result, (device ms per collective, host
        ms per collective on rank 0's clock, which waits for no device
        work, and the caching allocator's device allocations and retries
        per collective))."""
        def main():
            M.init()
            try:
                mine = xs[M.rank()]
                got = M.allreduce(mine)  # warm-up
                before = allocator()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                for _ in range(calls):
                    # Drop the last result first, as a training step has
                    # used its reduced gradient before the next one.
                    got = None
                    got = M.allreduce(mine)
                host = (time.perf_counter() - t0) * 1e3 / calls
                end.record()
                grew = [(a - b) / calls for a, b in zip(allocator(), before)]
                return got, start, end, host, grew
            finally:
                M.finalize()

        out = run_spmd(main, n=n)
        torch.cuda.synchronize()
        return ([o[0] for o in out],
                (out[0][1].elapsed_time(out[0][2]) / calls, *out[0][3:]))

    def allocator():
        stats = torch.cuda.memory_stats()
        return [stats.get(k, 0) for k in ("num_device_alloc",
                                          "num_alloc_retries")]

    def own_copies(outs, want, what):
        check(all(bits_equal(o, want) for o in outs),
              f"{what}: a rank's result differs")
        check(len({o.data_ptr() for o in outs}) == n,
              f"{what}: ranks share a result buffer")

    driver_ms = {}
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn(n, m, generator=gen, device=dev).to(dtype)
        before = ring_allreduce.launches
        outs, driver_ms["tree", dtype] = through_driver(xs)
        check(ring_allreduce.launches == before,
              f"tree route {dtype} launched kernel 6")
        own_copies(outs, tgen.tree_combine(list(xs.unbind(0)), "sum"),
                   f"tree route {dtype} vs tree_combine")
        tree32 = outs[0] if dtype == torch.float32 else None
        del outs
        saved = tgen.RING_MIN_BYTES
        tgen.RING_MIN_BYTES = 1
        try:
            before = ring_allreduce.launches
            outs, driver_ms["ring", dtype] = through_driver(xs)
            got = ring_allreduce.launches - before
        finally:
            tgen.RING_MIN_BYTES = saved
        check(got == calls + 1, f"ring route {dtype}: {got} kernel-6 "
              f"launches for {calls + 1} collectives; want one each")
        own_copies(outs, ring_allreduce_plain(xs)[0],
                   f"ring route {dtype} vs ring_allreduce_plain")
        if dtype == torch.float32:
            ref = xs.sum(0)
            tol = RING_SUM_TOL_U * 2.0 ** -24 * xs.abs().sum(0)
            for route, res32 in (("tree", tree32), ("ring", outs[0])):
                diff = (res32 - ref).abs()
                check(bool(torch.isfinite(res32).all()) and
                      bool((diff <= tol).all()),
                      f"{route} route float32 vs sum(0): worst |diff| / "
                      f"tol {(diff / tol).max().item()}")
                worst[route] = (diff / tol).max().item()
            del ref, tol, diff, tree32
        del outs, xs
        torch.cuda.empty_cache()

    # 4. The functional layer over a mesh of n ranks on the card.
    mesh = make_mesh(devices=[dev] * n)
    shards = torch.randn(n, m // n, generator=gen,
                         device=dev).to(torch.bfloat16)
    acts = torch.randn(n, 8, 1024, 1024, generator=gen,
                       device=dev).to(torch.bfloat16)
    params = C.allgather(shards, mesh, tiled=True)
    shifted = C.pshift(acts, mesh)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    check(all(launches.values()) and
          launches["ring_allreduce"] == 2 * (calls + 1),
          f"driver phase launches {launches}: want every kernel, and "
          f"kernel 6 once per ring collective")
    flat = shards.reshape(-1)
    check(all(bits_equal(params[r], flat) for r in range(n)) and
          bits_equal(params, ring_allgather_plain(flat, n)),
          "parallel.collectives.allgather differs from its plain version")
    ring = [(r, (r + 1) % n) for r in range(n)]
    check(bits_equal(shifted, sendrecv_plain(acts, ring)),
          "parallel.collectives.pshift differs from its plain version")
    del params, shifted, shards, acts, flat
    print(f"driver: {n} ranks on one card all-reduce {m} values each (the "
          f"flagship's gradient) through mpi_tpu_torch.allreduce, float32 "
          f"and bf16: the tree route bitwise tree_combine's fold, the ring "
          f"route bitwise ring_allreduce_plain with one kernel-6 launch per "
          f"collective, every rank its own buffer; float32 vs sum(0): worst "
          f"|diff| {worst!r} of the allowed {RING_SUM_TOL_U} u sum|x|; "
          f"parallel.collectives allgather and pshift bitwise their plain "
          f"versions; launches {launches}")

    # 5. Times: each route through the driver beside the same device work
    # called directly, on the same inputs.
    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn(n, m, generator=gen, device=dev).to(dtype)
        rows = list(xs.unbind(0))

        def tree_direct():
            total = tgen.tree_combine(rows, "sum")
            return [total] + [total.clone() for _ in range(n - 1)]

        direct = {"ring": kernel_ms(lambda: ring_allreduce_ranks(rows), [()],
                                    calls),
                  "tree": kernel_ms(tree_direct, [()], calls)}
        for route in ("tree", "ring"):
            ms, host_ms, (allocs, retries) = driver_ms[route, dtype]
            print(f"driver allreduce {route} route, {n} ranks x {m} {dtype}: "
                  f"{ms!r} ms per collective through mpi_tpu_torch.allreduce "
                  f"(CUDA events over {calls} after a warm-up; rank 0's host "
                  f"clock {host_ms!r} ms per call, no device wait; "
                  f"{allocs!r} device allocations and {retries!r} allocator "
                  f"retries per call); the same device work called directly "
                  f"{direct[route]!r} ms; driver's own cost "
                  f"{ms - direct[route]!r} ms  [{card}]")
        del xs, rows
        torch.cuda.empty_cache()
    return launches


def ring_launches(impl, n, layers, remat):
    """Launches of kernels 1, 2, 3 and 7 in one training step, counted
    from the code (``parallel/ring_attention.py``): per attention call at
    sp n, kernel 1 runs once (flash, Ulysses), n times (contiguous ring)
    or 3 + 2(n - 1) times (zigzag), kernels 2 and 3 as often in the
    backward; a ring hops n - 1 times forward and 2(n - 1) + 1 backward.
    remat replays each block's forward in the backward."""
    fwd = {"flash": 1, "ulysses_flash": 1, "ring_flash": n,
           "zigzag_flash": 3 + 2 * (n - 1)}[impl]
    ring = impl in ("ring_flash", "zigzag_flash")
    hops_fwd, hops_bwd = (n - 1, 2 * (n - 1) + 1) if ring else (0, 0)
    replay = 2 if remat else 1
    return [layers * fwd * replay, layers * fwd, layers * fwd,
            layers * (hops_fwd * replay + hops_bwd)]


def long_context_slice(dev, gen, card):
    """The long-context phase. (1) ring attention with flash chunks over 8
    sp ranks, contiguous and zigzag, float32 and bf16, forward and
    gradients against one flash_attention call over the whole sequence
    (b 1, s 8192, h 8, d 128). (2) The long-context flagship (bench.py's
    measure_long_context: 4 layers, seq 8192, batch 1, remat, bf16 over
    float32 masters, AdamW) from one seeded set of parameters with each of
    LONG_IMPLS: the first two losses against flash's, the launches of
    kernels 1, 2, 3 and 7 of every step against ring_launches, ms per
    step and a profile of one step; zigzag_flash trains LONG_STEPS steps
    and its last loss must be below its first, and one more step without
    remat; two faulty rings (controls) must miss flash's first two losses
    by more than LONG_LOSS_RTOL. (3) Cache-parallel decode at the flagship
    decode widths, cache 8192 over 8 shards, against one kernel-4 call
    over the whole cache and the plain version. Returns ({kernel:
    launches on this phase}, the largest errors)."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import make_train_step
    from mpi_tpu_torch.ops.attention import (flash_attention, flash_bwd_dkv,
                                             flash_bwd_dq, flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain, kernel_splits)
    from mpi_tpu_torch.parallel import (RankMesh,
                                        cache_parallel_decode_attention,
                                        ring_attention_sharded, sendrecv)
    from mpi_tpu_torch.train import flagship_train_config

    # The module (the package also exports a function of its name).
    tring = importlib.import_module("mpi_tpu_torch.parallel.ring_attention")
    n = LONG_SP
    mesh = RankMesh([dev] * n, ("sp",))
    kernels = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, sendrecv)
    errs = {}

    # ---- (1) ring attention against the whole sequence -----------------
    b, s, h, d = 1, LONG_SEQ, 8, 128
    for dtype in (torch.float32, torch.bfloat16):
        tol = LONG_TOL[str(dtype)]
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        want = flash_attention(*xs, True)
        want.backward(g)
        want = [want.detach(), *(x.grad for x in xs)]
        for layout in ("contiguous", "zigzag"):
            xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
            before = [w.launches for w in kernels]
            out = ring_attention_sharded(*xs, mesh, layout=layout,
                                         chunk_impl="flash")
            out.backward(g)
            torch.cuda.synchronize()
            got = [w.launches - c for w, c in zip(kernels, before)]
            per = 3 + 2 * (n - 1) if layout == "zigzag" else n
            check(got == [per, per, per, (n - 1) + 2 * (n - 1) + 1],
                  f"ring {layout} {dtype}: kernels 1, 2, 3, 7 launched "
                  f"{got} times, want {[per] * 3} and {3 * n - 2} hops")
            where = f"ring {layout} {dtype} b={b} s={s} h={h} d={d} sp={n}"
            for name, x, w in zip(("out", "dq", "dk", "dv"),
                                  [out.detach(), *(x.grad for x in xs)],
                                  want):
                atol, rtol = tol["out" if name == "out" else "grad"]
                check(x.dtype == dtype and x.shape == w.shape,
                      f"{name} {x.dtype} {tuple(x.shape)} at {where}")
                err = (x.float() - w.float()).abs().max().item()
                check(torch.allclose(x.float(), w.float(), atol=atol,
                                     rtol=rtol),
                      f"{name} differs from the whole-sequence flash call "
                      f"by {err} at {where}")
                errs[f"{layout} {dtype} {name}"] = err
            here = {name: errs[f"{layout} {dtype} {name}"]
                    for name in ("out", "dq", "dk", "dv")}
            print(f"{where}: kernel launches (1, 2, 3, 7) {got}; max |err| "
                  f"against one flash call over the sequence {here} "
                  f"(tolerances {tol})")
        del q, k, v, g, xs, want, out
    torch.cuda.empty_cache()

    # ---- (2) training the long-context flagship -------------------------
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 8192, (1, LONG_SEQ + 1))).to(dev)

    def train(impl, n_steps, count=False):
        """``n_steps`` steps of ``impl`` from the seeded state: (losses, ms
        per step and the host's ms to enqueue one, after the warm-up first
        step, and the counts of kernels 1, 2, 3 and 7 after the last step).
        With ``count``, each step's launches of those kernels must equal
        ring_launches; the step is then profiled once more."""
        cfg = flagship_train_config(LONG_LAYERS, LONG_SEQ,
                                    attention_impl=impl, remat=True)
        init_state, step = make_train_step(
            cfg, mesh=None if impl == "flash" else mesh)
        state = init_state(torch.Generator().manual_seed(0), dev)
        want = ring_launches(impl, n, LONG_LAYERS, True)
        losses = []
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for i in range(n_steps):
            before = [w.launches for w in kernels]
            state, loss = step(state, tokens)
            got = [w.launches - c for w, c in zip(kernels, before)]
            check(not count or got == want,
                  f"{impl} step {i}: kernels 1, 2, 3, 7 launched {got} "
                  f"times, want {want} (counted from the code)")
            losses.append(loss)
            if i == 0:
                start.record()  # the first step is the warm-up
                host = time.perf_counter()
        host = (time.perf_counter() - host) * 1e3 / (n_steps - 1)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (n_steps - 1)
        counts = [w.launches for w in kernels]
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{impl}: non-finite loss {losses}")
        if count:
            profile_steps(lambda: step(state, tokens), 1,
                          f"long context {impl}", ms, card)
        del state, step, init_state
        torch.cuda.empty_cache()
        return losses, ms, host, counts

    first, second, times, per_step = {}, {}, {}, {}
    for impl in LONG_IMPLS:
        n_steps = LONG_STEPS if impl == "zigzag_flash" else 3
        if impl == "zigzag_flash":
            for w in kernels:  # this phase's main path: counted alone
                w.launches = 0
        losses, times[impl], host, counts = train(impl, n_steps, count=True)
        if impl == "zigzag_flash":
            phase = counts
            check(losses[-1] < losses[0],
                  f"zigzag_flash loss did not fall: {losses}")
        first[impl], second[impl] = losses[:2]
        per_step[impl] = ring_launches(impl, n, LONG_LAYERS, True)
        print(f"long context {impl} (sp {n}, {LONG_LAYERS} layers, seq "
              f"{LONG_SEQ}, batch 1, remat): losses {losses}; "
              f"{times[impl]!r} ms per step (CUDA events over "
              f"{n_steps - 1} steps after a warm-up), host enqueue "
              f"{host!r} ms per step (host clock, the same steps); "
              f"launches per step of kernels 1, 2, 3, 7: {per_step[impl]}  "
              f"[{card}]")
    gaps = {impl: (abs(first[impl] - first["flash"]) / abs(first["flash"]),
                   abs(second[impl] - second["flash"]) /
                   abs(second["flash"]))
            for impl in LONG_IMPLS[1:]}
    print(f"first-step losses {first}, second-step {second}; relative gaps "
          f"to flash's (first, second) {gaps} (rtol {LONG_LOSS_RTOL})")

    # Controls: ring_flash with one fault each, from the same state. Both
    # losses of each must land outside LONG_LOSS_RTOL of flash's, or the
    # check below could not tell a faulty ring from a sound one.
    def last_chunk(out, lse, oc, lc):  # each merge keeps the newest chunk
        out.copy_(oc)
        lse.copy_(lc)

    def no_causal_skip(q, k, v, ring, causal=True):  # future kv attended
        return tring._RingFlash.apply(q.contiguous(), k.contiguous(),
                                      v.contiguous(), ring, False)

    control = {}
    for label, attr, fault in (
            ("merge keeps the last chunk", "_merge_into", last_chunk),
            ("causal skip off", "ring_flash_attention", no_causal_skip)):
        saved = getattr(tring, attr)
        setattr(tring, attr, fault)
        try:
            losses = train("ring_flash", 2)[0]
        finally:
            setattr(tring, attr, saved)
        control[label] = tuple(
            abs(x - w) / abs(w) for x, w in zip(losses,
                                                (first["flash"],
                                                 second["flash"])))
    print(f"controls, ring_flash with a fault: relative gaps of the first "
          f"and second losses to flash's {control}")
    for impl in LONG_IMPLS[1:]:
        check(max(gaps[impl]) <= LONG_LOSS_RTOL,
              f"{impl} first and second losses {first[impl]}, "
              f"{second[impl]} against flash's {first['flash']}, "
              f"{second['flash']} (rtol {LONG_LOSS_RTOL})")
    for label, gap in control.items():
        check(min(gap) > LONG_LOSS_RTOL,
              f"control {label!r}: a loss within {gap} of flash's, inside "
              f"the rtol {LONG_LOSS_RTOL} that sound impls must meet")
    # zigzag_flash without remat: kernel 1 and the forward hops once.
    cfg = flagship_train_config(LONG_LAYERS, LONG_SEQ,
                                attention_impl="zigzag_flash")
    init_state, step = make_train_step(cfg, mesh=mesh)
    state = init_state(torch.Generator().manual_seed(0), dev)
    before = [w.launches for w in kernels]
    state, loss = step(state, tokens)
    torch.cuda.synchronize()
    got = [w.launches - c for w, c in zip(kernels, before)]
    want = ring_launches("zigzag_flash", n, LONG_LAYERS, False)
    check(got == want, f"zigzag_flash without remat: launches {got}, want "
                       f"{want}")
    check(abs(float(loss) - first["zigzag_flash"]) <=
          REMAT_LOSS_RTOL * abs(first["zigzag_flash"]),
          f"zigzag_flash loss without remat {float(loss)} against "
          f"{first['zigzag_flash']} with it")
    print(f"zigzag_flash without remat: loss {float(loss)!r}; launches per "
          f"step of kernels 1, 2, 3, 7: {got}")
    del state, step, init_state
    torch.cuda.empty_cache()

    # ---- (3) cache-parallel decode ---------------------------------------
    bd, hd_, t, dtype = BATCH, 128, LONG_SEQ, torch.bfloat16
    q = torch.randn(bd, 8, hd_, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(bd, t, 8, hd_, generator=gen, device=dev).to(dtype)
            for _ in range(2))
    t_local = t // CACHE_SHARDS

    def shards(x):
        return x.reshape(bd, CACHE_SHARDS, t_local, 8, hd_).transpose(
            0, 1).contiguous()

    ks, vs = shards(k), shards(v)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = kernel_splits(bd, 8, 8, t_local, hd_, dtype, sms)
    edges = [r * t_local for r in range(1, CACHE_SHARDS)]
    cases = sorted({-1, 0, t - 1, *edges, *(e - 1 for e in edges)})
    tol = KERNEL_TOL[str(dtype)]["out"]
    worst = 0.0
    cp_mesh = RankMesh([dev] * CACHE_SHARDS, ("sp",))
    decode_launches = 0
    for n_valid in cases:
        before = flash_decode_attention.launches
        got = cache_parallel_decode_attention(q, ks, vs, n_valid, cp_mesh)
        decode_launches += flash_decode_attention.launches - before
        whole = flash_decode_attention(q, k, v, n_valid)
        ref = flash_decode_attention_plain(q, k, v, n_valid)[0]
        torch.cuda.synchronize()
        for name, w in (("one kernel-4 call", whole), ("plain", ref)):
            err = (got.float() - w.float()).abs().max().item()
            check(got.dtype == dtype and got.shape == q.shape and
                  torch.allclose(got.float(), w.float(), atol=tol[0],
                                 rtol=tol[1]),
                  f"cache-parallel decode differs from {name} by {err} at "
                  f"n_valid={n_valid}")
            worst = max(worst, err)
    check(decode_launches == CACHE_SHARDS * len(cases),
          f"cache-parallel decode launched kernel 4 {decode_launches} "
          f"times over {len(cases)} calls, want {CACHE_SHARDS} each")
    errs["cache-parallel"] = worst
    cp_ms = kernel_ms(lambda q_, k_, v_: cache_parallel_decode_attention(
        q_, k_, v_, t - 1, cp_mesh), [(q, ks, vs)], 30)
    whole_ms = kernel_ms(lambda q_, k_, v_: flash_decode_attention(
        q_, k_, v_, t - 1), [(q, k, v)], 60)
    print(f"cache-parallel decode b={bd} h=8 hd={hd_} {dtype}, t {t} over "
          f"{CACHE_SHARDS} shards of {t_local} ({splits} blocks per cluster "
          f"each): {len(cases)} n_valid cases {cases} pass against one "
          f"kernel-4 call over the whole cache and the plain version, max "
          f"|err| {worst!r} (tolerance {tol}); {decode_launches} kernel-4 "
          f"launches; {cp_ms * 1e3!r} us per decode (8 launches and the "
          f"merge) against {whole_ms * 1e3!r} us for one call over the "
          f"whole cache  [{card}]")
    del q, k, v, ks, vs
    torch.cuda.empty_cache()
    launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                         "sendrecv"), phase))
    launches["flash_decode_attention"] = decode_launches
    print(f"long-context phase launches: {launches} (kernels 1-3 and 7 over "
          f"{LONG_STEPS} zigzag_flash steps; kernel 4 over the "
          f"cache-parallel decode calls); ms per step {times}; kernel 1 and "
          f"7 launches per step "
          f"{ {i: (c[0], c[3]) for i, c in per_step.items()} }")
    return launches, errs


def clone_tree(tree):
    """A detached copy of a parameter tree (dicts and lists of tensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.detach().clone()


def rel_gap(got, ref, p0):
    """||got - ref|| / ||ref - p0|| over every leaf: the parameters' gap
    relative to how far the steps moved them from ``p0``."""
    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(got, ref))
    den = sum(float(((b.double() - c.double()) ** 2).sum())
              for b, c in zip(ref, p0))
    return (num / den) ** 0.5


def loss_gaps(got, ref):
    """Each loss's gap relative to its reference."""
    return [abs(a - b) / abs(b) for a, b in zip(got, ref)]


def opt_bytes(opt):
    """Bytes of the tensors ``opt`` keeps per leaf (its moments; the step
    counts aside)."""
    import torch

    return sum(t.numel() * t.element_size() for held in opt.state.values()
               for k, t in held.items() if k != "step" and torch.is_tensor(t))


def dp_launches(mode, n, layers, rest, remat=False):
    """Launches of kernels 1, 2, 3, 5 and 6 in one training step, counted
    from the code (``models/transformer.py``, ``_DataParallel``): each of
    the n dp ranks runs its own forward and backward, kernel 1 once per
    layer (twice under remat), kernels 2 and 3 once; plain dp reduces the
    bucket in one kernel-6 launch; zero1 and fsdp reduce-scatter it in one
    and all-reduce the replicated leaves in one more when there are any;
    zero1 gathers the parameters in one kernel-5 launch; fsdp gathers, for
    each rank, the leaves outside the blocks once and each block's weights
    at each use (twice under remat). The control reduces nothing. ``"one"``
    is the single-device step."""
    replay = 2 if remat else 1
    ranks = 1 if mode == "one" else n
    k6 = {"one": 0, "control": 0, "dp": 1}.get(mode, 1 + bool(rest))
    k5 = {"zero1": 1, "fsdp": n * (1 + layers * replay)}.get(mode, 0)
    return [ranks * layers * replay, ranks * layers, ranks * layers, k5, k6]


def dp_slice(dev, card):
    """Phase 9: data-parallel training of the flagship (8 layers, seq 1024,
    batch 8, bf16 over float32 masters, flash attention, AdamW at lr 1e-3)
    over DP_RANKS dp ranks of a ``("dp",)`` mesh on the card, every variant
    from one seeded set of parameters and one seeded batch, DP_STEPS steps
    each: (a) the single-device step, (b) plain dp, (c) zero1, (d) fsdp,
    (e) a faulty control, plain dp with its reduction replaced by rank 0's
    gradient alone. Checks: the launches of kernels 1-3, 5 and 6 in every
    step against dp_launches; (b) against (a) within DP_LOSS_RTOL and
    DP_PARAM_REL, (c) and (d) against (b) bit for bit (every leaf is
    sharded, so all three fold the same bucket in the same order); the
    control outside both tolerances; falling losses; each rank's moment
    bytes (zero1) and parameter bytes (fsdp) 1/dp of plain dp's. Then fsdp
    under remat (each block gathered again in the backward) for DP_STEPS
    steps against fsdp without it, losses and parameters bit for bit,
    kernels 5 and 6 against their plain versions at this phase's shapes,
    bitwise, their times there, and ms per step of (a)-(d) with a profile
    of one step each. (f): adafactor at TP_OPT_LR in plain dp, zero1 and
    fsdp, DP_STEPS steps each, zero1 and fsdp bitwise plain dp, and the
    bytes a rank holds. Returns ({kernel: launches on this phase's main
    path, (b)-(d) and (f)}, {kernel: max |kernel - plain|}, (a)'s (losses,
    parameters after DP_STEPS steps, ms per step)) for phases 10 and
    11."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (full_params, init_params, make_mesh_nd,
                                      make_train_step, rank_state)
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.ring_collectives import (
        ring_allgather, ring_allgather_plain, ring_allreduce,
        ring_allreduce_plain)
    from mpi_tpu_torch.parallel import sendrecv
    from mpi_tpu_torch.parallel.collectives import ring_reduce_scatter
    from mpi_tpu_torch.parallel.mesh import axis_ring
    from mpi_tpu_torch.train import flagship_train_config

    tmod = importlib.import_module("mpi_tpu_torch.models.transformer")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv, "ring_allgather":
                ring_allgather, "ring_allreduce": ring_allreduce,
                "sendrecv": sendrecv}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    n = DP_RANKS
    cfg = flagship_train_config()
    layers = cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    params0 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = make_mesh_nd(n, ("dp",), [dev] * n)
    flags = {"one": {}, "dp": {}, "control": {}, "zero1": {"zero1": True},
             "fsdp": {"fsdp": True}}

    def run(mode, c=cfg, m=mesh, p0=params0, toks=tokens, steps=DP_STEPS,
            want=None, opt=None):
        """``steps`` steps of ``mode`` from a copy of ``p0``: (step, state,
        losses); each step's launches of kernels 1-3, 5 and 6 (and 7, with
        ``want`` of six) must equal ``want`` or dp_launches. ``opt`` is
        make_train_step's optimizer keywords (AdamW at 1e-3 without)."""
        init_state, step = make_train_step(
            c, mesh=None if mode == "one" else m, **flags[mode],
            **(opt or {}))
        state = init_state.from_params(clone_tree(p0))
        rest = state["layout"].rest if "layout" in state else 0
        per_step = want or dp_launches(mode, n, c.n_layers, rest)
        losses = []
        for i in range(steps):
            before = counts()
            state, loss = step(state, toks)
            got = [a - b for a, b in zip(counts(), before)][:len(per_step)]
            check(got == per_step,
                  f"{mode} step {i}: kernels {names[:len(per_step)]} "
                  f"launched {got} times, want {per_step} (counted from "
                  f"the code)")
            losses.append(float(loss))
        check(all(np.isfinite(losses)), f"{mode}: non-finite loss {losses}")
        return step, state, losses

    def leaves(state):
        return [x.detach() for x in tree_leaves(full_params(state))]

    p0 = leaves({"params": params0})

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree))

    steps, states, losses = {}, {}, {}
    steps["one"], states["one"], losses["one"] = run("one")
    # ---- the main path: (b)-(d), then (f) with adafactor, counted alone
    for w in wrappers.values():
        w.launches = 0
    for mode in ("dp", "zero1", "fsdp"):
        steps[mode], states[mode], losses[mode] = run(mode)

    # ---- (f) adafactor at TP_OPT_LR in plain dp, zero1 and fsdp ----------
    # Every leaf of the flagship is sharded at dp 8, and the rule sees the
    # whole leaf and the whole reduced gradient put back together from the
    # ranks' pieces: plain dp's values, so the design gives zero1 and fsdp
    # plain dp's bits, as with AdamW.
    fac = {}
    for mode in ("dp", "zero1", "fsdp"):
        _, fstate, flosses = run(mode, opt={"optimizer": "adafactor",
                                            "learning_rate": TP_OPT_LR})
        held = [rank_state(fstate, r) for r in range(n)]
        fac[mode] = (flosses, [x.clone() for x in leaves(fstate)],
                     [nbytes(h["v_row"]) + nbytes(h["v_col"]) +
                      nbytes(h["v"]) for h in held],
                     [nbytes(h["params"]) for h in held])
        del fstate, held
        torch.cuda.empty_cache()
    sharded = dict(zip(names, counts()))
    for mode in ("zero1", "fsdp"):
        check(fac[mode][0] == fac["dp"][0] and all(
            bits_equal(a, b) for a, b in zip(fac[mode][1], fac["dp"][1])),
            f"adafactor {mode}: losses {fac[mode][0]} or parameters differ "
            f"from plain dp's {fac['dp'][0]} in their bits")
        check(fac[mode][2] == [fac[mode][2][0]] * n,
              f"adafactor {mode}: ranks hold unequal moment bytes "
              f"{fac[mode][2]}")
    check(fac["dp"][0][-1] < fac["dp"][0][0],
          f"adafactor plain dp loss did not fall: {fac['dp'][0]}")
    print(f"(f) adafactor (rate {TP_OPT_LR}), {n} dp ranks, {DP_STEPS} "
          f"steps: losses plain dp {fac['dp'][0]}, zero1 "
          f"{fac['zero1'][0]}, fsdp {fac['fsdp'][0]}; zero1 and fsdp "
          f"bitwise plain dp's losses and parameters (the design gives "
          f"it: every leaf sharded, the rule on plain dp's whole leaves). "
          f"Bytes a rank holds: moments plain dp {fac['dp'][2][0]}, zero1 "
          f"{fac['zero1'][2][0]}, fsdp {fac['fsdp'][2][0]} (the factored "
          f"moments whole, the full moments of the norms a rank's piece); "
          f"parameters plain dp {fac['dp'][3][0]}, zero1 "
          f"{fac['zero1'][3][0]}, fsdp {fac['fsdp'][3][0]}")
    del fac

    # ---- (e) the faulty control ------------------------------------------
    def rank_zero(contribs, ring, op="sum"):
        return contribs[:1].expand_as(contribs) * ring.size

    tmod.ring_allreduce = rank_zero
    try:
        _, cstate, losses["control"] = run("control")
    finally:
        tmod.ring_allreduce = ring_allreduce
    ctrl = leaves(cstate)
    del cstate
    torch.cuda.empty_cache()

    # ---- agreement ---------------------------------------------------------
    full = {mode: leaves(states[mode]) for mode in ("one", "dp", "zero1",
                                                    "fsdp")}
    one_leaves = [x.clone() for x in full["one"]]  # the steps below move it
    loss_gap = {mode: [abs(a - b) / abs(b) for a, b in
                       zip(losses[mode], losses["one"])]
                for mode in ("dp", "control")}
    ctrl_gap = [abs(a - b) / abs(b) for a, b in zip(losses["control"],
                                                    losses["dp"])]
    param_gap = rel_gap(full["dp"], full["one"], p0)
    ctrl_param_gap = rel_gap(ctrl, full["dp"], p0)
    print(f"data-parallel flagship, {n} dp ranks on the card ({DP_STEPS} "
          f"steps, batch 8, seq {cfg.max_seq - 1}): losses (a) one device "
          f"{losses['one']}, (b) dp {losses['dp']}, (c) zero1 "
          f"{losses['zero1']}, (d) fsdp {losses['fsdp']}, (e) control "
          f"{losses['control']}")
    print(f"relative loss gaps to (a): (b) {loss_gap['dp']}, (e) "
          f"{loss_gap['control']}; (e) to (b): {ctrl_gap} (rtol "
          f"{DP_LOSS_RTOL}); parameter gap ||p - p_ref|| / ||p_ref - p_0||: "
          f"(b) to (a) {param_gap!r}, (e) to (b) {ctrl_param_gap!r} "
          f"(limit {DP_PARAM_REL})")
    rest = states["dp"]["layout"].rest
    check(rest == 0, f"{rest} replicated values at dp {n}: the flagship's "
                     f"every leaf should divide by {n}")
    for mode in ("zero1", "fsdp"):
        check(losses[mode] == losses["dp"] and all(
            bits_equal(a, b) for a, b in zip(full[mode], full["dp"])),
            f"{mode}: losses {losses[mode]} or parameters differ from plain "
            f"dp's {losses['dp']} in their bits")
    check(max(loss_gap["dp"]) <= DP_LOSS_RTOL,
          f"plain dp losses {losses['dp']} against one device's "
          f"{losses['one']}: gaps {loss_gap['dp']} (rtol {DP_LOSS_RTOL})")
    check(param_gap <= DP_PARAM_REL,
          f"plain dp parameters {param_gap} from one device's (limit "
          f"{DP_PARAM_REL})")
    check(losses["control"][0] == losses["dp"][0],
          f"control's first loss {losses['control'][0]} (before any update) "
          f"differs from plain dp's {losses['dp'][0]}")
    check(ctrl_gap[1] > DP_LOSS_RTOL,
          f"control (rank 0's gradient alone) within {ctrl_gap[1]} of plain "
          f"dp's step-2 loss, inside the rtol {DP_LOSS_RTOL}")
    check(ctrl_param_gap > DP_PARAM_REL,
          f"control's parameters within {ctrl_param_gap} of plain dp's, "
          f"inside the limit {DP_PARAM_REL}")
    for mode in ("dp", "zero1", "fsdp"):
        check(losses[mode][-1] < losses[mode][0],
              f"{mode} loss did not fall: {losses[mode]}")
    del ctrl, full

    # ---- memory per rank -------------------------------------------------
    held = {mode: [rank_state(states[mode], r) for r in range(n)]
            for mode in ("dp", "zero1", "fsdp")}
    moments = {mode: [nbytes(h["exp_avg"]) + nbytes(h["exp_avg_sq"])
                      for h in held[mode]] for mode in held}
    param_bytes = {mode: [nbytes(h["params"]) for h in held[mode]]
                   for mode in held}
    for r in range(n):
        check(moments["zero1"][r] * n == moments["dp"][r],
              f"zero1 rank {r} holds {moments['zero1'][r]} moment bytes, "
              f"plain dp {moments['dp'][r]}")
        check(param_bytes["fsdp"][r] * n == param_bytes["dp"][r],
              f"fsdp rank {r} holds {param_bytes['fsdp'][r]} parameter "
              f"bytes, plain dp {param_bytes['dp'][r]}")
    print(f"bytes per rank between steps (no replicated leaf): moments "
          f"plain dp {moments['dp'][0]}, zero1 {moments['zero1']}, fsdp "
          f"{moments['fsdp'][0]}; parameters plain dp "
          f"{param_bytes['dp'][0]}, zero1 {param_bytes['zero1'][0]}, fsdp "
          f"{param_bytes['fsdp']}")
    del held

    # ---- fsdp under remat: each block gathered again in the backward ----
    # DP_STEPS steps, so the gradient through the second gather (the
    # backward's replay) moves the parameters that the later losses see.
    remat_k = dp_launches("fsdp", n, layers, 0, remat=True)
    _, rstate, rlosses = run("fsdp", flagship_train_config(remat=True),
                             want=remat_k)
    rfull, ffull = leaves(rstate), leaves(states["fsdp"])
    del rstate
    remat_gap = [abs(a - b) / abs(b) for a, b in zip(rlosses,
                                                     losses["fsdp"])]
    remat_param_gap = rel_gap(rfull, ffull, p0)
    remat_bits = rlosses == losses["fsdp"] and all(
        bits_equal(a, b) for a, b in zip(rfull, ffull))
    print(f"fsdp with remat, {DP_STEPS} steps: losses {rlosses} (without "
          f"{losses['fsdp']}), relative gaps {remat_gap}, parameter gap "
          f"{remat_param_gap!r}, bitwise equal: {remat_bits}; kernel 1 and "
          f"kernel 5 launches per step {remat_k[0]}, {remat_k[3]}")
    # The replay runs the same kernels on the same gathered bits, so the
    # design gives fsdp's losses and parameters bit for bit (measured so on
    # NVIDIA H100 80GB HBM3, 700 W); a gradient lost or doubled in the
    # second gather would move the parameters as the control does.
    check(remat_bits,
          f"fsdp remat losses {rlosses} or parameters (gap "
          f"{remat_param_gap}) differ from fsdp's without remat "
          f"{losses['fsdp']} in their bits")
    del rfull, ffull
    torch.cuda.empty_cache()

    # ---- kernels 5 and 6 against plain at this phase's shapes -----------
    ring = axis_ring(mesh, "dp")
    layout = states["dp"]["layout"]
    gen = torch.Generator(device=dev).manual_seed(9)
    errs = {"ring_allreduce": 0.0, "ring_allgather": 0.0}
    bucket = torch.randn(n, layout.width, generator=gen, device=dev)
    want = ring_allreduce_plain(bucket)
    for label, got, ref in (
            ("all-reduce", ring_allreduce(bucket, ring), want),
            ("reduce-scatter", ring_reduce_scatter(bucket, ring),
             want.reshape(n, n, -1)[torch.arange(n), torch.arange(n)])):
        torch.cuda.synchronize()
        check(bits_equal(got, ref), f"kernel 6 {label} of the ({n}, "
                                    f"{layout.width}) bucket differs from "
                                    f"its plain version")
        errs["ring_allreduce"] = max(errs["ring_allreduce"],
                                     max_abs_diff(got, ref))
        del got, ref
    del want
    shards = [("zero1's parameters", states["zero1"]["buffers"][0]),
              ("fsdp's top group", states["fsdp"]["buffers"][0]),
              ("fsdp's block 0", states["fsdp"]["buffers"][1])]
    for label, buf in shards:
        x = buf.reshape(-1)
        got, ref = ring_allgather(x, ring), ring_allgather_plain(x, n)
        torch.cuda.synchronize()
        check(bits_equal(got, ref), f"kernel 5 on {label} "
                                    f"{tuple(buf.shape)} differs from its "
                                    f"plain version")
        errs["ring_allgather"] = max(errs["ring_allgather"],
                                     max_abs_diff(got, ref))
        del got, ref
    # Least bytes: every rank's bucket row read once; the reduce-scatter
    # writes each rank's chunk once, the all-reduce every rank's copy.
    width_bytes = layout.width * bucket.element_size()
    rs_ms = kernel_ms(lambda b: ring_reduce_scatter(b, ring), [(bucket,)], 5)
    ar_ms = kernel_ms(lambda b: ring_allreduce(b, ring), [(bucket,)], 5)
    rs_bound = bound((n + 1) * width_bytes, (n - 1) * layout.width,
                     torch.float32)[0]
    ar_bound = bound(2 * n * width_bytes, (n - 1) * layout.width,
                     torch.float32)[0]
    gather_ms = {label: kernel_ms(lambda x: ring_allgather(x, ring),
                                  [(buf.reshape(-1),)], 10)
                 for label, buf in shards}
    print(f"kernels 5-6 at this phase's shapes, bitwise equal to plain "
          f"(max |err| {errs}); ({n}, {layout.width}) float32 bucket: "
          f"ring_reduce_scatter (kernel 6, then rank r's chunk) "
          f"{rs_ms * 1e3!r} us against the {rs_bound * 1e3!r} us bound of "
          f"writing the kept chunks alone; ring_allreduce {ar_ms * 1e3!r} "
          f"us (bound {ar_bound * 1e3!r}); ring_allgather "
          f"{ {k: v * 1e3 for k, v in gather_ms.items()} } us  [{card}]")
    del bucket
    torch.cuda.empty_cache()

    # ---- times ------------------------------------------------------------
    step_ms = {}
    for mode in ("one", "dp", "zero1", "fsdp"):
        step, state = steps[mode], states[mode]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        host = time.perf_counter()
        for _ in range(DP_TIMED_STEPS):
            step(state, tokens)
        host = (time.perf_counter() - host) * 1e3 / DP_TIMED_STEPS
        end.record()
        torch.cuda.synchronize()
        ms = step_ms[mode] = start.elapsed_time(end) / DP_TIMED_STEPS
        label = {"one": "(a) one device", "dp": "(b) plain dp",
                 "zero1": "(c) zero1", "fsdp": "(d) fsdp"}[mode]
        print(f"{label}: {ms!r} ms per step (CUDA events over "
              f"{DP_TIMED_STEPS} steps after {DP_STEPS}), host enqueue "
              f"{host!r} ms per step  [{card}]")
        prof = profile_steps(lambda: step(state, tokens), 1, label, ms,
                             card)
        if prof is not None:
            g = prof["groups"]
            print(f"{label}: kernel 5 {g.get('all-gather kernel 5', (0, 0))}"
                  f", kernel 6 {g.get('all-reduce kernel 6', (0, 0))} (ms, "
                  f"launches) a step; device busy share {prof['busy']!r}; "
                  f"{prof['launches']!r} launches a step  [{card}]")
        del state
        states[mode] = None
        torch.cuda.empty_cache()
    print(f"data-parallel phase launches (main path: (b)-(d), {DP_STEPS} "
          f"steps each): {sharded}")
    return sharded, errs, (losses["one"], one_leaves, step_ms["one"])


def tp_launches(layers, dp=1, remat=False):
    """Launches of kernel 6 by the tp reductions of one training step,
    counted from the code (``parallel/tensor_parallel.py``,
    ``models/transformer.py``): for each dp rank, per layer the reduce
    after wo and after w2 in the forward (again in remat's replay) and the
    copies' backward before the q/k/v projections and before w1; once, the
    embedding's reduce, the logits' copy backward, the loss's row max and
    its sums."""
    replay = 2 if remat else 1
    return dp * (2 * layers * replay + 2 * layers + 4)


def tp_slice(dev, card, one=None):
    """Phase 10: tensor-parallel training of the flagship (8 layers, seq
    1024, batch 8, bf16 over float32 masters, flash attention) over
    TP_RANKS tp ranks of a ``("tp",)`` mesh on the card, from one seeded set
    of parameters and one seeded batch, TP_STEPS steps each: (a) the
    single-device step (phase 9's, handed in as ``one``: losses, parameters
    after TP_STEPS AdamW steps, ms per step; run here when None); (b) tp 8,
    AdamW; (c) a faulty control, (b) with every tp reduction keeping rank
    0's partial alone; (d) adafactor and sgd on the warmup-cosine schedule
    (warmup 1, total TP_STEPS, rate TP_OPT_LR), each on one device and
    under tp 8; (e) the composition step (COMPOSE: zigzag_flash over (dp 2,
    sp 2, tp 2), fsdp against plain dp, bit for bit), which puts kernels 5
    and 7 on the path. Checks, each raising: every step's launches of
    kernels 1-3, 5, 6 (and 7 in (e)) against tp_launches (counted from the
    code); (b) against (a) within TP_LOSS_RTOL and TP_PARAM_REL, and (d)'s
    tp runs against their single-device runs too; the control outside
    both; every copy kernel 6 writes in (b) bitwise the same; falling
    losses in every sound run; adafactor's optimizer state under 0.6 of
    AdamW's bytes. Then (b) with the partials reduced in bf16 (measured,
    the choice's alternative), kernel 6 against its plain version at the
    tp shapes (bitwise) and its time there, and (b)'s ms per step with a
    profile of one step. Returns ({kernel: launches on this phase's main
    path, (b), (d) and (e)}, {kernel: max |kernel - plain|})."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (full_params, init_params, make_mesh_nd,
                                      make_train_step)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.ring_collectives import (
        ring_allgather, ring_allreduce, ring_allreduce_plain)
    from mpi_tpu_torch.parallel import RankMesh, sendrecv
    from mpi_tpu_torch.parallel.mesh import axis_ring
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.train import flagship_train_config

    tpm = importlib.import_module("mpi_tpu_torch.parallel.tensor_parallel")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv, "ring_allgather":
                ring_allgather, "ring_allreduce": ring_allreduce,
                "sendrecv": sendrecv}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    n = TP_RANKS
    cfg = flagship_train_config()
    layers = cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    params0 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = RankMesh([dev] * n, ("tp",))

    def run(label, m, kw, want, c=cfg, p0=params0, toks=tokens,
            steps=TP_STEPS):
        """``steps`` steps from a copy of ``p0`` over mesh ``m``: (step,
        state, losses); each step's launches of the first len(want) of
        kernels 1-3, 5, 6, 7 must equal ``want``."""
        init_state, step = make_train_step(c, mesh=m, **kw)
        state = init_state.from_params(clone_tree(p0))
        losses = []
        for i in range(steps):
            before = counts()
            state, loss = step(state, toks)
            got = [a - b for a, b in zip(counts(), before)][:len(want)]
            check(got == want,
                  f"{label} step {i}: kernels {names[:len(want)]} launched "
                  f"{got} times, want {want} (counted from the code)")
            losses.append(float(loss))
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        return step, state, losses

    def leaves(state):
        return [x.detach() for x in tree_leaves(full_params(state))]

    p0 = leaves({"params": params0})

    one_k = [layers, layers, layers, 0, 0]
    tp_k = [layers, layers, layers, 0, tp_launches(layers)]
    if one is None:
        _, ostate, olosses = run("(a) one device", None, {}, one_k)
        one = (olosses, [x.clone() for x in leaves(ostate)], None)
        del ostate
    one_losses, one_leaves, one_ms = one

    # ---- the main path: (b), (d) and (e), counted alone -------------------
    copies = {"calls": 0, "differ": 0}

    def checked(contribs, ring, op="sum"):
        """Kernel 6 as the tp operators call it; every rank's copy of the
        result must hold copy 0's bits."""
        out = ring_allreduce(contribs, ring, op)
        bits = out.view({2: torch.int16, 4: torch.int32}[out.element_size()])
        copies["calls"] += 1
        copies["differ"] += int(not bool((bits == bits[:1]).all()))
        return out

    for w in wrappers.values():
        w.launches = 0
    tpm.ring_allreduce = checked
    try:
        step_b, state_b, losses_b = run("(b) tp 8", mesh, {}, tp_k)
    finally:
        tpm.ring_allreduce = ring_allreduce
    check(copies["calls"] == TP_STEPS * tp_k[4] and copies["differ"] == 0,
          f"(b): {copies['differ']} of {copies['calls']} kernel-6 results "
          f"hold copies that differ from copy 0 (want {TP_STEPS * tp_k[4]} "
          f"results, every copy the same bits)")
    full_b = [x.clone() for x in leaves(state_b)]
    adamw_bytes = opt_bytes(state_b["opt"])

    sched = dict(learning_rate=TP_OPT_LR, warmup_steps=1,
                 total_steps=TP_STEPS)
    opt_runs = {}
    for name in ("adafactor", "sgd"):
        for where, m, want in (("one", None, one_k), ("tp", mesh, tp_k)):
            _, ostate, olosses = run(f"(d) {name} {where}", m,
                                     {"optimizer": name, **sched}, want)
            opt_runs[name, where] = (olosses, [x.clone() for x in
                                               leaves(ostate)],
                                     opt_bytes(ostate["opt"]))
            del ostate
    torch.cuda.empty_cache()

    ccfg = flagship_train_config(COMPOSE["layers"], COMPOSE["seq"],
                                 attention_impl="zigzag_flash")
    cmesh = make_mesh_nd(8, devices=[dev] * 8)
    cdp = cmesh.shape["dp"]
    check(tuple(cmesh.shape.values()) == (2, 2, 2),
          f"composition mesh {cmesh.shape}")
    ctoks = torch.from_numpy(np.random.default_rng(1).integers(
        0, ccfg.vocab, (COMPOSE["batch"], COMPOSE["seq"] + 1))).to(dev)
    cp0 = init_params(ccfg, torch.Generator().manual_seed(1), dev)
    ring_k = ring_launches("zigzag_flash", cmesh.shape["sp"],
                           COMPOSE["layers"], False)
    ck6 = 1 + tp_launches(COMPOSE["layers"], cdp)
    comp = {}
    for mode in ("dp", "fsdp"):
        k5 = cdp * (1 + COMPOSE["layers"]) if mode == "fsdp" else 0
        want = [cdp * k for k in ring_k[:3]] + [k5, ck6, cdp * ring_k[3]]
        _, cstate, closs = run(f"(e) composition {mode}", cmesh,
                               {"fsdp": mode == "fsdp"}, want, ccfg, cp0,
                               ctoks, COMPOSE["steps"])
        check(cstate["layout"].rest == 0,
              f"composition {mode}: replicated leaves at dp {cdp}")
        comp[mode] = (closs, leaves(cstate))
        del cstate
    main_counts = dict(zip(names, counts()))
    check(comp["fsdp"][0] == comp["dp"][0] and all(
        bits_equal(a, b) for a, b in zip(comp["fsdp"][1], comp["dp"][1])),
        f"composition: fsdp losses {comp['fsdp'][0]} or parameters differ "
        f"from plain dp's {comp['dp'][0]} in their bits")
    print(f"(e) composition (dp 2, sp 2, tp 2; zigzag_flash, "
          f"{COMPOSE['layers']} layers, seq {COMPOSE['seq']}, batch "
          f"{COMPOSE['batch']}): plain dp losses {comp['dp'][0]}, fsdp "
          f"{comp['fsdp'][0]}, the same bits, parameters too; launches per "
          f"step of kernels 1-3, 5, 6, 7 as counted from the code (kernels "
          f"1-3 {ring_k[0] * cdp}, kernel 6 {ck6}: 1 bucket and "
          f"{ck6 - 1} tp reductions, kernel 7 {ring_k[3] * cdp})")
    del cp0
    torch.cuda.empty_cache()

    # ---- (c) the faulty control, and (b) with bf16 partials ---------------
    def rank_zero(contribs, ring, op="sum"):
        return contribs[:1].expand_as(contribs)

    tpm.ring_allreduce = rank_zero
    try:
        _, cstate, losses_c = run("(c) control", mesh, {},
                                  [layers, layers, layers, 0, 0])
    finally:
        tpm.ring_allreduce = ring_allreduce
    ctrl = [x.clone() for x in leaves(cstate)]
    del cstate
    tpm.REDUCE_DTYPE = torch.bfloat16
    try:
        _, hstate, losses_h = run("(b) bf16 partials", mesh, {}, tp_k)
    finally:
        tpm.REDUCE_DTYPE = torch.float32
    half = [x.clone() for x in leaves(hstate)]
    del hstate
    torch.cuda.empty_cache()

    # ---- agreement ---------------------------------------------------------
    gaps = {"(b)": (loss_gaps(losses_b, one_losses),
                    rel_gap(full_b, one_leaves, p0)),
            "(c)": (loss_gaps(losses_c, one_losses),
                    rel_gap(ctrl, one_leaves, p0)),
            "(b) bf16 partials": (loss_gaps(losses_h, one_losses),
                                  rel_gap(half, one_leaves, p0))}
    for name in ("adafactor", "sgd"):
        got, ref = opt_runs[name, "tp"], opt_runs[name, "one"]
        gaps[f"(d) {name}"] = (loss_gaps(got[0], ref[0]),
                               rel_gap(got[1], ref[1], p0))
    print(f"tensor-parallel flagship, {n} tp ranks on the card ({TP_STEPS} "
          f"steps, batch 8, seq {cfg.max_seq - 1}): losses (a) one device "
          f"{one_losses}, (b) tp 8 {losses_b}, (c) control {losses_c}, (b) "
          f"with bf16 partials {losses_h}; (d) "
          f"{ {f'{k[0]} {k[1]}': v[0] for k, v in opt_runs.items()} }")
    for label, (lg, pg) in gaps.items():
        print(f"{label} against one device: relative loss gaps {lg} (rtol "
              f"{TP_LOSS_RTOL}), parameter gap ||p - p_one|| / ||p_one - "
              f"p_0|| {pg!r} (limit {TP_PARAM_REL})")
    for label in ("(b)", "(d) adafactor", "(d) sgd"):
        lg, pg = gaps[label]
        check(max(lg) <= TP_LOSS_RTOL and pg <= TP_PARAM_REL,
              f"{label}: loss gaps {lg} or parameter gap {pg} to one device "
              f"outside rtol {TP_LOSS_RTOL} / limit {TP_PARAM_REL}")
    lg, pg = gaps["(c)"]
    check(min(lg) > TP_LOSS_RTOL and pg > TP_PARAM_REL,
          f"control (rank 0's partials alone): loss gaps {lg} or parameter "
          f"gap {pg} inside rtol {TP_LOSS_RTOL} / limit {TP_PARAM_REL}")
    sound = {"(a)": one_losses, "(b)": losses_b,
             "(e) dp": comp["dp"][0], "(e) fsdp": comp["fsdp"][0],
             **{f"(d) {k[0]} {k[1]}": v[0] for k, v in opt_runs.items()}}
    for label, ls in sound.items():
        check(ls[-1] < ls[0], f"{label} loss did not fall: {ls}")
    fac_bytes = opt_runs["adafactor", "one"][2]
    print(f"optimizer state bytes: AdamW {adamw_bytes}, adafactor "
          f"{fac_bytes} ({fac_bytes / adamw_bytes!r} of AdamW's), sgd "
          f"{opt_runs['sgd', 'one'][2]}")
    check(fac_bytes < 0.6 * adamw_bytes,
          f"adafactor state {fac_bytes} bytes, not under 0.6 of AdamW's "
          f"{adamw_bytes}")
    del ctrl, half, comp, opt_runs
    torch.cuda.empty_cache()

    # ---- kernel 6 against plain at the tp shapes -------------------------
    ring = axis_ring(mesh, "tp")
    gen = torch.Generator(device=dev).manual_seed(10)
    m = 8 * (cfg.max_seq - 1) * cfg.d_model  # a (b, s, d) activation
    rows = 8 * (cfg.max_seq - 1)  # the loss's row max
    errs = {"ring_allreduce": 0.0}
    for label, x, op in (
            ("the (b, s, d) partials", torch.randn(n, m, generator=gen,
                                                   device=dev), "sum"),
            ("the row max", torch.randn(n, rows, generator=gen,
                                        device=dev), "max")):
        got, ref = ring_allreduce(x, ring, op), ring_allreduce_plain(x, op)
        torch.cuda.synchronize()
        check(bits_equal(got, ref), f"kernel 6 on {label} {tuple(x.shape)} "
                                    f"({op}) differs from its plain version")
        errs["ring_allreduce"] = max(errs["ring_allreduce"],
                                     max_abs_diff(got, ref))
        del got, ref
    x = torch.randn(n, m, generator=gen, device=dev)
    ar_ms = kernel_ms(lambda c: ring_allreduce(c, ring), [(x,)], 20)
    ar_bound = bound(2 * n * m * 4, (n - 1) * m, torch.float32)[0]
    print(f"kernel 6 at the tp shapes, bitwise equal to plain (sum of "
          f"({n}, {m}) float32 partials, max of ({n}, {rows})); the partials' "
          f"all-reduce {ar_ms * 1e3!r} us against a {ar_bound * 1e3!r} us "
          f"bound  [{card}]")
    del x
    torch.cuda.empty_cache()

    # ---- times ------------------------------------------------------------
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    host = time.perf_counter()
    for _ in range(TP_TIMED_STEPS):
        step_b(state_b, tokens)
    host = (time.perf_counter() - host) * 1e3 / TP_TIMED_STEPS
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / TP_TIMED_STEPS
    print(f"(b) tp 8: {ms!r} ms per step (CUDA events over {TP_TIMED_STEPS} "
          f"steps after {TP_STEPS}), host enqueue {host!r} ms per step; (a) "
          f"one device {one_ms!r} ms per step (phase 9)  [{card}]")
    prof = profile_steps(lambda: step_b(state_b, tokens), 1, "(b) tp 8", ms,
                         card)
    if prof is not None:
        g = prof["groups"]
        print(f"(b) tp 8: kernel 6 {g.get('all-reduce kernel 6', (0, 0))} "
              f"(ms, launches) a step; device busy share {prof['busy']!r}; "
              f"{prof['launches']!r} launches a step  [{card}]")
    del state_b
    torch.cuda.empty_cache()
    print(f"tensor-parallel phase launches (main path: (b), (d) and (e)): "
          f"{main_counts}")
    return main_counts, errs


def pp_launches(layers, micro, stages, remat=False):
    """Launches of kernels 1, 2, 3 and 7 in one pipelined training step,
    counted from the code (``parallel/pipeline.py``,
    ``models/pipeline_lm.py``): every microbatch runs every layer once
    (kernel 1 again in remat's replay, kernels 2 and 3 in the backward),
    and the schedule hops M + S − 2 times forward and as many backward."""
    replay = 2 if remat else 1
    hops = micro + stages - 2
    return [micro * layers * replay, micro * layers, micro * layers,
            2 * hops]


def pp_slice(dev, card, one):
    """Phase 11: pipeline-parallel training of the flagship (8 layers, seq
    1024, batch 8, bf16 over float32 masters, flash attention, AdamW at lr
    1e-3) over a ``("pp",)`` mesh of PP_STAGES ranks on the card (2 layers
    a stage, PP_MICRO microbatches of 2 rows), from the seeded parameters
    of phase 9's single-device step, handed in as ``one`` (losses,
    parameters after DP_STEPS steps, ms per step; run here when None):
    (a) pp 4, PP_STEPS
    steps; (b) the same with ``remat_stage``; (c) pp 8 × 8 microbatches (1
    layer and 1 row a stage) for one step; (d) a faulty control, (a) with a
    hop that hands each stage the activation of two steps back, so stage
    s + 1 takes its microbatch one step late. Checks, each raising: every
    step's launches of kernels 1-3 and 7 against pp_launches; (a) and (b)
    against one device within PP_LOSS_RTOL (losses) and PP_PARAM_REL
    (parameters after PP_STEPS steps), (c)'s loss against one device's
    first; the control outside both; falling losses. Then (a)'s ms per
    step over PP_TIMED_STEPS steps (CUDA events) and the host's enqueue,
    beside one device's, and a profile of one step. Returns {kernel:
    launches on this phase's main path, (a)-(c)}."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (init_params,
                                      make_pipelined_train_step,
                                      make_train_step, stack_block_params)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.parallel import make_mesh, sendrecv
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.train import flagship_train_config

    pmod = importlib.import_module("mpi_tpu_torch.parallel.pipeline")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv, "sendrecv": sendrecv}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    cfg = flagship_train_config()
    layers = cfg.n_layers
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    params0 = init_params(cfg, torch.Generator().manual_seed(0), dev)
    if one is None:  # this phase alone: its own single-device steps
        init_state, step = make_train_step(cfg)
        ostate = init_state.from_params(clone_tree(params0))
        one = ([float(step(ostate, tokens)[1]) for _ in range(PP_STEPS)],
               [x.detach() for x in tree_leaves(ostate["params"])], None)
        del ostate
    one_losses, one_leaves, one_ms = one
    p0 = [x.detach() for x in tree_leaves(params0)]

    def flat(params):
        """A pipelined tree's leaves in init_params' order (the blocks
        unstacked), as one_leaves holds them."""
        stages = tree_leaves(params["stages"])
        blocks = [[x.flatten(0, 1)[i] for x in stages]
                  for i in range(layers)]
        return [x.detach() for k in params0 for x in (
            [y for b in blocks for y in b] if k == "blocks"
            else tree_leaves(params[k]))]

    def run(label, stages, micro, steps, want, **kw):
        mesh = make_mesh(axis="pp", devices=[dev] * stages)
        init_state, step = make_pipelined_train_step(
            cfg, mesh, microbatches=micro, **kw)
        state = init_state.from_params(
            stack_block_params(clone_tree(params0), stages))
        losses = []
        for i in range(steps):
            before = counts()
            state, loss = step(state, tokens)
            got = [a - b for a, b in zip(counts(), before)]
            check(got == want,
                  f"{label} step {i}: kernels {names} launched {got} "
                  f"times, want {want} (counted from the code)")
            losses.append(float(loss))
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        return step, state, losses

    # ---- the main path: (a)-(c), counted alone ---------------------------
    for w in wrappers.values():
        w.launches = 0
    want_a = pp_launches(layers, PP_MICRO, PP_STAGES)
    step_a, state_a, losses_a = run("(a) pp 4", PP_STAGES, PP_MICRO,
                                    PP_STEPS, want_a)
    full_a = flat(state_a["params"])
    _, rstate, losses_r = run(
        "(b) pp 4 remat_stage", PP_STAGES, PP_MICRO, PP_STEPS,
        pp_launches(layers, PP_MICRO, PP_STAGES, remat=True),
        remat_stage=True)
    full_r = flat(rstate["params"])
    del rstate
    _, _, losses_8 = run("(c) pp 8 x 8", 8, 8, 1, pp_launches(layers, 8, 8))
    main_counts = dict(zip(names, counts()))
    torch.cuda.empty_cache()

    # ---- (d) the faulty control: each stage one step late ------------------
    real = pmod.ring_shift
    hops = PP_MICRO + PP_STAGES - 2
    held = []

    def late(y, ring):
        if len(held) == hops:  # a new pipeline call
            held.clear()
        held.append(y)
        return real(held[-2] if len(held) > 1 else torch.zeros_like(y),
                    ring)

    pmod.ring_shift = late
    try:  # the first hop of a call sends zeros: no backward hop for it
        _, cstate, losses_c = run("(d) control", PP_STAGES, PP_MICRO,
                                  PP_STEPS, want_a[:3] + [want_a[3] - 1])
    finally:
        pmod.ring_shift = real
    full_c = flat(cstate["params"])
    del cstate
    held.clear()
    torch.cuda.empty_cache()

    # ---- agreement ---------------------------------------------------------
    gaps = {label: (loss_gaps(ls, one_losses),
                    rel_gap(full, one_leaves, p0))
            for label, ls, full in (("(a)", losses_a, full_a),
                                    ("(b)", losses_r, full_r),
                                    ("(d)", losses_c, full_c))}
    gap_8 = loss_gaps(losses_8, one_losses[:1])
    remat_bits = losses_r == losses_a and all(
        bits_equal(a, b) for a, b in zip(full_r, full_a))
    print(f"pipeline-parallel flagship, {PP_STAGES} pp ranks on the card "
          f"({PP_MICRO} microbatches of {8 // PP_MICRO} rows, {PP_STEPS} "
          f"steps, seq {cfg.max_seq - 1}): losses one device {one_losses}, "
          f"(a) pp 4 {losses_a}, (b) remat_stage {losses_r} (bitwise (a)'s "
          f"losses and parameters: {remat_bits}), (c) pp 8 x 8 {losses_8}, "
          f"(d) control {losses_c}")
    for label, (lg, pg) in gaps.items():
        print(f"{label} against one device: relative loss gaps {lg} (rtol "
              f"{PP_LOSS_RTOL}), parameter gap ||p - p_one|| / ||p_one - "
              f"p_0|| {pg!r} (limit {PP_PARAM_REL})")
    print(f"(c) pp 8 x 8 first loss against one device's: {gap_8} (rtol "
          f"{PP_LOSS_RTOL})")
    for label in ("(a)", "(b)"):
        lg, pg = gaps[label]
        check(max(lg) <= PP_LOSS_RTOL and pg <= PP_PARAM_REL,
              f"{label}: loss gaps {lg} or parameter gap {pg} to one device "
              f"outside rtol {PP_LOSS_RTOL} / limit {PP_PARAM_REL}")
    check(gap_8[0] <= PP_LOSS_RTOL,
          f"(c) pp 8 x 8: first loss gap {gap_8} outside {PP_LOSS_RTOL}")
    lg, pg = gaps["(d)"]
    check(max(lg) > PP_LOSS_RTOL and pg > PP_PARAM_REL,
          f"control (a stage one step late): loss gaps {lg} or parameter "
          f"gap {pg} inside rtol {PP_LOSS_RTOL} / limit {PP_PARAM_REL}")
    for label, ls in (("(a)", losses_a), ("(b)", losses_r)):
        check(ls[-1] < ls[0], f"{label} loss did not fall: {ls}")
    del full_a, full_r, full_c

    # ---- times ------------------------------------------------------------
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    host = time.perf_counter()
    for _ in range(PP_TIMED_STEPS):
        step_a(state_a, tokens)
    host = (time.perf_counter() - host) * 1e3 / PP_TIMED_STEPS
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / PP_TIMED_STEPS
    print(f"(a) pp 4: {ms!r} ms per step (CUDA events over {PP_TIMED_STEPS} "
          f"steps after {PP_STEPS}), host enqueue {host!r} ms per step; one "
          f"device {one_ms!r} ms per step (phase 9)  [{card}]")
    prof = profile_steps(lambda: step_a(state_a, tokens), 1, "(a) pp 4", ms,
                         card)
    if prof is not None:
        g = prof["groups"]
        print(f"(a) pp 4: kernels 1-3 "
              f"{g.get('flash attention kernels 1-3', (0, 0))}, kernel 7 "
              f"{g.get('send/receive kernel 7', (0, 0))} (ms, launches) a "
              f"step; device busy share {prof['busy']!r}; "
              f"{prof['launches']!r} launches a step  [{card}]")
    del state_a
    torch.cuda.empty_cache()
    print(f"pipeline phase launches (main path: (a)-(c)): {main_counts}; "
          f"per step, counted from the code: (a) {want_a}, (b) "
          f"{pp_launches(layers, PP_MICRO, PP_STAGES, remat=True)}, (c) "
          f"{pp_launches(layers, 8, 8)}")
    return main_counts


def halo_slice(dev, card):
    """Phase 12: compiled halos at a real size. (a) 5-point Jacobi over a
    HALO_GRID² float32 grid (1 GiB) on a ``("row", "col")`` mesh of (2, 4)
    ranks on the card, HALO_SWEEPS sweeps, Dirichlet 0 and periodic; (b)
    3-point Jacobi over a rod of HALO_ROD float32 cells (1 GiB) on 8 ranks,
    HALO_SWEEPS sweeps, Dirichlet 0. Each must equal the dense sweep of the
    whole tensor on the card bit for bit (the same float32 neighbours
    added in the same order), and launch kernel 7 four times a 2-D sweep
    and twice a 1-D sweep. Reports ms a sweep against the dense sweep's,
    and kernel 7 against its plain version (bitwise), its time, its bound
    and one ``index_select``'s at the pipeline's hop, (4, 2, 1024, 1024)
    bf16, and at the halo edges. Returns ({"sendrecv": launches on this
    phase's main path, (a)-(b)}, max |kernel 7 - plain|)."""
    import torch
    import torch.nn.functional as F

    from mpi_tpu_torch.parallel import (RankMesh, jacobi_step_1d,
                                        jacobi_step_2d, make_mesh, sendrecv,
                                        sendrecv_plain)
    from mpi_tpu_torch.parallel.halo import _pattern

    gen = torch.Generator(device=dev).manual_seed(12)
    rows, cols = 2, 4
    mesh2 = RankMesh([dev] * 8, ("row", "col"), (rows, cols))
    mesh1 = make_mesh(devices=[dev] * 8)

    def dense_2d(u, periodic):
        p = torch.cat([u[-1:], u, u[:1]], 0) if periodic else \
            F.pad(u, (0, 0, 1, 1))
        p = torch.cat([p[:, -1:], p, p[:, :1]], 1) if periodic else \
            F.pad(p, (1, 1))
        return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2]
                + p[1:-1, 2:]) * 0.25

    def dense_1d(u):
        p = F.pad(u, (1, 1))
        return (p[:-2] + p[2:]) * 0.5

    def blocks_2d(u):
        bi, bj = u.shape[0] // rows, u.shape[1] // cols
        return u.reshape(rows, bi, cols, bj).transpose(1, 2).reshape(
            rows * cols, bi, bj)

    def grid_2d(b):
        bi, bj = b.shape[1:]
        return b.reshape(rows, cols, bi, bj).transpose(1, 2).reshape(
            rows * bi, cols * bj)

    def sweeps(fn, u):
        """HALO_SWEEPS sweeps of ``fn``: (result, device ms a sweep)."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(HALO_SWEEPS):
            u = fn(u)
        end.record()
        torch.cuda.synchronize()
        return u, start.elapsed_time(end) / HALO_SWEEPS

    cases = (("2-D", HALO_GRID, False), ("2-D", HALO_GRID, True),
             ("1-D", HALO_ROD, False))
    sendrecv.launches = 0  # the main path: (a) and (b), counted alone
    results = []
    for dims, size, periodic in cases:
        if dims == "2-D":
            u0 = torch.randn(size, size, generator=gen, device=dev)
            want, dense_ms = sweeps(lambda u: dense_2d(u, periodic), u0)
            before = sendrecv.launches
            got, halo_ms = sweeps(lambda b: jacobi_step_2d(
                b, mesh2, periodic=periodic), blocks_2d(u0))
            got = grid_2d(got)
            per_sweep = 4
        else:
            u0 = torch.randn(size, generator=gen, device=dev)
            want, dense_ms = sweeps(dense_1d, u0)
            before = sendrecv.launches
            got, halo_ms = sweeps(lambda b: jacobi_step_1d(
                b, mesh1, periodic=periodic), u0.reshape(8, -1))
            got = got.reshape(-1)
            per_sweep = 2
        launches = (sendrecv.launches - before) / HALO_SWEEPS
        label = (f"{dims} {tuple(u0.shape)} float32 "
                 f"{'periodic' if periodic else 'Dirichlet 0'}")
        check(bool(torch.isfinite(got).all()), f"{label}: non-finite values")
        check(bits_equal(got, want),
              f"{label}: {HALO_SWEEPS} halo sweeps differ from the dense "
              f"sweeps by up to {max_abs_diff(got, want)}")
        check(launches == per_sweep,
              f"{label}: kernel 7 launched {launches} times a sweep, want "
              f"{per_sweep}")
        ranks = "(2, 4) row x col" if dims == "2-D" else "8"
        print(f"halo {label} over {ranks} ranks, {HALO_SWEEPS} sweeps: "
              f"bitwise the dense sweep's; "
              f"{halo_ms!r} ms a sweep against the dense sweep's "
              f"{dense_ms!r} (CUDA events); kernel 7 {launches!r} launches "
              f"a sweep  [{card}]")
        results.append((label, halo_ms, dense_ms))
        del u0, want, got
        torch.cuda.empty_cache()
    main_counts = {"sendrecv": sendrecv.launches}

    # ---- kernel 7 at the pipeline's hop and at the halo edges ------------
    err = 0.0
    hop = torch.randn(PP_STAGES, 8 // PP_MICRO, 1024, 1024, generator=gen,
                      device=dev).to(torch.bfloat16)
    rows_edge = torch.randn(8, 1, HALO_GRID // cols, generator=gen,
                            device=dev)
    cols_edge = torch.randn(8, HALO_GRID // rows, 1, generator=gen,
                            device=dev)
    ring = [(r, (r + 1) % PP_STAGES) for r in range(PP_STAGES)]
    senders = torch.tensor([(r - 1) % PP_STAGES for r in range(PP_STAGES)],
                           device=dev)
    hop_mesh = make_mesh(axis="pp", devices=[dev] * PP_STAGES)
    shapes = [("the pipeline's hop", hop, hop_mesh, ring, senders)]
    for axis, edge in (("row", rows_edge), ("col", cols_edge)):
        pairs, _ = _pattern(mesh2, axis, 1, False)
        src = torch.zeros(8, dtype=torch.long, device=dev)
        for a, b in pairs:
            src[b] = a
        shapes.append((f"a 2-D {axis} edge", edge, mesh2, pairs, src))
    pairs, _ = _pattern(mesh1, "rank", 1, False)
    src = torch.tensor([max(r - 1, 0) for r in range(8)], device=dev)
    shapes.append(("a 1-D edge", cols_edge[:, :1, 0].contiguous(), mesh1,
                   pairs, src))
    for label, x, m, perm, src in shapes:
        got = sendrecv(x, m, perm)
        ref = sendrecv_plain(x, perm)
        torch.cuda.synchronize()
        check(bits_equal(got, ref), f"kernel 7 at {label} "
                                    f"{tuple(x.shape)} differs from its "
                                    f"plain version")
        err = max(err, max_abs_diff(got, ref))
        moved = 2 * x.numel() * x.element_size()
        k_ms = kernel_ms(lambda y: sendrecv(y, m, perm), [(x,)], 50)
        p_ms = kernel_ms(lambda y: sendrecv_plain(y, perm), [(x,)], 20)
        l_ms = kernel_ms(lambda y: y.index_select(0, src), [(x,)], 50)
        b_ms, b_by = bound(moved, 0, x.dtype)
        print(f"kernel 7 at {label} {tuple(x.shape)} {x.dtype}, bitwise "
              f"plain: {k_ms * 1e3!r} us against a {b_ms * 1e3!r} us bound "
              f"({b_by}), plain {p_ms * 1e3!r} us, index_select "
              f"{l_ms * 1e3!r} us  [{card}]")
    del hop, rows_edge, cols_edge
    torch.cuda.empty_cache()
    print(f"halo phase launches (main path: (a)-(b)): {main_counts}")
    return main_counts, err


def moe_config(base, **kw):
    """``base`` (a flagship config) with the MoE flagship's experts:
    MOE_EXPERTS experts, top-MOE_TOP_K routing, capacity factor
    MOE_CAPACITY."""
    import dataclasses

    return dataclasses.replace(base, n_experts=MOE_EXPERTS,
                               moe_top_k=MOE_TOP_K,
                               capacity_factor=MOE_CAPACITY, **kw)


def moe_step_launches(layers, dp=1, ep=1, tp=1, mode="dp", rest=0):
    """Launches of kernels 1, 2, 3, 6 and 5 in one MoE training step over a
    (dp, ep, tp) mesh, counted from the code (``models/moe.py``,
    ``models/transformer.py``, ``parallel/tensor_parallel.py``): each dp
    rank launches kernels 1-3 once a layer; where ep·tp is above 1, kernel
    6 twice a layer over the experts' ep × tp ring (their partials summed
    forward, the gradient to their input backward); where tp is above 1,
    twice a layer over the tp ring for the attention (the reduce after wo,
    the copy's backward before q/k/v) and four times once (the embedding's
    reduce, the logits' copy backward, the loss's row max and its sums:
    :func:`tp_launches` less the dense FFN's); a dp axis above 1 adds the
    fractions of first
    choices and the gradient bucket's reduction: plain dp one all-reduce,
    zero1 and fsdp one reduce-scatter and one all-reduce more where
    ``rest`` values are replicated; zero1 gathers the parameters in one
    kernel-5 launch, fsdp each rank's top group and each of its blocks.
    ``tests/test_torch_moe_kernels.py`` holds its card steps to this count
    too."""
    k6 = dp * (2 * layers * (ep * tp > 1) + (tp > 1) * (2 * layers + 4))
    k5 = 0
    if dp > 1:
        k6 += 1 + (1 if mode == "dp" else 1 + bool(rest))
        k5 = {"zero1": 1, "fsdp": dp * (1 + layers)}.get(mode, 0)
    return [dp * layers] * 3 + [k6, k5]


def moe_launches(layers, requests, new_tokens, steps, ep_steps, runs):
    """Launches of kernels 1-6 on phase 13's main path, counted from the
    code (``models/generate.py`` and :func:`moe_step_launches`): (a) each
    request's decode steps launch kernel 4 once a layer (the first new
    token comes from the prefill, on the dense cached path); (b) each
    single-device step kernels 1-3 once a layer; (c)-(e) ``ep_steps``
    steps of each mesh run, ``runs`` holding each run's launches a step
    (:func:`moe_step_launches`)."""
    k = [steps * layers] * 3 + [0, 0]
    for per_step in runs:
        k = [a + ep_steps * b for a, b in zip(k, per_step)]
    return {"flash_fwd": k[0], "flash_bwd_dq": k[1], "flash_bwd_dkv": k[2],
            "flash_decode_attention": requests * layers * (new_tokens - 1),
            "ring_allreduce": k[3], "ring_allgather": k[4]}


class RecordedRoutes:
    """While active, every routing of ``models.moe.route`` is kept:
    ``seen`` holds each call's (topk_idx, kept), in call order."""

    def __enter__(self):
        import importlib

        self.moe = importlib.import_module("mpi_tpu_torch.models.moe")
        self.route, self.seen = self.moe.route, []

        def recording(*args):
            out = self.route(*args)
            self.seen.append((out[2].clone(), out[3].clone()))
            return out

        self.moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def differ(self, other):
        """(choices whose expert differs, choices whose slot verdict
        differs, choices compared) against another recording of the same
        calls."""
        check(len(self.seen) == len(other.seen),
              f"{len(self.seen)} routings against {len(other.seen)}")
        idx = kept = total = 0
        for (i1, k1), (i2, k2) in zip(self.seen, other.seen):
            idx += int((i1 != i2).sum())
            kept += int((k1 != k2).sum())
            total += i1.numel()
        return idx, kept, total


def moe_slice(dev, card, dense_ms):
    """Phase 13: the Mixture-of-Experts flagship (the flagship with
    MOE_EXPERTS experts, top-MOE_TOP_K routing, capacity factor
    MOE_CAPACITY) served, trained on one device and trained over rank
    meshes on the card. Main path, counted alone: (a) N_REQUESTS requests
    of BATCH x PROMPT_LEN prompts + NEW_TOKENS through ``generate`` (bf16,
    kernel 4 for each decode step); (b) TRAIN_STEPS AdamW steps at full
    width and depth (bf16 over float32 masters, flash attention, batch 8,
    seq 1024), the first MOE_EP_STEPS of which are the reference of
    (c)-(e); (c) MOE_EP_STEPS steps over ``("dp", "ep")`` meshes of
    MOE_EP_MESHES ranks; (d) over ``("dp", "ep", "tp")`` meshes of
    MOE_TP_MESHES ranks (each expert's d_ff over tp); (e) each of
    MOE_ZERO_RUNS (plain dp, zero1 and fsdp with experts); each from (b)'s
    seeded state and batch, every copy kernel 6 writes in its first step
    checked to hold the same bits and its routing there counted against
    (b)'s, the steps after the first timed (CUDA events, kernel 6
    unchecked) with the run's peak memory, and one more step of each (c)
    run profiled outside the count. Then, outside the count: four faulty
    controls: the experts' partial outputs reduced to rank 0's alone on
    (1, 8), which must miss the tolerances,
    each dp rank's own aux penalty on (2, 4), measured, (d)'s partials of
    tp coordinate 0 alone on (1, 4, 2) and (e)'s rank 0's gradient alone
    in the fsdp reduce-scatter on (4, 2), both of which must miss; (a)'s
    teacher-forced float32 logits, flash-decode kernel against dense
    decode, with the routing decisions that differ counted; int8 weights'
    greedy agreement with bf16; ms per generated token; one float32
    training step with flash against dense attention (the loss within
    MOE_F32_LOSS_RTOL, the routing decisions that differ counted); kernel
    6 against its plain version at the (ep·tp, …) partial shapes
    (bitwise) and its time; (b)'s ms per step beside the dense flagship's
    ``dense_ms`` (phase 4). Returns {kernel: launches on the main path}."""
    import dataclasses
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (full_params, generate, init_params,
                                      loss_fn, make_train_step,
                                      quantize_params)
    from mpi_tpu_torch.models.generate import decode_step, prefill
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce,
                                                    ring_allreduce_plain)
    from mpi_tpu_torch.parallel import RankMesh
    from mpi_tpu_torch.parallel.tensor_parallel import tp_ring
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.serve import flagship_config
    from mpi_tpu_torch.train import flagship_train_config

    tpm = importlib.import_module("mpi_tpu_torch.parallel.tensor_parallel")
    tfm = importlib.import_module("mpi_tpu_torch.models.transformer")
    colm = importlib.import_module("mpi_tpu_torch.parallel.collectives")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allreduce": ring_allreduce,
                "ring_allgather": ring_allgather}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    scfg = moe_config(flagship_config())
    tcfg = moe_config(flagship_train_config())
    layers = tcfg.n_layers
    steps = NEW_TOKENS - 1

    # ---- the main path: (a)-(e), counted alone ----------------------------
    hgen = torch.Generator().manual_seed(0)
    sparams = init_params(scfg, hgen)
    prompts = [torch.randint(0, scfg.vocab, (BATCH, PROMPT_LEN),
                             generator=hgen) for _ in range(N_REQUESTS)]
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (8, tcfg.max_seq))).to(dev)
    params0 = init_params(tcfg, torch.Generator().manual_seed(0), dev)
    p0 = [x.detach().clone() for x in tree_leaves(params0)]
    copies = {"check": False, "calls": 0, "differ": 0}

    def checked(contribs, ring, op="sum"):
        """Kernel 6 as the ep, tp and dp reductions and the reduce-scatter
        call it; while ``copies["check"]`` is set (a mesh run's first
        step, untimed) every rank's copy of the result must hold copy 0's
        bits."""
        out = ring_allreduce(contribs, ring, op)
        if copies["check"]:
            bits = out.view({2: torch.int16,
                             4: torch.int32}[out.element_size()])
            copies["calls"] += 1
            copies["differ"] += int(not bool((bits == bits[:1]).all()))
        return out

    def step_launches(label, i, before, want):
        got = [a - b for a, b in zip(counts(), before)]
        got = got[:3] + got[4:]
        check(want is None or got == want,
              f"{label} step {i}: kernels 1-3, 6 and 5 launched {got} "
              f"times, want {want} (counted from the code)")

    def mesh_run(label, shape, mode="dp", count=True, profile=False):
        """MOE_EP_STEPS AdamW steps from (b)'s seeded state over a
        ``("dp", "ep"[, "tp"])`` mesh of ``shape`` in ``mode`` (plain dp,
        zero1 or fsdp), the state dropped after. Step 0 runs with kernel
        6's copies checked and its routing recorded; the steps after it
        are timed (CUDA events and the host's clock) with nothing checked
        between their launches. With ``count`` each step's launches of
        kernels 1-3, 6 and 5 must equal moe_step_launches'; with
        ``profile`` one more step is profiled, outside the main path's
        count. Returns a dict: ``losses``, ``params`` (full), ``routes``
        (step 0's), ``ms`` and ``host_ms`` a step, ``peak`` (bytes
        allocated in the run), ``base`` (held before it), ``want``
        (launches a step), ``rest`` (replicated values)."""
        mesh = RankMesh([dev] * int(np.prod(shape)),
                        ("dp", "ep", "tp")[:len(shape)], shape)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        init_state, step = make_train_step(
            tcfg, mesh=mesh, **({} if mode == "dp" else {mode: True}))
        state = init_state.from_params(clone_tree(params0))
        rest = state["layout"].rest if "layout" in state else 0
        want = moe_step_launches(layers, *shape, mode=mode, rest=rest)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        losses = []
        for i in range(MOE_EP_STEPS):
            before = counts()
            if i == 0:
                copies["check"] = True
                try:
                    with RecordedRoutes() as rec:
                        state, loss = step(state, tokens)
                finally:
                    copies["check"] = False
                torch.cuda.synchronize()
                t0.record()
                host = time.perf_counter()
            else:
                state, loss = step(state, tokens)
            step_launches(label, i, before, want if count else None)
            losses.append(loss)
        t1.record()
        host = (time.perf_counter() - host) * 1e3 / (MOE_EP_STEPS - 1)
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / (MOE_EP_STEPS - 1)
        peak = torch.cuda.max_memory_allocated(dev)
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        params = [x.detach().clone() for x in tree_leaves(full_params(state))]
        if profile:
            saved = counts()
            prof = profile_steps(lambda: step(state, tokens), 1, label, ms,
                                 card)
            for w, n in zip(wrappers.values(), saved):
                w.launches = n  # the profiled step is outside the count
            if prof is not None:
                g = prof["groups"]
                print(f"{label}: kernel 6 "
                      f"{g.get('all-reduce kernel 6', (0, 0))}, kernel 5 "
                      f"{g.get('all-gather kernel 5', (0, 0))} (ms, "
                      f"launches) a step; device busy share "
                      f"{prof['busy']!r}; {prof['launches']!r} launches a "
                      f"step  [{card}]")
        del state, step, init_state
        torch.cuda.empty_cache()
        return {"losses": losses, "params": params, "routes": rec.seen,
                "ms": ms, "host_ms": host, "peak": peak, "base": base,
                "want": want, "rest": rest}

    for w in wrappers.values():
        w.launches = 0
    outs = []
    for i, prompt in enumerate(prompts):
        before = flash_decode_attention.launches
        toks = generate(sparams, prompt, scfg, NEW_TOKENS)
        got = flash_decode_attention.launches - before
        check(got == layers * steps,
              f"MoE request {i}: decode kernel launched {got} times, want "
              f"{layers} layers x {steps} steps")
        check(tuple(toks.shape) == (BATCH, NEW_TOKENS) and
              bool(((toks >= 0) & (toks < scfg.vocab)).all()),
              f"MoE request {i}: tokens {tuple(toks.shape)} outside the "
              f"vocab or of the wrong shape")
        outs.append(toks)

    # (b): the first MOE_EP_STEPS steps are (c)-(e)'s reference (losses,
    # parameters, step 0's routing); timed after one more warm-up step.
    init_state, bstep = make_train_step(tcfg)
    bstate = init_state.from_params(clone_tree(params0))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    blosses = []
    for i in range(TRAIN_STEPS):
        if i == MOE_EP_STEPS + 1:
            start.record()
        before = counts()
        if i == 0:
            with RecordedRoutes() as one_routes:
                bstate, loss = bstep(bstate, tokens)
        else:
            bstate, loss = bstep(bstate, tokens)
        step_launches("(b) one device", i, before, moe_step_launches(layers))
        blosses.append(loss)
        if i == MOE_EP_STEPS - 1:
            one_leaves = [x.detach().clone()
                          for x in tree_leaves(bstate["params"])]
    end.record()
    torch.cuda.synchronize()
    one_ms = start.elapsed_time(end) / (TRAIN_STEPS - MOE_EP_STEPS - 1)
    blosses = [float(x) for x in blosses]
    check(all(np.isfinite(blosses)) and blosses[-1] < blosses[0],
          f"(b) MoE losses not finite or not falling: {blosses}")
    one = (blosses[:MOE_EP_STEPS], one_leaves)
    del bstate, bstep, init_state
    torch.cuda.empty_cache()

    def against_one(out):
        """(relative loss gaps, parameter gap) of a run to (b)."""
        return (loss_gaps(out["losses"], one[0]),
                rel_gap(out["params"], one[1], p0))

    def route_flips(seen):
        """(choices whose expert differs, choices whose slot verdict
        differs, choices) of a run's step-0 routing against (b)'s, from
        the same parameters: ``seen`` holds each dp rank's layers in
        turn, each routing its rank's rows of the batch."""
        ref = one_routes.seen
        dp = len(seen) // len(ref)
        check(len(seen) == dp * len(ref),
              f"{len(seen)} routings against one device's {len(ref)}")
        idx = kept = 0
        for layer, (i1, k1) in enumerate(ref):
            ranks = seen[layer::len(ref)]
            idx += int((torch.cat([i for i, _ in ranks]) != i1).sum())
            kept += int((torch.cat([k for _, k in ranks]) != k1).sum())
        return idx, kept, sum(i.numel() for i, _ in ref)

    # ---- (c)-(e) over rank meshes, every kernel-6 copy checked ------------
    runs, mesh_wants = {}, []
    tpm.ring_allreduce = tfm.ring_allreduce = checked
    colm._ring_allreduce = checked
    try:
        plain = None
        for label, shape, mode in (
                *((f"(c) {s}", s, "dp") for s in MOE_EP_MESHES),
                *((f"(d) {s}", s, "dp") for s in MOE_TP_MESHES),
                *((f"(e) {mode} {s}", s, mode) for s, mode in
                  MOE_ZERO_RUNS)):
            out = mesh_run(label, shape, mode,
                           profile=label.startswith("(c)"))
            mesh_wants.append(out["want"])
            if shape == (4, 2):
                check(out["rest"] == 0,
                      f"{label}: {out['rest']} replicated values: every "
                      f"leaf of the MoE flagship should have a dimension "
                      f"divisible by 4")
                if mode == "dp":
                    plain = out
                else:
                    check(out["losses"] == plain["losses"] and all(
                        bits_equal(a, b)
                        for a, b in zip(out["params"], plain["params"])),
                        f"{label}: losses {out['losses']} or parameters "
                        f"differ from plain dp's {plain['losses']} in "
                        f"their bits")
            out["gaps"] = against_one(out)
            out["flips"] = route_flips(out.pop("routes"))
            # Kept: (c) (2, 4)'s for the per-rank aux control, plain dp's
            # on (4, 2) until zero1 and fsdp are held to its bits.
            if label != "(c) (2, 4)" and out is not plain:
                del out["params"]
            runs[label] = out
            del out
        if plain is not None:
            del plain["params"]
        del plain
        torch.cuda.empty_cache()
    finally:
        tpm.ring_allreduce = tfm.ring_allreduce = ring_allreduce
        colm._ring_allreduce = ring_allreduce
    main_counts = dict(zip(names, counts()))
    want_counts = moe_launches(layers, N_REQUESTS, NEW_TOKENS, TRAIN_STEPS,
                               MOE_EP_STEPS, mesh_wants)
    check(main_counts == want_counts,
          f"MoE phase launches {main_counts}, want {want_counts} (counted "
          f"from the code)")
    n_copies = sum(w[3] for w in mesh_wants)
    check(copies["calls"] == n_copies and copies["differ"] == 0,
          f"(c)-(e): {copies['differ']} of {copies['calls']} kernel-6 "
          f"results of the runs' first steps hold copies that differ from "
          f"copy 0 (want {n_copies} results, every copy the same bits)")
    print(f"MoE flagship ({MOE_EXPERTS} experts, top-{MOE_TOP_K}, capacity "
          f"factor {MOE_CAPACITY}): served {N_REQUESTS} requests of "
          f"{BATCH}x{PROMPT_LEN} + {NEW_TOKENS}; (b) {TRAIN_STEPS} steps, "
          f"losses {blosses}; main-path launches {main_counts} as counted "
          f"from the code; {copies['calls']} kernel-6 results in the first "
          f"steps of (c)-(e), every copy the same bits; (e) zero1 and fsdp "
          f"on (4, 2) bitwise plain dp's losses and parameters")
    tok = 8 * (tcfg.max_seq - 1)
    for label, r in runs.items():
        print(f"{label}: {r['ms']!r} ms per step (CUDA events over steps 2-"
              f"{MOE_EP_STEPS}, kernel 6 unchecked), {tok / r['ms'] * 1e3!r} "
              f"tokens/s, host enqueue {r['host_ms']!r} ms per step; peak "
              f"{r['peak'] / 2**30!r} GiB allocated (max_memory_allocated, "
              f"{r['base'] / 2**30!r} GiB held before the run); step 0's "
              f"routing against one device's: {r['flips'][0]} experts, "
              f"{r['flips'][1]} slot verdicts of {r['flips'][2]} choices "
              f"differ  [{card}]")

    # ---- the controls -------------------------------------------------------
    def rank_zero(contribs, ring, op="sum"):
        return contribs[:1].expand_as(contribs)

    tpm.ring_allreduce = rank_zero
    try:
        ctrl = mesh_run("control: rank 0's partials", (1, 8), count=False)
    finally:
        tpm.ring_allreduce = ring_allreduce

    def per_rank(self, state, inputs, rows):
        for r in range(self.dp):
            yield loss_fn(state["params"], rows[r], self.cfg,
                          self.rank_meshes[r])

    sound_rank_losses = tfm._DataParallel._rank_losses
    tfm._DataParallel._rank_losses = per_rank
    try:
        per_rank_aux = mesh_run("per-rank aux", (2, 4), count=False)
    finally:
        tfm._DataParallel._rank_losses = sound_rank_losses

    def tp_zero(contribs, ring, op="sum"):
        """Kernel 6 with the contributions of the ranks off tp coordinate
        0 of the experts' ep × tp ring zeroed: each expert's other d_ff
        half dropped (forward, and the gradient to the experts' input)."""
        if "ep" in ring.shape and ring.shape.get("tp", 1) > 1:
            keep = torch.arange(ring.size, device=contribs.device) % \
                ring.shape["tp"] == 0
            contribs = contribs * keep.to(contribs.dtype).view(
                -1, *[1] * (contribs.dim() - 1))
        return ring_allreduce(contribs, ring, op)

    def rank_zero_grad(x, ring, op="sum"):
        return (x[0] * ring.size).reshape(ring.size, -1)

    tpm.ring_allreduce = tp_zero
    try:
        tp_ctrl = mesh_run("control: tp 0's partials", (1, 4, 2),
                           count=False)
    finally:
        tpm.ring_allreduce = ring_allreduce
    sound_reduce_scatter = tfm.ring_reduce_scatter
    tfm.ring_reduce_scatter = rank_zero_grad
    try:
        grad_ctrl = mesh_run("control: rank 0's gradient", (4, 2), "fsdp",
                             count=False)
    finally:
        tfm.ring_reduce_scatter = sound_reduce_scatter

    gaps = {label: r["gaps"] for label, r in runs.items()}
    gaps["control: rank 0's partials (1, 8)"] = against_one(ctrl)
    gaps["per-rank aux (2, 4)"] = against_one(per_rank_aux)
    ep24 = runs["(c) (2, 4)"]
    gaps["per-rank aux against (c) (2, 4)"] = (
        loss_gaps(per_rank_aux["losses"], ep24["losses"]),
        rel_gap(per_rank_aux["params"], ep24["params"], p0))
    gaps["control: tp 0's partials (1, 4, 2)"] = against_one(tp_ctrl)
    gaps["control: rank 0's gradient, fsdp (4, 2)"] = against_one(grad_ctrl)
    print(f"MoE flagship over rank meshes against one device "
          f"({MOE_EP_STEPS} steps): losses one device {one[0]}, "
          f"{ {k: r['losses'] for k, r in runs.items()} }, controls "
          f"{ctrl['losses']}, {tp_ctrl['losses']}, {grad_ctrl['losses']}, "
          f"per-rank aux {per_rank_aux['losses']}")
    for label, (lg, pg) in gaps.items():
        print(f"{label}: relative loss gaps {lg} (rtol {EP_LOSS_RTOL}), "
              f"parameter gap ||p - p_ref|| / ||p_ref - p_0|| {pg!r} "
              f"(limit {EP_PARAM_REL})")
    for key in runs:
        lg, pg = gaps[key]
        check(max(lg) <= EP_LOSS_RTOL and pg <= EP_PARAM_REL,
              f"{key}: loss gaps {lg} or parameter gap {pg} to one device "
              f"outside rtol {EP_LOSS_RTOL} / limit {EP_PARAM_REL}")
    for key in ("control: rank 0's partials (1, 8)",
                "control: tp 0's partials (1, 4, 2)"):
        lg, pg = gaps[key]
        check(min(lg) > EP_LOSS_RTOL and pg > EP_PARAM_REL,
              f"{key}: loss gaps {lg} or parameter gap {pg} inside rtol "
              f"{EP_LOSS_RTOL} / limit {EP_PARAM_REL}")
    # The rank-0-gradient control's first loss comes before any update:
    # fsdp's own, bit for bit; the later ones and the parameters must miss.
    lg, pg = gaps["control: rank 0's gradient, fsdp (4, 2)"]
    fsdp_losses = runs["(e) fsdp (4, 2)"]["losses"]
    check(grad_ctrl["losses"][0] == fsdp_losses[0]
          and min(lg[1:]) > EP_LOSS_RTOL and pg > EP_PARAM_REL,
          f"control (rank 0's gradient alone): first loss "
          f"{grad_ctrl['losses'][0]} against fsdp's {fsdp_losses[0]}, later "
          f"loss gaps {lg[1:]} or parameter gap {pg} inside rtol "
          f"{EP_LOSS_RTOL} / limit {EP_PARAM_REL}")
    del runs, ctrl, per_rank_aux, tp_ctrl, grad_ctrl, one_leaves, one
    torch.cuda.empty_cache()

    # ---- (a) teacher-forced, int8 weights, times ------------------------
    cfg_f = moe_config(flagship_config(dtype=torch.float32))
    cfg_d = dataclasses.replace(cfg_f, decode_attention="dense")
    params32 = init_params(cfg_f, torch.Generator().manual_seed(0))
    seq = torch.cat([prompts[0].to(dev), outs[0]], dim=1)
    worst, agree, n_tok = 0.0, 0, 0
    with torch.no_grad(), RecordedRoutes() as rd:
        _, cache_d = prefill(params32, seq[:, :PROMPT_LEN], cfg_d)
        logits_d = [decode_step(params32, seq[:, n], cache_d, n, cfg_d)[0]
                    for n in range(PROMPT_LEN, PROMPT_LEN + steps)]
    with torch.no_grad(), RecordedRoutes() as rf:
        _, cache_f = prefill(params32, seq[:, :PROMPT_LEN], cfg_f)
        for n in range(PROMPT_LEN, PROMPT_LEN + steps):
            lf, cache_f = decode_step(params32, seq[:, n], cache_f, n, cfg_f)
            ld = logits_d[n - PROMPT_LEN]
            check(bool(torch.isfinite(lf).all()),
                  f"MoE: non-finite logits at n_valid={n}")
            check(torch.allclose(lf, ld, atol=SLICE_LOGITS_ATOL,
                                 rtol=SLICE_LOGITS_RTOL),
                  f"MoE flash vs dense logits differ by "
                  f"{(lf - ld).abs().max().item()} at n_valid={n}")
            worst = max(worst, (lf - ld).abs().max().item())
            agree += int((lf.argmax(-1) == ld.argmax(-1)).sum())
            n_tok += lf.shape[0]
    routes = rf.differ(rd)
    print(f"MoE teacher-forced float32 flash vs dense decode over {steps} "
          f"steps: max |logit diff| {worst!r} (atol {SLICE_LOGITS_ATOL}, "
          f"rtol {SLICE_LOGITS_RTOL}); greedy-token agreement "
          f"{agree / n_tok!r}; routing decisions that differ: {routes[0]} "
          f"experts, {routes[1]} slot verdicts of {routes[2]} choices")
    del params32, cache_f, cache_d, logits_d

    qparams = quantize_params(sparams)
    qtoks = generate(qparams, prompts[0], scfg, NEW_TOKENS)
    check(tuple(qtoks.shape) == (BATCH, NEW_TOKENS) and
          bool(((qtoks >= 0) & (qtoks < scfg.vocab)).all()),
          "MoE int8 tokens outside the vocab or of the wrong shape")
    print(f"MoE int8 weights (router and experts too): agreement with bf16 "
          f"greedy {float((qtoks == outs[0]).float().mean())!r}")
    n_gen = BATCH * NEW_TOKENS
    for label, p, c in (
            ("MoE generate bf16, flash-decode kernel", sparams, scfg),
            ("MoE generate bf16, dense decode", sparams,
             dataclasses.replace(scfg, decode_attention="dense")),
            ("MoE generate int8 weights, flash-decode kernel", qparams,
             scfg)):
        generate(p, prompts[1], c, NEW_TOKENS)  # warm-up
        start.record()
        for _ in range(2):
            generate(p, prompts[1], c, NEW_TOKENS)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 2
        print(f"{label}: {ms!r} ms per request, {ms / NEW_TOKENS!r} ms per "
              f"generated token, {n_gen / ms * 1e3!r} tok/s  [{card}]")
    del qparams, sparams
    torch.cuda.empty_cache()

    # ---- (b) float32, flash against dense -------------------------------
    f32 = {}
    for impl in ("flash", "dense"):
        cfg = moe_config(flagship_train_config(dtype=torch.float32,
                                               attention_impl=impl))
        params = init_params(cfg, torch.Generator().manual_seed(0))
        for x in tree_leaves(params):
            x.requires_grad_(True)
        with RecordedRoutes() as rec:
            loss = loss_fn(params, tokens, cfg)
        loss.backward()
        f32[impl] = (loss.item(), rec)
        del params, loss
        torch.cuda.empty_cache()
    (lf, rf), (ld, rd) = f32["flash"], f32["dense"]
    routes = rf.differ(rd)
    print(f"MoE float32 step, flash vs dense attention: loss {lf!r} vs "
          f"{ld!r}, relative gap {abs(lf - ld) / abs(ld)!r} (rtol "
          f"{MOE_F32_LOSS_RTOL}); routing decisions that differ: "
          f"{routes[0]} experts, {routes[1]} slot verdicts of {routes[2]} "
          f"choices")
    check(np.isfinite(lf) and abs(lf - ld) <= MOE_F32_LOSS_RTOL * abs(ld),
          f"MoE float32 flash loss {lf} vs dense {ld}")
    del f32, rf, rd

    # ---- kernel 6 against plain at the (ep·tp, ...) partial shapes ---------
    # Once for each distinct shape, on the ep × tp ring of the last mesh
    # that gives it.
    gen = torch.Generator(device=dev).manual_seed(13)
    m = 8 * (tcfg.max_seq - 1) * tcfg.d_model  # the (b, s, d) partials
    partials = {}
    for dp, ep, tp in (*((dp, ep, 1) for dp, ep in MOE_EP_MESHES),
                       *MOE_TP_MESHES):
        partials.setdefault((ep * tp, m // dp), []).append((dp, ep, tp))
    for (n, cols), shapes in partials.items():
        ring = tp_ring(RankMesh([dev] * int(np.prod(shapes[-1])),
                                ("dp", "ep", "tp"), shapes[-1]),
                       ("ep", "tp"))
        x = torch.randn(n, cols, generator=gen, device=dev)
        got, ref = ring_allreduce(x, ring), ring_allreduce_plain(x)
        torch.cuda.synchronize()
        check(bits_equal(got, ref), f"kernel 6 on the ({n}, {cols}) "
                                    f"experts' partials differs from plain")
        ar_ms = kernel_ms(lambda c: ring_allreduce(c, ring), [(x,)], 20)
        ar_bound = bound(2 * n * cols * 4, (n - 1) * cols,
                         torch.float32)[0]
        print(f"kernel 6 at the experts' partials ({n}, {cols}) float32 of "
              f"the (dp, ep, tp) meshes {shapes} (the ep x tp ring of "
              f"{shapes[-1]}): bitwise equal to plain, {ar_ms * 1e3!r} us "
              f"against a {ar_bound * 1e3!r} us bound  [{card}]")
        del x, got, ref
    torch.cuda.empty_cache()

    tok = 8 * (tcfg.max_seq - 1)
    print(f"(b) MoE one device: {one_ms!r} ms per step, "
          f"{tok / one_ms * 1e3!r} tokens/s; dense flagship {dense_ms!r} ms "
          f"per step, {tok / dense_ms * 1e3!r} tokens/s (phase 4)  [{card}]")
    print(f"MoE phase launches (main path: (a)-(e)): {main_counts}")
    return main_counts


def spec_slice(dev, card):
    """Phase 14: prompt-lookup speculative decoding (``generate_lookahead``)
    at the flagship's widths and depth, SPEC_DRAFT_LEN drafted tokens a
    verify forward, an SPEC_NGRAM-token lookup key. Main path, counted
    alone: the repetitive and the random prompt at batch BATCH and 1
    (bf16), every kernel's launches read just after; each verify forward
    feeds m + 1 queries and the prefill a whole prompt, so both take the
    dense cached attention and the count from the code is 0 for every
    kernel. The verify forwards are counted by wrapping
    ``models.generate._forward_cached``. Then, outside the count: every
    bf16 output greedy under one teacher-forced bf16 dense forward (each
    token within SPEC_BF16_TIE of its row's largest logit), beside its
    agreement with ``generate``; float32 tokens equal to ``generate``'s on
    kernel 4, a first divergence allowed only at a printed near-tie
    (SPEC_FP32_TIE); the accept-all control (``speculative._accepted``
    patched to commit every draft) on the random prompt, which must fail
    both checks; ms per token beside ``generate``'s over SPEC_REPEATS
    interleaved repeats. Returns {kernel: launches on the main path}."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (forward, generate, generate_lookahead,
                                      init_params)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce)
    from mpi_tpu_torch.parallel import sendrecv
    from mpi_tpu_torch.serve import flagship_config

    gmod = importlib.import_module("mpi_tpu_torch.models.generate")
    smod = importlib.import_module("mpi_tpu_torch.models.speculative")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    m, ngram = SPEC_DRAFT_LEN, SPEC_NGRAM
    max_seq = PROMPT_LEN + NEW_TOKENS + m + 1
    cfg = flagship_config(max_seq=max_seq)
    cfg32 = flagship_config(dtype=torch.float32, max_seq=max_seq)
    rng = np.random.default_rng(14)
    phrases = rng.integers(0, cfg.vocab, (BATCH, SPEC_PHRASE))
    prompts = {
        "repetitive": torch.from_numpy(
            np.tile(phrases, -(-PROMPT_LEN // SPEC_PHRASE))[:, :PROMPT_LEN]),
        "random": torch.from_numpy(
            rng.integers(0, cfg.vocab, (BATCH, PROMPT_LEN)))}
    runs = [(name, b) for name in prompts for b in (BATCH, 1)]

    def spec_call(p, c, key):
        return generate_lookahead(p, prompts[key[0]][:key[1]], c, NEW_TOKENS,
                                  draft_len=m, ngram=ngram)

    def gen_call(p, c, key):
        return generate(p, prompts[key[0]][:key[1]], c, NEW_TOKENS)

    # ---- the main path, counted alone ------------------------------------
    params = init_params(cfg, torch.Generator().manual_seed(0))
    verifies = [0]
    sound_forward = gmod._forward_cached

    def counted(p, tokens, cache, n_valid, c):
        verifies[0] += n_valid > 0  # the prefill runs at n_valid 0
        return sound_forward(p, tokens, cache, n_valid, c)

    for w in wrappers.values():
        w.launches = 0
    spec, forwards = {}, {}
    gmod._forward_cached = counted
    try:
        for key in runs:
            before = verifies[0]
            spec[key] = spec_call(params, cfg, key)
            forwards[key] = verifies[0] - before
    finally:
        gmod._forward_cached = sound_forward
    torch.cuda.synchronize()
    main_counts = {name: w.launches for name, w in wrappers.items()}
    check(all(n == 0 for n in main_counts.values()),
          f"speculative path launched kernels {main_counts}, want none "
          f"(dense verify and prefill, counted from the code)")
    for (name, b), toks in spec.items():
        check(tuple(toks.shape) == (b, NEW_TOKENS) and
              toks.dtype == torch.int64 and toks.device.type == "cuda" and
              bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"speculative {name} batch {b}: tokens {toks.dtype} "
              f"{tuple(toks.shape)} on {toks.device}, or outside the vocab")
        n = forwards[name, b]
        print(f"speculative {name} prompt, batch {b}: {n} verify forwards "
              f"for {b * NEW_TOKENS} tokens ({b} rows one after another): "
              f"{b * NEW_TOKENS / n!r} tokens committed a forward, "
              f"{(b * NEW_TOKENS - n) / n!r} of them accepted drafts "
              f"(plain decode: 1 and 0)")
    print(f"speculative phase launches (main path): {main_counts}")

    # ---- bf16: teacher-forced greedy, agreement with generate -------------
    def greedy_gaps(p, c, prompt, out):
        """(b, NEW_TOKENS) float32: how far each output token's logit lies
        below its row's largest under one teacher-forced dense forward of
        prompt + output."""
        seq = torch.cat([prompt.to(dev), out], dim=1)
        with torch.no_grad():
            logits = forward(p, seq[:, :-1], c)[:, PROMPT_LEN - 1:].float()
        picked = logits.gather(-1, out[..., None])[..., 0]
        return logits.max(-1).values - picked

    def first_divergence(a, b):
        """(row, position) of the first token where ``a`` and ``b``
        differ, or None."""
        rows = (a != b).any(1).nonzero()
        if not len(rows):
            return None
        r = int(rows[0, 0])
        return r, int((a[r] != b[r]).nonzero()[0, 0])

    ref = {key: gen_call(params, cfg, key) for key in runs}
    for key in runs:
        sg = greedy_gaps(params, cfg, prompts[key[0]][:key[1]], spec[key])
        rg = greedy_gaps(params, cfg, prompts[key[0]][:key[1]], ref[key])
        where = first_divergence(spec[key], ref[key])
        div = "none" if where is None else (
            f"row {where[0]} position {where[1]}: speculative token "
            f"{int(spec[key][where])} ({float(sg[where])!r} below the row's "
            f"largest), generate's {int(ref[key][where])} "
            f"({float(rg[where])!r} below)")
        print(f"speculative {key[0]} prompt, batch {key[1]}, bf16: largest "
              f"gap to the teacher-forced row max {float(sg.max())!r} "
              f"(generate's {float(rg.max())!r}; limit {SPEC_BF16_TIE}); "
              f"agreement with generate "
              f"{float((spec[key] == ref[key]).float().mean())!r}; first "
              f"divergence {div}")
        check(float(sg.max()) <= SPEC_BF16_TIE and
              float(rg.max()) <= SPEC_BF16_TIE,
              f"speculative {key}: an output token lies more than "
              f"{SPEC_BF16_TIE} below its teacher-forced row max "
              f"(speculative {float(sg.max())}, generate {float(rg.max())})")

    # ---- float32: tokens equal to generate's on kernel 4 ------------------
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 check needs full float32 products")
    params32 = init_params(cfg32, torch.Generator().manual_seed(0))

    def fp32_verdict(out, want, prompt):
        """(every row equal to ``want`` but for a first divergence at a
        near-tie, the divergences): at each row's first divergence, the
        two tokens' gaps to the largest logit of one teacher-forced float32
        dense forward of the shared prefix."""
        seq = torch.cat([prompt.to(dev), want], dim=1)
        with torch.no_grad():
            logits = forward(params32, seq[:, :-1], cfg32)[:, PROMPT_LEN - 1:]
        notes = []
        for r in range(out.shape[0]):
            diff = (out[r] != want[r]).nonzero()
            if not len(diff):
                continue
            j = int(diff[0, 0])
            row = logits[r, j]
            gaps = [float(row.max() - row[t]) for t in (out[r, j], want[r, j])]
            notes.append((r, j, int(out[r, j]), int(want[r, j]), *gaps,
                          max(gaps) <= SPEC_FP32_TIE))
        return all(n[-1] for n in notes), notes

    ref32 = {}
    for name in prompts:
        key = (name, BATCH)
        ref32[name] = gen_call(params32, cfg32, key)
        ok, notes = fp32_verdict(spec_call(params32, cfg32, key), ref32[name],
                                 prompts[name])
        print(f"speculative {name} prompt, batch {BATCH}, float32: tokens "
              f"equal to generate's (kernel 4) in {BATCH - len(notes)} of "
              f"{BATCH} rows; first divergences (row, position, speculative "
              f"token, generate's, their gaps to the row max, a near-tie "
              f"within {SPEC_FP32_TIE}): {notes}")
        check(ok, f"speculative {name} float32: a divergence from generate "
                  f"that is no near-tie: {notes}")

    # ---- the control: every draft accepted --------------------------------
    sound_accepted = smod._accepted
    smod._accepted = lambda draft, greedy: torch.tensor(draft.shape[0])
    try:
        ctrl16 = spec_call(params, cfg, ("random", BATCH))
        ctrl32 = spec_call(params32, cfg32, ("random", BATCH))
    finally:
        smod._accepted = sound_accepted
    cg = float(greedy_gaps(params, cfg, prompts["random"], ctrl16).max())
    ok32, notes = fp32_verdict(ctrl32, ref32["random"], prompts["random"])
    print(f"control (every draft accepted), random prompt: bf16 largest gap "
          f"to the teacher-forced row max {cg!r} (limit {SPEC_BF16_TIE}), "
          f"agreement with generate "
          f"{float((ctrl16 == ref[('random', BATCH)]).float().mean())!r}; "
          f"float32 first divergences {notes}")
    check(cg > SPEC_BF16_TIE and not ok32,
          f"the accept-all control passed a check: bf16 gap {cg} (limit "
          f"{SPEC_BF16_TIE}), float32 verdict {ok32}")
    del params32, ref32, ctrl16, ctrl32
    torch.cuda.empty_cache()

    # ---- times -------------------------------------------------------------
    times = {key: ([], []) for key in runs}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(SPEC_REPEATS):
        for key in runs:
            for i, fn in enumerate((spec_call, gen_call)):
                start.record()
                fn(params, cfg, key)
                end.record()
                torch.cuda.synchronize()
                times[key][i].append(start.elapsed_time(end) / NEW_TOKENS)
    for (name, b), (ts, tg) in times.items():
        print(f"speculative {name} prompt, batch {b}: generate_lookahead "
              f"{min(ts)!r}-{max(ts)!r} ms per token, generate "
              f"{min(tg)!r}-{max(tg)!r} (ms per position of the batch, {b} "
              f"tokens; CUDA events, {SPEC_REPEATS} interleaved repeats)  "
              f"[{card}]")
    return main_counts


def lora_tp_launches(layers):
    """Launches of kernel 6 in one LoRA step over a tp mesh, counted from
    the code: :func:`tp_launches` less one, the copy before layer 0's
    q/k/v, whose backward never runs (its input, the frozen embedding's
    rows, needs no gradient)."""
    return tp_launches(layers) - 1


def lora_slice(dev, card, full_ms):
    """Phase 15: LoRA fine-tuning (``models/lora.py``) at the flagship
    training configuration: rank-LORA_RANK q/v adapters, alpha LORA_ALPHA,
    AdamW at LORA_LR over a frozen base from a seed. Main path, counted
    alone: (b) LORA_STEPS steps on one fixed batch (kernels 1-3), (e)
    LORA_TP_STEPS steps over a (1, 1, TP_RANKS) tp mesh (kernel 6 as
    well), (f) the trained merged tree served through ``generate`` (kernel
    4), every kernel's launches against the count from the code. Then,
    outside the count: (a) with fresh adapters the merged tree's forward
    bitwise the base's; (b) the loss falls, the base keeps every bit and
    gets no ``.grad``, the optimizer's moments are the adapters' alone;
    (c) the merged tree's loss equals the next step's; (d) the first
    LORA_DENSE_STEPS steps with dense attention within LORA_LOSS_RTOL of
    the flash steps, and a faulty control (each delta scaled by rank /
    alpha) outside it; in float32, LORA_STEPS steps within
    TRAIN_LOSS_RTOL and the adapter gradients within TRAIN_GRAD_REL, the
    control outside both; (e) tp within
    TP_LOSS_RTOL of one device; (f) float32 teacher-forced logits of
    kernel 4 against dense decode within SLICE_LOGITS_ATOL and int8 tokens
    in the vocab; (g) ms per LoRA step beside the full step's, interleaved,
    their optimizer bytes, and a profile of a LoRA step. ``full_ms`` is
    phase 5's full step. Returns {kernel: launches on the main path}."""
    import importlib

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (count_params, forward, generate,
                                      init_params, lora_init, loss_fn,
                                      make_lora_train_step, make_train_step,
                                      merge_lora, quantize_params)
    from mpi_tpu_torch.models.generate import decode_step, prefill
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce)
    from mpi_tpu_torch.parallel import RankMesh, sendrecv
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.serve import flagship_config
    from mpi_tpu_torch.train import flagship_train_config

    lmod = importlib.import_module("mpi_tpu_torch.models.lora")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    cfg = flagship_train_config()
    layers = cfg.n_layers
    rng = np.random.default_rng(15)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab,
                                           (BATCH, PROMPT_LEN))).to(dev)
    base = init_params(cfg, torch.Generator().manual_seed(0), dev)
    base_bits = [x.clone() for x in tree_leaves(base)]

    def run(label, c, mesh, steps, want):
        """``steps`` LoRA steps from fresh adapters (seed 1) over the
        frozen base: (state, step, losses); each step's launches of
        kernels 1-4, 5, 6, 7 must equal ``want``."""
        init_state, step = make_lora_train_step(
            c, base, rank=LORA_RANK, alpha=LORA_ALPHA, mesh=mesh,
            learning_rate=LORA_LR)
        state = init_state(torch.Generator().manual_seed(1))
        losses = []
        for i in range(steps):
            before = counts()
            state, loss = step(state, tokens)
            got = [a - b for a, b in zip(counts(), before)]
            check(got == want,
                  f"{label} step {i}: kernels {names} launched {got} times, "
                  f"want {want} (counted from the code)")
            losses.append(loss)
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        return state, step, losses

    one_k = [layers, layers, layers, 0, 0, 0, 0]
    tp_k = [layers, layers, layers, 0, 0, lora_tp_launches(layers), 0]
    scfg = flagship_config(max_seq=PROMPT_LEN + NEW_TOKENS)

    # ---- the main path: (b), (e) and (f), counted alone -------------------
    for w in wrappers.values():
        w.launches = 0
    state, step, losses = run("(b)", cfg, None, LORA_STEPS, one_k)
    tp_mesh = RankMesh([dev] * TP_RANKS, ("dp", "sp", "tp"),
                       (1, 1, TP_RANKS))
    _, _, tp_losses = run("(e) tp", cfg, tp_mesh, LORA_TP_STEPS, tp_k)
    with torch.no_grad():
        merged = merge_lora(base, state["lora"], LORA_ALPHA)
    toks = generate(merged, prompt, scfg, NEW_TOKENS)
    torch.cuda.synchronize()
    main_counts = dict(zip(names, counts()))
    flash = LORA_STEPS * layers + LORA_TP_STEPS * layers
    want_counts = {"flash_fwd": flash, "flash_bwd_dq": flash,
                   "flash_bwd_dkv": flash,
                   "flash_decode_attention": layers * (NEW_TOKENS - 1),
                   "ring_allgather": 0,
                   "ring_allreduce": LORA_TP_STEPS * tp_k[5], "sendrecv": 0}
    check(main_counts == want_counts,
          f"LoRA phase launches {main_counts}, want {want_counts} (counted "
          f"from the code)")
    check(tuple(toks.shape) == (BATCH, NEW_TOKENS) and
          toks.device.type == "cuda" and
          bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"merged tree's tokens {tuple(toks.shape)} on {toks.device}, or "
          f"outside the vocab")
    n_adapt = count_params(state["lora"])
    n_base = count_params(base)
    print(f"LoRA (rank {LORA_RANK}, q/v, alpha {LORA_ALPHA}, AdamW at "
          f"{LORA_LR}) over the flagship ({layers} layers, batch 8, seq "
          f"{cfg.max_seq - 1}): {n_adapt} adapter values against the base's "
          f"{n_base} ({n_adapt / n_base!r}); (b) losses {losses}; (e) tp "
          f"{TP_RANKS} losses {tp_losses}; launches per step of kernels 1-3 "
          f"{one_k[:3]}, kernel 6 under tp {tp_k[5]}; (f) {BATCH}x"
          f"{PROMPT_LEN} prompt + {NEW_TOKENS} tokens from the merged tree, "
          f"kernel 4 launched {main_counts['flash_decode_attention']} times  "
          f"[{card}]")
    print(f"LoRA phase launches (main path: (b), (e), (f)): {main_counts}")

    # ---- (b) the freeze ---------------------------------------------------
    check(losses[-1] < losses[0], f"(b) LoRA loss did not fall: {losses}")
    check(all(x.grad is None and bits_equal(x, b)
              for x, b in zip(tree_leaves(base), base_bits)),
          "(b) a base leaf changed or holds a .grad")
    adapters = tree_leaves(state["lora"]["blocks"])
    opt = state["opt"]
    moments = opt_bytes(opt) // 4  # float32 moments, as the adapters
    check({id(p) for p in opt.state} == {id(x) for x in adapters} and
          moments == 2 * n_adapt,
          f"(b) the optimizer holds {len(opt.state)} tensors' state and "
          f"{moments} float32 moment values; want the {len(adapters)} "
          f"adapters' {2 * n_adapt}")
    print(f"(b) base: every bit kept, no .grad; AdamW moments {moments} "
          f"values, the adapters' alone")

    # ---- (c) the merge equals the next step --------------------------------
    with torch.no_grad():
        merged_loss = float(loss_fn(merged, tokens, cfg))
    _, next_loss = step(state, tokens)
    next_loss = float(next_loss)
    gap = abs(merged_loss - next_loss) / abs(next_loss)
    print(f"(c) merged tree's loss {merged_loss!r}, the next step's "
          f"{next_loss!r}: relative gap {gap!r} (rtol {LORA_MERGE_RTOL})")
    check(gap <= LORA_MERGE_RTOL, f"(c) merge gap {gap}")

    # ---- (a) identity ------------------------------------------------------
    fresh = lora_init(base, LORA_RANK,
                      generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        same = bits_equal(forward(base, tokens[:, :-1], cfg),
                          forward(merge_lora(base, fresh, LORA_ALPHA),
                                  tokens[:, :-1], cfg))
    check(same, "(a) fresh adapters: the merged forward differs from the "
                "base's")
    print("(a) fresh adapters: the merged tree's forward is the base's, bit "
          "for bit (kernel 1)")

    # ---- (d) flash against dense, and the faulty control -------------------
    _, _, dense = run("(d) dense", flagship_train_config(
        attention_impl="dense"), None, LORA_DENSE_STEPS, [0] * len(names))
    sound_delta = lmod.lora_delta

    def rank_over_alpha(w, ab, alpha, rank):
        return sound_delta(w, ab, rank * rank / alpha, rank)

    lmod.lora_delta = rank_over_alpha
    try:
        _, _, ctrl = run("(d) control", cfg, None, LORA_DENSE_STEPS,
                         one_k)
    finally:
        lmod.lora_delta = sound_delta
    gaps, cgaps = loss_gaps(losses[:LORA_DENSE_STEPS], dense), \
        loss_gaps(ctrl, dense)
    tp_gaps = loss_gaps(tp_losses, losses[:LORA_TP_STEPS])
    print(f"(d) dense losses {dense}; flash against dense: relative gaps "
          f"{gaps} (rtol {LORA_LOSS_RTOL}); control (delta scaled by rank / "
          f"alpha) losses {ctrl}, gaps {cgaps} (step 0 equal by "
          f"construction: B = 0)")
    print(f"(e) tp {TP_RANKS} against one device: relative gaps {tp_gaps} "
          f"(rtol {TP_LOSS_RTOL})")
    check(max(gaps) <= LORA_LOSS_RTOL,
          f"(d) flash against dense: gaps {gaps} over {LORA_LOSS_RTOL}")
    check(min(cgaps[1:]) > LORA_LOSS_RTOL,
          f"(d) the control's gaps {cgaps} fall inside {LORA_LOSS_RTOL}")
    check(max(tp_gaps) <= TP_LOSS_RTOL,
          f"(e) tp against one device: gaps {tp_gaps} over {TP_LOSS_RTOL}")

    # ---- (d) the float32 witness: ten steps, and the adapter gradients -----
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 witness needs full float32 products")
    cfg32 = flagship_train_config(dtype=torch.float32)
    cfg32_dense = flagship_train_config(dtype=torch.float32,
                                        attention_impl="dense")
    state32, _, f32 = run("(d) float32", cfg32, None, LORA_STEPS, one_k)
    _, _, d32 = run("(d) float32 dense", cfg32_dense, None, LORA_STEPS,
                    [0] * len(names))
    lmod.lora_delta = rank_over_alpha
    try:
        _, _, c32 = run("(d) float32 control", cfg32, None, LORA_STEPS,
                        one_k)
    finally:
        lmod.lora_delta = sound_delta
    gaps32, cgaps32 = loss_gaps(f32, d32), loss_gaps(c32, d32)

    def adapter_grads(c, delta):
        """The adapter gradients of ``c``'s loss at ``state32``'s
        adapters (ten steps in: every B is non-zero), the deltas made by
        ``delta``."""
        leaves = tree_leaves(state32["lora"]["blocks"])
        lmod.lora_delta = delta
        try:
            loss = loss_fn(merge_lora(base, state32["lora"], LORA_ALPHA),
                           tokens, c)
        finally:
            lmod.lora_delta = sound_delta
        return torch.autograd.grad(loss, leaves)

    def grad_gap(got, ref):
        """The worst leaf's max |got - ref| over its largest |ref|."""
        return max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(got, ref))

    g_dense = adapter_grads(cfg32_dense, sound_delta)
    g_flash = adapter_grads(cfg32, sound_delta)
    g_ctrl = adapter_grads(cfg32, rank_over_alpha)
    ggap, cggap = grad_gap(g_flash, g_dense), grad_gap(g_ctrl, g_dense)
    del g_dense, g_flash, g_ctrl
    print(f"(d) float32 witness, TF32 off, {LORA_STEPS} steps at "
          f"{LORA_LR}: flash losses {f32}, dense {d32}, relative gaps "
          f"{gaps32} (rtol {TRAIN_LOSS_RTOL}); control gaps {cgaps32}; "
          f"adapter gradients at step {LORA_STEPS}, flash against dense: "
          f"worst leaf max|diff|/max|grad| {ggap!r}, control's {cggap!r} "
          f"(limit {TRAIN_GRAD_REL})  [{card}]")
    check(max(gaps32) <= TRAIN_LOSS_RTOL,
          f"(d) float32 flash against dense: gaps {gaps32} over "
          f"{TRAIN_LOSS_RTOL}")
    check(min(cgaps32[1:]) > TRAIN_LOSS_RTOL,
          f"(d) float32 control's gaps {cgaps32} fall inside "
          f"{TRAIN_LOSS_RTOL}")
    check(ggap <= TRAIN_GRAD_REL,
          f"(d) float32 adapter gradients: flash against dense {ggap} over "
          f"{TRAIN_GRAD_REL}")
    check(cggap > TRAIN_GRAD_REL,
          f"(d) float32 control's adapter gradients {cggap} fall inside "
          f"{TRAIN_GRAD_REL}")
    del state32
    torch.cuda.empty_cache()

    # ---- (f) kernel 4 against dense decode, float32; int8 ------------------
    cfg_f = flagship_config(dtype=torch.float32,
                            max_seq=PROMPT_LEN + NEW_TOKENS)
    cfg_d = flagship_config(dtype=torch.float32, decode_attention="dense",
                            max_seq=PROMPT_LEN + NEW_TOKENS)
    seq = torch.cat([prompt, toks], dim=1)
    worst = 0.0
    with torch.no_grad():
        _, cache_f = prefill(merged, seq[:, :PROMPT_LEN], cfg_f)
        _, cache_d = prefill(merged, seq[:, :PROMPT_LEN], cfg_d)
        for n_valid in range(PROMPT_LEN, PROMPT_LEN + NEW_TOKENS - 1):
            tok = seq[:, n_valid]
            lf, cache_f = decode_step(merged, tok, cache_f, n_valid, cfg_f)
            ld, cache_d = decode_step(merged, tok, cache_d, n_valid, cfg_d)
            check(bool(torch.isfinite(lf).all()) and
                  torch.allclose(lf, ld, atol=SLICE_LOGITS_ATOL,
                                 rtol=SLICE_LOGITS_RTOL),
                  f"(f) merged tree, kernel 4 against dense: logits differ "
                  f"by {(lf - ld).abs().max().item()} at n_valid={n_valid}")
            worst = max(worst, (lf - ld).abs().max().item())
    del cache_f, cache_d
    qtoks = generate(quantize_params(merged), prompt, scfg, NEW_TOKENS)
    torch.cuda.synchronize()
    check(tuple(qtoks.shape) == (BATCH, NEW_TOKENS) and
          bool(((qtoks >= 0) & (qtoks < cfg.vocab)).all()),
          "(f) int8 merged tree: tokens outside the vocab or of the wrong "
          "shape")
    print(f"(f) merged tree, teacher-forced float32 over "
          f"{NEW_TOKENS - 1} steps: max |kernel 4 - dense| logit {worst!r} "
          f"(atol {SLICE_LOGITS_ATOL}, rtol {SLICE_LOGITS_RTOL}); int8 "
          f"tokens in the vocab, agreement with bf16 greedy "
          f"{float((qtoks == toks).float().mean())!r}")
    del merged
    torch.cuda.empty_cache()

    # ---- (g) times: a LoRA step beside a full step, interleaved ------------
    init_full, full_step = make_train_step(cfg)
    full = init_full.from_params(clone_tree(base))
    full_step(full, tokens)  # warm-up: AdamW's moments exist from here

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = {"LoRA": [], "full": []}
    for _ in range(LORA_REPEATS):
        for label, fn, st in (("LoRA", step, state),
                              ("full", full_step, full)):
            torch.cuda.synchronize()
            start.record()
            for _ in range(LORA_TIMED_STEPS):
                fn(st, tokens)
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / LORA_TIMED_STEPS)
    lora_bytes, full_bytes = opt_bytes(opt), opt_bytes(full["opt"])
    print(f"(g) ms per step (CUDA events, {LORA_TIMED_STEPS} steps a "
          f"repeat, {LORA_REPEATS} interleaved repeats after a warm-up): "
          f"LoRA {times['LoRA']}, full {times['full']}; phase 5's full step "
          f"{full_ms!r}; optimizer state bytes: LoRA {lora_bytes}, full "
          f"{full_bytes}; kernels 1-3 launches a step {one_k[:3]} in both  "
          f"[{card}]")
    del full
    torch.cuda.empty_cache()
    profile_steps(lambda: step(state, tokens), 2, "LoRA step",
                  min(times["LoRA"]), card)
    return main_counts


def vit_flops_per_step(cfg, batch):
    """Model FLOPs of one ViT optimizer step, counted from
    ``models/vit.py`` as ``train.train_flops_per_step`` counts the LM's:
    the forward's matrix products (the patch projection; per block q, k, v
    and o, the FFN, and attention's two products over the whole s² of the
    non-causal encoder; the head) times 3 for forward and backward."""
    b, n, d, f = batch, cfg.n_patches, cfg.d_model, cfg.d_ff
    patch = 2 * b * n * cfg.patch_size ** 2 * cfg.channels * d
    qkvo = 8 * b * n * d * d
    ffn = 4 * b * n * d * f
    attn = 4 * b * n * n * d
    head = 2 * b * d * cfg.n_classes
    return 3.0 * (patch + cfg.n_layers * (qkvo + ffn + attn) + head)


def vit_tp_launches(layers):
    """Launches of kernel 6 in one ViT step over a tp axis, counted from
    the code (``models/vit.py``, ``block_body``): per layer the reduces
    after wo and w2 in the forward and the copies' backward before q/k/v
    and w1 (the first's input gradient reaches the patch projection); no
    embedding, logits or loss reduction (the head is replicated)."""
    return 4 * layers


def vit_slice(dev, card, flash_err):
    """Phase 16: the Vision Transformer (``models/vit.py``) at ViT-B/16
    (VIT), bf16 over float32 masters, flash attention: kernels 1-3 with
    causal=False at head_dim 64 and 196 patches, kernel 6 on a tp mesh.
    Main path, counted alone: (b) one batch of VIT_BATCH images classified
    through ``forward_vit``; (c) VIT_STEPS AdamW steps on one device
    through ``make_vit_train_step``; (d) VIT_MESH_STEPS steps over
    ``make_mesh_nd(8)``, (dp 2, sp 2, tp 2) ranks on the card (the rows in
    one pass, the tp reductions on kernel 6), every kernel's launches
    against the count from the code. Then, outside the count: (a) kernels
    1-3 at (VIT_BATCH, 196, 12, 64) timed beside the bound and SDPA, the
    inputs' bits kept (phase 1 held them against their plain versions at
    VIT_FLASH_SHAPE: ``flash_err`` is its largest |kernel - plain| there);
    (b) the main path's bf16 logits within VIT_BF16_LOGITS_ATOL of float32
    dense, float32 logits, flash against dense within VIT_LOGITS_TOL, the
    position symmetry within VIT_SYMMETRY_TOL, the causal control outside
    all three, and ms per batch, flash and dense interleaved; (c) the loss falls from near
    ln 1000, a remat step's loss is the plain step's (kernel 1 twice a
    layer), a float32 step flash against dense within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_REL, ms per step, images/s, TFLOP/s and MFU, and a profiled
    step; (d) within VIT_MESH_LOSS_RTOL and VIT_MESH_PARAM_REL of (c)'s
    first VIT_MESH_STEPS steps, every copy kernel 6 writes bitwise the
    same, the faulty control (rank 0's partial for the sum) outside both,
    tp on w1's spec, ms per step interleaved with one device's. Returns
    {kernel: launches on the main path}."""
    import dataclasses
    import importlib
    import math

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (ViTConfig, forward_vit,
                                      init_vit_params, make_mesh_nd,
                                      make_vit_train_step, vit_loss_fn)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce)
    from mpi_tpu_torch.parallel import sendrecv
    from mpi_tpu_torch.parallel.zero import tree_leaves
    from mpi_tpu_torch.train import peak_bf16_tflops

    tpm = importlib.import_module("mpi_tpu_torch.parallel.tensor_parallel")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    names = list(wrappers)

    def counts():
        return [wrappers[k].launches for k in names]

    @dataclasses.dataclass(frozen=True)
    class CausalViT(ViTConfig):
        """The faulty control: the same model, its encoder stack causal."""

        @property
        def inner(self):
            return dataclasses.replace(super().inner, causal=True)

    cfg = ViTConfig(**VIT, dtype=torch.bfloat16, attention_impl="flash")
    layers = cfg.n_layers
    rng = np.random.default_rng(16)
    images = torch.from_numpy(rng.standard_normal(
        (VIT_BATCH, cfg.image_size, cfg.image_size, cfg.channels)).astype(
            np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, VIT["n_classes"],
                                           VIT_BATCH)).to(dev)
    batch = (images, labels)
    params0 = init_vit_params(cfg, torch.Generator().manual_seed(0), dev)
    p0 = [x.clone() for x in tree_leaves(params0)]
    n_params = sum(x.numel() for x in p0)
    mesh = make_mesh_nd(8, devices=[dev] * 8)
    check(tuple(mesh.shape.values()) == (2, 2, 2), f"mesh {mesh.shape}")

    def run(label, c, m, steps, want, p=params0, snapshot=None):
        """``steps`` AdamW steps from a copy of ``p`` over mesh ``m``:
        (step, state, losses, the parameters after step ``snapshot``);
        each step's launches of kernels 1-4, 5, 6, 7 must equal
        ``want``."""
        init_state, step = make_vit_train_step(c, mesh=m,
                                               learning_rate=VIT_LR)
        state = init_state.from_params(clone_tree(p))
        losses, kept = [], None
        for i in range(steps):
            before = counts()
            state, loss = step(state, batch)
            got = [a - b for a, b in zip(counts(), before)]
            check(got == want,
                  f"{label} step {i}: kernels {names} launched {got} times, "
                  f"want {want} (counted from the code)")
            losses.append(loss)
            if i == snapshot:
                kept = [x.detach().clone()
                        for x in tree_leaves(state["params"])]
        losses = [float(x) for x in losses]
        check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
        return step, state, losses, kept

    one_k = [layers, layers, layers, 0, 0, 0, 0]
    mesh_k = [layers, layers, layers, 0, 0, vit_tp_launches(layers), 0]
    copies = {"calls": 0, "differ": 0}

    def checked(contribs, ring, op="sum"):
        """Kernel 6 as the tp operators call it; every rank's copy of the
        result must hold copy 0's bits."""
        out = ring_allreduce(contribs, ring, op)
        bits = out.view({2: torch.int16, 4: torch.int32}[out.element_size()])
        copies["calls"] += 1
        copies["differ"] += int(not bool((bits == bits[:1]).all()))
        return out

    # ---- the main path: (b), (c) and (d), counted alone -------------------
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        logits = forward_vit(params0, images, cfg)
    torch.cuda.synchronize()
    check(tuple(logits.shape) == (VIT_BATCH, VIT["n_classes"]) and
          logits.dtype == torch.float32 and logits.device.type == dev.type and
          bool(torch.isfinite(logits).all()),
          f"(b) logits {tuple(logits.shape)} {logits.dtype} on "
          f"{logits.device}, or not finite")
    step1, state1, losses, at3 = run("(c) one device", cfg, None, VIT_STEPS,
                                     one_k, snapshot=VIT_MESH_STEPS - 1)
    tpm.ring_allreduce = checked
    try:
        step_m, state_m, mesh_losses, _ = run("(d) mesh", cfg, mesh,
                                              VIT_MESH_STEPS, mesh_k)
    finally:
        tpm.ring_allreduce = ring_allreduce
    main_counts = dict(zip(names, counts()))
    flash = layers * (1 + VIT_STEPS + VIT_MESH_STEPS)
    want_counts = {"flash_fwd": flash,
                   "flash_bwd_dq": flash - layers,
                   "flash_bwd_dkv": flash - layers,
                   "flash_decode_attention": 0, "ring_allgather": 0,
                   "ring_allreduce": VIT_MESH_STEPS * mesh_k[5],
                   "sendrecv": 0}
    check(main_counts == want_counts,
          f"ViT phase launches {main_counts}, want {want_counts} (counted "
          f"from the code)")
    check(copies["calls"] == VIT_MESH_STEPS * mesh_k[5] and
          copies["differ"] == 0,
          f"(d): {copies['differ']} of {copies['calls']} kernel-6 results "
          f"hold copies that differ from copy 0")
    print(f"ViT ({n_params} parameters; {VIT_BATCH} images, "
          f"{cfg.n_patches} patches, {VIT}; bf16 over float32, flash): (c) "
          f"losses {losses}; (d) (dp 2, sp 2, tp 2) losses {mesh_losses}; "
          f"launches a step of kernels 1-3 {one_k[:3]}, kernel 6 on the "
          f"mesh {mesh_k[5]}, every copy the same bits  [{card}]")
    print(f"ViT phase launches (main path: (b), (c), (d)): {main_counts}")

    # ---- (a) kernels 1-3 at the ViT shape ----------------------------------
    gen = torch.Generator(device=dev).manual_seed(16)
    b, s, _, h, _, d, causal = VIT_FLASH_SHAPE
    _, sets = time_flash_kernels(dev, gen, card, b, s, h, d, causal)
    for q, k, v, g, lse, dl, o in sets:  # the kernels leave inputs alone
        kept = [x.clone() for x in (q, k, v, g, lse, dl, o)]
        flash_fwd(q, k, v, causal)
        flash_bwd_dq(q, k, v, g, lse, dl, causal)
        flash_bwd_dkv(q, k, v, g, lse, dl, causal)
        torch.cuda.synchronize()
        check(all(bits_equal(x, y) for x, y in
                  zip((q, k, v, g, lse, dl, o), kept)),
              "(a) a kernel wrote into its inputs at the ViT shape")
    del sets, kept
    print(f"(a) kernels 1-3 at b={b} s={s} h={h} d={d}, non-causal, bf16 "
          f"and float32 against plain (phase 1): max |err| {flash_err}; "
          f"inputs keep their bits")
    torch.cuda.empty_cache()

    # ---- (b) float32 logits: flash against dense, the symmetry ------------
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 checks need full float32 products")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dense32 = dataclasses.replace(cfg32, attention_impl="dense")
    causal32 = CausalViT(**VIT, attention_impl="flash")
    causal16 = dataclasses.replace(causal32, dtype=torch.bfloat16)
    sym = dict(params0, pos=torch.zeros_like(params0["pos"]))
    half = VIT["image_size"] // 2
    swapped = torch.cat([images[:, half:], images[:, :half]], dim=1)
    with torch.no_grad():
        want = forward_vit(params0, images, dense32)
        got = forward_vit(params0, images, cfg32)
        ctrl = forward_vit(params0, images, causal32)
        ctrl16 = forward_vit(params0, images, causal16)
        sym_a = forward_vit(sym, images, cfg32)
        sym_b = forward_vit(sym, swapped, cfg32)
        csym_a = forward_vit(sym, images, causal32)
        csym_b = forward_vit(sym, swapped, causal32)
    atol, rtol = VIT_LOGITS_TOL
    satol, srtol = VIT_SYMMETRY_TOL
    gap = max_abs_diff(got, want)
    cgap = max_abs_diff(ctrl, want)
    bf16_gap = max_abs_diff(logits, want)
    cbf16_gap = max_abs_diff(ctrl16, want)
    sgap, csgap = max_abs_diff(sym_a, sym_b), max_abs_diff(csym_a, csym_b)
    print(f"(b) float32 logits (|max| {want.abs().max().item()!r}), flash "
          f"against dense: max |diff| {gap!r} (atol {atol}, rtol {rtol}); "
          f"causal control {cgap!r}; bf16 flash (the main path's logits) "
          f"against float32 dense {bf16_gap!r} (atol {VIT_BF16_LOGITS_ATOL}),"
          f" causal control {cbf16_gap!r}. Zeroed position table, top and bottom halves "
          f"swapped: max |diff| {sgap!r} (atol {satol}, rtol {srtol}), causal "
          f"control {csgap!r}")
    check(torch.allclose(got, want, atol=atol, rtol=rtol),
          f"(b) float32 flash logits against dense: {gap}")
    check(not torch.allclose(ctrl, want, atol=atol, rtol=rtol),
          f"(b) the causal control's logits fall inside the tolerance "
          f"({cgap})")
    check(bf16_gap <= VIT_BF16_LOGITS_ATOL,
          f"(b) bf16 flash logits against float32 dense: {bf16_gap}")
    check(cbf16_gap > VIT_BF16_LOGITS_ATOL,
          f"(b) the bf16 causal control's logits fall inside the limit "
          f"({cbf16_gap})")
    check(torch.allclose(sym_a, sym_b, atol=satol, rtol=srtol),
          f"(b) position symmetry: {sgap}")
    check(not torch.allclose(csym_a, csym_b, atol=satol, rtol=srtol),
          f"(b) the causal control keeps the position symmetry ({csgap})")
    del want, got, ctrl, ctrl16, sym_a, sym_b, csym_a, csym_b, swapped, sym

    # ms per batch, flash and dense (bf16) interleaved.
    dense = dataclasses.replace(cfg, attention_impl="dense")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fwd_ms = {"flash": [], "dense": []}
    with torch.no_grad():
        forward_vit(params0, images, dense)  # warm-up
        for _ in range(VIT_REPEATS):
            for label, c in (("flash", cfg), ("dense", dense)):
                torch.cuda.synchronize()
                start.record()
                for _ in range(VIT_TIMED):
                    forward_vit(params0, images, c)
                end.record()
                torch.cuda.synchronize()
                fwd_ms[label].append(start.elapsed_time(end) / VIT_TIMED)
    print(f"(b) classify, ms per batch of {VIT_BATCH} (CUDA events, "
          f"{VIT_TIMED} forwards a repeat, {VIT_REPEATS} interleaved "
          f"repeats): flash {fwd_ms['flash']}, dense {fwd_ms['dense']}; "
          f"images/s {VIT_BATCH / max(fwd_ms['flash']) * 1e3!r}-"
          f"{VIT_BATCH / min(fwd_ms['flash']) * 1e3!r} (flash)  [{card}]")
    torch.cuda.empty_cache()

    # ---- (c) training on one device ----------------------------------------
    check(losses[-1] < losses[0], f"(c) loss did not fall: {losses}")
    check(abs(losses[0] - math.log(VIT["n_classes"])) <=
          0.3 * math.log(VIT["n_classes"]),
          f"(c) first loss {losses[0]} not within 30% of ln "
          f"{VIT['n_classes']}")
    _, _, rlosses, _ = run("(c) remat", dataclasses.replace(cfg, remat=True),
                           None, 1, [2 * layers] + one_k[1:])
    check(abs(rlosses[0] - losses[0]) <= REMAT_LOSS_RTOL * abs(losses[0]),
          f"(c) remat loss {rlosses[0]} differs from {losses[0]}")
    grads = {}
    for impl in ("flash", "dense"):
        c = dataclasses.replace(cfg32, attention_impl=impl)
        params = clone_tree(params0)
        leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
        loss = vit_loss_fn(params, batch, c)
        grads[impl] = (loss.item(), torch.autograd.grad(loss, leaves))
        del params, leaves, loss
    (lf, gf), (ld, gd) = grads["flash"], grads["dense"]
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                .item() for a, b in zip(gf, gd))
    print(f"(c) remat step: loss {rlosses[0]!r} (plain {losses[0]!r}), kernel "
          f"1 twice a layer; float32 step, flash against dense: loss {lf!r} "
          f"vs {ld!r}, {len(gf)} gradient leaves, worst max|diff|/max|grad| "
          f"{worst!r} (limits {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_REL})")
    check(abs(lf - ld) <= TRAIN_LOSS_RTOL * abs(ld),
          f"(c) float32 flash loss {lf} vs dense {ld}")
    check(all(bool(torch.isfinite(a).all()) for a in gf) and
          worst <= TRAIN_GRAD_REL,
          f"(c) float32 gradients, flash against dense: {worst}")
    del grads, gf, gd
    torch.cuda.empty_cache()

    # ---- (d) the mesh against one device, and the faulty control ----------
    check(state_m["specs"]["blocks"][0]["w1"] == (None, "tp"),
          f"(d) w1's spec {state_m['specs']['blocks'][0]['w1']}")
    tpm.ring_allreduce = (lambda contribs, ring, op="sum":
                          contribs[:1].expand_as(contribs))
    try:
        _, cstate, closses, _ = run("(d) control", cfg, mesh,
                                    VIT_MESH_STEPS, one_k)
    finally:
        tpm.ring_allreduce = ring_allreduce
    mesh_p = [x.detach() for x in tree_leaves(state_m["params"])]
    ctrl_p = [x.detach() for x in tree_leaves(cstate["params"])]
    del cstate
    lg, pg = loss_gaps(mesh_losses, losses), rel_gap(mesh_p, at3, p0)
    clg, cpg = loss_gaps(closses, losses), rel_gap(ctrl_p, at3, p0)
    print(f"(d) (dp 2, sp 2, tp 2) against one device over "
          f"{VIT_MESH_STEPS} steps: relative loss gaps {lg} (rtol "
          f"{VIT_MESH_LOSS_RTOL}), parameter gap ||p - p_one|| / ||p_one - "
          f"p_0|| {pg!r} (limit {VIT_MESH_PARAM_REL}); control (rank 0's "
          f"partials): losses {closses}, gaps {clg}, parameter gap {cpg!r}; "
          f"w1's spec "
          f"{state_m['specs']['blocks'][0]['w1']}")
    check(max(lg) <= VIT_MESH_LOSS_RTOL and pg <= VIT_MESH_PARAM_REL,
          f"(d) mesh against one device: gaps {lg}, {pg}")
    check(min(clg) > VIT_MESH_LOSS_RTOL and cpg > VIT_MESH_PARAM_REL,
          f"(d) the control's gaps {clg}, {cpg} fall inside the limits")
    del mesh_p, ctrl_p, at3
    torch.cuda.empty_cache()

    # ---- times: one device and the mesh, interleaved; a profiled step ------
    times = {"one device": [], "mesh": []}
    for _ in range(VIT_REPEATS):
        for label, fn, st in (("one device", step1, state1),
                              ("mesh", step_m, state_m)):
            torch.cuda.synchronize()
            start.record()
            for _ in range(VIT_TIMED):
                fn(st, batch)
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / VIT_TIMED)
    one_ms = min(times["one device"])
    flops = vit_flops_per_step(cfg, VIT_BATCH)
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    tflops = [flops / ms / 1e9 for ms in times["one device"]]
    print(f"(c) ms per step (CUDA events, {VIT_TIMED} steps a repeat, "
          f"{VIT_REPEATS} interleaved repeats): one device "
          f"{times['one device']}, (d) mesh {times['mesh']}; one device "
          f"{VIT_BATCH / max(times['one device']) * 1e3!r}-"
          f"{VIT_BATCH / one_ms * 1e3!r} images/s, {flops!r} model FLOP a "
          f"step, {min(tflops)!r}-{max(tflops)!r} TFLOP/s, MFU "
          f"{None if peak is None else max(tflops) / peak!r} against {peak} "
          f"TFLOP/s dense bf16  [{card}]")
    profile_steps(lambda: step1(state1, batch), 2, "ViT step", one_ms, card)
    del state1, state_m
    torch.cuda.empty_cache()
    return main_counts


def ssm_launches(layers, sp, forwards):
    """Kernel-7 launches of ``forwards`` sp forwards of the state-space LM,
    counted from the code: each layer's ``sharded_linear_scan`` hops the
    a- and the b-summary once a Hillis-Steele round (⌈log2 sp⌉ rounds) and
    the carry once; nothing at sp 1."""
    import math

    hops = 0 if sp == 1 else 2 * math.ceil(math.log2(sp)) + 1
    return forwards * layers * hops


def rel_l2(got, want) -> float:
    """||got - want|| / ||want|| in float64 (complex values as pairs)."""
    import torch

    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def ssm_slice(dev, card):
    """Phase 17: the state-space LM (``models/ssm.py``) served at
    measure_ssm's width (SSM), bf16 compute over float32 masters, and its
    sequence-parallel forward over SSM_SP sp ranks on the card (kernel 7
    for every hop of ``parallel/scan.py``'s sharded scan). Main path,
    counted alone: (c) ``ssm_forward`` at (BATCH, SSM_SEQ) and
    ``ssm_decode`` of BATCH × PROMPT_LEN prompts + NEW_TOKENS in bf16 and
    in float32 (no kernel); (d) ``ssm_forward_sp`` at (BATCH, SSM_SP_SEQ)
    in float32 and in bf16, ``ssm_launches`` kernel-7 launches. Then,
    outside the count: (a) kernel 7 at the scan's summary shape (SSM_SP,
    BATCH, d_state) complex64 as float32 pairs, bitwise its plain version,
    timed beside its bound, the plain version and ``index_select``; (b)
    ``sharded_linear_scan`` on (BATCH, SSM_SP_SEQ, d_state) complex64,
    |a| in [0.4, 0.99): within SSM_SCAN_TOL of the whole sequence's
    ``linear_scan``, rank 0's chunk bitwise the local scan, 7 hops, and
    the control (every hop the wrong way) outside the tolerance; (c) the
    prefill's states and last logits against PROMPT_LEN sequential steps
    (float32 within SSM_STEP_TOL, bf16 within SSM_BF16_STEP_REL), the
    float32 tokens greedy under a teacher-forced forward (each within
    SSM_FP32_TIE of its row's largest logit, near-ties printed), the
    control (a zeroed state after the prefill) outside it, ms per token;
    (d) float32 within SSM_SP_TOL of one device, bf16 within
    SSM_BF16_SP_REL, the control (the carry dropped) outside both, ms per
    forward beside one device's; a profiled decode step and sp forward.
    Returns ({kernel: launches on the main path}, max |kernel 7 -
    plain|)."""
    import importlib
    import math

    import torch

    from mpi_tpu_torch.models import (SsmConfig, init_ssm_params,
                                      init_ssm_state, ssm_decode,
                                      ssm_forward, ssm_forward_sp,
                                      ssm_prefill, ssm_step)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce)
    from mpi_tpu_torch.parallel import (linear_scan, make_mesh, sendrecv,
                                        sendrecv_plain, sharded_linear_scan)
    from mpi_tpu_torch.parallel.zero import tree_leaves

    ssm_mod = importlib.import_module("mpi_tpu_torch.models.ssm")
    scan_mod = importlib.import_module("mpi_tpu_torch.parallel.scan")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 checks need full float32 products")
    cfg = SsmConfig(**SSM, dtype=torch.bfloat16)
    cfg32 = SsmConfig(**SSM)
    h, n = cfg.d_state, SSM_SP
    params = init_ssm_params(cfg, torch.Generator().manual_seed(0))
    print(f"SSM: {sum(x.numel() for x in tree_leaves(params))} parameters "
          f"(float32 masters), {SSM}, batch {BATCH}, seq {SSM_SEQ}, sp "
          f"{n} at seq {SSM_SP_SEQ}")
    mesh = make_mesh(axis="sp", devices=[dev] * n)
    hgen = torch.Generator().manual_seed(17)
    tokens = torch.randint(0, cfg.vocab, (BATCH, SSM_SEQ), generator=hgen)
    long_toks = torch.randint(0, cfg.vocab, (BATCH, SSM_SP_SEQ),
                              generator=hgen)
    prompt = tokens[:, :PROMPT_LEN].to(dev)

    # ---- the main path, counted alone ------------------------------------
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():
        logits = ssm_forward(cfg, params, tokens)
        out16 = ssm_decode(cfg, params, prompt, NEW_TOKENS)
        out32 = ssm_decode(cfg32, params, prompt, NEW_TOKENS)
        sp32 = ssm_forward_sp(cfg32, params, long_toks, mesh)
        sp16 = ssm_forward_sp(cfg, params, long_toks, mesh)
    torch.cuda.synchronize()
    main_counts = {name: w.launches for name, w in wrappers.items()}
    want = {name: 0 for name in wrappers}
    want["sendrecv"] = ssm_launches(cfg.n_layers, n, 2)
    check(main_counts == want,
          f"SSM path launched {main_counts}, want {want} (counted from the "
          f"code: 2 sp forwards x {cfg.n_layers} layers x "
          f"{ssm_launches(1, n, 1)} hops)")
    check(logits.shape == (BATCH, SSM_SEQ, cfg.vocab) and
          logits.dtype == torch.bfloat16 and
          bool(torch.isfinite(logits).all()),
          f"ssm_forward: logits {logits.dtype} {tuple(logits.shape)}, or "
          f"not finite")
    for label, out in (("bf16", out16), ("float32", out32)):
        check(tuple(out.shape) == (BATCH, PROMPT_LEN + NEW_TOKENS) and
              out.device.type == "cuda" and torch.equal(out[:, :PROMPT_LEN],
                                                        prompt) and
              bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"ssm_decode {label}: tokens {tuple(out.shape)} on "
              f"{out.device}, the prompt changed, or outside the vocab")
    for label, out in (("float32", sp32), ("bf16", sp16)):
        check(out.shape == (BATCH, SSM_SP_SEQ, cfg.vocab) and
              bool(torch.isfinite(out).all()),
              f"ssm_forward_sp {label}: {tuple(out.shape)} or not finite")
    print(f"SSM phase launches (main path: a bf16 forward, bf16 and float32 "
          f"decodes, float32 and bf16 sp forwards): {main_counts}")
    del logits

    # ---- (a) kernel 7 at the scan's summary shape --------------------------
    dgen = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(n, BATCH, h, 2, generator=dgen, device=dev)
    perm = [(r, (r + 1) % n) for r in range(n)]
    src = torch.tensor([(r - 1) % n for r in range(n)], device=dev)
    got = sendrecv(x, mesh, perm)
    ref = sendrecv_plain(x, perm)
    torch.cuda.synchronize()
    check(bits_equal(got, ref), f"kernel 7 at the scan's summary shape "
                                f"{tuple(x.shape)} differs from its plain "
                                f"version")
    err = max_abs_diff(got, ref)
    k_ms = kernel_ms(lambda y: sendrecv(y, mesh, perm), [(x,)], 200)
    p_ms = kernel_ms(lambda y: sendrecv_plain(y, perm), [(x,)], 20)
    l_ms = kernel_ms(lambda y: y.index_select(0, src), [(x,)], 200)
    b_ms, b_by = bound(2 * x.numel() * x.element_size(), 0, x.dtype)
    print(f"(a) kernel 7 at the scan's summary shape {tuple(x.shape)} "
          f"float32 (({n}, b {BATCH}, h {h}) complex64), bitwise plain: "
          f"{k_ms * 1e3!r} us against a {b_ms * 1e3!r} us bound ({b_by}), "
          f"plain {p_ms * 1e3!r} us, index_select {l_ms * 1e3!r} us  "
          f"[{card}]")

    # ---- (b) the sharded scan against the whole sequence's -----------------
    shape = (BATCH, SSM_SP_SEQ, h)
    mod = 0.4 + 0.59 * torch.rand(shape, generator=dgen, device=dev)
    a = torch.polar(mod, math.pi * torch.rand(shape, generator=dgen,
                                              device=dev))
    b = torch.complex(torch.randn(shape, generator=dgen, device=dev),
                      torch.randn(shape, generator=dgen, device=dev))
    del mod

    def stack(t):
        return t.reshape(BATCH, n, -1, h).transpose(0, 1)

    def unstack(t):
        return t.transpose(0, 1).reshape(shape)

    def scan_gap(got, want):
        g, w = torch.view_as_real(got), torch.view_as_real(want)
        return max_abs_diff(g, w), torch.allclose(
            g, w, atol=SSM_SCAN_TOL[0], rtol=SSM_SCAN_TOL[1])

    with torch.no_grad():
        whole = linear_scan(a, b, dim=1)
        before = sendrecv.launches
        sharded = sharded_linear_scan(stack(a), stack(b), mesh, dim=1)
        torch.cuda.synchronize()
        hops = sendrecv.launches - before
        local0 = linear_scan(stack(a)[0], stack(b)[0], dim=1)
        gap, ok = scan_gap(unstack(sharded), whole)
        rank0 = bits_equal(torch.view_as_real(sharded[0]),
                           torch.view_as_real(local0))
        sound_hop = scan_mod._hop
        scan_mod._hop = lambda t, ring, shift: sound_hop(t, ring, -shift)
        try:
            wrong = sharded_linear_scan(stack(a), stack(b), mesh, dim=1)
        finally:
            scan_mod._hop = sound_hop
        ctrl_gap, ctrl_ok = scan_gap(unstack(wrong), whole)
    print(f"(b) sharded_linear_scan {shape} complex64 over {n} sp ranks: "
          f"{hops} kernel-7 launches; max |diff| to the whole sequence's "
          f"linear_scan {gap!r} (max |x| "
          f"{float(whole.abs().max())!r}; tolerance {SSM_SCAN_TOL}); rank "
          f"0's chunk bitwise the local scan: {rank0}; the control (every "
          f"hop the wrong way) {ctrl_gap!r}")
    check(hops == ssm_launches(1, n, 1),
          f"the sharded scan launched kernel 7 {hops} times, want "
          f"{ssm_launches(1, n, 1)}")
    check(ok, f"the sharded scan differs from the whole sequence's by {gap}")
    check(rank0, "rank 0's chunk of the sharded scan is not the local "
                 "scan's bits")
    check(not ctrl_ok, f"the wrong-way control passed the tolerance "
                       f"({ctrl_gap})")
    scan_ms = kernel_ms(lambda p, q: sharded_linear_scan(
        stack(p), stack(q), mesh, dim=1), [(a, b)], 3)
    whole_ms = kernel_ms(lambda p, q: linear_scan(p, q, dim=1), [(a, b)], 3)
    print(f"(b) ms a scan: sharded over {n} ranks {scan_ms!r}, the whole "
          f"sequence on one device {whole_ms!r} (CUDA events)  [{card}]")
    del a, b, whole, sharded, local0, wrong
    torch.cuda.empty_cache()

    # ---- (c) one device: prefill against steps, greedy decode ---------------
    with torch.no_grad():
        for c, label in ((cfg32, "float32"), (cfg, "bf16")):
            st_p, lg_p = ssm_prefill(c, params, prompt)
            st = init_ssm_state(c, BATCH)
            for i in range(PROMPT_LEN):
                st, lg = ssm_step(c, params, st, prompt[:, i])
            st_abs = max(max_abs_diff(torch.view_as_real(p),
                                      torch.view_as_real(q))
                         for p, q in zip(st_p, st))
            st_rel = max(rel_l2(p, q) for p, q in zip(st_p, st))
            lg_abs, lg_rel = max_abs_diff(lg_p, lg), rel_l2(lg_p, lg)
            print(f"(c) {label} prefill of {PROMPT_LEN} against "
                  f"{PROMPT_LEN} steps: states max |diff| {st_abs!r} "
                  f"(relative L2 {st_rel!r}), last logits max |diff| "
                  f"{lg_abs!r} (relative L2 {lg_rel!r})")
            if c is cfg32:
                check(all(torch.allclose(
                    torch.view_as_real(p), torch.view_as_real(q),
                    atol=SSM_STEP_TOL[0], rtol=SSM_STEP_TOL[1])
                    for p, q in zip(st_p, st)) and torch.allclose(
                    lg_p, lg, atol=SSM_STEP_TOL[0], rtol=SSM_STEP_TOL[1]),
                    f"float32 prefill against steps: states {st_abs}, "
                    f"logits {lg_abs} (tolerance {SSM_STEP_TOL})")
            else:
                check(st_rel <= SSM_BF16_STEP_REL and
                      lg_rel <= SSM_BF16_STEP_REL,
                      f"bf16 prefill against steps: relative L2 states "
                      f"{st_rel}, logits {lg_rel} (limit "
                      f"{SSM_BF16_STEP_REL})")

    def greedy_gaps(c, out):
        """(b, NEW_TOKENS) float32: how far each new token's logit lies
        below its row's largest under one teacher-forced forward."""
        with torch.no_grad():
            lg = ssm_forward(c, params, out[:, :-1])[:, PROMPT_LEN - 1:]
        lg = lg.float()
        picked = lg.gather(-1, out[:, PROMPT_LEN:, None])[..., 0]
        return lg.max(-1).values - picked

    g32 = greedy_gaps(cfg32, out32)
    ties = [(int(r), int(p), float(g32[r, p]))
            for r, p in (g32 > 0).nonzero().tolist()]
    g16 = greedy_gaps(cfg, out16)
    print(f"(c) float32 decode, {BATCH} x {NEW_TOKENS} tokens: "
          f"{int((g32 == 0).sum())} the teacher-forced argmax; near-ties "
          f"(row, position, gap to the row max; limit {SSM_FP32_TIE}): "
          f"{ties}. bf16 decode: {int((g16 == 0).sum())} the bf16 "
          f"teacher-forced argmax, largest gap {float(g16.max())!r}; "
          f"agreement with float32 "
          f"{float((out16 == out32).float().mean())!r}")
    check(float(g32.max()) <= SSM_FP32_TIE,
          f"float32 decode: a token lies {float(g32.max())} below its "
          f"teacher-forced row max (limit {SSM_FP32_TIE})")
    sound_prefill = ssm_mod._prefill

    def zeroed(c, p, toks):
        states, lg = sound_prefill(c, p, toks)
        return [torch.zeros_like(s) for s in states], lg

    ssm_mod._prefill = zeroed
    try:
        ctrl = ssm_decode(cfg32, params, prompt, NEW_TOKENS)
    finally:
        ssm_mod._prefill = sound_prefill
    cg = float(greedy_gaps(cfg32, ctrl).max())
    print(f"(c) control (the state zeroed after the prefill), float32: "
          f"largest gap to the teacher-forced row max {cg!r} (limit "
          f"{SSM_FP32_TIE}); agreement with the sound decode "
          f"{float((ctrl == out32).float().mean())!r}")
    check(cg > SSM_FP32_TIE, f"the zeroed-state control passed the greedy "
                             f"check (gap {cg})")

    times = {"bf16": [], "float32": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(SSM_REPEATS):
        for label, c in (("bf16", cfg), ("float32", cfg32)):
            torch.cuda.synchronize()
            start.record()
            ssm_decode(c, params, prompt, NEW_TOKENS)
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / NEW_TOKENS)
    for label, ts in times.items():
        print(f"(c) ssm_decode {label}: {ts} ms per token (the prefill of "
              f"{PROMPT_LEN} and {NEW_TOKENS - 1} steps over {NEW_TOKENS} "
              f"tokens, batch {BATCH}; {BATCH / max(ts) * 1e3!r}-"
              f"{BATCH / min(ts) * 1e3!r} tok/s; CUDA events, "
              f"{SSM_REPEATS} interleaved repeats)  [{card}]")
    del out16, out32, ctrl
    torch.cuda.empty_cache()

    # ---- (d) the sp forward against one device -----------------------------
    sound_scan = ssm_mod.sharded_linear_scan

    def dropped(coef, drive, ring, axis_name="sp", dim=0):
        return linear_scan(coef, drive, dim=dim + 1)  # each chunk alone

    with torch.no_grad():
        one32 = ssm_forward(cfg32, params, long_toks)
        gap32 = max_abs_diff(sp32, one32)
        ok32 = torch.allclose(sp32, one32, atol=SSM_SP_TOL[0],
                              rtol=SSM_SP_TOL[1])
        ssm_mod.sharded_linear_scan = dropped
        try:
            ctrl32 = ssm_forward_sp(cfg32, params, long_toks, mesh)
        finally:
            ssm_mod.sharded_linear_scan = sound_scan
        cgap32 = max_abs_diff(ctrl32, one32)
        cok32 = torch.allclose(ctrl32, one32, atol=SSM_SP_TOL[0],
                               rtol=SSM_SP_TOL[1])
        del ctrl32, one32, sp32
        torch.cuda.empty_cache()
        one16 = ssm_forward(cfg, params, long_toks)
        rel16, gap16 = rel_l2(sp16, one16), max_abs_diff(sp16, one16)
        ssm_mod.sharded_linear_scan = dropped
        try:
            ctrl16 = ssm_forward_sp(cfg, params, long_toks, mesh)
        finally:
            ssm_mod.sharded_linear_scan = sound_scan
        crel16 = rel_l2(ctrl16, one16)
        del ctrl16, one16, sp16
    torch.cuda.empty_cache()
    print(f"(d) ssm_forward_sp over {n} sp ranks at ({BATCH}, "
          f"{SSM_SP_SEQ}) against ssm_forward on one device: float32 max "
          f"|diff| {gap32!r} (tolerance {SSM_SP_TOL}), bf16 relative L2 "
          f"{rel16!r} (max |diff| {gap16!r}; limit {SSM_BF16_SP_REL}); the "
          f"control (the carry dropped): float32 max |diff| {cgap32!r}, "
          f"bf16 relative L2 {crel16!r}")
    check(ok32, f"float32 sp forward differs from one device by {gap32}")
    check(rel16 <= SSM_BF16_SP_REL,
          f"bf16 sp forward: relative L2 {rel16} over {SSM_BF16_SP_REL}")
    check(not cok32 and crel16 > SSM_BF16_SP_REL,
          f"the carry-dropped control passed a check: float32 {cgap32}, "
          f"bf16 {crel16}")

    fwd_times = {key: [] for key in ("sp bf16", "one bf16", "sp float32",
                                     "one float32")}
    calls = {"sp bf16": lambda: ssm_forward_sp(cfg, params, long_toks, mesh),
             "one bf16": lambda: ssm_forward(cfg, params, long_toks),
             "sp float32": lambda: ssm_forward_sp(cfg32, params, long_toks,
                                                  mesh),
             "one float32": lambda: ssm_forward(cfg32, params, long_toks)}
    with torch.no_grad():
        for fn in calls.values():
            fn()
        for _ in range(SSM_REPEATS):
            for key, fn in calls.items():
                torch.cuda.synchronize()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                fwd_times[key].append(start.elapsed_time(end))
    print(f"(d) ms a forward at ({BATCH}, {SSM_SP_SEQ}) (CUDA events, "
          f"{SSM_REPEATS} interleaved repeats): {fwd_times}; "
          f"{BATCH * SSM_SP_SEQ / min(fwd_times['sp bf16']) * 1e3!r} tok/s "
          f"sp bf16 at best  [{card}]")

    # ---- where a decode step's and an sp forward's time goes ---------------
    with torch.no_grad():
        dparams = ssm_mod._cast_weights(cfg, params)
        state, lg = ssm_prefill(cfg, dparams, prompt)
        tok = lg.argmax(-1)
        ssm_step(cfg, dparams, state, tok)
        profile_steps(lambda: ssm_step(cfg, dparams, state, tok), 4,
                      "SSM bf16 decode step", min(times["bf16"]), card)
        profile_steps(lambda: ssm_forward_sp(cfg, params, long_toks, mesh),
                      1, "SSM bf16 sp forward", min(fwd_times["sp bf16"]),
                      card)
    del params, dparams, state
    torch.cuda.empty_cache()
    return main_counts, err


def ssm_flops_per_step(cfg, batch, seq):
    """(model FLOPs of one SSM optimizer step, the float32 share), counted
    from ``models/ssm.py`` as ``train.train_flops_per_step`` counts the
    LM's: the forward's matrix products times 3 for forward and backward.
    Per layer the drive (two float32 products ``(N, d) @ (d, h)``) and the
    read-out (two ``(N, h) @ (h, d)``), 8 N d h together, and the MLP, 4 N
    d f; then the head, 2 N d V; N = batch · seq tokens. The scan's
    elementwise work is not counted."""
    n = batch * seq
    d, h, f, v = cfg.d_model, cfg.d_state, cfg.d_ff, cfg.vocab
    fp32 = 8 * n * d * h * cfg.n_layers
    total = fp32 + 4 * n * d * f * cfg.n_layers + 2 * n * d * v
    return 3.0 * total, 3.0 * fp32


def ssm_train_launches(dp_steps):
    """{kernel: launches} of phase 18's main path, counted from the code
    (``models/ssm.py``, ``make_ssm_train_step``): a one-device step launches
    no kernel (the scan is plain PyTorch, as JAX's is XLA's), a dp step one
    kernel-6 launch on its gradient bucket."""
    counts = {name: 0 for name in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv", "flash_decode_attention",
                                   "ring_allgather", "ring_allreduce",
                                   "sendrecv")}
    counts["ring_allreduce"] = dp_steps
    return counts


def ssm_train_slice(dev, card):
    """Phase 18: the state-space LM (``models/ssm.py``) trained through
    ``make_ssm_train_step`` at measure_ssm's width and batch (SSM, BATCH
    × (SSM_SEQ + 1) tokens), bf16 over float32 masters, on one device and
    over SSM_DP dp ranks on the card (kernel 6 on the gradient bucket).
    Main path, counted alone: (b) SSM_TRAIN_STEPS steps on one device and
    SSM_DP_STEPS dp steps, ``ssm_train_launches`` launches. Then, outside
    the count: (a) kernel 6 at the SSM's bucket (SSM_DP, 92,321,792)
    float32, bitwise its plain version and every rank's copy the same bits,
    timed beside its bound, the plain version and ``torch.sum``; (c) dp
    against one device over SSM_DP_STEPS steps from the same parameters, in
    float32 and in bf16, within SSM_DP_LOSS_RTOL and SSM_DP_PARAM_REL, and
    the control (each rank's copy of the bucket its own gradient, so the
    step takes rank 0's gradient alone) outside them; (d) ms a step, one
    device and dp interleaved, tokens/s, model TFLOP/s and MFU, a profiled
    step of each; (e) ``ssm_decode`` of the trained tree. Returns
    ({kernel: launches on the main path}, max |kernel 6 - plain|)."""
    import importlib
    import math

    import numpy as np
    import torch

    from mpi_tpu_torch.models import (SsmConfig, init_ssm_params,
                                      make_ssm_train_step, ssm_decode)
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce,
                                                    ring_allreduce_plain)
    from mpi_tpu_torch.parallel import make_mesh, sendrecv
    from mpi_tpu_torch.parallel.zero import DpLayout, tree_leaves
    from mpi_tpu_torch.train import peak_bf16_tflops

    ssm_mod = importlib.import_module("mpi_tpu_torch.models.ssm")
    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the float32 checks need full float32 products")
    cfgs = {"bf16": SsmConfig(**SSM, dtype=torch.bfloat16),
            "float32": SsmConfig(**SSM)}
    cfg = cfgs["bf16"]
    params0 = init_ssm_params(cfg, torch.Generator().manual_seed(0))
    p0 = tree_leaves(params0)
    n_params = sum(x.numel() for x in p0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (BATCH, SSM_SEQ + 1))).to(dev)
    mesh = make_mesh(axis="dp", devices=[dev] * SSM_DP)
    print(f"SSM training: {n_params} parameters (float32 masters), {SSM}, "
          f"tokens ({BATCH}, {SSM_SEQ + 1}), AdamW at 1e-3, dp "
          f"{SSM_DP} ranks on the card")

    def run(c, m, steps, snapshot=None):
        """``steps`` steps from params0: (step, state, losses, the leaves
        after ``snapshot`` steps)."""
        init_state, step = make_ssm_train_step(c, mesh=m)
        state = init_state.from_params(clone_tree(params0))
        losses, at = [], None
        for i in range(steps):
            losses.append(step(state, tokens)[1])
            if i + 1 == snapshot:
                at = [x.detach().clone() for x in
                      tree_leaves(state["params"])]
        check(state["step"] == steps, f"state['step'] {state['step']}, "
                                      f"want {steps}")
        return step, state, [float(x) for x in losses], at

    # ---- (b) the main path, counted alone ----------------------------------
    for w in wrappers.values():
        w.launches = 0
    step1, state1, losses, at3 = run(cfg, None, SSM_TRAIN_STEPS,
                                     snapshot=SSM_DP_STEPS)
    step_d, state_d, dp_losses, _ = run(cfg, mesh, SSM_DP_STEPS)
    torch.cuda.synchronize()
    main_counts = {name: w.launches for name, w in wrappers.items()}
    want = ssm_train_launches(SSM_DP_STEPS)
    check(main_counts == want,
          f"SSM training launched {main_counts}, want {want} (counted from "
          f"the code: no kernel a one-device step, one kernel-6 launch a dp "
          f"step)")
    print(f"(b) bf16 losses, one device: {losses}; dp {SSM_DP}: "
          f"{dp_losses}; launches (main path: {SSM_TRAIN_STEPS} steps on "
          f"one device, {SSM_DP_STEPS} dp steps): {main_counts}")
    check(all(math.isfinite(x) for x in losses + dp_losses),
          f"(b) a loss is not finite: {losses}, {dp_losses}")
    check(losses[-1] < losses[0], f"(b) loss did not fall: {losses}")
    check(all(x.dtype == torch.float32 and x.device.type == "cuda"
              for x in tree_leaves(state1["params"])),
          "(b) the masters left float32 or the card")

    # ---- (a) kernel 6 at the SSM's bucket ----------------------------------
    layout = DpLayout([[(x.shape, None) for x in p0]], SSM_DP)
    m = layout.width
    check(m == n_params, f"the bucket is padded: width {m}, {n_params} "
                         f"parameters")
    gen = torch.Generator(device=dev).manual_seed(18)
    bucket = torch.randn(SSM_DP, m, generator=gen, device=dev)
    got = ring_allreduce(bucket, mesh)
    ref = ring_allreduce_plain(bucket)
    torch.cuda.synchronize()
    check(bits_equal(got, ref), f"kernel 6 at the SSM bucket ({SSM_DP}, "
                                f"{m}) differs from its plain version")
    check(bits_equal(got, got[:1].expand_as(got)),
          "kernel 6 at the SSM bucket: the ranks hold different results")
    err = max_abs_diff(got, ref)
    del got, ref
    torch.cuda.empty_cache()
    k_ms = kernel_ms(lambda c: ring_allreduce(c, mesh), [(bucket,)], 10)
    p_ms = kernel_ms(ring_allreduce_plain, [(bucket,)], 3)
    l_ms = kernel_ms(lambda c: torch.sum(c, 0), [(bucket,)], 10)
    least = 2 * bucket.numel() * bucket.element_size()
    b_ms, b_by = bound(least, (SSM_DP - 1) * m, bucket.dtype)
    print(f"(a) kernel 6 at the SSM bucket ({SSM_DP}, {m}) float32, bitwise "
          f"plain, every copy the same bits: {k_ms * 1e3!r} us against a "
          f"{b_ms * 1e3!r} us bound ({b_by}; {least} bytes read once and "
          f"written once), {least / k_ms / 1e9!r} TB/s, plain "
          f"{p_ms * 1e3!r} us, torch.sum(contribs, 0) {l_ms * 1e3!r} us  "
          f"[{card}]")
    del bucket
    torch.cuda.empty_cache()

    # ---- (c) dp against one device, float32 and bf16, and the control -----
    def leaves_of(state):
        return [x.detach() for x in tree_leaves(state["params"])]

    def control(c):
        sound = ssm_mod.ring_allreduce
        ssm_mod.ring_allreduce = (lambda contribs, ring, op="sum":
                                  contribs * ring.size)
        try:
            _, state, ls, _ = run(c, mesh, SSM_DP_STEPS)
        finally:
            ssm_mod.ring_allreduce = sound
        return ls, leaves_of(state)

    gaps = {}
    for label, c in cfgs.items():
        if label == "bf16":
            one_l, one_p = losses[:SSM_DP_STEPS], at3
            dp_l, dp_p = dp_losses, leaves_of(state_d)
        else:
            _, state, one_l, _ = run(c, None, SSM_DP_STEPS)
            one_p = leaves_of(state)
            _, state, dp_l, _ = run(c, mesh, SSM_DP_STEPS)
            dp_p = leaves_of(state)
            del state
        ctrl_l, ctrl_p = control(c)
        gaps[label] = (max(loss_gaps(dp_l, one_l)), rel_gap(dp_p, one_p, p0),
                       loss_gaps(ctrl_l, one_l), rel_gap(ctrl_p, one_p, p0))
        print(f"(c) {label}, dp {SSM_DP} against one device over "
              f"{SSM_DP_STEPS} steps: losses {dp_l} against {one_l}, "
              f"largest relative gap {gaps[label][0]!r} (rtol "
              f"{SSM_DP_LOSS_RTOL[label]}), parameter gap ||p - p_one|| / "
              f"||p_one - p_0|| {gaps[label][1]!r} (limit "
              f"{SSM_DP_PARAM_REL[label]}); control (rank 0's gradient "
              f"alone): losses {ctrl_l}, gaps {gaps[label][2]}, parameter "
              f"gap {gaps[label][3]!r}")
        del one_p, dp_p, ctrl_p
        torch.cuda.empty_cache()
    for label, (lg, pg, clg, cpg) in gaps.items():
        check(lg <= SSM_DP_LOSS_RTOL[label] and pg <= SSM_DP_PARAM_REL[label],
              f"(c) {label} dp against one device: gaps {lg}, {pg}")
        check(max(clg) > SSM_DP_LOSS_RTOL[label] and
              cpg > SSM_DP_PARAM_REL[label],
              f"(c) {label}: the control's gaps {clg}, {cpg} fall inside "
              f"the limits")
    del at3

    # ---- (d) times: one device and dp, interleaved; a profiled step -------
    times = {"one device": [], f"dp {SSM_DP}": []}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(SSM_TRAIN_REPEATS):
        for label, fn, st in (("one device", step1, state1),
                              (f"dp {SSM_DP}", step_d, state_d)):
            torch.cuda.synchronize()
            start.record()
            for _ in range(SSM_TIMED_STEPS):
                fn(st, tokens)
            end.record()
            torch.cuda.synchronize()
            times[label].append(start.elapsed_time(end) / SSM_TIMED_STEPS)
    flops, fp32 = ssm_flops_per_step(cfg, BATCH, SSM_SEQ)
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    floor_ms = ((flops - fp32) / PEAK_FLOPS["torch.bfloat16"] +
                fp32 / PEAK_FLOPS["torch.float32"]) * 1e3
    n_tok = BATCH * SSM_SEQ
    for label, ts in times.items():
        tflops = [flops / ms / 1e9 for ms in ts]
        print(f"(d) {label}: {ts} ms per step (CUDA events, "
              f"{SSM_TIMED_STEPS} steps a repeat, {SSM_TRAIN_REPEATS} "
              f"interleaved repeats), {n_tok / max(ts) * 1e3!r}-"
              f"{n_tok / min(ts) * 1e3!r} tokens/s, {min(tflops)!r}-"
              f"{max(tflops)!r} model TFLOP/s, MFU "
              f"{None if peak is None else max(tflops) / peak!r} against "
              f"{peak} TFLOP/s dense bf16  [{card}]")
    print(f"(d) {flops!r} model FLOP a step ({fp32!r} of it in the float32 "
          f"drive and read-out products); at the peaks (bf16 "
          f"{PEAK_FLOPS['torch.bfloat16']}, float32 "
          f"{PEAK_FLOPS['torch.float32']}) the products alone take "
          f"{floor_ms!r} ms")
    profile_steps(lambda: step1(state1, tokens), 1, "SSM train step",
                  min(times["one device"]), card)
    profile_steps(lambda: step_d(state_d, tokens), 1,
                  f"SSM dp {SSM_DP} train step", min(times[f"dp {SSM_DP}"]),
                  card)
    del state_d
    torch.cuda.empty_cache()

    # ---- (e) the trained tree served ---------------------------------------
    prompt = tokens[:, :PROMPT_LEN]
    out = ssm_decode(cfg, state1["params"], prompt, NEW_TOKENS)
    torch.cuda.synchronize()
    check(tuple(out.shape) == (BATCH, PROMPT_LEN + NEW_TOKENS) and
          out.device.type == "cuda" and
          torch.equal(out[:, :PROMPT_LEN], prompt) and
          bool(((out >= 0) & (out < cfg.vocab)).all()),
          f"(e) ssm_decode of the trained tree: tokens {tuple(out.shape)} "
          f"on {out.device}, the prompt changed, or outside the vocab")
    print(f"(e) ssm_decode of the trained tree: {BATCH} x {PROMPT_LEN} "
          f"prompt + {NEW_TOKENS} tokens, in the vocab, the prompt kept; "
          f"{int(out[:, PROMPT_LEN:].unique().numel())} distinct new tokens")
    del state1, params0, p0
    torch.cuda.empty_cache()
    return main_counts, err


def io_launches(layers, steps, dp):
    """Launches of kernels 1-7 in ``steps`` steps of train.py's flagship
    step, counted from the code: one device, or ``dp`` ranks under FSDP
    (dp_launches; every flagship leaf is sharded at dp 8, so no replicated
    leaf takes a launch of its own)."""
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "ring_allgather",
             "ring_allreduce")
    per_step = dp_launches("one" if dp == 1 else "fsdp", dp, layers, 0)
    return {**{k: steps * n for k, n in zip(names, per_step)},
            "flash_decode_attention": 0, "sendrecv": 0}


def state_bytes(state):
    """Bytes of the storages a training state's tensors and its optimizer's
    tensors hold, each storage once."""
    import torch

    seen = {}

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif isinstance(node, torch.optim.Optimizer):
            for held in node.state.values():
                walk(list(held.values()))
        elif torch.is_tensor(node):
            st = node.untyped_storage()
            seen[(node.device, st.data_ptr())] = st.nbytes()

    walk(state)
    return sum(seen.values())


def io_slice(dev, card):
    """Phase 19: the trainer's I/O (``data.py``, ``utils/checkpoint.py``,
    ``train.py --corpus --checkpoint-dir --checkpoint-every --resume``).
    Writes a seeded 64 MiB uint16 corpus (ids below 8192) to a temporary
    directory, then for one device and for IO_DP dp ranks under FSDP:
    (a) the main path, counted alone: ``train.main`` at the flagship's full
    width from the corpus through the loader for IO_STEPS steps, an async
    checkpoint every IO_EVERY steps, launches against ``io_launches``;
    (b) the same run again without checkpoints, whose gap to (a) is the
    tolerance (0.0: bitwise); (c) the run stopped after step IO_EVERY's
    checkpoint (step IO_STEPS's removed) and resumed by ``train.main
    --resume`` into a state drawn from seed 1: its losses must equal (a)'s
    within the tolerance; (d) two controls that must miss it, the same
    restore with the optimizer's state dropped and with the stream started
    at step 0. Prints each save's cost to the step loop and its write
    time, the checkpoint's bytes against the state's, the gather's host
    time per batch (native and numpy), ms/step from the corpus against the
    synthetic stream, and ``torch.sum`` at the tp and ep partial shapes.
    Returns ({kernel: launches on the main path}, {shape: torch.sum ms})."""
    import contextlib
    import io
    import os
    import re
    import shutil
    import tempfile

    import numpy as np
    import torch

    from mpi_tpu_torch import train
    from mpi_tpu_torch.data import (ShardedLoader, _gather_windows,
                                    _gather_windows_plain, from_token_file)
    from mpi_tpu_torch.models import make_train_step
    from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                             flash_fwd)
    from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
    from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                    ring_allreduce)
    from mpi_tpu_torch.parallel import RankMesh, sendrecv
    from mpi_tpu_torch.utils.checkpoint import (all_steps,
                                                restore_checkpoint)

    wrappers = {"flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
                "flash_bwd_dkv": flash_bwd_dkv,
                "flash_decode_attention": flash_decode_attention,
                "ring_allgather": ring_allgather,
                "ring_allreduce": ring_allreduce, "sendrecv": sendrecv}
    cfg = train.flagship_train_config()
    seq = cfg.max_seq  # seq + 1 tokens a row
    runs = {"one device": (1, []), f"dp {IO_DP} fsdp": (
        IO_DP, ["--dp", str(IO_DP), "--fsdp"])}

    def cli(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = train.main(argv)
        out = out.getvalue()
        check(rc == 0, f"train.main {argv} exited {rc}:\n{out}")
        return out

    def losses_of(out):
        return {int(m[1]): float(m[2]) for m in re.finditer(
            r"^step (\d+) loss (\S+) ", out, re.MULTILINE)}

    def ms_of(out):
        return float(re.search(r"^([\d.]+) ms/step", out, re.MULTILINE)[1])

    def gap(got, want):
        return max(abs(got[i] - want[i]) / abs(want[i]) for i in got)

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io.")
    try:
        corpus = os.path.join(tmp, "corpus.bin")
        np.random.default_rng(19).integers(
            0, cfg.vocab, IO_CORPUS_TOKENS, dtype=np.uint16).tofile(corpus)
        print(f"trainer I/O: corpus of {IO_CORPUS_TOKENS} uint16 ids "
              f"({os.path.getsize(corpus)} bytes, seed 19, ids < "
              f"{cfg.vocab}); the flagship ({cfg.n_layers} layers, batch "
              f"{BATCH}, seq {seq - 1}) for {IO_STEPS} steps, a checkpoint "
              f"every {IO_EVERY}, one device and dp {IO_DP} fsdp")

        # ---- the gather, on the host ------------------------------------
        mm = np.memmap(corpus, dtype=np.uint16, mode="r")
        rng = np.random.default_rng(0)
        picks = [rng.permutation(IO_CORPUS_TOKENS // seq)[:BATCH]
                 for _ in range(IO_GATHER_BATCHES)]
        # Every picked page mapped first (a first touch is a page fault,
        # which would go to whichever gather ran first), then in turns.
        check(all(np.array_equal(_gather_windows(mm, p, seq),
                                 _gather_windows_plain(mm, p, seq))
                  for p in picks),
              "the native gather differs from the numpy gather")
        times = {"native": [], "numpy": []}
        for label, fn in (("native", _gather_windows),
                          ("numpy", _gather_windows_plain),
                          ("numpy", _gather_windows_plain),
                          ("native", _gather_windows)):
            t0 = time.perf_counter()
            for p in picks:
                fn(mm, p, seq)
            times[label].append((time.perf_counter() - t0) / len(picks)
                                * 1e6)
        src = from_token_file(corpus, BATCH, seq, dtype="uint16")
        for i in range(IO_GATHER_BATCHES):  # its pages mapped, as above
            src(i)
        t0 = time.perf_counter()
        for i in range(IO_GATHER_BATCHES):
            src(i)
        per_batch = (time.perf_counter() - t0) / IO_GATHER_BATCHES * 1e6
        print(f"(gather) a ({BATCH}, {seq}) batch from the memory-mapped "
              f"corpus (warm page cache, pages mapped), host clock, "
              f"{IO_GATHER_BATCHES} batches a turn, in turns native, numpy, "
              f"numpy, native: native {times['native']!r} us, numpy "
              f"{times['numpy']!r} us; from_token_file's source (its "
              f"window permutation and the native gather) {per_batch!r} us "
              f"(equal bits)  [{card}]")

        # ---- (a) the main path, counted alone ---------------------------
        dirs = {label: os.path.join(tmp, f"ckpt{n}")
                for label, (n, _) in runs.items()}
        outs = {}
        for w in wrappers.values():
            w.launches = 0
        for label, (n, flags) in runs.items():
            outs[label] = cli(["--corpus", corpus, "--steps", str(IO_STEPS),
                               "--checkpoint-dir", dirs[label],
                               "--checkpoint-every", str(IO_EVERY), *flags])
        torch.cuda.synchronize()
        main_counts = {name: w.launches for name, w in wrappers.items()}
        want = {k: sum(io_launches(cfg.n_layers, IO_STEPS, n)[k]
                       for n, _ in runs.values()) for k in wrappers}
        check(main_counts == want,
              f"trainer I/O launched {main_counts}, want {want} (counted "
              f"from the code)")
        print(f"(a) launches on the main path ({IO_STEPS} steps on one "
              f"device and {IO_STEPS} dp {IO_DP} fsdp steps through "
              f"train.main): {main_counts}")

        for label, (n, flags) in runs.items():
            out, d = outs[label], dirs[label]
            full = losses_of(out)
            check(sorted(full) == list(range(IO_STEPS)) and
                  all(np.isfinite(list(full.values()))),
                  f"{label}: losses {full}")
            check(all_steps(d) == list(range(IO_EVERY, IO_STEPS + 1,
                                             IO_EVERY)),
                  f"{label}: checkpoints {all_steps(d)}")
            saves = re.findall(r"^checkpoint step (\d+): ([\d.]+) ms on the "
                               r"step loop .*written in ([\d.]+) ms", out,
                               re.MULTILINE)
            check(len(saves) == IO_STEPS // IO_EVERY,
                  f"{label}: saves {saves}")
            ckpt_bytes = os.path.getsize(os.path.join(
                d, f"step_{IO_EVERY}", "arrays.npz"))

            # ---- (b) the tolerance: the run again, no checkpoints -------
            again = cli(["--corpus", corpus, "--steps", str(IO_STEPS),
                         *flags])
            tol = gap(losses_of(again), full)

            # ---- (c) stopped after step IO_EVERY's save, resumed --------
            shutil.rmtree(os.path.join(d, f"step_{IO_STEPS}"))
            resumed_out = cli(["--corpus", corpus, "--steps",
                               str(IO_STEPS - IO_EVERY), "--checkpoint-dir",
                               d, "--resume", "--seed", "1", *flags])
            resumed = losses_of(resumed_out)
            check(f"resumed from step {IO_EVERY}" in resumed_out and
                  sorted(resumed) == list(range(IO_EVERY, IO_STEPS)),
                  f"{label}: the resumed run {resumed}")
            r_gap = gap(resumed, full)
            check(r_gap <= tol, f"{label}: resumed losses {resumed} differ "
                                f"from the uninterrupted {full} by {r_gap} "
                                f"(tolerance {tol})")

            # ---- (d) the controls, the same restore through the library -
            mesh = None if n == 1 else RankMesh([dev] * n,
                                                ("dp", "sp", "tp"),
                                                (n, 1, 1))
            init_state, step = make_train_step(cfg, mesh=mesh,
                                               fsdp=n > 1)
            controls = {}
            for kind, start in (("fresh optimizer", IO_EVERY),
                                ("stream from step 0", 0)):
                state = init_state(torch.Generator().manual_seed(1), dev)
                restore_checkpoint(d, state, step=IO_EVERY)
                if kind == "fresh optimizer":
                    opt = state["opt"]
                    opt.load_state_dict({"state": {}, "param_groups":
                                         opt.state_dict()["param_groups"]})
                else:  # the restored state whole: its moments too
                    held = state_bytes(state)
                loader = iter(ShardedLoader(
                    from_token_file(corpus, BATCH, seq, dtype="uint16"),
                    mesh=mesh, start_step=start, device=dev))
                got = {}
                for i in range(IO_EVERY, IO_STEPS):
                    got[i] = float(step(state, next(loader))[1])
                loader.close()
                controls[kind] = gap(got, full)
                del state, loader
                torch.cuda.empty_cache()
            for kind, g in controls.items():
                check(g > tol, f"{label}: the control ({kind}) came within "
                               f"{g} of the uninterrupted losses "
                               f"(tolerance {tol})")
            # Every storage once: the file holds the state's bytes and the
            # npz and meta headers, no view written beside its base.
            check(held <= ckpt_bytes <= held + 2 ** 20,
                  f"{label}: checkpoint {ckpt_bytes} bytes for a state of "
                  f"{held}")
            print(f"{label}: losses {[full[i] for i in sorted(full)]}; two "
                  f"uninterrupted runs {'bitwise' if tol == 0 else 'apart'}"
                  f" (tolerance {tol!r}); resumed from step {IO_EVERY} in a "
                  f"state drawn from seed 1: "
                  f"{[resumed[i] for i in sorted(resumed)]}, gap {r_gap!r}; "
                  f"controls: fresh optimizer "
                  f"{controls['fresh optimizer']!r}, stream from step 0 "
                  f"{controls['stream from step 0']!r}")
            for at, loop_ms, write_ms in saves:
                print(f"{label}: checkpoint step {at}: {loop_ms} ms on the "
                      f"step loop (copy to the host), {write_ms} ms to write "
                      f"on the writer thread  [{card}]")
            print(f"{label}: checkpoint {ckpt_bytes} bytes against the "
                  f"state's {held} bytes (params, buffers and moments, each "
                  f"storage once); ms/step (CUDA events, each run's steps "
                  f"after its first) with "
                  f"checkpoints {ms_of(out)}, without {ms_of(again)}, "
                  f"resumed {ms_of(resumed_out)}  [{card}]")
            if n == 1:
                synth = cli(["--steps", str(IO_STEPS)])
                print(f"{label}: ms/step from the corpus {ms_of(again)} "
                      f"against the synthetic stream {ms_of(synth)} (steps "
                      f"1-{IO_STEPS - 1} of a run each)  [{card}]")
            shutil.rmtree(d)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- torch.sum at the tp and ep partials (PERF.md's row 6) ----------
    gen = torch.Generator(device=dev).manual_seed(19)
    sums = {}
    for shape in PARTIAL_SHAPES:
        x = torch.randn(*shape, generator=gen, device=dev)
        sums[shape] = kernel_ms(lambda c: torch.sum(c, 0), [(x,)], 10)
        print(f"torch.sum(contribs, 0) at {shape} float32: "
              f"{sums[shape] * 1e3!r} us  [{card}]")
        del x
    torch.cuda.empty_cache()
    print(f"phase 19 took {time.perf_counter() - t_phase!r} s")
    return main_counts, sums


def decode_times(dev, gen, card, cfg):
    """Kernel 4 at the flagship decode shape (n_valid 0, 128 and 255) and
    at a long cache of the same widths (t 8192, n_valid 8191): kernel,
    plain version and SDPA times (ms) and the bound. Returns {n_valid:
    row} for the flagship shape."""
    import torch
    import torch.nn.functional as F

    from mpi_tpu_torch.ops.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain, kernel_splits)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b, h, kv, hd, dtype = BATCH, cfg.n_heads, cfg.kv_heads, cfg.head_dim, \
        cfg.dtype
    rows = {}
    # The flagship's decode shape: twelve sets of inputs (96 MB) cycle so
    # each launch finds its K/V outside the 50 MB L2, as a decode step
    # does after streaming the layer's weights. At t 8192 one set (537 MB)
    # is past the L2 on its own. n_valid 0 (one live key) shows the fixed
    # cost of a launch.
    for t, n_sets, points in ((cfg.max_seq, 12, (0, PROMPT_LEN,
                                                 cfg.max_seq - 1)),
                              (8192, 1, (8191,))):
        sets = [(torch.randn(b, h, hd, generator=gen, device=dev).to(dtype),
                 torch.randn(b, t, kv, hd, generator=gen,
                             device=dev).to(dtype),
                 torch.randn(b, t, kv, hd, generator=gen,
                             device=dev).to(dtype))
                for _ in range(n_sets)]
        elt = sets[0][0].element_size()
        splits = kernel_splits(b, kv, h, t, hd, dtype, sms)
        reps = 240 if t < 8192 else 60
        for n_valid in points:
            n_live = n_valid + 1
            ms = kernel_ms(lambda q, k, v: flash_decode_attention(q, k, v,
                                                                  n_valid),
                           sets, reps)
            plain_ms = kernel_ms(
                lambda q, k, v: flash_decode_attention_plain(q, k, v,
                                                             n_valid),
                sets, 16 if t < 8192 else 4)
            sdpa_ms = kernel_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q[:, :, None], k[:, :n_live].transpose(1, 2),
                    v[:, :n_live].transpose(1, 2), enable_gqa=kv != h),
                sets, reps // 4)
            kv_bytes = 2 * b * n_live * kv * hd * elt
            bound_ms, bound_by = bound(kv_bytes + 2 * b * h * hd * elt +
                                       4 * b * h, 4 * b * h * n_live * hd,
                                       dtype)
            if t == cfg.max_seq:
                rows[n_valid] = dict(ms=ms, plain_ms=plain_ms,
                                     library_ms=sdpa_ms, bound_ms=bound_ms,
                                     bound_by=bound_by)
            print(f"decode kernel b={b} h={h} kv={kv} hd={hd} t={t} {dtype} "
                  f"n_valid={n_valid}: {splits} splits, {b * kv * splits} "
                  f"blocks; kernel {ms * 1e3!r} us, plain "
                  f"{plain_ms * 1e3!r} us, sdpa {sdpa_ms * 1e3!r} us; bound "
                  f"{bound_ms * 1e3!r} us by {bound_by} (live K+V "
                  f"{kv_bytes} B / {HBM_BYTES_PER_S:.3g} B/s = "
                  f"{kv_bytes / HBM_BYTES_PER_S * 1e6!r} us), "
                  f"{bound_ms / ms!r} of the bound  [{card}]")
        del sets
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    from mpi_tpu_torch.models import (generate, init_params,
                                      quantize_params)
    from mpi_tpu_torch.models.generate import decode_step, prefill
    from mpi_tpu_torch.ops import _build
    from mpi_tpu_torch.ops.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain, kernel_splits,
        kernel_tile)
    from mpi_tpu_torch.serve import flagship_config
    from mpi_tpu_torch.train import (flagship_train_config, peak_bf16_tflops,
                                     train_flops_per_step)
    from mpi_tpu_torch.utils.platform import resolve_device

    # ---- 1. device and build ------------------------------------------
    dev = resolve_device()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    for name in ("decode_attention", "flash_attention", "ring_collectives",
                 "sendrecv"):
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "Performance Loss")):
                print(f"  ptxas {name}: {line.strip()}")
    hgmma = sass_counts(_build.library_path("flash_attention"), "HGMMA")
    report = ptxas_report(_build.build_log("flash_attention"))
    for kernel in WGMMA_KERNELS:
        counts = named(hgmma, kernel)
        check(len(counts) == 2 and all(counts.values()),
              f"{kernel}: HGMMA per instantiation {counts}; want some in "
              f"each of d = 64 and 128")
        regs = named(report, kernel)
        check(len(regs) == 2, f"{kernel}: no ptxas report ({regs})")
        if kernel != "flash_fwd_wgmma_kernel":
            check(all(st == ld == 0 for _, st, ld in regs.values()),
                  f"{kernel} spills: {regs}")
        print(f"{kernel}: HGMMA {sorted(counts.values())}, ptxas "
              f"(registers, spill store / load bytes) "
              f"{sorted(regs.values())} for d = 64 and 128")

    # ---- 2. kernels against plain -------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = [  # (b, h, kv, hd, t)
        (8, 8, 8, 128, 256),   # flagship MHA
        (8, 8, 2, 128, 256),   # GQA
        (8, 8, 1, 128, 256),   # MQA
        (8, 8, 8, 128, 200),   # t not a multiple of the load unit
        (2, 16, 1, 64, 200),   # group 16: two row chunks per kv head
        (8, 8, 8, 128, 4096),  # flagship widths, long cache: 2 splits
        (1, 8, 2, 128, 4096),  # few clusters: 8 splits
    ]
    max_err = 0.0
    n_cmp = 0
    for b, h, kv, hd, t in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            tol = KERNEL_TOL[str(dtype)]
            q = torch.randn(b, h, hd, generator=gen, device=dev).to(dtype)
            k = torch.randn(b, t, kv, hd, generator=gen,
                            device=dev).to(dtype)
            v = torch.randn(b, t, kv, hd, generator=gen,
                            device=dev).to(dtype)
            unit = kernel_tile(dtype, hd)
            splits = kernel_splits(b, kv, h, t, hd, dtype, sms)
            edges = [r * t // splits for r in range(1, splits)]
            cases = sorted(n for n in {-1, 0, unit - 1, unit, t - 1, *edges,
                                       *(e - 1 for e in edges)} if n < t)
            for n_valid in cases:
                out, lse = flash_decode_attention(q, k, v, n_valid,
                                                  with_lse=True)
                # The same call with n_valid in device memory: the same
                # bits (every output is written once, in a fixed order).
                out2, lse2 = flash_decode_attention(
                    q, k, v, torch.tensor(n_valid, dtype=torch.int32,
                                          device=dev), with_lse=True)
                ref, ref_lse = flash_decode_attention_plain(q, k, v,
                                                            n_valid)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                where = (f"b={b} h={h} kv={kv} hd={hd} t={t} {splits} "
                         f"splits {dtype} n_valid={n_valid}")
                check(out.dtype == dtype and out.shape == q.shape,
                      f"kernel output {out.dtype} {tuple(out.shape)} at "
                      f"{where}")
                check(bits_equal(out, out2) and bits_equal(lse, lse2),
                      f"device n_valid gave other bits at {where}")
                check(torch.allclose(out.float(), ref.float(),
                                     atol=tol["out"][0], rtol=tol["out"][1]),
                      f"kernel out differs from plain by {err} at {where}")
                check(torch.allclose(lse, ref_lse, atol=tol["lse"][0],
                                     rtol=tol["lse"][1]),
                      f"kernel lse differs from plain by {lse_err} at "
                      f"{where}")
                if n_valid < 0:
                    check(bool((out == 0).all()) and
                          bool((lse < -1e29).all()),
                          f"empty live prefix not zero/-1e30 at {where}")
                max_err = max(max_err, err)
                n_cmp += 1
    print(f"decode kernel vs plain: {n_cmp} cases pass (n_valid at the "
          f"load unit's and every split's edges; each repeated with n_valid "
          f"in device memory, bitwise equal), max |out err| {max_err!r} "
          f"(tolerances {KERNEL_TOL})")
    flash_err, flash_shape_err = check_flash_kernels(dev, gen)
    ring_err = check_ring_kernels(dev, gen)

    # ---- 3. serving: the flagship through generate ---------------------
    cfg = flagship_config()
    steps = NEW_TOKENS - 1  # the first new token comes from the prefill
    hgen = torch.Generator().manual_seed(0)
    params = init_params(cfg, hgen)           # on the CUDA device
    prompts = [torch.randint(0, cfg.vocab, (BATCH, PROMPT_LEN),
                             generator=hgen) for _ in range(N_REQUESTS)]
    flash_decode_attention.launches = 0
    outs = []
    for i, prompt in enumerate(prompts):
        before = flash_decode_attention.launches
        toks = generate(params, prompt, cfg, NEW_TOKENS)
        torch.cuda.synchronize()
        got = flash_decode_attention.launches - before
        check(got == cfg.n_layers * steps,
              f"request {i}: decode kernel launched {got} times, want "
              f"{cfg.n_layers} layers x {steps} steps")
        check(tuple(toks.shape) == (BATCH, NEW_TOKENS) and
              toks.device.type == "cuda",
              f"request {i}: tokens {tuple(toks.shape)} on {toks.device}")
        check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"request {i}: tokens outside the vocab")
        outs.append(toks)
    main_launches = flash_decode_attention.launches
    print(f"served {N_REQUESTS} requests of {BATCH}x{PROMPT_LEN} prompt + "
          f"{NEW_TOKENS} new tokens; decode kernel launches "
          f"{main_launches} = {N_REQUESTS} x {cfg.n_layers} x {steps}")

    # Teacher-forced float32: the same tokens through decode_step with the
    # kernel and with the dense path, logits compared at every step.
    cfg_f = flagship_config(dtype=torch.float32)
    cfg_d = flagship_config(dtype=torch.float32, decode_attention="dense")
    params32 = init_params(cfg_f, torch.Generator().manual_seed(0))
    seq = torch.cat([prompts[0].to(dev), outs[0]], dim=1)
    _, cache_f = prefill(params32, seq[:, :PROMPT_LEN], cfg_f)
    _, cache_d = prefill(params32, seq[:, :PROMPT_LEN], cfg_d)
    worst, agree, n_tok = 0.0, 0, 0
    with torch.no_grad():
        for n_valid in range(PROMPT_LEN, PROMPT_LEN + steps):
            tok = seq[:, n_valid]
            lf, cache_f = decode_step(params32, tok, cache_f, n_valid, cfg_f)
            ld, cache_d = decode_step(params32, tok, cache_d, n_valid, cfg_d)
            check(bool(torch.isfinite(lf).all()),
                  f"non-finite logits at n_valid={n_valid}")
            check(torch.allclose(lf, ld, atol=SLICE_LOGITS_ATOL,
                                 rtol=SLICE_LOGITS_RTOL),
                  f"flash vs dense logits differ by "
                  f"{(lf - ld).abs().max().item()} at n_valid={n_valid}")
            worst = max(worst, (lf - ld).abs().max().item())
            agree += int((lf.argmax(-1) == ld.argmax(-1)).sum())
            n_tok += lf.shape[0]
    print(f"teacher-forced float32 flash vs dense over {steps} steps: max "
          f"|logit diff| {worst!r} (atol {SLICE_LOGITS_ATOL}, rtol "
          f"{SLICE_LOGITS_RTOL}); greedy-token agreement {agree / n_tok!r}")
    del params32, cache_f, cache_d

    qparams = quantize_params(params)
    qtoks = generate(qparams, prompts[0], cfg, NEW_TOKENS)
    torch.cuda.synchronize()
    check(tuple(qtoks.shape) == (BATCH, NEW_TOKENS) and
          bool(((qtoks >= 0) & (qtoks < cfg.vocab)).all()),
          "int8 tokens outside the vocab or of the wrong shape")
    print(f"int8 weights: tokens in vocab; agreement with bf16 greedy "
          f"{float((qtoks == outs[0]).float().mean())!r}")

    # ---- 4. training: the flagship through make_train_step ------------
    train_launches, step_ms = train_slice(dev)
    flash_vs_dense(dev)
    torch.cuda.empty_cache()

    # ---- 5. times -------------------------------------------------------
    tcfg = flagship_train_config()
    train_tok = 8 * 1024
    tflops = train_flops_per_step(tcfg, 8, 1024) / step_ms / 1e9
    peak = peak_bf16_tflops(torch.cuda.get_device_name(0))
    mfu = None if peak is None else tflops / peak
    print(f"train step bf16, flash kernels: {step_ms!r} ms per step (CUDA "
          f"events over {TRAIN_STEPS - 1} steps after a warm-up), "
          f"{train_tok / step_ms * 1e3!r} tokens/s, {tflops!r} model TFLOP/s, "
          f"MFU {mfu!r} against {peak} TFLOP/s dense bf16  [{card}]")
    train_profile(dev, card, step_ms)
    torch.cuda.empty_cache()

    def gen_ms(p, c, reps=3):
        generate(p, prompts[1], c, NEW_TOKENS)  # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            generate(p, prompts[1], c, NEW_TOKENS)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    n_gen = BATCH * NEW_TOKENS
    for label, p, c in (
            ("generate bf16, flash-decode kernel", params, cfg),
            ("generate bf16, dense decode", params,
             flagship_config(decode_attention="dense")),
            ("generate int8 weights, flash-decode kernel", qparams, cfg)):
        ms = gen_ms(p, c)
        print(f"{label}: {ms!r} ms per request, {ms / NEW_TOKENS!r} ms per "
              f"generated token, {n_gen / ms * 1e3!r} tok/s  [{card}]")
    del qparams, params

    rows = decode_times(dev, gen, card, cfg)
    flash_rows = flash_times(dev, gen, card)
    torch.cuda.empty_cache()

    # ---- 6. the device collective layer: 8 ranks on the card -----------
    ring_launches, ring_rows, slice_err = ring_slice(dev, card)
    print(f"collective layer launches (phase 6): {ring_launches}")
    torch.cuda.empty_cache()

    # ---- 7. the device MPI driver: rank threads on the card ------------
    driver_launches = driver_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 8. long context: sp ranks on the card --------------------------
    long_launches, _ = long_context_slice(dev, gen, card)
    torch.cuda.empty_cache()

    # ---- 9. data-parallel training: dp ranks on the card -----------------
    sharded_launches, dp_err, one = dp_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 10. tensor-parallel training: tp ranks on the card ---------------
    tp_counts, tp_err = tp_slice(dev, card, one)
    torch.cuda.empty_cache()

    # ---- 11. pipeline-parallel training: pp ranks on the card ----------
    pp_counts = pp_slice(dev, card, one)
    del one
    torch.cuda.empty_cache()

    # ---- 12. compiled halos: the ranks of a grid on the card -----------
    halo_counts, halo_err = halo_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 13. Mixture of Experts: served, trained, expert-parallel -------
    moe_counts = moe_slice(dev, card, step_ms)
    torch.cuda.empty_cache()

    # ---- 14. speculative decoding: prompt lookup, dense verify ----------
    spec_counts = spec_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 15. LoRA: adapter-only steps, the merged tree served ----------
    lora_counts = lora_slice(dev, card, step_ms)
    torch.cuda.empty_cache()

    # ---- 16. the Vision Transformer: classified, trained, on a mesh -----
    vit_counts = vit_slice(dev, card, flash_shape_err[VIT_FLASH_SHAPE])
    torch.cuda.empty_cache()

    # ---- 17. the state-space LM: served, sequence-parallel --------------
    ssm_counts, ssm_err = ssm_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 18. the state-space LM trained: one device and dp ranks -------
    ssm_train_counts, ssm_train_err = ssm_train_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 19. the trainer's I/O: corpus, checkpoints, resume -----------
    io_counts, _ = io_slice(dev, card)
    torch.cuda.empty_cache()

    # ---- 20. result -----------------------------------------------------
    source = "mpi_tpu_torch/ops/csrc/flash_attention.cu"
    kernels = []
    for name, replaces, n in zip(
            ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
            ("mpi_tpu/ops/attention.py:174", "mpi_tpu/ops/attention.py:231",
             "mpi_tpu/ops/attention.py:270"), train_launches):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": n,
                        "max_abs_err": flash_err[name], **flash_rows[name]})
    kernels.append({
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "mpi_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "mpi_tpu/ops/decode_attention.py:58",
        "launches": main_launches,
        "max_abs_err": max_err,
        **rows[cfg.max_seq - 1],
    })
    for name, source, replaces in (
            ("ring_allgather", "mpi_tpu_torch/ops/csrc/ring_collectives.cu",
             "mpi_tpu/ops/ring_collectives.py:65"),
            ("ring_allreduce", "mpi_tpu_torch/ops/csrc/ring_collectives.cu",
             "mpi_tpu/ops/ring_collectives.py:111"),
            ("sendrecv", "mpi_tpu_torch/ops/csrc/sendrecv.cu",
             "mpi_tpu/parallel/p2p.py:158")):
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": driver_launches[name],
                        "max_abs_err": max(ring_err[name], slice_err[name],
                                           dp_err.get(name, 0.0),
                                           tp_err.get(name, 0.0),
                                           max(halo_err, ssm_err)
                                           if name == "sendrecv" else 0.0,
                                           ssm_train_err
                                           if name == "ring_allreduce"
                                           else 0.0),
                        **ring_rows[name]})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{**{key: row[key] for key in keys},
                **({"long_context_launches": long_launches[row["name"]]}
                   if row["name"] in long_launches else {}),
                "sharded_launches": sharded_launches.get(row["name"], 0),
                "tp_launches": tp_counts.get(row["name"], 0),
                "pipeline_launches": pp_counts.get(row["name"], 0),
                "halo_launches": halo_counts.get(row["name"], 0),
                "moe_launches": moe_counts.get(row["name"], 0),
                "speculative_launches": spec_counts[row["name"]],
                "lora_launches": lora_counts[row["name"]],
                "vit_launches": vit_counts[row["name"]],
                "ssm_launches": ssm_counts[row["name"]],
                "ssm_train_launches": ssm_train_counts[row["name"]],
                "io_launches": io_counts[row["name"]]}
               for row in kernels]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
