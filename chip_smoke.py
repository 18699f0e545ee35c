#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mpi_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the
port's four paths and checks what comes out:

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

then times the paths and the kernels, and prints:

* a ``{"kernels": [...]}`` line: for each kernel its route, source, the TPU
  kernel it replaces, its launches on its path (kernels 5-7: in the
  driver's phase), its largest error against the plain version, and its
  time beside its bound, the plain version's time and one PyTorch library
  call's time;
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


def check_flash_kernels(dev, gen):
    """Kernels 1-3 against their plain versions on the card. Returns the
    largest |kernel - plain| of each kernel over every case."""
    import torch

    from mpi_tpu_torch.ops.attention import (_delta,
                                             flash_attention_bwd_plain,
                                             flash_attention_fwd_plain,
                                             flash_bwd_dq_delta,
                                             flash_chunk_bwd, flash_fwd)

    shapes = [  # (b, s, t, h, hk, d, causal)
        (8, 1024, 1024, 8, 8, 128, True),   # flagship
        (8, 1024, 1024, 8, 2, 128, True),   # GQA, kv 2
        (8, 1024, 1024, 8, 1, 128, True),   # MQA, kv 1
        (8, 1024, 1024, 8, 8, 128, False),  # non-causal
        (4, 1000, 1000, 8, 8, 128, True),   # no multiple of any tile
        (4, 512, 512, 16, 4, 64, True),     # head_dim 64
        (4, 512, 768, 8, 2, 128, False),    # s != t: a ring chunk
        (8193, 64, 64, 8, 8, 64, True),     # b * h = 65544 > grid y's 65535
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    worst_delta = 0.0
    n_cmp = 0
    for b, s, t, h, hk, d, causal in shapes:
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
            n_cmp += 1
            del q, g, k, v, out, lse, ref, ref_lse, got, want, dq2, delta
    print(f"flash kernels vs plain: {n_cmp} cases (out, lse, dq, dk, dv, "
          f"delta each; dq bitwise equal over two calls) pass; max |err| "
          f"{worst}, delta {worst_delta!r} (tolerances {FLASH_TOL}, delta "
          f"{DELTA_TOL})")
    return worst


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


def train_profile(dev, card, step_ms):
    """Where a flagship training step's device time goes: torch.profiler
    over two steps after a warm-up, device time by kernel and by group.
    The profiler slows the host, so the busy share is also given against
    ``step_ms``, the step's time measured without it."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpi_tpu_torch.models import make_train_step
    from mpi_tpu_torch.train import flagship_train_config

    cfg = flagship_train_config()
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (8, cfg.max_seq))).to(dev)
    init_state, step = make_train_step(cfg)
    state = init_state(torch.Generator().manual_seed(0))
    step(state, tokens)
    torch.cuda.synchronize()
    n = 2
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(n):
            step(state, tokens)
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
    busy = sum(ms for ms, _, _ in kernels)
    if not kernels:
        print("train step profile: the profiler saw no device time; "
              "breakdown not measured")
        return

    def group(name):
        low = name.lower()
        if "flash_" in low:
            return "flash attention kernels 1-3"
        if any(w in low for w in ("gemm", "xmma", "cutlass", "cublas",
                                  "nvjet")):
            return "matrix products (cuBLAS)"
        if "multi_tensor_apply" in low:
            return "AdamW (foreach)"
        return "elementwise, reductions, copies"

    groups = {}
    for ms, count, name in kernels:
        g = groups.setdefault(group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += count
    print(f"train step profile (torch.profiler, {n} steps after a warm-up; "
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


def flash_vs_dense(dev):
    """One float32 forward and backward at flagship width and depth from
    one seeded state, with flash attention and with dense attention: the
    loss and every gradient must agree."""
    import numpy as np
    import torch

    from mpi_tpu_torch.models import init_params, loss_fn
    from mpi_tpu_torch.models.transformer import _leaves
    from mpi_tpu_torch.train import flagship_train_config

    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 8192, (8, 1025))).to(dev)
    results = []
    for impl in ("flash", "dense"):
        cfg = flagship_train_config(dtype=torch.float32,
                                    attention_impl=impl)
        params = init_params(cfg, torch.Generator().manual_seed(0))
        leaves = _leaves(params)
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


def flash_times(dev, gen, card):
    """Each flash kernel at the flagship training shape: kernel, plain
    version and SDPA times (ms) and the bound; then the whole bf16
    backward (kernel 2 with delta, then kernel 3) against SDPA's backward
    at the flagship shape and at one sequence of 8192."""
    import torch
    import torch.nn.functional as F

    from mpi_tpu_torch.ops.attention import (_bwd_plain, _delta,
                                             flash_attention_fwd_plain,
                                             flash_bwd_dkv, flash_bwd_dq,
                                             flash_bwd_dq_delta,
                                             flash_chunk_bwd, flash_fwd)

    b, s, h, d, dtype = 8, 1024, 8, 128, torch.bfloat16
    # Two sets of inputs (2 x 103 MB, over the 50 MB L2) alternate, so each
    # launch reads its inputs from device memory, as a training step does.
    sets = []
    for _ in range(2):
        q, k, v, g = (torch.randn(b, s, h, d, generator=gen,
                                  device=dev).to(dtype) for _ in range(4))
        out, lse = flash_fwd(q, k, v, True)
        sets.append((q, k, v, g, lse, _delta(out, g), out))
    work = flash_work(b, s, s, h, h, d, 2, True)
    # Kernel 2 as the main path calls it, computing delta from out; its
    # plain version is the plain backward and the plain delta.
    fns = {
        "flash_fwd": (lambda q, k, v, g, lse, dl, o:
                      flash_fwd(q, k, v, True),
                      lambda q, k, v, g, lse, dl, o:
                      flash_attention_fwd_plain(q, k, v, True)),
        "flash_bwd_dq": (lambda q, k, v, g, lse, dl, o:
                         flash_bwd_dq_delta(q, k, v, g, lse, o, True),
                         lambda q, k, v, g, lse, dl, o:
                         _bwd_plain(q, k, v, g, lse, _delta(o, g), True)),
        "flash_bwd_dkv": (lambda q, k, v, g, lse, dl, o:
                          flash_bwd_dkv(q, k, v, g, lse, dl, True),
                          lambda q, k, v, g, lse, dl, o:
                          _bwd_plain(q, k, v, g, lse, dl, True)),
    }

    # SDPA, the yardstick: forward, and its backward alone (one autograd
    # call that computes dq, dk and dv together).
    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True)

    def sdpa_bwd_ms(sets, reps):
        graphs = []
        for q, k, v, g, *_ in sets:
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            graphs.append((sdpa(*leaves), leaves, g.transpose(1, 2)))
        return kernel_ms(
            lambda o, leaves, g: torch.autograd.grad(o, leaves, g,
                                                     retain_graph=True),
            graphs, reps)

    def backward_ms(sets, reps):
        return kernel_ms(lambda q, k, v, g, lse, dl, o:
                         flash_chunk_bwd(q, k, v, o, lse, g, True), sets,
                         reps)

    sdpa_fwd_ms = kernel_ms(lambda q, k, v, *_: sdpa(q, k, v), sets, 50)
    sdpa_bwd = sdpa_bwd_ms(sets, 50)
    rows = {}
    for name, (fn, plain) in fns.items():
        ms = kernel_ms(fn, sets, 50)
        plain_ms = kernel_ms(plain, sets, 4)
        bound_ms, bound_by = bound(*work[name], dtype)
        lib = sdpa_fwd_ms if name == "flash_fwd" else sdpa_bwd
        rows[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=lib)
        n_bytes, n_ops = work[name]
        print(f"{name} b={b} s={s} h={h} d={d} {dtype} causal: kernel "
              f"{ms * 1e3!r} us, plain {plain_ms * 1e3!r} us, sdpa "
              f"{'forward' if name == 'flash_fwd' else 'backward (dq, dk, dv)'}"
              f" {lib * 1e3!r} us; bound {bound_ms * 1e3!r} us by "
              f"{bound_by} ({n_ops} operations, {n_bytes} bytes); "
              f"{n_ops / ms / 1e9!r} TFLOP/s  [{card}]")

    given_ms = kernel_ms(lambda q, k, v, g, lse, dl, o:
                         flash_bwd_dq(q, k, v, g, lse, dl, True), sets, 50)
    print(f"flash_bwd_dq with delta given (no out read, no delta write): "
          f"kernel {given_ms * 1e3!r} us  [{card}]")

    def report_backward(label, sets, n_sdpa, work):
        ms = backward_ms(sets, 50)
        n_bytes = work["flash_bwd_dq"][0] + work["flash_bwd_dkv"][0]
        n_ops = work["flash_bwd_dq"][1] + work["flash_bwd_dkv"][1]
        bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
        print(f"flash backward (kernel 2 with delta, then kernel 3) "
              f"{label} {dtype} causal: {ms * 1e3!r} us, sdpa backward "
              f"(dq, dk, dv) {n_sdpa * 1e3!r} us, ratio {ms / n_sdpa!r}; "
              f"bound {bound_ms * 1e3!r} us by {bound_by}; "
              f"{n_ops / ms / 1e9!r} TFLOP/s over 7 products  [{card}]")

    report_backward(f"b={b} s={s} h={h} d={d}", sets, sdpa_bwd, work)
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
    long_sdpa = kernel_ms(lambda q, k, v, *_: sdpa(q, k, v), sets, 20)
    long_work = flash_work(1, 8192, 8192, h, h, d, 2, True)
    n_ops = long_work["flash_fwd"][1]
    print(f"flash_fwd b=1 s=8192 h={h} d={d} {dtype} causal: kernel "
          f"{long_ms * 1e3!r} us, sdpa forward {long_sdpa * 1e3!r} us; "
          f"{n_ops / long_ms / 1e9!r} TFLOP/s  [{card}]")
    report_backward(f"b=1 s=8192 h={h} d={d}", sets, sdpa_bwd_ms(sets, 20),
                    long_work)
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
    from mpi_tpu_torch.models.transformer import _leaves
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
    leaves = _leaves(init_params(flagship_train_config(), gen, dev))
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
    from mpi_tpu_torch.models.transformer import _leaves
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
    leaves = _leaves(init_params(flagship_train_config(), gen, dev))
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
    flash_err = check_flash_kernels(dev, gen)
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

    # ---- 8. result ------------------------------------------------------
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
                        "max_abs_err": max(ring_err[name], slice_err[name]),
                        **ring_rows[name]})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{key: row[key] for key in keys} for row in kernels]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
