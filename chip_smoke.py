#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``mpi_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version on the card, serves the
flagship decoder LM through ``generate`` (the port's main path) and checks
what comes out, times the path and the kernels, and prints:

* a ``{"kernels": [...]}`` line: for each kernel of the path its route,
  source, the TPU kernel it replaces, its launches on the main path, its
  largest error against the plain version, and its time beside its bound,
  the plain version's time and one PyTorch library call's time;
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

# Kernel against plain version. float32: summation order only. bfloat16:
# p is rounded to bf16 at each tile's running max in the kernel and at the
# global max in the plain version, and the output is rounded to bf16 (one
# ulp is 2**-8 relative), so out gets a bf16-sized tolerance; lse is
# float32 in both and differs by summation order.
KERNEL_TOL = {
    "torch.float32": {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5)},
    "torch.bfloat16": {"out": (2e-2, 1e-2), "lse": (1e-3, 1e-5)},
}
# Teacher-forced decode, flash against dense, float32 logits after 8
# layers: both are float32 end to end and differ by summation order.
SLICE_LOGITS_ATOL = 1e-3
SLICE_LOGITS_RTOL = 1e-3

# About 100 ms of GPU clock cycles: longer than the host takes to enqueue
# one timed run of launches (checked: the run fails if it is not). Each
# timed run stays under ~1000 launches, CUDA's queue of pending launches,
# past which the host would wait for the sleeping stream.
SLEEP_CYCLES = 200_000_000

N_REQUESTS = 3
BATCH = 8
PROMPT_LEN = 128
NEW_TOKENS = 128


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    import torch.nn.functional as F

    from mpi_tpu_torch.models import (generate, init_params,
                                      quantize_params)
    from mpi_tpu_torch.models.generate import decode_step, prefill
    from mpi_tpu_torch.ops import _build
    from mpi_tpu_torch.ops.decode_attention import (
        flash_decode_attention, flash_decode_attention_plain, kernel_tile)
    from mpi_tpu_torch.serve import flagship_config
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
    for line in _build.build_log("decode_attention").splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- 2. kernel against plain --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(1234)
    shapes = [  # (b, h, kv, hd, t)
        (8, 8, 8, 128, 256),   # flagship MHA
        (8, 8, 2, 128, 256),   # GQA
        (8, 8, 1, 128, 256),   # MQA
        (8, 8, 8, 128, 200),   # t not a multiple of the tile
        (2, 16, 1, 64, 200),   # group 16: two row chunks per kv head
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
            tile = kernel_tile(dtype, hd)
            for n_valid in (-1, 0, tile - 1, tile, t - 1):
                out, lse = flash_decode_attention(q, k, v, n_valid,
                                                  with_lse=True)
                ref, ref_lse = flash_decode_attention_plain(q, k, v,
                                                            n_valid)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                where = (f"b={b} h={h} kv={kv} hd={hd} t={t} "
                         f"{dtype} n_valid={n_valid}")
                check(out.dtype == dtype and out.shape == q.shape,
                      f"kernel output {out.dtype} {tuple(out.shape)} at "
                      f"{where}")
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
    print(f"kernel vs plain: {n_cmp} cases pass, max |out err| {max_err!r} "
          f"(tolerances {KERNEL_TOL})")

    # ---- 3. the slice: serve the flagship through generate -------------
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

    # ---- 4. times -------------------------------------------------------
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
    del qparams

    def kernel_ms(fn, sets, reps):
        for args in sets[:2]:
            fn(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # Hold the stream busy while the host enqueues the launches, so
        # the events time the launches back to back on the card and not
        # the Python that issues them.
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

    # The flagship's decode shape. Twelve sets of inputs (96 MB) cycle so
    # each launch finds its K/V outside the 50 MB L2, as a decode step
    # does after streaming the layer's weights.
    b, h, kv, hd, t = BATCH, cfg.n_heads, cfg.kv_heads, cfg.head_dim, \
        cfg.max_seq
    dtype = cfg.dtype
    sets = [(torch.randn(b, h, hd, generator=gen, device=dev).to(dtype),
             torch.randn(b, t, kv, hd, generator=gen, device=dev).to(dtype),
             torch.randn(b, t, kv, hd, generator=gen, device=dev).to(dtype))
            for _ in range(12)]
    elt = sets[0][0].element_size()
    rows = {}
    # n_valid 0 (one live key) shows the fixed cost of a launch.
    for n_valid in (0, PROMPT_LEN, t - 1):
        n_live = n_valid + 1
        ms = kernel_ms(lambda q, k, v: flash_decode_attention(q, k, v,
                                                              n_valid),
                       sets, 240)
        plain_ms = kernel_ms(
            lambda q, k, v: flash_decode_attention_plain(q, k, v, n_valid),
            sets, 16)
        sdpa_ms = kernel_ms(
            lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k[:, :n_live].transpose(1, 2),
                v[:, :n_live].transpose(1, 2), enable_gqa=kv != h),
            sets, 64)
        kv_bytes = 2 * b * n_live * kv * hd * elt
        n_bytes = kv_bytes + 2 * b * h * hd * elt + 4 * b * h
        n_ops = 4 * b * h * n_live * hd
        t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        t_ops = n_ops / PEAK_FLOPS[str(dtype)] * 1e3
        rows[n_valid] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                             bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations")
        print(f"decode kernel b={b} h={h} kv={kv} hd={hd} t={t} {dtype} "
              f"n_valid={n_valid}: kernel {ms * 1e3!r} us, plain "
              f"{plain_ms * 1e3!r} us, sdpa {sdpa_ms * 1e3!r} us; bound "
              f"{rows[n_valid]['bound_ms'] * 1e3!r} us by "
              f"{rows[n_valid]['bound_by']} (live K+V {kv_bytes} B / "
              f"{HBM_BYTES_PER_S:.3g} B/s = "
              f"{kv_bytes / HBM_BYTES_PER_S * 1e6!r} us)  [{card}]")

    # ---- 5. result ------------------------------------------------------
    r = rows[t - 1]
    kernels = [{
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "mpi_tpu_torch/ops/csrc/decode_attention.cu",
        "replaces": "mpi_tpu/ops/decode_attention.py:58",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": r["library_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
