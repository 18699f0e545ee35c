"""Train the flagship decoder LM for a few AdamW steps on the GPU.

The port's counterpart of the single-device path of ``examples/train.py``,
at the configuration of ``bench.py``'s ``measure_train_step``: d_model
1024, 8 layers, 8 heads of 128, d_ff 4096, vocab 8192, batch 8, seq 1024,
bf16 compute over float32 master weights, attention in the flash kernels
(forward and FA-2 backward), AdamW at lr 1e-3. Weights are random, drawn
from ``--seed``, and every step trains on one fixed batch of random tokens.
Prints the loss of each step, then the time per step after a warm-up step
(CUDA events), tokens per second, model TFLOP/s and MFU against the card's
dense bf16 peak.

Run::

    python -m mpi_tpu_torch.train                 # on the CUDA device
    python -m mpi_tpu_torch.train --layers 2 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from .models import TransformerConfig, make_train_step
from .utils.platform import resolve_device

__all__ = ["flagship_train_config", "train_flops_per_step",
           "peak_bf16_tflops", "main"]

# Dense bf16 peaks (NVIDIA's data sheets, no sparsity), keyed by
# torch.cuda.get_device_name.
_PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 PCIe", 756.0))


def flagship_train_config(n_layers: int = 8, seq: int = 1024,
                          dtype: torch.dtype = torch.bfloat16,
                          attention_impl: str = "flash",
                          remat: bool = False) -> TransformerConfig:
    """``bench.py``'s ``measure_train_step`` configuration: bf16 compute,
    float32 masters cast at each use, a learned position table of
    ``seq + 1`` rows."""
    return TransformerConfig(
        vocab=8192, d_model=1024, n_heads=8, n_layers=n_layers, d_ff=4096,
        max_seq=seq + 1, dtype=dtype, param_dtype=torch.float32,
        attention_impl=attention_impl, remat=remat)


def train_flops_per_step(cfg: TransformerConfig, batch: int,
                         seq: int) -> float:
    """Model FLOPs of one optimizer step, ``bench.py``'s count: the matrix
    products of the forward (projections, FFN, attention at half the full
    s² for the causal mask, logits) times 3 for forward and backward.
    Rematerialisation's recompute is not model work and is not counted."""
    b, s = batch, seq
    d, ff, n, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    qkvo = 8 * b * s * d * d
    ffn = 4 * b * s * d * ff
    attn = 2 * b * s * s * d
    return 3.0 * (n * (qkvo + ffn + attn) + 2 * b * s * d * v)


def peak_bf16_tflops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in TFLOP/s, or None for a card the table
    does not know: then there is no honest MFU."""
    for key, tflops in _PEAK_BF16_TFLOPS:
        if key in device_name:
            return tflops
    return None


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--attention", choices=("flash", "dense"),
                    default="flash")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2: one warm-up, one timed")

    dev = resolve_device(args.device)
    cfg = flagship_train_config(args.layers, args.seq,
                                attention_impl=args.attention,
                                remat=args.remat)
    init_state, step = make_train_step(cfg, grad_accum=args.grad_accum)
    state = init_state(torch.Generator().manual_seed(args.seed), dev)
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.seq + 1))).to(dev)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"flagship train on {name}: batch={args.batch} seq={args.seq} "
          f"layers={args.layers} attention={args.attention} "
          f"remat={args.remat} grad_accum={args.grad_accum}")

    _, loss = step(state, tokens)  # warm-up
    print(f"step 0 loss {float(loss):.6f} (warm-up)")
    losses = []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        losses.append(step(state, tokens)[1])
    if cuda:
        end.record()
        torch.cuda.synchronize(dev)
        ms = start.elapsed_time(end) / len(losses)
    else:
        ms = (time.perf_counter() - t0) * 1e3 / len(losses)
    for i, loss in enumerate(losses, 1):
        print(f"step {i} loss {float(loss):.6f}")
    finite = all(bool(torch.isfinite(x)) for x in losses)

    tok_s = args.batch * args.seq / ms * 1e3
    if not cuda:
        print(f"{ms:.3f} ms/step (host clock, CPU), {tok_s:.0f} tokens/s")
        return 0 if finite else 1
    tflops = train_flops_per_step(cfg, args.batch, args.seq) / ms / 1e9
    peak = peak_bf16_tflops(name)
    mfu = None if peak is None else tflops / peak
    print(f"{ms:.3f} ms/step (CUDA events), {tok_s:.0f} tokens/s, "
          f"{tflops:.2f} model TFLOP/s, MFU "
          f"{mfu if mfu is None else f'{mfu:.4f}'} against {peak} TFLOP/s "
          f"dense bf16 ({name})")
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
