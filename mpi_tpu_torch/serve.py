"""Serve the flagship decoder LM with KV-cache decode on the GPU.

The port's counterpart of parts 1-2 of ``examples/serve.py``: greedy
KV-cache decode, then the same with weight-only int8 weights, at the
flagship decode configuration (d_model 1024, 8 layers, 8 heads of 128,
d_ff 4096, vocab 8192, batch 8, 128 prompt and 128 new tokens, bf16), with
each decode step's attention in the flash-decode kernel. Weights are random,
drawn from ``--seed``. Prints the time of each ``generate`` call and its
tokens per second. Speculative decoding and the state-space model are not
ported yet.

Run::

    python -m mpi_tpu_torch.serve                 # on the CUDA device
    python -m mpi_tpu_torch.serve --layers 2 --device cpu   # plain path
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from .models import TransformerConfig, generate, init_params, quantize_params
from .utils.platform import resolve_device

__all__ = ["flagship_config", "main"]


def flagship_config(n_layers: int = 8, dtype: torch.dtype = torch.bfloat16,
                    decode_attention: str = "flash",
                    max_seq: int = 256) -> TransformerConfig:
    """The flagship decode configuration (``bench.py``'s
    ``measure_decode``), with decode attention in the flash-decode kernel.
    Parameters are stored in the compute dtype: the JAX package keeps
    float32 masters and casts them at each use, which gives the same
    values."""
    return TransformerConfig(
        vocab=8192, d_model=1024, n_heads=8, n_layers=n_layers, d_ff=4096,
        max_seq=max_seq, dtype=dtype, param_dtype=dtype,
        decode_attention=decode_attention)


def _timed_ms(fn, device: torch.device):
    """Run ``fn`` once and return (result, wall ms) on the host clock,
    synchronising the device before reading it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=128,
                    help="new tokens to generate")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = flagship_config(n_layers=args.layers,
                          max_seq=args.prompt_len + args.tokens)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    n_tok = args.batch * args.tokens

    def run(label, p):
        generate(p, prompt, cfg, args.tokens, device=dev)  # warm-up
        out, ms = _timed_ms(
            lambda: generate(p, prompt, cfg, args.tokens, device=dev), dev)
        print(f"{label:<24} {ms:9.2f} ms   {ms / args.tokens:7.3f} ms/step"
              f"   {n_tok / ms * 1e3:9.0f} tok/s")
        return out

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"flagship serve on {name}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.tokens} "
          f"layers={args.layers}")
    ref = run("greedy decode", params)
    q = run("greedy decode (int8)", quantize_params(params))
    valid = bool(((q >= 0) & (q < cfg.vocab)).all() and
                 ((ref >= 0) & (ref < cfg.vocab)).all())
    agree = float((q == ref).float().mean())
    print(f"outputs in vocab: {valid}   int8 agreement with bf16 greedy: "
          f"{agree:.1%}")
    return 0 if valid else 1


if __name__ == "__main__":
    sys.exit(main())
