"""Serve the flagship decoder LM with KV-cache decode on the GPU.

The port's counterpart of ``examples/serve.py``: greedy KV-cache decode,
the same with weight-only int8 weights, prompt-lookup speculative decoding
(``generate_lookahead``, ``--draft-len`` tokens verified a forward, an
``--ngram`` lookup key), and the state-space LM's recurrent decode
(``ssm_decode``: no KV cache, an O(1) state a layer; the example's small
SSM, 2 layers of the flagship's widths with d_state 32, float32), at the
flagship decode
configuration (d_model 1024, 8 layers, 8 heads of 128, d_ff 4096, vocab
8192, batch 8, 128 prompt and 128 new tokens, bf16), with each decode
step's attention in the flash-decode kernel (the speculative path's verify
forwards take the dense cached attention). Weights are random, drawn from
``--seed``. Prints the time of each call and its tokens per second, and the
int8 and speculative tokens' agreement with bf16 greedy.

Run::

    python -m mpi_tpu_torch.serve                 # on the CUDA device
    python -m mpi_tpu_torch.serve --layers 2 --device cpu   # plain path
    python -m mpi_tpu_torch.serve --draft-len 4 --ngram 2
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from .models import (SsmConfig, TransformerConfig, generate,
                     generate_lookahead, init_params, init_ssm_params,
                     quantize_params, ssm_decode)
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
    ap.add_argument("--draft-len", type=int, default=6,
                    help="drafted tokens verified a speculative forward")
    ap.add_argument("--ngram", type=int, default=3,
                    help="the speculative lookup key's length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # The speculative rounds write up to draft_len + 1 positions past the
    # last committed token.
    cfg = flagship_config(n_layers=args.layers,
                          max_seq=args.prompt_len + args.tokens
                          + args.draft_len + 1)
    gen = torch.Generator().manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    n_tok = args.batch * args.tokens

    def run(label, p, fn=generate, **kw):
        fn(p, prompt, cfg, args.tokens, device=dev, **kw)  # warm-up
        out, ms = _timed_ms(
            lambda: fn(p, prompt, cfg, args.tokens, device=dev, **kw), dev)
        print(f"{label:<24} {ms:9.2f} ms   {ms / args.tokens:7.3f} ms/step"
              f"   {n_tok / ms * 1e3:9.0f} tok/s")
        return out

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"flagship serve on {name}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.tokens} "
          f"layers={args.layers}")
    ref = run("greedy decode", params)
    q = run("greedy decode (int8)", quantize_params(params))
    spec = run("speculative decode", params, generate_lookahead,
               draft_len=args.draft_len, ngram=args.ngram)
    # The state-space LM: recurrent decode with no KV cache (its per-token
    # cost does not grow with the context). ssm_decode returns the prompt
    # and the new tokens.
    scfg = SsmConfig(vocab=cfg.vocab, d_model=cfg.d_model, n_layers=2,
                     d_state=32, d_ff=cfg.d_ff)
    sparams = init_ssm_params(
        scfg, torch.Generator().manual_seed(args.seed + 1), dev)
    ssm = run("ssm decode (no KV cache)", sparams,
              lambda p, head, c, n, device: ssm_decode(
                  scfg, p, head, n, device=device)[:, head.shape[1]:])
    valid = all(bool(((t >= 0) & (t < cfg.vocab)).all())
                for t in (ref, q, spec, ssm)) and \
        tuple(ssm.shape) == (args.batch, args.tokens)
    agree = float((q == ref).float().mean())
    spec_agree = float((spec == ref).float().mean())
    print(f"outputs in vocab: {valid}   int8 agreement with bf16 greedy: "
          f"{agree:.1%}   speculative agreement with bf16 greedy: "
          f"{spec_agree:.1%}")
    return 0 if valid else 1


if __name__ == "__main__":
    sys.exit(main())
