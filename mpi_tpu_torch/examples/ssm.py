"""ssm: the state-space LM (LRU) end to end on the port.

Twin of ``examples/ssm.py``: trains the small SSM to memorise a repeating
token pattern, decodes the continuation with the O(1)-per-token recurrent
state (no KV cache), and, with ``--sp N`` above 1, holds the
sequence-parallel forward (``ssm_forward_sp``: the sequence split over the
N ranks of an ``sp`` mesh that share the device, the recurrence's carries
hopped on kernel 7) against the single-device forward. Where the JAX
example forces N virtual devices, the N ranks here share the one device.

Run::

    python -m mpi_tpu_torch.examples.ssm --sp 4 --steps 150
    python -m mpi_tpu_torch.examples.ssm --device cpu --sp 2

It runs on the CUDA device unless ``--device`` names another, and raises
when CUDA is absent and no device is named. It prints ``ssm example OK``
and exits non-zero on any failure.
"""

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from mpi_tpu_torch.models import (SsmConfig, make_ssm_train_step, ssm_decode,
                                  ssm_forward, ssm_forward_sp)
from mpi_tpu_torch.parallel import make_mesh
from mpi_tpu_torch.utils.platform import resolve_device

CFG = SsmConfig(vocab=16, d_model=48, n_layers=2, d_state=24, d_ff=96)
LEARNING_RATE = 5e-3
LOSS_LIMIT = 0.1  # the memorised pattern's last loss
SP_LIMIT = 1e-2   # max |sp forward - one device|


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=0,
                    help="check the sequence-parallel forward over N sp "
                         "ranks sharing the device")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        raise SystemExit("--steps must be >= 1")
    dev = resolve_device(args.device)

    init, step = make_ssm_train_step(CFG, learning_rate=LEARNING_RATE)
    state = init(torch.Generator().manual_seed(0), dev)

    pat = np.tile(np.arange(8), 8)[:49]
    toks = torch.from_numpy(np.stack([pat] * 4)).to(dev)
    first = last = None
    for i in range(args.steps):
        state, loss = step(state, toks)
        if i == 0:
            first = float(loss)
        last = float(loss)
    print(f"loss {first:.3f} -> {last:.3f} after {args.steps} steps")
    if last > LOSS_LIMIT:
        raise SystemExit(f"SSM failed to memorize: loss {last}")

    params = state["params"]
    out = ssm_decode(CFG, params, toks[:1, :9], 12, device=dev)
    want = np.tile(np.arange(8), 4)[:21]
    got = out[0].cpu().numpy()
    print("decoded:", got.tolist())
    if not np.array_equal(got, want):
        raise SystemExit("decode diverged from the memorized pattern")

    n = args.sp
    if n > 1:
        sp_toks = toks[:, :n * (toks.shape[1] // n)]
        mesh = make_mesh(axis="sp", devices=[dev] * n)
        with torch.no_grad():
            got = ssm_forward_sp(CFG, params, sp_toks, mesh, device=dev)
            ref = ssm_forward(CFG, params, sp_toks, device=dev)
        err = float((got - ref).abs().max())
        print(f"sequence-parallel forward over {n} sp ranks: "
              f"max |err| {err:.2e}")
        if not err <= SP_LIMIT:
            raise SystemExit("sp forward diverged")
    print("ssm example OK")


if __name__ == "__main__":
    main()
