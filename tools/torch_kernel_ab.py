#!/usr/bin/env python3
"""Kernels 4 and 5 of the PyTorch port against another checkout's, on one
NVIDIA GPU, in one process.

    python3 tools/torch_kernel_ab.py --other DIR

DIR holds another checkout's ``mpi_tpu_torch`` (for example the parent
commit, unpacked with ``git archive <commit> mpi_tpu_torch`` into a
git-ignored directory). The script loads it under another name beside this
checkout's package, builds both, and times in turns (other, this, this,
other), with CUDA events and the stream held busy while the host enqueues
(``chip_smoke.kernel_ms``):

* the flash-decode kernel at the flagship decode shape (b 8, h = kv 8, hd
  128, t 256, bf16) at n_valid 255, 128 and 0, and at a long cache of the
  same widths (t 8192, n_valid 8191);
* the all-gather kernel at 8 ranks x 13,767,040 bf16 values (the flagship's
  parameters in eighths, chip_smoke.py phase 6).

It checks that the two agree (decode within chip_smoke.py's bf16
tolerance, all-gather bitwise) and prints one line per shape with both
times, the bound, and the card's ``nvidia-smi`` name and power limit.
Exits 2 without CUDA. Uses only the two kernels' public functions, so any
checkout of the port since it had both serves as the other.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root is on the path now)

FLAGSHIP_PARAMS = 110_136_320  # values of the flagship's 84 leaves


def load_other(root: Path, name: str = "other_mpi_tpu_torch"):
    """The ``mpi_tpu_torch`` package under ``root``, imported as ``name``
    (its imports are relative, so it loads beside this checkout's)."""
    pkg = root / "mpi_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def in_turns(fns, sets, reps):
    """ms of each of ``fns`` (other, this) timed other, this, this, other."""
    times = [[], []]
    for i in (0, 1, 1, 0):
        times[i].append(chip_smoke.kernel_ms(fns[i], sets, reps))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="directory that holds the other mpi_tpu_torch")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device is available", file=sys.stderr)
        return 2
    other = load_other(args.other.resolve())
    this = importlib.import_module("mpi_tpu_torch")
    pkgs = []
    for pkg in (other, this):
        name = pkg.__name__
        pkgs.append((importlib.import_module(f"{name}.ops.decode_attention"),
                     importlib.import_module(f"{name}.ops.ring_collectives"),
                     importlib.import_module(f"{name}.parallel")))
    for _, _, par in pkgs:
        par  # both build their own kernels at first use
    card = chip_smoke.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    dtype = torch.bfloat16
    tol = chip_smoke.KERNEL_TOL[str(dtype)]

    b, h, kv, hd = 8, 8, 8, 128
    for t, n_sets, points, reps in ((256, 12, (255, 128, 0), 240),
                                    (8192, 1, (8191,), 60)):
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for shape in ((b, h, hd), (b, t, kv, hd),
                                    (b, t, kv, hd)))
                for _ in range(n_sets)]
        for n_valid in points:
            fns = [lambda q, k, v, d=d: d.flash_decode_attention(q, k, v,
                                                                 n_valid,
                                                                 with_lse=True)
                   for d, _, _ in pkgs]
            (o_out, o_lse), (t_out, t_lse) = (fn(*sets[0]) for fn in fns)
            torch.cuda.synchronize()
            chip_smoke.check(
                torch.allclose(o_out.float(), t_out.float(),
                               atol=tol["out"][0], rtol=tol["out"][1]) and
                torch.allclose(o_lse, t_lse, atol=tol["lse"][0],
                               rtol=tol["lse"][1]),
                f"decode t={t} n_valid={n_valid}: the two disagree")
            times = in_turns(fns, sets, reps)
            n_live = n_valid + 1
            kv_bytes = 2 * b * n_live * kv * hd * 2
            bound_ms, _ = chip_smoke.bound(
                kv_bytes + 2 * b * h * hd * 2 + 4 * b * h,
                4 * b * h * n_live * hd, dtype)
            print(f"decode b={b} h={h} kv={kv} hd={hd} t={t} {dtype} "
                  f"n_valid={n_valid}: other {[x * 1e3 for x in times[0]]} "
                  f"us, this {[x * 1e3 for x in times[1]]} us; bound "
                  f"{bound_ms * 1e3!r} us  [{card}]")
        del sets

    n = chip_smoke.RING_RANKS
    shards = torch.randn(FLAGSHIP_PARAMS, generator=gen,
                         device=dev).to(dtype)
    fns = []
    for _, ring, par in pkgs:
        mesh = par.make_mesh(devices=[dev] * n)
        fns.append(lambda x, ring=ring, mesh=mesh: ring.ring_allgather(x,
                                                                       mesh))
    got = [fn(shards) for fn in fns]
    torch.cuda.synchronize()
    chip_smoke.check(chip_smoke.bits_equal(*got),
                     "all-gather: the two disagree")
    del got
    times = in_turns(fns, [(shards,)], 20)
    least = (FLAGSHIP_PARAMS + n * FLAGSHIP_PARAMS) * 2
    bound_ms, _ = chip_smoke.bound(least, 0, dtype)
    print(f"all-gather {n} ranks x {FLAGSHIP_PARAMS // n} {dtype}: other "
          f"{[x * 1e3 for x in times[0]]} us, this "
          f"{[x * 1e3 for x in times[1]]} us; bound {bound_ms * 1e3!r} us "
          f"({least} bytes)  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
