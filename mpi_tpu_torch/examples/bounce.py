"""bounce: ping-pong round trips on the port's cuda driver.

Twin of ``examples/bounce.py`` (the reference's examples/bounce/bounce.go):
even/odd rank pairs exchange messages of {0, 1, 10, ..., 10^7} bytes
(bounce.go:33), 10 repeats each (bounce.go:35), checking every echo
(bounce.go:104-108, 131-136). Two legs: raw bytes, and float64 values (the
reference's typed leg, bounce.go:114-136) as a tensor on the rank's device,
which the driver copies to the partner's device. Even ranks print the mean
round trip in microseconds per size (bounce.go:149-152), timed on the
host clock around send, receive and the wait for the echo's device work.
Run::

    python -m mpi_tpu_torch.examples.bounce --mpi-ranks 2
    python -m mpi_tpu_torch.examples.bounce --mpi-ranks 2 -- --json

Requires an even number of ranks (bounce.go:54-58). ``--max-bytes N``
keeps the sizes up to N (the tests run it small on the CPU).
"""

import argparse
import json
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

import mpi_tpu_torch

SIZES = [0] + [10 ** k for k in range(8)]  # bounce.go:33
REPS = 10  # bounce.go:35


def _args(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--json", action="store_true")
    parser.add_argument("--max-bytes", type=int, default=SIZES[-1])
    return parser.parse_known_args(argv)[0]


def _settle(x) -> None:
    """Wait until the device work that produced ``x`` is done."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.current_stream(x.device).synchronize()


def sweep(rank: int, partner: int, sizes, make: Callable, check: Callable,
          label: str, results: Dict) -> None:
    even = rank % 2 == 0
    for length in sizes:
        msg = make(length)
        times = []
        for _ in range(REPS):
            tag = rank if even else partner  # unique live {peer, tag} pair
            if even:
                t0 = time.perf_counter()
                mpi_tpu_torch.send(msg, partner, tag)
                echo = mpi_tpu_torch.receive(partner, tag)
                _settle(echo)
                times.append(time.perf_counter() - t0)
                if not check(echo, msg):
                    raise SystemExit(
                        f"rank {rank}: {label} echo mismatch at size {length}")
            else:
                got = mpi_tpu_torch.receive(partner, tag)
                mpi_tpu_torch.send(got, partner, tag)
        if even:
            results[(label, length)] = 1e6 * float(np.mean(times))


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    """One rank's part. Even ranks return ``{"sizes", "reps", "device",
    "bytes_us", "tensor_us"}``, the mean round trips; odd ranks None."""
    args = _args(argv)
    mpi_tpu_torch.init()
    try:
        rank, size = mpi_tpu_torch.rank(), mpi_tpu_torch.size()
        if size % 2 != 0:
            raise SystemExit("bounce requires an even number of ranks "
                             "(bounce.go:54-58)")
        partner = rank + 1 if rank % 2 == 0 else rank - 1
        device = mpi_tpu_torch.registered().device()
        sizes = [s for s in SIZES if s <= args.max_bytes]

        rng = np.random.default_rng(42)
        byte_msg = rng.integers(0, 256, sizes[-1], dtype=np.uint8).tobytes()
        values = torch.from_numpy(rng.standard_normal(sizes[-1])).to(device)

        results: dict = {}
        sweep(rank, partner, sizes, lambda n: byte_msg[:n],
              lambda a, b: a == b, "bytes", results)
        sweep(rank, partner, sizes, lambda n: values[:n],
              lambda a, b: a.device == b.device and torch.equal(a, b),
              "tensor", results)
        if rank % 2:
            return None
        out = {"rank": rank, "sizes": sizes, "reps": REPS,
               "device": str(device),
               "bytes_us": [results[("bytes", n)] for n in sizes],
               "tensor_us": [results[("tensor", n)] for n in sizes]}
        if args.json:
            print(json.dumps(out), flush=True)
        else:
            print(f"rank {rank} <-> {partner}  mean round-trip per size "
                  f"({REPS} reps, float64 tensor on {device})", flush=True)
            print(f"{'size':>10}  {'bytes µs':>12}  {'float64[] µs':>12}")
            for n, b, t in zip(sizes, out["bytes_us"], out["tensor_us"]):
                print(f"{n:>10}  {b:>12.1f}  {t:>12.1f}", flush=True)
        return out
    finally:
        mpi_tpu_torch.finalize()


if __name__ == "__main__":
    mpi_tpu_torch.run_main(main)
