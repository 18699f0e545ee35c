#!/usr/bin/env python3
"""Where the cuda driver's time goes per collective, on one NVIDIA GPU.

    python3 tools/driver_costs.py

8 rank threads on the card (``mpi_tpu_torch.backends.cuda.run_spmd``), as
in chip_smoke.py's driver phase. For each case it runs one warm-up and 10
timed collectives through ``mpi_tpu_torch`` and prints, per collective:
the device time (CUDA events on rank 0's stream), rank 0's host time (no
device wait), and the caching allocator's counts over the timed calls
(``torch.cuda.memory_stats``: device allocations and frees, allocation
retries, which free the cache and wait for the device; the change of the
reserved and allocated bytes over the run), and the host time
the leader spends in the all-reduce's fold (the route's own host work).
Cases:

* ``barrier``: the session alone (two barrier waits of 8 threads);
* ``allreduce`` of a 4 KB float32 tensor per rank, tree and ring routes:
  the session and the route's host work on a payload the device does
  at once;
* the flagship's gradient (110,136,320 values per rank), float32 and bf16,
  tree and ring routes, each with the ranks keeping their previous result
  while the next is computed (as chip_smoke.py's loop does) and dropping
  it first;
* the same device work called directly from one thread (no driver), host
  time and allocator counts;
* bounce's float64 tensor leg (``mpi_tpu_torch.examples.bounce``) at
  10^4, 10^5 and 10^6 values, each round trip's host µs, two passes;
* ``bounce.main`` itself, twice, as chip_smoke.py runs it: each round
  trip's host µs of both legs at every size.

Prints the card's ``nvidia-smi`` name and power limit. Exits 2 without
CUDA.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root is on the path now)

N = 8
CALLS = 10
FLAGSHIP_PARAMS = 110_136_320  # values of the flagship's 84 leaves
STATS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
         "reserved_bytes.all.current", "allocated_bytes.all.current")


def _stats():
    import torch

    s = torch.cuda.memory_stats()
    return {k: s.get(k, 0) for k in STATS}


def _delta(after, before):
    """Counts per collective; the byte gauges as the change over the run,
    in GB."""
    return {k: (after[k] - before[k]) / (1e9 if "bytes" in k else CALLS)
            for k in STATS}


def through_driver(make_payload, call, keep, ring=False):
    """Device ms, host ms and allocator counts per collective of ``call``
    on each rank's ``make_payload(rank)``, after one warm-up; ``ring``
    lowers ``RING_MIN_BYTES`` for the run."""
    import torch

    import mpi_tpu_torch as M
    from mpi_tpu_torch import collectives_generic as tgen
    from mpi_tpu_torch.backends import cuda
    from mpi_tpu_torch.backends.cuda import run_spmd

    leader_ms = []
    fold = cuda._MeshCollectives._allreduce_tensors

    def timed_fold(self, tensors, op):
        t0 = time.perf_counter()
        try:
            return fold(self, tensors, op)
        finally:
            leader_ms.append((time.perf_counter() - t0) * 1e3)

    def main():
        M.init()
        try:
            mine = make_payload(M.rank())
            got = call(mine)  # warm-up
            if not keep:
                got = None
            M.barrier()
            if M.rank() == 0:
                torch.cuda.synchronize()
                before = _stats()
            M.barrier()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                if keep:
                    got = call(mine)
                else:
                    call(mine)
            host = (time.perf_counter() - t0) * 1e3 / CALLS
            end.record()
            M.barrier()
            if M.rank() != 0:
                return None
            torch.cuda.synchronize()
            counts = _delta(_stats(), before)
            counts["leader_fold_host_ms"] = sum(leader_ms[-CALLS:]) / CALLS
            return start.elapsed_time(end) / CALLS, host, counts
        finally:
            M.finalize()

    saved = tgen.RING_MIN_BYTES
    if ring:
        tgen.RING_MIN_BYTES = 1
    cuda._MeshCollectives._allreduce_tensors = timed_fold
    try:
        return run_spmd(main, n=N)[0]
    finally:
        tgen.RING_MIN_BYTES = saved
        cuda._MeshCollectives._allreduce_tensors = fold


def direct(fn):
    """Device ms (stream held busy while the host enqueues), host ms and
    allocator counts per call of ``fn`` from one thread."""
    import torch

    fn()
    torch.cuda.synchronize()
    before = _stats()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / CALLS
    torch.cuda.synchronize()
    counts = _delta(_stats(), before)
    return chip_smoke.kernel_ms(fn, [()], CALLS), host, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("driver_costs: no CUDA device is available", file=sys.stderr)
        return 2
    import mpi_tpu_torch as M
    from mpi_tpu_torch import collectives_generic as tgen
    from mpi_tpu_torch.ops.ring_collectives import ring_allreduce_ranks

    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)

    def show(label, res):
        ms, host, counts = res
        print(f"{label}: device {ms!r} ms, host {host!r} ms per "
              f"collective; allocator per collective {counts}  [{card}]",
              flush=True)

    show("barrier, 8 ranks", through_driver(
        lambda r: None, lambda _: M.barrier(), keep=False))

    small = torch.randn(N, 1024, generator=gen, device=dev)
    for route in ("tree", "ring"):
        show(f"allreduce 4 KB float32, {route}", through_driver(
            lambda r: small[r], M.allreduce, True, route == "ring"))
    del small

    for dtype in (torch.float32, torch.bfloat16):
        xs = torch.randn(N, FLAGSHIP_PARAMS, generator=gen,
                         device=dev).to(dtype)
        rows = list(xs.unbind(0))
        for route in ("tree", "ring"):
            for keep in (True, False):
                torch.cuda.empty_cache()
                show(f"allreduce {N} x {FLAGSHIP_PARAMS} {dtype}, {route}, "
                     f"{'keeping' if keep else 'dropping'} the previous "
                     f"result", through_driver(lambda r: rows[r],
                                               M.allreduce, keep,
                                               route == "ring"))

        def tree_direct():
            total = tgen.tree_combine(rows, "sum")
            return [total] + [total.clone() for _ in range(N - 1)]

        torch.cuda.empty_cache()
        show(f"direct tree fold and copies {dtype}", direct(tree_direct))
        torch.cuda.empty_cache()
        show(f"direct ring_allreduce_ranks {dtype}",
             direct(lambda: ring_allreduce_ranks(rows)))
        del xs, rows
        torch.cuda.empty_cache()
    for values in (10 ** 4, 10 ** 5, 10 ** 6):
        print(f"bounce float64 tensor leg, {values} values, host us per "
              f"round trip: {round_trips(values)}  [{card}]", flush=True)
    for run in (1, 2):
        for (label, size), times in bounce_reps().items():
            print(f"bounce.main run {run}, {label} leg, size {size}, host us "
                  f"per round trip: {times}  [{card}]", flush=True)
    print(card)
    return 0


def bounce_reps():
    """``bounce.main`` on 2 ranks of the card through ``run_main``, with
    every round trip's host µs: {(leg, size): [µs, ...]}."""
    import contextlib
    import io
    import types

    import numpy as np

    import mpi_tpu_torch as M
    from mpi_tpu_torch.examples import bounce

    reps = []

    def mean(times):
        reps.append([round(t * 1e6) for t in times])
        return np.mean(times)

    proxy = types.SimpleNamespace(**{k: getattr(np, k) for k in dir(np)
                                     if not k.startswith("__")})
    proxy.mean = mean
    saved, bounce.np = bounce.np, proxy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res = M.run_main(lambda: bounce.main([]),
                             ["--mpi-ranks", "2"])[0]
    finally:
        bounce.np = saved
    keys = [(label, size) for label in ("bytes", "tensor")
            for size in res["sizes"]]
    return dict(zip(keys, reps))


def round_trips(values):
    """Two passes of bounce's 10 round trips of ``values`` float64 values
    on the card between ranks 0 and 1: each round trip's host µs, timed as
    bounce times them."""
    import torch

    import mpi_tpu_torch as M
    from mpi_tpu_torch.backends.cuda import run_spmd
    from mpi_tpu_torch.examples.bounce import REPS, _settle

    def main():
        M.init()
        try:
            r = M.rank()
            msg = torch.randn(values, dtype=torch.float64, device="cuda")
            passes = []
            for _ in range(2):
                times = []
                for _ in range(REPS):
                    if r == 0:
                        t0 = time.perf_counter()
                        M.send(msg, 1, 0)
                        _settle(M.receive(1, 0))
                        times.append(round((time.perf_counter() - t0) * 1e6))
                    else:
                        M.send(M.receive(0, 0), 0, 0)
                passes.append(times)
            return passes
        finally:
            M.finalize()

    return run_spmd(main, n=2)[0]


if __name__ == "__main__":
    sys.exit(main())
