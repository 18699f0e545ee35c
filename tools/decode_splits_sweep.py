#!/usr/bin/env python3
"""The flash-decode kernel's time against its blocks per cluster, S, on one
NVIDIA GPU.

    python3 tools/decode_splits_sweep.py

At the flagship decode widths (b 8, h = kv 8, hd 128, bf16) and caches of
t 256, 1024, 2048 and 8192 positions (all live, and at t 256 also one
live key, where S = 2 against S = 1 is the cost of a cluster launch and
its merge), it launches the built kernel with S forced to each value
from 1 to 8 that leaves every block at least one load unit, and times
each with CUDA events and the stream held busy while the host enqueues
(``chip_smoke.kernel_ms``), beside SDPA on the same inputs. It marks the
S that ``kernel_splits`` picks and prints the card's ``nvidia-smi`` name
and power limit. S = 1 is a plain launch, any other S a cluster launch.
Exits 2 without CUDA.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402  (the repo root is on the path now)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_splits_sweep: no CUDA device is available",
              file=sys.stderr)
        return 2
    from mpi_tpu_torch.ops import decode_attention as da

    card = chip_smoke.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, kv, hd, dtype = 8, 8, 8, 128, torch.bfloat16
    unit = da.kernel_tile(dtype, hd)
    lib = da._kernel_lib()
    for t, n_valid, n_sets, reps in ((256, 0, 12, 240), (256, 255, 12, 240),
                                     (1024, 1023, 4, 200),
                                     (2048, 2047, 2, 120),
                                     (8192, 8191, 1, 40)):
        sets = [tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                      for shape in ((b, h, hd), (b, t, kv, hd),
                                    (b, t, kv, hd)))
                for _ in range(n_sets)]
        out = torch.empty(b, h, hd, dtype=dtype, device=dev)
        lse = torch.empty(b, h, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        times = {}
        for s in range(1, 9):
            if s > 1 and t // s < unit:
                continue

            def launch(q, k, v, s=s):
                err = lib.decode_attention(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), b, t, kv, h, hd, s, n_valid, None,
                    1.0 / math.sqrt(hd), 1, stream)
                chip_smoke.check(err == 0, f"launch failed: cudaError {err}")

            times[s] = chip_smoke.kernel_ms(launch, sets, reps) * 1e3
        sdpa = chip_smoke.kernel_ms(
            lambda q, k, v: F.scaled_dot_product_attention(
                q[:, :, None], k[:, :n_valid + 1].transpose(1, 2),
                v[:, :n_valid + 1].transpose(1, 2)),
            sets, reps // 4) * 1e3
        picked = da.kernel_splits(b, kv, h, t, hd, dtype, sms)
        print(f"decode b={b} h={h} kv={kv} hd={hd} t={t} n_valid={n_valid} "
              f"{dtype}: us by S {times}; kernel_splits picks S={picked}; "
              f"sdpa {sdpa!r} us  [{card}]")
        del sets
    return 0


if __name__ == "__main__":
    sys.exit(main())
