"""Hold the driver's stream-ordering test to its purpose on the card.

Runs ``test_driver_orders_the_ranks_streams`` (``tests/test_torch_driver.py``)
as it is, where it must pass, and then with each of the cuda driver's three
``torch.cuda.Stream.wait_stream`` calls made a no-op at run time, where it
must fail: the leader's stream waiting on each rank's, each rank's stream
waiting on the leader's, and a receiver's stream waiting on the sender's.
No file is edited; each case runs ``--runs`` times, each in a fresh process.

Run from the root of the repo, on a machine with a CUDA device::

    python3 tools/stream_mutants.py --runs 2

Exits 0 when every case went as it must, 1 otherwise, 2 without CUDA.
"""

from __future__ import annotations

import argparse
import inspect
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = "tests/test_torch_driver.py::test_driver_orders_the_ranks_streams"
DRIVER = os.path.join(ROOT, "mpi_tpu_torch", "backends", "cuda.py")
# Case name -> the source line of the wait_stream call to disable.
CASES = {"leader waits on every rank": "lead.wait_stream(s)",
         "each rank waits on the leader": "stream.wait_stream(lead)",
         "receiver waits on the sender": "mine.wait_stream(self.stream)"}


def run_test(disabled: str) -> int:
    """Run the test in this process, the ``wait_stream`` calls made from a
    line that contains ``disabled`` (when it is not empty) doing nothing;
    returns pytest's exit code."""
    import pytest
    import torch

    if disabled:
        wait_stream = torch.cuda.Stream.wait_stream

        def patched(self, other):
            line = (inspect.stack()[1].code_context or [""])[0]
            return None if disabled in line else wait_stream(self, other)

        torch.cuda.Stream.wait_stream = patched
    return int(pytest.main(["-q", "-p", "no:cacheprovider", TEST]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--disable", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.disable is not None:
        return run_test(args.disable)

    import torch

    if not torch.cuda.is_available():
        print("stream_mutants: needs a CUDA device")
        return 2
    with open(DRIVER) as f:
        source = f.read()
    missing = [line for line in CASES.values() if line not in source]
    if missing:
        print(f"stream_mutants: {missing} no longer in {DRIVER}")
        return 1
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    ok = True
    for name, line in [("as it is", "")] + list(CASES.items()):
        codes = [subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--disable", line],
            cwd=ROOT, env=env, capture_output=True).returncode
                 for _ in range(args.runs)]
        # pytest exits 0 when every test passed and 1 when one failed.
        want = 0 if not line else 1
        good = all(c == want for c in codes)
        ok &= good
        print(f"{name}: pytest exit codes {codes}, want {want} each "
              f"({'as it must' if good else 'NOT as it must'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
