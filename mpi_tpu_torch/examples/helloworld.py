"""helloworld: every core primitive, on the port's cuda driver.

Twin of ``examples/helloworld.py`` (the reference's
examples/helloworld/helloworld.go): each rank sends a greeting to every
rank, itself included, and receives one from every rank, all concurrently
on threads of its own (helloworld.go:53-81), checks each, and prints what
it got. Run::

    python -m mpi_tpu_torch.examples.helloworld --mpi-ranks 4
    python -m mpi_tpu_torch.examples.helloworld --mpi-ranks 4 --mpi-device cpu
"""

import threading
from typing import List

import mpi_tpu_torch


def main() -> List[str]:
    """One rank's part; returns the greetings it received, checked, in
    source order."""
    mpi_tpu_torch.init()
    try:
        rank, size = mpi_tpu_torch.rank(), mpi_tpu_torch.size()
        received = [None] * size
        errors = []

        def send_to(dst: int) -> None:
            try:
                mpi_tpu_torch.send(f"Hello to rank {dst} from rank {rank}",
                                   dst, tag=rank)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        def recv_from(src: int) -> None:
            try:
                received[src] = mpi_tpu_torch.receive(src, tag=src)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(exc)

        threads = [threading.Thread(target=send_to, args=(d,))
                   for d in range(size)]
        threads += [threading.Thread(target=recv_from, args=(s,))
                    for s in range(size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise SystemExit(f"rank {rank}: {errors[0]}")
        for src, msg in enumerate(received):
            expect = f"Hello to rank {rank} from rank {src}"
            if msg != expect:
                raise SystemExit(
                    f"rank {rank}: bad greeting from {src}: {msg!r}")
            print(f"rank {rank}/{size} <- rank {src}: {msg}", flush=True)
        return received
    finally:
        mpi_tpu_torch.finalize()


if __name__ == "__main__":
    mpi_tpu_torch.run_main(main)
