"""mpi_tpu_torch — the PyTorch/CUDA port of ``mpi_tpu`` for NVIDIA Hopper.

The package sits beside the JAX package and computes the same functions.
Plain tensor code is PyTorch; each kernel that the JAX package wrote in
Pallas for the TPU is a CUDA C++ kernel for ``sm_90a`` here
(``ops/csrc/``), built at first use. The port imports neither ``jax`` nor
``mpi_tpu``: it keeps its own copy of what it needs.

Ported so far, for the flagship decoder LM (``models/``):
- serving: KV-cache ``generate`` over the flash-decode kernel
  (``ops/decode_attention.py``; ``python -m mpi_tpu_torch.serve``);
- training: one AdamW step on one device, with attention in the flash
  forward and FA-2 backward kernels (``ops/attention.py``;
  ``python -m mpi_tpu_torch.train``);
- the device collective layer: a rank mesh whose ranks may share one
  device (``parallel/mesh.py``), the ring all-gather and all-reduce
  kernels (``ops/ring_collectives.py``) and the static send/receive
  kernel (``parallel/p2p.py``), each one launch over all ranks, and the
  collectives over them (``parallel/collectives.py``);
- the device MPI driver: the reference's API as a facade (``api.py``,
  re-exported here: ``init``, ``rank``, ``size``, ``send``, ``receive``,
  the collectives, ...) over the cuda driver, one thread per rank over the
  CUDA devices (``backends/cuda.py``), started by ``run_main``
  (``python -m mpi_tpu_torch.examples.helloworld --mpi-ranks 4``).
Entry points run on the CUDA device unless the caller passes
``device="cpu"``.
"""

import torch  # noqa: F401  (the port's one framework)

from .api import (Interface, MpiError, NotInitializedError, TagError,
                  allgather, allreduce, alltoall, barrier, bcast, exscan,
                  finalize, gather, init, iprobe, rank, receive, reduce,
                  reduce_scatter, register, registered, scan, scatter, send,
                  sendrecv, size, wtime)
from .runner import run_main, selected_backend

__version__ = "0.1.0"

__all__ = ["Interface", "MpiError", "NotInitializedError", "TagError",
           "allgather", "allreduce", "alltoall", "barrier", "bcast",
           "exscan", "finalize", "gather", "init", "iprobe", "rank",
           "receive", "reduce", "reduce_scatter", "register", "registered",
           "run_main", "scan", "scatter", "selected_backend", "send",
           "sendrecv", "size", "wtime"]
