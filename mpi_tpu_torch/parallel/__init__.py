"""The port's device collective layer: the rank mesh, static
point-to-point exchange between its ranks, the collectives over them
(``parallel/collectives.py``, imported as a module as in the JAX package),
the long-context layer over a mesh's ``sp`` axis: ring attention, Ulysses
and cache-parallel decode, the ZeRO-1 / FSDP layouts over its ``dp``
axis (``parallel/zero.py``, imported as a module), Megatron's
reductions over its ``tp`` axis (``parallel/tensor_parallel.py``, imported
as a module; no JAX twin: GSPMD inserts them there), GPipe over its ``pp``
axis, the halo exchange and Jacobi sweeps of a block-sharded grid, and
the linear scan, sequence-parallel over its ``sp`` axis (the state-space
LM's recurrence); counterpart of ``mpi_tpu/parallel``.
The ring kernels live in ``mpi_tpu_torch/ops/ring_collectives.py``, as in
the JAX package."""

from .mesh import (RANK_AXIS, RankMesh, axis_ring, axis_slice,
                   describe_topology, make_mesh, make_mesh_2d, mesh_devices,
                   rank_axis)
from .p2p import (exchange, exchange_sharded, sendrecv, sendrecv_plain,
                  sendrecv_sharded, tagged_exchange)
from .ring_attention import (ring_attention, ring_attention_sharded,
                             ring_attention_zigzag, ring_flash_attention,
                             ring_flash_attention_zigzag, zigzag_indices,
                             zigzag_inverse_indices)
from .ulysses import ulysses_attention, ulysses_attention_sharded
from .pipeline import pipeline, pipeline_sharded
from .halo import halo_exchange, jacobi_step_1d, jacobi_step_2d
from .scan import linear_scan, sharded_linear_scan
from .cache_parallel import (cache_parallel_decode_attention,
                             merge_decode_partials)

__all__ = ["RANK_AXIS", "RankMesh", "rank_axis", "mesh_devices", "make_mesh",
           "make_mesh_2d", "axis_ring", "axis_slice", "describe_topology",
           "exchange", "tagged_exchange", "exchange_sharded", "sendrecv",
           "sendrecv_sharded", "sendrecv_plain", "ring_attention",
           "ring_flash_attention", "ring_flash_attention_zigzag",
           "ring_attention_sharded", "ring_attention_zigzag",
           "zigzag_indices", "zigzag_inverse_indices", "ulysses_attention",
           "ulysses_attention_sharded", "cache_parallel_decode_attention",
           "merge_decode_partials", "pipeline", "pipeline_sharded",
           "halo_exchange", "jacobi_step_1d", "jacobi_step_2d",
           "linear_scan", "sharded_linear_scan"]
