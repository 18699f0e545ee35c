"""The port's device collective layer: the rank mesh, static
point-to-point exchange between its ranks, and the collectives over them
(``parallel/collectives.py``, imported as a module as in the JAX package);
counterpart of ``mpi_tpu/parallel``. The ring kernels live in
``mpi_tpu_torch/ops/ring_collectives.py``, as in the JAX package."""

from .mesh import (RANK_AXIS, RankMesh, describe_topology, make_mesh,
                   make_mesh_2d, mesh_devices, rank_axis)
from .p2p import (exchange, exchange_sharded, sendrecv, sendrecv_plain,
                  sendrecv_sharded, tagged_exchange)

__all__ = ["RANK_AXIS", "RankMesh", "rank_axis", "mesh_devices", "make_mesh",
           "make_mesh_2d", "describe_topology", "exchange",
           "tagged_exchange", "exchange_sharded", "sendrecv",
           "sendrecv_sharded", "sendrecv_plain"]
