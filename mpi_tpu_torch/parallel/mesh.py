"""The rank mesh: which device each rank's data lies on.

Counterpart of ``mpi_tpu/parallel/mesh.py``. There a rank is a coordinate
on a ``jax.sharding.Mesh`` axis; here it is a position on a
:class:`RankMesh`, a small plain class that holds one ``torch.device`` per
rank, the axis names and ``.shape`` as a dict (as ``Mesh.shape`` is).

A mesh may name one device several times: the ranks then share it, as the
JAX package's XLA backend does when it maps more ranks than there are
devices round-robin (``XlaNetwork(oversubscribe=True)``). That is how eight
ranks live on one H100, and how the CPU tests put them on ``"cpu"``. The
ring and send/receive kernels run one launch over all ranks of such a mesh
(``ops/ring_collectives.py``, ``parallel/p2p.py``); a mesh over several
distinct CUDA devices makes them raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

__all__ = ["RANK_AXIS", "RankMesh", "rank_axis", "mesh_devices", "make_mesh",
           "make_mesh_2d", "axis_slice", "axis_ring", "mesh_device",
           "shared_ring",
           "rank_pointers", "describe_topology"]

RANK_AXIS = "rank"

Device = Union[str, torch.device]


def rank_axis() -> str:
    """Canonical mesh-axis name for MPI-style rank parallelism."""
    return RANK_AXIS


def _device(d: Device) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one (device 0 where CUDA is absent), as a tensor would say."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        d = torch.device("cuda", idx)
    return d


class RankMesh:
    """Ranks laid out on devices: ``devices`` in rank order (row-major over
    ``axis_names``), ``shape`` the size of each axis."""

    def __init__(self, devices: Sequence[Device], axis_names: Sequence[str],
                 sizes: Optional[Sequence[int]] = None):
        self.devices: List[torch.device] = [_device(d) for d in devices]
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if not self.devices:
            raise ValueError("mpi_tpu_torch: a mesh needs at least one "
                             "device; got none")
        sizes = (len(self.devices),) if sizes is None else tuple(sizes)
        if len(sizes) != len(self.axis_names):
            raise ValueError(f"mpi_tpu_torch: {len(self.axis_names)} axis "
                             f"names for a mesh of shape {sizes}")
        if math.prod(sizes) != len(self.devices):
            raise ValueError(f"mpi_tpu_torch: mesh shape {sizes} does not "
                             f"hold {len(self.devices)} devices")
        self.shape: Dict[str, int] = dict(zip(self.axis_names, sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        return len(self.devices)


def mesh_devices(n: Optional[int] = None) -> List[torch.device]:
    """First ``n`` CUDA devices in enumeration order; ``None`` means all of
    them (an empty list where CUDA is absent)."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    devs = [torch.device("cuda", i) for i in range(count)]
    if n is None:
        return devs
    if n > len(devs):
        raise ValueError(
            f"mpi_tpu_torch: requested {n} devices but only {len(devs)} "
            f"present")
    return devs[:n]


def make_mesh(n: Optional[int] = None, axis: str = RANK_AXIS,
              devices: Optional[Sequence[Device]] = None) -> RankMesh:
    """A 1-D mesh whose single axis is the MPI rank dimension: the first
    ``n`` CUDA devices, or ``devices`` as given (repeats allowed)."""
    if devices is None:
        devices = mesh_devices(n)
    return RankMesh(devices, (axis,))


def make_mesh_2d(shape: Tuple[int, int],
                 axes: Tuple[str, str] = ("outer", "inner"),
                 devices: Optional[Sequence[Device]] = None) -> RankMesh:
    """A 2-D mesh for hierarchical collectives; ``devices`` in row-major
    order over ``shape``."""
    n = shape[0] * shape[1]
    if devices is None:
        devices = mesh_devices(n)
    return RankMesh(devices, axes, shape)


def _rank_grid(mesh: RankMesh, axis: str) -> Tuple[torch.Tensor, int]:
    """The rank numbers laid out row-major over the mesh's axes, and the
    position of ``axis`` among them."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mpi_tpu_torch: mesh {mesh.axis_names} has no "
                         f"{axis!r} axis")
    sizes = [mesh.shape[a] for a in mesh.axis_names]
    return (torch.arange(mesh.size).reshape(sizes),
            mesh.axis_names.index(axis))


def axis_slice(mesh: RankMesh, axis: str, index: int) -> RankMesh:
    """The ranks of ``mesh`` whose ``axis`` coordinate is ``index``, as a
    mesh over the other axes in their order: the (sp, tp) mesh of dp rank
    ``index`` of a ``("dp", "sp", "tp")`` mesh. With no other axis it is a
    one-rank mesh with no axes."""
    grid, d = _rank_grid(mesh, axis)
    part = grid.select(d, index)
    names = tuple(a for a in mesh.axis_names if a != axis)
    return RankMesh([mesh.devices[r] for r in part.reshape(-1).tolist()],
                    names, tuple(part.shape))


def axis_ring(mesh: RankMesh,
              axis: Union[str, Tuple[str, ...]]) -> RankMesh:
    """The ranks along ``axis`` at coordinate 0 of every other axis, as a
    1-D mesh over ``axis`` in rank order: the dp ring of the (sp, tp)
    position (0, 0), whose ``size`` the ring collectives take as their
    rank count. A tuple of axes gives one ring over all of them, their
    ranks row-major in the mesh's axis order: ``("ep", "tp")`` is the ring
    of ep·tp ranks at dp coordinate 0, rank (e, j) at place e·tp + j. Its
    ``shape`` keeps each axis's size (the collectives read only ``size``
    and the rank order)."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    keep = sorted(_rank_grid(mesh, a)[1] for a in axes)
    grid = _rank_grid(mesh, axes[0])[0]
    index = [slice(None) if i in keep else 0
             for i in range(len(mesh.axis_names))]
    ranks = grid[tuple(index)].reshape(-1).tolist()
    names = tuple(mesh.axis_names[i] for i in keep)
    return RankMesh([mesh.devices[r] for r in ranks], names,
                    [mesh.shape[a] for a in names])


def mesh_device(mesh: RankMesh, x: torch.Tensor, name: str) -> str:
    """Where ``name`` runs ``x`` over ``mesh``: ``"cuda"`` (its kernel) or
    ``"cpu"`` (its plain version). Raises ``NotImplementedError`` for a mesh
    over several distinct devices, and ``ValueError`` for a tensor off the
    mesh's device or on a device that is neither."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mpi_tpu_torch: {name} runs on cuda (kernel) or "
                         f"cpu (plain); got {x.device}")
    distinct = sorted({str(d) for d in mesh.devices})
    if len(distinct) > 1:
        raise NotImplementedError(
            f"mpi_tpu_torch: {name} over a mesh of several devices "
            f"{distinct} is not ported: the kernels run every rank on one "
            f"device (the NVLink peer path is queued in ROADMAP.md)")
    if x.device != mesh.devices[0]:
        raise ValueError(f"mpi_tpu_torch: {name}: the tensor lies on "
                         f"{x.device}, the mesh's ranks on "
                         f"{mesh.devices[0]}")
    return x.device.type


def shared_ring(mesh: RankMesh, axis_name: str, x: torch.Tensor,
                what: str) -> RankMesh:
    """The 1-D mesh of ``mesh``'s ``axis_name`` ranks, on the device they
    share with ``x``. The other axes (``dp``, ``tp``) stay batch and head
    dimensions of the same launches: the ring of ring attention, Ulysses
    and the pipeline. Raises ``TypeError`` for a mesh that is no
    :class:`RankMesh`, ``ValueError`` for one without the axis,
    ``NotImplementedError`` for one over several distinct devices."""
    if not isinstance(mesh, RankMesh):
        raise TypeError(f"mpi_tpu_torch: {what} takes a RankMesh; got "
                        f"{type(mesh).__name__}")
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mpi_tpu_torch: mesh {mesh.axis_names} has no "
                         f"{axis_name!r} axis for {what}")
    mesh_device(mesh, x, what)
    return RankMesh([mesh.devices[0]] * mesh.shape[axis_name], (axis_name,))


def rank_pointers(stacked: torch.Tensor) -> ctypes.Array:
    """The kernels' per-rank pointer table: the address of ``stacked[r]``
    for each rank r of a stacked ``(n, ...)`` tensor."""
    ptrs = [stacked[r].data_ptr() for r in range(stacked.shape[0])]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def describe_topology() -> dict:
    """Launcher-facing summary of the devices this process sees."""
    devs = mesh_devices()
    dist = torch.distributed
    ready = dist.is_available() and dist.is_initialized()
    return {
        "platform": "cuda" if devs else "none",
        "num_devices": len(devs),
        "num_processes": dist.get_world_size() if ready else 1,
        "process_index": dist.get_rank() if ready else 0,
        "local_devices": len(devs),
        "device_kinds": sorted({torch.cuda.get_device_name(d)
                                for d in devs}),
    }
