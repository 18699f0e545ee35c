"""The port's rank mesh, and how the collective wrappers check the devices
of what they are given. Needs no GPU: meshes that name CUDA devices are
built without touching one, and every check raises before a launch."""

import pytest
import torch

from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                ring_allreduce,
                                                ring_allreduce_sharded)
from mpi_tpu_torch.parallel import (RANK_AXIS, describe_topology,
                                    exchange_sharded, make_mesh,
                                    make_mesh_2d, mesh_devices, rank_axis,
                                    sendrecv, sendrecv_sharded)

WRAPPERS = {
    "ring_allreduce": lambda x, mesh: ring_allreduce(x, mesh),
    "ring_allreduce_sharded": lambda x, mesh: ring_allreduce_sharded(x, mesh),
    "ring_allgather": lambda x, mesh: ring_allgather(x, mesh),
    "sendrecv": lambda x, mesh: sendrecv(x, mesh, [(0, 1)]),
    "sendrecv_sharded": lambda x, mesh: sendrecv_sharded(x, mesh, [(0, 1)]),
    "exchange_sharded": lambda x, mesh: exchange_sharded(x, mesh, [(0, 1)]),
}


def test_rank_axis():
    assert rank_axis() == RANK_AXIS == "rank"


def test_make_mesh_raises_with_too_few_devices():
    present = len(mesh_devices())
    assert all(d.type == "cuda" for d in mesh_devices())
    with pytest.raises(ValueError, match=f"requested {present + 1} devices "
                                         f"but only {present} present"):
        make_mesh(present + 1)


def test_mesh_with_repeated_devices():
    mesh = make_mesh(devices=["cpu"] * 8)
    assert mesh.size == 8
    assert mesh.devices == [torch.device("cpu")] * 8
    assert mesh.axis_names == ("rank",)
    assert mesh.shape == {"rank": 8}
    out = ring_allreduce_sharded(torch.ones(8, 16), mesh)
    assert torch.equal(out, torch.full((16,), 8.0))
    # A CUDA device without an index is device 0 (or the current one).
    cuda = make_mesh(devices=["cuda"] * 2, axis="dp")
    assert cuda.devices[0] == cuda.devices[1]
    assert cuda.devices[0].index is not None
    assert cuda.shape == {"dp": 2}


def test_make_mesh_2d_shape():
    mesh = make_mesh_2d((2, 4), devices=["cpu"] * 8)
    assert mesh.shape == {"outer": 2, "inner": 4}
    assert mesh.axis_names == ("outer", "inner")
    assert mesh.size == 8
    with pytest.raises(ValueError, match="does not hold"):
        make_mesh_2d((2, 4), devices=["cpu"] * 6)


def test_describe_topology():
    info = describe_topology()
    assert set(info) == {"platform", "num_devices", "num_processes",
                         "process_index", "local_devices", "device_kinds"}
    assert info["num_devices"] == len(mesh_devices())


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_raise_for_tensors_off_the_mesh_device(name):
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="lies on cpu, the mesh's ranks on "
                                         "cuda:0"):
        WRAPPERS[name](x, make_mesh(devices=["cuda:0"] * 4))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrappers_raise_for_a_mesh_over_several_cuda_devices(name):
    mesh = make_mesh(devices=["cuda:0", "cuda:1", "cuda:0", "cuda:1"])
    with pytest.raises(NotImplementedError, match="NVLink peer path"):
        WRAPPERS[name](torch.zeros(4, 8), mesh)
