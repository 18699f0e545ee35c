"""Rules the PyTorch port keeps, checked without a GPU.

* The port imports neither ``jax`` nor the JAX package ``mpi_tpu``.
* Entry points run on the CUDA device unless the caller names another: with
  CUDA absent and no device given they raise instead of using the CPU.
* The decode, flash, ring and send/receive wrappers take the plain path
  only for CPU tensors; any other device raises instead of falling back,
  and a CPU call counts no kernel launch.
* A missing CUDA compiler is an error, never a stub.
* The cuda driver waits for the device nowhere on its path: no
  ``torch.cuda.synchronize`` in ``backends/cuda.py``.
* The all-reduce and all-gather kernels are one ordinary launch each: no
  grid barrier, no cooperative launch. The decode kernel merges its
  cluster's splits with no atomic. The bf16 flash forward and backward multiply on
  wgmma with p, ds and their transposes in registers, not through shared
  memory; on CUDA the backward takes delta from kernel 2, not from torch
  ops; no launch sets a kernel attribute.
"""

import inspect
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpi_tpu_torch import train
from mpi_tpu_torch.models import (TransformerConfig, generate, init_params,
                                  make_train_step)
from mpi_tpu_torch.ops import _build
from mpi_tpu_torch.ops.attention import (flash_attention, flash_bwd_dkv,
                                         flash_bwd_dq, flash_bwd_dq_delta,
                                         flash_chunk_bwd, flash_fwd)
from mpi_tpu_torch.ops import decode_attention
from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
from mpi_tpu_torch.ops.ring_collectives import (ring_allgather,
                                                ring_allgather_sharded,
                                                ring_allreduce,
                                                ring_allreduce_ranks,
                                                ring_allreduce_sharded)
from mpi_tpu_torch.parallel import make_mesh, sendrecv, sendrecv_sharded
from mpi_tpu_torch.parallel import collectives as pcoll
from mpi_tpu_torch import run_main
from mpi_tpu_torch.backends import cuda as cuda_driver

ROOT = Path(__file__).resolve().parent.parent
CFG = TransformerConfig(vocab=64, d_model=32, n_heads=4, n_layers=1,
                        d_ff=64, max_seq=16)
# `import jax`, `from jax`, or the JAX package by module path; the port's
# own name (mpi_tpu_torch) does not match.
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)|\bmpi_tpu\.|"
                       r"\bfrom\s+mpi_tpu\s|\bimport\s+mpi_tpu\b(?!_)",
                       re.MULTILINE)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, mpi_tpu_torch, mpi_tpu_torch.models, "
            "mpi_tpu_torch.serve, mpi_tpu_torch.train, mpi_tpu_torch.ops, "
            "mpi_tpu_torch.ops.ring_collectives, mpi_tpu_torch.parallel, "
            "mpi_tpu_torch.parallel.mesh, mpi_tpu_torch.parallel.p2p, "
            "mpi_tpu_torch.parallel.collectives, mpi_tpu_torch.api, "
            "mpi_tpu_torch.collectives_generic, mpi_tpu_torch.runner, "
            "mpi_tpu_torch.backends.cuda, mpi_tpu_torch.backends.rendezvous, "
            "mpi_tpu_torch.examples.helloworld, "
            "mpi_tpu_torch.examples.bounce\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mpi_tpu'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "mpi_tpu_torch").rglob(
        "*.py"), *(ROOT / "mpi_tpu_torch").rglob("*.cu"),
        ROOT / "chip_smoke.py"]))
def test_port_sources_name_no_jax(path):
    hits = FORBIDDEN.findall((ROOT / path).read_text())
    assert not hits, f"{path}: {hits}"


def test_entry_points_raise_without_cuda(monkeypatch):
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.zeros((1, 4), dtype=torch.long)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, prompt, CFG, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(CFG, torch.Generator().manual_seed(0))
    init_state, _ = make_train_step(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_state(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--layers", "1", "--seq", "8", "--batch", "1",
                    "--steps", "2"])
    # Asking for the CPU by name is the one way onto it.
    assert generate(params, prompt, CFG, 2, device="cpu").shape == (1, 2)
    assert set(init_state(torch.Generator().manual_seed(0),
                          device="cpu")) == {"params", "opt"}


def test_driver_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_driver.CudaNetwork()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_driver.CudaNetwork(4, oversubscribe=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cuda_driver.run_spmd(lambda: None, n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(lambda: None, ["--mpi-ranks", "2"])
    # Asking for the CPU by name is the one way onto it.
    assert cuda_driver.run_spmd(lambda: 1, n=2, device="cpu") == [1, 1]
    assert run_main(lambda: 2, ["--mpi-ranks", "2",
                                "--mpi-device", "cpu"]) == [2, 2]


def test_no_environment_variable_moves_run_main_off_the_card(monkeypatch):
    """Only the program's own ``--mpi-device`` flag puts its ranks on the
    CPU: with the backend and rank count from the environment, as the JAX
    runner reads them, and a device named there too, ``run_main`` stays on
    CUDA, which raises here."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("MPI_TPU_BACKEND", "cuda")
    monkeypatch.setenv("MPI_TPU_RANKS", "2")
    monkeypatch.setenv("MPI_TPU_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_main(lambda: None, [])


def _code_of(src: str) -> str:
    """``src`` without comments and docstrings."""
    import ast
    import io
    import tokenize

    docs = set()
    for node in ast.walk(ast.parse(src)):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(
                body[0], ast.Expr) and isinstance(
                getattr(body[0], "value", None), ast.Constant) and isinstance(
                body[0].value.value, str):
            docs.add(body[0].lineno)
    out = []
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type == tokenize.COMMENT:
            continue
        if tok.type == tokenize.STRING and tok.start[0] in docs:
            continue
        out.append(tok.string)
    return " ".join(out)


def test_cuda_driver_never_synchronizes():
    """No path of the driver waits for the device on the host: the
    collectives order streams with events (wait_stream), and a host wait
    per collective would hide what the driver costs."""
    code = _code_of((ROOT / "mpi_tpu_torch" / "backends" /
                     "cuda.py").read_text())
    assert "wait_stream" in code
    for banned in ("synchronize", "cudaDeviceSynchronize", ".item (",
                   ".cpu ("):
        assert banned not in code, banned


def test_generate_refuses_params_on_another_device():
    params = init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="params lie on"):
        generate(params, torch.zeros((1, 4), dtype=torch.long), CFG, 2,
                 device="meta")


def test_decode_wrapper_never_falls_back_off_the_cpu():
    q = torch.empty((1, 4, 32), device="meta")
    k = torch.empty((1, 8, 4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        flash_decode_attention(q, k, k, 3)


def test_cpu_calls_are_not_counted_as_kernel_launches():
    before = flash_decode_attention.launches
    q = torch.randn(1, 4, 32)
    k = torch.randn(1, 8, 4, 32)
    flash_decode_attention(q, k, k, 3)
    assert flash_decode_attention.launches == before


def test_flash_wrappers_never_fall_back_off_the_cpu():
    q = torch.empty((1, 8, 4, 64), device="meta")
    rows = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        flash_bwd_dq(q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        flash_bwd_dkv(q, q, q, q, rows, rows)


def test_dq_delta_wrapper_never_falls_back_off_the_cpu():
    q = torch.empty((1, 8, 4, 64), device="meta")
    rows = torch.empty((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
        flash_bwd_dq_delta(q, q, q, q, rows, q)


def test_cpu_dq_delta_calls_are_not_counted_as_kernel_launches():
    before = flash_bwd_dq.launches
    q = torch.randn(1, 8, 4, 64)
    out, lse = flash_fwd(q, q, q)
    dq, delta = flash_bwd_dq_delta(q, q, q, q, lse, out)
    assert dq.shape == q.shape and delta.shape == (1, 4, 8)
    assert flash_bwd_dq.launches == before


def test_cuda_backward_takes_delta_from_kernel_2():
    """Past its CPU branch, flash_chunk_bwd computes no delta with torch
    ops: kernel 2 does, and kernel 3 reads it."""
    src = inspect.getsource(flash_chunk_bwd)
    cuda_path = src[src.index('== "cpu"'):].split("\n", 2)[2]
    assert "flash_bwd_dq_delta(" in cuda_path
    assert "_delta(" not in cuda_path.replace("flash_bwd_dq_delta(", "")


def test_cpu_flash_calls_are_not_counted_as_kernel_launches():
    wrappers = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    q = torch.randn(1, 8, 4, 64, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    assert q.grad is not None
    assert [w.launches for w in wrappers] == before


def test_collective_wrappers_never_fall_back_off_the_cpu():
    mesh = make_mesh(devices=["meta"] * 4)
    x = torch.empty((4, 8), device="meta")
    calls = [lambda: ring_allreduce(x, mesh),
             lambda: ring_allreduce_sharded(x, mesh),
             lambda: ring_allreduce_ranks(list(x)),
             lambda: ring_allgather(x, mesh),
             lambda: sendrecv(x, mesh, [(0, 1)]),
             lambda: sendrecv_sharded(x, mesh, [(0, 1)]),
             lambda: pcoll.ring_allreduce(x, mesh),
             lambda: pcoll.ring_reduce_scatter(x, mesh),
             lambda: pcoll.allgather(x, mesh),
             lambda: pcoll.pshift(x, mesh)]
    for call in calls:
        with pytest.raises(ValueError, match="cuda .kernel. or cpu"):
            call()


def test_cpu_collective_calls_are_not_counted_as_kernel_launches():
    wrappers = (ring_allreduce, ring_allgather, sendrecv)
    before = [w.launches for w in wrappers]
    mesh = make_mesh(devices=["cpu"] * 4)
    x = torch.randn(4, 8)
    ring_allreduce(x, mesh)
    ring_allreduce_sharded(torch.randn(4, 5), mesh)
    ring_allgather(x, mesh)
    ring_allgather_sharded(x, mesh)
    sendrecv(x, mesh, [(0, 1), (1, 0)])
    sendrecv_sharded(x, mesh, [(2, 3)])
    ring_allreduce_ranks(list(torch.randn(4, 5)))
    pcoll.ring_allreduce(x, mesh)
    pcoll.ring_reduce_scatter(x, mesh)
    pcoll.allgather(x, mesh)
    pcoll.pshift(x, mesh)
    assert [w.launches for w in wrappers] == before


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


CSRC = ROOT / "mpi_tpu_torch" / "ops" / "csrc"


def _c_function(src: str, name: str) -> str:
    """The text of the C++ function ``name`` in ``src``: its definition
    (the first ``name(`` followed by a body), braces matched."""
    for m in re.finditer(rf"\b{name}\s*\(", src):
        end = src.find(";", m.end())
        brace = src.find("{", m.end())
        if brace < 0 or (0 <= end < brace):
            continue  # a call or a declaration
        depth = 0
        for i in range(brace, len(src)):
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            if depth == 0:
                return src[m.start():i + 1]
    raise AssertionError(f"no definition of {name}")


@pytest.mark.parametrize("functions", [
    ("allreduce_kernel", "launch_allreduce", "allreduce_t", "ring_allreduce"),
    ("allgather_kernel", "launch_allgather", "ring_allgather")],
    ids=["allreduce", "allgather"])
def test_allreduce_kernel_is_one_ordinary_launch(functions):
    """Both ring kernels (all-reduce, all-gather) are one ordinary launch:
    no grid barrier, no cooperative launch."""
    src = (CSRC / "ring_collectives.cu").read_text()
    for name in functions:
        body = _c_function(src, name)
        for banned in ("this_grid", ".sync()", "cudaLaunchCooperativeKernel",
                       "launch_cooperative"):
            assert banned not in body, f"{name} uses {banned}"
    assert "<<<" in _c_function(src, functions[1])
    for gone in ("cooperative_groups", "launch_cooperative", "grid.sync"):
        assert gone not in src, f"ring_collectives.cu keeps {gone}"


def test_decode_kernel_uses_no_atomics():
    """Kernel 4 merges its splits in a fixed order through distributed
    shared memory, with no atomic, so two calls give the same bits."""
    src = (CSRC / "decode_attention.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    assert "atomic" not in code.lower()
    kernel = _c_function(code, "decode_attention_kernel")
    assert "cluster.sync()" in kernel and "map_shared_rank" in kernel
    launch = _c_function(code, "launch")
    assert "cudaLaunchAttributeClusterDimension" in launch
    assert "cudaLaunchKernelEx" in launch


def test_decode_launch_policy_matches_the_kernel_source():
    """The wrapper's copies of kernel 4's launch policy (threads a block,
    the load unit ``Shape::UNIT``, ``by_rows``' query rows a block, the
    largest cluster) agree with decode_attention.cu, read from its source
    so the CPU can check them."""
    src = (CSRC / "decode_attention.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", code)
        assert m, f"no constexpr {name}"
        return int(m.group(1))

    threads = const("kThreads")
    assert threads == decode_attention._KERNEL_THREADS
    assert const("kMaxSplits") == decode_attention._MAX_SPLITS
    vec = {dt: int(re.search(rf"struct Elem<{cty}> \{{.*?kVec = (\d+);",
                             code, re.DOTALL).group(1))
           for dt, cty in ((torch.float32, "float"),
                           (torch.bfloat16, "__nv_bfloat16"))}
    shape = re.search(r"struct Shape \{(.*?)\};", code, re.DOTALL).group(1)
    shape = " ".join(shape.split())
    cap = re.search(r"TPK = \(HD / VEC < (\d+)\) \? HD / VEC : (\d+);",
                    shape)
    assert cap and cap.group(1) == cap.group(2), "TPK's form changed"
    assert "NV = HD / (VEC * TPK);" in shape
    assert "KPP = kThreads / TPK;" in shape
    assert "UNIT = KPP * P;" in shape
    per = int(re.search(r"P = (\d+) / NV;", shape).group(1))
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128, 256):
            tpk = min(hd // vec[dtype], int(cap.group(1)))
            unit = threads // tpk * (per // (hd // (vec[dtype] * tpk)))
            assert decode_attention._load_unit(dtype, hd) == unit, \
                (dtype, hd)
    rows = _c_function(code, "by_rows")
    tests = re.findall(r"if \(group (==|<=) (\d+)\)\s*return launch<T, HD, "
                       r"(\d+)>", rows)
    last = re.findall(r"return launch<T, HD, (\w+)>", rows)[-1]
    assert [op for op, _, _ in tests] == ["==", "==", "<="], tests
    for group in range(1, 33):
        picked = next((int(r) for op, g, r in tests
                       if (group == int(g) if op == "==" else
                           group <= int(g))),
                      const(last) if last.startswith("k") else int(last))
        assert decode_attention._rows(group) == picked, group


def test_bf16_flash_forward_keeps_p_in_registers():
    src = (CSRC / "flash_attention.cu").read_text()
    consumer = _c_function(src, "fwd_consumer")
    assert "issue_s<D>" in consumer and "issue_pv<D>" in consumer
    assert "wgmma_rs_n" in _c_function(src, "wgmma_pv")
    assert "wgmma.mma_async" in _c_function(src, "wgmma_ss_n128")
    for banned in ("stash", "warp_gemm", "mma_bf16", "__shared__"):
        assert banned not in consumer, f"fwd_consumer uses {banned}"
    # The bf16 forward launches the wgmma kernel; the mma.sync forward body
    # takes float32 only.
    assert "flash_fwd_wgmma_kernel<D>" in _c_function(src, "fwd_bf16")
    assert "const float* __restrict__ q" in _c_function(src,
                                                         "flash_fwd_tile")


def test_bf16_flash_backward_multiplies_on_wgmma_in_registers():
    src = (CSRC / "flash_attention.cu").read_text()
    assert "wgmma.mma_async" in _c_function(src, "wgmma_ss_n64")
    assert "wgmma_ss_n64" in _c_function(src, "issue_ss64")
    assert "wgmma_pv<D>" in _c_function(src, "issue_pv")
    for name in ("dq_consumer", "dkv_consumer"):
        consumer = _c_function(src, name)
        assert "issue_ss64<D>" in consumer and "issue_pv<D, 4>" in consumer
        assert "pack_p(" in consumer
        for banned in ("stash", "warp_gemm", "mma_bf16", "__shared__"):
            assert banned not in consumer, f"{name} uses {banned}"
    for gone in ("mma_bf16", "ld_pair", "mma.sync.aligned"):
        assert gone not in src, f"the bf16 mma.sync path left {gone}"
    # The bf16 backward launches the wgmma kernels; the FMA bodies take
    # float32 only.
    for launcher, kernel in (("bwd_dq_bf16", "flash_bwd_dq_wgmma_kernel"),
                             ("bwd_dkv_bf16", "flash_bwd_dkv_wgmma_kernel")):
        launches = re.findall(r"(\w+)<D>\s*<<<",
                              _c_function(src, launcher))
        assert launches == [kernel], (launcher, launches)
    for name in ("flash_bwd_dq_tile", "flash_bwd_dkv_tile"):
        assert "const float* __restrict__ q" in _c_function(src, name)


def test_no_launch_sets_a_kernel_attribute():
    """cudaFuncSetAttribute runs once per device, in smem_limit_once, and
    in no launching function."""
    src = (CSRC / "flash_attention.cu").read_text()
    launchers = ("fwd_f32", "fwd_bf16", "bwd_dq_f32", "bwd_dq_bf16",
                 "bwd_dkv_f32", "bwd_dkv_bf16", "flash_fwd", "flash_bwd_dq",
                 "flash_bwd_dq_delta", "flash_bwd_dkv")
    for name in launchers:
        body = _c_function(src, name)
        assert "cudaFuncSetAttribute" not in body, name
    for name in launchers[:6]:
        assert "smem_limit_once(" in _c_function(src, name), name
    once = _c_function(src, "smem_limit_once")
    assert "cudaFuncSetAttribute" in once and "ready[dev]" in once
    assert src.count("cudaFuncSetAttribute(") == 1
