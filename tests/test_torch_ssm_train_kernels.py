"""The state-space LM's training on the card: kernel 6 on a gradient bucket
of the SSM's layout against its plain version, the data-parallel step
(its bucket summed on kernel 6) against the one-device step, and the twin
of ``examples/ssm.py`` with its sequence-parallel check. Skips where there
is no CUDA device (the kernels have no CPU mode); the CPU parity with the
JAX package is in ``test_torch_ssm_train.py``.

Tolerances, float32 with TF32 off: dp 8 against one device over three
AdamW steps, losses rtol 1e-4 (``chip_smoke.py``'s phase 9 for the
flagship's dp step: the ranks' gradients are summed in the ring's order,
not as one batch's, and AdamW's first update is about lr · sign(g), so the
parameters carry the rounding into the next losses). Kernel 6 is held
bitwise.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mpi_tpu_torch.models import (SsmConfig, init_ssm_params,
                                  make_ssm_train_step)
from mpi_tpu_torch.ops.ring_collectives import (ring_allreduce,
                                                ring_allreduce_plain)
from mpi_tpu_torch.parallel import make_mesh
from mpi_tpu_torch.parallel.zero import DpLayout, tree_leaves

ROOT = Path(__file__).resolve().parent.parent
CFG = SsmConfig(vocab=512, d_model=128, n_layers=2, d_state=64, d_ff=256)
DP = 8
STEPS = 3
LOSS_RTOL = 1e-4


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # Full-float32 plain path, restored after each test.
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _tokens(dev, b=8, s=65, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CFG.vocab, (b, s), generator=gen).to(dev)


@pytest.mark.cuda
def test_allreduce_on_the_ssm_bucket_matches_plain(cuda):
    """(8, width) float32, every leaf replicated in the dp layout."""
    leaves = tree_leaves(init_ssm_params(CFG, torch.Generator(), "meta"))
    layout = DpLayout([[(x.shape, None) for x in leaves]], DP)
    assert layout.width == -(-sum(x.numel() for x in leaves) // DP) * DP
    gen = torch.Generator(device=cuda).manual_seed(6)
    bucket = torch.randn(DP, layout.width, generator=gen, device=cuda)
    mesh = make_mesh(axis="dp", devices=[cuda] * DP)
    before = ring_allreduce.launches
    got = ring_allreduce(bucket, mesh)
    assert ring_allreduce.launches == before + 1
    assert torch.equal(got, ring_allreduce_plain(bucket))
    assert torch.equal(got, got[:1].expand_as(got))


@pytest.mark.cuda
def test_dp_step_matches_one_device(cuda):
    toks = _tokens(cuda)
    runs = {}
    for label, mesh in (("one", None),
                        ("dp", make_mesh(axis="dp", devices=[cuda] * DP))):
        init_state, step = make_ssm_train_step(CFG, mesh=mesh)
        state = init_state(torch.Generator().manual_seed(1), cuda)
        before = ring_allreduce.launches
        losses = [float(step(state, toks)[1]) for _ in range(STEPS)]
        torch.cuda.synchronize()
        runs[label] = (losses, ring_allreduce.launches - before, state)
    (one, one_k, _), (dp, dp_k, state) = runs["one"], runs["dp"]
    assert (one_k, dp_k) == (0, STEPS)
    assert state["step"] == STEPS
    assert all(x.device.type == "cuda" for x in tree_leaves(state["params"]))
    for a, b in zip(dp, one):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (dp, one)
    assert dp[-1] < dp[0]


@pytest.mark.cuda
def test_example_on_the_card(cuda):
    res = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.examples.ssm", "--sp", "4"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "ssm example OK" in res.stdout
