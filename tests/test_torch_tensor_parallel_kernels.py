"""Tensor-parallel training on the card: the model split over 4 tp ranks of
one CUDA device (kernel 6 runs every tp reduction, kernels 1-3 the
attention over all heads), and over (dp 2, tp 4), against the same steps
on the CPU (the kernels' plain versions), under sgd (constant and on the
warmup-cosine schedule), AdamW and adafactor. Skips where there is no CUDA
device (the kernels have no CPU mode); the CPU parity with the JAX package
is in ``test_torch_tensor_parallel.py`` and ``test_torch_optimizers.py``.

Tolerances, float32 and from summation order (cuBLAS and the flash
kernels against the CPU's products): losses atol = rtol = 1e-5,
parameters after three sgd steps atol 1e-4, rtol 1e-5, as
``test_torch_train.py`` explains. AdamW's and adafactor's first update is
about lr·sign(g) elementwise, so a gradient element near 0 whose rounding
differs moves its parameter by up to 2 lr (measured on the card: one
element of 65536 by 1.3e-4): their runs compare the losses, which such an
element does not move, and not each parameter.
"""

import pytest
import torch

from mpi_tpu_torch.models import TransformerConfig, make_train_step
from mpi_tpu_torch.models.transformer import full_params
from mpi_tpu_torch.ops.attention import flash_fwd
from mpi_tpu_torch.ops.ring_collectives import ring_allreduce
from mpi_tpu_torch.parallel import RankMesh
from mpi_tpu_torch.parallel.zero import tree_leaves

LOSS = dict(atol=1e-5, rtol=1e-5)
PARAMS = dict(atol=1e-4, rtol=1e-5)
CFG = TransformerConfig(vocab=64, d_model=256, n_heads=4, n_layers=2,
                        d_ff=256, max_seq=65, attention_impl="flash")
SGD = {"optimizer": "sgd"}
COSINE = {"warmup_steps": 1, "total_steps": 4}
CASES = {  # name -> (mesh shape (dp, sp, tp), make_train_step options)
    "tp4-sgd": ((1, 1, 4), SGD),
    "dp2-tp4-fsdp-sgd": ((2, 1, 4), {"fsdp": True, **SGD}),
    "tp4-sgd-cosine": ((1, 1, 4), {**SGD, **COSINE}),
    "tp4-adamw": ((1, 1, 4), {}),
    "tp4-adafactor-cosine": ((1, 1, 4), {"optimizer": "adafactor",
                                         **COSINE}),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


def _train(dev, case, steps=3):
    """(losses, full parameters, launches of kernels 1 and 6 a step)."""
    shape, kw = CASES[case]
    mesh = RankMesh([dev] * (shape[0] * shape[1] * shape[2]),
                    ("dp", "sp", "tp"), shape)
    init_state, step = make_train_step(CFG, mesh=mesh, **kw)
    state = init_state(torch.Generator().manual_seed(0), dev)
    tokens = torch.randint(0, CFG.vocab, (4, CFG.max_seq),
                           generator=torch.Generator().manual_seed(1))
    losses, launches = [], []
    for _ in range(steps):
        before = (flash_fwd.launches, ring_allreduce.launches)
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append((flash_fwd.launches - before[0],
                         ring_allreduce.launches - before[1]))
    return (losses, [x.detach().cpu() for x in
                     tree_leaves(full_params(state))], launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_tp_step_on_the_card_matches_the_cpu(cuda, case):
    losses, params, launches = _train(cuda, case)
    want_losses, want_params, _ = _train(torch.device("cpu"), case)
    torch.testing.assert_close(torch.tensor(losses),
                               torch.tensor(want_losses), **LOSS)
    if CASES[case][1].get("optimizer") == "sgd":
        for got, want in zip(params, want_params):
            torch.testing.assert_close(got, want, **PARAMS)
    # Counted from the code: each dp rank runs kernel 1 once per layer and
    # kernel 6 four times per layer (the reductions after wo and w2, the
    # copies' backward before the projections and w1) and four times more
    # (the embedding, the logits' copy, the row max, the sums of the loss);
    # a dp mesh adds its bucket's reduce-scatter.
    dp = CASES[case][0][0]
    per_rank = 4 * CFG.n_layers + 4
    assert launches == [(dp * CFG.n_layers,
                         dp * per_rank + (dp > 1))] * 3
