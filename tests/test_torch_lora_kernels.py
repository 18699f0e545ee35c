"""LoRA fine-tuning on the card: adapter-only steps with attention on the
flash kernels (1-3) against the same steps with dense attention, over one
device and a tp mesh of the card's ranks (kernel 6), and the merged tree
served through ``generate`` on kernel 4 against the CPU. Skips where
there is no CUDA device (the kernels have no CPU mode); the CPU parity
with the JAX package is in ``test_torch_lora.py``.

float32 throughout, TF32 off. Losses are compared over ten steps, not
every adapter element: AdamW's first update is about lr · sign(g), so a
rounding flip of a near-zero gradient's sign moves its element by 2 lr.
Losses atol = rtol = 1e-5: summation order, as
``test_torch_tensor_parallel_kernels.py`` explains. The size of kernels
2-3's gradients is held directly: the adapter gradients at the trained
adapters (every B non-zero), flash against dense, each leaf within 1e-3
of its largest element (``chip_smoke.py``'s TRAIN_GRAD_REL).
"""

import pytest
import torch

from mpi_tpu_torch.models import (TransformerConfig, generate, init_params,
                                  loss_fn, make_lora_train_step, merge_lora)
from mpi_tpu_torch.ops.attention import (flash_bwd_dkv, flash_bwd_dq,
                                         flash_fwd)
from mpi_tpu_torch.ops.decode_attention import flash_decode_attention
from mpi_tpu_torch.ops.ring_collectives import ring_allreduce
from mpi_tpu_torch.parallel import RankMesh
from mpi_tpu_torch.parallel.zero import tree_leaves, tree_with_leaves

LOSS = dict(atol=1e-5, rtol=1e-5)
CFG = dict(vocab=64, d_model=256, n_heads=4, n_layers=2, d_ff=256,
           max_seq=65, decode_attention="flash")
STEPS = 10
GRAD_REL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


def _train(dev, impl, tp=1):
    """(losses, merged tree, launches of kernels 1, 2, 3 and 6 a step,
    the base, the trained adapters, the tokens)."""
    cfg = TransformerConfig(**CFG, attention_impl=impl)
    base = init_params(cfg, torch.Generator().manual_seed(0), dev)
    mesh = None if tp == 1 else RankMesh([dev] * tp, ("dp", "sp", "tp"),
                                         (1, 1, tp))
    init_state, step = make_lora_train_step(cfg, base, rank=8, mesh=mesh,
                                            learning_rate=1e-2)
    state = init_state(torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (4, cfg.max_seq),
                           generator=torch.Generator().manual_seed(2)
                           ).to(dev)
    wrappers = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, ring_allreduce)
    losses, launches = [], []
    for _ in range(STEPS):
        before = [w.launches for w in wrappers]
        state, loss = step(state, tokens)
        losses.append(float(loss))
        launches.append([w.launches - b for w, b in zip(wrappers, before)])
    with torch.no_grad():
        merged = merge_lora(base, state["lora"])
    return losses, merged, launches, base, state["lora"], tokens


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 4])
def test_lora_steps_on_the_flash_kernels_match_dense(cuda, tp):
    losses, _, launches, *_ = _train(cuda, "flash", tp)
    dense = _train(cuda, "dense")[0]
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(dense),
                               **LOSS)
    assert losses[-1] < losses[0]
    # Counted from the code: kernels 1-3 once a layer; over tp, kernel 6 4
    # times a layer and 3 more (the copy before layer 0's q/k/v is not
    # differentiated: its input, the frozen embedding, needs no gradient).
    layers = CFG["n_layers"]
    k6 = 0 if tp == 1 else 4 * layers + 3
    assert launches == [[layers, layers, layers, k6]] * STEPS


@pytest.mark.cuda
def test_adapter_gradients_on_the_flash_kernels_match_dense(cuda):
    _, _, _, base, lora, tokens = _train(cuda, "flash")
    leaves = tree_leaves(lora["blocks"])
    grads = {}
    for impl in ("flash", "dense"):
        cfg = TransformerConfig(**CFG, attention_impl=impl)
        loss = loss_fn(merge_lora(base, lora), tokens, cfg)
        grads[impl] = torch.autograd.grad(loss, leaves)
    for got, want in zip(grads["flash"], grads["dense"]):
        assert torch.isfinite(got).all()
        gap = (got - want).abs().max() / want.abs().max()
        assert gap <= GRAD_REL, gap


@pytest.mark.cuda
def test_merged_tree_served_on_kernel_4_matches_the_cpu(cuda):
    merged = _train(cuda, "flash")[1]
    cfg = TransformerConfig(**CFG)
    prompt = torch.randint(0, cfg.vocab, (4, 16),
                           generator=torch.Generator().manual_seed(3))
    before = flash_decode_attention.launches
    got = generate(merged, prompt, cfg, 12)
    assert flash_decode_attention.launches - before == cfg.n_layers * 11
    on_cpu = tree_with_leaves(merged, (x.cpu() for x in tree_leaves(merged)))
    want = generate(on_cpu, prompt, cfg, 12, device="cpu")
    assert torch.equal(got.cpu(), want)
