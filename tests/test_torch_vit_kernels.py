"""The Vision Transformer's attention on the card: kernels 1-3 at ViT-B/16's
head shape (196 patches, 12 heads of 64, non-causal) against their plain
versions, and a float32 ViT step with flash attention against the same
step with dense attention. Skips where there is no CUDA device (the
kernels have no CPU mode); the CPU parity with the JAX package is in
``test_torch_vit.py`` and ``test_torch_vit_sharded.py``.

Kernel tolerances are ``test_torch_flash_kernel.py``'s (its docstring gives
the reasons). s = 196 leaves kernel 1's last 128-row tile 68 valid rows and
the backward's last 64-row tile 4: every output row is held against the
plain version, and the inputs must keep every bit (no tile writes past
s). The step, float32 with TF32 off: losses atol = rtol = 1e-5 (summation
order), every gradient leaf within 1e-3 of its largest element
(``chip_smoke.py``'s TRAIN_GRAD_REL).
"""

import dataclasses

import pytest
import torch

from mpi_tpu_torch.models import (ViTConfig, init_vit_params,
                                  make_vit_train_step, vit_loss_fn)
from mpi_tpu_torch.ops.attention import (_delta, flash_attention_bwd_plain,
                                         flash_attention_fwd_plain,
                                         flash_bwd_dkv, flash_bwd_dq,
                                         flash_bwd_dq_delta, flash_fwd)
from mpi_tpu_torch.parallel.zero import tree_leaves

TOL = {torch.float32: {"out": (1e-5, 1e-5), "lse": (1e-5, 1e-5),
                       "grad": (1e-4, 1e-4)},
       torch.bfloat16: {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-3),
                        "grad": (2e-2, 2e-2)}}
DELTA_TOL = (1e-5, 1e-5)
LOSS = dict(atol=1e-5, rtol=1e-5)
GRAD_REL = 1e-3
# ViT-B/16's patches and heads at a narrow width: 224 / 16 = 14, 196 patches.
CFG = dict(image_size=224, patch_size=16, channels=3, n_classes=10,
           d_model=256, n_heads=4, n_layers=2, d_ff=512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-float32 plain path
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_vit_shape_match_plain(cuda, dtype):
    b, s, h, d = 2, 196, 12, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, g = (torch.randn(b, s, h, d, generator=gen, device=cuda)
                  .to(dtype) for _ in range(4))
    kept = [x.clone() for x in (q, k, v, g)]
    tol = TOL[dtype]
    out, lse = flash_fwd(q, k, v, False)
    ref, ref_lse = flash_attention_fwd_plain(q, k, v, False)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol["out"][0],
                               rtol=tol["out"][1])
    torch.testing.assert_close(lse, ref_lse, atol=tol["lse"][0],
                               rtol=tol["lse"][1])
    dq, delta = flash_bwd_dq_delta(q, k, v, g, ref_lse, ref, False)
    dk, dv = flash_bwd_dkv(q, k, v, g, ref_lse, _delta(ref, g), False)
    want = flash_attention_bwd_plain(q, k, v, ref, ref_lse, g, False)
    torch.cuda.synchronize()
    torch.testing.assert_close(delta, _delta(ref, g), atol=DELTA_TOL[0],
                               rtol=DELTA_TOL[1])
    for name, x, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert x.dtype == dtype and x.shape == w.shape, name
        torch.testing.assert_close(x.float(), w.float(),
                                   atol=tol["grad"][0], rtol=tol["grad"][1],
                                   msg=lambda m, n=name: f"{n}: {m}")
    for x, y in zip((q, k, v, g), kept):
        assert torch.equal(x, y)


def _step(dev, impl):
    """One float32 step from one seeded tree: (loss, gradients, launches of
    kernels 1, 2, 3)."""
    cfg = ViTConfig(**CFG, attention_impl=impl)
    params = init_vit_params(cfg, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(1)
    images = torch.randn(4, 224, 224, 3, generator=gen).to(dev)
    labels = torch.randint(0, 10, (4,), generator=gen).to(dev)
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    wrappers = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    before = [w.launches for w in wrappers]
    loss = vit_loss_fn(params, (images, labels), cfg)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return (loss.item(), grads,
            [w.launches - c for w, c in zip(wrappers, before)])


@pytest.mark.cuda
def test_vit_step_on_the_flash_kernels_matches_dense(cuda):
    loss, grads, launches = _step(cuda, "flash")
    dense, dense_grads, none = _step(cuda, "dense")
    assert launches == [CFG["n_layers"]] * 3 and none == [0, 0, 0]
    torch.testing.assert_close(torch.tensor(loss), torch.tensor(dense),
                               **LOSS)
    for a, b in zip(grads, dense_grads):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        assert torch.isfinite(a).all() and rel <= GRAD_REL, rel
    # And a bf16 step trains: the loss falls over three AdamW steps.
    cfg = dataclasses.replace(ViTConfig(**CFG, attention_impl="flash"),
                              dtype=torch.bfloat16)
    init_state, step = make_vit_train_step(cfg, learning_rate=1e-3)
    state = init_state(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = (torch.randn(4, 224, 224, 3, generator=gen),
             torch.randint(0, 10, (4,), generator=gen))
    losses = [float(step(state, batch)[1]) for _ in range(3)]
    assert losses[-1] < losses[0], losses
