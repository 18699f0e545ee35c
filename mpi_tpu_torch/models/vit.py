"""Vision Transformer: the encoder (bidirectional) model family.

Counterpart of ``mpi_tpu/models/vit.py``. The blocks are the flagship's
(:func:`~.transformer.block_body` under ``TransformerConfig(causal=False)``,
so with ``attention_impl="flash"`` kernels 1-3 run their non-causal grid),
with the image-side pieces around them: the images cut into patches and
projected in, a learned position table, the patches mean-pooled (there is
no class token) and a linear classification head out. The parameter tree
is the JAX package's (:func:`vit_params_from_jax` carries it over).

Over a mesh the blocks split as the flagship's do (:func:`vit_param_specs`:
heads and d_ff over ``tp``, the reductions on kernel 6; the patch
projection and the head replicated), the sequence-parallel impls run over
``sp``, and a ``dp`` axis above 1 runs every row in one pass: the
parameters are replicated over dp, so that pass gives the JAX package's
global loss and gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import RankMesh
from ..utils.platform import resolve_device
from .convert import _tensor
from .transformer import (TransformerConfig, _layernorm, block_body,
                          check_mesh, init_params, make_optimizer,
                          param_specs, sane_specs, token_xent, train_state)

__all__ = ["ViTConfig", "init_vit_params", "forward_vit", "vit_loss_fn",
           "vit_param_specs", "make_vit_train_step", "vit_params_from_jax"]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Same fields and defaults as the JAX package's config, with torch
    dtypes. ``attention_impl`` is the encoder stack's (see
    :class:`~.transformer.TransformerConfig`; the zigzag layouts are
    causal-only and raise)."""

    image_size: int = 32
    patch_size: int = 4
    channels: int = 3
    n_classes: int = 10
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "dense"
    remat: bool = False
    n_kv_heads: Optional[int] = None

    def __post_init__(self):
        if self.image_size % self.patch_size:
            raise ValueError(
                f"mpi_tpu_torch: image_size {self.image_size} not divisible "
                f"by patch_size {self.patch_size}")

    @property
    def n_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side

    @property
    def inner(self) -> TransformerConfig:
        """The encoder stack's config, which the shared blocks run under."""
        return TransformerConfig(
            vocab=1,  # unused: no token embedding
            d_model=self.d_model, n_heads=self.n_heads,
            n_layers=self.n_layers, d_ff=self.d_ff,
            max_seq=self.n_patches, dtype=self.dtype,
            param_dtype=self.param_dtype,
            attention_impl=self.attention_impl, remat=self.remat,
            n_kv_heads=self.n_kv_heads, causal=False)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Any]:
    """The parameter tree from ``generator``, on ``device`` (the CUDA
    device unless the caller names another): the encoder blocks, final
    norm and position table of :func:`~.transformer.init_params` (whose
    token embedding is dropped; its table of ``n_patches`` rows holds the
    patch positions), the patch projection ``(p·p·C, d)`` and the head
    ``{"w": (d, n_classes), "b"}``. Weights are ``N(0, 1) /
    sqrt(fan_in)``; the draws differ from ``jax.random``'s. On the
    ``"meta"`` device nothing is drawn: the tree gives the shapes alone."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    params = init_params(cfg.inner, generator, dev)
    del params["embed"]  # images enter through the patch projection

    def dense(shape, fan_in):
        if dev.type == "meta":
            return torch.empty(shape, dtype=pd, device=dev)
        w = torch.randn(shape, generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=pd)

    pdim = cfg.patch_size * cfg.patch_size * cfg.channels
    params["patch"] = dense((pdim, cfg.d_model), pdim)
    params["head"] = {"w": dense((cfg.d_model, cfg.n_classes), cfg.d_model),
                      "b": torch.zeros(cfg.n_classes, dtype=pd, device=dev)}
    return params


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(b, H, W, C) → (b, n_patches, p·p·C), patches in row-major order."""
    b, H, W, C = images.shape
    if (H, W, C) != (cfg.image_size, cfg.image_size, cfg.channels):
        raise ValueError(
            f"mpi_tpu_torch: expected {cfg.image_size}x{cfg.image_size}x"
            f"{cfg.channels} images, got {H}x{W}x{C}")
    p = cfg.patch_size
    x = images.reshape(b, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, cfg.n_patches, p * p * C)


def forward_vit(params: Dict[str, Any], images: torch.Tensor, cfg: ViTConfig,
                mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """Float32 class logits ``(b, n_classes)`` of ``(b, H, W, C)`` images,
    on the device the parameters lie on. With ``cfg.remat`` each block is
    recomputed in the backward pass (``torch.utils.checkpoint``)."""
    inner = cfg.inner
    check_mesh(mesh, inner, embedding=False)
    dt = cfg.dtype
    x = _patchify(images.to(device=params["patch"].device, dtype=dt), cfg)
    x = x @ params["patch"].to(dt) + params["pos"].to(dt)[None]
    for blk in params["blocks"]:
        if cfg.remat:
            x, _ = checkpoint(block_body, x, blk, inner, mesh,
                              use_reentrant=False)
        else:
            x, _ = block_body(x, blk, inner, mesh)
    x = _layernorm(x, params["final_ln"]["scale"].to(dt),
                   params["final_ln"]["bias"].to(dt))
    pooled = x.mean(dim=1)  # mean-pool over the patches
    logits = pooled @ params["head"]["w"].to(dt) + params["head"]["b"].to(dt)
    return logits.float()


def vit_loss_fn(params: Dict[str, Any],
                batch: Tuple[torch.Tensor, torch.Tensor], cfg: ViTConfig,
                mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """Mean softmax cross-entropy over ``(images, int labels)``."""
    images, labels = batch
    logits = forward_vit(params, images, cfg, mesh)
    return token_xent(logits, labels.to(logits.device))


def vit_param_specs(cfg: ViTConfig, params: Any,
                    mesh: Optional[RankMesh]) -> Any:
    """The spec of every leaf of ``params``, sanitized against ``mesh``:
    the blocks' from :func:`~.transformer.param_specs` (tp on heads and
    d_ff), the position table and final norm replicated, the patch
    projection and the head replicated. Raises ``KeyError`` where the
    tree has a leaf the specs lack."""
    specs = param_specs(cfg.inner)
    del specs["embed"]
    specs["patch"] = ()
    specs["head"] = {"w": (), "b": ()}
    return sane_specs(specs, params, mesh)


def make_vit_train_step(cfg: ViTConfig, mesh: Any = None,
                        learning_rate: float = 1e-3,
                        optimizer: str = "adamw"):
    """``(init_state, step)`` of classifier training, on one device.

    ``init_state(generator, device=None)`` draws fresh parameters
    (:func:`init_vit_params`) and returns ``{"params", "opt"}``, the
    optimizer :func:`~.transformer.make_optimizer`'s rule over every leaf;
    ``init_state.from_params(params)`` builds the state around a given tree
    (from :func:`vit_params_from_jax`, say). Over a mesh the state also
    holds it (``"mesh"``) and the parameters' specs (``"specs"``,
    :func:`vit_param_specs`), from which
    :func:`~.transformer.rank_state` reads the tp split. ``step(state,
    (images, labels)) -> (state, loss)`` runs one optimizer step and
    updates the state in place (the JAX step returns a new state);
    ``loss`` is a 0-dim float32 tensor on the device. See the module note
    for the mesh."""
    check_mesh(mesh, cfg.inner, embedding=False)
    build = make_optimizer(optimizer, learning_rate)

    def from_params(params: Dict[str, Any]) -> Dict[str, Any]:
        return train_state(params, build, mesh,
                           lambda p, m: vit_param_specs(cfg, p, m))

    def init_state(generator: torch.Generator,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
        return from_params(init_vit_params(cfg, generator, device))

    def step(state: Dict[str, Any],
             batch: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[Dict[str, Any], torch.Tensor]:
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = vit_loss_fn(state["params"], batch, cfg, mesh)
        loss.backward()
        opt.step()
        return state, loss.detach()

    init_state.from_params = from_params
    return init_state, step


def vit_params_from_jax(tree: Any, cfg: ViTConfig,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, Any]:
    """The port's parameters from the JAX package's ViT tree (its
    ``init_vit_params`` or a train state's ``"params"``), whose arrays the
    caller has turned into numpy arrays: each leaf a ``cfg.param_dtype``
    tensor on ``device`` (the CUDA device unless the caller names another).
    Raises ``ValueError`` if the tree's keys, layer count or any leaf's
    shape (the patch projection, the position table, every block's)
    disagree with ``cfg``."""
    dev = resolve_device(device)

    def walk(node: Any, want: Any, where: str) -> Any:
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else \
                    type(node).__name__
                raise ValueError(f"mpi_tpu_torch: ViT tree at {where or '/'}"
                                 f" holds {got}; cfg wants {sorted(want)}")
            return {k: walk(v, want[k], f"{where}/{k}")
                    for k, v in node.items()}
        if isinstance(want, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(want):
                got = len(node) if isinstance(node, (list, tuple)) else \
                    type(node).__name__
                raise ValueError(f"mpi_tpu_torch: ViT tree has {got} blocks;"
                                 f" cfg wants {len(want)} layers")
            return [walk(v, w, f"{where}/{i}")
                    for i, (v, w) in enumerate(zip(node, want))]
        t = _tensor(node, dev, cfg.param_dtype)
        if t.shape != want.shape:
            raise ValueError(f"mpi_tpu_torch: ViT tree's {where} has shape "
                             f"{tuple(t.shape)}; cfg wants "
                             f"{tuple(want.shape)}")
        return t

    shapes = init_vit_params(cfg, torch.Generator(), "meta")
    return walk(tree, shapes, "")
