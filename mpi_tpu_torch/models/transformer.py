"""Decoder-only Transformer LM: forward, loss and training.

Counterpart of ``mpi_tpu/models/transformer.py``: the config, the parameter
tree, the forward pass, the next-token loss and one training step
(AdamW, adafactor or sgd, at a constant rate or on optax's schedules).
The parameter tree and the einsum layouts are the JAX package's (``wq (d,
h, hd)``, ``wo (h, hd, d)``, ...), so the JAX tree loads as it is
(:mod:`.convert`) and the two compute the same thing. Every
``attention_impl`` of the JAX package runs: ``flash`` on the
flash-attention kernels (:mod:`..ops.attention`), ``blockwise`` in plain
PyTorch, and the long-context impls (ring, zigzag and Ulysses, fold or
flash chunks) over the ``sp`` axis of a :class:`RankMesh`
(:mod:`..parallel.ring_attention`, :mod:`..parallel.ulysses`).

**The mesh.** The ranks of a :class:`RankMesh` share one device, row-major
over its axes (``("dp", "sp", "tp")`` from :func:`make_mesh_nd`). The
sequence-parallel impls communicate over its ``sp`` axis (kernel 7 for the
ring's hops). A ``tp`` axis above 1 splits the model Megatron-style, as
:func:`param_specs` lays it out, with the reductions that GSPMD inserts in
the JAX package run explicitly on kernel 6
(:mod:`..parallel.tensor_parallel`): tp rank r projects with its heads'
columns of wq, wk and wv and its d_ff columns of w1 (one einsum with an
explicit tp dimension each, their input through ``tp_copy``), contracts
its heads with its rows of wo and its d_ff with its rows of w2 into
partials that ``tp_reduce`` sums, looks up the tokens of its vocab range,
and computes the logits of its vocab range, whose cross-entropy is
vocab-parallel. Attention itself needs no communication and stays one
launch over all heads. The parameters stay whole tensors; each tp rank
reads its slice as a view, so a sharded leaf's gradient is the ranks'
disjoint slices, and a replicated leaf (the norms, the position table) is
read once, on the activation every tp rank shares, so its gradient is
counted once.

A training step over a mesh whose ``dp`` axis is above 1 is
data-parallel: dp rank r computes the loss of its own rows of the batch,
``tokens[r·b/dp:(r+1)·b/dp]`` (the JAX package's ``P('dp', 'sp')`` split),
over its own (sp, tp) sub-mesh, with its own tp reductions, and its
gradient becomes row r of a ``(dp, m)`` float32 bucket. Kernel 6 then
reduces the bucket over the dp ring
(:func:`~mpi_tpu_torch.parallel.mesh.axis_ring`) and the optimizer updates
the parameters; with ``zero1`` the reduction is a reduce-scatter, each
rank updates its shard with its shard of the optimizer state (adafactor,
whose rule reduces over whole leaves: each leaf put back together from
its ranks' shards, its moments whole), and kernel 5 gathers the
parameters; with ``fsdp`` the parameters live as shards
between steps and kernel 5 gathers each block's weights just before the
block runs (:mod:`..parallel.zero` holds the layouts; dp claims the first
dimension tp leaves free, ``wo (h, hd, d)`` dimension 1 under tp). The
returned loss is the mean of the ranks' losses. The optimizers are
optax's rules (:mod:`.optimizers`). A mesh over several distinct devices
raises ``NotImplementedError`` (the NVLink peer path of kernels 5-7).

**Mixture of Experts.** With ``n_experts > 0`` each block's FFN is the
routed top-k expert FFN of :mod:`.moe`, and the blocks carry the aux
statistics out (each expert's fraction of first choices and its mean
router probability), from which the loss adds ``moe_aux_coef`` times the
load-balance penalty summed over the layers. An ``ep`` axis above 1 splits
the experts over its ranks and a ``tp`` axis each expert's d_ff, the ep ×
tp ranks' partial outputs summed in one kernel-6 launch. The
penalty is the JAX package's over the whole batch: under dp the fractions
are the global batch's (every dp rank's forward first, then the ranks'
fractions summed over the dp ring on kernel 6, then the backwards: the
fractions carry no gradient, so each rank's penalty with the global
fractions and its own probabilities gives the global penalty and its
gradient as the mean over the ranks), and ``grad_accum`` takes JAX's
microbatches (consecutive rows of the global batch, each split over dp).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (blockwise_attention, dense_attention,
                             flash_attention)
from ..ops.ring_collectives import ring_allgather, ring_allreduce
from ..parallel.collectives import ring_reduce_scatter
from ..parallel.mesh import RankMesh, axis_ring, axis_slice, mesh_devices
from ..parallel.ring_attention import ring_attention_sharded
from ..parallel.zero import (DpLayout, allreduce_grads, fsdp_specs,
                             grad_bucket, pieces_view, spec_dim, spec_leaves,
                             tree_leaves, tree_with_leaves, unshard,
                             zero1_specs)
from ..parallel.tensor_parallel import (tp_copy, tp_reduce, tp_ring,
                                        tp_size, vocab_parallel_embed,
                                        vocab_parallel_xent)
from ..parallel.ulysses import ulysses_attention_sharded
from ..utils.platform import resolve_device
from .moe import aux_loss, init_moe_params, moe_parts
from .optimizers import build_optimizer, learning_rate_schedule

__all__ = ["TransformerConfig", "init_params", "param_specs", "sanitize_spec",
           "sane_specs", "sane_param_specs", "forward", "forward_with_aux",
           "apply_rope", "block_body", "token_xent", "loss_fn",
           "make_optimizer", "train_state", "make_train_parts",
           "make_train_step", "full_params", "rank_state", "make_mesh_nd"]

# The sequence-parallel attention impls: they run over a mesh's sp axis.
_SP_IMPLS = ("ring", "ring_flash", "zigzag", "zigzag_flash", "ulysses",
             "ulysses_flash")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as the JAX package's config, with torch
    dtypes. ``attention_impl`` is the full-sequence attention: ``"dense"``
    (the oracle), ``"flash"`` (the flash-attention kernels, forward and
    backward), ``"blockwise"``, or, over a mesh's ``sp`` axis, ``"ring"``,
    ``"ring_flash"``, ``"zigzag"``, ``"zigzag_flash"``, ``"ulysses"`` and
    ``"ulysses_flash"``; ``decode_attention`` is the single-token decode
    step's: ``"dense"`` (einsum chain, the oracle) or ``"flash"`` (the
    flash-decode kernel). Prefill always takes the dense cached path."""

    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 128
    dtype: torch.dtype = torch.float32        # compute dtype
    param_dtype: torch.dtype = torch.float32  # stored parameters
    attention_impl: str = "dense"
    decode_attention: str = "dense"
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_top_k: int = 1
    remat: bool = False
    n_kv_heads: Optional[int] = None
    rope: bool = False
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"mpi_tpu_torch: d_model {self.d_model} not "
                             f"divisible by n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        kv = self.n_heads if self.n_kv_heads is None else self.n_kv_heads
        if not 1 <= kv <= self.n_heads or self.n_heads % kv:
            raise ValueError(
                f"mpi_tpu_torch: n_kv_heads={kv} must divide n_heads="
                f"{self.n_heads}")
        return kv


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict[str, Any]:
    """Initialise the parameter tree (plain dicts and a list of blocks, the
    JAX package's layout) from ``generator``, on ``device`` (the CUDA
    device unless the caller names another). Weights are
    ``N(0, 1) / sqrt(fan_in)``; the draws differ from ``jax.random``'s.
    With ``n_experts > 0`` a block holds the experts' tree (``"moe"``,
    :func:`~mpi_tpu_torch.models.moe.init_moe_params`) in place of ``w1``
    and ``w2``. On the ``"meta"`` device the weights are drawn from
    nothing: the tree gives the shapes alone."""
    dev = resolve_device(device)
    pd = cfg.param_dtype

    def dense(shape, fan_in):
        if dev.type == "meta":  # shapes alone: nothing to draw
            return torch.empty(shape, dtype=pd, device=dev)
        w = torch.randn(shape, generator=generator,
                        device=generator.device) / math.sqrt(fan_in)
        return w.to(device=dev, dtype=pd)

    def ones(n):
        return torch.ones(n, dtype=pd, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=pd, device=dev)

    d, h, f = cfg.d_model, cfg.n_heads, cfg.d_ff
    hd, kv = cfg.head_dim, cfg.kv_heads
    params: Dict[str, Any] = {
        "embed": dense((cfg.vocab, d), d),
        "final_ln": {"scale": ones(d), "bias": zeros(d)},
        "blocks": [],
    }
    if not cfg.rope:  # rope needs no learned position table
        params["pos"] = dense((cfg.max_seq, d), d)
    for _ in range(cfg.n_layers):
        blk = {
            "ln1": {"scale": ones(d), "bias": zeros(d)},
            "ln2": {"scale": ones(d), "bias": zeros(d)},
            "wq": dense((d, h, hd), d),
            "wk": dense((d, kv, hd), d),
            "wv": dense((d, kv, hd), d),
            "wo": dense((h, hd, d), d),
        }
        if cfg.n_experts > 0:
            blk["moe"] = init_moe_params(d, f, cfg.n_experts, pd, generator,
                                         dev)
        else:
            blk["w1"] = dense((d, f), d)
            blk["w2"] = dense((f, d), f)
        params["blocks"].append(blk)
    return params


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The spec of every leaf of :func:`init_params`'s tree, as the JAX
    package gives them, each a plain tuple with one entry per dimension (a
    mesh axis or None; ``()`` is replicated). The Megatron-style tp split:
    q, k and v column-parallel over heads, wo row-parallel, w1 column- and
    w2 row-parallel over d_ff, the embedding vocab-sharded; norms and the
    position table replicated. With experts the block holds the JAX tree's
    MoE entries (experts over ``ep``, each expert's d_ff over ``tp``)."""
    blk: Dict[str, Any] = {
        "ln1": {"scale": (), "bias": ()},
        "ln2": {"scale": (), "bias": ()},
        "wq": (None, "tp", None),
        "wk": (None, "tp", None),
        "wv": (None, "tp", None),
        "wo": ("tp", None, None),
    }
    if cfg.n_experts > 0:
        blk["moe"] = {"router": (), "w1e": ("ep", None, "tp"),
                      "w2e": ("ep", "tp", None)}
    else:
        blk["w1"] = (None, "tp")
        blk["w2"] = ("tp", None)
    specs: Dict[str, Any] = {
        "embed": ("tp", None),
        "final_ln": {"scale": (), "bias": ()},
        "blocks": [dict(blk) for _ in range(cfg.n_layers)],
    }
    if not cfg.rope:
        specs["pos"] = ()
    return specs


def sanitize_spec(spec: Tuple[Any, ...],
                  mesh: Optional[RankMesh]) -> Tuple[Any, ...]:
    """``spec`` with the axis names ``mesh`` lacks dropped (replicated
    there), so one set of specs fits any mesh shape."""
    if mesh is None:
        return tuple(spec)
    return tuple(p if p in mesh.axis_names else None for p in spec)


def sane_specs(specs: Any, params: Any, mesh: Optional[RankMesh]) -> Any:
    """The spec tree ``specs`` laid out as ``params``'s tree, matched by
    key (a tree in any key order fits), every spec sanitized against
    ``mesh``."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {key: walk(value, spec[key]) for key, value in node.items()}
        if isinstance(node, list):
            return [walk(value, sub) for value, sub in zip(node, spec)]
        return sanitize_spec(spec, mesh)

    return walk(params, specs)


def sane_param_specs(cfg: TransformerConfig, params: Any,
                     mesh: Optional[RankMesh]) -> Any:
    """:func:`param_specs` through :func:`sane_specs`."""
    return sane_specs(param_specs(cfg), params, mesh)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _layernorm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding: rotate each half-dim pair of ``x``
    ``(b, s, h, hd)`` by its position's phase. ``positions`` is ``(s,)``
    global positions. Phases in float32, result cast back to x's dtype."""
    hd = x.shape[-1]
    if hd % 2:
        raise ValueError(f"mpi_tpu_torch: rope needs an even head_dim, "
                         f"got {hd}")
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions.to(torch.float32)[:, None] * freqs  # (s, half)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def repeat_kv_heads(k, v, cfg: TransformerConfig):
    """Expand GQA k/v ``(b, s, kv_heads, hd)`` to ``n_heads`` for every
    full-sequence attention but ``flash``, as the JAX package does: those
    expect equal head counts."""
    group = cfg.n_heads // cfg.kv_heads
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    return k, v


def _attention(x, blk, cfg: TransformerConfig,
               mesh: Optional[RankMesh] = None,
               ring: Optional[RankMesh] = None):
    """Multi-head attention over the tp ranks of ``ring``: rank r projects
    ``x`` with its heads' columns of wq, wk and wv (heads ``[r·h/tp,
    (r+1)·h/tp)``, kv heads likewise), the attention runs over all heads in
    one call, and rank r contracts its heads with its rows of wo into a
    partial that :func:`tp_reduce` sums."""
    s = x.shape[1]
    tp = tp_size(ring)
    xs = tp_copy(x, ring)

    def heads(w):  # (d, heads, hd) -> (b, s, heads, hd), rank-major heads
        return torch.einsum("tbsd,dthk->bsthk", xs,
                            w.to(x.dtype).unflatten(1, (tp, -1))).flatten(2, 3)

    q, k, v = heads(blk["wq"]), heads(blk["wk"]), heads(blk["wv"])
    if cfg.rope:
        # Global positions, applied before any sequence sharding: the
        # ring and zigzag layouts then carry already-rotated values.
        pos = torch.arange(s, dtype=torch.int32, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    impl = cfg.attention_impl
    if impl != "flash":
        # The flash kernels read grouped kv heads natively: no repeat.
        k, v = repeat_kv_heads(k, v, cfg)
    if impl == "flash":
        ctx = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              cfg.causal)
    elif impl == "dense":
        ctx = dense_attention(q, k, v, causal=cfg.causal)
    elif impl == "blockwise":
        ctx = blockwise_attention(q, k, v, causal=cfg.causal)
    elif mesh is None and impl in _SP_IMPLS:
        raise ValueError(f"mpi_tpu_torch: attention_impl={impl!r} needs a "
                         f"mesh with an 'sp' axis")
    elif impl in ("ring", "zigzag", "ring_flash", "zigzag_flash"):
        layout = "zigzag" if impl.startswith("zigzag") else "contiguous"
        chunk = "flash" if impl.endswith("_flash") else "fold"
        ctx = ring_attention_sharded(q, k, v, mesh, axis_name="sp",
                                     causal=cfg.causal, layout=layout,
                                     chunk_impl=chunk)
    elif impl in ("ulysses", "ulysses_flash"):
        kernel = "flash" if impl.endswith("_flash") else "blockwise"
        ctx = ulysses_attention_sharded(q, k, v, mesh, axis_name="sp",
                                        causal=cfg.causal,
                                        kernel_impl=kernel)
    else:
        raise ValueError(
            f"mpi_tpu_torch: unknown attention_impl {impl!r}: expected "
            f"dense|flash|blockwise|ring|ring_flash|zigzag|zigzag_flash|"
            f"ulysses|ulysses_flash")
    partial = torch.einsum("bsthk,thkd->tbsd", ctx.unflatten(2, (tp, -1)),
                           blk["wo"].to(x.dtype).unflatten(0, (tp, -1)))
    return tp_reduce(partial, ring)


def _ffn(x, blk, cfg: TransformerConfig, ring: Optional[RankMesh] = None):
    """Position-wise FFN with tanh-GELU (``jax.nn.gelu``'s default):
    ``(y, stats)``. Dense, over the tp ranks of ``ring``: rank r its d_ff
    columns of w1 and rows of w2, the partials summed by :func:`tp_reduce`,
    and empty statistics ``(2, 0)``. With experts, the routed FFN over the
    ep × tp ranks of ``ring`` and its aux statistics ``(2, E)``
    (:func:`~mpi_tpu_torch.models.moe.moe_parts`)."""
    if cfg.n_experts > 0:
        return moe_parts(x, blk["moe"], cfg.n_experts, cfg.capacity_factor,
                         cfg.moe_top_k, ring)
    tp = tp_size(ring)
    h = F.gelu(torch.einsum("tbsd,dtf->tbsf", tp_copy(x, ring),
                            blk["w1"].to(x.dtype).unflatten(1, (tp, -1))),
               approximate="tanh")
    partial = torch.einsum("tbsf,tfd->tbsd", h,
                           blk["w2"].to(x.dtype).unflatten(0, (tp, -1)))
    return (tp_reduce(partial, ring),
            torch.zeros((2, 0), dtype=torch.float32, device=x.device))


def block_body(x, blk, cfg: TransformerConfig,
               mesh: Optional[RankMesh] = None):
    """One pre-norm transformer block (attention and FFN residuals):
    ``(x, stats)``, the FFN's aux statistics beside the output (see
    :func:`_ffn`). ``blk`` is the block's tree, or a callable that returns
    it: an FSDP step's block, whose weights are gathered here, and again
    when remat recomputes the block in the backward. The experts run over
    one ring of ``mesh``'s ``ep`` and ``tp`` ranks, the rest over its
    ``tp`` ring."""
    if callable(blk):
        blk = blk()
    ring = tp_ring(mesh)
    h = _layernorm(x, blk["ln1"]["scale"].to(x.dtype),
                   blk["ln1"]["bias"].to(x.dtype))
    x = x + _attention(h, blk, cfg, mesh, ring)
    h = _layernorm(x, blk["ln2"]["scale"].to(x.dtype),
                   blk["ln2"]["bias"].to(x.dtype))
    y, stats = _ffn(h, blk, cfg, tp_ring(mesh, ("ep", "tp"))
                    if cfg.n_experts else ring)
    return x + y, stats


def _vocab_parallel_forward(params: Dict[str, Any], tokens: torch.Tensor,
                            cfg: TransformerConfig,
                            mesh: Optional[RankMesh]
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (batch, seq) → (logits ``(tp, batch, seq, vocab/tp)``, tp
    rank r's vocab range at index r, and the layers' aux statistics ``(L,
    2, E)``, E = 0 for the dense FFN)."""
    check_mesh(mesh, cfg)
    s = tokens.shape[1]
    ring = tp_ring(mesh)
    x = vocab_parallel_embed(params["embed"].to(cfg.dtype), tokens, ring)
    if not cfg.rope:
        x = x + params["pos"].to(cfg.dtype)[:s][None]
    stats = []
    for blk in params["blocks"]:
        if cfg.remat:
            x, blk_stats = checkpoint(block_body, x, blk, cfg, mesh,
                                      use_reentrant=False)
        else:
            x, blk_stats = block_body(x, blk, cfg, mesh)
        stats.append(blk_stats)
    x = _layernorm(x, params["final_ln"]["scale"].to(x.dtype),
                   params["final_ln"]["bias"].to(x.dtype))
    logits = torch.einsum(
        "tbsd,tvd->tbsv", tp_copy(x, ring),
        params["embed"].to(x.dtype).unflatten(0, (tp_size(ring), -1)))
    return logits, torch.stack(stats)


def forward_with_aux(params: Dict[str, Any], tokens: torch.Tensor,
                     cfg: TransformerConfig, mesh: Optional[RankMesh] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (batch, seq) → (logits (batch, seq, vocab), aux loss), on the
    device the parameters lie on. The aux loss is the MoE load-balance
    penalty summed over the layers, 0 for the dense FFN. With
    ``cfg.remat`` each block is recomputed in the backward pass
    (``torch.utils.checkpoint``, where JAX has ``jax.checkpoint``). The
    sequence-parallel impls run over ``mesh``'s ``sp`` axis and a ``tp``
    axis splits the model (see the module note); the tp ranks' vocab
    ranges of the logits are laid side by side."""
    logits, stats = _vocab_parallel_forward(params, tokens, cfg, mesh)
    return logits.permute(1, 2, 0, 3).flatten(2), aux_loss(stats)


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig,
            mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """tokens (batch, seq) → logits (batch, seq, vocab), on the device the
    parameters lie on."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]


def token_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy as ``logsumexp − target_logit`` in
    float32: the (b, s, vocab) log-softmax is never materialised."""
    logits32 = logits.float()
    lse = torch.logsumexp(logits32, dim=-1)
    tgt = torch.gather(logits32, -1, targets.long()[..., None])[..., 0]
    return (lse - tgt).mean()


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig,
            mesh: Optional[RankMesh] = None) -> torch.Tensor:
    """Next-token cross-entropy of ``tokens`` (batch, seq + 1), mean over
    every predicted position, plus ``moe_aux_coef`` times the aux loss.
    Over a ``tp`` axis the cross-entropy is vocab-parallel
    (:func:`~mpi_tpu_torch.parallel.tensor_parallel.vocab_parallel_xent`):
    the logits are never gathered."""
    xent, stats = _loss_parts(params, tokens, cfg, mesh)
    return xent + cfg.moe_aux_coef * aux_loss(stats)


def _loss_parts(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: TransformerConfig, mesh: Optional[RankMesh]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`loss_fn`'s cross-entropy and the layers' aux statistics
    ``(L, 2, E)``."""
    logits, stats = _vocab_parallel_forward(params, tokens[:, :-1], cfg,
                                            mesh)
    ring = tp_ring(mesh)
    if ring is None:
        return token_xent(logits[0], tokens[:, 1:]), stats
    return vocab_parallel_xent(logits, tokens[:, 1:], ring), stats


# --------------------------------------------------------------------------
# Training step
# --------------------------------------------------------------------------

def check_mesh(mesh: Any, cfg: TransformerConfig,
               embedding: bool = True) -> None:
    """Raise unless ``mesh`` is None or a :class:`RankMesh` this slice
    runs: ``TypeError`` for another object, ``NotImplementedError`` for
    ranks over several distinct devices, ``ValueError`` when its ``tp``
    axis does not divide the heads (as the JAX package checks), d_ff or
    the vocabulary (each tp rank reads an equal slice of w1, w2, the
    experts' d_ff and the embedding), or, with experts,
    its ``ep`` axis does not divide them (each ep rank runs an equal
    share). ``embedding=False`` leaves the vocabulary out: an encoder with
    no token embedding (:mod:`.vit`)."""
    if mesh is None:
        return
    if not isinstance(mesh, RankMesh):
        raise TypeError(f"mpi_tpu_torch: a mesh must be a RankMesh; got "
                        f"{type(mesh).__name__}")
    distinct = sorted({str(d) for d in mesh.devices})
    if len(distinct) > 1:
        raise NotImplementedError(
            f"mpi_tpu_torch: a mesh over several devices {distinct} is not "
            f"ported yet: its ranks must share one device (the NVLink peer "
            f"path of kernels 5-7 is queued in ROADMAP.md)")
    tp = mesh.shape.get("tp", 1)
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"mpi_tpu_torch: tp={tp} must divide n_heads={cfg.n_heads} and "
            f"kv_heads={cfg.kv_heads} (GQA shards kv heads over tp too)")
    if cfg.d_ff % tp or (embedding and cfg.vocab % tp):
        raise ValueError(
            f"mpi_tpu_torch: tp={tp} must divide d_ff={cfg.d_ff} and "
            f"vocab={cfg.vocab} (w1, w2 and the embedding split over tp)"
            if embedding else f"mpi_tpu_torch: tp={tp} must divide d_ff="
            f"{cfg.d_ff} (w1 and w2 split over tp)")
    if cfg.n_experts == 0:
        return
    ep = mesh.shape.get("ep", 1)
    if cfg.n_experts % ep:
        raise ValueError(
            f"mpi_tpu_torch: ep={ep} must divide n_experts={cfg.n_experts} "
            f"(each ep rank runs an equal share of the experts)")


def make_optimizer(optimizer: str = "adamw", learning_rate: float = 1e-3,
                   warmup_steps: int = 0, total_steps: Optional[int] = None
                   ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """A builder ``leaves -> torch.optim.Optimizer`` for ``optimizer``, the
    JAX package's choices as optax's rules (:mod:`.optimizers`):
    ``"adamw"`` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every
    leaf; torch's own default decay is 1e-2), ``"adafactor"`` (optax's
    defaults) or ``"sgd"`` (momentum 0.9). Schedule: with ``total_steps``,
    linear warmup over ``warmup_steps`` into cosine decay to 10% of the
    peak at ``total_steps``; with only ``warmup_steps``, linear warmup then
    constant; otherwise the constant ``learning_rate``."""
    if optimizer not in ("adamw", "adafactor", "sgd"):
        raise ValueError(f"mpi_tpu_torch: unknown optimizer {optimizer!r}: "
                         f"expected adamw|adafactor|sgd")
    schedule = learning_rate_schedule(learning_rate, warmup_steps,
                                      total_steps)

    def build(leaves: List[torch.Tensor]) -> torch.optim.Optimizer:
        return build_optimizer(optimizer, leaves, learning_rate, schedule)

    return build


def train_state(params: Dict[str, Any],
                build: Callable[[List[torch.Tensor]], torch.optim.Optimizer],
                mesh: Optional[RankMesh] = None,
                specs: Optional[Callable[[Any, RankMesh], Any]] = None
                ) -> Dict[str, Any]:
    """The state of a step on one dp rank around ``params``: ``{"params",
    "opt"}``, every leaf made trainable under the optimizer that ``build``
    (:func:`make_optimizer`) makes of them; a leaf that is not floating
    point raises ``TypeError``. Over a mesh the state also holds it
    (``"mesh"``) and ``specs(params, mesh)`` (``"specs"``), from which
    :func:`rank_state` reads the tp split."""
    leaves = tree_leaves(params)
    for x in leaves:
        if not x.is_floating_point():
            raise TypeError(f"mpi_tpu_torch: cannot train a {x.dtype} "
                            f"parameter")
        x.requires_grad_(True)
    state = {"params": params, "opt": build(leaves)}
    if mesh is not None:
        state.update(mesh=mesh, specs=specs(params, mesh))
    return state


def _groups(params: Dict[str, Any]) -> List[Any]:
    """A data-parallel step's gather groups: the leaves outside the blocks
    (embedding, position table, final norm), then each block."""
    return [{k: v for k, v in params.items() if k != "blocks"},
            *params["blocks"]]


def _regroup(params: Dict[str, Any], leaves) -> Dict[str, Any]:
    """A tree of ``params``'s structure and key order holding ``leaves``
    in :func:`_groups`' order."""
    it = iter(leaves)
    groups = [tree_with_leaves(g, it) for g in _groups(params)]
    return {k: groups[1:] if k == "blocks" else groups[0][k]
            for k in params}


class _GatherGroup(torch.autograd.Function):
    """Dp rank ``rank``'s full tensors of group ``g``'s sharded leaves,
    gathered from the group's ``(dp, S_g)`` buffer of pieces by one
    kernel-5 launch over the dp ring (it writes every rank's copy; this
    rank's is read). Nothing is saved but the layout: the backward lays the
    tensors' gradients out as the buffer's, a copy with no communication;
    the ranks' gradients meet in the step's reduce-scatter."""

    @staticmethod
    def forward(ctx, buf, layout, g, rank, ring):
        ctx.layout, ctx.g = layout, g
        start = layout.spans[g][0]
        mine = ring_allgather(buf.reshape(-1), ring)[rank].view(buf.shape)
        return tuple(layout.full(mine, i, start)
                     for i in layout.group_leaves(g, sharded=True))

    @staticmethod
    def backward(ctx, *grads):
        layout, g = ctx.layout, ctx.g
        start, stop = layout.spans[g]
        out = grads[0].new_empty((layout.n, stop - start))
        for i, grad in zip(layout.group_leaves(g, sharded=True), grads):
            layout.pieces(out, i, start).copy_(
                pieces_view(grad, layout.leaves[i].dim, layout.n))
        return out, None, None, None, None


def _span(state: Dict[str, Any], i: int) -> Tuple[int, int]:
    """The buffer of a zero1 or fsdp state that holds sharded leaf ``i``,
    and the chunk column the buffer starts at."""
    off = state["layout"].leaves[i].offset
    return next((g, start) for g, (start, stop) in enumerate(state["spans"])
                if start <= off < stop)


class _DataParallel:
    """:func:`make_train_parts` over a mesh whose ``dp`` axis is above 1
    (see the module note). ``mode`` is ``"dp"`` (parameters and moments
    replicated), ``"zero1"`` or ``"fsdp"``.

    Every mode packs the ranks' gradients into the same bucket layout
    (:class:`~mpi_tpu_torch.parallel.zero.DpLayout`, ``fsdp_specs``'
    dimensions for dp and fsdp, ``zero1_specs``' for zero1), so kernel 6
    folds each value in the same ring order whichever reduction runs, and
    AdamW and sgd are elementwise: where the modes' dimensions agree and
    every leaf is sharded, they give the same bits. (Plain dp reduces
    replicated leaves in the same launch as the shards, the others in a
    launch of their own, which moves the chunks' edges and so the fold
    orders.)

    adafactor's row and column means and its RMS terms are taken over
    whole leaves, so with ``whole_leaves`` zero1 and fsdp hand the
    optimizer each sharded leaf as its ``(dp, piece)`` view of the buffer
    (``state["pieces"]``), with its reduced gradient as the same view of
    the reduce-scatter's output, in a param group of its own whose
    ``pieces_dim`` names the dimension dp claims
    (:class:`~mpi_tpu_torch.models.optimizers.Adafactor`): the rule runs
    on the whole leaf, its moments are those of the whole leaf, and each
    rank's piece takes its part of the update. The whole leaf and its
    gradient hold plain dp's values, so where every leaf is sharded the
    modes give the same bits here too."""

    def __init__(self, cfg, mesh, build, grad_accum, mode, whole_leaves):
        self.cfg, self.mesh, self.build = cfg, mesh, build
        self.grad_accum, self.mode = grad_accum, mode
        self.whole_leaves = whole_leaves
        self.dp = mesh.shape["dp"]
        # One dp ring stands for every (sp, tp) position's: the ranks share
        # one device, and every position's ring reduces the same values.
        self.ring = axis_ring(mesh, "dp")
        subs = [axis_slice(mesh, "dp", r) for r in range(self.dp)]
        self.rank_meshes = [m if m.axis_names else None for m in subs]

    def layout(self, params, specs):
        """The bucket layout of ``params``, whose tp specs are ``specs``
        (:func:`sane_param_specs`)."""
        if self.mode == "zero1":  # the moments' specs, matched by shape
            specs = zero1_specs(params, specs, params, self.mesh)
        else:
            specs = fsdp_specs(params, specs, self.mesh)
        return DpLayout([[(x.shape, spec_dim(s)) for x, s in
                          zip(tree_leaves(g), spec_leaves(sg))]
                         for g, sg in zip(_groups(params), _groups(specs))],
                        self.dp)

    def from_params(self, params):
        leaves = [x for g in _groups(params) for x in tree_leaves(g)]
        for x in leaves:
            if not x.is_floating_point():
                raise TypeError(f"mpi_tpu_torch: cannot train a "
                                f"{x.dtype} parameter")
        specs = sane_param_specs(self.cfg, params, self.mesh)
        layout = self.layout(params, specs)
        state = {"params": params, "layout": layout, "mode": self.mode,
                 "mesh": self.mesh, "specs": specs}
        if self.mode == "dp":
            for x in leaves:
                x.requires_grad_(True)
            state["opt"] = self.build(leaves)
            return state
        rest = [x for x, leaf in zip(leaves, layout.leaves)
                if leaf.dim is None]
        for x in leaves if self.mode == "zero1" else rest:
            x.requires_grad_(True)  # zero1's forward reads the full leaves
        # zero1: one (dp, chunk) buffer of every rank's shards; fsdp: one
        # (dp, S_g) buffer a group, each group gathered on its own.
        spans = (layout.spans if self.mode == "fsdp"
                 else [(0, layout.chunk)])
        bufs = [torch.empty((self.dp, stop - start), dtype=leaves[0].dtype,
                            device=leaves[0].device) for start, stop in spans]
        state.update(spans=spans, buffers=bufs)
        self._fill(state, leaves)
        pieces = [None if leaf.dim is None else self._pieces(state, i)
                  for i, leaf in enumerate(layout.leaves)]
        if self.mode == "fsdp":  # the parameters are the pieces alone now
            state["params"] = _regroup(params, [
                x if v is None else v for x, v in zip(leaves, pieces)])
        state["shards"] = [[buf[r] for buf in bufs] for r in range(self.dp)]
        if self.whole_leaves:
            state["pieces"] = pieces
            groups = [{"params": [v], "pieces_dim": leaf.dim}
                      for v, leaf in zip(pieces, layout.leaves)
                      if v is not None]
            state["opt"] = self.build(groups + ([{"params": rest}] if rest
                                                else []))
        else:
            state["opt"] = self.build([s for row in state["shards"]
                                       for s in row] + rest)
        return state

    def _pieces(self, state, i):
        g, start = _span(state, i)
        return state["layout"].pieces(state["buffers"][g], i, start)

    def _fill(self, state, leaves):
        """Each rank's pieces of the full ``leaves`` into the buffers."""
        layout = state["layout"]
        for i, x in enumerate(leaves):
            dim = layout.leaves[i].dim
            if dim is not None and x.numel():
                self._pieces(state, i).copy_(pieces_view(x.detach(), dim,
                                                         self.dp))

    def _rank_params(self, state, inputs, r):
        """Rank r's tree for an fsdp step: the top group gathered now,
        each block gathered when :func:`block_body` runs it."""
        layout = state["layout"]
        n_groups = len(layout.spans)
        rest = iter(inputs[n_groups:])
        by_leaf = {i: next(rest) for i, leaf in enumerate(layout.leaves)
                   if leaf.dim is None}
        templates = _groups(state["params"])

        def group_tree(g):
            own = layout.group_leaves(g)
            sharded = layout.group_leaves(g, sharded=True)
            full = dict(zip(sharded, _GatherGroup.apply(
                inputs[g], layout, g, r, self.ring))) if sharded else {}
            return tree_with_leaves(templates[g],
                                    iter([full.get(i, by_leaf.get(i))
                                          for i in own]))

        blocks = [lambda g=g: group_tree(g) for g in range(1, n_groups)]
        top = group_tree(0)
        return {k: blocks if k == "blocks" else top[k]
                for k in state["params"]}

    def step(self, state, tokens):
        layout, opt, dp, k = state["layout"], state["opt"], self.dp, \
            self.grad_accum
        b = tokens.shape[0]
        if b % (dp * k):
            raise ValueError(f"mpi_tpu_torch: batch {b} not divisible by "
                             f"dp={dp} x grad_accum={k}")
        params = state["params"]
        leaves = [x for g in _groups(params) for x in tree_leaves(g)]
        dev = leaves[0].device
        tokens = tokens.to(dev)
        opt.zero_grad(set_to_none=True)
        # fsdp: the buffers' gradients, then the replicated leaves'.
        if self.mode == "fsdp":
            inputs = [buf.detach().requires_grad_(True)
                      for buf in state["buffers"]]
            inputs += [x for x, leaf in zip(leaves, layout.leaves)
                       if leaf.dim is None]
        else:
            inputs = leaves
        bucket = grad_bucket(layout, dev)
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        # JAX's microbatches: consecutive rows of the batch, each split
        # over dp; rank r's gradient from its own rows alone.
        for j, micro in enumerate(tokens.chunk(k)):
            for r, rank_loss in enumerate(self._rank_losses(
                    state, inputs, micro.chunk(dp))):
                micro_loss = rank_loss / k
                grads = torch.autograd.grad(micro_loss, inputs,
                                            allow_unused=True,
                                            materialize_grads=True)
                self._pack(state, bucket[r], grads, add=j > 0)
                loss += micro_loss.detach()
        self._update(state, leaves, bucket)
        return state, loss / dp

    def _rank_losses(self, state, inputs, rows):
        """Each dp rank's loss on its ``rows``, in rank order. The dense
        model's are computed one at a time, as they are asked for (one
        rank's graph held at a time). With experts every rank's forward
        runs first, then kernel 6 sums the ranks' fractions of first
        choices ``(dp, L·E)`` over the dp ring, and rank r's loss takes the
        penalty with the global batch's fractions (their mean) and its own
        router probabilities: the JAX package's penalty over the batch and
        its gradient, as the mean over the ranks."""
        def parts(r):
            rank_params = (self._rank_params(state, inputs, r)
                           if self.mode == "fsdp" else state["params"])
            return _loss_parts(rank_params, rows[r], self.cfg,
                               self.rank_meshes[r])

        if not self.cfg.n_experts:
            for r in range(self.dp):
                xent, _ = parts(r)
                yield xent
            return
        ranks = [parts(r) for r in range(self.dp)]
        # The ranks' (L, E) fractions summed over the dp ring: tp_reduce
        # takes any ring.
        frac = tp_reduce(torch.stack([stats[:, 0].detach()
                                      for _, stats in ranks]),
                         self.ring) / self.dp
        for xent, stats in ranks:
            global_stats = torch.stack([frac, stats[:, 1]], dim=1)
            yield xent + self.cfg.moe_aux_coef * aux_loss(global_stats)

    def _pack(self, state, row, grads, add):
        layout = state["layout"]
        if self.mode != "fsdp":
            layout.pack(row, grads, add)
            return
        chunks = layout.chunks(row)
        dsts = [chunks[:, start:stop] for start, stop in layout.spans]
        dsts += [layout.tail(row, i) for i, leaf in enumerate(layout.leaves)
                 if leaf.dim is None]
        for dst, grad in zip(dsts, grads):
            if add:
                dst.add_(grad)
            else:
                dst.copy_(grad)

    def _update(self, state, leaves, bucket):
        """Reduce the bucket over the dp ring (kernel 6) and update."""
        layout, opt, dp = state["layout"], state["opt"], self.dp
        if self.mode == "dp":
            allreduce_grads(bucket, layout, leaves, self.ring,
                            ring_allreduce)
            opt.step()
            return
        nc = dp * layout.chunk
        sharded = bucket if layout.width == nc else \
            bucket[:, :nc].contiguous()
        mine = ring_reduce_scatter(sharded, self.ring).div_(dp)
        if layout.width > nc:  # leaves with no divisible dimension
            rest = ring_allreduce(bucket[:, nc:].contiguous(),
                                  self.ring)[0].div_(dp)
            for i, x in enumerate(leaves):
                if layout.leaves[i].dim is None:
                    x.grad = layout.unpack(rest, i)
        if self.whole_leaves:
            for i, v in enumerate(state["pieces"]):
                if v is not None:
                    v.grad = layout.pieces(mine, i)
        else:
            for r, row in enumerate(state["shards"]):
                for s, (start, stop) in zip(row, state["spans"]):
                    s.grad = mine[r, start:stop]
        opt.step()
        if self.mode == "zero1":
            gathered = ring_allgather(state["buffers"][0].reshape(-1),
                                      self.ring)
            with torch.no_grad():  # rank 0's copy; every rank's is the same
                for i, x in enumerate(leaves):
                    if layout.leaves[i].dim is not None:
                        layout.unpack(gathered[0], i, out=x)


def full_params(state: Dict[str, Any]) -> Dict[str, Any]:
    """The full parameter tree of a training state: ``state["params"]``,
    unless ``fsdp`` holds it as pieces, which are then put back together
    (plain PyTorch copies, no kernel launch)."""
    if state.get("mode") != "fsdp":
        return state["params"]
    params, layout = state["params"], state["layout"]
    leaves = [x for g in _groups(params) for x in tree_leaves(g)]
    return _regroup(params, [
        x if leaf.dim is None else unshard(x, leaf.dim).detach()
        for x, leaf in zip(leaves, layout.leaves)])


def _moment_names(opt: torch.optim.Optimizer) -> List[str]:
    """The names of the tensors the optimizer keeps per leaf: AdamW's
    ``exp_avg`` and ``exp_avg_sq``, sgd's ``momentum_buffer``, adafactor's
    ``v_row``, ``v_col`` and ``v`` (empty before the first step)."""
    first = next(iter(opt.state.values()), {})
    return [k for k, v in first.items() if k != "step" and torch.is_tensor(v)]


def rank_state(state: Dict[str, Any], rank: int, tp_rank: int = 0,
               ep_rank: int = 0) -> Dict[str, Any]:
    """What the rank at dp coordinate ``rank``, tp coordinate ``tp_rank``
    and ep coordinate ``ep_rank`` holds of a training state:
    ``{"params"}`` and one entry per tensor the optimizer keeps per leaf
    (:func:`_moment_names`; they exist from the first step on), each a
    tree of the parameter tree's layout whose leaves are views of the
    state's tensors: the rank's piece of a leaf that dp, tp or ep shards
    (the experts' ``w1e`` / ``w2e`` hold ``n_experts / ep`` experts a
    rank and ``d_ff / tp`` of each one's d_ff, and under fsdp ``d_model /
    dp`` of its d_model), the leaf whole where none does. These are the shapes of the
    JAX package's shards on that rank's device; an optimizer tensor not of
    its leaf's shape (adafactor's factored moments) is given whole, as
    zero1 and fsdp keep it."""
    params, opt = state["params"], state["opt"]
    layout, mesh = state.get("layout"), state.get("mesh")
    leaves = [x for g in _groups(params) for x in tree_leaves(g)]
    specs = [s for g in _groups(state["specs"]) for s in spec_leaves(g)] \
        if mesh is not None else [()] * len(leaves)
    coords = {"tp": tp_rank, "ep": ep_rank}
    sizes = {axis: 1 if mesh is None else mesh.shape.get(axis, 1)
             for axis in coords}

    def dp_piece(x, i, what):
        dim = None if layout is None else layout.leaves[i].dim
        if dim is None or state["mode"] == "dp":
            return x if what == "params" else opt.state[x][what]
        if what == "params":
            return x[rank] if state["mode"] == "fsdp" else x
        if "pieces" in state:  # the moments of the whole leaf
            moment = opt.state[state["pieces"][i]][what]
            if moment.shape != layout.leaves[i].shape:
                return moment
            return pieces_view(moment, dim, layout.n)[rank]
        g, start = _span(state, i)
        moment = opt.state[state["shards"][rank][g]][what]
        return layout.pieces(moment.view(1, -1), i, start)[0]

    def held(x, i, what):
        piece = dp_piece(x, i, what)
        shape = x.shape if layout is None else layout.leaves[i].shape
        for axis, coord in coords.items():
            dim = spec_dim(specs[i], axis)
            if dim is None or piece.dim() != len(shape) or \
                    piece.shape[dim] != shape[dim]:
                continue
            k = piece.shape[dim] // sizes[axis]
            piece = piece.narrow(dim, coord * k, k)
        return piece

    return {what: _regroup(params, [held(x, i, what)
                                    for i, x in enumerate(leaves)])
            for what in ("params", *_moment_names(opt))}


def make_train_parts(cfg: TransformerConfig, mesh: Any = None,
                     learning_rate: float = 1e-3, grad_accum: int = 1,
                     optimizer: str = "adamw", warmup_steps: int = 0,
                     total_steps: Optional[int] = None,
                     zero1: bool = False, fsdp: bool = False):
    """Build ``(init_state, step)``, on one device.

    ``init_state(generator, device=None)`` draws fresh parameters
    (:func:`init_params`, float32 masters at ``cfg.param_dtype`` on the
    CUDA device unless ``device`` names another) and returns the state,
    ``{"params", "opt"}`` and, over a dp mesh, the layout it was sharded
    by; ``init_state.from_params(params)`` builds the state around a given
    full tree instead (from :func:`params_from_jax`, say), taking its
    tensors as they are and, for ``fsdp``, cutting them into the ranks'
    pieces (:func:`full_params` puts them back together). ``step(state,
    tokens) -> (state, loss)`` runs one optimizer step on ``tokens``
    (batch, seq + 1) and updates the state in place (the JAX step returns
    a new state and donates the old); ``loss`` is a 0-dim float32 tensor
    on the device.

    ``grad_accum=k`` averages the gradients of ``k`` microbatches before
    one update, each ``b/k`` consecutive rows of the batch (split over
    the dp ranks, over a dp mesh); the batch must divide by ``k`` (times
    dp). The optimizer options are :func:`make_optimizer`'s.
    ``mesh`` is a :class:`RankMesh` whose ranks share the device
    (:func:`check_mesh`): its ``sp`` axis carries the sequence-parallel
    attention impls, and a ``dp`` axis above 1 makes the step
    data-parallel, with ``zero1`` (optimizer state sharded over dp) or
    ``fsdp`` (parameters too) as options that need a ``dp`` axis, and a
    ``tp`` axis above 1 splits the model over its ranks; see the module
    note. A state built over a mesh also holds it (``"mesh"``) and the
    parameters' specs (``"specs"``), from which :func:`rank_state` reads
    the tp split."""
    if grad_accum < 1:
        raise ValueError(f"mpi_tpu_torch: grad_accum must be >= 1, got "
                         f"{grad_accum}")
    check_mesh(mesh, cfg)
    has_dp = mesh is not None and "dp" in mesh.axis_names
    for name, on in (("zero1", zero1), ("fsdp", fsdp)):
        if on and not has_dp:
            raise ValueError(f"mpi_tpu_torch: {name}=True needs a mesh with "
                             f"a 'dp' axis")
    if fsdp and zero1:
        raise ValueError("mpi_tpu_torch: fsdp subsumes zero1 (optimizer "
                         "state follows the dp-sharded parameters); pass "
                         "only fsdp=True")
    build = make_optimizer(optimizer, learning_rate, warmup_steps,
                           total_steps)
    if has_dp and mesh.shape["dp"] > 1:
        mode = "fsdp" if fsdp else "zero1" if zero1 else "dp"
        parallel = _DataParallel(cfg, mesh, build, grad_accum, mode,
                                 whole_leaves=optimizer == "adafactor")
        from_params, step = parallel.from_params, parallel.step
    else:  # one dp rank: zero1 and fsdp shard nothing, as in JAX
        def from_params(params: Dict[str, Any]) -> Dict[str, Any]:
            return train_state(params, build, mesh, lambda p, m:
                               sane_param_specs(cfg, p, m))

        def step(state: Dict[str, Any], tokens: torch.Tensor
                 ) -> Tuple[Dict[str, Any], torch.Tensor]:
            params, opt = state["params"], state["opt"]
            b = tokens.shape[0]
            if b % grad_accum:
                raise ValueError(f"mpi_tpu_torch: batch {b} not divisible "
                                 f"by grad_accum={grad_accum}")
            tokens = tokens.to(params["embed"].device)
            opt.zero_grad(set_to_none=True)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for micro in tokens.chunk(grad_accum):
                micro_loss = loss_fn(params, micro, cfg, mesh) / grad_accum
                micro_loss.backward()
                loss += micro_loss.detach()
            opt.step()
            return state, loss

    def init_state(generator: torch.Generator,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> Dict[str, Any]:
        return from_params(init_params(cfg, generator, device))

    init_state.from_params = from_params
    return init_state, step


def make_train_step(cfg: TransformerConfig, mesh: Any = None,
                    learning_rate: float = 1e-3, grad_accum: int = 1,
                    optimizer: str = "adamw", warmup_steps: int = 0,
                    total_steps: Optional[int] = None,
                    zero1: bool = False, fsdp: bool = False):
    """``(init_state, step)`` as :func:`make_train_parts` builds them. The
    JAX package jits its step here; the port runs eagerly, so the two
    names give the same step."""
    return make_train_parts(cfg, mesh=mesh, learning_rate=learning_rate,
                            grad_accum=grad_accum, optimizer=optimizer,
                            warmup_steps=warmup_steps,
                            total_steps=total_steps, zero1=zero1, fsdp=fsdp)


def make_mesh_nd(n_devices: int,
                 axes: Tuple[str, ...] = ("dp", "sp", "tp"),
                 devices: Optional[List[Union[str, torch.device]]] = None
                 ) -> RankMesh:
    """Factor ``n_devices`` into a :class:`RankMesh` over ``axes`` as the
    JAX package does: smallest prime factors are peeled off and dealt
    round-robin from the leftmost axis, e.g. 8 → (2, 2, 2), 4 → (2, 2, 1),
    6 → (2, 3, 1), 12 → (2, 2, 3), 1 → (1, 1, 1). ``devices`` (repeats
    allowed: ranks then share a device) defaults to the first
    ``n_devices`` CUDA devices."""
    if devices is None:
        devices = mesh_devices(n_devices)
    dims = [1] * len(axes)
    rem = n_devices
    i = 0
    while rem > 1:
        # peel the smallest prime factor
        f = next((p for p in range(2, rem + 1) if rem % p == 0), rem)
        dims[i % len(axes)] *= f
        rem //= f
        i += 1
    return RankMesh(devices, axes, dims)
