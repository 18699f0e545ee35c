"""State-space sequence model (LRU family): the non-attention LM, served.

Counterpart of the serving half of ``mpi_tpu/models/ssm.py``. A diagonal
complex linear recurrence (the Linear Recurrent Unit) interleaved with
MLPs: where the Transformer mixes time with attention, this mixes it with
an O(s) scan (:func:`~mpi_tpu_torch.parallel.scan.linear_scan`, a
log-depth doubling scan), and decoding carries an O(1) recurrent state a
layer instead of a KV cache. Per layer, over hidden size ``d`` and state
size ``h``::

    lam = exp(-exp(nu_log) + i * exp(theta_log))     # |lam| < 1
    gam = sqrt(1 - |lam|^2)                          # input normaliser
    x_t = lam * x_{t-1} + gam * (u_t @ B)            # complex diagonal
    y_t = Re(x_t @ C) + D * u_t                      # read-out + skip

The recurrence runs in complex64 and the drive and read-out are float32
products (two real ones each, as in JAX); the MLP and the head run in
``cfg.dtype``. The parameter tree is the JAX package's
(:func:`ssm_params_from_jax` carries it over).

:func:`ssm_forward_sp` splits the sequence over a mesh's ``sp`` axis: the
ranks share the card, so every per-position operation runs once on the
whole sequence, and only the recurrence runs as
:func:`~mpi_tpu_torch.parallel.scan.sharded_linear_scan` over the stacked
chunks, its carries hopped on kernel 7.

:func:`make_ssm_train_step` trains it: the port's ``token_xent`` over the
forward, one optimizer step of :func:`~.transformer.make_optimizer`'s rule
on the float32 masters. Over a mesh's ``dp`` axis each rank takes its own
rows of the batch, its gradient goes into its row of a ``(dp, width)``
float32 bucket, and one kernel-6 launch sums the bucket over the ranks,
which share the card (the JAX package shards the batch and GSPMD inserts
the psum).

Every entry point runs on ``device``, the CUDA device unless the caller
names another, where the parameters must lie; with CUDA absent and no
device given it raises.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.ring_collectives import ring_allreduce
from ..parallel.mesh import RankMesh, shared_ring
from ..parallel.scan import linear_scan, sharded_linear_scan
from ..parallel.zero import (DpLayout, allreduce_grads, grad_bucket,
                             tree_leaves)
from ..utils.platform import resolve_device
from .convert import _tensor
from .transformer import _layernorm, make_optimizer, token_xent, train_state

__all__ = ["SsmConfig", "init_ssm_params", "ssm_forward", "ssm_forward_sp",
           "init_ssm_state", "ssm_step", "ssm_prefill", "ssm_decode",
           "make_ssm_train_step", "ssm_params_from_jax"]

Device = Optional[Union[str, torch.device]]
State = List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    """Same fields and defaults as the JAX package's config, with a torch
    ``dtype`` (the MLP's and the head's compute dtype)."""

    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    d_state: int = 64          # per-layer complex state size
    d_ff: int = 512
    dtype: torch.dtype = torch.float32
    # |lam| initialised uniform in [r_min, r_max): long memories near 1.
    r_min: float = 0.4
    r_max: float = 0.99


def init_ssm_params(cfg: SsmConfig, generator: torch.Generator,
                    device: Device = None) -> Dict[str, Any]:
    """The parameter tree (float32 masters, the JAX package's layout) from
    ``generator``, on ``device`` (the CUDA device unless the caller names
    another). Dense weights are ``N(0, 1) / sqrt(fan_in)``; the LRU ring
    init draws |lam| in ``[r_min, r_max)`` and the phase in ``[1e-6, π)``.
    The draws differ from ``jax.random``'s. On the ``"meta"`` device
    nothing is drawn: the tree gives the shapes alone."""
    dev = resolve_device(device)
    d, h, f = cfg.d_model, cfg.d_state, cfg.d_ff
    meta = dev.type == "meta"

    def draw(fn, shape):
        if meta:
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return fn(shape, generator=generator, device=generator.device)

    def glorot(shape):
        return (draw(torch.randn, shape) / math.sqrt(shape[0])).to(dev)

    def uniform(shape, lo, hi):
        # The upper ends are open, as jax.random.uniform's: a draw that
        # rounds up to ``hi`` is pulled back one float32 step.
        top = torch.nextafter(torch.tensor(hi, dtype=torch.float32),
                              torch.tensor(lo, dtype=torch.float32))
        x = lo + draw(torch.rand, shape) * (hi - lo)
        return x.clamp(lo, float(top))

    def norm():
        return {"scale": torch.ones(d, device=dev),
                "bias": torch.zeros(d, device=dev)}

    blocks = []
    for _ in range(cfg.n_layers):
        # LRU ring init: lam = exp(-exp(nu) + i exp(theta)), |lam| in
        # [r_min, r_max), the phase over the circle's first half (its
        # lower bound keeps log() finite, as in JAX).
        mod = uniform((h,), cfg.r_min, cfg.r_max)
        theta = uniform((h,), 1e-6, math.pi)
        blocks.append({
            "nu_log": torch.log(-torch.log(mod)).to(dev),
            "theta_log": torch.log(theta).to(dev),
            "b_re": glorot((d, h)),
            "b_im": glorot((d, h)),
            "c_re": glorot((h, d)),
            "c_im": glorot((h, d)),
            "d_skip": torch.zeros(d, device=dev),
            "ln1": norm(),
            "w1": glorot((d, f)),
            "w2": glorot((f, d)),
            "ln2": norm(),
        })
    return {
        "embed": (draw(torch.randn, (cfg.vocab, d)) / math.sqrt(d)).to(dev),
        "blocks": blocks,
        "ln_f": norm(),
        "head": glorot((d, cfg.vocab)),
    }


def _device_of(params: Dict[str, Any]) -> torch.device:
    return params["embed"].device


def _runs_on(params: Dict[str, Any], device: Device, what: str
             ) -> torch.device:
    """The device ``what`` runs on, where ``params`` must lie."""
    dev = resolve_device(device)
    if _device_of(params).type != dev.type:
        raise ValueError(f"mpi_tpu_torch: params lie on "
                         f"{_device_of(params)}, {what} runs on {dev}")
    return dev


def _lam_gam(blk) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's complex64 decay ``lam`` and float32 input scale
    ``gam``, both ``(h,)``."""
    lam = torch.exp(torch.complex(-torch.exp(blk["nu_log"]),
                                  torch.exp(blk["theta_log"])))
    gam = torch.sqrt(torch.clamp(1.0 - lam.abs() ** 2, min=1e-8))
    return lam, gam


def _drive(blk, u: torch.Tensor, gam: torch.Tensor) -> torch.Tensor:
    """``gam · (u @ B)`` in complex64, from two float32 products."""
    u32 = u.float()
    return torch.complex(u32 @ blk["b_re"], u32 @ blk["b_im"]) * gam


def _read_out(blk, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """``Re(x @ C) + D·u`` in ``u``'s dtype, ``Re(x @ C)`` from two float32
    products."""
    y = x.real @ blk["c_re"] - x.imag @ blk["c_im"]
    return y.to(u.dtype) + blk["d_skip"].to(u.dtype) * u


def _lru_scan(blk, u: torch.Tensor, scan_fn=None, with_state=False):
    """The recurrence over a full sequence: u (b, s, d) -> y (b, s, d).

    ``scan_fn(a, b)`` computes the inclusive linear scan along dimension 1
    (default: :func:`linear_scan`; the sequence-parallel forward passes
    the sharded scan). ``with_state`` also returns the final recurrent
    state x_{s-1} (b, h), which a decode loop continues from."""
    lam, gam = _lam_gam(blk)
    drive = _drive(blk, u, gam)
    if scan_fn is None:
        x = linear_scan(lam, drive, dim=1)
    else:
        x = scan_fn(lam, drive)
    y = _read_out(blk, x, u)
    if with_state:
        return y, x[:, -1]
    return y


def _mlp(blk, x: torch.Tensor) -> torch.Tensor:
    """``x`` plus the pre-norm tanh-GELU MLP (``jax.nn.gelu``'s default)."""
    h = _layernorm(x, blk["ln2"]["scale"].to(x.dtype),
                   blk["ln2"]["bias"].to(x.dtype))
    h = F.gelu(h @ blk["w1"].to(x.dtype), approximate="tanh")
    return x + h @ blk["w2"].to(x.dtype)


def _block(blk, x: torch.Tensor, scan_fn=None, with_state=False):
    h = _layernorm(x, blk["ln1"]["scale"].to(x.dtype),
                   blk["ln1"]["bias"].to(x.dtype))
    if with_state:
        y, s_last = _lru_scan(blk, h, scan_fn, with_state=True)
    else:
        y, s_last = _lru_scan(blk, h, scan_fn), None
    x = _mlp(blk, x + y)
    return (x, s_last) if with_state else x


def _head(params, x: torch.Tensor) -> torch.Tensor:
    x = _layernorm(x, params["ln_f"]["scale"].to(x.dtype),
                   params["ln_f"]["bias"].to(x.dtype))
    return x @ params["head"].to(x.dtype)


def _embed(cfg: SsmConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The tokens' rows of the table in ``cfg.dtype`` (rows picked, then
    cast: the values of JAX's cast-then-pick)."""
    return params["embed"][tokens].to(cfg.dtype)


def _cast_weights(cfg: SsmConfig, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` with the MLP's and the head's weights in ``cfg.dtype``:
    cast once for a decode loop, which would cast them every token."""
    blocks = [{**blk, "w1": blk["w1"].to(cfg.dtype),
               "w2": blk["w2"].to(cfg.dtype)} for blk in params["blocks"]]
    return {**params, "blocks": blocks,
            "head": params["head"].to(cfg.dtype)}


def _forward_impl(cfg: SsmConfig, params: Dict[str, Any],
                  tokens: torch.Tensor, scan_fn=None) -> torch.Tensor:
    x = _embed(cfg, params, tokens)
    for blk in params["blocks"]:
        x = _block(blk, x, scan_fn)
    return _head(params, x)


def ssm_forward(cfg: SsmConfig, params: Dict[str, Any], tokens: torch.Tensor,
                device: Device = None) -> torch.Tensor:
    """tokens (b, s) -> logits (b, s, vocab) in ``cfg.dtype``. Strictly
    causal: position t sees tokens[:, :t+1] only."""
    dev = _runs_on(params, device, "ssm_forward")
    return _forward_impl(cfg, params, tokens.to(dev))


def ssm_forward_sp(cfg: SsmConfig, params: Dict[str, Any],
                   tokens: torch.Tensor, mesh: RankMesh,
                   axis_name: str = "sp", device: Device = None
                   ) -> torch.Tensor:
    """Sequence-parallel forward: global tokens (b, s) in, global logits
    (b, s, vocab) out, the sequence split into one contiguous chunk per
    ``axis_name`` rank of ``mesh`` (the JAX function runs inside
    ``shard_map`` on this rank's chunk). The ranks share the device, so
    the per-position operations run once on the whole sequence; each
    layer's recurrence runs as :func:`sharded_linear_scan` over the stacked
    chunks (``2·⌈log2 n⌉ + 1`` kernel-7 hops a layer on the card). Raises
    ``ValueError`` when ``s`` does not split over the ranks."""
    dev = _runs_on(params, device, "ssm_forward_sp")
    tokens = tokens.to(dev)
    ring = shared_ring(mesh, axis_name, tokens, "ssm_forward_sp")
    n = ring.size
    b, s = tokens.shape
    if s % n:
        raise ValueError(f"mpi_tpu_torch: sequence {s} does not split over "
                         f"{n} {axis_name!r} ranks")

    def scan_fn(lam, drive):
        h = drive.shape[-1]
        chunks = drive.reshape(b, n, s // n, h).transpose(0, 1)
        x = sharded_linear_scan(lam, chunks, ring, axis_name, dim=1)
        return x.transpose(0, 1).reshape(b, s, h)

    return _forward_impl(cfg, params, tokens, scan_fn)


# -- recurrent decode: O(1) state a layer, no KV cache ---------------------

def init_ssm_state(cfg: SsmConfig, batch: int, device: Device = None
                   ) -> State:
    """Per-layer recurrent state, all zeros (no context yet): ``n_layers``
    complex64 tensors ``(batch, d_state)`` on ``device``."""
    dev = resolve_device(device)
    return [torch.zeros((batch, cfg.d_state), dtype=torch.complex64,
                        device=dev) for _ in range(cfg.n_layers)]


def _step(cfg: SsmConfig, params: Dict[str, Any], coeffs, state: State,
          tokens: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """:func:`ssm_step` with each layer's ``(lam, gam)`` given."""
    x = _embed(cfg, params, tokens)  # (b, d)
    new_state = []
    for blk, (lam, gam), s in zip(params["blocks"], coeffs, state):
        h = _layernorm(x, blk["ln1"]["scale"].to(x.dtype),
                       blk["ln1"]["bias"].to(x.dtype))
        s = lam * s + _drive(blk, h, gam)
        new_state.append(s)
        x = _mlp(blk, x + _read_out(blk, s, h))
    return new_state, _head(params, x)


@torch.no_grad()
def ssm_step(cfg: SsmConfig, params: Dict[str, Any], state: State,
             tokens: torch.Tensor, device: Device = None
             ) -> Tuple[State, torch.Tensor]:
    """One token step: tokens (b,) -> (new state, logits (b, vocab)), the
    recurrence the scan runs, carried explicitly."""
    dev = _runs_on(params, device, "ssm_step")
    coeffs = [_lam_gam(blk) for blk in params["blocks"]]
    return _step(cfg, params, coeffs, state, tokens.to(dev))


def _prefill(cfg: SsmConfig, params: Dict[str, Any], prompt: torch.Tensor
             ) -> Tuple[State, torch.Tensor]:
    x = _embed(cfg, params, prompt)
    states = []
    for blk in params["blocks"]:
        x, s_last = _block(blk, x, with_state=True)
        states.append(s_last)
    return states, _head(params, x[:, -1])


@torch.no_grad()
def ssm_prefill(cfg: SsmConfig, params: Dict[str, Any],
                prompt: torch.Tensor, device: Device = None
                ) -> Tuple[State, torch.Tensor]:
    """(per-layer recurrent state after the last prompt token, last-position
    logits (b, vocab)) in one parallel-scan forward: only the last position
    goes through the head."""
    dev = _runs_on(params, device, "ssm_prefill")
    return _prefill(cfg, params, prompt.to(dev))


@torch.no_grad()
def ssm_decode(cfg: SsmConfig, params: Dict[str, Any], prompt: torch.Tensor,
               n_new: int, device: Device = None) -> torch.Tensor:
    """Greedy decode: prompt (b, p) -> (b, p + n_new), the prompt first.
    The prefill is one parallel scan and gives the first new token; then
    ``n_new − 1`` :func:`ssm_step` calls carry the O(1) state (the JAX
    package's scan runs one more step and discards it). The argmax stays on
    the device: no host sync a token. Returns the prompt unchanged when
    ``n_new <= 0`` or ``p == 0``."""
    dev = _runs_on(params, device, "ssm_decode")
    prompt = prompt.to(dev)
    if n_new <= 0 or prompt.shape[1] == 0:
        # p == 0 leaves no last position to read logits from.
        return prompt
    params = _cast_weights(cfg, params)
    state, logits = _prefill(cfg, params, prompt)
    coeffs = [_lam_gam(blk) for blk in params["blocks"]]
    tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
    toks = [tok]
    for _ in range(n_new - 1):
        state, logits = _step(cfg, params, coeffs, state, tok)
        tok = torch.argmax(logits, dim=-1).to(prompt.dtype)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


# -- training -------------------------------------------------------------

def _loss(cfg: SsmConfig, params: Dict[str, Any], tokens: torch.Tensor
          ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (b, s + 1)."""
    return token_xent(_forward_impl(cfg, params, tokens[:, :-1]),
                      tokens[:, 1:])


def _dp_loss(cfg: SsmConfig, params: Dict[str, Any], tokens: torch.Tensor,
             ring: RankMesh) -> torch.Tensor:
    """The data-parallel step's gradients into the leaves' ``.grad``, and
    its loss: rank r's rows are ``tokens.chunk(n)[r]``; its gradient goes
    into row r of the bucket of a :class:`DpLayout` with every leaf
    replicated, and :func:`allreduce_grads` sums it on kernel 6 as the
    Transformer's plain dp step does. The loss is the mean of the ranks'
    losses, the batch's mean (the ranks hold equally many tokens)."""
    n = ring.size
    if tokens.shape[0] % n:
        raise ValueError(f"mpi_tpu_torch: batch {tokens.shape[0]} not "
                         f"divisible by dp={n}")
    leaves = tree_leaves(params)
    layout = DpLayout([[(x.shape, None) for x in leaves]], n)
    bucket = grad_bucket(layout, tokens.device)
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for r, rows in enumerate(tokens.chunk(n)):
        rank_loss = _loss(cfg, params, rows)
        layout.pack(bucket[r], torch.autograd.grad(rank_loss, leaves))
        loss += rank_loss.detach()
    allreduce_grads(bucket, layout, leaves, ring, ring_allreduce)
    return loss / n


def make_ssm_train_step(cfg: SsmConfig, learning_rate: float = 1e-3,
                        optimizer: str = "adamw",
                        mesh: Optional[RankMesh] = None):
    """``(init_state, step)`` of next-token training.

    ``init_state(generator, device=None)`` draws fresh parameters
    (:func:`init_ssm_params`) and returns ``{"params", "opt", "step"}``:
    the optimizer :func:`~.transformer.make_optimizer`'s rule (``"adamw"``,
    ``"adafactor"`` or ``"sgd"``; another name raises ``ValueError``) over
    every leaf, ``"step"`` the count of updates.
    ``init_state.from_params(params)`` builds the state around a given tree
    (from :func:`ssm_params_from_jax`, say). ``step(state, tokens) ->
    (state, loss)`` takes ``(b, s + 1)`` tokens, the inputs ``tokens[:,
    :-1]`` and the targets ``tokens[:, 1:]``, runs one optimizer step and
    updates the state in place (the JAX step returns a new state); ``loss``
    is a 0-dim float32 tensor on the device.

    ``mesh`` is a :class:`RankMesh` with a ``dp`` axis (``ValueError``
    without one), whose ranks share one device; its other axes carry
    nothing, as in the JAX package. With ``dp`` above 1 the batch splits
    over the dp ranks and their gradients are summed on kernel 6 (see the
    module note); the batch must divide by dp (``ValueError``)."""
    if mesh is not None:
        if not isinstance(mesh, RankMesh):
            raise TypeError(f"mpi_tpu_torch: a mesh must be a RankMesh; got "
                            f"{type(mesh).__name__}")
        if "dp" not in mesh.axis_names:
            raise ValueError(f"mpi_tpu_torch: make_ssm_train_step shards "
                             f"the batch over a 'dp' axis; mesh "
                             f"{mesh.axis_names} has none")
        if mesh.shape["dp"] == 1:
            mesh = None
    build = make_optimizer(optimizer, learning_rate)

    def from_params(params: Dict[str, Any]) -> Dict[str, Any]:
        return {**train_state(params, build), "step": 0}

    def init_state(generator: torch.Generator, device: Device = None
                   ) -> Dict[str, Any]:
        return from_params(init_ssm_params(cfg, generator, device))

    def step(state: Dict[str, Any], tokens: torch.Tensor
             ) -> Tuple[Dict[str, Any], torch.Tensor]:
        params, opt = state["params"], state["opt"]
        tokens = tokens.to(_device_of(params))
        opt.zero_grad(set_to_none=True)
        if mesh is None:
            loss = _loss(cfg, params, tokens)
            loss.backward()
        else:
            ring = shared_ring(mesh, "dp", tokens, "make_ssm_train_step")
            loss = _dp_loss(cfg, params, tokens, ring)
        opt.step()
        state["step"] += 1
        return state, loss.detach()

    init_state.from_params = from_params
    return init_state, step


def ssm_params_from_jax(tree: Any, cfg: SsmConfig, device: Device = None
                        ) -> Dict[str, Any]:
    """The port's parameters from the JAX package's SSM tree (its
    ``init_ssm_params`` or a train state's ``"params"``), whose arrays the
    caller has turned into numpy arrays: each leaf a float32 tensor on
    ``device`` (the CUDA device unless the caller names another). Raises
    ``ValueError`` if the tree's keys, layer count or any leaf's shape
    disagree with ``cfg``."""
    dev = resolve_device(device)

    def walk(node: Any, want: Any, where: str) -> Any:
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                got = sorted(node) if isinstance(node, dict) else \
                    type(node).__name__
                raise ValueError(f"mpi_tpu_torch: SSM tree at {where or '/'}"
                                 f" holds {got}; cfg wants {sorted(want)}")
            return {k: walk(node[k], want[k], f"{where}/{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(want):
                got = len(node) if isinstance(node, (list, tuple)) else \
                    type(node).__name__
                raise ValueError(f"mpi_tpu_torch: SSM tree has {got} blocks;"
                                 f" cfg wants {len(want)} layers")
            return [walk(v, w, f"{where}/{i}")
                    for i, (v, w) in enumerate(zip(node, want))]
        t = _tensor(node, dev, torch.float32)
        if t.shape != want.shape:
            raise ValueError(f"mpi_tpu_torch: SSM tree's {where} has shape "
                             f"{tuple(t.shape)}; cfg wants "
                             f"{tuple(want.shape)}")
        return t

    shapes = init_ssm_params(cfg, torch.Generator(), "meta")
    return walk(tree, shapes, "")
