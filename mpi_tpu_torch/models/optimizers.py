"""optax's update rules and learning-rate schedules, for the training step.

The JAX package takes its optimizers from optax
(``mpi_tpu/models/transformer.py:436-467``: ``optax.adamw``,
``optax.adafactor``, ``optax.sgd(momentum=0.9)``, and
``warmup_cosine_decay_schedule`` or ``linear_schedule``). The port imports
no optax, so this module holds optax 0.2.6's rules:

* :class:`Adafactor`: optax's ``adafactor`` with its defaults, not
  ``torch.optim.Adafactor`` (another rule). ``scale_by_factored_rms``: the
  second moment decays at ``1 − (t+1)^−0.8``, g² gets eps 1e-30, and a
  leaf whose second largest dimension is at least 128 is factored over its
  two largest dimensions (:func:`factored_dims`) into a row and a column
  moment; then ``clip_by_block_rms(1.0)``, the learning rate,
  ``scale_by_param_block_rms`` (the parameter's RMS, at least 1e-3) and
  −1. The block RMS terms and the factored means are taken over each
  whole leaf: the port holds every leaf whole on one device, its tp ranks'
  slices being views (``parallel/tensor_parallel.py``), so none of them
  needs a tp reduction. Under ZeRO-1 and FSDP a leaf lives as its dp
  ranks' pieces in one device buffer: the rule puts the whole leaf and its
  reduced gradient back together from them (``parallel/zero.py``'s
  ``unshard``), keeps the moments of the whole leaf, and writes each
  rank's part of the update into its piece.
* sgd: ``torch.optim.SGD(momentum=0.9)``, whose momentum (dampening 0,
  the first buffer the gradient itself) is optax's ``trace``.
* adamw: ``torch.optim.AdamW`` with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8, weight decay 1e-4, scaled by the rate as optax does).
* :func:`learning_rate_schedule`: update k takes the rate at count k, as
  optax's ``scale_by_schedule`` does, so under a warmup the first update
  has rate 0.0. The rates are computed in float32, as optax computes them.
  The count lives in each param group (``SCHEDULE_COUNT``), where optax
  keeps it in the optimizer state: ``state_dict()`` saves it and
  ``load_state_dict()`` restores it, so a resumed optimizer continues the
  curve at the restored count.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.zero import pieces_view, unshard

__all__ = ["SCHEDULE_COUNT", "factored_dims", "Adafactor",
           "linear_schedule", "warmup_cosine_decay_schedule",
           "learning_rate_schedule", "build_optimizer"]

Schedule = Callable[[int], float]
_F32 = np.float32
# optax.adafactor's defaults, the JAX package's only use of it.
_MIN_DIM_SIZE_TO_FACTOR = 128
_DECAY_RATE = 0.8
_EPS = 1e-30
_CLIPPING_THRESHOLD = 1.0
_MIN_SCALE = 1e-3
# The param-group key of a scheduled optimizer's update count.
SCHEDULE_COUNT = "schedule_count"


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the second largest and the largest
    dimension of ``shape`` (numpy's argsort decides ties), or None when the
    leaf has fewer than two dimensions or the second largest is under
    128."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < _MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """optax 0.2.6's ``adafactor(learning_rate=lr)`` with its defaults
    (see the module note). The state of each leaf holds ``step`` (the
    update count) and ``v_row``, ``v_col`` and ``v``, shaped as optax's:
    the row and column moments of a factored leaf with ``v`` a ``(1,)``
    zero, or the full moment ``v`` with ``(1,)`` zeros for the others.

    A param group whose ``pieces_dim`` is a dimension ``d`` holds leaves
    given as their dp ranks' stacked pieces along ``d``, ``(n, ..., k,
    ...)`` (``parallel.zero.pieces_view``; ZeRO-1's and FSDP's buffers):
    the rule runs on the whole leaf, with the state of the whole leaf, and
    each piece takes its part of the update."""

    def __init__(self, params, lr: float = 1e-3):
        super().__init__(params, dict(lr=lr, pieces_dim=None))

    def _init_state(self, p: torch.Tensor, dims) -> dict:
        one = p.new_zeros(1)
        if dims is None:
            return {"step": 0, "v_row": one, "v_col": one.clone(),
                    "v": torch.zeros_like(p)}
        d1, d0 = dims
        shape = list(p.shape)
        return {"step": 0,
                "v_row": p.new_zeros(shape[:d0] + shape[d0 + 1:]),
                "v_col": p.new_zeros(shape[:d1] + shape[d1 + 1:]),
                "v": one}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            dim = group["pieces_dim"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                whole, g = ((p, p.grad) if dim is None else
                            (unshard(p, dim), unshard(p.grad, dim)))
                dims = factored_dims(whole.shape)
                state = self.state[p]
                if not state:
                    state.update(self._init_state(whole, dims))
                t = _F32(state["step"] + 1)
                decay = float(_F32(1) - t ** _F32(-_DECAY_RATE))
                g2 = g * g + _EPS
                if dims is not None:
                    d1, d0 = dims
                    v_row = state["v_row"].mul_(decay).add_(
                        g2.mean(d0), alpha=1 - decay)
                    v_col = state["v_col"].mul_(decay).add_(
                        g2.mean(d1), alpha=1 - decay)
                    reduced_d1 = d1 - 1 if d1 > d0 else d1
                    row_factor = (v_row / v_row.mean(
                        reduced_d1, keepdim=True)) ** -0.5
                    u = (g * row_factor.unsqueeze(d0)
                         * (v_col ** -0.5).unsqueeze(d1))
                else:
                    v = state["v"].mul_(decay).add_(g2, alpha=1 - decay)
                    u = g * v ** -0.5
                rms = u.square().mean().sqrt()
                u = u / torch.clamp(rms / _CLIPPING_THRESHOLD, min=1.0)
                u = u * group["lr"]
                p_rms = whole.square().mean().sqrt()
                u = u * torch.where(p_rms <= _MIN_SCALE, _MIN_SCALE, p_rms)
                p.sub_(u if dim is None else pieces_view(u, dim, p.shape[0]))
                state["step"] += 1
        return loss


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax's ``linear_schedule``: ``init_value`` to ``end_value`` over
    ``transition_steps`` counts, then ``end_value``; with no transition
    steps, ``init_value`` throughout."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = _F32(1) - _F32(min(max(count, 0), transition_steps)) \
            / _F32(transition_steps)
        return float(_F32(init_value - end_value) * frac + _F32(end_value))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float) -> Schedule:
    """optax's ``warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps`` (counted from 0), held
    there."""
    span = decay_steps - warmup_steps
    if span <= 0:
        raise ValueError(f"mpi_tpu_torch: the cosine decay needs positive "
                         f"decay steps; got total {decay_steps} with warmup "
                         f"{warmup_steps}")
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return warmup(count)
        c = _F32(min(count - warmup_steps, span))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c
                                               / _F32(span)))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return float(_F32(peak_value) * decayed)

    return schedule


def learning_rate_schedule(learning_rate: float, warmup_steps: int = 0,
                           total_steps: Optional[int] = None
                           ) -> Optional[Schedule]:
    """The JAX package's schedule choice: with ``total_steps``, warmup over
    ``max(warmup_steps, 1)`` into cosine decay to a tenth of the peak at
    ``total_steps``; with ``warmup_steps`` alone, linear warmup then the
    constant rate; otherwise None (a constant ``learning_rate``)."""
    if total_steps is not None:
        return warmup_cosine_decay_schedule(
            0.0, learning_rate, max(warmup_steps, 1), total_steps,
            0.1 * learning_rate)
    if warmup_steps:
        return linear_schedule(0.0, learning_rate, warmup_steps)
    return None


def build_optimizer(optimizer: str, leaves: List[torch.Tensor],
                    learning_rate: float,
                    schedule: Optional[Schedule]) -> torch.optim.Optimizer:
    """``optimizer`` (adamw, adafactor or sgd) over ``leaves``; with a
    ``schedule``, each ``step()`` first sets in every group the rate of the
    group's update count (``group[SCHEDULE_COUNT]``: 0, 1, ...), then
    counts the update."""
    if optimizer == "adamw":
        opt = torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
    elif optimizer == "sgd":
        opt = torch.optim.SGD(leaves, lr=learning_rate, momentum=0.9)
    else:
        opt = Adafactor(leaves, lr=learning_rate)
    if schedule is not None:
        for group in opt.param_groups:
            group[SCHEDULE_COUNT] = 0

        def set_rate(o, args, kwargs):
            for group in o.param_groups:
                group["lr"] = schedule(group[SCHEDULE_COUNT])
                group[SCHEDULE_COUNT] += 1

        opt.register_step_pre_hook(set_rate)
    return opt
