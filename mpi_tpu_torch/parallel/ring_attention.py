"""Ring attention: sequence parallelism over the ``sp`` ranks of a mesh.

Counterpart of ``mpi_tpu/parallel/ring_attention.py``. Each rank keeps its
query shard and passes its key/value shard around the ring; after ``n``
steps every query has seen every key. There a rank is a device inside
``shard_map`` and the hop is ``lax.ppermute``; here the ranks share one
device, a per-rank function takes the stacked view ``(n, b, s_local, h,
d)`` (rank r's shard at index r) over a :class:`RankMesh` of ``n`` ranks,
and the hop is kernel 7 (:func:`~mpi_tpu_torch.parallel.p2p.sendrecv`,
one launch over all ranks; its plain version on the CPU), with k and v
packed into one launch.

Two kinds of chunk, as in the JAX module:

* **fold** (:func:`ring_attention`, :func:`ring_attention_zigzag`): the
  einsum online-softmax fold (:func:`~mpi_tpu_torch.ops.attention.
  online_softmax_fold`) in plain PyTorch, differentiated by autograd (the
  hop's backward is the reverse hop);
* **flash** (:func:`ring_flash_attention`,
  :func:`ring_flash_attention_zigzag`): flash kernel 1 per chunk, merged
  through the log-sum-exp rows into a float32 output, and a
  ``torch.autograd.Function`` backward (the JAX ``custom_vjp``) of
  kernels 2 and 3 per chunk pair against the merged output and lse, with
  dk/dv travelling with their chunks and coming home after a last hop.

**One launch per case per ring step, not one per rank.** After step t
the kv resident at rank i came from ``src = (i − t) mod n``, so the JAX
per-device ``lax.cond(src > me)`` splits the stacked axis into two
contiguous ranges: ranks ``t..n−1`` hold a chunk from their past, ranks
``0..t−1`` one from their future. Each range is folded into the kernel's
batch, ``(g, b, …) → (g·b, …)``, and launched once. At sp = n a flash
call takes n launches of kernel 1 (contiguous) or 3 + 2(n − 1) (zigzag),
as many of kernels 2 and 3 in its backward, and n − 1 hops forward,
2(n − 1) + 1 backward.

Two layouts: **contiguous** (shard i holds positions ``[i·s_local,
(i+1)·s_local)``) and **zigzag** (the sequence cut into 2n chunks, shard
i holds chunks i and 2n−1−i, so causal work is the same on every rank at
every step). :func:`ring_attention_sharded` takes the JAX global layout
``(b, s, h, d)``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..ops.attention import (NEG_INF, flash_bwd_dkv, flash_bwd_dq,
                             flash_fwd, merge_attention_chunks,
                             online_softmax_fold)
from .mesh import RankMesh, mesh_device, shared_ring
from .p2p import ring_hop, ring_shift

__all__ = ["ring_attention", "ring_flash_attention",
           "ring_flash_attention_zigzag", "ring_attention_sharded",
           "ring_attention_zigzag", "zigzag_indices",
           "zigzag_inverse_indices"]


# --------------------------------------------------------------------------
# The stacked view (the ring and its hop: parallel/mesh.py, p2p.py)
# --------------------------------------------------------------------------

def _stacked_shape(q, k, v, mesh: RankMesh, what: str):
    """``(n, b, s_local, h, d)`` after checking the stacked shards."""
    if q.dim() != 5 or k.dim() != 5 or v.shape != k.shape:
        raise ValueError(
            f"mpi_tpu_torch: {what} wants stacked shards q (n, b, s, h, d) "
            f"and k, v (n, b, s, hk, d); got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != mesh.size or k.shape[:3] != q.shape[:3]:
        raise ValueError(
            f"mpi_tpu_torch: {what}: q {tuple(q.shape)} and k "
            f"{tuple(k.shape)} must hold one (b, s_local) shard per rank of "
            f"the {mesh.size}-rank ring")
    mesh_device(mesh, q, what)
    return tuple(q.shape)


def _tri(s: int, device) -> torch.Tensor:
    return (torch.arange(s, device=device)[:, None] >=
            torch.arange(s, device=device)[None, :])


# --------------------------------------------------------------------------
# Fold chunks (einsum online softmax, autograd)
# --------------------------------------------------------------------------

def _fold_start(q, k, v):
    """float32 queries, packed kv ``(n, 2, b, h, s, d)`` and the empty
    ``(m, l, acc)`` state, heads before sequence as the fold wants."""
    n, b, s, h, d = q.shape
    q32 = q.transpose(2, 3).float()
    kv = torch.stack([k.transpose(2, 3), v.transpose(2, 3)], 1)
    m = torch.full((n, b, h, s), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((n, b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((n, b, h, s, d), dtype=torch.float32, device=q.device)
    return q32, kv, (m, l, acc)


def _fold_end(q, m, l, acc):
    del m
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(2, 3).to(q.dtype)


def _cat_ranks(lo, hi):
    """Rank ranges ``[:t]`` and ``[t:]`` of each state tensor, rejoined."""
    return tuple(torch.cat([a, b]) for a, b in zip(lo, hi))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: RankMesh, causal: bool = True) -> torch.Tensor:
    """Ring attention with einsum fold chunks over the ranks of ``mesh``
    (contiguous layout). ``q, k, v`` are the stacked shards ``(n, b,
    s_local, h, d)`` with equal head counts; returns the same shape in q's
    dtype. Differentiable through autograd."""
    n = _stacked_shape(q, k, v, mesh, "ring_attention")[0]
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, kv, state = _fold_start(q, k, v)
    for step in range(n):
        if step == 0:
            mask = _tri(q.shape[2], q.device) if causal else None
            state = online_softmax_fold(q32, kv[:, 0], kv[:, 1], *state,
                                        scale, mask=mask)
        elif causal:
            # Ranks step..n-1 hold a chunk wholly in their past: every key;
            # ranks 0..step-1 one wholly in their future: skipped.
            part = online_softmax_fold(
                q32[step:], kv[step:, 0], kv[step:, 1],
                *(x[step:] for x in state), scale)
            state = _cat_ranks((x[:step] for x in state), part)
        else:
            state = online_softmax_fold(q32, kv[:, 0], kv[:, 1], *state,
                                        scale)
        if step + 1 < n:
            # Neighbour hop: kv moves, queries stay.
            kv = ring_shift(kv, mesh)
    return _fold_end(q, *state)


def ring_attention_zigzag(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mesh: RankMesh) -> torch.Tensor:
    """Causal ring attention with fold chunks under the zigzag layout:
    each stacked shard's first half is global chunk r, its second chunk
    2n−1−r (c positions each). Per step, with the visiting kv from src:

    * ``src < r`` (ranks step..n−1): every query × the early kv half;
    * ``src > r`` (ranks 0..step−1): the late queries × both kv halves;
    * step 0: the self block, triangular early and late halves plus the
      full late × early block, as one masked fold."""
    n, _, s_local, _, _ = _stacked_shape(q, k, v, mesh,
                                         "ring_attention_zigzag")
    if s_local % 2:
        raise ValueError("mpi_tpu_torch: zigzag shards must have even local "
                         "length")
    c = s_local // 2
    scale = 1.0 / math.sqrt(q.shape[-1])
    q32, kv, state = _fold_start(q, k, v)
    tri = _tri(c, q.device)
    full = torch.ones((c, c), dtype=torch.bool, device=q.device)
    mask0 = torch.cat([torch.cat([tri, ~full], 1), torch.cat([full, tri], 1)])
    state = online_softmax_fold(q32, kv[:, 0], kv[:, 1], *state, scale,
                                mask=mask0)
    for step in range(1, n):
        kv = ring_shift(kv, mesh)
        m, l, acc = state
        past = online_softmax_fold(
            q32[step:], kv[step:, 0, ..., :c, :], kv[step:, 1, ..., :c, :],
            m[step:], l[step:], acc[step:], scale)
        m2, l2, acc2 = online_softmax_fold(
            q32[:step, ..., c:, :], kv[:step, 0], kv[:step, 1],
            m[:step, ..., c:], l[:step, ..., c:], acc[:step, ..., c:, :],
            scale)
        future = (torch.cat([m[:step, ..., :c], m2], -1),
                  torch.cat([l[:step, ..., :c], l2], -1),
                  torch.cat([acc[:step, ..., :c, :], acc2], -2))
        state = _cat_ranks(future, past)
    return _fold_end(q, *state)


# --------------------------------------------------------------------------
# Flash chunks (kernels 1-3, one launch per rank range)
# --------------------------------------------------------------------------

def _fold_batch(x: torch.Tensor) -> torch.Tensor:
    """``(g, b, …)`` → a contiguous ``(g·b, …)`` for the kernels."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).contiguous()


def _check_square(q, k, causal: bool) -> None:
    """The kernels align a causal mask at the top left, which is right
    only for the square self blocks this module asks for: a causal chunk
    with s ≠ t raises rather than mean something else."""
    if causal and k.shape[2] != q.shape[2]:
        raise ValueError(f"mpi_tpu_torch: a causal ring chunk must be "
                         f"square; got {q.shape[2]} queries and "
                         f"{k.shape[2]} keys")


def _chunk_fwd(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1 over a rank range: q ``(g, b, s, h, d)``, k/v ``(g, b, t,
    hk, d)`` → out ``(g, b, s, h, d)`` and lse ``(g, b, h, s)``."""
    _check_square(q, k, causal)
    g, b = q.shape[:2]
    out, lse = flash_fwd(_fold_batch(q), _fold_batch(k), _fold_batch(v),
                         causal)
    return out.reshape(q.shape), lse.reshape(g, b, *lse.shape[1:])


def _chunk_bwd(q, k, v, g, lse, delta, causal: bool):
    """Kernels 2 (δ given) and 3 over a rank range: the pair's ``(dq,
    dk, dv)`` contributions (in the inputs' dtype; the callers add them
    into float32 accumulators) against the merged softmax rows ``lse``
    and ``delta`` ``(g, b, h, s)``."""
    _check_square(q, k, causal)
    args = [_fold_batch(x) for x in (q, k, v, g, lse, delta)]
    dq = flash_bwd_dq(*args, causal)
    dk, dv = flash_bwd_dkv(*args, causal)
    return dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)


def _merge_into(out, lse, oc, lc) -> None:
    """Merge a chunk result into views of the running float32 state."""
    o_m, l_m = merge_attention_chunks(out, lse, oc, lc)
    out.copy_(o_m)
    lse.copy_(l_m)


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) ``(n, b, h, s)`` from the merged float32 output,
    once per query shard (kernel 2 is then called with δ given)."""
    return (g.float() * out).sum(-1).transpose(-1, -2).contiguous()


class _RingFlash(torch.autograd.Function):
    """Contiguous-layout ring of flash chunks; see the module note."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal):
        n = q.shape[0]
        kv = torch.stack([k, v], 1)
        # Step 0: the resident (diagonal) chunk, causal within the chunk.
        # The running output stays float32 across the ring, one cast at
        # the end, as the JAX function keeps it.
        out, lse = _chunk_fwd(q, kv[:, 0], kv[:, 1], causal)
        out = out.float()
        for step in range(1, n):
            kv = ring_hop(kv, mesh)
            lo = step if causal else 0  # causal: ranks 0..step-1 skip
            oc, lc = _chunk_fwd(q[lo:], kv[lo:, 0], kv[lo:, 1], False)
            _merge_into(out[lo:], lse[lo:], oc, lc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh, ctx.causal = mesh, causal
        return out.to(q.dtype, copy=True)  # out itself stays saved

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, causal, n = ctx.mesh, ctx.causal, q.shape[0]
        g = g.contiguous()
        delta = _delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        # dk/dv travel with their kv chunks and are home after a last hop.
        dkv = torch.zeros((n, 2, *k.shape[1:]), dtype=torch.float32,
                          device=q.device)
        kv = torch.stack([k, v], 1)
        for step in range(n):
            if step:
                kv = ring_hop(kv, mesh)
                dkv = ring_hop(dkv, mesh)
            lo = step if causal else 0
            dql, dkl, dvl = _chunk_bwd(q[lo:], kv[lo:, 0], kv[lo:, 1],
                                       g[lo:], lse[lo:], delta[lo:],
                                       causal and step == 0)
            dq[lo:] += dql
            dkv[lo:, 0] += dkl
            dkv[lo:, 1] += dvl
        dkv = ring_hop(dkv, mesh)
        return (dq.to(q.dtype), dkv[:, 0].to(k.dtype), dkv[:, 1].to(v.dtype),
                None, None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mesh: RankMesh, causal: bool = True) -> torch.Tensor:
    """Ring attention whose chunks run the flash kernels (contiguous
    layout). ``q`` ``(n, b, s_local, h, d)``, k/v ``(n, b, s_local, hk,
    d)`` with ``h % hk == 0``, stacked over the ranks of ``mesh``; returns
    ``(n, b, s_local, h, d)`` in q's dtype. Differentiable: the backward
    re-rotates kv and runs kernels 2 and 3 per chunk pair against the
    merged float32 output and lse, dk/dv accumulating in float32 on the
    travelling chunks. CUDA tensors launch the kernels; CPU tensors run
    their plain versions."""
    _stacked_shape(q, k, v, mesh, "ring_flash_attention")
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mesh, causal)


class _RingFlashZigzag(torch.autograd.Function):
    """Zigzag-layout ring of flash chunks; see
    :func:`ring_flash_attention_zigzag`."""

    @staticmethod
    def forward(ctx, q, k, v, mesh):
        n, c = q.shape[0], q.shape[2] // 2
        kv = torch.stack([k, v], 1)
        # Self step: early x early and late x late are causal square
        # blocks; late x early is full (the early chunk is wholly past).
        o_e, l_e = _chunk_fwd(q[:, :, :c], kv[:, 0, :, :c], kv[:, 1, :, :c],
                              True)
        o_l, l_l = _chunk_fwd(q[:, :, c:], kv[:, 0, :, c:], kv[:, 1, :, c:],
                              True)
        out = torch.cat([o_e, o_l], 2).float()
        lse = torch.cat([l_e, l_l], -1)
        oc, lc = _chunk_fwd(q[:, :, c:], kv[:, 0, :, :c], kv[:, 1, :, :c],
                            False)
        _merge_into(out[:, :, c:], lse[..., c:], oc, lc)
        for step in range(1, n):
            kv = ring_hop(kv, mesh)
            # Ranks step..n-1 (src < r): every query x the early kv half.
            oc, lc = _chunk_fwd(q[step:], kv[step:, 0, :, :c],
                                kv[step:, 1, :, :c], False)
            _merge_into(out[step:], lse[step:], oc, lc)
            # Ranks 0..step-1 (src > r): the late queries x both halves.
            oc, lc = _chunk_fwd(q[:step, :, c:], kv[:step, 0], kv[:step, 1],
                                False)
            _merge_into(out[:step, :, c:], lse[:step, ..., c:], oc, lc)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mesh = mesh
        return out.to(q.dtype, copy=True)  # out itself stays saved

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, n, c = ctx.mesh, q.shape[0], q.shape[2] // 2
        g = g.contiguous()
        delta = _delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dkv = torch.zeros((n, 2, *k.shape[1:]), dtype=torch.float32,
                          device=q.device)
        kv = torch.stack([k, v], 1)
        # Self step: the forward's three sub-pairs as (q_lo, kv_lo, causal).
        for q_lo, kv_lo, causal in ((0, 0, True), (c, c, True),
                                    (c, 0, False)):
            qs, ks = slice(q_lo, q_lo + c), slice(kv_lo, kv_lo + c)
            dql, dkl, dvl = _chunk_bwd(
                q[:, :, qs], kv[:, 0, :, ks], kv[:, 1, :, ks], g[:, :, qs],
                lse[..., qs], delta[..., qs], causal)
            dq[:, :, qs] += dql
            dkv[:, 0, :, ks] += dkl
            dkv[:, 1, :, ks] += dvl
        for step in range(1, n):
            kv = ring_hop(kv, mesh)
            dkv = ring_hop(dkv, mesh)
            dql, dkl, dvl = _chunk_bwd(
                q[step:], kv[step:, 0, :, :c], kv[step:, 1, :, :c], g[step:],
                lse[step:], delta[step:], False)
            dq[step:] += dql
            dkv[step:, 0, :, :c] += dkl
            dkv[step:, 1, :, :c] += dvl
            dql, dkl, dvl = _chunk_bwd(
                q[:step, :, c:], kv[:step, 0], kv[:step, 1], g[:step, :, c:],
                lse[:step, ..., c:], delta[:step, ..., c:], False)
            dq[:step, :, c:] += dql
            dkv[:step, 0] += dkl
            dkv[:step, 1] += dvl
        dkv = ring_hop(dkv, mesh)
        return (dq.to(q.dtype), dkv[:, 0].to(k.dtype), dkv[:, 1].to(v.dtype),
                None)


def ring_flash_attention_zigzag(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor,
                                mesh: RankMesh) -> torch.Tensor:
    """Causal zigzag ring attention with flash chunks: the balanced
    layout of :func:`ring_attention_zigzag` with the kernels and backward
    of :func:`ring_flash_attention`. Per step the case split maps onto
    plain causal or full kernel calls on chunk slices:

    * self step: early × early and late × late (causal, square), late ×
      early (full) — three launches over every rank;
    * ranks ``step..n−1`` (src < r): all queries × the kv early half
      (full, 2c × c);
    * ranks ``0..step−1`` (src > r): the late queries × both kv halves
      (full, c × 2c)."""
    _, _, s_local, _, _ = _stacked_shape(q, k, v, mesh,
                                         "ring_flash_attention_zigzag")
    if s_local % 2:
        raise ValueError("mpi_tpu_torch: zigzag shards must have even local "
                         "length")
    return _RingFlashZigzag.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), mesh)


# --------------------------------------------------------------------------
# Zigzag layout and the global-layout wrapper
# --------------------------------------------------------------------------

def zigzag_indices(n: int, s: int) -> np.ndarray:
    """Global→zigzag gather indices: position ``j`` of the permuted
    sequence (which shards contiguously onto ``n`` ranks) reads global
    position ``zigzag_indices(n, s)[j]``. Shard ``i`` ends up holding
    chunks ``i`` and ``2n-1-i`` of the ``2n``-chunk split."""
    if s % (2 * n):
        raise ValueError(
            f"mpi_tpu_torch: zigzag layout needs seq ({s}) divisible by "
            f"2*ring size ({2 * n})")
    c = s // (2 * n)
    idx = []
    for i in range(n):
        idx.append(np.arange(i * c, (i + 1) * c))
        idx.append(np.arange((2 * n - 1 - i) * c, (2 * n - i) * c))
    return np.concatenate(idx)


def zigzag_inverse_indices(n: int, s: int) -> np.ndarray:
    """Inverse permutation: undoes :func:`zigzag_indices`."""
    fwd = zigzag_indices(n, s)
    inv = np.empty_like(fwd)
    inv[fwd] = np.arange(s)
    return inv


def _to_ranks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Global ``(b, s, h, d)`` → stacked ``(n, b, s/n, h, d)``."""
    b, s = x.shape[:2]
    if s % n:
        raise ValueError(f"mpi_tpu_torch: sequence {s} does not split over "
                         f"{n} ranks")
    return x.reshape(b, n, s // n, *x.shape[2:]).transpose(0, 1).contiguous()


def _from_ranks(x: torch.Tensor) -> torch.Tensor:
    """Stacked ``(n, b, s_local, h, d)`` → global ``(b, n·s_local, h, d)``."""
    n, b, s = x.shape[:3]
    return x.transpose(0, 1).reshape(b, n * s, *x.shape[3:])


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: RankMesh, axis_name: str = "sp",
                           causal: bool = True, layout: str = "contiguous",
                           chunk_impl: str = "fold") -> torch.Tensor:
    """Global ``(b, s, h, d)`` tensors in, ring attention over the
    ``axis_name`` ranks of ``mesh``, global tensors out.

    The sequence splits into one stacked shard per ``axis_name`` rank.
    The JAX function also shards batch and heads over the mesh's ``dp``
    and ``tp`` axes (its ``batch_axis`` / ``head_axis``); here those ranks
    share the device, so their shards are the batch and head dimensions
    of the same launches and need no argument. ``layout="zigzag"`` (causal only) permutes the sequence
    into the zigzag order, runs the zigzag body and permutes back.
    ``chunk_impl`` is ``"fold"`` (einsum, autograd) or ``"flash"`` (the
    kernels, with their FA-2 backward)."""
    ring = shared_ring(mesh, axis_name, q, "ring attention")
    if chunk_impl not in ("fold", "flash"):
        raise ValueError(
            f"mpi_tpu_torch: unknown ring chunk_impl {chunk_impl!r}: "
            f"expected fold|flash")
    n = ring.size
    if layout == "zigzag":
        if not causal:
            raise ValueError(
                "mpi_tpu_torch: zigzag layout only applies to causal "
                "attention (non-causal work is already balanced)")
        s = q.shape[1]
        fwd = torch.as_tensor(zigzag_indices(n, s), device=q.device)
        inv = torch.as_tensor(zigzag_inverse_indices(n, s), device=q.device)
        body = (ring_flash_attention_zigzag if chunk_impl == "flash"
                else ring_attention_zigzag)
        out = body(*(_to_ranks(x.index_select(1, fwd), n) for x in (q, k, v)),
                   ring)
        return _from_ranks(out).index_select(1, inv)
    if layout != "contiguous":
        raise ValueError(
            f"mpi_tpu_torch: unknown ring layout {layout!r}: "
            f"expected contiguous|zigzag")
    body = ring_flash_attention if chunk_impl == "flash" else ring_attention
    return _from_ranks(body(*(_to_ranks(x, n) for x in (q, k, v)), ring,
                            causal))
