"""Attention ops of the port: the dense oracle and flash attention
(counterpart of ``mpi_tpu/ops/attention.py``).

:func:`flash_attention` is a ``torch.autograd.Function`` over three
hand-written CUDA kernels (``csrc/flash_attention.cu``; see the note there
for their design and what bounds them): the forward (kernel 1, which also
emits the per-row log-sum-exp) and the FlashAttention-2 backward, dq
(kernel 2, which can also compute δ = rowsum(dO∘O) itself) and dk/dv
(kernel 3), which rebuild the probabilities from ``(q, k, lse)``. Each
kernel's wrapper (:func:`flash_fwd`, :func:`flash_bwd_dq` and
:func:`flash_bwd_dq_delta`, :func:`flash_bwd_dkv`) launches it for CUDA
tensors and counts the launch in its ``launches`` (both kernel 2 wrappers
in ``flash_bwd_dq.launches``); for CPU tensors it runs the
plain PyTorch version of the same function
(:func:`flash_attention_fwd_plain`, :func:`flash_attention_bwd_plain`); on
any other device, or on an input the kernel does not take, it raises.

Layouts are the JAX package's: q/k/v ``(b, s, h, d)``, where k/v may carry
fewer (grouped, GQA) heads that divide h, and lse ``(b, h, s)`` float32.
The mask is ``col < t`` and, when causal, ``row >= col``, aligned at the
top left.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import _build

__all__ = ["NEG_INF", "dense_attention", "flash_attention",
           "flash_attention_with_lse", "flash_chunk_bwd",
           "flash_attention_fwd_plain", "flash_attention_bwd_plain",
           "flash_fwd", "flash_bwd_dq", "flash_bwd_dq_delta",
           "flash_bwd_dkv"]

NEG_INF = -1e30  # finite mask value: keeps exp() well-defined everywhere
_KERNEL_HEAD_DIMS = (64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Materialised-logits attention. q/k/v ``(b, s, h, d)`` with equal
    head counts; softmax in float32, probabilities cast back to q's dtype
    before the PV product, as the JAX oracle does."""
    logits = torch.einsum("bshk,bthk->bhst", q, k) * (1.0 / math.sqrt(
        q.shape[-1]))
    if causal:
        s = q.shape[1]
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhst,bthk->bshk", probs.to(q.dtype), v)


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------

def _shapes(q, k, v) -> Tuple[int, int, int, int, int, int]:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"mpi_tpu_torch: flash attention wants q (b, s, h, d) and k, v "
            f"(b, t, hk, d) of one shape; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    bk, t, hk, dk = k.shape
    if bk != b or dk != d:
        raise ValueError(f"mpi_tpu_torch: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on batch or head_dim")
    if h % hk:
        raise ValueError(f"mpi_tpu_torch: flash attention kv heads ({hk}) "
                         f"must divide query heads ({h})")
    if not (q.device == k.device == v.device):
        raise ValueError("mpi_tpu_torch: q, k and v lie on different "
                         "devices")
    return b, s, h, d, t, hk


def _valid(s: int, t: int, causal: bool, device) -> torch.Tensor:
    """(s, t) bool: True where a query row attends a key column (every
    column exists here, so only the causal rule masks)."""
    if not causal:
        return torch.ones((s, t), dtype=torch.bool, device=device)
    return (torch.arange(s, device=device)[:, None] >=
            torch.arange(t, device=device)[None, :])


def _grouped(q, hk):
    """q (b, s, h, d) as float32 (b, s, hk, group, d)."""
    b, s, h, d = q.shape
    return q.float().reshape(b, s, hk, h // hk, d)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 1; returns ``(out, lse)``.

    The kernel's arithmetic contract: logits from q and k in their stored
    dtype with float32 accumulation (products of bf16 values are exact in
    float32), softmax state in float32, p cast to v's dtype before the PV
    product, out in q's dtype and lse = m + log(l) in float32. The
    softmax is taken at each row's global max, where the kernel takes it
    tile by tile at the running max; in float32 the two agree to rounding,
    in bf16 they round p at different scales."""
    b, s, h, d, t, hk = _shapes(q, k, v)
    valid = _valid(s, t, causal, q.device)
    logits = torch.einsum("bsKgd,btKd->bKgst", _grouped(q, hk),
                          k.float()) * (1.0 / math.sqrt(d))
    logits = logits.masked_fill(~valid, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bKgst,btKd->bKgsd", p.to(v.dtype).float(), v.float())
    out = (acc / l[..., None]).reshape(b, h, s, d).transpose(1, 2)
    return (out.to(q.dtype).contiguous(),
            (m + torch.log(l)).reshape(b, h, s))


def _bwd_plain(q, k, v, g, lse, delta, causal):
    """dq, dk, dv from dout ``g``, ``lse`` and ``delta`` (both (b, h, s)
    float32): the arithmetic of kernels 2 and 3."""
    b, s, h, d, t, hk = _shapes(q, k, v)
    scale = 1.0 / math.sqrt(d)
    valid = _valid(s, t, causal, q.device)
    qf, gf = _grouped(q, hk), _grouped(g, hk)
    kf, vf = k.float(), v.float()
    rows = (b, hk, h // hk, s)
    logits = torch.einsum("bsKgd,btKd->bKgst", qf, kf) * scale
    p = torch.exp(logits - lse.reshape(rows)[..., None]).masked_fill(
        ~valid, 0.0)
    dv = torch.einsum("bKgst,bsKgd->btKd", p.to(g.dtype).float(), gf)
    dp = torch.einsum("bsKgd,btKd->bKgst", gf, vf)
    ds = p * (dp - delta.reshape(rows)[..., None]) * scale
    dk = torch.einsum("bKgst,bsKgd->btKd", ds.to(q.dtype).float(), qf)
    dq = torch.einsum("bKgst,btKd->bsKgd", ds.to(k.dtype).float(), kf)
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """δ = rowsum(dO ∘ O) in float32, (b, h, s): the plain version of
    what kernel 2 computes in its prologue (the JAX package computes it
    outside its kernels)."""
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of kernels 2 and 3; returns ``(dq, dk, dv)``.

    p = exp(logits − lse) rebuilt and masked to 0, dv = pᵀ·dO with p in
    dO's dtype, ds = p∘(dP − δ)·scale cast to k's / q's dtype before
    dq = ds·K and dk = dsᵀ·Q; float32 accumulation, outputs in q's, k's
    and v's dtype. GQA gradients sum over each kv head's group."""
    return _bwd_plain(q, k, v, g, lse, _delta(out, g), causal)


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

@functools.cache
def _kernel_lib():
    """The built library, with the C signatures declared once."""
    lib = _build.load("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    shape = [i32] * 7 + [ctypes.c_float, i32, ptr]
    lib.flash_fwd.argtypes = [ptr] * 5 + shape
    lib.flash_bwd_dq.argtypes = [ptr] * 7 + shape
    lib.flash_bwd_dq_delta.argtypes = [ptr] * 8 + shape
    lib.flash_bwd_dkv.argtypes = [ptr] * 8 + shape
    for fn in (lib.flash_fwd, lib.flash_bwd_dq, lib.flash_bwd_dq_delta,
               lib.flash_bwd_dkv):
        fn.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check_kernel_inputs(name, tensors, rows=()):
    """Raise unless the kernel takes these tensors: one float32 or bf16
    dtype, head_dim 64 or 128, contiguous, 16-byte aligned; ``rows`` are
    the float32 (b, h, s) lse/delta tensors."""
    q = tensors[0]
    if q.dtype not in _KERNEL_DTYPES or any(x.dtype != q.dtype
                                            for x in tensors):
        raise TypeError(
            f"mpi_tpu_torch: {name} takes float32 or bfloat16, one dtype "
            f"for all of q, k, v (and dout); got "
            f"{[str(x.dtype) for x in tensors]}")
    if q.shape[-1] not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mpi_tpu_torch: {name} takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}; got {q.shape[-1]}")
    if any(r.dtype != torch.float32 for r in rows):
        raise TypeError(f"mpi_tpu_torch: {name} takes float32 lse and "
                        f"delta")
    every = (*tensors, *rows)
    if any(x.device != q.device for x in every):
        raise ValueError(f"mpi_tpu_torch: {name}: inputs lie on different "
                         f"devices")
    if not all(x.is_contiguous() for x in every):
        raise ValueError(f"mpi_tpu_torch: {name} needs contiguous inputs")
    if any(x.data_ptr() % 16 for x in every):
        raise ValueError(f"mpi_tpu_torch: {name} needs 16-byte aligned "
                         f"inputs")
    if q.shape[1] < 1:
        raise ValueError(f"mpi_tpu_torch: {name} needs s >= 1; got "
                         f"{tuple(q.shape)}")


def _bwd_shapes(name, q, k, v, g, *rows):
    """Check dout ``g`` against q and each (b, h, s) row tensor (lse,
    delta)."""
    _shapes(q, k, v)
    if g.shape != q.shape:
        raise ValueError(f"mpi_tpu_torch: {name}: dout {tuple(g.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    b, s, h, _ = q.shape
    for r in rows:
        if tuple(r.shape) != (b, h, s):
            raise ValueError(f"mpi_tpu_torch: {name} wants lse/delta of "
                             f"shape {(b, h, s)}; got {tuple(r.shape)}")


def _raise_on(err: int, name: str) -> None:
    if err:
        msg = _kernel_lib().flash_attention_error_string(err).decode()
        raise RuntimeError(f"mpi_tpu_torch: {name} kernel launch failed: "
                           f"{msg} (cudaError {err})")


def _dims(q, k, causal):
    b, s, h, d = q.shape
    t, hk = k.shape[1], k.shape[2]
    return (b, s, t, h, hk, d, int(bool(causal)), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)


def _device(name, x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"mpi_tpu_torch: {name} runs on cuda (kernel) or "
                         f"cpu (plain); got {x.device}")
    return x.device.type


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: ``(out, lse)`` of flash attention. CUDA tensors launch
    the kernel (counted in ``flash_fwd.launches``); CPU tensors run
    :func:`flash_attention_fwd_plain`."""
    _shapes(q, k, v)
    if _device("flash_fwd", q) == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal)
    _check_kernel_inputs("flash_fwd", (q, k, v))
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _raise_on(_kernel_lib().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_dims(q, k, causal)), "flash_fwd")
    flash_fwd.launches += 1
    return out, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """Kernel 2: dq from dout ``g``, ``lse`` and ``delta`` (both (b, h, s)
    float32). CUDA tensors launch the kernel (``flash_bwd_dq.launches``);
    CPU tensors run the plain version."""
    _bwd_shapes("flash_bwd_dq", q, k, v, g, lse, delta)
    if _device("flash_bwd_dq", q) == "cpu":
        return _bwd_plain(q, k, v, g, lse, delta, causal)[0]
    _check_kernel_inputs("flash_bwd_dq", (q, k, v, g), (lse, delta))
    dq = torch.empty_like(q)
    _raise_on(_kernel_lib().flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal)), "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dq_delta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       g: torch.Tensor, lse: torch.Tensor, out: torch.Tensor,
                       causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2 from the forward's ``out``: ``(dq, delta)``, where the
    kernel computes delta = rowsum(dO∘O) ((b, h, s) float32) for its own
    rows before its first tile and writes it for kernel 3. CUDA tensors
    launch the kernel (``flash_bwd_dq.launches``); CPU tensors run the
    plain version."""
    _bwd_shapes("flash_bwd_dq_delta", q, k, v, g, lse)
    if out.shape != q.shape:
        raise ValueError(f"mpi_tpu_torch: flash_bwd_dq_delta: out "
                         f"{tuple(out.shape)} must have q's shape "
                         f"{tuple(q.shape)}")
    if _device("flash_bwd_dq_delta", q) == "cpu":
        delta = _delta(out, g)
        return _bwd_plain(q, k, v, g, lse, delta, causal)[0], delta
    _check_kernel_inputs("flash_bwd_dq_delta", (q, k, v, g, out), (lse,))
    b, s, h, _ = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _raise_on(_kernel_lib().flash_bwd_dq_delta(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), out.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, causal)), "flash_bwd_dq_delta")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 3: ``(dk, dv)``, summed over each kv head's group of query
    heads. CUDA tensors launch the kernel (``flash_bwd_dkv.launches``);
    CPU tensors run the plain version."""
    _bwd_shapes("flash_bwd_dkv", q, k, v, g, lse, delta)
    if _device("flash_bwd_dkv", q) == "cpu":
        return _bwd_plain(q, k, v, g, lse, delta, causal)[1:]
    _check_kernel_inputs("flash_bwd_dkv", (q, k, v, g), (lse, delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _raise_on(_kernel_lib().flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, causal)), "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# --------------------------------------------------------------------------
# Public entries
# --------------------------------------------------------------------------

def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only flash attention that also returns the per-row
    log-sum-exp: ``(out, lse)`` with lse ``(b, h, s)`` float32. No
    gradient is registered; :func:`flash_chunk_bwd` is its backward."""
    return flash_fwd(q, k, v, causal)


def flash_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FA-2 backward of one (query chunk, kv chunk) pair against the
    softmax whose rows are ``out`` and ``lse`` (b, h, s): the rebuilt
    probabilities ``exp(qk − lse)`` are the global ones, so the returned
    ``(dq, dk, dv)`` are this pair's additive contributions. On CUDA,
    kernel 2 computes δ = rowsum(dO∘O) and dq, then kernel 3 reads δ on
    the same stream."""
    _shapes(q, k, v)
    if _device("flash_chunk_bwd", q) == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal)
    dq, delta = flash_bwd_dq_delta(q, k, v, g, lse, out, causal)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel 1, saving (q, k, v, out, lse). Backward: kernel 2
    with δ, then kernel 3 (plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_chunk_bwd(q, k, v, out, lse, g.contiguous(),
                                     ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Flash attention with its FA-2 backward. q ``(b, s, h, d)``, k/v
    ``(b, t, hk, d)`` with ``h % hk == 0`` (GQA read natively); returns
    ``(b, s, h, d)`` in q's dtype. CUDA tensors go through kernels 1-3,
    CPU tensors through their plain versions; any other device raises."""
    return _FlashAttention.apply(q, k, v, causal)
