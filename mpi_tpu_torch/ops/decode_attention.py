"""Flash-decode attention: one query position against the KV cache.

Counterpart of ``mpi_tpu/ops/decode_attention.py``. On a CUDA tensor
:func:`flash_decode_attention` launches the hand-written kernel in
``csrc/decode_attention.cu`` (see the note there for its design and what
bounds it); on a CPU tensor it runs :func:`flash_decode_attention_plain`,
the plain PyTorch version of the same function. On any other device, or
when the kernel does not take the input, it raises: there is no fallback
from the card to the plain version.

The caches are read in place in their storage layout ``(b, t, kv, hd)``;
``n_valid`` is the query's absolute position, so columns ``0 .. n_valid``
are live and a new decode step needs no rebuild. On the card ``n_valid``
may be a one-element int32 tensor on the device, which the kernel reads
itself: nothing on the host waits for its value.

The kernel splits the cache positions of each (b, kv head) over a cluster
of :func:`kernel_splits` blocks and merges their partial softmax states on
the chip; :func:`kernel_tile` is a block's load unit.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from . import _build

__all__ = ["NEG_INF", "flash_decode_attention",
           "flash_decode_attention_plain", "kernel_splits", "kernel_tile"]

NEG_INF = -1e30  # the JAX package's finite mask value
_KERNEL_HEAD_DIMS = (64, 128, 256)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_THREADS = 256
_MAX_SPLITS = 8  # blocks per cluster: the portable cluster size


def _check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor
           ) -> Tuple[int, int, int, int, int]:
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"mpi_tpu_torch: flash_decode_attention wants q (b, h, hd) and "
            f"caches (b, t, kv, hd) of one shape; got {tuple(q.shape)}, "
            f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, hd = q.shape
    bk, t, kv, hdk = k_cache.shape
    if bk != b or hdk != hd:
        raise ValueError(
            f"mpi_tpu_torch: q {tuple(q.shape)} and cache "
            f"{tuple(k_cache.shape)} disagree on batch or head_dim")
    if h % kv:
        raise ValueError(f"mpi_tpu_torch: n_heads {h} not divisible by "
                         f"kv_heads {kv}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("mpi_tpu_torch: q and the caches lie on different "
                         "devices")
    return b, h, hd, t, kv


def flash_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, n_valid: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel; returns ``(out, lse)``.

    Same arithmetic contract as the TPU kernel: logits and softmax state in
    float32, p cast to v's dtype before the PV product, columns past
    ``n_valid`` contribute nothing, and an empty live prefix
    (``n_valid < 0``) gives a zero output and lse ~ -1e30."""
    b, h, hd, t, kv = _check(q, k_cache, v_cache)
    group = h // kv
    qg = q.reshape(b, kv, group, hd).float()
    logits = torch.einsum("bKgk,btKk->bKgt", qg, k_cache.float()) * (
        1.0 / math.sqrt(hd))
    dead = torch.arange(t, device=q.device) > n_valid
    logits = logits.masked_fill(dead, NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None]).masked_fill(dead, 0.0)
    l = p.sum(dim=-1).clamp_min(1e-30)
    acc = torch.einsum("bKgt,btKk->bKgk", p.to(v_cache.dtype).float(),
                       v_cache.float())
    out = (acc / l[..., None]).to(q.dtype).reshape(b, h, hd)
    return out, (m + torch.log(l)).reshape(b, h)


@functools.cache
def _kernel_lib():
    """The built library, with the C signatures declared once."""
    lib = _build.load("decode_attention")
    lib.decode_attention.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                             ctypes.c_void_p]
    lib.decode_attention.restype = ctypes.c_int
    lib.decode_attention_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.decode_attention_tile.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def kernel_tile(dtype: torch.dtype, hd: int) -> int:
    """Keys per batch of one block of the CUDA kernel (its load unit) for
    ``dtype`` and ``hd``, as the built kernel reports it (0 for a head_dim
    it does not take). Needs the CUDA toolkit, since it builds the
    kernel."""
    return _kernel_lib().decode_attention_tile(hd, int(dtype ==
                                                       torch.bfloat16))


def _load_unit(dtype: torch.dtype, hd: int) -> int:
    """:func:`kernel_tile` computed here, as ``Shape::UNIT`` in the
    kernel's source does: hd / VEC threads read one key row in 16-byte
    pieces (at most 32), and each of the block's key groups takes
    4 / (pieces per thread) keys a batch."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    tpk = min(hd // vec, 32)
    return _KERNEL_THREADS // tpk * (4 // (hd // (vec * tpk)))


def _rows(group: int) -> int:
    """Query rows per block for a GQA group, as the kernel's launcher
    picks them."""
    return 1 if group == 1 else 2 if group == 2 else 4 if group <= 4 else 8


def kernel_splits(b: int, kv: int, h: int, t: int, hd: int,
                  dtype: torch.dtype, sms: int) -> int:
    """Blocks per cluster, S, that the wrapper gives the kernel: as many
    as keep the clusters' blocks within the card's ``sms`` SMs, at most 8
    (the portable cluster size), and few enough that each block takes at
    least four load units of the ``t`` cache positions (block r takes
    ``[r t // S, (r + 1) t // S)``). A cluster launch costs about a
    microsecond more than a plain one on an H100, which a split of fewer
    keys does not earn back (PERF.md §6, PR 9). It depends on t, not on
    the live length."""
    group = h // kv
    clusters = b * kv * -(-group // _rows(group))
    return max(1, min(_MAX_SPLITS, sms // clusters,
                      t // (4 * _load_unit(dtype, hd))))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(q, k_cache, v_cache, n_valid, b, h, hd, t, kv):
    tensors = (q, k_cache, v_cache)
    if q.dtype not in _KERNEL_DTYPES or any(x.dtype != q.dtype
                                            for x in tensors):
        raise TypeError(
            f"mpi_tpu_torch: the decode kernel takes float32 or bfloat16, "
            f"one dtype for q and both caches; got "
            f"{[str(x.dtype) for x in tensors]}")
    if hd not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"mpi_tpu_torch: the decode kernel takes head_dim "
                         f"in {_KERNEL_HEAD_DIMS}; got {hd}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("mpi_tpu_torch: the decode kernel needs contiguous "
                         "q and caches")
    if any(x.data_ptr() % 16 for x in tensors):
        raise ValueError("mpi_tpu_torch: the decode kernel needs 16-byte "
                         "aligned q and caches")
    if isinstance(n_valid, torch.Tensor):
        if n_valid.numel() != 1 or n_valid.dtype != torch.int32:
            raise TypeError(
                f"mpi_tpu_torch: a tensor n_valid must be one int32 value; "
                f"got {n_valid.dtype} of shape {tuple(n_valid.shape)}")
        n_value, n_at = 0, n_valid.data_ptr()
    else:
        n_value, n_at = max(-1, min(int(n_valid), t)), None
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device)
    splits = kernel_splits(b, kv, h, t, hd, q.dtype,
                           _sm_count(q.device.index))
    lib = _kernel_lib()
    err = lib.decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, t, kv, h, hd, splits, n_value, n_at,
        1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(
            f"mpi_tpu_torch: decode kernel launch failed: "
            f"{lib.decode_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    flash_decode_attention.launches += 1
    return out, lse


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           n_valid: Union[int, torch.Tensor],
                           with_lse: bool = False):
    """Single-position attention against the cache.

    ``q``: (b, h, hd), the decode position's queries; ``k_cache`` /
    ``v_cache``: (b, t, kv, hd) with ``h % kv == 0``; ``n_valid``: the
    query's absolute position (it attends to cache columns ``0 .. n_valid``
    inclusive; its own k/v must already be written at column ``n_valid``),
    an int or a one-element tensor. Returns (b, h, hd) in q's dtype
    and, with ``with_lse=True``, also the float32 (b, h) log-sum-exp rows.

    CUDA tensors go through the kernel (``flash_decode_attention.launches``
    counts its launches), which reads an int32 ``n_valid`` on q's device
    from device memory; CPU tensors go through the plain version."""
    b, h, hd, t, kv = _check(q, k_cache, v_cache)
    if q.device.type == "cuda":
        if not (isinstance(n_valid, torch.Tensor) and
                n_valid.device == q.device):
            n_valid = int(n_valid)
        out, lse = _launch(q, k_cache, v_cache, n_valid, b, h, hd, t, kv)
    elif q.device.type == "cpu":
        out, lse = flash_decode_attention_plain(q, k_cache, v_cache,
                                                int(n_valid))
    else:
        raise ValueError(f"mpi_tpu_torch: flash_decode_attention runs on "
                         f"cuda (kernel) or cpu (plain); got {q.device}")
    return (out, lse) if with_lse else out


flash_decode_attention.launches = 0
