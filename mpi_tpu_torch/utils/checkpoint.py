"""Checkpoint / resume for the port's training states.

Counterpart of ``mpi_tpu/utils/checkpoint.py``, with its on-disk layout:
one ``step_N/`` directory per checkpoint holding

  * ``arrays.npz`` — every saved leaf, key = its path in the state
    (``params/blocks/0/w1``);
  * ``meta.json``  — step number, leaf order, format tag
    (``mpi_tpu_torch.checkpoint.v1``) and each leaf's kind and dtype.

Writes are atomic (temp dir + rename, the old step parked and recovered
after a crash mid-overwrite), ``max_to_keep`` prunes the oldest steps, and
:class:`AsyncCheckpointer` writes on a background thread behind a bounded
queue.

What is saved. The state (dicts and lists) is walked in order. Every tensor
whose storage the state owns is saved once: a tensor that is a view of
another leaf's whole storage (FSDP's ``state["params"]`` pieces of
``state["buffers"]``, ZeRO-1's ``state["shards"]`` rows) is recorded as a
view of it and not written again. Python scalars are saved as 0-d arrays.
A ``torch.optim.Optimizer`` is saved through its ``state_dict()``: its
per-parameter tensors and scalars, and its param groups' numbers (the
rate, and the schedule's update count that ``models/optimizers.py`` keeps
there). bfloat16 has no numpy dtype: it is written as uint16 and named in
``meta.json``. The structural entries ``layout``, ``mesh``, ``specs``,
``mode`` and ``spans`` are not saved: they come from the template.

Restore. The JAX package builds new arrays from a template; the port's
states are updated in place and hold aliases (views of the FSDP buffers,
optimizers that find their moments by parameter identity). So
:func:`restore_checkpoint` writes each saved tensor into the template's own
tensor with ``copy_`` under ``torch.no_grad()``, which keeps every view,
device and identity; restores each optimizer with ``load_state_dict``; and
puts Python scalars back with their own type. The template must come from
the same builder as the saved state.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FORMAT",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "all_steps",
    "AsyncCheckpointer",
]

FORMAT = "mpi_tpu_torch.checkpoint.v1"
_STEP_RE = re.compile(r"^step_(\d+)$")
# Entries a state holds for its structure, rebuilt by its builder.
_STRUCTURE = frozenset({"layout", "mesh", "specs", "mode", "spans"})
_SCALARS = (bool, int, float, complex, np.generic)


def _flatten(state: Any) -> List[Tuple[str, Any, Any, Any]]:
    """The leaves of ``state`` in order: (key, parent, slot, value), the key
    the path of dict keys and list indices joined by ``/``."""
    out: List[Tuple[str, Any, Any, Any]] = []

    def walk(node, key, parent, slot):
        if isinstance(node, dict):
            for k, v in node.items():
                if k not in _STRUCTURE:
                    walk(v, f"{key}/{k}" if key else str(k), node, k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}" if key else str(i), node, i)
        elif node is None:
            return
        elif isinstance(node, (torch.Tensor, np.ndarray,
                               torch.optim.Optimizer, *_SCALARS)):
            out.append((key, parent, slot, node))
        else:
            raise TypeError(f"mpi_tpu_torch: cannot checkpoint the "
                            f"{type(node).__name__} at {key or '/'}")

    walk(state, "", None, None)
    return out


def _covers(t: torch.Tensor) -> bool:
    """Whether ``t`` is the whole of its storage."""
    return (t.storage_offset() == 0 and t.is_contiguous() and
            t.numel() * t.element_size() == t.untyped_storage().nbytes())


def _storage(t: torch.Tensor):
    return t.device, t.untyped_storage().data_ptr()


def _bases(leaves) -> Dict[str, str]:
    """{key of a view: key of the leaf whose whole storage it views}."""
    owner: Dict[Any, str] = {}
    for key, _, _, v in leaves:
        if isinstance(v, torch.Tensor) and v.numel() and _covers(v):
            owner.setdefault(_storage(v), key)
    return {key: owner[_storage(v)] for key, _, _, v in leaves
            if isinstance(v, torch.Tensor) and v.numel()
            and owner.get(_storage(v), key) != key}


def _names(leaves) -> Dict[int, str]:
    """{id of a tensor leaf: its key} (the first key of a repeated one)."""
    out: Dict[int, str] = {}
    for key, _, _, v in leaves:
        if isinstance(v, torch.Tensor):
            out.setdefault(id(v), key)
    return out


def _param_keys(opt: torch.optim.Optimizer,
                names: Dict[int, str]) -> List[Optional[str]]:
    """The state key of each of the optimizer's parameters, in its order
    (None for a parameter the state does not hold)."""
    return [names.get(id(p)) for g in opt.param_groups for p in g["params"]]


def _tensor_to_numpy(t: torch.Tensor, copy: bool) -> np.ndarray:
    x = t.detach().to("cpu", copy=copy).contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _numpy_to_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == str(torch.bfloat16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _entry(value: Any, copy: bool
           ) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
    """A tensor's, array's or scalar's meta entry and saved array (None
    for None, which an optimizer's per-parameter state may hold)."""
    if value is None:
        return {"kind": "none"}, None
    if isinstance(value, torch.Tensor):
        return ({"kind": "tensor", "dtype": str(value.dtype),
                 "shape": list(value.shape)},
                _tensor_to_numpy(value, copy))
    if isinstance(value, np.ndarray):
        return {"kind": "ndarray"}, np.array(value, copy=copy)
    return {"kind": "scalar", "type": type(value).__name__}, np.asarray(value)


def _snapshot(state: Any, copy: bool = False):
    """Gather ``state`` to the host: (keys, meta entries, {name: ndarray}).

    ``copy=True`` forces owned copies, which a later (async) write needs:
    the training step updates the state's tensors in place, and a CPU
    tensor's numpy array is its own storage. A CUDA tensor's copy to the
    host waits for the work queued on the current stream before it."""
    leaves = _flatten(state)
    bases = _bases(leaves)
    names = _names(leaves)
    entries: Dict[str, Dict[str, Any]] = {}
    arrays: Dict[str, np.ndarray] = {}
    for key, _, _, value in leaves:
        if key in bases:
            entries[key] = {"kind": "view", "of": bases[key],
                            "dtype": str(value.dtype),
                            "shape": list(value.shape)}
        elif isinstance(value, torch.optim.Optimizer):
            sd = value.state_dict()
            state_kinds: Dict[str, Dict[str, Any]] = {}
            for idx, per_param in sd["state"].items():
                state_kinds[str(idx)] = {}
                for name, v in per_param.items():
                    entry, arr = _entry(v, copy)
                    state_kinds[str(idx)][name] = entry
                    if arr is not None:
                        arrays[f"{key}/state/{idx}/{name}"] = arr
            groups = []
            for g, group in enumerate(sd["param_groups"]):
                scalars = {}
                for name, v in group.items():
                    if isinstance(v, _SCALARS):
                        sub = f"{key}/param_groups/{g}/{name}"
                        scalars[name], arrays[sub] = _entry(v, copy)
                groups.append({"n_params": len(group["params"]),
                               "scalars": scalars})
            entries[key] = {"kind": "optimizer", "state": state_kinds,
                            "groups": groups,
                            "params": _param_keys(value, names)}
        else:
            entries[key], arrays[key] = _entry(value, copy)
    return [key for key, _, _, _ in leaves], entries, arrays


def save_checkpoint(directory: str, state: Any, step: int,
                    max_to_keep: Optional[int] = None) -> str:
    """Write ``state`` (dicts and lists of tensors, arrays, scalars and
    optimizers) as ``step_{step}``. Returns the checkpoint path.
    ``max_to_keep`` prunes oldest steps."""
    keys, entries, arrays = _snapshot(state)
    return _write_checkpoint(directory, keys, entries, arrays, step,
                             max_to_keep)


def _write_checkpoint(directory: str, keys: List[str],
                      entries: Dict[str, Dict[str, Any]],
                      arrays: Dict[str, np.ndarray], step: int,
                      max_to_keep: Optional[int] = None) -> str:
    """Disk half of a save: npz + meta into a temp dir, then the
    park-and-rename overwrite dance. Host-only (no device)."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(prefix=f".step_{step}.tmp.", dir=directory)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, "keys": keys, "format": FORMAT,
                       "leaves": entries}, f)
        # Overwrite near-atomically: park the old step under a
        # ``.step_N.old.*`` name before renaming the new one in. A crash
        # between the two renames leaves no ``step_N`` but an intact
        # parked copy — ``all_steps`` recovers it (see ``_recover_old``),
        # so either the old or the new checkpoint is always reachable.
        # A concurrent reader's recovery can resurrect the parked copy
        # in that same window, making our rename land on a non-empty
        # dir — park-and-rename retries until it wins (the resurrector
        # acts at most once per parked dir, so this converges).
        old = None
        for attempt in range(10):
            if os.path.exists(final):
                old = tempfile.mkdtemp(prefix=f".step_{step}.old.",
                                       dir=directory)
                os.rmdir(old)
                os.rename(final, old)
            try:
                os.rename(tmp, final)
                break
            except OSError:
                if attempt == 9:
                    if old is not None and not os.path.exists(final):
                        os.rename(old, final)  # put the old one back
                        old = None
                    raise
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if max_to_keep is not None:
        steps = all_steps(directory)
        for old in steps[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, f"step_{old}"),
                          ignore_errors=True)
    return final


class _SaveHandle:
    """Completion handle for one async save (a tiny future); ``seconds``
    is how long its write took on the writer thread."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._path: Optional[str] = None
        self._exc: Optional[BaseException] = None
        self.seconds: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> str:
        """Block until the write lands; return the checkpoint path or
        re-raise the write error."""
        if not self._done.wait(timeout):
            raise TimeoutError("mpi_tpu_torch: async checkpoint still "
                               "writing")
        if self._exc is not None:
            raise self._exc
        if self._path is None:
            raise RuntimeError("mpi_tpu_torch: async checkpoint finished "
                               "without a path")
        return self._path


class AsyncCheckpointer:
    """Background checkpoint writer: training resumes while bytes hit disk.

    :meth:`save` copies the state to the host **synchronously** on the
    caller's thread before it returns: the port's step updates the state in
    place, so a later copy would tear the checkpoint. The copy from the
    device runs on the current stream after the work queued there, and the
    next step's in-place updates follow it. The disk half (npz encode, the
    park-and-rename overwrite) runs on a single worker thread, which also
    keeps concurrent saves step-ordered.

    Use as a context manager or call :meth:`wait` /:meth:`close`; both
    re-raise the first background write error.
    """

    def __init__(self, max_pending: int = 2) -> None:
        # Bounded: each queued job holds a full host copy of the state,
        # so when disk is slower than the checkpoint cadence, save()
        # BLOCKS once ``max_pending`` snapshots are in flight instead of
        # accumulating model-sized copies until the host runs out.
        self._jobs: "queue.Queue[Optional[tuple]]" = queue.Queue(
            maxsize=max(1, max_pending))
        self._worker: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        # _first_exc has its own lock: save() may block in a full-queue
        # put() while holding _lock, and the worker's error path must
        # stay able to record its failure (and task_done) meanwhile.
        self._exc_lock = threading.Lock()
        self._first_exc: Optional[BaseException] = None
        self._closed = False

    def save(self, directory: str, state: Any, step: int,
             max_to_keep: Optional[int] = None) -> _SaveHandle:
        """Snapshot ``state`` now; write ``step_{step}`` in the background.
        Returns a handle whose ``result()`` blocks for this save only."""
        with self._exc_lock:
            if self._first_exc is not None:
                exc, self._first_exc = self._first_exc, None
                raise exc
        with self._lock:
            if self._closed:
                raise RuntimeError("mpi_tpu_torch: AsyncCheckpointer is "
                                   "closed")
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="mpi-torch-ckpt-writer",
                    daemon=True)
                self._worker.start()
        keys, entries, arrays = _snapshot(state, copy=True)
        handle = _SaveHandle()
        # Enqueue under the lock: the snapshot above can take seconds, and
        # a concurrent close() must either see this job (queued before the
        # shutdown sentinel) or make this call raise — never strand the
        # job on a dead queue with a forever-pending handle.
        with self._lock:
            if self._closed:
                raise RuntimeError(
                    "mpi_tpu_torch: AsyncCheckpointer closed during save()")
            self._jobs.put((directory, keys, entries, arrays, step,
                            max_to_keep, handle))
        return handle

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                if job is None:
                    return
                directory, keys, entries, arrays, step, max_to_keep, \
                    handle = job
                t0 = time.perf_counter()
                try:
                    handle._path = _write_checkpoint(
                        directory, keys, entries, arrays, step, max_to_keep)
                except BaseException as exc:  # noqa: BLE001 — reported
                    handle._exc = exc         # via handle and wait()
                    with self._exc_lock:
                        if self._first_exc is None:
                            self._first_exc = exc
                finally:
                    handle.seconds = time.perf_counter() - t0
                    handle._done.set()
            finally:
                self._jobs.task_done()

    def wait(self) -> None:
        """Block until every queued save has landed; re-raise the first
        background error (also surfaced by the failing save's handle)."""
        self._jobs.join()
        with self._exc_lock:
            exc, self._first_exc = self._first_exc, None
        if exc is not None:
            raise exc

    def close(self) -> None:
        """Drain pending saves and stop the worker (idempotent)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._jobs.put(None)
            worker.join()
        with self._exc_lock:
            exc, self._first_exc = self._first_exc, None
        if exc is not None:
            raise exc

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


_OLD_RE = re.compile(r"^\.step_(\d+)\.old\.")


def _recover_old(directory: str) -> None:
    """Restore checkpoints orphaned by a crash mid-overwrite.

    ``save_checkpoint`` parks the previous ``step_N`` as ``.step_N.old.*``
    before renaming the replacement in; a crash between the renames leaves
    only the parked copy. Rename it back so the step stays visible."""
    for name in os.listdir(directory):
        m = _OLD_RE.match(name)
        if not m:
            continue
        final = os.path.join(directory, f"step_{m.group(1)}")
        parked = os.path.join(directory, name)
        if os.path.exists(final):
            # The replacement landed; the parked copy is leftover debris.
            shutil.rmtree(parked, ignore_errors=True)
        elif os.path.exists(os.path.join(parked, "meta.json")):
            try:
                os.rename(parked, final)
            except OSError:
                pass  # concurrent writer raced us; next scan cleans up


def all_steps(directory: str) -> List[int]:
    """Complete checkpoint steps present, ascending (recovering any step
    orphaned by a crash mid-overwrite first)."""
    if not os.path.isdir(directory):
        return []
    _recover_old(directory)
    steps = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(directory, name, "meta.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _mismatch(what: str) -> ValueError:
    return ValueError(f"mpi_tpu_torch: checkpoint/template tree mismatch "
                      f"({what})")


def _restored(entry: Dict[str, Any], arr: np.ndarray, where: str) -> Any:
    """A saved tensor or scalar as the object to put back."""
    if entry["kind"] == "none":
        return None
    if entry["kind"] == "tensor":
        return _numpy_to_tensor(arr, entry["dtype"])
    if entry["kind"] == "scalar":
        return arr[()].item() if entry["type"] in ("int", "float", "bool",
                                                   "complex") else arr[()]
    raise _mismatch(f"{where} is a {entry['kind']}")


def _optimizer_state(opt: torch.optim.Optimizer, key: str,
                     entry: Dict[str, Any], arrays: Dict[str, np.ndarray],
                     names: Dict[int, str]) -> Dict[str, Any]:
    """The state dict that restores ``opt`` from ``entry``; raises a tree
    mismatch before anything is written."""
    # load_state_dict matches the moments to the parameters by position:
    # the template's optimizer must hold the same leaves in the same order.
    mine, saved_keys = _param_keys(opt, names), entry["params"]
    if mine != saved_keys:
        at = next(i for i, (a, b) in enumerate(zip(mine + [None],
                                                   saved_keys + [None]))
                  if a != b)
        raise _mismatch(f"{key}: the optimizer's parameters differ from "
                        f"parameter {at} on (template {mine[at:at + 1]}, "
                        f"checkpoint {saved_keys[at:at + 1]})")
    groups = opt.state_dict()["param_groups"]
    saved = entry["groups"]
    if [len(g["params"]) for g in groups] != \
            [g["n_params"] for g in saved]:
        raise _mismatch(f"{key}: param groups of "
                        f"{[len(g['params']) for g in groups]} parameters, "
                        f"checkpoint {[g['n_params'] for g in saved]}")
    for g, (group, want) in enumerate(zip(groups, saved)):
        scalars = {k for k, v in group.items() if isinstance(v, _SCALARS)}
        if scalars != set(want["scalars"]):
            raise _mismatch(f"{key}: param group {g} holds "
                            f"{sorted(scalars)}, checkpoint "
                            f"{sorted(want['scalars'])}")
        for name in scalars:
            value = arrays[f"{key}/param_groups/{g}/{name}"][()]
            group[name] = type(group[name])(value)
    n_params = len(mine)
    state = {}
    for idx, per_param in entry["state"].items():
        if not 0 <= int(idx) < n_params:
            raise _mismatch(f"{key}: state of parameter {idx}, the template "
                            f"has {n_params}")
        state[int(idx)] = {
            name: _restored(sub, arrays.get(f"{key}/state/{idx}/{name}"),
                            f"{key}/state/{idx}/{name}")
            for name, sub in per_param.items()}
    return {"state": state, "param_groups": groups}


def restore_checkpoint(directory: str, template: Any,
                       step: Optional[int] = None) -> Any:
    """Load ``step`` (default: latest) into ``template`` in place and
    return it.

    ``template`` is a state of the same structure (the same builder, any
    values): each saved tensor is written into its tensor with ``copy_``,
    so views, devices and the optimizers' parameter identities survive;
    each optimizer is restored with ``load_state_dict``; each Python scalar
    is put back with its template's type. A key, kind, shape, dtype or view
    that differs from the template raises ``ValueError`` naming a tree
    mismatch; no checkpoint raises ``FileNotFoundError``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"mpi_tpu_torch: no checkpoints under {directory!r}")
    path = os.path.join(directory, f"step_{step}")
    if not os.path.exists(path) and os.path.isdir(directory):
        # The explicit-step path must see crash-orphaned steps too.
        _recover_old(directory)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"mpi_tpu_torch: {path} holds format "
                         f"{meta.get('format')!r}, not {FORMAT!r}")
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        arrays = {k: npz[k] for k in npz.files}

    leaves = _flatten(template)
    keys = [key for key, _, _, _ in leaves]
    if sorted(keys) != sorted(meta["keys"]):
        missing = set(meta["keys"]) - set(keys)
        extra = set(keys) - set(meta["keys"])
        raise _mismatch(f"missing from template: {sorted(missing)[:5]}, "
                        f"not in checkpoint: {sorted(extra)[:5]}")
    if keys != meta["keys"]:
        # The order places the leaves in the dp buffers and the optimizer.
        at = next(i for i, (a, b) in enumerate(zip(keys, meta["keys"]))
                  if a != b)
        raise _mismatch(f"leaf {at} is {keys[at]} in the template, "
                        f"{meta['keys'][at]} in the checkpoint: build the "
                        f"template as the saved state was built")
    entries = meta["leaves"]
    names = _names(leaves)
    by_key = {key: value for key, _, _, value in leaves}
    # Every leaf is checked before any is written: a mismatch leaves the
    # template as it was.
    writes = []
    for key, parent, slot, tmpl in leaves:
        entry = entries[key]
        kind = entry["kind"]
        if isinstance(tmpl, torch.Tensor):
            if kind not in ("tensor", "view") or \
                    list(tmpl.shape) != entry["shape"] or \
                    str(tmpl.dtype) != entry["dtype"]:
                raise _mismatch(f"{key}: template {tmpl.dtype} "
                                f"{tuple(tmpl.shape)}, checkpoint {kind} "
                                f"{entry.get('dtype')} {entry.get('shape')}")
            if kind == "view":  # restored through its base
                base = by_key.get(entry["of"])
                if not isinstance(base, torch.Tensor) or \
                        _storage(base) != _storage(tmpl):
                    raise _mismatch(f"{key} is not a view of "
                                    f"{entry['of']} in the template")
            else:
                writes.append((tmpl.copy_, _numpy_to_tensor(
                    arrays[key], entry["dtype"])))
        elif isinstance(tmpl, np.ndarray):
            if kind != "ndarray" or tmpl.shape != arrays[key].shape:
                raise _mismatch(f"{key}: template array {tmpl.shape}, "
                                f"checkpoint {kind}")
            writes.append((lambda v, t=tmpl: np.copyto(t, v), arrays[key]))
        elif isinstance(tmpl, torch.optim.Optimizer):
            if kind != "optimizer":
                raise _mismatch(f"{key}: template optimizer, checkpoint "
                                f"{kind}")
            writes.append((tmpl.load_state_dict, _optimizer_state(
                tmpl, key, entry, arrays, names)))
        else:
            if kind != "scalar" or arrays[key].ndim != 0:
                raise _mismatch(f"{key}: template scalar, checkpoint {kind}")
            writes.append((lambda v, p=parent, k=slot: p.__setitem__(k, v),
                           type(tmpl)(arrays[key][()])))
    with torch.no_grad():
        for write, value in writes:
            write(value)
    return template
