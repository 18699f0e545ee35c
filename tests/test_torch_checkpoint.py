"""The port's checkpoints (``mpi_tpu_torch/utils/checkpoint.py``) and
``train.py --checkpoint-dir --checkpoint-every --resume``, on the CPU.

* Every case of the JAX package's ``TestCheckpoint`` and
  ``TestAsyncCheckpointer`` (``tests/test_trace_checkpoint.py``) on torch
  states: round trip, pruning, mismatch, restore into a tp state, the crash
  window, debris, overwrite, ordering, the snapshot taken at ``save``,
  backpressure, write errors; the JAX package's ``all_steps`` and
  ``latest_step`` read the port's directory.
* Restore and continue: a state saved after step 1 and restored into a
  template drawn from another seed takes two more steps with the losses and
  every parameter and moment of the uninterrupted run, bit for bit, for
  every kind of training state the port builds.
* Against JAX: that restored run's losses equal JAX's uninterrupted
  ``make_train_step`` (one device, and FSDP on ``make_mesh_nd(8)``, the
  twin of ``tests/test_models.py``'s FSDP round trip) within
  ``tests/test_torch_zero.py``'s tolerances (float32 summation order).
* The trainer: ``train.main`` with ``--corpus --checkpoint-every 2 --steps
  4``, then ``--resume --steps 2``, prints the straight 6-step run's losses
  (repr, so bitwise), under ``--warmup-steps 2`` and FSDP too.
"""

import json
import os
import re
import shutil
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from mpi_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from mpi_tpu.models import make_mesh_nd as jax_make_mesh_nd  # noqa: E402
from mpi_tpu.models import make_train_step as jax_make_train_step  # noqa
from mpi_tpu.utils import all_steps as jax_all_steps  # noqa: E402
from mpi_tpu.utils import latest_step as jax_latest_step  # noqa: E402
from mpi_tpu_torch import train  # noqa: E402
from mpi_tpu_torch.models import (SsmConfig, TransformerConfig,  # noqa
                                  ViTConfig, init_params,
                                  make_lora_train_step, make_mesh_nd,
                                  make_ssm_train_step, make_train_step,
                                  make_vit_train_step, params_from_jax,
                                  rank_state)
from mpi_tpu_torch.parallel import RankMesh  # noqa: E402
from mpi_tpu_torch.utils import checkpoint as ck  # noqa: E402
from mpi_tpu_torch.utils.checkpoint import (AsyncCheckpointer,  # noqa
                                            all_steps, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint)

LOSS = dict(atol=1e-5, rtol=1e-5)
MODEL = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq=17)
CFG = TransformerConfig(**MODEL)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _state(seed=0):
    return {"params": {"w": torch.randn(4, 3, generator=_gen(seed)),
                       "b": torch.zeros(3)},
            "step": 7, "lr": 1e-3}


# --------------------------------------------------------------------------
# TestCheckpoint's cases
# --------------------------------------------------------------------------

def test_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), state, step=7)
    assert latest_step(str(tmp_path)) == 7
    template = _state(seed=1)
    w = template["params"]["w"]
    got = restore_checkpoint(str(tmp_path), template)
    assert got is template and got["params"]["w"] is w  # in place
    assert torch.equal(w, state["params"]["w"])
    assert got["step"] == 7 and isinstance(got["step"], int)
    assert got["lr"] == pytest.approx(1e-3) and isinstance(got["lr"], float)
    with open(tmp_path / "step_7" / "meta.json") as f:
        assert json.load(f)["format"] == "mpi_tpu_torch.checkpoint.v1"


def test_multiple_steps_and_pruning(tmp_path):
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), _state(), step=s, max_to_keep=2)
    assert all_steps(str(tmp_path)) == [3, 4]
    got = restore_checkpoint(str(tmp_path), _state(), step=3)
    assert got["step"] == 7


@pytest.mark.parametrize("template", [
    {"other": torch.zeros(2)},
    {"params": {"w": torch.zeros(4, 4), "b": torch.zeros(3)}, "step": 0,
     "lr": 0.0},
    {"params": {"w": torch.zeros(4, 3, dtype=torch.float64),
                "b": torch.zeros(3)}, "step": 0, "lr": 0.0},
    {"params": {"w": torch.zeros(4, 3), "b": torch.zeros(3)},
     "step": torch.zeros(()), "lr": 0.0}],
    ids=["keys", "shape", "dtype", "kind"])
def test_template_mismatch_raises(tmp_path, template):
    save_checkpoint(str(tmp_path), _state(), step=1)
    with pytest.raises(ValueError, match="tree mismatch"):
        restore_checkpoint(str(tmp_path), template)
    # Checked before written: the template keeps its zeros.
    assert all(not v.any() for _, _, _, v in ck._flatten(template)
               if torch.is_tensor(v))


def test_restore_into_a_tp_state(tmp_path):
    """The twin of restoring onto a sharded mesh: a full parameter tree
    restored into a tp-2 train state's parameters, whose tp ranks' pieces
    are then those of the saved tree."""
    params = init_params(CFG, _gen(0), "cpu")
    save_checkpoint(str(tmp_path), params, step=0)
    mesh = RankMesh(["cpu"] * 2, ("dp", "sp", "tp"), (1, 1, 2))
    init_state, _ = make_train_step(CFG, mesh=mesh)
    state = init_state(_gen(1), "cpu")
    restore_checkpoint(str(tmp_path), state["params"])
    assert torch.equal(state["params"]["embed"], params["embed"])
    w1 = params["blocks"][0]["w1"]
    piece = rank_state(state, 0, 1)["params"]["blocks"][0]["w1"]
    assert torch.equal(piece, w1[:, w1.shape[1] // 2:])


def test_an_optimizer_over_other_leaves_raises(tmp_path):
    """load_state_dict matches moments to parameters by position: a
    template whose optimizer holds the leaves in another order is
    refused, not given the wrong moments."""
    a, b = torch.zeros(2, 3), torch.zeros(3)
    opt = torch.optim.AdamW([a, b])
    a.grad, b.grad = torch.ones(2, 3), torch.ones(3)
    opt.step()
    save_checkpoint(str(tmp_path), {"a": a, "b": b, "opt": opt}, step=1)
    c, d = torch.zeros(2, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="optimizer's parameters differ"):
        restore_checkpoint(str(tmp_path), {"a": c, "b": d,
                                           "opt": torch.optim.AdamW([d, c])})


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), {"x": 1})


def test_unsupported_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint the object"):
        save_checkpoint(str(tmp_path), {"x": object()}, step=0)


def test_bf16_is_written_as_uint16(tmp_path):
    x = torch.randn(5, 7, generator=_gen(2)).to(torch.bfloat16)
    save_checkpoint(str(tmp_path), {"x": x}, step=0)
    with np.load(tmp_path / "step_0" / "arrays.npz") as npz:
        assert npz["x"].dtype == np.uint16
    with open(tmp_path / "step_0" / "meta.json") as f:
        assert json.load(f)["leaves"]["x"]["dtype"] == "torch.bfloat16"
    got = restore_checkpoint(str(tmp_path),
                             {"x": torch.zeros(5, 7, dtype=torch.bfloat16)})
    assert torch.equal(got["x"].view(torch.int16), x.view(torch.int16))


def test_jax_reads_the_port_directory(tmp_path):
    for s in (1, 3):
        save_checkpoint(str(tmp_path), _state(), step=s)
    os.rename(tmp_path / "step_3", tmp_path / ".step_3.old.crash")
    assert jax_all_steps(str(tmp_path)) == [1, 3]  # JAX recovers it too
    assert jax_latest_step(str(tmp_path)) == 3
    assert all_steps(str(tmp_path)) == [1, 3]


def test_crash_window_between_park_and_rename_recovers(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), state, step=5)
    os.rename(tmp_path / "step_5", tmp_path / ".step_5.old.crash")
    assert not (tmp_path / "step_5").exists()
    assert all_steps(str(tmp_path)) == [5]
    assert (tmp_path / "step_5").exists()
    got = restore_checkpoint(str(tmp_path), _state(seed=1))
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert all_steps(str(tmp_path)) == [5]
    shutil.rmtree(tmp_path / "step_5")


def test_explicit_step_recovers_a_parked_copy(tmp_path):
    state = _state()
    save_checkpoint(str(tmp_path), state, step=2)
    os.rename(tmp_path / "step_2", tmp_path / ".step_2.old.crash")
    got = restore_checkpoint(str(tmp_path), _state(seed=1), step=2)
    assert torch.equal(got["params"]["w"], state["params"]["w"])


def test_parked_debris_cleaned_once_replacement_landed(tmp_path):
    save_checkpoint(str(tmp_path), _state(), step=3)
    debris = tmp_path / ".step_3.old.leftover"
    os.makedirs(debris)
    with open(debris / "meta.json", "w") as f:
        json.dump({"step": 3}, f)
    assert all_steps(str(tmp_path)) == [3]
    assert not debris.exists()


def test_overwrite_same_step_keeps_new_and_leaves_no_debris(tmp_path):
    new_state = _state(seed=2)
    save_checkpoint(str(tmp_path), _state(), step=9)
    save_checkpoint(str(tmp_path), new_state, step=9)
    got = restore_checkpoint(str(tmp_path), _state(seed=1))
    assert torch.equal(got["params"]["w"], new_state["params"]["w"])
    assert [n for n in os.listdir(tmp_path) if n.startswith(".step_")] == []


# --------------------------------------------------------------------------
# TestAsyncCheckpointer's cases
# --------------------------------------------------------------------------

def test_async_roundtrip_and_ordering(tmp_path):
    w = torch.arange(6.0).reshape(2, 3)
    with AsyncCheckpointer() as ckpt:
        handles = []
        for s in range(3):
            w.add_(1.0)  # in place, as the port's steps update
            handles.append(ckpt.save(str(tmp_path), {"w": w, "step": s},
                                     step=s, max_to_keep=2))
        paths = [h.result(30) for h in handles]
        ckpt.wait()
    assert all(p.endswith(f"step_{s}") for s, p in enumerate(paths))
    assert all(h.seconds is not None and h.seconds >= 0 for h in handles)
    assert latest_step(str(tmp_path)) == 2
    got = restore_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3),
                                             "step": 9})
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3) + 3.0)
    assert got["step"] == 2
    got = restore_checkpoint(str(tmp_path), {"w": torch.zeros(2, 3),
                                             "step": 9}, step=1)
    assert torch.equal(got["w"], torch.arange(6.0).reshape(2, 3) + 2.0)


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_snapshot_is_immune_to_buffer_reuse(tmp_path, kind):
    src = torch.ones(4) if kind == "tensor" else np.ones(4, np.float32)
    ckpt = AsyncCheckpointer()
    try:
        h = ckpt.save(str(tmp_path), {"x": src}, step=1)
        src[:] = -1.0  # "train step" overwrites the buffer
        h.result(30)
    finally:
        ckpt.close()
    zeros = torch.zeros(4) if kind == "tensor" else np.zeros(4, np.float32)
    got = restore_checkpoint(str(tmp_path), {"x": zeros})
    assert (np.asarray(got["x"]) == 1.0).all()


def test_a_step_after_save_does_not_reach_the_file(tmp_path, monkeypatch):
    """The port's step updates the state in place: ``save`` copies it
    before it returns, so a step taken at once (while the write waits on
    the writer thread) is not in the checkpoint."""
    import threading

    import mpi_tpu_torch.utils.checkpoint as ckmod

    orig = ckmod._write_checkpoint
    gate = threading.Event()

    def held(*args, **kwargs):
        assert gate.wait(30)
        return orig(*args, **kwargs)

    monkeypatch.setattr(ckmod, "_write_checkpoint", held)
    init_state, step = make_train_step(CFG)
    state = init_state(_gen(0), "cpu")
    tok = _tokens()
    step(state, tok)
    saved = [x.clone() for x in _tensors(state)]
    with AsyncCheckpointer() as ckpt:
        h = ckpt.save(str(tmp_path), state, step=1)
        step(state, tok)  # while the write waits
        assert not h.done()
        gate.set()
        h.result(30)
    after = _tensors(state)
    got = _tensors(restore_checkpoint(str(tmp_path),
                                      init_state(_gen(1), "cpu")))
    assert all(torch.equal(a, b) for a, b in zip(got, saved))
    assert not all(torch.equal(a, b) for a, b in zip(got, after))


def test_backpressure_bounds_pending_snapshots(tmp_path, monkeypatch):
    import mpi_tpu_torch.utils.checkpoint as ckmod

    orig = ckmod._write_checkpoint

    def slow(*args, **kwargs):
        time.sleep(0.25)
        return orig(*args, **kwargs)

    monkeypatch.setattr(ckmod, "_write_checkpoint", slow)
    ckpt = ckmod.AsyncCheckpointer(max_pending=1)
    try:
        t0 = time.monotonic()
        handles = [ckpt.save(str(tmp_path), {"x": torch.ones(2)}, step=s)
                   for s in range(3)]
        enqueue_time = time.monotonic() - t0
        ckpt.wait()
    finally:
        ckpt.close()
    assert enqueue_time >= 0.25
    assert all(h.done() for h in handles)


def test_write_error_surfaces_on_wait(tmp_path):
    target = tmp_path / "not_a_dir"
    target.write_text("occupied")  # makedirs will fail on a file
    ckpt = AsyncCheckpointer()
    h = ckpt.save(str(target), {"x": torch.ones(2)}, step=0)
    with pytest.raises(OSError):
        h.result(30)
    with pytest.raises(OSError):
        ckpt.wait()
    ckpt.close()


def test_closed_checkpointer_rejects_saves(tmp_path):
    ckpt = AsyncCheckpointer()
    ckpt.save(str(tmp_path), {"x": torch.ones(2)}, step=0).result(30)
    ckpt.close()
    with pytest.raises(RuntimeError, match="closed"):
        ckpt.save(str(tmp_path), {"x": torch.ones(2)}, step=1)


# --------------------------------------------------------------------------
# Restore and continue, bit for bit, for every kind of training state
# --------------------------------------------------------------------------

def _tokens(batch=8, seed=5, vocab=MODEL["vocab"], seq=MODEL["max_seq"]):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, (batch, seq)).astype(np.int32))


def _tensors(state):
    """Every tensor of ``state`` and of its optimizers' state, in order."""
    out = []
    for _, _, _, v in ck._flatten(state):
        if isinstance(v, torch.optim.Optimizer):
            for per_param in v.state_dict()["state"].values():
                out += [x for x in per_param.values() if torch.is_tensor(x)]
        elif torch.is_tensor(v):
            out.append(v)
    return out


def _dp(n=2):
    return RankMesh(["cpu"] * n, ("dp",))


def _lm(**kw):
    def build(seed):
        init_state, step = make_train_step(CFG, **kw)
        return init_state(_gen(seed), "cpu"), step
    return build, _tokens()


def _remat():
    cfg = TransformerConfig(**MODEL, remat=True)

    def build(seed):
        init_state, step = make_train_step(cfg)
        return init_state(_gen(seed), "cpu"), step
    return build, _tokens()


def _ssm(mesh=None):
    cfg = SsmConfig(vocab=61, d_model=32, n_layers=2, d_state=16, d_ff=64)

    def build(seed):
        init_state, step = make_ssm_train_step(cfg, mesh=mesh)
        return init_state(_gen(seed), "cpu"), step
    return build, _tokens(vocab=61)


def _vit():
    cfg = ViTConfig(image_size=16, patch_size=4, channels=3, n_classes=7,
                    d_model=32, n_heads=4, n_layers=2, d_ff=64)
    rng = np.random.default_rng(0)
    batch = (torch.from_numpy(rng.standard_normal(
        (8, 16, 16, 3)).astype(np.float32)),
             torch.from_numpy(rng.integers(0, 7, 8).astype(np.int32)))

    def build(seed):
        init_state, step = make_vit_train_step(cfg)
        return init_state(_gen(seed), "cpu"), step
    return build, batch


def _lora():
    base = init_params(CFG, _gen(0), "cpu")

    def build(seed):
        init_state, step = make_lora_train_step(CFG, base, rank=4)
        return init_state(_gen(seed)), step
    return build, _tokens()


CASES = {
    "one_device": lambda: _lm(),
    "dp2": lambda: _lm(mesh=_dp()),
    "dp2_zero1": lambda: _lm(mesh=_dp(), zero1=True),
    "dp2_fsdp": lambda: _lm(mesh=_dp(), fsdp=True),
    "tp2": lambda: _lm(mesh=RankMesh(["cpu"] * 2, ("dp", "sp", "tp"),
                                     (1, 1, 2))),
    "adafactor": lambda: _lm(optimizer="adafactor"),
    "sgd": lambda: _lm(optimizer="sgd"),
    "adafactor_zero1": lambda: _lm(mesh=_dp(), zero1=True,
                                   optimizer="adafactor"),
    "adafactor_fsdp": lambda: _lm(mesh=_dp(), fsdp=True,
                                  optimizer="adafactor"),
    "sgd_fsdp": lambda: _lm(mesh=_dp(), fsdp=True, optimizer="sgd"),
    "warmup_cosine": lambda: _lm(warmup_steps=2, total_steps=6),
    "warmup_linear": lambda: _lm(warmup_steps=4, optimizer="adafactor"),
    "grad_accum": lambda: _lm(grad_accum=2),
    "remat": _remat,
    "ssm": lambda: _ssm(),
    "ssm_dp2": lambda: _ssm(_dp()),
    "vit": _vit,
    "lora": _lora,
}


def _unique_bytes(tensors):
    seen = {}
    for t in tensors:
        seen[ck._storage(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


@pytest.mark.parametrize("case", list(CASES))
def test_restored_state_continues_bitwise(tmp_path, case):
    build, batch = CASES[case]()
    state, step = build(0)
    step(state, batch)
    save_checkpoint(str(tmp_path), state, step=1)
    at_save = [x.detach().clone() for x in _tensors(state)]
    want = [float(step(state, batch)[1]) for _ in range(2)]
    want_tensors = _tensors(state)

    template, step_r = build(1)
    ids = [id(x) for x in _tensors(template)[:3]]
    assert restore_checkpoint(str(tmp_path), template) is template
    assert [id(x) for x in _tensors(template)[:3]] == ids  # in place
    restored = _tensors(template)
    assert len(restored) == len(at_save)
    for a, b in zip(restored, at_save):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got = [float(step_r(template, batch)[1]) for _ in range(2)]
    assert got == want
    for a, b in zip(_tensors(template), want_tensors):
        assert torch.equal(a, b)
    if "step" in template:  # the SSM's update count
        assert template["step"] == state["step"] == 3

    # Each storage once on disk: no view (FSDP's params, ZeRO-1's shards)
    # written beside the buffer it views.
    with np.load(tmp_path / "step_1" / "arrays.npz") as npz:
        on_disk = sum(npz[k].nbytes for k in npz.files
                      if npz[k].ndim and not k.startswith("opt/"))
    leaves = [v for _, _, _, v in ck._flatten(state) if torch.is_tensor(v)]
    assert on_disk == _unique_bytes(leaves)
    if "fsdp" in case:
        buffers = {ck._storage(b) for b in template["buffers"]}
        views = [x for _, _, _, x in ck._flatten(template["params"])
                 if ck._storage(x) in buffers]
        assert views  # the restored params still view the buffers


def test_a_fresh_optimizer_or_another_stream_does_not_continue(tmp_path):
    """The controls of the bitwise check: the same restore with the
    optimizer's state dropped (the second loss, after its first update,
    differs), or on another batch, gives other losses."""
    build, batch = _lm(warmup_steps=2, total_steps=6)
    state, step = build(0)
    step(state, batch)
    save_checkpoint(str(tmp_path), state, step=1)
    want = [float(step(state, batch)[1]) for _ in range(2)]
    for control in ("fresh optimizer", "other batch"):
        template, step_r = build(1)
        restore_checkpoint(str(tmp_path), template)
        if control == "fresh optimizer":
            template["opt"].load_state_dict(build(2)[0]["opt"].state_dict())
        other = _tokens(seed=6) if control == "other batch" else batch
        got = [float(step_r(template, other)[1]) for _ in range(2)]
        assert got[1] != want[1], control


# --------------------------------------------------------------------------
# Against JAX's uninterrupted make_train_step
# --------------------------------------------------------------------------

JAX_RUNS = ("one_device", "fsdp_nd8")


@pytest.fixture(scope="module")
def jax_runs():
    """run -> (initial params, three losses) of JAX's jitted step, and
    under "template" the parameters of another key."""
    tok = _tokens(batch=4).numpy()
    out = {}
    for name in JAX_RUNS:
        if name == "one_device":
            init_state, step = jax_make_train_step(JaxConfig(**MODEL))
            batch = jnp.asarray(tok)
        else:
            mesh = jax_make_mesh_nd(8, devices=jax.devices()[:8])
            init_state, step = jax_make_train_step(JaxConfig(**MODEL),
                                                   mesh=mesh, fsdp=True)
            batch = jax.device_put(jnp.asarray(tok),
                                   NamedSharding(mesh, P("dp", None)))
        state = init_state(jax.random.PRNGKey(0))
        params0 = jax.tree.map(np.asarray, state["params"])
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(float(loss))
        out[name] = params0, losses
    out["template"] = jax.tree.map(np.asarray, init_state(
        jax.random.PRNGKey(1))["params"])
    return out


@pytest.mark.parametrize("name", JAX_RUNS)
def test_restored_run_matches_jax_uninterrupted(jax_runs, tmp_path, name):
    params0, want = jax_runs[name]
    kw = {} if name == "one_device" else dict(
        mesh=make_mesh_nd(8, devices=["cpu"] * 8), fsdp=True)
    init_state, step = make_train_step(CFG, **kw)
    state = init_state.from_params(params_from_jax(params0, CFG, "cpu"))
    batch = _tokens(batch=4)
    got = [float(step(state, batch)[1])]
    save_checkpoint(str(tmp_path), state, step=1)
    # The template is built as the state was (JAX's key order, which sets
    # the dp layout and the optimizer's order), from another key.
    template = init_state.from_params(
        params_from_jax(jax_runs["template"], CFG, "cpu"))
    restore_checkpoint(str(tmp_path), template)
    got += [float(step(template, batch)[1]) for _ in range(2)]
    np.testing.assert_allclose(got, want, **LOSS)
    # Built another way, its leaves are in another order: refused.
    with pytest.raises(ValueError, match="tree mismatch.*as the saved state was built"):
        restore_checkpoint(str(tmp_path), init_state(_gen(7), "cpu"))


# --------------------------------------------------------------------------
# train.py --corpus --checkpoint-dir --checkpoint-every --resume
# --------------------------------------------------------------------------

TINY = ["--layers", "1", "--seq", "16", "--batch", "2", "--device", "cpu"]


def _losses(out):
    return {int(m[1]): m[2] for m in re.finditer(
        r"^step (\d+) loss (\S+) ", out, re.MULTILINE)}


@pytest.mark.parametrize("flags", [[], ["--warmup-steps", "2"],
                                   ["--dp", "2", "--fsdp"]],
                         ids=["plain", "warmup", "fsdp"])
def test_train_cli_resume_replays_the_straight_run(tmp_path, capsys, flags):
    corpus = tmp_path / "corpus.bin"
    np.random.default_rng(3).integers(0, 8192, 20_000,
                                      dtype=np.uint16).tofile(corpus)
    ckdir = str(tmp_path / "ckpt")
    common = [*TINY, "--corpus", str(corpus), *flags]
    save = ["--checkpoint-dir", ckdir, "--checkpoint-every", "2"]
    if "--warmup-steps" in flags:
        # The schedule's horizon is the run's last step, start + --steps,
        # as in examples/train.py: a 4-step run decays over 4 steps. So the
        # straight run saves as it goes and stops after step 4's save.
        assert train.main([*common, "--steps", "6", *save]) == 0
        straight = _losses(capsys.readouterr().out)
        shutil.rmtree(os.path.join(ckdir, "step_6"))
    else:
        assert train.main([*common, "--steps", "6"]) == 0
        straight = _losses(capsys.readouterr().out)
        assert train.main([*common, "--steps", "4", *save]) == 0
        out = capsys.readouterr().out
        assert _losses(out) == {i: straight[i] for i in range(4)}
        assert "checkpoint step 2:" in out and "checkpoint step 4:" in out
    assert sorted(straight) == list(range(6))
    assert all_steps(ckdir) == [2, 4]

    # The template is drawn from another seed: the restore must replace
    # every value, and the corpus stream does not depend on --seed.
    assert train.main([*common, "--steps", "2", "--checkpoint-dir", ckdir,
                       "--resume", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert _losses(out) == {4: straight[4], 5: straight[5]}

    if "--fsdp" in flags:
        with open(os.path.join(ckdir, "step_4", "meta.json")) as f:
            leaves = json.load(f)["leaves"]
        with np.load(os.path.join(ckdir, "step_4", "arrays.npz")) as npz:
            held = {k: npz[k].nbytes for k in npz.files}
        views = [k for k, e in leaves.items() if e["kind"] == "view"]
        assert any(k.startswith("params/") for k in views)
        assert not set(views) & set(held)
        # What is on disk is the fresh state's storage, each once.
        init_state, _ = make_train_step(
            train.flagship_train_config(1, 16),
            mesh=RankMesh(["cpu"] * 2, ("dp", "sp", "tp"), (2, 1, 1)),
            fsdp=True)
        fresh = init_state(_gen(0), "cpu")
        leaves = [v for _, _, _, v in ck._flatten(fresh) if torch.is_tensor(v)]
        assert sum(n for k, n in held.items() if not k.startswith("opt/")) \
            == _unique_bytes(leaves)


def test_train_cli_checks_the_corpus_and_its_flags(tmp_path):
    corpus = tmp_path / "corpus.bin"
    np.full(5000, 9000, dtype=np.uint16).tofile(corpus)
    with pytest.raises(SystemExit, match="token id 9000 >= vocab 8192"):
        train.main([*TINY, "--corpus", str(corpus), "--steps", "2"])
    with pytest.raises(SystemExit) as err:
        train.main([*TINY, "--resume", "--steps", "2"])
    assert err.value.code == 2  # --resume needs --checkpoint-dir
    with pytest.raises(SystemExit, match="--lora does not support --resume"):
        train.main([*TINY, "--lora", "4", "--resume", "--checkpoint-dir",
                    str(tmp_path)])
