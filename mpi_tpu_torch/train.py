"""Train the flagship decoder LM for a few optimizer steps on the GPU.

The port's counterpart of the single-device path of ``examples/train.py``,
at the configuration of ``bench.py``'s ``measure_train_step``: d_model
1024, 8 layers, 8 heads of 128, d_ff 4096, vocab 8192, batch 8, seq 1024,
bf16 compute over float32 master weights, attention in the flash kernels
(forward and FA-2 backward), AdamW at lr 1e-3. Weights are random, drawn
from ``--seed``. Step i trains on the i-th batch of a deterministic stream
(``data.py``'s ``ShardedLoader``, which builds the next batches on the host
while the device runs): ``SyntheticLM(vocab, batch, seq + 1, seed=--seed)``,
or with ``--corpus PATH`` windows of a raw uint16 token file, memory-mapped
and gathered by the port's native gather (``from_token_file``; every id
must be below the vocabulary, checked once before training). Prints the
loss and time of each step (CUDA events), then the time per step after the
first, tokens per second, model TFLOP/s and MFU against the card's dense
bf16 peak.

``--checkpoint-dir DIR`` saves the training state every
``--checkpoint-every`` steps (``utils/checkpoint.py``'s
``AsyncCheckpointer``, the last 3 kept): the state is copied to the host
before the next step, the file written on a background thread; each save's
cost to the step loop and its write time are printed apart from the
steps' times. ``--resume`` continues from the latest checkpoint there: the
state is restored into the fresh one, the stream starts at that step, and
the schedule's horizon is the restored step plus ``--steps``, as in
``examples/train.py``.

``--attention`` takes every ``attention_impl`` of ``examples/train.py``;
the sequence-parallel ones (ring, zigzag, Ulysses) run over ``--sp N``
rank positions of an ``sp`` mesh whose ranks share the chosen device.
``--dp N`` trains data-parallel over N ranks: each computes the gradient
of its share of the batch and kernel 6 reduces them; ``--zero1`` shards
the optimizer state over them and ``--fsdp`` the parameters too, as
``examples/train.py`` offers. ``--tp N`` splits the model Megatron-style
over N tensor-parallel ranks (heads, d_ff and vocab; kernel 6 runs the tp
reductions). ``--dp``, ``--sp`` and ``--tp`` make one ``("dp", "sp",
"tp")`` mesh, ranks row-major as ``make_mesh_nd`` lays them out (all 1,
the default, means no mesh). ``--optimizer`` takes adamw, adafactor or
sgd (momentum 0.9), and ``--warmup-steps W`` warms the rate up over W
steps into cosine decay over the run (``total_steps = --steps``), as
``examples/train.py`` does. ``--lora RANK`` freezes a base drawn from
``--seed`` and trains rank-RANK q/v adapters at lr 1e-2 in its place
(``models/lora.py``; kernels 1-3 as the full step, on the same mesh); it
refuses ``--grad-accum`` above 1, ``--warmup-steps``, ``--zero1`` and
``--fsdp``, as ``examples/train.py`` does. Its MFU is None:
:func:`train_flops_per_step` counts a full fine-tune's weight gradients.
``--sample N`` then greedily generates N tokens after an 8-token prompt
(:func:`sample_prompt`, ``examples/train.py``'s) through ``generate`` on
the flash-decode kernel, from the merged tree under ``--lora`` and the
trained one otherwise. The long-context
configuration (``bench.py``'s ``measure_long_context``: 4 layers, seq
8192, batch 1, remat) with zigzag ring attention over 8 ranks is::

    python -m mpi_tpu_torch.train --layers 4 --seq 8192 --batch 1 \
        --remat --attention zigzag_flash --sp 8

Run::

    python -m mpi_tpu_torch.train                 # on the CUDA device
    python -m mpi_tpu_torch.train --dp 8 --zero1  # 8 dp ranks, ZeRO-1
    python -m mpi_tpu_torch.train --tp 8          # 8 tp ranks
    python -m mpi_tpu_torch.train --optimizer adafactor --warmup-steps 2
    python -m mpi_tpu_torch.train --lora 8 --sample 16  # LoRA, then sample
    python -m mpi_tpu_torch.train --corpus tokens.bin --checkpoint-dir ckpt \
        --checkpoint-every 5 --steps 10
    python -m mpi_tpu_torch.train --corpus tokens.bin --checkpoint-dir ckpt \
        --resume --steps 10                      # steps 10-19
    python -m mpi_tpu_torch.train --layers 2 --seq 64 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from .data import ShardedLoader, SyntheticLM, from_token_file
from .models import (TransformerConfig, full_params, generate, init_params,
                     make_lora_train_step, make_train_step, merge_lora)
from .parallel import RankMesh
from .utils.checkpoint import (AsyncCheckpointer, latest_step,
                               restore_checkpoint)
from .utils.platform import resolve_device

__all__ = ["ATTENTION_IMPLS", "flagship_train_config",
           "train_flops_per_step", "peak_bf16_tflops", "sample_prompt",
           "main"]

# examples/train.py's --attention choices.
ATTENTION_IMPLS = ("dense", "flash", "blockwise", "ring", "ring_flash",
                   "zigzag", "zigzag_flash", "ulysses", "ulysses_flash")

# Dense bf16 peaks (NVIDIA's data sheets, no sparsity), keyed by
# torch.cuda.get_device_name.
_PEAK_BF16_TFLOPS = (("H100 80GB HBM3", 989.0), ("H100 PCIe", 756.0))

# --sample's prompt: examples/train.py's, the step-0 batch of
# SyntheticLM(vocab, 1, PROMPT_LEN, seed=PROMPT_SEED).
PROMPT_LEN = 8
PROMPT_SEED = 99


def sample_prompt(vocab: int) -> torch.Tensor:
    """``--sample``'s (1, PROMPT_LEN) prompt, drawn as the JAX package's
    ``SyntheticLM`` draws its step 0: int32 from a numpy generator seeded
    with ``(PROMPT_SEED, 0)``, so both trainers prompt with the same
    tokens."""
    rng = np.random.default_rng(np.random.SeedSequence([PROMPT_SEED, 0]))
    return torch.from_numpy(rng.integers(0, vocab, (1, PROMPT_LEN),
                                         dtype=np.int32)).long()


def flagship_train_config(n_layers: int = 8, seq: int = 1024,
                          dtype: torch.dtype = torch.bfloat16,
                          attention_impl: str = "flash",
                          remat: bool = False) -> TransformerConfig:
    """``bench.py``'s ``measure_train_step`` configuration: bf16 compute,
    float32 masters cast at each use, a learned position table of
    ``seq + 1`` rows."""
    return TransformerConfig(
        vocab=8192, d_model=1024, n_heads=8, n_layers=n_layers, d_ff=4096,
        max_seq=seq + 1, dtype=dtype, param_dtype=torch.float32,
        attention_impl=attention_impl, remat=remat)


def train_flops_per_step(cfg: TransformerConfig, batch: int,
                         seq: int) -> float:
    """Model FLOPs of one optimizer step, ``bench.py``'s count: the matrix
    products of the forward (projections, FFN, attention at half the full
    s² for the causal mask, logits) times 3 for forward and backward.
    Rematerialisation's recompute is not model work and is not counted."""
    b, s = batch, seq
    d, ff, n, v = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.vocab
    qkvo = 8 * b * s * d * d
    ffn = 4 * b * s * d * ff
    attn = 2 * b * s * s * d
    return 3.0 * (n * (qkvo + ffn + attn) + 2 * b * s * d * v)


def peak_bf16_tflops(device_name: str) -> Optional[float]:
    """The card's dense bf16 peak in TFLOP/s, or None for a card the table
    does not know: then there is no honest MFU."""
    for key, tflops in _PEAK_BF16_TFLOPS:
        if key in device_name:
            return tflops
    return None


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--attention", choices=ATTENTION_IMPLS, default="flash")
    ap.add_argument("--sp", type=int, default=1,
                    help="rank positions of an sp mesh on the device for "
                         "the sequence-parallel impls")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel ranks on the device, each with its "
                         "share of the batch")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer state over dp (ZeRO-1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="fully shard the parameters over dp "
                         "(ZeRO-3/FSDP; subsumes --zero1)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel ranks on the device (heads, "
                         "d_ff and vocab split over them)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor", "sgd"])
    ap.add_argument("--warmup-steps", type=int, default=0,
                    help="linear LR warmup; with --steps it becomes "
                         "warmup + cosine decay")
    ap.add_argument("--lora", type=int, default=0, metavar="RANK",
                    help="freeze the base model and train rank-RANK "
                         "LoRA adapters instead (adapter-only state)")
    ap.add_argument("--sample", type=int, default=0, metavar="N",
                    help="after training, greedily generate N tokens")
    ap.add_argument("--corpus", default=None,
                    help="raw binary uint16 token file to train on "
                         "(memory-mapped; native gather); token ids must "
                         "be below the vocabulary. default: synthetic "
                         "stream")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save the training state here (default: no "
                         "checkpoints)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in "
                         "--checkpoint-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.steps < 2:
        ap.error("--steps must be at least 2: one warm-up, one timed")
    if min(args.sp, args.dp, args.tp) < 1:
        ap.error("--sp, --dp and --tp must be at least 1")
    if args.checkpoint_every < 1:
        ap.error("--checkpoint-every must be at least 1")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir")
    if args.lora:
        unsupported = [n for n, v in (("--grad-accum", args.grad_accum > 1),
                                      ("--warmup-steps", args.warmup_steps),
                                      ("--zero1", args.zero1),
                                      ("--fsdp", args.fsdp),
                                      ("--resume", args.resume)) if v]
        if unsupported:
            raise SystemExit(
                f"--lora does not support {', '.join(unsupported)} in "
                f"this demo (adapter state has its own shape)")
    if PROMPT_LEN + args.sample > args.seq + 1:
        ap.error(f"--sample {args.sample}: the {PROMPT_LEN}-token prompt "
                 f"and {args.sample} new tokens exceed max_seq "
                 f"{args.seq + 1} (--seq + 1)")

    dev = resolve_device(args.device)
    cfg = flagship_train_config(args.layers, args.seq,
                                attention_impl=args.attention,
                                remat=args.remat)
    mesh = None
    sizes = (args.dp, args.sp, args.tp)
    if args.dp * args.sp * args.tp > 1 or args.zero1 or args.fsdp:
        mesh = RankMesh([dev] * (args.dp * args.sp * args.tp),
                        ("dp", "sp", "tp"), sizes)
    if args.corpus:
        source = from_token_file(args.corpus, args.batch, args.seq + 1,
                                 dtype="uint16")
        # Once, before training: an id past the vocabulary is a device-side
        # assert in the embedding on CUDA.
        top = int(np.memmap(args.corpus, dtype=np.uint16, mode="r").max())
        if top >= cfg.vocab:
            raise SystemExit(
                f"--corpus contains token id {top} >= vocab {cfg.vocab}; "
                f"re-tokenize or remap the corpus first")
    else:
        source = SyntheticLM(cfg.vocab, args.batch, args.seq + 1,
                             seed=args.seed)
    # Resolve the resume point before building the step: the schedule's
    # horizon is the absolute final step (start + steps), so a resumed run
    # continues the same warmup/cosine curve.
    start = 0
    if args.resume:
        start = latest_step(args.checkpoint_dir) or 0
    gen = torch.Generator().manual_seed(args.seed)
    if args.lora:
        base = init_params(cfg, gen, dev)
        init_state, step = make_lora_train_step(
            cfg, base, rank=args.lora, mesh=mesh, learning_rate=1e-2,
            optimizer=args.optimizer)
        state = init_state(gen)
    else:
        init_state, step = make_train_step(
            cfg, mesh=mesh, grad_accum=args.grad_accum,
            optimizer=args.optimizer, warmup_steps=args.warmup_steps,
            total_steps=start + args.steps if args.warmup_steps else None,
            zero1=args.zero1, fsdp=args.fsdp)
        state = init_state(gen, dev)
    if start:
        restore_checkpoint(args.checkpoint_dir, state)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(f"flagship train on {name}: batch={args.batch} seq={args.seq} "
          f"layers={args.layers} attention={args.attention} dp={args.dp} "
          f"sp={args.sp} tp={args.tp} zero1={args.zero1} fsdp={args.fsdp} "
          f"optimizer={args.optimizer} warmup_steps={args.warmup_steps} "
          f"remat={args.remat} grad_accum={args.grad_accum} "
          f"lora={args.lora} sample={args.sample} "
          f"corpus={args.corpus} checkpoint_dir={args.checkpoint_dir}")
    if start:
        print(f"resumed from step {start}")

    loader = iter(ShardedLoader(source, mesh=mesh, start_step=start,
                                device=dev))
    ckpt = AsyncCheckpointer() if args.checkpoint_dir else None
    losses, times, saves = [], [], []
    try:
        for i in range(start, start + args.steps):
            tokens = next(loader)
            if cuda:
                times.append((torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True)))
                times[-1][0].record()
            t0 = time.perf_counter()
            losses.append(step(state, tokens)[1])
            if cuda:
                times[-1][1].record()
            else:
                times.append((time.perf_counter() - t0) * 1e3)
            if ckpt is not None and (i + 1) % args.checkpoint_every == 0:
                # The step's own work ends first, so the save's cost to the
                # loop is its copy to the host and its enqueue alone.
                if cuda:
                    torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                handle = ckpt.save(args.checkpoint_dir, state, step=i + 1,
                                   max_to_keep=3)
                saves.append((i + 1, (time.perf_counter() - t0) * 1e3,
                              handle))
        if ckpt is not None:
            ckpt.wait()
    finally:
        loader.close()
        if ckpt is not None:
            ckpt.close()
    if cuda:
        torch.cuda.synchronize(dev)
        times = [a.elapsed_time(b) for a, b in times]
    for i, (loss, ms) in enumerate(zip(losses, times), start):
        first = " (first step of the run)" if i == start else ""
        print(f"step {i} loss {float(loss)!r} {ms:.3f} ms{first}")
    for at, ms, handle in saves:
        print(f"checkpoint step {at}: {ms:.3f} ms on the step loop (copy "
              f"to the host), written in {handle.seconds * 1e3:.3f} ms on "
              f"the writer thread ({handle.result()})")
    ms = sum(times[1:]) / len(times[1:])
    finite = all(bool(torch.isfinite(x)) for x in losses)

    tok_s = args.batch * args.seq / ms * 1e3
    what = f"LoRA rank {args.lora}, " if args.lora else ""
    if not cuda:
        print(f"{ms:.3f} ms/step ({what}host clock, CPU), {tok_s:.0f} "
              f"tokens/s")
    elif args.lora:
        print(f"{ms:.3f} ms/step ({what}CUDA events), {tok_s:.0f} tokens/s, "
              f"MFU None (train_flops_per_step counts a full fine-tune's "
              f"weight gradients) ({name})")
    else:
        tflops = train_flops_per_step(cfg, args.batch, args.seq) / ms / 1e9
        peak = peak_bf16_tflops(name)
        mfu = None if peak is None else tflops / peak
        print(f"{ms:.3f} ms/step (CUDA events), {tok_s:.0f} tokens/s, "
              f"{tflops:.2f} model TFLOP/s, MFU "
              f"{mfu if mfu is None else f'{mfu:.4f}'} against {peak} "
              f"TFLOP/s dense bf16 ({name})")
    if args.sample:
        with torch.no_grad():
            params = (merge_lora(base, state["lora"]) if args.lora
                      else full_params(state))
        toks = generate(params, sample_prompt(cfg.vocab).to(dev),
                        dataclasses.replace(cfg, decode_attention="flash"),
                        args.sample, device=dev)
        print("sampled:", toks[0].tolist())
    return 0 if finite else 1


if __name__ == "__main__":
    sys.exit(main())
