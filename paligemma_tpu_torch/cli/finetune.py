"""Fine-tuning CLI (port of paligemma_tpu/cli/finetune.py).

Mirrors the reference fine-tune recipe (ref: Paligemma_FT.ipynb): LoRA r=8
on q/k/v/o/gate/up/down (cell 41), AdamW lr=1e-4, grad-accum 8, clip 1.0
(cells 43/47), JSON-extraction targets via json2token (cell 20), validation
by generate + normalized edit distance (cell 38).

    python -m paligemma_tpu_torch.cli.finetune --model_path <dir> \\
        --train_jsonl train.jsonl --output_dir out --export_hf

Dataset: a JSONL manifest with rows ``{"image": <path>, "prompt": <str>,
"target": <str-or-json>}``, or an HF dataset of CORD-style rows
(``--hf_dataset``, train/hf_dataset.py).

Device: the card (``cuda:0``), or the CPU with ``--only_cpu``
(cli.infer.card_or_cpu); with no card and no ``--only_cpu`` it exits with
an error and never runs on the CPU by itself. The weights load in bf16, as
in the JAX CLI, and train on train/trainer.Trainer (on the card the flash
forward and backward kernels). ``--base_quant int8 | nf4 | int4`` (or
``--quantize_int8``) quantizes the frozen LM base first.

The mesh, as in the JAX CLI (train/trainer under core/mesh):

* ``--data_parallel D --model_parallel M`` trains over D x M ranks, one
  process each (cli/ranks: spawned here, or one per process under
  ``torchrun --nproc_per_node D*M``): every rank loads the checkpoint,
  reads the same rows in the same order and builds the same batches; the
  trainer keeps its slices and its rows (``--batch_size`` must divide over
  D) and issues the same collectives. Ranks that share a card run over
  gloo (a correctness run).
* ``--fsdp``: ZeRO-3 over the data axis (a no-op at D = 1).
* ``--multihost``: this process is one rank of a run across hosts
  (core/multihost: one process per card, numbered host by host); with
  ``--coordinator host:port --num_processes N --process_id i`` it joins
  through that address, without them from torchrun's environment. Every
  process runs the same command but for ``--process_id``. The mesh keeps
  the model axis inside a host (``--model_parallel`` defaults to the
  host's ranks, ``--data_parallel`` to the rest).

Rank 0 alone prints, writes ``metrics.jsonl``, the checkpoints and the
export; the others take part in the collectives of a save (the state
gathered to one card's layout) and of the export. The evaluation runs on
rank 0, over the merged weights gathered from every rank, in one card's
engine (as the JAX CLI evaluates on its merged params without a mesh);
rank 0 hands the score to the others, so every rank stops early at the
same step.

Outputs under ``--output_dir``: ``metrics.jsonl`` (a line per step and per
evaluation), ``epoch_{k}/`` and ``final/`` (checkpoints/local: the adapters,
or the trained LM, with the optimizer state, in one card's layout whatever
the mesh, so a run resumes under another mesh), and with ``--export_hf``
the merged model as ``hf_export/`` (fp32 safetensors, config.json and the
tokenizer files), which ``cli.infer`` and ``cli.serve`` load as they load
any checkpoint; ``cli.serve --lora NAME=<output_dir>/final`` serves the
adapters over the base checkpoint.

``--resume_from`` reads this package's checkpoints only (a directory with
checkpoints/local's ``state.pt``): the JAX package's orbax training states
cannot be read without jax, and a directory without ``state.pt`` exits with
an error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from . import ranks
from .errors import CliError, require, user_errors


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    with user_errors():
        p = _parser()
        args = p.parse_args(argv)
        _check(p, args)
        if args.multihost:
            import torch.distributed as dist

            try:
                _run(args, _join_multihost(args))
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
        elif args.data_parallel * args.model_parallel > 1:
            ranks.launch(_rank_main, argv, args.model_parallel, args.only_cpu,
                         data_parallel=args.data_parallel)
        else:
            _run(args, None)


def _rank_main(argv, rank: "ranks.Rank") -> None:
    """One rank of the CLI's mesh (cli/ranks)."""
    with user_errors():
        _run(_parser().parse_args(argv), rank)


def _join_multihost(args) -> "ranks.Rank":
    """This process as a rank of a run across hosts (core/multihost)."""
    import torch.distributed as dist

    from ..core import multihost

    require(args.only_cpu or torch.cuda.is_available(),
            "no CUDA device found; pass --only_cpu to run on the CPU")
    multihost.initialize(args.coordinator, args.num_processes, args.process_id)
    mesh = multihost.make_multihost_mesh(
        args.data_parallel if args.data_parallel > 1 else None,
        args.model_parallel if args.model_parallel > 1 else None, only_cpu=args.only_cpu)
    device = (torch.device("cpu") if args.only_cpu
              else torch.device("cuda", torch.cuda.current_device()))
    me = ranks.Rank(rank=dist.get_rank(), world=dist.get_world_size(), device=device,
                    backend=mesh.backend, mesh=mesh,
                    ops=dist.new_group(backend="gloo", timeout=ranks.IDLE_TIMEOUT))
    me.say(f"ranks: {me.world} over {mesh.backend} (multihost); mesh data {mesh.data} x "
           f"model {mesh.model}", file=sys.stderr, flush=True)
    return me


def _check(p: argparse.ArgumentParser, args) -> None:
    """The flags' errors, before any rank starts."""
    from ..checkpoints.local import has_pytree
    from ..core.config import PaliGemmaConfig
    from ..core.mesh import local_text_config
    from .infer import card_or_cpu, check_parallel

    check_parallel(args)
    if not args.multihost and args.data_parallel * args.model_parallel == 1:
        card_or_cpu(args.only_cpu)
    if not args.train_jsonl and not args.hf_dataset:
        p.error("provide --train_jsonl or --hf_dataset")
    require(args.batch_size % args.data_parallel == 0,
            f"--batch_size {args.batch_size} does not split over --data_parallel "
            f"{args.data_parallel}: each data shard trains on batch_size / data_parallel rows")
    if args.model_parallel > 1:
        cfg = PaliGemmaConfig.from_hf_json(args.model_path)
        try:
            local_text_config(cfg.text_config, args.model_parallel)
        except NotImplementedError as e:
            raise CliError(f"--model_parallel {args.model_parallel}: {e}") from None
    if args.resume_from:
        require(has_pytree(args.resume_from),
                f"--resume_from {args.resume_from}: no checkpoint of this package there "
                "(expected a directory holding state.pt, as epoch_<k>/ and final/ under a "
                "run's --output_dir); the JAX package's orbax training states are not read "
                "(that needs jax)")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="PaliGemma fine-tuning (PyTorch + CUDA)")
    p.add_argument("--model_path", required=True, help="HF checkpoint directory")
    p.add_argument("--train_jsonl", default=None)
    p.add_argument("--eval_jsonl", default=None)
    p.add_argument("--hf_dataset", default=None,
                   help="HF dataset (hub name or local save_to_disk dir) of "
                        "CORD-style rows (image + ground_truth JSON) — the "
                        "reference's naver-clova-ix/cord-v2 path "
                        "(ref: Paligemma_FT.ipynb cell 20)")
    p.add_argument("--hf_train_split", default="train")
    p.add_argument("--hf_eval_split", default=None,
                   help="e.g. 'validation' to also eval from --hf_dataset")
    p.add_argument("--shuffle_seed", type=int, default=0,
                   help="seed for per-epoch training-order shuffling "
                        "(-1 disables shuffling)")
    p.add_argument("--eval_subset", type=int, default=16,
                   help="number of eval rows scored per evaluation "
                        "(0 = all rows)")
    p.add_argument("--prompt", default="extract JSON.")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--resume_from", default=None,
                   help="a checkpoint directory of this package (state.pt), saved under "
                        "any mesh")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--grad_accum", type=int, default=8)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--lora_rank", type=int, default=8)
    p.add_argument("--full_finetune", action="store_true",
                   help="full LM fine-tune (vision frozen) instead of LoRA")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 base + LoRA (alias for --base_quant int8)")
    p.add_argument("--base_quant", default="none",
                   choices=("none", "int8", "nf4", "int4"),
                   help="quantize the FROZEN LM base for the fine-tune: "
                        "int8 per-channel, or blockwise 4-bit (nf4 = the "
                        "reference's BitsAndBytes QLoRA recipe, ref: "
                        "Paligemma_FT.ipynb cell 41; int4 = symmetric grid)")
    p.add_argument("--max_length", type=int, default=512)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split each batch over D data shards (D x --model_parallel ranks, "
                        "one process each: spawned, or under torchrun)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallel over M ranks, one process each; ranks sharing a "
                        "card run over gloo")
    p.add_argument("--fsdp", action="store_true",
                   help="shard params/grads/optimizer state over the data "
                        "axis too (ZeRO-3; for full fine-tunes whose AdamW "
                        "moments exceed one card)")
    p.add_argument("--eval_every", type=int, default=200)
    p.add_argument("--max_new_tokens_eval", type=int, default=512)
    p.add_argument("--early_stopping_patience", type=int, default=0,
                   help="stop when val_edit_distance hasn't improved for N "
                        "evals (0 = off; ref: FT notebook EarlyStopping cell 45)")
    p.add_argument("--export_hf", action="store_true",
                   help="also export the final (LoRA-merged) model as an "
                        "HF-format checkpoint directory (the offline analog "
                        "of the reference's hub push)")
    p.add_argument("--only_cpu", action="store_true")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-host run as one rank (core/multihost; every "
                        "process launches this same command) and train over a "
                        "data-across-hosts x model-inside-a-host mesh")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's host:port for --multihost; requires --num_processes and "
                        "--process_id (without it: torchrun's environment)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="with --multihost: the ranks in all (one process a card)")
    p.add_argument("--process_id", type=int, default=None,
                   help="with --multihost: this process's rank, numbered host by host")
    return p


def _run(args, rank: "ranks.Rank" = None) -> None:
    """The CLI's body, on one card (``rank`` None) or as one rank of the
    mesh; every rank runs it in the same order."""
    from .infer import card_or_cpu

    if rank is None:
        device, say, lead = card_or_cpu(args.only_cpu), print, True
    else:
        device, say, lead = rank.device, rank.say, rank.lead
        require(args.batch_size % rank.mesh.data == 0,
                f"--batch_size {args.batch_size} does not split over the mesh's data axis of "
                f"{rank.mesh.data}")

    import numpy as np
    from PIL import Image
    from transformers import AutoTokenizer

    from ..checkpoints.hf_loader import load_hf_model
    from ..processing.processor import PaliGemmaProcessor
    from ..runtime.quantize import quantize_lm_for_serving
    from ..train.data import collate, json2token
    from ..train.trainer import TrainConfig, Trainer

    def load_manifest(path):
        rows = []
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                target = row["target"]
                if not isinstance(target, str):
                    target = json2token(target)
                rows.append(
                    {"image": row["image"],
                     "prompt": row.get("prompt", args.prompt),
                     "target": target}
                )
        return rows

    params, config = load_hf_model(args.model_path, torch.bfloat16, device=device)
    if args.quantize_int8 and args.base_quant == "none":
        args.base_quant = "int8"
    if args.base_quant == "int8":
        # fuse=False: the fused qkv/gateup layout is a serving-side
        # transform; training needs per-projection weights so LoRA deltas
        # can be merged back for eval/export
        params = quantize_lm_for_serving(params, fuse=False)
    elif args.base_quant in ("nf4", "int4"):
        from ..runtime.quantize import quantize_lm_for_training

        params = quantize_lm_for_training(params, kind=args.base_quant, fuse=False)
    tokenizer = AutoTokenizer.from_pretrained(args.model_path, padding_side="right")
    processor = PaliGemmaProcessor(
        tokenizer,
        num_image_tokens=config.vision_config.num_image_tokens,
        image_size=config.vision_config.image_size,
    )

    tc = TrainConfig(
        learning_rate=args.learning_rate,
        grad_clip=args.grad_clip,
        grad_accum_steps=args.grad_accum,
        warmup_steps=args.warmup_steps,
        lora_rank=None if args.full_finetune else args.lora_rank,
        fsdp=args.fsdp,
    )
    trainer = Trainer(params, config, tc, mesh=None if rank is None else rank.mesh)
    del params  # under a mesh the trainer keeps this rank's slices only
    if args.resume_from:
        trainer.restore(args.resume_from)

    if args.hf_dataset:
        from ..train.hf_dataset import load_hf_rows

        train_rows = list(load_hf_rows(
            args.hf_dataset, split=args.hf_train_split, prompt=args.prompt
        ).rows())
        eval_rows = (
            list(load_hf_rows(args.hf_dataset, split=args.hf_eval_split,
                              prompt=args.prompt).rows())
            if args.hf_eval_split else []
        )
    else:
        train_rows = load_manifest(args.train_jsonl)
        eval_rows = []
    if args.eval_jsonl:
        eval_rows = load_manifest(args.eval_jsonl)

    def _image(r):
        return Image.open(r["image"]) if isinstance(r["image"], str) else r["image"]

    def batches(rows, bs, epoch):
        """Seeded per-epoch shuffle; the tail partial batch is KEPT by
        replicating rows up to ``bs`` with their labels blanked to -100, so
        the padding rows contribute zero gradient and every step has a
        full batch (the reference's loader shuffles and drops nothing)."""
        order = list(range(len(rows)))
        if args.shuffle_seed >= 0:
            np.random.default_rng(args.shuffle_seed + epoch).shuffle(order)
        for i in range(0, len(order), bs):
            idx = order[i : i + bs]
            n_real = len(idx)
            idx = idx + [idx[0]] * (bs - n_real)  # replicate to full batch
            chunk = [rows[j] for j in idx]
            batch = collate(
                processor, [_image(r) for r in chunk],
                [r["prompt"] for r in chunk],
                [r["target"] for r in chunk],
                max_length=args.max_length,
            )
            if n_real < bs:
                batch["labels"][n_real:] = -100  # padding rows: no gradient
            yield batch

    from ..runtime.logging import MetricsLogger

    step = 0
    if lead:
        os.makedirs(args.output_dir, exist_ok=True)
        metrics = MetricsLogger(os.path.join(args.output_dir, "metrics.jsonl"))
    best_dist, evals_since_best, stop = float("inf"), 0, False
    for epoch in range(args.epochs):
        if stop:
            break
        for batch in batches(train_rows, args.batch_size, epoch):
            t0 = time.perf_counter()
            loss = trainer.train_step(batch)  # a float: the step has ended on the device
            dt = time.perf_counter() - t0
            step += 1
            tokens = int(batch["attention_mask"].sum())
            say(f"epoch {epoch} step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if lead:
                metrics.log(step, epoch=epoch, train_loss=loss, step_ms=dt * 1e3,
                            tokens_per_sec=tokens / dt)
            if eval_rows and step % args.eval_every == 0:
                dist = _evaluate(trainer, processor, eval_rows, config, args, rank)
                if lead:
                    metrics.log(step, val_edit_distance=dist)
                if dist < best_dist - 1e-6:
                    best_dist, evals_since_best = dist, 0
                else:
                    evals_since_best += 1
                if (args.early_stopping_patience
                        and evals_since_best >= args.early_stopping_patience):
                    say(f"early stopping: no val improvement for "
                        f"{evals_since_best} evals")
                    stop = True
                    break
        trainer.save(os.path.join(args.output_dir, f"epoch_{epoch}"))
    trainer.save(os.path.join(args.output_dir, "final"))
    if lead:
        metrics.close()
    if args.export_hf:
        from ..checkpoints.hf_export import export_hf_checkpoint

        merged = trainer.merged_params()  # every rank: the gather is collective
        if lead:
            export_dir = os.path.join(args.output_dir, "hf_export")
            export_hf_checkpoint(config, merged, export_dir)
            # ship the tokenizer along so the export is directly servable
            tokenizer.save_pretrained(export_dir)
            print(f"exported HF checkpoint to {export_dir}")
        del merged
    say("done")


def _evaluate(trainer, processor, eval_rows, config, args, rank=None):
    """The mean normalized edit distance of greedy answers on the eval
    subset: on rank 0, in one card's engine over the merged weights every
    rank gathers; the score is handed to the other ranks."""
    import numpy as np
    from PIL import Image

    from ..runtime.engine import PaliGemmaEngine
    from ..train.data import normalized_edit_distance

    merged = trainer.merged_params()  # every rank: the gather is collective
    dist = None
    if rank is None or rank.lead:
        engine = PaliGemmaEngine(
            merged, config,
            max_seq_len=args.max_length + args.max_new_tokens_eval,
            eos_token_id=processor.tokenizer.eos_token_id,
            # the plain bf16 decode: the merged tree is not the int8 decode
            # tree the decode kernels take (the JAX engine turns its fused
            # layer off for such a tree itself)
            fused_layer=False,
        )
        scores = []
        subset = eval_rows[: args.eval_subset] if args.eval_subset else eval_rows
        for row in subset:
            img = Image.open(row["image"]) if isinstance(row["image"], str) else row["image"]
            inputs = processor(images=[img], text=[row["prompt"]])
            toks = engine.generate(
                inputs["pixel_values"], inputs["input_ids"], inputs["attention_mask"],
                max_new_tokens=args.max_new_tokens_eval, do_sample=False,
            )
            pred = processor.tokenizer.decode(toks[0], skip_special_tokens=True)
            scores.append(normalized_edit_distance(pred, row["target"]))
        dist = float(np.mean(scores))
        print(f"val_edit_distance {dist:.4f}")
        del engine
    del merged
    return dist if rank is None else rank.share(dist)


if __name__ == "__main__":
    main()
