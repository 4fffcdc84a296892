"""Inference CLI (port of paligemma_tpu/cli/infer.py).

Mirrors the reference entrypoint and its flags (ref: inference.py:109-154,
launched by launch_inference.sh): load an HF checkpoint directory, process
one or more images + prompts, generate with greedy or temperature/top-p
sampling, print prompt + decoded continuation.

    python -m paligemma_tpu_torch.cli.infer --model_path <dir> \\
        --prompt "caption en" --image_file_path pic.jpg --quantize_int8

Device: the card (``cuda:0``), or the CPU with ``--only_cpu``; with no card
and no ``--only_cpu`` it exits with an error and never runs on the CPU by
itself. ``--dtype float32`` runs on the card through the fp32 forms of the
kernels (the flash forward, the int8 GEMV tile and head, the split decode
attention, the final norm), with every other flag: ``--int8_prefill`` (the
W8A8 kernels' fp32 forms), ``--model_parallel N`` and ``--data_parallel D``
(the fp32 partial of the tensor-parallel chains).

Decode: with ``--quantize_int8`` the engine decodes from the int8 tree
(runtime.quantize) with its kernel defaults (on the card: the
hand-written decode layer and head kernels, in the ``--dtype``); without
it, the plain decode (``fused_layer=False``), as the JAX package's decode
is XLA.

``--int8_prefill`` (with ``--quantize_int8``) serves from one int8 tree:
the bf16 copy of the LM is dropped once quantized, and the prefill runs
its projections W8A8 (each row of activations quantized to int8; on the
card the int8 x int8 GEMM of kernels/w8a8). Without ``--quantize_int8`` it
exits with an error.

``--speculative`` (greedy, one image and prompt) decodes with n-gram
speculative decoding (runtime/engine ``generate_spec``, ``--draft_k``
drafts a cycle): the tokens of greedy decoding, and the cycles in the
``timings`` line.

``--model_parallel N`` (N > 1) serves the model tensor-parallel over N
ranks, one process each (cli/ranks: spawned here, or one per process under
``torchrun --nproc_per_node N``): every rank loads the checkpoint and the
images, keeps its slices (core/mesh.shard_params) and runs the same
``PaliGemmaEngine(mesh=...)``; rank 0 prints the rows and the timings.
Each rank takes ``cuda:(rank % device_count)``; ranks that share a card
run over gloo (a correctness run: every collective stages through host
memory).

``--data_parallel D`` (D > 1, with or without ``--model_parallel M``)
splits the batch over D data shards, D x M ranks in all (cli/ranks): each
shard prefills and decodes its own ``B/D`` rows (runtime/engine under a
data axis) and every rank returns the whole batch; rank 0 prints the rows
in prompt order. The prompts must divide over D, and ``--speculative``
(one prompt) takes no data axis: both exit with an error.

Besides the printed rows, the run's phases (load, quantize, preprocess,
prefill, decode) are written as one ``timings:`` JSON line to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from . import ranks
from .errors import CliError, require, user_errors

# decode steps per host check for EOS (engine.generate's sync_every): the
# same tokens at any value, and above 1 a greedy row takes its next token
# from the head kernel's on-device argmax instead of copying logits out
SYNC_EVERY = 8


@dataclasses.dataclass
class InferResult:
    tokens: np.ndarray  # (B, <= max_tokens_to_generate) int32
    texts: List[str]  # prompt + decoded, one per row
    pixel_route: str  # "native" or "pil" (processing.processor)
    timings: Dict[str, float]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="PaliGemma inference (PyTorch + CUDA)")
    p.add_argument("--model_path", required=True, help="HF checkpoint directory")
    p.add_argument("--prompt", required=True, action="append",
                   help="prefix prompt (repeat for a batch)")
    p.add_argument("--image_file_path", required=True, action="append",
                   help="image path (repeat for a batch)")
    p.add_argument("--max_tokens_to_generate", type=int, default=100)
    p.add_argument("--temperature", type=float, default=0.8)
    p.add_argument("--top_p", type=float, default=0.9)
    p.add_argument("--do_sample", action="store_true")
    p.add_argument("--only_cpu", action="store_true")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--int8_prefill", action="store_true",
                   help="prefill from the int8 tree too (single weight copy on the "
                        "card; W8A8 prefill: int8 x int8 products). Requires "
                        "--quantize_int8")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only quantization of the decoder")
    p.add_argument("--max_seq_len", type=int, default=1024)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split the batch over D data shards (D x --model_parallel ranks, one "
                        "process each); the prompts must divide over D")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallel over N ranks, one process each (spawned, or under "
                        "torchrun --nproc_per_node N); ranks sharing a card run over gloo")
    p.add_argument("--speculative", action="store_true",
                   help="n-gram speculative decoding (greedy, one image and prompt): "
                        "draft tokens from the prompt and output so far, verified in "
                        "one forward (runtime.engine.generate_spec); the tokens of "
                        "greedy decoding")
    p.add_argument("--draft_k", type=int, default=8,
                   help="draft tokens proposed per speculative cycle (with --speculative)")
    p.add_argument("--decode_detections", action="store_true",
                   help="parse <loc####>/<seg###> tokens in the output "
                        "('detect ...' / 'segment ...' prompts) and print "
                        "one JSON line of pixel boxes per image")
    return p.parse_args(argv)


def card_or_cpu(only_cpu: bool) -> torch.device:
    """The card (``cuda:0``), or the CPU when asked; no card and no
    ``--only_cpu`` is an error, never a silent run on the CPU. On the card
    either ``--dtype`` runs the kernels (fp32: their fp32 forms)."""
    if only_cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise CliError("no CUDA device found; pass --only_cpu to run on the CPU")
    return torch.device("cuda", 0)


def check_parallel(args) -> None:
    """The mesh flags both CLIs take: each axis at least 1."""
    require(args.data_parallel >= 1, "--data_parallel must be at least 1")
    require(args.model_parallel >= 1, "--model_parallel must be at least 1")


def _device(args) -> torch.device:
    require(not args.int8_prefill or args.quantize_int8, "--int8_prefill requires --quantize_int8")
    check_parallel(args)
    d = args.data_parallel
    if d > 1:
        require(not args.speculative,
                f"--speculative decodes one image and prompt (B == 1), which cannot split over "
                f"--data_parallel {d}; drop one of them")
        require(len(args.prompt) % d == 0,
                f"--data_parallel {d} splits the batch over {d} shards: pass a multiple of {d} "
                f"prompts (got {len(args.prompt)})")
    return card_or_cpu(args.only_cpu)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace, tokenizer=None, *, rank: "ranks.Rank" = None) -> InferResult:
    """The CLI's body: prints as the CLI does and returns the tokens, the
    printed rows and the timings. ``tokenizer``: used in place of
    ``AutoTokenizer.from_pretrained(args.model_path)`` when given.
    ``rank``: this process's place among the ranks of ``--data_parallel``
    x ``--model_parallel`` (cli/ranks); only rank 0 prints."""
    device = _device(args)
    say = print
    if rank is not None:
        device, say = rank.device, rank.say
    prompts = list(args.prompt)
    require(
        len(args.image_file_path) == len(prompts),
        f"got {len(prompts)} --prompt but {len(args.image_file_path)} "
        "--image_file_path; pass one image per prompt",
    )
    require(args.max_tokens_to_generate >= 1, "--max_tokens_to_generate must be at least 1")
    if args.speculative:
        require(not args.do_sample, "--speculative is greedy-only; drop --do_sample")
        require(len(prompts) == 1, "--speculative serves one image/prompt at a time")
        require(args.draft_k >= 1, "--draft_k must be at least 1")

    from PIL import Image

    from ..checkpoints.hf_loader import load_hf_model
    from ..processing.processor import PaliGemmaProcessor
    from ..runtime.engine import PaliGemmaEngine
    from ..runtime.quantize import quantize_lm_for_serving

    # opened (not decoded) before the load, so a wrong path fails at once
    images = [Image.open(f) for f in args.image_file_path]
    timings: Dict[str, float] = {}
    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    say(f"Device in use: {device}{name}")
    say("Loading model")
    t0 = time.perf_counter()
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params, config = load_hf_model(args.model_path, dtype, device=device)
    _sync(device)
    timings["load_s"] = time.perf_counter() - t0
    # split precision: --dtype weights for the compute-bound prefill, int8
    # for the bandwidth-bound decode
    decode_params = None
    if args.quantize_int8:
        t0 = time.perf_counter()
        decode_params = quantize_lm_for_serving(params)
        _sync(device)
        timings["quantize_s"] = time.perf_counter() - t0
    if args.int8_prefill:
        params = decode_params  # single-copy: the bf16 tree is dropped

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_path, padding_side="right")
    processor = PaliGemmaProcessor(
        tokenizer,
        num_image_tokens=config.vision_config.num_image_tokens,
        image_size=config.vision_config.image_size,
    )
    t0 = time.perf_counter()
    inputs = processor(images=images, text=prompts)
    timings["preprocess_ms"] = (time.perf_counter() - t0) * 1e3

    # grow the cache to fit prompt + budget (the reference's torch.cat cache
    # grows unboundedly, ref: modeling_gemma.py:54-55; ours is preallocated,
    # so size it up front instead of silently clamping writes)
    need = inputs["input_ids"].shape[1] + args.max_tokens_to_generate
    if args.speculative:  # a verify writes draft_k slots past the last token
        need += args.draft_k
    max_seq_len = max(args.max_seq_len, ((need + 127) // 128) * 128)
    engine = PaliGemmaEngine(
        params, config,
        max_seq_len=max_seq_len,
        eos_token_id=tokenizer.eos_token_id,
        decode_params=decode_params,
        # the plain decode unless the int8 tree was asked for
        fused_layer=None if args.quantize_int8 else False,
        int8_act_prefill=args.int8_prefill,
        mesh=None if rank is None else rank.mesh,
    )
    say("Running inference")
    prefill = engine.prefill

    def timed_prefill(*a, **kw):  # the prefill's own time, vision included
        t = time.perf_counter()
        out = prefill(*a, **kw)
        _sync(device)
        timings["prefill_ms"] = (time.perf_counter() - t) * 1e3
        return out

    engine.prefill = timed_prefill
    t0 = time.perf_counter()
    try:
        if args.speculative:
            tokens = engine.generate_spec(
                inputs["pixel_values"],
                inputs["input_ids"],
                inputs["attention_mask"],
                max_new_tokens=args.max_tokens_to_generate,
                draft_k=args.draft_k,
                sync_every=SYNC_EVERY,
            )
            timings["spec_cycles"] = engine.spec_cycles
        else:
            tokens = engine.generate(
                inputs["pixel_values"],
                inputs["input_ids"],
                inputs["attention_mask"],
                max_new_tokens=args.max_tokens_to_generate,
                temperature=args.temperature,
                top_p=args.top_p,
                do_sample=args.do_sample,
                generator=torch.Generator(device=device).manual_seed(args.seed),
                sync_every=SYNC_EVERY,
            )
    finally:
        del engine.prefill  # no reference cycle keeps the weights alive
    timings["decode_ms"] = (time.perf_counter() - t0) * 1e3 - timings["prefill_ms"]
    timings["tokens"] = int(tokens.shape[1])
    if rank is not None:
        rank.agree(tokens.tolist(), "the generated tokens")

    texts = []
    for prompt, row, image in zip(prompts, tokens, images):
        decoded = tokenizer.decode(row, skip_special_tokens=True)
        texts.append(prompt + decoded)
        say(prompt + decoded)
        if args.decode_detections:
            from ..processing.detection import extract_objects

            w, h = image.size
            objs = [
                {
                    "label": o.label,
                    "box_yxyx": list(o.box_pixels(h, w)),
                    "has_mask": o.seg_indices is not None,
                }
                for o in extract_objects(decoded)
            ]
            say(json.dumps(objs))
    say(f"timings: {json.dumps(timings)}", file=sys.stderr)
    return InferResult(tokens=tokens, texts=texts, pixel_route=processor.last_route,
                       timings=timings)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    with user_errors():
        args = parse_args(argv)
        if args.data_parallel * args.model_parallel > 1:
            _device(args)  # the flags' errors before any rank starts
            ranks.launch(_rank_main, argv, args.model_parallel, args.only_cpu,
                         data_parallel=args.data_parallel)
        else:
            run(args)


def _rank_main(argv, rank: "ranks.Rank") -> None:
    """One rank of the CLI's mesh (cli/ranks)."""
    with user_errors():
        run(parse_args(argv), rank=rank)


if __name__ == "__main__":
    main()
