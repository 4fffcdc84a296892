"""Serving CLI (port of paligemma_tpu/cli/serve.py): continuous-batching
inference over many requests, through the port's serving engines
(runtime/serving.py, runtime/serving_paged.py).

* **batch mode** (``--requests_jsonl FILE`` or ``-`` for stdin): read one
  JSON request per line, run them all through the engine with continuous
  batching (slots refill as requests finish), and print one JSON result
  line per request in completion order.
* **HTTP mode** (``--http PORT``, bound to 127.0.0.1 only): ``POST
  /generate`` with the same JSON request returns the decoded text;
  ``"stream": true`` answers with server-sent events, one ``data:
  {"token", "text_delta"}`` per accepted token (in window-sized bursts)
  and a final ``data: {..., "done": true}``. ``POST /cancel`` with
  ``{"request_id": N}`` cancels a queued or running request (its waiting
  /generate answers ``{"cancelled": true}``); ``GET /healthz`` reports
  what was served. One thread owns the engine: handlers hand it their
  requests and cancels, in arrival order, and it runs the scheduler's
  rounds (pipelined on the card) while there is work, so concurrent
  requests share the same decode ticks.

Request JSON: ``{"prompt": str, "image": path}`` plus optional
``request_id``, ``max_new_tokens``, ``do_sample``, ``temperature``,
``top_p``, ``lora`` (a ``--lora`` name) and ``grammar`` (a ``--grammar``
name); HTTP requests may pass ``image_b64`` (base64 image bytes) instead of
a path. Result line: ``request_id``, ``text``, ``num_tokens`` and the
request's latencies (``Request.metrics()``).

    python -m paligemma_tpu_torch.cli.serve --model_path <dir> \\
        --requests_jsonl reqs.jsonl --quantize_int8 [--engine paged]

Device: the card, or the CPU with ``--only_cpu``, as cli/infer: no card and
no ``--only_cpu`` exits 2. ``--dtype float32`` runs on the card through the
kernels' fp32 forms with every flag (dense and paged, sampled rows,
``--grammar``, ``--prefix_cache``, ``--spec_decode``, ``--lora``,
``--int8_prefill``, ``--model_parallel N``, ``--data_parallel D``).
With ``--quantize_int8`` the engines decode from the int8 tree with their
kernel defaults (on the card: the decode kernel chain); without it, the
plain decode, as in cli/infer.

``--spec_decode`` serves with n-gram speculative decoding (greedy only: a
sampled request is refused with an error line; ``--spec_draft_k`` drafts a
cycle), with the tokens of the engine without it.

``--int8_prefill`` (with ``--quantize_int8``) serves from one int8 tree,
as cli/infer: the bf16 copy of the LM is dropped and every prefill wave
runs its projections W8A8; without ``--quantize_int8`` it exits 2.

``--model_parallel N`` (N > 1) serves tensor-parallel over N ranks, one
process each (cli/ranks: spawned here, or one per process under ``torchrun
--nproc_per_node N``), with every flag above. Every rank loads the
checkpoint (and the ``--lora`` adapters, each rank keeping its shard) and
builds the same engine with the mesh. Batch mode: rank 0 reads the
requests and hands them to the other ranks over the ranks' control group;
every rank runs the same batch and only rank 0 prints. HTTP mode: rank 0
runs the front end, and its engine thread hands every engine call
(submit, cancel, one scheduler round, stop) to the other ranks before it
makes it; they apply the calls in that order (``_Server.follow``). Every
rank reads back the same tokens (held against each other at the end);
only rank 0 answers. An idle server waits on the control group, whose
timeout an idle server does not reach (cli/ranks).

``--data_parallel D`` (D > 1, with or without ``--model_parallel M``;
D x M ranks) serves the paged engine with its slots and page pool split
over D data shards (runtime/serving_paged), batch or HTTP as above: every
rank schedules all shards alike and computes its own. As in the JAX CLI,
``--engine dense`` (pure TP: slots are the batch) and a ``--max_slots``
(or ``--n_pages``) that does not divide over D exit 2. ``--lora``
reads the port's own adapter checkpoints (checkpoints/local.save_pytree of
``{"lora": ...}``, as ``cli.finetune`` writes under ``final/``), not the
JAX package's orbax ones (reading those needs jax).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import os
import queue
import sys
import tempfile
import threading
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from . import ranks
from .errors import CliError, require, user_errors


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    with user_errors():
        _main(argv)


def _build_parser():
    p = argparse.ArgumentParser(
        description="PaliGemma continuous-batching server (PyTorch + CUDA)")
    p.add_argument("--model_path", required=True, help="HF checkpoint directory")
    p.add_argument("--engine", default="dense", choices=["dense", "paged"])
    p.add_argument("--requests_jsonl", default=None,
                   help="JSONL request file, or '-' for stdin (batch mode)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve HTTP on 127.0.0.1:PORT instead of batch mode")
    p.add_argument("--max_slots", type=int, default=8)
    p.add_argument("--max_seq_len", type=int, default=1024)
    p.add_argument("--page_size", type=int, default=64, help="paged engine: tokens per KV page")
    p.add_argument("--n_pages", type=int, default=None,
                   help="paged engine: physical page-pool size (default: half the dense "
                        "reservation)")
    p.add_argument("--sync_every", type=int, default=8,
                   help="decode ticks per host read-back")
    p.add_argument("--prefix_cache", action="store_true",
                   help="exact-match prefix KV reuse: a byte-identical (image, prompt) pair "
                        "is seated with no prefill (paged: page sharing, dense: KV row "
                        "copies)")
    p.add_argument("--spec_decode", action="store_true",
                   help="n-gram speculative decoding inside the batched window (greedy "
                        "requests only; the tokens of the engine without it)")
    p.add_argument("--spec_draft_k", type=int, default=8,
                   help="drafted tokens per speculative cycle (with --spec_decode)")
    p.add_argument("--grammar", action="append", default=[], metavar="NAME=REGEX",
                   help="register a constrained-decoding grammar (a regex subset over the "
                        "output text, e.g. yes|no or \\d+(,\\d+)*), repeatable; requests "
                        'pick one with {"grammar": NAME}. Constrained rows emit only tokens '
                        "that keep the output a valid prefix and stop only on a complete "
                        "match")
    p.add_argument("--lora", action="append", default=[], metavar="NAME=DIR",
                   help="serve the LoRA adapter in DIR under NAME, repeatable; requests pick "
                        'one with {"lora": NAME}. DIR is a checkpoint of this package '
                        "(checkpoints/local.save_pytree of {'lora': adapter tree}); the JAX "
                        "package's orbax finetune checkpoints are not read")
    p.add_argument("--max_new_tokens", type=int, default=100, help="default per-request budget")
    p.add_argument("--quantize_int8", action="store_true",
                   help="int8 weight-only decode (the decode kernels on the card)")
    p.add_argument("--int8_prefill", action="store_true",
                   help="prefill from the int8 tree too (drops the bf16 copy from the card; "
                        "W8A8 prefill: int8 x int8 products). Requires --quantize_int8")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--only_cpu", action="store_true")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="split the paged engine's slots and page pool over D data shards "
                        "(D x --model_parallel ranks, one process each)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="tensor parallel over N ranks, one process each (spawned, or under "
                        "torchrun --nproc_per_node N); ranks sharing a card run over gloo")
    return p


def _main(argv):
    args = _build_parser().parse_args(argv)
    require(args.requests_jsonl is not None or args.http is not None,
            "pass --requests_jsonl FILE (or -) for batch mode, or --http PORT for server mode")
    if args.data_parallel * args.model_parallel > 1:
        _device(args)  # the flags' errors before any rank starts
        with _stdin_as_file(args, argv) as rank_argv:
            ranks.launch(_rank_main, rank_argv, args.model_parallel, args.only_cpu,
                         data_parallel=args.data_parallel)
        return
    _serve(args)


@contextlib.contextmanager
def _stdin_as_file(args, argv):
    """``--requests_jsonl -`` for spawned ranks: a spawned process reads no
    stdin, so this process reads it into a temporary file and rank 0 reads
    that (under torchrun rank 0 reads its own stdin)."""
    if args.requests_jsonl != "-" or "WORLD_SIZE" in os.environ:
        yield argv
        return
    fd, path = tempfile.mkstemp(prefix="paligemma_requests_", suffix=".jsonl")
    try:
        with os.fdopen(fd, "w") as fh:
            fh.write(sys.stdin.read())
        out = list(argv)
        for i, a in enumerate(out):
            if a == "--requests_jsonl=-":
                out[i] = f"--requests_jsonl={path}"
            elif a == "-" and i > 0 and out[i - 1] == "--requests_jsonl":
                out[i] = path
        yield out
    finally:
        os.remove(path)


def _serve(args, rank: "ranks.Rank" = None) -> None:
    srv = build_server(args, rank=rank)
    if args.http is None:
        srv.run_batch(args.requests_jsonl)
    elif rank is None or rank.lead:
        srv.serve_http(args.http)
    else:
        srv.follow()


def _rank_main(argv, rank: "ranks.Rank") -> None:
    """One rank of the CLI's mesh (cli/ranks)."""
    with user_errors():
        _serve(_build_parser().parse_args(argv), rank)


def _device(args) -> torch.device:
    from .infer import card_or_cpu, check_parallel

    require(not args.int8_prefill or args.quantize_int8, "--int8_prefill requires --quantize_int8")
    check_parallel(args)
    if args.data_parallel > 1:  # the JAX CLI's refusals
        require(args.engine == "paged",
                "--engine dense shards weights only (pure TP): use --model_parallel N with "
                "--data_parallel 1, or --engine paged for a data axis")
        require(args.max_slots % args.data_parallel == 0,
                "--max_slots must divide evenly over --data_parallel shards")
        require(args.n_pages is None or args.n_pages % args.data_parallel == 0,
                "--n_pages must divide evenly over --data_parallel shards")
    return card_or_cpu(args.only_cpu)


def _named(specs, what, form):
    """``NAME=VALUE`` flags -> [(name, value)], names unique."""
    out, seen = [], set()
    for spec in specs:
        require("=" in spec, f"--{what} expects {form}, got {spec!r}")
        name, value = spec.split("=", 1)
        require(name not in seen, f"--{what} name {name!r} given twice")
        seen.add(name)
        out.append((name, value))
    return out


def build_server(args, *, rank: "ranks.Rank" = None):
    """Load the model and wire up a ready-to-run ``_Server`` (apart from
    ``_main`` so that tests can drive HTTP mode in-process). ``rank``: this
    process's place among ``--model_parallel``'s ranks (cli/ranks)."""
    device = _device(args)
    say = print
    if rank is not None:
        device, say = rank.device, rank.say
    lora_specs = _named(args.lora, "lora", "NAME=DIR")
    grammar_specs = _named(args.grammar, "grammar", "NAME=REGEX")
    from transformers import AutoTokenizer

    from ..checkpoints.hf_loader import load_hf_model
    from ..processing.processor import PaliGemmaProcessor
    from ..runtime.quantize import quantize_lm_for_serving
    from ..runtime.serving import ServingEngine
    from ..runtime.serving_paged import PagedServingEngine

    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    say(f"Device in use: {device}{name}", file=sys.stderr)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    params, config = load_hf_model(args.model_path, dtype, device=device)
    decode_params = quantize_lm_for_serving(params) if args.quantize_int8 else None
    if args.int8_prefill:
        params = decode_params  # single-copy serving: the bf16 tree is dropped
    tokenizer = AutoTokenizer.from_pretrained(args.model_path, padding_side="right")
    processor = PaliGemmaProcessor(
        tokenizer,
        num_image_tokens=config.vision_config.num_image_tokens,
        image_size=config.vision_config.image_size,
    )

    lora_bank = None
    if lora_specs:
        from ..checkpoints.local import restore_pytree

        lora_bank = {}
        for lname, path in lora_specs:
            state = restore_pytree(path)
            require(isinstance(state, dict) and "lora" in state,
                    f"{path} is not a LoRA adapter checkpoint of this package (expected "
                    "checkpoints/local.save_pytree of {'lora': adapter tree}; the JAX "
                    "package's orbax checkpoints are not read)")
            lora_bank[lname] = state["lora"]

    grammars = None
    if grammar_specs:
        from ..processing.grammar import (compile_regex, compile_token_dfa,
                                          token_strings_from_tokenizer)

        strs = token_strings_from_tokenizer(tokenizer, min(len(tokenizer), config.vocab_size))
        strs += [""] * (config.vocab_size - len(strs))
        grammars = {}
        for gname, pattern in grammar_specs:
            try:
                dfa = compile_regex(pattern)
            except ValueError as e:
                raise CliError(f"--grammar {gname}: {e}")
            grammars[gname] = compile_token_dfa(dfa, strs, tokenizer.eos_token_id)

    kw = dict(max_slots=args.max_slots, max_seq_len=args.max_seq_len,
              decode_params=decode_params, sync_every=args.sync_every,
              prefix_cache=args.prefix_cache, lora_bank=lora_bank, grammars=grammars,
              spec_decode=args.spec_decode, spec_draft_k=args.spec_draft_k,
              int8_act_prefill=args.int8_prefill, mesh=None if rank is None else rank.mesh,
              # the kernel tick takes the int8 tree; the bf16 decode is the plain one
              fused_decode=None if args.quantize_int8 else False)
    if args.engine == "paged":
        engine = PagedServingEngine(params, config, page_size=args.page_size,
                                    n_pages=args.n_pages, **kw)
    else:
        engine = ServingEngine(params, config, **kw)
    return _Server(engine, processor, tokenizer, args.max_new_tokens, rank=rank)


class _Call:
    """A /generate submission or a /cancel, handed to the engine's thread."""

    def __init__(self, req=None, cancel: Optional[int] = None):
        self.req = req
        self.cancel = cancel
        self.accepted = threading.Event()  # submitted (or refused), or cancelled
        self.done = threading.Event()  # ``result`` is in
        self.status = 200  # 400: a request the engine refused; 500: the engine failed
        self.result: Optional[dict] = None

    def finish(self, result: dict, status: int = 200) -> None:
        self.result, self.status = result, status
        self.accepted.set()
        self.done.set()


class _Server:
    """Shared request plumbing for batch and HTTP modes. ``rank``: under
    ``--model_parallel``, this process's place among the ranks (module
    docstring); rank 0 reads, answers and prints."""

    def __init__(self, engine, processor, tokenizer, default_max_new, *,
                 rank: "ranks.Rank" = None):
        self.engine = engine
        self.rank = rank
        self.lead = rank is None or rank.lead
        self._submitted: list = []  # the requests every rank submitted, in order
        self.processor = processor
        self.tokenizer = tokenizer
        self.default_max_new = default_max_new
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._served = 0
        self._served_tokens = 0
        # HTTP mode: calls waiting for the engine's thread, which holds
        # ``lock`` while it takes them and runs a scheduler round
        self.inbox: "queue.Queue[_Call]" = queue.Queue()
        self.lock = threading.Lock()

    def _to_request(self, row, image=None):
        """JSON dict -> runtime Request (tokenize and preprocess here, on the
        host, so that engine ticks stay device work)."""
        from PIL import Image

        from ..runtime.serving import Request

        require(isinstance(row, dict) and "prompt" in row,
                "request JSON needs a 'prompt' field")
        if image is None:
            if "image_b64" in row:
                image = Image.open(io.BytesIO(base64.b64decode(row["image_b64"])))
            else:
                require("image" in row, "request JSON needs 'image' (path) or 'image_b64'")
                image = Image.open(row["image"])
        inputs = self.processor(images=[image], text=[row["prompt"]])
        with self._id_lock:
            rid = row.get("request_id")
            if rid is None:
                rid = self._next_id
            self._next_id = max(self._next_id + 1, int(rid) + 1)
        return Request(
            request_id=int(rid),
            input_ids=np.asarray(inputs["input_ids"][0], np.int32),
            pixel_values=np.asarray(inputs["pixel_values"][0], np.float32),
            max_new_tokens=int(row.get("max_new_tokens", self.default_max_new)),
            temperature=float(row.get("temperature", 0.8)),
            top_p=float(row.get("top_p", 0.9)),
            do_sample=bool(row.get("do_sample", False)),
            eos_token_id=self.tokenizer.eos_token_id,
            lora=row.get("lora"),
            grammar=row.get("grammar"),
        )

    def _result(self, req):
        self._served += 1
        self._served_tokens += len(req.tokens)
        return {
            "request_id": req.request_id,
            "text": self.tokenizer.decode(req.tokens, skip_special_tokens=True),
            "num_tokens": len(req.tokens),
            # engine-stamped latencies: queue_ms, ttft_ms, total_ms, decode t/s
            **req.metrics(),
        }

    # ---- batch mode ----

    def _read_batch(self, path):
        fh = sys.stdin if path == "-" else open(path)
        try:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
        except json.JSONDecodeError as e:
            raise CliError(f"bad JSON in requests file: {e}")
        finally:
            if fh is not sys.stdin:
                fh.close()
        require(rows, "requests file is empty")
        return [self._to_request(row) for row in rows]

    def _agree(self) -> None:
        """Under a mesh: every rank read back the same tokens and seated
        each request in the same slot (so on the same data shard); the
        ranks of a model group hold the same state rows of their shard."""
        if self.rank is not None:
            self.rank.agree([(r.request_id, list(r.tokens), r.slot) for r in self._submitted],
                            "the tokens and seats of the requests served")
            self.rank.agree(self.engine.state["write_pos"].tolist(),
                            "the state of the shard's slots", within_model=True)

    def run_batch(self, path):
        reqs, error = None, None
        if self.lead:
            try:
                reqs = self._read_batch(path)
            except Exception as e:  # the other ranks stop with it
                error = e
        if self.rank is not None:  # rank 0's requests, to every rank
            kind, got = self.rank.share(("error", str(error)) if error is not None
                                        else ("ok", reqs))
            if kind == "error" and not self.lead:
                raise CliError(f"rank 0 could not read the requests: {got}")
            reqs = got
        if error is not None:
            raise error
        for req in reqs:
            self.engine.submit(req)
            self._submitted.append(req)
        inflight = None
        while self.engine.has_work or inflight is not None:
            finished, inflight = self.engine.advance(inflight)
            for req in finished:
                if self.lead:
                    print(json.dumps(self._result(req)), flush=True)
        self._agree()
        if self.lead:
            print(f"served {self._served} requests", file=sys.stderr)

    # ---- HTTP mode ----

    def _publish(self, op: str, arg=None) -> None:
        """Under ``--model_parallel``: hand an engine call to the other
        ranks before making it (:meth:`follow`)."""
        if self.rank is not None:
            self.rank.share((op, arg))

    def follow(self) -> None:
        """HTTP mode on a rank other than 0: apply rank 0's engine calls in
        its order until it stops. The wait for the next call is on the
        ranks' control group, which an idle server does not time out."""
        inflight = None
        while True:
            op, arg = self.rank.share()
            if op == "stop":
                break
            if op == "submit":
                try:
                    self.engine.submit(arg)
                except ValueError:  # refused on rank 0 too
                    continue
                self._submitted.append(arg)
            elif op == "cancel":
                self.engine.cancel(arg)
            else:
                _, inflight = self.engine.advance(inflight)
        self._agree()

    def _take(self, call: _Call, waiting: Dict[int, _Call]) -> None:
        """Apply one call on the engine's thread."""
        if call.cancel is not None:
            self._publish("cancel", call.cancel)
            ok = self.engine.cancel(call.cancel)
            victim = waiting.pop(call.cancel, None)
            if victim is not None:  # answer its /generate
                victim.finish({"request_id": call.cancel, "cancelled": True, "num_tokens": None})
            call.finish({"request_id": call.cancel, "cancelled": ok})
            return
        # the other ranks' copy: no callback (it streams from rank 0)
        self._publish("submit", dataclasses.replace(call.req, on_token=None))
        try:
            self.engine.submit(call.req)
        except ValueError as e:  # a bad request, not a server fault
            call.finish({"error": str(e)}, 400)
            return
        self._submitted.append(call.req)
        waiting[call.req.request_id] = call
        call.accepted.set()

    def serve_http(self, port, ready_event=None, max_requests=None):
        """Serve until shut down. ``ready_event`` / ``max_requests`` are for
        tests: the event is set once the socket listens, and the server
        shuts itself down after answering that many /generate calls."""
        import http.server
        import socketserver

        work = threading.Event()  # a call was handed over
        stop = threading.Event()
        waiting: Dict[int, _Call] = {}  # request_id -> its /generate call
        srv_ref = {}
        failed = []  # the engine thread's exception

        def engine_loop():
            inflight = None
            try:
                while True:
                    if inflight is None and not self.engine.has_work:
                        work.wait()
                    if stop.is_set():
                        self._publish("stop")
                        return
                    work.clear()
                    finished = []
                    with self.lock:
                        while True:  # every call handed over so far, in order
                            try:
                                self._take(self.inbox.get_nowait(), waiting)
                            except queue.Empty:
                                break
                        if self.engine.has_work or inflight is not None:
                            self._publish("advance")
                            finished, inflight = self.engine.advance(inflight)
                    for req in finished:
                        call = waiting.pop(req.request_id, None)
                        if call is not None:  # None: a /cancel answered it
                            call.finish(self._result(req))
            except Exception as e:  # the engine failed: answer the waiting calls, stop
                failed.append(e)
                traceback.print_exc()
                for call in waiting.values():
                    call.finish({"error": "the engine failed; see the server's log"}, 500)
                threading.Thread(target=srv_ref["srv"].shutdown, daemon=True).start()

        def hand_over(call: _Call) -> _Call:
            self.inbox.put(call)
            work.set()
            return call

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _reply(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n))

            def _event(self, obj):
                self.wfile.write(("data: " + json.dumps(obj) + "\n\n").encode())
                self.wfile.flush()

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"ok": True, "served": outer._served,
                                      "served_tokens": outer._served_tokens,
                                      "pending": len(waiting) + outer.inbox.qsize()})
                else:
                    self._reply(404, {"error": "unknown path"})

            def do_POST(self):
                if self.path == "/cancel":
                    try:
                        rid = int(self._json()["request_id"])
                    except Exception as e:  # a bad request, not a server fault
                        self._reply(400, {"error": str(e)})
                        return
                    call = hand_over(_Call(cancel=rid))
                    call.done.wait()
                    self._reply(200, call.result)
                    return
                if self.path != "/generate":
                    self._reply(404, {"error": "unknown path"})
                    return
                try:
                    row = self._json()
                    stream = bool(row.get("stream", False))
                    req = outer._to_request(row)
                except Exception as e:  # a bad request, not a server fault
                    self._reply(400, {"error": str(e)})
                    return
                tok_q: "queue.Queue[int]" = queue.Queue()
                if stream:
                    # called on the engine's thread as each window's tokens
                    # are read back
                    req.on_token = tok_q.put
                call = hand_over(_Call(req))
                call.accepted.wait()
                if call.status != 200:
                    self._reply(call.status, call.result)
                    return
                if stream:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    while True:
                        try:
                            tok = tok_q.get(timeout=0.05)
                        except queue.Empty:
                            if call.done.is_set() and tok_q.empty():
                                break
                            continue
                        self._event({"token": int(tok), "text_delta": outer.tokenizer.decode(
                            [tok], skip_special_tokens=True)})
                    self._event({**call.result, "done": True})
                else:
                    call.done.wait()
                    self._reply(call.status, call.result)
                if max_requests is not None and outer._served >= max_requests:
                    threading.Thread(target=srv_ref["srv"].shutdown, daemon=True).start()

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        loop = threading.Thread(target=engine_loop, daemon=True)
        loop.start()
        try:
            with Srv(("127.0.0.1", port), Handler) as srv:
                srv_ref["srv"] = srv
                self.http_port = srv.server_address[1]
                print(f"listening on http://127.0.0.1:{self.http_port}", file=sys.stderr)
                if ready_event is not None:
                    ready_event.set()
                srv.serve_forever()
        finally:
            stop.set()
            work.set()
            loop.join()
        if self.rank is not None:
            if failed:  # the other ranks are ended with this one
                raise RuntimeError("the engine failed on rank 0") from failed[0]
            self._agree()


if __name__ == "__main__":
    main()
