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
no ``--only_cpu`` exits 2, and so does ``--dtype float32`` on the card.
With ``--quantize_int8`` the engines decode from the int8 tree with their
kernel defaults (on the card: the decode kernel chain); without it, the
plain bf16 decode, as in cli/infer.

``--spec_decode`` serves with n-gram speculative decoding (greedy only: a
sampled request is refused with an error line; ``--spec_draft_k`` drafts a
cycle), with the tokens of the engine without it.

``--int8_prefill`` (with ``--quantize_int8``) serves from one int8 tree,
as cli/infer: the bf16 copy of the LM is dropped and every prefill wave
runs its projections W8A8; without ``--quantize_int8`` it exits 2.

Flags of parts not yet ported exit 2 with the ROADMAP item that ports
them: ``--data_parallel`` / ``--model_parallel`` above 1 (item 14). ``--lora``
reads the port's own adapter checkpoints (checkpoints/local.save_pytree of
``{"lora": ...}``, as ``cli.finetune`` writes under ``final/``), not the
JAX package's orbax ones (reading those needs jax).
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import queue
import sys
import threading
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from .errors import CliError, require, user_errors


def main(argv=None):
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
                   help="not ported above 1: exits with an error")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="not ported above 1: exits with an error")
    return p


def _main(argv=None):
    args = _build_parser().parse_args(argv)
    require(args.requests_jsonl is not None or args.http is not None,
            "pass --requests_jsonl FILE (or -) for batch mode, or --http PORT for server mode")
    srv = build_server(args)
    if args.http is not None:
        srv.serve_http(args.http)
    else:
        srv.run_batch(args.requests_jsonl)


def _device(args) -> torch.device:
    from .infer import card_or_cpu

    require(not args.int8_prefill or args.quantize_int8, "--int8_prefill requires --quantize_int8")
    require(args.data_parallel * args.model_parallel == 1,
            "--data_parallel / --model_parallel above 1 are not ported yet (ROADMAP item 14: "
            "the port's mesh runs one process per rank, and a front end over it is its own "
            "design)")
    return card_or_cpu(args.only_cpu, args.dtype)


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


def build_server(args):
    """Load the model and wire up a ready-to-run ``_Server`` (apart from
    ``_main`` so that tests can drive HTTP mode in-process)."""
    device = _device(args)
    lora_specs = _named(args.lora, "lora", "NAME=DIR")
    grammar_specs = _named(args.grammar, "grammar", "NAME=REGEX")
    from transformers import AutoTokenizer

    from ..checkpoints.hf_loader import load_hf_model
    from ..processing.processor import PaliGemmaProcessor
    from ..runtime.quantize import quantize_lm_for_serving
    from ..runtime.serving import ServingEngine
    from ..runtime.serving_paged import PagedServingEngine

    name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    print(f"Device in use: {device}{name}", file=sys.stderr)
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
              int8_act_prefill=args.int8_prefill,
              # the kernel tick takes the int8 tree; the bf16 decode is the plain one
              fused_decode=None if args.quantize_int8 else False)
    if args.engine == "paged":
        engine = PagedServingEngine(params, config, page_size=args.page_size,
                                    n_pages=args.n_pages, **kw)
    else:
        engine = ServingEngine(params, config, **kw)
    return _Server(engine, processor, tokenizer, args.max_new_tokens)


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
    """Shared request plumbing for batch and HTTP modes."""

    def __init__(self, engine, processor, tokenizer, default_max_new):
        self.engine = engine
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

    def run_batch(self, path):
        fh = sys.stdin if path == "-" else open(path)
        try:
            rows = [json.loads(ln) for ln in fh if ln.strip()]
        except json.JSONDecodeError as e:
            raise CliError(f"bad JSON in requests file: {e}")
        finally:
            if fh is not sys.stdin:
                fh.close()
        require(rows, "requests file is empty")
        for row in rows:
            self.engine.submit(self._to_request(row))
        inflight = None
        while self.engine.has_work or inflight is not None:
            finished, inflight = self.engine.advance(inflight)
            for req in finished:
                print(json.dumps(self._result(req)), flush=True)
        print(f"served {self._served} requests", file=sys.stderr)

    # ---- HTTP mode ----

    def _take(self, call: _Call, waiting: Dict[int, _Call]) -> None:
        """Apply one call on the engine's thread."""
        if call.cancel is not None:
            ok = self.engine.cancel(call.cancel)
            victim = waiting.pop(call.cancel, None)
            if victim is not None:  # answer its /generate
                victim.finish({"request_id": call.cancel, "cancelled": True, "num_tokens": None})
            call.finish({"request_id": call.cancel, "cancelled": ok})
            return
        try:
            self.engine.submit(call.req)
        except ValueError as e:  # a bad request, not a server fault
            call.finish({"error": str(e)}, 400)
            return
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

        def engine_loop():
            inflight = None
            try:
                while True:
                    if inflight is None and not self.engine.has_work:
                        work.wait()
                    if stop.is_set():
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
                            finished, inflight = self.engine.advance(inflight)
                    for req in finished:
                        call = waiting.pop(req.request_id, None)
                        if call is not None:  # None: a /cancel answered it
                            call.finish(self._result(req))
            except Exception:  # the engine failed: answer the waiting calls, stop
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


if __name__ == "__main__":
    main()
