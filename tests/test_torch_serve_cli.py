"""The port's serving CLI (``python -m paligemma_tpu_torch.cli.serve``)
against the JAX package's, on the tiny HF checkpoint directory of
tests/test_torch_cli.py (CPU, ``--only_cpu --dtype float32``):

* batch mode, dense and paged: the result lines give the JAX CLI's
  ``request_id``, ``text`` and ``num_tokens`` for greedy requests, plainly
  and with ``--grammar`` and ``--prefix_cache`` (constrained rows,
  unconstrained rows and byte-identical duplicates in one file), the same
  with ``--spec_decode``, and two long prompts with ``--quantize_int8
  --int8_prefill`` (single-copy serving, a W8A8 prefill wave);
* HTTP mode in-process on a free port: /generate (path and base64 image),
  a stream whose events carry the tokens of the non-stream answer and end
  with a ``done`` event, /healthz, /cancel of a queued request (made
  deterministic by holding the server's engine lock while the request and
  its cancel are handed over), 400s for bad requests; every wait has its
  own timeout;
* ``--lora`` reads a ``save_pytree`` directory;
* ``--only_cpu --model_parallel 2`` (two spawned gloo ranks, cli/ranks,
  on tests/test_torch_cli.py's one-KV-head checkpoint): batch mode with
  ``--lora``, ``--grammar`` and ``--prefix_cache`` (dense) and with
  ``--grammar``, ``--prefix_cache`` and ``--spec_decode`` from stdin
  (paged) prints the one-rank result lines, from rank 0 only; HTTP mode
  answers a request, a stream and a cancel, stays up while idle for longer
  than the ranks' collective timeout, and both ranks shut down cleanly;
* user mistakes, flags of parts not yet ported, ``--int8_prefill``
  without ``--quantize_int8``, a missing card and ``--dtype float32`` on a
  card exit 2 with a one-line reason.
"""

import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

transformers = pytest.importorskip("transformers")

from paligemma_tpu_torch.cli import serve as t_serve  # noqa: E402
from tests.test_torch_cli import checkpoint_dir, image_path, mqa_checkpoint_dir  # noqa: E402,F401

torch.set_num_threads(2)

WAIT = 60  # seconds: the bound on every wait of a test here

ROWS = [
    {"request_id": 7, "prompt": "describe the image", "max_new_tokens": 4},
    {"prompt": "hello world", "max_new_tokens": 3},
    {"prompt": "this building is", "max_new_tokens": 5},
]
# constrained, unconstrained and byte-identical rows for --grammar + --prefix_cache
ROWS_EXTRAS = [
    {"request_id": 0, "prompt": "describe the image", "max_new_tokens": 6, "grammar": "g"},
    {"prompt": "hello world", "max_new_tokens": 4},
    {"prompt": "describe the image", "max_new_tokens": 6, "grammar": "g"},
    {"prompt": "hello world", "max_new_tokens": 4},
    {"prompt": "answer in english", "max_new_tokens": 5, "grammar": "yn"},
    {"prompt": "answer in english", "max_new_tokens": 5, "grammar": "yn"},
]
# two prompts of 260+ tokens (with the image's): one wave of at least 256 rows
ROWS_LONG = [
    {"request_id": 3, "prompt": " ".join(["hello", "world"] * 65), "max_new_tokens": 4},
    {"prompt": " ".join(["this", "building", "is", "a"] * 33), "max_new_tokens": 5},
]
EXTRAS = ["--prefix_cache", "--grammar", "g=(this|building|is|a| )+",
          "--grammar", "yn=(hello|world)"]


def _jsonl(tmp_path, rows, image, name="reqs.jsonl"):
    p = tmp_path / name
    p.write_text("\n".join(json.dumps({**r, "image": image}) for r in rows))
    return str(p)


def _lines(out):
    return [json.loads(ln) for ln in out.strip().splitlines()]


@pytest.mark.parametrize("variant", ["plain", "grammar_prefix_cache", "spec_decode",
                                     "int8_prefill"])
@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_batch_matches_the_jax_cli(checkpoint_dir, image_path, tmp_path, capsys,  # noqa: F811
                                   engine, monkeypatch, variant):
    """int8_prefill: single-copy serving from the int8 tree, two long
    prompts seated in one wave (>= 256 rows: the W8A8 products, counted)."""
    from paligemma_tpu.cli.serve import main as jax_main
    from paligemma_tpu_torch.kernels import quant as t_quant

    rows, extra = (ROWS, []) if variant == "plain" else (ROWS_EXTRAS, EXTRAS)
    seq = ["--max_seq_len", "64"]
    if variant == "spec_decode":
        extra = extra + ["--spec_decode", "--spec_draft_k", "3"]
    if variant == "int8_prefill":
        rows, extra = ROWS_LONG, ["--quantize_int8", "--int8_prefill", "--n_pages", "40"]
        seq = ["--max_seq_len", "256"]
    argv = ["--model_path", checkpoint_dir, "--engine", engine, "--requests_jsonl",
            _jsonl(tmp_path, rows, image_path), "--max_slots", "2", *seq,
            "--page_size", "16", "--sync_every", "2", "--dtype", "float32", *extra]
    jax_main(argv)
    want = _lines(capsys.readouterr().out)
    w8a8_calls = []
    plain = t_quant._w8a8_matmul
    monkeypatch.setattr(t_quant, "_w8a8_matmul",
                        lambda *a: w8a8_calls.append(a[0].shape) or plain(*a))
    t_serve.main(argv + ["--only_cpu"])
    assert len(w8a8_calls) == (8 if variant == "int8_prefill" else 0)  # 4 a layer, one wave
    cap = capsys.readouterr()
    got = _lines(cap.out)
    keys = ("request_id", "text", "num_tokens")
    assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
    assert len(got) == len(rows)
    assert all({"queue_ms", "ttft_ms", "total_ms"} <= set(r) for r in got)
    assert f"served {len(rows)} requests" in cap.err
    if variant == "plain":
        assert {r["request_id"] for r in got} == {7, 8, 9}
        assert {r["request_id"]: r["num_tokens"] for r in got}[9] == 5


def _start(checkpoint_dir, *extra, max_requests=None):  # noqa: F811
    args = t_serve._build_parser().parse_args([
        "--model_path", checkpoint_dir, "--http", "0", "--max_slots", "1",
        "--max_seq_len", "64", "--sync_every", "2", "--dtype", "float32", "--only_cpu",
        *extra])
    srv = t_serve.build_server(args)
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_http, args=(0,),
                         kwargs={"ready_event": ready, "max_requests": max_requests},
                         daemon=True)
    t.start()
    assert ready.wait(WAIT)
    return srv, t, f"http://127.0.0.1:{srv.http_port}"


def _post(base, path, obj, out=None, raw=None):
    data = raw if raw is not None else json.dumps(obj).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as resp:
            r = (resp.status, json.loads(resp.read()))
    except urllib.error.HTTPError as e:
        r = (e.code, json.loads(e.read()))
    if out is not None:
        out.append(r)
    return r


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=WAIT) as resp:
        return json.loads(resp.read())


def _until(cond):
    """Wait (bounded) for a condition that no other thread can undo."""
    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def test_http_generate_stream_healthz(checkpoint_dir, image_path):  # noqa: F811
    srv, t, base = _start(checkpoint_dir, max_requests=3)
    assert srv.http_port > 0
    code, r1 = _post(base, "/generate", {"prompt": "describe the image", "image": image_path,
                                         "max_new_tokens": 5})
    assert code == 200 and r1["num_tokens"] == 5 and isinstance(r1["text"], str)
    assert _get(base, "/healthz") == {"ok": True, "served": 1, "served_tokens": 5,
                                      "pending": 0}
    with open(image_path, "rb") as fh:
        b64 = base64.b64encode(fh.read()).decode()
    code, r2 = _post(base, "/generate", {"prompt": "describe the image", "image_b64": b64,
                                         "max_new_tokens": 5})
    assert code == 200 and r2["text"] == r1["text"]

    data = json.dumps({"prompt": "describe the image", "image": image_path,
                       "max_new_tokens": 5, "stream": True}).encode()
    req = urllib.request.Request(base + "/generate", data=data,
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    done = events[-1]
    toks = [e["token"] for e in events[:-1]]
    assert done["done"] and done["num_tokens"] == 5 and len(toks) == 5
    assert done["text"] == r1["text"]
    tok = srv.tokenizer
    # the deltas are each token's text; the tokens decode to the answer
    assert [e["text_delta"] for e in events[:-1]] == [
        tok.decode([i], skip_special_tokens=True) for i in toks]
    assert tok.decode(toks, skip_special_tokens=True) == r1["text"]
    t.join(WAIT)
    assert not t.is_alive()  # max_requests=3 shut it down


def test_http_cancel_of_a_queued_request(checkpoint_dir, image_path):  # noqa: F811
    """With the engine lock held, a /generate and its /cancel are both
    handed over before the engine's thread takes either: the request is
    cancelled while queued, whatever the timing."""
    srv, t, base = _start(checkpoint_dir, max_requests=1)
    row = {"request_id": 5, "prompt": "describe the image", "image": image_path,
           "max_new_tokens": 40}
    victim, cancel = [], []
    with srv.lock:
        a = threading.Thread(target=_post, args=(base, "/generate", row, victim), daemon=True)
        a.start()
        _until(lambda: srv.inbox.qsize() == 1)
        c = threading.Thread(target=_post, args=(base, "/cancel", {"request_id": 5}, cancel),
                             daemon=True)
        c.start()
        _until(lambda: srv.inbox.qsize() == 2)
        assert _get(base, "/healthz")["pending"] == 2
    a.join(WAIT)
    c.join(WAIT)
    assert cancel == [(200, {"request_id": 5, "cancelled": True})]
    assert victim == [(200, {"request_id": 5, "cancelled": True, "num_tokens": None})]
    assert _post(base, "/cancel", {"request_id": 5}) == (200, {"request_id": 5,
                                                               "cancelled": False})
    assert _get(base, "/healthz")["served"] == 0
    code, r = _post(base, "/generate", {"prompt": "hello world", "image": image_path,
                                        "max_new_tokens": 2})
    assert code == 200 and r["num_tokens"] == 2
    t.join(WAIT)
    assert not t.is_alive()


def test_http_bad_requests(checkpoint_dir, image_path):  # noqa: F811
    srv, t, base = _start(checkpoint_dir, "--grammar", "g=(this)+", max_requests=1)
    assert _post(base, "/generate", None, raw=b"{not json")[0] == 400
    assert _post(base, "/generate", {"image": image_path})[0] == 400  # no prompt
    assert _post(base, "/generate", {"prompt": "hi"})[0] == 400  # no image
    code, r = _post(base, "/generate", {"prompt": "hi", "image": image_path, "grammar": "nope"})
    assert code == 400 and "unknown grammar" in r["error"]
    assert _post(base, "/cancel", {"id": 3})[0] == 400
    assert _post(base, "/nowhere", {})[0] == 404
    with pytest.raises(urllib.error.HTTPError):
        _get(base, "/nowhere")
    code, r = _post(base, "/generate", {"prompt": "hi", "image": image_path, "grammar": "g",
                                        "max_new_tokens": 3})
    assert code == 200 and set(r["text"].replace(" ", "")) <= set("this")
    t.join(WAIT)
    assert not t.is_alive()


def test_lora_reads_a_save_pytree_directory(checkpoint_dir, image_path, tmp_path,  # noqa: F811
                                            capsys):
    """--lora NAME=DIR serves an adapter written by checkpoints/local.save_pytree:
    the CLI's texts equal the port engine's with the same bank."""
    from PIL import Image

    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.checkpoints.local import save_pytree
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.runtime.serving import Request, ServingEngine
    from paligemma_tpu_torch.train.lora import init_lora

    params, cfg = load_hf_model(checkpoint_dir, torch.float32, device="cpu")
    lora = init_lora(torch.Generator().manual_seed(3), cfg.text_config, rank=4)
    g = torch.Generator().manual_seed(4)
    for p in lora["layers"].values():
        p["b"] = torch.randn(p["b"].shape, generator=g) * 0.5
    save_pytree(str(tmp_path / "ad"), {"lora": lora})
    rows = [{"prompt": "describe the image", "max_new_tokens": 5, "lora": "x"},
            {"prompt": "describe the image", "max_new_tokens": 5}]
    t_serve.main(["--model_path", checkpoint_dir, "--requests_jsonl",
                  _jsonl(tmp_path, rows, image_path), "--lora", f"x={tmp_path / 'ad'}",
                  "--max_slots", "2", "--max_seq_len", "64", "--dtype", "float32",
                  "--only_cpu"])
    got = {r["request_id"]: r["text"] for r in _lines(capsys.readouterr().out)}

    tok = transformers.AutoTokenizer.from_pretrained(checkpoint_dir, padding_side="right")
    proc = PaliGemmaProcessor(tok, cfg.vision_config.num_image_tokens,
                              cfg.vision_config.image_size)
    inputs = proc(images=[Image.open(image_path)], text=["describe the image"])
    eng = ServingEngine(params, cfg, max_slots=2, max_seq_len=64, lora_bank={"x": lora})
    reqs = [Request(request_id=i, input_ids=inputs["input_ids"][0],
                    pixel_values=inputs["pixel_values"][0], max_new_tokens=5,
                    eos_token_id=tok.eos_token_id, lora=r.get("lora"))
            for i, r in enumerate(rows)]
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert got == {r.request_id: tok.decode(r.tokens, skip_special_tokens=True) for r in reqs}


def _exit2(argv, capsys, match):
    with pytest.raises(SystemExit) as ei:
        t_serve.main(argv)
    assert ei.value.code == 2
    err = capsys.readouterr().err
    reason = [ln for ln in err.splitlines() if ln.startswith("error: ")]
    assert len(reason) == 1 and match in reason[0], err
    return err


@pytest.mark.parametrize("flags,match", [
    ([], "--requests_jsonl"),
    (["--int8_prefill"], "--int8_prefill requires --quantize_int8"),
    (["--data_parallel", "2"], "--engine dense shards weights only"),
    (["--model_parallel", "2", "--data_parallel", "2"], "--engine dense shards weights only"),
    (["--grammar", "nameless"], "NAME=REGEX"),
    (["--grammar", "g=(ab"], "--grammar g"),
    (["--lora", "x"], "NAME=DIR"),
    (["--lora", "x=/nonexistent/adapter"], "not found"),
], ids=["no_mode", "int8_prefill", "data_parallel", "model_parallel",
        "grammar_form", "grammar_regex", "lora_form", "lora_missing"])
def test_friendly_errors(checkpoint_dir, tmp_path, capsys, flags, match):  # noqa: F811
    mode = [] if not flags else ["--requests_jsonl", "-"]
    _exit2(["--model_path", checkpoint_dir, "--only_cpu", *mode, *flags], capsys, match)


def test_request_errors_exit_2(checkpoint_dir, image_path, tmp_path, capsys):  # noqa: F811
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{not json}\n")
    base = ["--model_path", checkpoint_dir, "--only_cpu", "--dtype", "float32"]
    _exit2(base + ["--requests_jsonl", str(bad)], capsys, "bad JSON")
    reqs = _jsonl(tmp_path, [{"prompt": "hi", "grammar": "nope"}], image_path, "g.jsonl")
    _exit2(base + ["--requests_jsonl", reqs], capsys, "unknown grammar")
    reqs = _jsonl(tmp_path, [{"prompt": "hi", "lora": "nope"}], image_path, "l.jsonl")
    _exit2(base + ["--requests_jsonl", reqs], capsys, "unknown LoRA adapter")
    not_lora = tmp_path / "notlora"
    from paligemma_tpu_torch.checkpoints.local import save_pytree

    save_pytree(str(not_lora), {"params": torch.zeros(2)})
    _exit2(base + ["--requests_jsonl", reqs, "--lora", f"x={not_lora}"], capsys,
           "not a LoRA adapter checkpoint")


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_spec_decode_refuses_a_sampled_request(checkpoint_dir, image_path, tmp_path,  # noqa: F811
                                               capsys, engine):
    """--spec_decode is greedy-only, as the JAX CLI's: a sampled row exits 2."""
    reqs = _jsonl(tmp_path, [{"prompt": "hi", "do_sample": True}], image_path, "s.jsonl")
    _exit2(["--model_path", checkpoint_dir, "--only_cpu", "--dtype", "float32", "--engine",
            engine, "--page_size", "16", "--requests_jsonl", reqs, "--spec_decode"], capsys,
           "greedy-only")


def test_card_rule(checkpoint_dir, capsys, monkeypatch):  # noqa: F811
    """No card and no --only_cpu exits 2 (never a silent CPU run); --dtype
    float32 on a card passes the device check with every flag: dense or
    paged, with grammars, the prefix cache, spec_decode, --lora,
    --int8_prefill, --model_parallel > 1 and --data_parallel > 1 (each
    kernel on that path has an fp32 form)."""
    argv = ["--model_path", checkpoint_dir, "--requests_jsonl", "-"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _exit2(argv, capsys, "no CUDA device found; pass --only_cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fp32 = argv + ["--dtype", "float32", "--quantize_int8"]
    for extra in ([], ["--engine", "paged", "--prefix_cache", "--grammar", "g=a+"],
                  ["--spec_decode"], ["--lora", "x=/nowhere"], ["--int8_prefill"],
                  ["--model_parallel", "2"], ["--engine", "paged", "--data_parallel", "2"]):
        args = t_serve._build_parser().parse_args(fp32 + extra)
        assert t_serve._device(args) == torch.device("cuda", 0), extra
    assert "Loading" not in capsys.readouterr().err


def test_http_engine_failure_answers_500_and_stops(checkpoint_dir, image_path):  # noqa: F811
    """A round that raises answers the waiting /generate with a 500 and shuts
    the server down (no handler is left waiting on a dead engine thread)."""
    srv, t, base = _start(checkpoint_dir)

    def broken(*a, **kw):
        raise RuntimeError("injected engine fault")

    srv.engine.advance = broken
    code, r = _post(base, "/generate", {"prompt": "hi", "image": image_path,
                                        "max_new_tokens": 2})
    assert code == 500 and "engine failed" in r["error"]
    t.join(WAIT)
    assert not t.is_alive()


# ---- tensor parallel: --model_parallel 2 on two spawned gloo ranks ----
TP_ROWS = [
    {"request_id": 0, "prompt": "describe the image", "max_new_tokens": 5},
    {"prompt": "hello world", "max_new_tokens": 5, "lora": "x"},
    {"prompt": "describe the image", "max_new_tokens": 6, "grammar": "g"},
    {"prompt": "hello world", "max_new_tokens": 5, "lora": "x"},
    {"prompt": "describe the image", "max_new_tokens": 5},
]
TP_GRAMMAR = ["--prefix_cache", "--grammar", "g=(this|building|is|a| )+"]


@pytest.fixture(scope="module")
def mqa_lora_dir(mqa_checkpoint_dir, tmp_path_factory):  # noqa: F811
    """An adapter of the one-KV-head checkpoint with nonzero B, written by
    checkpoints/local.save_pytree."""
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.checkpoints.local import save_pytree
    from paligemma_tpu_torch.train.lora import init_lora

    _, cfg = load_hf_model(mqa_checkpoint_dir, torch.float32, device="cpu")
    lora = init_lora(torch.Generator().manual_seed(3), cfg.text_config, rank=4)
    g = torch.Generator().manual_seed(4)
    for p in lora["layers"].values():
        p["b"] = torch.randn(p["b"].shape, generator=g) * 0.5
    d = tmp_path_factory.mktemp("mqa_lora") / "x"
    save_pytree(str(d), {"lora": lora})
    return str(d)


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_batch_model_parallel_prints_the_one_rank_lines(mqa_checkpoint_dir, mqa_lora_dir,  # noqa: F811
                                                        image_path, tmp_path, capfd,
                                                        monkeypatch, engine):
    """dense: --lora --grammar --prefix_cache; paged: --grammar --prefix_cache
    --spec_decode with the requests on stdin (rank 0 reads them through the
    launcher). The m = 2 lines are the m = 1 lines; rank 0 alone prints."""
    rows = TP_ROWS if engine == "dense" else [{k: v for k, v in r.items() if k != "lora"}
                                              for r in TP_ROWS]
    extra = (["--lora", f"x={mqa_lora_dir}"] if engine == "dense"
             else ["--spec_decode", "--spec_draft_k", "3"])
    path = _jsonl(tmp_path, rows, image_path)
    base = ["--model_path", mqa_checkpoint_dir, "--engine", engine, "--max_slots", "2",
            "--max_seq_len", "64", "--page_size", "16", "--sync_every", "2", "--dtype",
            "float32", "--only_cpu", *TP_GRAMMAR, *extra]
    if engine == "paged":
        monkeypatch.setattr("sys.stdin", io.StringIO(open(path).read()))
        t_serve.main(base + ["--requests_jsonl", "-", "--model_parallel", "2"])
    else:
        t_serve.main(base + ["--requests_jsonl", path, "--model_parallel", "2"])
    cap = capfd.readouterr()
    got = _lines(cap.out)
    t_serve.main(base + ["--requests_jsonl", path])
    want = _lines(capfd.readouterr().out)
    keys = ("request_id", "text", "num_tokens")
    assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
    assert len(got) == len(rows)
    assert cap.err.count(f"served {len(rows)} requests") == 1
    assert "ranks: 2 over gloo, devices cpu, cpu" in cap.err


HTTP_TP_REQUESTS = 3  # /generate answers before the TP HTTP test's server shuts down


def _http_rank(argv, rank):
    """cli/ranks entry of the TP HTTP test: one rank of ``cli.serve
    --model_parallel`` in HTTP mode (cli/serve ``_serve``), with rank 0's
    server shut down after HTTP_TP_REQUESTS answers (then it hands the stop
    call to rank 1)."""
    args = t_serve._build_parser().parse_args(argv)
    srv = t_serve.build_server(args, rank=rank)
    if rank.lead:
        srv.serve_http(args.http, max_requests=HTTP_TP_REQUESTS)
    else:
        srv.follow()


def _launch_in_thread(entry, argv, timeout_s, data=1):
    """cli/ranks.launch of ``data`` x 2 CPU ranks in a thread: (thread,
    {"code": exit code})."""
    from paligemma_tpu_torch.cli import ranks

    out = {}

    def run():
        try:
            ranks.launch(entry, argv, 2, True, timeout_s, data_parallel=data)
            out["code"] = 0
        except SystemExit as e:
            out["code"] = e.code

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def test_http_model_parallel_round_trips_and_idles(mqa_checkpoint_dir, image_path):  # noqa: F811
    """Rank 0 runs the front end and hands each engine call to rank 1: a
    request, its stream (the same tokens), a cancel of a running stream;
    then an idle wait longer than the model group's collective timeout (the
    ranks wait on their control group, not a collective), a last request,
    and the shutdown after HTTP_TP_REQUESTS answers ends both ranks with
    exit code 0."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rank_timeout = 6
    t, out = _launch_in_thread(_http_rank, [
        "--model_path", mqa_checkpoint_dir, "--http", str(port), "--max_slots", "2",
        "--max_seq_len", "256", "--sync_every", "2", "--dtype", "float32", "--only_cpu",
        "--model_parallel", "2"], rank_timeout)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 3 * WAIT
    while True:  # the ranks load the checkpoint first
        try:
            assert _get(base, "/healthz")["ok"]
            break
        except (urllib.error.URLError, ConnectionError):
            assert t.is_alive() and time.monotonic() < deadline, out
            time.sleep(0.2)
    row = {"prompt": "describe the image", "image": image_path, "max_new_tokens": 4}
    code, r1 = _post(base, "/generate", row)
    assert code == 200 and r1["num_tokens"] == 4
    req = urllib.request.Request(base + "/generate", data=json.dumps({**row, "stream": True})
                                 .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        events = [json.loads(ln.decode()[len("data: "):]) for ln in resp
                  if ln.startswith(b"data: ")]
    assert events[-1]["done"] and events[-1]["text"] == r1["text"] and len(events) == 5
    long = {**row, "request_id": 50, "max_new_tokens": 200, "stream": True}
    req = urllib.request.Request(base + "/generate", data=json.dumps(long).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        assert resp.readline().startswith(b"data: {\"token\"")  # seated and decoding
        assert _post(base, "/cancel", {"request_id": 50}) == (
            200, {"request_id": 50, "cancelled": True})
        last = [ln for ln in resp if ln.startswith(b"data: ")][-1]
    assert json.loads(last.decode()[len("data: "):])["cancelled"]
    time.sleep(rank_timeout + 2)  # idle past the ranks' collective timeout
    code, r3 = _post(base, "/generate", row)
    assert code == 200 and r3["text"] == r1["text"]
    t.join(WAIT)
    assert not t.is_alive() and out["code"] == 0


# ---- data parallel: --data_parallel 2 (x --model_parallel 2), paged ----
@pytest.mark.parametrize("mesh", [["--data_parallel", "2"],
                                  ["--data_parallel", "2", "--model_parallel", "2"]],
                         ids=["data_parallel", "data_parallel_x_model_parallel"])
def test_batch_data_parallel_prints_the_one_rank_lines(mqa_checkpoint_dir, mqa_lora_dir,  # noqa: F811
                                                       image_path, tmp_path, capfd, mesh):
    """The paged engine over a data axis of 2 (alone, and beside a model
    axis of 2) with --lora --grammar --prefix_cache, 4 slots (2 a shard):
    the lines are the one-rank lines; rank 0 alone prints; a --max_slots
    that does not divide over the shards exits 2, as in the JAX CLI."""
    path = _jsonl(tmp_path, TP_ROWS, image_path)
    base = ["--model_path", mqa_checkpoint_dir, "--engine", "paged", "--max_slots", "4",
            "--max_seq_len", "64", "--page_size", "16", "--sync_every", "2", "--dtype",
            "float32", "--only_cpu", *TP_GRAMMAR, "--lora", f"x={mqa_lora_dir}",
            "--requests_jsonl", path]
    t_serve.main(base + mesh)
    cap = capfd.readouterr()
    got = _lines(cap.out)
    t_serve.main(base)
    want = _lines(capfd.readouterr().out)
    keys = ("request_id", "text", "num_tokens")
    assert [{k: r[k] for k in keys} for r in got] == [{k: r[k] for k in keys} for r in want]
    assert len(got) == len(TP_ROWS)
    assert cap.err.count(f"served {len(TP_ROWS)} requests") == 1
    assert "mesh data 2 x model" in cap.err
    with pytest.raises(SystemExit) as ei:
        t_serve.main(base[:base.index("--max_slots") + 1] + ["3"]
                     + base[base.index("--max_slots") + 2:] + mesh)
    assert ei.value.code == 2
    assert "--max_slots must divide evenly over --data_parallel shards" in capfd.readouterr().err


def test_http_data_parallel_x_model_parallel_round_trips(mqa_checkpoint_dir, image_path):  # noqa: F811
    """HTTP over 2 x 2 ranks (the paged engine, 4 slots): rank 0 answers a
    request and its stream with the same tokens, and a greedy request
    beside it on the other shard; the shutdown after HTTP_TP_REQUESTS
    answers ends every rank with exit code 0."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t, out = _launch_in_thread(_http_rank, [
        "--model_path", mqa_checkpoint_dir, "--http", str(port), "--engine", "paged",
        "--max_slots", "4", "--max_seq_len", "64", "--page_size", "16", "--sync_every", "2",
        "--dtype", "float32", "--only_cpu", "--data_parallel", "2", "--model_parallel", "2"],
        120, data=2)
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 3 * WAIT
    while True:  # the ranks load the checkpoint first
        try:
            assert _get(base, "/healthz")["ok"]
            break
        except (urllib.error.URLError, ConnectionError):
            assert t.is_alive() and time.monotonic() < deadline, out
            time.sleep(0.2)
    row = {"prompt": "describe the image", "image": image_path, "max_new_tokens": 4}
    code, r1 = _post(base, "/generate", row)
    assert code == 200 and r1["num_tokens"] == 4
    answers = {}

    def other():
        answers["other"] = _post(base, "/generate", {**row, "prompt": "hello world"})

    side = threading.Thread(target=other, daemon=True)
    side.start()
    req = urllib.request.Request(base + "/generate", data=json.dumps({**row, "stream": True})
                                 .encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as resp:
        events = [json.loads(ln.decode()[len("data: "):]) for ln in resp
                  if ln.startswith(b"data: ")]
    side.join(WAIT)
    assert events[-1]["done"] and events[-1]["text"] == r1["text"] and len(events) == 5
    assert answers["other"][0] == 200 and answers["other"][1]["num_tokens"] == 4
    t.join(WAIT)
    assert not t.is_alive() and out["code"] == 0
