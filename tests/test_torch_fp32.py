"""The fp32 forms of the port's kernels (``--dtype float32`` on the card), on
the CPU: the arithmetic of the GEMV tile's three-term split that grounds the
card's tolerance, the wrappers' dispatch and counters (the mixed cache
forms' too), the decode chain's support check at fp32, and the card's
(activations, cache) dtype pairs. The kernel
paths at fp32 against the JAX package run in tests/test_torch_kernels.py,
tests/test_torch_paged.py and tests/test_torch_engine.py (all fp32 on the
CPU); the kernels themselves in tests/test_torch_cuda.py on a card."""

import numpy as np
import pytest
import torch

from paligemma_tpu_torch import kernels
from paligemma_tpu_torch.cli import infer as t_infer
from paligemma_tpu_torch.kernels import decode_attention as t_dattn
from paligemma_tpu_torch.kernels import decode_elementwise as t_elem
from paligemma_tpu_torch.kernels import decode_head as t_head
from paligemma_tpu_torch.kernels import flash_attention as t_flash
from paligemma_tpu_torch.kernels import gemv_plan as t_plan
from paligemma_tpu_torch.kernels import int8_gemv as t_gemv
from paligemma_tpu_torch.kernels import lora as t_lora
from paligemma_tpu_torch.kernels import paged_attention as t_paged
from paligemma_tpu_torch.kernels import w8a8 as t_w8a8
from paligemma_tpu_torch.kernels.ablation import decode_attention as t_sda
from paligemma_tpu_torch.kernels.ablation import vision_attention as t_va
from paligemma_tpu_torch.runtime.engine import check_cache_dtype

torch.set_num_threads(2)

# the tolerance of the fp32 forms against their plain versions on the card,
# relative to the largest element (tests/test_torch_cuda.py FP32_REL,
# chip_smoke.py FP32_REL)
FP32_REL = 2e-5

FP32_FORMS = ("flash_attention_fwd_fp32", "int8_gemv_fp32", "int8_gemv_rope_kv_fp32",
              "head_argmax_fp32", "decode_attention_fp32", "paged_decode_attention_fp32",
              "rms_norm_fp32", "lora_shrink_fp32", "int8_gemv_f32_fp32",
              "int8_gemv_f32_lora_fp32", "w8a8_quant_rows_fp32", "w8a8_gemm_fp32",
              "flash_attention_bwd_dq_fp32", "flash_attention_bwd_dkv_fp32",
              "vision_attention_fp32", "seg_decode_attention_fp32")
# the mixed forms (a KV cache of the other dtype), counted apart as well
MIXED_FORMS = ("int8_gemv_rope_kv_cache_fp32", "int8_gemv_rope_kv_fp32_cache_bf16",
               "decode_attention_cache_fp32", "decode_attention_fp32_cache_bf16",
               "paged_decode_attention_cache_fp32", "paged_decode_attention_fp32_cache_bf16")


def _split3(x):
    """hi, mid, lo: the bf16 terms of fp32 x (csrc/gemv_tile.cuh gt_split3)."""
    hi = x.to(torch.bfloat16).float()
    mid = (x - hi).to(torch.bfloat16).float()
    lo = (x - hi - mid).to(torch.bfloat16).float()
    return hi, mid, lo


@pytest.mark.parametrize("k", [2048, 16384])
def test_three_term_split_holds_fp32(k):
    """The GEMV tile's fp32 form on seeded x and int8 W at Gemma-2B's K: the
    three bf16 terms add up to x exactly; the products of 16-row steps of
    each term against the exact bf16 weights, summed in fp32 step by step
    (the tile's order within a warp), stay within 2e-6 of the largest
    element of the exact product (fp32 x @ W itself: ~4e-7), while one bf16
    pass is ~1.6e-3 off. FP32_REL sits ten times above the first and fifty
    times below the last."""
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((8, k), dtype=np.float32)) * 3.0
    w = torch.from_numpy(rng.integers(-127, 128, (k, 256), dtype=np.int8)).float()
    s = torch.from_numpy((rng.random(256, dtype=np.float32) + 0.5) / (127 * k**0.5))
    hi, mid, lo = _split3(x)
    assert torch.equal(hi + mid + lo, x) and torch.equal((hi + mid) + lo, x)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).float(), t)
    exact = (x.double() @ w.double()) * s.double()
    acc = torch.zeros(8, 256)
    for k0 in range(0, k, 16):
        for t in (hi, mid, lo):
            acc = acc + t[:, k0:k0 + 16] @ w[k0:k0 + 16]
    top = float(exact.abs().max())
    split = float(((acc * s).double() - exact).abs().max()) / top
    one_pass = float(((hi @ w * s).double() - exact).abs().max()) / top
    assert split <= 2e-6 and split * 10 <= FP32_REL <= one_pass / 50, (split, one_pass)


def test_fp32_forms_are_counted_apart():
    """Each fp32 form and each mixed form has its own counter in WRAPPERS
    (no name ends in ``_f32``: ``int8_gemv_f32`` is mode 3's fp32 partial);
    on CPU tensors the wrappers run the plain versions and count nothing."""
    for name in FP32_FORMS + MIXED_FORMS:
        assert name in kernels.WRAPPERS and not name.endswith("_f32")
    assert all(kernels.WRAPPERS[n].__name__ == n for n in MIXED_FORMS)
    kernels.reset_launch_counts()
    x = torch.randn(2, 64)
    w8 = torch.randint(-127, 128, (64, 128), dtype=torch.int8)
    s = torch.rand(128) / 100
    torch.testing.assert_close(t_gemv.int8_gemv_fp32(x, w8, s),
                               t_gemv.int8_gemv_reference(x, w8, s))
    q = torch.randn(1, 8, 2, 16)
    pl = torch.tensor([8], dtype=torch.int32)
    out, lse = t_flash.flash_attention_fwd_fp32(q, q, q, pl, pl)
    torch.testing.assert_close(out, t_flash.reference_attention(q, q, q, pl, pl))
    torch.testing.assert_close(t_elem.rms_norm_fp32(x, torch.zeros(64)),
                               t_elem.rms_norm_reference(x, torch.zeros(64)))
    lse, delta = torch.zeros(1, 2, 8), torch.randn(1, 2, 8)
    bwd = (q, q, q, q, lse, delta, pl, pl, 0.25)
    torch.testing.assert_close(t_flash.flash_attention_bwd_dq_fp32(*bwd),
                               t_flash._reference_backward(*bwd, 0)[0])
    torch.testing.assert_close(t_flash.flash_attention_bwd_dkv_fp32(*bwd),
                               t_flash._reference_backward(*bwd, 0)[1:])
    qa, kc = torch.randn(2, 4, 16), torch.randn(2, 8, 16).to(torch.bfloat16)
    valid = torch.ones(2, 8, dtype=torch.bool)
    torch.testing.assert_close(t_dattn.decode_attention_fp32_cache_bf16(qa, kc, kc, valid, 0.25),
                               t_dattn.decode_attention_reference(qa, kc, kc, valid, 0.25))
    pool, table = kc.reshape(1, 16, 1, 16), torch.zeros(2, 1, dtype=torch.int32)
    lens = torch.tensor([3, 16], dtype=torch.int32)
    torch.testing.assert_close(
        t_paged.paged_decode_attention_cache_fp32(qa.bfloat16(), pool.float(), pool.float(),
                                                  table, lens),
        t_paged.reference_paged_decode_attention(qa.bfloat16(), pool.float(), pool.float(),
                                                 table, lens))
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("name", ["flash", "gemv", "rope", "head", "dense", "paged", "norm",
                                  "shrink", "f32", "k1", "quant", "gemm", "bwd_dq", "bwd_dkv",
                                  "vision", "seg"])
def test_fp32_form_wrappers_take_fp32_only(name):
    """A wrapper of an fp32 form refuses other dtypes (it never casts);
    K2's fp32 form takes int8 codes, not activations."""
    b16 = torch.zeros(2, 4, 16, dtype=torch.bfloat16)
    bwd = (b16[None],) * 6 + (None, None, 1.0)  # q, k, v, dout, lse, delta, lengths, scale
    calls = {
        "bwd_dq": lambda: t_flash.flash_attention_bwd_dq_fp32(*bwd),
        "bwd_dkv": lambda: t_flash.flash_attention_bwd_dkv_fp32(*bwd),
        "vision": lambda: t_va.vision_attention_fp32(b16[None], b16[None], b16[None]),
        "seg": lambda: t_sda.decode_attention_fp32(b16, b16[None], b16[None], None, None, None),
        "shrink": lambda: t_lora.lora_shrink_fp32(b16[0], None, None, 4, 8),
        "f32": lambda: t_gemv.int8_gemv_f32_fp32(b16[0], None, None),
        "k1": lambda: t_gemv.int8_gemv_f32_lora_fp32(b16[0], None, None, None),
        "quant": lambda: t_w8a8.w8a8_quant_rows_fp32(b16[0]),
        "gemm": lambda: t_w8a8.w8a8_gemm_fp32(b16[0].float(), None, None, None),
        "flash": lambda: t_flash.flash_attention_fwd_fp32(b16[None], b16[None], b16[None],
                                                          None, None),
        "gemv": lambda: t_gemv.int8_gemv_fp32(b16[0], None, None),
        "rope": lambda: t_gemv.int8_gemv_rope_kv_fp32(b16[0]),
        "head": lambda: t_head.head_argmax_fp32(b16, {}),
        "dense": lambda: t_dattn.decode_attention_fp32(b16, b16, b16, None, 1.0),
        "paged": lambda: t_paged.paged_decode_attention_fp32(b16, b16, b16, None, None),
        "norm": lambda: t_elem.rms_norm_fp32(b16[0], None),
    }
    with pytest.raises(ValueError, match="fp32"):
        calls[name]()


def test_norm_prologue_fits_at_fp32():
    """The fp32 prologue stages nothing: any plan with K % 4 == 0 fits,
    where the bf16 staging buffer can refuse a plan's K range."""
    wide = t_plan.GemvPlan.make(16384, 65536)
    assert not t_plan.norm_fits(wide) and t_plan.norm_fits(wide, fp32=True)
    for k, n in ((2048, 2560), (2048, 32768)):
        plan = t_plan.GemvPlan.make(k, n)
        assert t_plan.norm_fits(plan) and t_plan.norm_fits(plan, fp32=True)
    assert not t_plan.norm_fits(t_plan.GemvPlan.make(18, 64), fp32=True)


def test_mixed_cache_dtype_raises_on_the_card_only():
    """The card takes the four (activations, cache) pairs of bf16 and fp32,
    the mixed ones through the kernels' mixed forms; a cache of any other
    dtype (fp16) raises for a CUDA device, with a message naming the four
    pairs, and the CPU's plain path takes it."""
    for act in (torch.bfloat16, torch.float32):
        params = {"lm": {"embed": torch.zeros(2, 2, dtype=act)}}
        for cache in (torch.bfloat16, torch.float32):
            check_cache_dtype(torch.device("cuda"), params, cache, "engine")
        with pytest.raises(ValueError, match=r"\(torch.float32, torch.bfloat16\)"):
            check_cache_dtype(torch.device("cuda"), params, torch.float16, "engine")
        check_cache_dtype(torch.device("cpu"), params, torch.float16, "engine")


@pytest.mark.parametrize("flag", ["lora", "int8_prefill", "model_parallel", "data_parallel"])
def test_fp32_flags_pass_the_device_check(flag, monkeypatch):
    """Each flag that once had no fp32 form passes both CLIs' device checks at
    fp32 on a card (monkeypatched), and ``--only_cpu`` still takes the CPU."""
    from paligemma_tpu_torch.cli import serve as t_serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    extra = {"lora": ["--quantize_int8", "--lora", "x=/nowhere"],
             "int8_prefill": ["--quantize_int8", "--int8_prefill"],
             "model_parallel": ["--model_parallel", "2"],
             "data_parallel": ["--engine", "paged", "--data_parallel", "2"]}[flag]
    serve_args = t_serve._build_parser().parse_args(
        ["--model_path", "m", "--requests_jsonl", "-", "--dtype", "float32", *extra])
    assert t_serve._device(serve_args) == torch.device("cuda", 0)
    if flag != "lora":  # cli.infer has no --lora
        infer_extra = [a for a in extra if a not in ("--engine", "paged")]
        args = t_infer.parse_args(["--model_path", "m", "--prompt", "a", "--prompt", "b",
                                   "--image_file_path", "i.png", "--image_file_path", "j.png",
                                   "--dtype", "float32", *infer_extra])
        assert t_infer._device(args) == torch.device("cuda", 0)
        args.only_cpu = True
        assert t_infer._device(args).type == "cpu"
    serve_args.only_cpu = True
    assert t_serve._device(serve_args).type == "cpu"
