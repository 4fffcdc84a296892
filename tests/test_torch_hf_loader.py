"""The port's safetensors reader / writer, HF loader and export (CPU).

* the reader against ``safetensors.torch.load_file`` (every dtype the port
  reads, 0-d and empty tensors, two shard files), the writer read back by
  ``safe_open``;
* ``params_from_state_dict``, ``load_hf_model(device="cpu")`` and
  ``state_dict_from_params`` against the JAX package's, exactly, on a tiny
  ``transformers`` PaliGemma (the classic file layout and the nested
  layout of transformers >= 4.52's ``state_dict()``);
* export -> load is the identity;
* golden against transformers, an oracle independent of JAX: prefill
  logits within rtol 1e-3 / atol 2e-4 and 12 greedy tokens equal, and an
  exported directory loads back into transformers with the same logits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")
from safetensors import safe_open

from paligemma_tpu.checkpoints import hf_export as j_export
from paligemma_tpu.checkpoints import hf_loader as j_loader
from paligemma_tpu.core.config import PaliGemmaConfig as JaxConfig
from paligemma_tpu_torch.checkpoints import hf_export as t_export
from paligemma_tpu_torch.checkpoints import hf_loader as t_loader
from paligemma_tpu_torch.checkpoints import safetensors as t_st
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.core.config import PaliGemmaConfig
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

torch.set_num_threads(2)

VOCAB = 128
IMG_TOK = 120
BOS, EOS, PAD = 2, 1, 0

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
          torch.int8, torch.uint8, torch.bool]


def _tensors(dtype, seed=0):
    """A 2-D, a 0-d and an empty tensor of ``dtype``."""
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        full, scalar = torch.randn(5, 7, generator=g).to(dtype), torch.tensor(-2.75).to(dtype)
    elif dtype == torch.bool:
        full, scalar = torch.rand(5, 7, generator=g) < 0.5, torch.tensor(True)
    else:
        lo, hi = (0, 256) if dtype == torch.uint8 else (-100, 100)
        full = torch.randint(lo, hi, (5, 7), generator=g).to(dtype)
        scalar = torch.tensor(7).to(dtype)
    return {"full": full, "scalar": scalar, "empty": torch.zeros(0, 3, dtype=dtype),
            "odd": full[:, :3].contiguous()}


def _assert_same(got, want, where=""):
    assert set(got) == set(want), (where, set(got) ^ set(want))
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, (where, k)
        assert torch.equal(got[k], want[k]), (where, k)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_reader_matches_library(tmp_path, dtype):
    path = str(tmp_path / "a.safetensors")
    safetensors_torch.save_file(_tensors(dtype), path)
    _assert_same(t_st.load_file(path), safetensors_torch.load_file(path))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_writer_read_back_by_library(tmp_path, dtype):
    path = str(tmp_path / "a.safetensors")
    ts = _tensors(dtype, seed=1)
    n = t_st.save_file(ts, path, metadata={"format": "pt"})
    assert n == os.path.getsize(path)
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        _assert_same({k: f.get_tensor(k) for k in f.keys()}, ts)
    with open(path, "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0


def test_reader_over_two_shards(tmp_path):
    a, b = _tensors(torch.float32, 2), _tensors(torch.bfloat16, 3)
    safetensors_torch.save_file({f"a.{k}": v for k, v in a.items()},
                                str(tmp_path / "model-00001-of-00002.safetensors"))
    safetensors_torch.save_file({f"b.{k}": v for k, v in b.items()},
                                str(tmp_path / "model-00002-of-00002.safetensors"))
    sd = t_loader.load_state_dict_from_safetensors(str(tmp_path))
    want = {**{f"a.{k}": v for k, v in a.items()}, **{f"b.{k}": v for k, v in b.items()}}
    _assert_same(dict(sd), want)
    sd.close()
    with pytest.raises(FileNotFoundError):
        t_loader.load_state_dict_from_safetensors(str(tmp_path / "nothing"))


def _hf_config():
    return transformers.PaliGemmaConfig(
        vision_config=dict(
            image_size=28, patch_size=14, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4, projection_dim=48,
            vision_use_head=False,
        ),
        text_config=dict(
            vocab_size=VOCAB, hidden_size=48, intermediate_size=96,
            num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, model_type="gemma", bos_token_id=BOS, eos_token_id=EOS,
            pad_token_id=PAD,
        ),
        projection_dim=48, image_token_index=IMG_TOK, pad_token_id=PAD,
        vocab_size=VOCAB,
    )


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    return transformers.PaliGemmaForConditionalGeneration(_hf_config()).eval().float()


@pytest.fixture(scope="module")
def ckpt(hf_model, tmp_path_factory):
    """Two checkpoint directories: the classic layout (save_pretrained)
    and the nested layout of ``state_dict()``, written with the port's
    writer; the same config.json."""
    classic = tmp_path_factory.mktemp("classic")
    hf_model.save_pretrained(str(classic), safe_serialization=True)
    nested = tmp_path_factory.mktemp("nested")
    sd = hf_model.state_dict()
    assert any(k.startswith("model.language_model.") for k in sd)
    t_st.save_file({k: v.contiguous() for k, v in sd.items()},
                   str(nested / "model.safetensors"))
    with open(classic / "config.json") as f, open(nested / "config.json", "w") as g:
        g.write(f.read())
    return {"classic": str(classic), "nested": str(nested)}


def _jax_to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    assert torch.equal(got, want), where


def test_params_from_state_dict_matches_jax(hf_model, ckpt):
    cfg = PaliGemmaConfig.from_hf_json(ckpt["classic"])
    sd = hf_model.state_dict()
    want = _jax_to_port(j_loader.params_from_state_dict(
        JaxConfig.from_hf_json(ckpt["classic"]), sd, jnp.float32))
    got = t_loader.params_from_state_dict(cfg, sd)
    _assert_tree_equal(got, want)
    # numpy values, and the tree owns its memory
    np_sd = {k: v.numpy() for k, v in sd.items()}
    got_np = t_loader.params_from_state_dict(cfg, np_sd)
    _assert_tree_equal(got_np, want)
    got_np["lm"]["embed"].add_(1.0)
    got_np["vision"]["pos_embed"].add_(1.0)
    _assert_tree_equal(t_loader.params_from_state_dict(cfg, np_sd), want)
    assert t_loader.normalize_key("model.language_model.layers.0.x") == "language_model.layers.0.x"
    assert t_loader.normalize_key("language_model.model.norm.weight") == "language_model.norm.weight"


@pytest.mark.parametrize("layout", ["classic", "nested"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_model_cpu_matches_jax(ckpt, layout, dtype):
    want, want_cfg = j_loader.load_hf_model(ckpt[layout], getattr(jnp, dtype))
    got, cfg = t_loader.load_hf_model(ckpt[layout], getattr(torch, dtype), device="cpu")
    _assert_tree_equal(got, _jax_to_port(want))
    assert cfg == PaliGemmaConfig.from_hf_json(ckpt["classic"])
    assert cfg.text_config.num_hidden_layers == want_cfg.text_config.num_hidden_layers == 3


def test_load_hf_model_needs_the_card_unless_asked(ckpt):
    """device=None is the card: with none it raises, it never loads to
    the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this box has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_loader.load_hf_model(ckpt["classic"])


def test_state_dict_from_params_matches_jax(ckpt):
    jp, jcfg = j_loader.load_hf_model(ckpt["classic"], jnp.float32)
    tp, cfg = t_loader.load_hf_model(ckpt["classic"], torch.float32, device="cpu")
    want = j_export.state_dict_from_params(jcfg, jp)
    got = t_export.state_dict_from_params(cfg, tp)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the state dict owns its memory
    got["language_model.model.norm.weight"].add_(1.0)
    assert torch.equal(tp["lm"]["final_norm"],
                       t_export.state_dict_from_params(cfg, tp)["language_model.model.norm.weight"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_then_load_is_identity(ckpt, tmp_path, dtype):
    params, cfg = t_loader.load_hf_model(ckpt["classic"], getattr(torch, dtype), device="cpu")
    out = str(tmp_path / "export")
    n = t_export.export_hf_checkpoint(cfg, params, out)
    assert n == os.path.getsize(os.path.join(out, "model.safetensors"))
    # fp32 on disk whatever the tree's dtype, as the JAX package writes it
    with safe_open(os.path.join(out, "model.safetensors"), framework="pt") as f:
        assert {f.get_slice(k).get_dtype() for k in f.keys()} == {"F32"}
    again, cfg2 = t_loader.load_hf_model(out, getattr(torch, dtype), device="cpu")
    assert cfg2 == cfg
    _assert_tree_equal(again, params)
    # the bf16 file (half the bytes) loads back to the same bf16 tree
    out16 = str(tmp_path / "export16")
    n16 = t_export.export_hf_checkpoint(cfg, params, out16, dtype=torch.bfloat16)
    assert n16 < n
    bf, _ = t_loader.load_hf_model(out16, torch.bfloat16, device="cpu")
    ref, _ = t_loader.load_hf_model(out, torch.bfloat16, device="cpu")
    _assert_tree_equal(bf, ref)


def test_jax_export_loads_in_port(ckpt, tmp_path):
    """A directory the JAX package exported loads in the port to the tree
    the port's own export of the same params gives."""
    jp, jcfg = j_loader.load_hf_model(ckpt["classic"], jnp.float32)
    out = str(tmp_path / "jax_export")
    j_export.export_hf_checkpoint(jcfg, jp, out)
    got, _ = t_loader.load_hf_model(out, torch.float32, device="cpu")
    _assert_tree_equal(got, _jax_to_port(jp))


def _inputs(batch=1, extra_ids=(BOS, 17, 23, 42, 9)):
    n_img = 4  # (28/14)^2
    rng = np.random.default_rng(42)
    ids = np.concatenate(
        [np.full((batch, n_img), IMG_TOK), np.tile(extra_ids, (batch, 1))], axis=1
    ).astype(np.int64)
    return ids, np.ones_like(ids), rng.normal(size=(batch, 3, 28, 28)).astype(np.float32)


@pytest.fixture(scope="module")
def port_engine(ckpt):
    params, cfg = t_loader.load_hf_model(ckpt["classic"], torch.float32, device="cpu")
    return PaliGemmaEngine(params, cfg, max_seq_len=64, eos_token_id=EOS), params, cfg


def test_golden_prefill_logits_vs_transformers(hf_model, port_engine):
    engine, _, _ = port_engine
    ids, mask, pixels = _inputs()
    with torch.no_grad():
        hf = hf_model(input_ids=torch.tensor(ids), pixel_values=torch.tensor(pixels),
                      attention_mask=torch.tensor(mask)).logits.numpy()
    logits, _ = engine.prefill(pixels, ids, mask)
    np.testing.assert_allclose(logits[0].numpy(), hf[0, -1], rtol=1e-3, atol=2e-4)


def test_golden_greedy_tokens_vs_transformers(hf_model, port_engine):
    engine, _, _ = port_engine
    ids, mask, pixels = _inputs()
    with torch.no_grad():
        hf = hf_model.generate(input_ids=torch.tensor(ids), pixel_values=torch.tensor(pixels),
                               attention_mask=torch.tensor(mask), max_new_tokens=12,
                               do_sample=False, eos_token_id=None)
    ours = engine.generate(pixels, ids, mask, max_new_tokens=12, eos_token_id=-1)
    np.testing.assert_array_equal(ours[0], hf[0, ids.shape[1]:].numpy())


def test_export_loads_in_transformers_with_same_logits(hf_model, port_engine, tmp_path):
    _, params, cfg = port_engine
    out = str(tmp_path / "export_hf")
    t_export.export_hf_checkpoint(cfg, params, out)
    again = transformers.PaliGemmaForConditionalGeneration.from_pretrained(
        out, dtype=torch.float32).eval()
    ids, mask, pixels = _inputs()
    kw = dict(input_ids=torch.tensor(ids), pixel_values=torch.tensor(pixels),
              attention_mask=torch.tensor(mask))
    with torch.no_grad():
        torch.testing.assert_close(again(**kw).logits, hf_model(**kw).logits, rtol=0, atol=0)
