"""The port's training slice against the JAX package on the CPU: the flash
backward (plain FA2 version) against the Pallas backward in interpret mode,
the loss, the training mask, forward_train, LoRA gradients, the Trainer over
three steps, merge_lora on quantized bases, 4-bit quantization and local
checkpoints. Inputs are made with numpy from a seed; fp32 throughout.

Tolerances: fp32 math that sums in another order than XLA agrees to about
1e-6 relative per op; through two layers, the loss and the softmax, logits
and gradients agree to 2e-5 relative to their largest element, losses to
1e-5. Trained parameters agree to 1e-5 relative plus 1 % of one Adam step
(the learning rate) per update: Adam divides a gradient by its own size
plus eps = 1e-8, so a gradient of ~1e-7 (1e-6 of the largest), whose last
digits differ between the two frameworks, moves its parameter by a
visibly different fraction of the step (measured: 0.3 % of it)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paligemma_tpu.core import config as j_config
from paligemma_tpu.kernels import flash_attention as j_flash
from paligemma_tpu.kernels import quant as j_quant
from paligemma_tpu.models import paligemma as j_pg
from paligemma_tpu.runtime import quantize as j_rq
from paligemma_tpu.train import lora as j_lora
from paligemma_tpu.train import trainer as j_trainer
from paligemma_tpu.train.losses import causal_lm_loss as j_loss
from paligemma_tpu_torch.core import config as t_config
from paligemma_tpu_torch.convert import params_from_numpy
from paligemma_tpu_torch.kernels import flash_attention as t_flash
from paligemma_tpu_torch.kernels import quant as t_quant
from paligemma_tpu_torch.models import paligemma as t_pg
from paligemma_tpu_torch.runtime import quantize as t_rq
from paligemma_tpu_torch.train import lora as t_lora
from paligemma_tpu_torch.train.losses import causal_lm_loss as t_loss
from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

torch.set_num_threads(2)

CFG = j_config.tiny_test_config()
T_CFG = t_config.tiny_test_config()
REL = 2e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-12))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return params_from_numpy(_np(tree), "cpu")


def _batch(b=2, seed=0, pad=0):
    """Processor-shaped batch: image tokens + 2 prompt tokens as the prefix,
    4 suffix tokens as labels; ``pad`` masks the last tokens of row 1."""
    rng = np.random.default_rng(seed)
    n_img, s_txt = CFG.vision_config.num_patches, 6
    ids = np.concatenate([np.full((b, n_img), CFG.image_token_index),
                          rng.integers(3, 100, (b, s_txt))], 1).astype(np.int32)
    ttype = np.concatenate([np.zeros((b, n_img + 2)), np.ones((b, s_txt - 2))], 1).astype(np.int32)
    mask = np.ones_like(ids)
    if pad:
        mask[-1, -pad:] = 0
        ids[-1, -pad:] = CFG.pad_token_id
    labels = np.where((ttype == 1) & (mask == 1), ids, -100).astype(np.int32)
    return {"pixel_values": rng.normal(size=(b, 3, 28, 28)).astype(np.float32),
            "input_ids": ids, "attention_mask": mask, "token_type_ids": ttype, "labels": labels}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _lora(seed=1, rank=4, b_scale=0.1):
    """JAX adapters with a random (nonzero) B, so every target's delta and
    both A and B gradients are live."""
    lo = j_lora.init_lora(jax.random.PRNGKey(seed), CFG.text_config, rank=rank)
    rng = np.random.default_rng(seed)
    for p in lo["layers"].values():
        p["b"] = jnp.asarray(rng.normal(size=p["b"].shape).astype(np.float32) * b_scale)
    return lo


# ------------------------------------------------------------------ config ----
@pytest.mark.parametrize("factory", ["paligemma_3b_224", "paligemma_3b_448",
                                     "paligemma_3b_896", "tiny_test_config"])
def test_config_is_own_copy_equal_to_jax(factory):
    """Every factory's config equals the JAX package's field by field, and
    the port's dataclasses are its own, not the JAX package's."""
    got, want = getattr(t_config, factory)(), getattr(j_config, factory)()
    assert type(got) is not type(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    hf = {"vision_config": {"hidden_size": 48, "patch_size": 7},
          "text_config": {"max_position_encodings": 512, "num_hidden_layers": 3},
          "projection_dim": 48, "pad_token_id": None}
    assert (dataclasses.asdict(t_config.PaliGemmaConfig.from_hf_dict(hf))
            == dataclasses.asdict(j_config.PaliGemmaConfig.from_hf_dict(hf)))


# ------------------------------------------------------------ flash bwd ----
@pytest.mark.parametrize(
    "b,s,hq,hkv,d,case",
    [
        (2, 40, 4, 1, 32, "prefix"),  # prefix-LM, MQA, ragged kv_len
        (1, 33, 2, 2, 16, "causal"),  # pure causal, MHA
        (2, 24, 4, 2, 72, "prefix"),  # GQA, SigLIP's head_dim 72
        (2, 20, 4, 1, 16, "empty"),  # row 1 has kv_len 0
    ],
)
def test_flash_forward_backward_matches_pallas(b, s, hq, hkv, d, case):
    """out, lse and dq/dk/dv of the port's flash attention (its plain
    version on the CPU) against the Pallas kernels in interpret mode under
    jax.vjp, fp32. dO is 0 on rows with no visible key: there the TPU
    kernel's forward gives the mean of V and a nonzero lse (its finite
    NEG_INF), the port 0 and 0 (checked separately)."""
    rng = np.random.default_rng(s + d)
    q = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    kv_len = np.array([s - 5 * i for i in range(b)], np.int32)
    prefix = {"prefix": kv_len - 9, "causal": np.zeros(b), "empty": kv_len - 4}[case]
    prefix = prefix.astype(np.int32)
    if case == "empty":
        kv_len[1] = 0
    dout = rng.normal(size=q.shape).astype(np.float32)
    seen = np.asarray(t_flash._allowed(s, s, torch.from_numpy(prefix),
                                       torch.from_numpy(kv_len), 0, "cpu")).any(-1)  # (B, S)
    dout *= seen[:, :, None, None]

    def fwd(q_, k_, v_):
        return j_flash.flash_attention(q_, k_, v_, jnp.asarray(prefix), jnp.asarray(kv_len),
                                       interpret=True)

    want, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    w_dq, w_dk, w_dv = vjp(jnp.asarray(dout))
    _, w_lse = j_flash._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(prefix), jnp.asarray(kv_len), d**-0.5, 0,
                                      *j_flash._auto_blocks(s, hq, hkv, s, None, None), True,
                                      return_lse=True)
    sq_p = -(-s // 128) * 128
    w_lse = np.asarray(w_lse)[:, :, : (hq // hkv) * sq_p, 0].reshape(b, hkv, hq // hkv, sq_p)
    w_lse = w_lse[..., :s].reshape(b, hq, s)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    tp, tl = torch.from_numpy(prefix), torch.from_numpy(kv_len)
    out = t_flash.flash_attention(tq, tk, tv, tp, tl)
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    _, lse = t_flash.flash_attention_with_lse(tq.detach(), tk.detach(), tv.detach(), tp, tl)

    live = seen[:, :, None]  # (B, S, 1): rows with a visible key
    assert _rel(out.detach().numpy() * live[..., None], np.asarray(want) * live[..., None]) < REL
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[seen],
                               w_lse.transpose(0, 2, 1)[seen], rtol=1e-5, atol=1e-5)
    for got, ref in ((dq, w_dq), (dk, w_dk), (dv, w_dv)):
        assert _rel(got, ref) < REL
    # rows without a visible key: out 0, lse 0, and they add nothing
    assert not out.detach().numpy()[~seen].any() and not lse.numpy().transpose(0, 2, 1)[~seen].any()


@pytest.mark.parametrize(
    "b,s,hq,hkv,d",
    [
        (2, 130, 8, 1, 256),  # Gemma's heads, a padded 128-row tile, prefix-LM
        (2, 40, 4, 2, 72),  # GQA, SigLIP's head_dim 72
    ],
)
def test_flash_backward_bf16_matches_pallas(b, s, hq, hkv, d):
    """dq/dk/dv of the port's flash attention (plain version on the CPU) at
    bf16 inputs against the Pallas backward in interpret mode under
    jax.vjp. Both round p and ds to bf16 before their products; they differ
    by the forward's bf16 out (delta) and the order of fp32 sums: within
    1e-2 of the largest element (at most 4.2e-3 measured)."""
    rng = np.random.default_rng(s + d)
    q, k, v, dout = (rng.normal(size=shape).astype(np.float32)
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    kv_len = np.array([s - 5 * i for i in range(b)], np.int32)
    prefix = (kv_len - 9).astype(np.int32)
    seen = np.asarray(t_flash._allowed(s, s, torch.from_numpy(prefix),
                                       torch.from_numpy(kv_len), 0, "cpu")).any(-1)
    dout *= seen[:, :, None, None]
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, dout))

    def fwd(q_, k_, v_):
        return j_flash.flash_attention(q_, k_, v_, jnp.asarray(prefix), jnp.asarray(kv_len),
                                       interpret=True)

    _, vjp = jax.vjp(fwd, jq, jk, jv)
    want = vjp(jdo)

    def bf16(x):  # the same bf16 values on the torch side
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)

    tq, tk, tv = (bf16(x).requires_grad_(True) for x in (jq, jk, jv))
    out = t_flash.flash_attention(tq, tk, tv, torch.from_numpy(prefix), torch.from_numpy(kv_len))
    got = torch.autograd.grad(out, (tq, tk, tv), bf16(jdo))
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.bfloat16
        err = _rel(g_.float().numpy(), np.asarray(w_.astype(jnp.float32)))
        assert err < 1e-2, (name, err)


def test_flash_backward_wrappers_on_cpu_are_the_plain_version():
    """The dq and dk/dv wrappers take their plain version for CPU tensors,
    given the same lse and delta as flash_attention_backward."""
    rng = np.random.default_rng(3)
    q, dout = (torch.from_numpy(rng.normal(size=(2, 9, 4, 16)).astype(np.float32)) for _ in "ab")
    k, v = (torch.from_numpy(rng.normal(size=(2, 9, 1, 16)).astype(np.float32)) for _ in "ab")
    pl, kl = torch.tensor([4, 2], dtype=torch.int32), torch.tensor([9, 6], dtype=torch.int32)
    launched = (t_flash.flash_attention_bwd_dq.launches, t_flash.flash_attention_bwd_dkv.launches)
    out, lse = t_flash.flash_attention_with_lse(q, k, v, pl, kl)
    dq, dk, dv = t_flash.flash_attention_backward(q, k, v, out, lse, dout, pl, kl)
    delta = t_flash._delta(out, dout)
    assert torch.equal(t_flash.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, 0.25), dq)
    got_dk, got_dv = t_flash.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, 0.25)
    assert torch.equal(got_dk, dk) and torch.equal(got_dv, dv)
    assert (t_flash.flash_attention_bwd_dq.launches,
            t_flash.flash_attention_bwd_dkv.launches) == launched  # no kernel on the CPU
    assert t_flash.dkv_splits(2, 1, 8 * 512, 512) == 8  # 16 key blocks -> 128 blocks


# -------------------------------------------------------- loss and mask ----
def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (2, 7)).astype(np.int32)
    labels[:, :3] = -100
    got = t_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(j_loss(jnp.asarray(logits), jnp.asarray(labels))),
                               rtol=1e-6)
    none = np.full_like(labels, -100)  # no valid target: denominator 1, loss 0
    assert float(t_loss(torch.from_numpy(logits), torch.from_numpy(none))) == 0.0


def test_train_attention_mask_matches_jax():
    mask = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], np.int32)
    ttype = np.array([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], np.int32)
    got = t_pg.train_attention_mask(torch.from_numpy(mask), torch.from_numpy(ttype))
    want = j_pg.train_attention_mask(jnp.asarray(mask), jnp.asarray(ttype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------- forward and gradients ----
@pytest.fixture(scope="module")
def weights():
    jp = j_pg.init_params(jax.random.PRNGKey(0), CFG)
    return jp, _t(jp)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_matches_jax(weights, use_flash, remat):
    """Logits of the port's forward_train (plain mask or flash lengths,
    remat on or off) against JAX's plain forward_train, LoRA on, one row
    padded."""
    jp, tp = weights
    lo = _lora()
    batch = _batch(pad=2)
    jb = _jbatch(batch)
    want = j_pg.forward_train(jp, CFG, jb["pixel_values"], jb["input_ids"], jb["attention_mask"],
                              jb["token_type_ids"], lora=lo, remat=False)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = t_pg.forward_train(tp, T_CFG, tb["pixel_values"], tb["input_ids"],
                             tb["attention_mask"], tb["token_type_ids"], lora=_t(lo),
                             remat=remat, use_flash=use_flash)
    real = batch["attention_mask"].astype(bool)  # padded rows are don't-care
    assert _rel(got.detach().numpy()[real], np.asarray(want)[real]) < REL


@pytest.mark.parametrize("base", ["dense", "int8", "nf4"])
@pytest.mark.parametrize("use_flash", [False, True])
def test_lora_gradients_match_jax(weights, base, use_flash):
    """d loss / d adapters (a, b and alpha of every target) against
    jax.grad, over a dense, an int8 (unfused) and an NF4 (fused) base."""
    jp, _ = weights
    if base == "int8":
        jp = j_rq.quantize_lm_for_serving(jp, fuse=False)
    elif base == "nf4":
        jp = j_rq.quantize_lm_for_training(jp, kind="nf4", group=64, fuse=True)
    tp = _t(jp)
    lo = _lora()
    batch = _batch(pad=1, seed=4)
    jb = _jbatch(batch)

    def loss(lora):
        logits = j_pg.forward_train(jp, CFG, jb["pixel_values"], jb["input_ids"],
                                    jb["attention_mask"], jb["token_type_ids"], lora=lora)
        return j_loss(logits, jb["labels"])

    want_loss, want = jax.value_and_grad(loss)(lo)
    tr = Trainer(tp, T_CFG, TrainConfig(lora_rank=4, use_flash=use_flash), lora=_t(lo))
    got_loss, grads = tr.loss_and_grads(batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    flat_want = [want["layers"][name][x] for name, p in tr.lora["layers"].items() for x in p]
    assert len(grads) == len(flat_want)
    for got, ref in zip(grads, flat_want):
        assert _rel(got, ref) < 1e-4  # d alpha: a sum over every product


# ---------------------------------------------------------------- Trainer ----
def _assert_trees_close(got, want, atol):
    for path, w in jax.tree_util.tree_leaves_with_path(_np(want)):
        g = got
        for key in path:
            g = g[key.key]
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_trainer_lora_accum_warmup_matches_jax(weights):
    """Three LoRA steps with grad_accum_steps=2 and warmup_steps=2: the
    losses and the adapters after each step equal JAX's Trainer; the
    adapters move on step 2 only (accumulation), and with lr 0 on the first
    update under warmup they stay put until the update after that."""
    jp, tp = weights
    tc = dict(lora_rank=4, learning_rate=5e-3, grad_accum_steps=2, warmup_steps=2)
    jt = j_trainer.Trainer(jp, CFG, j_trainer.TrainConfig(**tc), rng=jax.random.PRNGKey(1))
    tt = Trainer(tp, T_CFG, TrainConfig(**tc), lora=_t(jt.lora))
    start = {k: v["b"].clone() for k, v in tt.lora["layers"].items()}
    for step, seed in enumerate((0, 1, 2)):
        batch = _batch(seed=seed, pad=1)
        want = jt.train_step(_jbatch(batch))
        got = tt.train_step(batch)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        _assert_trees_close(tt.lora, jt.lora, 0.0)
        same = all(torch.equal(tt.lora["layers"][k]["b"], start[k]) for k in start)
        assert same  # step 0: accumulating; step 1: lr(0) = 0; step 2: accumulating
    batch = _batch(seed=3)
    np.testing.assert_allclose(tt.train_step(batch), jt.train_step(_jbatch(batch)), rtol=1e-5)
    _assert_trees_close(tt.lora, jt.lora, 0.01 * tc["learning_rate"])
    assert not torch.equal(tt.lora["layers"]["q"]["b"], start["q"])


def test_trainer_full_ft_matches_jax(weights):
    """Three full fine-tune steps (vision frozen): losses, the LM weights
    against JAX's Trainer, the vision tower untouched, the caller's params
    unchanged."""
    jp, tp = weights
    tc = dict(lora_rank=None, learning_rate=1e-3)
    jt = j_trainer.Trainer(jp, CFG, j_trainer.TrainConfig(**tc))
    tt = Trainer(tp, T_CFG, TrainConfig(**tc))
    before = tp["lm"]["layers"]["attn"]["q"].clone()
    for seed in range(3):
        batch = _batch(seed=seed)
        np.testing.assert_allclose(tt.train_step(batch), jt.train_step(_jbatch(batch)), rtol=1e-5)
    _assert_trees_close(tt.params["lm"], jt.params["lm"], 3 * 0.01 * tc["learning_rate"])
    assert torch.equal(tp["lm"]["layers"]["attn"]["q"], before)
    assert tt.params["vision"] is tp["vision"]
    assert not torch.equal(tt.params["lm"]["layers"]["attn"]["q"], before)


@pytest.mark.parametrize("lora_rank", [4, None], ids=["lora", "full_ft"])
def test_trainer_flash_path_matches_jax_pallas(weights, lora_rank):
    """Training at fp32 on the flash path (the fp32 form's arithmetic: p and
    ds unrounded; the plain FA2 backward here, the fp32 backward kernels on
    a card) against JAX's Trainer with use_flash=True (the Pallas forward
    and backward in interpret mode), two steps with one row padded: losses
    within 1e-5, the trained weights within 1e-5 plus 5 % of a step per
    update. Five, not the module's 1 %: in the full fine-tune one embedding
    element (token 482) has a gradient of ~3.5e-9, 5e-9 of the largest and
    below Adam's eps, whose fp32 noise moves it by 4 % of a step apart here
    and by 2.6 % on the plain path (use_flash=False on both sides,
    measured)."""
    jp, tp = weights
    tc = dict(lora_rank=lora_rank, learning_rate=1e-3, use_flash=True)
    jt = j_trainer.Trainer(jp, CFG, j_trainer.TrainConfig(**tc), rng=jax.random.PRNGKey(2))
    tt = Trainer(tp, T_CFG, TrainConfig(**tc), lora=None if lora_rank is None else _t(jt.lora))
    for seed in (0, 1):
        batch = _batch(seed=seed, pad=1)
        np.testing.assert_allclose(tt.train_step(batch), jt.train_step(_jbatch(batch)),
                                   rtol=1e-5)
    atol = 2 * 0.05 * tc["learning_rate"]
    _assert_trees_close(tt.lora if lora_rank else tt.params["lm"],
                        jt.lora if lora_rank else jt.params["lm"], atol)


def test_trainer_save_restore_round_trip(weights, tmp_path):
    """save, two more steps, restore: adapters and optimizer state are back,
    and the next step repeats the first run's step exactly."""
    _, tp = weights
    tt = Trainer(tp, T_CFG, TrainConfig(lora_rank=4, learning_rate=1e-2, grad_accum_steps=2))
    tt.train_step(_batch(seed=0))
    tt.train_step(_batch(seed=1))
    tt.save(str(tmp_path / "ckpt"))
    saved = {k: v["a"].clone() for k, v in tt.lora["layers"].items()}
    first = [tt.train_step(_batch(seed=s)) for s in (2, 3)]
    after = tt.lora["layers"]["up"]["b"].clone()
    tt.restore(str(tmp_path / "ckpt"))
    assert all(torch.equal(tt.lora["layers"][k]["a"], saved[k]) for k in saved)
    assert tt.opt_state["count"] == 1 and tt.opt_state["mini_step"] == 0
    again = [tt.train_step(_batch(seed=s)) for s in (2, 3)]
    np.testing.assert_allclose(again, first, rtol=1e-6)
    torch.testing.assert_close(tt.lora["layers"]["up"]["b"], after, rtol=1e-6, atol=1e-9)


def test_trainer_raises_on_mesh_and_fsdp(weights):
    """The name is older than the mesh trainer (tests/test_torch_train_mesh.py):
    ``fsdp=True`` without a mesh, and a 1 x 1 mesh, change nothing, as in
    JAX (``fsdp`` is a no-op without a mesh or at data == 1): two full
    fine-tune steps give the plain Trainer's losses and weights bit for
    bit."""
    from paligemma_tpu_torch.core.mesh import single_device_mesh

    _, tp = weights
    runs = []
    for tc, mesh in ((TrainConfig(lora_rank=None, learning_rate=1e-3), None),
                     (TrainConfig(lora_rank=None, learning_rate=1e-3, fsdp=True), None),
                     (TrainConfig(lora_rank=None, learning_rate=1e-3, fsdp=True),
                      single_device_mesh())):
        tt = Trainer(tp, T_CFG, tc, mesh=mesh)
        runs.append(([tt.train_step(_batch(seed=s)) for s in (0, 1)], tt.params["lm"]))
    for losses, lm in runs[1:]:
        assert losses == runs[0][0]
        for got, want in zip(jax.tree.leaves(lm), jax.tree.leaves(runs[0][1])):
            assert torch.equal(got, want)


# ------------------------------------------------- quantized bases, LoRA ----
@pytest.mark.parametrize("base", ["int8_fused", "int8", "nf4_fused", "int4"])
def test_merge_lora_matches_jax(weights, base):
    """merge_lora over an int8 / 4-bit base, fused or not, equals JAX's on
    the same (JAX-quantized) tree: bf16 dequantized weights plus deltas."""
    jp, _ = weights
    kind, fuse = base.split("_")[0], base.endswith("_fused")
    if kind == "int8":
        jq = j_rq.quantize_lm_for_serving(jp, fuse=fuse)
    else:
        jq = j_rq.quantize_lm_for_training(jp, kind=kind, fuse=fuse)
    lo = j_lora.init_lora(jax.random.PRNGKey(2), CFG.text_config, rank=2, targets=("q", "v", "gate"))
    lo = jax.tree.map(lambda x: x + 0.05, lo)  # nonzero B
    want = j_lora.merge_lora(jq["lm"], lo)
    got = t_lora.merge_lora(_t(jq)["lm"], _t(lo))

    def densify(w, deq):
        return np.asarray(deq(w, jnp.bfloat16) if not torch.is_tensor(w) else w, np.float32)

    for grp, names in (("attn", ("q", "k", "v", "o")), ("mlp", ("gate", "up", "down"))):
        for name in names:
            w, g = want["layers"][grp][name], got["layers"][grp][name]
            if isinstance(w, dict):  # untargeted, still quantized: same leaves
                assert set(g) == set(w)
                for key in w:
                    np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
                continue
            np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32),
                                          err_msg=f"{grp}.{name}")
    assert t_lora.num_trainable_params(_t(lo)) == j_lora.num_trainable_params(lo)


@pytest.mark.parametrize("kind", ["nf4", "int4"])
def test_quantize_4bit_bits_match_jax(kind):
    """Packed nibbles, block scales and the codebook equal JAX's bit for
    bit; dequantization of JAX's tree equals JAX's; the stacked layer tree
    of quantize_lm_for_training matches too."""
    w = np.random.default_rng(5).normal(size=(3, 128, 40)).astype(np.float32)
    want = j_quant.quantize_4bit(jnp.asarray(w), kind=kind, group=32)
    got = t_quant.quantize_4bit(torch.from_numpy(w), kind=kind, group=32)
    for key in ("w4", "s4", "grid"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(
        t_quant.dequantize_4bit(_t(want)).numpy(), np.asarray(j_quant.dequantize_4bit(want)))
    chunked = t_quant.quantize_4bit(torch.from_numpy(w), kind=kind, group=32, chunk_elems=1000)
    assert all(torch.equal(chunked[k], got[k]) for k in ("w4", "s4", "grid"))
    x = np.random.default_rng(6).normal(size=(2, 5, 128)).astype(np.float32)
    layer0 = {key: got[key][0] for key in ("w4", "s4")} | {"grid": got["grid"]}
    np.testing.assert_allclose(
        t_quant.matmul_any(torch.from_numpy(x), layer0).numpy(),
        np.asarray(j_quant.matmul_any(jnp.asarray(x), jax.tree.map(lambda a: a[0], want)
                                      | {"grid": want["grid"]})),
        rtol=1e-5, atol=1e-5)

    jp = j_pg.init_params(jax.random.PRNGKey(3), CFG)
    jq = j_rq.quantize_lm_for_training(jp, kind=kind, group=64)
    tq = t_rq.quantize_lm_for_training(_t(jp), kind=kind, group=64)
    for path, leaf in jax.tree_util.tree_leaves_with_path(_np(jq["lm"]["layers"])):
        t = tq["lm"]["layers"]
        for key in path:
            t = t[key.key]
        np.testing.assert_array_equal(t.numpy(), leaf, err_msg=jax.tree_util.keystr(path))


def test_params_from_numpy_carries_lora_int8_and_4bit_trees(weights):
    """A LoRA tree, an int8 tree and a 4-bit tree arrive with their dtypes:
    fp32 adapters, int8 w8 + fp32 s, uint8 w4 + fp32 s4 and grid, also under
    a bf16 cast of the rest."""
    jp, _ = weights
    lo = _t(_lora())
    assert lo["layers"]["q"]["a"].dtype == torch.float32
    q8 = params_from_numpy(_np(j_rq.quantize_lm_for_serving(jp)), "cpu", torch.bfloat16)
    assert q8["lm"]["layers"]["attn"]["qkv"]["w8"].dtype == torch.int8
    assert q8["lm"]["layers"]["attn"]["qkv"]["s"].dtype == torch.float32
    assert q8["lm"]["embed"].dtype == torch.bfloat16
    q4 = params_from_numpy(_np(j_rq.quantize_lm_for_training(jp)), "cpu", torch.bfloat16)
    leaf = q4["lm"]["layers"]["mlp"]["gateup"]
    assert (leaf["w4"].dtype, leaf["s4"].dtype, leaf["grid"].dtype) == (
        torch.uint8, torch.float32, torch.float32)
    assert leaf["grid"].shape == (CFG.text_config.num_hidden_layers, 16)
