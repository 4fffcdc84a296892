"""examples/detect_demo_torch.py against examples/detect_demo.py: both run
as subprocesses on the CPU with the same seeded ``--vae`` npz (in the
official vae-oid.npz key layout), each into its own ``--out_dir``; the
boxes are equal and each mask within one grey level."""

import json
import os
import subprocess
import sys

import numpy as np
import torch
from PIL import Image

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _vae_npz(path, d=32, seed=0):
    """A decoder in vae-oid.npz's torch key layout, from a seed."""
    rng = np.random.default_rng(seed)
    ckpt = {"_vq_vae._embedding": rng.normal(size=(128, d)).astype(np.float32)}

    def conv(name, cin, cout, k):
        ckpt[f"{name}.weight"] = (rng.normal(size=(cout, cin, k, k)) * 0.05).astype(np.float32)
        ckpt[f"{name}.bias"] = (rng.normal(size=(cout,)) * 0.05).astype(np.float32)

    def convt(name, cin, cout):  # ConvTranspose2d: (in, out, kh, kw)
        ckpt[f"{name}.weight"] = (rng.normal(size=(cin, cout, 4, 4)) * 0.1).astype(np.float32)
        ckpt[f"{name}.bias"] = (rng.normal(size=(cout,)) * 0.05).astype(np.float32)

    conv("decoder.0", d, 128, 1)
    for r in (2, 3):
        for j, k in ((0, 3), (2, 3), (4, 1)):
            conv(f"decoder.{r}.net.{j}", 128, 128, k)
    cin = 128
    for i, cout in zip((4, 6, 8, 10), (128, 64, 32, 16)):
        convt(f"decoder.{i}", cin, cout)
        cin = cout
    conv("decoder.12", 16, 1, 1)
    np.savez(path, **ckpt)


def _run(script, out_dir, vae):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), "--vae", vae,
                          "--out_dir", str(out_dir), "--height", "240", "--width", "320"],
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_detect_demo_torch_writes_the_jax_demos_files(tmp_path):
    vae = str(tmp_path / "vae-oid.npz")
    _vae_npz(vae)
    out_j, out_t = tmp_path / "jax", tmp_path / "torch"
    said_j = _run("detect_demo.py", out_j, vae)
    said_t = _run("detect_demo_torch.py", out_t, vae)
    assert sorted(os.listdir(out_j)) == sorted(os.listdir(out_t))
    with open(out_j / "boxes.json") as fj, open(out_t / "boxes.json") as ft:
        boxes = json.load(fj)
        assert json.load(ft) == boxes
    assert [b["has_mask"] for b in boxes] == [False, True]
    masks = sorted(f for f in os.listdir(out_j) if f.endswith(".png"))
    assert len(masks) == 2
    for name in masks:
        mj = np.asarray(Image.open(out_j / name)).astype(np.int32)
        mt = np.asarray(Image.open(out_t / name)).astype(np.int32)
        assert mj.shape == mt.shape == (240, 320)
        assert np.abs(mj - mt).max() <= 1, name
        assert mj.any()
    # the text the two print, up to the lines that name their own paths
    assert said_t.replace(str(out_t), "OUT") == said_j.replace(str(out_j), "OUT")
