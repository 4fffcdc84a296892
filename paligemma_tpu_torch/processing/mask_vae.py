"""VQ-VAE mask decoder for PaliGemma ``<seg###>`` tokens (port of
paligemma_tpu/processing/mask_vae.py).

A segmentation output encodes each object mask as 16 codebook indices. The
public decoder (big_vision's ``vae-oid.npz``) turns them into a 64x64 soft
mask inside the detection box:

    indices (B, 16) -> codebook lookup -> (B, D, 4, 4)
    -> Conv1x1(D->128) + ReLU
    -> 2 x ResBlock(128)      [Conv3x3-ReLU-Conv3x3-ReLU-Conv1x1 + skip]
    -> 4 x [ConvTranspose(k=4, s=2, p=1) + ReLU]   features 128, 64, 32, 16
    -> Conv1x1(->1)           raw logits, demo maps to [0,1] via x*0.5+0.5

The params tree keeps the JAX package's layout (nested dicts, HWIO conv
kernels; each transposed conv's kernel stored (4, 4, out, in)), so a JAX
tree carries over through ``convert.params_from_numpy``. The decode is a
few MFLOPs of ``torch.nn.functional`` convolutions on the params' device:
no kernel of its own.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

NUM_TOKENS = 16          # seg tokens per mask -> 4x4 latent grid
GRID = 4
NUM_EMBEDDINGS = 128     # codebook size == number of <seg###> tokens
MASK_RES = 64


def _conv(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """NCHW conv of an HWIO kernel (1x1 or 3x3; padding k // 2 is SAME at
    stride 1, as the JAX function pads)."""
    w = p["kernel"].permute(3, 2, 0, 1)  # HWIO -> (out, in, H, W)
    return F.conv2d(x, w, p["bias"], padding=w.shape[-1] // 2)


def _conv_transpose(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """Stride-2 k=4 transposed conv that doubles H and W.

    The JAX function runs ``lax.conv_transpose(strides 2, padding ((2, 2),
    (2, 2)), transpose_kernel=True)`` on the kernel k stored (4, 4, a, b):
    a correlation, over the input dilated by 2 and padded by 2, with the
    kernel k' = k flipped in H and W with its two channel axes swapped, so
    k'[h, w, b, a] = k[3 - h, 3 - w, a, b] (in b, out a). torch's
    ``conv_transpose2d(stride 2, padding P)`` with a weight W (in, out, 4, 4)
    is that same correlation with the pad 4 - 1 - P and W flipped in H and
    W. Pad 2 gives P = 1, and the two flips cancel: W[b, a, h, w] =
    k[h, w, a, b], a plain permute."""
    w = p["kernel"].permute(3, 2, 0, 1)  # (4, 4, out, in) -> (in, out, 4, 4)
    return F.conv_transpose2d(x, w, p["bias"], stride=2, padding=1)


def _resblock(x: torch.Tensor, p: Dict) -> torch.Tensor:
    h = F.relu(_conv(x, p["conv0"]))
    h = F.relu(_conv(h, p["conv1"]))
    h = _conv(h, p["conv2"])
    return x + h


@torch.no_grad()
def reconstruct_masks(params: Dict, indices) -> torch.Tensor:
    """(B, 16) codebook indices (a tensor or an array) -> (B, 64, 64) mask
    logits in the params' dtype, on the params' device.

    Postprocess like the public demo: ``np.clip(m * 0.5 + 0.5, 0, 1)`` then
    threshold at 0.5 (see :func:`to_unit_range`).
    """
    emb = params["embeddings"]  # (NUM_EMBEDDINGS, D)
    indices = torch.as_tensor(indices, device=emb.device)
    if indices.shape[-1] != NUM_TOKENS:
        raise ValueError(f"reconstruct_masks: {NUM_TOKENS} indices a mask, got "
                         f"{tuple(indices.shape)}")
    x = emb[indices.reshape(-1).long()]
    x = x.reshape(indices.shape[0], GRID, GRID, emb.shape[1]).permute(0, 3, 1, 2)
    x = F.relu(_conv(x, params["conv_in"]))
    x = _resblock(x, params["res0"])
    x = _resblock(x, params["res1"])
    for i in range(4):
        x = F.relu(_conv_transpose(x, params[f"up{i}"]))
    x = _conv(x, params["conv_out"])
    return x[:, 0]


def to_unit_range(mask_logits) -> np.ndarray:
    """Demo-parity mapping of decoder output to [0, 1] soft masks."""
    if torch.is_tensor(mask_logits):
        mask_logits = mask_logits.detach().float().cpu().numpy()
    return np.clip(np.asarray(mask_logits) * 0.5 + 0.5, 0.0, 1.0)


def init_params(generator: torch.Generator, embedding_dim: int = 512,
                dtype: torch.dtype = torch.float32) -> Dict:
    """Random decoder with the official geometry (for tests / demos without
    the npz), drawn from ``generator`` on its device."""
    dev = generator.device

    def normal(shape, scale):
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dtype)

    def conv_p(kh, kw, cin, cout):
        return {"kernel": normal((kh, kw, cin, cout), 1.0 / np.sqrt(kh * kw * cin)),
                "bias": torch.zeros((cout,), dtype=dtype, device=dev)}

    def convt_p(cin, cout):
        # stored (H, W, out, in), as the loader lays out torch's (in, out, H, W)
        return {"kernel": normal((4, 4, cout, cin), 1.0 / np.sqrt(16 * cin)),
                "bias": torch.zeros((cout,), dtype=dtype, device=dev)}

    def res_p(dim):
        return {"conv0": conv_p(3, 3, dim, dim), "conv1": conv_p(3, 3, dim, dim),
                "conv2": conv_p(1, 1, dim, dim)}

    dim = 128
    p = {
        "embeddings": normal((NUM_EMBEDDINGS, embedding_dim), 1.0),
        "conv_in": conv_p(1, 1, embedding_dim, dim),
        "res0": res_p(dim),
        "res1": res_p(dim),
    }
    # features=dim, then halved after each upsample (big_vision order)
    cin = 128
    for i, cout in enumerate((128, 64, 32, 16)):
        p[f"up{i}"] = convt_p(cin, cout)
        cin = cout
    p["conv_out"] = conv_p(1, 1, 16, 1)
    return p


def load_vae_oid_npz(path: str) -> Dict:
    """Load the official ``vae-oid.npz`` (torch-layout keys) into the tree
    above, as CPU tensors: conv weights (O, I, H, W) -> HWIO; transposed-conv
    weights (I, O, H, W) get the same transpose, to (H, W, O, I), which
    ``_conv_transpose`` reads back."""
    with np.load(path) as f:
        ckpt = dict(f)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    def conv(name):
        return {"kernel": t(np.transpose(ckpt[f"{name}.weight"], (2, 3, 1, 0))),
                "bias": t(ckpt[f"{name}.bias"])}

    def res(name):
        return {"conv0": conv(f"{name}.net.0"), "conv1": conv(f"{name}.net.2"),
                "conv2": conv(f"{name}.net.4")}

    return {
        "embeddings": t(ckpt["_vq_vae._embedding"]),
        "conv_in": conv("decoder.0"),
        "res0": res("decoder.2"),
        "res1": res("decoder.3"),
        "up0": conv("decoder.4"),
        "up1": conv("decoder.6"),
        "up2": conv("decoder.8"),
        "up3": conv("decoder.10"),
        "conv_out": conv("decoder.12"),
    }
