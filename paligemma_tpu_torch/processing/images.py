"""Image preprocessing (port of paligemma_tpu/processing/images.py).

Two paths with the same math (resize -> rescale 1/255 -> normalize with
mean=std=0.5 -> CHW; ref: processing_paligemma.py:13-73):

* ``process_images_host``: PIL bicubic resize on the host (a copy of the JAX
  package's), bit-compatible with the reference pipeline.
* ``preprocess_device``: the same in torch on the tensor's device. The
  resize is ``F.interpolate(mode="bicubic", antialias=True)``: its
  antialiased path uses the a = -0.5 cubic that ``jax.image.resize``
  uses, so the two agree to ~2.5e-5 in normalized units. Without
  ``antialias`` torch takes a = -0.75 and skips the widened support on a
  downscale, and they differ by up to 157 on the 0-255 scale. The math
  runs in float64 and the result is float32, so the card and the host
  give the same pixels to an ulp (in float32 their sums round apart).

PIL is imported inside ``process_images_host`` only: the GPU host has none.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_STANDARD_MEAN = (0.5, 0.5, 0.5)
IMAGENET_STANDARD_STD = (0.5, 0.5, 0.5)


def process_images_host(
    images: Sequence,  # PIL images
    image_size: int,
    scale_factor: float = 1.0 / 255.0,
    mean=IMAGENET_STANDARD_MEAN,
    std=IMAGENET_STANDARD_STD,
) -> np.ndarray:
    """PIL bicubic resize + rescale + normalize + HWC->CHW; returns (B,C,H,W)."""
    from PIL import Image

    out = []
    for image in images:
        img = image.resize((image_size, image_size), resample=Image.Resampling.BICUBIC)
        arr = np.asarray(img.convert("RGB")).astype(np.float32) * scale_factor
        arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        out.append(arr.transpose(2, 0, 1))
    return np.stack(out, axis=0)


def preprocess_device(
    raw_images,  # (B, H, W, 3) uint8 or float, numpy or tensor
    image_size: int,
    *,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Bicubic resize (antialiased) + rescale + normalize on a device.
    Returns (B, C, image_size, image_size) float32.

    The work runs on ``device``; by default a tensor's own device, and
    for a numpy array the card (``device="cpu"`` for the host). With no
    card and no ``device`` a numpy array raises rather than run on the
    CPU."""
    if not torch.is_tensor(raw_images):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("preprocess_device: no CUDA device; pass device='cpu' "
                                   "to preprocess on the host")
            device = torch.device("cuda")
        raw_images = torch.from_numpy(np.ascontiguousarray(raw_images))
    if device is not None:
        raw_images = raw_images.to(device)
    x = raw_images.to(torch.float64).permute(0, 3, 1, 2)
    x = F.interpolate(x, size=(image_size, image_size), mode="bicubic",
                      align_corners=False, antialias=True)
    x = x * (1.0 / 255.0)
    mean = torch.tensor(IMAGENET_STANDARD_MEAN, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STANDARD_STD, dtype=x.dtype, device=x.device).view(1, 3, 1, 1)
    return ((x - mean) / std).to(torch.float32).contiguous()
