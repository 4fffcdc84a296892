"""Decode PaliGemma detection / segmentation outputs (the port's own copy
of paligemma_tpu/processing/detection.py; numpy and ``re`` only).

The reference registers 1024 ``<loc####>`` and 128 ``<seg###>`` task tokens
(ref: processing_paligemma.py:129-145) so a fine-tuned checkpoint can emit
detection ("detect <thing>") and segmentation ("segment <thing>") strings —
but it ships nothing that turns those strings back into boxes or masks.
This module closes that loop, following the public PaliGemma output
grammar (big_vision convention, also used by the HF demo apps):

* one object =  4 ``<loc####>`` tokens (ymin, xmin, ymax, xmax, each a bin
  in [0, 1023] over a 1024-bin grid normalized to the image), optionally
  followed by 16 ``<seg###>`` tokens (VQ codebook indices for a 64x64 mask
  inside the box), followed by a free-text label;
* objects are separated by `` ; ``.

Coordinates are decoded as ``int(bin) / 1024 * dim`` (floored to integer
pixels, clipped to the image) — the exact arithmetic of the public
big_vision / HF demo postprocessing, so boxes match those apps bit for
bit. ``format_objects`` is the inverse (``min(1023, round(norm * 1024))``),
which round-trips every decodable bin exactly.

Everything here is host-side numpy string postprocessing — it runs after
``tokenizer.decode`` and touches no device state.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

_LOC = r"<loc(\d{4})>\s*"
_SEG_NOCAP = r"<seg\d{3}>\s*"

# One object: 4 loc bins (groups 1-4), optional 16 seg codes (group 5, as
# one blob — re only keeps the last match of a repeated group, so the blob
# is re-scanned with _SEG_RE), optional label text (group 6) up to the next
# ';' or '<'. Optional whitespace between tokens: HF fast-tokenizer decode
# inserts spaces between added tokens, SentencePiece decode does not —
# both forms parse.
_OBJ_RE = re.compile(
    rf"{_LOC}{_LOC}{_LOC}{_LOC}"
    rf"((?:{_SEG_NOCAP}){{16}})?"
    r"\s*([^;<]*)"
)
_SEG_RE = re.compile(r"<seg(\d{3})>")


@dataclass(frozen=True)
class Detection:
    """One decoded object.

    ``box`` is (ymin, xmin, ymax, xmax) normalized to [0, 1];
    ``seg_indices`` is a length-16 tuple of VQ codebook indices (0..127)
    when the model emitted a segmentation, else None.
    """

    box: Tuple[float, float, float, float]
    label: str
    seg_indices: Optional[Tuple[int, ...]] = None

    def box_pixels(self, height: int, width: int) -> Tuple[int, int, int, int]:
        """Scale the normalized box to integer pixel coordinates
        (ymin, xmin, ymax, xmax), clipped to the image.

        ``int(norm * dim)`` (floor) — the HF/big_vision demo arithmetic."""
        y0, x0, y1, x1 = self.box
        return (
            min(int(y0 * height), height - 1),
            min(int(x0 * width), width - 1),
            min(int(y1 * height), height - 1),
            min(int(x1 * width), width - 1),
        )


def extract_objects(text: str) -> List[Detection]:
    """Parse a decoded PaliGemma string into a list of :class:`Detection`.

    Tolerant by design: text before the first loc token (e.g. the echoed
    prompt when the caller decodes the full sequence) is ignored, malformed
    fragments (fewer than 4 loc tokens) are skipped, and labels are
    whitespace-stripped.
    """
    out: List[Detection] = []
    for m in _OBJ_RE.finditer(text):
        bins = tuple(int(m.group(i)) / 1024.0 for i in range(1, 5))
        seg_blob = m.group(5)
        seg = (
            tuple(int(s) for s in _SEG_RE.findall(seg_blob))
            if seg_blob
            else None
        )
        out.append(Detection(box=bins, label=m.group(6).strip(), seg_indices=seg))
    return out


def boxes_array(
    dets: Sequence[Detection], height: int, width: int
) -> np.ndarray:
    """(N, 4) int32 array of pixel boxes (ymin, xmin, ymax, xmax)."""
    if not dets:
        return np.zeros((0, 4), np.int32)
    return np.asarray(
        [d.box_pixels(height, width) for d in dets], np.int32
    )


def render_box_masks(
    dets: Sequence[Detection], height: int, width: int
) -> np.ndarray:
    """(N, H, W) uint8 occupancy masks.

    For detections without seg tokens this is the filled box. For
    detections *with* seg tokens, pass their decoded 64x64 soft masks
    through :func:`paste_mask_in_box` instead; this function still returns
    the box fill so callers can use one code path for visualization.
    """
    masks = np.zeros((len(dets), height, width), np.uint8)
    for i, d in enumerate(dets):
        y0, x0, y1, x1 = d.box_pixels(height, width)
        if y1 >= y0 and x1 >= x0:
            masks[i, y0 : y1 + 1, x0 : x1 + 1] = 1
    return masks


def paste_mask_in_box(
    mask64: np.ndarray,
    box: Tuple[float, float, float, float],
    height: int,
    width: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """Resize a decoded (64, 64) float mask into its box on an (H, W) canvas.

    Bilinear resize (matches the big_vision reference postprocessing step
    for PaliGemma segmentation), then threshold to uint8.
    """
    assert mask64.shape == (64, 64), mask64.shape
    y0f, x0f, y1f, x1f = box
    y0 = min(int(y0f * height), height - 1)
    x0 = min(int(x0f * width), width - 1)
    y1 = min(int(y1f * height), height - 1)
    x1 = min(int(x1f * width), width - 1)
    out = np.zeros((height, width), np.uint8)
    bh, bw = y1 - y0 + 1, x1 - x0 + 1
    if bh <= 0 or bw <= 0:
        return out
    # Separable bilinear resize 64x64 -> (bh, bw), align_corners=True
    # semantics (endpoints map to endpoints), pure numpy.
    ys = np.linspace(0.0, 63.0, bh)
    xs = np.linspace(0.0, 63.0, bw)
    yi = np.clip(np.floor(ys).astype(np.int64), 0, 62)
    xi = np.clip(np.floor(xs).astype(np.int64), 0, 62)
    wy = (ys - yi)[:, None]
    wx = (xs - xi)[None, :]
    m = mask64.astype(np.float64)
    top = m[yi][:, xi] * (1 - wx) + m[yi][:, xi + 1] * wx
    bot = m[yi + 1][:, xi] * (1 - wx) + m[yi + 1][:, xi + 1] * wx
    resized = top * (1 - wy) + bot * wy
    out[y0 : y1 + 1, x0 : x1 + 1] = (resized >= threshold).astype(np.uint8)
    return out


def format_objects(dets: Sequence[Detection]) -> str:
    """Inverse of :func:`extract_objects` — emit the PaliGemma string for a
    list of detections (useful for building fine-tuning targets)."""
    parts = []
    for d in dets:
        bins = [min(1023, max(0, int(round(v * 1024)))) for v in d.box]
        s = "".join(f"<loc{b:04d}>" for b in bins)
        if d.seg_indices is not None:
            assert len(d.seg_indices) == 16
            s += "".join(f"<seg{i:03d}>" for i in d.seg_indices)
        s += f" {d.label}" if d.label else ""
        parts.append(s)
    return " ; ".join(parts)
