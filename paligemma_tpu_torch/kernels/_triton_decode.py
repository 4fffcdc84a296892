"""Triton kernels of kernels/decode_elementwise.py.

Imported only by the launching functions there, on a CUDA tensor's first
launch: this module imports ``triton`` at its top (Triton resolves ``tl``
from a kernel's module globals), and ``triton`` exists only where a card is.
"""

import triton
import triton.language as tl


@triton.jit
def rms_norm_kernel(x_ptr, w_ptr, out_ptr, K, eps, BLOCK: tl.constexpr):
    # one row: fp32 mean of squares, x * rsqrt(ms + eps) * (1 + w)
    row = tl.program_id(0)
    offs = tl.arange(0, BLOCK)
    m = offs < K
    x = tl.load(x_ptr + row * K + offs, mask=m, other=0.0).to(tl.float32)
    w = tl.load(w_ptr + offs, mask=m, other=0.0).to(tl.float32)
    ms = tl.sum(x * x, axis=0) / K
    y = x * tl.rsqrt(ms + eps) * (1.0 + w)
    tl.store(out_ptr + row * K + offs, y.to(out_ptr.dtype.element_ty), mask=m)


@triton.jit
def rope_kv_write_kernel(
    qkv_ptr, cos_ptr, sin_ptr, pos_ptr, q_ptr, kc_ptr, vc_ptr, kn_ptr, vn_ptr, tab_ptr,
    NQ2, stride_cb, tstride, H: tl.constexpr, D: tl.constexpr, HALF: tl.constexpr,
    PAGED: tl.constexpr, PS: tl.constexpr,
):
    # program (b, h): h < H rotates query head h, h == H rotates the key,
    # h == H + 1 copies the value. K and V land in cache row pos[b] of row b
    # (dense), or in slot tab[b, pos // PS] * PS + pos % PS of the layer's
    # page pool (PAGED)
    b = tl.program_id(0)
    h = tl.program_id(1)
    offs = tl.arange(0, HALF)
    base = qkv_ptr + b * NQ2 + h * D
    x1 = tl.load(base + offs).to(tl.float32)
    x2 = tl.load(base + HALF + offs).to(tl.float32)
    if h <= H:
        c1 = tl.load(cos_ptr + b * D + offs).to(tl.float32)
        c2 = tl.load(cos_ptr + b * D + HALF + offs).to(tl.float32)
        s1 = tl.load(sin_ptr + b * D + offs).to(tl.float32)
        s2 = tl.load(sin_ptr + b * D + HALF + offs).to(tl.float32)
        o1 = x1 * c1 - x2 * s1
        o2 = x2 * c2 + x1 * s2
    else:
        o1 = x1
        o2 = x2
    if h < H:
        qo = q_ptr + (b * H + h) * D
        tl.store(qo + offs, o1.to(q_ptr.dtype.element_ty))
        tl.store(qo + HALF + offs, o2.to(q_ptr.dtype.element_ty))
    else:
        pos = tl.load(pos_ptr + b).to(tl.int64)
        if PAGED:
            page = tl.load(tab_ptr + b * tstride + pos // PS).to(tl.int64)
            row = (page * PS + pos % PS) * D
        else:
            row = b * stride_cb + pos * D
        if h == H:
            tl.store(kc_ptr + row + offs, o1.to(kc_ptr.dtype.element_ty))
            tl.store(kc_ptr + row + HALF + offs, o2.to(kc_ptr.dtype.element_ty))
            tl.store(kn_ptr + b * D + offs, o1.to(kn_ptr.dtype.element_ty))
            tl.store(kn_ptr + b * D + HALF + offs, o2.to(kn_ptr.dtype.element_ty))
        else:
            tl.store(vc_ptr + row + offs, o1.to(vc_ptr.dtype.element_ty))
            tl.store(vc_ptr + row + HALF + offs, o2.to(vc_ptr.dtype.element_ty))
            tl.store(vn_ptr + b * D + offs, o1.to(vn_ptr.dtype.element_ty))
            tl.store(vn_ptr + b * D + HALF + offs, o2.to(vn_ptr.dtype.element_ty))
