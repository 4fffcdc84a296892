"""The Triton kernel of kernels/decode_elementwise.py (the final RMSNorm).

Imported only by the launching function there, on a CUDA tensor's first
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
