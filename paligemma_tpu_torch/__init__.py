"""PyTorch + CUDA port of paligemma_tpu for NVIDIA Hopper (sm_90a).

The JAX package ``paligemma_tpu`` is the reference; this package mirrors its
module layout (``ops/``, ``kernels/``, ``models/``, ``runtime/``, ``train/``,
``checkpoints/``) with the same function names and the same parameter
layout (nested dicts, per-layer tensors stacked on a leading L axis, weights
stored (in, out), int8 leaves ``{"w8", "s"}``, 4-bit leaves
``{"w4", "s4", "grid"}``, LoRA leaves ``{"a", "b", "alpha"}``), so each
module is held against its counterpart.

Run-time imports are torch, numpy and the standard library only; nothing
of the JAX package is imported (``core/config.py`` is the port's own copy of
the config dataclasses).

Every TPU kernel on the ported path has a hand-written Hopper kernel under
``csrc/`` (CUDA C++) or in its wrapper module (Triton), built on first use
(``kernels/_build.py``). A wrapper takes its plain PyTorch version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
"""

from .core.config import (  # noqa: F401
    GemmaConfig,
    PaliGemmaConfig,
    SiglipVisionConfig,
    paligemma_3b_224,
    paligemma_3b_448,
    paligemma_3b_896,
    tiny_test_config,
)
