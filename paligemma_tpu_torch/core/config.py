"""Model configurations, shared with the JAX package.

``paligemma_tpu.core.config`` imports only the standard library (no jax), so
the port re-exports its frozen dataclasses instead of copying them. Importing
it runs ``paligemma_tpu/__init__.py``, which is lazy and pulls in no jax.
"""

from paligemma_tpu.core.config import (  # noqa: F401
    GemmaConfig,
    PaliGemmaConfig,
    SiglipVisionConfig,
    paligemma_3b_224,
    tiny_test_config,
)
