"""Ablation shelf: ports of the JAX package's quarantined kernels
(paligemma_tpu/kernels/ablation), each with its hand-written Hopper kernel.

Nothing in the engine, serving or training paths imports from here except
``models/siglip.encode(attn="fused")``, which runs ``vision_attention``;
``kernels/__init__.py`` registers the wrappers only to count their launches.
The modules keep the JAX names and signatures (without Pallas's
``interpret``):

* ``vision_attention`` — one-shot softmax MHA for the SigLIP tower
  (``csrc/vision_attention.cu``);
* ``decode_attention`` — length-aware single-token GQA over a dense cache
  with a pad hole (``csrc/seg_attention.cu``);
* ``quant4`` — int4 "K-halves" weight-only matmul (``csrc/int4_matmul.cu``);
* ``quant_pallas`` — int8 dequant-in-kernel matmuls for (K, N) and (N, K)
  weights (``csrc/int8_matmul.cu``), with autograd wrappers.
"""
