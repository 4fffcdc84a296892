"""The spawned rank of tests/test_torch_w8a8.py's two-rank W8A8 prefill: a
module of its own that imports no JAX, so the children do not load it."""

import os

import numpy as np
import torch
import torch.distributed as dist

from paligemma_tpu_torch.core.mesh import make_mesh
from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
from test_torch_tp import _cfg


def rank_prefill(rank, world, init, weights_file, out_dir):
    """One rank of a model axis of ``world`` on gloo: the single-copy
    engine's prefill logits (W8A8), saved as ``logits{rank}.pt``."""
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank)
    try:
        tq, vocab, pix, ids = torch.load(weights_file, weights_only=False)
        eng = PaliGemmaEngine(tq, _cfg(vocab), max_seq_len=320, decode_params=tq,
                              use_flash=False, fused_layer=False, int8_act_prefill=True,
                              mesh=make_mesh(1, world))
        logits, _ = eng.prefill(pix, ids, np.ones_like(ids))
        torch.save(logits, os.path.join(out_dir, f"logits{rank}.pt"))
    finally:
        dist.destroy_process_group()
