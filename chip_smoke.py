"""GPU smoke run of paligemma_tpu_torch: build the hand-written Hopper
kernels, check each against its plain PyTorch version at the shapes of the
main paths, then drive PaliGemma-3B-224 (full widths, random weights from a
seed, int8 decode tree) through its main paths:

* the int8 greedy inference path, PaliGemmaEngine.generate, held against
  the plain path;
* single-copy int8 serving (the ``w8a8`` phase): the W8A8 prefill's two
  kernels bit for bit against their plain versions at Gemma-2B's four
  projections, the engine that holds only the int8 tree
  (``int8_act_prefill``) against the weight-only int8 engine on that tree,
  with no plain int8 product on the card; ``--int8_prefill`` through both
  CLIs; the tensor-parallel single-copy prefill at world size 1 (NCCL) and
  on two gloo ranks giving one card's bits;
* the reference job through the port's CLI (cli.infer.main): the same
  weights written as a full-size HF checkpoint (fp32 safetensors) and
  loaded back bit for bit, then a caption of a seeded image with
  --quantize_int8 (its ids equal to generate's on the in-memory tree, the
  pixels through the native C++ preprocessor) and a sampled batch of two,
  the same text at the same seed;
* the serving entry point (cli.serve.main) on that checkpoint: 12 requests
  in batch mode through the dense and the paged engine (a ServingEngine's
  tokens), twice with the prefix cache (hits with no prefill), with
  grammars (constrained texts accepted, free rows unchanged, the logits
  head), over HTTP (a cancel, 8 concurrent requests, a stream) and with
  LoRA adapters saved by save_pytree;
* ``--dtype float32`` on the card (the ``fp32`` phase, after serve_cli): the
  fp32 forms of B1, the int8 GEMV tile and head, the split decode
  attention and the final norm, each within FP32_REL of its plain fp32
  version at the 3B shapes (the kernel cases); that checkpoint loaded at
  fp32, its kernel engine against the torch-ops engine, generate_spec
  against generate bit for bit, cli.infer --dtype float32 with and without
  --quantize_int8 and with --speculative, cli.serve --dtype float32 dense
  and paged with sampled, grammar and repeated rows and the prefix cache
  (dense == paged), and the 896 px tower through the fp32 B1; the fp32
  forms of the LoRA shrink and expand, the fp32 partial, K1 and W8A8 K1 /
  K2 against their plain versions, cli.serve --dtype float32 with --lora
  (dense and paged) and --int8_prefill, cli.infer --int8_prefill, and the
  TP engines at world size 1 over NCCL on the fp32 trees (one card's
  tokens bit for bit, with the bank too); the Trainer on the fp32 tree
  (B1 and B6's fp32 forms against plain attention on the first step, the
  loss falling, 36 / 18 / 18 fp32 flash launches a step) and the 896 px
  tower through B12's fp32 form; B6, B12 and B10's fp32 forms against their
  plain versions;
* a KV cache whose dtype is not the activations' (``cache_dtype``; the
  ``mixed`` phase after ``serve``, and the fp32 phase's (i)): the mixed
  forms of the qkv GEMV's cache write, 3b and B5 against their plain
  versions; bf16 over an fp32 cache gives the bf16 cache's tokens and
  logits bit for bit through generate, generate_spec and both serving
  engines; fp32 over a bf16 cache gives the fp32 cache's prefill logits bit
  for bit, decode logits within FP32_LOGIT_TOL of the torch-ops engine with
  that cache, dense == paged with a bank, a grammar and the prefix cache,
  spec == greedy, and at TP m = 1 one card's tokens;
* the fine-tuning entry point (cli.finetune.main) on that checkpoint: LoRA
  r8 over a seeded manifest with evaluations and --export_hf, its losses
  bit for bit a Trainer's on the batches derived here in the CLI's order,
  its checkpoints restoring to that Trainer's state, its evaluations
  recomputed, its export loaded back and answering through cli.infer, then
  --resume_from, --base_quant nf4 and --full_finetune runs;
* the continuous-batching serving path: the dense ServingEngine and the
  paged PagedServingEngine serve the same 12 requests with identical
  tokens, the paged engine preempts and recomputes from a small pool, its
  page walk agrees with its fused chain, sampled neighbours leave the
  greedy rows' tokens unchanged, and a request that fills its cache to the
  last position leaves its neighbour's tokens unchanged;
* speculative decoding (the ``spec`` phase, every verify on the decode
  kernels at B x (draft_k + 1) rows, a guard making the plain int8 product
  raise on the card): PaliGemmaEngine.generate_spec against generate
  (the same tokens, int for int), its tok/s against generate's in turns and
  under the acceptance dial, a verify's device time against a decode
  step's, then the dense and paged engines with spec_decode against the
  engines without it (the prefix cache, a pool that preempts); the CLIs'
  ``--speculative`` (the cli phase) and ``--spec_decode`` (the serve_cli
  phase: dense with grammars and the prefix cache, paged with a grammar on
  a pool that preempts); every gate holds the verify calls' launches
  against the windows' cycle counts;
* multi-LoRA serving: a bank of 3 adapters over the same requests, each
  under its own adapter or the base model, through the dense and paged
  kernel ticks (the LoRA shrink kernel and the LoRA expand in the int8
  GEMV's epilogue) and the plain tick, held against each other and against
  an engine without a bank;
* tensor-parallel serving at the JAX package's feature set: K1 (the fp32
  partial with the LoRA expand) at the 3B shard shapes; at world size 1
  over NCCL the TP engines with a bank, a grammar, a prefix repeat and
  spec_decode (dense and paged) and generate_spec give the one-card kernel
  engines' tokens, the bank applied inside the TP chain (4 shrinks and 2 K1
  a layer and tick, no plain LoRA product in a tick); two gloo ranks on the
  card run the same features alike; ``cli.infer`` and ``cli.serve`` (batch
  and HTTP) with ``--model_parallel 2`` on the cli phase's checkpoint, then
  both again with ``--dtype float32`` in the same ranks (``--data_parallel
  2`` likewise);
* single-GPU LoRA training, Trainer.train_step at full width and depth
  (B=2, S=512, remat): the flash kernels' forward and backward against the
  plain attention path on the first step, the loss falling over 8 steps,
  gradient accumulation, one step each over an int8 and an NF4 base, and
  the merged adapters served by PaliGemmaEngine.generate;
* the training half of the mesh (the ``train_mesh`` phase, last): the
  Trainer under make_mesh(2, 1), (1, 2) and (2, 2) on gloo ranks that
  share the card, at 2 layers of full width (LoRA, an FSDP full fine-tune,
  QLoRA over NF4) against
  one card's Trainer, and cli.finetune with --data_parallel 2,
  --model_parallel 2 (resuming the data axis's state), --fsdp
  --full_finetune and two --multihost processes through a coordinator.

    python3 chip_smoke.py          # needs one CUDA card, nvcc and triton

Prints per-phase lines, then a JSON line with one entry per kernel: its
``launches`` summed over the counted runs of the paths (the w8a8 phase's
generate, the five CLI runs, the serve_cli runs, the fp32 phase's runs, the four finetune CLI runs and
the answer from their export, the served runs (a)-(e), the spec phase's runs, the multi-LoRA runs,
the TP runs, the ablation phase's runs, the 8 training steps and the
train_mesh ranks' Trainer runs; each run's
counts are zeroed just before it and read just after), its error against its
plain version, its time,
the plain version's and one PyTorch library call's where one computes the
same function, and its bound (the larger of bytes / 3.35 TB/s and
operations / 989 TFLOP/s at the timed shapes; the W8A8 GEMM's int8
operations / 1,979 TOPS; the fp32 forms' operations / 67 TFLOP/s fp32). Then
the card's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``. Any
failed check raises, so the exit code is not 0 and the last line is never
printed.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
N_TEXT = 10  # text tokens after the 256 image tokens
N_NEW = 64  # greedy tokens per generate
MAX_SEQ = 2048
# Teacher-forced logits of the kernel path vs the plain path, relative to
# the plain path's max |logit|. Both take fp32 int8 dots and bf16
# activations through 18 layers, but round to bf16 at different places
# (fused GEMV epilogues and fp32 attention vs per-op bf16), so they differ
# by a few bf16 ulps (2^-8 = 0.0039) of the largest logit: 7.69e-3 on an
# NVIDIA H100 80GB HBM3 at 700 W. The tolerance is about 4x that reading; a
# kernel that dropped or garbled a term is off by O(1).
LOGIT_REL_TOL = 3e-2
# the kernels of the int8 greedy inference path (PaliGemmaEngine.generate):
# per decode layer the qkv GEMV with the input norm and RoPE + KV write
# (int8_gemv_rope_kv), attention, and the o, gateup (post-attention norm in
# its prologue) and down GEMVs; rms_norm is the final norm, once a step
GENERATE_KERNELS = ("flash_attention_fwd", "int8_gemv", "decode_attention", "rms_norm",
                    "int8_gemv_rope_kv", "head_argmax")
# device launches per decode layer without a LoRA bank: the qkv GEMV, the
# attention's split and combine, o, gateup, down (9 before the norms and
# RoPE moved into the GEMVs); and the final norm, once a step or tick
LAYER_LAUNCHES = 6
# the device events of a decode layer's kernels (the profile's gate), and
# the final norm's
LAYER_EVENTS = ("int8_gemv_kernel", "attn_split", "attn_combine", "rope_kv_write_kernel")
NORM_EVENT = "rms_norm_kernel"
# the tensor-parallel wrappers (B7, B7b, B8 and the fp32-partial epilogue):
# no one-card kernel path launches them
TP_KERNELS = ("int8_gemv_f32", "int8_gemv_f32_lora", "mlp_decode_fused", "attn_decode_tp",
              "attn_decode_paged_tp")
# the ablation shelf's wrappers (kernels/ablation): only their own entry
# points and siglip.encode(attn="fused") launch them (the ablation phase)
ABLATION_KERNELS = ("vision_attention", "seg_decode_attention", "int4_matmul", "int8_matmul",
                    "int8_matmul_nmajor")
# the serving engines' kernels: (must launch, must not launch, once per layer
# and tick); the dense tick is the generate chain, the paged fused tick the
# same chain with kernels B and A (the qkv GEMV writing page slots), the
# page walk kernel A with torch ops. A tick that launches rms_norm (the
# final norm) launches it once
DENSE_TICK = (GENERATE_KERNELS, ("paged_decode_attention", "lora_shrink") + TP_KERNELS,
              ("decode_attention", "int8_gemv_rope_kv"))
PAGED_FUSED_TICK = (("flash_attention_fwd", "int8_gemv", "rms_norm", "head_argmax",
                     "paged_decode_attention", "int8_gemv_rope_kv"),
                    ("decode_attention", "lora_shrink") + TP_KERNELS,
                    ("paged_decode_attention", "int8_gemv_rope_kv"))
# sampled ticks take the int8 GEMV head, so a mixed run need not reach the
# argmax head kernel
PAGED_MIXED_TICK = (tuple(k for k in PAGED_FUSED_TICK[0] if k != "head_argmax"),
                    *PAGED_FUSED_TICK[1:])
PAGE_WALK_TICK = (("flash_attention_fwd", "paged_decode_attention"),
                  ("decode_attention", "int8_gemv_rope_kv") + TP_KERNELS,
                  ("paged_decode_attention",))
# the multi-LoRA tick adds lora_shrink (kernels/lora) four times per layer
# (qkv, o, gate|up, down), and each of the four GEMV launches of the layer
# (int8_gemv_rope_kv for qkv, int8_gemv for the other three) adds the
# expand in its epilogue: 8 LoRA-related launches per layer and tick, one
# shrink and one GEMV per target group; no run without a bank launches
# lora_shrink
LORA_KERNELS = ("lora_shrink",)
LORA_LAUNCHES_PER_LAYER = {"lora_shrink": 4, "int8_gemv": 3, "int8_gemv_rope_kv": 1}
# the tensor-parallel ticks at world size 1 (run (b)): the dense TP tick is
# B7 (its chain counts int8_gemv_rope_kv, decode_attention and
# int8_gemv_f32 each) and B7b per layer, then the vocab-shard argmax head;
# the paged TP tick is B8 and B7b per layer, then the gathered int8 GEMV
# head
TP_DENSE_TICK = (GENERATE_KERNELS + ("int8_gemv_f32", "mlp_decode_fused", "attn_decode_tp"),
                 ("paged_decode_attention", "attn_decode_paged_tp", "lora_shrink"),
                 ("attn_decode_tp", "mlp_decode_fused", "decode_attention", "int8_gemv_rope_kv"))
TP_PAGED_TICK = (("flash_attention_fwd", "int8_gemv", "rms_norm", "paged_decode_attention",
                  "int8_gemv_rope_kv", "int8_gemv_f32", "mlp_decode_fused",
                  "attn_decode_paged_tp"),
                 ("decode_attention", "attn_decode_tp", "head_argmax", "lora_shrink"),
                 ("attn_decode_paged_tp", "mlp_decode_fused", "paged_decode_attention",
                  "int8_gemv_rope_kv"))
# host-side profiler rows of the collectives (c10d's dispatch and NCCL's own
# range); the gloo path stages through host copies, counted as copies
COLLECTIVE_KEYS = ("c10d::", "nccl:", "record_param_comms", "allreduce", "all_gather",
                   "all_reduce")
# the kernel cases' model axis sizes (the H100 runs one rank's shard at a
# time): 8 query heads and I = 16384 split into 8 / m heads and I / m; the
# widths are Gemma-2B's in PaliGemma-3B-224
# the W8A8 prefill's kernels: only the single-copy engines launch them
W8A8_KERNELS = ("w8a8_quant_rows", "w8a8_gemm")
TP_SIZES = (1, 2, 4, 8)
TP_LAYER = dict(hidden=2048, heads=8, head_dim=256, inter=16384, vocab=257152)
# run (c): two ranks sharing the one card over gloo; the seconds it may take
TP2_TIMEOUT = 600
# serving phase: 12 requests (256 image tokens + 4..60 text tokens, 16..64 new
# tokens) over 8 slots; the small pool makes the paged engine preempt (the
# scheduler is host bookkeeping, independent of the tokens: with these
# requests a 44-page pool evicts request 6 after 16 of its tokens)
N_REQ = 12
SERVE = dict(max_slots=8, max_seq_len=1024, sync_every=8, pipeline=True)
PAGE = 64
FULL_POOL = 8 * 1024 // PAGE + 1  # the dense reservation + the garbage page
SMALL_POOL = 44
# run (e): a cache this long is filled exactly by a 316-token prompt whose
# budget is capped at submit (68 tokens), beside a 260-token prompt that
# decodes 100 tokens
FILL_SEQ = 384
# multilora phase: 3 adapters of rank 8, alpha 8, on q/k/v/o/gate/up/down
# (the reference's fine-tune recipe, cli/finetune.py), fp32 as init_lora
# makes them, with seeded nonzero B (a trained adapter, not init's B = 0);
# the serving phase's 12 requests take [base, a, b, c] in turn. The random
# 3B model repeats one token with a wide margin: B of std 0.05 (each delta
# ~14 % of its base projection's norm, a fine-tune's size) changed no token
# on an H100, so the served bank's B has std 0.5 (deltas ~1.4x the base),
# for every adapter to move tokens. The kernel tick rounds the adapter
# basis z to bf16 where the TPU kernel does, the plain tick keeps it in
# fp32 as JAX's XLA path does (with fp32 activations the two compute the
# same function, tests/test_torch_multilora.py
# test_kernel_tick_equals_plain_tick_in_fp32); at 1.4x deltas that rounding alone moves the teacher-forced logits by
# 6.6e-2 of the largest on an H100, so the logit gate runs a bank of the
# fine-tune's size (B std 0.05) and the large bank's reading is printed
LORA_RANK, LORA_ALPHA, LORA_B_STD, LORA_B_STD_GATE = 8, 8.0, 0.5, 0.05
# K1's partials of m = 2 ranks, summed and added, against one card: each rank
# rounds its basis z_r to bf16 (ROADMAP C, "LoRA rounding"), relative to the
# largest element
K1_SUM_TOL = 3e-2
LORA_NAMES = ("a", "b", "c")
CASE_LAYER = 5  # the layer of the kernel cases
# ablation phase (B9, B11): Gemma-2B's four projections of one layer at
# decode rows (1, 8), the first row past the decode routes (17), the TTFT
# prompt's prefill (266) and the training batch (B2 x S512 = 1024)
PROJECTIONS = (("qkv", 2048, 2560), ("o", 2048, 2048), ("gateup", 2048, 32768),
               ("down", 16384, 2048))
INT4_ROWS = (1, 8, 17, 266, 1024)
INT8_ROWS = (1, 8, 17, 266, 1024)
# the device events of B9 / B11 (one per call): the wgmma tile, the GEMV
# tile of B11's (K, N) decode rows and B9's int4 form
WQ_EVENTS = ("wq_wgmma_kernel", "int8_gemv_kernel", "int4_gemv_kernel")
WQ_WRAPPERS = ("int4_matmul", "int8_matmul", "int8_matmul_nmajor")
# H100 SXM peaks for the bounds (NVIDIA's data sheet, dense): bf16 tensor
# cores and HBM3
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations a second (H100 SXM)
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_TF32X3_FLOPS = 495e12 / 3  # fp32 products as three tf32 tensor-core products
PEAK_BYTES = 3.35e12
# the spin kernel that checks each profile's device clock (profiled): ~0.5
# ms at the H100's clocks, so that the ~20 us the events add to a kernel
# under the profiler stay inside the check's 15 %
SPIN_CYCLES = 1_000_000
# profiles of one function before its device times are given up: the card's
# host has dropped a function's events in three runs in a row
PROFILE_RUNS = 6
# short spin kernels that open every profile (profiled)
PROFILE_OPENING_SPINS = 8
# the flash forward's (B1) cases: label, (b, sq, skv, hq, hkv, d), prefix_len,
# kv_len, q_offset, timing ("json": the kernels line's times and device
# times; "device": device times beside SDPA (and B12 at the tower's shape);
# None: checked only). LM prefill (256 image + 10 text tokens), a causal
# suffix, the training shape, SigLIP's head_dim at 224 px and the 896 px
# tower, head_dim 64 with 64-row tiles across two heads, queries after a
# cached prefix, and a row with kv_len 0 (exact zeros)
FLASH_FWD_CASES = (
    ("LM prefill B1 S266 Hq8 Hkv1 D256", (1, 266, 266, 8, 1, 256), [266], [266], 0, "json"),
    ("prefix<kv_len B2 S266 Hq8 Hkv1 D256", (2, 266, 266, 8, 1, 256), [226, 219], [266, 259], 0,
     None),
    ("train B2 S512 Hq8 Hkv1 D256", (2, 512, 512, 8, 1, 256), [268, 268], [512, 400], 0,
     "device"),
    # a tensor-parallel rank's heads in training (train_mesh): m = 2 at B2,
    # 2 x 2 at one row a data shard
    ("train TP-local m=2 B2 S512 Hq4 Hkv1 D256", (2, 512, 512, 4, 1, 256), [268, 268],
     [512, 400], 0, "device"),
    ("train TP-local 2x2 B1 S512 Hq4 Hkv1 D256", (1, 512, 512, 4, 1, 256), [268], [512], 0,
     None),
    ("vision B2 S256 H16 D72", (2, 256, 256, 16, 16, 72), [256, 249], [256, 249], 0, None),
    ("tower B1 S4096 H16 D72", (1, 4096, 4096, 16, 16, 72), [4096], [4096], 0, "device"),
    ("GQA B2 S199 Hq4 Hkv2 D64", (2, 199, 199, 4, 2, 64), [60, 100], [199, 150], 0, None),
    ("q_offset 266 B2 Sq64 Skv330 D256", (2, 64, 330, 8, 1, 256), [256, 256], [330, 300], 266,
     None),
    ("kv_len 0 row B2 S128 Hq8 Hkv1 D256", (2, 128, 128, 8, 1, 256), [40, 0], [128, 0], 0, None),
)
# training phase: B=2 rows of 512 tokens, 256 image + 12 prompt tokens as
# the prefix, suffix labels; row 1 padded to 400 real tokens
TRAIN_B, TRAIN_S, TRAIN_PROMPT, TRAIN_REAL1 = 2, 512, 12, 400
TRAIN_STEPS = 8
# the training step's kernels: the flash forward runs twice per layer (the
# forward and remat's recompute), each backward kernel once
TRAIN_PER_STEP = {"flash_attention_fwd": 36, "flash_attention_bwd_dq": 18,
                  "flash_attention_bwd_dkv": 18}
TRAIN_ONLY = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
# first step, flash kernels vs the plain attention path from the same
# adapters: both run bf16 activations through 18 layers and round the
# softmax weights to bf16 before their product with V, but round the rest
# at other places (the kernels round ds to bf16 before dQ and dK, where the
# TPU kernels do; the plain path rounds the weights' gradient dP, through
# autograd of its bf16 cast, and keeps ds in fp32), so the loss differs in
# the fourth digit and each LoRA-b gradient by ~1e-2 of its largest element
# (measured in PERF.md); a dropped or garbled term is off by O(1)
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
# --dtype float32 (the fp32 phase and the fp32 kernel cases). Each fp32 form
# against its plain fp32 version (TF32 off), relative to the largest
# element: the GEMV tile's three-term split is within ~1.5e-6 of fp32 x @ W
# at K = 16384, one bf16 or TF32 pass ~1.6e-3 off (tests/test_torch_fp32.py
# models both); FP32_REL is ten times the first and fifty times below the
# second. The fp32 kernel engine's logits against the torch-ops engine's
# (plain fp32 attention and int8 products), relative to max |logit|, and
# the 896 px tower's features, flash against 'xla': FP32_LOGIT_TOL, 30
# times below the bf16 gate (LOGIT_REL_TOL).
FP32_REL = 2e-5
# B6's fp32 cases (label, (B, S, Hq, Hkv, D), prefix_len, kv_len, timed):
# the training shape and a TP rank's Hq4 (timed; the second printed only),
# GQA, a kv_len 0 row, prefix-LM at D128, and the 3xTF32 tiles' edges: a
# key count off the 32-key tile with D80, and D72 (padded to 80) with eight
# heads folded over 45 rows, so 64-row tiles straddle query heads
B6_FP32_CASES = [
    ("train B2 S512 Hq8 Hkv1 D256", (2, 512, 8, 1, 256), [268, 268], [512, 400], True),
    ("train TP-local m=2 B2 S512 Hq4 Hkv1 D256", (2, 512, 4, 1, 256), [268, 268],
     [512, 400], "device"),
    ("GQA B2 S199 Hq4 Hkv2 D64", (2, 199, 4, 2, 64), [60, 100], [199, 150], False),
    ("kv_len 0 row B2 S40 Hq4 Hkv2 D72", (2, 40, 4, 2, 72), [17, 0], [40, 0], False),
    ("prefix-LM B1 S130 Hq2 Hkv1 D128", (1, 130, 2, 1, 128), [50], [130], False),
    ("key tile edge B1 S77 Hq6 Hkv2 D80", (1, 77, 6, 2, 80), [40], [70], False),
    ("heads straddle tiles B2 S45 Hq8 Hkv1 D72", (2, 45, 8, 1, 72), [20, 45], [45, 33],
     False),
]
FP32_LOGIT_TOL = 1e-3
FP32_NEW = 32  # greedy tokens of the fp32 engines and CLIs
# the bf16 kernels of the main paths -> their fp32 forms' counters (one
# card's, the LoRA shrink's, the fp32 partial's, K1's and W8A8's)
FP32_OF = {"flash_attention_fwd": "flash_attention_fwd_fp32", "int8_gemv": "int8_gemv_fp32",
           "int8_gemv_rope_kv": "int8_gemv_rope_kv_fp32", "head_argmax": "head_argmax_fp32",
           "decode_attention": "decode_attention_fp32",
           "paged_decode_attention": "paged_decode_attention_fp32", "rms_norm": "rms_norm_fp32",
           "lora_shrink": "lora_shrink_fp32", "int8_gemv_f32": "int8_gemv_f32_fp32",
           "int8_gemv_f32_lora": "int8_gemv_f32_lora_fp32",
           "w8a8_quant_rows": "w8a8_quant_rows_fp32", "w8a8_gemm": "w8a8_gemm_fp32",
           "flash_attention_bwd_dq": "flash_attention_bwd_dq_fp32",
           "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_fp32",
           "vision_attention": "vision_attention_fp32",
           "seg_decode_attention": "seg_decode_attention_fp32"}
# A KV cache of the other dtype (the engines' cache_dtype; the mixed phase
# and the fp32 phase's (i)): the three kernel families that read or write
# the cache -> their mixed forms, by the activation dtype (bf16 over an fp32
# cache, fp32 over a bf16 one). Each mixed form against its plain version
# within the tolerance of its activation dtype's forms (MIXED_REL: the
# bf16 cache kernels' 1e-2; FP32_REL); a bf16 output of an fp32 form (the
# cache rows) may round either side of its plain value's tie: 1e-2.
MIXED_OF = {
    torch.bfloat16: {"int8_gemv_rope_kv": "int8_gemv_rope_kv_cache_fp32",
                     "decode_attention": "decode_attention_cache_fp32",
                     "paged_decode_attention": "paged_decode_attention_cache_fp32"},
    torch.float32: {"int8_gemv_rope_kv_fp32": "int8_gemv_rope_kv_fp32_cache_bf16",
                    "decode_attention_fp32": "decode_attention_fp32_cache_bf16",
                    "paged_decode_attention_fp32": "paged_decode_attention_fp32_cache_bf16"}}
MIXED_FORMS = tuple(m for of in MIXED_OF.values() for m in of.values())
MIXED_REL = {torch.bfloat16: 1e-2, torch.float32: FP32_REL}
# the Trainer at fp32 (the fp32 phase's (h)): first step, kernels (B1 and
# B6's fp32 forms) against plain attention from the same adapters. Both run
# fp32 through 18 layers and differ only in the order of the attention's
# sums (~1e-6 relative per op), so the loss agrees to 1e-5 and each LoRA-b
# gradient to 1e-4 of its largest element; a dropped or garbled term is off
# by O(1). Then FP32_TRAIN_STEPS counted steps at lr 1e-3.
FP32_TRAIN_LOSS_REL_TOL = 1e-5
FP32_TRAIN_GRAD_REL_TOL = 1e-4
FP32_TRAIN_STEPS = 3


def ptxas_lines(log_path, kernels_of_interest):
    """Print ``-Xptxas -v``'s registers, shared memory and spills of every
    instantiation of the named kernels (from the build's ptxas.log)."""
    lines = log_path.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        name = line.split("'")[1]
        if not any(k in name for k in kernels_of_interest):
            continue
        info = [ln.replace("ptxas info    :", "").strip() for ln in lines[i + 1:i + 4]
                if "spill" in ln or "Used" in ln]
        print(f"build: ptxas {name[:60]}: {'; '.join(info)}", flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def profiled(fn, label, counts=None, check=None):
    """``fn()`` under torch.profiler, checked, for on the H100's host a
    run's device events come back wrong now and then: every kernel of a
    tick at ~0.46-0.48 of its time, or some of a run's kernels missing
    (an LM head at a quarter of its time, below its bytes bound), or no
    device event at all.

    * the clock: after ``fn`` a spin kernel of ``SPIN_CYCLES`` runs
      between two CUDA events (behind a shorter spin, so that no launch gap
      is in their time); the profiler's duration of it must be within 15 %
      of theirs;
    * the events: ``check(rows, grew)`` returns why the rows cannot be
      right (events missing), or None.

    A run that fails either is printed and done again, up to
    ``PROFILE_RUNS`` runs. Returns (the device-side rows of ``key_averages()`` without the
    spins, the profile, wall ms of ``fn``, what ``counts()`` (launch
    counts) grew by: ``grew``), or None when no run passed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_RUNS + 1):
        sync()
        before = counts() if counts else {}
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # short spins first: the H100 host's profiler drops a run's first
            # device events now and then (3 of 8 calls; 3 of 10 behind three
            # spins), and these absorb them
            for _ in range(PROFILE_OPENING_SPINS):
                torch.cuda._sleep(SPIN_CYCLES // 100)
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
            torch.cuda._sleep(SPIN_CYCLES // 10)
            ev0.record()
            torch.cuda._sleep(SPIN_CYCLES)
            ev1.record()
            sync()
        grew = {k: v - before[k] for k, v in counts().items()} if counts else {}
        events_ms = ev0.elapsed_time(ev1)
        # the two spins are the last device events: fn's work ended before them
        dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        spin = dev[-1] if len(dev) > 2 else None
        rows = [k for k in prof.key_averages() if k.device_type == DeviceType.CUDA
                and k.self_device_time_total > 0 and spin is not None and k.key != spin.name]
        spin_ms = (spin.time_range.end - spin.time_range.start) / 1e3 if rows else 0.0
        why = "no device event of fn" if not rows else (check(rows, grew) if check else None)
        if not why and not 0.85 * events_ms <= spin_ms <= 1.15 * events_ms:
            why = f"the profiler's spin kernel {spin_ms:.4f} ms against CUDA events' {events_ms:.4f} ms"
        if not why:
            return rows, prof, wall, grew
        print(f"profile: {label}: run {attempt}: {why}: its times are not used", flush=True)
    return None


def device_ms(fn, iters: int = 10, label: str = "device_ms"):
    """Device time per call of ``fn``: torch.profiler's device-side events
    (kernels, copies, memsets) over ``iters`` calls after a warm-up call, so
    the host's issue time is not in it (back to back, a call of a few tens
    of us can measure the host). Each event's mean time times its events
    per call (its count / ``iters``, rounded): the H100 host's profiler
    sometimes keeps all but one event of a run, and the rest still time
    right; a count far from a whole number of events per call is refused
    (:func:`profiled` profiles again). Returns (ms, [(event, us per call),
    ...] largest first), or (None, []) when no profile passed."""
    def per_call(k):
        return round(k.count / iters)

    def whole_calls(rows, grew):
        return next((f"{k.key[:40]}: {k.count} events in {iters} calls" for k in rows
                     if per_call(k) == 0 or abs(k.count / iters - per_call(k)) > 0.25), None)

    fn()
    got = profiled(lambda: [fn() for _ in range(iters)], label, check=whole_calls)
    if got is None:
        return None, []
    parts = sorted(((k.key, k.self_device_time_total / k.count * per_call(k)) for k in got[0]),
                   key=lambda x: -x[1])
    return sum(us for _, us in parts) / 1e3, parts


def device_times(label, fns, iters: int = 10):
    """Print the device time per call (:func:`device_ms`) of each (name, fn)
    with its largest events; returns {name: ms or None}."""
    out = {}
    for name, fn in fns:
        ms, parts = device_ms(fn, iters, f"{name} {label}")
        out[name] = ms
        if ms is None:
            print(f"  device {name:26s} {label:40s} not measured (the profiler saw no device "
                  f"activity)", flush=True)
            continue
        detail = ", ".join(f"{k[:44]} {us:.2f} us" for k, us in parts[:4])
        print(f"  device {name:26s} {label:40s} {ms:.4f} ms per call ({detail})", flush=True)
    return out


def timed_pair(kernel_fn, plain_fn, iters: int):
    """(kernel ms, plain ms), measured plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return min(k1, k2), min(p1, p2)


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> float:
    """The least time the card could take: the larger of the operations
    over their peak rate (by default the bf16 tensor cores') and the bytes
    over HBM bandwidth."""
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class KernelReport:
    """Per-kernel max error, tolerance check, times and bound."""

    def __init__(self):
        self.rows = {}

    def case(self, name, label, got, want, rel_tol, floor=1.0):
        """``got`` within ``rel_tol`` of max(``floor``, max |want|); floor 0
        makes it relative to the largest element (the TP partials, whose
        elements lie far below 1)."""
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} {label}: non-finite output")
        err = float((got - want).abs().max())
        tol = rel_tol * max(floor, float(want.abs().max()))
        ok = err <= tol
        print(f"  {name:20s} {label:44s} max_abs_err {err:.3e}  tol {tol:.3e}  "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        row = self.rows.setdefault(name, {"max_abs_err": 0.0})
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if not ok:
            raise AssertionError(f"{name} {label}: max_abs_err {err} > {tol}")

    def time(self, name, label, kernel_fn, plain_fn, flops, n_bytes, library_fn=None,
             iters=20, in_json=True, peak=PEAK_FLOPS):
        """Kernel vs plain version (plain, kernel, kernel, plain), the
        library call if there is one, and the bound of this call's work
        (``flops`` operations at ``peak`` per second, ``n_bytes`` bytes read
        once and written once).
        ``in_json``: add the times to the kernel's row of the JSON line
        (else they are printed only). Returns (kernel, plain, library or
        None, bound) in ms."""
        k, p = timed_pair(kernel_fn, plain_fn, iters)
        lib = None
        if library_fn is not None:
            try:
                lib = min(cuda_ms(library_fn, iters), cuda_ms(library_fn, iters))
            except RuntimeError as e:  # a yardstick only: report, do not fail
                print(f"  {name:20s} {label:44s} library call failed: {e}", flush=True)
        bound = bound_ms(flops, n_bytes, peak)
        lib_txt = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name:20s} {label:44s} kernel {k:.4f} ms  plain {p:.4f} ms  library "
              f"{lib_txt}  bound {bound:.4f} ms ({flops / 1e9:.3f} GFLOP, "
              f"{n_bytes / 1e6:.3f} MB){'' if in_json else ' (not in the JSON sum)'}",
              flush=True)
        if not in_json:
            return k, p, lib, bound
        row = self.rows[name]
        row["ms"] = row.get("ms", 0.0) + k
        row["plain_ms"] = row.get("plain_ms", 0.0) + p
        row["bound_ms"] = row.get("bound_ms", 0.0) + bound
        row["flops_ms"] = row.get("flops_ms", 0.0) + flops / peak * 1e3
        row["bytes_ms"] = row.get("bytes_ms", 0.0) + n_bytes / PEAK_BYTES * 1e3
        if library_fn is not None:
            prev = row.get("library_ms", 0.0)
            row["library_ms"] = None if lib is None or prev is None else prev + lib
        else:
            row.setdefault("library_ms", None)
        return k, p, lib, bound


def _sdpa_args(q, k, v, allowed):
    """(B, S, H, D) q/k/v and a (B, Sq, Skv) visibility mask in the layout
    of F.scaled_dot_product_attention (views, no copies)."""
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), allowed[:, None]


def flash_fwd_device_times(label, q, k, v, pl, kl, q_off):
    """Device time per call of the flash forward (B1) beside SDPA on the
    same inputs (without a mask where every key is visible), and beside B12
    at a vision tower's shape; prints them with the bound of the call.
    Returns (B1 call, SDPA call, flops, bytes)."""
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels.ablation import vision_attention as va

    sq, hq, d = q.shape[1:]
    skv, hkv = k.shape[1:3]
    allowed = fa._allowed(sq, skv, pl, kl, q_off, q.device)
    args = _sdpa_args(q, k, v, allowed)
    mask = None if bool(allowed.all()) else args[3]

    def run():
        return fa.flash_attention(q, k, v, pl, kl, q_offset=q_off)

    def sdpa():
        return F.scaled_dot_product_attention(args[0], args[1], args[2], attn_mask=mask,
                                              enable_gqa=True)

    fns = [("flash_attention_fwd", run), ("SDPA", sdpa)]
    if hkv == hq and mask is None and sq % 128 == 0:
        fns.append(("vision_attention (B12)", lambda: va.vision_attention(q, k, v)))
    dt = device_times(label, fns)
    flops, n_bytes = 4 * d * hq * int(allowed.sum()), 2 * nbytes(q) + nbytes(k, v)  # out as q
    print(f"  device B1 {label}: "
          + ", ".join(f"{n} {'not measured' if ms is None else f'{ms:.4f} ms'}"
                      for n, ms in dt.items())
          + f"; bound {bound_ms(flops, n_bytes):.4f} ms ({flops / 1e9:.3f} GFLOP, "
          f"{n_bytes / 1e6:.3f} MB)", flush=True)
    return run, sdpa, flops, n_bytes


def gemv_device_times(dev, label=""):
    """Device time per call (torch.profiler) of int8_gemv at the decoder's
    four projections and of head_argmax_fused at the LM head, B 1 and 8,
    with the weights cold as in a decode step: each call takes the next of
    enough weight copies to pass 60 MB (the L2 holds 50 MB). Beside them:
    the bytes bound, and torch._weight_int8pack_mm on N-major copies with
    bf16 scales (the product without the epilogue; never called by the
    port), timed the same way. ``label`` tags the lines (tools/gemv_times.py
    runs this on other trees)."""
    from paligemma_tpu_torch.kernels import decode_head as dh
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    g = torch.Generator(device=dev).manual_seed(SEED + 9)

    def cycling(fns):
        at = [0]

        def run():
            at[0] = (at[0] + 1) % len(fns)
            return fns[at[0]]()
        return run

    def us(fn, calls):
        ms = device_ms(fn, calls)[0]
        return None if ms is None else ms * 1e3

    def txt(v):
        return "not measured" if v is None else f"{v:.2f} us"

    tag = f"[{label}] " if label else ""
    print(f"kernels: {tag}int8_gemv / head_argmax device time, weights cold", flush=True)
    for name, k, n, epi in (("qkv", 2048, 2560, ""), ("o+res", 2048, 2048, "residual"),
                            ("gateup+GeGLU", 2048, 32768, "geglu"),
                            ("down+res", 16384, 2048, "residual"), ("head", 2048, 257152, "head")):
        copies = max(1 if epi == "head" else 12, -(-60_000_000 // (k * n)))
        w8s = [torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
               for _ in range(copies)]
        s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
        w8ts, s_bf = [w.t().contiguous() for w in w8s], s.to(torch.bfloat16)
        heads = [dh.repack_head({"w8": w, "s": s}) for w in w8s] if epi == "head" else []
        calls = 4 * copies
        for b in (1, 8):
            x = (torch.randn(b, k, generator=g, device=dev)).to(torch.bfloat16)
            kw = ({"residual": torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)}
                  if epi == "residual" else {"geglu": epi == "geglu"})
            out_bytes = 8 * b if epi == "head" else 2 * b * (n // 2 if epi == "geglu" else n)
            n_bytes = (k * n + 4 * n + 2 * b * k + out_bytes
                       + (2 * b * n if epi == "residual" else 0))
            bound = n_bytes / PEAK_BYTES * 1e6
            if epi == "head":
                kern = cycling([lambda h=h: dh.head_argmax_fused(x, h) for h in heads])
                kname = "head_argmax"
            else:
                kern = cycling([lambda w=w: gv.int8_gemv(x, w, s, **kw) for w in w8s])
                kname = "int8_gemv"
            k_us = us(kern, calls)
            lib_us = us(cycling([lambda w=w: torch._weight_int8pack_mm(x, w, s_bf) for w in w8ts]),
                        calls)
            share = "" if k_us is None else f" ({100 * bound / k_us:.1f} % of it)"
            print(f"  device {tag}{kname:20s} {name + f' B{b} {k}->{n}':36s} {txt(k_us)}  bound "
                  f"{bound:.2f} us{share}  _weight_int8pack_mm {txt(lib_us)}", flush=True)
            if epi == "head":
                logits_us = us(cycling([lambda w=w: gv.int8_gemv(x, w, s) for w in w8s]), calls)
                print(f"  device {tag}{'int8_gemv':20s} {name + f' B{b} logits path':36s} "
                      f"{txt(logits_us)}", flush=True)
        del w8s, w8ts, heads


def lora_device_times(dev, label=""):
    """Device time per call (torch.profiler) of one decoder layer's LoRA
    operands at B8 with a bank of LORA_NAMES adapters of rank LORA_RANK
    (fp32, G = (N+1) * rank): the four shrinks (kernels/lora) and the four
    int8 GEMVs with the expand in their epilogue against the same GEMVs
    without it, the weights and the bank cold as in a decode tick (each
    call takes the next of enough copies to pass 60 MB); beside them the
    bytes bound of the bank's extra work (A and B read once, z written) and
    the cuBLAS products alone (x @ A, z @ B in bf16; never called by the
    port). Prints the bank's extra device time per layer and per tick of
    the 18 layers; ``label`` tags the lines (tools/gemv_times.py runs this
    on other trees)."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    b, rank, n_layers = 8, LORA_RANK, 18
    gcols = (len(LORA_NAMES) + 1) * rank
    ids = (torch.arange(b, device=dev) % (len(LORA_NAMES) + 1)).to(torch.int32)
    tag = f"[{label}] " if label else ""
    print(f"kernels: {tag}LoRA shrink and expand device time, B{b}, G {gcols}, weights and "
          f"bank cold", flush=True)
    groups = (("qkv", 2048, 2560, (2048, 2304), {}), ("o", 2048, 2048, (), {"residual": True}),
              ("gu", 2048, 32768, (16384,), {"geglu": True}),
              ("down", 16384, 2048, (), {"residual": True}))
    tot = {}
    for name, k, n, bounds, kw in groups:
        ng = gcols * (len(bounds) + 1)
        copies = max(12, -(-60_000_000 // (k * n)))
        x = (torch.randn(b, k, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        gkw = ({"residual": torch.randn(b, n, generator=g, device=dev).to(torch.bfloat16)}
               if kw.get("residual") else dict(kw))
        ops = []
        for _ in range(copies):
            w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
            s = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
            a = torch.randn(k, ng, generator=g, device=dev) * k**-0.5
            lb = torch.randn(gcols, n, generator=g, device=dev) * 0.05
            z = kl.lora_shrink_reference(x, a, ids, rank, gcols)
            ops.append((w8, s, a, lb, z, a.to(torch.bfloat16), lb.to(torch.bfloat16)))
        fns = {
            "shrink": [lambda o=o: kl.lora_shrink(x, o[2], ids, rank, gcols) for o in ops],
            "GEMV + expand": [lambda o=o: gv.int8_gemv(x, o[0], o[1], lora=(o[4], o[3], bounds),
                                                       **gkw) for o in ops],
            "GEMV": [lambda o=o: gv.int8_gemv(x, o[0], o[1], **gkw) for o in ops],
            "x @ A (cuBLAS)": [lambda o=o: x @ o[5] for o in ops],
            "z @ B (cuBLAS)": [lambda o=o: o[4][:, :gcols] @ o[6] for o in ops],
        }
        got = {}
        for what, f in fns.items():
            got[what] = device_ms(_cycling(f), 2 * copies)[0]
            tot[what] = None if got[what] is None or tot.get(what, 0.0) is None else (
                tot.get(what, 0.0) + got[what])
        bank_bytes = 4 * (k * ng + gcols * n) + 2 * b * (k + ng)
        tot["bound"] = tot.get("bound", 0.0) + bank_bytes / PEAK_BYTES * 1e3
        print(f"  device {tag}lora {name:5s} K{k} N{n} nG{ng}: " + ", ".join(
            f"{w} {'not measured' if v is None else f'{v * 1e3:.2f} us'}"
            for w, v in got.items()) + f"; the bank's bytes bound "
            f"{bank_bytes / PEAK_BYTES * 1e6:.2f} us", flush=True)
        del ops, fns
    if None in (tot["shrink"], tot["GEMV + expand"], tot["GEMV"]):
        print(f"  device {tag}lora: the bank's extra time not measured", flush=True)
        return
    extra = tot["shrink"] + tot["GEMV + expand"] - tot["GEMV"]
    print(f"  device {tag}lora one layer B{b}: shrinks {tot['shrink'] * 1e3:.2f} us, GEMVs with "
          f"the expand {tot['GEMV + expand'] * 1e3:.2f} us against {tot['GEMV'] * 1e3:.2f} "
          f"without; the bank's extra {extra * 1e3:.2f} us a layer, {extra * n_layers:.4f} ms "
          f"a tick of {n_layers} layers (bound {tot['bound'] * n_layers:.4f} ms); cuBLAS "
          f"x @ A {tot['x @ A (cuBLAS)']} ms, z @ B {tot['z @ B (cuBLAS)']} ms a layer",
          flush=True)


def _cold(make, n_bytes_each):
    """Enough copies from ``make()`` to pass 60 MB (the L2 holds 50 MB), so
    that each call of a cycled run finds its weights cold."""
    return [make() for _ in range(max(12, -(-60_000_000 // n_bytes_each)))]


def fused_gemv_cases(report: KernelReport, dev):
    """The layer's RMSNorm in the int8 GEMV's prologue and RoPE + the KV
    write in the qkv GEMV's epilogue (kernels/int8_gemv ``norm=``,
    ``int8_gemv_rope_kv``) against the plain chains they replaced, within
    1e-2, at B1 and B8: qkv and gateup at Gemma-2B's widths and one TP
    rank's (m = 8: one local head, I/8), into a dense cache and a page pool
    (shuffled pages), with and without a LoRA bank (3 fp32 adapters of rank
    8, the shrink with the same norm). Bit rules: dense == paged; the cast
    q|k|v are the plain-epilogue GEMV's bits (v copied, q and k rotated as
    the plain version rotates them); base rows of a bank the bits without
    one; one y everywhere (three plans' GEMVs over identity weights and the
    shrink return the same normalized rows); a second call the same bits.
    Then the times: back to back at B1 (the JSON's), and the device times
    of :func:`fused_device_times`."""
    from paligemma_tpu_torch.kernels import decode_elementwise as el
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    g = torch.Generator(device=dev).manual_seed(SEED + 14)
    kdim, heads, hd, inter = (TP_LAYER[k] for k in ("hidden", "heads", "head_dim", "inter"))
    eps, s_len, ps = 1e-6, MAX_SEQ, PAGE

    def bf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def int8(k, n):
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        return w8, (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)

    print("kernels: int8_gemv with the norm prologue", flush=True)
    norm = (bf(kdim, scale=0.1), eps)
    for name, n, kw in (("qkv", (heads + 2) * hd, {}), ("gateup+GeGLU", 2 * inter, {"geglu": True}),
                        ("qkv m8", 3 * hd, {}), ("gateup+GeGLU m8", 2 * inter // 8,
                                                 {"geglu": True})):
        w8, s = int8(kdim, n)
        for b in (1, 8):
            x = bf(b, kdim, scale=3.0)
            got = gv.int8_gemv(x, w8, s, norm=norm, **kw)
            again = gv.int8_gemv(x, w8, s, norm=norm, **kw)
            want = gv.int8_gemv_reference(x, w8, s, norm=norm, **kw)
            sync()
            report.case("int8_gemv", f"{name} + norm B{b} {kdim}->{n}", got, want, 1e-2)
            if not torch.equal(got, again):
                raise AssertionError(f"int8_gemv {name} + norm: a second call gave other bits")
        del w8
    eye = torch.eye(kdim, device=dev, dtype=torch.int8)
    unit = torch.zeros(kdim, 8, device=dev, dtype=torch.bfloat16)
    unit[torch.arange(1000, 1008, device=dev), torch.arange(8, device=dev)] = 1.0
    for b in (1, 8):
        x = bf(b, kdim, scale=3.0)
        ys = []
        for reps in (1, 2, 16):  # plans of 256, 256 and 1024 K rows a CTA
            out = gv.int8_gemv(x, eye.repeat(1, reps).contiguous(),
                               torch.ones(kdim * reps, device=dev), norm=norm)
            ys += list(out.split(kdim, dim=1))
        z = kl.lora_shrink(x, unit, torch.zeros(b, dtype=torch.int32, device=dev), 8, 8,
                           norm=norm)
        sync()
        report.case("int8_gemv", f"norm prologue's y B{b} vs rms_norm", ys[0],
                    el.rms_norm_reference(x, *norm), 1e-2)
        same = all(torch.equal(t, ys[0]) for t in ys) and torch.equal(z, ys[0][:, 1000:1008])
        print(f"  {'int8_gemv':20s} {f'one y: 3 plans and the shrink, B{b}':44s} torch.equal "
              f"{same}  {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            raise AssertionError("the norm prologue's y differs between plans or the shrink")
    del eye

    print("kernels: int8_gemv_rope_kv (qkv + norm + RoPE + KV write)", flush=True)
    gcols, rank = (len(LORA_NAMES) + 1) * LORA_RANK, LORA_RANK
    for hl in (heads, 1):
        n = (hl + 2) * hd
        w8, s = int8(kdim, n)
        a = torch.randn(kdim, 3 * gcols, generator=g, device=dev) * kdim**-0.5
        a[:, torch.arange(3 * gcols, device=dev) % gcols < rank] = 0  # the zero adapter
        lb = torch.randn(gcols, n, generator=g, device=dev) * 0.5
        for b in (1, 8):
            x = bf(b, kdim, scale=3.0)
            ang = torch.rand(b, hd, generator=g, device=dev) * 6.28
            cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
            pos = torch.tensor([s_len - 1 - 229 * i % (s_len // 2) for i in range(b)],
                               dtype=torch.int32, device=dev)
            n_p = s_len // ps
            table = (torch.randperm(b * n_p, generator=g, device=dev) + 1).to(torch.int32)
            table = table.reshape(b, n_p)
            ids = (torch.arange(b, device=dev) % (len(LORA_NAMES) + 1)).to(torch.int32)
            rows = torch.arange(b, device=dev)
            slot = table[rows, pos.long() // ps].long(), pos.long() % ps

            def run(fn, paged, lora):
                shape = (b * n_p + 1, ps, hd) if paged else (b, s_len, hd)
                kd, vd = (torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(2))
                kn, vn = (torch.empty(b, hd, dtype=torch.bfloat16, device=dev) for _ in range(2))
                q, _, _ = fn(x, w8, s, cos, sin, pos, hl, kd, vd, kn, vn, norm=norm,
                             page_table=table if paged else None, lora=lora)
                at = slot if paged else (rows, pos.long())
                return q, kn, vn, kd[at], vd[at]

            base = None
            for bank in (False, True):
                lora = None
                if bank:
                    z = kl.lora_shrink(x, a, ids, rank, gcols, norm=norm)
                    zp = kl.lora_shrink_reference(x, a, ids, rank, gcols, norm=norm)
                    sync()
                    report.case("lora_shrink", f"norm B{b} K{kdim} nG{3 * gcols}", z, zp, 1e-2)
                    lora = (z, lb, (hl * hd, (hl + 1) * hd))
                label = f"B{b} Hl{hl} D{hd}{' bank' if bank else ''}"
                dense = run(gv.int8_gemv_rope_kv, False, lora)
                paged = run(gv.int8_gemv_rope_kv, True, lora)
                again = run(gv.int8_gemv_rope_kv, False, lora)
                qkv = gv.int8_gemv(x, w8, s, norm=norm, lora=lora)  # mode 0's epilogue
                for layout, got in (("dense", dense), ("paged", paged)):
                    want = run(gv.int8_gemv_rope_kv_reference, layout == "paged", lora)
                    sync()
                    report.case("int8_gemv_rope_kv", f"{label} {layout} q", got[0], want[0], 1e-2)
                    report.case("int8_gemv_rope_kv", f"{label} {layout} k/v rows, k_new/v_new",
                                torch.cat([t.flatten() for t in got[1:]]),
                                torch.cat([t.flatten() for t in want[1:]]), 1e-2)
                kc, vc = (torch.zeros(b, s_len, hd, dtype=torch.bfloat16, device=dev)
                          for _ in range(2))
                kn, vn = (torch.empty(b, hd, dtype=torch.bfloat16, device=dev) for _ in range(2))
                mode0 = el.rope_kv_write_reference(qkv, cos, sin, pos, hl, kc, vc, kn, vn)
                sync()
                checks = {"dense == paged": all(map(torch.equal, dense, paged)),
                          "a second call": all(map(torch.equal, dense, again)),
                          "mode 0's bits, rotated plainly": all(map(torch.equal, dense[:3],
                                                                    mode0))}
                if bank:
                    checks["base rows == no bank"] = all(
                        torch.equal(u[ids == 0], v[ids == 0]) for u, v in zip(dense[:3], base))
                else:
                    base = dense[:3]
                print(f"  {'int8_gemv_rope_kv':20s} {label:44s} bits: " + ", ".join(
                    f"{k} {v}" for k, v in checks.items())
                    + f"  {'ok' if all(checks.values()) else 'FAIL'}", flush=True)
                if not all(checks.values()):
                    raise AssertionError(f"int8_gemv_rope_kv {label}: bit rules {checks}")
            if b == 1 and hl == heads:
                kd, vd = (torch.zeros(b, s_len, hd, dtype=torch.bfloat16, device=dev)
                          for _ in range(2))
                kn, vn = (torch.empty(b, hd, dtype=torch.bfloat16, device=dev) for _ in range(2))
                args = (x, w8, s, cos, sin, pos, hl, kd, vd, kn, vn)
                # reads x, the norm weight, the weights and scales, cos, sin, pos; writes q
                # and the fresh rows (cache and k_new / v_new)
                report.time("int8_gemv_rope_kv", f"{label} dense",
                            lambda: gv.int8_gemv_rope_kv(*args, norm=norm),
                            lambda: gv.int8_gemv_rope_kv_reference(*args, norm=norm),
                            flops=2 * b * kdim * n + 6 * b * n,
                            n_bytes=(nbytes(x, norm[0], w8, s, cos, sin, pos) + 2 * b * hl * hd
                                     + 4 * nbytes(kn)))
        del w8, a, lb
    fused_device_times(dev)


def fused_device_times(dev, label=""):
    """Device time per call (torch.profiler, weights cold: each call takes
    the next of enough copies to pass 60 MB) of one decode layer's norm and
    RoPE work at B1 and B8, on the tree under test (tools/decode_times.py
    runs it on others), each beside its bytes bound:

    * where kernels/int8_gemv has ``int8_gemv_rope_kv``: the qkv GEMV with
      the norm prologue and the RoPE + KV write epilogue (dense rows and
      page slots), with the norm alone, and with neither; gateup with and
      without the norm;
    * else (the chain before it): rms_norm, the qkv GEMV, rope_kv_write and
      rope_kv_write_paged (Triton), gateup.

    Prints the layer's sum: the two norms, qkv and RoPE, gateup."""
    from paligemma_tpu_torch.kernels import decode_elementwise as el
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    fused = hasattr(gv, "int8_gemv_rope_kv")
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    kdim, heads, hd, inter = (TP_LAYER[k] for k in ("hidden", "heads", "head_dim", "inter"))
    nq, ng, ps, eps = (heads + 2) * hd, 2 * inter, PAGE, 1e-6
    tag = f"[{label}] " if label else ""
    print(f"kernels: {tag}the layer's norms and RoPE, device time, weights cold "
          f"({'fused into the GEMVs' if fused else 'the chain of separate kernels'})", flush=True)

    def leaf(n):
        return (torch.randint(-127, 128, (kdim, n), generator=g, device=dev, dtype=torch.int8),
                (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * kdim**0.5))

    qkvs, gus = _cold(lambda: leaf(nq), kdim * nq), _cold(lambda: leaf(ng), kdim * ng)
    wn = (torch.randn(kdim, generator=g, device=dev) * 0.1).to(torch.bfloat16)
    for b in (1, 8):
        x = (torch.randn(b, kdim, generator=g, device=dev) * 3).to(torch.bfloat16)
        ang = torch.rand(b, hd, generator=g, device=dev) * 6.28
        cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
        pos = torch.tensor([300 + 13 * i for i in range(b)], dtype=torch.int32, device=dev)
        kc, vc = (torch.zeros(b, MAX_SEQ, hd, dtype=torch.bfloat16, device=dev) for _ in range(2))
        kp, vp = (torch.zeros(8 * b + 1, ps, hd, dtype=torch.bfloat16, device=dev)
                  for _ in range(2))
        table = (torch.arange(8 * b, device=dev) + 1).to(torch.int32).reshape(b, 8)
        kn, vn = (torch.empty(b, hd, dtype=torch.bfloat16, device=dev) for _ in range(2))
        qkv_bytes = kdim * nq + 4 * nq + 2 * b * kdim  # weights, scales, x
        # cos, sin, pos in; q out, k and v into the cache and k_new / v_new
        rope_out = nbytes(cos, sin, pos) + 2 * b * heads * hd + 4 * nbytes(kn)
        rope_bytes = 2 * b * nq + rope_out  # the separate kernel reads q|k|v
        gu_bytes = kdim * ng + 4 * ng + 2 * b * kdim + b * ng
        norm_bytes = 4 * b * kdim + 2 * kdim
        if fused:
            rope = (cos, sin, pos)
            fns = [("qkv + norm + RoPE, dense", [lambda w=w: gv.int8_gemv_rope_kv(
                        x, *w, *rope, heads, kc, vc, kn, vn, norm=(wn, eps)) for w in qkvs],
                    qkv_bytes + 2 * kdim + rope_out),
                   ("qkv + norm + RoPE, paged", [lambda w=w: gv.int8_gemv_rope_kv(
                       x, *w, *rope, heads, kp, vp, kn, vn, norm=(wn, eps), page_table=table)
                       for w in qkvs], qkv_bytes + 2 * kdim + rope_out + nbytes(table)),
                   ("qkv + norm", [lambda w=w: gv.int8_gemv(x, *w, norm=(wn, eps))
                                   for w in qkvs], qkv_bytes + 2 * kdim + 2 * b * nq),
                   ("qkv", [lambda w=w: gv.int8_gemv(x, *w) for w in qkvs],
                    qkv_bytes + 2 * b * nq),
                   ("gateup + norm", [lambda w=w: gv.int8_gemv(x, *w, geglu=True, norm=(wn, eps))
                                      for w in gus], gu_bytes + 2 * kdim),
                   ("gateup", [lambda w=w: gv.int8_gemv(x, *w, geglu=True) for w in gus],
                    gu_bytes)]
            layer = ("qkv + norm + RoPE, dense", "gateup + norm")
        else:
            qkv_out = gv.int8_gemv(x, *qkvs[0])
            fns = [("rms_norm", [lambda: el.rms_norm(x, wn, eps)], norm_bytes),
                   ("qkv", [lambda w=w: gv.int8_gemv(x, *w) for w in qkvs],
                    qkv_bytes + 2 * b * nq),
                   ("rope_kv_write", [lambda: el.rope_kv_write(qkv_out, cos, sin, pos, heads, kc,
                                                               vc, kn, vn)], rope_bytes),
                   ("rope_kv_write_paged", [lambda: el.rope_kv_write_paged(
                       qkv_out, cos, sin, pos, heads, kp, vp, table, kn, vn)],
                    rope_bytes + nbytes(table)),
                   ("gateup", [lambda w=w: gv.int8_gemv(x, *w, geglu=True) for w in gus],
                    gu_bytes)]
            layer = ("rms_norm", "rms_norm", "qkv", "rope_kv_write", "gateup")
        got = {}
        for name, calls, n_bytes in fns:
            ms = device_ms(_cycling(calls), max(10, 2 * len(calls)), f"{name} B{b}")[0]
            got[name] = ms
            print(f"  device {tag}{name:26s} B{b}: "
                  f"{'not measured' if ms is None else f'{ms * 1e3:.2f} us'}  bound "
                  f"{n_bytes / PEAK_BYTES * 1e6:.3f} us (bytes)", flush=True)
        parts = [got[k] for k in layer]
        total = "not measured" if None in parts else f"{sum(parts) * 1e3:.2f} us"
        print(f"  device {tag}one layer's norms, qkv, RoPE and gateup B{b}: {total} "
              f"({' + '.join(layer)})", flush=True)
        del kc, vc, kp, vp
    del qkvs, gus


def kernel_phase(report: KernelReport, dev):
    from paligemma_tpu_torch.kernels import decode_attention as da
    from paligemma_tpu_torch.kernels import decode_elementwise as el
    from paligemma_tpu_torch.kernels import decode_head as dh
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(SEED)

    def bf(*shape, scale=1.0):
        a = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(a).to(dev, torch.bfloat16)

    def int8_weight(k, n):
        w8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
        s = torch.from_numpy((rng.random(n, dtype=np.float32) + 0.5) / (127.0 * k**0.5)).to(dev)
        return w8, s

    # -- flash attention forward (B1) at FLASH_FWD_CASES: out within 1e-2
    # and lse within 1e-4 of max(1, |plain|), a second call the same bits
    print("kernels: flash_attention_fwd", flush=True)
    for label, (b, sq, skv, hq, hkv, d), pfx, kvl, q_off, timing in FLASH_FWD_CASES:
        q, k, v = bf(b, sq, hq, d), bf(b, skv, hkv, d), bf(b, skv, hkv, d)
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_off)
        again = fa.flash_attention_with_lse(q, k, v, pl, kl, q_offset=q_off)
        want_out, want_lse = fa._reference_forward(q, k, v, pl, kl, d**-0.5, q_off)
        sync()
        report.case("flash_attention_fwd", f"{label} out", out, want_out, 1e-2)
        report.case("flash_attention_fwd", f"{label} lse", lse, want_lse, 1e-4)
        del want_out, want_lse
        if not (torch.equal(again[0], out) and torch.equal(again[1], lse)):
            raise AssertionError(f"flash_attention_fwd {label}: a second call gave other bits")
        if kvl[-1] == 0 and (out[-1].any() or lse[-1].any()):
            raise AssertionError(f"flash_attention_fwd {label}: the kv_len 0 row is not zeros")
        if timing is None:
            continue
        run, sdpa, flops, n_bytes = flash_fwd_device_times(label, q, k, v, pl, kl, q_off)
        if timing == "json":
            report.time("flash_attention_fwd", label, run,
                        lambda: fa.reference_attention(q, k, v, pl, kl, q_offset=q_off),
                        flops=flops, n_bytes=n_bytes, library_fn=sdpa)
        del q, k, v, out, lse, again

    # -- flash attention backward (B6) and the forward's lse: the training
    # shape (prefix 268 = 256 image + 12 prompt tokens, kv_len 512 and 400),
    # GQA with a padded row tile, SigLIP's head_dim 72, a row with kv_len 0
    print("kernels: flash_attention_bwd_dq, flash_attention_bwd_dkv, forward lse", flush=True)
    # timed: True, in the JSON line and device times; "device": device times
    for label, (b, s, hq, hkv, d), pfx, kvl, timed in [
        ("train B2 S512 Hq8 Hkv1 D256", (2, 512, 8, 1, 256), [268, 268], [512, 400], True),
        ("train TP-local m=2 B2 S512 Hq4 Hkv1 D256", (2, 512, 4, 1, 256), [268, 268],
         [512, 400], "device"),
        ("train TP-local 2x2 B1 S512 Hq4 Hkv1 D256", (1, 512, 4, 1, 256), [268], [512], False),
        ("GQA B2 S199 Hq4 Hkv2 D256", (2, 199, 4, 2, 256), [60, 100], [199, 150], False),
        ("vision B2 S256 H16 D72", (2, 256, 16, 16, 72), [256, 100], [256, 230], False),
        ("kv_len 0 row B2 S128 Hq8 Hkv1 D256", (2, 128, 8, 1, 256), [40, 0], [128, 0], False),
    ]:
        q, k, v, dout = bf(b, s, hq, d), bf(b, s, hkv, d), bf(b, s, hkv, d), bf(b, s, hq, d)
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl)
        want_out, want_lse = fa._reference_forward(q, k, v, pl, kl, d**-0.5, 0)
        delta = fa._delta(out, dout)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, d**-0.5)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, d**-0.5)
        want = fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, d**-0.5, 0)
        sync()
        report.case("flash_attention_fwd", f"{label} out", out, want_out, 1e-2)
        report.case("flash_attention_fwd", f"{label} lse", lse, want_lse, 1e-4)
        report.case("flash_attention_bwd_dq", label, dq, want[0], 1e-2)
        report.case("flash_attention_bwd_dkv", f"{label} dk", dk, want[1], 1e-2)
        report.case("flash_attention_bwd_dkv", f"{label} dv", dv, want[2], 1e-2)
        if len(kvl) > 1 and kvl[1] == 0 and any(bool(t[1].any()) for t in (out, lse, dq, dk, dv)):
            raise AssertionError("flash attention: the kv_len 0 row is not exact zeros")
        if timed:
            allowed = fa._allowed(s, s, pl, kl, 0, dev)
            pairs = hq * int(allowed.sum())  # visible (query head, row, key) triples
            stats = nbytes(lse, delta)
            lib_bwd = None
            try:  # SDPA's backward (dq, dk and dv in one call) on the same inputs
                leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
                a = _sdpa_args(*leaves, allowed)
                lib_out = F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                         enable_gqa=True)
                lib_grad = dout.transpose(1, 2)

                def lib_bwd():
                    return torch.autograd.grad(lib_out, leaves, lib_grad, retain_graph=True)
            except RuntimeError as e:
                print(f"  flash backward: library call failed: {e}", flush=True)
            scale = d**-0.5

            def run_dq():
                return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, scale)

            def run_dkv():
                return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, scale)

            flops_dq, flops_dkv = 6 * d * pairs, 8 * d * pairs
            bytes_dq = nbytes(q, k, v, dout, dq) + stats
            bytes_dkv = nbytes(q, k, v, dout, dk, dv) + stats
            if timed == "device":  # printed only
                dt = device_times(label, [("flash_attention_bwd_dq", run_dq),
                                          ("flash_attention_bwd_dkv", run_dkv)]
                                  + ([("SDPA backward", lib_bwd)] if lib_bwd else []))
                txt = {k: "not measured" if v is None else f"{v:.4f} ms" for k, v in dt.items()}
                print(f"  device B6 {label}: dq {txt['flash_attention_bwd_dq']} (bound "
                      f"{bound_ms(flops_dq, bytes_dq):.4f} ms), dk/dv "
                      f"{txt['flash_attention_bwd_dkv']} (bound "
                      f"{bound_ms(flops_dkv, bytes_dkv):.4f} ms), one SDPA backward "
                      f"{txt.get('SDPA backward', 'not measured')} (not in the JSON sum)",
                      flush=True)
                continue
            bound_dq = report.time(
                "flash_attention_bwd_dq", label, run_dq,
                lambda: fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, scale, 0)[0],
                flops=flops_dq, n_bytes=bytes_dq, library_fn=lib_bwd)[3]
            bound_dkv = report.time(
                "flash_attention_bwd_dkv", label, run_dkv,
                lambda: fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, scale, 0)[1:],
                flops=flops_dkv, n_bytes=bytes_dkv, library_fn=lib_bwd)[3]
            dt = device_times(label, [("flash_attention_bwd_dq", run_dq),
                                      ("flash_attention_bwd_dkv", run_dkv)]
                              + ([("SDPA backward", lib_bwd)] if lib_bwd else []))
            if None not in (dt["flash_attention_bwd_dq"], dt["flash_attention_bwd_dkv"]):
                both = dt["flash_attention_bwd_dq"] + dt["flash_attention_bwd_dkv"]
                lib_txt = ("not measured" if dt.get("SDPA backward") is None
                           else f"{dt['SDPA backward']:.4f} ms")
                print(f"  device B6 dq + dk/dv (sum included) {label}: {both:.4f} ms, bound "
                      f"{bound_dq + bound_dkv:.4f} ms, one SDPA backward {lib_txt}", flush=True)

    # -- int8 GEMV (csrc/gemv_tile.cuh) at the four layer projections and
    # the LM head, and at ragged shapes: K not a multiple of 16 (or of 4:
    # x read element by element), N not a multiple of 128 (or of 16: weight
    # bytes read one by one); B from 1 to 33 (no 32-row cap as on the TPU);
    # a second call must give the same bits
    print("kernels: int8_gemv", flush=True)
    shapes = [("qkv", 2048, 2560, {}, (1, 2, 5, 8, 9, 33)),
              ("o+res", 2048, 2048, {"residual": True}, (1, 8, 33)),
              ("gateup+GeGLU", 2048, 32768, {"geglu": True}, (1, 8, 33)),
              ("down+res", 16384, 2048, {"residual": True}, (1, 8, 33)),
              ("head", 2048, 257152, {}, (1, 8, 33)),
              ("ragged K", 2040, 2500, {}, (1, 5, 9)),
              ("odd K", 1001, 388, {"residual": True}, (2, 8)),
              ("small GeGLU", 77, 300, {"geglu": True}, (2, 33))]
    for name, k, n, kw, batches in shapes:
        w8, s = int8_weight(k, n)
        for b in batches:
            x = bf(b, k)
            args = {}
            if kw.get("residual"):
                args["residual"] = bf(b, n)
            if kw.get("geglu"):
                args["geglu"] = True
            got = gv.int8_gemv(x, w8, s, **args)
            again = gv.int8_gemv(x, w8, s, **args)
            want = gv.int8_gemv_reference(x, w8, s, **args)
            sync()
            label = f"{name} B{b} {k}->{n}"
            report.case("int8_gemv", label, got, want, 1e-2)
            if not torch.equal(got, again):
                raise AssertionError(f"int8_gemv {label}: a second call gave other bits")
            # ms in the JSON: the three int8_gemv calls of a decode layer at
            # B=1 (o, gateup with the post-attention norm in its prologue,
            # down; qkv is int8_gemv_rope_kv's and printed only), beside
            # torch's int8 weight-only matmul on the N-major copy with bf16
            # scales (the product alone, without the epilogue or the norm)
            if b == 1 and name in ("qkv", "o+res", "gateup+GeGLU", "down+res"):
                w8t, s_bf = w8.t().contiguous(), s.to(torch.bfloat16)
                tkw = dict(args, norm=(bf(k, scale=0.1), 1e-6)) if args.get("geglu") else args
                report.time("int8_gemv", label + (" + norm" if "norm" in tkw else ""),
                            lambda: gv.int8_gemv(x, w8, s, **tkw),
                            lambda: gv.int8_gemv_reference(x, w8, s, **tkw),
                            flops=2 * b * k * n,
                            n_bytes=nbytes(x, w8, s, got,
                                           *[t for t in args.values() if torch.is_tensor(t)])
                            + (2 * k if "norm" in tkw else 0),
                            library_fn=lambda: torch._weight_int8pack_mm(x, w8t, s_bf),
                            in_json=name != "qkv")
                del w8t
            elif b == 1 and name == "head":
                k_ms, p_ms = timed_pair(lambda: gv.int8_gemv(x, w8, s),
                                        lambda: gv.int8_gemv_reference(x, w8, s), 5)
                print(f"  {'int8_gemv':20s} {label:44s} kernel {k_ms:.4f} ms  "
                      f"plain {p_ms:.4f} ms (not in the JSON sum)", flush=True)
        del w8, s
    print(f"  {'int8_gemv':20s} {'a second call gives the same bits':44s} ok", flush=True)
    gemv_device_times(dev)

    # -- decode attention over one layer's window, ragged validity at B=4
    print("kernels: decode_attention", flush=True)
    for w in (512, 2048):
        for b in (1, 4, 33):
            q = bf(b, 8, 256)
            kc, vc = bf(b, MAX_SEQ, 256), bf(b, MAX_SEQ, 256)
            lens = [1 + (w - 2 - 97 * i) % (w - 1) for i in range(b)]  # in [1, W)
            valid = torch.zeros((b, w), dtype=torch.bool, device=dev)
            for i, n_ok in enumerate(lens):
                valid[i, :n_ok] = True
            if b > 1:
                valid[1, 5:40] = False  # a hole
            got = da.decode_attention(q, kc, vc, valid, 256**-0.5)
            want = da.decode_attention_reference(q, kc, vc, valid, 256**-0.5)
            sync()
            label = f"B{b} W{w} D256 Hq8"
            report.case("decode_attention", label, got, want, 1e-2)
            if b == 1 and w == 2048:
                n_keys = int(valid.sum())  # the keys this call needs
                sdpa = (q[:, :, None], kc[:, None, :w], vc[:, None, :w], valid[:, None, None])
                report.time("decode_attention", label,
                            lambda: da.decode_attention(q, kc, vc, valid, 256**-0.5),
                            lambda: da.decode_attention_reference(q, kc, vc, valid, 256**-0.5),
                            flops=4 * 256 * 8 * n_keys,
                            n_bytes=nbytes(q, valid, got) + 2 * n_keys * 256 * 2,
                            library_fn=lambda: F.scaled_dot_product_attention(
                                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3],
                                scale=256**-0.5, enable_gqa=True))

    # device times (back to back, a call of a few us measures the host): the
    # split and the combine pass apart, beside SDPA with a bool mask and GQA,
    # at the b1 decode step's window (512), the longest (2048) and B8
    for b, w in ((1, 512), (1, 2048), (8, 2048)):
        q = bf(b, 8, 256)
        kc, vc = bf(b, MAX_SEQ, 256), bf(b, MAX_SEQ, 256)
        lens = torch.tensor([w - 61 * i for i in range(b)], device=dev)
        valid = (torch.arange(w, device=dev)[None] < lens[:, None]).contiguous()
        sdpa = (q[:, :, None], kc[:, None, :w], vc[:, None, :w], valid[:, None, None])
        n_keys = int(valid.sum())
        label = f"B{b} W{w} D256 Hq8"
        dt = device_times(label, [
            ("decode_attention", lambda: da.decode_attention(q, kc, vc, valid, 256**-0.5)),
            ("SDPA", lambda: F.scaled_dot_product_attention(
                sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3], scale=256**-0.5,
                is_causal=False, enable_gqa=True))])
        print(f"  device 3b {label}: " + ", ".join(
            f"{n} {'not measured' if ms is None else f'{ms:.4f} ms'}" for n, ms in dt.items())
            + f"; bound {bound_ms(4 * 256 * 8 * n_keys, nbytes(q, valid, q) + 4 * n_keys * 256):.5f}"
            " ms (bytes)", flush=True)
        del kc, vc

    # -- the final RMSNorm (Triton; the layers' norms are GEMV prologues)
    print("kernels: rms_norm (the final norm before the head)", flush=True)
    for b in (1, 8):
        x, wn = bf(b, 2048), bf(2048, scale=0.1)
        got, want = el.rms_norm(x, wn, 1e-6), el.rms_norm_reference(x, wn, 1e-6)
        sync()
        report.case("rms_norm", f"B{b} K2048", got, want, 1e-2)
        if b == 1:
            w1 = (1.0 + wn.float()).to(x.dtype)  # Gemma's (1 + w) scale
            report.time("rms_norm", f"B{b} K2048", lambda: el.rms_norm(x, wn, 1e-6),
                        lambda: el.rms_norm_reference(x, wn, 1e-6),
                        flops=4 * x.numel(), n_bytes=nbytes(x, wn, got),
                        library_fn=lambda: F.rms_norm(x, (2048,), w1, 1e-6))
            device_times(f"B{b} K2048", [
                ("rms_norm", lambda: el.rms_norm(x, wn, 1e-6)),
                ("F.rms_norm", lambda: F.rms_norm(x, (2048,), w1, 1e-6))])
    fused_gemv_cases(report, dev)

    # -- paged decode attention over the layer-stacked pool at layer 17
    print("kernels: paged_decode_attention", flush=True)
    ps, n_layers = 64, 18
    for b, w, hkv, frag in [(1, 512, 1, False), (1, 1024, 1, True), (8, 512, 1, True),
                            (8, 1024, 1, False), (8, 1024, 2, True)]:
        n_p = w // ps
        n_pages = b * n_p + 1  # page 0: the garbage page
        kp = bf(n_layers, n_pages, ps, hkv, 256)
        vp = bf(n_layers, n_pages, ps, hkv, 256)
        ids = np.arange(1, n_pages)
        if frag:
            rng.shuffle(ids)
        table = torch.from_numpy(ids.reshape(b, n_p).astype(np.int32)).to(dev)
        lens = [w - 61 * i for i in range(b)]
        if b > 1:
            lens[3] = 0  # an empty row: exact zeros
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = bf(b, 8, 256)
        got = pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
        want = pa.reference_paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
        sync()
        label = (f"B{b} W{w} Hq8 Hkv{hkv} layer17 {'fragmented' if frag else 'contiguous'}")
        report.case("paged_decode_attention", label, got, want, 1e-2)
        if b > 1 and torch.count_nonzero(got[3]):
            raise AssertionError("paged_decode_attention: kv_len == 0 row is not exact zeros")
        if b == 8 and w == 1024 and hkv == 1:
            n_keys = sum(lens)  # the keys this call needs, over every row
            report.time("paged_decode_attention", label,
                        lambda: pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17),
                        lambda: pa.reference_paged_decode_attention(q, kp, vp, table, kv_len,
                                                                    layer_idx=17),
                        flops=4 * 256 * 8 * n_keys,
                        n_bytes=nbytes(q, table, kv_len, got) + 2 * n_keys * hkv * 256 * 2)
            # device time beside SDPA over the same keys gathered densely
            kd = kp[17][table.long()].reshape(b, w, 256)
            vd = vp[17][table.long()].reshape(b, w, 256)
            mask = (torch.arange(w, device=dev)[None] < kv_len[:, None].long())[:, None, None]
            device_times(label, [
                ("paged_decode_attention",
                 lambda: pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)),
                ("SDPA (keys gathered)", lambda: F.scaled_dot_product_attention(
                    q[:, :, None], kd[:, None], vd[:, None], attn_mask=mask, enable_gqa=True))])
            del kd, vd
        del kp, vp
    # shared keys: each row's pages are consecutive slices of its dense cache
    # row; the paged kernel must return decode_attention's bits, also over a
    # narrower bucket of pages (fewer empty splits in the combine)
    b = 8
    kc, vc = bf(b, 1024, 256), bf(b, 1024, 256)
    q = bf(b, 8, 256)
    lens = torch.tensor([1 + 61 * i for i in range(b)], dtype=torch.int32, device=dev)  # <= 428
    valid = (torch.arange(1024, device=dev)[None] < lens[:, None].long()).contiguous()
    dense = da.decode_attention(q, kc, vc, valid, 256**-0.5).reshape(b, 8, 256)
    kp, vp = kc.view(b * 16, ps, 1, 256), vc.view(b * 16, ps, 1, 256)
    table = (torch.arange(16, device=dev)[None] + 16 * torch.arange(b, device=dev)[:, None]).to(torch.int32)
    for n_p in (16, 8):
        paged = pa.paged_decode_attention(q, kp, vp, table[:, :n_p], lens, 256**-0.5)
        sync()
        same = torch.equal(paged, dense)
        print(f"  {'paged_decode_attention':20s} {f'shared keys, {n_p} pages vs dense W1024':44s} "
              f"torch.equal {same}  {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            raise AssertionError("paged_decode_attention differs from decode_attention on shared keys")
    # the same keys through B10's policy (one segment) and through a 5-page
    # table of page size 16 (W = 80, not a multiple of the 32-key tile)
    from paligemma_tpu_torch.kernels.ablation import decode_attention as sda
    seg = sda.decode_attention(q, kc[:, :, None], vc[:, :, None], lens, lens, lens, 256**-0.5)
    short = lens.clamp(max=80)
    valid80 = (torch.arange(1024, device=dev)[None] < short[:, None].long()).contiguous()
    dense80 = da.decode_attention(q, kc, vc, valid80, 256**-0.5).reshape(b, 8, 256)
    kp16, vp16 = kc.view(b * 64, 16, 1, 256), vc.view(b * 64, 16, 1, 256)
    table16 = (torch.arange(5, device=dev)[None] + 64 * torch.arange(b, device=dev)[:, None]).to(torch.int32)
    paged80 = pa.paged_decode_attention(q, kp16, vp16, table16, short, 256**-0.5)
    sync()
    for what, same in (("seg_decode_attention, one segment, vs dense W1024", torch.equal(seg, dense)),
                       ("paged, 5 pages of 16 (W80) vs dense W1024", torch.equal(paged80, dense80))):
        print(f"  {'shared keys':20s} {what:44s} torch.equal {same}  {'ok' if same else 'FAIL'}",
              flush=True)
        if not same:
            raise AssertionError(f"split attention policies differ on shared keys: {what}")
    del kc, vc, kp, vp

    # -- LM-head argmax: random inputs, then a planted three-way tie
    print("kernels: head_argmax", flush=True)
    w8, s = int8_weight(2048, 257152)
    head = dh.repack_head({"w8": w8, "s": s})
    for b in (1, 8):
        y = bf(b, 2048)
        ids, mx = dh.head_argmax_fused(y, head, return_max=True)
        logits = gv.int8_gemv(y, w8, s).float()  # the logits path's own head
        plain = ((y.float() @ w8.float()) * s).to(torch.bfloat16).float()
        sync()
        if not (torch.equal(ids.long(), logits.argmax(-1)) and torch.equal(mx, logits.max(-1).values)):
            raise AssertionError("head_argmax: differs from argmax of the int8_gemv logits")
        again = dh.head_argmax_fused(y, head, return_max=True)
        if not (torch.equal(again[0], ids) and torch.equal(again[1], mx)):
            raise AssertionError("head_argmax: a second call differs")
        # against the plain version: the kernel's winner is a maximum of the
        # plain logits up to the bf16 rounding of a reordered fp32 sum
        win_plain = plain.gather(1, ids.long()[:, None])[:, 0]
        report.case("head_argmax", f"B{b} winning logit vs plain max", win_plain,
                    plain.max(-1).values, 1e-2)
        report.case("head_argmax", f"B{b} returned max vs plain", mx, plain.max(-1).values, 1e-2)
        if b == 1:
            report.time("head_argmax", f"B{b} 2048->257152",
                        lambda: dh.head_argmax_fused(y, head),
                        lambda: dh.reference_head_argmax(y, {"w8": w8, "s": s}),
                        flops=2 * b * w8.numel(), n_bytes=nbytes(y, w8, s, ids, mx), iters=5)
    y = bf(1, 2048)
    j0, dups = 1000, (70000, 257000)
    w8[:, j0] = torch.where(y[0] > 0, 127, -127).to(torch.int8)
    s[j0] = 1.0
    for j in dups:
        w8[:, j] = w8[:, j0]
        s[j] = s[j0]
    head = dh.repack_head({"w8": w8, "s": s})
    ids = dh.head_argmax_fused(y, head)
    sync()
    tie = int(ids[0])
    print(f"  {'head_argmax':20s} {'planted tie at ' + str((j0,) + dups):44s} -> id {tie}  "
          f"{'ok' if tie == j0 else 'FAIL'}", flush=True)
    if tie != j0:
        raise AssertionError(f"head_argmax: planted tie resolved to {tie}, not {j0}")
    del w8, s, head


def tp_kernel_phase(report: KernelReport, dev):
    """The tensor-parallel kernels on one rank's shard of one decoder layer
    of PaliGemma-3B-224 at full width (K 2048, 8 heads of 256, I 16384), for
    m = 1, 2, 4 and 8 ranks: B7 (attn_decode_tp), B8 (attn_decode_paged_tp)
    and B7b (mlp_decode_fused) at ranks 0 and m-1 against their plain
    versions; the sum of all m ranks' fp32 partials, cast, against the
    unsharded result (m = 1, whose cast partial is the one-card chain's
    int8_gemv output); the fp32-partial epilogue; the vocab-shard argmax
    combine, with a tie planted across two shards."""
    from paligemma_tpu_torch.core.mesh import Mesh, shard_params
    from paligemma_tpu_torch.kernels import decode_head as dh
    from paligemma_tpu_torch.kernels import decode_layer_paged_tp as ptp
    from paligemma_tpu_torch.kernels import decode_layer_tp as tp
    from paligemma_tpu_torch.kernels import decode_mlp as dm
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    kdim, heads, hd, inter, vocab = (TP_LAYER[k] for k in ("hidden", "heads", "head_dim",
                                                          "inter", "vocab"))
    n_layers, layer, eps = 2, 1, 1e-6
    seq, ps = MAX_SEQ, PAGE

    def bf(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def int8(*shape):  # stacked (.., K, N) int8 weight, per-column fp32 scales
        w8 = torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)
        s = torch.rand(shape[:-2] + shape[-1:], generator=g, device=dev)
        return {"w8": w8, "s": (s + 0.5) / (127.0 * shape[-2] ** 0.5)}

    layers = {"input_norm": bf(n_layers, kdim, scale=0.1),
              "post_norm": bf(n_layers, kdim, scale=0.1),
              "attn": {"qkv": int8(n_layers, kdim, (heads + 2) * hd),
                       "o": int8(n_layers, heads * hd, kdim)},
              "mlp": {"gateup": int8(n_layers, kdim, 2 * inter),
                      "down": int8(n_layers, inter, kdim)}}

    print("kernels: attn_decode_tp, attn_decode_paged_tp, mlp_decode_fused (one rank's shard)",
          flush=True)
    for b in (1, 8):
        x, y2 = bf(b, kdim), bf(b, kdim)
        kc, vc = bf(n_layers, b, seq, hd), bf(n_layers, b, seq, hd)
        pos = torch.tensor([seq - 1 - 229 * i % (seq // 2) for i in range(b)], dtype=torch.int32,
                           device=dev)
        valid = (torch.arange(seq, device=dev)[None] <= pos[:, None].long()).contiguous()
        n_keys = int(valid.sum())  # this token's position included
        ang = torch.rand(b, hd, generator=g, device=dev) * 6.28
        cos, sin = ang.cos().to(torch.bfloat16), ang.sin().to(torch.bfloat16)
        # the page pool holds the dense cache's rows, each row's pages shuffled
        n_p = seq // ps
        table = torch.from_numpy(
            (rng.permutation(b * n_p) + 1).reshape(b, n_p).astype(np.int32)).to(dev)
        kp = torch.zeros((n_layers, b * n_p + 1, ps, hd), dtype=torch.bfloat16, device=dev)
        vp = torch.zeros_like(kp)
        kp[:, table.flatten().long()] = kc.reshape(n_layers, b * n_p, ps, hd)
        vp[:, table.flatten().long()] = vc.reshape(n_layers, b * n_p, ps, hd)
        unsharded = {}
        for m in TP_SIZES:
            sums = {}
            for r in range(m):
                local = shard_params({"layers": layers}, Mesh(model=m, rank=r))["layers"]
                hl, il = heads // m, inter // m
                check = r in (0, m - 1)
                caches = [(kc.clone(), vc.clone()) for _ in range(1 + check)]
                pools = [(kp.clone(), vp.clone()) for _ in range(1 + check)]
                dense_args = dict(valid=valid, cache_pos=pos, cos=cos, sin=sin, head_dim=hd,
                                  eps=eps)
                paged_args = dict(page_table=table, write_pos=pos, cos=cos, sin=sin,
                                  pages_bucket=n_p, head_dim=hd, eps=eps)
                got = tp.attn_decode_tp(x, local, *caches[0], layer, **dense_args)
                gotp = ptp.attn_decode_paged_tp(x, local, *pools[0], layer, **paged_args)
                post = (layers["post_norm"][layer], eps)  # in the gate/up GEMV's prologue
                gotm = dm.mlp_decode_fused(y2, local["mlp"], layer, out_dtype=torch.float32,
                                           norm=post)
                for name, part in (("attn_decode_tp", got[0]), ("attn_decode_paged_tp", gotp[0]),
                                   ("mlp_decode_fused", gotm)):
                    sums[name] = part if r == 0 else sums[name] + part
                if not check:
                    continue
                want = tp.attn_decode_tp_reference(x, local, *caches[1], layer, **dense_args)
                wantp = ptp.attn_decode_paged_tp_reference(x, local, *pools[1], layer,
                                                           **paged_args)
                wantm = dm.reference_mlp(y2, local["mlp"], layer, out_dtype=torch.float32,
                                         norm=post)
                sync()
                label = f"m{m} r{r} B{b} Hl{hl}"
                rows = torch.arange(b, device=dev)
                slot = table[rows, pos.long() // ps].long(), pos.long() % ps
                report.case("attn_decode_tp", f"{label} o partial (fp32)", got[0], want[0], 1e-2,
                            floor=0.0)
                report.case("attn_decode_tp", f"{label} k/v new and cache rows",
                            torch.cat([*got[1:], caches[0][0][layer, rows, pos.long()],
                                       caches[0][1][layer, rows, pos.long()]]),
                            torch.cat([*want[1:], caches[1][0][layer, rows, pos.long()],
                                       caches[1][1][layer, rows, pos.long()]]), 1e-2)
                report.case("attn_decode_paged_tp", f"{label} o partial (fp32)", gotp[0],
                            wantp[0], 1e-2, floor=0.0)
                report.case("attn_decode_paged_tp", f"{label} k/v new and pool slots",
                            torch.cat([*gotp[1:], pools[0][0][layer][slot],
                                       pools[0][1][layer][slot]]),
                            torch.cat([*wantp[1:], pools[1][0][layer][slot],
                                       pools[1][1][layer][slot]]), 1e-2)
                report.case("mlp_decode_fused", f"m{m} r{r} B{b} I/m {il} down partial (fp32)",
                            gotm, wantm, 1e-2, floor=0.0)
                if b == 1 and r == 0 and m in (1, 8):
                    qkv, o = local["attn"]["qkv"], local["attn"]["o"]
                    gu, dn = local["mlp"]["gateup"], local["mlp"]["down"]
                    w_attn = (nbytes(x, layers["input_norm"][layer], qkv["w8"][layer],
                                     qkv["s"][layer], o["w8"][layer], o["s"][layer], cos, sin,
                                     pos, got[0], *got[1:])
                              + 2 * n_keys * hd * 2  # the keys and values this call needs
                              + 2 * b * hd * 2)  # the fresh K/V rows written into the cache
                    f_attn = (2 * b * kdim * (hl + 2) * hd + 4 * hd * hl * n_keys
                              + 2 * b * hl * hd * kdim)
                    report.time("attn_decode_tp", label,
                                lambda: tp.attn_decode_tp(x, local, *caches[0], layer,
                                                          **dense_args),
                                lambda: tp.attn_decode_tp_reference(x, local, *caches[1], layer,
                                                                    **dense_args),
                                flops=f_attn, n_bytes=w_attn + nbytes(valid))
                    report.time("attn_decode_paged_tp", label,
                                lambda: ptp.attn_decode_paged_tp(x, local, *pools[0], layer,
                                                                 **paged_args),
                                lambda: ptp.attn_decode_paged_tp_reference(x, local, *pools[1],
                                                                           layer, **paged_args),
                                flops=f_attn, n_bytes=w_attn + nbytes(table))
                    report.time("mlp_decode_fused", f"m{m} r{r} B{b} I/m {il}",
                                lambda: dm.mlp_decode_fused(y2, local["mlp"], layer,
                                                            out_dtype=torch.float32, norm=post),
                                lambda: dm.reference_mlp(y2, local["mlp"], layer,
                                                         out_dtype=torch.float32, norm=post),
                                flops=2 * b * kdim * 2 * il + 2 * b * il * kdim,
                                n_bytes=nbytes(y2, post[0], gu["w8"][layer], gu["s"][layer],
                                               dn["w8"][layer], dn["s"][layer], gotm))
                    # rows 5, 6, 8 of PERF.md: the chains' device time per call
                    device_times(label, [
                        ("attn_decode_tp", lambda: tp.attn_decode_tp(x, local, *caches[0], layer,
                                                                     **dense_args)),
                        ("attn_decode_paged_tp", lambda: ptp.attn_decode_paged_tp(
                            x, local, *pools[0], layer, **paged_args)),
                        ("mlp_decode_fused", lambda: dm.mlp_decode_fused(
                            y2, local["mlp"], layer, out_dtype=torch.float32, norm=post))])
                del local, caches, pools
            for name, part in sums.items():
                if m == 1:
                    unsharded[name] = part.to(torch.bfloat16)
                else:
                    report.case(name, f"m{m} B{b} sum of {m} fp32 partials, cast, vs m1",
                                part.to(torch.bfloat16), unsharded[name], 1e-2, floor=0.0)
        # the unsharded MLP on one card: the bf16 epilogue of the same chain
        one = dm.mlp_decode_fused(y2, layers["mlp"], layer,
                                  norm=(layers["post_norm"][layer], eps))
        sync()
        if not torch.equal(one, unsharded["mlp_decode_fused"]):
            raise AssertionError("mlp_decode_fused: the fp32 partial at m=1, cast, differs "
                                 "from the bf16 epilogue's bits")
        print(f"  {'mlp_decode_fused':20s} {f'B{b} m1 fp32 partial, cast == bf16 output':44s} "
              f"torch.equal True  ok", flush=True)
        del kc, vc, kp, vp

    print("kernels: int8_gemv on one rank's shard (m = 2, 8)", flush=True)
    for m in (2, 8):
        for name, k, n, kw in ((f"qkv m{m}", kdim, (heads // m + 2) * hd, {}),
                               (f"gateup m{m}", kdim, 2 * inter // m, {"geglu": True})):
            w = int8(k, n)
            for b in (1, 8):
                x = bf(b, k)
                got = gv.int8_gemv(x, w["w8"], w["s"], **kw)
                again = gv.int8_gemv(x, w["w8"], w["s"], **kw)
                sync()
                report.case("int8_gemv", f"{name} B{b} {k}->{n}", got,
                            gv.int8_gemv_reference(x, w["w8"], w["s"], **kw), 1e-2)
                if not torch.equal(got, again):
                    raise AssertionError(f"int8_gemv {name}: a second call gave other bits")
            del w

    print("kernels: int8_gemv_f32 (the fp32-partial epilogue)", flush=True)
    for name, k, n in (("o rows m1", heads * hd, kdim), ("o rows m8", hd, kdim),
                       ("down rows m1", inter, kdim), ("down rows m8", inter // 8, kdim)):
        w = int8(k, n)
        for b in (1, 8):
            x = bf(b, k)
            got = gv.int8_gemv_f32(x, w["w8"], w["s"])
            want = gv.int8_gemv_reference(x, w["w8"], w["s"], out_fp32=True)
            bits = gv.int8_gemv(x, w["w8"], w["s"])
            sync()
            label = f"{name} B{b} {k}->{n}"
            report.case("int8_gemv_f32", label, got, want, 1e-2, floor=0.0)
            if got.dtype != torch.float32 or not torch.equal(got.to(torch.bfloat16), bits):
                raise AssertionError(f"int8_gemv_f32 {label}: cast differs from int8_gemv's bits")
            if b == 1 and name.startswith("down"):
                report.time("int8_gemv_f32", label,
                            lambda: gv.int8_gemv_f32(x, w["w8"], w["s"]),
                            lambda: gv.int8_gemv_reference(x, w["w8"], w["s"], out_fp32=True),
                            flops=2 * b * k * n, n_bytes=nbytes(x, w["w8"], w["s"], got))
                # the same GEMV with the bf16 epilogue, timed in turns with it
                f32_ms, bf16_ms = timed_pair(lambda: gv.int8_gemv_f32(x, w["w8"], w["s"]),
                                             lambda: gv.int8_gemv(x, w["w8"], w["s"]), 20)
                print(f"  {'int8_gemv_f32':20s} {label:44s} fp32 out {f32_ms:.4f} ms, bf16 "
                      f"out {bf16_ms:.4f} ms (int8_gemv, not in the JSON)", flush=True)
        del w
    print(f"  {'int8_gemv_f32':20s} {'cast of the fp32 partial == int8_gemv bits':44s} ok",
          flush=True)
    k1_cases(report, dev, int8, bf)
    del layers

    print("kernels: head_argmax over vocab shards, combined across ranks", flush=True)
    head = int8(kdim, vocab)
    w8, s = head["w8"], head["s"]

    def combine(y, m, bits=False):
        """The vocab-shard argmax of m ranks; with ``bits`` each shard's id
        and logit must equal argmax of its int8_gemv logits bit for bit
        (the shard's vocab is padded to the tile, the logits' is not)."""
        vl = vocab // m
        mx, ids = [], []
        for r in range(m):
            shard = {"w8": w8[:, r * vl:(r + 1) * vl].contiguous(),
                     "s": s[r * vl:(r + 1) * vl].contiguous()}
            i, v = dh.head_argmax_fused(y, dh.repack_head(shard), return_max=True)
            if bits:
                logits = gv.int8_gemv(y, shard["w8"], shard["s"]).float()
                if not (torch.equal(i.long(), logits.argmax(-1))
                        and torch.equal(v, logits.max(-1).values)):
                    raise AssertionError(f"head_argmax: shard {r} of {m} differs from argmax "
                                         "of its int8_gemv logits")
            ids.append(i + r * vl)
            mx.append(v)
        return tp.pick_first_max(torch.stack(mx), torch.stack(ids))

    y = bf(8, kdim)
    plain = ((y.float() @ w8.float()) * s).to(torch.bfloat16).float()
    for m in TP_SIZES[1:]:
        ids = combine(y, m, bits=True)
        sync()
        report.case("head_argmax", f"m{m} combined shards B8, winning logit vs plain max",
                    plain.gather(1, ids.long()[:, None])[:, 0], plain.max(-1).values, 1e-2)
    print(f"  {'head_argmax':20s} {'each shard == argmax of its int8_gemv logits':44s} "
          f"torch.equal True  ok", flush=True)
    y = bf(1, kdim)
    j0, dup = 1000, vocab - 1000  # in shard 0 and in shard m-1 for every m
    w8[:, j0] = torch.where(y[0] > 0, 127, -127).to(torch.int8)
    w8[:, dup] = w8[:, j0]
    s[j0] = s[dup] = 1.0
    for m in TP_SIZES[1:]:
        tie = int(combine(y, m)[0])
        print(f"  {'head_argmax':20s} {f'm{m} tie planted at {(j0, dup)}':44s} -> id {tie}  "
              f"{'ok' if tie == j0 else 'FAIL'}", flush=True)
        if tie != j0:
            raise AssertionError(f"vocab-shard combine: planted tie resolved to {tie}, not {j0}")
    del head, w8, s


def k1_cases(report: KernelReport, dev, int8, bf):
    """K1 (int8_gemv_f32_lora): a tensor-parallel rank's o or down partial
    with the multilora phase's bank (LORA_NAMES adapters and the base row,
    rank LORA_RANK, fp32) at the 3B shard shapes, m = 1 and 2, B 1 and 8:
    each half against the plain version on the same basis z (the base half
    within 1e-2, the delta half within 1e-3 of its largest element: the
    same products in another fp32 order) and a second call's bits; the
    ranks' partials summed and added as decode_layer_tp.add_partial adds
    them, against the one-card residual epilogue with the expand: the same
    bits at m = 1, within K1_SUM_TOL at m = 2 (each rank rounds its z_r).
    Then K1's time at B8 on rank 0 of m = 2, beside cuBLAS's x_r @ A_r and
    z @ B (bf16; no single PyTorch call computes K1's function)."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    kdim, heads, hd, inter = (TP_LAYER[k] for k in ("hidden", "heads", "head_dim", "inter"))
    gcols = (len(LORA_NAMES) + 1) * LORA_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    print(f"kernels: int8_gemv_f32_lora (K1: the fp32 partial with the LoRA expand; bank of "
          f"{len(LORA_NAMES) + 1} rows, rank {LORA_RANK}, G {gcols})", flush=True)
    for name, k_full in (("o", heads * hd), ("down", inter)):
        w = int8(k_full, kdim)
        a = torch.randn(k_full, gcols, generator=gen, device=dev) * k_full**-0.5
        lb = torch.randn(gcols, kdim, generator=gen, device=dev) * LORA_B_STD
        for b in (1, 8):
            ids = (torch.arange(b, device=dev) % (len(LORA_NAMES) + 1)).to(torch.int32)
            x, h = bf(b, k_full, scale=0.5), bf(b, kdim)
            z1 = kl.lora_shrink(x, a, ids, LORA_RANK, gcols)
            one = gv.int8_gemv(x, w["w8"], w["s"], residual=h, lora=(z1, lb, ()))
            for m in (1, 2):
                total = None
                for r in range(m):
                    rows = slice(r * k_full // m, (r + 1) * k_full // m)
                    xr = x[:, rows].contiguous()
                    wr, ar = w["w8"][rows].contiguous(), a[rows].contiguous()
                    zr = kl.lora_shrink(xr, ar, ids, LORA_RANK, gcols)
                    got = gv.int8_gemv_f32(xr, wr, w["s"], lora=(zr, lb, ()))
                    again = gv.int8_gemv_f32(xr, wr, w["s"], lora=(zr, lb, ()))
                    want = gv.int8_gemv_reference(xr, wr, w["s"], out_fp32=True,
                                                  lora=(zr, lb, ()))
                    sync()
                    label = f"{name} m{m} r{r} B{b} K{xr.shape[1]}->{kdim}"
                    report.case("int8_gemv_f32_lora", f"{label} base half", got[:, :kdim],
                                want[:, :kdim], 1e-2, floor=0.0)
                    report.case("int8_gemv_f32_lora", f"{label} delta half", got[:, kdim:],
                                want[:, kdim:], 1e-3, floor=0.0)
                    if got.shape != (b, 2 * kdim) or not torch.equal(got, again):
                        raise AssertionError(f"int8_gemv_f32_lora {label}: shape "
                                             f"{tuple(got.shape)} or a second call's bits")
                    total = got if total is None else total + got
                    if b == 8 and m == 2 and r == 0:
                        k1_timed(report, label, xr, wr, w["s"], ar, zr, lb, ids, got)
                summed = (h + total[:, :kdim].to(h.dtype)) + total[:, kdim:].to(h.dtype)
                if m == 1:
                    same = torch.equal(summed, one)
                    print(f"  {'int8_gemv_f32_lora':20s} {f'{name} m1 B{b} added == one card':44s}"
                          f" torch.equal {same}  {'ok' if same else 'FAIL'}", flush=True)
                    if not same:
                        raise AssertionError(f"K1 {name} B{b}: m=1 is not the one-card "
                                             "residual epilogue with the expand")
                else:  # not K1 against its plain version: not in the JSON's max_abs_err
                    err = float((summed.float() - one.float()).abs().max())
                    tol = K1_SUM_TOL * max(1.0, float(one.float().abs().max()))
                    print(f"  {'int8_gemv_f32_lora':20s} {f'{name} m{m} B{b} sum, added, vs one card':44s}"
                          f" max_abs_err {err:.3e}  tol {tol:.3e}  {'ok' if err <= tol else 'FAIL'}",
                          flush=True)
                    if not err <= tol:
                        raise AssertionError(f"K1 {name} m{m} B{b}: {err} > {tol} against one card")
        del w, a, lb


def k1_timed(report, label, xr, wr, s, ar, zr, lb, ids, got):
    """K1's time (the JSON row) beside the cuBLAS products of its delta."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv

    b, k = xr.shape
    n, g = wr.shape[1], lb.shape[0]
    ar_bf, lb_bf = ar.to(torch.bfloat16), lb.to(torch.bfloat16)
    report.time("int8_gemv_f32_lora", f"{label} G{g}",
                lambda: gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ())),
                lambda: gv.int8_gemv_reference(xr, wr, s, out_fp32=True, lora=(zr, lb, ())),
                flops=2 * b * k * n + 2 * b * g * n, n_bytes=nbytes(xr, wr, s, zr, lb, got))
    xa, zb = cuda_ms(lambda: xr @ ar_bf, 20), cuda_ms(lambda: zr @ lb_bf, 20)
    print(f"  {'int8_gemv_f32_lora':20s} {label:44s} cuBLAS x_r @ A_r {xa:.4f} ms + z @ B "
          f"{zb:.4f} ms = {xa + zb:.4f} ms (bf16; the delta alone, never called by the port)",
          flush=True)
    device_times(label, [
        ("int8_gemv_f32_lora", lambda: gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ()))),
        ("int8_gemv_f32", lambda: gv.int8_gemv_f32(xr, wr, s)),
        ("x_r @ A_r (cuBLAS)", lambda: xr @ ar_bf), ("z @ B (cuBLAS)", lambda: zr @ lb_bf)])


def int4_library_pack(w4p, s4):
    """The same int4 weights in the form torch._weight_int4pack_mm takes
    (a yardstick for B9; the port never calls it): the values q + 8 in
    tinygemm's (N, K/2) byte layout through torch._convert_weight_to_int4pack,
    the per-column scale repeated for every 128-row group in bf16, zero
    points 0. Returns x -> the product; raises RuntimeError where this build
    refuses the form."""
    from paligemma_tpu_torch.kernels.ablation import quant4 as q4

    q = q4._unpack(w4p)  # (K, N), -8..7
    k, n = q.shape
    u = (q + 8).t().contiguous().to(torch.uint8)
    packed = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).contiguous(), 8)
    sz = torch.zeros((k // 128, n, 2), dtype=torch.bfloat16, device=w4p.device)
    sz[:, :, 0] = s4.to(torch.bfloat16)
    return lambda x: torch._weight_int4pack_mm(x, packed, 128, sz)


def int4_library_call(w4p, s4, label):
    """:func:`int4_library_pack` with its error against the plain version
    printed; None, with the reason printed, where this build refuses the
    form."""
    from paligemma_tpu_torch.kernels.ablation import quant4 as q4

    try:
        call = int4_library_pack(w4p, s4)
        x = torch.randn(1, w4p.shape[0] * 2, device=w4p.device).to(torch.bfloat16)
        err = float((call(x).float() - q4.int4_matmul_reference(x, w4p, s4).float()).abs().max())
        print(f"  {'int4_matmul':20s} {label + ' _weight_int4pack_mm form':44s} max_abs_err vs "
              f"plain {err:.3e} (bf16 scales)", flush=True)
        return call
    except RuntimeError as e:
        print(f"  {'int4_matmul':20s} {label:44s} torch._weight_int4pack_mm refused: "
              f"{str(e).splitlines()[0][:160]}", flush=True)
        return None


def _cycling(fns):
    """A call that runs the next of ``fns`` each time (cold weights: each
    fn reads its own copy)."""
    at = [0]

    def run():
        at[0] = (at[0] + 1) % len(fns)
        return fns[at[0]]()
    return run


def wq_device_times(dev, label="", kinds=("int4", "int8")):
    """Device time per call (torch.profiler, :func:`device_ms`) of B9
    (int4_matmul at INT4_ROWS) and B11 (int8_matmul, int8_matmul_nmajor at
    INT8_ROWS) at Gemma-2B's four projections, with the weights cold as in a
    decode step (each call takes the next of enough copies to pass 60 MB),
    beside the bound and the library call on the same weights
    (torch._weight_int4pack_mm, torch._weight_int8pack_mm; never called by
    the port); per projection and summed over one layer's four. At M >= 266
    also cuBLAS's ``x @ w_bf16`` on the weights dequantized and scaled
    beforehand: a different function (it reads twice the int8 weight bytes,
    four times the int4), the yardstick of dequantizing ahead of time, never
    called by the port. Returns {(kernel, M): (kernel ms, library ms, bound
    ms, cuBLAS ms)} (None where not measured). ``label`` tags the lines
    (tools/gemv_times.py runs this on other trees)."""
    from paligemma_tpu_torch.kernels.ablation import quant4 as q4
    from paligemma_tpu_torch.kernels.ablation import quant_pallas as qp

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    tag = f"[{label}] " if label else ""
    print(f"kernels: {tag}int4_matmul / int8_matmul device time, weights cold", flush=True)
    sums = {}

    def add(key, vals):
        acc = sums.setdefault(key, [0.0, 0.0, 0.0, 0.0])
        for i, v in enumerate(vals):
            acc[i] = None if v is None or acc[i] is None else acc[i] + v

    def ms_of(fns, calls):
        return device_ms(_cycling(fns), calls)[0]

    def txt(v):
        return "not measured" if v is None else f"{v * 1e3:.2f} us"

    def cublas_fns(wqs, m, k):
        """x @ w_bf16 over the dequantized copies (M >= 266), else None."""
        if m < 266:
            return None
        x = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
        return [lambda w=w: x @ w for w in wqs]

    for name, k, n in PROJECTIONS:
        runs = []  # (kernel, M, kernel fns, library fns, weight bytes, scale bytes, cuBLAS fns)
        if "int4" in kinds:
            copies = max(4, -(-60_000_000 // (k * n // 2)))
            w4s = [torch.randint(-128, 128, (k // 2, n), generator=g, device=dev,
                                 dtype=torch.int8) for _ in range(copies)]
            s4 = (torch.rand(n, generator=g, device=dev) + 0.5) / (7.0 * k**0.5)
            try:
                libs = [int4_library_pack(w, s4) for w in w4s]
            except RuntimeError:
                libs = None
            w4bf = [q4.dequantize_int4({"w4p": w, "s": s4}, torch.bfloat16)
                    for w in w4s[:max(4, -(-60_000_000 // (2 * k * n)))]]
            for m in INT4_ROWS:
                x = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
                runs.append(("int4_matmul", m, [lambda w=w, x=x: q4.int4_matmul(x, w, s4)
                                                for w in w4s],
                             None if libs is None else [lambda c=c, x=x: c(x) for c in libs],
                             k * n // 2, 4 * n, cublas_fns(w4bf, m, k)))
        if "int8" in kinds:
            copies = max(4, -(-60_000_000 // (k * n)))
            w8s = [torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
                   for _ in range(copies)]
            w8ts = [w.t().contiguous() for w in w8s]
            s8 = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
            s8_bf = s8.to(torch.bfloat16)
            w8bf = [(w.float() * s8).to(torch.bfloat16)
                    for w in w8s[:max(4, -(-60_000_000 // (2 * k * n)))]]
            for m in INT8_ROWS:
                x = (torch.randn(m, k, generator=g, device=dev)).to(torch.bfloat16)
                lib = [lambda w=w, x=x: torch._weight_int8pack_mm(x, w, s8_bf) for w in w8ts]
                cub = cublas_fns(w8bf, m, k)
                runs.append(("int8_matmul", m, [lambda w=w, x=x: qp.int8_matmul(x, w, s8)
                                                for w in w8s], lib, k * n, 4 * n, cub))
                runs.append(("int8_matmul_nmajor", m,
                             [lambda w=w, x=x: qp.int8_matmul_nmajor(x, w, s8) for w in w8ts],
                             lib, k * n, 4 * n, cub))
        cublas = {}  # one cuBLAS time per (M, weights' kind): the same function for both layouts
        for kname, m, kern, lib, w_bytes, s_bytes, cub in runs:
            calls = 2 * len(kern)
            k_ms = ms_of(kern, calls)
            l_ms = None if lib is None else ms_of(lib, calls)
            c_key = (m, kname == "int4_matmul")
            if cub is not None and c_key not in cublas:
                cublas[c_key] = ms_of(cub, 2 * len(cub))
            c_ms = cublas.get(c_key)
            b_ms = bound_ms(2 * m * k * n, w_bytes + s_bytes + 2 * m * k + 2 * m * n)
            add((kname, m), (k_ms, l_ms, b_ms, c_ms))
            print(f"  device {tag}{kname:20s} {name} M{m} {k}->{n}: {txt(k_ms)}  bound "
                  f"{b_ms * 1e3:.2f} us  library {txt(l_ms)}"
                  + ("" if cub is None else f"  cuBLAS x @ w_bf16 (dequantized beforehand, "
                                            f"another function) {txt(c_ms)}"), flush=True)
        del runs
    for (kname, m), (k_ms, l_ms, b_ms, c_ms) in sums.items():
        print(f"  device {tag}{kname:20s} one layer, {len(PROJECTIONS)} projections, M{m}: "
              f"{txt(k_ms)}  bound {b_ms * 1e3:.2f} us  library {txt(l_ms)}"
              + (f"  cuBLAS x @ w_bf16 {txt(c_ms)}" if m >= 266 else ""), flush=True)
    return {key: tuple(v) for key, v in sums.items()}


def ablation_phase(report: KernelReport, dev, card):
    """The ablation shelf's kernels (kernels/ablation: B12 vision_attention,
    B10 the length-aware decode attention, B9 int4_matmul, B11 int8_matmul
    and int8_matmul_nmajor) against their plain versions at PaliGemma-3B's
    widths, timed beside one PyTorch call where one computes the same
    function; then their counted runs through their own entry points:
    siglip.encode(attn="fused") on the 224, 448 and 896 px towers (27 layers,
    random bf16 weights; exactly one B12 launch per layer, features held
    against attn="xla"), and one call per decode case, projection and row
    count. Returns the counted runs' launches."""
    from paligemma_tpu_torch import kernels, paligemma_3b_224, paligemma_3b_448
    from paligemma_tpu_torch.core.config import paligemma_3b_896
    from paligemma_tpu_torch.convert import init_vision_params
    from paligemma_tpu_torch.kernels.ablation import decode_attention as sda
    from paligemma_tpu_torch.kernels.ablation import quant4 as q4
    from paligemma_tpu_torch.kernels.ablation import quant_pallas as qp
    from paligemma_tpu_torch.kernels.ablation import vision_attention as va
    from paligemma_tpu_torch.models import siglip

    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def bf(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    from paligemma_tpu_torch.kernels import _build
    from paligemma_tpu_torch.kernels import flash_attention as fa

    print("kernels: vision_attention (B12; SigLIP-So400m H16 D72)", flush=True)
    for label, s in (("224px B1 S256 H16 D72", 256), ("448px B1 S1024 H16 D72", 1024),
                     ("896px B1 S4096 H16 D72", 4096)):
        q, k, v = bf(1, s, 16, 72), bf(1, s, 16, 72), bf(1, s, 16, 72)
        got = va.vision_attention(q, k, v)
        want = va.vision_attention_reference(q, k, v, 72**-0.5)
        sync()
        report.case("vision_attention", label, got, want, 1e-2)
        sdpa = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        flops = 4 * s * s * 72 * 16
        report.time("vision_attention", label, lambda: va.vision_attention(q, k, v),
                    lambda: va.vision_attention_reference(q, k, v, 72**-0.5),
                    flops=flops, n_bytes=nbytes(q, k, v, got),
                    library_fn=lambda: F.scaled_dot_product_attention(*sdpa))
        # device times beside SDPA and the flash forward (B1) on the same
        # inputs, and the host time of the call's three tensor maps
        lens = torch.tensor([s], dtype=torch.int32, device=dev)
        dt = device_times(label, [
            ("vision_attention (B12)", lambda: va.vision_attention(q, k, v)),
            ("flash_attention_fwd (B1)", lambda: fa.flash_attention(q, k, v, lens, lens)),
            ("SDPA", lambda: F.scaled_dot_product_attention(*sdpa))])
        n_maps = 2000
        t0 = time.perf_counter()
        err = _build.library().pg_vision_attention_maps(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, s, 16, 72, va.rows_per_block(1, s, 16),
            n_maps)
        maps_us = (time.perf_counter() - t0) / n_maps * 1e6
        _build.check(err, "pg_vision_attention_maps")
        print(f"  device B12 {label}: " + ", ".join(
            f"{n} {'not measured' if ms is None else f'{ms:.4f} ms'}" for n, ms in dt.items())
            + f"; bound {bound_ms(flops, nbytes(q, k, v, got)):.4f} ms; tensor maps "
            f"{maps_us:.2f} us per call on the host  [{card}]", flush=True)
    # every depth instantiation (64, 80, 128), 64- and 128-row blocks, two
    # batches in one tensor map; a second call gives the same bits
    for b, s, h, d in ((2, 128, 3, 72), (1, 4096, 16, 64), (1, 256, 16, 64),
                       (2, 2048, 8, 128), (1, 256, 4, 128)):
        q, k, v = bf(b, s, h, d), bf(b, s, h, d), bf(b, s, h, d)
        got = va.vision_attention(q, k, v)
        again = va.vision_attention(q, k, v)
        want = va.vision_attention_reference(q, k, v, d**-0.5)
        sync()
        label = f"B{b} S{s} H{h} D{d} ({va.rows_per_block(b, s, h)}-row blocks)"
        report.case("vision_attention", label, got, want, 1e-2)
        if not torch.equal(again, got):
            raise AssertionError(f"vision_attention {label}: a second call gave other bits")

    # rows: contiguous to the cache's end, kv_len at 32-key tile edges (64,
    # 1024), holes (row 3's [256, 640) and the rows past kv_len are whole
    # tiles, so they are never read), a 33-key row
    print("kernels: seg_decode_attention (B10; Gemma-2B cache S_max 2048 D256)", flush=True)
    seg_rows = ([2048, 64, 250, 256, 300, 33, 97, 700], [2048, 64, 266, 640, 300, 33, 1200, 700],
                [2048, 64, 1000, 1024, 300, 33, 1500, 700])
    seg_cases = []
    for b, hq, hkv in ((1, 8, 1), (8, 8, 1), (8, 8, 2), (8, 4, 4)):
        q, kc, vc = bf(b, hq, 256), bf(b, MAX_SEQ, hkv, 256), bf(b, MAX_SEQ, hkv, 256)
        segs = [torch.tensor(r[:b], dtype=torch.int32, device=dev) for r in seg_rows]
        label = f"B{b} Hq{hq} Hkv{hkv} W{MAX_SEQ} D256" + (" holes" if b > 1 else "")
        got = sda.decode_attention(q, kc, vc, *segs)
        want = sda.reference_decode_attention(q, kc, vc, *segs)
        sync()
        report.case("seg_decode_attention", label, got, want, 1e-2)
        seg_cases.append((q, kc, vc, segs))
        col = torch.arange(MAX_SEQ, device=dev)[None]
        n_keys = int(((col < segs[0][:, None]) | ((col >= segs[1][:, None])
                                                  & (col < segs[2][:, None]))).sum())
        if hkv == 1:
            mask = ((col < segs[0][:, None]) | ((col >= segs[1][:, None])
                                               & (col < segs[2][:, None])))[:, None, None]
            sdpa = (q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), mask)
            report.time("seg_decode_attention", label,
                        lambda: sda.decode_attention(q, kc, vc, *segs),
                        lambda: sda.reference_decode_attention(q, kc, vc, *segs),
                        flops=4 * 256 * hq * n_keys,
                        n_bytes=nbytes(q, got, *segs) + 2 * n_keys * hkv * 256 * 2,
                        library_fn=lambda: F.scaled_dot_product_attention(
                            sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3], enable_gqa=True),
                        in_json=b == 1)
        if hkv == 1:
            device_times(label, [
                ("seg_decode_attention", lambda: sda.decode_attention(q, kc, vc, *segs)),
                ("SDPA", lambda: F.scaled_dot_product_attention(
                    sdpa[0], sdpa[1], sdpa[2], attn_mask=sdpa[3], enable_gqa=True))])
        if b == 8 and hkv == 1:  # NaN in the skipped tiles: they are never read
            kp, vp = kc.clone(), vc.clone()
            for t in (kp, vp):
                t[3, 256:640] = float("nan")
                t[1, 64:] = float("nan")
                t[5, 64:] = float("nan")
            poisoned = sda.decode_attention(q, kp, vp, *segs)
            sync()
            same = torch.equal(poisoned, got)
            print(f"  {'seg_decode_attention':20s} {'NaN in the hole and past kv_len':44s} "
                  f"torch.equal {same}  {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise AssertionError("seg_decode_attention read a tile it must skip")
            del kp, vp

    print("kernels: int4_matmul, int8_matmul, int8_matmul_nmajor (B9, B11; Gemma-2B "
          "projections)", flush=True)
    # first one 128-column tile at the least depth (one stage of 64 stored
    # rows; two ranks at N 144): the wgmma tile's descriptors, swizzles and
    # TMA boxes, before the full sizes
    for k, n in ((64, 128), (128, 144)):
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        w4p = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
        sc = torch.rand(n, generator=g, device=dev) + 0.5
        for m in (1, 17, 65):
            x = bf(m, k)
            cases = [("int8_matmul", qp.int8_matmul(x, w8, sc),
                      qp.int8_matmul_reference(x, w8, sc)),
                     ("int8_matmul_nmajor", qp.int8_matmul_nmajor(x, w8.t().contiguous(), sc),
                      qp.int8_matmul_reference(x, w8, sc))]
            if k % 128 == 0:
                cases.append(("int4_matmul", q4.int4_matmul(x, w4p, sc),
                              q4.int4_matmul_reference(x, w4p, sc)))
            sync()
            for kname, got, want in cases:
                report.case(kname, f"one tile M{m} K{k} N{n}", got, want, 1e-2)
    proj, layer_ms = [], {}
    for name, k, n in PROJECTIONS:
        w4p = torch.randint(-128, 128, (k // 2, n), generator=g, device=dev, dtype=torch.int8)
        s4 = (torch.rand(n, generator=g, device=dev) + 0.5) / (7.0 * k**0.5)
        lib4 = int4_library_call(w4p, s4, name)
        w8 = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        w8t = w8.t().contiguous()
        s8 = (torch.rand(n, generator=g, device=dev) + 0.5) / (127.0 * k**0.5)
        s8_bf = s8.to(torch.bfloat16)  # the library call takes x's dtype
        proj.append((name, k, n, w4p, s4, w8, w8t, s8))
        for m in sorted(set(INT4_ROWS + INT8_ROWS)):
            x = bf(m, k)
            label = f"{name} M{m} {k}->{n}"
            calls = []
            if m in INT4_ROWS:
                calls.append(("int4_matmul", lambda: q4.int4_matmul(x, w4p, s4),
                              lambda: q4.int4_matmul_reference(x, w4p, s4), w4p, s4,
                              None if lib4 is None else (lambda: lib4(x))))
            if m in INT8_ROWS:
                lib = lambda: torch._weight_int8pack_mm(x, w8t, s8_bf)  # noqa: E731
                calls += [("int8_matmul", lambda: qp.int8_matmul(x, w8, s8),
                           lambda: qp.int8_matmul_reference(x, w8, s8), w8, s8, lib),
                          ("int8_matmul_nmajor", lambda: qp.int8_matmul_nmajor(x, w8t, s8),
                           lambda: qp.int8_matmul_nmajor_reference(x, w8t, s8), w8t, s8, lib)]
            for kname, kern, plain, w, sc, lib in calls:
                got, want, again = kern(), plain(), kern()
                sync()
                report.case(kname, label, got, want, 1e-2)
                if not torch.equal(again, got):
                    raise AssertionError(f"{kname} {label}: a second call gave other bits")
                if m in (1, 266, 1024):
                    t = report.time(kname, label, kern, plain, flops=2 * m * k * n,
                                    n_bytes=nbytes(x, w, sc, got), library_fn=lib,
                                    in_json=m == 1)
                    acc = layer_ms.setdefault((kname, m), [0.0, 0.0, 0.0, 0.0])
                    for i, v in enumerate(t):
                        acc[i] = None if v is None or acc[i] is None else acc[i] + v
            del x
    for (kname, m), (k_ms, p_ms, lib_ms, b_ms) in layer_ms.items():
        lib_txt = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        label = f"one layer, {len(PROJECTIONS)} projections, M{m}"
        print(f"  {kname:20s} {label:44s} kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
              f"library {lib_txt}  bound {b_ms:.4f} ms", flush=True)
    # B9 at its decode rows (1, 8) and 266 and B11 on the device, weights
    # cold (the back-to-back times above are the host's rate at M1)
    wq_device_times(dev)
    # backward of the autograd wrappers: dx = (g * s) @ w8^T against a plain
    # fp32 product (one projection, training rows)
    name, k, n, _, _, w8, w8t, s8 = proj[0]
    x = bf(1024, k).requires_grad_(True)
    gout = bf(1024, n)
    want = ((gout.float() * s8) @ w8.float().T).to(torch.bfloat16)
    for fn, w in ((qp._int8_matmul_diffable, w8), (qp._int8_matmul_nmajor_diffable, w8t)):
        x.grad = None
        fn(x, w, s8).backward(gout)
        sync()
        report.case("int8_matmul_nmajor" if w is w8t else "int8_matmul",
                    f"{name} M1024 dx (autograd backward)", x.grad, want, 1e-2)
    del x, gout

    # the counted runs: each kernel through its entry point
    towers = {}
    counts = {}
    for label, vcfg in (("224px", paligemma_3b_224().vision_config),
                        ("448px", paligemma_3b_448().vision_config),
                        ("896px", paligemma_3b_896().vision_config)):
        vp = init_vision_params(vcfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                torch.bfloat16)
        px = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
            (1, 3, vcfg.image_size, vcfg.image_size), dtype=np.float32)).to(dev)
        kernels.reset_launch_counts()
        fused = siglip.encode(vp, vcfg, px, attn="fused")
        sync()
        c = kernels.launch_counts()
        want = {k: (vcfg.num_hidden_layers if k == "vision_attention" else 0) for k in c}
        if c != want:
            raise AssertionError(f"siglip.encode(attn='fused') {label}: launches {c}, want {want}")
        counts["vision_attention"] = counts.get("vision_attention", 0) + c["vision_attention"]
        plain = siglip.encode(vp, vcfg, px, attn="xla")
        flash = siglip.encode(vp, vcfg, px, attn="flash")
        sync()
        if fused.shape != (1, vcfg.num_patches, vcfg.hidden_size):
            raise AssertionError(f"tower {label}: features of shape {tuple(fused.shape)}")

        def rel_err(a):
            return float((a.float() - plain.float()).abs().max() / plain.float().abs().max())

        # attn='flash' is gated where the engines take it (>= 2048 patches:
        # the 896 px tower); at 224 / 448 px it is printed
        rel, rel_flash = rel_err(fused), rel_err(flash)
        gate_flash = vcfg.num_patches >= 2048
        ok = (bool(torch.isfinite(fused).all()) and rel <= LOGIT_REL_TOL
              and bool(torch.isfinite(flash).all())
              and (rel_flash <= LOGIT_REL_TOL or not gate_flash))
        print(f"ablation: siglip.encode(attn='fused') {label}: {c['vision_attention']} "
              f"vision_attention launches; features vs attn='xla' max rel err {rel:.3e} "
              f"(tol {LOGIT_REL_TOL}); attn='flash' vs 'xla' {rel_flash:.3e}"
              f"{'' if gate_flash else ', not gated'}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"tower {label}: features off by {rel} (fused), "
                                 f"{rel_flash} (flash)")
        towers[label] = (vp, vcfg, px)

    kernels.reset_launch_counts()
    for q, kc, vc, segs in seg_cases:
        sda.decode_attention(q, kc, vc, *segs)
    for name, k, n, w4p, s4, w8, w8t, s8 in proj:
        for m in INT4_ROWS:
            q4.int4_matmul(bf(m, k), w4p, s4)
        for m in INT8_ROWS:
            x = bf(m, k)
            qp.int8_matmul(x, w8, s8)
            qp.int8_matmul_nmajor(x, w8t, s8)
    sync()
    c = kernels.launch_counts()
    want = {k: 0 for k in c}
    want.update(seg_decode_attention=len(seg_cases), int4_matmul=len(proj) * len(INT4_ROWS),
                int8_matmul=len(proj) * len(INT8_ROWS),
                int8_matmul_nmajor=len(proj) * len(INT8_ROWS))
    print(f"ablation: launches of the entry-point runs: {json.dumps(c)}", flush=True)
    if c != want:
        raise AssertionError(f"ablation entry points: launches {c}, want {want}")
    for k, v in c.items():
        counts[k] = counts.get(k, 0) + v

    # device times (the back-to-back times above are the host's launch rate
    # for the small calls): one call of each kernel at the JSON line's shapes
    qv = [bf(1, s, 16, 72) for s in (256, 1024, 4096) for _ in range(3)]
    q, kc, vc, segs = seg_cases[0]

    xs = {m: [bf(m, k) for _, k, *_ in proj] for m in (1, 266)}

    def wq_round(m):
        for x, (name, k, n, w4p, s4, w8, w8t, s8) in zip(xs[m], proj):
            q4.int4_matmul(x, w4p, s4)
            qp.int8_matmul(x, w8, s8)
            qp.int8_matmul_nmajor(x, w8t, s8)

    def one_each():
        va.vision_attention(*qv[:3])
        va.vision_attention(*qv[3:6])
        va.vision_attention(*qv[6:])
        sda.decode_attention(q, kc, vc, *segs)
        wq_round(1)

    # each B9 / B11 call is one device launch (gated): the rounds at M1 (the
    # GEMV tiles and the 16-row wgmma tile) and at M266 (the wgmma tile)
    for label, fn in (("ablation kernels: B12 S256 + S1024 + S4096, B10 B1 W2048, B9 / B11 x 4 "
                       "projections M1", one_each),
                      ("ablation kernels: B9 / B11 x 4 projections M266", lambda: wq_round(266))):
        fn()
        got = _profile(label, fn, 1, card, top=16, unit="round", check=_wq_events)
        if got is None:
            raise AssertionError(f"profile {label}: no run showed one device launch per B9 / "
                                 f"B11 call")
        print(f"profile: {label}: {sum(k.count for k in got[1] if _is_wq(k.key))} B9 / B11 "
              f"device events, one per call  ok", flush=True)
    del proj, seg_cases, qv

    # the tower with each attention path, timed in turns (after the counts)
    for label, (vp, vcfg, px) in towers.items():
        paths = ("xla", "flash", "fused")
        ms = {a: [] for a in paths}
        for a in paths + paths[::-1]:
            ms[a].append(cuda_ms(lambda: siglip.encode(vp, vcfg, px, attn=a), 5))
        print(f"ablation: tower {label} ({vcfg.num_patches} patches, {vcfg.num_hidden_layers} "
              f"layers) ms per encode: "
              + ", ".join(f"{a} {min(ms[a]):.3f}" for a in paths) + f"  [{card}]", flush=True)
    del towers
    return counts


def make_inputs(cfg, dev):
    rng = np.random.default_rng(SEED)
    n_img = cfg.vision_config.num_patches
    ids = np.concatenate([np.full((1, n_img), cfg.image_token_index),
                          rng.integers(2, min(1000, cfg.image_token_index), (1, N_TEXT))], 1).astype(np.int64)
    px = cfg.vision_config.image_size
    pixels = rng.standard_normal((1, 3, px, px), dtype=np.float32)
    return (torch.from_numpy(pixels).to(dev), torch.from_numpy(ids).to(dev),
            torch.ones((1, ids.shape[1]), dtype=torch.int32, device=dev))


def main_path(dev, card):
    from paligemma_tpu_torch import kernels, paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

    cfg = paligemma_3b_224()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev, torch.bfloat16)
    decode = quantize_lm_for_serving(params)
    sync()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"main: 3B-224 weights (bf16 {n_bytes / 2**30:.2f} GiB) + int8 decode tree in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    eng = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
    if not (eng.use_flash and eng.fused_layer and eng._greedy_head_fused):
        raise AssertionError("kernel engine did not select the kernel paths")
    plain = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                            use_flash=False, fused_layer=False)
    # the one-card fused_mlp route: plain layers, each layer's decode MLP
    # through B7b (kernels/decode_mlp)
    mlp_eng = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                              fused_layer=False, fused_mlp=True)
    pixels, ids, mask = make_inputs(cfg, dev)

    kernels.reset_launch_counts()
    tok1 = eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=1)
    tok16 = eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=16)
    sync()
    counts = kernels.launch_counts()
    print(f"main: launches during generate(sync_every=1) + generate(sync_every=16): "
          f"{json.dumps(counts)}", flush=True)
    if tok1.shape != (1, N_NEW) or not np.array_equal(tok1, tok16):
        raise AssertionError(f"sync_every=1 vs 16 tokens differ:\n{tok1}\n{tok16}")
    print(f"main: sync_every=1 and 16 emit the same {N_NEW} tokens: {tok1[0, :16].tolist()} ...",
          flush=True)
    missing = [k for k in GENERATE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    n_layers = cfg.text_config.num_hidden_layers
    # one final norm a decode step, one qkv GEMV (with the layer's norm and
    # RoPE) a layer and step (the steps: one attention a layer and step)
    steps = counts["decode_attention"] // n_layers
    if counts["rms_norm"] != steps or counts["int8_gemv_rope_kv"] != n_layers * steps:
        raise AssertionError(f"generate: {counts['rms_norm']} rms_norm and "
                             f"{counts['int8_gemv_rope_kv']} int8_gemv_rope_kv launches over "
                             f"{steps} steps of {n_layers} layers")
    kernels.reset_launch_counts()
    tok_mlp = mlp_eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1,
                               sync_every=16)
    sync()
    mlp_counts = kernels.launch_counts()
    print(f"main: launches during generate(fused_mlp=True, fused_layer=False): "
          f"{json.dumps(mlp_counts)}", flush=True)
    if (mlp_counts["mlp_decode_fused"] != n_layers * N_NEW or mlp_counts["decode_attention"]
            or mlp_counts["attn_decode_tp"] or mlp_counts["int8_gemv_f32"]
            or mlp_counts["int8_gemv_rope_kv"] or mlp_counts["rms_norm"]):
        raise AssertionError("fused_mlp: B7b must run once per layer and step, and no "
                             "decode-layer kernel")

    # teacher-force the emitted tokens through the kernel, plain and
    # fused_mlp engines
    lk, sk = eng.prefill(pixels, ids, mask)
    lp, sp = plain.prefill(pixels, ids, mask)
    lm, sm = mlp_eng.prefill(pixels, ids, mask)
    worst, flips = _compare(lk, lp, "prefill", tok1[0, 0])
    worst_m, f = _compare(lk, lm, "fused_mlp prefill", tok1[0, 0])
    ties_m = [0] if f else []
    for t in range(N_NEW - 1):
        tok = torch.from_numpy(tok1[:, t])
        lk, sk = eng.decode_step(tok, sk)
        lp, sp = plain.decode_step(tok, sp)
        lm, sm = mlp_eng.decode_step(tok, sm)
        w, f = _compare(lk, lp, f"decode {t}", tok1[0, t + 1])
        worst, flips = max(worst, w), flips + f
        # fused_mlp's greedy token must be the emitted one unless near a tie
        w, f = _compare(lk, lm, f"fused_mlp decode {t}", tok1[0, t + 1])
        worst_m = max(worst_m, w)
        if f:
            ties_m.append(t + 1)
    sync()
    print(f"main: teacher-forced logits, kernel vs plain path: max rel err {worst:.3e} "
          f"(tol {LOGIT_REL_TOL}) over prefill + {N_NEW - 1} steps; "
          f"near-tie steps skipped in the token check: {flips}", flush=True)
    differ = [t for t in range(N_NEW) if tok_mlp[0, t] != tok1[0, t]]
    print(f"main: fused_mlp vs fused_layer: {N_NEW - len(differ)}/{N_NEW} tokens identical"
          f"{f', first divergence at token {differ[0]}' if differ else ''}; teacher-forced "
          f"logits max rel err {worst_m:.3e} (tol {LOGIT_REL_TOL}); near-tie steps {ties_m}",
          flush=True)
    if differ and differ[0] not in ties_m:
        raise AssertionError(f"fused_mlp tokens diverge from fused_layer's at token {differ[0]}, "
                             "which is no near tie")
    del mlp_eng

    for name, e in (("kernels", eng), ("plain", plain)):
        decode_rate(f"main: {name:7s}", e, pixels, ids, mask, card)
    profile_phase(eng, pixels, ids, mask, card, layers=n_layers)
    return params, decode, cfg, tok1


def decode_step_ms(e, pixels, ids, mask, n=32) -> float:
    """b1 greedy decode ms per step over ``n`` steps of ``decode_chunk``
    after a prefill, CUDA events."""
    logits, state = e.prefill(pixels, ids, mask)
    bucket = e.kv_bucket_for(ids.shape[1] + n)
    e.decode_chunk(logits, state, 4, kv_bucket=bucket)  # warm-up
    logits, state = e.prefill(pixels, ids, mask)
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    e.decode_chunk(logits, state, n, kv_bucket=bucket)
    end.record()
    sync()
    return start.elapsed_time(end) / n


def decode_rate(label, e, pixels, ids, mask, card, n=32):
    """Prints TTFT (prefill incl. vision, the median of 3) and the b1 greedy
    decode rate over ``n`` steps of ``decode_chunk``, CUDA events."""
    ttft = sorted(cuda_ms(lambda: e.prefill(pixels, ids, mask), 1) for _ in range(3))[1]
    step_ms = decode_step_ms(e, pixels, ids, mask, n)
    print(f"{label} TTFT {ttft:.2f} ms  b1 int8 greedy decode {1000.0 / step_ms:.1f} tok/s "
          f"({step_ms:.3f} ms/step)  [{card}]", flush=True)


# ----------------------------------------------------------- W8A8 prefill ----
# rows of the W8A8 kernel cases: one 224 px prompt (256 image + 10 text
# tokens) and a serving wave (8 prompts of 320 rows)
W8A8_ROWS = (266, 2560)
W8A8_TEACHER = 16  # decode steps teacher-forced through both engines
# Single-copy (W8A8) logits against the weight-only int8 engine's on the same
# int8 tree, relative to the largest |logit|: W8A8 rounds each activation to
# half a code (1/254 of its row's amax) before every projection of 18 layers;
# the decode after it is the same kernel path, on the two prefills' caches.
# 1.50e-2 on an NVIDIA H100 80GB HBM3 at 700 W; the tolerance is about 3x that
# reading; a product that dropped or garbled a term is off by O(1).
W8A8_LOGIT_TOL = 5e-2


def _held_bytes(eng) -> int:
    """Bytes of the card tensors an engine's weight trees hold, each storage
    once (the single-copy engine's prefill and decode trees share theirs)."""
    seen = {}
    for t in list(_leaves(eng.params)) + list(_leaves(eng.decode_params)):
        if torch.is_tensor(t) and t.is_cuda:
            seen[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(seen.values())


def w8a8_kernel_cases(report: KernelReport, decode, dev):
    """K1 and K2 against their plain versions, bit for bit, at the four
    projections of Gemma-2B (layer CASE_LAYER's int8 weights) and
    ``W8A8_ROWS`` rows (rows over four decades of scale, row 0 all zero);
    K2's int32 sums too; a second call's bits. Timed (plain, kernel, kernel,
    plain; the M266 rows in the JSON line) beside torch._int_mm on the same
    codes (its (N, K) copy made outside the timed window), then device times
    (torch.profiler) of K2, _int_mm, cuBLAS bf16 on the weights dequantized
    beforehand, and K1."""
    from paligemma_tpu_torch.kernels import w8a8

    layers = decode["lm"]["layers"]
    groups = {"qkv": "attn", "o": "attn", "gateup": "mlp", "down": "mlp"}
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    sums = {}
    for m in W8A8_ROWS:
        for name, k, n in PROJECTIONS:
            w8 = layers[groups[name]][name]["w8"][CASE_LAYER]
            s = layers[groups[name]][name]["s"][CASE_LAYER]
            x = (torch.randn(m, k, generator=g, device=dev)
                 * 10.0 ** (torch.rand(m, 1, generator=g, device=dev) * 4 - 2)).to(torch.bfloat16)
            x[0] = 0
            label = f"{name} M{m} K{k} N{n}"
            x8, a_s = w8a8.w8a8_quant_rows(x)
            r8, rs = w8a8.quant_rows_reference(x)
            report.case("w8a8_quant_rows", f"{label} codes", x8.float(), r8.float(), 0.0)
            report.case("w8a8_quant_rows", f"{label} scales", a_s, rs, 0.0)
            got = w8a8.w8a8_gemm(x8, w8, a_s, s)
            report.case("w8a8_gemm", f"{label} bf16", got, w8a8.gemm_reference(x8, w8, a_s, s),
                        0.0)
            acc = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.int32)
            if not torch.equal(acc, w8a8.int_sums_reference(x8, w8)):
                raise AssertionError(f"w8a8_gemm {label}: int32 sums differ from the exact ones")
            if not (torch.equal(w8a8.w8a8_gemm(x8, w8, a_s, s), got) and (got[0] == 0).all()):
                raise AssertionError(f"w8a8_gemm {label}: a second call's bits differ, or the "
                                     "all-zero row is not 0")
            w_nk = w8.t().contiguous()  # torch._int_mm's layout, outside the timed window
            w_deq = (w8.float() * s).to(torch.bfloat16)
            in_json = m == W8A8_ROWS[0]
            t2 = report.time("w8a8_gemm", label, lambda: w8a8.w8a8_gemm(x8, w8, a_s, s),
                             lambda: w8a8.gemm_reference(x8, w8, a_s, s), 2.0 * m * k * n,
                             nbytes(x8, w8, a_s, s, got),
                             library_fn=lambda: torch._int_mm(x8, w_nk.t()), iters=10,
                             in_json=in_json, peak=PEAK_INT8_OPS)
            t1 = report.time("w8a8_quant_rows", label, lambda: w8a8.w8a8_quant_rows(x),
                             lambda: w8a8.quant_rows_reference(x), 3.0 * m * k,
                             nbytes(x, x8, a_s), iters=10, in_json=in_json,
                             peak=PEAK_FP32_FLOPS)
            dt = device_times(f"{label} (weights warm)", (
                ("w8a8_gemm", lambda: w8a8.w8a8_gemm(x8, w8, a_s, s)),
                ("torch._int_mm", lambda: torch._int_mm(x8, w_nk.t())),
                ("cuBLAS bf16 x @ w_deq", lambda: x @ w_deq),
                ("w8a8_quant_rows", lambda: w8a8.w8a8_quant_rows(x))))
            acc_row = sums.setdefault(m, {})
            for key, v in list(dt.items()) + [("bound", t2[3]), ("K1 bound", t1[3])]:
                acc_row[key] = None if v is None or acc_row.get(key, 0.0) is None else (
                    acc_row.get(key, 0.0) + v)
            del w_nk, w_deq
    for m, row in sums.items():
        print(f"w8a8: one layer's four projections at M{m}, device ms: " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in row.items()),
            flush=True)


def w8a8_phase(report: KernelReport, params, decode, cfg, dev, card, tok_gen):
    """W8A8 prefill (single-copy int8 serving) at full width and depth:

    1. K1 and K2 against their plain versions (:func:`w8a8_kernel_cases`);
    2. the single-copy engine (``params`` = ``decode_params`` = the int8
       tree, ``int8_act_prefill``): one counted generate under
       :class:`_NoPlainInt8` (no fp32 copy of an int8 weight, no plain
       W8A8): 4 K1 and 4 K2 a layer at its prefill, the head's GEMV once;
    3. its prefill and W8A8_TEACHER decode steps teacher-forced beside the
       weight-only int8 engine on the same tree: logits within
       W8A8_LOGIT_TOL, the emitted token wherever the top-2 gap exceeds it;
       its tokens beside the two-copy engine's (printed);
    4. TTFT (the prefill, tower included) of the two-copy and single-copy
       engines in turns, each one's weight bytes and peak allocated memory
       above the resident trees during a generate, and the prefill's device
       time by kernel. Returns the launch counts of step 2."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

    t0 = time.perf_counter()
    w8a8_kernel_cases(report, decode, dev)
    print(f"w8a8: kernel cases done in {time.perf_counter() - t0:.1f} s", flush=True)
    n_layers = cfg.text_config.num_hidden_layers
    single = PaliGemmaEngine(decode, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                             int8_act_prefill=True)
    if not (single.use_flash and single.fused_layer and single._greedy_head_fused):
        raise AssertionError("w8a8: the single-copy engine did not select the kernel paths")
    pixels, ids, mask = make_inputs(cfg, dev)
    kernels.reset_launch_counts()
    with _NoPlainInt8():
        tok = single.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1,
                              sync_every=16)
        sync()
    counts = kernels.launch_counts()
    steps = counts["decode_attention"] // n_layers
    want = {"w8a8_quant_rows": 4 * n_layers, "w8a8_gemm": 4 * n_layers,
            "flash_attention_fwd": n_layers, "int8_gemv_rope_kv": n_layers * steps,
            "int8_gemv": 3 * n_layers * steps + 1, "rms_norm": steps, "head_argmax": steps}
    print(f"w8a8: single-copy generate ({ids.shape[1]} prompt rows, {N_NEW} tokens): launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or not steps:
        raise AssertionError(f"w8a8: launch counts (got, want) off: {bad}")
    agree = int((tok == tok_gen).sum())
    print(f"w8a8: single-copy vs two-copy (bf16 prefill) engine: {agree}/{N_NEW} tokens "
          f"identical: {tok[0, :12].tolist()} ...", flush=True)

    wo = PaliGemmaEngine(decode, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
    ls, ss = single.prefill(pixels, ids, mask)
    lw, sw = wo.prefill(pixels, ids, mask)
    worst, ties = _compare(ls, lw, "w8a8 prefill", tok[0, 0], W8A8_LOGIT_TOL)
    for t in range(W8A8_TEACHER):
        step_tok = torch.from_numpy(tok[:, t])
        ls, ss = single.decode_step(step_tok, ss)
        lw, sw = wo.decode_step(step_tok, sw)
        w, f = _compare(ls, lw, f"w8a8 decode {t}", tok[0, t + 1], W8A8_LOGIT_TOL)
        worst, ties = max(worst, w), ties + f
    sync()
    print(f"w8a8: teacher-forced logits, single-copy vs the weight-only int8 engine on the same "
          f"tree: max rel err {worst:.3e} (tol {W8A8_LOGIT_TOL}) over the prefill + "
          f"{W8A8_TEACHER} steps; near-tie steps {ties}", flush=True)
    del wo, ls, ss, lw, sw

    two = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
    ttft = {"two-copy": [], "single-copy": []}
    for name, e in (("two-copy", two), ("single-copy", single), ("single-copy", single),
                    ("two-copy", two)):
        ttft[name].append(sorted(cuda_ms(lambda: e.prefill(pixels, ids, mask), 1)
                                 for _ in range(3))[1])
    for name, e in (("two-copy", two), ("single-copy", single)):
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        e.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=16)
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        ms, parts = device_ms(lambda: e.prefill(pixels, ids, mask), 3, f"w8a8 {name} prefill")
        top = ", ".join(f"{k[:40]} {us:.1f} us" for k, us in parts[:6])
        print(f"w8a8: {name} engine: TTFT (prefill, tower included, b1 {ids.shape[1]} tokens) "
              f"{' / '.join(f'{v:.2f}' for v in ttft[name])} ms in turns; weights held "
              f"{_held_bytes(e) / 2**30:.3f} GiB; peak allocated above them during a {N_NEW}-token "
              f"generate {peak / 2**30:.3f} GiB; prefill device "
              f"{'not measured' if ms is None else f'{ms:.3f} ms'} ({top})  [{card}]",
              flush=True)
    del two, single
    return counts


# ---------------------------------------------------------------- the CLI ----
CLI_NEW = 32  # greedy tokens of the CLI's caption
CLI_IMAGE = (480, 640)  # the seeded RGB frame's (H, W)
CLI_PROMPTS = ("caption en", "answer en what is in the picture on the left")
# room asked of a directory before the checkpoint is written there, beyond
# the file itself
CLI_DISK_SLACK = 1 << 30


class _StubImage:
    """Stands in for a PIL image (the card's host has no PIL): ``.size``,
    ``.convert("RGB")`` and ``.resize`` over the uint8 (H, W, 3) array
    saved in the "image file" (``np.save``)."""

    def __init__(self, arr):
        self._arr = arr
        self.size = (arr.shape[1], arr.shape[0])

    def convert(self, mode):
        if mode != "RGB":
            raise ValueError(f"stub image: mode {mode}")
        return self._arr

    def resize(self, size, resample=None):
        """An antialiased bicubic resize to ``size`` (W, H) on the CPU,
        rounded back to uint8 (PIL's filter differs in the last bits)."""
        x = torch.from_numpy(self._arr).permute(2, 0, 1)[None].float()
        y = F.interpolate(x, size=(size[1], size[0]), mode="bicubic", antialias=True,
                          align_corners=False)
        return _StubImage(y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy())


class _WordTokenizer:
    """Stands in for ``AutoTokenizer.from_pretrained`` (the card's host has
    no transformers): a whitespace word-level tokenizer with the interface
    the processor and the CLIs use (tests/test_processing.py's
    StubTokenizer). ``<image>`` is the config's image token; every id is
    below the vocabulary. ``decode`` records the rows it is given. Every id
    has a surface text: a word's, or ``w<id>`` for an id no word took, each
    after one space (``decode`` joins them so, and ``convert_ids_to_tokens``
    gives them SentencePiece's way, with U+2581 for the space); ``words``
    take their ids first, so that the ids of later words cannot move."""

    bos_token = "<bos>"
    eos_token_id = 1
    _SPECIAL = ("<pad>", "<eos>", "<bos>", "<image>")

    def __init__(self, image_token_id, vocab_size=None, words=()):
        self.vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "\n": 3, "<image>": image_token_id}
        self._next = 4
        self.decoded = []
        self.vocab_size = vocab_size
        for w in words:
            self._add(w)

    def __len__(self):
        return self.vocab_size if self.vocab_size is not None else len(self.vocab)

    @property
    def all_special_ids(self):
        return [self.vocab[t] for t in self._SPECIAL]

    def _words(self):
        return {v: k for k, v in self.vocab.items()}

    def convert_ids_to_tokens(self, ids):
        words = self._words()
        return ["\u2581" + words.get(int(t), f"w{int(t)}") for t in ids]

    def _add(self, t):
        if t not in self.vocab:
            self.vocab[t] = self._next
            self._next += 1

    def add_special_tokens(self, d):
        for t in d.get("additional_special_tokens", []):
            self._add(t)

    def add_tokens(self, toks):
        for t in toks:
            self._add(t)

    def convert_tokens_to_ids(self, tok):
        return self.vocab[tok]

    def _encode(self, s):
        ids = []
        while s:
            for t in ("<image>", self.bos_token, "\n"):
                if s.startswith(t):
                    ids.append(self.vocab[t])
                    s = s[len(t):]
                    break
            else:
                if s.startswith(" "):
                    s = s[1:]
                    continue
                w = s.split(" ")[0].split("\n")[0].split("<")[0] or s[0]
                self._add(w)
                ids.append(self.vocab[w])
                s = s[len(w):]
        return ids

    def __call__(self, texts, return_tensors="np", truncation=True, padding="longest"):
        seqs = [self._encode(t) for t in texts]
        n = max(len(q) for q in seqs)
        ids = np.zeros((len(seqs), n), np.int64)
        mask = np.zeros((len(seqs), n), np.int64)
        for i, q in enumerate(seqs):
            ids[i, :len(q)], mask[i, :len(q)] = q, 1
        return {"input_ids": ids, "attention_mask": mask}

    def decode(self, row, skip_special_tokens=True):
        row = [int(t) for t in row]
        self.decoded.append(row)
        words = self._words()
        skip = {self.vocab[t] for t in self._SPECIAL} if skip_special_tokens else set()
        return "".join(f" {words.get(t, f'w{t}')}" for t in row if t not in skip)

    def save_pretrained(self, path):
        """Writes the vocabulary, which ``_StandIns``' ``from_pretrained``
        of ``path`` reads back (the same ids for the same words)."""
        with open(os.path.join(path, _WORDS_FILE), "w") as f:
            json.dump({"vocab": self.vocab, "next": self._next}, f)


_WORDS_FILE = "word_tokenizer.json"


class _StandIns:
    """Installs ``PIL.Image.open`` and ``transformers.AutoTokenizer`` stand-ins
    in ``sys.modules`` for the ``with`` block and restores what was there;
    ``tokenizers`` lists every tokenizer handed out (one that
    ``save_pretrained`` wrote under the path comes back with its words)."""

    def __init__(self, image_token_id, vocab_size=None, words=()):
        import types

        self.tokenizers = []
        pil, image, tf = (types.ModuleType(n) for n in ("PIL", "PIL.Image", "transformers"))
        image.open = lambda path: _StubImage(np.load(path))
        image.Resampling = types.SimpleNamespace(BICUBIC="bicubic")
        pil.Image = image

        def from_pretrained(path, **kw):
            tok = _WordTokenizer(image_token_id, vocab_size, words)
            saved = os.path.join(path, _WORDS_FILE)
            if os.path.isfile(saved):
                with open(saved) as f:
                    state = json.load(f)
                tok.vocab, tok._next = state["vocab"], state["next"]
            self.tokenizers.append(tok)
            return tok

        tf.AutoTokenizer = types.SimpleNamespace(from_pretrained=from_pretrained)
        self._mods = {"PIL": pil, "PIL.Image": image, "transformers": tf}
        self._saved = {}

    def __enter__(self):
        self._saved = {k: sys.modules.get(k) for k in self._mods}
        sys.modules.update(self._mods)
        return self

    def __exit__(self, *exc):
        for k, v in self._saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _checkpoint_dir(need_fp32, need_bf16):
    """A directory with room for the checkpoint: the checkout's build/ (git
    ignores it) or the temporary directory. Returns (parent, dtype)."""
    import tempfile

    build = pathlib.Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    cands = [str(build), tempfile.gettempdir()]
    free = {c: shutil.disk_usage(c).free for c in cands}
    print("cli: free bytes " + ", ".join(f"{c}: {f}" for c, f in free.items())
          + f" (the fp32 checkpoint needs {need_fp32}, bf16 {need_bf16})", flush=True)
    for need, dtype in ((need_fp32, torch.float32), (need_bf16, torch.bfloat16)):
        for c in cands:
            if free[c] >= need + CLI_DISK_SLACK:
                if dtype == torch.bfloat16:
                    print(f"cli: no directory has room for the fp32 checkpoint: writing bf16 "
                          f"({need_bf16} bytes) instead", flush=True)
                return c, dtype
    raise AssertionError("cli: no directory has room for the checkpoint, not even in bf16")


def _cli_call(infer, argv, stand_ins):
    """``infer.main(argv)`` with its stdout and stderr captured and the
    launch counts zeroed just before and read just after. Returns (its
    stdout, the timings JSON, counts, wall s, the rows the CLI decoded, the
    text it should have printed for them after "Running inference")."""
    import contextlib
    import io

    from paligemma_tpu_torch import kernels

    out, err = io.StringIO(), io.StringIO()
    n_tok = len(stand_ins.tokenizers)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            infer.main(argv)
    except BaseException:  # SystemExit included: show what the CLI said
        print(f"cli: the CLI failed; its stdout:\n{out.getvalue()}its stderr:\n"
              f"{err.getvalue()}", flush=True)
        raise
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if len(stand_ins.tokenizers) != n_tok + 1:
        raise AssertionError("cli: the CLI did not load one tokenizer")
    timings = json.loads(err.getvalue().split("timings: ", 1)[1].splitlines()[0])
    tok = stand_ins.tokenizers[-1]
    rows = list(tok.decoded)
    prompts = [argv[i + 1] for i, a in enumerate(argv) if a == "--prompt"]
    want = "".join(f"{p}{tok.decode(r)}\n" for p, r in zip(prompts, rows))
    return out.getvalue(), timings, counts, wall, rows, want


def _cli_launches(label, counts, n_layers, greedy):
    """A CLI answer's one prefill: one flash forward a layer; its decode
    steps: one int8_gemv_rope_kv and one attention a layer, one final norm,
    and one head_argmax if greedy (none if sampled)."""
    steps = counts["decode_attention"] // n_layers
    print(f"cli {label}: launches over 1 prefill and {steps} decode steps: "
          f"{json.dumps(counts)}", flush=True)
    want = {"flash_attention_fwd": n_layers, "int8_gemv_rope_kv": n_layers * steps,
            "decode_attention": n_layers * steps, "rms_norm": steps,
            "head_argmax": steps if greedy else 0}
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or not steps:
        raise AssertionError(f"cli {label}: launch counts (got, want) off: {bad}, {steps} steps")


def _timing_line(label, t, wall, card):
    parts = [f"load {t['load_s']:.3f} s"]
    if "quantize_s" in t:
        parts.append(f"quantize {t['quantize_s']:.3f} s")
    parts += [f"preprocess {t['preprocess_ms']:.3f} ms", f"prefill {t['prefill_ms']:.3f} ms",
              f"decode {t['decode_ms']:.3f} ms ({t['tokens']} tokens, "
              f"{t['decode_ms'] / t['tokens']:.3f} ms/token)"]
    print(f"cli {label}: wall {wall:.3f} s per answer: {', '.join(parts)}  [{card}]", flush=True)


def cli_phase(params, decode, cfg, dev, card):
    """The reference job through the port's CLI at full width and depth:
    write ``params`` as an HF checkpoint (fp32 safetensors, as the
    official one ships), load it back bit for bit, caption a seeded image
    greedily with ``--quantize_int8`` (tokens equal to PaliGemmaEngine on
    the in-memory int8 tree ``decode``, native preprocessing), then a
    sampled batch of two, twice (the same text). Returns the launch counts
    summed over the CLI runs, the checkpoint's directory, which the caller
    removes (the serve_cli and cli_tp phases serve from it), and the greedy
    caption's ids."""
    import tempfile

    from paligemma_tpu_torch.checkpoints.hf_export import export_hf_checkpoint
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.cli import infer
    from paligemma_tpu_torch.processing import native
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving

    n_layers = cfg.text_config.num_hidden_layers
    n_el = sum(t.numel() for t in _leaves(params))
    parent, dtype = _checkpoint_dir(4 * n_el, 2 * n_el)
    d = tempfile.mkdtemp(prefix="cli_ckpt_", dir=parent)
    total: dict = {}
    try:
        t0 = time.perf_counter()
        n_bytes = export_hf_checkpoint(cfg, params, d, dtype=dtype)
        secs = time.perf_counter() - t0
        print(f"cli: export_hf_checkpoint of the 3B-224 tree ({n_el} parameters, {n_bytes} "
              f"bytes of {'fp32' if dtype == torch.float32 else 'bf16'} safetensors) in "
              f"{secs:.2f} s ({n_bytes / secs / 1e9:.2f} GB/s into the page cache, not synced) "
              f"under {parent}  [{card}]", flush=True)

        sync()
        t0 = time.perf_counter()
        loaded, lcfg = load_hf_model(d, torch.bfloat16)
        sync()
        secs = time.perf_counter() - t0
        got, want = list(_leaves(loaded)), list(_leaves(params))
        if lcfg != cfg or len(got) != len(want) or not all(
                a.device == b.device and a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want)):
            raise AssertionError("cli: the loaded tree differs from the exported one")
        print(f"cli: load_hf_model to {torch.cuda.get_device_name(0)} in {secs:.2f} s "
              f"({n_bytes / secs / 1e9:.2f} GB/s of file, page cache warm: the file was just "
              f"written): {len(got)} leaves bit-identical to the exported tree  [{card}]",
              flush=True)
        del loaded, got

        rng = np.random.default_rng(SEED + 3)
        img = [os.path.join(d, f"img{i}.npy") for i in range(2)]
        raws = [rng.integers(0, 256, (*CLI_IMAGE, 3), dtype=np.uint8) for _ in img]
        for path, raw in zip(img, raws):
            np.save(path, raw)
        if not native.native_available():
            raise AssertionError("cli: the native preprocessing library did not build")
        for b in (1, 8):
            batch = np.stack([raws[0]] * b)
            native.preprocess_images_native(batch, cfg.vision_config.image_size)
            t0 = time.perf_counter()
            for _ in range(5):
                native.preprocess_images_native(batch, cfg.vision_config.image_size)
            ms = (time.perf_counter() - t0) / 5 * 1e3
            print(f"cli: native preprocessing {CLI_IMAGE[0]}x{CLI_IMAGE[1]} -> "
                  f"{cfg.vision_config.image_size}: {ms / b:.3f} ms per image at batch {b} "
                  f"({min(b, os.cpu_count() or 1)} threads, {os.cpu_count()} cores)  [{card}]",
                  flush=True)
        sync()
        t0 = time.perf_counter()
        quantize_lm_for_serving(params)
        sync()
        print(f"cli: quantize_lm_for_serving of the 3B tree {time.perf_counter() - t0:.3f} s  "
              f"[{card}]", flush=True)

        stand = _StandIns(cfg.image_token_index)
        print("cli: stand-ins in sys.modules for this phase only (the card's host has neither "
              "package): PIL.Image.open (reads the np.save'd frame) and "
              "transformers.AutoTokenizer.from_pretrained (a word-level tokenizer, ids below "
              f"{cfg.vocab_size})", flush=True)
        with stand:
            # greedy caption, int8 decode
            argv = ["--model_path", d, "--image_file_path", img[0], "--prompt", CLI_PROMPTS[0],
                    "--quantize_int8", "--max_tokens_to_generate", str(CLI_NEW)]
            text, t, counts, wall, rows, want = _cli_call(infer, argv, stand)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            _cli_launches("greedy", counts, n_layers, True)
            ids = np.asarray(rows)
            first, rest = text.split("\n", 1)
            if (not first.startswith("Device in use: ")
                    or rest != f"Loading model\nRunning inference\n{want}"):
                raise AssertionError(f"cli greedy: printed {text!r}, want the rows {want!r}")
            proc = PaliGemmaProcessor(_WordTokenizer(cfg.image_token_index),
                                      cfg.vision_config.num_image_tokens,
                                      cfg.vision_config.image_size)
            inputs = proc(images=[_StubImage(raws[0])], text=[CLI_PROMPTS[0]])
            if proc.last_route != "native":
                raise AssertionError(f"cli: pixels took the {proc.last_route} route")
            eng = PaliGemmaEngine(params, cfg, max_seq_len=1024,
                                  eos_token_id=_WordTokenizer.eos_token_id, decode_params=decode)
            ref = eng.generate(inputs["pixel_values"], inputs["input_ids"],
                               inputs["attention_mask"], max_new_tokens=CLI_NEW,
                               sync_every=infer.SYNC_EVERY)
            del eng
            if not np.array_equal(ids, ref) or not (
                    ids.shape[1] == CLI_NEW or ids[0, -1] == _WordTokenizer.eos_token_id):
                raise AssertionError(f"cli greedy: ids {ids.tolist()} != engine {ref.tolist()}")
            print(f"cli greedy: {first!r}, then {want[:60]!r}...; its {ids.shape[1]} ids equal "
                  f"PaliGemmaEngine.generate on the in-memory int8 tree, int for int: "
                  f"{ids[0, :8].tolist()} ...; pixels through the native route", flush=True)
            _timing_line("greedy", t, wall, card)

            # the same caption with --speculative: the greedy ids, every
            # verify on the decode kernels (no plain int8 product)
            with _NoPlainInt8():
                text, t, counts, wall, rows, want = _cli_call(
                    infer, argv + ["--speculative", "--draft_k", str(SPEC_DRAFT_K)], stand)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            verifies = _spec_verifies(t["spec_cycles"], infer.SYNC_EVERY)
            _spec_counts("cli --speculative", counts, verifies, n_layers, prefills=1)
            if not np.array_equal(np.asarray(rows), ids) or not text.endswith(want):
                raise AssertionError(f"cli --speculative: ids {rows} != the greedy CLI's "
                                     f"{ids.tolist()}")
            print(f"cli --speculative: the greedy CLI's {ids.shape[1]} ids in {t['spec_cycles']} "
                  f"cycles ({verifies} verify calls in windows of {infer.SYNC_EVERY}, draft_k "
                  f"{SPEC_DRAFT_K})",
                  flush=True)
            _timing_line("--speculative", t, wall, card)

            # the same caption from one int8 tree (--int8_prefill): the
            # single-copy engine's ids, its prefill's products on K1 + K2
            with _NoPlainInt8():
                text, t, counts, wall, rows, want = _cli_call(infer, argv + ["--int8_prefill"],
                                                              stand)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            _cli_launches("--int8_prefill", counts, n_layers, True)
            if {counts["w8a8_quant_rows"], counts["w8a8_gemm"]} != {4 * n_layers}:
                raise AssertionError(f"cli --int8_prefill: {counts['w8a8_quant_rows']} K1 and "
                                     f"{counts['w8a8_gemm']} K2 launches, want {4 * n_layers}")
            eng = PaliGemmaEngine(decode, cfg, max_seq_len=1024,
                                  eos_token_id=_WordTokenizer.eos_token_id, decode_params=decode,
                                  int8_act_prefill=True)
            ref8 = eng.generate(inputs["pixel_values"], inputs["input_ids"],
                                inputs["attention_mask"], max_new_tokens=CLI_NEW,
                                sync_every=infer.SYNC_EVERY)
            del eng
            if not np.array_equal(np.asarray(rows), ref8) or not text.endswith(want):
                raise AssertionError(f"cli --int8_prefill: ids {rows} != the single-copy "
                                     f"engine's {ref8.tolist()}")
            print(f"cli --int8_prefill: {ref8.shape[1]} ids equal the single-copy engine's on "
                  f"the in-memory int8 tree; {int((ref8 == ids).sum())}/{ids.size} equal the "
                  f"two-copy CLI's", flush=True)
            _timing_line("--int8_prefill", t, wall, card)

            # a sampled batch of two images of one size, prompts of two lengths
            argv = ["--model_path", d, "--quantize_int8", "--max_tokens_to_generate",
                    str(CLI_NEW), "--do_sample", "--seed", "0"]
            for path, prompt in zip(img, CLI_PROMPTS):
                argv += ["--image_file_path", path, "--prompt", prompt]
            runs = []
            for r in range(2):
                text, t, counts, wall, rows, want = _cli_call(infer, argv, stand)
                for k, v in counts.items():
                    total[k] = total.get(k, 0) + v
                _cli_launches(f"sampled run {r}", counts, n_layers, False)
                _timing_line(f"sampled B2 run {r}", t, wall, card)
                printed = text.split("Running inference\n", 1)[1]
                if printed != want or len(rows) != 2:
                    raise AssertionError(f"cli sampled: printed {printed!r}, want {want!r}")
                runs.append((printed, rows))
            if runs[0] != runs[1]:
                raise AssertionError(f"cli sampled: two runs at --seed 0 differ:\n{runs}")
            mask = proc(images=[_StubImage(r) for r in raws], text=list(CLI_PROMPTS))[
                "attention_mask"]
            if not (mask[0].sum() < mask.shape[1] == mask[1].sum()
                    and (np.diff(mask, axis=1) <= 0).all()):
                raise AssertionError(f"cli sampled: the batch is not right-padded: {mask.sum(1)}")
            print(f"cli sampled: two runs at --seed 0 print the same {len(runs[0][1])} rows; "
                  f"prompts of {mask.sum(1).tolist()} tokens, right-padded", flush=True)
    except BaseException:
        shutil.rmtree(d, ignore_errors=True)
        raise
    return total, d, ids[0]


CLI_TP_NEW = 16  # tokens of the tensor-parallel CLI runs
CLI_TP_TIMEOUT = 600  # seconds, the spawn of two ranks that runs both CLIs


def _cli_tp_entry(argv, rank):
    """One rank of the CLIs' ``--model_parallel 2`` (or ``--data_parallel
    2``) runs, both in one spawn of two ranks (cli/ranks): ``argv`` =
    [out_dir, image token id, vocab,
    cli.infer's flags (JSON), cli.serve's flags (JSON), and optionally the
    same at ``--dtype float32`` (JSON, JSON; serve: a batch, no HTTP), run
    after the first two in the same ranks]. First cli.infer's
    rank entry on the cli phase's stand-ins (its tokenizer, so that the
    caption's ids compare with the one-card caption's), then cli.serve's
    rank body on one server in both modes: the batch of ``--requests_jsonl``,
    then HTTP on ``--http`` until one /generate is answered (rank 1 follows
    rank 0's calls), on the serve_cli phase's stand-ins (every id a
    surface, the prompts' words first). Stand-ins are installed here, since
    a spawned process starts without them. Each CLI's stdout and stderr are
    captured; the rank writes them, the caption's ids and the text they
    decode to, its device and backend to ``out_dir``."""
    import contextlib
    import io

    from paligemma_tpu_torch.cli import infer, serve

    out_dir, image_token, vocab = argv[0], int(argv[1]), int(argv[2])
    infer_argv, serve_argv = json.loads(argv[3]), json.loads(argv[4])
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"device": str(rank.device), "backend": rank.backend}

    def captured(what, stand, body):
        out, err = io.StringIO(), io.StringIO()
        try:
            with stand, contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                body()
        finally:
            rec[what] = {"stdout": out.getvalue(), "stderr": err.getvalue()}

    def serve_both():
        args = serve._build_parser().parse_args(serve_argv)
        srv = serve.build_server(args, rank=rank)
        srv.run_batch(args.requests_jsonl)
        if rank.lead:
            srv.serve_http(args.http, max_requests=1)
        else:
            srv.follow()

    def infer_rows(key, argv_i):
        stand = _StandIns(image_token)
        captured(key, stand, lambda: infer._rank_main(argv_i, rank))
        tok = stand.tokenizers[-1]
        rec[key + "_rows"] = list(tok.decoded)
        prompts = [argv_i[i + 1] for i, a in enumerate(argv_i) if a == "--prompt"]
        rec[key + "_want"] = "".join(f"{p}{tok.decode(r)}\n"
                                     for p, r in zip(prompts, rec[key + "_rows"]))

    words = sorted({w for p in SERVE_CLI_PROMPTS for w in p.split()})
    try:
        infer_rows("infer", infer_argv)
        captured("serve", _StandIns(image_token, vocab, words), serve_both)
        if len(argv) > 5:  # the same CLIs at --dtype float32, in the same ranks
            import gc

            gc.collect()
            torch.cuda.empty_cache()
            infer_rows("infer32", json.loads(argv[5]))
            serve32 = json.loads(argv[6])
            captured("serve32", _StandIns(image_token, vocab, words),
                     lambda: serve._rank_main(serve32, rank))
    finally:
        with open(os.path.join(out_dir, f"rank{rank.rank}.json"), "w") as f:
            json.dump(rec, f)


def cli_tp_phase(cfg, card, ckpt, one_card_ids, label="cli_tp", data=1, fp32_ids=None):
    """The CLIs' tensor-parallel mode (``data`` 1: ``--model_parallel 2``)
    or their data axis (``data`` 2: ``--data_parallel 2``, the paged
    engine, two prompts) on the cli phase's checkpoint, in one spawn of two
    ranks that share the card (cli/ranks; gloo: a correctness run, the
    collectives staging through host memory): ``cli.infer --quantize_int8``
    (a greedy caption; with a data axis one row a rank), then one
    ``cli.serve`` server with ``--lora``, ``--grammar`` and
    ``--prefix_cache`` that runs a batch and answers one HTTP request
    (_cli_tp_entry). Gates: exit code 0, both ranks on cuda:0 over gloo,
    rank 1 prints nothing; the caption of the first prompt has the one-card
    caption's length (``one_card_ids``, the cli phase's greedy ids on the
    same checkpoint, image, prompt and tokenizer, cut to CLI_TP_NEW: its
    share of equal ids is printed, not gated, as m = 2 rounds its partial
    sums differently and a batch of two pads the prompt) and rank 0 prints
    exactly its rows, in prompt order; the batch's lines well formed, a
    constrained row in its grammar, the repeat a cache hit; the HTTP answer
    the batch's text for the same request (every rank holds the same
    tokens and seats: the CLIs check it themselves). ``fp32_ids``: the
    fp32 engine's caption ids (fp32_phase); then the same ranks run both
    CLIs again with ``--dtype float32`` (serve: the batch), held to the
    same gates against those ids."""
    import urllib.request

    from paligemma_tpu_torch.checkpoints.local import save_pytree
    from paligemma_tpu_torch.cli import ranks
    from paligemma_tpu_torch.processing import grammar as gr

    work = pathlib.Path(ckpt) / label
    work.mkdir()
    mesh = ["--data_parallel", "2"] if data > 1 else ["--model_parallel", "2"]
    img = [os.path.join(ckpt, f"img{i}.npy") for i in range(2)]
    ad = lora_bank_adapters(cfg, torch.device("cuda", 0), LORA_B_STD)["a"]
    save_pytree(str(work / "lora_a"), {"lora": {"layers": {
        t: {k: v.cpu() for k, v in p.items()} for t, p in ad["layers"].items()}}})
    del ad
    rows = [{"request_id": 0, "prompt": SERVE_CLI_PROMPTS[0], "image": img[0],
             "max_new_tokens": CLI_TP_NEW},
            {"prompt": SERVE_CLI_PROMPTS[1], "image": img[1], "max_new_tokens": CLI_TP_NEW,
             "lora": "a"},
            {"prompt": SERVE_CLI_PROMPTS[0], "image": img[1], "max_new_tokens": CLI_TP_NEW,
             "grammar": "digits"},
            {"prompt": SERVE_CLI_PROMPTS[0], "image": img[0], "max_new_tokens": CLI_TP_NEW}]
    if data > 1:
        # one slot a shard: the repeat is admitted once request 0's entry
        # exists, first of its wave, so it is pinned to the entry's shard
        rows[2], rows[3] = rows[3], rows[2]
    jsonl = work / "reqs.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in rows))
    port = _free_port()
    n_prompts = 2 if data > 1 else 1
    infer_argv = ["--model_path", ckpt, "--quantize_int8", "--max_tokens_to_generate",
                  str(CLI_TP_NEW), *mesh]
    for i in range(n_prompts):
        infer_argv += ["--image_file_path", img[i], "--prompt", CLI_PROMPTS[i]]
    serve_argv = ["--model_path", ckpt, "--quantize_int8", "--max_slots",
                  "2" if data > 1 else "4", "--max_seq_len", "1024", "--sync_every", "8",
                  "--requests_jsonl", str(jsonl), "--http", str(port), "--prefix_cache", "--lora",
                  f"a={work / 'lora_a'}", "--grammar", f"digits={SERVE_CLI_GRAMMARS['digits']}",
                  *mesh, *(["--engine", "paged"] if data > 1 else [])]
    entry_argv = [str(work), str(cfg.image_token_index), str(cfg.vocab_size),
                  json.dumps(infer_argv), json.dumps(serve_argv)]
    if fp32_ids is not None:
        at = serve_argv.index("--http")
        entry_argv += [json.dumps(infer_argv + ["--dtype", "float32"]),
                       json.dumps(serve_argv[:at] + serve_argv[at + 2:] + ["--dtype", "float32"])]
    result = {}

    def launch():
        try:
            ranks.launch(_cli_tp_entry, entry_argv, 2 // data, False, CLI_TP_TIMEOUT,
                         data_parallel=data)
        except BaseException as e:  # SystemExit included: reported by this thread's caller
            result["error"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=launch, daemon=True)
    th.start()
    deadline = time.monotonic() + CLI_TP_TIMEOUT
    body = json.dumps({"prompt": SERVE_CLI_PROMPTS[0], "image": img[0],
                       "max_new_tokens": CLI_TP_NEW}).encode()
    answer = None
    while answer is None and th.is_alive() and time.monotonic() < deadline:
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=SERVE_CLI_HTTP_TIMEOUT) as resp:
                answer = (resp.status, json.loads(resp.read()))
        except (urllib.error.URLError, ConnectionError):
            time.sleep(1.0)
    th.join(CLI_TP_TIMEOUT)
    wall = time.perf_counter() - t0
    recs = [json.loads(p.read_text()) if p.is_file() else {}
            for p in (work / f"rank{r}.json" for r in range(2))]
    if "error" in result or th.is_alive() or answer is None:
        for r, rec in enumerate(recs):
            for what in ("infer", "serve", "infer32", "serve32"):
                if what in rec:
                    print(f"{label} {what}: rank {r}'s stdout:\n{rec[what]['stdout']}stderr:\n"
                          f"{rec[what]['stderr']}", flush=True)
        raise AssertionError(f"{label}: {result.get('error')!r}, HTTP answer {answer}")
    if any(rec["device"] != "cuda:0" or rec["backend"] != "gloo" for rec in recs):
        raise AssertionError(f"{label}: ranks on {[(r['device'], r['backend']) for r in recs]}"
                             ", want cuda:0 over gloo (two ranks share the card)")
    printed = [recs[1][k]["stdout"] for k in ("infer", "serve", "infer32", "serve32")
               if k in recs[1]]
    if any(printed) or (fp32_ids is not None and len(printed) != 4):
        raise AssertionError(f"{label}: rank 1 printed {printed!r}")

    def check_infer(key, one_ids, tag):
        inf = recs[0][key]
        timings = json.loads(inf["stderr"].split("timings: ", 1)[1].splitlines()[0])
        ref = [int(t) for t in one_ids[:CLI_TP_NEW]]
        eos = _WordTokenizer.eos_token_id
        ref = ref[:ref.index(eos) + 1] if eos in ref else ref
        got = recs[0][key + "_rows"]
        first, rest = inf["stdout"].split("\n", 1)
        # a batch of two runs to its longer row (a row past its EOS holds EOS)
        n_tok = timings["tokens"]
        if (len(got) != n_prompts or any(len(r) != n_tok for r in got)
                or not (n_tok == len(ref) if data == 1 else 1 <= n_tok <= CLI_TP_NEW)
                or not first.startswith("Device in use: cuda:0")
                or rest != f"Loading model\nRunning inference\n{recs[0][key + '_want']}"):
            raise AssertionError(f"{label} {tag}: rank 0 printed {inf['stdout']!r} for the ids "
                                 f"{got}, want {n_prompts} row(s) of {n_tok} ids (the one-card "
                                 f"caption's {ref})")
        same = sum(a == b for a, b in zip(got[0], ref))
        print(f"{label}: {tag} {' '.join(mesh)} (two ranks on cuda:0 over gloo): rank 0 printed "
              f"{n_prompts} row(s) in prompt order, the first of {len(got[0])} ids; "
              f"{same}/{len(ref)} ids equal the one-card caption's (printed, not gated: " + (
                  "m = 2 sums its partials in another order)" if data == 1 else
                  "the batch of two pads the prompt)"), flush=True)

    def check_serve(key, tag):
        lines = [json.loads(ln) for ln in recs[0][key]["stdout"].splitlines()]
        if (sorted(g["request_id"] for g in lines) != list(range(len(rows)))
                or not all({"text", "num_tokens", "ttft_ms"} <= set(g) for g in lines)
                or f"served {len(rows)} requests" not in recs[0][key]["stderr"]):
            raise AssertionError(f"{label} {tag}: rank 0 printed {recs[0][key]['stdout']!r}")
        by_id = {g["request_id"]: g for g in lines}
        digits = gr.compile_regex(SERVE_CLI_GRAMMARS["digits"])
        g_row, r_row = (3, 2) if data > 1 else (2, 3)
        if not digits.matches(by_id[g_row]["text"]) or by_id[r_row]["text"] != by_id[0]["text"]:
            raise AssertionError(f"{label} {tag}: the constrained row {by_id[g_row]['text']!r} "
                                 "or the repeat's text")
        return lines, by_id

    check_infer("infer", one_card_ids, "cli.infer --quantize_int8")
    lines, by_id = check_serve("serve", "serve")
    if answer[0] != 200 or answer[1]["text"] != by_id[0]["text"]:
        raise AssertionError(f"{label} serve --http: answered {answer}, want the batch's "
                             f"{by_id[0]['text']!r}")
    engine = " --engine paged" if data > 1 else ""
    print(f"{label}: cli.serve {' '.join(mesh)}{engine} (--lora --grammar --prefix_cache), "
          f"one server: "
          f"the batch's {len(lines)} result lines from rank 0, the constrained row in its "
          f"grammar, the repeat's text the first's; then one /generate over HTTP answered by "
          f"rank 0 with the batch's text, and both ranks shut down with exit code 0; one spawn "
          f"of two ranks for both CLIs, wall {wall:.1f} s (process start and "
          f"{8 if fp32_ids is not None else 4} checkpoint loads included)  [{card}]", flush=True)
    if fp32_ids is not None:
        check_infer("infer32", fp32_ids, "cli.infer --dtype float32 --quantize_int8")
        lines32, _ = check_serve("serve32", "serve --dtype float32")
        print(f"{label}: cli.serve --dtype float32 {' '.join(mesh)}{engine} (--lora --grammar "
              f"--prefix_cache, a batch): the {len(lines32)} result lines from rank 0, the "
              "constrained row in its grammar, the repeat's text the first's (the fp32 forms of "
              f"{'the fp32 partial and K1' if data == 1 else 'the one-card chain, a shard each'}"
              ")", flush=True)
    shutil.rmtree(work, ignore_errors=True)


# the serve_cli phase: 12 requests of these prompts (words without digits,
# so that no prompt word takes the surface of a grammar's token), each with
# a seeded frame of one of three sizes
SERVE_CLI_PROMPTS = (
    "caption en", "describe the scene in detail", "answer en what is on the table",
    "question en how many people are there", "caption es", "ocr",
    "answer en where is the red car parked", "describe en the colors of the sky and the sea",
    "caption en briefly", "answer en is it raining",
    "detect cat", "question en what is the man holding in his left hand")
SERVE_CLI_SHAPES = ((224, 224), (480, 640), (300, 400))
SERVE_CLI_FLAGS = ("--quantize_int8", "--max_slots", str(SERVE["max_slots"]), "--max_seq_len",
                   str(SERVE["max_seq_len"]), "--sync_every", str(SERVE["sync_every"]))
# over the stand-in tokenizer's surfaces (" word" or " w<id>"): "digits"
# takes any run of ids no word took; "choice" is finite and stops its rows
# (every proper prefix of its tokens' texts is the text of a word, so no
# token can leave a row in a state it cannot finish)
SERVE_CLI_GRAMMARS = {"digits": "( w[0-9]+)+", "choice": "( w5000| w5001 w5002)"}
# the grammar of the run that preempts constrained rows: its start state
# allows only " w1..." tokens and every later state only " w2..." ones, so a
# row seated again in the start state would leave the grammar
SERVE_CLI_LEAD = ("lead", " w1[0-9]*( w2[0-9]*)+")
SERVE_CLI_LEAD_BUDGET = 160  # tokens a row: 7 pages of 64 with its ~270-token prompt
SERVE_CLI_LEAD_POOL = 45  # pages: 7 rows seated, short once they reach their 7th page
SERVE_CLI_HTTP_TIMEOUT = 300  # seconds, every client call of the HTTP run


def _serve_cli_rows(d):
    rng = np.random.default_rng(SEED + 5)
    rows = []
    for i, prompt in enumerate(SERVE_CLI_PROMPTS):
        path = os.path.join(d, f"serve_img{i}.npy")
        np.save(path, rng.integers(0, 256, (*SERVE_CLI_SHAPES[i % 3], 3), dtype=np.uint8))
        rows.append({"request_id": i, "prompt": prompt, "image": path,
                     "max_new_tokens": int(rng.integers(16, 49))})
    return rows


def _count_ticks(eng):
    """Counts the engine's ticks from now on, and those that took the argmax
    head: ``[ticks, argmax-head ticks]``. A tick that takes the argmax head
    with a constrained row seated raises."""
    name = "_tick_paged" if hasattr(eng, "paged") else "_tick"
    inner, decide, ticks = getattr(eng, name), eng._head_argmax_tick, [0, 0]

    def counted(*a, **kw):
        ticks[0] += 1
        return inner(*a, **kw)

    def head_tick(with_sampling):
        took = decide(with_sampling)
        if took and any(r is not None and r.grammar is not None for r in eng.slots):
            raise AssertionError("the argmax head was taken with a constrained row seated")
        ticks[1] += took
        return took

    setattr(eng, name, counted)
    eng._head_argmax_tick = head_tick
    return ticks


def _serve_cli_call(serve, argv, stand, label, hook=None):
    """``serve.main(argv)`` (batch mode) with its output captured and the
    launch counts zeroed just before it and read just after; the server it
    builds is kept, its ticks counted and ``run_batch`` timed (``hook``
    sees the engine first). Returns the result lines, each request's ids
    (the rows the CLI decoded), the counts, ticks, the wall of the served
    run and the server."""
    import contextlib
    import io

    from paligemma_tpu_torch import kernels

    made = {}
    build = serve.build_server

    def capture(args, **kw):
        srv = build(args, **kw)
        made["ticks"] = _count_ticks(srv.engine)
        if hook is not None:
            hook(srv.engine)
        run = srv.run_batch

        def timed(path):
            sync()
            t0 = time.perf_counter()
            run(path)
            sync()
            made["wall"] = time.perf_counter() - t0

        srv.run_batch = timed
        made["srv"] = srv
        return srv

    out, err = io.StringIO(), io.StringIO()
    serve.build_server = capture
    kernels.reset_launch_counts()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            serve.main(argv)
    except BaseException:  # SystemExit included: show what the CLI said
        print(f"serve_cli {label}: the CLI failed; its stdout:\n{out.getvalue()}its stderr:\n"
              f"{err.getvalue()}", flush=True)
        raise
    finally:
        serve.build_server = build
    sync()
    counts = kernels.launch_counts()
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.strip()]
    rows = stand.tokenizers[-1].decoded
    if len(rows) != len(lines) or f"served {len(lines)} requests" not in err.getvalue():
        raise AssertionError(f"serve_cli {label}: {len(lines)} result lines, {len(rows)} rows "
                             f"decoded; stderr {err.getvalue()!r}")
    return dict(lines=lines, tokens={ln["request_id"]: r for ln, r in zip(lines, rows)},
                counts=counts, ticks=made["ticks"][0], head_ticks=made["ticks"][1],
                wall=made["wall"], srv=made["srv"])


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else float("nan")


def _serve_cli_line(label, lines, wall, counts, eng, ticks, card):
    n_tok = sum(ln["num_tokens"] for ln in lines)
    ttft = [ln["ttft_ms"] for ln in lines]
    print(f"serve_cli: {label}: {len(lines)} requests, {n_tok} tokens, wall {wall:.3f} s, "
          f"{n_tok / wall:.1f} tok/s aggregate, TTFT p50 {_pct(ttft, 50):.1f} ms p95 "
          f"{_pct(ttft, 95):.1f} ms, prefill calls {eng.prefill_calls}, cache hits "
          f"{eng.cache_hits}, {ticks} ticks, launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}  [{card}]", flush=True)


def _serve_cli_launches(label, counts, ticks, eng, n_layers, head_ticks=None, lora=False):
    """The launches of a served run: one flash forward a layer per prefill
    call; per tick and layer the qkv GEMV with RoPE + KV write and the
    attention (dense or paged) and three more GEMVs, the final norm once a
    tick, and the head: the argmax head kernel on every tick, or, for a run
    with grammars, on the ``head_ticks`` that took it (``_count_ticks``: none
    with a constrained row seated) and the int8 GEMV head on the others,
    which must be some; with a bank 4 LoRA shrinks per layer and tick, none
    without; with ``--int8_prefill`` 4 K1 and 4 K2 a layer and wave and the
    wave's head GEMV."""
    paged = hasattr(eng, "paged")
    attn, other = (("paged_decode_attention", "decode_attention") if paged
                   else ("decode_attention", "paged_decode_attention"))
    argmax = ticks if head_ticks is None else head_ticks
    want = {"flash_attention_fwd": n_layers * eng.prefill_calls, attn: n_layers * ticks,
            "int8_gemv_rope_kv": n_layers * ticks, other: 0, "rms_norm": ticks,
            "int8_gemv": 3 * n_layers * ticks + ticks - argmax, "head_argmax": argmax,
            "lora_shrink": 4 * n_layers * ticks if lora else 0}
    want.update({k: 0 for k in TP_KERNELS + ABLATION_KERNELS + TRAIN_ONLY})
    # --int8_prefill: every wave (256 image tokens and more) is W8A8, and its
    # head the int8 GEMV
    waves = eng.prefill_calls if eng.int8_act_prefill else 0
    want.update(w8a8_quant_rows=4 * n_layers * waves, w8a8_gemm=4 * n_layers * waves)
    want["int8_gemv"] += waves
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or not ticks or argmax == (0 if head_ticks is None else ticks):
        raise AssertionError(f"serve_cli {label}: launch counts (got, want) off: {bad}, "
                             f"{ticks} ticks")


def _tick_compare(srvs, rows, n_layers, card, rounds=6):
    """The dense tick of 8 live rows on each server's engine (``srvs``: name
    -> (server, the grammar its rows take or None)): a window of each is
    first dispatched under sync debug mode "error"; then windows in turns,
    one of each per round (unpipelined, the read-back included), and one
    profiled window of each. Returns {name: (median host ms per tick,
    device busy ms per tick or None)}."""
    for srv, grammar in srvs.values():
        eng = srv.engine
        for row in rows:
            eng.submit(srv._to_request(dict(row, max_new_tokens=256,
                                            **({"grammar": grammar} if grammar else {}))))
        eng.step()
        _window_without_sync(eng)
    times = {name: [] for name in srvs}
    for _ in range(rounds):
        for name, (srv, _) in srvs.items():
            sync()
            t0 = time.perf_counter()
            srv.engine.step()
            sync()
            times[name].append((time.perf_counter() - t0) * 1e3 / srv.engine.sync_every)
    out = {}
    for name, (srv, grammar) in srvs.items():
        # a grammar tick's head is an int8 GEMV, which the layer count would
        # take for a layer's: its launches are gated by _serve_cli_launches
        got = _profile(f"serve_cli {name} dense window B8, {srv.engine.sync_every} ticks",
                       srv.engine.step, srv.engine.sync_every, card, unit="tick",
                       layers=None if grammar else n_layers)
        out[name] = (float(np.median(times[name])), got[0] if got else None)
        for r in [r for r in srv.engine.slots if r is not None]:
            srv.engine.cancel(r.request_id)
    return out


def _serve_cli_http(serve, d, rows, want, n_layers, card):
    """HTTP mode on 127.0.0.1 and a free port: a /cancel of a request held
    in the queue (the engine lock is held while it and its /generate are
    handed over), 8 concurrent /generate calls (batch mode's text), /healthz,
    one stream (its deltas join to batch mode's text), then the server
    stops through ``max_requests``. Every client call has a timeout.
    Returns the launch counts of the 8 calls."""
    import urllib.request

    from paligemma_tpu_torch import kernels

    args = serve._build_parser().parse_args(["--model_path", d, "--http", "0",
                                             *SERVE_CLI_FLAGS])
    srv = serve.build_server(args)
    port = _free_port()
    ready = threading.Event()
    th = threading.Thread(target=srv.serve_http, args=(port,),
                          kwargs={"ready_event": ready, "max_requests": 9}, daemon=True)
    th.start()
    if not ready.wait(SERVE_CLI_HTTP_TIMEOUT):
        raise AssertionError("serve_cli http: the server did not start")
    base = f"http://127.0.0.1:{srv.http_port}"

    def post(path, obj, out):
        req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=SERVE_CLI_HTTP_TIMEOUT) as resp:
            out.append(json.loads(resp.read()))

    def until(cond):
        deadline = time.monotonic() + SERVE_CLI_HTTP_TIMEOUT
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError("serve_cli http: a call was not handed over")
            time.sleep(0.005)

    def joined(threads):
        for t in threads:
            t.join(SERVE_CLI_HTTP_TIMEOUT)
        if any(t.is_alive() for t in threads):
            raise AssertionError("serve_cli http: a client call did not return")

    # a queued request and its cancel, handed over while the engine waits
    victim, cancel = [], []
    with srv.lock:
        a = threading.Thread(target=post, args=("/generate", dict(rows[0], request_id=100),
                                                victim), daemon=True)
        a.start()
        until(lambda: srv.inbox.qsize() == 1)
        c = threading.Thread(target=post, args=("/cancel", {"request_id": 100}, cancel),
                             daemon=True)
        c.start()
        until(lambda: srv.inbox.qsize() == 2)
    joined([a, c])
    if cancel != [{"request_id": 100, "cancelled": True}] or victim != [
            {"request_id": 100, "cancelled": True, "num_tokens": None}]:
        raise AssertionError(f"serve_cli http: cancel {cancel}, its /generate {victim}")

    ticks = _count_ticks(srv.engine)
    kernels.reset_launch_counts()
    replies = [[] for _ in range(8)]
    calls = [threading.Thread(target=post, args=("/generate", rows[i], replies[i]), daemon=True)
             for i in range(8)]
    t0 = time.perf_counter()
    for t in calls:
        t.start()
    joined(calls)
    wall = time.perf_counter() - t0
    sync()
    counts = kernels.launch_counts()
    got = [r[0] for r in replies]
    bad = [i for i, r in enumerate(got) if (r["request_id"], r["text"], r["num_tokens"]) != (
        i, want[i]["text"], want[i]["num_tokens"])]
    if bad:
        raise AssertionError(f"serve_cli http: requests {bad} differ from batch mode")
    _serve_cli_launches("http", counts, ticks[0], srv.engine, n_layers)
    with urllib.request.urlopen(base + "/healthz", timeout=SERVE_CLI_HTTP_TIMEOUT) as resp:
        health = json.loads(resp.read())
    n_tok = sum(r["num_tokens"] for r in got)
    if health != {"ok": True, "served": 8, "served_tokens": n_tok, "pending": 0}:
        raise AssertionError(f"serve_cli http: /healthz {health}")
    engine_ms = max(r["total_ms"] for r in got)
    _serve_cli_line("http, 8 concurrent /generate (client wall)", got, wall, counts,
                    srv.engine, ticks[0], card)
    print(f"serve_cli: http: client wall {wall * 1e3:.1f} ms for 8 concurrent /generate, the "
          f"slowest request's engine-side total {engine_ms:.1f} ms: {wall * 1e3 - engine_ms:.1f} "
          f"ms outside the engine (preprocessing, hand-over, JSON, sockets)  [{card}]",
          flush=True)

    # one stream: its deltas join to batch mode's text
    req = urllib.request.Request(base + "/generate",
                                 data=json.dumps(dict(rows[8], stream=True)).encode(),
                                 headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=SERVE_CLI_HTTP_TIMEOUT) as resp:
        for line in resp:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[len("data: "):]))
    text = "".join(e["text_delta"] for e in events[:-1])
    done = events[-1] if events else {}
    if not (done.get("done") and done["text"] == text == want[8]["text"]
            and done["num_tokens"] == len(events) - 1 == want[8]["num_tokens"]):
        raise AssertionError(f"serve_cli http: the stream's {len(events)} events do not join to "
                             "batch mode's text")
    th.join(SERVE_CLI_HTTP_TIMEOUT)
    if th.is_alive():
        raise AssertionError("serve_cli http: max_requests did not stop the server")
    print(f"serve_cli: http: cancel of a queued request answered cancelled; 8 concurrent "
          f"/generate gave batch mode's texts; /healthz served 8 ({n_tok} tokens); the stream's "
          f"{len(events) - 1} deltas join to its text; the server stopped after "
          f"max_requests=9", flush=True)
    return counts


def serve_cli_phase(params, decode, cfg, dev, card, d):
    """The serving entry point, ``python -m paligemma_tpu_torch.cli.serve``,
    at full width and depth on the checkpoint the cli phase wrote
    (``--quantize_int8``, 8 slots, max_seq_len 1024, sync_every 8), with
    the stand-ins of PIL and transformers, 12 seeded requests:

    1. batch mode, dense and paged: each request's tokens equal a
       ServingEngine's on the in-memory tree for the same requests (so
       dense == paged);
    2. ``--prefix_cache``, paged and dense, the requests twice: the second
       wave's tokens equal the first's; the hits launch no flash forward
       and make no prefill call;
    3. ``--grammar``, dense and paged, constrained greedy and sampled rows
       beside free ones: constrained texts are accepted by the grammar, the
       choices grammar stops its rows, free rows keep run 1's tokens, and
       no tick with a constrained row seated takes the argmax head (the
       int8 GEMV head instead); then a paged pool that preempts rows of
       ``SERVE_CLI_LEAD`` after they emitted tokens: every text stays in
       the grammar;
    4. HTTP mode (``_serve_cli_http``);
    5. ``--lora`` with the multilora phase's adapters saved by
       ``save_pytree``: the tokens of an engine with that bank.

    Returns the launch counts summed over the runs."""
    import gc

    from paligemma_tpu_torch.checkpoints.local import save_pytree
    from paligemma_tpu_torch.cli import serve
    from paligemma_tpu_torch.processing import grammar as gr
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    n_layers = cfg.text_config.num_hidden_layers
    eos = _WordTokenizer.eos_token_id
    words = sorted({w for p in SERVE_CLI_PROMPTS for w in p.split()})
    rows = _serve_cli_rows(d)
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def jsonl(name, rs):
        path = os.path.join(d, name)
        with open(path, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in rs))
        return path

    def argv(path, *extra):
        return ["--model_path", d, "--requests_jsonl", path, *SERVE_CLI_FLAGS, *extra]

    def released(run):
        run.pop("srv", None)
        gc.collect()
        torch.cuda.empty_cache()

    stand = _StandIns(cfg.image_token_index, cfg.vocab_size, words)
    with stand:
        tok = _WordTokenizer(cfg.image_token_index, cfg.vocab_size, words)
        proc = PaliGemmaProcessor(tok, cfg.vision_config.num_image_tokens,
                                  cfg.vision_config.image_size)
        to_req = serve._Server(None, proc, tok, 100)._to_request

        def reference(rs, timed=None, single=False, **kw):
            """A ServingEngine's tokens for the requests of ``rs``; with
            ``timed``, the wall of its run_to_completion and of converting
            the rows (the CLI's preprocessing) go there; ``single``: the
            single-copy engine (the int8 tree alone, W8A8 prefill)."""
            eng = ServingEngine(decode if single else params, cfg, decode_params=decode,
                                int8_act_prefill=single, **SERVE, **kw)
            t0 = time.perf_counter()
            reqs = [to_req(r) for r in rs]
            pre = time.perf_counter() - t0
            for r in reqs:
                eng.submit(r)
            sync()
            t0 = time.perf_counter()
            eng.run_to_completion()
            sync()
            if timed is not None:
                timed.update(run=time.perf_counter() - t0, pre=pre)
            return {r.request_id: list(r.tokens) for r in reqs}

        ref = reference(rows)  # the serving shapes' first calls, off the clock
        engine_time: dict = {}
        if reference(rows, engine_time) != ref:
            raise AssertionError("serve_cli: two ServingEngine runs of the requests differ")

        # 1. batch mode, dense and paged
        path = jsonl("serve_reqs.jsonl", rows)
        runs = {}
        for engine in ("dense", "paged"):
            run = _serve_cli_call(serve, argv(path, "--engine", engine), stand, engine)
            add(run["counts"])
            eng = run["srv"].engine
            if not (eng.fused_decode and eng.use_flash and eng.pipeline) and dev.type == "cuda":
                raise AssertionError(f"serve_cli {engine}: the engine is not on the kernel path")
            _serve_cli_launches(engine, run["counts"], run["ticks"], eng, n_layers)
            differ = [i for i in ref if run["tokens"].get(i) != ref[i]]
            if differ:
                raise AssertionError(f"serve_cli {engine}: requests {differ} differ from the "
                                     "ServingEngine's tokens")
            _serve_cli_line(f"batch {engine}", run["lines"], run["wall"], run["counts"], eng,
                            run["ticks"], card)
            if engine == "dense":
                plain_srv = run.pop("srv")  # kept for the tick comparison of run 3
            runs[engine] = run["lines"]
            released(run)
        # 1b. --int8_prefill (single-copy serving), dense and paged, with no
        # plain int8 product; then dense without and with it, in turns
        ref8 = reference(rows, single=True)
        for engine in ("dense", "paged"):
            label = f"{engine} --int8_prefill"
            with _NoPlainInt8():
                run = _serve_cli_call(serve, argv(path, "--engine", engine, "--int8_prefill"),
                                      stand, label)
            add(run["counts"])
            eng = run["srv"].engine
            if not eng.int8_act_prefill or "w8" not in eng.params["lm"]["layers"]["attn"]["qkv"]:
                raise AssertionError(f"serve_cli {label}: the engine does not prefill W8A8 from "
                                     "the int8 tree")
            _serve_cli_launches(label, run["counts"], run["ticks"], eng, n_layers)
            differ = [i for i in ref8 if run["tokens"].get(i) != ref8[i]]
            if differ:
                raise AssertionError(f"serve_cli {label}: requests {differ} differ from the "
                                     "single-copy ServingEngine's tokens")
            _serve_cli_line(f"batch {label}", run["lines"], run["wall"], run["counts"], eng,
                            run["ticks"], card)
            released(run)
        same = sum(ref8[i] == ref[i] for i in ref)
        print(f"serve_cli: --int8_prefill dense and paged: 12/12 requests with the single-copy "
              f"ServingEngine's tokens; {same}/12 requests with the two-copy engine's",
              flush=True)
        for label, extra in (("dense (in turns)", ()),
                             ("dense --int8_prefill (in turns)", ("--int8_prefill",))):
            with _NoPlainInt8():
                run = _serve_cli_call(serve, argv(path, "--engine", "dense", *extra), stand,
                                      label)
            add(run["counts"])
            _serve_cli_line(f"batch {label}", run["lines"], run["wall"], run["counts"],
                            run["srv"].engine, run["ticks"], card)
            released(run)

        by_id = {ln["request_id"]: ln for ln in runs["dense"]}
        n_ref = sum(map(len, ref.values()))
        print(f"serve_cli: batch dense and paged: 12/12 requests with the ServingEngine's "
              f"tokens ({n_ref} tokens); {ref[0][:6]} ...; the same requests through "
              f"ServingEngine.run_to_completion, no CLI: wall {engine_time['run']:.3f} s, "
              f"{n_ref / engine_time['run']:.1f} tok/s; the CLI's conversion of the 12 rows "
              f"(image file, processor, tokenizer) {engine_time['pre'] * 1e3:.1f} ms  [{card}]",
              flush=True)

        # 2. --prefix_cache, paged and dense: the requests, then the same again:
        # all 12 paged (entries a row holds are not evicted); 8 dense, whose
        # LRU keeps 8 entries (a cycle of 12 through 8 would never hit)
        def twice(rs):
            return rs + [dict(r, request_id=r["request_id"] + N_REQ) for r in rs]

        def spy(eng, hits, prefilled, seat_ms):
            """Which requests hit and which prefilled, and the card time of
            seating a hit and of a prefill wave (synchronized around each)."""
            insert, wave = eng._insert_cached, eng._prefill_wave

            def insert_cached(slot, req):
                sync()
                t0 = time.perf_counter()
                hit = insert(slot, req)
                sync()
                if hit:
                    hits.add(req.request_id)
                    seat_ms["hit"].append((time.perf_counter() - t0) * 1e3)
                return hit

            def prefill_wave(need):
                prefilled.update(req.request_id for _, req in need)
                sync()
                t0 = time.perf_counter()
                out = wave(need)
                sync()
                if need:
                    seat_ms["prefill"].append(((time.perf_counter() - t0) * 1e3, len(need)))
                return out

            eng._insert_cached, eng._prefill_wave = insert_cached, prefill_wave

        for engine in ("paged", "dense"):
            hits, prefilled, seat_ms = set(), set(), {"hit": [], "prefill": []}
            # a pool as large as the dense reservation: entries hold pages too
            pool = ("--n_pages", str(FULL_POOL)) if engine == "paged" else ()
            prows = twice(rows if engine == "paged" else rows[:8])
            run = _serve_cli_call(
                serve, argv(jsonl("serve_twice.jsonl", prows), "--engine", engine,
                            "--prefix_cache", *pool), stand, f"prefix_cache {engine}",
                lambda eng: spy(eng, hits, prefilled, seat_ms))
            add(run["counts"])
            eng = run["srv"].engine
            _serve_cli_launches(f"prefix_cache {engine}", run["counts"], run["ticks"], eng,
                                n_layers)
            toks = run["tokens"]
            differ = [r["request_id"] for r in prows
                      if toks[r["request_id"]] != ref[r["request_id"] % N_REQ]]
            if (differ or not hits or hits & prefilled or eng.cache_hits != len(hits)
                    or len(prefilled) + len(hits) != len(prows)):
                raise AssertionError(f"serve_cli prefix_cache {engine}: requests {differ} "
                                     f"differ; hits {sorted(hits)}, prefilled {sorted(prefilled)}")
            lines = {ln["request_id"]: ln for ln in run["lines"]}
            ttft = {k: [lines[i]["ttft_ms"] for i in ids] for k, ids in (("hit", hits),
                                                                           ("miss", prefilled))}
            waves = seat_ms["prefill"]
            _serve_cli_line(f"prefix_cache {engine}, {len(prows)} requests "
                            f"({len(prows) // 2} twice)", run["lines"],
                            run["wall"], run["counts"], eng, run["ticks"], card)
            how = ("borrowed pages, one tail-page copy" if engine == "paged"
                   else "a copy of the stored KV rows")
            print(f"serve_cli: prefix_cache {engine}: second wave's tokens equal the first's; "
                  f"{len(hits)} hits (ids {sorted(hits)}) seated with no prefill, "
                  f"{len(prefilled)} prefilled in {eng.prefill_calls} calls ({n_layers} flash "
                  f"launches each); TTFT p50 hits {_pct(ttft['hit'], 50):.1f} ms, misses "
                  f"{_pct(ttft['miss'], 50):.1f} ms (both with their wait in the queue: the hits "
                  f"are the later requests); seating a hit {_pct(seat_ms['hit'], 50):.3f} ms p50 "
                  f"({how}) against a prefill wave "
                  f"{sum(w for w, _ in waves) / max(len(waves), 1):.3f} ms mean for "
                  f"{sum(n for _, n in waves) / max(len(waves), 1):.1f} rows  [{card}]",
                  flush=True)
            released(run)

        # 3. --grammar, dense and paged: constrained greedy and sampled rows
        # beside free ones
        kinds = (None, "digits", "digits", "choice")
        grows = []
        for i, r in enumerate(rows):
            g = kinds[i % 4]
            grows.append(dict(r, **({} if g is None else {"grammar": g}),
                              **({"do_sample": True} if i % 4 == 2 else {})))
        gflags = [a for name, pattern in SERVE_CLI_GRAMMARS.items()
                  for a in ("--grammar", f"{name}={pattern}")]
        dfas = {n: gr.compile_regex(p) for n, p in (*SERVE_CLI_GRAMMARS.items(), SERVE_CLI_LEAD)}

        def in_grammar(label, r, toks, text):
            """A constrained row's text is accepted by its grammar, and the
            choices grammar stops its rows."""
            g = r["grammar"]
            if not dfas[g].matches(text):
                raise AssertionError(f"serve_cli {label}: request {r['request_id']}'s text "
                                     f"{text!r} is not accepted by {g}")
            if g == "choice" and not (toks[-1] == eos and len(toks) < r["max_new_tokens"]):
                raise AssertionError(f"serve_cli {label}: the choices grammar did not stop "
                                     f"request {r['request_id']}: {toks}")

        grammar_runs = {}
        for engine in ("dense", "paged"):
            label = f"grammar {engine}"
            run = _serve_cli_call(serve, argv(jsonl("serve_grammar.jsonl", grows), "--engine",
                                              engine, *gflags), stand, label)
            add(run["counts"])
            eng = run["srv"].engine
            _serve_cli_launches(label, run["counts"], run["ticks"], eng, n_layers,
                                head_ticks=run["head_ticks"])
            lines = {ln["request_id"]: ln for ln in run["lines"]}
            for r in grows:
                i, toks = r["request_id"], run["tokens"][r["request_id"]]
                if r.get("grammar") is None:
                    if toks != ref[i]:
                        raise AssertionError(f"serve_cli {label}: free request {i} changed")
                else:
                    in_grammar(label, r, toks, lines[i]["text"])
            _serve_cli_line(label, run["lines"], run["wall"], run["counts"], eng, run["ticks"],
                            card)
            print(f"serve_cli: {label}: " + "; ".join(
                f"{r['request_id']} {r.get('grammar') or 'free'}"
                f"{' sampled' if r.get('do_sample') else ''} "
                f"{lines[r['request_id']]['text'][:40]!r}" for r in grows[:4])
                + f" ...; free rows keep run 1's tokens; {run['head_ticks']} of {run['ticks']} "
                f"ticks (no constrained row seated) took the argmax head", flush=True)
            grammar_runs[engine] = run
        greedy = [r["request_id"] for r in grows if r.get("grammar") and not r.get("do_sample")]
        same = sum(grammar_runs["dense"]["tokens"][i] == grammar_runs["paged"]["tokens"][i]
                   for i in greedy)
        print(f"serve_cli: grammar: constrained greedy rows with the same tokens dense and paged: "
              f"{same}/{len(greedy)} (printed, not gated)", flush=True)
        released(grammar_runs.pop("paged"))
        run = grammar_runs.pop("dense")

        # 3c. --spec_decode with the grammars and the prefix cache, dense: the
        # greedy rows of run 3's first 8, twice (the second wave seated from
        # the cache); free rows keep run 1's tokens, constrained rows run 3's
        srows = [r for r in grows[:8] if not r.get("do_sample")]
        srows = srows + [dict(r, request_id=r["request_id"] + N_REQ) for r in srows]
        cyc = {}

        def spy_ticks(eng):
            cyc["n"] = _count_spec_ticks(eng)

        with _NoPlainInt8():
            spec_run = _serve_cli_call(
                serve, argv(jsonl("serve_spec.jsonl", srows), "--engine", "dense",
                            "--prefix_cache", "--spec_decode", "--spec_draft_k",
                            str(SPEC_DRAFT_K), *gflags), stand, "spec_decode", spy_ticks)
        add(spec_run["counts"])
        eng = spec_run["srv"].engine
        n_all, n_argmax = cyc["n"]
        _spec_counts("serve_cli spec_decode", spec_run["counts"], n_all, n_layers,
                     greedy=None, prefills=eng.prefill_calls, argmax=n_argmax)
        differ = [r["request_id"] for r in srows
                  if spec_run["tokens"][r["request_id"]] != run["tokens"][r["request_id"] % N_REQ]]
        n_half = len(srows) // 2
        if differ or eng.cache_hits != n_half or not eng.spec_decode:
            raise AssertionError(f"serve_cli spec_decode: requests {differ} differ from the "
                                 f"runs without it, or {eng.cache_hits} hits of {n_half}")
        _serve_cli_line("spec_decode dense, grammars, prefix cache", spec_run["lines"],
                        spec_run["wall"], spec_run["counts"], eng, n_all, card)
        print(f"serve_cli: spec_decode: {len(srows)} greedy requests ({n_half} twice, "
              f"{sum(1 for r in srows if r.get('grammar'))} constrained) with the tokens of the "
              f"runs without it; {eng.cache_hits} hits; {n_all} verify cycles, "
              f"{n_argmax} of them (no constrained row seated) on the argmax head",
              flush=True)
        released(spec_run)

        # 3b. a paged pool that preempts constrained rows: each is seated
        # again in the DFA state its emitted tokens reach
        lrows = [dict(r, grammar=SERVE_CLI_LEAD[0], max_new_tokens=SERVE_CLI_LEAD_BUDGET)
                 for r in rows]
        resumed = []

        def spy_preempt(into):
            def hook(eng):
                preempt = eng._preempt_youngest

                def preempt_youngest(exclude, shard):
                    slot = preempt(exclude, shard)
                    if slot is not None:
                        req = eng.pending[0]
                        into.append((req.request_id, len(req.input_ids) - req.prefix_len))
                    return slot

                eng._preempt_youngest = preempt_youngest
            return hook

        lead_argv = argv(jsonl("serve_lead.jsonl", lrows), "--engine", "paged", "--n_pages",
                         str(SERVE_CLI_LEAD_POOL), "--grammar", "=".join(SERVE_CLI_LEAD))
        pre = _serve_cli_call(serve, lead_argv, stand, "grammar preempted", spy_preempt(resumed))
        add(pre["counts"])
        eng = pre["srv"].engine
        _serve_cli_launches("grammar preempted", pre["counts"], pre["ticks"], eng, n_layers,
                            head_ticks=pre["head_ticks"])
        if not (eng.preemptions and resumed and all(n > 0 for _, n in resumed)):
            raise AssertionError(f"serve_cli grammar preempted: {eng.preemptions} preemptions, "
                                 f"(request, tokens emitted before it) {resumed}")
        lines = {ln["request_id"]: ln for ln in pre["lines"]}
        for r in lrows:
            in_grammar("grammar preempted", r, pre["tokens"][r["request_id"]],
                       lines[r["request_id"]]["text"])
        _serve_cli_line(f"grammar paged, {SERVE_CLI_LEAD_POOL}-page pool", pre["lines"],
                        pre["wall"], pre["counts"], eng, pre["ticks"], card)
        print(f"serve_cli: grammar preempted: {eng.preemptions} preemptions of constrained rows "
              f"(request, tokens emitted before it: {resumed}); every row's text stays in "
              f"{SERVE_CLI_LEAD[1]!r}, whose start state allows no later token", flush=True)
        released(pre)

        # 3d. the same with --spec_decode: the paged verify with the int8
        # logits head at B x (draft_k + 1) rows and each position masked by
        # its prefix's DFA state; each row's tokens before its first
        # eviction (in either run) equal the run without spec (a recompute
        # re-encodes the emitted tokens with the prefill's weights, so later
        # tokens may move)
        resumed_s = []

        def spy_spec(eng):
            spy_ticks(eng)
            spy_preempt(resumed_s)(eng)

        with _NoPlainInt8():
            pspec = _serve_cli_call(serve, lead_argv + ["--spec_decode", "--spec_draft_k",
                                                        str(SPEC_DRAFT_K)],
                                    stand, "grammar preempted spec_decode", spy_spec)
        add(pspec["counts"])
        eng = pspec["srv"].engine
        n_all, n_argmax = cyc["n"]
        _spec_counts("serve_cli paged grammar spec_decode", pspec["counts"], n_all, n_layers,
                     paged=True, greedy=None, prefills=eng.prefill_calls, argmax=n_argmax)
        if not (eng.spec_decode and eng.preemptions and resumed_s):
            raise AssertionError(f"serve_cli paged grammar spec_decode: {eng.preemptions} "
                                 f"preemptions, evictions {resumed_s}")
        first = {}
        for rid, n_tok in resumed + resumed_s:
            first[rid] = min(first.get(rid, n_tok), n_tok)
        lines = {ln["request_id"]: ln for ln in pspec["lines"]}
        differ = []
        for r in lrows:
            i = r["request_id"]
            in_grammar("grammar preempted spec_decode", r, pspec["tokens"][i], lines[i]["text"])
            n_tok = first.get(i)  # None: never evicted, the whole list
            if pspec["tokens"][i][:n_tok] != pre["tokens"][i][:n_tok]:
                differ.append(i)
        if differ:
            raise AssertionError(f"serve_cli paged grammar spec_decode: requests {differ} differ "
                                 "from the run without spec before their first eviction")
        agree = sum(x == y for r in lrows for x, y in zip(pspec["tokens"][r["request_id"]],
                                                          pre["tokens"][r["request_id"]]))
        n_pre = sum(len(pre["tokens"][r["request_id"]]) for r in lrows)
        _serve_cli_line(f"grammar paged spec_decode, {SERVE_CLI_LEAD_POOL}-page pool",
                        pspec["lines"], pspec["wall"], pspec["counts"], eng, n_all, card)
        print(f"serve_cli: grammar preempted spec_decode: {eng.preemptions} preemptions "
              f"(request, tokens emitted before it: {resumed_s}); {n_all} verify cycles, "
              f"{n_argmax} on the argmax head; every row in the grammar and equal to the run "
              f"without spec before its first eviction; {agree}/{n_pre} tokens agree in all",
              flush=True)
        released(pspec)
        ticks = _tick_compare({"plain greedy": (plain_srv, None),
                               "grammar greedy": (run["srv"], "digits")}, rows[:8], n_layers,
                              card)
        (host_p, dev_p), (host_g, dev_g) = ticks["plain greedy"], ticks["grammar greedy"]
        busy = ("not measured" if dev_p is None or dev_g is None else
                f"plain {dev_p:.3f} ms, grammar {dev_g:.3f} ms: {dev_g - dev_p:+.3f} ms")
        print(f"serve_cli: dense tick of 8 live rows, windows of {SERVE['sync_every']} in turns "
              f"(unpipelined, read-back included; median of 6 each): plain greedy {host_p:.3f} "
              f"ms, grammar greedy {host_g:.3f} ms (the int8 GEMV head, the mask and the DFA "
              f"step): {host_g - host_p:+.3f} ms; device busy per tick: {busy}  [{card}]",
              flush=True)
        del plain_srv
        released(run)

        # 4. HTTP mode
        add(_serve_cli_http(serve, d, rows, by_id, n_layers, card))
        gc.collect()
        torch.cuda.empty_cache()

        # 5. --lora with the multilora phase's adapters
        adapters = lora_bank_adapters(cfg, dev, LORA_B_STD)
        names = [None, *LORA_NAMES]
        lflags = []
        for name, ad in adapters.items():
            save_pytree(os.path.join(d, f"lora_{name}"), {"lora": ad})
            lflags += ["--lora", f"{name}={os.path.join(d, f'lora_{name}')}"]
        lrows = [dict(r, **({"lora": names[i % 4]} if names[i % 4] else {}))
                 for i, r in enumerate(rows)]
        want = reference(lrows, lora_bank=adapters)
        run = _serve_cli_call(serve, argv(jsonl("serve_lora.jsonl", lrows), *lflags), stand,
                              "lora")
        add(run["counts"])
        eng = run["srv"].engine
        _serve_cli_launches("lora", run["counts"], run["ticks"], eng, n_layers, lora=True)
        differ = [i for i in want if run["tokens"].get(i) != want[i]]
        if differ:
            raise AssertionError(f"serve_cli lora: requests {differ} differ from the engine "
                                 "with the same bank")
        moved = sum(want[i] != ref[i] for i in want if names[i % 4])
        _serve_cli_line("lora dense", run["lines"], run["wall"], run["counts"], eng,
                        run["ticks"], card)
        print(f"serve_cli: lora: 12/12 requests with the tokens of a ServingEngine with the "
              f"same bank; {moved}/9 adapter rows differ from the base model", flush=True)
        released(run)
    print(f"serve_cli: launches summed over the runs: {json.dumps(total)}", flush=True)
    return total


def serving_requests(cfg, sample=False):
    """The phase's 12 requests, made anew (the engines mutate them); with
    ``sample`` the odd ids sample (temperature 0.8, top-p 0.9)."""
    from paligemma_tpu_torch.runtime.serving import Request

    rng = np.random.default_rng(SEED + 1)
    px_rng = np.random.default_rng(SEED + 2)
    px = cfg.vision_config.image_size
    out = []
    for i in range(N_REQ):
        n_txt, budget = int(rng.integers(4, 61)), int(rng.integers(16, 65))
        ids = np.concatenate([np.full(cfg.vision_config.num_patches, cfg.image_token_index),
                              rng.integers(2, 1000, n_txt)]).astype(np.int32)
        out.append(Request(request_id=i, input_ids=ids, max_new_tokens=budget, eos_token_id=-1,
                           pixel_values=px_rng.standard_normal((3, px, px), dtype=np.float32),
                           do_sample=sample and i % 2 == 1, temperature=0.8, top_p=0.9))
    return out


def fill_requests(cfg):
    """Run (e)'s two requests: request 0 asks for more tokens than fit in a
    FILL_SEQ cache and is capped at submit to fill it exactly; request 1
    runs on after request 0 has finished."""
    reqs = serving_requests(cfg)[:2]
    n_img = cfg.vision_config.num_patches
    for r, n_txt, budget in ((reqs[0], 60, FILL_SEQ), (reqs[1], 4, 100)):
        r.input_ids = np.concatenate([r.input_ids[:n_img],
                                      np.arange(2, 2 + n_txt)]).astype(np.int32)
        r.max_new_tokens = budget
    return reqs


def _recording_engine():
    from paligemma_tpu_torch.runtime.serving_paged import PagedServingEngine

    class Recording(PagedServingEngine):
        """Observes the scheduler: the peak of pages in use, and the tokens
        each preempted request had before its first eviction."""

        def __init__(self, *a, **kw):
            self.peak_pages, self.first_eviction = 0, {}
            super().__init__(*a, **kw)

        def _before_window(self, ticks):
            super()._before_window(ticks)
            self.peak_pages = max(self.peak_pages, self.n_pages - 1 - self.paged.free_pages())

        def _preempt_youngest(self, exclude, shard):
            seen = {r.request_id: len(r.tokens) for r in self.slots if r is not None}
            slot = super()._preempt_youngest(exclude, shard)
            if slot is not None:
                rid = self.pending[0].request_id
                self.first_eviction.setdefault(rid, seen[rid])
            return slot

    return Recording


def _serve(eng, reqs, vocab):
    """Submit, run to completion; every request must finish with its whole
    budget of in-vocab tokens. Returns ({id: tokens}, wall s, p50 TTFT ms)."""
    for r in reqs:
        eng.submit(r)
    budgets = {r.request_id: r.max_new_tokens for r in reqs}  # as capped by submit
    sync()
    t0 = time.perf_counter()
    done = eng.run_to_completion()
    sync()
    wall = time.perf_counter() - t0
    if sorted(r.request_id for r in done) != sorted(budgets):
        raise AssertionError("serving: not every request finished")
    for r in reqs:
        if len(r.tokens) != budgets[r.request_id] or not all(0 <= t < vocab for t in r.tokens):
            raise AssertionError(f"serving: request {r.request_id} emitted {len(r.tokens)} of "
                                 f"{budgets[r.request_id]} tokens, or out-of-vocab ids")
    ttft = float(np.median([r.metrics()["ttft_ms"] for r in reqs]))
    return {r.request_id: list(r.tokens) for r in reqs}, wall, ttft


def _served(label, eng, reqs, vocab, n_layers, tick_kernels=None):
    """``_serve`` with the launch counts zeroed just before the run and read
    just after it. ``tick_kernels`` (must launch, must not launch, once per
    layer and tick) is checked against the counts and the engine's ticks,
    and a tick that must launch rms_norm (the final norm) launches it once;
    None: the run must launch no kernel. Returns ``_serve``'s result and the
    run's counts."""
    from paligemma_tpu_torch import kernels

    name = "_tick_paged" if hasattr(eng, "paged") else "_tick"
    inner, ticks = getattr(eng, name), [0]

    def counted(*a, **kw):
        ticks[0] += 1
        return inner(*a, **kw)

    setattr(eng, name, counted)
    kernels.reset_launch_counts()
    out = _serve(eng, reqs, vocab)
    counts = kernels.launch_counts()
    print(f"serve {label}: launches over {ticks[0]} ticks: {json.dumps(counts)}", flush=True)
    if tick_kernels is None:
        bad = [k for k, v in counts.items() if v]
    else:
        need, absent, per_tick = tick_kernels
        bad = ([k for k in need if counts[k] == 0] + [k for k in absent if counts[k]]
               + [k for k in per_tick if counts[k] != n_layers * ticks[0]]
               + [k for k in ("rms_norm",) if k in need and counts[k] != ticks[0]])
    if bad or not ticks[0]:
        raise AssertionError(f"serve {label}: launch counts off for {bad} "
                             f"({ticks[0]} ticks, {n_layers} layers)")
    return out, counts


def serving_phase(params, decode, cfg, dev, card):
    """The continuous-batching serving path at full width: dense vs paged
    tokens, preemption, the page walk, a mixed greedy/sampled batch, and
    throughput beside the plain path. Returns the launch counts summed over
    the served runs (a)-(e), and run (a)'s tokens of the dense and the paged
    engine."""
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    Paged = _recording_engine()
    vocab = cfg.vocab_size
    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}

    def served(label, eng, reqs, tick_kernels):
        out, counts = _served(label, eng, reqs, vocab, n_layers, tick_kernels)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out

    def dense(**kw):
        return ServingEngine(params, cfg, decode_params=decode, **SERVE, **kw)

    def paged(n_pages=FULL_POOL, **kw):
        return Paged(params, cfg, decode_params=decode, page_size=PAGE, n_pages=n_pages,
                     **SERVE, **kw)

    def tok_s(toks, wall):
        return sum(len(t) for t in toks.values()) / wall

    # first calls (cuBLAS heuristics, Triton specializations) off the clock
    for make in (dense, lambda: paged(paged_kernel="fused"), lambda: paged(paged_kernel="multi"),
                 lambda: paged(fused_decode=False, use_flash=False)):
        warm = serving_requests(cfg)[:2]
        for r in warm:
            r.max_new_tokens = 9
        _serve(make(), warm, vocab)

    # (a) dense vs paged, a pool as large as the dense reservation
    eng_dense, eng_a = dense(), paged(paged_kernel="fused")
    if not all(e.fused_decode and e.use_flash and e.pipeline for e in (eng_dense, eng_a)) or (
            eng_a.paged_kernel != "fused"):
        raise AssertionError("a serving engine did not select the kernel paths")
    tok_d, wall_d, ttft_d = served("(a) dense", eng_dense, serving_requests(cfg), DENSE_TICK)
    tok_a, wall_a, ttft_a = served("(a) paged fused", eng_a, serving_requests(cfg),
                                   PAGED_FUSED_TICK)
    differ = [i for i in tok_d if tok_d[i] != tok_a[i]]
    print(f"serve (a): dense vs paged(fused): {N_REQ - len(differ)}/{N_REQ} requests with "
          f"identical tokens ({sum(map(len, tok_a.values()))} tokens); preemptions "
          f"{eng_a.preemptions}; peak pages in use {eng_a.peak_pages} of the dense reservation "
          f"{FULL_POOL - 1}", flush=True)
    if differ or eng_a.preemptions:
        raise AssertionError(f"serve (a): requests {differ} differ between dense and paged, or "
                             f"the full pool preempted ({eng_a.preemptions})")

    # (b) preemption from a small pool
    eng_b = paged(n_pages=SMALL_POOL, paged_kernel="fused")
    tok_b, _, _ = served("(b) paged fused", eng_b, serving_requests(cfg), PAGED_FUSED_TICK)
    for rid, n in sorted(eng_b.first_eviction.items()):
        if tok_b[rid][:n] != tok_a[rid][:n]:
            raise AssertionError(f"serve (b): request {rid} tokens before its eviction differ")
        later = sum(x == y for x, y in zip(tok_b[rid][n:], tok_a[rid][n:]))
        print(f"serve (b): request {rid} evicted after {n} tokens, recomputed; "
              f"{later}/{len(tok_a[rid]) - n} later tokens agree with (a)", flush=True)
    print(f"serve (b): {SMALL_POOL}-page pool: preemptions {eng_b.preemptions}, every request "
          f"complete with its full budget; peak pages in use {eng_b.peak_pages}", flush=True)
    if eng_b.preemptions < 1:
        raise AssertionError("serve (b): the small pool never preempted")

    # (c) the page walk: paged attention kernel once per layer
    tok_c, _, _ = served("(c) page walk", paged(paged_kernel="multi"), serving_requests(cfg),
                         PAGE_WALK_TICK)
    agree = sum(x == y for i in tok_a for x, y in zip(tok_a[i], tok_c[i]))
    print(f"serve (c): page walk ('multi') tokens agreeing with (a): {agree}/"
          f"{sum(map(len, tok_a.values()))}", flush=True)
    worst = _teacher_force_paged(params, eng_a.decode_params, cfg, dev, serving_requests(cfg)[0],
                                 tok_a[0], gemma, paligemma)
    print(f"serve (c): teacher-forced request 0 ({len(tok_a[0])} tokens) through "
          f"decode_step_paged 'multi' vs 'fused' logits: max rel err {worst:.3e} "
          f"(tol {LOGIT_REL_TOL})", flush=True)

    # (d) half the requests sample; the greedy rows keep (a)'s tokens
    eng_d = paged(paged_kernel="fused", generator=torch.Generator(device=dev).manual_seed(SEED))
    reqs_d = serving_requests(cfg, sample=True)
    tok_d2, _, _ = served("(d) paged fused, mixed", eng_d, reqs_d, PAGED_MIXED_TICK)
    greedy = [r.request_id for r in reqs_d if not r.do_sample]
    changed = [i for i in greedy if tok_d2[i] != tok_a[i]]
    n_same = sum(tok_d2[r.request_id] == tok_a[r.request_id] for r in reqs_d if r.do_sample)
    print(f"serve (d): mixed batch: {len(greedy) - len(changed)}/{len(greedy)} greedy requests "
          f"keep (a)'s tokens; sampled requests equal to greedy: {n_same}/{N_REQ - len(greedy)}",
          flush=True)
    if changed:
        raise AssertionError(f"serve (d): greedy requests {changed} changed beside sampled rows")

    # (e) request 0 (slot 0) fills the cache to its last position; its slot
    # goes on ticking, inactive, until it is seated again, and must write
    # nowhere but its own row: request 1 (slot 1) keeps the tokens it gets
    # alone, in the dense and in the paged engine
    fill = dict(SERVE, max_seq_len=FILL_SEQ)
    fill_paged = dict(fill, page_size=PAGE, n_pages=8 * FILL_SEQ // PAGE + 1,
                      paged_kernel="fused")
    tok_e = served("(e) dense", ServingEngine(params, cfg, decode_params=decode, **fill),
                   fill_requests(cfg), DENSE_TICK)[0]
    tok_ep = served("(e) paged fused", Paged(params, cfg, decode_params=decode, **fill_paged),
                    fill_requests(cfg), PAGED_FUSED_TICK)[0]
    alone = _serve(ServingEngine(params, cfg, decode_params=decode, **fill),
                   fill_requests(cfg)[1:], vocab)[0]
    n_fill = FILL_SEQ - len(fill_requests(cfg)[0].input_ids)
    print(f"serve (e): request 0 capped to {len(tok_e[0])} tokens (fills the {FILL_SEQ}-token "
          f"cache); request 1's {len(tok_e[1])} tokens equal its tokens alone: dense "
          f"{tok_e[1] == alone[1]}, paged {tok_ep[1] == alone[1]}; dense == paged "
          f"{tok_e == tok_ep}", flush=True)
    if len(tok_e[0]) != n_fill or not (tok_e[1] == alone[1] and tok_e == tok_ep):
        raise AssertionError("serve (e): the row that filled the cache disturbed its neighbour")

    print(f"serve: launches summed over the served runs (a)-(e): {json.dumps(total)}",
          flush=True)
    missing = [k for k, v in total.items()
               if v == 0 and k not in TRAIN_ONLY + TP_KERNELS + ABLATION_KERNELS + LORA_KERNELS
               + W8A8_KERNELS + tuple(FP32_OF.values()) + MIXED_FORMS]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: {missing}")

    # the plain path: no kernel launches, same requests
    (tok_p, wall_p, ttft_p), _ = _served("plain", paged(fused_decode=False, use_flash=False),
                                         serving_requests(cfg), vocab, n_layers)
    agree = sum(x == y for i in tok_a for x, y in zip(tok_a[i], tok_p[i]))
    print(f"serve: plain path tokens agreeing with (a): {agree}/{sum(map(len, tok_a.values()))}",
          flush=True)
    # no host synchronization inside a decode window (8 live rows each), and
    # where a paged tick's time goes
    engines = {"dense greedy": (dense(), False), "paged sampled": (paged(), True),
               "paged greedy": (paged(paged_kernel="fused"), False)}
    for name, (eng, sample) in engines.items():
        for r in serving_requests(cfg, sample=sample)[:8]:
            r.max_new_tokens = 64
            eng.submit(r)
        eng.step()  # prefill the 8 rows and decode a first window
        _window_without_sync(eng)
    print(f"serve: no host synchronization inside a decode window: {', '.join(engines)}",
          flush=True)
    _profile(f"paged fused greedy window B8, {SERVE['sync_every']} ticks",
             engines["paged greedy"][0].step, SERVE["sync_every"], card, unit="tick",
             layers=n_layers)
    for name, toks, wall, ttft in (("paged kernels", tok_a, wall_a, ttft_a),
                                   ("dense kernels", tok_d, wall_d, ttft_d),
                                   ("paged plain", tok_p, wall_p, ttft_p)):
        print(f"serve: {name:13s} {N_REQ} requests, 8 slots: {tok_s(toks, wall):.1f} tok/s "
              f"aggregate (all tokens / run wall {wall:.2f} s), TTFT p50 {ttft:.1f} ms  "
              f"[{card}]", flush=True)
    return total, tok_d, tok_a


def _mixed_tick(tick, act=torch.bfloat16):
    """A serving tick's (must launch, must not launch, once per layer and
    tick) over a cache of the other dtype: the three cache families' mixed
    forms in their uniform forms' places, the uniform forms must not
    launch."""
    of = MIXED_OF[act]
    need, absent, per_tick = tick

    def sub(names):
        return tuple(of.get(k, k) for k in names)

    return sub(need), sub(absent) + tuple(k for k in of if k in need), sub(per_tick)


def mixed_cache_phase(params, decode, cfg, dev, card, tok_gen, tok_dense):
    """bf16 activations over an fp32 KV cache (``cache_dtype=torch.float32``:
    the mixed forms of the qkv GEMV's cache write, 3b and B5) at full width
    on the int8 decode tree. The cache holds each bf16 row widened, exactly,
    so every gate is bit for bit the bf16 cache's:

    (a) generate, B1, N_NEW greedy tokens: main's ``tok_gen``; per step one
        mixed qkv GEMV and one mixed attention a layer and no uniform one;
        along the tokens, teacher-forced, the prefill's and every step's
        logits equal the bf16-cache engine's;
    (b) generate_spec: the same tokens, every verify on the mixed chain;
    (c) the serving phase's 12 requests through the dense and the paged
        fused engine: run (a)'s dense tokens ``tok_dense``, so dense ==
        paged.

    Returns the launch counts summed over the counted runs."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    f32 = torch.float32
    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    e32 = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode, cache_dtype=f32)
    e16 = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
    if not (e32.use_flash and e32.fused_layer and e32._greedy_head_fused
            and e32.cache_dtype == f32):
        raise AssertionError("mixed: the fp32-cache engine did not select the kernel paths")
    pixels, ids, mask = make_inputs(cfg, dev)
    kernels.reset_launch_counts()
    tok = e32.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1, sync_every=16)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    _cli_launches("mixed generate", _as_uniform_names("mixed generate", counts, torch.bfloat16),
                  n_layers, True)
    l32, s32 = e32.prefill(pixels, ids, mask)
    l16, s16 = e16.prefill(pixels, ids, mask)
    same = [torch.equal(l32, l16)]
    for t in range(N_NEW - 1):
        step = torch.from_numpy(tok[:, t])
        l32, s32 = e32.decode_step(step, s32)
        l16, s16 = e16.decode_step(step, s16)
        same.append(torch.equal(l32, l16))
    sync()
    print(f"mixed (a): bf16 over an fp32 cache: generate's {N_NEW} tokens equal the bf16 cache's "
          f"{np.array_equal(tok, tok_gen)}; teacher-forced logits bit for bit the bf16-cache "
          f"engine's at {sum(same)}/{len(same)} of the prefill + {N_NEW - 1} steps; "
          f"{counts['int8_gemv_rope_kv_cache_fp32']} int8_gemv_rope_kv_cache_fp32 and "
          f"{counts['decode_attention_cache_fp32']} decode_attention_cache_fp32, no uniform "
          "form", flush=True)
    if not (np.array_equal(tok, tok_gen) and all(same)):
        raise AssertionError("mixed (a): the fp32 cache's tokens or logits differ from the bf16 "
                             "cache's")
    del l32, s32, l16, s16, e16
    kernels.reset_launch_counts()
    with _NoPlainInt8():
        spec = e32.generate_spec(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1,
                                 draft_k=SPEC_DRAFT_K, sync_every=SPEC_SYNC)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    verifies = _spec_verifies(e32.spec_cycles, SPEC_SYNC)
    _spec_counts("mixed generate_spec", _as_uniform_names("mixed generate_spec", counts,
                                                          torch.bfloat16),
                 verifies, n_layers, prefills=1)
    print(f"mixed (b): generate_spec over the fp32 cache gives generate's tokens "
          f"{np.array_equal(spec, tok)} in {e32.spec_cycles} cycles ({verifies} verify calls)",
          flush=True)
    if not np.array_equal(spec, tok):
        raise AssertionError("mixed (b): generate_spec differs from generate")
    del e32
    torch.cuda.empty_cache()

    Paged = _recording_engine()
    served = {}
    for label, make, tick in (
            ("dense", lambda: ServingEngine(params, cfg, decode_params=decode, cache_dtype=f32,
                                            **SERVE), DENSE_TICK),
            ("paged fused", lambda: Paged(params, cfg, decode_params=decode, page_size=PAGE,
                                          n_pages=FULL_POOL, paged_kernel="fused",
                                          cache_dtype=f32, **SERVE), PAGED_FUSED_TICK)):
        eng = make()
        if not (eng.fused_decode and eng.use_flash and eng.cache_dtype == f32):
            raise AssertionError(f"mixed (c) {label}: the engine is not on the kernel tick")
        (toks, wall, _), counts = _served(f"mixed (c) {label}", eng, serving_requests(cfg),
                                          cfg.vocab_size, n_layers, _mixed_tick(tick))
        add(counts)
        served[label] = toks
        print(f"mixed (c) {label}: {sum(toks[i] == tok_dense[i] for i in toks)}/{N_REQ} requests "
              f"with the bf16-cache dense engine's tokens; "
              f"{sum(map(len, toks.values())) / wall:.1f} tok/s  [{card}]", flush=True)
        del eng
    if not (served["dense"] == served["paged fused"] == tok_dense):
        raise AssertionError("mixed (c): the fp32-cache engines' tokens differ from the bf16 "
                             "cache's, or dense from paged")
    return total


def fp32_mixed_cache(p32, dq32, cfg, dev, card, eng, inputs):
    """fp32_phase's (i): the fp32 int8 tree over a bf16 KV cache (the mixed
    forms). Gates: the prefill logits bit for bit the fp32-cache kernel
    engine ``eng``'s (prefill attends over the fresh k / v); FP32_NEW
    greedy tokens, one mixed qkv GEMV and one mixed attention a layer and
    step and no uniform one; along them, teacher-forced, each step's logits
    within FP32_LOGIT_TOL of the torch-ops engine with the same bf16 cache
    (both read the fresh row back rounded), its greedy token the emitted
    one but at a near tie (the gap to the fp32-cache engine, the cache's
    own rounding, printed); generate_spec == generate bit for bit; the
    feature runs on one card over the bf16 cache: the [base, a, b, c] bank
    with a grammar row and a prefix repeat, dense == paged bit for bit, and
    spec_decode dense and paged == the same engine without it. Returns
    (summed launch counts, the greedy tokens)."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine

    bf = torch.bfloat16
    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def names(label, counts):
        return _as_uniform_names(label, counts, torch.float32)

    e16 = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32, cache_dtype=bf)
    ops16 = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32, cache_dtype=bf,
                            fused_layer=False, use_flash=False)
    if not (e16.use_flash and e16.fused_layer and e16._greedy_head_fused):
        raise AssertionError("fp32 (i): the bf16-cache engine did not select the kernel paths")
    kernels.reset_launch_counts()
    tok = e16.generate(*inputs, max_new_tokens=FP32_NEW, eos_token_id=-1, sync_every=8)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    _cli_launches("fp32 (i) generate", names("fp32 (i) generate", counts), n_layers, True)
    tok_ops = ops16.generate(*inputs, max_new_tokens=FP32_NEW, eos_token_id=-1, sync_every=8)
    lk, sk = e16.prefill(*inputs)
    lp, sp = ops16.prefill(*inputs)
    l32, s32 = eng.prefill(*inputs)
    prefill_same = torch.equal(lk, l32)
    worst, ties = _compare(lk, lp, "fp32 (i) prefill", tok[0, 0], tol=FP32_LOGIT_TOL)
    ties = [0] if ties else []
    gap = 0.0
    for t in range(FP32_NEW - 1):
        step = torch.from_numpy(tok[:, t])
        lk, sk = e16.decode_step(step, sk)
        lp, sp = ops16.decode_step(step, sp)
        l32, s32 = eng.decode_step(step, s32)
        w, f = _compare(lk, lp, f"fp32 (i) decode {t}", tok[0, t + 1], tol=FP32_LOGIT_TOL)
        worst = max(worst, w)
        gap = max(gap, float((lk - l32).abs().max()) / float(l32.abs().max()))
        if f:
            ties.append(t + 1)
    sync()
    differ = [t for t in range(FP32_NEW) if tok_ops[0, t] != tok[0, t]]
    print(f"fp32 (i): fp32 over a bf16 cache: prefill logits bit for bit the fp32 cache's "
          f"{prefill_same}; teacher-forced logits against the torch-ops engine with the bf16 "
          f"cache: max rel err {worst:.3e} of max |logit| (tol {FP32_LOGIT_TOL}); "
          f"{FP32_NEW - len(differ)}/{FP32_NEW} greedy tokens identical"
          f"{f', first divergence at {differ[0]}' if differ else ''}; near-tie steps {ties}; "
          f"against the fp32-cache kernel engine (the cache's rounding) {gap:.3e}; "
          f"{counts['int8_gemv_rope_kv_fp32_cache_bf16']} int8_gemv_rope_kv_fp32_cache_bf16 and "
          f"{counts['decode_attention_fp32_cache_bf16']} decode_attention_fp32_cache_bf16, no "
          f"uniform form  [{card}]", flush=True)
    if not prefill_same or (differ and differ[0] not in ties):
        raise AssertionError(f"fp32 (i): prefill logits differ from the fp32 cache's "
                             f"({prefill_same}), or the torch-ops tokens diverge at {differ} "
                             "off a near tie")
    del lk, sk, lp, sp, l32, s32, ops16
    kernels.reset_launch_counts()
    with _NoPlainInt8():
        spec = e16.generate_spec(*inputs, max_new_tokens=FP32_NEW, eos_token_id=-1,
                                 draft_k=SPEC_DRAFT_K, sync_every=SPEC_SYNC)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    verifies = _spec_verifies(e16.spec_cycles, SPEC_SYNC)
    _spec_counts("fp32 (i) generate_spec", names("fp32 (i) generate_spec", counts), verifies,
                 n_layers, prefills=1)
    if not np.array_equal(spec, tok):
        raise AssertionError(f"fp32 (i): generate_spec {spec.tolist()} != generate "
                             f"{tok.tolist()}")
    print(f"fp32 (i): generate_spec over the bf16 cache gives generate's {FP32_NEW} tokens bit "
          f"for bit in {e16.spec_cycles} cycles ({verifies} verify calls)", flush=True)
    del e16
    torch.cuda.empty_cache()
    feats, counts = tp_feature_runs(
        "fp32 (i) one card, bf16 cache", p32, dq32, cfg, dev, card, None, None,
        runs=("bank dense", "bank paged", "greedy dense", "spec dense", "spec paged"),
        cache_dtype=bf, as_names=names)
    add(counts)
    ok_bank = feats["bank dense"] == feats["bank paged"]
    ok_spec = feats["spec dense"] == feats["spec paged"] == feats["greedy dense"]
    print(f"fp32 (i): feature runs over the bf16 cache: the bank with a grammar row and a "
          f"prefix repeat, dense == paged {ok_bank}; spec_decode dense == paged == greedy "
          f"{ok_spec}", flush=True)
    if not (ok_bank and ok_spec):
        raise AssertionError("fp32 (i): dense != paged with the bank, or spec != greedy")
    return total, tok


def lora_bank_adapters(cfg, dev, b_std):
    """LORA_NAMES adapters from init_lora (seeded), each with a seeded
    nonzero B of std ``b_std``."""
    from paligemma_tpu_torch.train.lora import init_lora

    out = {}
    for i, name in enumerate(LORA_NAMES):
        g = torch.Generator(device=dev).manual_seed(SEED + 10 + i)
        ad = init_lora(g, cfg.text_config, rank=LORA_RANK, alpha=LORA_ALPHA)
        for p in ad["layers"].values():
            p["b"] = torch.randn(p["b"].shape, generator=g, device=dev) * b_std
        out[name] = ad
    return out


def lora_kernel_cases(report: KernelReport, pack, decode, cfg, dev):
    """lora_shrink and int8_gemv's LoRA expand against their plain versions
    at one layer's shapes (B = 1 and 8 rows, the fp32 bank and a bf16 copy);
    the expand with base rows only (a delta of exactly 0) bit-equal to the
    GEMV without LoRA, and a second call's bits; then one layer's four
    groups at B8: shrink and GEMV with and without the expand, back to back
    and on the device (torch.profiler), beside the cuBLAS products alone
    (x @ A and z @ B in bf16, never called by the port)."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    tc = cfg.text_config
    nq, hd, inter = tc.num_attention_heads * tc.head_dim, tc.head_dim, tc.intermediate_size
    lay = decode["lm"]["layers"]
    g_cols, rank = pack["o_b"].shape[1], pack["rank"]
    groups = (("qkv", lay["attn"]["qkv"], (nq, nq + hd), {}),
              ("o", lay["attn"]["o"], (), {"residual": True}),
              ("gu", lay["mlp"]["gateup"], (inter,), {"geglu": True}),
              ("down", lay["mlp"]["down"], (), {"residual": True}))
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    print(f"kernels: lora_shrink + int8_gemv LoRA expand ({len(LORA_NAMES)} adapters, rank "
          f"{rank}, G {g_cols}; Gemma-2B layer {CASE_LAYER})", flush=True)
    layer_ms = {}
    device = []  # (name, fn) of the B8 calls, timed on the device below
    for b in (1, 8):
        ids = torch.arange(b, device=dev, dtype=torch.int32) % (len(LORA_NAMES) + 1)
        base_ids = torch.zeros_like(ids)
        for name, leaf, bounds, kw in groups:
            w8, sc = leaf["w8"][CASE_LAYER], leaf["s"][CASE_LAYER]
            k = w8.shape[0]
            x = (torch.randn(b, k, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            res = None
            if kw.get("residual"):
                res = torch.randn(b, w8.shape[1], generator=gen, device=dev).to(torch.bfloat16)
            gkw = {"residual": res} if res is not None else dict(kw)
            for dtype in (torch.float32, torch.bfloat16):
                a = pack[name + "_a"][CASE_LAYER].to(dtype).contiguous()
                lb = pack[name + "_b"][CASE_LAYER].to(dtype).contiguous()
                dt = "fp32" if dtype == torch.float32 else "bf16"
                tag = f"{name} B{b} K{k} nG{a.shape[1]} {dt}"
                z = kl.lora_shrink(x, a, ids, rank, g_cols)
                zp = kl.lora_shrink_reference(x, a, ids, rank, g_cols)
                sync()
                report.case("lora_shrink", tag, z, zp, 1e-2)
                got = gv.int8_gemv(x, w8, sc, lora=(z, lb, bounds), **gkw)
                want = gv.int8_gemv_reference(x, w8, sc, lora=(zp, lb, bounds), **gkw)
                sync()
                report.case("int8_gemv", f"{name} B{b} LoRA expand {dt} B", got, want, 1e-2)
                again = (kl.lora_shrink(x, a, ids, rank, g_cols),
                         gv.int8_gemv(x, w8, sc, lora=(z, lb, bounds), **gkw))
                if not (torch.equal(again[0], z) and torch.equal(again[1], got)):
                    raise AssertionError(f"LoRA {tag}: a second call gave other bits")
            z0 = kl.lora_shrink(x, pack[name + "_a"][CASE_LAYER], base_ids, rank, g_cols)
            same = (not z0.any() and torch.equal(
                gv.int8_gemv(x, w8, sc, lora=(z0, pack[name + "_b"][CASE_LAYER], bounds), **gkw),
                gv.int8_gemv(x, w8, sc, **gkw)))
            print(f"  {'int8_gemv':20s} {name + f' B{b} base rows: LoRA == no LoRA':44s} "
                  f"torch.equal {same}  {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise AssertionError(f"int8_gemv {name}: a zero delta changed the epilogue's bits")
            if b != 8:
                continue
            # times at the serving shape (8 rows, the fp32 bank)
            a, lb = pack[name + "_a"][CASE_LAYER], pack[name + "_b"][CASE_LAYER]
            a_bf, lb_bf = a.to(torch.bfloat16), lb.to(torch.bfloat16)
            z = kl.lora_shrink(x, a, ids, rank, g_cols)
            t_s = report.time("lora_shrink", f"{name} B8 K{k} nG{a.shape[1]} fp32",
                              lambda: kl.lora_shrink(x, a, ids, rank, g_cols),
                              lambda: kl.lora_shrink_reference(x, a, ids, rank, g_cols),
                              flops=2 * b * k * a.shape[1], n_bytes=nbytes(x, a, ids, z),
                              library_fn=lambda: x @ a_bf)
            out = gv.int8_gemv(x, w8, sc, lora=(z, lb, bounds), **gkw)
            t_e = report.time("int8_gemv", f"{name} B8 + LoRA expand",
                              lambda: gv.int8_gemv(x, w8, sc, lora=(z, lb, bounds), **gkw),
                              lambda: gv.int8_gemv_reference(x, w8, sc, lora=(z, lb, bounds),
                                                             **gkw),
                              flops=2 * b * (k * w8.shape[1] + lb.numel()),
                              n_bytes=nbytes(x, w8, sc, z, lb, out)
                              + (nbytes(res) if res is not None else 0),
                              library_fn=lambda: z[:, :g_cols] @ lb_bf, in_json=False)
            t_0 = report.time("int8_gemv", f"{name} B8 without LoRA",
                              lambda: gv.int8_gemv(x, w8, sc, **gkw),
                              lambda: gv.int8_gemv_reference(x, w8, sc, **gkw),
                              flops=2 * b * k * w8.shape[1],
                              n_bytes=nbytes(x, w8, sc, out)
                              + (nbytes(res) if res is not None else 0), in_json=False)
            for key, t in (("shrink", t_s), ("gemv+expand", t_e), ("gemv", t_0)):
                acc = layer_ms.setdefault(key, [0.0, 0.0, 0.0, 0.0])
                acc[0], acc[1], acc[2] = acc[0] + t[0], acc[1] + t[1], acc[2] + t[3]
                acc[3] = None if acc[3] is None or t[2] is None else acc[3] + t[2]
            device += [
                (f"{name} shrink", lambda x=x, a=a, ids=ids: kl.lora_shrink(x, a, ids, rank,
                                                                           g_cols)),
                (f"{name} x @ A (cuBLAS)", lambda x=x, a_bf=a_bf: x @ a_bf),
                (f"{name} GEMV + expand", lambda x=x, w8=w8, sc=sc, z=z, lb=lb, bounds=bounds,
                 gkw=gkw: gv.int8_gemv(x, w8, sc, lora=(z, lb, bounds), **gkw)),
                (f"{name} GEMV", lambda x=x, w8=w8, sc=sc, gkw=gkw: gv.int8_gemv(x, w8, sc, **gkw)),
                (f"{name} z @ B (cuBLAS)", lambda z=z, lb_bf=lb_bf: z[:, :g_cols] @ lb_bf)]
    sk, sp, sb, sl = layer_ms["shrink"]
    ek, ep, eb, el = layer_ms["gemv+expand"]
    bk, bp, bb, _ = layer_ms["gemv"]
    print(f"  lora: one layer B8, 4 groups, back to back: shrink {sk:.4f} ms (plain {sp:.4f}, "
          f"x @ A {sl:.4f}, bound {sb:.4f}); GEMVs with the expand {ek:.4f} ms (plain "
          f"{ep:.4f}, bound {eb:.4f}) vs without {bk:.4f} ms (bound {bb:.4f}); z @ B {el:.4f} "
          f"ms", flush=True)
    # device times: the same calls (weights warm in the L2: a layer's GEMV
    # operands are re-read each call)
    dt = device_times("B8 layer 5", device)
    per = {}
    for label, ms in dt.items():
        what = label.split(" ", 1)[1]
        per[what] = None if ms is None or per.get(what, 0.0) is None else per.get(what, 0.0) + ms
    txt = ", ".join(f"{w} {'not measured' if v is None else f'{v:.4f} ms'}"
                    for w, v in per.items())
    print(f"  lora: one layer B8, 4 groups, device: {txt}", flush=True)


def _teacher_force_lora(params, eng_k, eng_p, cfg, dev, req, tokens, gemma, paligemma):
    """Prefill one adapter request with the bank, then feed it its tokens
    through the kernel tick (the chain with the bank's kernel operands) and
    the plain tick (the bank through torch projections) from two copies of
    the cache; returns the largest logit difference relative to the
    largest plain logit."""
    n = len(req.input_ids)
    bucket = -(-n // PAGE) * PAGE
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = req.input_ids
    mask = np.zeros((1, bucket), np.int32)
    mask[0, :n] = 1
    aid = torch.tensor([eng_k._lora_index[req.lora]], dtype=torch.int32, device=dev)
    cache1 = gemma.init_kv_cache(cfg.text_config, 1, bucket, eng_k.cache_dtype, device=dev)
    _, cache1 = paligemma.prefill(params, cfg, torch.from_numpy(req.pixel_values[None]).to(dev),
                                  torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                                  cache1, use_flash=True, last_only=True, lora=eng_k.lora_bank,
                                  adapter_ids=aid)
    max_seq = SERVE["max_seq_len"]
    caches = []
    for _ in range(2):
        c = gemma.init_kv_cache(cfg.text_config, 1, max_seq, eng_k.cache_dtype, device=dev)
        for name in ("k", "v"):
            c[name][:, :, :bucket] = cache1[name]
        caches.append(c)
    valid = torch.zeros((1, max_seq), dtype=torch.bool, device=dev)
    valid[0, :n] = True
    worst = 0.0
    for t, tok in enumerate(tokens[:-1]):
        tok = torch.tensor([tok], device=dev)
        pos = torch.tensor([n + t], dtype=torch.int32, device=dev)
        valid[0, n + t] = True
        kw = dict(cache_pos=pos, kv_valid=valid, position_ids=pos + 1, adapter_ids=aid)
        lk, _ = paligemma.decode_step(eng_k.decode_params, cfg, tok, caches[0],
                                      fused_layer=True, lora=eng_k._lora_arg(), **kw)
        lp, _ = paligemma.decode_step(eng_p.decode_params, cfg, tok, caches[1],
                                      fused_layer=False, lora=eng_p._lora_arg(), **kw)
        if not (torch.isfinite(lk).all() and torch.isfinite(lp).all()):
            raise AssertionError(f"multilora teacher forcing step {t}: non-finite logits")
        worst = max(worst, float((lk - lp).abs().max()) / float(lp.abs().max()))
    return worst


def multilora_phase(report: KernelReport, params, decode, cfg, dev, card):
    """Multi-LoRA serving at full width: a bank of 3 adapters (rank 8, all
    seven targets, fp32) served by the dense engine's kernel tick, the
    paged engine's fused tick and the plain tick, the serving phase's 12
    requests taking [base, a, b, c] in turn. Gates: the kernels against
    their plain versions; base rows equal an engine with no bank; dense ==
    paged; an adapter row's teacher-forced logits, kernel tick vs plain
    tick; every adapter changes some tokens; 4 lora_shrink launches per
    layer and tick. Returns the launch counts of the served runs."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    Paged = _recording_engine()
    vocab = cfg.vocab_size
    n_layers = cfg.text_config.num_hidden_layers
    adapters = lora_bank_adapters(cfg, dev, LORA_B_STD)
    names = [None, *LORA_NAMES]

    def requests():
        reqs = serving_requests(cfg)
        for r in reqs:
            r.lora = names[r.request_id % len(names)]
        return reqs

    def dense(**kw):
        return ServingEngine(params, cfg, decode_params=decode, **SERVE, **kw)

    def paged(**kw):
        return Paged(params, cfg, decode_params=decode, page_size=PAGE, n_pages=FULL_POOL,
                     **SERVE, **kw)

    eng_d = dense(lora_bank=adapters)
    if not (eng_d.fused_decode and eng_d._lora_fused_pack is not None):
        raise AssertionError("multilora: the dense engine did not take the kernel tick")
    pack = eng_d._lora_fused_pack
    lora_kernel_cases(report, pack, eng_d.decode_params, cfg, dev)

    # the adapters' size against the base projections (layer 0, 8 rows)
    tc = cfg.text_config
    nq, hd, inter = tc.num_attention_heads * tc.head_dim, tc.head_dim, tc.intermediate_size
    lay = eng_d.decode_params["lm"]["layers"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    ids = torch.ones(8, dtype=torch.int32, device=dev)
    ratios = []
    for name, leaf, bounds in (("qkv", lay["attn"]["qkv"], (nq, nq + hd)),
                               ("o", lay["attn"]["o"], ()),
                               ("gu", lay["mlp"]["gateup"], (inter,)),
                               ("down", lay["mlp"]["down"], ())):
        x = torch.randn(8, leaf["w8"].shape[-2], generator=gen, device=dev).to(torch.bfloat16)
        z = kl.lora_shrink_reference(x, pack[name + "_a"][0], ids, pack["rank"],
                                     pack["o_b"].shape[1])
        delta = gv.lora_expand_reference(z, pack[name + "_b"][0], bounds, torch.bfloat16)
        base = (x.float() @ leaf["w8"][0].float()) * leaf["s"][0]
        ratios.append(f"{name} {float(delta.norm() / base.norm()):.3f}")
    print(f"multilora: adapter 'a' delta / base projection norm, layer 0: {', '.join(ratios)}",
          flush=True)

    total: dict = {}

    def served(label, eng, tick_kernels, per_tick_attn, reqs=None):
        (toks, wall, ttft), counts = _served(label, eng, reqs or requests(), vocab, n_layers,
                                             tick_kernels)
        if per_tick_attn is not None:  # one attention launch per layer and tick
            want = {k: n * counts[per_tick_attn] for k, n in LORA_LAUNCHES_PER_LAYER.items()}
            got = {k: counts[k] for k in want}
            print(f"multilora {label}: LoRA-related launches per layer and tick "
                  f"{sum(got.values()) / counts[per_tick_attn]:.1f} ({json.dumps(got)} over "
                  f"{counts[per_tick_attn]} layer-ticks)", flush=True)
            if got != want:
                raise AssertionError(f"multilora {label}: launches {got}, want {want} "
                                     f"({LORA_LAUNCHES_PER_LAYER} per layer and tick)")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return toks, wall, ttft

    # warm-up (first calls of the new shapes) off the clock
    for make in (lambda: dense(lora_bank=adapters),
                 lambda: paged(paged_kernel="fused", lora_bank=adapters)):
        warm = requests()[:2]
        for r in warm:
            r.max_new_tokens = 9
        _serve(make(), warm, vocab)

    # the ticks without a bank, lora_shrink moved from "must not" to "must"
    dense_lora = (DENSE_TICK[0] + LORA_KERNELS,
                  tuple(k for k in DENSE_TICK[1] if k not in LORA_KERNELS), DENSE_TICK[2])
    paged_lora = (PAGED_FUSED_TICK[0] + LORA_KERNELS,
                  tuple(k for k in PAGED_FUSED_TICK[1] if k not in LORA_KERNELS),
                  PAGED_FUSED_TICK[2])
    tok_d, wall_d, ttft_d = served("multilora dense", eng_d, dense_lora, "decode_attention")
    eng_p = paged(paged_kernel="fused", lora_bank=adapters)
    tok_p, wall_p, ttft_p = served("multilora paged fused", eng_p, paged_lora,
                                   "paged_decode_attention")
    eng_x = dense(lora_bank=adapters, fused_decode=False, use_flash=False)
    tok_x, wall_x, ttft_x = served("multilora plain", eng_x, None, None)
    # the same requests without adapter names, on an engine without a bank
    tok_0, wall_0, ttft_0 = served("no bank, dense", dense(), DENSE_TICK, None,
                                   serving_requests(cfg))

    n_tok = sum(map(len, tok_d.values()))
    differ = [i for i in tok_d if tok_d[i] != tok_p[i]]
    base_rows = [i for i in tok_d if names[i % len(names)] is None]
    base_off = [i for i in base_rows if tok_d[i] != tok_0[i]]
    moved = {n: sum(tok_d[i] != tok_0[i] for i in tok_d if names[i % len(names)] == n)
             for n in LORA_NAMES}
    agree = sum(x == y for i in tok_d for x, y in zip(tok_d[i], tok_x[i]))
    print(f"multilora: dense vs paged(fused) with the bank: {N_REQ - len(differ)}/{N_REQ} "
          f"requests with identical tokens ({n_tok} tokens); base rows {base_rows} equal to "
          f"the engine without a bank: {len(base_rows) - len(base_off)}/{len(base_rows)}; "
          f"requests changed by each adapter: {json.dumps(moved)}; plain tick tokens agreeing "
          f"with the kernel tick: {agree}/{n_tok}", flush=True)
    if differ:
        raise AssertionError(f"multilora: requests {differ} differ between dense and paged")
    if base_off:
        raise AssertionError(f"multilora: base rows {base_off} differ from the engine without "
                             "a bank")
    if not all(moved.values()):
        raise AssertionError(f"multilora: an adapter changed no request's tokens: {moved}")
    req = requests()[1]
    big = _teacher_force_lora(params, eng_d, eng_x, cfg, dev, req, tok_d[1], gemma, paligemma)
    gate_bank = lora_bank_adapters(cfg, dev, LORA_B_STD_GATE)
    worst = _teacher_force_lora(params, dense(lora_bank=gate_bank),
                                dense(lora_bank=gate_bank, fused_decode=False, use_flash=False),
                                cfg, dev, req, tok_d[1], gemma, paligemma)
    ok = worst <= LOGIT_REL_TOL
    print(f"multilora: teacher-forced request 1 (adapter {req.lora!r}, {len(tok_d[1])} tokens), "
          f"kernel tick vs plain tick logits: max rel err {worst:.3e} with B std "
          f"{LORA_B_STD_GATE} (tol {LOGIT_REL_TOL})  {'ok' if ok else 'FAIL'}; {big:.3e} with "
          f"the served bank's B std {LORA_B_STD} (not gated)", flush=True)
    if not ok:
        raise AssertionError(f"multilora: kernel vs plain tick logits rel err {worst}")

    # no host synchronization inside a window, and the device time per tick
    # with the bank and without it (8 live rows, greedy)
    engines = {"dense + bank": dense(lora_bank=adapters), "dense": dense(),
               "paged fused + bank": paged(paged_kernel="fused", lora_bank=adapters),
               "paged fused": paged(paged_kernel="fused")}
    for name, eng in engines.items():
        for r in (requests() if eng.lora_bank is not None else serving_requests(cfg))[:8]:
            r.max_new_tokens = 64
            eng.submit(r)
        eng.step()
        _window_without_sync(eng)
    print(f"multilora: no host synchronization inside a decode window: {', '.join(engines)}",
          flush=True)
    busy = {}
    for name, eng in engines.items():
        got = _profile(f"multilora {name} greedy window B8, {SERVE['sync_every']} ticks",
                       eng.step, SERVE["sync_every"], card, unit="tick", layers=n_layers)
        busy[name] = None if got is None else got[0]
        if got is not None and eng.lora_bank is not None:
            # the LoRA-related launches on the device: the shrinks and the
            # GEMVs (each with its expand), per layer and tick
            ev = {k: sum(r.count for r in got[1] if k in r.key)
                  for k in ("lora_shrink_kernel", "int8_gemv_kernel", "attn_split")}
            layer_ticks = ev.pop("attn_split")  # one attention split per layer and tick
            per_lt = sum(ev.values()) / max(1, layer_ticks)
            print(f"multilora: {name}: device launches per layer and tick: {json.dumps(ev)} / "
                  f"{layer_ticks} layer-ticks = {per_lt:.2f}", flush=True)
            if per_lt != sum(LORA_LAUNCHES_PER_LAYER.values()):
                raise AssertionError(f"multilora {name}: {per_lt} LoRA-related device launches "
                                     f"per layer and tick, want "
                                     f"{sum(LORA_LAUNCHES_PER_LAYER.values())}")
    for kind in ("dense", "paged fused"):
        with_bank, without = busy[kind + " + bank"], busy[kind]
        extra = ("not measured" if with_bank is None or without is None
                 else f"+{with_bank - without:.3f} ms ({with_bank:.3f} against {without:.3f})")
        print(f"multilora: the bank's extra device time per {kind} tick, 8 live rows: {extra}  "
              f"[{card}]", flush=True)
    for name, toks, wall, ttft in (("dense + bank", tok_d, wall_d, ttft_d),
                                   ("paged + bank", tok_p, wall_p, ttft_p),
                                   ("plain + bank", tok_x, wall_x, ttft_x),
                                   ("dense, no bank", tok_0, wall_0, ttft_0)):
        print(f"multilora: {name:14s} {N_REQ} requests, 8 slots: "
              f"{sum(map(len, toks.values())) / wall:.1f} tok/s aggregate (run wall {wall:.2f} s), "
              f"TTFT p50 {ttft:.1f} ms  [{card}]", flush=True)
    return total


def _window_without_sync(eng):
    """Dispatch one decode window under CUDA's sync debug mode "error": an
    operation that would make the host wait for the card raises. Then read
    the window back."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        window = eng._dispatch()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if window is None:
        raise AssertionError("no decode window to check")
    eng._absorb(window)


def _teacher_force_paged(params, dparams, cfg, dev, req, tokens, gemma, paligemma):
    """Prefill one request, copy it into two page pools (a fragmented
    table), and feed it its (a) tokens through decode_step_paged 'multi' and
    'fused'; returns the largest logit difference relative to the largest
    'fused' logit."""
    n = len(req.input_ids)
    bucket = -(-n // PAGE) * PAGE
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = req.input_ids
    mask = np.zeros((1, bucket), np.int32)
    mask[0, :n] = 1
    cache1 = gemma.init_kv_cache(cfg.text_config, 1, bucket, torch.bfloat16, device=dev)
    _, cache1 = paligemma.prefill(params, cfg, torch.from_numpy(req.pixel_values[None]).to(dev),
                                  torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
                                  cache1, use_flash=True, last_only=True)
    n_p = 16
    order = np.random.default_rng(SEED).permutation(np.arange(1, n_p + 1)).astype(np.int32)
    table = torch.from_numpy(order[None]).to(dev)
    pools = []
    for _ in range(2):
        pool = gemma.init_kv_cache(cfg.text_config, n_p + 1, PAGE, torch.bfloat16, device=dev)
        for name in ("k", "v"):
            rows = cache1[name][:, 0].reshape(cfg.text_config.num_hidden_layers, bucket // PAGE,
                                              PAGE, 1, -1)
            pool[name][:, table[0, : bucket // PAGE].long()] = rows
        pools.append(pool)
    worst = 0.0
    for t, tok in enumerate(tokens[:-1]):
        tok = torch.tensor([tok], device=dev)
        wp = torch.tensor([n + t], dtype=torch.int32, device=dev)
        lm, _ = paligemma.decode_step_paged(dparams, cfg, tok, pools[0], table, wp, wp + 1,
                                            pages_bucket=n_p, paged_kernel="multi")
        lf, _ = paligemma.decode_step_paged(dparams, cfg, tok, pools[1], table, wp, wp + 1,
                                            pages_bucket=n_p, paged_kernel="fused")
        if not (torch.isfinite(lm).all() and torch.isfinite(lf).all()):
            raise AssertionError(f"teacher forcing step {t}: non-finite logits")
        worst = max(worst, float((lm - lf).abs().max()) / float(lf.abs().max()))
    if worst > LOGIT_REL_TOL:
        raise AssertionError(f"serve (c): 'multi' vs 'fused' logits rel err {worst} > {LOGIT_REL_TOL}")
    return worst


def _gemv_events(rows, grew):
    """Why the GEMV tile's and the LoRA shrink's device events in ``rows``
    cannot be right: one per wrapper call (``grew``: the wrappers' counts
    over the run; a tree without int8_gemv_rope_kv has none of its calls)."""
    want = {"int8_gemv_kernel": (grew["int8_gemv"] + grew["int8_gemv_f32"]
                                 + grew.get("int8_gemv_rope_kv", 0) + grew["int8_gemv_fp32"]
                                 + grew["int8_gemv_rope_kv_fp32"]),
            "head_argmax_kernel": grew["head_argmax"] + grew["head_argmax_fp32"],
            "lora_shrink_kernel": grew["lora_shrink"]}
    for name, n in want.items():
        got = sum(k.count for k in rows if name in k.key)
        if got != n:
            return f"{got} {name} events of {n} launches"
    return None


def _is_wq(key):
    return any(t in key for t in WQ_EVENTS)


def _wq_events(rows, grew):
    """Why ``rows`` cannot be one device event per B9 / B11 call (``grew``:
    the wrappers' counts over the run; no other GEMV runs in it)."""
    calls = sum(grew[k] for k in WQ_WRAPPERS)
    got = sum(k.count for k in rows if _is_wq(k.key))
    return None if got == calls else f"{got} B9 / B11 device events of {calls} calls"


def layer_launches(rows, n_layers):
    """(device launches per decode layer, final norms per step or tick,
    events of the retired RoPE kernel) from a decode profile's device
    ``rows``: the layer kernels' events (LAYER_EVENTS; the head is the
    argmax kernel, not a GEMV) over the layer-steps (one attention split
    each), and the norm kernel's events beyond one a step."""
    ev = {k: sum(r.count for r in rows if k in r.key) for k in LAYER_EVENTS + (NORM_EVENT,)}
    layer_steps = ev["attn_split"]
    steps = layer_steps / n_layers
    per_layer = (sum(ev[k] for k in LAYER_EVENTS) + ev[NORM_EVENT] - steps) / max(1, layer_steps)
    return per_layer, ev[NORM_EVENT] / max(1, steps), ev["rope_kv_write_kernel"]


def _profile(label, fn, per, card, top=8, unit=None, host_top=0, layers=None, check=None):
    """torch.profiler over ``fn()`` (:func:`profiled`: its clock checked
    against CUDA events): device-busy time against wall time per ``per``
    (steps), and the kernels with the most device time. With
    ``host_top``: the host side too, the ops' self CPU time (the
    collectives' apart) against the wall time, and the ``host_top`` ops
    with the most of it. With ``layers`` (a decode step or tick of that
    many layers, greedy, without a LoRA bank): the device launches per
    layer and the final norms per step (:func:`layer_launches`), which
    must be LAYER_LAUNCHES and 1. ``check`` replaces :func:`_gemv_events`
    as the test of a profile's events. Returns (device busy ms per ``per``,
    the device-side rows), or None when no profile passed."""
    from torch.autograd import DeviceType

    from paligemma_tpu_torch import kernels

    unit = unit or ("step" if per > 1 else "prefill")
    got = profiled(fn, label, counts=kernels.launch_counts, check=check or _gemv_events)
    if got is None:
        print(f"profile: {label}: device time not measured (no run passed the clock check)",
              flush=True)
        return None
    # device-side events only: a CPU op (aten::mm, or the autograd node that
    # launches a kernel through ctypes) also carries its kernels' time, and
    # counting both would count that time twice
    rows, prof, wall, wrapped = got
    busy = sum(k.self_device_time_total for k in rows) / 1e3
    n_events = sum(k.count for k in rows)
    print(f"profile: {label}: per {unit} wall "
          f"{wall / per:.3f} ms, device busy {busy / per:.3f} ms "
          f"({100 * busy / wall:.1f} %), {n_events / per:.1f} device events  [{card}]",
          flush=True)
    if layers:
        per_layer, norms, rope = layer_launches(rows, layers)
        ok = per_layer == LAYER_LAUNCHES and norms == 1 and rope == 0
        print(f"profile: {label}: device launches per decode layer {per_layer:.2f} (want "
              f"{LAYER_LAUNCHES}), final norms per {unit} {norms:.2f} (want 1), separate RoPE "
              f"kernels {rope}  {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"profile {label}: {per_layer} device launches per layer, "
                                 f"{norms} norms per {unit}, {rope} RoPE kernels")
    for k in sorted(rows, key=lambda k: -k.self_device_time_total)[:top]:
        print(f"profile:   {k.key[:48]:48s} {k.count / per:6.1f} calls "
              f"{k.self_device_time_total / per:9.1f} us  "
              f"({k.self_device_time_total / k.count:.2f} us each)", flush=True)
    # the GEMV tile's kernels on the device (one launch per GEMV) beside
    # the wrappers' calls
    gemv = [k for k in rows if any(t in k.key for t in ("int8_gemv", "head_argmax"))]
    if gemv:
        dev_txt = ", ".join(f"{k.key.split('(')[0].replace('void ', '')[:34]} "
                            f"{k.count / per:.1f} launches {k.self_device_time_total / per:.1f} us"
                            for k in sorted(gemv, key=lambda k: k.key))
        calls = ", ".join(f"{k} {wrapped[k] / per:.1f}"
                          for k in ("int8_gemv", "int8_gemv_f32", "head_argmax") if wrapped[k])
        busy_gemv = sum(k.self_device_time_total for k in gemv) / 1e3
        print(f"profile: {label}: GEMV tile per {unit}: {busy_gemv / per:.3f} ms of device "
              f"busy {busy / per:.3f} ms; device: {dev_txt}; wrapper calls: {calls}",
              flush=True)
    if not host_top:
        return busy / per, rows
    # host-side events: each op's self CPU time (its children excluded), so
    # the rows add up; what is outside every op is Python, the ctypes
    # launches of the hand-written kernels and the profiler's own cost
    ops = [k for k in prof.key_averages()
           if k.device_type == DeviceType.CPU and k.self_cpu_time_total > 0]
    coll = [k for k in ops if any(t in k.key for t in COLLECTIVE_KEYS)]
    ops_ms = sum(k.self_cpu_time_total for k in ops) / 1e3
    coll_ms = sum(k.self_cpu_time_total for k in coll) / 1e3
    print(f"profile: {label}: host per {unit}: ops' self CPU {ops_ms / per:.3f} ms, of it "
          f"collectives {coll_ms / per:.3f} ms ({sum(k.count for k in coll) / per:.1f} "
          f"calls); outside any op {(wall - ops_ms) / per:.3f} ms of wall "
          f"{wall / per:.3f} ms", flush=True)
    for k in sorted(ops, key=lambda k: -k.self_cpu_time_total)[:host_top]:
        print(f"profile:   host {k.key[:43]:43s} {k.count / per:6.1f} calls "
              f"{k.self_cpu_time_total / per:9.1f} us  "
              f"({k.self_cpu_time_total / k.count:.2f} us each)", flush=True)
    return busy / per, rows


def profile_phase(eng, pixels, ids, mask, card, n_steps=8, buckets=(512, None), prefix="",
                  host_top=10, layers=None):
    """Where the kernel path's time goes: one prefill, and ``n_steps``
    greedy decode steps at each window of ``buckets`` (None: the full
    cache), the decode on the device and on the host; ``layers``: gate the
    device launches per layer (:func:`_profile`)."""
    eng.prefill(pixels, ids, mask)  # warm-up at this shape
    _profile(f"{prefix}prefill B1 266 tokens", lambda: eng.prefill(pixels, ids, mask), 1, card)
    for bucket in buckets:
        ls = eng.prefill(pixels, ids, mask)
        eng.decode_chunk(ls[0], ls[1], n_steps, kv_bucket=bucket)  # warm-up
        ls = eng.prefill(pixels, ids, mask)
        _profile(f"{prefix}greedy decode B1 W{bucket or MAX_SEQ}, {n_steps} steps",
                 lambda: eng.decode_chunk(ls[0], ls[1], n_steps, kv_bucket=bucket), n_steps,
                 card, host_top=host_top, layers=layers)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _compare(lk, lp, label, emitted, tol=LOGIT_REL_TOL):
    """Relative logit error; and the plain path's greedy token must be the
    emitted one wherever its top-2 gap exceeds the tolerance."""
    if not torch.isfinite(lk).all():
        raise AssertionError(f"{label}: non-finite kernel-path logits")
    scale = float(lp.abs().max())
    rel = float((lk - lp).abs().max()) / scale
    if rel > tol:
        raise AssertionError(f"{label}: kernel vs plain logits rel err {rel} > {tol}")
    top2 = lp[0].topk(2).values
    if float(top2[0] - top2[1]) > tol * scale:
        if int(lp[0].argmax()) != int(emitted):
            raise AssertionError(f"{label}: plain greedy {int(lp[0].argmax())} != emitted {emitted}")
        return rel, 0
    return rel, 1


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def collective_host_times(mesh, dev, card, calls=400):
    """Host time per collective of the TP decode step, without the
    profiler: ``calls`` back-to-back calls of each at the step's shapes
    (the B1 partial and the head's (logit, id) pair), timed on the host's
    clock around a final synchronization."""
    from paligemma_tpu_torch.core.mesh import all_gather, psum

    part = torch.randn(1, 2048, device=dev)
    mx = torch.randn(1, device=dev)
    for name, fn in (("psum (1, 2048) fp32", lambda: psum(part, mesh)),
                     ("all_gather (1,) fp32", lambda: all_gather(mx, mesh))):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        ms = (time.perf_counter() - t0) * 1e3 / calls
        print(f"tp (b): host time per collective, {name}, {mesh.backend} world size "
              f"{mesh.model}: {ms:.4f} ms ({calls} back-to-back calls)  [{card}]", flush=True)


def tp_step_attribution(eng, one, pixels, ids, mask, card, rounds=3):
    """How much of the TP step's extra time over one card the collectives
    take, at world size 1, where each collective is an identity: b1 decode
    ms per step of the one-card engine ``one``, of the TP engine ``eng``,
    and of ``eng`` with ``psum`` / ``all_gather`` replaced by their m = 1
    results (no torch.distributed call), in turns; medians of ``rounds``."""
    from paligemma_tpu_torch.core import mesh as mesh_lib

    real = (mesh_lib.psum, mesh_lib.all_gather)
    identity = (lambda x, mesh: x, lambda x, mesh: x.contiguous()[None])
    times = {"one card": [], "TP": [], "TP, collectives as identities": []}
    try:
        for _ in range(rounds):
            times["one card"].append(decode_step_ms(one, pixels, ids, mask))
            times["TP"].append(decode_step_ms(eng, pixels, ids, mask))
            mesh_lib.psum, mesh_lib.all_gather = identity
            times["TP, collectives as identities"].append(decode_step_ms(eng, pixels, ids, mask))
            mesh_lib.psum, mesh_lib.all_gather = real
    finally:
        mesh_lib.psum, mesh_lib.all_gather = real
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"tp (b): b1 decode ms/step in turns, median of {rounds}: "
          + ", ".join(f"{k} {v:.3f} ({', '.join(f'{x:.3f}' for x in times[k])})"
                      for k, v in med.items()) + f"  [{card}]", flush=True)
    extra = med["TP"] - med["one card"]
    coll = med["TP"] - med["TP, collectives as identities"]
    print(f"tp (b): the TP step's extra time over one card {extra:.3f} ms/step, of it the "
          f"collectives {coll:.3f} ms ({100 * coll / extra:.1f} %), the rest of the TP chain "
          f"{extra - coll:.3f} ms  [{card}]", flush=True)


def tp_one_rank_phase(params, decode, cfg, dev, card, tok_gen, tok_dense, tok_paged):
    """Run (b): the tensor-parallel engines at world size 1 over NCCL. At
    m = 1 the TP chain (B7 / B8, B7b, the fp32 partials summed by an
    all-reduce and cast after it, the vocab-shard argmax combine) computes
    the one-card chain's bits, so generate and the dense and paged serving
    runs must give the one-card kernel engines' tokens exactly. Each run's
    launch counts are zeroed just before it and read just after; B7 or B8
    and B7b run once per layer and step or tick. Then one decode window per
    TP engine under CUDA's sync debug mode. Returns the summed counts and
    the one-card kernel engines' feature-run tokens."""
    import torch.distributed as dist

    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.core.mesh import make_mesh
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    Paged = _recording_engine()
    vocab, n_layers = cfg.vocab_size, cfg.text_config.num_hidden_layers
    total: dict = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host, no cluster
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        print(f"tp (b): process group {dist.get_backend()} world size "
              f"{dist.get_world_size()}, mesh data {mesh.data} x model {mesh.model}", flush=True)
        eng = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode, mesh=mesh)
        if not (eng.fused_layer and eng.use_flash and eng._greedy_head_fused):
            raise AssertionError("the TP engine did not select the kernel paths")
        pixels, ids, mask = make_inputs(cfg, dev)
        kernels.reset_launch_counts()
        tok = eng.generate(pixels, ids, mask, max_new_tokens=N_NEW, eos_token_id=-1,
                           sync_every=16)
        sync()
        counts = kernels.launch_counts()
        print(f"tp (b): launches during TP generate(sync_every=16): {json.dumps(counts)}",
              flush=True)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        per_step = {k: counts[k] for k in ("attn_decode_tp", "mlp_decode_fused")}
        if (set(per_step.values()) != {n_layers * N_NEW}
                or counts["int8_gemv_f32"] != 2 * n_layers * N_NEW
                or counts["head_argmax"] != N_NEW or counts["attn_decode_paged_tp"]):
            raise AssertionError(f"tp (b) generate: launch counts off ({N_NEW} steps)")
        same = np.array_equal(tok, tok_gen)
        print(f"tp (b): TP generate m=1 vs the one-card kernel engine: {N_NEW} tokens identical "
              f"{same}", flush=True)
        if not same:
            raise AssertionError(f"tp (b): TP generate tokens differ:\n{tok}\n{tok_gen}")
        # W8A8 at m = 1: the single-copy TP engine's prefill gives one card's bits
        single = PaliGemmaEngine(decode, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                                 int8_act_prefill=True)
        lo, so = single.prefill(pixels, ids, mask)
        del single
        tp8 = PaliGemmaEngine(decode, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                              mesh=mesh, int8_act_prefill=True)
        kernels.reset_launch_counts()
        lt, st = tp8.prefill(pixels, ids, mask)
        sync()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        same = torch.equal(lt, lo) and all(torch.equal(st.cache[n], so.cache[n]) for n in "kv")
        print(f"tp (b): single-copy W8A8 prefill, TP m=1 vs one card: logits and KV cache "
              f"bit-identical {same}; {counts['w8a8_quant_rows']} K1, {counts['w8a8_gemm']} K2",
              flush=True)
        if not same or {counts["w8a8_quant_rows"], counts["w8a8_gemm"]} != {4 * n_layers}:
            raise AssertionError("tp (b): the TP m=1 single-copy prefill is not one card's")
        del tp8, lo, so, lt, st
        decode_rate("tp (b): TP m=1 ", eng, pixels, ids, mask, card)
        profile_phase(eng, pixels, ids, mask, card, buckets=(512,), prefix="TP m=1 NCCL ",
                      layers=n_layers)
        collective_host_times(mesh, dev, card)
        one = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
        tp_step_attribution(eng, one, pixels, ids, mask, card)
        # generate_spec under the mesh: the verify on the TP chain at draft_k + 1 rows
        spec_kw = dict(max_new_tokens=N_NEW, eos_token_id=-1, draft_k=SPEC_DRAFT_K,
                       match_n=SPEC_MATCH_N, sync_every=SPEC_SYNC)
        spec_one = one.generate_spec(pixels, ids, mask, **spec_kw)
        kernels.reset_launch_counts()
        spec_tp = eng.generate_spec(pixels, ids, mask, **spec_kw)
        sync()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        same = np.array_equal(spec_tp, spec_one) and np.array_equal(spec_tp, tok)
        print(f"tp (b): TP generate_spec m=1 ({eng.spec_cycles} cycles, draft_k "
              f"{SPEC_DRAFT_K}): {spec_tp.shape[1]} tokens identical to the one-card "
              f"generate_spec's and to TP generate's {same}; {counts['attn_decode_tp']} B7, "
              f"{counts['head_argmax']} head calls", flush=True)
        if not same or counts["attn_decode_tp"] != n_layers * _spec_verifies(
                eng.spec_cycles, SPEC_SYNC):
            raise AssertionError("tp (b): TP generate_spec differs from one card, or its "
                                 "verify calls did not run the TP chain")
        del one
        del eng
        feats_one, c_one = tp_feature_runs("tp (b) one card", params, decode, cfg, dev, card,
                                           None, None)
        feats_tp, c_tp = tp_feature_runs("tp (b) TP m=1", params, decode, cfg, dev, card, mesh,
                                         feats_one)
        for c in (c_one, c_tp):
            for k, v in c.items():
                total[k] = total.get(k, 0) + v

        for label, make, tick, want in (
                ("(b) dense TP m=1", lambda: ServingEngine(params, cfg, decode_params=decode,
                                                           mesh=mesh, **SERVE),
                 TP_DENSE_TICK, tok_dense),
                ("(b) paged TP m=1", lambda: Paged(params, cfg, decode_params=decode, mesh=mesh,
                                                   page_size=PAGE, n_pages=FULL_POOL, **SERVE),
                 TP_PAGED_TICK, tok_paged)):
            served = make()
            if not served.fused_decode or getattr(served, "paged_kernel", "fused_tp") != "fused_tp":
                raise AssertionError(f"serve {label}: the engine did not select the TP kernels")
            (toks, wall, ttft), counts = _served(label, served, serving_requests(cfg), vocab,
                                                 n_layers, tick)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            differ = [i for i in want if toks[i] != want[i]]
            print(f"serve {label}: {N_REQ - len(differ)}/{N_REQ} requests with the one-card "
                  f"kernel engine's tokens; {sum(map(len, toks.values())) / wall:.1f} tok/s "
                  f"aggregate, TTFT p50 {ttft:.1f} ms  [{card}]", flush=True)
            if differ:
                raise AssertionError(f"serve {label}: requests {differ} differ from one card")
            del served

        engines = {"dense TP greedy": ServingEngine(params, cfg, decode_params=decode,
                                                    mesh=mesh, **SERVE),
                   "paged TP": Paged(params, cfg, decode_params=decode, mesh=mesh,
                                     page_size=PAGE, n_pages=FULL_POOL, **SERVE)}
        for served in engines.values():
            for r in serving_requests(cfg)[:8]:
                r.max_new_tokens = 64
                served.submit(r)
            served.step()  # prefill the 8 rows and decode a first window
            _window_without_sync(served)
        print(f"tp (b): no host synchronization inside a decode window: {', '.join(engines)}",
              flush=True)
        del engines
    finally:
        dist.destroy_process_group()
    return total, feats_one


TP_FEATURE_REQ = 8  # requests of each feature run of tp (b) / (c)
TP_FEATURE_NEW = 24  # their budget, at most
TP_GRAMMAR = ("g", "(x[0-9])+")  # ids 5000-5009 are "x0".."x9" (tp_grammars)
TP_GRAMMAR_ROW, TP_REPEAT_ROW = 5, 7  # the constrained request; request 1's byte copy


def tp_feature_requests(cfg, bank: bool):
    """The feature runs' requests: the first TP_FEATURE_REQ of the serving
    phase's, budgets capped at TP_FEATURE_NEW; with ``bank`` they take
    [base, a, b, c] in turn. Request TP_GRAMMAR_ROW decodes under TP_GRAMMAR
    (its EOS the grammar's), request TP_REPEAT_ROW is a byte copy of request
    1 (a prefix-cache hit)."""
    reqs = serving_requests(cfg)[:TP_FEATURE_REQ]
    names = [None, *LORA_NAMES]
    for r in reqs:
        r.max_new_tokens = min(r.max_new_tokens, TP_FEATURE_NEW)
        r.lora = names[r.request_id % len(names)] if bank else None
    reqs[TP_GRAMMAR_ROW].grammar, reqs[TP_GRAMMAR_ROW].eos_token_id = TP_GRAMMAR[0], 1
    src, rep = reqs[1], reqs[TP_REPEAT_ROW]
    rep.input_ids, rep.pixel_values = src.input_ids.copy(), src.pixel_values.copy()
    rep.lora, rep.max_new_tokens = src.lora, src.max_new_tokens
    return reqs


def tp_grammars(cfg):
    """TP_GRAMMAR over surfaces " w<id>" for every id but EOS (1) and ids
    5000-5009, which are "x0".."x9": only those ten continue a match."""
    from paligemma_tpu_torch.processing import grammar as gr

    strs = [f" w{i}" for i in range(cfg.vocab_size)]
    strs[1] = ""
    for k in range(10):
        strs[5000 + k] = f"x{k}"
    return {TP_GRAMMAR[0]: gr.compile_token_dfa(gr.compile_regex(TP_GRAMMAR[1]), strs, 1)}


class _PlainLoraInTicks:
    """Counts the plain LoRA products (models/gemma._lora_delta returning a
    delta) made inside the decode ticks of ``eng`` (prefill takes the bank
    through the torch projections; a kernel tick never should), and the
    ticks."""

    def __init__(self, eng):
        self.eng, self.calls, self.ticks, self._inside = eng, 0, 0, False

    def __enter__(self):
        from paligemma_tpu_torch.models import gemma

        self._gemma, self._delta = gemma, gemma._lora_delta
        name = "_tick_paged" if hasattr(self.eng, "paged") else "_tick"
        self._name, tick = name, getattr(self.eng, name)

        def delta(*a, **kw):
            out = self._delta(*a, **kw)
            self.calls += self._inside and out is not None
            return out

        def counted(*a, **kw):
            self.ticks, self._inside = self.ticks + 1, True
            try:
                return tick(*a, **kw)
            finally:
                self._inside = False

        gemma._lora_delta = delta
        setattr(self.eng, name, counted)
        return self

    def __exit__(self, *exc):
        self._gemma._lora_delta = self._delta
        delattr(self.eng, self._name)


def _feature_serve(eng, reqs):
    """Run ``reqs`` to completion (a constrained row may stop at its EOS):
    ({id: tokens}, wall s)."""
    for r in reqs:
        eng.submit(r)
    sync()
    t0 = time.perf_counter()
    eng.run_to_completion()
    sync()
    if not all(r.done for r in reqs):
        raise AssertionError("tp features: a request did not finish")
    return {r.request_id: list(r.tokens) for r in reqs}, time.perf_counter() - t0


def _check_grammar_rows(label, toks):
    """The constrained row emitted only TP_GRAMMAR's tokens (ids 5000-5009)
    up to its EOS."""
    row = toks[TP_GRAMMAR_ROW]
    body = row[:-1] if row and row[-1] == 1 else row
    if not body or not all(5000 <= t <= 5009 for t in body):
        raise AssertionError(f"{label}: the constrained row left the grammar: {row}")


FEATURE_RUNS = ("bank dense", "bank paged", "spec dense", "spec paged")


def tp_feature_runs(label, params, decode, cfg, dev, card, mesh, one_card, say=print, *,
                    runs=FEATURE_RUNS, cache_dtype=None, as_names=None):
    """The TP engines at the JAX package's feature set against the one-card
    kernel engines (``one_card``: {run: tokens}, None to run them here):
    dense and paged serving with a bank of LORA_NAMES adapters, a grammar
    row and a prefix repeat ("bank"), and spec_decode with the grammar row
    and the repeat ("spec"; "greedy dense": the same without spec_decode).
    Gates: the tokens (``one_card`` given: within the caller's own rule);
    the grammar row in its grammar; the repeat a cache hit; per layer and
    tick of a bank run 4 shrinks, 2 K1, the qkv and gate/up expands in their
    GEMVs, and no plain LoRA product inside a tick (``as_names(label,
    counts)``: the counts under the bf16 kernels' names, for another
    activation or cache dtype). ``cache_dtype``: the engines' KV cache.
    Returns ({run: tokens}, summed launch counts)."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    Paged = _recording_engine()
    n_layers = cfg.text_config.num_hidden_layers
    adapters = lora_bank_adapters(cfg, dev, LORA_B_STD)
    grammars = tp_grammars(cfg)
    out, total = {}, {}
    for run in runs:
        bank, paged = run.startswith("bank"), run.endswith("paged")
        kw = dict(decode_params=decode, grammars=grammars, prefix_cache=True, mesh=mesh,
                  lora_bank=adapters if bank else None, spec_decode=run.startswith("spec"),
                  spec_draft_k=SPEC_DRAFT_K, fused_decode=True, cache_dtype=cache_dtype,
                  **SERVE)
        eng = (Paged(params, cfg, page_size=PAGE, n_pages=FULL_POOL, **kw) if paged
               else ServingEngine(params, cfg, **kw))
        want_kernel = ("fused" if mesh is None else "fused_tp") if paged else None
        if not eng.fused_decode or getattr(eng, "paged_kernel", None) != want_kernel:
            raise AssertionError(f"{label} {run}: the engine did not take the kernel tick")
        kernels.reset_launch_counts()
        with _PlainLoraInTicks(eng) as probe:
            toks, wall = _feature_serve(eng, tp_feature_requests(cfg, bank))
        sync()
        counts = kernels.launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if as_names is not None:
            counts = as_names(f"{label} {run}", counts)
        _check_grammar_rows(f"{label} {run}", toks)
        if eng.cache_hits < 1:
            raise AssertionError(f"{label} {run}: the repeat was not a prefix-cache hit")
        lt = n_layers * probe.ticks
        say(f"{label} {run}: launches over {probe.ticks} ticks: {json.dumps(counts)}; "
            f"{eng.cache_hits} cache hits, {probe.calls} plain LoRA products in ticks; "
            f"{sum(map(len, toks.values())) / wall:.1f} tok/s  [{card}]", flush=True)
        if bank:
            tp_chain = mesh is not None
            attn = ("attn_decode_paged_tp" if paged else "attn_decode_tp") if tp_chain else (
                "paged_decode_attention" if paged else "decode_attention")
            want = {"lora_shrink": 4 * lt, "int8_gemv_rope_kv": lt, attn: lt}
            if tp_chain:
                want.update({"int8_gemv_f32_lora": 2 * lt, "int8_gemv_f32": 0,
                             "mlp_decode_fused": lt})
            bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
            say(f"{label} {run}: per layer and tick {counts['lora_shrink'] / lt:.0f} "
                f"shrinks, the qkv and gate/up expands in their GEMVs, "
                + (f"{counts['int8_gemv_f32_lora'] / lt:.0f} K1 (o, down)" if tp_chain
                   else "the o and down expands in their residual GEMVs"), flush=True)
            if bad or probe.calls or not probe.ticks:
                raise AssertionError(f"{label} {run}: launch counts (got, want) {bad}, "
                                     f"{probe.calls} plain LoRA products inside ticks")
        elif mesh is not None and (counts["int8_gemv_f32_lora"] or not counts[
                "attn_decode_paged_tp" if paged else "attn_decode_tp"]):
            raise AssertionError(f"{label} {run}: K1 launched without a bank, or the verify "
                                 "did not run the TP chain")
        out[run] = toks
        if one_card is not None:
            differ = [i for i in toks if toks[i] != one_card[run][i]]
            say(f"{label} {run}: {len(toks) - len(differ)}/{len(toks)} requests with the "
                f"one-card kernel engine's tokens", flush=True)
            if differ:
                raise AssertionError(f"{label} {run}: requests {differ} differ from one card")
        if bank and mesh is not None and mesh.backend == "nccl":  # gloo stages on the host
            for r in tp_feature_requests(cfg, bank)[:8]:
                r.max_new_tokens = 64
                eng.submit(r)
            eng.step()
            _window_without_sync(eng)
            say(f"{label} {run}: no host synchronization inside a bank window", flush=True)
        del eng
        torch.cuda.empty_cache()
    return out, total


def _teacher_logits(eng, req, tokens):
    """fp32 logits (len(tokens), vocab) on the host: the prefill's, then one
    decode step per token fed back (the last one is not fed)."""
    ids = torch.from_numpy(req.input_ids[None].astype(np.int64))
    logits, state = eng.prefill(req.pixel_values[None], ids, torch.ones_like(ids))
    out = [logits[0].cpu()]
    for t in tokens[:-1]:
        logits, state = eng.decode_step(torch.tensor([t]), state)
        out.append(logits[0].cpu())
    return torch.stack(out)


def _teacher_bank_logits(eng, cfg, req, tokens):
    """A dense serving engine with a bank (kernel tick; under its mesh the
    TP chain): prefill ``req`` under its adapter, then feed it ``tokens``
    one decode step each (the last one is not fed). fp32 logits
    (len(tokens), vocab) on the host."""
    from paligemma_tpu_torch.models import gemma, paligemma

    dev = eng.device
    n = len(req.input_ids)
    bucket = -(-n // PAGE) * PAGE
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :n] = req.input_ids
    mask = np.zeros((1, bucket), np.int32)
    mask[0, :n] = 1
    aid = torch.tensor([eng._lora_index[req.lora]], dtype=torch.int32, device=dev)
    cache1 = gemma.init_kv_cache(cfg.text_config, 1, bucket, eng.cache_dtype, device=dev)
    logits, cache1 = paligemma.prefill(
        eng.params, cfg, torch.from_numpy(req.pixel_values[None]).to(dev),
        torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev), cache1, use_flash=True,
        last_only=True, lora=eng.lora_bank, adapter_ids=aid, mesh=eng.mesh)
    cache = gemma.init_kv_cache(cfg.text_config, 1, SERVE["max_seq_len"], eng.cache_dtype,
                                device=dev)
    for name in ("k", "v"):
        cache[name][:, :, :bucket] = cache1[name]
    valid = torch.zeros((1, SERVE["max_seq_len"]), dtype=torch.bool, device=dev)
    valid[0, :n] = True
    out = [logits[0, 0].cpu()]
    for t, tok in enumerate(tokens[:-1]):
        pos = torch.tensor([n + t], dtype=torch.int32, device=dev)
        valid[0, n + t] = True
        lk, _ = paligemma.decode_step(eng.decode_params, cfg, torch.tensor([tok], device=dev),
                                      cache, cache_pos=pos, kv_valid=valid, position_ids=pos + 1,
                                      fused_layer=True, lora=eng._lora_arg(), adapter_ids=aid,
                                      mesh=eng.mesh)
        out.append(lk[0].cpu())
    return torch.stack(out)


def _w8a8_lm_prefill(tree, cfg, mesh, dev):
    """The LM's single-copy W8A8 prefill of make_inputs' prompt
    (gemma.forward with ``int8_act`` from the int8 ``tree``) over one card's
    tower embeddings; under ``mesh`` from this rank's slices of the LM.
    Returns (the last token's logits, the K cache, the V cache)."""
    from paligemma_tpu_torch.core import mesh as mesh_lib
    from paligemma_tpu_torch.models import gemma, paligemma, siglip

    pixels, ids, mask = make_inputs(cfg, dev)
    feats = siglip.encode(tree["vision"], cfg.vision_config, pixels.to(torch.bfloat16),
                          attn=paligemma._vision_attn_mode(cfg, True))
    merged = paligemma.merge_embeddings(cfg, ids, gemma.embed_tokens(tree["lm"], ids),
                                        paligemma.project_image_features(tree, feats))
    lm = tree["lm"] if mesh is None else mesh_lib.shard_params(tree["lm"], mesh)
    tc = cfg.text_config
    n = mask.sum(-1).to(torch.int32)
    cache = gemma.init_kv_cache(tc, ids.shape[0], ids.shape[1], torch.bfloat16, device=dev)
    logits, cache = gemma.forward(lm, tc, merged, paligemma.prefill_position_ids(mask), cache,
                                  0, mask.bool(), flash_lens=(n, n), logits_idx=n - 1,
                                  mesh=mesh, int8_act=True)
    return logits, cache["k"], cache["v"]


def _tp2_rank(rank, world, init, out_dir, teacher, card):
    """One rank of run (c) (a spawned process on the shared card): the
    dense TP ServingEngine on the 12 requests over gloo, then request 0's
    one-card tokens teacher-forced through the TP kernel engine; the
    feature runs (tp_feature_runs: a bank, a grammar, a prefix repeat,
    spec_decode, dense and paged) and an adapter request's tokens
    teacher-forced through the TP engine with the gate bank. Rank 0 also
    runs the one-card kernel engines on the same tokens. Writes its tokens
    and logits' agreement to ``out_dir``."""
    import torch.distributed as dist

    from paligemma_tpu_torch import paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.core.mesh import make_mesh
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TP2_TIMEOUT))
    try:
        cfg = paligemma_3b_224()
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                             torch.bfloat16)
        decode = quantize_lm_for_serving(params)
        mesh = make_mesh(1, world)
        eng = ServingEngine(params, cfg, decode_params=decode, mesh=mesh, **SERVE)
        if not eng.fused_decode:
            raise AssertionError("run (c): the TP serving engine did not select the kernels")
        toks, wall, ttft = _serve(eng, serving_requests(cfg), cfg.vocab_size)
        del eng
        req = serving_requests(cfg)[0]
        tp = PaliGemmaEngine(params, cfg, max_seq_len=1024, decode_params=decode, mesh=mesh)
        lt = _teacher_logits(tp, req, teacher)
        del tp
        out = {"tokens": toks, "wall": wall, "ttft": ttft,
               "w8a8": [t.cpu() for t in _w8a8_lm_prefill(decode, cfg, mesh, dev)]}
        t0 = time.perf_counter()
        out["features"], _ = tp_feature_runs(
            f"tp (c) m={world} rank {rank}", params, decode, cfg, dev, card, mesh, None,
            say=print if rank == 0 else (lambda *a, **kw: None))
        out["features_s"] = time.perf_counter() - t0
        gate = lora_bank_adapters(cfg, dev, LORA_B_STD_GATE)
        lreq = tp_feature_requests(cfg, True)[1]  # adapter "a"
        tp_bank = ServingEngine(params, cfg, decode_params=decode, mesh=mesh, lora_bank=gate,
                                **SERVE)
        lt_bank = _teacher_bank_logits(tp_bank, cfg, lreq, out["features"]["bank dense"][1])
        del tp_bank
        if rank == 0:
            out["w8a8_one"] = [t.cpu() for t in _w8a8_lm_prefill(decode, cfg, None, dev)]
            one = PaliGemmaEngine(params, cfg, max_seq_len=1024, decode_params=decode)
            lo = _teacher_logits(one, req, teacher)
            if not torch.isfinite(lt).all():
                raise AssertionError("run (c): non-finite TP logits")
            out["rel_err"] = float(((lt - lo).abs().amax(-1) / lo.abs().amax(-1)).max())
            del one
            one_bank = ServingEngine(params, cfg, decode_params=decode, lora_bank=gate, **SERVE)
            lo_bank = _teacher_bank_logits(one_bank, cfg, lreq, out["features"]["bank dense"][1])
            if not torch.isfinite(lt_bank).all():
                raise AssertionError("run (c): non-finite TP logits with the bank")
            out["bank_rel_err"] = float(((lt_bank - lo_bank).abs().amax(-1)
                                         / lo_bank.abs().amax(-1)).max())
            out["bank_tokens"] = len(lo_bank)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_two_rank_phase(cfg, card, tok_dense):
    """Run (c): two processes share the one card as the two ranks of a
    model axis of 2 (gloo; the collectives stage through host memory, the
    products stay on the card), serving the 12 requests with the dense TP
    ServingEngine. Gate: every rank emits the same tokens, and request 0's
    teacher-forced logits lie within LOGIT_REL_TOL of the one-card kernel
    path's. Printed, not gated: greedy agreement with the one-card tokens,
    since a bf16 near tie can flip at full width with random weights."""
    import torch.multiprocessing as mp

    world = 2
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_tp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.start_processes(_tp2_rank, args=(world, str(work / "init"), str(work),
                                              tok_dense[0], card),
                             nprocs=world, start_method="spawn", join=False)
    try:
        deadline = time.monotonic() + TP2_TIMEOUT
        while not ctx.join(timeout=5):  # raises if a rank failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"run (c): {world} ranks did not finish in {TP2_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    outs = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(work, ignore_errors=True)
    toks = outs[0]["tokens"]
    if any(o["tokens"] != toks for o in outs[1:]):
        raise AssertionError("run (c): the ranks emitted different tokens")
    same = sum(toks[i] == tok_dense[i] for i in tok_dense)
    n_tok = sum(map(len, tok_dense.values()))
    agree = sum(x == y for i in tok_dense for x, y in zip(toks[i], tok_dense[i]))
    first = [(i, next(j for j, (x, y) in enumerate(zip(toks[i], tok_dense[i])) if x != y))
             for i in sorted(tok_dense) if toks[i] != tok_dense[i]]
    print(f"tp (c): {world} ranks on one card over gloo, dense TP ServingEngine, {N_REQ} "
          f"requests in {time.perf_counter() - t0:.1f} s (process start and weights included): "
          f"every rank emitted the same tokens; {same}/{N_REQ} requests and {agree}/{n_tok} "
          f"tokens equal the one-card kernel engine's; first divergence (request, token): "
          f"{first[0] if first else 'none'}; serving wall {outs[0]['wall']:.2f} s, TTFT p50 "
          f"{outs[0]['ttft']:.1f} ms  [{card}]", flush=True)
    one = outs[0]["w8a8_one"]
    same = all(torch.equal(a, b) for o in outs for a, b in zip(o["w8a8"], one))
    print(f"tp (c): the LM's single-copy W8A8 prefill over one card's tower embeddings, "
          f"{world} gloo ranks vs one card: last-token logits and KV cache bit-identical on "
          f"every rank {same}", flush=True)
    if not same:
        raise AssertionError(f"tp (c): the W8A8 prefill at m={world} is not one card's bits")
    worst = outs[0]["rel_err"]
    print(f"tp (c): request 0's {len(tok_dense[0])} one-card tokens teacher-forced, TP m=2 vs "
          f"one-card kernel logits: max rel err {worst:.3e} (tol {LOGIT_REL_TOL})", flush=True)
    if not worst <= LOGIT_REL_TOL:
        raise AssertionError(f"run (c): TP m=2 logits rel err {worst} > {LOGIT_REL_TOL}")
    feats = outs[0]["features"]
    if any(o["features"] != feats for o in outs[1:]):
        raise AssertionError("run (c): the ranks emitted different tokens in the feature runs")
    print(f"tp (c): feature runs ({', '.join(feats)}; {TP_FEATURE_REQ} requests each) in "
          f"{outs[0]['features_s']:.1f} s over gloo: every rank emitted the same tokens "
          f"(a correctness run: the collectives stage through host memory)  [{card}]",
          flush=True)
    worst = outs[0]["bank_rel_err"]
    print(f"tp (c): an adapter request's {outs[0]['bank_tokens']} tokens teacher-forced with "
          f"the bank (B std {LORA_B_STD_GATE}), TP m=2 kernel tick vs one-card kernel tick "
          f"logits: max rel err {worst:.3e} (tol {LOGIT_REL_TOL})", flush=True)
    if not worst <= LOGIT_REL_TOL:
        raise AssertionError(f"run (c): TP m=2 logits with the bank rel err {worst} > "
                             f"{LOGIT_REL_TOL}")


# ---------------------------------------------------------------------------
# dp: the data axis of serving and inference, its ranks sharing the one card
# ---------------------------------------------------------------------------
DP_TIMEOUT = 900  # seconds, each spawn of the dp phase
DP_POOL = SMALL_POOL  # run (b)'s pool, 22 pages a shard: a shard must preempt
DP_FULL_POOL = FULL_POOL + 1  # an even pool (65 pages a shard): no preemption
DPTP_NEW = 16  # the DP x TP run: the serving phase's first TP_FEATURE_REQ requests, 16 tokens
# the DP x TP paged tick: run (b)'s TP paged tick at the rank's 4 slots
DPTP_TICK = TP_PAGED_TICK


def _near_ties(label, one, cfg, reqs, toks, want, bank=None, tol=LOGIT_REL_TOL):
    """Rows of ``toks`` ({id: tokens}) that differ from ``want`` (the
    one-card kernel engine's): each is teacher-forced along its own tokens
    through the one-card kernel engine ``one`` (a PaliGemmaEngine, or with
    ``bank`` a dense ServingEngine with the bank), and every token it
    emitted must lie within ``tol`` of the top logit (of max |logit|): a
    near tie (bf16: LOGIT_REL_TOL) that another prefill batch size's bits
    may flip.
    Constrained rows are held by their grammar instead. Returns a phrase:
    the identical rows, and the largest gap seen over max |logit|."""
    worst = 0.0
    by_id = {r.request_id: r for r in reqs}
    differ = [i for i in toks if toks[i] != want[i]]
    for i in differ:
        req = by_id[i]
        if req.grammar is not None:
            continue
        tokens = toks[i]
        lg = (_teacher_bank_logits(one, cfg, req, tokens) if bank else
              _teacher_logits(one, req, tokens))
        if not torch.isfinite(lg).all():
            raise AssertionError(f"dp {label}: non-finite teacher-forced logits")
        picked = lg.gather(1, torch.tensor(tokens)[:, None])[:, 0]
        gap = float(((lg.max(dim=1).values - picked) / lg.abs().amax(dim=1)).max())
        worst = max(worst, gap)
        if gap > tol:
            raise AssertionError(f"dp {label}: request {i}'s tokens leave the one-card logits' "
                                 f"top by {gap:.3e} of max |logit| (tol {tol})")
    said = f"{len(toks) - len(differ)}/{len(toks)} requests with the one-card kernel engine's " \
        "tokens"
    if differ:
        said += (f"; the others' tokens within {worst:.3e} of max |logit| of the one-card top "
                 f"logit, teacher-forced (tol {tol})")
    return said


def _dp_rank(rank, world, data, init, out_dir, refs_file, card):
    """One rank of the dp phase's engine runs (a spawned process on the
    shared card; gloo): PaliGemma-3B at full width and depth from seed 0,
    the int8 decode tree, under ``make_mesh(data, world // data)``. With a
    model axis of 1 (pure DP): the paged engine on the serving phase's 12
    requests with run (b)'s 44-page pool (a shard preempts), the feature
    runs (a bank, a grammar row, a prefix repeat; spec_decode with the
    grammar row and the repeat), one decode window under CUDA's sync debug
    mode, and generate at B = 2. With a model axis of 2 (DP x TP): the
    paged engine on the TP paged chain, TP_FEATURE_REQ requests of
    DPTP_NEW tokens, and request 0's one-card tokens teacher-forced
    through the DP x TP PaliGemmaEngine. Each run's launch counts are
    zeroed just before it and read just after, and gated. Rank 0 holds the
    tokens against the one-card kernel engine's (``refs_file``; differing
    rows must be near ties, ``_near_ties``). Every rank writes its tokens
    to ``out_dir``."""
    import contextlib
    import io

    import torch.distributed as dist

    from paligemma_tpu_torch import kernels, paligemma_3b_224
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.core.mesh import make_mesh
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    quiet = contextlib.redirect_stdout(io.StringIO()) if rank else contextlib.nullcontext()
    try:
        with quiet:
            cfg = paligemma_3b_224()
            params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                                 torch.bfloat16)
            decode = quantize_lm_for_serving(params)
            mesh = make_mesh(data, world // data)
            refs = torch.load(refs_file, weights_only=False)
            Paged = _recording_engine()
            vocab, n_layers = cfg.vocab_size, cfg.text_config.num_hidden_layers
            tag = f"d={mesh.data} x m={mesh.model}"
            out, lines = {}, []

            def paged(n_pages, **kw):
                eng = Paged(params, cfg, decode_params=decode, page_size=PAGE, n_pages=n_pages,
                            mesh=mesh, **SERVE, **kw)
                want = "fused" if mesh.model == 1 else "fused_tp"
                if (eng.paged_kernel != want or not eng.fused_decode or not eng.use_flash
                        or eng.paged.n_shards != data):
                    raise AssertionError(f"dp {tag}: the engine did not take the kernel tick")
                return eng

            def seats(reqs):
                return {r.request_id: r.slot for r in reqs}

            if mesh.model == 1:
                reqs = serving_requests(cfg)
                eng = paged(DP_POOL)
                (toks, wall, ttft), counts = _served(f"dp {tag} (pool {DP_POOL})", eng, reqs,
                                                     vocab, n_layers, PAGED_FUSED_TICK)
                if eng.preemptions < 1:
                    raise AssertionError(f"dp {tag}: the {DP_POOL}-page pool did not preempt")
                out["serve"] = (toks, seats(reqs), eng.preemptions, eng.prefill_calls)
                lines.append(f"serve: {N_REQ} requests, {SERVE['max_slots']} slots "
                             f"({SERVE['max_slots'] // data} a shard), a {DP_POOL}-page pool "
                             f"({DP_POOL // data} a shard): {eng.preemptions} preemptions "
                             f"(first evictions after {eng.first_eviction} tokens), "
                             f"{sum(map(len, toks.values())) / wall:.1f} tok/s, TTFT p50 "
                             f"{ttft:.1f} ms")
                del eng
                adapters = lora_bank_adapters(cfg, dev, LORA_B_STD)
                grammars = tp_grammars(cfg)
                for run, bank in (("bank paged", True), ("spec paged", False)):
                    eng = paged(DP_FULL_POOL, grammars=grammars, prefix_cache=True,
                                lora_bank=adapters if bank else None, spec_decode=not bank,
                                spec_draft_k=SPEC_DRAFT_K)
                    kernels.reset_launch_counts()
                    reqs = tp_feature_requests(cfg, bank)
                    toks, wall = _feature_serve(eng, reqs)
                    sync()
                    counts = kernels.launch_counts()
                    _check_grammar_rows(f"tp dp {run}", toks)
                    need = ["flash_attention_fwd", "int8_gemv_rope_kv", "paged_decode_attention",
                            "rms_norm"] + (["lora_shrink"] if bank else [])
                    if eng.cache_hits < 1 or any(counts[k] == 0 for k in need):
                        raise AssertionError(f"dp {tag} {run}: {eng.cache_hits} cache hits, "
                                             f"launches {counts}")
                    out[run] = (toks, seats(reqs))
                    lines.append(f"{run}: launches {json.dumps(counts)}; {eng.cache_hits} "
                                 f"cache hits; {sum(map(len, toks.values())) / wall:.1f} tok/s")
                    del eng
                    torch.cuda.empty_cache()
                eng = paged(DP_FULL_POOL)
                for r in serving_requests(cfg)[:8]:
                    r.max_new_tokens = 64
                    eng.submit(r)
                eng.step()
                _window_without_sync(eng)
                lines.append("no host synchronization inside a decode window (CUDA's sync debug "
                             "mode; the shards' tokens are gathered at the read-back)")
                del eng
                gen = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode,
                                      mesh=mesh)
                pixels, ids, mask = make_inputs(cfg, dev)
                pixels2 = torch.cat([pixels, pixels.flip(-1)])
                ids2, mask2 = ids.repeat(2, 1), mask.repeat(2, 1)
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                out["generate"] = gen.generate(pixels2, ids2, mask2, max_new_tokens=N_NEW,
                                               eos_token_id=-1, sync_every=16)
                sync()
                counts = kernels.launch_counts()
                if any(counts[k] == 0 for k in GENERATE_KERNELS):
                    raise AssertionError(f"dp {tag} generate: launch counts {counts}")
                lines.append(f"generate B=2 (one row a rank): {out['generate'].shape[1]} tokens "
                             f"a row in {time.perf_counter() - t0:.2f} s; launches "
                             f"{json.dumps(counts)}")
                del gen
            else:
                reqs = serving_requests(cfg)[:TP_FEATURE_REQ]
                for r in reqs:
                    r.max_new_tokens = DPTP_NEW
                eng = paged(DP_FULL_POOL)
                (toks, wall, ttft), counts = _served(f"dp {tag}", eng, reqs, vocab, n_layers,
                                                     DPTP_TICK)
                out["dptp"] = (toks, seats(reqs))
                lines.append(f"TP paged chain: {len(reqs)} requests of {DPTP_NEW} tokens, "
                             f"{SERVE['max_slots'] // data} slots a shard: "
                             f"{sum(map(len, toks.values())) / wall:.1f} tok/s, TTFT p50 "
                             f"{ttft:.1f} ms")
                del eng
                torch.cuda.empty_cache()
                tp = PaliGemmaEngine(params, cfg, max_seq_len=1024, decode_params=decode,
                                     mesh=mesh)
                lt = _teacher_logits(tp, serving_requests(cfg)[0], refs["serve"][0][:DPTP_NEW])
                del tp
            if rank == 0:
                one = PaliGemmaEngine(params, cfg, max_seq_len=MAX_SEQ, decode_params=decode)
                if mesh.model == 1:
                    lines.append("serve: " + _near_ties("serve", one, cfg, serving_requests(cfg),
                                                        out["serve"][0], refs["serve"]))
                    one_gen = one.generate(pixels2, ids2, mask2, max_new_tokens=N_NEW,
                                           eos_token_id=-1, sync_every=16)
                    gen_reqs = [dataclasses.replace(serving_requests(cfg)[0], request_id=i,
                                                    input_ids=ids2[i].cpu().numpy(),
                                                    pixel_values=pixels2[i].cpu().numpy())
                                for i in range(2)]
                    lines.append("generate B=2: " + _near_ties(
                        "generate", one, cfg, gen_reqs,
                        {i: out["generate"][i].tolist() for i in range(2)},
                        {i: one_gen[i].tolist() for i in range(2)}))
                    for run, bank in (("bank paged", True), ("spec paged", False)):
                        judge = one if not bank else ServingEngine(
                            params, cfg, decode_params=decode, lora_bank=adapters, **SERVE)
                        lines.append(f"{run}: " + _near_ties(
                            run, judge, cfg, tp_feature_requests(cfg, bank), out[run][0],
                            refs[run], bank))
                        del judge
                else:
                    want = {i: refs["serve"][i][:DPTP_NEW] for i in range(TP_FEATURE_REQ)}
                    fresh = serving_requests(cfg)[:TP_FEATURE_REQ]
                    said = _near_ties("dptp", one, cfg, fresh, out["dptp"][0], want)
                    lo = _teacher_logits(one, fresh[0], want[0])
                    if not torch.isfinite(lt).all():
                        raise AssertionError(f"dp {tag}: non-finite DP x TP logits")
                    rel = float(((lt - lo).abs().amax(-1) / lo.abs().amax(-1)).max())
                    lines.append(f"TP paged chain: {said}; request 0's {DPTP_NEW} one-card "
                                 f"tokens teacher-forced, DP x TP vs one card logits: max rel "
                                 f"err {rel:.3e} (tol {LOGIT_REL_TOL})")
                    if not rel <= LOGIT_REL_TOL:
                        raise AssertionError(f"dp {tag}: logits rel err {rel} > {LOGIT_REL_TOL}")
                del one
            torch.save({"out": out, "lines": lines},
                       os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_spawn(label, data, model, work, refs_file, card):
    """Spawn ``data x model`` ranks of ``_dp_rank`` on the card; their
    outputs, every rank's the same (else raises)."""
    import torch.multiprocessing as mp

    world = data * model
    d = work / label
    d.mkdir(parents=True)
    ctx = mp.start_processes(_dp_rank, args=(world, data, str(d / "init"), str(d), refs_file,
                                             card),
                             nprocs=world, start_method="spawn", join=False)
    try:
        deadline = time.monotonic() + DP_TIMEOUT
        while not ctx.join(timeout=5):  # raises if a rank failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"dp {label}: {world} ranks did not finish in {DP_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(world)]
    for o in outs[1:]:
        for k, v in outs[0]["out"].items():
            same = (np.array_equal(v, o["out"][k]) if isinstance(v, np.ndarray)
                    else v == o["out"][k])
            if not same:
                raise AssertionError(f"dp {label}: the ranks disagree on {k}")
    return outs[0]


def dp_phase(cfg, card, tok_paged, feats_one):
    """The data axis on the one card: two gloo ranks as a data axis of 2
    (pure DP) and four as 2 x 2 (DP x TP) run ``_dp_rank``'s engine runs
    (every rank the same tokens and seats; rank 0 holds them against the
    one-card kernel engine's ``tok_paged`` / ``feats_one``). The ranks share
    the card, so the collectives stage through host memory: these runs show
    that the results are right, not the speed of DP (tok/s printed as
    such). The CLIs' ``--data_parallel 2``: ``cli_tp_phase(data=2)``."""
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    refs_file = str(work / "refs.pt")
    torch.save({"serve": tok_paged, **feats_one}, refs_file)
    try:
        for label, data, model in (("d=2", 2, 1), ("d=2 x m=2", 2, 2)):
            t0 = time.perf_counter()
            got = _dp_spawn(label.replace(" ", ""), data, model, work, refs_file, card)
            for line in got["lines"]:
                print(f"dp {label}: {line}  [{card}]", flush=True)
            print(f"dp {label}: {data * model} ranks on one card over gloo in "
                  f"{time.perf_counter() - t0:.1f} s (process start and weights included): "
                  f"every rank the same tokens and seats; tok/s above show correctness, not "
                  f"the speed of DP (the ranks share one card; collectives through host "
                  f"memory)  [{card}]", flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ------------------------------------------------------------- train_mesh ----
# the training half of the mesh on the one card: gloo ranks that share it
TM_TIMEOUT = 900  # seconds: the model group's collectives in a spawn
TM_STEPS = 2  # steps of each Trainer run
TM_LR = 1e-3
TM_LOSS_REL_TOL = 1e-3
# adapters after TM_STEPS steps against one card's: the ranks sum bf16
# partials and gradients in another order, and Adam moves an element whose
# gradient is near its eps by up to 2 lr a step on such a difference, so
# each leaf is held on the mean |difference| against the mean |movement| of
# one card's adapters from their start (the largest difference printed)
TM_ADAPTER_REL_TOL = 0.1
# every run of the phase is at this depth (LM and tower layers, full widths):
# at 18 layers a full fine-tune's step of layer gathers through host memory
# takes ~33 s and the CLI's two saves write 2 x 15 GB, past the card
# machine's budget of disk writes for the whole script; the LoRA runs took
# ~100 s more at 18 layers, which the script's time limit no longer holds
TM_CUT_LAYERS = 2
TM_MESHES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
_TM_LORA = dict(lora_rank=8, lora_alpha=8.0, learning_rate=TM_LR, warmup_steps=0)
TM_RUNS = {  # name -> TrainConfig kwargs; "nf4": a 4-bit base
    "lora": _TM_LORA,
    "lora_acc2": dict(_TM_LORA, grad_accum_steps=2),
    "fsdp": dict(lora_rank=None, learning_rate=TM_LR, fsdp=True),
    "nf4": _TM_LORA,
}
TM_PLAN = {"2x1": ("lora", "lora_acc2", "fsdp"), "1x2": ("lora", "lora_acc2", "nf4"),
           "2x2": ("lora", "lora_acc2")}
# the CLI runs on the cut checkpoint: one epoch of the quick manifest's 4
# rows (2 steps); label -> flags; "resume" resumes the 2 x 1 "lora" run
TM_CLI_FLAGS = ("--epochs", "1", "--batch_size", "2", "--grad_accum", "1", "--lora_rank", "8",
                "--max_length", "512", "--learning_rate", "1e-3", "--warmup_steps", "0")
TM_CLI = {"2x1": (("lora", ("--data_parallel", "2")),
                  ("export", ("--data_parallel", "2", "--export_hf")),
                  ("fsdp", ("--fsdp", "--full_finetune", "--data_parallel", "2"))),
          "1x2": (("resume", ("--model_parallel", "2")),),
          "2x2": ()}


def _tm_cut(cfg):
    """``cfg`` at TM_CUT_LAYERS decoder and tower layers, full widths."""
    return dataclasses.replace(
        cfg, text_config=dataclasses.replace(cfg.text_config, num_hidden_layers=TM_CUT_LAYERS),
        vision_config=dataclasses.replace(cfg.vision_config, num_hidden_layers=TM_CUT_LAYERS))


def _lm_numel(tc) -> int:
    """The Gemma decoder's parameter count at config ``tc``."""
    h, i, n = tc.hidden_size, tc.intermediate_size, tc.num_hidden_layers
    hq, hkv = tc.num_attention_heads * tc.head_dim, tc.num_key_value_heads * tc.head_dim
    return tc.vocab_size * h + h + n * (2 * h + h * (2 * hq + 2 * hkv) + 3 * h * i)


def _tm_bytes(tr) -> int:
    """This rank's persistent training state: the trained tensors and their
    optimizer moments (and accumulators)."""
    from paligemma_tpu_torch.train.trainer import _leaves as t_leaves

    held = t_leaves(tr._trainable(tr.params, tr.lora))
    held += [t for k in ("mu", "nu", "acc") for t in tr.opt_state.get(k, [])]
    return sum(t.numel() * t.element_size() for t in held)


def _tm_adapters(state):
    return {name: {k: v.detach().float().cpu().clone() for k, v in leaf.items()}
            for name, leaf in state["lora"]["layers"].items()}


def _tm_trainer_runs(names, cfg, dev, mesh):
    """The Trainer runs ``names`` (TM_RUNS) on train_batch, TM_STEPS steps
    each, under ``mesh`` (None: one card), each counted on its own: {name:
    losses, launch counts, adapters in one card's layout (LoRA), this
    rank's state bytes, wall s}."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_training
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    batch = train_batch(cfg)
    run_cfg = _tm_cut(cfg)
    out = {}
    params = init_params(run_cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                         torch.bfloat16)
    for name in names:
        base = (quantize_lm_for_training(params, "nf4", 64, fuse=False) if name == "nf4"
                else params)
        tr = Trainer(base, run_cfg, TrainConfig(**TM_RUNS[name]), mesh=mesh,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
        start = _tm_adapters(tr._state()) if tr.lora is not None else None
        sync()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses = [tr.train_step(batch) for _ in range(TM_STEPS)]
        sync()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        rec = {"losses": losses, "counts": counts, "bytes": _tm_bytes(tr), "wall": wall,
               "layers": run_cfg.text_config.num_hidden_layers}
        if tr.lora is not None:
            rec["lora"], rec["start"] = _tm_adapters(tr._state()), start
        out[name] = rec
        del tr, base
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return out


def _tm_entry(argv, rank):
    """One rank of a train_mesh spawn (cli/ranks.launch: the ranks share
    the card over gloo): ``argv`` = [work dir, mesh tag, the cli phase's
    checkpoint, its copy cut to TM_CUT_LAYERS, the quick manifest, a state
    to resume from]. The Trainer runs of TM_PLAN[tag], then cli.finetune's
    rank body on TM_CLI[tag]'s flags (stand-ins installed here: a spawned
    process starts without them); rank 0 reads each run's metrics.jsonl
    and removes a full fine-tune's output at once (its saves are the
    largest writes). The rank writes its record to the work dir."""
    import contextlib
    import io

    from paligemma_tpu_torch.cli import finetune
    from paligemma_tpu_torch.core.config import PaliGemmaConfig

    work, tag, ckpt, cut_ckpt, manifest, resume = argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PaliGemmaConfig.from_hf_json(ckpt)  # the 3B config the cli phase wrote
    rec = {"device": str(rank.device), "backend": rank.backend,
           "mesh": (rank.mesh.data, rank.mesh.model),
           "runs": _tm_trainer_runs(TM_PLAN[tag], cfg, rank.device, rank.mesh), "cli": {}}
    for label, flags in TM_CLI[tag]:
        out_dir = os.path.join(work, f"{tag}_{label}")
        cli_argv = ["--model_path", cut_ckpt, "--train_jsonl", manifest,
                    "--output_dir", out_dir, *TM_CLI_FLAGS, *flags]
        if label == "resume":
            cli_argv += ["--resume_from", resume]
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with _StandIns(cfg.image_token_index), contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                finetune._rank_main(cli_argv, rank)
        finally:
            rec["cli"][label] = {"stdout": out.getvalue(), "stderr": err.getvalue(),
                                 "wall": time.perf_counter() - t0}
        if rank.lead:
            rec["cli"][label]["metrics"] = _tm_metrics(out_dir)
            rec["cli"][label]["saved"] = sorted(os.listdir(out_dir))
            if "--full_finetune" in flags:
                shutil.rmtree(out_dir)
    torch.save(rec, os.path.join(work, f"{tag}_rank{rank.rank}.pt"))


def _tm_multihost_main():
    """One process of train_mesh (e): ``python3 -c "import chip_smoke;
    chip_smoke._tm_multihost_main()" <image token id> <cli.finetune flags>``,
    the CLI with the stand-ins installed."""
    from paligemma_tpu_torch.cli import finetune

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with _StandIns(int(sys.argv[1])):
        finetune.main(sys.argv[2:])


def _tm_metrics(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _tm_losses(metrics):
    return [m["train_loss"] for m in metrics if "train_loss" in m]


def _tm_rel(got, want) -> float:
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def _tm_hold_losses(label, got, want, card):
    rel = _tm_rel(got, want)
    print(f"train_mesh {label}: losses {' '.join(f'{x:.5f}' for x in got)} against one card's "
          f"{' '.join(f'{x:.5f}' for x in want)}: max rel {rel:.3e} (tol {TM_LOSS_REL_TOL})  "
          f"[{card}]", flush=True)
    if len(got) != len(want) or not rel <= TM_LOSS_REL_TOL:
        raise AssertionError(f"train_mesh {label}: losses {got} against one card's {want}")


def _tm_hold_adapters(label, got, want, start):
    """Each adapter leaf: mean |got - want| within TM_ADAPTER_REL_TOL of the
    mean |want - start| (one card's movement); prints the worst ratio and
    the largest difference."""
    worst, biggest = 0.0, 0.0
    for name, leaf in want.items():
        for k, w in leaf.items():
            g, s0 = got[name][k], start[name][k]
            moved = float((w - s0).abs().mean())
            diff = float((g - w).abs().mean())
            biggest = max(biggest, float((g - w).abs().max()))
            if moved > 0:
                worst = max(worst, diff / moved)
            elif diff > 0:
                raise AssertionError(f"train_mesh {label}: {name}.{k} moved where one card's "
                                     "did not")
    print(f"train_mesh {label}: adapters' mean |difference| from one card's at most "
          f"{worst:.3e} of one card's mean movement (tol {TM_ADAPTER_REL_TOL}); the largest "
          f"difference {biggest:.3e} (lr {TM_LR})", flush=True)
    if not worst <= TM_ADAPTER_REL_TOL:
        raise AssertionError(f"train_mesh {label}: adapters {worst} > {TM_ADAPTER_REL_TOL}")


def _tm_check_spawn(tag, recs, refs, card):
    """Every rank of a spawn the same losses; each Trainer run held against
    one card's (losses, adapters, launches per step: TRAIN_PER_STEP at 18
    layers, scaled at the cut depth); each CLI run printed on rank 0 only.
    Returns the summed launch counts of the spawn's Trainer runs."""
    total: dict = {}
    world = len(recs)
    for r, rec in enumerate(recs):
        if rec["device"] != "cuda:0" or rec["backend"] != "gloo" or \
                tuple(rec["mesh"]) != TM_MESHES[tag]:
            raise AssertionError(f"train_mesh {tag}: rank {r} on {rec['device']} over "
                                 f"{rec['backend']}, mesh {rec['mesh']}")
    for name in TM_PLAN[tag]:
        runs = [rec["runs"][name] for rec in recs]
        if any(x["losses"] != runs[0]["losses"] for x in runs[1:]):
            raise AssertionError(f"train_mesh {tag} {name}: the ranks disagree on the losses")
        layers = runs[0]["layers"]
        per_step = {k: v * layers // 18 for k, v in TRAIN_PER_STEP.items()}
        want_counts = {k: per_step.get(k, 0) * TM_STEPS for k in runs[0]["counts"]}
        for r, x in enumerate(runs):
            if x["counts"] != want_counts:
                raise AssertionError(f"train_mesh {tag} {name}: rank {r} launched "
                                     f"{x['counts']}, want {want_counts}")
            for k, v in x["counts"].items():
                total[k] = total.get(k, 0) + v
        ref = refs["runs"][name]
        label = f"{tag} {name} ({layers} layers)"
        _tm_hold_losses(f"{label}, {world} ranks, {TM_STEPS} steps", runs[0]["losses"],
                        ref["losses"], card)
        if "lora" in ref:
            _tm_hold_adapters(label, runs[0]["lora"], ref["lora"], ref["start"])
        if name == "fsdp":
            print(f"train_mesh {label}: each rank holds {', '.join(str(x['bytes']) for x in runs)}"
                  f" bytes of trained weights and moments against one card's {ref['bytes']} "
                  f"({max(x['bytes'] for x in runs) / ref['bytes']:.3f} of it)", flush=True)
        print(f"train_mesh {label}: every rank launched "
              f"{json.dumps({k: v for k, v in want_counts.items() if v})} (its own heads and "
              f"rows); the run's wall {runs[0]['wall']:.2f} s, correctness only (gloo ranks "
              f"share the card)  [{card}]", flush=True)
    for label, _ in TM_CLI[tag]:
        said = [rec["cli"][label]["stdout"] for rec in recs]
        if not said[0].endswith("done\n") or any(said[1:]):
            raise AssertionError(f"train_mesh {tag} cli {label}: rank 0 printed "
                                 f"{said[0][-300:]!r}, the others {said[1:]}")
        print(f"train_mesh (d) {tag} cli.finetune {label}: {recs[0]['cli'][label]['wall']:.1f} "
              f"s, only rank 0 printed; it wrote {recs[0]['cli'][label]['saved']}", flush=True)
    return total


def train_mesh_phase(cfg, dev, card, ckpt):
    """The training half of the mesh at full width (PaliGemma-3B 224,
    seeded bf16 weights, train_batch: B 2, S 512, prefix 268; LoRA r8 on all
    seven targets, remat), on gloo ranks that share the card (cli/
    ranks.launch with ``_tm_entry``; the collectives stage through host
    memory, so these runs show that the results are right, not the speed
    of a mesh):

    Every run is at TM_CUT_LAYERS layers (a copy of the cli phase's
    checkpoint cut to them, or seeded weights of that depth):

    (a) Trainer under make_mesh(2, 1), (1, 2) and (2, 2):
        TM_STEPS LoRA steps with grad_accum_steps 1, and a run with 2,
        against one card's Trainer on the same batch: losses within
        TM_LOSS_REL_TOL, adapters by TM_ADAPTER_REL_TOL; every rank
        launches B1 and B6 exactly TRAIN_PER_STEP a step at its own heads
        and rows;
    (b) a full fine-tune at data 2 with fsdp=True against one card's
        losses; each rank's trained weights and moments in bytes against
        one card's;
    (c) QLoRA over an NF4 base at model 2 (4-bit trees sharded);
    (d) cli.finetune: --data_parallel 2, its final/ resumed on one card
        (cli.finetune --resume_from) and under --model_parallel 2, all
        against one-card Trainers (restored from that final/ for the
        resumed runs); --data_parallel 2 with --export_hf (read back by
        cli.infer) and --fsdp --full_finetune --data_parallel 2;
    (e) two --multihost --coordinator 127.0.0.1:<port> processes (a model
        axis of 2 on one host), against one card's Trainer on the CLI's
        batches.

    Returns the launch counts summed over the ranks' Trainer runs (each
    counted on its own)."""
    import tempfile

    from paligemma_tpu_torch.checkpoints.hf_export import export_hf_checkpoint
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.cli import finetune, infer, ranks
    from paligemma_tpu_torch.convert import init_params
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    t_phase = time.perf_counter()
    vc = cfg.vision_config
    cut_cfg = _tm_cut(cfg)
    work = tempfile.mkdtemp(prefix="train_mesh_", dir=os.path.dirname(ckpt))
    # the cut checkpoint (bf16), its fp32 export and the full fine-tune's two
    # states (the LM and two moments, bf16), with the whole model's share
    n_cut = _lm_numel(cut_cfg.text_config)
    need = 2 * 2 * n_cut + 4 * 2 * n_cut + 2 * 3 * 2 * n_cut
    free = shutil.disk_usage(work).free
    print(f"train_mesh: {free} bytes free under {work}, {need} needed", flush=True)
    if free < need + CLI_DISK_SLACK:
        shutil.rmtree(work, ignore_errors=True)
        raise AssertionError("train_mesh: no room for the phase's outputs")
    total: dict = {}

    def proc():
        return PaliGemmaProcessor(_WordTokenizer(cfg.image_token_index), vc.num_image_tokens,
                                  vc.image_size)

    def cli_tc(**kw):  # the CLI's TrainConfig under TM_CLI_FLAGS
        return TrainConfig(**{"learning_rate": TM_LR, "grad_accum_steps": 1,
                              "warmup_steps": 0, "lora_rank": 8, **kw})

    def cli_losses(path, batches, restore=None, **kw):
        """One card's Trainer on the checkpoint at ``path``."""
        params, pcfg = load_hf_model(path, torch.bfloat16, device=dev)
        tr = Trainer(params, pcfg, cli_tc(**kw))
        if restore is not None:
            tr.restore(restore)
        losses = [tr.train_step(b) for b in batches]
        del tr, params
        torch.cuda.empty_cache()
        return losses

    try:
        rng = np.random.default_rng(SEED + 23)
        rows = _ft_rows(work, rng, 4, "tm")
        manifest = _ft_manifest(os.path.join(work, "quick.jsonl"), rows)
        cli_batches = list(_ft_batches(rows, 2, 0, proc()))
        cut_ckpt = os.path.join(work, "cut_ckpt")
        params = init_params(cut_cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                             torch.bfloat16)
        export_hf_checkpoint(cut_cfg, params, cut_ckpt, dtype=torch.bfloat16)
        del params

        # one card's references
        t0 = time.perf_counter()
        refs = {"runs": _tm_trainer_runs(tuple(TM_RUNS), cfg, dev, None),
                "cli_lora": cli_losses(cut_ckpt, cli_batches),
                "cli_full": cli_losses(cut_ckpt, cli_batches, lora_rank=None)}
        print(f"train_mesh: one card's references in {time.perf_counter() - t0:.1f} s",
              flush=True)

        def spawn(tag, resume=""):
            d, m = TM_MESHES[tag]
            t0 = time.perf_counter()
            ranks.launch(_tm_entry, [work, tag, ckpt, cut_ckpt, manifest, resume], m, False,
                         timeout_s=TM_TIMEOUT, data_parallel=d)
            recs = [torch.load(os.path.join(work, f"{tag}_rank{r}.pt"), weights_only=False)
                    for r in range(d * m)]
            print(f"train_mesh {tag}: {d * m} ranks on one card over gloo in "
                  f"{time.perf_counter() - t0:.1f} s (process start, weights and the CLI runs "
                  "included)", flush=True)
            for k, v in _tm_check_spawn(tag, recs, refs, card).items():
                total[k] = total.get(k, 0) + v
            return {label: rec["metrics"] for label, rec in recs[0]["cli"].items()}

        # (a), (b), (d): the data axis
        cli = spawn("2x1")
        _tm_hold_losses(f"(d) cli --data_parallel 2 ({TM_CUT_LAYERS} layers)",
                        _tm_losses(cli["lora"]), refs["cli_lora"], card)
        _tm_hold_losses(f"(d) cli --data_parallel 2 --export_hf ({TM_CUT_LAYERS} layers)",
                        _tm_losses(cli["export"]), refs["cli_lora"], card)
        _tm_hold_losses(f"(d) cli --fsdp --full_finetune --data_parallel 2 ({TM_CUT_LAYERS} "
                        "layers)", _tm_losses(cli["fsdp"]), refs["cli_full"], card)
        export = os.path.join(work, "2x1_export", "hf_export")
        stand = _StandIns(cfg.image_token_index)
        with stand:
            text, _, _, wall_i, got_rows, want_text = _cli_call(infer, [
                "--model_path", export, "--prompt", "caption en", "--image_file_path",
                rows[0]["image"], "--max_tokens_to_generate", "8", "--quantize_int8"], stand)
        shutil.rmtree(export)
        if not text.endswith(want_text) or len(got_rows) != 1 or not got_rows[0]:
            raise AssertionError(f"train_mesh (d): cli.infer on the export printed "
                                 f"{text[-300:]!r}")
        print(f"train_mesh (d): rank 0's --export_hf answered through cli.infer --quantize_int8 "
              f"in {wall_i:.1f} s: {len(got_rows[0])} ids", flush=True)

        # (d): the data axis's state resumed on one card, then under a model axis
        final = os.path.join(work, "2x1_lora", "final")
        refs["resume"] = cli_losses(cut_ckpt, cli_batches, restore=final)
        with stand:
            one_out = os.path.join(work, "one_card_resume")
            _ft_call(finetune, ["--model_path", cut_ckpt, "--train_jsonl", manifest, "--output_dir",
                                one_out, *TM_CLI_FLAGS, "--resume_from", final], stand)
        _tm_hold_losses("(d) saved under 2 x 1, resumed on one card (cli --resume_from)",
                        _tm_losses(_tm_metrics(one_out)), refs["resume"], card)
        # (a), (c), (d): the model axis
        cli = spawn("1x2", resume=final)
        _tm_hold_losses("(d) saved under 2 x 1, resumed under --model_parallel 2",
                        _tm_losses(cli["resume"]), refs["resume"], card)
        # (a): DP x TP
        spawn("2x2")

        # (e) two --multihost processes through a coordinator
        port = _free_port()
        root = str(pathlib.Path(__file__).resolve().parent)
        mh_out = os.path.join(work, "multihost")
        env = {**os.environ, "PYTHONPATH": root + os.pathsep + os.environ.get("PYTHONPATH", "")}
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", "import chip_smoke; chip_smoke._tm_multihost_main()",
             str(cfg.image_token_index), "--model_path", cut_ckpt, "--train_jsonl", manifest,
             "--output_dir", mh_out, *TM_CLI_FLAGS, "--multihost", "--coordinator",
             f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(pid)],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for pid in range(2)]
        try:
            said = [p.communicate(timeout=TM_TIMEOUT)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for pid, (p, text) in enumerate(zip(procs, said)):
            if p.returncode != 0:
                raise AssertionError(f"train_mesh (e): process {pid} exited {p.returncode}:\n"
                                     f"{text[-3000:]}")
        if "mesh data 1 x model 2" not in said[0] or "done" in said[1]:
            raise AssertionError(f"train_mesh (e): {said[0][-600:]!r} / {said[1][-300:]!r}")
        _tm_hold_losses(f"(e) 2 --multihost processes ({time.perf_counter() - t0:.1f} s)",
                        _tm_losses(_tm_metrics(mh_out)), refs["cli_lora"], card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"train_mesh: phase done in {time.perf_counter() - t_phase:.1f} s; launches summed over "
          f"the ranks' counted Trainer runs: {json.dumps({k: v for k, v in total.items() if v})}",
          flush=True)
    return total

def train_batch(cfg):
    """The training phase's batch (numpy, seeded): 256 image tokens and a
    12-token prompt as the prefix, suffix tokens as labels, row 1 padded to
    400 real tokens."""
    rng = np.random.default_rng(SEED + 3)
    n_img = cfg.vision_config.num_patches
    ids = np.concatenate([np.full((TRAIN_B, n_img), cfg.image_token_index),
                          rng.integers(2, min(1000, cfg.image_token_index),
                                       (TRAIN_B, TRAIN_S - n_img))], 1).astype(np.int32)
    ttype = np.broadcast_to(np.arange(TRAIN_S) >= n_img + TRAIN_PROMPT, ids.shape).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, TRAIN_REAL1:] = 0
    ids[1, TRAIN_REAL1:] = cfg.pad_token_id
    labels = np.where((ttype == 1) & (mask == 1), ids, -100).astype(np.int32)
    px = cfg.vision_config.image_size
    return {"pixel_values": rng.standard_normal((TRAIN_B, 3, px, px), dtype=np.float32),
            "input_ids": ids, "attention_mask": mask, "token_type_ids": ttype, "labels": labels}


def _timed_step(tr, batch):
    """(loss, ms) of one train_step, CUDA events around it."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    loss = tr.train_step(batch)
    end.record()
    sync()
    return loss, start.elapsed_time(end)


def _counted_step(tr, batch):
    """One train_step with the launch counts zeroed just before it and read
    just after; the flash kernels must launch exactly TRAIN_PER_STEP times
    (kernel path) or not at all (plain path), every other kernel never."""
    from paligemma_tpu_torch import kernels

    kernels.reset_launch_counts()
    loss, ms = _timed_step(tr, batch)
    counts = kernels.launch_counts()
    want = {k: (TRAIN_PER_STEP.get(k, 0) if tr.use_flash else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"train step launches {counts}, want {want}")
    if not np.isfinite(loss):
        raise AssertionError(f"train step: non-finite loss {loss}")
    return loss, ms, counts


def train_phase(params, cfg, dev, card):
    """Single-GPU LoRA training at full width and depth (r=8, alpha 8, fp32
    adapters, remat): (a) first-step loss and LoRA-b gradients, flash
    kernels vs plain attention; (b) the loss falls over 8 steps at lr 1e-3;
    (c) grad_accum_steps=2 moves the adapters on every second step only;
    (d) one step over an int8 and an NF4 base; (e) exact launch counts per
    step; (f) the merged adapters serve a generate call. Returns the launch
    counts summed over the 8 counted steps of (b)."""
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import (quantize_lm_for_serving,
                                                      quantize_lm_for_training)
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    batch = train_batch(cfg)
    n_tok, n_real = TRAIN_B * TRAIN_S, int(batch["attention_mask"].sum())
    tc = TrainConfig(lora_rank=8, lora_alpha=8.0, learning_rate=1e-3, remat=True)

    def trainer(**kw):
        return Trainer(params, cfg, dataclasses.replace(tc, **kw),
                       generator=torch.Generator(dev).manual_seed(SEED))

    kern, plain = trainer(), trainer(use_flash=False)
    if not kern.use_flash or plain.use_flash:
        raise AssertionError("the trainer did not select the flash kernels on CUDA")

    # (a) first step from the same adapters: kernels vs plain attention
    loss_k, grads_k = kern.loss_and_grads(batch)
    loss_p, grads_p = plain.loss_and_grads(batch)
    sync()
    names = [(t, key) for t, leaf in kern.lora["layers"].items() for key in leaf]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst, worst_at = 0.0, None
    for (target, key), gk, gp in zip(names, grads_k, grads_p):
        if key != "b":
            continue
        if not torch.isfinite(gk).all():
            raise AssertionError(f"train (a): non-finite gradient of {target}.b")
        rel = float((gk - gp).abs().max()) / float(gp.abs().max())
        if rel > worst:
            worst, worst_at = rel, target
    print(f"train (a): first step, flash kernels vs plain attention: loss {float(loss_k):.6f} vs "
          f"{float(loss_p):.6f} (rel {loss_rel:.3e}, tol {TRAIN_LOSS_REL_TOL}); LoRA-b gradients "
          f"max rel err {worst:.3e} ({worst_at}.b; tol {TRAIN_GRAD_REL_TOL})  [{card}]",
          flush=True)
    if loss_rel > TRAIN_LOSS_REL_TOL or worst > TRAIN_GRAD_REL_TOL:
        raise AssertionError("train (a): kernel and plain first steps disagree")
    del grads_k, grads_p

    # (b) + (e): 8 steps on the fixed batch, each counted on its own
    losses, times, total = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        loss, ms, counts = _counted_step(kern, batch)
        losses.append(loss)
        times.append(ms)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    peak_k = torch.cuda.max_memory_allocated() / 2**30
    print(f"train (b): LoRA r8 lr 1e-3, {TRAIN_STEPS} steps on one batch: loss "
          f"{' '.join(f'{x:.5f}' for x in losses)}  [{card}]", flush=True)
    print(f"train (e): every step launched exactly {json.dumps(TRAIN_PER_STEP)} and no other "
          f"kernel; summed over the {TRAIN_STEPS} steps: {json.dumps(total)}", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (b): the loss did not fall ({losses[0]} -> {losses[-1]})")

    plain_times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        plain_times.append(_counted_step(plain, batch)[1])
    peak_p = torch.cuda.max_memory_allocated() / 2**30
    for name, ts, peak in (("kernels", times[1:], peak_k), ("plain", plain_times[1:], peak_p)):
        ms = float(np.median(ts))
        print(f"train: {name:7s} step B{TRAIN_B} S{TRAIN_S} LoRA r8 remat: {ms:.1f} ms "
              f"(median of {len(ts)}), {n_tok / ms * 1e3:.0f} tok/s over all positions "
              f"({n_real / ms * 1e3:.0f} real), peak allocated {peak:.2f} GiB (weights and "
              f"the serving trees included)  [{card}]", flush=True)

    # (c) accumulation over 2 steps: the adapters move on steps 2 and 4 only
    acc = trainer(grad_accum_steps=2)
    moved = []
    for _ in range(4):
        before = [leaf["b"].clone() for leaf in acc.lora["layers"].values()]
        _counted_step(acc, batch)
        moved.append(not all(torch.equal(b0, leaf["b"])
                             for b0, leaf in zip(before, acc.lora["layers"].values())))
    print(f"train (c): grad_accum_steps=2, adapters moved on steps 1-4: {moved}", flush=True)
    if moved != [False, True, False, True]:
        raise AssertionError("train (c): accumulation did not hold the adapters between updates")
    del acc

    # (d) one step over quantized bases (the trainer's int8 base is unfused)
    for name, quantize in (("int8", lambda: quantize_lm_for_serving(params, fuse=False)),
                           ("nf4", lambda: quantize_lm_for_training(params, "nf4", 64,
                                                                     fuse=False))):
        base = quantize()
        tq = Trainer(base, cfg, tc, generator=torch.Generator(dev).manual_seed(SEED))
        loss, ms, _ = _counted_step(tq, batch)
        print(f"train (d): one LoRA step over the {name} base: loss {loss:.5f}, {ms:.1f} ms  "
              f"[{card}]", flush=True)
        del base, tq

    # (f) the merged adapters serve
    merged = kern.merged_params()
    eng = PaliGemmaEngine(merged, cfg, max_seq_len=512,
                          decode_params=quantize_lm_for_serving(merged))
    n_img = cfg.vision_config.num_patches
    prompt = batch["input_ids"][:1, : n_img + TRAIN_PROMPT]
    toks = eng.generate(batch["pixel_values"][:1], prompt, np.ones_like(prompt),
                        max_new_tokens=8, eos_token_id=-1)
    moved_q = not torch.equal(merged["lm"]["layers"]["attn"]["q"], params["lm"]["layers"]["attn"]["q"])
    print(f"train (f): merged_params() served by PaliGemmaEngine.generate: {toks[0].tolist()} "
          f"(merged q differs from the base: {moved_q})", flush=True)
    if toks.shape != (1, 8) or not ((toks >= 0) & (toks < cfg.vocab_size)).all() or not moved_q:
        raise AssertionError("train (f): the merged parameters did not serve")
    del eng, merged

    kern.train_step(batch)  # warm, then one profiled step
    _profile(f"train step B{TRAIN_B} S{TRAIN_S} LoRA r8 remat", lambda: kern.train_step(batch), 1,
             card, top=10, unit="step")
    return total


# ------------------------------------------------------------ fine-tuning CLI ----
FT_ROWS, FT_EVAL_ROWS = 8, 2  # manifest rows
FT_SHAPES = ((480, 640), (224, 224))  # frame (H, W), alternating
FT_PROMPT = "extract JSON."  # the CLI's default prompt
FT_WORDS = ("menu", "item", "coffee", "latte", "bagel", "total", "cash", "change", "tax",
            "service", "water", "soup")
FT_NEW = 16  # greedy tokens an evaluation row
# the main run (plus --epochs 2, --eval_jsonl and --export_hf); warmup 0, so
# that every second step's update moves the adapters (the CLI's default
# warmup of 50 gives the first update a learning rate of 0)
FT_FLAGS = ("--batch_size", "2", "--grad_accum", "2", "--lora_rank", "8", "--max_length", "512",
            "--learning_rate", "1e-3", "--eval_every", "4", "--eval_subset", "2",
            "--max_new_tokens_eval", str(FT_NEW), "--warmup_steps", "0")
# the QLoRA and full fine-tune runs: 2 steps over the first 4 rows
FT_QUICK = ("--epochs", "1", "--batch_size", "2", "--grad_accum", "1", "--lora_rank", "8",
            "--max_length", "512", "--learning_rate", "1e-3", "--warmup_steps", "0")


def _ft_rows(d, rng, n, tag):
    """``n`` seeded manifest rows: frames of FT_SHAPES saved with np.save,
    targets of 20-100 words, JSON objects (json2token's route) on every
    other pair of rows and plain strings on the rest."""
    rows = []
    for i in range(n):
        path = os.path.join(d, f"{tag}{i}.npy")
        np.save(path, rng.integers(0, 256, (*FT_SHAPES[i % 2], 3), dtype=np.uint8))
        words = [FT_WORDS[j] for j in rng.integers(0, len(FT_WORDS), int(rng.integers(20, 100)))]
        if (i // 2) % 2 == 0:
            k = len(words) // 4
            target = {"menu": [{"nm": w, "price": f"{int(p)}.00"}
                               for w, p in zip(words[:k], rng.integers(1, 30, k))],
                      "total": f"{int(rng.integers(10, 300))}.00"}
        else:
            target = " ".join(words)
        rows.append({"image": path, "prompt": FT_PROMPT, "target": target})
    return rows


def _ft_manifest(path, rows):
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in rows))
    return path


def _ft_batches(rows, bs, epoch, processor, seed=0, max_length=512):
    """The CLI's batches of one epoch, derived here on their own: the order
    of ``np.random.default_rng(seed + epoch).shuffle``, a partial tail
    filled with copies of its first row whose labels are all -100."""
    from paligemma_tpu_torch.train.data import collate, json2token

    order = list(range(len(rows)))
    if seed >= 0:
        np.random.default_rng(seed + epoch).shuffle(order)
    for i in range(0, len(order), bs):
        idx = order[i:i + bs]
        n_real = len(idx)
        chunk = [rows[j] for j in idx + [idx[0]] * (bs - n_real)]
        targets = [r["target"] if isinstance(r["target"], str) else json2token(r["target"])
                   for r in chunk]
        batch = collate(processor, [_StubImage(np.load(r["image"])) for r in chunk],
                        [r["prompt"] for r in chunk], targets, max_length=max_length)
        if n_real < bs:
            batch["labels"][n_real:] = -100
        yield batch


def _same_tree(a, b) -> bool:
    """Nested dicts / lists equal: tensors bit for bit, on one device and
    in one dtype, numbers by ==."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(map(_same_tree, a, b))
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype and a.device == b.device
                and torch.equal(a, b))
    return a == b


class _TrainProbe:
    """While active, each ``Trainer.train_step`` records its loss, host ms
    (the step ends in a read of the loss), launch counts (the counters'
    growth over the step), whether the adapters' B moved, and a copy of its
    batch, and a CUDA tensor that reaches the plain LM attention
    (``ops.attention.gqa``) inside a step raises; ``Trainer.save``,
    ``cli.finetune._evaluate`` and ``export_hf_checkpoint`` are timed."""

    def __init__(self):
        self.steps, self.saves, self.evals, self.exports = [], [], [], []
        self._undo = []

    def _patch(self, owner, name, make):
        inner = getattr(owner, name)
        self._undo.append((owner, name, inner))
        setattr(owner, name, make(inner))

    def __enter__(self):
        from paligemma_tpu_torch import kernels
        from paligemma_tpu_torch.checkpoints import hf_export
        from paligemma_tpu_torch.cli import finetune
        from paligemma_tpu_torch.ops import attention
        from paligemma_tpu_torch.train import trainer

        probe, in_step = self, [False]

        def step(inner):
            def train_step(tr, batch):
                before_b = (None if tr.lora is None else
                            [leaf["b"].clone() for leaf in tr.lora["layers"].values()])
                before = kernels.launch_counts()
                in_step[0] = True
                t0 = time.perf_counter()
                try:
                    loss = inner(tr, batch)
                finally:
                    in_step[0] = False
                ms = (time.perf_counter() - t0) * 1e3
                after = kernels.launch_counts()
                moved = None if before_b is None else not all(
                    torch.equal(b0, leaf["b"])
                    for b0, leaf in zip(before_b, tr.lora["layers"].values()))
                probe.steps.append({"loss": loss, "ms": ms, "moved": moved,
                                    "counts": {k: after[k] - before[k] for k in after},
                                    "batch": {k: np.array(v) for k, v in batch.items()}})
                return loss
            return train_step

        def guard(inner):
            def gqa(q, *a, **kw):
                if in_step[0] and q.is_cuda:
                    raise AssertionError("finetune: a CUDA tensor reached the plain LM "
                                         "attention in a training step")
                return inner(q, *a, **kw)
            return gqa

        def timed(out, result=False):
            def make(inner):
                def call(*a, **kw):
                    sync()
                    t0 = time.perf_counter()
                    res = inner(*a, **kw)
                    sync()
                    out.append(((time.perf_counter() - t0) * 1e3, res if result else None))
                    return res
                return call
            return make

        self._patch(trainer.Trainer, "train_step", step)
        self._patch(trainer.Trainer, "save", timed(self.saves))
        self._patch(finetune, "_evaluate", timed(self.evals, result=True))
        self._patch(hf_export, "export_hf_checkpoint", timed(self.exports, result=True))
        self._patch(attention, "gqa", guard)
        return self

    def __exit__(self, *exc):
        for owner, name, inner in reversed(self._undo):
            setattr(owner, name, inner)
        self._undo = []
        return False


def _ft_call(finetune, argv, stand_ins):
    """``finetune.main(argv)`` with its stdout and stderr captured and the
    launch counts zeroed just before and read just after. Returns (its
    stdout, counts, wall s)."""
    import contextlib
    import io

    from paligemma_tpu_torch import kernels

    out, err = io.StringIO(), io.StringIO()
    n_tok = len(stand_ins.tokenizers)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            finetune.main(argv)
    except BaseException:  # SystemExit included: show what the CLI said
        print(f"finetune: the CLI failed; its stdout:\n{out.getvalue()}its stderr:\n"
              f"{err.getvalue()}", flush=True)
        raise
    sync()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    if len(stand_ins.tokenizers) != n_tok + 1:
        raise AssertionError("finetune: the CLI did not load one tokenizer")
    if not out.getvalue().endswith("done\n"):
        raise AssertionError(f"finetune: the CLI did not finish: {out.getvalue()[-400:]!r}")
    return out.getvalue(), counts, wall


def _ft_steps(label, steps, accum, eval_rows, counts, n_layers):
    """Every step launched exactly TRAIN_PER_STEP and no other kernel; the
    adapters moved on every ``accum``-th step only; the run's counts are
    its steps' plus one flash forward a layer for each evaluated row."""
    for i, s in enumerate(steps):
        want = {k: TRAIN_PER_STEP.get(k, 0) for k in s["counts"]}
        if s["counts"] != want:
            raise AssertionError(f"finetune {label}: step {i + 1} launched {s['counts']}, "
                                 f"want {want}")
        if s["moved"] is not None and s["moved"] != ((i + 1) % accum == 0):
            raise AssertionError(f"finetune {label}: adapters moved on steps "
                                 f"{[x['moved'] for x in steps]} at grad_accum {accum}")
        if not np.isfinite(s["loss"]):
            raise AssertionError(f"finetune {label}: step {i + 1} loss {s['loss']}")
    n = len(steps)
    want = {k: 0 for k in counts}
    want.update({k: v * n for k, v in TRAIN_PER_STEP.items()})
    want["flash_attention_fwd"] += n_layers * eval_rows
    if counts != want:
        raise AssertionError(f"finetune {label}: the run launched {counts}, want {want}")


def _ft_same_batches(label, recorded, mine):
    if len(recorded) != len(mine) or not all(
            a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
            for a, b in zip(recorded, mine)):
        raise AssertionError(f"finetune {label}: the CLI's batches differ from the ones "
                             "derived here")


def _ft_eval_check(label, trainer, rows, processor, decoded, dist, cfg):
    """The CLI's evaluation at this step: the rows it decoded equal greedy
    tokens of a plain-decode engine on ``trainer``'s merged tree, and its
    val_edit_distance equals the mean distance recomputed from them."""
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.train.data import json2token, normalized_edit_distance

    eng = PaliGemmaEngine(trainer.merged_params(), cfg, max_seq_len=512 + FT_NEW,
                          eos_token_id=_WordTokenizer.eos_token_id, fused_layer=False)
    scores = []
    for row, got in zip(rows, decoded):
        inputs = processor(images=[_StubImage(np.load(row["image"]))], text=[row["prompt"]])
        toks = eng.generate(inputs["pixel_values"], inputs["input_ids"],
                            inputs["attention_mask"], max_new_tokens=FT_NEW, do_sample=False)
        if toks[0].tolist() != got:
            raise AssertionError(f"finetune {label}: the CLI's eval tokens {got} != the "
                                 f"engine's {toks[0].tolist()}")
        target = row["target"] if isinstance(row["target"], str) else json2token(row["target"])
        scores.append(normalized_edit_distance(processor.tokenizer.decode(got), target))
    if float(np.mean(scores)) != dist:
        raise AssertionError(f"finetune {label}: val_edit_distance {dist} != recomputed "
                             f"{float(np.mean(scores))}")
    del eng


def finetune_phase(params, cfg, dev, card, ckpt):
    """The fine-tuning entry point at full width and depth, from the cli
    phase's HF checkpoint ``ckpt``: ``cli.finetune.main`` over a seeded
    manifest (8 rows, 2 eval rows; 2 epochs, batch 2, grad_accum 2, LoRA r8,
    evaluation every 4 steps, --export_hf), held step for step against a
    Trainer driven here on the batches this function derives in the CLI's
    order: (a) losses bit for bit; (b) launches per step; (c) the adapters
    move on every second step only; (d) each val_edit_distance and its
    tokens; (e) epoch_0, epoch_1 and final restore to the trainer's state;
    (f) hf_export loads back as the merged tree; (g) ``cli.infer
    --quantize_int8`` answers from the export with the engine's tokens on
    the re-quantized merged tree; (h) metrics.jsonl's lines. Then a
    --resume_from run of one epoch against a restored Trainer, and 2-step
    runs with --base_quant nf4 and --full_finetune against Trainers on the
    same bases. Returns the launch counts summed over the CLI runs (i)."""
    import tempfile

    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.cli import finetune, infer
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import (quantize_lm_for_serving,
                                                      quantize_lm_for_training)
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    n_layers = cfg.text_config.num_hidden_layers
    vc = cfg.vision_config
    n_el = sum(t.numel() for t in _leaves(params))
    n_lm = sum(t.numel() for t in _leaves(params["lm"]))
    work = tempfile.mkdtemp(prefix="finetune_", dir=os.path.dirname(ckpt))
    need_export, need_full = 4 * n_el, 2 * 3 * 2 * n_lm  # full FT: 2 saves of the LM + 2 moments
    free = shutil.disk_usage(work).free
    print(f"finetune: {free} bytes free under {work}: the fp32 export needs {need_export}, the "
          f"full fine-tune's two checkpoints {need_full}", flush=True)
    if free < max(need_export, need_full) + CLI_DISK_SLACK:
        shutil.rmtree(work, ignore_errors=True)
        raise AssertionError("finetune: no room for the phase's outputs")
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def proc():
        return PaliGemmaProcessor(_WordTokenizer(cfg.image_token_index), vc.num_image_tokens,
                                  vc.image_size)

    tc = TrainConfig(learning_rate=1e-3, grad_accum_steps=2, warmup_steps=0, lora_rank=8)
    tc_quick = dataclasses.replace(tc, grad_accum_steps=1)
    try:
        rng = np.random.default_rng(SEED + 17)
        rows, eval_rows = _ft_rows(work, rng, FT_ROWS, "train"), _ft_rows(work, rng,
                                                                            FT_EVAL_ROWS, "eval")
        train = _ft_manifest(os.path.join(work, "train.jsonl"), rows)
        quick = _ft_manifest(os.path.join(work, "quick.jsonl"), rows[:4])
        ev = _ft_manifest(os.path.join(work, "eval.jsonl"), eval_rows)
        out = os.path.join(work, "run")
        stand = _StandIns(cfg.image_token_index)
        with stand:
            # ---- the main run ----
            torch.cuda.reset_peak_memory_stats()
            with _TrainProbe() as cli_probe:
                _, counts, wall = _ft_call(finetune, [
                    "--model_path", ckpt, "--train_jsonl", train, "--eval_jsonl", ev,
                    "--output_dir", out, "--epochs", "2", *FT_FLAGS, "--export_hf"], stand)
            peak = torch.cuda.max_memory_allocated() / 2**30
            add(counts)
            cli_tok = stand.tokenizers[-1]
            with open(os.path.join(out, "metrics.jsonl")) as f:
                metrics = [json.loads(line) for line in f]
            _ft_steps("main run", cli_probe.steps, 2, 2 * FT_EVAL_ROWS, counts, n_layers)
            print(f"finetune main run: 8 steps and 2 evaluations of {FT_EVAL_ROWS} rows in "
                  f"{wall:.2f} s; every step launched exactly {json.dumps(TRAIN_PER_STEP)}, "
                  f"the run {json.dumps({k: v for k, v in counts.items() if v})} (18 flash "
                  f"forwards an evaluated row); no CUDA tensor reached the plain LM attention; "
                  f"adapters moved on steps {[s['moved'] for s in cli_probe.steps]}  [{card}]",
                  flush=True)

            # (h) metrics.jsonl: a line per step, the evaluations at steps 4 and 8
            train_keys = ["epoch", "step", "step_ms", "time", "tokens_per_sec", "train_loss"]
            want = [train_keys] * 4 + [["step", "time", "val_edit_distance"]]
            if [sorted(m) for m in metrics] != want * 2 or [m["step"] for m in metrics] != [
                    1, 2, 3, 4, 4, 5, 6, 7, 8, 8]:
                raise AssertionError(f"finetune (h): metrics.jsonl lines {metrics}")

            # (a) the batches, derived here in the CLI's order, then a
            # Trainer driven on them alone
            p_mine = proc()
            t0 = time.perf_counter()
            mine = [b for e in (0, 1) for b in _ft_batches(rows, 2, e, p_mine)]
            collate_ms = (time.perf_counter() - t0) * 1e3 / len(mine)
            _ft_same_batches("main run", [s["batch"] for s in cli_probe.steps], mine)
            if p_mine.tokenizer.vocab != cli_tok.vocab:
                raise AssertionError("finetune: the CLI's tokenizer saw other words")
            direct = Trainer(params, cfg, tc)
            evals = [m["val_edit_distance"] for m in metrics if "val_edit_distance" in m]
            with _TrainProbe() as d_probe:
                for i, batch in enumerate(mine):
                    direct.train_step(batch)
                    if i % 4 != 3:
                        continue
                    # (d) the evaluation of this step
                    k = i // 4
                    _ft_eval_check(f"(d) step {i + 1}", direct, eval_rows, p_mine,
                                   cli_tok.decoded[2 * k:2 * k + 2], evals[k], cfg)
                    # (e) epoch_k restores to this state
                    for name in (f"epoch_{k}",) + (("final",) if k else ()):
                        again = Trainer(params, cfg, tc)
                        again.restore(os.path.join(out, name))
                        if not _same_tree(again._state(), direct._state()):
                            raise AssertionError(f"finetune (e): {name} restores to another "
                                                 "state than the trainer's")
                        del again
            cli_losses = [m["train_loss"] for m in metrics if "train_loss" in m]
            d_losses = [s["loss"] for s in d_probe.steps]
            if cli_losses != d_losses:
                raise AssertionError(f"finetune (a): the CLI's losses {cli_losses} != the "
                                     f"Trainer's {d_losses}")
            print(f"finetune (a): the CLI's 8 losses equal a Trainer's on the batches derived "
                  f"here, bit for bit: {' '.join(f'{x:.5f}' for x in cli_losses)}; (d) "
                  f"val_edit_distance {evals} equal the distances recomputed from the eval "
                  f"engine's tokens, which equal a plain-decode engine's on the trainer's "
                  f"merged tree; (e) epoch_0, epoch_1 and final restore to its state, tensor "
                  f"for tensor; (h) metrics.jsonl holds 8 step lines and 2 eval lines  [{card}]",
                  flush=True)

            # (f) the export reads back as the merged tree
            export = os.path.join(out, "hf_export")
            merged = direct.merged_params()
            loaded, lcfg = load_hf_model(export, torch.bfloat16, device=dev)
            if lcfg != cfg or not _same_tree(loaded, merged):
                raise AssertionError("finetune (f): hf_export loads back as another tree")
            del loaded
            (export_ms, export_bytes), = cli_probe.exports
            print(f"finetune (f): hf_export ({export_bytes} bytes of fp32 safetensors, the "
                  f"tokenizer's {sorted(os.listdir(export))}) loads back equal to "
                  f"merged_params(), tensor for tensor", flush=True)

            # (g) cli.infer --quantize_int8 answers from the export
            argv = ["--model_path", export, "--image_file_path", rows[0]["image"], "--prompt",
                    CLI_PROMPTS[0], "--quantize_int8", "--max_tokens_to_generate", str(CLI_NEW)]
            text, t, counts, wall_g, got_rows, want_text = _cli_call(infer, argv, stand)
            add(counts)
            _cli_launches("finetune export", counts, n_layers, True)
            ref_tok = sys.modules["transformers"].AutoTokenizer.from_pretrained(export)
            p_ref = PaliGemmaProcessor(ref_tok, vc.num_image_tokens, vc.image_size)
            inputs = p_ref(images=[_StubImage(np.load(rows[0]["image"]))], text=[CLI_PROMPTS[0]])
            eng = PaliGemmaEngine(merged, cfg, max_seq_len=1024,
                                  eos_token_id=_WordTokenizer.eos_token_id,
                                  decode_params=quantize_lm_for_serving(merged))
            ref = eng.generate(inputs["pixel_values"], inputs["input_ids"],
                               inputs["attention_mask"], max_new_tokens=CLI_NEW,
                               sync_every=infer.SYNC_EVERY)
            if not np.array_equal(np.asarray(got_rows), ref) or not text.endswith(want_text):
                raise AssertionError(f"finetune (g): cli.infer on the export gave {got_rows}, "
                                     f"the engine on the merged tree {ref.tolist()}")
            print(f"finetune (g): cli.infer --quantize_int8 on hf_export answers with the "
                  f"{ref.shape[1]} ids of PaliGemmaEngine on the re-quantized merged tree: "
                  f"{ref[0, :8].tolist()} ...", flush=True)
            _timing_line("finetune export", t, wall_g, card)
            del eng, merged, inputs
            shutil.rmtree(export)

            # the resumed run: one epoch from final, against a restored Trainer
            with _TrainProbe() as r_probe:
                _, counts, _ = _ft_call(finetune, [
                    "--model_path", ckpt, "--train_jsonl", train, "--output_dir",
                    os.path.join(work, "resumed"), "--epochs", "1", *FT_FLAGS,
                    "--resume_from", os.path.join(out, "final")], stand)
            add(counts)
            _ft_steps("resumed", r_probe.steps, 2, 0, counts, n_layers)
            _ft_same_batches("resumed", [s["batch"] for s in r_probe.steps], mine[:4])
            restored = Trainer(params, cfg, tc)
            restored.restore(os.path.join(out, "final"))
            with _TrainProbe() as rd_probe:
                for batch in mine[:4]:
                    restored.train_step(batch)
            r_cli, r_dir = ([s["loss"] for s in p.steps] for p in (r_probe, rd_probe))
            if r_cli != r_dir:
                raise AssertionError(f"finetune resumed: losses {r_cli} != a restored "
                                     f"Trainer's {r_dir}")
            print(f"finetune resumed: --resume_from final, one epoch: its 4 losses equal a "
                  f"Trainer restored from final on the same batches, bit for bit: "
                  f"{' '.join(f'{x:.5f}' for x in r_cli)}", flush=True)
            del restored, direct

            # QLoRA and the full fine-tune: 2 steps each against a Trainer
            quick_batches = list(_ft_batches(rows[:4], 2, 0, proc()))
            quick_ms = {}
            for label, flag, make in (
                    ("nf4", ("--base_quant", "nf4"),
                     lambda: Trainer(quantize_lm_for_training(params, kind="nf4", fuse=False),
                                     cfg, tc_quick)),
                    ("full", ("--full_finetune",),
                     lambda: Trainer(params, cfg, dataclasses.replace(tc_quick,
                                                                      lora_rank=None)))):
                q_out = os.path.join(work, label)
                with _TrainProbe() as q_probe:
                    _, counts, _ = _ft_call(finetune, [
                        "--model_path", ckpt, "--train_jsonl", quick, "--output_dir", q_out,
                        *FT_QUICK, *flag], stand)
                add(counts)
                _ft_steps(label, q_probe.steps, 1, 0, counts, n_layers)
                _ft_same_batches(label, [s["batch"] for s in q_probe.steps], quick_batches)
                saved = sorted(os.listdir(q_out))
                shutil.rmtree(q_out)
                tq = make()
                with _TrainProbe() as qd_probe:
                    for batch in quick_batches:
                        tq.train_step(batch)
                del tq
                torch.cuda.empty_cache()
                q_cli, q_dir = ([s["loss"] for s in p.steps] for p in (q_probe, qd_probe))
                if q_cli != q_dir:
                    raise AssertionError(f"finetune {label}: losses {q_cli} != a Trainer's "
                                         f"{q_dir}")
                quick_ms[label] = ([s["ms"] for s in q_probe.steps], q_probe.saves)
                print(f"finetune {label}: {flag[0]}{' ' + flag[1] if len(flag) > 1 else ''}, "
                      f"2 steps: losses {' '.join(f'{x:.5f}' for x in q_cli)} equal a "
                      f"Trainer's bit for bit; step ms {[round(s['ms'], 1) for s in q_probe.steps]}"
                      f"; saves {[round(ms) for ms, _ in q_probe.saves]} ms ({saved})  [{card}]",
                      flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # the step through the CLI against the Trainer alone, in turns (CLI, Trainer,
    # CLI resumed, Trainer restored): the main run meets each padded length
    # first, the three after it run lengths already seen
    runs = (("CLI", cli_probe), ("Trainer", d_probe), ("CLI resumed", r_probe),
            ("Trainer restored", rd_probe))
    lengths = [s["batch"]["input_ids"].shape[1] for s in cli_probe.steps]
    print("finetune: step ms in turns, padded lengths " + " ".join(map(str, lengths)) + ": "
          + "; ".join(f"{name} " + " ".join(f"{s['ms']:.1f}" for s in p.steps)
                      for name, p in runs) + f"  [{card}]", flush=True)
    cli_ms = [s["ms"] for s in r_probe.steps[1:]]
    dir_ms = [s["ms"] for s in rd_probe.steps[1:]]
    tps = [m["tokens_per_sec"] for m in metrics if "tokens_per_sec" in m]
    print(f"finetune: step through the CLI {float(np.median(cli_ms)):.1f} ms against the Trainer "
          f"alone {float(np.median(dir_ms)):.1f} ms (the resumed run and the restored Trainer, "
          f"medians of their steps 2-4); {float(np.median(tps)):.0f} real tokens/s (median over "
          f"the main run's steps); peak allocated {peak:.2f} GiB (the phase's caller's weights "
          f"and int8 tree included)  [{card}]", flush=True)
    eval_ms = [ms for ms, _ in cli_probe.evals]
    save_ms = [ms for ms, _ in cli_probe.saves]
    print(f"finetune: collate {collate_ms:.1f} ms a batch of 2 (host: the stand-in frames' "
          f"resize and tokenizing); evaluation {float(np.mean(eval_ms)) / FT_EVAL_ROWS:.1f} ms "
          f"a row ({FT_NEW} greedy tokens, plain bf16 decode, engine build included); LoRA "
          f"saves {' '.join(f'{x:.1f}' for x in save_ms)} ms; export {export_ms / 1e3:.2f} s for "
          f"{export_bytes} bytes ({export_bytes / export_ms / 1e6:.2f} GB/s into the page cache)"
          f"  [{card}]", flush=True)
    return total


# ------------------------------------------------------ speculative decoding ----
SPEC_SEQ = 2048  # generate_spec's cache
SPEC_NEW = 128  # generate_spec's tokens
SPEC_DRAFT_K = 8
SPEC_SYNC = 8  # generate_spec's cycles per window
SPEC_MATCH_N = 2
SPEC_CORRUPT = (0.0, 0.5, 1.0)  # the acceptance dial's points
SPEC_CYCLES_PROFILED = 8  # verify calls (and decode steps) per profile
# the GEMV tile's rows against the verify's: a decode step (1, 8 slots),
# a b1 verify (draft_k + 1) and an 8-slot one (8 (draft_k + 1))
SPEC_GEMV_ROWS = (1, 8, 9, 16, 72)
SPEC_LAYER = (("qkv", 2048, 2560), ("o", 2048, 2048), ("gateup", 2048, 32768),
              ("down", 16384, 2048))  # 3B: (name, K, N) of a decode layer's GEMVs


class _NoPlainInt8:
    """While active, ``kernels.quant._int8_matmul`` (the plain int8 branch
    of ``matmul_any``, which copies each weight to fp32) and
    ``quant._w8a8_matmul`` (W8A8's plain version) raise on a CUDA tensor:
    the spec path must run on the decode kernels, a single-copy prefill on
    the W8A8 kernels and the GEMV tile."""

    NAMES = ("_int8_matmul", "_w8a8_matmul")

    def __enter__(self):
        from paligemma_tpu_torch.kernels import quant

        self.quant = quant
        self.inner = {n: getattr(quant, n) for n in self.NAMES}
        for n, fn in self.inner.items():
            def guarded(x, w8, s, n=n, fn=fn):
                if x.is_cuda:
                    raise AssertionError(f"a CUDA tensor reached quant.{n}")
                return fn(x, w8, s)

            setattr(quant, n, guarded)
        return self

    def __exit__(self, *exc):
        for n, fn in self.inner.items():
            setattr(self.quant, n, fn)
        return False


def spec_kernel_cases(report: KernelReport, dev):
    """The dense attention at a verify's rows (``rows_per_cache`` = draft_k
    + 1 query rows per cache row, each its own mask row: the row's valid
    slots and its block up to itself) against its plain version and against
    the one-row-per-cache-row call on the repeated cache (the same bits);
    then the device time of a layer's four GEMVs on the GEMV tile at the
    decode and verify row counts, and B11's wgmma tile above 16 rows."""
    from paligemma_tpu_torch.kernels import decode_attention as dattn
    from paligemma_tpu_torch.kernels.ablation import quant_pallas
    from paligemma_tpu_torch.kernels.int8_gemv import int8_gemv

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    s, d, h = SPEC_DRAFT_K + 1, 256, 8
    for b, w in ((1, 512), (8, 1024)):
        kc = torch.randn((b, w, d), generator=g, device=dev).to(torch.bfloat16)
        vc = torch.randn((b, w, d), generator=g, device=dev).to(torch.bfloat16)
        q = torch.randn((b * s, h, d), generator=g, device=dev).to(torch.bfloat16)
        start = torch.randint(w // 4, w - s, (b,), generator=g, device=dev)
        base = torch.rand((b, w), generator=g, device=dev) < 0.9
        base &= torch.arange(w, device=dev)[None] < start[:, None]
        j = torch.arange(w, device=dev)[None, None]
        off = j - start[:, None, None]
        vis = base[:, None] | ((off >= 0) & (off <= torch.arange(s, device=dev)[None, :, None]))
        valid = vis.reshape(b * s, w).contiguous()
        got = dattn.decode_attention(q, kc, vc, valid, d**-0.5, rows_per_cache=s)
        want = dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5, s)
        label = f"verify B{b} x {s} rows W{w}"
        report.case("decode_attention", label, got, want, 1e-2)
        kr, vr = kc.repeat_interleave(s, 0).contiguous(), vc.repeat_interleave(s, 0).contiguous()
        if not torch.equal(got, dattn.decode_attention(q, kr, vr, valid, d**-0.5)):
            raise AssertionError(f"decode_attention {label}: rows_per_cache changed bits")
        # SDPA on the repeated cache (the repeat outside its time)
        sdpa = (q[:, :, None], kr[:, None], vr[:, None], valid[:, None, None])
        report.time("decode_attention", label,
                    lambda: dattn.decode_attention(q, kc, vc, valid, d**-0.5, rows_per_cache=s),
                    lambda: dattn.decode_attention_reference(q, kc, vc, valid, d**-0.5, s),
                    4 * b * s * h * w * d, nbytes(q, valid) + 2 * b * w * d * 2 + b * s * h * d * 2,
                    library_fn=lambda: F.scaled_dot_product_attention(*sdpa), in_json=False)
    print(f"  decode_attention verify: rows_per_cache={s} gives the bits of the call on the "
          f"cache rows repeated {s} times", flush=True)

    # a layer's GEMVs at the decode and verify row counts (weights cold: one
    # weight set per call, cycled)
    layers = [{n: (torch.randint(-127, 128, (k, nn), generator=g, device=dev,
                                 dtype=torch.int8),
                   torch.rand((nn,), generator=g, device=dev) * 0.01 + 1e-3)
               for n, k, nn in SPEC_LAYER} for _ in range(2)]
    xs = {m: {k: torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
              for k in {k for _, k, _ in SPEC_LAYER}} for m in SPEC_GEMV_ROWS}
    turn = [0]

    def layer(fn, m):
        def run():
            lw = layers[turn[0] % 2]
            turn[0] += 1
            for n, k, _ in SPEC_LAYER:
                fn(xs[m][k], *lw[n])
        return run

    fns = [(f"int8_gemv x4 M{m}", layer(int8_gemv, m)) for m in SPEC_GEMV_ROWS]
    fns += [(f"B11 wgmma x4 M{m}", layer(quant_pallas.int8_matmul, m))
            for m in SPEC_GEMV_ROWS if m > 16]
    times = device_times("a 3B decode layer's qkv, o, gateup, down", fns)
    n_bytes = sum(k * n for _, k, n in SPEC_LAYER)
    base = times.get(f"int8_gemv x4 M1")
    for name, ms in times.items():
        if ms is not None and base:
            print(f"  spec: {name}: {ms:.4f} ms, {ms / base:.2f}x the one-row layer; weight "
                  f"bytes {n_bytes / 1e6:.1f} MB once = {n_bytes / PEAK_BYTES * 1e3:.4f} ms",
                  flush=True)
    return times


def _spec_counts(label, counts, verifies, n_layers, paged=False, greedy=True, prefills=None,
                 argmax=None):
    """The launches of ``verifies`` verify calls: per call and layer the qkv
    GEMV with RoPE + KV write, the attention and three GEMVs; per call one
    final norm and the argmax head (``greedy``), or the int8 GEMV head
    (False), or (None) the argmax head on ``argmax`` of them and the int8
    GEMV head on the others (a grammar engine); ``prefills`` flash forwards
    of a layer, when given."""
    attn, other = (("paged_decode_attention", "decode_attention") if paged
                   else ("decode_attention", "paged_decode_attention"))
    heads = verifies if greedy else (0 if greedy is False else argmax)
    want = {"int8_gemv_rope_kv": n_layers * verifies, attn: n_layers * verifies, other: 0,
            "int8_gemv": 3 * n_layers * verifies + verifies - heads,
            "rms_norm": verifies, "head_argmax": heads}
    if prefills is not None:
        want["flash_attention_fwd"] = n_layers * prefills
    want.update({k: 0 for k in TP_KERNELS + ABLATION_KERNELS + TRAIN_ONLY + LORA_KERNELS})
    bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
    if bad or not verifies:
        raise AssertionError(f"spec {label}: launch counts (got, want) off: {bad}, "
                             f"{verifies} verify calls")


def _spec_verifies(cycles, sync_every):
    """The verify calls of a generate_spec that emitted in ``cycles``
    cycles: whole windows of ``sync_every`` (at least one), the host
    reading the row's state once per window."""
    return sync_every * max(1, -(-cycles // sync_every))


def _count_spec_ticks(eng):
    """Counts the ticks of the engine's spec windows from now on, as the
    host sizes them, and those of windows that took the argmax head:
    ``[ticks, argmax-head ticks]``."""
    run, decide, n = eng._run_spec_window, eng._spec_greedy, [0, 0]
    took = [False]

    def greedy():
        took[0] = decide()
        return took[0]

    def window(ticks):
        out = run(ticks)
        n[0] += ticks
        n[1] += ticks * took[0]
        return out

    eng._spec_greedy, eng._run_spec_window = greedy, window
    return n


def spec_phase(report: KernelReport, params, decode, cfg, dev, card):
    """Speculative decoding at full width (module docstring): the kernel
    cases, generate_spec against generate (tokens, launches, tok/s in turns,
    the acceptance dial), a verify's device time against a decode step's,
    a window with no host sync, then the dense and paged engines with
    spec_decode against the engines without it (and the prefix cache, and a
    pool that preempts). Everything runs under :class:`_NoPlainInt8`.
    Returns the launch counts summed over the counted runs."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.models import gemma, paligemma
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    t_phase = time.perf_counter()
    with _NoPlainInt8():
        spec_kernel_cases(report, dev)
        eng = PaliGemmaEngine(params, cfg, max_seq_len=SPEC_SEQ, decode_params=decode)
        pixels, ids, mask = make_inputs(cfg, dev)
        kw = dict(eos_token_id=-1, draft_k=SPEC_DRAFT_K, match_n=SPEC_MATCH_N,
                  sync_every=SPEC_SYNC)
        eng.generate_spec(pixels, ids, mask, max_new_tokens=16, **kw)  # first calls
        want = eng.generate(pixels, ids, mask, max_new_tokens=SPEC_NEW, eos_token_id=-1,
                            sync_every=8)
        kernels.reset_launch_counts()
        got = eng.generate_spec(pixels, ids, mask, max_new_tokens=SPEC_NEW, **kw)
        sync()
        counts = kernels.launch_counts()
        add(counts)
        cycles = eng.spec_cycles
        verifies = _spec_verifies(cycles, SPEC_SYNC)
        _spec_counts("generate_spec", counts, verifies, n_layers, prefills=1)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"spec: generate_spec tokens differ from generate's:\n{got}\n"
                                 f"{want}")
        print(f"spec: generate_spec B1 {SPEC_NEW} tokens, draft_k {SPEC_DRAFT_K}, match_n "
              f"{SPEC_MATCH_N}: tokens equal generate's, int for int ({want[0, :8].tolist()} "
              f"...); {cycles} cycles emitted, {(SPEC_NEW - 1) / cycles:.2f} tokens per cycle "
              f"({(SPEC_NEW - 1) / cycles - 1:.2f} accepted drafts), {verifies} verify calls "
              f"(windows of {SPEC_SYNC}); launches {json.dumps({k: v for k, v in counts.items() if v})}",
              flush=True)

        def wall(fn):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            return time.perf_counter() - t0

        plain_fn = lambda: eng.generate(pixels, ids, mask, max_new_tokens=SPEC_NEW,  # noqa: E731
                                        eos_token_id=-1, sync_every=8)
        runs = {"plain": [], "spec": []}
        for name in ("plain", "spec", "spec", "plain"):
            runs[name].append(wall(plain_fn if name == "plain" else lambda: eng.generate_spec(
                pixels, ids, mask, max_new_tokens=SPEC_NEW, **kw)))
        t_plain, t_spec = min(runs["plain"]), min(runs["spec"])
        print(f"spec: B1 {SPEC_NEW} tokens, whole call (prefill included), in turns plain, "
              f"spec, spec, plain: generate {SPEC_NEW / t_plain:.1f} tok/s ({t_plain * 1e3:.1f} "
              f"ms), generate_spec {SPEC_NEW / t_spec:.1f} tok/s ({t_spec * 1e3:.1f} ms): "
              f"{t_plain / t_spec:.2f}x  [{card}]", flush=True)
        for cf in SPEC_CORRUPT:
            fn = lambda: eng.generate_spec(pixels, ids, mask, max_new_tokens=SPEC_NEW,  # noqa
                                           corrupt_frac=cf, **kw)
            fn()
            tok = fn()
            n_cyc = eng.spec_cycles
            t = min(wall(fn), wall(fn))
            if not np.array_equal(tok, want):
                raise AssertionError(f"spec: corrupt_frac {cf} changed the tokens")
            print(f"spec: corrupt_frac {cf}: {n_cyc} cycles, {(SPEC_NEW - 1) / n_cyc - 1:.2f} "
                  f"accepted drafts per cycle, {SPEC_NEW / t:.1f} tok/s ({t * 1e3:.1f} ms; "
                  f"generate {SPEC_NEW / t_plain:.1f} tok/s), tokens unchanged  [{card}]",
                  flush=True)

        # a verify call's device time against a decode step's, B1 and 8 rows
        s = SPEC_DRAFT_K + 1
        dp = eng.decode_params
        busy = {}
        for b in (1, 8):
            max_seq = 1024
            cache = gemma.init_kv_cache(cfg.text_config, b, max_seq, torch.bfloat16, device=dev)
            for name in ("k", "v"):
                cache[name].normal_(generator=torch.Generator(device=dev).manual_seed(SEED + 41))
            wp = torch.full((b,), 300, dtype=torch.int32, device=dev)
            valid = torch.zeros((b, max_seq), dtype=torch.bool, device=dev)
            valid[:, :300] = True
            pos = wp + 1
            toks = torch.randint(2, 1000, (b, s), device=dev)
            bucket = 512

            def verify():
                paligemma.decode_verify(dp, cfg, toks, cache, wp, valid, pos, kv_bucket=bucket,
                                        fused_layer=True, greedy_head=True)

            def step():
                paligemma.decode_step_greedy(dp, cfg, toks[:, 0], cache, cache_pos=wp,
                                             kv_valid=valid, position_ids=pos,
                                             kv_bucket=bucket)

            for name, fn in (("decode step", step), ("verify", verify)):
                fn()
                per = SPEC_CYCLES_PROFILED
                got_p = _profile(f"spec {name} B{b} ({b * (s if name == 'verify' else 1)} rows) "
                                 f"W{bucket}", lambda: [fn() for _ in range(per)], per, card,
                                 unit="call", layers=n_layers)
                busy[(b, name)] = None if got_p is None else got_p[0]
        for b in (1, 8):
            v, st_ = busy[(b, "verify")], busy[(b, "decode step")]
            if v is None or st_ is None:
                print(f"spec: B{b} verify vs decode step device time: not measured", flush=True)
                continue
            print(f"spec: B{b}: a verify call ({b * s} rows) {v:.3f} ms of device time against "
                  f"a decode step's ({b} rows) {st_:.3f} ms: {v / st_:.2f}x, so a cycle breaks "
                  f"even at {v / st_ - 1:.2f} accepted drafts per row  [{card}]", flush=True)

        # no host synchronization inside a window of cycles
        st = eng.spec_start(pixels, ids, mask, SPEC_NEW, -1, SPEC_DRAFT_K, SPEC_MATCH_N, 0.5)
        sync()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._spec_cycles(st, 8)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync()
        del eng, st

        # serving: the 12 requests with spec_decode, against the engines without
        Paged = _recording_engine()
        vocab = cfg.vocab_size

        def served(label, make, reqs, paged=False):
            eng = make()
            n = _count_spec_ticks(eng)
            kernels.reset_launch_counts()
            toks, wall_s, ttft = _serve(eng, reqs, vocab)
            counts = kernels.launch_counts()
            add(counts)
            _spec_counts(label, counts, n[0], n_layers, paged=paged,
                         prefills=eng.prefill_calls)
            n_tok = sum(map(len, toks.values()))
            print(f"spec: serve {label}: {n[0]} cycles, {n_tok} tokens, {n_tok / wall_s:.1f} "
                  f"tok/s aggregate (wall {wall_s:.3f} s), TTFT p50 {ttft:.1f} ms, prefill "
                  f"calls {eng.prefill_calls}, cache hits {eng.cache_hits}, preemptions "
                  f"{getattr(eng, 'preemptions', 0)}  [{card}]", flush=True)
            return toks, eng

        def dense(**kw):
            return lambda: ServingEngine(params, cfg, decode_params=decode, **SERVE, **kw)

        def paged(n_pages=FULL_POOL, **kw):
            return lambda: Paged(params, cfg, decode_params=decode, page_size=PAGE,
                                 n_pages=n_pages, paged_kernel="fused", **SERVE, **kw)

        spec_kw = dict(spec_decode=True, spec_draft_k=SPEC_DRAFT_K, spec_match_n=SPEC_MATCH_N)
        warm = serving_requests(cfg)[:2]
        for r in warm:
            r.max_new_tokens = 9
        _serve(dense(**spec_kw)(), warm, vocab)
        base, base_wall, _ = _serve(dense()(), serving_requests(cfg), vocab)
        tok_d, _ = served("dense", dense(**spec_kw), serving_requests(cfg))
        tok_p, eng_p = served("paged", paged(**spec_kw), serving_requests(cfg), paged=True)
        differ = [i for i in base if tok_d[i] != base[i] or tok_p[i] != base[i]]
        if differ or eng_p.preemptions:
            raise AssertionError(f"spec serve: requests {differ} differ from the engine without "
                                 f"spec_decode, or the full pool preempted")
        n_base = sum(map(len, base.values()))
        print(f"spec: serve dense and paged with spec_decode: 12/12 requests with the tokens of "
              f"the dense engine without it ({n_base} tokens, {n_base / base_wall:.1f} tok/s "
              f"without spec)  [{card}]", flush=True)
        tok_b, eng_b = served("paged preempting", paged(n_pages=SMALL_POOL, **spec_kw),
                              serving_requests(cfg), paged=True)
        if eng_b.preemptions < 1:
            raise AssertionError("spec serve: the small pool never preempted")
        for rid, n_tok in sorted(eng_b.first_eviction.items()):
            if tok_b[rid][:n_tok] != base[rid][:n_tok]:
                raise AssertionError(f"spec serve: request {rid}'s tokens before its eviction "
                                     "differ")
        agree = sum(x == y for i in base for x, y in zip(base[i], tok_b[i]))
        print(f"spec: serve paged, {SMALL_POOL}-page pool: {eng_b.preemptions} preemptions "
              f"(recomputed from scratch), tokens before each eviction equal; {agree}/{n_base} "
              f"tokens agree with the engine without spec", flush=True)
        reqs = serving_requests(cfg)[:8]
        twice = reqs + [dataclasses.replace(r, request_id=r.request_id + N_REQ, tokens=[])
                        for r in reqs]
        tok_c, eng_c = served("dense prefix cache, 8 requests twice",
                              dense(prefix_cache=True, **spec_kw), twice)
        differ = [r.request_id for r in twice if tok_c[r.request_id] != base[r.request_id % N_REQ]]
        if differ or eng_c.cache_hits != 8:
            raise AssertionError(f"spec serve prefix cache: requests {differ} differ, "
                                 f"{eng_c.cache_hits} hits")
        print("spec: serve dense with the prefix cache: 8 hits seated with no prefill keep "
              "speculating, 16/16 requests with the tokens of the engine without spec_decode",
              flush=True)
        eng = dense(**spec_kw)()
        for r in serving_requests(cfg)[:8]:
            # a window of 8 cycles can emit 72 tokens a row: leave some
            r.max_new_tokens = 400
            eng.submit(r)
        eng.step()
        _window_without_sync(eng)
        print("spec: no host synchronization inside a generate_spec window of 8 cycles or a "
              "dense spec serving window", flush=True)
    print(f"spec: phase done in {time.perf_counter() - t_phase:.1f} s; launches summed over the "
          f"counted runs: {json.dumps(total)}", flush=True)
    return total


# ---------------------------------------------------------------- fp32 ----
def _as_bf16_names(label, counts):
    """The launch counts of an fp32 run under the bf16 kernels' names (for
    the bf16 phases' gates): each fp32 form's count in its bf16 kernel's
    place. A bf16 kernel of the main path that launched raises: at fp32
    every launch is an fp32 form's."""
    ran = {k: counts[k] for k in FP32_OF if counts[k]}
    if ran:
        raise AssertionError(f"{label}: bf16 kernels launched in an fp32 run: {ran}")
    out = {k: v for k, v in counts.items() if k not in FP32_OF.values()}
    out.update({k: counts[f] for k, f in FP32_OF.items()})
    return out


def _as_uniform_names(label, counts, act):
    """The launch counts of a run over a cache of the other dtype under the
    bf16 kernels' names (for the uniform phases' gates): each mixed form's
    count in its uniform form's place, an fp32 run's then mapped as
    ``_as_bf16_names`` maps it. A uniform form of the three cache families,
    or a mixed form of the other activation dtype, that launched raises:
    over such a cache every launch of them is this dtype's mixed form's."""
    of = MIXED_OF[act]
    other = [m for a, o in MIXED_OF.items() if a != act for m in o.values()]
    ran = {k: counts[k] for k in (*of, *other) if counts[k]}
    if ran:
        raise AssertionError(f"{label}: uniform or other cache forms launched over a mixed "
                             f"cache: {ran}")
    out = {k: v for k, v in counts.items() if k not in of.values()}
    out.update({k: counts[m] for k, m in of.items()})
    return _as_bf16_names(label, out) if act == torch.float32 else out


def _only_launches(label, counts, want):
    """The launches of a run are exactly ``want`` (every other count 0)."""
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def fp32_kernel_phase(report: KernelReport, dev):
    """The fp32 forms (``--dtype float32``) against their plain fp32 versions
    at the main path's shapes, within FP32_REL of the largest element (TF32
    off): B1 at the LM prefill and the 896 px tower; the GEMV tile at layer
    5's four projections at B1, B8 and the verify's M9 and M72 (qkv with the
    norm and RoPE + KV write, gate/up with the norm); the head at B1 and B8
    (ids the argmax of the fp32 logits path's GEMV, bit for bit); 3b at B1
    and B8, W2048; B5 at B8, W1024, page size 64 (and dense == paged on
    shared keys); the final norm. Times beside the bound at fp32 (67 TFLOP/s
    outside the tensor cores; B1's at 3xTF32, 165 TFLOP/s on the tensor
    cores; or the bytes at 3.35 TB/s) and the library
    call: fp32 SDPA with the same mask for B1, 3b and B5, cuBLAS fp32 on
    the dequantized weight for the GEMVs (another function: no epilogue,
    fp32 weights), F.rms_norm for the norm."""
    from paligemma_tpu_torch.kernels import decode_attention as da
    from paligemma_tpu_torch.kernels import decode_elementwise as el
    from paligemma_tpu_torch.kernels import decode_head as dh
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(SEED + 22)

    def f32(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)

    def int8_weight(k, n):
        w8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
        s = torch.from_numpy((rng.random(n, dtype=np.float32) + 0.5) / (127.0 * k**0.5)).to(dev)
        return w8, s

    def same_bits(name, label, a, b):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{name} {label}: a second call gave other bits")

    print(f"kernels: fp32 forms (--dtype float32), within {FP32_REL} of the largest element of "
          "the plain fp32 version, TF32 off", flush=True)
    # -- B1 at fp32: the LM prefill (in the JSON line) and the 896 px tower
    for label, (b, sq, hq, hkv, d), n_ok in (("LM prefill B1 S266 Hq8 Hkv1 D256",
                                              (1, 266, 8, 1, 256), 266),
                                             ("tower B1 S4096 H16 D72", (1, 4096, 16, 16, 72),
                                              4096)):
        q, k, v = f32(b, sq, hq, d), f32(b, sq, hkv, d), f32(b, sq, hkv, d)
        pl = kl = torch.tensor([n_ok], dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl)
        again = fa.flash_attention_with_lse(q, k, v, pl, kl)
        want_out, want_lse = fa._reference_forward(q, k, v, pl, kl, d**-0.5, 0)
        sync()
        report.case("flash_attention_fwd_fp32", f"{label} out", out, want_out, FP32_REL, floor=0)
        report.case("flash_attention_fwd_fp32", f"{label} lse", lse, want_lse, 1e-5)
        same_bits("flash_attention_fwd_fp32", label, again, (out, lse))
        del want_out, want_lse, again
        allowed = fa._allowed(sq, sq, pl, kl, 0, dev)
        a = _sdpa_args(q, k, v, allowed)
        mask = None if bool(allowed.all()) else a[3]

        def sdpa(a=a, mask=mask):
            return F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=mask,
                                                  enable_gqa=True)

        def run(q=q, k=k, v=v, pl=pl, kl=kl):
            return fa.flash_attention(q, k, v, pl, kl)

        flops, n_bytes = 4 * d * hq * int(allowed.sum()), 2 * nbytes(q) + nbytes(k, v)
        lm = label.startswith("LM")
        report.time("flash_attention_fwd_fp32", label, run,
                    lambda: fa.reference_attention(q, k, v, pl, kl), flops=flops,
                    n_bytes=n_bytes, library_fn=sdpa, iters=20 if lm else 3, in_json=lm,
                    peak=PEAK_TF32X3_FLOPS)
        dt = device_times(label, [("flash_attention_fwd_fp32", run), ("SDPA fp32", sdpa)],
                          iters=10 if lm else 2)
        print(f"  device B1 fp32 {label}: " + ", ".join(
            f"{n} {'not measured' if ms is None else f'{ms:.4f} ms'}" for n, ms in dt.items())
            + f"; bound {bound_ms(flops, n_bytes, PEAK_TF32X3_FLOPS):.4f} ms (3xTF32 at "
            f"{PEAK_TF32X3_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
        del q, k, v, out, lse, a

    # -- the GEMV tile at fp32: layer 5's projections at decode and verify rows
    fns = []
    for name, k, n, epi in (("qkv+norm+RoPE", 2048, 2560, "rope"), ("o+res", 2048, 2048, "res"),
                            ("gateup+norm+GeGLU", 2048, 32768, "geglu"),
                            ("down+res", 16384, 2048, "res")):
        w8, s = int8_weight(k, n)
        wdq = w8.float() * s  # the library's operand: the dequantized weight
        wn = f32(k, scale=0.1)
        counter = "int8_gemv_rope_kv_fp32" if epi == "rope" else "int8_gemv_fp32"
        for b in (1, 8, 9, 72):
            x = f32(b, k)
            label = f"{name} {'B' if b <= 8 else 'M'}{b} {k}->{n}"
            if epi == "rope":
                ang = f32(b, 256)
                cos, sin = ang.cos(), ang.sin()
                pos = torch.tensor([(37 * i) % 1000 for i in range(b)], dtype=torch.int32,
                                   device=dev)
                bufs = [torch.zeros(b, 1024, 256, device=dev) for _ in range(4)]
                news = [torch.empty(b, 256, device=dev) for _ in range(4)]

                def run(x=x, w8=w8, s=s, cos=cos, sin=sin, pos=pos, bufs=bufs, news=news, wn=wn):
                    return gv.int8_gemv_rope_kv(x, w8, s, cos, sin, pos, 8, bufs[0], bufs[1],
                                                news[0], news[1], norm=(wn, 1e-6))

                def plain(x=x, w8=w8, s=s, cos=cos, sin=sin, pos=pos, bufs=bufs, news=news,
                          wn=wn):
                    return gv.int8_gemv_rope_kv_reference(x, w8, s, cos, sin, pos, 8, bufs[2],
                                                          bufs[3], news[2], news[3],
                                                          norm=(wn, 1e-6))

                got, want = run()[0], plain()[0]
                sync()
                report.case(counter, f"{label} q", got, want, FP32_REL, floor=0)
                for what, g, w in (("K row", bufs[0], bufs[2]), ("V row", bufs[1], bufs[3]),
                                   ("k_new", news[0], news[2]), ("v_new", news[1], news[3])):
                    report.case(counter, f"{label} {what}", g, w, FP32_REL, floor=0)
                same_bits(counter, label, (run()[0],), (got,))
                out_bytes = nbytes(got) + 4 * b * 256 * 4
            else:
                kw = ({"residual": f32(b, n)} if epi == "res"
                      else {"geglu": True, "norm": (wn, 1e-6)})

                def run(x=x, w8=w8, s=s, kw=kw):
                    return gv.int8_gemv(x, w8, s, **kw)

                def plain(x=x, w8=w8, s=s, kw=kw):
                    return gv.int8_gemv_reference(x, w8, s, **kw)

                got, want = run(), plain()
                sync()
                report.case(counter, label, got, want, FP32_REL, floor=0)
                same_bits(counter, label, (run(),), (got,))
                out_bytes = nbytes(got) + (nbytes(kw["residual"]) if epi == "res" else 0)
            if b == 1:
                n_bytes = nbytes(x, w8, s) + out_bytes + (4 * k if epi != "res" else 0)

                def lib(x=x, wdq=wdq):
                    return x @ wdq

                report.time(counter, label + " (library: cuBLAS fp32 x @ dequantized W, "
                            "another function)", run, plain, flops=2 * b * k * n,
                            n_bytes=n_bytes, library_fn=lib, peak=PEAK_FP32_FLOPS)
                fns += [(f"{counter} {name}", run), (f"cuBLAS fp32 {name}", lib)]
        del w8, s, wdq
    device_times("fp32 B1 layer 5", fns)
    del fns

    # -- the head at fp32: ids the argmax of the fp32 logits path's GEMV
    w8, s = int8_weight(2048, 257152)
    head = dh.repack_head({"w8": w8, "s": s})
    for b in (1, 8):
        y = f32(b, 2048)
        ids, mx = dh.head_argmax_fused(y, head, return_max=True)
        logits = gv.int8_gemv(y, w8, s)  # the fp32 logits path's own head
        plain = (y @ w8.float()) * s
        sync()
        if not (logits.dtype == torch.float32 and torch.equal(ids.long(), logits.argmax(-1))
                and torch.equal(mx, logits.max(-1).values)):
            raise AssertionError("head_argmax_fp32: differs from argmax of the fp32 logits path")
        print(f"  {'head_argmax_fp32':20s} {f'B{b} ids == argmax of int8_gemv_fp32 logits':44s} "
              "bit for bit  ok", flush=True)
        report.case("head_argmax_fp32", f"B{b} winning logit vs plain max",
                    plain.gather(1, ids.long()[:, None])[:, 0], plain.max(-1).values, FP32_REL,
                    floor=0)
        report.case("head_argmax_fp32", f"B{b} fp32 logits path vs plain", logits, plain,
                    FP32_REL, floor=0)
        del plain, logits
        if b == 1:
            report.time("head_argmax_fp32", "B1 2048->257152",
                        lambda: dh.head_argmax_fused(y, head),
                        lambda: dh.reference_head_argmax(y, {"w8": w8, "s": s}),
                        flops=2 * w8.numel(), n_bytes=nbytes(y, w8, s, ids, mx), iters=5,
                        peak=PEAK_FP32_FLOPS)
            device_times("fp32 B1 2048->257152", [
                ("head_argmax_fp32", lambda: dh.head_argmax_fused(y, head))])
    del w8, s, head

    # -- 3b at fp32, W2048
    for b in (1, 8):
        q = f32(b, 8, 256)
        kc, vc = f32(b, MAX_SEQ, 256), f32(b, MAX_SEQ, 256)
        lens = torch.tensor([2048 - 61 * i for i in range(b)], device=dev)
        valid = (torch.arange(2048, device=dev)[None] < lens[:, None]).contiguous()
        if b > 1:
            valid[1, 5:40] = False  # a hole
        got = da.decode_attention(q, kc, vc, valid, 256**-0.5)
        want = da.decode_attention_reference(q, kc, vc, valid, 256**-0.5)
        sync()
        label = f"B{b} W2048 D256 Hq8"
        report.case("decode_attention_fp32", label, got, want, FP32_REL, floor=0)
        if b == 1:
            n_keys = int(valid.sum())
            a = (q[:, :, None], kc[:, None, :2048], vc[:, None, :2048], valid[:, None, None])

            def sdpa(a=a):
                return F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                      scale=256**-0.5, enable_gqa=True)

            def run(q=q, kc=kc, vc=vc, valid=valid):
                return da.decode_attention(q, kc, vc, valid, 256**-0.5)

            report.time("decode_attention_fp32", label, run,
                        lambda: da.decode_attention_reference(q, kc, vc, valid, 256**-0.5),
                        flops=4 * 256 * 8 * n_keys,
                        n_bytes=nbytes(q, valid, got) + 2 * n_keys * 256 * 4, library_fn=sdpa,
                        peak=PEAK_FP32_FLOPS)
            device_times(f"fp32 {label}", [("decode_attention_fp32", run), ("SDPA fp32", sdpa)])
        del kc, vc

    # -- B5 at fp32: B8, W1024, page size 64, at layer 17 of the stacked pool
    ps, n_layers, b, w = 64, 18, 8, 1024
    n_p = w // ps
    n_pages = b * n_p + 1
    kp, vp = f32(n_layers, n_pages, ps, 1, 256), f32(n_layers, n_pages, ps, 1, 256)
    pids = np.arange(1, n_pages)
    rng.shuffle(pids)
    table = torch.from_numpy(pids.reshape(b, n_p).astype(np.int32)).to(dev)
    lens = [w - 61 * i for i in range(b)]
    lens[3] = 0  # an empty row: exact zeros
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = f32(b, 8, 256)
    got = pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
    want = pa.reference_paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
    sync()
    label = "B8 W1024 Hq8 Hkv1 layer17 fragmented"
    report.case("paged_decode_attention_fp32", label, got, want, FP32_REL, floor=0)
    if torch.count_nonzero(got[3]):
        raise AssertionError("paged_decode_attention_fp32: a kv_len 0 row is not exact zeros")
    kd = kp[17][table.long()].reshape(b, w, 256)
    vd = vp[17][table.long()].reshape(b, w, 256)
    pmask = (torch.arange(w, device=dev)[None] < kv_len[:, None].long())[:, None, None]

    def run_paged():
        return pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)

    def sdpa_paged():
        return F.scaled_dot_product_attention(q[:, :, None], kd[:, None], vd[:, None],
                                              attn_mask=pmask, enable_gqa=True)

    n_keys = sum(lens)
    report.time("paged_decode_attention_fp32", label + " (library: SDPA fp32 on the keys "
                "gathered)", run_paged,
                lambda: pa.reference_paged_decode_attention(q, kp, vp, table, kv_len,
                                                            layer_idx=17),
                flops=4 * 256 * 8 * n_keys,
                n_bytes=nbytes(q, table, kv_len, got) + 2 * n_keys * 256 * 4,
                library_fn=sdpa_paged, peak=PEAK_FP32_FLOPS)
    device_times(f"fp32 {label}", [("paged_decode_attention_fp32", run_paged),
                                   ("SDPA fp32 (keys gathered)", sdpa_paged)])
    # dense == paged at fp32: each row's pages are consecutive slices of its
    # dense cache row
    dense = da.decode_attention(q, kd, vd, pmask[:, 0, 0].contiguous(), 256**-0.5)
    paged = pa.paged_decode_attention(q, kp, vp, table, kv_len, 256**-0.5, layer_idx=17)
    sync()
    same = torch.equal(paged, dense.reshape(b, 8, 256))
    print(f"  {'paged_decode_attention_fp32':20s} {'shared keys vs decode_attention_fp32':44s} "
          f"torch.equal {same}  {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("paged_decode_attention_fp32 differs from decode_attention_fp32 "
                             "on shared keys")
    del kp, vp, kd, vd

    # -- the final norm at fp32
    for b in (1, 8):
        x, wn = f32(b, 2048), f32(2048, scale=0.1)
        got, want = el.rms_norm(x, wn, 1e-6), el.rms_norm_reference(x, wn, 1e-6)
        sync()
        report.case("rms_norm_fp32", f"B{b} K2048", got, want, 1e-6, floor=0)
        if b == 1:
            w1 = 1.0 + wn
            report.time("rms_norm_fp32", f"B{b} K2048", lambda: el.rms_norm(x, wn, 1e-6),
                        lambda: el.rms_norm_reference(x, wn, 1e-6), flops=4 * x.numel(),
                        n_bytes=nbytes(x, wn, got),
                        library_fn=lambda: F.rms_norm(x, (2048,), w1, 1e-6),
                        peak=PEAK_FP32_FLOPS)
            device_times("fp32 B1 K2048", [("rms_norm_fp32", lambda: el.rms_norm(x, wn, 1e-6)),
                                           ("F.rms_norm fp32",
                                            lambda: F.rms_norm(x, (2048,), w1, 1e-6))])
    del x, wn
    fp32_bank_cases(report, dev, f32, int8_weight)
    fp32_partial_cases(report, dev, f32, int8_weight)
    fp32_w8a8_cases(report, dev, f32, int8_weight)
    return fp32_attention_cases(report, dev, f32)


def fp32_attention_cases(report: KernelReport, dev, f32):
    """fp32_kernel_phase's attention forms of the training and ablation
    paths, each against its plain fp32 version within FP32_REL of the
    largest element, a second call the same bits:

    * B6's fp32 dq and dk/dv (with the fp32-out split sum) at the training
      shape (B2 S512 Hq8, and a TP rank's Hq4, Hkv1 D256, prefix 268, kv_len
      512 / 400), GQA at D64, a kv_len 0 row at D72 (exact zeros), D128,
      and the edges of the 3xTF32 tiles (B6_FP32_CASES); timed at Hq8 and
      Hq4 beside one fp32 SDPA backward with a bool mask, bound at 3xTF32;
    * B12's fp32 form at the 224, 448 and 896 px towers (B1 H16 D72), timed
      beside fp32 SDPA;
    * B10's fp32 form at the Gemma-2B cache (S 2048, D 256) with pad holes
      (NaN in skipped tiles is never read), timed at B1 beside fp32 SDPA,
      then one counted call per case through its entry point.

    Returns the counted calls' launches."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.kernels import flash_attention as fa
    from paligemma_tpu_torch.kernels.ablation import decode_attention as sda
    from paligemma_tpu_torch.kernels.ablation import vision_attention as va

    # -- B6 at fp32
    print("kernels: flash_attention_bwd_dq_fp32, flash_attention_bwd_dkv_fp32 (B6 fp32)",
          flush=True)
    for label, (b, s, hq, hkv, d), pfx, kvl, timed in B6_FP32_CASES:
        q, k, v, dout = f32(b, s, hq, d), f32(b, s, hkv, d), f32(b, s, hkv, d), f32(b, s, hq, d)
        pl = torch.tensor(pfx, dtype=torch.int32, device=dev)
        kl = torch.tensor(kvl, dtype=torch.int32, device=dev)
        out, lse = fa.flash_attention_with_lse(q, k, v, pl, kl)
        delta = fa._delta(out, dout)
        scale = d**-0.5

        def run_dq(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta, pl=pl, kl=kl, scale=scale):
            return fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, pl, kl, scale)

        def run_dkv(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta, pl=pl, kl=kl, scale=scale):
            return fa.flash_attention_bwd_dkv(q, k, v, dout, lse, delta, pl, kl, scale)

        def plain(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta, pl=pl, kl=kl, scale=scale):
            return fa._reference_backward(q, k, v, dout, lse, delta, pl, kl, scale, 0)

        dq, (dk, dv), want = run_dq(), run_dkv(), plain()
        again = (run_dq(), *run_dkv())
        sync()
        report.case("flash_attention_bwd_dq_fp32", label, dq, want[0], FP32_REL, floor=0)
        report.case("flash_attention_bwd_dkv_fp32", f"{label} dk", dk, want[1], FP32_REL,
                    floor=0)
        report.case("flash_attention_bwd_dkv_fp32", f"{label} dv", dv, want[2], FP32_REL,
                    floor=0)
        if not all(torch.equal(x, y) for x, y in zip(again, (dq, dk, dv))):
            raise AssertionError(f"flash backward fp32 {label}: a second call gave other bits")
        if kvl[-1] == 0 and any(bool(t[-1].any()) for t in (dq, dk, dv)):
            raise AssertionError("flash backward fp32: the kv_len 0 row is not exact zeros")
        del want, again
        if not timed:
            continue
        allowed = fa._allowed(s, s, pl, kl, 0, dev)
        pairs = hq * int(allowed.sum())  # visible (query head, row, key) triples
        stats = nbytes(lse, delta)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        a = _sdpa_args(*leaves, allowed)
        lib_out = F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                 enable_gqa=True)

        def lib_bwd(lib_out=lib_out, leaves=leaves, g=dout.transpose(1, 2)):
            return torch.autograd.grad(lib_out, leaves, g, retain_graph=True)

        flops_dq, flops_dkv = 6 * d * pairs, 8 * d * pairs
        bytes_dq = nbytes(q, k, v, dout, dq) + stats
        bytes_dkv = nbytes(q, k, v, dout, dk, dv) + stats
        dt = device_times(f"fp32 {label}", [("flash_attention_bwd_dq_fp32", run_dq),
                                            ("flash_attention_bwd_dkv_fp32", run_dkv),
                                            ("SDPA fp32 backward", lib_bwd)], iters=5)
        print(f"  device B6 fp32 {label}: dq {_ms(dt['flash_attention_bwd_dq_fp32'])} (bound "
              f"{bound_ms(flops_dq, bytes_dq, PEAK_TF32X3_FLOPS):.4f} ms), dk/dv "
              f"{_ms(dt['flash_attention_bwd_dkv_fp32'])} (bound "
              f"{bound_ms(flops_dkv, bytes_dkv, PEAK_TF32X3_FLOPS):.4f} ms), one fp32 SDPA "
              f"backward {_ms(dt['SDPA fp32 backward'])}", flush=True)
        if timed == "device":  # printed only
            continue
        report.time("flash_attention_bwd_dq_fp32", label, run_dq, lambda plain=plain: plain()[0],
                    flops=flops_dq, n_bytes=bytes_dq, library_fn=lib_bwd, iters=10,
                    peak=PEAK_TF32X3_FLOPS)
        report.time("flash_attention_bwd_dkv_fp32", label, run_dkv,
                    lambda plain=plain: plain()[1:], flops=flops_dkv, n_bytes=bytes_dkv,
                    library_fn=lib_bwd, iters=10, peak=PEAK_TF32X3_FLOPS)
    del q, k, v, dout, out, lse, delta, dq, dk, dv, lib_bwd

    # -- B12 at fp32: the towers' S, B1 H16 D72
    print("kernels: vision_attention_fp32 (B12 fp32; SigLIP-So400m H16 D72)", flush=True)
    for label, s in (("224px B1 S256 H16 D72", 256), ("448px B1 S1024 H16 D72", 1024),
                     ("896px B1 S4096 H16 D72", 4096)):
        q, k, v = f32(1, s, 16, 72), f32(1, s, 16, 72), f32(1, s, 16, 72)
        got, again = va.vision_attention(q, k, v), va.vision_attention(q, k, v)
        want = va.vision_attention_reference(q, k, v, 72**-0.5)
        sync()
        report.case("vision_attention_fp32", label, got, want, FP32_REL, floor=0)
        if not torch.equal(again, got):
            raise AssertionError(f"vision_attention_fp32 {label}: a second call gave other bits")
        del want, again
        sdpa = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        flops = 4 * s * s * 72 * 16

        def run(q=q, k=k, v=v):
            return va.vision_attention(q, k, v)

        def lib(sdpa=sdpa):
            return F.scaled_dot_product_attention(*sdpa)

        report.time("vision_attention_fp32", label, run,
                    lambda q=q, k=k, v=v: va.vision_attention_reference(q, k, v, 72**-0.5),
                    flops=flops, n_bytes=nbytes(q, k, v, got), library_fn=lib,
                    iters=20 if s < 4096 else 3, peak=PEAK_TF32X3_FLOPS)
        if s == 4096:
            dt = device_times(f"fp32 {label}", [("vision_attention_fp32", run),
                                                ("SDPA fp32", lib)], iters=2)
            print(f"  device B12 fp32 {label}: " + ", ".join(
                f"{n} {_ms(ms)}" for n, ms in dt.items()) + f"; bound "
                f"{bound_ms(flops, nbytes(q, k, v, got), PEAK_TF32X3_FLOPS):.4f} ms", flush=True)
        del q, k, v, got, sdpa

    # -- B10 at fp32: Gemma-2B's cache, pad holes and kv_len at tile edges
    print("kernels: seg_decode_attention_fp32 (B10 fp32; S_max 2048 D256)", flush=True)
    seg_rows = ([2048, 64, 250, 256, 300, 33, 97, 700], [2048, 64, 266, 640, 300, 33, 1200, 700],
                [2048, 64, 1000, 1024, 300, 33, 1500, 700])
    cases = []
    for b, hq, hkv in ((1, 8, 1), (8, 8, 1), (8, 4, 2)):
        q, kc, vc = f32(b, hq, 256), f32(b, MAX_SEQ, hkv, 256), f32(b, MAX_SEQ, hkv, 256)
        segs = [torch.tensor(r[:b], dtype=torch.int32, device=dev) for r in seg_rows]
        label = f"B{b} Hq{hq} Hkv{hkv} W{MAX_SEQ} D256" + (" holes" if b > 1 else "")
        got, again = sda.decode_attention(q, kc, vc, *segs), sda.decode_attention(q, kc, vc, *segs)
        want = sda.reference_decode_attention(q, kc, vc, *segs)
        sync()
        report.case("seg_decode_attention_fp32", label, got, want, FP32_REL, floor=0)
        if not torch.equal(again, got):
            raise AssertionError(f"seg_decode_attention_fp32 {label}: a second call gave other "
                                 "bits")
        cases.append((q, kc, vc, segs))
        if b > 1:  # NaN in the skipped tiles: they are never read
            kp, vp = kc.clone(), vc.clone()
            for t in (kp, vp):
                t[3, 256:640] = float("nan")
                t[1, 64:] = float("nan")
            if not torch.equal(sda.decode_attention(q, kp, vp, *segs), got):
                raise AssertionError(f"seg_decode_attention_fp32 {label}: read a tile it must "
                                     "skip")
            del kp, vp
            continue
        col = torch.arange(MAX_SEQ, device=dev)[None]
        ok = (col < segs[0][:, None]) | ((col >= segs[1][:, None]) & (col < segs[2][:, None]))
        n_keys = int(ok.sum())
        a = (q[:, :, None], kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3), ok[:, None, None])

        def run(q=q, kc=kc, vc=vc, segs=segs):
            return sda.decode_attention(q, kc, vc, *segs)

        def lib(a=a):
            return F.scaled_dot_product_attention(a[0], a[1], a[2], attn_mask=a[3],
                                                  enable_gqa=True)

        report.time("seg_decode_attention_fp32", label, run,
                    lambda: sda.reference_decode_attention(q, kc, vc, *segs),
                    flops=4 * 256 * hq * n_keys,
                    n_bytes=nbytes(q, got, *segs) + 2 * n_keys * hkv * 256 * 4, library_fn=lib,
                    peak=PEAK_FP32_FLOPS)
        device_times(f"fp32 {label}", [("seg_decode_attention_fp32", run), ("SDPA fp32", lib)])
    kernels.reset_launch_counts()
    for q, kc, vc, segs in cases:
        sda.decode_attention(q, kc, vc, *segs)
    sync()
    counts = kernels.launch_counts()
    _only_launches("seg_decode_attention_fp32 entry point", counts,
                   {"seg_decode_attention_fp32": len(cases)})
    print(f"kernels: seg_decode_attention_fp32 entry-point runs: {len(cases)} launches, no "
          "other kernel", flush=True)
    return counts


def mixed_kernel_cases(report: KernelReport, dev):
    """The mixed forms (a KV cache of the other dtype: bf16 q over fp32,
    fp32 q over bf16) against their plain versions within MIXED_REL at the
    main paths' shapes: the qkv GEMV with the norm prologue and the RoPE +
    KV write (2048->2560, B1 into a dense cache, B8 into page slots; its q
    and the cache rows bit for bit the uniform form's q and rows converted
    to the cache dtype); 3b at B1 and B8, W2048 and B5 at B8, W1024, page
    size 64, layer 17 (bit for bit the uniform form on the cache converted
    first, dense == paged on shared keys, a kv_len 0 row zeros). Times
    beside the plain version and the bound (the cache's bytes in its own
    dtype); no library call takes a cache of another dtype than q (SDPA
    takes one), so none is timed. Device times through ``profiled``."""
    from paligemma_tpu_torch.kernels import decode_attention as da
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(SEED + 25)

    def rnd(*shape, dtype, scale=1.0):
        t = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale).to(dev)
        return t.to(dtype)

    def bits(name, label, checks):
        print(f"  {name:20s} {label:44s} bits: " + ", ".join(f"{k} {v}" for k, v in checks.items())
              + f"  {'ok' if all(checks.values()) else 'FAIL'}", flush=True)
        if not all(checks.values()):
            raise AssertionError(f"{name} {label}: bit rules {checks}")

    print(f"kernels: the mixed forms (a KV cache of the other dtype), within "
          f"{MIXED_REL[torch.bfloat16]} (bf16 q) / {FP32_REL} (fp32 q) of the plain versions",
          flush=True)
    fns = []
    for act, cache in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        rope_name, dense_name, paged_name = MIXED_OF[act].values()
        tol, floor = MIXED_REL[act], 1.0 if act == torch.bfloat16 else 0.0
        peak = PEAK_FLOPS if act == torch.bfloat16 else PEAK_FP32_FLOPS
        csize = torch.finfo(cache).bits // 8
        pair = f"{str(act)[6:]} over {str(cache)[6:]}"

        # -- K-a: the qkv GEMV's RoPE + KV write into the other dtype
        k, h, d, n = 2048, 8, 256, 2560
        w8 = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8)).to(dev)
        s = torch.from_numpy((rng.random(n, dtype=np.float32) + 0.5) / (127.0 * k**0.5)).to(dev)
        norm = (rnd(k, dtype=act, scale=0.1), 1e-6)
        for b, paged in ((1, False), (8, True)):
            x = rnd(b, k, dtype=act, scale=3.0)
            ang = torch.from_numpy(rng.random((b, d), dtype=np.float32) * 6.28).to(dev)
            cos, sin = ang.cos().to(act), ang.sin().to(act)
            pos = torch.tensor([(300 + 229 * i) % 1000 for i in range(b)], dtype=torch.int32,
                               device=dev)
            table, shape = None, (b, 1024, d)
            if paged:
                table = torch.from_numpy(rng.permutation(b * 16).reshape(b, 16) + 1).to(
                    device=dev, dtype=torch.int32)
                shape = (b * 16 + 1, PAGE, d)

            def bufs(dtype):
                return ([torch.zeros(shape, dtype=dtype, device=dev) for _ in range(2)]
                        + [torch.empty(b, d, dtype=dtype, device=dev) for _ in range(2)])

            def run(fn, out, x=x, cos=cos, sin=sin, pos=pos, table=table, w8=w8, s=s,
                    norm=norm):
                q, _, _ = fn(x, w8, s, cos, sin, pos, h, *out, norm=norm, page_table=table)
                return [q, *out]

            mine, plain, one = bufs(cache), bufs(cache), bufs(act)
            got = run(gv.int8_gemv_rope_kv, mine)
            want = run(gv.int8_gemv_rope_kv_reference, plain)
            same = run(gv.int8_gemv_rope_kv, one)
            sync()
            label = f"{pair} qkv+norm+RoPE B{b} {'paged' if paged else 'dense'}"
            report.case(rope_name, f"{label} q", got[0], want[0], tol, floor)
            report.case(rope_name, f"{label} K/V rows, k_new/v_new",
                        torch.cat([t.flatten() for t in got[1:]]),
                        torch.cat([t.flatten() for t in want[1:]]), MIXED_REL[torch.bfloat16])
            bits(rope_name, label, {
                "q == uniform form's": torch.equal(got[0], same[0]),
                "rows == uniform rows .to(cache)": all(
                    torch.equal(u, v.to(cache)) for u, v in zip(got[1:], same[1:]))})
            if b == 1:
                def kern(mine=mine, run=run):
                    return run(gv.int8_gemv_rope_kv, mine)

                report.time(rope_name, label, kern,
                            lambda plain=plain, run=run: run(gv.int8_gemv_rope_kv_reference,
                                                             plain),
                            flops=2 * b * k * n + 6 * b * n,
                            n_bytes=(nbytes(x, norm[0], w8, s, cos, sin, pos, got[0])
                                     + 4 * b * d * csize), peak=peak)
                fns.append((f"{rope_name} B1", kern))

        # -- K-b: 3b over a cache of the other dtype, W2048
        for b in (1, 8):
            q = rnd(b, 8, 256, dtype=act)
            kc, vc = rnd(b, MAX_SEQ, 256, dtype=cache), rnd(b, MAX_SEQ, 256, dtype=cache)
            lens = torch.tensor([2048 - 61 * i for i in range(b)], device=dev)
            valid = (torch.arange(2048, device=dev)[None] < lens[:, None]).contiguous()
            if b > 1:
                valid[1, 5:40] = False  # a hole
            got = da.decode_attention(q, kc, vc, valid, 256**-0.5)
            want = da.decode_attention_reference(q, kc, vc, valid, 256**-0.5)
            same = da.decode_attention(q, kc.to(act), vc.to(act), valid, 256**-0.5)
            sync()
            label = f"{pair} B{b} W2048 D256 Hq8"
            report.case(dense_name, label, got, want, tol, floor)
            bits(dense_name, label, {"== uniform form on the converted cache":
                                     torch.equal(got, same)})
            if b == 1:
                n_keys = int(valid.sum())

                def kern(q=q, kc=kc, vc=vc, valid=valid):
                    return da.decode_attention(q, kc, vc, valid, 256**-0.5)

                report.time(dense_name, label, kern,
                            lambda: da.decode_attention_reference(q, kc, vc, valid, 256**-0.5),
                            flops=4 * 256 * 8 * n_keys,
                            n_bytes=nbytes(q, valid, got) + 2 * n_keys * 256 * csize, peak=peak)
                fns.append((f"{dense_name} B1 W2048", kern))
            del kc, vc

        # -- K-c: B5 over a pool of the other dtype, B8 W1024 ps64 layer 17
        n_layers, b, w = 18, 8, 1024
        n_p = w // PAGE
        n_pages = b * n_p + 1
        kp = rnd(n_layers, n_pages, PAGE, 1, 256, dtype=cache)
        vp = rnd(n_layers, n_pages, PAGE, 1, 256, dtype=cache)
        table = torch.from_numpy((rng.permutation(n_pages - 1) + 1).reshape(b, n_p).astype(
            np.int32)).to(dev)
        lens = [w - 61 * i for i in range(b)]
        lens[3] = 0  # an empty row: exact zeros
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = rnd(b, 8, 256, dtype=act)
        got = pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
        want = pa.reference_paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)
        same = pa.paged_decode_attention(q, kp[17:18].to(act), vp[17:18].to(act), table, kv_len,
                                         layer_idx=0)
        kd = kp[17][table.long()].reshape(b, w, 256)
        vd = vp[17][table.long()].reshape(b, w, 256)
        pmask = (torch.arange(w, device=dev)[None] < kv_len[:, None].long()).contiguous()
        dense = da.decode_attention(q, kd, vd, pmask, 256**-0.5)
        sync()
        label = f"{pair} B8 W1024 Hq8 Hkv1 layer17 fragmented"
        report.case(paged_name, label, got, want, tol, floor)
        bits(paged_name, label, {"== uniform form on the converted pool": torch.equal(got, same),
                                 "== the dense mixed form on shared keys":
                                 torch.equal(got, dense.reshape(b, 8, 256)),
                                 "kv_len 0 row zeros": not torch.count_nonzero(got[3])})

        def kern_p(q=q, kp=kp, vp=vp, table=table, kv_len=kv_len):
            return pa.paged_decode_attention(q, kp, vp, table, kv_len, layer_idx=17)

        n_keys = sum(lens)
        report.time(paged_name, label, kern_p,
                    lambda: pa.reference_paged_decode_attention(q, kp, vp, table, kv_len,
                                                                layer_idx=17),
                    flops=4 * 256 * 8 * n_keys,
                    n_bytes=nbytes(q, table, kv_len, got) + 2 * n_keys * 256 * csize, peak=peak)
        fns.append((f"{paged_name} B8 W1024", kern_p))
        del kp, vp, kd, vd
    device_times("mixed forms", fns)


def _ms(v):
    return "not measured" if v is None else f"{v:.4f} ms"


def fp32_bank_cases(report: KernelReport, dev, f32, int8_weight):
    """F1 and F2: the LoRA shrink's fp32 form and the expand in the fp32
    GEMV's epilogue at layer 5's four targets (qkv through the RoPE + KV
    write with the input norm, gate | up with the post-attention norm, o
    and down with the residual), B1 and B8, a [base, a, b, c] bank of rank
    LORA_RANK (fp32 A and B, the zero adapter in row 0): each within FP32_REL
    of its plain version (z, and the projection with its delta), base rows
    the fp32 GEMV's bits without the bank, a second call's bits. At B8 each
    shrink and GEMV with the expand timed (the shrinks in the JSON row of
    lora_shrink_fp32; the expand printed, int8_gemv_fp32's row keeps the
    GEMV alone) beside cuBLAS fp32 ``x @ A`` and ``z @ B``, then device
    times of the four."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    gcols = (len(LORA_NAMES) + 1) * LORA_RANK
    print(f"kernels: F1 lora_shrink_fp32 + F2 the LoRA expand in the fp32 GEMV ({len(LORA_NAMES)} "
          f"adapters and the base row, rank {LORA_RANK}, G {gcols}; layer 5's shapes)", flush=True)
    groups = (("qkv", 2048, 2560, (2048, 2304)), ("o", 2048, 2048, ()),
              ("gu", 2048, 32768, (16384,)), ("down", 16384, 2048, ()))
    device, tot = [], {}
    for name, k, n, bounds in groups:
        w8, s = int8_weight(k, n)
        nt = len(bounds) + 1
        a = f32(k, nt * gcols, scale=k**-0.5)
        a[:, torch.arange(nt * gcols, device=dev) % gcols < LORA_RANK] = 0  # the zero adapter
        lb = f32(gcols, n, scale=LORA_B_STD)
        wn = f32(k, scale=0.1) if name in ("qkv", "gu") else None
        norm = None if wn is None else (wn, 1e-6)
        for b in (1, 8):
            ids = (torch.arange(b, device=dev) % (len(LORA_NAMES) + 1)).to(torch.int32)
            x = f32(b, k)
            tag = f"{name} B{b} K{k} nG{a.shape[1]}"
            z = kl.lora_shrink(x, a, ids, LORA_RANK, gcols, norm=norm)
            zp = kl.lora_shrink_reference(x, a, ids, LORA_RANK, gcols, norm=norm)
            sync()
            report.case("lora_shrink_fp32", tag, z, zp, FP32_REL, floor=0)
            if name == "qkv":
                ang = f32(b, 256)
                cos, sin = ang.cos(), ang.sin()
                pos = torch.tensor([(37 * i) % 1000 for i in range(b)], dtype=torch.int32,
                                   device=dev)
                bufs = [torch.zeros(b, 1024, 256, device=dev) for _ in range(4)]
                news = [torch.empty(b, 256, device=dev) for _ in range(4)]

                def run(lora, x=x, w8=w8, s=s, cos=cos, sin=sin, pos=pos, bufs=bufs, news=news,
                        norm=norm):
                    return gv.int8_gemv_rope_kv(x, w8, s, cos, sin, pos, 8, bufs[0], bufs[1],
                                                news[0], news[1], norm=norm, lora=lora)[0]

                def plain(lora, x=x, w8=w8, s=s, cos=cos, sin=sin, pos=pos, bufs=bufs,
                          news=news, norm=norm):
                    return gv.int8_gemv_rope_kv_reference(x, w8, s, cos, sin, pos, 8, bufs[2],
                                                          bufs[3], news[2], news[3], norm=norm,
                                                          lora=lora)[0]
                counter = "int8_gemv_rope_kv_fp32"
            else:
                gkw = {"geglu": True} if name == "gu" else {"residual": f32(b, n)}

                def run(lora, x=x, w8=w8, s=s, gkw=gkw, norm=norm):
                    return gv.int8_gemv(x, w8, s, lora=lora, norm=norm, **gkw)

                def plain(lora, x=x, w8=w8, s=s, gkw=gkw, norm=norm):
                    return gv.int8_gemv_reference(x, w8, s, lora=lora, norm=norm, **gkw)
                counter = "int8_gemv_fp32"
            got = run((z, lb, bounds)).clone()
            want = plain((zp, lb, bounds))
            sync()
            report.case(counter, f"{name} B{b} + LoRA expand (F2)", got, want, FP32_REL, floor=0)
            again = (kl.lora_shrink(x, a, ids, LORA_RANK, gcols, norm=norm),
                     run((z, lb, bounds)).clone())
            no_bank = run(None).clone()
            base = ids == 0
            sync()
            same = (torch.equal(again[0], z) and torch.equal(again[1], got)
                    and not z[base].any() and torch.equal(got[base], no_bank[base]))
            print(f"  {counter:20s} {f'{name} B{b}: base rows == no bank; 2nd call':44s} "
                  f"bit for bit {same}  {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise AssertionError(f"fp32 LoRA {tag}: a base row moved, or a second call "
                                     "gave other bits")
            if b != 8:
                continue
            zb = z[:, :gcols].contiguous()
            t_s = report.time("lora_shrink_fp32", tag,
                              lambda x=x, a=a, ids=ids, norm=norm: kl.lora_shrink(
                                  x, a, ids, LORA_RANK, gcols, norm=norm),
                              lambda x=x, a=a, ids=ids, norm=norm: kl.lora_shrink_reference(
                                  x, a, ids, LORA_RANK, gcols, norm=norm),
                              flops=2 * b * k * a.shape[1],
                              n_bytes=nbytes(x, a, ids, z) + (4 * k if norm else 0),
                              library_fn=lambda x=x, a=a: x @ a, peak=PEAK_FP32_FLOPS)
            t_e = report.time(counter, f"{name} B8 + LoRA expand (F2; library z @ B)",
                              lambda z=z: run((z, lb, bounds)), lambda z=z: plain((z, lb, bounds)),
                              flops=2 * b * (k * n + gcols * n),
                              n_bytes=nbytes(x, w8, s, z, lb, got), library_fn=lambda: zb @ lb,
                              in_json=False, peak=PEAK_FP32_FLOPS)
            t_0 = report.time(counter, f"{name} B8 without the bank", lambda: run(None),
                              lambda: plain(None), flops=2 * b * k * n,
                              n_bytes=nbytes(x, w8, s, got), in_json=False, peak=PEAK_FP32_FLOPS)
            for key, t in (("shrink", t_s), ("gemv+expand", t_e), ("gemv", t_0)):
                acc = tot.setdefault(key, [0.0, 0.0, 0.0, 0.0])
                acc[0], acc[1], acc[3] = acc[0] + t[0], acc[1] + t[1], acc[3] + t[3]
                acc[2] = None if acc[2] is None or t[2] is None else acc[2] + t[2]
            device += [(f"{name} shrink", lambda x=x, a=a, ids=ids, norm=norm: kl.lora_shrink(
                x, a, ids, LORA_RANK, gcols, norm=norm)),
                (f"{name} x @ A (cuBLAS fp32)", lambda x=x, a=a: x @ a),
                (f"{name} GEMV + expand", lambda z=z, run=run, lb=lb, bounds=bounds: run(
                    (z, lb, bounds))),
                (f"{name} GEMV", lambda run=run: run(None)),
                (f"{name} z @ B (cuBLAS fp32)", lambda zb=zb, lb=lb: zb @ lb)]
        del w8, s, a, lb
    sk, sp, sl, sb = tot["shrink"]
    ek, ep, el, eb = tot["gemv+expand"]
    bk, _, _, bb = tot["gemv"]
    print(f"  fp32 lora: one layer B8, 4 groups, back to back: shrinks {sk:.4f} ms (plain "
          f"{sp:.4f}, cuBLAS fp32 x @ A {_ms(sl)}, bound {sb:.4f}); GEMVs with the expand "
          f"{ek:.4f} ms (plain {ep:.4f}, bound {eb:.4f}) against {bk:.4f} without (bound "
          f"{bb:.4f}); z @ B {_ms(el)}", flush=True)
    dt = device_times("fp32 B8 layer 5 bank", device)
    per = {}
    for label, ms in dt.items():
        what = label.split(" ", 1)[1]
        per[what] = None if ms is None or per.get(what, 0.0) is None else per.get(what, 0.0) + ms
    print("  fp32 lora: one layer B8, 4 groups, device: " + ", ".join(
        f"{w} {'not measured' if v is None else f'{v:.4f} ms'}" for w, v in per.items()),
        flush=True)


def fp32_partial_cases(report: KernelReport, dev, f32, int8_weight):
    """F3: the fp32 partial (mode 3) and K1 of fp32 x at o (K 2048) and down
    (K 16384) at B8, with and without the bank: rank 0 of m = 2 (the rank's
    K rows and A's rows) within FP32_REL of the plain versions, mode 3 ==
    the fp32 GEMV's mode 0 bit for bit, K1's base half == mode 3; at m = 1
    K1's [base | delta] added as decode_layer_tp.add_partial adds them ==
    the one-card fp32 residual GEMV with the expand, bit for bit. Timed at
    rank 0 of m = 2 (both rows in the JSON line) beside cuBLAS fp32 on the
    dequantized shard (mode 3; another function) and cuBLAS's two fp32
    products (K1: no single call computes it)."""
    from paligemma_tpu_torch.kernels import int8_gemv as gv
    from paligemma_tpu_torch.kernels import lora as kl

    gcols = (len(LORA_NAMES) + 1) * LORA_RANK
    b = 8
    ids = (torch.arange(b, device=dev) % (len(LORA_NAMES) + 1)).to(torch.int32)
    print(f"kernels: F3 int8_gemv_f32_fp32 (mode 3 at fp32) and int8_gemv_f32_lora_fp32 (K1 at "
          f"fp32), B{b}, bank G {gcols}", flush=True)
    for name, k_full in (("o", 2048), ("down", 16384)):
        w8, s = int8_weight(k_full, 2048)
        a = f32(k_full, gcols, scale=k_full**-0.5)
        lb = f32(gcols, 2048, scale=LORA_B_STD)
        x, h = f32(b, k_full, scale=0.5), f32(b, 2048)
        z1 = kl.lora_shrink(x, a, ids, LORA_RANK, gcols)
        one = gv.int8_gemv(x, w8, s, residual=h, lora=(z1, lb, ()))
        k1_one = gv.int8_gemv_f32(x, w8, s, lora=(z1, lb, ()))
        sync()
        same = torch.equal((h + k1_one[:, :2048]) + k1_one[:, 2048:], one)
        print(f"  {'int8_gemv_f32_lora_fp32':20s} {f'{name} m1 B{b} added == one card':44s} "
              f"bit for bit {same}  {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            raise AssertionError(f"fp32 K1 {name}: m = 1 is not the one-card fp32 epilogue")
        rows = slice(0, k_full // 2)
        xr, wr, ar = x[:, rows].contiguous(), w8[rows].contiguous(), a[rows].contiguous()
        zr = kl.lora_shrink(xr, ar, ids, LORA_RANK, gcols)
        label = f"{name} m2 r0 B{b} K{k_full // 2}->2048"
        part = gv.int8_gemv_f32(xr, wr, s)
        k1 = gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ()))
        mode0 = gv.int8_gemv(xr, wr, s)
        sync()
        report.case("int8_gemv_f32_fp32", label, part,
                    gv.int8_gemv_reference(xr, wr, s, out_fp32=True), FP32_REL, floor=0)
        report.case("int8_gemv_f32_lora_fp32", label, k1,
                    gv.int8_gemv_reference(xr, wr, s, out_fp32=True, lora=(zr, lb, ())),
                    FP32_REL, floor=0)
        same = (torch.equal(part, mode0) and torch.equal(k1[:, :2048], part)
                and torch.equal(gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ())), k1))
        print(f"  {'int8_gemv_f32_fp32':20s} {f'{label}: == mode 0; K1 base == it':44s} "
              f"bit for bit {same}  {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            raise AssertionError(f"fp32 partial {label}: not mode 0's bits, or K1's base half "
                                 "differs from it")
        wdq = wr.float() * s
        report.time("int8_gemv_f32_fp32", f"{label} (library: cuBLAS fp32 x_r @ dequantized "
                    "W_r, another function)", lambda: gv.int8_gemv_f32(xr, wr, s),
                    lambda: gv.int8_gemv_reference(xr, wr, s, out_fp32=True),
                    flops=2 * b * wr.numel(), n_bytes=nbytes(xr, wr, s, part),
                    library_fn=lambda: xr @ wdq, peak=PEAK_FP32_FLOPS)
        report.time("int8_gemv_f32_lora_fp32", f"{label} G{gcols}",
                    lambda: gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ())),
                    lambda: gv.int8_gemv_reference(xr, wr, s, out_fp32=True, lora=(zr, lb, ())),
                    flops=2 * b * (wr.numel() + lb.numel()),
                    n_bytes=nbytes(xr, wr, s, zr, lb, k1), peak=PEAK_FP32_FLOPS)
        xa, zb = cuda_ms(lambda: xr @ ar, 20), cuda_ms(lambda: zr @ lb, 20)
        print(f"  {'int8_gemv_f32_lora_fp32':20s} {label:44s} cuBLAS fp32 x_r @ A_r {xa:.4f} ms "
              f"+ z @ B {zb:.4f} ms = {xa + zb:.4f} ms (the delta alone, never called by the "
              "port)", flush=True)
        device_times(f"fp32 {label}", [
            ("int8_gemv_f32_lora_fp32", lambda: gv.int8_gemv_f32(xr, wr, s, lora=(zr, lb, ()))),
            ("int8_gemv_f32_fp32", lambda: gv.int8_gemv_f32(xr, wr, s)),
            ("x_r @ A_r (cuBLAS fp32)", lambda: xr @ ar), ("z @ B (cuBLAS fp32)", lambda: zr @ lb)])
        del w8, s, a, lb, wdq


def fp32_w8a8_cases(report: KernelReport, dev, f32, int8_weight):
    """F4: K1 reading fp32 rows (own amax, and a given one as a TP shard
    takes it) and K2 writing fp32, bit for bit with their plain versions, at
    layer 5's four projections and W8A8_ROWS rows (rows over four decades of
    scale, row 0 all zero); a second call's bits. Timed at both row counts
    (the M266 rows in the JSON line) beside ``torch._int_mm`` with the fp32
    epilogue of ``scale_sums`` for K2; device times of a layer's four."""
    from paligemma_tpu_torch.kernels import w8a8

    print("kernels: F4 w8a8_quant_rows_fp32 and w8a8_gemm_fp32 (bit for bit)", flush=True)
    sums = {}
    for m in W8A8_ROWS:
        for name, k, n in PROJECTIONS:
            w8, s = int8_weight(k, n)
            x = f32(m, k) * 10.0 ** (torch.rand(m, 1, device=dev) * 4 - 2)
            x[0] = 0
            label = f"{name} M{m} K{k} N{n}"
            x8, a_s = w8a8.w8a8_quant_rows(x)
            r8, rs = w8a8.quant_rows_reference(x)
            amax = x.abs().amax(-1) * 1.5
            g8, gs = w8a8.w8a8_quant_rows(x, amax)
            q8, qs = w8a8.quant_rows_reference(x, amax)
            got = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.float32)
            want = w8a8.gemm_reference(x8, w8, a_s, s, out_dtype=torch.float32)
            sync()
            report.case("w8a8_quant_rows_fp32", f"{label} codes", x8.float(), r8.float(), 0.0)
            report.case("w8a8_quant_rows_fp32", f"{label} scales", a_s, rs, 0.0)
            if not (torch.equal(g8, q8) and torch.equal(gs, qs)):
                raise AssertionError(f"w8a8_quant_rows_fp32 {label}: a given amax's codes differ")
            report.case("w8a8_gemm_fp32", f"{label} fp32 out", got, want, 0.0)
            again = w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.float32)
            if not (torch.equal(again, got) and (got[0] == 0).all()
                    and torch.equal(w8a8.w8a8_quant_rows(x)[0], x8)):
                raise AssertionError(f"w8a8 fp32 {label}: a second call's bits differ, or the "
                                     "zero row is not 0")
            w_nk = w8.t().contiguous()  # torch._int_mm's layout, outside the timed window
            in_json = m == W8A8_ROWS[0]

            def lib(x8=x8, w_nk=w_nk, a_s=a_s, s=s):
                return w8a8.scale_sums(torch._int_mm(x8, w_nk.t()), a_s, s, torch.float32)

            t2 = report.time("w8a8_gemm_fp32", label + " (library: _int_mm + fp32 epilogue)",
                             lambda: w8a8.w8a8_gemm(x8, w8, a_s, s, out_dtype=torch.float32),
                             lambda: w8a8.gemm_reference(x8, w8, a_s, s, torch.float32),
                             2.0 * m * k * n, nbytes(x8, w8, a_s, s, got), library_fn=lib,
                             iters=10, in_json=in_json, peak=PEAK_INT8_OPS)
            t1 = report.time("w8a8_quant_rows_fp32", label, lambda: w8a8.w8a8_quant_rows(x),
                             lambda: w8a8.quant_rows_reference(x), 3.0 * m * k,
                             nbytes(x, x8, a_s), iters=10, in_json=in_json,
                             peak=PEAK_FP32_FLOPS)
            dt = device_times(f"fp32 {label} (weights warm)", (
                ("w8a8_gemm_fp32", lambda: w8a8.w8a8_gemm(x8, w8, a_s, s,
                                                          out_dtype=torch.float32)),
                ("_int_mm + fp32 epilogue", lib),
                ("w8a8_quant_rows_fp32", lambda: w8a8.w8a8_quant_rows(x))))
            acc_row = sums.setdefault(m, {})
            for key, v in list(dt.items()) + [("K2 bound", t2[3]), ("K1 bound", t1[3])]:
                acc_row[key] = None if v is None or acc_row.get(key, 0.0) is None else (
                    acc_row.get(key, 0.0) + v)
            del w8, s, w_nk
    for m, row in sums.items():
        print(f"w8a8 fp32: one layer's four projections at M{m}, device ms: " + ", ".join(
            f"{k} {'not measured' if v is None else f'{v:.4f}'}" for k, v in row.items()),
            flush=True)


def fp32_phase(cfg, dev, card, d):
    """``--dtype float32`` on the card at full width and depth, from the cli
    phase's checkpoint ``d`` loaded at fp32:

    (a) PaliGemmaEngine on its fp32 int8 tree with the kernel defaults
        against one with ``fused_layer=False, use_flash=False`` (torch ops):
        prefill logits within FP32_LOGIT_TOL of max |logit|, and along the
        kernel engine's FP32_NEW greedy tokens, teacher-forced, each step's
        logits too, the torch-ops engine's greedy token the emitted one but
        at a near tie; generate_spec gives greedy's tokens bit for bit; the
        b1 decode step's device time (profiled), its rate and the TTFT;
    (b) cli.infer --dtype float32 with --quantize_int8 (the engine's
        tokens), with --speculative (the same) and without --quantize_int8
        (the plain decode's, flash prefill);
    (c) cli.serve --dtype float32 --quantize_int8 in batch mode, dense and
        paged, on the serve_cli phase's requests, a third sampled, one under
        a grammar, one repeated, with --prefix_cache: the free greedy rows'
        tokens equal an fp32 ServingEngine's, and dense equals paged;
    (d) the 896 px tower at fp32 from seeded weights, attn="flash" (27 B1
        fp32 launches) against attn="xla";
    (e) cli.serve --dtype float32 --quantize_int8 --lora (the multilora
        phase's [base, a, b, c] bank, fp32) dense and paged on (c)'s 12
        requests: tokens equal an fp32 ServingEngine's with the bank (its
        kernel tick), dense equals paged; that engine against the torch-ops
        tick with the bank: a differing row a near tie (FP32_LOGIT_TOL),
        an adapter row's teacher-forced logits within FP32_LOGIT_TOL;
    (f) cli.infer and cli.serve --dtype float32 --quantize_int8
        --int8_prefill (K1 / K2's fp32 forms): the single-copy fp32
        engines' tokens; the single-copy engine's prefill logits within
        W8A8_LOGIT_TOL of the two-copy fp32 engine's (W8A8 quantizes the
        activations: an int8 code a row, not an fp32 rounding);
    (g) the TP engines at world size 1 over NCCL on the fp32 trees: generate
        and the bank's 12 requests give one card's fp32 tokens bit for bit
        (the fp32 partial and K1 summed by the all-reduce);
    (h) the Trainer on the fp32 tree (:func:`fp32_train`): B1 and B6's fp32
        forms against plain attention on the first step, the loss falling,
        exactly 36 / 18 / 18 fp32 flash launches a step;
    (i) the fp32 tree over a bf16 KV cache (:func:`fp32_mixed_cache`; the
        mixed forms), and in (g) its TP generate: one card's tokens.

    (d) also encodes the tower with attn="fused" (27 B12 fp32 launches)
    against attn="xla".

    Every launch of a run is an fp32 form's (``_as_bf16_names``), counted
    as the bf16 phases count theirs. Returns the counts summed over the
    counted runs and the fp32 engine's caption ids of the CLI's image and
    prompt (cli_tp_phase's one-card reference at fp32)."""
    import gc

    from paligemma_tpu_torch import kernels, paligemma_3b_896
    from paligemma_tpu_torch.checkpoints.hf_loader import load_hf_model
    from paligemma_tpu_torch.cli import infer, serve
    from paligemma_tpu_torch.convert import init_vision_params
    from paligemma_tpu_torch.models import siglip
    from paligemma_tpu_torch.processing.processor import PaliGemmaProcessor
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.quantize import quantize_lm_for_serving
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    import contextlib

    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # (a) the engines
    sync()
    t0 = time.perf_counter()
    p32, c32 = load_hf_model(d, torch.float32, device=dev)
    sync()
    load_s = time.perf_counter() - t0
    if c32 != cfg or p32["lm"]["embed"].dtype != torch.float32:
        raise AssertionError("fp32: the checkpoint did not load as the fp32 3B-224 tree")
    dq32 = quantize_lm_for_serving(p32)
    eng = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32)
    if not (eng.use_flash and eng.fused_layer and eng._greedy_head_fused
            and eng.cache_dtype == torch.float32):
        raise AssertionError("fp32: the kernel engine did not select the kernel paths")
    ops = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32, fused_layer=False,
                          use_flash=False)
    print(f"fp32: the cli checkpoint loaded at fp32 in {load_s:.2f} s, its int8 tree made; "
          f"kernel engine (fp32 cache) and torch-ops engine  [{card}]", flush=True)
    pixels, ids, mask = make_inputs(cfg, dev)
    kernels.reset_launch_counts()
    tok = eng.generate(pixels, ids, mask, max_new_tokens=FP32_NEW, eos_token_id=-1, sync_every=8)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    _cli_launches("fp32 generate", _as_bf16_names("fp32 generate", counts), n_layers, True)
    tok_ops = ops.generate(pixels, ids, mask, max_new_tokens=FP32_NEW, eos_token_id=-1,
                           sync_every=8)
    lk, sk = eng.prefill(pixels, ids, mask)
    lp, sp = ops.prefill(pixels, ids, mask)
    worst, ties = _compare(lk, lp, "fp32 prefill", tok[0, 0], tol=FP32_LOGIT_TOL)
    ties = [0] if ties else []
    for t in range(FP32_NEW - 1):
        step = torch.from_numpy(tok[:, t])
        lk, sk = eng.decode_step(step, sk)
        lp, sp = ops.decode_step(step, sp)
        w, f = _compare(lk, lp, f"fp32 decode {t}", tok[0, t + 1], tol=FP32_LOGIT_TOL)
        worst = max(worst, w)
        if f:
            ties.append(t + 1)
    sync()
    differ = [t for t in range(FP32_NEW) if tok_ops[0, t] != tok[0, t]]
    print(f"fp32: kernel vs torch-ops engine: teacher-forced logits max rel err {worst:.3e} of "
          f"max |logit| (tol {FP32_LOGIT_TOL}) over the prefill + {FP32_NEW - 1} steps; "
          f"{FP32_NEW - len(differ)}/{FP32_NEW} greedy tokens identical"
          f"{f', first divergence at {differ[0]}' if differ else ''}; near-tie steps {ties}; "
          f"tokens {tok[0, :12].tolist()} ...", flush=True)
    if differ and differ[0] not in ties:
        raise AssertionError(f"fp32: the torch-ops engine's tokens diverge at {differ[0]}, "
                             "which is no near tie")
    del lk, sk, lp, sp
    kernels.reset_launch_counts()
    with _NoPlainInt8():
        spec = eng.generate_spec(pixels, ids, mask, max_new_tokens=FP32_NEW, eos_token_id=-1,
                                 draft_k=SPEC_DRAFT_K, sync_every=SPEC_SYNC)
    sync()
    counts = kernels.launch_counts()
    add(counts)
    verifies = _spec_verifies(eng.spec_cycles, SPEC_SYNC)
    _spec_counts("fp32 generate_spec", _as_bf16_names("fp32 generate_spec", counts), verifies,
                 n_layers, prefills=1)
    if not np.array_equal(spec, tok):
        raise AssertionError(f"fp32: generate_spec {spec.tolist()} != generate {tok.tolist()}")
    print(f"fp32: generate_spec gives generate's {FP32_NEW} tokens bit for bit in "
          f"{eng.spec_cycles} cycles ({verifies} verify calls on the fp32 decode chain)",
          flush=True)
    decode_rate("fp32: kernels  ", eng, pixels, ids, mask, card)
    decode_rate("fp32: torch ops", ops, pixels, ids, mask, card)
    profile_phase(eng, pixels, ids, mask, card, buckets=(512,), prefix="fp32 ", host_top=0,
                  layers=n_layers)
    # (i) a bf16 KV cache beside the fp32 tree
    counts, tok16 = fp32_mixed_cache(p32, dq32, cfg, dev, card, eng, (pixels, ids, mask))
    add(counts)

    # the references of (b) and (c), before the engines are freed
    stand = _StandIns(cfg.image_token_index, cfg.vocab_size,
                      sorted({w for p in SERVE_CLI_PROMPTS for w in p.split()}))
    img = os.path.join(d, "img0.npy")
    rows = _serve_cli_rows(d)
    with stand:
        tk = _WordTokenizer(cfg.image_token_index, cfg.vocab_size,
                            sorted({w for p in SERVE_CLI_PROMPTS for w in p.split()}))
        proc = PaliGemmaProcessor(tk, cfg.vision_config.num_image_tokens,
                                  cfg.vision_config.image_size)
        inputs = proc(images=[_StubImage(np.load(img))], text=[CLI_PROMPTS[0]])
        eos = _WordTokenizer.eos_token_id
        want_q = PaliGemmaEngine(p32, cfg, max_seq_len=1024, eos_token_id=eos,
                                 decode_params=dq32).generate(
            inputs["pixel_values"], inputs["input_ids"], inputs["attention_mask"],
            max_new_tokens=CLI_NEW, sync_every=infer.SYNC_EVERY)
        want_p = PaliGemmaEngine(p32, cfg, max_seq_len=1024, eos_token_id=eos,
                                 fused_layer=False).generate(
            inputs["pixel_values"], inputs["input_ids"], inputs["attention_mask"],
            max_new_tokens=CLI_NEW, sync_every=infer.SYNC_EVERY)
        to_req = serve._Server(None, proc, tk, 100)._to_request
        ref_eng = ServingEngine(p32, cfg, decode_params=dq32, **SERVE)
        reqs = [to_req(r) for r in rows]
        for r in reqs:
            ref_eng.submit(r)
        ref_eng.run_to_completion()
        ref = {r.request_id: list(r.tokens) for r in reqs}
        del ref_eng

        # (e)'s references: the bank through the fp32 kernel tick and the
        # torch-ops tick
        adapters = lora_bank_adapters(cfg, dev, LORA_B_STD)
        names = [None, *LORA_NAMES]
        lrows = [dict(r, **({"lora": names[i % 4]} if names[i % 4] else {}))
                 for i, r in enumerate(rows)]
        bank_k = ServingEngine(p32, cfg, decode_params=dq32, lora_bank=adapters, **SERVE)
        bank_p = ServingEngine(p32, cfg, decode_params=dq32, lora_bank=adapters,
                               fused_decode=False, **SERVE)
        lreqs = {}
        for label, e in (("kernel", bank_k), ("ops", bank_p)):
            lreqs[label] = [to_req(r) for r in lrows]
            for r in lreqs[label]:
                e.submit(r)
            e.run_to_completion()
        ref_bank = {r.request_id: list(r.tokens) for r in lreqs["kernel"]}
        ops_bank = {r.request_id: list(r.tokens) for r in lreqs["ops"]}
        from paligemma_tpu_torch.models import gemma, paligemma
        adapter_req = lreqs["kernel"][1]  # adapter "a"
        worst = _teacher_force_lora(p32, bank_k, bank_p, cfg, dev, adapter_req,
                                    ref_bank[1], gemma, paligemma)
        ties = _near_ties("fp32 bank", bank_k, cfg, lreqs["kernel"], ops_bank, ref_bank,
                          bank=True, tol=FP32_LOGIT_TOL)
        print(f"fp32 bank: the kernel tick (lora_shrink_fp32, the fp32 expand) against the "
              f"torch-ops tick, 12 requests [base, a, b, c]: {ties} (torch-ops tokens on the "
              f"kernel engine); request 1 (adapter a) teacher-forced logits max rel err "
              f"{worst:.3e} of max |logit| (tol {FP32_LOGIT_TOL})", flush=True)
        if worst > FP32_LOGIT_TOL:
            raise AssertionError(f"fp32 bank: kernel vs torch-ops logits {worst} > "
                                 f"{FP32_LOGIT_TOL}")
        del bank_p

        # (f)'s references: the single-copy fp32 engines (W8A8 prefill)
        single = PaliGemmaEngine(dq32, cfg, max_seq_len=1024, eos_token_id=eos,
                                 decode_params=dq32, int8_act_prefill=True)
        want_8 = single.generate(inputs["pixel_values"], inputs["input_ids"],
                                 inputs["attention_mask"], max_new_tokens=CLI_NEW,
                                 sync_every=infer.SYNC_EVERY)
        two = PaliGemmaEngine(p32, cfg, max_seq_len=1024, eos_token_id=eos, decode_params=dq32)
        args8 = (inputs["pixel_values"], inputs["input_ids"], inputs["attention_mask"])
        l8, _ = single.prefill(*args8)
        l2, _ = two.prefill(*args8)
        w8, _ = _compare(l8, l2, "fp32 W8A8 prefill", want_8[0, 0], W8A8_LOGIT_TOL)
        print(f"fp32 w8a8: the single-copy fp32 engine's prefill logits (K1 / K2 fp32 forms) "
              f"against the two-copy fp32 engine's: max rel err {w8:.3e} of max |logit| (tol "
              f"{W8A8_LOGIT_TOL}: W8A8 quantizes each activation row to int8); "
              f"{int((want_8 == want_q).sum())}/{want_q.size} caption ids equal", flush=True)
        del single, two, l8, l2
        ref8_eng = ServingEngine(dq32, cfg, decode_params=dq32, int8_act_prefill=True, **SERVE)
        r8 = [to_req(r) for r in rows]
        for r in r8:
            ref8_eng.submit(r)
        ref8_eng.run_to_completion()
        ref8 = {r.request_id: list(r.tokens) for r in r8}
        del ref8_eng

        # (g) the TP engines at world size 1 over NCCL
        add(fp32_tp_one_rank(p32, dq32, cfg, dev, tok, adapters, lrows, to_req, ref_bank,
                             (pixels, ids, mask), tok16))
    del eng, ops, bank_k, dq32
    gc.collect()
    torch.cuda.empty_cache()
    # (h) the Trainer at fp32 on the same tree
    add(fp32_train(p32, cfg, dev, card))
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    # (b) cli.infer --dtype float32
    argv = ["--model_path", d, "--image_file_path", img, "--prompt", CLI_PROMPTS[0],
            "--max_tokens_to_generate", str(CLI_NEW), "--dtype", "float32"]
    with stand:
        for label, extra, want in (("--quantize_int8", ["--quantize_int8"], want_q),
                                   ("--quantize_int8 --speculative",
                                    ["--quantize_int8", "--speculative", "--draft_k",
                                     str(SPEC_DRAFT_K)], want_q),
                                   ("plain decode", [], want_p)):
            with _NoPlainInt8() if extra else contextlib.nullcontext():
                text, t, counts, wall, got, _ = _cli_call(infer, argv + extra, stand)
            add(counts)
            named = _as_bf16_names(f"fp32 cli {label}", counts)
            if "--speculative" in extra:
                _spec_counts("fp32 cli --speculative", named,
                             _spec_verifies(t["spec_cycles"], infer.SYNC_EVERY), n_layers,
                             prefills=1)
            elif extra:
                _cli_launches(f"fp32 {label}", named, n_layers, True)
            else:  # the prefill's flash forwards; the plain decode launches nothing
                _only_launches(f"fp32 cli {label}", counts,
                               {"flash_attention_fwd_fp32": n_layers})
            if not np.array_equal(np.asarray(got), want):
                raise AssertionError(f"fp32 cli {label}: ids {got} != the fp32 engine's "
                                     f"{want.tolist()}")
            print(f"fp32 cli {label}: {np.asarray(got).shape[1]} ids equal the fp32 engine's "
                  f"({'int8 tree, kernel decode' if extra else 'fp32 tree, plain decode'})",
                  flush=True)
            _timing_line(f"fp32 {label}", t, wall, card)

    # (c) cli.serve --dtype float32, dense and paged
    crows = []
    for i, r in enumerate(rows):
        crows.append(dict(r, **({"do_sample": True} if i % 3 == 1 else {}),
                          **({"grammar": "digits"} if i == 0 else {})))
    repeat = dict(rows[N_REQ - 1], request_id=N_REQ)  # a prefix-cache candidate
    crows.append(repeat)
    path = os.path.join(d, "fp32_reqs.jsonl")
    with open(path, "w") as fh:
        fh.write("".join(json.dumps(r) + "\n" for r in crows))
    digits = SERVE_CLI_GRAMMARS["digits"]
    from paligemma_tpu_torch.processing import grammar as gr
    dfa = gr.compile_regex(digits)
    served = {}
    with stand:
        for engine in ("dense", "paged"):
            argv = ["--model_path", d, "--requests_jsonl", path, *SERVE_CLI_FLAGS, "--dtype",
                    "float32", "--engine", engine, "--prefix_cache", "--grammar",
                    f"digits={digits}"]
            run = _serve_cli_call(serve, argv, stand, f"fp32 {engine}")
            add(run["counts"])
            e = run["srv"].engine
            if not (e.fused_decode and e.use_flash and e.cache_dtype == torch.float32):
                raise AssertionError(f"fp32 serve {engine}: the engine is not on the fp32 "
                                     "kernel path")
            _serve_cli_launches(f"fp32 {engine}", _as_bf16_names(f"fp32 serve {engine}",
                                                                 run["counts"]),
                                run["ticks"], e, n_layers, head_ticks=run["head_ticks"])
            toks = run["tokens"]
            free = [r["request_id"] for r in crows[:N_REQ]
                    if not r.get("do_sample") and "grammar" not in r]
            bad = [i for i in free if toks[i] != ref[i]]
            if bad or toks[N_REQ] != toks[N_REQ - 1]:
                raise AssertionError(f"fp32 serve {engine}: greedy requests {bad} differ from "
                                     "the fp32 ServingEngine's, or the repeat from its original")
            text0 = {ln["request_id"]: ln["text"] for ln in run["lines"]}[0]
            if not dfa.matches(text0):
                raise AssertionError(f"fp32 serve {engine}: the grammar row's text {text0!r}")
            _serve_cli_line(f"fp32 batch {engine}", run["lines"], run["wall"], run["counts"], e,
                            run["ticks"], card)
            served[engine] = toks
            run.pop("srv", None)
            gc.collect()
            torch.cuda.empty_cache()
    if served["dense"] != served["paged"]:
        differ = [i for i in served["dense"] if served["dense"][i] != served["paged"][i]]
        raise AssertionError(f"fp32 serve: dense and paged differ on requests {differ}")
    print(f"fp32 serve: dense == paged on all {len(crows)} requests ({len(free)} free greedy "
          f"rows equal the fp32 ServingEngine's, {sum('do_sample' in r for r in crows)} sampled, "
          "1 under a grammar, the repeat equal to its original)", flush=True)

    # (e) cli.serve --dtype float32 --lora, dense and paged
    from paligemma_tpu_torch.checkpoints.local import save_pytree
    lflags = []
    for name, ad in adapters.items():
        ldir = os.path.join(d, f"lora32_{name}")
        save_pytree(ldir, {"lora": ad})
        lflags += ["--lora", f"{name}={ldir}"]
    del adapters
    lpath = os.path.join(d, "fp32_lora_reqs.jsonl")
    with open(lpath, "w") as fh:
        fh.write("".join(json.dumps(r) + "\n" for r in lrows))
    served = {}
    with stand:
        for engine in ("dense", "paged"):
            argv = ["--model_path", d, "--requests_jsonl", lpath, *SERVE_CLI_FLAGS, "--dtype",
                    "float32", "--engine", engine, *lflags]
            run = _serve_cli_call(serve, argv, stand, f"fp32 {engine} --lora")
            add(run["counts"])
            e = run["srv"].engine
            if not (e.fused_decode and e._lora_fused_pack is not None
                    and e.cache_dtype == torch.float32):
                raise AssertionError(f"fp32 serve {engine} --lora: the bank is not on the fp32 "
                                     "kernel tick")
            _serve_cli_launches(f"fp32 {engine} --lora", _as_bf16_names(
                f"fp32 serve {engine} --lora", run["counts"]), run["ticks"], e, n_layers,
                lora=True)
            differ = [i for i in ref_bank if run["tokens"].get(i) != ref_bank[i]]
            if differ:
                raise AssertionError(f"fp32 serve {engine} --lora: requests {differ} differ from "
                                     "the fp32 ServingEngine's with the bank")
            _serve_cli_line(f"fp32 batch {engine} --lora", run["lines"], run["wall"],
                            run["counts"], e, run["ticks"], card)
            served[engine] = run["tokens"]
            run.pop("srv", None)
            gc.collect()
            torch.cuda.empty_cache()
    moved = sum(ref_bank[i] != ref[i] for i in ref if names[i % 4])
    print(f"fp32 serve --lora: dense == paged == the fp32 ServingEngine with the bank on all 12 "
          f"requests; {moved}/9 adapter rows differ from the base model's tokens", flush=True)

    # (f) --int8_prefill at fp32: cli.infer, then cli.serve dense
    argv = ["--model_path", d, "--image_file_path", img, "--prompt", CLI_PROMPTS[0],
            "--max_tokens_to_generate", str(CLI_NEW), "--dtype", "float32", "--quantize_int8",
            "--int8_prefill"]
    with stand, _NoPlainInt8():
        text, t, counts, wall, got, _ = _cli_call(infer, argv, stand)
    add(counts)
    named = _as_bf16_names("fp32 cli --int8_prefill", counts)
    _cli_launches("fp32 --int8_prefill", named, n_layers, True)
    if {named["w8a8_quant_rows"], named["w8a8_gemm"]} != {4 * n_layers}:
        raise AssertionError(f"fp32 cli --int8_prefill: {named['w8a8_quant_rows']} K1 and "
                             f"{named['w8a8_gemm']} K2 fp32 launches, want {4 * n_layers}")
    if not np.array_equal(np.asarray(got), want_8):
        raise AssertionError(f"fp32 cli --int8_prefill: ids {got} != the single-copy fp32 "
                             f"engine's {want_8.tolist()}")
    print(f"fp32 cli --int8_prefill: {want_8.shape[1]} ids equal the single-copy fp32 engine's",
          flush=True)
    _timing_line("fp32 --int8_prefill", t, wall, card)
    path8 = os.path.join(d, "fp32_8_reqs.jsonl")
    with open(path8, "w") as fh:
        fh.write("".join(json.dumps(r) + "\n" for r in rows))
    with stand:
        argv = ["--model_path", d, "--requests_jsonl", path8, *SERVE_CLI_FLAGS, "--dtype",
                "float32", "--int8_prefill"]
        with _NoPlainInt8():
            run = _serve_cli_call(serve, argv, stand, "fp32 dense --int8_prefill")
        add(run["counts"])
        e = run["srv"].engine
        if not (e.int8_act_prefill and e.cache_dtype == torch.float32):
            raise AssertionError("fp32 serve --int8_prefill: not the fp32 single-copy engine")
        _serve_cli_launches("fp32 dense --int8_prefill", _as_bf16_names(
            "fp32 serve --int8_prefill", run["counts"]), run["ticks"], e, n_layers)
        differ = [i for i in ref8 if run["tokens"].get(i) != ref8[i]]
        if differ:
            raise AssertionError(f"fp32 serve --int8_prefill: requests {differ} differ from the "
                                 "single-copy fp32 ServingEngine's")
        _serve_cli_line("fp32 batch dense --int8_prefill", run["lines"], run["wall"],
                        run["counts"], e, run["ticks"], card)
        print(f"fp32 serve --int8_prefill: 12/12 requests with the single-copy fp32 "
              f"ServingEngine's tokens; {sum(ref8[i] == ref[i] for i in ref)}/12 with the "
              "two-copy fp32 engine's", flush=True)
        run.pop("srv", None)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the 896 px tower at fp32: flash (B1 fp32) against 'xla'
    vcfg = paligemma_3b_896().vision_config
    vp = init_vision_params(vcfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                            torch.float32)
    px = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (1, 3, vcfg.image_size, vcfg.image_size), dtype=np.float32)).to(dev)
    feats = {}
    for attn, form in (("flash", "flash_attention_fwd_fp32"), ("fused", "vision_attention_fp32")):
        kernels.reset_launch_counts()
        feats[attn] = siglip.encode(vp, vcfg, px, attn=attn)
        sync()
        counts = kernels.launch_counts()
        add(counts)
        _only_launches(f"fp32 tower {attn}", counts, {form: vcfg.num_hidden_layers})
    plain = siglip.encode(vp, vcfg, px, attn="xla")
    sync()
    rel = {a: float((f - plain).abs().max() / plain.abs().max()) for a, f in feats.items()}
    ms = {a: cuda_ms(lambda a=a: siglip.encode(vp, vcfg, px, attn=a), 2)
          for a in ("flash", "fused", "xla")}
    print(f"fp32 tower 896px: features max rel err of max |feature| against attn='xla': "
          f"'flash' ({vcfg.num_hidden_layers} fp32 B1 launches) {rel['flash']:.3e}, 'fused' "
          f"({vcfg.num_hidden_layers} fp32 B12 launches) {rel['fused']:.3e} (tol "
          f"{FP32_LOGIT_TOL}); encode {ms['flash']:.2f} ms (flash), {ms['fused']:.2f} ms "
          f"(fused), {ms['xla']:.2f} ms (xla)  [{card}]", flush=True)
    for attn, f in feats.items():
        if not (torch.isfinite(f).all() and rel[attn] <= FP32_LOGIT_TOL):
            raise AssertionError(f"fp32 tower: {attn} vs xla features off by {rel[attn]}")
    return total, [int(t) for t in want_q[0]]


def fp32_train(p32, cfg, dev, card):
    """fp32_phase's (h): the Trainer on the phase's fp32 tree at full width
    and depth (LoRA r8, alpha 8, remat; train_batch: B2 S512, prefix 268,
    row 1 padded to 400 tokens): (a) the first step's loss and LoRA-b
    gradients, the kernels (B1 and B6's fp32 forms) against plain attention
    from the same adapters, within FP32_TRAIN_LOSS_REL_TOL and
    FP32_TRAIN_GRAD_REL_TOL of its largest element; (b) the loss falls over
    FP32_TRAIN_STEPS steps at lr 1e-3; (e) every step launches exactly
    TRAIN_PER_STEP under the fp32 forms' names (36 forwards, 18 dq, 18 dk/dv)
    and no bf16 kernel; the step ms and the peak allocated memory. Returns
    the counted steps' launches."""
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.train.trainer import TrainConfig, Trainer

    batch = train_batch(cfg)
    tc = TrainConfig(lora_rank=8, lora_alpha=8.0, learning_rate=1e-3, remat=True)
    kern = Trainer(p32, cfg, tc, generator=torch.Generator(dev).manual_seed(SEED))
    plain = Trainer(p32, cfg, dataclasses.replace(tc, use_flash=False),
                    generator=torch.Generator(dev).manual_seed(SEED))
    if not kern.use_flash or plain.use_flash:
        raise AssertionError("fp32 train: the trainer did not select the flash kernels on CUDA")
    loss_k, grads_k = kern.loss_and_grads(batch)
    loss_p, grads_p = plain.loss_and_grads(batch)
    sync()
    del plain
    names = [(t, key) for t, leaf in kern.lora["layers"].items() for key in leaf]
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    worst, worst_at = 0.0, None
    for (target, key), gk, gp in zip(names, grads_k, grads_p):
        if key != "b":
            continue
        if not torch.isfinite(gk).all():
            raise AssertionError(f"fp32 train (a): non-finite gradient of {target}.b")
        rel = float((gk - gp).abs().max()) / float(gp.abs().max())
        if rel > worst:
            worst, worst_at = rel, target
    print(f"fp32 train (a): first step, fp32 flash kernels vs plain attention: loss "
          f"{float(loss_k):.7f} vs {float(loss_p):.7f} (rel {loss_rel:.3e}, tol "
          f"{FP32_TRAIN_LOSS_REL_TOL}); LoRA-b gradients max rel err {worst:.3e} ({worst_at}.b; "
          f"tol {FP32_TRAIN_GRAD_REL_TOL})  [{card}]", flush=True)
    if loss_rel > FP32_TRAIN_LOSS_REL_TOL or worst > FP32_TRAIN_GRAD_REL_TOL:
        raise AssertionError("fp32 train (a): kernel and plain first steps disagree")
    del grads_k, grads_p

    losses, times, total = [], [], {}
    torch.cuda.reset_peak_memory_stats()
    for step in range(FP32_TRAIN_STEPS):
        kernels.reset_launch_counts()
        loss, ms = _timed_step(kern, batch)
        counts = kernels.launch_counts()
        named = _as_bf16_names(f"fp32 train step {step}", counts)
        want = {k: TRAIN_PER_STEP.get(k, 0) for k in named}
        if named != want or not np.isfinite(loss):
            raise AssertionError(f"fp32 train step {step}: launches {counts} (loss {loss}), want "
                                 f"{want} under the fp32 forms' names")
        losses.append(loss)
        times.append(ms)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = {FP32_OF[k]: v for k, v in TRAIN_PER_STEP.items()}
    print(f"fp32 train (b): LoRA r8 lr 1e-3, {FP32_TRAIN_STEPS} steps on one batch: loss "
          f"{' '.join(f'{x:.6f}' for x in losses)}; (e) every step launched exactly "
          f"{json.dumps(per_step)} and no other kernel  [{card}]", flush=True)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"fp32 train (b): the loss did not fall ({losses[0]} -> "
                             f"{losses[-1]})")
    ms = float(np.median(times[1:]))
    n_tok = TRAIN_B * TRAIN_S
    print(f"fp32 train: step B{TRAIN_B} S{TRAIN_S} LoRA r8 remat fp32: {ms:.1f} ms (median of "
          f"{len(times) - 1}; steps {', '.join(f'{t:.1f}' for t in times)} ms), "
          f"{n_tok / ms * 1e3:.0f} tok/s over all positions, peak allocated {peak:.2f} GiB (the "
          f"fp32 tree included)  [{card}]", flush=True)
    return total


def fp32_tp_one_rank(p32, dq32, cfg, dev, tok, adapters, lrows, to_req, ref_bank, inputs,
                     tok16):
    """fp32_phase's (g): an NCCL group of world size 1, then the TP engines
    on the fp32 trees: generate (FP32_NEW greedy tokens: the TP chain with
    the fp32 partial, int8_gemv_f32_fp32) against the one-card fp32 engine's
    ``tok``, the same over a bf16 cache (the mixed forms in the TP chain)
    against the one-card bf16-cache engine's ``tok16``, and a dense
    ServingEngine with the bank on ``lrows`` (K1's fp32 form,
    lora_shrink_fp32) against ``ref_bank``: bit for bit. Returns the summed
    launch counts."""
    import torch.distributed as dist

    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.core.mesh import make_mesh
    from paligemma_tpu_torch.runtime.engine import PaliGemmaEngine
    from paligemma_tpu_torch.runtime.serving import ServingEngine

    n_layers = cfg.text_config.num_hidden_layers
    total: dict = {}
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        eng = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32, mesh=mesh)
        kernels.reset_launch_counts()
        got = eng.generate(*inputs, max_new_tokens=FP32_NEW, eos_token_id=-1, sync_every=8)
        sync()
        counts = _as_bf16_names("fp32 tp generate", kernels.launch_counts())
        for k, v in kernels.launch_counts().items():
            total[k] = total.get(k, 0) + v
        steps = counts["head_argmax"]
        want = {"attn_decode_tp": n_layers * steps, "mlp_decode_fused": n_layers * steps,
                "int8_gemv_f32": 2 * n_layers * steps}
        bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
        same = np.array_equal(got, tok)
        print(f"fp32 tp: TP generate m=1 over NCCL vs the one-card fp32 engine: {FP32_NEW} tokens "
              f"bit for bit {same}; {counts['int8_gemv_f32']} int8_gemv_f32_fp32 over {steps} "
              "steps", flush=True)
        if not same or bad or not steps:
            raise AssertionError(f"fp32 tp generate: tokens differ from one card ({same}) or "
                                 f"launches off {bad}")
        del eng
        eng = PaliGemmaEngine(p32, cfg, max_seq_len=MAX_SEQ, decode_params=dq32, mesh=mesh,
                              cache_dtype=torch.bfloat16)
        kernels.reset_launch_counts()
        got = eng.generate(*inputs, max_new_tokens=FP32_NEW, eos_token_id=-1, sync_every=8)
        sync()
        raw = kernels.launch_counts()
        for k, v in raw.items():
            total[k] = total.get(k, 0) + v
        counts = _as_uniform_names("fp32 tp bf16-cache generate", raw, torch.float32)
        steps = counts["head_argmax"]
        want = {"attn_decode_tp": n_layers * steps, "int8_gemv_rope_kv": n_layers * steps,
                "decode_attention": n_layers * steps, "int8_gemv_f32": 2 * n_layers * steps}
        bad = {k: (counts[k], v) for k, v in want.items() if counts[k] != v}
        same = np.array_equal(got, tok16)
        print(f"fp32 tp: TP generate m=1 over NCCL with a bf16 cache vs the one-card bf16-cache "
              f"engine: {FP32_NEW} tokens bit for bit {same}; "
              f"{raw['int8_gemv_rope_kv_fp32_cache_bf16']} int8_gemv_rope_kv_fp32_cache_bf16, "
              f"{raw['decode_attention_fp32_cache_bf16']} decode_attention_fp32_cache_bf16 over "
              f"{steps} steps", flush=True)
        if not same or bad or not steps:
            raise AssertionError(f"fp32 tp bf16-cache generate: tokens differ from one card "
                                 f"({same}) or launches off {bad}")
        del eng
        served = ServingEngine(p32, cfg, decode_params=dq32, mesh=mesh, lora_bank=adapters,
                               **SERVE)
        if not served.fused_decode or served._lora_fused_pack is None:
            raise AssertionError("fp32 tp bank: the TP engine did not take the bank's chain")
        reqs = [to_req(r) for r in lrows]
        kernels.reset_launch_counts()
        for r in reqs:
            served.submit(r)
        served.run_to_completion()
        sync()
        raw = kernels.launch_counts()
        counts = _as_bf16_names("fp32 tp bank", raw)
        for k, v in raw.items():
            total[k] = total.get(k, 0) + v
        toks = {r.request_id: list(r.tokens) for r in reqs}
        differ = [i for i in ref_bank if toks[i] != ref_bank[i]]
        print(f"fp32 tp: dense TP m=1 with the bank: {len(reqs) - len(differ)}/{len(reqs)} "
              f"requests with the one-card fp32 engine's tokens, bit for bit; "
              f"{counts['int8_gemv_f32_lora']} K1 fp32, {counts['lora_shrink']} shrinks fp32",
              flush=True)
        if differ or not (counts["int8_gemv_f32_lora"] and counts["lora_shrink"]):
            raise AssertionError(f"fp32 tp bank: requests {differ} differ from one card, or "
                                 "K1 / the shrink never launched")
        del served
    finally:
        dist.destroy_process_group()
    return total


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    from paligemma_tpu_torch import kernels
    from paligemma_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"build: {lib_path.parent.name} built/loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas_lines(lib_path.parent / "ptxas.log", ("int8_gemv_kernel", "head_argmax_kernel",
                                                 "int4_gemv_kernel", "lora_shrink_kernel",
                                                 "w8a8"))

    report = KernelReport()
    t0 = time.perf_counter()
    kernel_phase(report, dev)
    tp_kernel_phase(report, dev)
    t1 = time.perf_counter()
    fp32_kernel_counts = fp32_kernel_phase(report, dev)
    print(f"kernels: fp32 forms done in {time.perf_counter() - t1:.1f} s", flush=True)
    t1 = time.perf_counter()
    mixed_kernel_cases(report, dev)
    print(f"kernels: mixed forms done in {time.perf_counter() - t1:.1f} s", flush=True)
    sync()
    torch.cuda.empty_cache()
    print(f"kernels: all cases within tolerance ({time.perf_counter() - t0:.1f} s)", flush=True)
    t0 = time.perf_counter()
    ablation_counts = ablation_phase(report, dev, card)
    torch.cuda.empty_cache()
    print(f"ablation: phase done in {time.perf_counter() - t0:.1f} s", flush=True)

    params, decode, cfg, tok_gen = main_path(dev, card)
    t0 = time.perf_counter()
    w8a8_counts = w8a8_phase(report, params, decode, cfg, dev, card, tok_gen)
    torch.cuda.empty_cache()
    print(f"w8a8: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cli_counts, ckpt, cli_ids = cli_phase(params, decode, cfg, dev, card)
    torch.cuda.empty_cache()
    print(f"cli: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    atexit.register(shutil.rmtree, ckpt, True)  # the cli_tp phase, last, reads it too
    t0 = time.perf_counter()
    serve_cli_counts = serve_cli_phase(params, decode, cfg, dev, card, ckpt)
    torch.cuda.empty_cache()
    print(f"serve_cli: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    fp32_counts, fp32_ids = fp32_phase(cfg, dev, card, ckpt)
    torch.cuda.empty_cache()
    print(f"fp32: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    finetune_counts = finetune_phase(params, cfg, dev, card, ckpt)
    torch.cuda.empty_cache()
    print(f"finetune: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts, tok_dense, tok_paged = serving_phase(params, decode, cfg, dev, card)
    print(f"serve: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    mixed_counts = mixed_cache_phase(params, decode, cfg, dev, card, tok_gen, tok_dense)
    torch.cuda.empty_cache()
    print(f"mixed: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    spec_counts = spec_phase(report, params, decode, cfg, dev, card)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lora_counts = multilora_phase(report, params, decode, cfg, dev, card)
    torch.cuda.empty_cache()
    print(f"multilora: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tp_counts, feats_one = tp_one_rank_phase(params, decode, cfg, dev, card, tok_gen, tok_dense,
                                             tok_paged)
    del decode
    torch.cuda.empty_cache()
    tp_two_rank_phase(cfg, card, tok_dense)
    print(f"tp: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    train_counts = train_phase(params, cfg, dev, card)
    print(f"train: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    # last, after every profile of this process: in runs where the CLIs'
    # spawned ranks ran before the spec and multilora phases, those phases'
    # larger profiles lost 1-3 of ~576 GEMV events on every try
    t0 = time.perf_counter()
    cli_tp_phase(cfg, card, ckpt, cli_ids, fp32_ids=fp32_ids)
    torch.cuda.empty_cache()
    print(f"cli_tp: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    # the data axis: spawned ranks too, so after every profile of this process
    t0 = time.perf_counter()
    del params
    torch.cuda.empty_cache()
    dp_phase(cfg, card, tok_paged, feats_one)
    cli_tp_phase(cfg, card, ckpt, cli_ids, label="cli_dp", data=2, fp32_ids=fp32_ids)
    torch.cuda.empty_cache()
    print(f"dp: phase done in {time.perf_counter() - t0:.1f} s", flush=True)
    # the training half of the mesh: spawned ranks too, after dp
    train_mesh_counts = train_mesh_phase(cfg, dev, card, ckpt)
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    counts = {k: sum(c.get(k, 0) for c in (counts, lora_counts, tp_counts, train_counts,
                                           ablation_counts, cli_counts, serve_cli_counts,
                                           spec_counts, finetune_counts, w8a8_counts,
                                           train_mesh_counts, fp32_counts, fp32_kernel_counts,
                                           mixed_counts))
              for k in kernels.WRAPPERS}
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")

    src = {
        "flash_attention_fwd": ("cuda", "paligemma_tpu_torch/csrc/flash_attention.cu",
                                "paligemma_tpu/kernels/flash_attention.py:43"),
        "int8_gemv": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                      "paligemma_tpu/kernels/decode_layer.py:95"),
        "decode_attention": ("cuda", "paligemma_tpu_torch/csrc/decode_attention.cu",
                             "paligemma_tpu/kernels/decode_layer.py:95"),
        # the final norm (the layers' norms are the GEMVs' prologues)
        "rms_norm": ("triton", "paligemma_tpu_torch/kernels/_triton_decode.py",
                     "paligemma_tpu/kernels/decode_layer.py:95"),
        # the qkv GEMV with the input norm, RoPE and the fresh K/V rows
        # (dense rows, or page slots as the paged kernel's caller writes them)
        "int8_gemv_rope_kv": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                              "paligemma_tpu/kernels/decode_layer.py:95 / "
                              "paligemma_tpu/kernels/decode_layer_paged.py:56"),
        "head_argmax": ("cuda", "paligemma_tpu_torch/csrc/decode_head.cu",
                        "paligemma_tpu/kernels/decode_head.py:35"),
        "paged_decode_attention": ("cuda", "paligemma_tpu_torch/csrc/paged_attention.cu",
                                   "paligemma_tpu/kernels/paged_attention.py:42"),
        "flash_attention_bwd_dq": ("cuda", "paligemma_tpu_torch/csrc/flash_attention_bwd.cu",
                                   "paligemma_tpu/kernels/flash_attention.py:262"),
        "flash_attention_bwd_dkv": ("cuda", "paligemma_tpu_torch/csrc/flash_attention_bwd.cu",
                                    "paligemma_tpu/kernels/flash_attention.py:321"),
        "int8_gemv_f32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                          "paligemma_tpu/kernels/decode_layer_tp.py:79"),
        # K1: a TP rank's o / down partial with its LoRA delta; XLA under
        # GSPMD in the reference (the mesh's multi-LoRA tick), no Pallas kernel
        "int8_gemv_f32_lora": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                               "paligemma_tpu/runtime/serving.py:223"),
        # the LoRA shrink of B2 / B4 with lora=True (its expand is in
        # int8_gemv's epilogue)
        "lora_shrink": ("cuda", "paligemma_tpu_torch/csrc/lora.cu",
                        "paligemma_tpu/kernels/decode_layer.py:95"),
        # chains of the port's kernels (CUDA GEMVs and attention), each
        # counted once per call
        "mlp_decode_fused": ("cuda", "paligemma_tpu_torch/kernels/decode_mlp.py",
                             "paligemma_tpu/kernels/decode_mlp.py:49"),
        "attn_decode_tp": ("cuda", "paligemma_tpu_torch/kernels/decode_layer_tp.py",
                           "paligemma_tpu/kernels/decode_layer_tp.py:79"),
        "attn_decode_paged_tp": ("cuda", "paligemma_tpu_torch/kernels/decode_layer_paged_tp.py",
                                 "paligemma_tpu/kernels/decode_layer_paged_tp.py:58"),
        "vision_attention": ("cuda", "paligemma_tpu_torch/csrc/vision_attention.cu",
                             "paligemma_tpu/kernels/ablation/vision_attention.py:47"),
        "seg_decode_attention": ("cuda", "paligemma_tpu_torch/csrc/seg_attention.cu",
                                 "paligemma_tpu/kernels/ablation/decode_attention.py:46"),
        "int4_matmul": ("cuda", "paligemma_tpu_torch/csrc/int4_matmul.cu",
                        "paligemma_tpu/kernels/ablation/quant4.py:66"),
        "int8_matmul": ("cuda", "paligemma_tpu_torch/csrc/int8_matmul.cu",
                        "paligemma_tpu/kernels/ablation/quant_pallas.py:22"),
        "int8_matmul_nmajor": ("cuda", "paligemma_tpu_torch/csrc/int8_matmul.cu",
                               "paligemma_tpu/kernels/ablation/quant_pallas.py:109"),
        # W8A8 prefill: XLA in the reference (_xla_w8a8_matmul), no Pallas kernel
        "w8a8_quant_rows": ("cuda", "paligemma_tpu_torch/csrc/w8a8_gemm.cu",
                            "paligemma_tpu/kernels/quant.py:92"),
        "w8a8_gemm": ("cuda", "paligemma_tpu_torch/csrc/w8a8_gemm.cu",
                      "paligemma_tpu/kernels/quant.py:92"),
        # the fp32 forms (--dtype float32) of the one-card main path
        "flash_attention_fwd_fp32": ("cuda", "paligemma_tpu_torch/csrc/flash_attention.cu",
                                     "paligemma_tpu/kernels/flash_attention.py:43"),
        "int8_gemv_fp32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv_fp32.cu",
                           "paligemma_tpu/kernels/decode_layer.py:95"),
        "int8_gemv_rope_kv_fp32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv_fp32.cu",
                                   "paligemma_tpu/kernels/decode_layer.py:95 / "
                                   "paligemma_tpu/kernels/decode_layer_paged.py:56"),
        "head_argmax_fp32": ("cuda", "paligemma_tpu_torch/csrc/decode_head.cu",
                             "paligemma_tpu/kernels/decode_head.py:35"),
        "decode_attention_fp32": ("cuda", "paligemma_tpu_torch/csrc/decode_attention.cu",
                                  "paligemma_tpu/kernels/decode_layer.py:95"),
        "paged_decode_attention_fp32": ("cuda", "paligemma_tpu_torch/csrc/paged_attention.cu",
                                        "paligemma_tpu/kernels/paged_attention.py:42"),
        "rms_norm_fp32": ("triton", "paligemma_tpu_torch/kernels/_triton_decode.py",
                          "paligemma_tpu/kernels/decode_layer.py:95"),
        # the fp32 forms of the LoRA bank, the mesh and W8A8
        "lora_shrink_fp32": ("cuda", "paligemma_tpu_torch/csrc/lora.cu",
                             "paligemma_tpu/kernels/decode_layer.py:95"),
        "int8_gemv_f32_fp32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv_fp32.cu",
                               "paligemma_tpu/kernels/decode_layer_tp.py:79"),
        "int8_gemv_f32_lora_fp32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv_fp32.cu",
                                    "paligemma_tpu/runtime/serving.py:223"),
        "w8a8_quant_rows_fp32": ("cuda", "paligemma_tpu_torch/csrc/w8a8_gemm.cu",
                                 "paligemma_tpu/kernels/quant.py:92"),
        "w8a8_gemm_fp32": ("cuda", "paligemma_tpu_torch/csrc/w8a8_gemm.cu",
                           "paligemma_tpu/kernels/quant.py:92"),
        # the fp32 forms of the flash backward (the Trainer at fp32), B12, B10
        "flash_attention_bwd_dq_fp32": ("cuda", "paligemma_tpu_torch/csrc/flash_attention_bwd.cu",
                                        "paligemma_tpu/kernels/flash_attention.py:262"),
        "flash_attention_bwd_dkv_fp32": ("cuda",
                                         "paligemma_tpu_torch/csrc/flash_attention_bwd.cu",
                                         "paligemma_tpu/kernels/flash_attention.py:321"),
        "vision_attention_fp32": ("cuda", "paligemma_tpu_torch/csrc/flash_attention.cu",
                                  "paligemma_tpu/kernels/ablation/vision_attention.py:47"),
        "seg_decode_attention_fp32": ("cuda", "paligemma_tpu_torch/csrc/seg_attention.cu",
                                      "paligemma_tpu/kernels/ablation/decode_attention.py:46"),
        # the mixed forms: a KV cache of the other dtype (cache_dtype)
        "int8_gemv_rope_kv_cache_fp32": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv.cu",
                                         "paligemma_tpu/kernels/decode_layer.py:95 / "
                                         "paligemma_tpu/kernels/decode_layer_paged.py:56"),
        "int8_gemv_rope_kv_fp32_cache_bf16": ("cuda", "paligemma_tpu_torch/csrc/int8_gemv_fp32.cu",
                                              "paligemma_tpu/kernels/decode_layer.py:95 / "
                                              "paligemma_tpu/kernels/decode_layer_paged.py:56"),
        "decode_attention_cache_fp32": ("cuda", "paligemma_tpu_torch/csrc/decode_attention.cu",
                                        "paligemma_tpu/kernels/decode_layer.py:95"),
        "decode_attention_fp32_cache_bf16": ("cuda",
                                             "paligemma_tpu_torch/csrc/decode_attention.cu",
                                             "paligemma_tpu/kernels/decode_layer.py:95"),
        "paged_decode_attention_cache_fp32": ("cuda",
                                              "paligemma_tpu_torch/csrc/paged_attention.cu",
                                              "paligemma_tpu/kernels/paged_attention.py:42"),
        "paged_decode_attention_fp32_cache_bf16": (
            "cuda", "paligemma_tpu_torch/csrc/paged_attention.cu",
            "paligemma_tpu/kernels/paged_attention.py:42"),
    }
    rows = []
    for name in kernels.WRAPPERS:
        route, source, replaces = src[name]
        r = report.rows[name]
        rows.append({"name": name, "route": route, "source": source, "replaces": replaces,
                     "launches": counts[name], "max_abs_err": r["max_abs_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": "operations" if r["flops_ms"] > r["bytes_ms"] else "bytes",
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
