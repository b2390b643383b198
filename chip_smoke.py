"""GPU smoke run of the PyTorch port (``repro_torch``): ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the sources in this checkout, holds
each kernel against its plain PyTorch version on the card, drives the
main paths (``ChipServer`` serving ``cifar9_s1`` at full width beside
``mnist5``, through the megakernel and through the staged kernels; a
shared ``ChipServer`` serving the 4 x S=4 composite; the face ->
owner ``CascadePipeline``, fused and host-side; the delta-gated
``TemporalPipeline`` on 8 ``cifar9_s1`` video streams, and on the
``cifar10`` family under the operating-point controller; STE training of
``face_detector`` and ``owner_detector`` at batch 32, the trained detector
folded and served through ``ChipServer``, and a BitLinear layer at
SmolLM-360M's MLP width; ``repro_torch.launch.serve`` serving SmolLM-360M
at full width, prefill through the flash-attention kernel, then greedy
decode, and the same serve of OLMoE-1B-7B (6.92 B parameters, 64 experts
a layer on the dense MoE path) and RWKV6-3B at full width, and of
MusicGen-medium (4 codebooks) at full width; Qwen2-VL-2B at full width
prefilled from patch embeddings on its M-RoPE grid and decoded through
``train.serve``'s steps, its launcher refusal; ``cifar9_s1``
under the continuous policy on Poisson and bursty
traces, and a ``ServeFleet`` of two replicas with a killed host and a
warm-started replacement), checks the answers against the float
reference, and times every kernel (a call in a CUDA graph) beside its
bound, its plain version and a PyTorch library yardstick.  Needs one
CUDA device and no arguments; exits non-zero on any failure, and without a CUDA
device or outside a checkout of the repository.

Phases: 1 environment, 2 build, 3 kernels vs plain versions (flash
attention also at head dims 8 and 20, which run on the next instantiation
up; the packed xnor_matmul at the three shapes phase 7 times), 4 end to end
(staged == megakernel == composite member == delta gate at threshold 0 ==
float reference; the fused cascade vs the float references and the host
rule; SmolLM-360M in float32: prefill logits through the kernel == through
its plain version, prefill + 4 decode steps == the teacher-forced
forward; in bf16 the kernel at each probability type == chunked attention
at the same one; OLMoE-1B-7B and RWKV6-3B at full width in float32, the
same checks where both runs routed every token alike (a token routed
differently must be a near-tie, and they are counted); Jamba at scaled()
size, the card == the CPU, and so the scaled() configs of kimi-k2,
qwen1.5-110b (head dim 8) and musicgen-medium (20), their prefills
through the flash kernel; MusicGen-medium and Qwen2-VL-2B at full width
in float32, prefill logits kernel == plain and prefill + decode ==
teacher-forced), 5 serve (the chip tier; the LM serves of SmolLM-360M,
OLMoE-1B-7B, RWKV6-3B and MusicGen-medium, Qwen2-VL-2B through the serve
steps, their flash launches, and bf16 greedy agreement between kernel
and plain runs for SmolLM), 5b continuous
serving and the fleet (the continuous ladder 1-32 held bit-exact for the
megakernel, a staged lane and the composite; 400 frames at 200 frames/s
under the continuous and the static policy; a shared continuous
composite; two replicas, host0 killed, zero loss; one replica over a
group of two device entries), 5c the autotune cache (every candidate of
the megakernel's cluster grid at cifar9_s1 B=8 and 256, of the 4 x S=4
quad's, of the staged conv's nslices x rows grid at B=8 held bit-exact
and timed, the delta gate's recompute at every cluster size, the
winners recorded in a cache file of its own and launched next,
``chip_serve --autotune`` once, ``BENCH_autotune.json`` unchanged), 6
train -> fold
-> serve (the STE training of
``face_detector`` and ``owner_detector``, each step on the card held
against the same step on the CPU; the packed conv against the float conv
on the trained weights; the folded detector served through ``ChipServer``;
BitLinear's packed path against its STE forward), 6b LM training
(SmolLM-360M with ``quant="binary"`` at full width, 5 adamw steps of 8 x
256 tokens; the scaled() step on the card against the CPU's; the
binary-LM example twin end to end, its decode's prefill through the
flash kernel at head dim 32; ``launch.train`` on MusicGen-medium and
Qwen2-VL-2B at full width, 3 adamw steps of 8 x 256 each, and their
scaled() steps card == CPU), 7 times (row 3 at mnist5's hidden layer,
at the serve batch and at BitLinear's shape; row 10 also at the prefill
shapes of OLMoE, MusicGen and Qwen2-VL and at head dims 8 and 20; the
SmolLM and OLMoE serves' prefill ms,
decode ms per token, tok/s and device idle share; MusicGen's batch
breakdown), 8 the cost model (``launch.dryrun`` of SmolLM-360M's four
cells on meta tensors; SmolLM-360M's prefill, decode and training step
and OLMoE-1B-7B's prefill at full width counted by ``launch.op_cost`` on
the card == on meta, the prefills through the flash kernel inside the
count, each timed in a CUDA graph against its roofline: bound share at
most 1.05, MFU, peak live bytes beside ``max_memory_allocated``), 9 the
training meshes at world size 1 (the host mesh over the card on a
one-rank process group, every train-state leaf's shard its full shape,
a full-width SmolLM-360M step under the mesh == the step without it, bit
for bit).
Near the end come ``{"kernels": [...]}`` and the card's name and power
limit on lines of their own; the last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (NVIDIA data sheet)
FLOP_PER_S = {torch.bfloat16: 989e12,   # dense tensor cores, data sheet
              torch.float32: 67e12}     # fp32 outside the tensor cores
POPC_PER_CLK_PER_SM = 16        # CUDA C++ Programming Guide, arithmetic
                                # instruction throughput, cc 9.0: popc
INT8_OPS_PER_S = 1979e12        # dense int8 tensor cores, data sheet (2 ops
                                # a MAC); no 1-bit rate is published, so the
                                # binary MACs' peak is this MAC rate scaled
                                # by the probe's measured binary / int8 MAC
                                # rates (Card.probe_mma)
MMA_PROBE = (4, 20_000)         # blocks an SM, iterations of 8 MMAs a warp
PROFILE_TRIES = 3               # profiler sessions before giving up
GRAPH_CALLS = 50                # calls a CUDA graph phase 7 times replays
FLOOR_ITERS = 200               # empty-kernel launches the floor probe times
BATCH = 8
RAGGED = 5
SERVE_BATCH = 256                      # the megakernel serve's other batch
SERVE_REQUESTS = 64
REPLACES = {
    "conv_block": "src/repro/kernels/binary_conv2x2_block.py:154",
    "xnor_matmul": "src/repro/kernels/xnor_matmul.py:137",
    "xnor_matmul_pack": "src/repro/kernels/xnor_matmul.py:123",
    "megakernel": "src/repro/kernels/megakernel.py:366",
    "composite": "src/repro/kernels/megakernel.py:366",
    "cascade": "src/repro/kernels/megakernel.py:593",
    "delta": "src/repro/kernels/megakernel.py:799",
    "binary_conv2x2": "src/repro/kernels/binary_conv2x2.py:84",
    "binarize_pack": "src/repro/kernels/binarize_pack.py:42",
    "flash_attention": "src/repro/kernels/flash_attention.py:103",
}
SOURCES = {
    "conv_block": "src/repro_torch/csrc/conv_block.cu",
    "xnor_matmul": "src/repro_torch/csrc/xnor_matmul.cu",
    "xnor_matmul_pack": "src/repro_torch/csrc/xnor_matmul.cu",
    "megakernel": "src/repro_torch/csrc/megakernel.cu",
    "composite": "src/repro_torch/csrc/megakernel.cu",
    "cascade": "src/repro_torch/csrc/cascade.cu",
    "delta": "src/repro_torch/csrc/delta.cu",
    "binary_conv2x2": "src/repro_torch/csrc/binary_conv2x2.cu",
    "binarize_pack": "src/repro_torch/csrc/binarize_pack.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
}
# every exact tiling of the 256-channel array by REGISTRY programs
TILINGS = (("cifar9_s4", "cifar9_s4t", "mnist5", "face_detector"),
           ("cifar9_s2", "face_angles"),
           ("cifar9_s2", "mnist5", "face_detector"))
RAGGED_MEMBERS = (8, 5, 3, 1)
CASCADE = ("face_detector", "owner_detector")
DET_CLUSTERS = (2, 8)           # the detector's own cluster shape and the
                                # recognizer's (mk.cascade_geometry picks)
CASCADE_EARLIER_MS = 1.7912     # the cascade's device time at B=8, margin
                                # -inf, on the one-block body it replaced
                                # (PERF.md section 6; not measured here)
MARGINS = (float("-inf"), -3.5, 0.0, 7.0, float("inf"))
SCHEDULES = ((8, 8, 1), (8, 3, 2), (4, 2, 5))        # (bb, rb, check_every)
# delta-gate thresholds: both sentinels, zero (= the plain megakernel), a
# fractional value (the ceil in delta_ctrl) and interior values
THRESHOLDS = (float("-inf"), 0.0, 1.0, 2.5, 64.0, float("inf"))
# (program, B, n_real) the delta gate is held at: cifar9_s1 and each
# variant of the cifar10 family lane at the serves' B=8, mnist5 ragged
DELTA_CASES = (("cifar9_s1", BATCH, BATCH), ("cifar9_s2", BATCH, BATCH),
               ("cifar9_s4", BATCH, BATCH), ("cifar9_s4t", BATCH, BATCH),
               ("mnist5", RAGGED, 3))
# SCHEDULES plus the temporal serves' own (bb 8, rb 2, check_every 1)
DELTA_SCHEDULES = SCHEDULES + ((8, 2, 1),)
VIDEO_STEPS = 16
# repro's own odd binary_conv2x2 shapes (tests/test_kernels_binary_conv2x2.py
# CASES and its property range), then two maps too wide for one staged row
# (column chunks): (B, H, W, c, F), B = 0 for a 3-D map
CONV_ODD = ((0, 4, 4, 32, 8), (0, 31, 31, 128, 32), (0, 8, 9, 40, 16),
            (3, 12, 7, 70, 20), (2, 2, 2, 1, 1), (5, 9, 11, 33, 33),
            (1, 3, 500, 2048, 40), (2, 3, 4000, 256, 33))
# the fused layer on maps too wide for one staged row (column chunks):
# (label, B, H, W, c, F, pool)
CONV_WIDE = (("wide", 2, 5, 2500, 256, 64, True),
             ("wide", 1, 3, 4000, 256, 32, False))
# binarize_pack: BitLinear's SmolLM-360M MLP input (256 tokens x d_model
# 960), an odd shape, and cifar9_s1's layer-2 activations at B=8
PACK_SHAPES = ((256, 960), (300, 100), (8 * 31 * 31, 256))
# the int32 xnor_matmul's ragged edges: M (a half m16, one past, several
# tiles), N (inside one n8 tile, odd, past a block), K (one bit, one word,
# 4 words, 50 words (8-byte copies), 128 words (16 chunks))
XNOR_RAGGED = ((1, 15, 17, 300), (1, 10, 33), (1, 31, 100, 1600, 4096))
XNOR_PACK_N = (32, 96, 2560)           # the packed variant's ragged N
# phase 5b: continuous serving of cifar9_s1 through the megakernel at
# repro's driver defaults (200 frames/s offered, SLO 50 ms); the window
# target ceil(200 x 0.05 x 0.5) = 5 sits below the batch, so the ladder runs
CONT_BATCH, CONT_SLO_MS, CONT_RATE, CONT_FRAMES = 32, 50.0, 200.0, 400
CONT_TRAFFIC = ("poisson", "bursty")
LADDER = (1, 2, 4, 8, 16, 32)          # the ladder {1, 2, 4, ..., 32}
FLEET_KILL_AFTER = 16                  # host0 dies after 16 served frames
TRAIN_BATCH = 32
TRAIN_SEED = 7                         # the detector twin's init seed
DETECTOR_STEPS = 40
OWNER_STEPS = 3
BITLINEAR = (960, 2560, 256, 5)        # d_in, d_out, tokens, STE steps
LM_ARCH = "smollm-360m"
LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_GEN = 8, 4, 512, 32
LM_SERVE = ("--arch", LM_ARCH, "--requests", str(LM_REQUESTS), "--batch",
            str(LM_BATCH), "--prompt-len", str(LM_PROMPT), "--gen-len",
            str(LM_GEN))
LM_CHECK = (2, 512, 4)                 # batch, prompt, decode steps (fp32)
# SmolLM's prefill logits and decode steps in float32: repro's tolerance
# for prefill + decode vs the teacher-forced forward (its
# tests/test_serve_equiv.py); the sums run in other orders 32 layers deep
LM_TOL = 2e-4
# flash attention vs its plain version: (label, B, S, H, KH, D, causal),
# the serve's prefill at its pull sizes 4 and 1 first, the scaled()
# configs' head dims 32 and 16, then the head dims the kernel runs on the
# next instantiation up: 8 (kimi-k2's and qwen1.5-110b's scaled(), G = 8)
# and 20 (musicgen-medium's scaled(), MHA) at the serve's prefill size,
# and each not causal at G = 1 and G = 3; each in float32 and in bf16 at
# both probability types (FLASH_PROBS)
FLASH_SHAPES = (("SmolLM prefill", 4, 512, 15, 5, 64, True),
                ("SmolLM prefill", 1, 512, 15, 5, 64, True),
                ("OLMoE prefill", 4, 512, 16, 16, 128, True),
                ("MusicGen prefill", 4, 512, 24, 24, 64, True),
                ("Qwen2-VL prefill", 4, 512, 12, 2, 128, True),
                ("MHA", 2, 256, 8, 8, 64, True),
                ("MQA", 2, 256, 8, 1, 64, True),
                ("D=128, G=4", 1, 384, 32, 8, 128, True),
                ("ragged S", 3, 333, 15, 5, 64, True),
                ("non-causal", 2, 200, 6, 2, 64, False),
                ("scaled() D=32", 2, 100, 6, 2, 32, True),
                ("scaled() D=16", 2, 77, 4, 4, 16, True),
                ("D=16 non-causal", 1, 90, 4, 1, 16, False),
                ("D=8 G=8 prefill", 4, 512, 8, 1, 8, True),
                ("D=20 MHA prefill", 4, 512, 3, 3, 20, True),
                ("D=8 non-causal", 1, 90, 4, 4, 8, False),
                ("D=20 G=3 non-causal", 2, 77, 6, 2, 20, False))
# repro's tolerances (tests/test_kernels_flash.py): float32 sums in other
# orders; in bf16 the output rounds to bf16 (and p too, with probs_bf16)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# bf16's probability types: p and v rounded to bf16 before p.v (like for
# like with SDPA), or float32 p (SmolLM-360M's attn_probs_bf16=False)
FLASH_PROBS = (True, False)
# the two probability types differ by a few bf16 ulps at most, so the max
# error cannot tell a kernel that ignores probs_bf16 from a sound one; the
# mean can: a sound kernel's mean abs error to its reference at the same
# type is this many times below its mean abs error to the other type's,
# and a kernel ignoring the type swaps the two (the plain version against
# chunked attention: tests/test_torch_flash.py)
PROBS_SEPARATION = 10.0
# phase 5c: the autotuner's megakernel grid at the serve's two batches,
# its staged conv grid on these programs at BATCH
AUTOTUNE_BATCHES = (BATCH, SERVE_BATCH)
# the delta gate's changed lanes at each candidate cluster (B=8): all,
# five with lane 0 unchanged, none
DELTA_TUNED_LANES = (tuple(range(BATCH)), (1, 2, 4, 6, 7), ())
STAGED_TUNED = ("cifar9_s1", "mnist5")
# phase 6b: SmolLM-360M's binary training step at full width
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS = 8, 256, 5
# the expert and recurrent blocks (phases 4, 5 and 7): OLMoE-1B-7B and
# RWKV6-3B at full width, Jamba at scaled() size (full width needs more
# than one card); float32 checks (batch, prompt, decode steps), then
# serves in the configs' own dtypes.  RWKV6's WKV is a per-token loop of
# small launches (32 layers x the prompt), so its prompt is 128
MOE_ARCH, RWKV_ARCH, HYBRID_ARCH = "olmoe-1b-7b", "rwkv6-3b", "jamba-v0.1-52b"
MOE_CHECK, RWKV_CHECK, HYBRID_CHECK = (2, 512, 4), (2, 128, 4), (2, 24, 4)
# phase 4: the scaled() configs whose head dims the flash kernel pads (8:
# kimi-k2 and qwen1.5-110b, G = 8; 20: musicgen-medium), prefill + decode
# in float32 on the card == on the CPU, (arch, seed) and (batch, prompt,
# decode steps)
PADDED_ARCHS = (("kimi-k2-1t-a32b", 9), ("qwen1.5-110b", 10),
                ("musicgen-medium", 11))
PADDED_CHECK = (2, 100, 4)
MOE_SERVE = ("--arch", MOE_ARCH, "--requests", "8", "--batch", "4",
             "--prompt-len", "512", "--gen-len", "32")
RWKV_SERVE = ("--arch", RWKV_ARCH, "--requests", "8", "--batch", "4",
              "--prompt-len", "128", "--gen-len", "16")
# MusicGen's codebooks and the VLM batch (phases 4, 5, 6b and 7), both at
# full width, one parameter set on the card at a time: float32 checks
# (batch, prompt, decode steps); MusicGen served by launch.serve, the VLM
# (no input table: the launcher refuses it) through train.serve's steps
# on a batch of VLM_SERVE[0] embeds prompts of VLM_SERVE[1] positions and
# VLM_SERVE[2] decode steps fed the batch's next embeds; 3 adamw steps of
# 8 x 256 each through launch.train
MUSIC_ARCH, VLM_ARCH = "musicgen-medium", "qwen2-vl-2b"
MUSIC_CHECK = VLM_CHECK = (2, 512, 4)
MUSIC_SERVE = ("--arch", MUSIC_ARCH, "--requests", "8", "--batch", "4",
               "--prompt-len", "512", "--gen-len", "32")
VLM_SERVE = (4, 512, 32)
CB_TRAIN = ("--steps", "3", "--global-batch", "8", "--seq-len", "256")
# phase 8: the cost model.  SmolLM-360M's four dry-run cells on meta, then
# whole steps at full width in the configs' own dtypes, each counted on
# the card and on meta at the same shape: (arch, step, seq_len, batch,
# config overrides), the decode step's cache the prefill's, padded by
# LM_GEN; the training step with the config's remat (each pattern repeat
# recomputed in the backward), and beside it without
COST_STEPS = ((LM_ARCH, "prefill", LM_PROMPT, LM_BATCH, {}),
              (LM_ARCH, "decode", LM_PROMPT + LM_GEN, LM_BATCH, {}),
              (LM_ARCH, "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH, {}),
              (LM_ARCH, "train", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
               {"remat": False}),
              (MOE_ARCH, "prefill", 512, 4, {}))
# phase 9: the training meshes at world size 1, one full-width step of
# SmolLM-360M (batch, sequence) under the host mesh and outside it, then
# on DTensors of the state's specs on a one-rank NCCL group
MESH_STEP = (LM_TRAIN_BATCH, LM_TRAIN_SEQ)
# phase 9's sharded count on the card: SmolLM-360M's scaled() config with
# 8 heads over 4 KV heads (so that the (2, 4) mesh's model axis splits
# them), a prefill of (batch, sequence) on a fake group of 8 ranks whose
# blocks lie on the card, counted == on meta; then one full-width pod
# cell of the dry run on meta
SHARDED_MESH = (2, 4)
SHARDED_HEADS = (8, 4)
# and with q heads that do not divide the model axis: torch.chunk's blocks
# 2, 2, 2 and 0 of the 6 q heads, the first device's two reading KV head 0
SHARDED_UNEVEN_HEADS = (6, 2)
SHARDED_PREFILL = (8, 256)
# and a training step of that config at remat=True (batch, sequence) on
# the same fake group: each pattern repeat recomputed in the backward
SHARDED_TRAIN = (8, 128)
# and Gemma2-2B's scaled() config at 2 q heads over 1 KV head: its softcap
# takes the chunked attention, each head's query rows shared by 2 of the 4
# model devices (zig-zag halves of the causal triangle)
SHARDED_ROWS = ("gemma2-2b", 2, 1)
# a decode step of SmolLM-360M's scaled() config at a batch of one (cache
# of this many positions) on the same fake group: the batch leaves "data"
# idle, so the weights' free dims split over it and the outputs gather
SHARDED_DECODE_LEN = 256
# and the faults' steps (ROADMAP 3.15, 3.16) on the same fake group:
# (arch, step, batch, sequence).  RWKV-6's scaled() 3 heads do not divide
# the 4 model devices, so its cache keeps the state whole and the decode
# updates it whole, reading y at each device's heads; its LoRA products
# run on each device's columns.  Gemma2's post norms take each sublayer's
# sum reduced once, in the stream's dtype
SHARDED_STEPS = (("rwkv6-3b", "train", 8, 64), ("rwkv6-3b", "decode", 8, 64),
                 ("gemma2-2b", "train", 8, 128))
POD_CELL = (LM_ARCH, "train_4k")
# this cell's FLOPs a device on pod as this tree counts it on an 8-core
# x86_64 CPU with torch 2.13.0+cpu (PERF.md section 5), beside the card's
# torch's count: the products are placed by hand, so the two should agree
POD_CELL_CPU_FLOPS = 1.69547e13
# row 10 at SmolLM's prefill (bf16, probs_bf16=True), a call in a CUDA
# graph before the padded head dims (PERF.md's kernel table): the D = 64
# path they leave as it was
FLASH_EARLIER_MS = 0.01719
STEP_GRAPH_CALLS = 5            # steps a CUDA graph of phase 8 replays
STEP_EVENT_ITERS = 5            # steps CUDA events time where capture fails
BOUND_SHARE_MAX = 1.05          # no step runs faster than its bound
# phase 8's trip-count checks: (arch, step, seq, batch, scaled()): counted
# eagerly on the card (every iteration of the recurrence) == counted on
# meta (four iterations, the middle one's charges scaled), exactly
SCAN_STEPS = ((RWKV_ARCH, "prefill", 256, 1, False),
              (HYBRID_ARCH, "train", 64, 2, True))
# phase 10: one OLMoE-1B-7B MoE layer at full width, float32: prefill x
# (B, S) through apply_ep, decode x (B, 1) through apply_ep_decode
EP_PREFILL, EP_DECODE = (4, 512), (4, 1)
EP_NO_DROP = 8.0                # capacity factor E / k: nothing drops
FP8_MEAN_REL = 0.1              # repro's bound on the fp8 dispatch vs dense
PIPE_CHECK = (64, 8, 960)       # batch, microbatches, width (SmolLM's)
COLLECTIVE_BACKEND = "cpu:gloo,cuda:nccl"   # NCCL for the card's tensors


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


_START = time.perf_counter()


def phase(n, title: str) -> None:
    print(f"\n=== phase {n} (at {time.perf_counter() - _START:.1f} s): "
          f"{title}", flush=True)


class Card:
    """The card's identity and the rates the bounds divide by."""

    def __init__(self):
        self.name = torch.cuda.get_device_name(0)
        self.smi = sh("nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader").splitlines()[0]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        clk = sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                 "--format=csv,noheader,nounits").splitlines()[0]
        self.clock_hz = float(clk) * 1e6
        self.popc_per_s = self.sms * POPC_PER_CLK_PER_SM * self.clock_hz

    def popc_bound(self, nbytes: float, word_ops: float):
        """(bound_ms, bound_by) on the CUDA cores: the larger of bytes over
        HBM bandwidth and xor+popc word-ops over the card's popc issue
        rate."""
        return self._bound(nbytes, word_ops / self.popc_per_s)

    def mac_bound(self, nbytes: float, macs: float):
        """(bound_ms, bound_by) of binary MACs on the tensor cores: the
        larger of bytes over HBM bandwidth and MACs over the binary MAC
        peak (probe_mma)."""
        return self._bound(nbytes, macs / self.binary_macs_per_s)

    @staticmethod
    def _bound(nbytes: float, t_ops_s: float):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = t_ops_s * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def probe_mma(self) -> None:
        """Measure the issue rates of mma.sync m16n8k256 .b1 and m16n8k32
        .s8 (csrc/mma_rate.cu, CUDA events over one long launch each) and
        set the binary MAC peak: the data sheet's int8 MAC rate times the
        measured ratio of binary to int8 MACs a second."""
        import ctypes

        from repro_torch.kernels import _build
        fn = _build.library("mma_rate").mma_rate_launch
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")
        blocks, iters = MMA_PROBE[0] * self.sms, MMA_PROBE[1]
        stream = torch.cuda.current_stream().cuda_stream
        rates, mac_rates = {}, {}
        for binary, macs in ((1, 16 * 8 * 256), (0, 16 * 8 * 32)):
            def launch():
                if fn(binary, blocks, iters, sink.data_ptr(), stream):
                    raise RuntimeError("mma_rate launch failed")
            # 8 warps a block, 8 chains a warp
            rates[binary] = blocks * 64 * iters / (time_ms(launch, 3) / 1e3)
            mac_rates[binary] = rates[binary] * macs
            shape = "m16n8k256 .b1" if binary else "m16n8k32 .s8"
            print(f"  mma probe {shape}: {rates[binary] / 1e12:.4f} T mma/s = "
                  f"{mac_rates[binary] / 1e15:.4f} P MAC/s [{self.smi}]")
        ratio = mac_rates[1] / mac_rates[0]
        self.binary_macs_per_s = INT8_OPS_PER_S / 2 * ratio
        print(f"  binary MACs a second / int8 MACs a second {ratio:.4f} "
              f"(issue rates {rates[1] / rates[0]:.4f}); binary MAC peak "
              f"{INT8_OPS_PER_S / 2e15:.4f} P (int8, data sheet) x "
              f"{ratio:.4f} = {self.binary_macs_per_s / 1e15:.4f} P MAC/s")

    def probe_floor(self) -> None:
        """Time an empty kernel (csrc/mma_rate.cu empty_launch) the way
        phase 7 times every row, a call in a CUDA graph, with CUDA events
        back to back and torch.profiler device time beside it: the launch
        floor the smallest kernels sit near."""
        import ctypes

        from repro_torch.kernels import _build
        from repro_torch.launch.timing import graph_ms
        fn = _build.library("mma_rate").empty_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def launch():       # on the current stream: graph_ms captures it
            if fn(torch.cuda.current_stream().cuda_stream):
                raise RuntimeError("empty_launch failed")
        self.floor_events_ms = time_ms(launch, FLOOR_ITERS)
        self.floor_profiler_ms = device_ms(launch, FLOOR_ITERS,
                                           "empty_kernel")
        self.floor_ms = graph_ms(launch, GRAPH_CALLS)
        print(f"  launch floor (empty kernel, one warp): "
              f"{self.floor_ms:.5f} ms a call in a CUDA graph, "
              + (f"{self.floor_profiler_ms:.5f} ms device (torch.profiler)"
                 if self.floor_profiler_ms is not None
                 else "profiler device time not measured")
              + f", {self.floor_events_ms:.5f} ms a call by CUDA events back "
              f"to back [{self.smi}]")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, by
    CUDA events after a warm-up (L2 stays warm, as in steady serving)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_profile(fn, iters: int, warmup: bool = True):
    """Host wall time of ``iters`` calls of ``fn`` (ending in a
    synchronize) and the device time of the CUDA kernels they ran, from
    ``torch.profiler``: ``(wall_ms, {kernel name: device ms})``, the dict
    empty when the profiler records no device activity.  One call warms
    up first unless ``warmup`` is False (``fn`` ran warm before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        fn()
    torch.cuda.synchronize()
    # device activity only: every reading here is a kernel's device time,
    # and the host ops' events of a whole LM serve took the profiler
    # minutes to process (PR 23's smoke: 248 s for SmolLM-360M's serve
    # and breakdown, 212 s for OLMoE-1B-7B's)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.time_range.elapsed_us() / 1e3)
    return wall_ms, kernels


def device_ms(fn, iters: int, name: str = ""):
    """Device time of one call of ``fn``: its CUDA kernels whose names hold
    ``name`` (all of them for ""), from ``torch.profiler`` over ``iters``
    calls; None when the profiler records no device activity in any of
    PROFILE_TRIES sessions (a session now and then comes back empty)."""
    for _ in range(PROFILE_TRIES):
        _, kernels = device_profile(fn, iters)
        hits = [ms for k, ms in kernels.items() if name in k]
        if hits:
            return sum(hits) / iters
    return None


def kernel_split(kernels, iters: int, names) -> str:
    """Device microseconds per call of the named kernels (substrings of
    the mangled names) and of everything else the profile holds."""
    per = {n: 0.0 for n in names + ("other",)}
    for k, ms in kernels.items():
        hit = next((n for n in names if n in k), "other")
        per[hit] += ms * 1e3 / iters
    return ", ".join(f"{n} {us:.1f} us" for n, us in per.items())


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max abs err {err})")
    return err


def words(gen, *shape) -> torch.Tensor:
    """Random 32-bit words (bit 31 set in about half) as int32."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def max_abs_err_all(got, want) -> int:
    return max(max_abs_err(g, w) for g, w in zip(got, want))


def close_err(got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs difference; raises unless ``got`` is within rtol = atol =
    ``tol`` of ``want``."""
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"beyond {tol} (max abs err {err})")
    return err


def probs_type_errs(got, same, other, what: str):
    """Mean abs errors of ``got`` to ``same`` (the reference at its own
    probability type) and to ``other`` (at the other type); raises unless
    the first is PROBS_SEPARATION times below the second."""
    e_same = float((got.float() - same.float()).abs().mean())
    e_other = float((got.float() - other.float()).abs().mean())
    if not e_same * PROBS_SEPARATION < e_other:
        raise AssertionError(
            f"{what}: mean abs err {e_same:.3e} to the reference at its own "
            f"probability type is not {PROBS_SEPARATION}x below the "
            f"{e_other:.3e} to the other type's: the kernel does not compute "
            f"the probability type it was asked for")
    return e_same, e_other


def quiet():
    """Keep a run's own printing out of the smoke's output."""
    return contextlib.redirect_stdout(io.StringIO())


@contextlib.contextmanager
def plain_attention():
    """Route ``ops.flash_attention`` through the kernel's plain version,
    for the runs the main path is compared with (they launch nothing)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    real = ops.flash_attention
    ops.flash_attention = (
        lambda q, k, v, *, causal=True, scale=None, probs_bf16=None:
        fa.flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 probs_bf16=probs_bf16))
    try:
        yield
    finally:
        ops.flash_attention = real


def attention_flops(b: int, s: int, h: int, d: int, causal: bool) -> int:
    """q.k and p.v multiply-adds (2 FLOPs each) over the (query, key) pairs
    the mask keeps."""
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    return 4 * d * pairs


def flash_block_tiles(b: int, s: int, h: int, kh: int, causal: bool):
    """(block-tiles, heaviest block's tiles) of the bf16 kernel's schedule:
    a block per 64 rows (position, g) of one (batch, KV head), each
    visiting 64-key tiles up to its last row's diagonal."""
    g, total, heaviest = h // kh, 0, 0
    for r0 in range(0, s * g, 64):
        n_keys = (min(r0 + 64, s * g) - 1) // g + 1 if causal else s
        n = -(-n_keys // 64)
        total, heaviest = total + n, max(heaviest, n)
    return b * kh * total, heaviest


def lm_checks(dev) -> None:
    """Phase 4's LM part: SmolLM-360M at full width in float32 (random
    weights from a seed).  Prefill logits through the flash kernel ==
    through its plain version, and prefill + decode steps == the
    teacher-forced forward (plain chunked attention), within LM_TOL; then
    the bf16 checks of :func:`lm_bf16_probs`."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.train import serve
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the float32 checks need "
                             "float32 matmuls")
    cfg = get_config(LM_ARCH).with_(dtype="float32")
    params = transformer.init_params(cfg, seed=3, device=dev)
    b, s, k = LM_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + k),
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.int32).to(dev)
    ops.reset_launch_counts()
    h, _, _ = transformer.forward(params, cfg, {"tokens": toks[:, :s]},
                                  mode="prefill")
    got = transformer.lm_logits(params, cfg, h)
    n = ops.launch_counts()["flash_attention"]
    if n != cfg.num_layers:
        raise AssertionError(f"prefill launched flash attention {n} times, "
                             f"want {cfg.num_layers}")
    with plain_attention():
        h, _, _ = transformer.forward(params, cfg, {"tokens": toks[:, :s]},
                                      mode="prefill")
        want = transformer.lm_logits(params, cfg, h)
    err = close_err(got, want, LM_TOL)
    print(f"  {LM_ARCH} float32, B={b}, S={s}: prefill logits "
          f"{tuple(got.shape)} through the kernel ({n} launches) == "
          f"through its plain version "
          f"(max abs err {err:.3e}, tolerance {LM_TOL}; logits max "
          f"{float(want.abs().max()):.3f})")
    del got, want, h

    h, _, _ = transformer.forward(params, cfg, {"tokens": toks}, mode="train")
    teacher = transformer.lm_logits(params, cfg, h[:, s - 1:])
    logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(
        params, {"tokens": toks[:, :s]})
    outs = [logits]
    decode = serve.build_decode_step(cfg)
    for i in range(k):
        logits, cache = decode(params, cache, toks[:, s + i][:, None], s + i)
        outs.append(logits)
    got = torch.cat(outs, dim=1)
    if not torch.isfinite(got).all():
        raise AssertionError("non-finite LM logits")
    err = float((got - teacher).abs().max())
    if not torch.allclose(got, teacher, rtol=LM_TOL, atol=LM_TOL):
        raise AssertionError(f"prefill + {k} decode steps != teacher-forced "
                             f"forward (max abs err {err})")
    agree = float((got.argmax(-1) == teacher.argmax(-1)).float().mean())
    print(f"  {LM_ARCH} float32: prefill {s} + {k} decode steps == the "
          f"teacher-forced forward (chunked attention) at positions "
          f"{s - 1}..{s + k - 1} (max abs err {err:.3e}, tolerance {LM_TOL}; "
          f"argmax agreement {agree:.3f})")
    del got, teacher, cache, outs, logits
    lm_bf16_probs(dev, params, toks[:, :s])


def lm_bf16_probs(dev, params, toks) -> None:
    """SmolLM-360M in bf16: the kernel at each probability type against
    ``chunked_attention`` at the same one, within repro's bf16 tolerance,
    at the serve's prefill shape (``probs_bf16=False`` is the config's own
    setting, which ``repro`` serves); then the prompt's logits through 32
    layers, kernel (prefill) vs chunked (teacher-forced), each also against
    the float32 forward (reported)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention, transformer
    b, s, h, kh, d = FLASH_SHAPES[0][1:6]
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(b, s, h, d, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, s, kh, d, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    tol = FLASH_TOL[torch.bfloat16]
    chunked = {p: attention.chunked_attention(q, k, v, causal=True,
                                              probs_bf16=p)
               for p in FLASH_PROBS}
    for probs_bf16 in FLASH_PROBS:
        got = fa.flash_attention(q, k, v, causal=True, probs_bf16=probs_bf16)
        want, other = chunked[probs_bf16], chunked[not probs_bf16]
        err = float((got.float() - want.float()).abs().max())
        if not err <= tol:
            raise AssertionError(f"bf16 flash vs chunked attention "
                                 f"(probs_bf16={probs_bf16}): max abs err "
                                 f"{err} beyond {tol}")
        # chunked rounds bf16 p at its own chunks' running max, not at the
        # kernel's 64-key tiles', so only float32 p separates from the
        # other type here (True's mean errors are reported)
        if probs_bf16:
            means = tuple(float((got.float() - x.float()).abs().mean())
                          for x in (want, other))
        else:
            means = probs_type_errs(got, want, other,
                                    "bf16 flash vs chunked attention "
                                    "(probs_bf16=False)")
        print(f"  bf16 flash kernel vs chunked_attention, both probs_bf16="
              f"{probs_bf16}, B={b} S={s} H={h} KH={kh} D={d}: max abs err "
              f"{err:.3e} (tolerance {tol}); mean abs err {means[0]:.3e}, "
              f"to chunked at probs_bf16={not probs_bf16} {means[1]:.3e}"
              + ("" if probs_bf16 else
                 f" (held {PROBS_SEPARATION}x apart)"))

    cfg16 = get_config(LM_ARCH)
    logits = {}
    for label, c, mode in (("kernel", cfg16, "prefill"),
                           ("chunked", cfg16, "train"),
                           ("float32", cfg16.with_(dtype="float32"), "train")):
        hid, _, _ = transformer.forward(params, c, {"tokens": toks},
                                        mode=mode)
        logits[label] = transformer.lm_logits(params, c, hid).float()
    if not all(torch.isfinite(x).all() for x in logits.values()):
        raise AssertionError("non-finite bf16 LM logits")
    ref = logits["float32"]

    def dist(a, b):
        diff = (a - b).abs()
        same = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        return f"max {float(diff.max()):.3e}, mean {float(diff.mean()):.3e}, " \
               f"argmax agreement {same:.3f}"

    print(f"  {LM_ARCH} bf16, B={toks.shape[0]}, S={toks.shape[1]}, prompt "
          f"logits (max |logit| {float(ref.abs().max()):.3f}): kernel vs "
          f"chunked {dist(logits['kernel'], logits['chunked'])}; vs the "
          f"float32 forward: kernel {dist(logits['kernel'], ref)}, chunked "
          f"{dist(logits['chunked'], ref)} (reported)")


def lm_serve(card):
    """Phase 5's LM part: ``repro_torch.launch.serve.main`` on SmolLM-360M
    at full width (bf16 activations) on the card, the flash kernel
    launched once per layer per prefill; then the same serve under a
    frozen clock (so both pull full batches) through the kernel and
    through its plain version, and their greedy tokens compared.  Returns
    (the report, the launch counts of the serve)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm
    cfg = get_config(LM_ARCH)
    ops.reset_launch_counts()
    report = lm.main(list(LM_SERVE))
    counts = ops.launch_counts()
    layers = cfg.num_layers
    want = {k: 0 for k in counts}
    want["flash_attention"] = layers * len(report.prefill_ms)
    if counts != want:
        raise AssertionError(f"LM serve launches {counts}, want {want}")
    n_req, gen_len = LM_REQUESTS, LM_GEN
    if sorted(report.tokens) != list(range(n_req)) or any(
            len(t) != gen_len or not all(0 <= x < cfg.vocab_size for x in t)
            for t in report.tokens.values()):
        raise AssertionError("LM serve: missing requests or bad token ids")
    print(f"  LM serve {LM_ARCH}: {report.served} requests in "
          f"{len(report.prefill_ms)} batches; flash_attention launched "
          f"{counts['flash_attention']} times = {layers} per prefill; "
          f"{report.tokens_per_s:.1f} tok/s (first serve) [{card.smi}]")
    runs = {}
    for plain in (False, True):
        ctx = plain_attention() if plain else contextlib.nullcontext()
        with ctx, quiet():
            runs[plain] = lm.main(list(LM_SERVE), clock=lambda: 0.0,
                                  sleep=lambda _: None)
    equal = prefix = 0
    for rid, toks in runs[False].tokens.items():
        other = runs[True].tokens[rid]
        equal += sum(a == b for a, b in zip(toks, other))
        n = 0
        while n < gen_len and toks[n] == other[n]:
            n += 1
        prefix += n
    total = n_req * gen_len
    print(f"  bf16 greedy tokens, kernel vs plain attention (frozen clock, "
          f"full batches): {equal}/{total} equal positions, {prefix}/{total} "
          f"before the first divergence (reported, not asserted: bf16 rounds "
          f"the two attentions' outputs apart)")
    return report, counts


def batch_breakdown(card, dev, cfg, params, batch: int, prompt: int,
                    gen_len: int) -> None:
    """Where one full batch's time goes in ``launch.serve``'s steps: a
    prefill of ``batch`` prompts and 8 decode steps, each profiled apart
    over one call after a warm one (host wall a call or step, device
    busy, idle share, the kernels by family: flash, cuBLAS,
    elementwise)."""
    from repro_torch.data import tokens as dtok
    from repro_torch.train import serve
    toks = torch.cat([dtok.batch_for_step(cfg, i, global_batch=1,
                                          seq_len=prompt,
                                          device=dev)["tokens"]
                      for i in range(batch)])
    prefill = serve.build_prefill_step(cfg, max_len=prompt + gen_len)
    decode = serve.build_decode_step(cfg)
    state = {}

    def prefill_once():
        state["logits"], state["cache"] = prefill(params, {"tokens": toks})

    def decode_steps():
        cur = serve.sample(None, state["logits"])
        cache = state["cache"]
        for t in range(8):
            logits, cache = decode(params, cache, cur, prompt + t)
            cur = serve.sample(None, logits)

    for label, fn, per in (("prefill", prefill_once, 1),
                           ("decode", decode_steps, 8)):
        wall_ms, kernels = device_profile(fn, 1)
        calls = per
        line = (f"  LM {cfg.name} {label} batch {batch} (prompt {prompt}), "
                f"profiled: host {wall_ms / calls:.3f} ms a "
                f"{'step' if per > 1 else 'call'}")
        if kernels:
            busy = sum(kernels.values())
            line += (f", device busy {busy / calls:.3f} ms (idle share "
                     f"{1 - busy / wall_ms:.4f}), {len(kernels)} kernel "
                     f"names; " + kernel_split(kernels, calls,
                                               ("flash_fwd", "nvjet",
                                                "gemm", "elementwise")))
        else:
            line += ", device time not measured (no device activity recorded)"
        print(line + f" [{card.smi}]")


def moe_layers(cfg) -> int:
    return sum(k.endswith("_moe")
               for k in cfg.prefix + cfg.pattern * cfg.num_pattern_repeats)


def attn_layers(cfg) -> int:
    from repro_torch.models import transformer
    return sum(k in transformer.ATTN_KINDS
               for k in cfg.prefix + cfg.pattern * cfg.num_pattern_repeats)


def routed_err(got, want, first, positions, tol: float, what: str) -> float:
    """Max abs difference of (B, P, ...) ``got`` and ``want`` at the
    positions both runs' routings allow: before each row's first token
    routed differently (``moe.route_divergence``, which has already held
    every such token to a near-tie).  Raises beyond rtol = atol = tol."""
    keep = torch.tensor([[p < first.get(r, float("inf")) for p in positions]
                         for r in range(got.shape[0])], device=got.device)
    if not keep.any():
        raise AssertionError(f"{what}: no position left to compare")
    g, w = got[keep].float(), want[keep].float()
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, rtol=tol, atol=tol):
        raise AssertionError(f"{what}: max abs err {err} beyond {tol}")
    return err


def decode_vs_teacher(params, cfg, toks, s: int, k: int, what: str,
                      positions=None):
    """Prefill s tokens of ``toks`` (B, s + k), (B, s + k, ncb) with
    codebooks, or embeds (B, s + k, D) for a config without an input
    table, and decode k steps through ``train.serve``'s steps, against the
    teacher-forced forward (chunked attention) at positions s-1 ..
    s+k-1, within LM_TOL where both runs routed alike.  ``positions``
    (B, s, 3) places an M-RoPE prompt; the decode steps put step i at
    (s+i, s+i, s+i), and the teacher takes the same positions.  Returns
    (max abs err, tokens routed differently, argmax agreement)."""
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve
    n = moe_layers(cfg)
    key = "tokens" if cfg.embed_inputs else "embeds"
    prompt, teach = {key: toks[:, :s]}, {key: toks}
    if positions is not None:
        b = toks.shape[0]
        steps = torch.arange(s, s + k, dtype=positions.dtype,
                             device=positions.device)
        prompt["positions"] = positions
        teach["positions"] = torch.cat(
            [positions, steps[None, :, None].expand(b, k, 3)], dim=1)
    with moe.record_routes() as rec_t:
        h, _, _ = transformer.forward(params, cfg, teach, mode="train")
        teacher = transformer.lm_logits(params, cfg, h[:, s - 1:])
    del h
    with moe.record_routes() as rec_r:
        logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(
            params, prompt)
        outs = [logits]
        decode = serve.build_decode_step(cfg)
        for i in range(k):
            logits, cache = decode(params, cache, toks[:, s + i][:, None],
                                   s + i)
            outs.append(logits)
    got = torch.cat(outs, dim=1)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite logits")
    first, n_diff = moe.route_divergence(
        moe.route_table(rec_r, [(0, s)] + [(s + i, 1) for i in range(k)], n),
        moe.route_table(rec_t, [(0, s + k)], n))
    err = routed_err(got, teacher, first, range(s - 1, s + k), LM_TOL,
                     f"{what}: prefill + {k} decode steps vs the "
                     f"teacher-forced forward")
    agree = float((got.argmax(-1) == teacher.argmax(-1)).float().mean())
    return err, n_diff, agree


def scaled_card_vs_cpu(dev, arch: str, seed: int, check, repeats=None,
                       what: str = "") -> int:
    """``arch``'s scaled() config in float32 (``repeats`` pattern repeats
    where given): prefill + decode steps (``check``: batch, prompt, decode
    steps) on the card == on the CPU within LM_TOL where both runs routed
    alike (a token routed differently must be a near-tie), the card's
    prefill through the flash kernel, a launch an attention layer.
    Returns the card's flash launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.device import to_device
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.train import serve

    cfg = get_config(arch).scaled().with_(dtype="float32",
                                          param_dtype="float32")
    if repeats is not None:
        cfg = cfg.with_(num_layers=repeats * len(cfg.pattern))
    cpu_params = transformer.init_params(cfg, seed=seed, device="cpu")
    b, s, k = check
    cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
    toks = torch.randint(0, cfg.vocab_size, (b, s + k) + cb,
                         generator=torch.Generator().manual_seed(seed + 3),
                         dtype=torch.int32)
    n = moe_layers(cfg)
    segments = [(0, s)] + [(s + i, 1) for i in range(k)]
    out = []
    for where in (torch.device("cpu"), dev):
        params = to_device(cpu_params, where)
        t = toks.to(where)
        ops.reset_launch_counts()
        with moe.record_routes() as rec:
            logits, cache = serve.build_prefill_step(cfg, max_len=s + k)(
                params, {"tokens": t[:, :s]})
            outs = [logits]
            decode = serve.build_decode_step(cfg)
            for i in range(k):
                logits, cache = decode(params, cache, t[:, s + i][:, None],
                                       s + i)
                outs.append(logits)
        launched = ops.launch_counts()["flash_attention"]
        if launched != (attn_layers(cfg) if where.type == "cuda" else 0):
            raise AssertionError(f"{arch} on {where} launched flash "
                                 f"attention {launched} times")
        out.append((torch.cat(outs, dim=1).cpu(),
                    moe.route_table(rec, segments, n)))
    (want, cpu_routes), (got, card_routes) = out
    if not torch.isfinite(got).all():
        raise AssertionError(f"{arch} scaled(): non-finite logits")
    first, n_diff = moe.route_divergence(card_routes, cpu_routes)
    err = routed_err(got, want, first,
                     range(s - 1, s + k), LM_TOL,
                     f"{arch} scaled(), the card vs the CPU")
    kinds = "/".join(cfg.prefix + cfg.pattern)
    print(f"  {arch} scaled() float32 ({cfg.num_layers} layers: {kinds}"
          + (f" x {repeats}" if repeats else "")
          + f", {cfg.num_heads} heads of dim {cfg.head_dim} over "
          f"{cfg.num_kv_heads} KV heads{what}), B={b}: prefill {s} + {k} "
          f"decode steps on the card (flash {attn_layers(cfg)} launches) == "
          f"on the CPU (max abs err {err:.3e}, tolerance {LM_TOL}); tokens "
          f"routed differently (near-ties): {n_diff}")
    return attn_layers(cfg)


def padded_head_dim_checks(dev) -> int:
    """Phase 4's part for the head dims the flash kernel runs on the next
    instantiation up (fault 3.5): PADDED_ARCHS' scaled() configs, the card
    == the CPU.  Returns their flash launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    launched = 0
    for arch, seed in PADDED_ARCHS:
        d = get_config(arch).scaled().head_dim
        launched += scaled_card_vs_cpu(
            dev, arch, seed, PADDED_CHECK,
            what=f"; the kernel's D={fa.kernel_dim(d)} instantiation")
    print(f"  padded head-dim checks took {time.perf_counter() - t0:.1f} s")
    return launched


def expert_recurrent_checks(dev) -> None:
    """Phase 4's part for the expert and recurrent blocks, one parameter
    set on the card at a time, all in float32 within LM_TOL: OLMoE-1B-7B
    at full width, prefill logits through the flash kernel (a launch a
    layer) == through its plain version, and prefill + decode steps ==
    the teacher-forced forward, each where both runs chose the same
    experts (every token routed differently must be a near-tie, their
    count printed); RWKV6-3B at full width, prefill + decode ==
    teacher-forced (no flash launch); Jamba at scaled() size with two
    pattern repeats, prefill + decode on the card == on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import moe, transformer
    from repro_torch.optim.optimizers import tree_leaves

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config(MOE_ARCH).with_(dtype="float32")
    params = transformer.init_params(cfg, seed=3, device=dev)
    nparams = sum(p.numel() for p in tree_leaves(params))
    b, s, k = MOE_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + k),
                         generator=torch.Generator().manual_seed(6),
                         dtype=torch.int32).to(dev)
    n = moe_layers(cfg)
    logits, tables = {}, {}
    for plain in (False, True):
        ctx = plain_attention() if plain else contextlib.nullcontext()
        ops.reset_launch_counts()
        with ctx, moe.record_routes() as rec:
            h, _, _ = transformer.forward(params, cfg,
                                          {"tokens": toks[:, :s]},
                                          mode="prefill")
            logits[plain] = transformer.lm_logits(params, cfg, h)
        launched = ops.launch_counts()["flash_attention"]
        if launched != (0 if plain else attn_layers(cfg)):
            raise AssertionError(f"{MOE_ARCH} prefill (plain={plain}) "
                                 f"launched flash attention {launched} "
                                 f"times")
        tables[plain] = moe.route_table(rec, [(0, s)], n)
    del h
    first, n_diff = moe.route_divergence(tables[False], tables[True])
    err = routed_err(logits[False], logits[True], first, range(s), LM_TOL,
                     f"{MOE_ARCH} prefill logits, kernel vs plain")
    print(f"  {MOE_ARCH} float32 ({nparams / 1e9:.3f} B params, {n} MoE "
          f"layers of {cfg.moe.num_experts} experts, top-{cfg.moe.top_k}), "
          f"B={b}, S={s}: prefill logits through the kernel "
          f"({attn_layers(cfg)} launches) == through its plain version "
          f"(max abs err {err:.3e}, tolerance {LM_TOL}; logits max "
          f"{float(logits[True].abs().max()):.3f}); tokens routed "
          f"differently (near-ties): {n_diff}")
    del logits
    err, n_diff, agree = decode_vs_teacher(params, cfg, toks, s, k, MOE_ARCH)
    print(f"  {MOE_ARCH} float32: prefill {s} + {k} decode steps == the "
          f"teacher-forced forward (chunked attention) at positions "
          f"{s - 1}..{s + k - 1} (max abs err {err:.3e}, tolerance "
          f"{LM_TOL}; argmax agreement {agree:.3f}); tokens routed "
          f"differently (near-ties): {n_diff}")
    del params, toks
    torch.cuda.empty_cache()

    cfg = get_config(RWKV_ARCH).with_(dtype="float32")
    params = transformer.init_params(cfg, seed=4, device=dev)
    nparams = sum(p.numel() for p in tree_leaves(params))
    b, s, k = RWKV_CHECK
    toks = torch.randint(0, cfg.vocab_size, (b, s + k),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32).to(dev)
    ops.reset_launch_counts()
    err, _, agree = decode_vs_teacher(params, cfg, toks, s, k, RWKV_ARCH)
    if ops.launch_counts()["flash_attention"]:
        raise AssertionError(f"{RWKV_ARCH} launched flash attention")
    print(f"  {RWKV_ARCH} float32 ({nparams / 1e9:.3f} B params, "
          f"{cfg.num_layers} rwkv blocks, per-token WKV), B={b}: prefill "
          f"{s} + {k} decode steps == the teacher-forced forward (max abs "
          f"err {err:.3e}, tolerance {LM_TOL}; argmax agreement "
          f"{agree:.3f}); no flash launch")
    del params, toks
    torch.cuda.empty_cache()

    scaled_card_vs_cpu(dev, HYBRID_ARCH, 5, HYBRID_CHECK, repeats=2)
    print(f"  expert and recurrent checks took "
          f"{time.perf_counter() - t0:.1f} s")


def lm_serves(card):
    """Phase 5's part: ``repro_torch.launch.serve.main`` at full width
    (bf16 activations, float32 parameters) on OLMoE-1B-7B, on RWKV6-3B
    (prompt 128) and on MusicGen-medium (4-codebook prompts, every id a
    codebook id), the flash kernel launched once an attention layer of
    each prefill (never for RWKV6) and nothing else.  Returns ({arch:
    report}, the flash launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm
    reports, flash = {}, 0
    torch.cuda.empty_cache()
    for argv in (MOE_SERVE, RWKV_SERVE, MUSIC_SERVE):
        opts = dict(zip(argv[::2], argv[1::2]))
        arch, gen_len = opts["--arch"], int(opts["--gen-len"])
        cfg = get_config(arch)
        t0 = time.perf_counter()
        ops.reset_launch_counts()
        with quiet():
            report = lm.main(list(argv))
        counts = ops.launch_counts()
        want = {k: 0 for k in counts}
        want["flash_attention"] = attn_layers(cfg) * len(report.prefill_ms)
        if counts != want:
            raise AssertionError(f"{arch} serve launches {counts}, want "
                                 f"{want}")
        if sorted(report.tokens) != list(range(int(opts["--requests"]))) \
                or any(len(t) != gen_len
                       or not all(0 <= x < cfg.vocab_size for x in t)
                       for t in report.tokens.values()):
            raise AssertionError(f"{arch} serve: missing requests or bad "
                                 f"token ids")
        print(f"  LM serve {arch} ({cfg.dtype} activations, "
              f"{cfg.param_dtype} params; {report.served} requests, slots "
              f"of {opts['--batch']}, prompt {opts['--prompt-len']}, "
              f"{gen_len} tokens): {report.tokens_per_s:.2f} tok/s; "
              f"prefill {[round(x, 3) for x in report.prefill_ms]} ms by "
              f"batch, decode "
              f"{[round(x, 3) for x in report.decode_ms_per_token]} "
              f"ms/token by batch; flash_attention launched "
              f"{counts['flash_attention']} times = {attn_layers(cfg)} per "
              f"prefill; took {time.perf_counter() - t0:.1f} s (first "
              f"serve, parameter init included) [{card.smi}]")
        reports[arch] = report
        flash += counts["flash_attention"]
        torch.cuda.empty_cache()
    return reports, flash


def codebook_vlm_checks(dev) -> None:
    """Phase 4's part for MusicGen's codebooks and the VLM batch, one
    parameter set on the card at a time, in float32 within LM_TOL:
    MusicGen-medium and Qwen2-VL-2B at full width, prefill logits through
    the flash kernel (a launch a layer) == through its plain version, and
    prefill + decode steps == the teacher-forced forward (chunked
    attention).  MusicGen runs on 4-codebook tokens to (B, S, 4) logits;
    Qwen2-VL on ``vlm_batch_for_step``'s embeds and M-RoPE grid, its
    decode steps at (s+i, s+i, s+i) and the teacher at the same
    positions."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.optim.optimizers import tree_leaves

    t0 = time.perf_counter()
    for arch, (b, s, k), seed in ((MUSIC_ARCH, MUSIC_CHECK, 3),
                                  (VLM_ARCH, VLM_CHECK, 4)):
        torch.cuda.empty_cache()
        cfg = get_config(arch).with_(dtype="float32")
        params = transformer.init_params(cfg, seed=seed, device=dev)
        nparams = sum(p.numel() for p in tree_leaves(params))
        positions = None
        if cfg.embed_inputs:
            lane = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
            inputs = torch.randint(
                0, cfg.vocab_size, (b, s + k) + lane,
                generator=torch.Generator().manual_seed(seed + 3),
                dtype=torch.int32).to(dev)
            prompt = {"tokens": inputs[:, :s]}
        else:
            batch = dtok.vlm_batch_for_step(cfg, 0, global_batch=b,
                                            seq_len=s + k, device=dev)
            inputs, positions = batch["embeds"], batch["positions"][:, :s]
            prompt = {"embeds": inputs[:, :s], "positions": positions}
        logits = {}
        for plain in (False, True):
            ctx = plain_attention() if plain else contextlib.nullcontext()
            ops.reset_launch_counts()
            with ctx:
                h, _, _ = transformer.forward(params, cfg, prompt,
                                              mode="prefill")
                logits[plain] = transformer.lm_logits(params, cfg, h)
            del h
            launched = ops.launch_counts()["flash_attention"]
            if launched != (0 if plain else attn_layers(cfg)):
                raise AssertionError(f"{arch} prefill (plain={plain}) "
                                     f"launched flash attention {launched} "
                                     f"times, want {attn_layers(cfg)}")
        err = close_err(logits[False], logits[True], LM_TOL)
        what = (f"{cfg.num_codebooks} codebooks of {cfg.vocab_size}"
                if cfg.num_codebooks > 1 else
                f"embeds and M-RoPE grid {cfg.mrope_sections}")
        print(f"  {arch} float32 ({nparams / 1e9:.3f} B params, "
              f"{cfg.num_layers} layers, H={cfg.num_heads} "
              f"KH={cfg.num_kv_heads} D={cfg.head_dim}; {what}), B={b}, "
              f"S={s}: prefill logits {tuple(logits[False].shape)} through "
              f"the kernel ({attn_layers(cfg)} launches) == through its "
              f"plain version (max abs err {err:.3e}, tolerance {LM_TOL}; "
              f"logits max {float(logits[True].abs().max()):.3f})")
        del logits
        err, _, agree = decode_vs_teacher(params, cfg, inputs, s, k, arch,
                                          positions)
        print(f"  {arch} float32: prefill {s} + {k} decode steps == the "
              f"teacher-forced forward (chunked attention) at positions "
              f"{s - 1}..{s + k - 1} (max abs err {err:.3e}, tolerance "
              f"{LM_TOL}; argmax agreement {agree:.3f})")
        del params, inputs, prompt
    torch.cuda.empty_cache()
    print(f"  codebook and VLM checks took {time.perf_counter() - t0:.1f} s")


def vlm_serve(card, dev):
    """Phase 5's part for Qwen2-VL-2B at full width (bf16 activations,
    float32 parameters), which has no input table: ``train.serve``'s
    steps on VLM_SERVE's batch (embeds prompts on the M-RoPE grid, then
    decode steps fed the batch's next embeds), the flash kernel launched
    once a layer of the prefill and nothing else; then the launcher
    refusing it.  The steps run twice, cold then warm.  Returns ({warm
    "prefill_ms" and "decode_ms", and the cold run's}, the flash
    launches)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as lm
    from repro_torch.models import transformer
    from repro_torch.train import serve

    cfg = get_config(VLM_ARCH)
    b, s, n = VLM_SERVE
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch = dtok.vlm_batch_for_step(cfg, 0, global_batch=b, seq_len=s + n,
                                    device=dev)
    emb = batch["embeds"]
    prefill = serve.build_prefill_step(cfg, max_len=s + n)
    decode = serve.build_decode_step(cfg)
    ops.reset_launch_counts()
    runs = []
    for _ in range(2):          # a cold run (first calls), then a warm one
        torch.cuda.synchronize(dev)
        t_pf = time.perf_counter()
        logits, cache = prefill(
            params, {"embeds": emb[:, :s],
                     "positions": batch["positions"][:, :s]})
        ids = [serve.sample(None, logits)]
        torch.cuda.synchronize(dev)
        t_dc = time.perf_counter()
        for i in range(n):
            logits, cache = decode(params, cache, emb[:, s + i][:, None],
                                   s + i)
            ids.append(serve.sample(None, logits))
        ids = torch.cat(ids, dim=1).cpu()
        t_end = time.perf_counter()
        if tuple(ids.shape) != (b, n + 1) or not bool(
                ((ids >= 0) & (ids < cfg.vocab_size)).all()):
            raise AssertionError(f"{VLM_ARCH} serve: ids "
                                 f"{tuple(ids.shape)} outside [0, "
                                 f"{cfg.vocab_size})")
        runs.append(((t_dc - t_pf) * 1e3, (t_end - t_dc) * 1e3 / n))
    counts = ops.launch_counts()
    want = {k: 0 for k in counts}
    want["flash_attention"] = attn_layers(cfg) * len(runs)
    if counts != want:
        raise AssertionError(f"{VLM_ARCH} serve launches {counts}, want "
                             f"{want}")
    (cold_pf, cold_dc), (pf_ms, dc_ms) = runs
    print(f"  VLM serve {VLM_ARCH} through train.serve's steps ({cfg.dtype} "
          f"activations, {cfg.param_dtype} params; B={b}, a {s}-position "
          f"embeds prompt on the M-RoPE grid, {n} decode steps fed the "
          f"batch's next embeds; a cold run, then a warm one): prefill "
          f"{cold_pf:.3f} / {pf_ms:.3f} ms, decode {cold_dc:.3f} / "
          f"{dc_ms:.3f} ms a step ({b * 1e3 / dc_ms:.2f} tok/s decoding, "
          f"warm); flash_attention launched {counts['flash_attention']} "
          f"times = {attn_layers(cfg)} per prefill, nothing else; took "
          f"{time.perf_counter() - t0:.1f} s (parameter init included) "
          f"[{card.smi}]")
    out = {"prefill_ms": pf_ms, "decode_ms": dc_ms,
           "cold_prefill_ms": cold_pf, "cold_decode_ms": cold_dc}
    flash = counts["flash_attention"]
    del params, cache, batch, emb, logits
    torch.cuda.empty_cache()
    try:
        with quiet():
            lm.main(["--arch", VLM_ARCH])
    except ValueError as e:
        print(f"  launch.serve --arch {VLM_ARCH} refuses: {e}")
    else:
        raise AssertionError(f"launch.serve served {VLM_ARCH}'s stub")
    return out, flash


def codebook_vlm_train(card, dev) -> None:
    """Phase 6b's part: ``repro_torch.launch.train.main`` on MusicGen-
    medium and Qwen2-VL-2B at full width in their own dtypes, CB_TRAIN's
    adamw steps (the VLM on ``vlm_batch_for_step``'s embeds), each step
    timed by the host clock around a synchronised step, the losses
    finite; then one adamw step of each at scaled() on the card == the
    CPU's within ``optimizers.step_tolerance``, with the gradients'
    rounding level carried through Adam's first step (``adam_eps``:
    Qwen2-VL's key bias has gradients of a few eps)."""
    import inspect

    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.device import to_device
    from repro_torch.launch import train as lt
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import steps

    real = steps.build_train_step
    for arch in (MUSIC_ARCH, VLM_ARCH):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = []

        def timed(cfg, optimizer):
            step = real(cfg, optimizer)

            def run(state, batch):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(state, batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t) * 1e3)
                return out
            return run

        t0 = time.perf_counter()
        steps.build_train_step = timed
        try:
            with quiet():
                state, losses = lt.main(["--arch", arch, *CB_TRAIN])
        finally:
            steps.build_train_step = real
        nparams = sum(p.numel() for p in opt.tree_leaves(state["params"]))
        del state
        torch.cuda.empty_cache()
        n_steps = int(CB_TRAIN[1])
        if len(losses) != n_steps or not all(np.isfinite(losses)):
            raise AssertionError(f"{arch} training losses {losses}")
        cfg = get_config(arch)
        print(f"  launch.train {arch} ({nparams / 1e9:.3f} B params, "
              f"{cfg.dtype} activations, {cfg.param_dtype} params, "
              f"{'VLM batch' if not cfg.embed_inputs else 'token batch'}), "
              f"adamw, {' '.join(CB_TRAIN)}: losses "
              f"{[round(v, 4) for v in losses]}; ms a step (host clock, "
              f"synchronised) {[round(v, 1) for v in ms]}; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB; took "
              f"{time.perf_counter() - t0:.1f} s [{card.smi}]")

    eps = inspect.signature(opt.adamw).parameters["eps"].default
    for arch in (MUSIC_ARCH, VLM_ARCH):
        small = get_config(arch).scaled().with_(dtype="float32",
                                                param_dtype="float32")
        sched = opt.cosine_schedule(1e-3, 2, 10)
        small_opt = opt.make("adamw", sched)
        cpu_state = steps.create_state(small, 3, small_opt, device="cpu")
        batch_fn = (dtok.batch_for_step if small.embed_inputs
                    else dtok.vlm_batch_for_step)
        batch = batch_fn(small, 0, global_batch=4, seq_len=64, device="cpu")
        out = {}
        for where in ("cpu", dev):
            st = to_device(cpu_state, torch.device(where))
            out[str(where)] = steps.build_train_step(small, small_opt)(
                st, {k: v.to(where) for k, v in batch.items()})
        _, grads = opt.value_and_grad(
            lambda p: steps.make_loss_fn(small)(p, batch),
            cpu_state["params"])
        clip = min(1.0, 1.0 / max(float(out["cpu"][1]["grad_norm"]), 1e-9))
        want = out["cpu"][0]["params"]
        bounds = opt.step_tolerance(
            want, opt.tree_map(lambda g: g * clip, grads), float(sched(0)),
            adam_eps=eps)
        worst = 0.0
        for w, g, bd in zip(opt.tree_leaves(want),
                            opt.tree_leaves(out[str(dev)][0]["params"]),
                            opt.tree_leaves(bounds)):
            diff = (g.cpu() - w).abs()
            if not bool(diff.le(bd).all()):
                raise AssertionError(f"{arch} scaled() step on the card off "
                                     f"the CPU's by {float(diff.max())}")
            worst = max(worst, float((diff / bd).max()))
        dl = abs(float(out[str(dev)][1]["loss"])
                 - float(out["cpu"][1]["loss"]))
        if dl > LM_TOL * (1 + abs(float(out["cpu"][1]["loss"]))):
            raise AssertionError(f"{arch} scaled() step loss: card - CPU = "
                                 f"{dl}")
        print(f"  {arch} scaled() adamw step ({small.num_layers} layers, "
              f"head dim {small.head_dim}, chunked attention): card == CPU "
              f"within step_tolerance (adam_eps {eps}; worst {worst:.3f} of "
              f"the bound), loss |card - CPU| {dl:.2e}")


def mesh_phase(dev) -> int:
    """Phase 9: the training meshes at world size 1.  The host mesh over
    the one card on a one-rank process group (gloo, a localhost
    rendezvous); every leaf of SmolLM-360M's train state (adamw) shards to
    its full shape; one full-width training step (MESH_STEP, bf16
    activations) under ``mesh_context(make_host_mesh())`` equals, bit for
    bit, the same step outside it (every leaf of the new state and the
    loss).  Then the sharded step (:func:`sharded_checks`); returns its
    flash launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import steps

    t0 = time.perf_counter()
    cfg = get_config(LM_ARCH)
    optimizer = opt.make("adamw", opt.cosine_schedule(3e-4, warmup=100,
                                                      total=10000))
    b, sq = MESH_STEP
    batch = tokens.batch_for_step(cfg, 0, global_batch=b, seq_len=sq,
                                  device=dev)
    step = steps.build_train_step(cfg, optimizer)
    mesh = mesh_lib.make_host_mesh()
    if dict(mesh.shape) != {"data": 1, "model": torch.cuda.device_count()}:
        raise AssertionError(f"host mesh {dict(mesh.shape)}")

    def run():
        new, metrics = step(steps.create_state(cfg, 0, optimizer,
                                               device=dev), batch)
        torch.cuda.synchronize()
        return new, metrics["loss"]

    with dctx.local_process_group():
        dmesh = shd.device_mesh(mesh)
        named = dict(shd.leaves_with_path(shd.to_named(
            mesh, steps.state_specs(cfg, mesh, optimizer), dmesh)))
        leaves = shd.leaves_with_path(steps.state_shape(cfg, optimizer))
        for path, leaf in leaves:
            got = named[path].shard_shape(leaf.shape, leaf.dtype)
            if got != tuple(leaf.shape):
                raise AssertionError(f"{path}: shard {got} of "
                                     f"{tuple(leaf.shape)} at world size 1")
        with dctx.mesh_context(mesh):
            inside, loss_in = run()
    inside = {p: x.detach().cpu() for p, x in shd.leaves_with_path(inside)}
    outside, loss_out = run()
    differ = [p for p, x in shd.leaves_with_path(outside)
              if not torch.equal(x.detach().cpu(), inside[p])]
    if differ or not torch.equal(loss_in, loss_out):
        raise AssertionError(f"the step under the host mesh differs from "
                             f"the step without: {differ[:4]}, loss "
                             f"{float(loss_in)} vs {float(loss_out)}")
    del inside, outside
    torch.cuda.empty_cache()
    print(f"  host mesh {dict(mesh.shape)} over {dmesh.device_type}, one "
          f"rank: {len(leaves)} state leaves shard to their full shapes; "
          f"{LM_ARCH} adamw step {b} x {sq} under the mesh == without it, "
          f"bit for bit (loss {float(loss_in):.6f})")
    n_flash = sharded_checks(dev, cfg, optimizer, step, batch, mesh)
    print(f"  phase 9 took {time.perf_counter() - t0:.1f} s")
    return n_flash


def fake_group_counts(dev, scfg, shape, on_card_hook=None):
    """``shape``'s step of config ``scfg`` on a fake group of 8 ranks over
    SHARDED_MESH, counted on meta and then on arguments built on the card
    (the state or parameters from seed 0, zero tokens, an empty cache;
    the decode's token at the cache's last position), each placed as the
    DTensors of its specs: the two counts equal, exactly (FLOPs, bytes,
    wire bytes), and every block on the card.  ``on_card_hook`` wraps the
    card's count (a context manager).  Returns the card's count and the
    meta count."""
    import contextlib
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.configs import shapes as shp
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    from repro_torch.train import steps

    smesh = mesh_lib.make_mesh_for(math.prod(SHARDED_MESH),
                                   SHARDED_MESH[1], abstract=True)
    with dctx.fake_process_group(smesh.size):
        dmesh = shd.device_mesh(smesh)
        step_fn, meta_args, _ = dryrun.sharded_step_and_args(
            scfg, shape, smesh)
        with dctx.sharded_step(smesh):
            on_meta = op_cost.count(step_fn, *meta_args)
        place = lambda tree, specs: shd.distribute(
            tree, shd.to_named(smesh, specs, dmesh))
        toks = {k: torch.zeros(v.shape, dtype=v.dtype, device=dev)
                for k, v in shp.input_specs(scfg, shape).items()}
        if shape.step == "train":
            optimizer = dryrun.build_optimizer(scfg)
            state = steps.create_state(scfg, 0, optimizer, device=dev)
            args = (place(state, steps.state_specs(scfg, smesh, optimizer)),
                    place(toks, shd.batch_specs(scfg, smesh, toks)))
        else:
            params = transformer.init_params(scfg, seed=0, device=dev)
            args = (place(params, shd.param_specs(scfg, smesh, params)),)
            if shape.step == "prefill":
                args += (place(toks, shd.batch_specs(scfg, smesh, toks)),)
            else:
                cache = transformer.init_cache(scfg, shape.global_batch,
                                               shape.seq_len, device=dev)
                tok = {"t": list(toks.values())[0]}
                args += (place(cache, shd.cache_specs(scfg, smesh, cache)),
                         place(tok, shd.batch_specs(scfg, smesh, tok))["t"],
                         shape.seq_len - 1)
        blocks = {t.to_local().device.type
                  for _, t in shd.leaves_with_path(args)
                  if hasattr(t, "to_local")}
        with (on_card_hook or contextlib.nullcontext)():
            with dctx.sharded_step(smesh):
                on_card = op_cost.count(step_fn, *args)
        torch.cuda.synchronize()
    if blocks != {"cuda"}:
        raise AssertionError(f"the fake group's blocks lie on {blocks}")
    if ((on_card.flops, on_card.bytes, on_card.coll_wire_bytes)
            != (on_meta.flops, on_meta.bytes, on_meta.coll_wire_bytes)):
        raise AssertionError(
            f"the sharded {scfg.name} {shape.name} counted on the card "
            f"({on_card.flops:.6e} FLOPs, {on_card.bytes:.6e} bytes, "
            f"{on_card.coll_wire_bytes} wire) != on meta "
            f"({on_meta.flops:.6e}, {on_meta.bytes:.6e}, "
            f"{on_meta.coll_wire_bytes})")
    return on_card, on_meta


def _counts(cost) -> str:
    return (f"one device's {cost.flops:.6e} FLOPs, {cost.bytes:.6e} "
            f"bytes, {cost.coll_wire_bytes:.6e} wire bytes "
            f"{({k: v for k, v in cost.coll_breakdown.items() if v})}")


def fake_group_prefill(dev, h: int, kh: int, arch: str = LM_ARCH) -> int:
    """A prefill of ``arch``'s scaled() config at ``h`` q and ``kh`` KV
    heads on the fake group (:func:`fake_group_counts`, card == meta).
    Where the config takes flash, the kernel launched once an attention
    layer on this rank's blocks (the batch over "data", torch.chunk's
    blocks of the heads over "model", each with the KV heads it reads);
    where its heads divide the model devices m > 1 ways on the chunked
    path, each layer's attention through
    ``attention.query_row_attention`` (each head's query rows shared by
    its m devices).  Returns the flash launches."""
    import contextlib
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    scfg = get_config(arch).scaled().with_(num_heads=h, num_kv_heads=kh)
    b, sq = SHARDED_PREFILL
    flash = all(attention.uses_flash(scfg, k) for k in scfg.pattern)
    rows = [0]
    by_rows = attention.query_row_attention

    def counted(*a, **kw):
        rows[0] += 1
        return by_rows(*a, **kw)

    @contextlib.contextmanager
    def counting():
        attention.query_row_attention = counted
        try:
            yield
        finally:
            attention.query_row_attention = by_rows
    ops.reset_launch_counts()
    on_card, _ = fake_group_counts(
        dev, scfg, shp.ShapeSpec("prefill_sharded", sq, b, "prefill"),
        counting)
    n_flash = ops.launch_counts()["flash_attention"]
    m = SHARDED_MESH[1] // h if SHARDED_MESH[1] % h == 0 else 1
    want = ((attn_layers(scfg), 0) if flash
            else (0, attn_layers(scfg) if m > 1 else 0))
    if (n_flash, rows[0]) != want:
        raise AssertionError(f"{n_flash} flash launches and {rows[0]} "
                             f"query-row attentions in the sharded prefill, "
                             f"want {want}")
    q_heads = shd.chunk_ranges(h, SHARDED_MESH[1])
    split = (f"each head's query rows over {m} model devices "
             f"({rows[0]} layers)" if rows[0] else
             f"q heads {[y - x for x, y in q_heads]} over the model devices")
    print(f"  {arch} scaled() H={h} KH={kh} prefill {b} x {sq} on a fake "
          f"group of {math.prod(SHARDED_MESH)} over {SHARDED_MESH}, blocks "
          f"on the card: {_counts(on_card)} == on meta; flash launched "
          f"{n_flash} times on each rank's blocks (batch / "
          f"{SHARDED_MESH[0]}, {split})")
    return n_flash


def fake_group_train(dev) -> int:
    """One training step of SmolLM-360M's scaled() config at
    SHARDED_HEADS with ``remat`` on (each pattern repeat recomputed in
    the backward, ``placed_matmul``'s Functions and the collectives of a
    repeat run again there) on the fake group (:func:`fake_group_counts`,
    card == meta).  Returns the flash launches."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops

    h, kh = SHARDED_HEADS
    scfg = get_config(LM_ARCH).scaled().with_(num_heads=h, num_kv_heads=kh,
                                              remat=True)
    b, sq = SHARDED_TRAIN
    ops.reset_launch_counts()
    on_card, on_meta = fake_group_counts(
        dev, scfg, shp.ShapeSpec("train_sharded", sq, b, "train"))
    n_flash = ops.launch_counts()["flash_attention"]
    print(f"  {LM_ARCH} scaled() H={h} KH={kh} adamw train step {b} x {sq} "
          f"at remat=True on the fake group, blocks on the card: "
          f"{_counts(on_card)} == on meta; flash launched {n_flash} times; "
          f"peak_bytes card {on_card.peak_bytes / 1e6:.3f} MB, meta "
          f"{on_meta.peak_bytes / 1e6:.3f} MB")
    return n_flash


def fake_group_decode(dev) -> None:
    """A decode step of SmolLM-360M's scaled() config at a batch of one
    (cache SHARDED_DECODE_LEN) on the fake group (:func:`fake_group_counts`,
    card == meta): the batch leaves "data" idle, so each linear layer's
    weight splits its free dim over it and the output gathers
    (``sharding.gather_blocks``, counted)."""
    import contextlib
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd

    scfg = get_config(LM_ARCH).scaled()
    shape = shp.ShapeSpec("decode_b1", SHARDED_DECODE_LEN, 1, "decode")
    gathers = [0]
    gather = shd.gather_blocks

    def counted(*a, **kw):
        gathers[0] += 1
        return gather(*a, **kw)

    @contextlib.contextmanager
    def counting():
        shd.gather_blocks = counted
        try:
            yield
        finally:
            shd.gather_blocks = gather
    on_card, _ = fake_group_counts(dev, scfg, shape, counting)
    if not gathers[0]:
        raise AssertionError("the decode at B=1 split no weight over the "
                             "idle data axis")
    print(f"  {LM_ARCH} scaled() decode at B=1 (cache "
          f"{SHARDED_DECODE_LEN}) on the fake group, blocks on the card: "
          f"{gathers[0]} products split over the idle \"data\" axis and "
          f"gathered; {_counts(on_card)} == on meta")


def fake_group_step(dev, arch: str, step: str, b: int, sq: int) -> None:
    """A ``step`` ("train" or "decode") of ``arch``'s scaled() config at
    batch ``b`` and sequence (or cache) ``sq`` on the fake group
    (:func:`fake_group_counts`, card == meta)."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config

    on_card, _ = fake_group_counts(
        dev, get_config(arch).scaled(),
        shp.ShapeSpec(f"{step}_sharded", sq, b, step))
    print(f"  {arch} scaled() {step} {b} x {sq} on the fake group, blocks on "
          f"the card: {_counts(on_card)} == on meta")


def sharded_checks(dev, cfg, optimizer, step, batch, mesh) -> int:
    """Phase 9's sharded counts.  (1) The full-width training step on
    DTensors of the state's specs over the host mesh (1, 1), on a
    one-rank NCCL group: counted on the card == the plain
    step's count (FLOPs and bytes, exactly; no wire bytes), and its new
    state and loss == the plain step's, bit for bit.  (2) Prefills of
    SmolLM-360M's scaled() config on a fake group of 8 ranks over the
    (2, 4) mesh, its blocks on the card (:func:`fake_group_prefill`), at
    SHARDED_HEADS and at SHARDED_UNEVEN_HEADS, whose q heads do not
    divide the model axis, and Gemma2-2B's at SHARDED_ROWS, whose heads
    share the model devices by query rows; a decode step at a batch of
    one, the weights split over the idle "data" axis
    (:func:`fake_group_decode`); a training step at ``remat=True``
    (:func:`fake_group_train`); RWKV-6's and Gemma2-2B's steps of
    SHARDED_STEPS (:func:`fake_group_step`); and flash on a block of no
    heads,
    returned empty with no launch.  (3) The dry run's POD_CELL on the
    256-chip mesh, on meta, printed beside this tree's count on the CPU
    (POD_CELL_CPU_FLOPS).  Returns (2)'s flash launches."""
    from repro_torch.distributed import context as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.train import steps

    state = steps.create_state(cfg, 0, optimizer, device=dev)
    plain = op_cost.count(step, state, batch)
    new, metrics = step(state, batch)
    torch.cuda.synchronize()
    with dctx.local_process_group(COLLECTIVE_BACKEND):
        dmesh = shd.device_mesh(mesh)
        dstate = shd.distribute(state, shd.to_named(
            mesh, steps.state_specs(cfg, mesh, optimizer), dmesh))
        dbatch = shd.distribute(batch, shd.to_named(
            mesh, shd.batch_specs(cfg, mesh, batch), dmesh))
        with dctx.sharded_step(mesh):
            counted = op_cost.count(step, dstate, dbatch)
            dnew, dmetrics = step(dstate, dbatch)
        got = {p: x.full_tensor() for p, x in shd.leaves_with_path(dnew)}
        loss = dmetrics["loss"].full_tensor()
        torch.cuda.synchronize()
    if (counted.flops, counted.bytes) != (plain.flops, plain.bytes):
        raise AssertionError(
            f"the (1, 1) mesh's DTensor step counts {counted.flops:.6e} "
            f"FLOPs, {counted.bytes:.6e} bytes; the plain step "
            f"{plain.flops:.6e}, {plain.bytes:.6e}")
    if counted.coll_wire_bytes:
        raise AssertionError(f"wire bytes {counted.coll_wire_bytes} on one "
                             f"device")
    differ = [p for p, x in shd.leaves_with_path(new)
              if not torch.equal(x, got[p])]
    if differ or not torch.equal(loss, metrics["loss"]):
        raise AssertionError(f"the DTensor step differs from the plain "
                             f"step: {differ[:4]}, loss {float(loss)} vs "
                             f"{float(metrics['loss'])}")
    del state, new, dstate, dnew, got
    torch.cuda.empty_cache()
    print(f"  (1, 1) mesh, one-rank NCCL group: {LM_ARCH}'s DTensor adamw "
          f"step counted on the card {counted.flops:.6e} FLOPs, "
          f"{counted.bytes:.6e} bytes == the plain step's, its state and "
          f"loss ({float(loss):.6f}) == the plain step's, bit for bit")

    n_flash = 0
    for h, kh in (SHARDED_HEADS, SHARDED_UNEVEN_HEADS):
        n_flash += fake_group_prefill(dev, h, kh)
    arch, h, kh = SHARDED_ROWS
    n_flash += fake_group_prefill(dev, h, kh, arch)
    fake_group_decode(dev)
    n_flash += fake_group_train(dev)
    for arch, kind, b, sq in SHARDED_STEPS:
        fake_group_step(dev, arch, kind, b, sq)
    # the block of no heads a device holds where the heads do not fill
    # the devices: returned empty, nothing launched
    ops.reset_launch_counts()
    empty = torch.zeros((2, 64, 0, 32), device=dev, dtype=torch.bfloat16)
    out = fa.flash_attention(empty, empty, empty)
    if out.shape != empty.shape or ops.launch_counts()["flash_attention"]:
        raise AssertionError(f"flash on a block of no heads: {out.shape}, "
                             f"{ops.launch_counts()['flash_attention']} "
                             f"launches")
    print(f"  flash on a block of no heads {tuple(empty.shape)}: empty, "
          f"no launch")

    t = time.perf_counter()
    rec = dryrun.lower_cell(*POD_CELL, mesh_name="pod")
    if rec["status"] != "OK" or not rec["step_counted"]:
        raise AssertionError(f"pod cell {POD_CELL}: {rec}")
    print(f"  dry run {POD_CELL[0]} {POD_CELL[1]} on pod ({rec['chips']} "
          f"chips, meta, {time.perf_counter() - t:.1f} s): one device "
          f"{rec['hlo_flops'] / rec['chips']:.6e} FLOPs, "
          f"{rec['hlo_bytes'] / rec['chips']:.6e} bytes, "
          f"{rec['coll_bytes_per_chip']:.6e} wire bytes "
          f"{ {k: v for k, v in rec['coll_breakdown'].items() if v} }; "
          f"t_compute {rec['t_compute']:.4f} s, t_memory "
          f"{rec['t_memory']:.4f} s, t_collective {rec['t_collective']:.4f}"
          f" s ({rec['bottleneck']}), roofline_fraction "
          f"{rec['roofline_fraction']:.4f}")
    flops = rec["hlo_flops"] / rec["chips"]
    print(f"  {POD_CELL[0]} {POD_CELL[1]} pod FLOPs a device: "
          f"{flops:.6e} with torch {torch.__version__} here, "
          f"{POD_CELL_CPU_FLOPS:.6e} with torch 2.13.0+cpu on the CPU "
          f"(ratio {flops / POD_CELL_CPU_FLOPS:.4f})")
    return n_flash


def scan_cost_checks(card, dev) -> int:
    """Phase 8's trip-count checks: each of SCAN_STEPS counted on the card
    by ``launch.op_cost`` (every iteration of the per-token recurrence
    runs) == counted on meta (``op_cost.scan``: four iterations, the
    middle one's charges scaled), FLOPs and bytes exactly.  Returns the
    flash launches inside the card's counts."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, op_cost
    from repro_torch.models import transformer
    from repro_torch.train import steps

    flash = 0
    for arch, step, seq, batch, scaled in SCAN_STEPS:
        cfg = get_config(arch)
        cfg = cfg.scaled() if scaled else cfg
        shape = shp.ShapeSpec(f"{step} {batch}x{seq}", seq, batch, step)
        fn, meta_args = dryrun.step_and_args(cfg, shape)
        t0 = time.perf_counter()
        meta = op_cost.count(fn, *meta_args)
        t_meta = time.perf_counter() - t0
        del meta_args
        torch.cuda.empty_cache()
        toks = dtok.batch_for_step(cfg, 0, global_batch=batch, seq_len=seq,
                                   device=dev)
        if step == "train":
            optimizer = dryrun.build_optimizer(cfg)
            args = (steps.create_state(cfg, 0, optimizer, device=dev), toks)
        else:
            args = (transformer.init_params(cfg, seed=0, device=dev),
                    {"tokens": toks["tokens"]})
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cost = op_cost.count(fn, *args)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        n_flash = ops.launch_counts()["flash_attention"]
        flash += n_flash
        del args
        torch.cuda.empty_cache()
        what = f"{arch}{' scaled()' if scaled else ''} {shape.name}"
        if (cost.flops, cost.bytes) != (meta.flops, meta.bytes):
            raise AssertionError(
                f"{what}: the card counts {cost.flops:.6e} FLOPs, "
                f"{cost.bytes:.6e} bytes eagerly; meta scaled "
                f"{meta.flops:.6e}, {meta.bytes:.6e}")
        print(f"  {what}: {cost.flops:.6e} FLOPs, {cost.bytes:.6e} bytes "
              f"counted eagerly on the card ({seq} iterations a recurrent "
              f"layer, {t_card:.1f} s; flash launches {n_flash}) == scaled "
              f"on meta ({t_meta:.1f} s); peak_bytes card "
              f"{cost.peak_bytes / 1e9:.3f} GB, meta "
              f"{meta.peak_bytes / 1e9:.3f} GB")
    return flash


def first_routed_apart(card_rec, cpu_rec, length: int) -> float:
    """The first token, in the flat (batch, position) order capacity slots
    follow, that the two runs of one MoE layer routed differently (each
    must be a near-tie: ``moe.route_divergence``), or inf.  A token
    routed apart moves every later token's slot, so only the ones before
    it compare."""
    from repro_torch.models import moe
    first, _ = moe.route_divergence(
        moe.route_table(card_rec, [(0, length)], 1),
        moe.route_table(cpu_rec, [(0, length)], 1))
    return min((r * length + p for r, p in first.items()),
               default=float("inf"))


def ep_checks(dev, mesh, cpu_mesh) -> list:
    """Phase 10's expert-parallel part on a one-rank mesh: one OLMoE-1B-7B
    MoE layer at full width in float32, prefill through apply_ep and
    decode through apply_ep_decode, each with and without the fp8
    dispatch: at capacity factor E / k == apply_dense on the card (within
    LM_TOL; fp8 within repro's mean bound), and at the config's factor ==
    the same path on the CPU (drops and all, within LM_TOL, before the
    first token the two routed apart, a near-tie).  Returns the lines it
    prints."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe

    cfg = get_config(MOE_ARCH).with_(dtype="float32", param_dtype="float32")
    m = cfg.moe
    params = moe.init(torch.Generator(device=dev).manual_seed(11), cfg,
                      device=dev)
    cpu_params = {k: v.cpu() for k, v in params.items()}
    gen = torch.Generator(device=dev).manual_seed(12)
    lines = []
    for path, (b, s) in ((moe.apply_ep, EP_PREFILL),
                         (moe.apply_ep_decode, EP_DECODE)):
        x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
        dense, _ = moe.apply_dense(params, cfg, x)
        for fp8 in (False, True):
            name = f"{path.__name__}{' fp8' if fp8 else ''} B={b} S={s}"
            free = cfg.with_(moe=dataclasses.replace(
                m, capacity_factor=EP_NO_DROP, dispatch_fp8=fp8))
            y, _ = path(params, free, x, mesh)
            if fp8 and path is moe.apply_ep:
                err = float((y - dense).abs().mean()
                            / (dense.abs().mean() + 1e-6))
                if not err < FP8_MEAN_REL:
                    raise AssertionError(f"{name}: mean rel err {err} vs "
                                         f"dense")
                no_drop = f"mean rel err {err:.3e} (bound {FP8_MEAN_REL})"
            else:
                no_drop = (f"max abs err "
                           f"{close_err(y, dense, LM_TOL):.3e}")
            own = cfg.with_(moe=dataclasses.replace(m, dispatch_fp8=fp8))
            with moe.record_routes() as rec_card:
                y_card, aux_card = path(params, own, x, mesh)
            with moe.record_routes() as rec_cpu:
                y_cpu, aux_cpu = path(cpu_params, own, x.cpu(), cpu_mesh)
            first = first_routed_apart(rec_card, rec_cpu, s)
            keep = int(min(first, b * s))
            if keep == 0:
                raise AssertionError(f"{name}: no token left to compare")
            d = cfg.d_model
            err = close_err(y_card.reshape(-1, d)[:keep].cpu(),
                            y_cpu.reshape(-1, d)[:keep], LM_TOL)
            aux_err = abs(float(aux_card) - float(aux_cpu))
            if aux_err > LM_TOL * max(1.0, abs(float(aux_cpu))):
                raise AssertionError(f"{name}: aux {float(aux_card)} vs the "
                                     f"CPU's {float(aux_cpu)}")
            lines.append(
                f"  {name}: capacity factor {EP_NO_DROP} == apply_dense on "
                f"the card ({no_drop}); factor {m.capacity_factor} == the "
                f"CPU's (max abs err {err:.3e} over {keep} of {b * s} "
                f"tokens, tolerance {LM_TOL}; aux err {aux_err:.3e})")
    return lines


def psum_checks(dev, mesh, cpu_mesh) -> str:
    """Phase 10's compressed psum at world size 1 over SmolLM-360M's
    gradient tree (random gradients in its parameters' shapes and types):
    every leaf's mean and residual == ``compress`` then ``decompress`` on
    the card, bit for bit, and == the same psum on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import context as dctx
    from repro_torch.models import transformer
    from repro_torch.optim import grad_compress as gc
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=dev).manual_seed(13)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=gen,
                                           device=dev).to(p.dtype),
                     transformer.init_params(cfg, device="meta"))
    err = gc.init_error_state(grads)
    with dctx.mesh_context(mesh):
        mean, new_err = gc.compressed_psum_tree(grads, err, "data")
    with dctx.mesh_context(cpu_mesh):
        cpu_mean, cpu_err = gc.compressed_psum_tree(
            tree_map(lambda t: t.cpu(), grads),
            tree_map(lambda t: t.cpu(), err), "data")
    n = 0
    for g, e, got, got_e, c, c_e in zip(
            *(tree_leaves(t) for t in (grads, err, mean, new_err, cpu_mean,
                                       cpu_err))):
        q, scale, want_e = gc.compress(g, e)
        want = gc.decompress(q, scale).to(g.dtype)
        if not (torch.equal(got, want) and torch.equal(got_e, want_e)
                and torch.equal(got.cpu(), c) and torch.equal(got_e.cpu(),
                                                              c_e)):
            raise AssertionError("compressed psum at world size 1 differs "
                                 "from compress + decompress or from the "
                                 "CPU's")
        n += g.numel()
    return (f"  compressed psum over {LM_ARCH}'s gradient tree "
            f"({len(tree_leaves(grads))} leaves, {n / 1e6:.1f} M values) at "
            f"world size 1 == compress + decompress on the card and == the "
            f"CPU's, bit for bit (max abs err 0)")


def pipeline_check(dev) -> str:
    """Phase 10's pipeline: one stage over a one-rank ``pod`` axis, M
    microbatches: the output and the stage's gradients == the stage
    applied to the whole batch (within LM_TOL: the microbatches' products
    are smaller GEMMs)."""
    from repro_torch.checkpoint.ckpt import make_mesh
    from repro_torch.distributed.pipeline import pipelined

    b, m, d = PIPE_CHECK
    gen = torch.Generator(device=dev).manual_seed(14)
    params = {"w": torch.randn((1, d, d), generator=gen, device=dev)
              / d ** 0.5,
              "b": torch.randn((1, d), generator=gen, device=dev) * 0.1}
    x = torch.randn((b, d), generator=gen, device=dev)

    def stage(p, h):
        return torch.tanh(h @ p["w"] + p["b"])
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    y = pipelined(stage, make_mesh((1, 1), ("pod", "data"), devices=[dev]),
                  m)(leaves, x)
    (y ** 2).sum().backward()
    ref = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = stage({k: v[0] for k, v in ref.items()}, x)
    (want ** 2).sum().backward()
    errs = [close_err(y.detach(), want.detach(), LM_TOL)] + [
        close_err(leaves[k].grad, ref[k].grad, LM_TOL) for k in params]
    return (f"  pipeline, 1 stage x {m} microbatches, B={b} D={d}: output "
            f"== the stage on the batch (max abs err {errs[0]:.3e}), "
            f"gradients w, b (max abs err {errs[1]:.3e}, {errs[2]:.3e}; "
            f"tolerance {LM_TOL})")


def collective_phase(card, dev) -> None:
    """Phase 10: the collectives and expert parallelism at world size 1,
    on a one-rank process group whose CUDA tensors go through NCCL (the
    backend a multi-card job takes) and whose CPU tensors through gloo
    (for the CPU's runs of the same paths): ``ep_checks``,
    ``psum_checks``, ``pipeline_check``."""
    from repro_torch.checkpoint.ckpt import make_mesh
    from repro_torch.distributed import context as dctx
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    with dctx.local_process_group(COLLECTIVE_BACKEND):
        mesh = mesh_lib.make_host_mesh()
        cpu_mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
        for line in ep_checks(dev, mesh, cpu_mesh):
            print(line)
        print(psum_checks(dev, mesh, cpu_mesh))
        print(pipeline_check(dev))
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  phase 10 took {time.perf_counter() - t0:.1f} s [{card.smi}]")


def cost_phase(card, dev) -> int:
    """Phase 8: the cost model on the card.  The dry run of SmolLM-360M's
    four cells (meta tensors, ``launch.dryrun``); then each of COST_STEPS
    with real parameters on the card: counted by ``launch.op_cost`` (FLOPs
    and bytes must equal the meta count at the same shape, and the
    prefills must launch the flash kernel once a layer), timed without the
    counter (a step in a CUDA graph where capture works, else CUDA events
    back to back), its roofline terms, bound share and MFU (the bound
    share must not pass BOUND_SHARE_MAX: no step runs faster than its
    bound), and the counter's peak live bytes beside
    ``max_memory_allocated``.  Returns the flash launches of the counted
    steps."""
    from repro_torch.configs import shapes as shp
    from repro_torch.configs.base import active_param_count
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, op_cost, roofline
    from repro_torch.launch.timing import events_ms, graph_ms
    from repro_torch.models import transformer
    from repro_torch.train import serve

    for name in shp.SHAPES:
        rec = dryrun.lower_cell(LM_ARCH, name)
        if rec["status"] != "OK":
            print(f"  dry run {LM_ARCH} {name}: {rec['status']} "
                  f"({rec['reason'][:60]}...)")
            continue
        print(f"  dry run {LM_ARCH} {name} (meta, traced in "
              f"{rec['trace_s']} s): {rec['hlo_flops']:.4e} FLOPs, "
              f"{rec['hlo_bytes']:.4e} bytes, t_compute "
              f"{rec['t_compute'] * 1e3:.3f} ms, t_memory "
              f"{rec['t_memory'] * 1e3:.3f} ms, {rec['bottleneck']}-bound, "
              f"roofline_fraction {rec['roofline_fraction']:.4f}, "
              f"useful_flops_ratio {rec['useful_flops_ratio']:.4f}, peak "
              f"{(rec['bytes_per_chip']['argument'] + rec['bytes_per_chip']['temp']) / 1e9:.2f} GB")

    flash, params = 0, {}
    for arch, step, seq, batch, over in COST_STEPS:
        cfg = get_config(arch).with_(**over)
        shape = shp.ShapeSpec(f"{step} {batch}x{seq}", seq, batch, step)
        fn, meta_args = dryrun.step_and_args(cfg, shape)
        meta = op_cost.count(fn, *meta_args)
        del meta_args
        if arch not in params:
            params.clear()
            torch.cuda.empty_cache()
            params[arch] = transformer.init_params(cfg, seed=0, device=dev)
        p = params[arch]
        if step == "train":
            optimizer = dryrun.build_optimizer(cfg)
            args = ({"params": p, "opt_state": optimizer.init(p),
                     "step": torch.zeros((), dtype=torch.int32, device=dev)},
                    dtok.batch_for_step(cfg, 0, global_batch=batch,
                                        seq_len=seq, device=dev))
        else:
            prompt = seq if step == "prefill" else LM_PROMPT
            toks = dtok.batch_for_step(cfg, 0, global_batch=batch,
                                       seq_len=prompt, device=dev)["tokens"]
            args = (p, {"tokens": toks})
            if step == "decode":
                logits, cache = serve.build_prefill_step(cfg, max_len=seq)(
                    *args)
                args = (p, cache, serve.sample(None, logits), prompt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        cost = op_cost.count(fn, *args)
        torch.cuda.synchronize()
        max_alloc = torch.cuda.max_memory_allocated()
        n_flash = ops.launch_counts()["flash_attention"]
        flash += n_flash
        what = f"{arch} {shape.name}" + (
            f" remat={cfg.remat}" if step == "train" else "")
        if (cost.flops, cost.bytes) != (meta.flops, meta.bytes):
            raise AssertionError(
                f"{what}: the card counts {cost.flops:.6e} FLOPs, "
                f"{cost.bytes:.6e} bytes; meta {meta.flops:.6e}, "
                f"{meta.bytes:.6e}")
        want_flash = attn_layers(cfg) if step == "prefill" else 0
        if n_flash != want_flash:
            raise AssertionError(f"{what}: {n_flash} flash launches, want "
                                 f"{want_flash}")

        def run():
            fn(*args)
        try:
            ms, timed_by = graph_ms(run, STEP_GRAPH_CALLS), "cuda_graph_events"
        except Exception as e:   # a step that cannot be captured
            ms = events_ms(run, STEP_EVENT_ITERS)
            timed_by = f"cuda_events (capture failed: {type(e).__name__})"
        rl = roofline.analyze(
            cost, arch=arch, shape=shape.name, mesh_name=dryrun.MESH,
            chips=1, dtype=cfg.dtype,
            model_flops=roofline.model_flops_for(cfg, shape,
                                                 active_param_count(cfg)))
        bound_ms = max(rl.t_compute, rl.t_memory) * 1e3
        share = bound_ms / ms
        mfu = rl.model_flops / (rl.peak_flops * ms / 1e3)
        print(f"  {what} ({cfg.dtype}, peak {rl.peak_flops / 1e12:.0f} "
              f"TFLOP/s): {cost.flops:.6e} FLOPs, {cost.bytes:.6e} bytes == "
              f"meta; flash launches {n_flash}; t_compute "
              f"{rl.t_compute * 1e3:.4f} ms, t_memory "
              f"{rl.t_memory * 1e3:.4f} ms, {rl.bottleneck}-bound; measured "
              f"{ms:.4f} ms ({timed_by}); bound_share {share:.4f}, mfu "
              f"{mfu:.4f}, useful_flops_ratio {rl.useful_flops_ratio:.4f}; "
              f"peak_bytes {cost.peak_bytes / 1e9:.3f} GB (meta "
              f"{meta.peak_bytes / 1e9:.3f} GB), "
              f"max_memory_allocated {max_alloc / 1e9:.3f} GB "
              f"[{card.smi}]")
        if share > BOUND_SHARE_MAX:
            raise AssertionError(
                f"{what}: bound share {share:.4f} > {BOUND_SHARE_MAX}: the "
                f"counter over-counts (no step runs faster than its bound)")
        del args
    params.clear()
    torch.cuda.empty_cache()
    return flash


def member_word_ops(stages, batch: int) -> int:
    """xor+popc word-ops of ``batch`` frames through one member's stages
    (each 2x2 tap of each channel word of each output bit, and each FC
    weight word of each output)."""
    ops = 0
    for st in stages:
        if st[0] == "conv":
            _, h, w, c, f, pool = st[:6]
            pos = (4 * ((h - 1) // 2) * ((w - 1) // 2) if pool
                   else (h - 1) * (w - 1))
            ops += batch * pos * f * 4 * (c // 32)
        elif st[0] == "fc":
            ops += batch * st[2] * -(-st[1] // 32)
    return ops


def median_margin(margins_of, det_logits) -> float:
    """The median detector margin of a batch: about half its frames
    escalate at it."""
    return float(np.median(margins_of(det_logits.cpu().numpy())))


def image_bytes(image) -> int:
    return 4 * sum(v.numel() for v in image.values())


def random_image(interpreter, program, gen):
    """A weight image from init_params with spread-out BN statistics, so
    thresholds and both comparator directions occur."""
    params = interpreter.init_params(gen, program, device="cpu")
    for p in params["conv"]:
        f = p["gamma"].shape[0]
        p["gamma"] = torch.randn(f, generator=gen)
        p["beta"] = torch.randn(f, generator=gen) * 4
        p["mean"] = torch.randn(f, generator=gen) * 16
        p["var"] = torch.rand(f, generator=gen) * 100 + 1
    return interpreter.fold_params(params, program, image=True)


def warm_delta_state(pack, prog, frames, classes, gen):
    """A warm delta-gate state whose deltas spread: lane i's last frame is
    its current frame with an i x i corner patch shifted by half the
    intensity range (lane 0 unchanged); random cached logits.  (last,
    llog) on the frames' device."""
    io = prog.instrs[0]
    levels = 2 ** io.bits
    prev = frames.clone()
    for i in range(1, len(frames)):
        prev[i, :i, :i] = (prev[i, :i, :i] + levels // 2) % levels
    last = pack(prev, io.bits, io.in_channels, io.channels)
    llog = torch.randint(-50, 50, (len(frames), classes), generator=gen,
                         dtype=torch.int32).to(frames.device)
    return last, llog


def fresh_rows(counts, queue, bpad: int) -> int:
    """Member frames a delta dispatch recomputes: the K changed lanes, plus
    lane 0 when the drain covers a queue row at or past K (it holds index
    0) and lane 0 is not among the K."""
    k, slots = counts
    return k + int(min(slots, bpad) > k and queue[0] != 0)


def one_step(prog, params, images, labels, step, sched, where):
    """One STE step of the detector twin (forward_train, autograd, adamw
    from a fresh state) of ``params`` on ``where``: (new params,
    gradients, loss)."""
    from repro_torch.core.chip import interpreter
    from repro_torch.device import to_device
    from repro_torch.examples import always_on_detector as detector
    from repro_torch.optim import optimizers as opt
    params = to_device(params, where)
    optimizer = opt.adamw(sched)

    def loss_of(p):
        logits, new_p = interpreter.forward_train(p, prog, images.to(where))
        return detector.detector_loss(logits, labels.to(where)), new_p

    (loss, new_p), grads = opt.value_and_grad(loss_of, params)
    new, _, _ = optimizer.update(grads, optimizer.init(params), new_p, step)
    return new, grads, float(loss)


def check_card_step(name, card_step, cpu_step, lr) -> str:
    """Hold the card's step to the CPU's: latents within
    ``step_tolerance`` of the CPU's (per leaf max(1e-4 x max abs, 1e-7),
    widened by 2 lr where the CPU gradient is at rounding level), BN
    running statistics rtol 1e-5.  Returns a summary line."""
    from repro_torch.optim.optimizers import step_tolerance
    (card, _, _), (cpu, grads, _) = card_step, cpu_step
    bounds = step_tolerance(cpu, grads, lr)
    worst, free = 0.0, 0
    for part in ("conv", "fc"):
        for i, layer in enumerate(cpu[part]):
            for k, want in layer.items():
                got = card[part][i][k].cpu()
                if k in ("mean", "var"):
                    if not torch.allclose(got, want, rtol=1e-5, atol=0):
                        raise AssertionError(f"{name}: card {part}[{i}].{k} "
                                             f"!= CPU (rtol 1e-5)")
                    continue
                bound = bounds[part][i][k]
                diff = (got - want).abs()
                if not bool(diff.le(bound).all()):
                    raise AssertionError(f"{name}: card {part}[{i}].{k} off "
                                         f"the CPU step by {float(diff.max())}")
                worst = max(worst, float((diff / bound).max()))
                free += int((bound >= 2 * lr).sum())
    return (f"card step == CPU step within step_tolerance (worst "
            f"{worst:.3f} of the bound; {free} latents with a rounding-level "
            f"gradient); BN statistics rtol 1e-5")


def train_phase(card, dev, gen, programs):
    """Phase 6: STE training of ``face_detector`` and ``owner_detector``
    on ``dev`` (each program's step held against the same step on the
    CPU), the packed conv against the float conv on the trained detector,
    the folded detector served through ``ChipServer``, and BitLinear's
    packed path against its STE forward.  Returns (the launch counts of
    the phase, the trained params by program)."""
    from repro_torch.core import binary_layers
    from repro_torch.core.chip import interpreter, isa
    from repro_torch.core.chip import neuron_array as na
    from repro_torch.examples import always_on_detector as detector
    from repro_torch.kernels import ops
    from repro_torch.optim import optimizers as opt

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on: the STE gradients need "
                             "float32 einsums")
    face, owner = programs["face_detector"], programs["owner_detector"]
    ops.reset_launch_counts()
    trained = {}
    for name, prog, steps in (("face_detector", face, DETECTOR_STEPS),
                              ("owner_detector", owner, OWNER_STEPS)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, losses = detector.train_detector(prog, steps, TRAIN_BATCH,
                                                 device=dev, seed=TRAIN_SEED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        trained[name] = params
        print(f"  {name}: {steps} steps at batch {TRAIN_BATCH} in "
              f"{wall:.3f} s ({steps / wall:.2f} steps/s, "
              f"{wall / steps * 1e3:.2f} ms a step, first step included); "
              f"mean loss {losses[0]:.4f} -> {losses[-1]:.4f} [{card.smi}]")
        # the first step of that run (its init params, batch and schedule)
        # on the card == the same step on the CPU; trained, the hinge loss
        # may reach 0 and its gradients with it
        sched = opt.cosine_schedule(2e-3, 20, steps)
        init = interpreter.init_params(
            torch.Generator().manual_seed(TRAIN_SEED), prog, device="cpu")
        images_b, labels_b = detector.detector_batch(0, TRAIN_BATCH,
                                                     device="cpu")
        args = (prog, init, images_b, labels_b, 0, sched)
        walls = []
        for where in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            walls.append((one_step(*args, where), time.perf_counter() - t0))
        (card_step, card_s), (cpu_step, cpu_s) = walls
        line = check_card_step(name, card_step, cpu_step, float(sched(0)))
        print(f"  {name}: first step {card_s * 1e3:.1f} ms on the card, "
              f"{cpu_s * 1e3:.1f} ms on the CPU (host clock, "
              f"{torch.get_num_threads()} threads)")
        for part in ("conv", "fc"):
            for i, g in enumerate(card_step[1][part]):
                if not float(g["w"].abs().max()) > 0.0:
                    raise AssertionError(f"{name}: {part}[{i}] weight "
                                         f"gradient is zero")
        print(f"  {name}: {line}; every conv and FC weight gradient "
              f"nonzero")

    # the eval forward of the trained detector: the float conv (training's
    # einsums) == the packed conv (binarize_pack + binary_conv2x2) at every
    # conv layer
    folded = interpreter.fold_params(trained["face_detector"], face)
    io = face.instrs[0]
    coords = detector.window_coords()
    frames = [detector.synthetic_frame(t, detector.face_at(t))
              for t in range(8)]
    wins = np.concatenate([detector.windows_of(f) for f in frames])
    x = na.thermometer_encode(torch.from_numpy(wins[:TRAIN_BATCH]).to(dev),
                              io.bits, io.channels)
    convs = [ins for ins in face.instrs if isinstance(ins, isa.ConvInstr)]
    for ins, layer in zip(convs, folded["conv"]):
        s_float = na.conv2x2(x, layer["w"])
        if not torch.equal(na.conv2x2_packed(x, layer["w"]), s_float):
            raise AssertionError(f"face_detector {ins.height}x{ins.width}: "
                                 f"packed conv != float conv")
        x = na.comparator(s_float, layer["tau"], layer["flip"])
        if ins.maxpool:
            x = na.maxpool2x2(x)
    print(f"  face_detector eval forward, {TRAIN_BATCH} windows: float conv "
          f"== packed conv (binary_conv2x2) at all {len(convs)} conv layers")

    # fold packed and serve 8 QQVGA frames of 54 windows through ChipServer
    server = detector.deploy(trained["face_detector"], face, device=dev)
    served = [detector.serve_frame(server, f) for f in frames]
    st = server.stats()
    server.close()
    ref_y = interpreter.forward_infer(folded, face, wins,
                                      device=dev)[1].cpu().numpy()
    if not np.array_equal(np.concatenate(served), ref_y):
        raise AssertionError("served window labels != float reference")
    if not (st.billed == st.total_served == len(wins)
            and st.dispatches == len(frames) and not st.padded["face"]):
        raise AssertionError(f"detector bill: {st.billed} billed, "
                             f"{st.total_served} served, {st.dispatches} "
                             f"dispatches")
    hits = 0
    for t, labels in enumerate(served):
        at = detector.face_at(t)
        hit_at = [c for c, y in zip(coords, labels) if y == 1]
        hits += (at is not None and any(
            abs(y - at[0]) <= 16 and abs(xx - at[1]) <= 16
            for y, xx in hit_at)) or (at is None and not hit_at)
    print(f"  served {len(frames)} frames x {len(coords)} windows in "
          f"{st.dispatches} megakernel dispatches: labels == float "
          f"reference, billed {st.billed} == served {st.total_served} + "
          f"padded 0; frame-level agreement {hits}/{len(frames)} (reported, "
          f"not asserted)")

    # BitLinear at SmolLM-360M's MLP up-projection: a few STE steps, then
    # the packed path (binarize_pack -> xnor_matmul) == the STE forward
    d_in, d_out, tokens, bl_steps = BITLINEAR
    bl = binary_layers.init(torch.Generator().manual_seed(21), d_in, d_out,
                            device=dev)
    xs = torch.randn((tokens, d_in), generator=gen).to(dev)
    target = torch.randn((tokens, d_out), generator=gen).to(dev)
    bl_opt = opt.adamw(opt.cosine_schedule(1e-2, 1, bl_steps))
    bl_state = bl_opt.init(bl)
    bl_losses = []
    for i in range(bl_steps):
        (loss, _), grads = opt.value_and_grad(
            lambda p: (torch.mean((binary_layers.apply_train(p, xs)
                                   - target) ** 2), None), bl)
        bl, bl_state, _ = bl_opt.update(grads, bl_state, bl, i)
        bl_losses.append(float(loss))
    with torch.no_grad():
        y_train = binary_layers.apply_train(bl, xs)
    y_infer = binary_layers.apply_infer(bl, xs)
    if not torch.equal(y_infer, y_train):
        raise AssertionError("BitLinear apply_infer != apply_train forward")
    print(f"  BitLinear {d_in} -> {d_out} on {tokens} tokens: {bl_steps} STE "
          f"steps, loss {bl_losses[0]:.4f} -> {bl_losses[-1]:.4f}; "
          f"apply_infer (binarize_pack -> xnor_matmul) == apply_train "
          f"forward, bit for bit")
    counts = ops.launch_counts()
    for k in ("binary_conv2x2", "binarize_pack", "xnor_matmul",
              "megakernel"):
        if not counts[k]:
            raise AssertionError(f"{k} was not launched by the training path")
    print(f"  launches on the training path: "
          f"{ {k: v for k, v in counts.items() if v} }")
    return counts, trained



def staged_pair(plan, packed, frames):
    """A staged lane on the card, stage by stage, each kernel beside its
    plain version on the same input (the kernel's output feeds the next
    stage): (int32 logits, {kernel: max abs err}); raises on a
    disagreement."""
    from repro_torch.core import binarize
    from repro_torch.core.chip import neuron_array as na
    from repro_torch.kernels import binary_conv2x2_block as bcb
    from repro_torch.kernels import xnor_matmul as xm
    errs = {"conv_block": 0, "xnor_matmul": 0, "xnor_matmul_pack": 0}
    ci = fi = 0
    x = logits = None
    for st in plan.stages:
        if hasattr(st, "bits"):                      # the IO stage
            x = na.thermometer_encode_packed(frames, st.bits, st.channels)
        elif hasattr(st, "pool"):                    # a conv layer
            p = packed["conv"][ci]
            ci += 1
            args = (x, p["w_words"], p["tau"], p["flip"])
            got = bcb.binary_conv2x2_block(*args, c=st.c, pool=st.pool)
            want = bcb.conv_block_body(*args, k4=4 * st.c, h=x.shape[1],
                                       wd=x.shape[2], pool=st.pool)
            errs["conv_block"] = max(errs["conv_block"],
                                     max_abs_err(got, want))
            x = got
        else:                                        # an FC layer
            x = x.reshape(x.shape[0], -1)
            p = packed["fc"][fi]
            fi += 1
            key = "xnor_matmul_pack" if st.pack_out else "xnor_matmul"
            got = xm.xnor_matmul(x, p["w_words"], st.in_features,
                                 pack_out=st.pack_out)
            want = xm.xnor_matmul_plain(x, p["w_words"], st.in_features,
                                        pack_out=st.pack_out)
            errs[key] = max(errs[key], max_abs_err(got, want))
            if st.final:
                logits = got
            elif st.pack_out:
                x = got
            else:       # odd-width hidden FC: threshold at 0, repack
                x = binarize.pack_signs(binarize.hard_sign(got.float()),
                                        axis=-1)
    return logits, errs


def serving_phase(card, dev, programs, artifacts, offline, cifar_params,
                  quad, quad_packed, lane_frames, quad_served, errs):
    """Phase 5b: the ladder of the continuous policy held bit-exact,
    continuous serving of cifar9_s1 at full width beside the static policy
    on the same traces, a shared continuous composite, a two-replica fleet
    with a kill and a warm-started replacement, and one replica over a
    group of two device entries.  Returns the launches of each kernel the
    phase's serves made, the counts set to 0 before each serve and read
    after it."""
    from repro_torch.core.chip import interpreter
    from repro_torch.kernels import cache as warmcache
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import ops
    from repro_torch.launch.chip_serve import frame_stream
    from repro_torch.serving import (ChipServer, FaultInjector, ServeFleet,
                                     make_trace, replay)
    launches = {}

    def count(counts, *names):
        for k in names:
            launches[k] = launches.get(k, 0) + counts[k]

    # the ladder: the megakernel and a staged lane at every size a
    # continuous dispatch of batch 32 can take, and the 4 x S=4 composite
    # with every member padded to the same size (a ragged shared dispatch)
    cifar = programs["cifar9_s1"]
    plan = interpreter.compile_plan(cifar)
    art = artifacts["cifar9_s1"]
    image = interpreter.ensure_image(art, cifar)
    cplan, cimage = interpreter.pack_programs(
        {n: programs[n] for n in quad}, {n: quad_packed[n] for n in quad})
    for b in LADDER:
        frames = torch.from_numpy(frame_stream(cifar, b, 40 + b)).to(dev)
        want = mk.megakernel_plain(image, frames, spec=plan.mega)
        got = mk.megakernel_forward(image, frames, spec=plan.mega)
        errs["megakernel"] = max(errs["megakernel"], max_abs_err(got, want))
        logits, lane = staged_pair(plan, art, frames)
        for k, v in lane.items():
            errs[k] = max(errs[k], v)
        if not torch.equal(logits, got):
            raise AssertionError(f"B={b}: staged lane != megakernel")
        members = tuple(torch.from_numpy(frame_stream(programs[n], b,
                                                      50 + b + i)).to(dev)
                        for i, n in enumerate(quad))
        errs["composite"] = max(errs["composite"], max_abs_err_all(
            mk.composite_forward(cimage, members, spec=cplan.spec),
            mk.composite_plain(cimage, members, spec=cplan.spec)))
    torch.cuda.synchronize()
    print(f"  ladder {LADDER}: megakernel cifar9_s1, its staged lane "
          f"(conv_block x 8, xnor_matmul) and the composite "
          f"{'+'.join(quad)} (every member at the size) == plain versions; "
          f"staged == megakernel")

    # continuous serving at full width vs the static policy, real clock
    bank = frame_stream(cifar, CONT_FRAMES, 900)
    ref = interpreter.forward_infer(
        interpreter.fold_params(cifar_params, cifar), cifar, bank,
        device=dev)[1].cpu().numpy()
    for kind in CONT_TRAFFIC:
        trace = make_trace(kind, ["cifar9_s1"], CONT_RATE, CONT_FRAMES,
                           seed=0)
        for policy in ("continuous", "static"):
            server = ChipServer({"cifar9_s1": cifar}, {"cifar9_s1": art},
                                batch=CONT_BATCH, megakernel=True,
                                device=dev, policy=policy,
                                slo_ms=CONT_SLO_MS)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            results = replay(server, trace, {"cifar9_s1": bank})
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            server.close()
            st = server.stats()
            got = np.full(CONT_FRAMES, -1)
            for r in results:
                got[r.rid] = r.label
            if len(results) != CONT_FRAMES or not np.array_equal(got, ref):
                raise AssertionError(f"{kind} {policy}: labels != float "
                                     f"reference")
            if st.billed != st.total_served + sum(st.padded.values()):
                raise AssertionError(f"{kind} {policy}: billed != served + "
                                     f"padded")
            if counts["megakernel"] != st.dispatches:
                raise AssertionError(f"{kind} {policy}: launches {counts}")
            if policy == "continuous":
                count(counts, "megakernel")
            trace_recs = server.latency_trace()
            met = sum(e["latency_ms"] <= CONT_SLO_MS
                      for e in trace_recs) / len(trace_recs)
            print(f"  {kind} {policy}: {CONT_FRAMES} frames offered at "
                  f"{CONT_RATE:.0f} f/s over {trace.duration_s:.3f} s, "
                  f"dispatch sizes {st.dispatch_sizes} (size: dispatches), "
                  f"p50 {st.p50_ms:.3f} / p95 {st.p95_ms:.3f} / p99 "
                  f"{st.p99_ms:.3f} ms ({met:.4f} within {CONT_SLO_MS:.0f} "
                  f"ms), padding ratio {st.padding_ratio:.4f}, billed "
                  f"{st.billed} == {st.total_served} served + "
                  f"{sum(st.padded.values())} padded, {CONT_FRAMES / wall:.1f} "
                  f"frames/s over the replay, {st.host_frames_per_s:,.1f} "
                  f"frames/s inside dispatches; labels == float reference "
                  f"[{card.smi}]")

    # the 4 x S=4 group shared under the continuous policy, up to 11
    # frames a lane: a full composite dispatch, then a ragged one on the
    # ladder (every member padded to 4); labels == phase 5's shared serve
    # of the same frames (its rids run lane after lane)
    server = ChipServer({n: programs[n] for n in quad},
                        {n: quad_packed[n] for n in quad}, batch=BATCH,
                        megakernel=True, device=dev, shared=True,
                        policy="continuous")
    which, first = {}, 0
    for n in quad:
        for j, f in enumerate(lane_frames[n][:11]):
            which[server.submit(n, f)] = quad_served[first + j]
        first += len(lane_frames[n])
    ops.reset_launch_counts()
    results = server.drain()
    counts = ops.launch_counts()
    server.close()
    st = server.stats()
    if sorted(r.rid for r in results) != sorted(which) or any(
            (r.program, r.label) != which[r.rid] for r in results):
        raise AssertionError("shared continuous labels != shared static")
    if (counts["composite"] != st.shared_dispatches or not
            st.shared_dispatches or min(st.dispatch_sizes) >= BATCH):
        raise AssertionError(f"shared continuous: launches {counts}, sizes "
                             f"{st.dispatch_sizes}")
    count(counts, "composite", "megakernel")
    print(f"  shared continuous {'+'.join(quad)}: {st.total_served} served, "
          f"dispatch sizes {st.dispatch_sizes}, {st.shared_dispatches} "
          f"composite launches, billed {st.billed} == served + padded "
          f"{sum(st.padded.values())}; labels == phase 5's shared serve")

    # a fleet of two replicas sharing the card, staged lanes; host0 killed
    # after FLEET_KILL_AFTER served frames, a replacement warm-started
    fprogs = {n: programs[n] for n in artifacts}
    streams = {n: frame_stream(programs[n], SERVE_REQUESTS // 2, 100 + i)
               for i, n in enumerate(artifacts)}
    warmcache.invalidate()
    fleet = ServeFleet(fprogs, artifacts, replicas=2, batch=BATCH,
                       injector=FaultInjector("host0", FLEET_KILL_AFTER),
                       replace=True, prefetch=2)
    hits_built = warmcache.stats()["hits"]
    ops.reset_launch_counts()
    which, results = {}, []
    for j in range(SERVE_REQUESTS // 2):
        for n in fprogs:
            which[fleet.submit(n, streams[n][j])] = (n, j)
        if j % 4 == 3:
            results.extend(fleet.step())
    results += fleet.drain()
    counts = ops.launch_counts()
    fleet.close()
    st = fleet.stats()
    if sorted(r.rid for r in results) != sorted(which):
        raise AssertionError("fleet lost or repeated frames")
    for r in results:
        n, j = which[r.rid]
        if r.program != n or r.label != offline[n][j]:
            raise AssertionError(f"fleet frame {r.rid}: label != plain path")
    if not (st.billed == st.total_served + sum(st.padded.values())
            and st.total_served == len(which) + st.refired_frames
            and st.failed_replicas == ("host0",)
            and st.warm_start["hits"] > hits_built
            and st.recovery_ms is not None):
        raise AssertionError(f"fleet books: {st}")
    if not all(counts[k] for k in ("conv_block", "xnor_matmul",
                                   "xnor_matmul_pack")):
        raise AssertionError(f"fleet launches {counts}")
    count(counts, "conv_block", "xnor_matmul", "xnor_matmul_pack")
    for name, rs in sorted(st.replicas.items()):
        print(f"  fleet {name}{' (FAILED)' if name in st.failed_replicas else ''}"
              f": {rs.total_served} served, {sum(rs.padded.values())} "
              f"padded, {rs.dispatches} dispatches")
    print(f"  fleet of 2 on {card.name} (one card: the replicas share it, "
          f"placement across GPUs unchecked): {len(which)} frames, none "
          f"lost, labels == plain path; {st.migrated_frames} migrated "
          f"(+{st.refired_frames} refired), billed {st.billed} == "
          f"{st.total_served} served + {sum(st.padded.values())} padded; "
          f"warm start {st.warm_start['hits'] - hits_built} hits for the "
          f"replacement; recovery_ms {st.recovery_ms:.3f} (kill to the "
          f"replacement's first served frame, host clock); launches "
          f"{ {k: counts[k] for k in ('conv_block', 'xnor_matmul', 'xnor_matmul_pack')} } "
          f"[{card.smi}]")

    # one replica over the device group (cuda:0, cuda:0): every dispatch
    # scattered in two shares and gathered back
    server = ChipServer(fprogs, artifacts, batch=BATCH, megakernel=True,
                        mesh=(dev, dev))
    which = {}
    for j in range(SERVE_REQUESTS // 2):
        for n in fprogs:
            which[server.submit(n, streams[n][j])] = (n, j)
    ops.reset_launch_counts()
    results = server.drain()
    counts = ops.launch_counts()
    server.close()
    st = server.stats()
    if sorted(r.rid for r in results) != sorted(which):
        raise AssertionError("group replica lost or repeated frames")
    for r in results:
        n, j = which[r.rid]
        if r.label != offline[n][j]:
            raise AssertionError(f"group replica frame {r.rid}: label != "
                                 f"plain path")
    if counts["megakernel"] != 2 * st.dispatches:
        raise AssertionError(f"group replica: launches {counts}")
    count(counts, "megakernel")
    print(f"  replica over ({dev}, {dev}): {st.total_served} served in "
          f"{st.dispatches} dispatches, {counts['megakernel']} megakernel "
          f"launches (two shares a dispatch), labels == plain path")
    print(f"  phase 5b launches {launches}")
    return launches


def launched_geometry(mk, bcb):
    """Spies on the ctypes launchers of the composite, conv_block and
    delta kernels: each launch appends the geometry the wrapper passed
    (the cluster size; the conv's ConvTiles.args; the recompute's cluster
    size), so a check reads the geometry a launch really took.  Returns
    (seen, restore)."""
    seen = {"cluster": [], "conv": [], "delta": []}
    composite, conv, delta = (mk._composite_launcher, bcb._launcher,
                              mk._delta_launcher)
    real_composite, real_conv, real_delta = composite(), conv(), delta()

    def spy_composite(*args):
        seen["cluster"].append(args[10][0])         # geo.args[0]
        return real_composite(*args)

    def spy_conv(*args):
        seen["conv"].append(tuple(args[12:23]))     # ConvTiles.args
        return real_conv(*args)

    def spy_delta(*args):
        seen["delta"].append(args[18][0])           # geo.args[0]
        return real_delta(*args)
    mk._composite_launcher = lambda: spy_composite
    bcb._launcher = lambda: spy_conv
    mk._delta_launcher = lambda: spy_delta

    def restore():
        mk._composite_launcher, bcb._launcher = composite, conv
        mk._delta_launcher = delta
    return seen, restore


def autotune_phase(card, dev, programs, artifacts, quad_images):
    """Phase 5c: the autotune cache on the card, in a cache file of its
    own.  The solo megakernel's cluster grid at cifar9_s1 B=8 and 256, the
    delta gate's recompute at each of its sizes (B=8), the 4 x S=4 quad's
    at B=8, the staged conv grid at cifar9_s1 B=8: every candidate's
    outputs == the plain version's (tolerance 0), each grid
    timed (graph ms, best of 3) and its winner recorded; a cold cache
    launches the formula's geometry and a recorded entry the recorded one
    (read from the launchers' arguments); ``chip_serve --autotune`` once
    in a subprocess; ``BENCH_autotune.json`` unchanged."""
    import hashlib
    import os
    import tempfile
    from repro_torch.core.binarize import thermometer_pack
    from repro_torch.core.chip import interpreter
    from repro_torch.kernels import autotune
    from repro_torch.kernels import binary_conv2x2_block as bcb
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import ops
    from repro_torch.launch.chip_serve import frame_stream
    from repro_torch.launch.timing import events_ms
    from repro_torch.serving.server import ChipServer

    bench = ROOT / "BENCH_autotune.json"
    digest = hashlib.sha256(bench.read_bytes()).hexdigest()
    tmp = tempfile.mkdtemp(prefix="autotune_")
    old_env = os.environ.get(autotune.CACHE_ENV)
    os.environ[autotune.CACHE_ENV] = os.path.join(tmp, "autotune.json")
    autotune.invalidate()
    seen, restore = launched_geometry(mk, bcb)
    winners, path = {}, {}

    def on_path(fn):
        # the path's launches: the tuners, the launches after a record and
        # the serves; not the bit-exact comparisons with the plain versions
        ops.reset_launch_counts()
        out = fn()
        for k, v in ops.launch_counts().items():
            path[k] = path.get(k, 0) + v
        return out

    def show(label, report, entry, cold):
        # a recorded 0 is the formula's geometry (no candidate beat it by
        # autotune.MARGIN)
        won = {k: entry[k] or cold[k] for k in cold}
        for cand, ms in report:
            tags = [t for t, on in (("winner", cand == won),
                                    ("cold default", cand == cold)) if on]
            print(f"    {label} {cand}: {ms:.5f} ms"
                  + (f"  <- {', '.join(tags)}" if tags else ""))
        print(f"  {label}: recorded {entry} (0: the formula's; the grid's "
              f"fastest, if another, timed again alternately with the "
              f"formula and kept only {autotune.MARGIN:.0%} faster) "
              f"[{card.smi}]")

    try:
        cifar = programs["cifar9_s1"]
        plan = interpreter.compile_plan(cifar)
        image = interpreter.ensure_image(artifacts["cifar9_s1"], cifar)
        formula = mk.cluster_geometry(mk.solo_member_spec(plan.mega)).cluster
        solo = {b: torch.from_numpy(frame_stream(cifar, b, 700 + b)).to(dev)
                for b in AUTOTUNE_BATCHES}
        for b, frames in solo.items():          # cold, before any record
            want = mk.megakernel_plain(image, frames, spec=plan.mega)
            del seen["cluster"][:]
            cold = plan.forward_mega(image, frames, device=dev)[0]
            if seen["cluster"] != [formula] or not torch.equal(
                    cold, want.float()):
                raise AssertionError(f"cold cache B={b}: launched "
                                     f"{seen['cluster']}, formula {formula}")
            for c in autotune.CLUSTERS:
                got = plan.forward_mega(image, frames, device=dev,
                                        cluster=c)[0]
                if not torch.equal(got, want.float()):
                    raise AssertionError(f"megakernel cluster {c} B={b} != "
                                         f"plain version")
        for b, frames in solo.items():
            report = []
            entry = on_path(lambda: autotune.tune_mega(plan, image, frames,
                                                       report=report))
            show(f"megakernel cifar9_s1 B={b}", report, entry,
                 {"cluster": formula})
            del seen["cluster"][:]
            on_path(lambda: plan.forward_mega(image, frames, device=dev))
            if seen["cluster"] != [entry["cluster"] or formula]:
                raise AssertionError(f"after record: launched "
                                     f"{seen['cluster']}, recorded {entry}")
            winners[f"megakernel B={b}"] = (entry, report)
        # the read side's host cost: a dispatch resolving through the
        # memoised cache against one given its cluster (no lookup), by
        # CUDA events back to back, alternated; and the lookup alone
        frames = solo[BATCH]
        c8 = winners[f"megakernel B={BATCH}"][0]["cluster"] or formula
        host = {"resolved": [], "explicit": []}
        for _ in range(5):
            host["resolved"].append(events_ms(lambda: plan.forward_mega(
                image, frames, device=dev), 2000))
            host["explicit"].append(events_ms(lambda: plan.forward_mega(
                image, frames, device=dev, cluster=c8), 2000))
        t0 = time.perf_counter()
        for _ in range(100_000):
            autotune.mega_tiles(cifar, BATCH, None, dev)
        lookup_us = (time.perf_counter() - t0) * 10
        print(f"  host path a dispatch, cifar9_s1 B={BATCH} (CUDA events "
              f"back to back, 2000 calls, 5 rounds alternated): forward_mega "
              f"resolving through the cache "
              f"{[round(v, 5) for v in host['resolved']]} ms, given its "
              f"cluster {[round(v, 5) for v in host['explicit']]} ms; a "
              f"memoised lookup alone {lookup_us:.2f} us (host clock) "
              f"[{card.smi}]")
        # end to end: cifar9_s1 served at B=256 through a ChipServer, a
        # cold cache (the formula's clusters of 8) against the tuned one,
        # alternated; labels equal
        big = SERVE_BATCH
        stream = frame_stream(cifar, 8 * big, 730)
        tuned_env = os.environ[autotune.CACHE_ENV]
        serve_fps, serve_labels = {"cold": [], "tuned": []}, {}
        for which in ("cold", "tuned", "cold", "tuned"):
            os.environ[autotune.CACHE_ENV] = (
                tuned_env if which == "tuned"
                else os.path.join(tmp, "cold.json"))
            autotune.invalidate()
            server = ChipServer({"cifar9_s1": cifar},
                                {"cifar9_s1": artifacts["cifar9_s1"]},
                                batch=big, megakernel=True, device=dev)
            for f in stream:
                server.submit("cifar9_s1", f)
            del seen["cluster"][:]
            results = on_path(server.drain)
            server.close()
            want_c = ((winners[f"megakernel B={big}"][0]["cluster"]
                       if which == "tuned" else 0) or formula)
            if set(seen["cluster"]) != {want_c}:
                raise AssertionError(f"{which} serve launched "
                                     f"{set(seen['cluster'])}")
            serve_fps[which].append(server.stats().host_frames_per_s)
            serve_labels[which] = [r.label for r in sorted(
                results, key=lambda r: r.rid)]
        os.environ[autotune.CACHE_ENV] = tuned_env
        autotune.invalidate()
        if serve_labels["cold"] != serve_labels["tuned"]:
            raise AssertionError("tuned serve labels != cold serve labels")
        print(f"  ChipServer cifar9_s1 batch {big}, {len(stream)} frames "
              f"(megakernel): cold cache (clusters of {formula}) "
              f"{[round(v) for v in serve_fps['cold']]} frames/s, tuned "
              f"(clusters of "
              f"{winners[f'megakernel B={big}'][0]['cluster'] or formula})"
              f" {[round(v) for v in serve_fps['tuned']]} frames/s (host "
              f"clock, cold / tuned alternated); labels equal [{card.smi}]")

        # the delta gate's recompute resolves its cluster through the
        # megakernel's entry: at every size of the grid, cifar9_s1 B=8
        # from a warm state with 8, 5 (lane 0 unchanged: the drain's lane-0
        # rule) and 0 lanes changed, at two drain schedules, == delta_plain;
        # then the recorded entry is the cluster it launches
        dplan, dimage = interpreter.pack_delta(cifar, artifacts["cifar9_s1"])
        dimage = {k: v.to(dev) for k, v in dimage.items()}
        frames = solo[BATCH]
        io = cifar.instrs[0]
        levels = 2 ** io.bits
        llog = torch.randint(-50, 50, (BATCH, dplan.classes),
                             generator=torch.Generator().manual_seed(740),
                             dtype=torch.int32).to(dev)
        ctrl = dplan.delta_ctrl(1.0, BATCH).to(dev)
        for lanes in DELTA_TUNED_LANES:
            prev = frames.clone()
            for i in lanes:
                prev[i, :2, :2] = (prev[i, :2, :2] + levels // 2) % levels
            last = thermometer_pack(prev, io.bits, io.in_channels,
                                    io.channels)
            for rb in (0, 2):
                want = mk.delta_plain(dimage, frames, last, llog, ctrl,
                                      spec=dplan.spec, rb=rb)
                if int(want[3][0]) != len(lanes):
                    raise AssertionError(f"delta: {int(want[3][0])} lanes "
                                         f"changed, want {len(lanes)}")
                want = (want[1], want[0]) + tuple(want[2:])
                for c in autotune.CLUSTERS:
                    got = dplan.forward_delta(dimage, frames, last, llog,
                                              ctrl, device=dev, rb=rb,
                                              cluster=c)[2:]
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"delta cluster {c}, lanes "
                                             f"{lanes}, rb {rb} != plain")
        del seen["delta"][:]
        on_path(lambda: dplan.forward_delta(dimage, frames, last, llog, ctrl,
                                            device=dev))
        if seen["delta"] != [c8]:
            raise AssertionError(f"delta after record: launched "
                                 f"{seen['delta']}, recorded {c8}")
        print(f"  delta cifar9_s1 B={BATCH}, recompute at clusters "
              f"{autotune.CLUSTERS}, {[len(x) for x in DELTA_TUNED_LANES]} "
              f"lanes changed, rb 0 and 2: logits, new_last, queue, counts "
              f"and deltas == delta_plain; the megakernel's entry steers it "
              f"(launched at {c8})")

        # the 4 x S=4 quad, B=8 a member
        cplan, cimage = interpreter.pack_programs(
            {n: programs[n] for n in TILINGS[0]}, quad_images)
        frames = tuple(torch.from_numpy(frame_stream(programs[n], BATCH,
                                                     710 + i)).to(dev)
                       for i, n in enumerate(TILINGS[0]))
        want = mk.composite_plain(cimage, frames, spec=cplan.spec)
        qformula = mk.cluster_geometry(cplan.spec).cluster
        del seen["cluster"][:]
        cplan.forward(cimage, frames, device=dev)
        if seen["cluster"] != [qformula]:
            raise AssertionError(f"cold composite launched {seen['cluster']}")
        for c in autotune.CLUSTERS:
            got = cplan.forward(cimage, frames, device=dev, cluster=c)[0]
            if not all(torch.equal(g, w.float()) for g, w in zip(got, want)):
                raise AssertionError(f"composite cluster {c} != plain")
        report = []
        entry = on_path(lambda: autotune.tune_composite(
            cplan, cimage, frames, report=report))
        show("composite 4 x S=4 B=8", report, entry, {"cluster": qformula})
        del seen["cluster"][:]
        on_path(lambda: cplan.forward(cimage, frames, device=dev))
        if seen["cluster"] != [entry["cluster"] or qformula]:
            raise AssertionError(f"composite after record: {seen['cluster']}")
        winners["composite B=8"] = (entry, report)

        # the staged conv grid at B=8: cifar9_s1 (8 conv layers, the last
        # FC unpacked) and mnist5 (a packed hidden FC)
        accepted = 0
        for name in STAGED_TUNED:
            prog = programs[name]
            splan = interpreter.compile_plan(prog)
            frames = torch.from_numpy(frame_stream(prog, BATCH, 720)).to(dev)
            packed = artifacts[name]
            simage = interpreter.ensure_image(packed, prog)
            want = mk.megakernel_plain(simage, frames,
                                       spec=splan.mega).float()
            cold_tiles = [t.args for t in splan.conv_geometry(BATCH, 0, 0,
                                                              dev)]
            del seen["conv"][:]
            splan.forward(packed, frames, device=dev)
            if seen["conv"] != cold_tiles:
                raise AssertionError(f"cold staged conv {name} launched "
                                     f"another geometry than conv_tiles")
            fslices = 256 // prog.s // 32
            for ns in sorted({min(n, fslices) for n in autotune.NSLICES}):
                for rows in autotune.ROWS:
                    try:
                        splan.conv_geometry(BATCH, ns, rows, dev)
                    except ValueError:
                        continue
                    accepted += 1
                    got = splan.forward(packed, frames, device=dev,
                                        conv_tiles=(ns, rows))[0]
                    if not torch.equal(got, want):
                        raise AssertionError(f"staged conv {name} ({ns}, "
                                             f"{rows}) != plain version")
            report = []
            entry = on_path(lambda: autotune.tune_staged_conv(
                splan, packed, frames, report=report))
            show(f"staged conv {name} B={BATCH}", report, entry,
                 {"nslices": 0, "rows": 0})
            del seen["conv"][:]
            on_path(lambda: splan.forward(packed, frames, device=dev))
            rec = [t.args for t in splan.conv_geometry(
                BATCH, entry["nslices"], entry["rows"], dev)]
            if seen["conv"] != rec:
                raise AssertionError(f"staged conv {name} after record: "
                                     f"another geometry than the recorded")
            winners[f"staged conv {name} B={BATCH}"] = (entry, report)
        print(f"  every candidate bit-exact with the plain version: "
              f"{len(autotune.CLUSTERS)} cluster sizes x "
              f"{len(AUTOTUNE_BATCHES)} batches, {len(autotune.CLUSTERS)} "
              f"for the quad, {accepted} staged conv geometries of "
              f"{' and '.join(STAGED_TUNED)}; cold cache "
              f"== formula, recorded entry == next launch (launcher "
              f"arguments)")
    finally:
        restore()
        autotune.invalidate()

    # chip_serve --autotune, once, in its own process and cache file
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env[autotune.CACHE_ENV] = os.path.join(tmp, "chip_serve.json")
    cmd = [sys.executable, "-m", "repro_torch.launch.chip_serve",
           "--programs", "cifar9_s1", "--batch", str(BATCH),
           "--requests", "16", "--megakernel", "--autotune"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    line = [ln for ln in out.stdout.splitlines() if "autotuned" in ln]
    if out.returncode or not line or not os.path.exists(
            env[autotune.CACHE_ENV]):
        raise AssertionError(f"chip_serve --autotune rc {out.returncode}: "
                             f"{out.stdout[-800:]} {out.stderr[-800:]}")
    print(f"  chip_serve --autotune: {line[0].strip()}; served "
          f"({time.perf_counter() - t0:.1f} s, rc 0)")
    if old_env is None:
        os.environ.pop(autotune.CACHE_ENV, None)
    else:
        os.environ[autotune.CACHE_ENV] = old_env
    if hashlib.sha256(bench.read_bytes()).hexdigest() != digest:
        raise AssertionError("BENCH_autotune.json changed")
    print("  BENCH_autotune.json unchanged (sha256)")
    print(f"  phase 5c launches (tuners, recorded launches, serves) "
          f"{ {k: v for k, v in path.items() if v} }")
    return winners, path


def lm_train_phase(card, dev):
    """Phase 6b: SmolLM-360M with quant="binary" at full width, in the
    config's own dtypes, trained LM_TRAIN_STEPS adamw steps at batch
    LM_TRAIN_BATCH x LM_TRAIN_SEQ: finite losses, ms a step (host clock
    around synchronised steps) and the device's busy time (profiler); the
    first step at scaled() size on the card == the CPU's within
    ``optimizers.step_tolerance``; then the binary-LM example twin end to
    end, its greedy decode prefilling through the flash kernel at
    scaled()'s head dim.  Returns the step line's numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data import tokens as dtok
    from repro_torch.device import to_device
    from repro_torch.examples import train_binary_lm
    from repro_torch.kernels import ops
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import steps

    cfg = get_config(LM_ARCH, quant="binary")
    optimizer = opt.make("adamw", opt.cosine_schedule(3e-4, 2,
                                                      LM_TRAIN_STEPS))
    state = steps.create_state(cfg, 0, optimizer, device=dev)
    train_step = steps.build_train_step(cfg, optimizer)
    batches = [dtok.batch_for_step(cfg, i, global_batch=LM_TRAIN_BATCH,
                                   seq_len=LM_TRAIN_SEQ, device=dev)
               for i in range(LM_TRAIN_STEPS)]
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"LM training losses {losses}")
    box = {"state": state}

    def one():
        box["state"], _ = train_step(box["state"], batches[0])

    wall_ms, kernels = device_profile(one, 2)
    busy = sum(kernels.values()) / 2 if kernels else None
    nparams = sum(p.numel() for p in opt.tree_leaves(state["params"]))
    print(f"  {LM_ARCH} quant=binary ({nparams / 1e6:.1f} M params, "
          f"{cfg.dtype} activations, {cfg.param_dtype} params, remat "
          f"{cfg.remat}), adamw, "
          f"batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: peak memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated over the steps); "
          f"losses "
          f"{[round(v, 4) for v in losses]}; ms a step (host clock, "
          f"synchronised) {[round(v, 1) for v in ms]} (steady, steps 2-"
          f"{LM_TRAIN_STEPS}: {np.mean(ms[1:]):.1f} ms; the first warms the "
          f"libraries); profiled "
          f"{wall_ms / 2:.1f} ms a step, device busy "
          + (f"{busy:.1f} ms (idle share {1 - 2 * busy / wall_ms:.4f})"
             if busy is not None else "not measured")
          + f" [{card.smi}]")

    # the first step at scaled() size: the card == the CPU
    small = get_config(LM_ARCH, quant="binary").scaled().with_(
        dtype="float32", param_dtype="float32")
    sched = opt.cosine_schedule(1e-3, 2, 10)
    small_opt = opt.make("adamw", sched)
    cpu_state = steps.create_state(small, 3, small_opt, device="cpu")
    batch = dtok.batch_for_step(small, 0, global_batch=4, seq_len=64,
                                device="cpu")
    out = {}
    for where in ("cpu", dev):
        st = to_device(cpu_state, torch.device(where))
        out[str(where)] = steps.build_train_step(small, small_opt)(
            st, {k: v.to(where) for k, v in batch.items()})
    _, grads = opt.value_and_grad(
        lambda p: steps.make_loss_fn(small)(p, batch), cpu_state["params"])
    want = out["cpu"][0]["params"]
    bounds = opt.step_tolerance(want, grads, float(sched(0)))
    worst = 0.0
    for w, g, b in zip(opt.tree_leaves(want),
                       opt.tree_leaves(out[str(dev)][0]["params"]),
                       opt.tree_leaves(bounds)):
        diff = (g.cpu() - w).abs()
        if not bool(diff.le(b).all()):
            raise AssertionError(f"LM step on the card off the CPU's by "
                                 f"{float(diff.max())}")
        worst = max(worst, float((diff / b).max()))
    dl = abs(float(out[str(dev)][1]["loss"]) - float(out["cpu"][1]["loss"]))
    if dl > LM_TOL * (1 + abs(float(out["cpu"][1]["loss"]))):
        raise AssertionError(f"LM step loss: card - CPU = {dl}")
    print(f"  scaled() binary step: card == CPU within step_tolerance "
          f"(worst {worst:.3f} of the bound), loss |card - CPU| {dl:.2e}")

    t0 = time.perf_counter()
    before = ops.launch_counts()["flash_attention"]
    with quiet():
        ex_losses, gen = train_binary_lm.main([])
    # its greedy decode prefills through the flash kernel at scaled()'s
    # head dim (32), once a layer
    flash = ops.launch_counts()["flash_attention"] - before
    if flash < small.num_layers:
        raise AssertionError(f"the example's prefill launched flash "
                             f"attention {flash} times, want at least "
                             f"{small.num_layers} (head dim "
                             f"{small.head_dim})")
    k = min(20, len(ex_losses) // 2)
    print(f"  examples/train_binary_lm twin on {dev}: {len(ex_losses)} steps "
          f"(preempted at {train_binary_lm.CRASH_AT}, restored), loss "
          f"{sum(ex_losses[:k]) / k:.3f} -> {sum(ex_losses[-k:]) / k:.3f}, "
          f"decoded {tuple(gen.shape)}, flash attention launched {flash} "
          f"times at head dim {small.head_dim}; OK in "
          f"{time.perf_counter() - t0:.1f} s")
    return {"losses": losses, "ms": ms, "busy_ms": busy,
            "profiled_ms": wall_ms / 2, "peak_bytes": peak}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs one "
                         "GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.binarize import thermometer_pack, unpack_signs
    from repro_torch.core.chip import energy, interpreter, networks
    from repro_torch.examples import always_on_detector as detector
    from repro_torch.examples.quickstart import train_step
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import binarize_pack as bp
    from repro_torch.kernels import binary_conv2x2 as bc
    from repro_torch.kernels import binary_conv2x2_block as bcb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import megakernel as mk
    from repro_torch.kernels import xnor_matmul as xm
    from repro_torch.launch import serve as lm
    from repro_torch.launch.chip_serve import build_params, frame_stream
    from repro_torch.launch.timing import graph_ms
    from repro_torch.optim import optimizers as opt
    from repro_torch.serving.cascade import CascadePipeline, margins_of
    from repro_torch.serving.server import ChipServer
    from repro_torch.serving.temporal import TemporalPipeline
    from repro_torch.serving.traffic import video_trace

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # -- 1. environment ------------------------------------------------------
    phase(1, "environment")
    card = Card()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(sh(_build.nvcc(), "--version").splitlines()[-1])
    try:
        import triton
        print(f"triton {triton.__version__}")
    except ImportError:
        print("triton not installed")
    print(f"devices {torch.cuda.device_count()}, {card.name}, {card.sms} SMs, "
          f"max SM clock {card.clock_hz / 1e6:.0f} MHz")
    print(f"nvidia-smi: {card.smi}")
    print(f"rates: HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s (data sheet); int8 "
          f"{INT8_OPS_PER_S / 1e12:.0f} TOP/s (data sheet; the binary MAC "
          f"peak follows the phase 2 probe); popc "
          f"{card.popc_per_s / 1e12:.3f} T word-ops/s = {card.sms} SMs x "
          f"{POPC_PER_CLK_PER_SM}/clk (CUDA guide, cc 9.0) x max SM clock; "
          f"bf16 {FLOP_PER_S[torch.bfloat16] / 1e12:.0f} and fp32 "
          f"{FLOP_PER_S[torch.float32] / 1e12:.0f} TFLOP/s (data sheet)")

    # -- 2. build -----------------------------------------------------------
    phase(2, "build")
    t0 = time.perf_counter()
    built = _build.build(ptxas_verbose=True)
    print(f"built {len(built)} sources in {time.perf_counter() - t0:.1f} s "
          f"(parallel nvcc)")
    for b in built.values():
        kernel, spills = None, ""
        for line in b.log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                kernel = m.group(1)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                spills = (f"stack {m.group(1)} B, spills "
                          f"{m.group(2)}/{m.group(3)} B")
            m = re.search(r"Used (\d+) registers.*?(?:(\d+) bytes smem)?$",
                          line)
            if m and kernel:
                print(f"  {b.name}: {kernel[-40:]}: {m.group(1)} registers, "
                      f"{m.group(2) or 0} B static smem, {spills}")
    card.probe_mma()
    card.probe_floor()

    programs = {n: networks.REGISTRY[n]() for n in networks.REGISTRY}
    cifar = programs["cifar9_s1"]
    gen = torch.Generator().manual_seed(0)
    errs = {k: 0 for k in REPLACES}
    errs["flash_attention"] = 0.0

    # -- 3. kernels vs plain versions --------------------------------------
    phase(3, "kernels vs plain versions: bit-exact (tolerance 0), flash "
             "attention within repro's float tolerances")
    # every distinct conv layer of the REGISTRY programs at B=8, each under
    # the first program that has it (cifar9_s1's eight first)
    conv_shapes = []
    for name, prog in programs.items():
        for _, h, w, c, f, pool in (st for st in interpreter.compile_plan(
                prog).mega if st[0] == "conv"):
            if all(s[2:] != (h, w, c, f, pool) for s in conv_shapes):
                conv_shapes.append((name, BATCH, h, w, c, f, pool))
    for name, b, h, w, c, f, pool in conv_shapes + list(CONV_WIDE):
        a = words(gen, b, h, w, c // 32)
        wt = words(gen, f, 4, c // 32)
        tau = torch.randint(-4 * c, 4 * c + 1, (f,), generator=gen,
                            dtype=torch.int32)
        tau[0], tau[1] = -2 ** 31, 2 ** 31 - 256          # saturated neurons
        flip = torch.randint(0, 2, (f,), generator=gen, dtype=torch.int32)
        want = bcb.conv_block_body(a.to(dev), wt.to(dev), tau.to(dev),
                                   flip.to(dev), k4=4 * c, h=h, wd=w,
                                   pool=pool)
        got = bcb.binary_conv2x2_block(a.to(dev), wt.to(dev), tau.to(dev),
                                       flip.to(dev), c=c, pool=pool)
        torch.cuda.synchronize()
        errs["conv_block"] = max(errs["conv_block"], max_abs_err(got, want))
        print(f"  conv_block {name} B={b} {h}x{w} C={c} F={f} pool={pool}: "
              f"equal")
    fc_shapes = [("cifar9_s1 final", BATCH, 10, 1024, False),
                 ("mnist5 hidden", BATCH, 64, 256, True),
                 ("mnist5 final", BATCH, 10, 64, False),
                 ("BitLinear", BITLINEAR[2], BITLINEAR[1], BITLINEAR[0],
                  False),
                 ("mnist5 hidden", SERVE_BATCH, 64, 256, True),
                 ("BitLinear packed", BITLINEAR[2], BITLINEAR[1],
                  BITLINEAR[0], True)]
    # random words (bits set past k too); the ragged grid and BitLinear's
    # shape with both operands 4 bytes off a 16-byte boundary (1-word
    # cp.async) go through the int32 variant's tiles, masks and chunking
    ragged = [("ragged", m, n, k, False) for m in XNOR_RAGGED[0]
              for n in XNOR_RAGGED[1] for k in XNOR_RAGGED[2]]
    ragged += [("ragged", m, n, k, True) for m in XNOR_RAGGED[0]
               for n in XNOR_PACK_N for k in XNOR_RAGGED[2]]
    offset = [("offset",) + fc_shapes[i][1:] for i in (3, 5)]
    for label, m, n, k, pack in fc_shapes + ragged + offset:
        kw = -(-k // 32)
        a, wt = words(gen, m, kw).to(dev), words(gen, n, kw).to(dev)
        if label == "offset":
            a = torch.cat([a.new_zeros(1), a.flatten()])[1:].view(m, kw)
            wt = torch.cat([wt.new_zeros(1), wt.flatten()])[1:].view(n, kw)
        want = xm.xnor_matmul_plain(a, wt, k, pack_out=pack)
        got = xm.xnor_matmul(a, wt, k, pack_out=pack)
        torch.cuda.synchronize()
        key = "xnor_matmul_pack" if pack else "xnor_matmul"
        errs[key] = max(errs[key], max_abs_err(got, want))
        if label != "ragged":
            t = xm.xnor_tiles(m, n, kw, card.sms, pack)
            print(f"  {key} {label} M={m} K={k} N={n}: equal (tiles "
                  f"{t.bm} x {t.bn}, m16 x n{8 * t.tn} a warp, grid "
                  f"{t.grid}, copies of "
                  f"{xm.copy_words(kw, a.data_ptr(), wt.data_ptr())} words)")
    print(f"  xnor_matmul ragged M in {XNOR_RAGGED[0]} x N in "
          f"{XNOR_RAGGED[1]} (packed: {XNOR_PACK_N}) x K in "
          f"{XNOR_RAGGED[2]} ({len(ragged)} shapes): equal")
    images = {n: random_image(interpreter, p, gen) for n, p in programs.items()}
    for name, prog in programs.items():
        plan = interpreter.compile_plan(prog)
        image = {k: v.to(dev) for k, v in images[name].items()}
        batches = (BATCH, RAGGED) + ((SERVE_BATCH,) if name == "cifar9_s1"
                                     else ())
        for b in batches:
            frames = torch.from_numpy(frame_stream(prog, b, b)).to(dev)
            want = mk.megakernel_plain(image, frames, spec=plan.mega)
            got = mk.megakernel_forward(image, frames, spec=plan.mega)
            torch.cuda.synchronize()
            errs["megakernel"] = max(errs["megakernel"],
                                     max_abs_err(got, want))
        geo = mk.cluster_geometry(mk.solo_member_spec(plan.mega))
        print(f"  megakernel {name} B={', '.join(map(str, batches))} "
              f"(clusters of {geo.cluster}): equal")
    for names in TILINGS:
        cplan, cimage = interpreter.pack_programs(
            {n: programs[n] for n in names}, {n: images[n] for n in names})
        cimage = {k: v.to(dev) for k, v in cimage.items()}
        for batches in ((BATCH,) * len(names), RAGGED_MEMBERS[:len(names)]):
            frames = tuple(torch.from_numpy(frame_stream(programs[n], b, b))
                           .to(dev) for n, b in zip(names, batches))
            want = mk.composite_plain(cimage, frames, spec=cplan.spec)
            got = mk.composite_forward(cimage, frames, spec=cplan.spec)
            torch.cuda.synchronize()
            errs["composite"] = max(errs["composite"],
                                    max_abs_err_all(got, want))
        print(f"  composite {'+'.join(names)} B={BATCH} each and ragged "
              f"{RAGGED_MEMBERS[:len(names)]}: equal")
    cplan, cimage = interpreter.pack_cascade(
        {n: programs[n] for n in CASCADE}, {n: images[n] for n in CASCADE},
        detector=CASCADE[0], recognizer=CASCADE[1])
    cimage = {k: v.to(dev) for k, v in cimage.items()}
    # B=8 and ragged at every margin and schedule, each margin also with
    # the detector at both cluster shapes; B=256 (several waves of
    # clusters) at the median margin and the first schedule
    for b in (BATCH, RAGGED, SERVE_BATCH):
        det_geo, rec_geo = mk.cascade_geometry(cplan.spec, b, card.sms)
        frames = torch.from_numpy(frame_stream(programs[CASCADE[0]], b,
                                               10 + b)).to(dev)
        n_real = b if b != RAGGED else b - 1      # a masked padding lane
        det_l = mk.cascade_plain(cimage, frames,
                                 cplan.margin_ctrl(0.0, b).to(dev),
                                 spec=cplan.spec)[0]
        median = median_margin(margins_of, det_l)
        margins = (median,) if b == SERVE_BATCH else MARGINS + (median,)
        schedules = SCHEDULES[:1] if b == SERVE_BATCH else SCHEDULES
        escalated = []
        for margin in margins:
            ctrl = cplan.margin_ctrl(margin, n_real).to(dev)
            for i, (bb, rb, ce) in enumerate(schedules):
                kw = dict(spec=cplan.spec, bb=bb, rb=rb, check_every=ce)
                want = mk.cascade_plain(cimage, frames, ctrl, **kw)
                got = mk.cascade_forward(cimage, frames, ctrl, **kw)
                torch.cuda.synchronize()
                errs["cascade"] = max(errs["cascade"],
                                      max_abs_err_all(got, want))
                for n in DET_CLUSTERS if i == 0 and b != SERVE_BATCH else ():
                    alt = mk.cascade_forward(cimage, frames, ctrl, **kw,
                                             det_cluster=n)
                    torch.cuda.synchronize()
                    errs["cascade"] = max(errs["cascade"],
                                          max_abs_err_all(alt, want))
            escalated.append(int(got[3][0]))
        print(f"  cascade {'->'.join(CASCADE)} B={b} (n_real {n_real}; "
              f"detector clusters of {det_geo.cluster}, {det_geo.smem} B a "
              f"block, recognizer of {rec_geo.cluster}, {rec_geo.smem} B), "
              f"margins {margins} (escalated {escalated}), schedules "
              f"{schedules}: det, rec, queue and counts equal"
              + ("" if b == SERVE_BATCH else
                 f" (and the detector at clusters of each of "
                 f"{DET_CLUSTERS}, first schedule)"))

    # the delta gate at every shape a main path gives it: cifar9_s1 (the
    # video serve), each variant of the cifar10 family lane, all at B=8,
    # and mnist5 ragged
    for name, b, n_real in DELTA_CASES:
        prog = programs[name]
        io = prog.instrs[0]
        dplan, dimage = interpreter.pack_delta(prog, images[name], name=name)
        dimage = {k: v.to(dev) for k, v in dimage.items()}
        frames = torch.from_numpy(frame_stream(prog, b, 20 + b)).to(dev)
        last, llog = warm_delta_state(thermometer_pack, prog, frames,
                                      dplan.classes, gen)
        deltas = mk.delta_plain(dimage, frames, last, llog,
                                dplan.delta_ctrl(0.0, n_real).to(dev),
                                spec=dplan.spec)[4]
        median = float(deltas[:n_real].float().median())
        changed = []
        for thr in THRESHOLDS + (median,):
            ctrl = dplan.delta_ctrl(thr, n_real).to(dev)
            for bb, rb, ce in DELTA_SCHEDULES:
                kw = dict(spec=dplan.spec, bb=bb, rb=rb, check_every=ce)
                want = mk.delta_plain(dimage, frames, last, llog, ctrl, **kw)
                got = mk.delta_forward(dimage, frames, last, llog, ctrl, **kw)
                torch.cuda.synchronize()
                errs["delta"] = max(errs["delta"], max_abs_err_all(got, want))
            changed.append(int(got[3][0]))
        print(f"  delta {name} B={b} (n_real {n_real}), thresholds "
              f"{THRESHOLDS + (median,)} (changed {changed}), schedules "
              f"{DELTA_SCHEDULES}: logits, new_last, queue, counts and "
              f"deltas equal")
        # three steps carrying the state on the device, kernel and plain
        # apart, at the serve's drain schedule and at a wider one
        kw = dict(spec=dplan.spec, bb=8, rb=2, check_every=2)
        kstate = pstate = dplan.init_state(b, device=dev)
        steps = []
        for step, thr in enumerate((float("-inf"), 1.0, 1.0)):
            ctrl = dplan.delta_ctrl(thr, n_real).to(dev)
            got = mk.delta_forward(dimage, frames, *kstate, ctrl, **kw)
            want = mk.delta_plain(dimage, frames, *pstate, ctrl, **kw)
            torch.cuda.synchronize()
            errs["delta"] = max(errs["delta"], max_abs_err_all(got, want))
            kstate, pstate = (got[1], got[0]), (want[1], want[0])
            steps.append(got[3].tolist())
            frames = frames.clone()
            frames[step::3] = (frames[step::3] + 3) % 2 ** io.bits
        print(f"  delta {name} three steps, state carried on the device "
              f"(counts {steps}): equal at every step")
        if b != BATCH:
            continue
        # only lane 1 changes; bb = 8, rb = 2: the drain covers row 1
        # (index 0) and recomputes lane 0 over its sentinel cache, as
        # repro's does
        frames = torch.from_numpy(frame_stream(prog, b, 31)).to(dev)
        prev = frames.clone()
        prev[1] = (prev[1] + 1) % 2 ** io.bits
        last = thermometer_pack(prev, io.bits, io.in_channels, io.channels)
        llog = torch.full((b, dplan.classes), 777, dtype=torch.int32,
                          device=dev)
        ctrl = dplan.delta_ctrl(1.0, b).to(dev)
        kw = dict(spec=dplan.spec, bb=8, rb=2)
        want = mk.delta_plain(dimage, frames, last, llog, ctrl, **kw)
        got = mk.delta_forward(dimage, frames, last, llog, ctrl, **kw)
        torch.cuda.synchronize()
        errs["delta"] = max(errs["delta"], max_abs_err_all(got, want))
        fresh = mk.megakernel_plain(dimage, frames[:2], spec=dplan.plan.mega)
        if not (got[3].tolist() == [1, 2] and torch.equal(got[0][:2], fresh)
                and (got[0][2:] == 777).all()
                and torch.equal(got[1][0], last[0])):
            raise AssertionError(f"delta {name} lane-0 drain case: counts "
                                 f"{got[3].tolist()}")
        print(f"  delta {name} lane-0 drain case (only lane 1 changed, rb "
              f"2): lane 0 recomputed over its cache, its last words kept; "
              f"equal")

    # the unfused packed conv: cifar9_s1's first layer, every
    # face_detector conv layer (the detector's packed-vs-float check in
    # phase 6 runs them), every other REGISTRY conv shape, all at B=8, and
    # repro's odd shapes
    face_convs = [(f"face_detector {h}x{w}", BATCH, h, w, c, f)
                  for _, h, w, c, f, _pool in (st for st in
                                               interpreter.compile_plan(
                                                   programs["face_detector"]
                                               ).mega if st[0] == "conv")]
    bc_shapes = [("cifar9_s1 layer 1", BATCH, 32, 32, 256, 256)] + face_convs
    for name, b, h, w, c, f, _pool in conv_shapes:
        if all(s[1:] != (b, h, w, c, f) for s in bc_shapes):
            bc_shapes.append((f"{name} {h}x{w}", b, h, w, c, f))
    bc_shapes += [(f"odd {b}x{h}x{w} c={c} F={f}", b, h, w, c, f)
                  for b, h, w, c, f in CONV_ODD]
    for label, b, h, w, c, f in bc_shapes:
        a = words(gen, *((b,) if b else ()), h, w, -(-c // 32)).to(dev)
        wt = words(gen, f, 4, -(-c // 32)).to(dev)
        want = bc.binary_conv2x2_plain(a, wt, c)
        got = bc.binary_conv2x2(a, wt, c=c)
        torch.cuda.synchronize()
        errs["binary_conv2x2"] = max(errs["binary_conv2x2"],
                                     max_abs_err(got, want))
        print(f"  binary_conv2x2 {label} (B={b or '3-D'}, {h}x{w}, C={c}, "
              f"F={f}): equal")
    for m, k in PACK_SHAPES:
        x = torch.randn((m, k), generator=gen)
        x.view(-1)[:5] = torch.tensor([0.0, -0.0, float("nan"), 1e-30,
                                       -1e-30])
        x.view(-1)[-3:] = torch.tensor([-0.0, float("nan"), -1.0])
        x = x.to(dev)
        # the same values 4 bytes off a 16-byte boundary take the row path
        off = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(m, k)
        paths = []
        for xi in (x, off):
            want = bp.binarize_pack_plain(xi)
            got = bp.binarize_pack(xi)
            torch.cuda.synchronize()
            errs["binarize_pack"] = max(errs["binarize_pack"],
                                        max_abs_err(got, want))
            paths.append("flat" if bp.pack_path(k, xi.data_ptr()) else "row")
        print(f"  binarize_pack M={m} K={k} (with 0.0, -0.0, NaN, "
              f"+/-1e-30), {' and '.join(paths)} paths: equal")
    for label, b, sq, h, kh, d, causal in FLASH_SHAPES:
        qkv = [torch.randn(shape, generator=gen) for shape in
               ((b, sq, h, d), (b, sq, kh, d), (b, sq, kh, d))]
        for dtype, tol in FLASH_TOL.items():
            q, k, v = (x.to(dtype).to(dev) for x in qkv)
            for probs_bf16 in (FLASH_PROBS if dtype == torch.bfloat16
                               else (None,)):
                got = fa.flash_attention(q, k, v, causal=causal,
                                         probs_bf16=probs_bf16)
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                probs_bf16=probs_bf16)
                torch.cuda.synchronize()
                err = close_err(got, want, tol)
                what = (f"flash_attention {label} B={b} S={sq} H={h} "
                        f"KH={kh} D={d} causal={causal} {str(dtype)[6:]}"
                        + (f" probs_bf16={probs_bf16}"
                           if probs_bf16 is not None else ""))
                if probs_bf16 is not None:
                    means = probs_type_errs(
                        got, want, fa.flash_attention_plain(
                            q, k, v, causal=causal,
                            probs_bf16=not probs_bf16), what)
                if dtype == torch.bfloat16 and label.endswith("prefill"):
                    errs["flash_attention"] = max(errs["flash_attention"],
                                                  err)
                print(f"  {what}: max abs err {err:.3e} (tolerance {tol})"
                      + (f"; mean abs err {means[0]:.3e}, to the other "
                         f"type's plain {means[1]:.3e}"
                         if probs_bf16 is not None else ""))

    # -- 4. end to end -------------------------------------------------------
    phase(4, "end to end: staged == megakernel == float reference")
    artifacts, offline = {}, {}
    for i, name in enumerate(("cifar9_s1", "mnist5")):
        prog = programs[name]
        plan = interpreter.compile_plan(prog)
        params = build_params(prog, seed=i, warm_bn=True, device=dev)
        artifacts[name] = interpreter.fold_params(params, prog, packed=True)
        frames = frame_stream(prog, SERVE_REQUESTS // 2, 100 + i)
        ref_l, ref_y = interpreter.forward_infer(
            interpreter.fold_params(params, prog), prog, frames, device=dev)
        st_l, st_y = plan.forward(artifacts[name], frames, device=dev)
        mg_l, mg_y = plan.forward_mega(
            interpreter.fold_params(params, prog, image=True), frames,
            device=dev)
        for what, (lg, y) in (("staged", (st_l, st_y)),
                              ("megakernel", (mg_l, mg_y))):
            if not (torch.equal(lg, ref_l) and torch.equal(y, ref_y)):
                raise AssertionError(f"{name}: {what} != float reference")
        if not torch.isfinite(ref_l).all():
            raise AssertionError(f"{name}: non-finite logits")
        if name == "cifar9_s1":
            cifar_params = params
            dplan, dimage = interpreter.pack_delta(prog, artifacts[name])
            for thr in (0.0, float("-inf")):
                out = dplan.forward_delta(
                    dimage, frames, *dplan.init_state(len(frames), device=dev),
                    dplan.delta_ctrl(thr, len(frames)), device=dev)
                if not (torch.equal(out[0], ref_l)
                        and torch.equal(out[1], ref_y)
                        and torch.equal(out[0], mg_l)
                        and int(out[5][0]) == len(frames)):
                    raise AssertionError(f"delta gate at threshold {thr} != "
                                         f"megakernel / float reference")
            print(f"  {name}: delta gate at thresholds 0 and -inf == "
                  f"megakernel == float reference")
        offline[name] = ref_y.cpu().numpy()
        print(f"  {name}: {len(frames)} frames, logits {tuple(ref_l.shape)}, "
              f"staged == megakernel == float reference (label counts "
              f"{np.bincount(offline[name], minlength=10).tolist()})")

    # composite members == solo megakernel == float reference, every tiling
    tiled = sorted({n for names in TILINGS for n in names} | set(CASCADE))
    params = {n: build_params(programs[n], seed=10 + i, warm_bn=True,
                              device=dev) for i, n in enumerate(tiled)}
    packed = {n: interpreter.fold_params(params[n], programs[n], packed=True)
              for n in tiled}
    for names in TILINGS:
        cplan, cimage = interpreter.pack_programs(
            {n: programs[n] for n in names}, {n: packed[n] for n in names})
        frames = {n: frame_stream(programs[n], 16 - 3 * i, 200 + i)
                  for i, n in enumerate(names)}
        c_l, c_y = cplan.forward(cimage, frames, device=dev)
        for i, n in enumerate(names):
            prog = programs[n]
            ref_l, ref_y = interpreter.forward_infer(
                interpreter.fold_params(params[n], prog), prog, frames[n],
                device=dev)
            mg_l, _ = interpreter.compile_plan(prog).forward_mega(
                interpreter.ensure_image(packed[n], prog), frames[n],
                device=dev)
            if not (torch.equal(c_l[i], ref_l) and torch.equal(c_y[i], ref_y)
                    and torch.equal(mg_l, ref_l)):
                raise AssertionError(f"composite {'+'.join(names)}: member "
                                     f"{n} != solo megakernel / float "
                                     f"reference")
        print(f"  composite {'+'.join(names)}: members "
              f"{[len(frames[n]) for n in names]} frames, each == solo "
              f"megakernel == float reference")

    # the fused cascade vs the float references and the host rule
    det, rec = (programs[n] for n in CASCADE)
    frames = frame_stream(det, 4 * BATCH, 300)
    ref_det, _ = interpreter.forward_infer(
        interpreter.fold_params(params[CASCADE[0]], det), det, frames,
        device=dev)
    ref_rec, _ = interpreter.forward_infer(
        interpreter.fold_params(params[CASCADE[1]], rec), rec, frames,
        device=dev)
    cplan, cimage = interpreter.pack_cascade(
        {n: programs[n] for n in CASCADE}, {n: packed[n] for n in CASCADE},
        detector=CASCADE[0], recognizer=CASCADE[1])
    bpad, rb = mk.cascade_schedule(len(frames), 8, 0)
    for margin in (float("-inf"), 0.0, median_margin(margins_of, ref_det)):
        d_l, _, r_l, _, queue, counts = cplan.forward_fused(
            cimage, frames, cplan.margin_ctrl(margin, len(frames)),
            device=dev)
        want_q = np.nonzero(margins_of(ref_det.cpu().numpy())
                            >= margin)[0]
        e = len(want_q)
        q = queue.cpu().numpy()
        if not (torch.equal(d_l, ref_det) and int(counts[0]) == e
                and np.array_equal(q[:e], want_q) and not q[e:].any()
                and torch.equal(r_l[:e], ref_rec[torch.from_numpy(want_q)
                                                 .to(dev)])
                and not r_l[e:].any()
                and int(counts[1]) == mk.drain_slots(e, bpad, rb, 1)):
            raise AssertionError(f"fused cascade at margin {margin} != "
                                 f"float references + host rule")
        print(f"  cascade {'->'.join(CASCADE)} margin {margin}: "
              f"{len(frames)} frames, {e} escalated, counts "
              f"{counts.tolist()}; det == float reference, queue == host "
              f"rule, rec[:E] == float reference on the queued frames")

    lm_checks(dev)
    expert_recurrent_checks(dev)
    codebook_vlm_checks(dev)
    flash4 = padded_head_dim_checks(dev)

    # -- 5. serve ------------------------------------------------------------
    phase(5, f"serve {SERVE_REQUESTS} requests through ChipServer "
             f"(batch {BATCH}, prefetch 2)")
    launches = {}
    for megakernel in (True, False):
        server = ChipServer({n: programs[n] for n in artifacts}, artifacts,
                            batch=BATCH, megakernel=megakernel, prefetch=2,
                            device=dev)
        streams = {n: frame_stream(programs[n], SERVE_REQUESTS // 2, 100 + i)
                   for i, n in enumerate(artifacts)}
        for j in range(SERVE_REQUESTS // 2):
            for n in artifacts:
                server.submit(n, streams[n][j])
        ops.reset_launch_counts()
        results = server.drain()
        counts = ops.launch_counts()
        server.close()
        st = server.stats()
        if st.billed != st.total_served + sum(st.padded.values()):
            raise AssertionError(f"ledger: {st.billed} billed != served + "
                                 f"padded")
        if st.total_served != SERVE_REQUESTS or len(results) != SERVE_REQUESTS:
            raise AssertionError(f"served {st.total_served} of "
                                 f"{SERVE_REQUESTS}")
        for n in artifacts:
            got = np.array([r.label for r in sorted(results,
                                                    key=lambda r: r.rid)
                            if r.program == n])
            if not np.array_equal(got, offline[n]):
                raise AssertionError(f"{n}: served labels != offline plan")
        def per_dispatch(pred):          # launches one dispatch makes
            return sum(st.variant_dispatches[n] * sum(
                1 for t in interpreter.compile_plan(programs[n]).mega
                if pred(t)) for n in artifacts)
        expect = ({"megakernel": st.dispatches} if megakernel else
                  {"conv_block": per_dispatch(lambda t: t[0] == "conv"),
                   "xnor_matmul": per_dispatch(
                       lambda t: t[0] == "fc" and not t[4]),
                   "xnor_matmul_pack": per_dispatch(
                       lambda t: t[0] == "fc" and t[4])})
        for k, v in expect.items():
            if counts[k] != v:
                raise AssertionError(f"{k}: {counts[k]} launches, want {v}")
            launches[k] = counts[k]
        mode = "megakernel" if megakernel else "staged"
        print(f"  {mode}: {st.total_served} served in {st.dispatches} "
              f"dispatches, billed {st.billed} == served + padded "
              f"{sum(st.padded.values())}; labels == offline plan; launches "
              f"{ {k: counts[k] for k in expect} }")
        print(f"  {mode}: {st.host_frames_per_s:,.0f} frames/s host "
              f"(first serve, includes warm-up), chip-model bill "
              f"{st.chip.uj_per_frame:.2f} uJ/frame, "
              f"{st.chip.frames_per_s:,.0f} frames/s at Emin [{card.smi}]")

    # the 4 x S=4 group through a shared ChipServer vs a solo one
    quad = TILINGS[0]
    lane_frames = {n: frame_stream(programs[n], 16 - 3 * i, 400 + i)
                   for i, n in enumerate(quad)}
    served = {}
    for shared in (True, False):
        server = ChipServer({n: programs[n] for n in quad},
                            {n: packed[n] for n in quad}, batch=BATCH,
                            megakernel=True, prefetch=2, device=dev,
                            shared=shared)
        for n in quad:
            server.submit_many(n, lane_frames[n])
        ops.reset_launch_counts()
        results = server.drain()
        counts = ops.launch_counts()
        server.close()
        st = server.stats()
        if st.billed != st.total_served + sum(st.padded.values()):
            raise AssertionError("shared ledger: billed != served + padded")
        solo = st.dispatches - st.shared_dispatches
        if (counts["composite"] != st.shared_dispatches
                or counts["megakernel"] != solo):
            raise AssertionError(f"shared={shared}: launches {counts}, want "
                                 f"{st.shared_dispatches} composite and "
                                 f"{solo} megakernel")
        served[shared] = {r.rid: (r.program, r.label) for r in results}
        if shared:
            if server.shared_groups != (quad,) or not st.shared_dispatches:
                raise AssertionError(f"shared groups {server.shared_groups},"
                                     f" {st.shared_dispatches} shared "
                                     f"dispatches")
            launches["composite"] = counts["composite"]
        print(f"  {'shared' if shared else 'solo'} {'+'.join(quad)}: "
              f"{st.total_served} served in {st.dispatches} dispatches "
              f"({st.shared_dispatches} shared), billed {st.billed} == "
              f"served + padded; utilization {st.array_utilization:.2f}; "
              f"launches composite {counts['composite']}, megakernel "
              f"{counts['megakernel']}")
    if served[True] != served[False] or len(served[True]) != sum(
            len(f) for f in lane_frames.values()):
        raise AssertionError("shared server labels != solo server labels")
    print("  shared labels == solo labels")

    # the face -> owner cascade, fused and host-side, on one stream
    stream = frame_stream(programs[CASCADE[0]], SERVE_REQUESTS, 500)
    margin = median_margin(margins_of, interpreter.forward_infer(
        interpreter.fold_params(params[CASCADE[0]], det), det, stream,
        device=dev)[0])
    answers = {}
    for fused in (True, False):
        server = ChipServer({n: programs[n] for n in CASCADE},
                            {n: packed[n] for n in CASCADE}, batch=BATCH,
                            megakernel=True, device=dev)
        casc = CascadePipeline(server, *CASCADE, margin=margin, fused=fused)
        casc.submit_many(stream)
        ops.reset_launch_counts()
        results = casc.drain()
        counts = ops.launch_counts()
        server.close()
        st = server.stats()
        bill = casc.report()
        if st.billed != st.total_served + sum(st.padded.values()):
            raise AssertionError("cascade ledger: billed != served + padded")
        want = ({"cascade": casc.fused_dispatches, "megakernel": 0} if fused
                else {"cascade": 0, "megakernel": st.dispatches})
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"fused={fused}: launches {counts}, want "
                                 f"{want}")
        if fused:
            launches["cascade"] = counts["cascade"]
        answers[fused] = sorted((r.rid, r.label, r.escalated)
                                for r in results)
        print(f"  cascade {'fused' if fused else 'host'} at margin "
              f"{margin}: {bill.frames} frames, {bill.escalated} escalated, "
              f"{st.dispatches} "
              f"dispatches, billed {st.billed} == served + padded "
              f"{sum(st.padded.values())}; launches {want}; bill "
              f"{bill.uj_per_frame:.2f} uJ/frame")
    if answers[True] != answers[False] or len(answers[True]) != len(stream):
        raise AssertionError("fused cascade answers != host cascade answers")
    print("  fused labels and escalations == host-side")

    # the delta-gated video path: 8 cifar9_s1 streams, on the card and
    # through the plain versions (a CPU server), and vs the float reference
    io = cifar.instrs[0]
    trace = video_trace((io.height, io.width, io.in_channels), VIDEO_STEPS,
                        streams=BATCH, seed=1000, change_rate=0.25,
                        levels=2 ** io.bits)
    flat = trace.frames.reshape((-1,) + trace.frames.shape[2:])
    ref_y = interpreter.forward_infer(
        interpreter.fold_params(cifar_params, cifar), cifar, flat,
        device=dev)[1].cpu().numpy()
    video = {}
    for where in (dev, torch.device("cpu")):
        server = ChipServer({"cifar9_s1": cifar},
                            {"cifar9_s1": artifacts["cifar9_s1"]},
                            batch=BATCH, megakernel=True, device=where)
        pipe = TemporalPipeline(server, "cifar9_s1", threshold=1.0, rb=2)
        for t in range(len(trace)):
            pipe.submit_many(trace.frames[t])
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        results = pipe.drain()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        st = server.stats()
        bill = pipe.report()
        if st.billed != st.total_served + sum(st.padded.values()):
            raise AssertionError("temporal ledger: billed != served + padded")
        want = {k: 0 for k in counts}
        if where.type == "cuda":
            want["delta"] = pipe.gated_dispatches
            launches["delta"] = counts["delta"]
        if counts != want or pipe.gated_dispatches != VIDEO_STEPS:
            raise AssertionError(f"temporal on {where}: launches {counts}, "
                                 f"want {want}")
        video[where.type] = [(r.rid, r.label, r.computed, r.delta)
                             for r in results]
        labels = np.array([r.label for r in sorted(results,
                                                   key=lambda r: r.rid)])
        if not np.array_equal(labels, ref_y):
            raise AssertionError(f"temporal labels on {where} != float "
                                 f"reference (threshold 1)")
        print(f"  temporal cifar9_s1 on {where.type}: {bill.frames} frames "
              f"({BATCH} streams x {VIDEO_STEPS} steps, change rate 0.25), "
              f"{bill.computed} computed + {bill.computed_padded} drain "
              f"padding, skip ratio {bill.skip_ratio:.4f}; billed "
              f"{st.billed} == served + padded; {bill.uj_per_frame:.4f} "
              f"uJ/frame vs {bill.uj_per_frame_ungated:.4f} ungated; "
              f"{bill.frames / wall:,.1f} frames/s host; launches "
              f"{ {k: v for k, v in counts.items() if v} }; labels == "
              f"float reference" + (f" [{card.smi}]" if where.type == "cuda"
                                    else ""))
    if video["cuda"] != video["cpu"]:
        raise AssertionError("temporal results on the card != plain versions")
    print("  temporal results (label, computed, delta) on the card == plain "
          "versions")

    # the cifar10 family lane under the operating-point controller, with a
    # budget between the S=1 and S=2 powers so the variant switches
    fam = networks.FAMILIES["cifar10"]
    fparams = {n: build_params(programs[n], seed=40 + i, warm_bn=True,
                               device=dev) for i, n in enumerate(fam)}
    powers = {n: energy.analyze_net(programs[n]).power_w * 1e6 for n in fam}
    budget = (powers["cifar9_s1"] + powers["cifar9_s2"]) / 2
    fart = {n: interpreter.fold_params(fparams[n], programs[n], packed=True)
            for n in fam}
    ftrace = video_trace((io.height, io.width, io.in_channels), 8,
                         streams=BATCH, seed=1001, change_rate=0.25,
                         levels=2 ** io.bits)
    fflat = ftrace.frames.reshape((-1,) + ftrace.frames.shape[2:])
    family = {}
    for where in (dev, torch.device("cpu")):
        server = ChipServer({n: programs[n] for n in fam}, fart, batch=BATCH,
                            device=where, families={"cifar10": fam},
                            budget_uj_s=budget)
        pipe = TemporalPipeline(server, "cifar10", threshold=1.0, rb=2)
        for t in range(len(ftrace)):
            pipe.submit_many(ftrace.frames[t])
        ops.reset_launch_counts()
        results = pipe.drain()
        counts = ops.launch_counts()
        st = server.stats()
        want = {k: 0 for k in counts}
        if where.type == "cuda":
            want["delta"] = pipe.gated_dispatches
        if counts != want:
            raise AssertionError(f"family lane on {where}: launches {counts}, "
                                 f"want {want}")
        used = sorted({r.variant for r in results})
        if len(used) < 2:
            raise AssertionError(f"family lane served only {used}")
        if not (st.billed == st.total_served + sum(st.padded.values()) == sum(
                server._vserved[v] + server._vpadded[v] for v in fam)):
            raise AssertionError("family ledger: billed != served + padded, "
                                 "per lane and per variant")
        refs = {v: interpreter.forward_infer(
            interpreter.fold_params(fparams[v], programs[v]), programs[v],
            fflat, device=dev)[1].cpu().numpy() for v in used}
        for r in results:
            if r.label != refs[r.variant][r.rid]:
                raise AssertionError(f"family frame {r.rid} on {where}: "
                                     f"label != float reference of "
                                     f"{r.variant}")
        bill = pipe.report()
        family[where.type] = (
            [(r.rid, r.label, r.computed, r.delta, r.variant,
              tuple(np.asarray(r.logits).tolist())) for r in results],
            st.billed, dict(server._vserved), dict(server._vpadded),
            dict(st.variant_dispatches), (bill.frames, bill.computed,
                                          bill.computed_padded,
                                          bill.uj_per_frame))
        print(f"  temporal cifar10 family on {where.type} under "
              f"operating-point (budget {budget:,.1f} uJ/s): {bill.frames} "
              f"frames, variants "
              f"{ {v: n for v, n in st.variant_dispatches.items() if n} }, "
              f"downshift ratio {st.downshift_ratio:.3f}, skip ratio "
              f"{bill.skip_ratio:.4f}, {bill.computed} computed + "
              f"{bill.computed_padded} drain padding, "
              f"{bill.uj_per_frame:.4f} uJ/frame; launches "
              f"{ {k: v for k, v in counts.items() if v} }; labels == float "
              f"reference of each chosen variant")
    if family["cuda"] != family["cpu"]:
        raise AssertionError("family lane on the card != plain versions")
    print("  family results (label, computed, delta, variant, logits), "
          "per-variant ledger and bill on the card == plain versions")

    lm_report, lm_counts = lm_serve(card)
    launches["flash_attention"] = lm_counts["flash_attention"]
    er_reports, er_flash = lm_serves(card)
    launches["flash_attention"] += er_flash
    vlm_report, vlm_flash = vlm_serve(card, dev)
    launches["flash_attention"] += vlm_flash

    # -- 5b. continuous serving and the fleet --------------------------------
    phase("5b", f"continuous serving (SLO {CONT_SLO_MS:.0f} ms, batch "
                f"{CONT_BATCH}) and a fleet of 2 replicas with a kill")
    by_phase = {k: {"5": v} for k, v in launches.items()}
    # the padded head dims' prefills of phase 4 (fault 3.5's path)
    by_phase["flash_attention"] = {"4": flash4,
                                   **by_phase["flash_attention"]}
    launches["flash_attention"] += flash4
    for k, v in serving_phase(card, dev, programs, artifacts, offline,
                              cifar_params, quad, packed, lane_frames,
                              served[True], errs).items():
        by_phase[k]["5b"] = v
        launches[k] += v

    # -- 5c. the autotune cache ---------------------------------------------
    phase("5c", "the autotune cache: cluster and conv geometry grids, "
                "bit-exact and timed (graph ms), cache resolution, "
                "chip_serve --autotune")
    t5c = time.perf_counter()
    _, counts = autotune_phase(card, dev, programs, artifacts,
                               {n: packed[n] for n in quad})
    for k in ("conv_block", "xnor_matmul", "xnor_matmul_pack", "megakernel",
              "composite"):
        if not counts.get(k):
            raise AssertionError(f"phase 5c never launched {k}")
        by_phase[k]["5c"] = counts[k]
        launches[k] += counts[k]
    print(f"  phase 5c took {time.perf_counter() - t5c:.1f} s")

    # -- 6. train -> fold -> serve -------------------------------------------
    phase(6, f"train -> fold -> serve on the card (face_detector "
             f"{DETECTOR_STEPS} steps, owner_detector {OWNER_STEPS} steps, "
             f"batch {TRAIN_BATCH}; BitLinear {BITLINEAR[0]} -> "
             f"{BITLINEAR[1]})")
    counts, trained = train_phase(card, dev, gen, programs)
    launches["binary_conv2x2"] = counts["binary_conv2x2"]
    launches["binarize_pack"] = counts["binarize_pack"]
    # xnor_matmul runs on three main paths: the staged serve (phase 5,
    # cifar9_s1's FC layers), the fleet (phase 5b) and BitLinear's packed
    # path (phase 6)
    by_phase["xnor_matmul"]["6"] = counts["xnor_matmul"]
    launches["xnor_matmul"] += counts["xnor_matmul"]
    face, owner = programs["face_detector"], programs["owner_detector"]

    # -- 6b. LM training at full width ---------------------------------------
    phase("6b", f"LM training: {LM_ARCH} quant=binary at full width, "
                f"{LM_TRAIN_STEPS} adamw steps of {LM_TRAIN_BATCH} x "
                f"{LM_TRAIN_SEQ}; the binary-LM example twin")
    t6b = time.perf_counter()
    ops.reset_launch_counts()
    lm_train_phase(card, dev)
    t_cb = time.perf_counter()
    codebook_vlm_train(card, dev)
    print(f"  {MUSIC_ARCH} and {VLM_ARCH} training took "
          f"{time.perf_counter() - t_cb:.1f} s")
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    # BitLinear trains as a float +/-1 matmul and attention in training is
    # chunked (the flash kernel has no backward): only the example's
    # greedy decode runs a row of the table, flash attention at prefill
    by_phase["flash_attention"]["6b"] = counts.get("flash_attention", 0)
    launches["flash_attention"] += counts.get("flash_attention", 0)
    print(f"  phase 6b launches of the table's kernels: {counts or 'none'}; "
          f"took {time.perf_counter() - t6b:.1f} s")

    # -- 7. times ------------------------------------------------------------
    phase(7, f"times (CUDA-graph events, with CUDA events back to back and "
             f"torch.profiler device time beside them, warm L2) "
             f"[{card.smi}]")
    t7 = time.perf_counter()
    rows = {}

    # timed_by names what ms and library_ms measure: "cuda_graph_events",
    # a call's mean over GRAPH_CALLS calls captured in one CUDA graph and
    # replayed between two CUDA events (timing.graph_ms: device time with
    # no host gap, and no drift within this long process); "cuda_events",
    # the mean over back-to-back calls (host launch path included), where
    # a call cannot be captured.  events holds (events ms, library events
    # ms, profiler ms, library profiler ms): the back-to-back events and
    # torch.profiler's device time a call, kept beside the graph reading.
    # bound_ms: with macs (the rows whose work is binary MACs) the tensor
    # cores' bound at the binary MAC peak, the CUDA-core (popc issue) bound
    # beside it as cuda_core_bound_ms; without, the popc bound or the
    # given one.  shape labels a row timed at more than one shape: the
    # first call makes the row, later ones add their numbers under
    # "shapes"
    def row(name, ms, plain_ms, nbytes, word_ops, library_ms, bound=None,
            timed_by="cuda_graph_events", events=None, macs=None,
            shape=None):
        if macs is not None:
            bound = card.mac_bound(nbytes, macs)
        bound_ms, bound_by = bound or card.popc_bound(nbytes, word_ops)
        entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms,
                     timed_by=timed_by)
        if name not in rows:
            rows[name] = dict(name=name, route="cuda", source=SOURCES[name],
                              replaces=REPLACES[name],
                              launches=launches[name],
                              max_abs_err=errs[name], **entry,
                              launch_floor_ms=card.floor_ms)
            if len(by_phase.get(name, {})) > 1:
                rows[name]["launches_by_phase"] = by_phase[name]
            if shape is not None:
                rows[name]["shape"] = shape
            entry = rows[name]
        else:
            entry["shape"] = shape
            rows[name].setdefault("shapes", []).append(entry)
        extra = ""
        if events is not None:
            entry.update(events_ms=events[0], library_events_ms=events[1],
                         profiler_ms=events[2],
                         library_profiler_ms=events[3])
            extra += (f"; CUDA events back to back: {events[0]:.4f} ms, "
                      f"library " + (f"{events[1]:.4f} ms"
                                     if events[1] is not None else "none")
                      + "; torch.profiler device: " + ", library ".join(
                          f"{x:.4f} ms" if x is not None else "none"
                          for x in events[2:]))
        if macs is not None:
            core_ms, core_by = card.popc_bound(nbytes, word_ops)
            entry.update(cuda_core_bound_ms=core_ms,
                         cuda_core_bound_by=core_by)
            extra += (f"; CUDA-core bound {core_ms:.5f} ms ({core_by}; "
                      f"{word_ops / 1e9:.4f} G xor+popc words)")
        print(f"  {name}" + (f" {shape}" if shape else "")
              + f": {ms:.5f} ms, plain {plain_ms:.4f} ms, "
              + ("tensor-core bound " if macs is not None else "bound ")
              + f"{bound_ms:.5f} ms ({bound_by}"
              + (f"; {macs / 1e9:.4f} G binary MACs" if macs else "")
              + "), library "
              + (f"{library_ms:.5f} ms" if library_ms is not None else "none")
              + f" (timed by {timed_by}){extra} [{card.smi}]")

    def timings(kernel, kname, library, iters):
        """The kernel's ms a call and the library call's, each from a CUDA
        graph of GRAPH_CALLS calls between CUDA events, with CUDA events
        over back-to-back calls and torch.profiler's device time (of the
        kernels named kname; all of the library call's) beside them: (ms,
        library ms, timed_by, (events ms, library events ms, profiler ms,
        library profiler ms)).  A call that cannot be captured keeps the
        back-to-back events, and timed_by says so."""
        events = (time_ms(kernel, iters),
                  time_ms(library, iters) if library else None,
                  device_ms(kernel, iters, kname),
                  device_ms(library, iters) if library else None)
        try:
            return (graph_ms(kernel, GRAPH_CALLS),
                    graph_ms(library, GRAPH_CALLS) if library else None,
                    "cuda_graph_events", events)
        except RuntimeError as e:
            print(f"    not capturable in a CUDA graph ({kname or 'all'}): "
                  f"{str(e).splitlines()[0]}; CUDA events back to back "
                  f"stand in")
            return events[0], events[1], "cuda_events (not capturable)", \
                events

    # conv_block: the 8 conv layers of one cifar9_s1 dispatch at batch 8
    conv = [s for s in conv_shapes if s[0] == "cifar9_s1"]
    ops_in = []
    for _, b, h, w, c, f, pool in conv:
        a = words(gen, b, h, w, c // 32).to(dev)
        wt = words(gen, f, 4, c // 32).to(dev)
        tau = torch.randint(-4 * c, 4 * c + 1, (f,), generator=gen,
                            dtype=torch.int32).to(dev)
        flip = torch.randint(0, 2, (f,), generator=gen,
                             dtype=torch.int32).to(dev)
        # the library yardstick reads the same bits, unpacked to +/-1 fp16
        # (sums up to 4*256 are exact): NCHW maps, (F, C, 2, 2) taps
        xh = unpack_signs(a, c).permute(0, 3, 1, 2).to(torch.float16)
        wh = unpack_signs(wt, c).reshape(f, 2, 2, c).permute(
            0, 3, 1, 2).to(torch.float16)
        ops_in.append((a, wt, tau, flip, b, h, w, c, f, pool, xh, wh))
    # bound: each map, tap, threshold and output word moved once; the
    # binary MACs count every conv position a layer computes (all four of
    # a pool window's), F features x 4c bits each
    nbytes = word_ops = macs = 0
    for a, wt, tau, flip, b, h, w, c, f, pool, *_ in ops_in:
        ho, wo = ((h - 1) // 2, (w - 1) // 2) if pool else (h - 1, w - 1)
        positions = 4 * ho * wo if pool else ho * wo
        nbytes += 4 * (a.numel() + wt.numel() + 2 * f + b * ho * wo * f // 32)
        word_ops += b * positions * f * 4 * (c // 32)
        macs += b * positions * f * 4 * c
    ms, lib_ms, timed_by, events = timings(
        lambda: [bcb.binary_conv2x2_block(a, wt, tau, flip, c=c, pool=pool)
                 for a, wt, tau, flip, b, h, w, c, f, pool, *_ in ops_in],
        "conv_block_mma",
        lambda: [torch.nn.functional.conv2d(xh, wh)
                 for *_, xh, wh in ops_in], 50)
    row("conv_block", ms,
        time_ms(lambda: [bcb.conv_block_body(a, wt, tau, flip, k4=4 * c,
                                             h=h, wd=w, pool=pool)
                         for a, wt, tau, flip, b, h, w, c, f, pool, *_
                         in ops_in], 5),
        nbytes, word_ops, lib_ms, timed_by=timed_by, events=events,
        macs=macs)
    for a, wt, tau, flip, b, h, w, c, f, pool, xh, wh in ops_in:
        t = bcb.conv_tiles(b, h, w, f, c // 32, pool, sms=card.sms)
        lms, llib, lby, lev = timings(
            lambda: bcb.binary_conv2x2_block(a, wt, tau, flip, c=c,
                                             pool=pool),
            "conv_block_mma", lambda: torch.nn.functional.conv2d(xh, wh), 50)
        print(f"    layer {h}x{w} C={c} pool={pool}: {lms:.4f} ms, conv2d "
              f"{llib:.4f} ms ({lby}); events {lev[0]:.4f} / {lev[1]:.4f} "
              f"ms; grid {t.grid}, {t.rows} rows a band, {t.nslices} "
              f"slices a block, {t.smem} B shared memory")

    # xnor_matmul at BitLinear's SmolLM-360M up-projection (phase 6: the
    # row) and at cifar9_s1's last FC layer (phase 5); xnor_matmul_pack at
    # mnist5's hidden layer (the row), at the serve batch and at
    # BitLinear's shape, where the work and not the launch sets the time
    # (no path packs there); the library call is a bf16 matmul of the same
    # +/-1 values (sums up to K are exact in float32 accumulation)
    for key, (label, m, n, k, pack) in (("xnor_matmul", fc_shapes[3]),
                                        ("xnor_matmul", fc_shapes[0]),
                                        ("xnor_matmul_pack", fc_shapes[1]),
                                        ("xnor_matmul_pack", fc_shapes[4]),
                                        ("xnor_matmul_pack", fc_shapes[5])):
        kw = -(-k // 32)
        a, wt = words(gen, m, kw).to(dev), words(gen, n, kw).to(dev)
        ab = unpack_signs(a, k).to(torch.bfloat16)        # same bits, +/-1
        wb = unpack_signs(wt, k).t().contiguous().to(torch.bfloat16)
        out_words = m * (n // 32 if pack else n)
        ms, lib_ms, timed_by, events = timings(
            lambda: xm.xnor_matmul(a, wt, k, pack_out=pack),
            "xnor_mma_kernel", lambda: torch.matmul(ab, wb), 200)
        row(key, ms,
            time_ms(lambda: xm.xnor_matmul_plain(a, wt, k, pack_out=pack),
                    20),
            4 * (a.numel() + wt.numel() + out_words), m * n * kw,
            lib_ms, timed_by=timed_by, events=events, macs=m * n * k,
            shape=f"{label} M={m} K={k} N={n}")
        t = xm.xnor_tiles(m, n, kw, card.sms, pack)
        print(f"    tiles {t.bm} x {t.bn} ({t.wm} x {t.wn} warps of "
              f"m16 x n{8 * t.tn}), grid {t.grid}, {t.nchunks} chunks "
              f"of {t.kchunk} K steps, {t.smem} B shared memory")

    plan = interpreter.compile_plan(cifar)
    image = interpreter.ensure_image(artifacts["cifar9_s1"], cifar)
    io = plan.mega[0]
    geo = mk.cluster_geometry(mk.solo_member_spec(plan.mega))
    print(f"  megakernel cifar9_s1: clusters of {geo.cluster} blocks of "
          f"{mk.CLUSTER_WARPS} warps, a cluster a frame, {geo.smem} B "
          f"dynamic shared memory a block")
    for b in (BATCH, SERVE_BATCH):
        frames = torch.from_numpy(frame_stream(cifar, b, 7)).to(dev)
        nbytes = 4 * (frames.numel() + sum(v.numel() for v in image.values())
                      + io[5] // io[3] + b * plan.mega[-1][2])
        ms, _, timed_by, events = timings(
            lambda: mk.megakernel_forward(image, frames, spec=plan.mega),
            "composite_kernel", None, 20)
        plain_ms = time_ms(lambda: mk.megakernel_plain(image, frames,
                                                       spec=plan.mega), 3)
        if b == BATCH:
            row("megakernel", ms, plain_ms, nbytes,
                member_word_ops(plan.mega, b), None, timed_by=timed_by,
                events=events, macs=32 * member_word_ops(plan.mega, b))
        else:
            bound, by = card.mac_bound(nbytes,
                                       32 * member_word_ops(plan.mega, b))
            print(f"  megakernel cifar9_s1 B={b}: {ms:.4f} ms ({timed_by}; "
                  f"events {events[0]:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"tensor-core bound {bound:.5f} ms ({by}) [{card.smi}]")

    for batch, n_req in ((BATCH, 128), (256, 1024)):
        server = ChipServer({"cifar9_s1": cifar},
                            {"cifar9_s1": artifacts["cifar9_s1"]},
                            batch=batch, megakernel=True, prefetch=2,
                            device=dev)
        stream = frame_stream(cifar, n_req, 300)
        for rep in range(2):                     # warm-up, then measured
            server.reset_stats()
            server.submit_many("cifar9_s1", stream)
            server.drain()
        st = server.stats()
        server.close()
        print(f"  serve cifar9_s1 megakernel batch {batch}: "
              f"{st.host_frames_per_s:,.1f} frames/s host ({n_req} frames, "
              f"{st.dispatches} dispatches, prefetch 2) [{card.smi}]")

    # composite: the 4 x S=4 quad at B=8 per member
    cplan, cimage = interpreter.pack_programs(
        {n: programs[n] for n in quad}, {n: packed[n] for n in quad})
    cimage = {k: v.to(dev) for k, v in cimage.items()}
    frames = tuple(torch.from_numpy(frame_stream(programs[n], BATCH, 600 + i))
                   .to(dev) for i, n in enumerate(quad))
    nbytes = 4 * (sum(f.numel() for f in frames) + BATCH * sum(cplan.classes)
                  + sum(st[0][5] // st[0][3] for st in cplan.spec))
    geo = mk.cluster_geometry(cplan.spec)
    print(f"  composite {'+'.join(quad)}: {len(quad)} x {BATCH} clusters of "
          f"{geo.cluster} blocks, {geo.smem} B dynamic shared memory a block")
    ms, _, timed_by, events = timings(
        lambda: mk.composite_forward(cimage, frames, spec=cplan.spec),
        "composite_kernel", None, 20)
    row("composite", ms,
        time_ms(lambda: mk.composite_plain(cimage, frames, spec=cplan.spec),
                3),
        nbytes + image_bytes(cimage),
        sum(member_word_ops(st, BATCH) for st in cplan.spec), None,
        timed_by=timed_by, events=events,
        macs=32 * sum(member_word_ops(st, BATCH) for st in cplan.spec))

    # cascade: face -> owner at B=8; the row is margin -inf (every frame
    # escalates, so E = counts[1] = B and the recognizer work is the same
    # under either count); margin 0, the batch's median margin and +inf
    # (none escalates) are timed beside it, -inf and +inf split by kernel,
    # and -inf with the detector at each cluster shape
    cplan, cimage = interpreter.pack_cascade(
        {n: programs[n] for n in CASCADE}, {n: packed[n] for n in CASCADE},
        detector=CASCADE[0], recognizer=CASCADE[1])
    cimage = {k: v.to(dev) for k, v in cimage.items()}
    frames = torch.from_numpy(frame_stream(det, BATCH, 700)).to(dev)
    det_spec, rec_spec = cplan.spec
    det_l = mk.cascade_plain(cimage, frames, cplan.margin_ctrl(0.0, BATCH)
                             .to(dev), spec=cplan.spec)[0]
    det_geo, rec_geo = mk.cascade_geometry(cplan.spec, BATCH, card.sms)
    print(f"  cascade {'->'.join(CASCADE)} B={BATCH}: detector clusters of "
          f"{det_geo.cluster}, recognizer clusters of {rec_geo.cluster}, "
          f"{mk.CLUSTER_WARPS} warps a block; earlier (the one-block body, "
          f"one block a frame on the CUDA cores; PERF.md section 6): "
          f"{CASCADE_EARLIER_MS} ms device time at margin -inf")
    for margin in (float("-inf"), 0.0, median_margin(margins_of, det_l),
                   float("inf")):
        ctrl = cplan.margin_ctrl(margin, BATCH).to(dev)
        call = lambda: mk.cascade_forward(cimage, frames, ctrl,
                                          spec=cplan.spec)
        counts = call()[3].tolist()
        e = counts[0]
        nbytes = 4 * (frames.numel() + 2 + BATCH * (sum(cplan.classes) + 1)
                      + 2 + det_spec[0][5] // det_spec[0][3]
                      + rec_spec[0][5] // rec_spec[0][3])
        ops_e = (member_word_ops(det_spec, BATCH)
                 + member_word_ops(rec_spec, e))
        ms, _, timed_by, events = timings(call, "", None, 20)
        if margin in (float("-inf"), float("inf")):
            _, kernels = device_profile(call, 20)
            print(f"  cascade margin {margin} profiled: "
                  + (kernel_split(kernels, 20, ("detector_kernel",
                                                "escalate_kernel",
                                                "recognizer_kernel"))
                     if kernels else "no device activity recorded, the "
                     "split not measured"))
        if margin == float("-inf"):
            for n in DET_CLUSTERS:
                alt_ms, _, alt_by, alt_ev = timings(
                    lambda: mk.cascade_forward(cimage, frames, ctrl,
                                               spec=cplan.spec,
                                               det_cluster=n),
                    "", None, 20)
                print(f"  cascade margin -inf, detector at clusters of {n}: "
                      f"{alt_ms:.4f} ms ({alt_by}; events {alt_ev[0]:.4f} "
                      f"ms) [{card.smi}]")
            row("cascade", ms,
                time_ms(lambda: mk.cascade_plain(cimage, frames, ctrl,
                                                 spec=cplan.spec), 3),
                nbytes + image_bytes(cimage), ops_e, None,
                timed_by=timed_by, events=events, macs=32 * ops_e)
        else:
            bound_e, _ = card.mac_bound(nbytes + image_bytes(cimage),
                                        32 * ops_e)
            bound_bill, _ = card.mac_bound(
                nbytes + image_bytes(cimage),
                32 * (member_word_ops(det_spec, BATCH)
                      + member_word_ops(rec_spec, counts[1])))
            print(f"  cascade margin {margin}: {ms:.4f} ms ({timed_by}), E "
                  f"{e}, counts[1] "
                  f"{counts[1]}; tensor-core bound {bound_e:.5f} ms on E "
                  f"recognizer frames, {bound_bill:.5f} ms on counts[1] "
                  f"[{card.smi}]")

    # delta: cifar9_s1 at B=8 on a warm state; the row is threshold -inf
    # (E = 8 recomputed), E = 0 (+inf) and the median delta are timed
    # beside it
    dplan, dimage = interpreter.pack_delta(cifar, artifacts["cifar9_s1"])
    dimage = {k: v.to(dev) for k, v in dimage.items()}
    frames = torch.from_numpy(frame_stream(cifar, BATCH, 1100)).to(dev)
    last, llog = warm_delta_state(thermometer_pack, cifar, frames,
                                  dplan.classes, gen)
    member = dplan.spec[0]
    items = last[0].numel()
    deltas = mk.delta_plain(dimage, frames, last, llog,
                            dplan.delta_ctrl(0.0, BATCH).to(dev),
                            spec=dplan.spec)[4]
    for thr in (float("inf"), float(deltas.float().median()),
                float("-inf")):
        ctrl = dplan.delta_ctrl(thr, BATCH).to(dev)
        call = lambda: mk.delta_forward(dimage, frames, last, llog, ctrl,
                                        spec=dplan.spec)
        out = call()
        counts, queue = out[3].tolist(), out[2].tolist()
        n_fresh = fresh_rows(counts, queue, BATCH)
        # frames, the thermometer table, last, llog, ctrl in; logits,
        # new_last, queue, counts, deltas out; the image only when a
        # member frame runs
        nbytes = 4 * (frames.numel() + member[0][5] // member[0][3]
                      + 2 * last.numel() + 2 * llog.numel() + 2
                      + 2 * BATCH + 2)
        if n_fresh:
            nbytes += image_bytes(dimage)
        word_ops = BATCH * items + member_word_ops(member, n_fresh)
        ms, _, timed_by, events = timings(call, "", None, 20)
        wall_ms, kernels = device_profile(call, 20)
        if kernels:
            busy = sum(kernels.values())
            print(f"  delta threshold {thr} profiled: host {wall_ms / 20:.4f} "
                  f"ms a call, device {busy / 20:.4f} ms a call (idle share "
                  f"{1 - busy / wall_ms:.4f}); "
                  + kernel_split(kernels, 20, ("gate_kernel",
                                               "change_scan_kernel",
                                               "recompute_kernel")))
        else:
            print(f"  delta threshold {thr} profiled: no device activity "
                  f"recorded, device time not measured")
        if thr == float("-inf"):
            row("delta", ms,
                time_ms(lambda: mk.delta_plain(dimage, frames, last, llog,
                                               ctrl, spec=dplan.spec), 3),
                nbytes, word_ops, None, timed_by=timed_by, events=events,
                macs=32 * word_ops)
        else:
            bound, by = card.mac_bound(nbytes, 32 * word_ops)
            print(f"  delta threshold {thr}: {ms:.4f} ms ({timed_by}; events "
                  f"{events[0]:.4f} ms), E {counts[0]}, "
                  f"counts[1] {counts[1]}, member frames run {n_fresh}; "
                  f"tensor-core bound {bound:.5f} ms ({by}) [{card.smi}]")

    # the temporal serve of phase 5 on the card, profiled: host frames/s
    # and the device's busy and idle share over whole passes
    server = ChipServer({"cifar9_s1": cifar},
                        {"cifar9_s1": artifacts["cifar9_s1"]}, batch=BATCH,
                        megakernel=True, device=dev)
    pipe = TemporalPipeline(server, "cifar9_s1", threshold=1.0, rb=2)

    def serve_video():
        pipe.reset()
        for t in range(len(trace)):
            pipe.submit_many(trace.frames[t])
        pipe.drain()

    wall_ms, kernels = device_profile(serve_video, 3)
    frames_per_pass = len(trace) * trace.streams
    line = (f"  serve temporal cifar9_s1 {BATCH} streams x {VIDEO_STEPS} "
            f"steps: {3 * frames_per_pass / wall_ms * 1e3:,.1f} frames/s "
            f"host ({wall_ms / 3:.3f} ms a pass)")
    if kernels:
        busy = sum(kernels.values())
        line += (f", device busy {busy / 3:.3f} ms a pass (idle share "
                 f"{1 - busy / wall_ms:.4f}); "
                 + kernel_split(kernels, 3, ("gate_kernel",
                                             "change_scan_kernel",
                                             "recompute_kernel")))
    else:
        line += ", device time not measured (no device activity recorded)"
    print(line + f" [{card.smi}]")
    server.close()

    quad_stream = {n: frame_stream(programs[n], 256, 800 + i)
                   for i, n in enumerate(quad)}
    server = ChipServer({n: programs[n] for n in quad},
                        {n: packed[n] for n in quad}, batch=BATCH,
                        megakernel=True, prefetch=2, device=dev, shared=True)
    for _ in range(2):                           # warm-up, then measured
        server.reset_stats()
        for n in quad:
            server.submit_many(n, quad_stream[n])
        server.drain()
    st = server.stats()
    server.close()
    print(f"  serve shared {'+'.join(quad)} batch {BATCH}: "
          f"{st.host_frames_per_s:,.1f} frames/s host ({st.total_served} "
          f"frames, {st.dispatches} dispatches, {st.shared_dispatches} "
          f"shared, prefetch 2) [{card.smi}]")
    casc_stream = frame_stream(det, 256, 900)
    server = ChipServer({n: programs[n] for n in CASCADE},
                        {n: packed[n] for n in CASCADE}, batch=BATCH,
                        megakernel=True, device=dev)
    casc = CascadePipeline(server, *CASCADE, margin=margin, fused=True)
    for _ in range(2):                           # warm-up, then measured
        server.reset_stats()
        casc.submit_many(casc_stream)
        casc.drain()
    st = server.stats()
    server.close()
    print(f"  serve fused cascade {'->'.join(CASCADE)} batch {BATCH}: "
          f"{st.served[CASCADE[0]] / st.host_wall_s:,.1f} frames/s host "
          f"({st.served[CASCADE[0]]} frames, {st.served[CASCADE[1]]} "
          f"escalated, {st.dispatches} dispatches) [{card.smi}]")

    # binary_conv2x2: cifar9_s1's first layer at B=8 (32x32, 256 channels,
    # 256 features: 7.9 MB of int32 sums against 63 M xor+popc words); the
    # library yardstick is conv2d in fp16 on the same bits unpacked to +/-1
    # (NCHW, sums up to 4 x 256 are exact), as for conv_block
    b, h, w, c, f = BATCH, 32, 32, 256, 256
    a = words(gen, b, h, w, c // 32).to(dev)
    wt = words(gen, f, 4, c // 32).to(dev)
    xh = unpack_signs(a, c).permute(0, 3, 1, 2).to(torch.float16)
    wh = unpack_signs(wt, c).reshape(f, 2, 2, c).permute(0, 3, 1, 2).to(
        torch.float16)
    nbytes = 4 * (a.numel() + wt.numel() + b * (h - 1) * (w - 1) * f)
    ms, lib_ms, timed_by, events = timings(
        lambda: bc.binary_conv2x2(a, wt, c=c), "binary_conv2x2_mma",
        lambda: torch.nn.functional.conv2d(xh, wh), 50)
    row("binary_conv2x2", ms,
        time_ms(lambda: bc.binary_conv2x2_plain(a, wt, c), 5),
        nbytes, b * (h - 1) * (w - 1) * f * 4 * (c // 32), lib_ms,
        timed_by=timed_by, events=events,
        macs=b * (h - 1) * (w - 1) * f * 4 * c)
    for label, b, h, w, c, f in face_convs:
        a = words(gen, b, h, w, -(-c // 32)).to(dev)
        wt = words(gen, f, 4, -(-c // 32)).to(dev)
        lms, _, lby, lev = timings(lambda: bc.binary_conv2x2(a, wt, c=c),
                                   "binary_conv2x2_mma", None, 50)
        print(f"    binary_conv2x2 {label} B={b}: {lms:.4f} ms ({lby}), "
              f"events {lev[0]:.4f} ms")

    # binarize_pack: the row is BitLinear's (256 tokens, 960), then
    # cifar9_s1's layer-2 activations at B=8 and the odd shape; bytes bound
    # it (each float read once, each word written once; a word is the
    # operation count)
    for m, k in PACK_SHAPES:
        x = torch.randn((m, k), generator=gen).to(dev)
        kw = -(-k // 32)
        path = "flat" if bp.pack_path(k, x.data_ptr()) else "row"
        ms, _, timed_by, events = timings(lambda: bp.binarize_pack(x),
                                          "binarize_pack", None, 200)
        row("binarize_pack", ms,
            time_ms(lambda: bp.binarize_pack_plain(x), 20),
            4 * (m * k + m * kw), m * kw, None, timed_by=timed_by,
            events=events, shape=f"M={m} K={k} ({path} path)")

    # one training step (forward_train, autograd, adamw) of each program
    for name, prog in (("face_detector", face), ("owner_detector", owner)):
        params = trained[name]
        optimizer = opt.adamw(opt.cosine_schedule(2e-3, 20, 40))
        state = optimizer.init(params)
        images_b, labels_b = detector.detector_batch(0, TRAIN_BATCH,
                                                     device=dev)

        def train_once():
            train_step(params, state, 5, images_b, labels_b, prog=prog,
                       optimizer=optimizer, loss_fn=detector.detector_loss)

        ms = time_ms(train_once, 10)
        wall_ms, kernels = device_profile(train_once, 5)
        line = (f"  train step {name} batch {TRAIN_BATCH}: {ms:.3f} ms "
                f"({1e3 / ms:.2f} steps/s, CUDA events over 10 steps); "
                f"profiled: host {wall_ms / 5:.3f} ms a step, ")
        if kernels:
            busy = sum(kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
            line += (f"device busy {busy / 5:.3f} ms (idle share "
                     f"{1 - busy / wall_ms:.4f}), {len(kernels)} kernel "
                     f"names, top: " + ", ".join(
                         f"{k[:48]} {v / 5 * 1e3:.1f} us" for k, v in top))
        else:
            line += "device time not measured (no device activity recorded)"
        print(line + f" [{card.smi}]")

    # flash attention at the serve's prefill (B=4, S=512, H=15, KH=5,
    # D=64); the row is bf16, the serve's type, at probs_bf16=True (like
    # for like with SDPA, which rounds p to bf16 too), the serve's own
    # float32 p timed beside it.  At this shape a call's host path (the
    # wrapper's checks, ctypes; SDPA's dispatch) takes longer than the
    # kernel, so the row's ms and library ms are a call's time in a CUDA
    # graph (timed_by "cuda_graph_events"); back-to-back CUDA events,
    # printed beside, are the host path's cost a call, and the profiler's
    # device time stands beside both.  Bound: q, k, v and o once each over
    # HBM, or the causal FLOPs over the type's peak, the larger; library: one
    # scaled_dot_product_attention call (B, H, S, D), GQA
    _, b, sq, h, kh, d, causal = FLASH_SHAPES[0]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(dev)
                   for shape in ((b, sq, h, d), (b, sq, kh, d),
                                 (b, sq, kh, d)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = q.element_size() * 2 * (q.numel() + k.numel())
        flops = attention_flops(b, sq, h, d, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FLOP_PER_S[dtype] * 1e3
        bound = (max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations")

        def lib():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_events = time_ms(lib, 200, warmup=20)
        lib_device = device_ms(lib, 50)
        lib_ms = graph_ms(lib, GRAPH_CALLS)
        for probs_bf16 in (FLASH_PROBS if dtype == torch.bfloat16
                           else (None,)):
            kw = dict(causal=causal, probs_bf16=probs_bf16)

            def kernel():
                return fa.flash_attention(q, k, v, **kw)

            events = time_ms(kernel, 200, warmup=20)
            ms, timed_by = graph_ms(kernel, GRAPH_CALLS), "cuda_graph_events"
            plain_ms = time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                                **kw), 5)
            label = (f"{str(dtype)[6:]}"
                     + (f" probs_bf16={probs_bf16}"
                        if probs_bf16 is not None else ""))
            if probs_bf16:
                row("flash_attention", ms, plain_ms, nbytes, 0, lib_ms,
                    bound, timed_by,
                    events=(events, lib_events,
                            device_ms(kernel, 50, "flash_fwd"), lib_device))
                row_ms = ms
                print(f"    {label}: {ms / FLASH_EARLIER_MS:.3f} x the "
                      f"{FLASH_EARLIER_MS} ms before the padded head dims "
                      f"(the D = 64 path; graph readings drift 7% across "
                      f"calls)")
            else:
                print(f"  flash_attention {label}: {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
                      f"({bound[1]}), library {lib_ms:.4f} ms (timed by "
                      f"{timed_by}) [{card.smi}]")
            print(f"    {label}: {flops / 1e9:.3f} GFLOP causal, "
                  f"{nbytes / 1e6:.2f} MB; a call ({timed_by}): kernel "
                  f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), SDPA "
                  f"{lib_ms:.4f} ms ({flops / lib_ms / 1e9:.2f} TFLOP/s); "
                  f"host path a call (CUDA events back to back): kernel "
                  f"{events:.4f} ms, SDPA {lib_events:.4f} ms")

    # what bounds the bf16 kernel: at B=1 its 120 blocks each hold an SM
    # alone, so a call is the heaviest block's chain of key tiles (the
    # latency of a tile); at the row's B=4 three blocks share an SM, so
    # the row's time over the block-tiles an SM computes is the SM's rate
    q, k, v = (torch.randn(shape, generator=gen).bfloat16().to(dev)
               for shape in ((1, sq, h, d), (1, sq, kh, d), (1, sq, kh, d)))
    lone = graph_ms(lambda: fa.flash_attention(q, k, v, causal=causal,
                                               probs_bf16=True), GRAPH_CALLS)
    _, heaviest = flash_block_tiles(1, sq, h, kh, causal)
    tiles, _ = flash_block_tiles(b, sq, h, kh, causal)
    print(f"    bf16 probs_bf16=True, a call in a CUDA graph: B=1 "
          f"{lone:.4f} ms, {lone / heaviest * 1e3:.3f} us a key tile of the "
          f"heaviest block ({heaviest} tiles); B={b} "
          f"{row_ms * card.sms / tiles * 1e3:.3f} us a 64 x 64 block-tile "
          f"an SM ({tiles} block-tiles)")

    # the dispatcher op the main path calls (ops.flash_attention, through
    # torch.ops.repro_torch.flash_attention) beside the launcher it wraps
    # (fa.flash_attention), at SmolLM's prefill shape in bf16 with the
    # serve's own float32 p: the host's time to issue a call (200 calls
    # between two clock reads, the card left to run behind them; median
    # of 5 alternating readings) and a call's time in a CUDA graph
    _, b, sq, h, kh, d, causal = FLASH_SHAPES[0]
    q, k, v = (torch.randn(shape, generator=gen).bfloat16().to(dev)
               for shape in ((b, sq, h, d), (b, sq, kh, d), (b, sq, kh, d)))
    kw = dict(causal=causal, probs_bf16=False)
    paths = {"op": lambda: ops.flash_attention(q, k, v, **kw),
             "launcher": lambda: fa.flash_attention(q, k, v, **kw)}
    if not torch.equal(paths["op"](), paths["launcher"]()):
        raise SystemExit("FAIL: the flash op and its launcher disagree")

    def issue_us(fn, calls: int = 200) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / calls * 1e6

    for fn in paths.values():
        issue_us(fn, 20)
    host = {name: [] for name in paths}
    for _ in range(5):
        for name, fn in paths.items():
            host[name].append(issue_us(fn))
    host = {name: float(np.median(x)) for name, x in host.items()}
    graph = {name: graph_ms(fn, GRAPH_CALLS) for name, fn in paths.items()}
    print(f"    flash op vs launcher, SmolLM prefill B={b} S={sq} H={h} "
          f"KH={kh} D={d} bf16 probs_bf16=False: host issue a call "
          f"{host['op']:.2f} us (op) vs {host['launcher']:.2f} us "
          f"(launcher), +{host['op'] - host['launcher']:.2f} us; a call in "
          f"a CUDA graph {graph['op']:.5f} ms (op) vs "
          f"{graph['launcher']:.5f} ms (launcher) [{card.smi}]")

    # flash attention at the prefill shapes of OLMoE-1B-7B (B=4, S=512,
    # H=KH=16, D=128), MusicGen-medium (H=KH=24, D=64) and Qwen2-VL-2B
    # (H=12, KH=2, D=128), and at the padded head dims 8 (H=8, KH=1, on
    # the D=16 instantiation) and 20 (H=KH=3, on D=32), bf16: more shapes
    # of row 10, each at probs_bf16=True like for like with SDPA, the
    # serve's own float32 p (the configs' attn_probs_bf16 is False) beside
    # it; the same bound (of the true D) and library call as above
    for label in ("OLMoE prefill", "MusicGen prefill", "Qwen2-VL prefill",
                  "D=8 G=8 prefill", "D=20 MHA prefill"):
        t_flash = time.perf_counter()
        _, b, sq, h, kh, d, causal = next(x for x in FLASH_SHAPES
                                          if x[0] == label)
        q, k, v = (torch.randn(shape, generator=gen).bfloat16().to(dev)
                   for shape in ((b, sq, h, d), (b, sq, kh, d),
                                 (b, sq, kh, d)))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        nbytes = q.element_size() * 2 * (q.numel() + k.numel())
        flops = attention_flops(b, sq, h, d, causal)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FLOP_PER_S[torch.bfloat16] * 1e3
        bound = (max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations")

        def lib():
            return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

        lib_events = time_ms(lib, 200, warmup=20)
        lib_device = device_ms(lib, 50)
        lib_ms = graph_ms(lib, GRAPH_CALLS)
        for probs_bf16 in FLASH_PROBS:
            kw = dict(causal=causal, probs_bf16=probs_bf16)

            def kernel():
                return fa.flash_attention(q, k, v, **kw)

            events = time_ms(kernel, 200, warmup=20)
            ms = graph_ms(kernel, GRAPH_CALLS)
            plain_ms = time_ms(
                lambda: fa.flash_attention_plain(q, k, v, **kw), 5)
            shape = (f"{label} B={b} S={sq} H={h} KH={kh} D={d} bf16 "
                     f"probs_bf16={probs_bf16}")
            if probs_bf16:
                row("flash_attention", ms, plain_ms, nbytes, 0, lib_ms,
                    bound, events=(events, lib_events,
                                   device_ms(kernel, 50, "flash_fwd"),
                                   lib_device),
                    shape=shape)
            else:
                print(f"  flash_attention {shape}: {ms:.5f} ms, plain "
                      f"{plain_ms:.4f} ms, bound {bound[0]:.5f} ms "
                      f"({bound[1]}), library {lib_ms:.5f} ms (timed by "
                      f"cuda_graph_events) [{card.smi}]")
            print(f"    {shape}: {flops / 1e9:.3f} GFLOP causal, "
                  f"{nbytes / 1e6:.2f} MB; kernel {ms:.5f} ms "
                  f"({flops / ms / 1e9:.2f} TFLOP/s), SDPA {lib_ms:.5f} ms "
                  f"({flops / lib_ms / 1e9:.2f} TFLOP/s), kernel / SDPA "
                  f"{ms / lib_ms:.3f}; bound {bound[0]:.5f} ms ({bound[1]}: "
                  f"bytes {t_bytes:.5f}, operations {t_ops:.5f}); host path "
                  f"a call (CUDA events back to back): kernel {events:.4f} "
                  f"ms, SDPA {lib_events:.4f} ms")
        print(f"  row 10 at {label}'s shape took "
              f"{time.perf_counter() - t_flash:.1f} s")

    print(f"  phase 7's kernel rows took {time.perf_counter() - t7:.1f} s")
    t_lm = time.perf_counter()

    # the LM serve, warm since phase 5, profiled: prefill ms, decode ms a
    # token, tok/s, and the device's idle share over the whole serve
    # (parameter init and the host's prompt generation included)
    warm = []

    def serve_lm():
        with quiet():
            warm.append(lm.main(list(LM_SERVE)))

    wall_ms, kernels = device_profile(serve_lm, 1, warmup=False)
    rep = warm[0]
    line = (f"  LM serve {LM_ARCH} ({LM_REQUESTS} requests, batch "
            f"{LM_BATCH}, prompt {LM_PROMPT}, {LM_GEN} tokens; warm): "
            f"prefill {rep.prefill_ms} ms by batch, decode "
            f"{rep.decode_ms_per_token} ms/token by batch, "
            f"{rep.tokens_per_s:.2f} tok/s; profiled serve {wall_ms:.1f} ms")
    if kernels:
        busy = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        line += (f", device busy {busy:.1f} ms (idle share "
                 f"{1 - busy / wall_ms:.4f}), {len(kernels)} kernel names, "
                 f"top: " + ", ".join(f"{n[:40]} {t:.1f} ms" for n, t in top))
    else:
        line += ", device time not measured (no device activity recorded)"
    print(line + f" [{card.smi}]")
    print(f"  LM serve first run (phase 5): prefill "
          f"{lm_report.prefill_ms} ms, decode "
          f"{lm_report.decode_ms_per_token} ms/token, "
          f"{lm_report.tokens_per_s:.2f} tok/s")

    # where a batch's time goes: one full-batch prefill and decode steps,
    # profiled apart (host wall vs device busy, flash's share of prefill)
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    cfg = get_config(LM_ARCH)
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch_breakdown(card, dev, cfg, params, LM_BATCH, LM_PROMPT, LM_GEN)
    del params
    torch.cuda.empty_cache()
    print(f"  {LM_ARCH}'s serve profile and batch breakdown took "
          f"{time.perf_counter() - t_lm:.1f} s")

    # the OLMoE-1B-7B serve, warm since phase 5, profiled: prefill ms,
    # decode ms a token, tok/s, and the device's idle share over the whole
    # serve (the 6.92 B float32 parameters' init included); then its batch
    # of 4 and RWKV6-3B's taken apart as SmolLM's above
    t_moe = time.perf_counter()
    warm = []

    def serve_moe():
        with quiet():
            warm.append(lm.main(list(MOE_SERVE)))

    wall_ms, kernels = device_profile(serve_moe, 1, warmup=False)
    rep = warm[-1]
    line = (f"  LM serve {MOE_ARCH} (warm): prefill "
            f"{[round(x, 3) for x in rep.prefill_ms]} ms by batch, decode "
            f"{[round(x, 3) for x in rep.decode_ms_per_token]} ms/token by "
            f"batch, {rep.tokens_per_s:.2f} tok/s; profiled serve "
            f"{wall_ms:.1f} ms")
    if kernels:
        busy = sum(kernels.values())
        line += (f", device busy {busy:.1f} ms (idle share "
                 f"{1 - busy / wall_ms:.4f}), {len(kernels)} kernel names; "
                 + kernel_split(kernels, 1, ("flash_fwd", "nvjet", "gemm",
                                             "elementwise")))
    else:
        line += ", device time not measured (no device activity recorded)"
    print(line + f" [{card.smi}]")
    for argv in (MOE_SERVE, RWKV_SERVE):
        opts = dict(zip(argv[::2], argv[1::2]))
        cfg = get_config(opts["--arch"])
        params = transformer.init_params(cfg, seed=0, device=dev)
        batch_breakdown(card, dev, cfg, params, int(opts["--batch"]),
                        int(opts["--prompt-len"]), int(opts["--gen-len"]))
        del params
        torch.cuda.empty_cache()
    print(f"  {MOE_ARCH}'s serve profile and the batch breakdowns of "
          f"{MOE_ARCH} and {RWKV_ARCH} took "
          f"{time.perf_counter() - t_moe:.1f} s")
    # MusicGen-medium's batch of 4 taken apart the same way: the device's
    # idle share over its decode steps (and its prefill)
    t_cb = time.perf_counter()
    opts = dict(zip(MUSIC_SERVE[::2], MUSIC_SERVE[1::2]))
    cfg = get_config(MUSIC_ARCH)
    params = transformer.init_params(cfg, seed=0, device=dev)
    batch_breakdown(card, dev, cfg, params, int(opts["--batch"]),
                    int(opts["--prompt-len"]), int(opts["--gen-len"]))
    del params
    torch.cuda.empty_cache()
    print(f"  {MUSIC_ARCH}'s batch breakdown took "
          f"{time.perf_counter() - t_cb:.1f} s")
    first = er_reports[MUSIC_ARCH]
    print(f"  LM serve {MUSIC_ARCH} first run (phase 5): prefill "
          f"{first.prefill_ms} ms, decode {first.decode_ms_per_token} "
          f"ms/token, {first.tokens_per_s:.2f} tok/s; {VLM_ARCH} (train.serve "
          f"steps, warm): prefill {vlm_report['prefill_ms']:.3f} ms, decode "
          f"{vlm_report['decode_ms']:.3f} ms a step")
    first = er_reports[MOE_ARCH]
    print(f"  LM serve {MOE_ARCH} first run (phase 5): prefill "
          f"{first.prefill_ms} ms, decode {first.decode_ms_per_token} "
          f"ms/token, {first.tokens_per_s:.2f} tok/s; {RWKV_ARCH}: prefill "
          f"{er_reports[RWKV_ARCH].prefill_ms} ms, decode "
          f"{er_reports[RWKV_ARCH].decode_ms_per_token} ms/token, "
          f"{er_reports[RWKV_ARCH].tokens_per_s:.2f} tok/s")

    # -- 8. the cost model ----------------------------------------------------
    phase(8, f"the cost model: {LM_ARCH}'s dry run on meta, then whole steps "
             f"counted on the card == on meta, timed, against the roofline "
             f"[{card.smi}]")
    t8 = time.perf_counter()
    n8 = cost_phase(card, dev) + scan_cost_checks(card, dev)
    by_phase["flash_attention"]["8"] = n8
    rows["flash_attention"]["launches"] += n8
    print(f"  phase 8 took {time.perf_counter() - t8:.1f} s")

    # -- 9. the training meshes --------------------------------------------
    phase(9, "the training meshes at world size 1: the host mesh, shard "
             "shapes, a step under the mesh == the step without; the "
             "sharded step counted (a (1, 1) DTensor step == the plain "
             "one, a fake (2, 4) group's blocks on the card == on meta at "
             "even and uneven head splits, heads shared by query rows and "
             "a decode at a batch of one, a pod cell on meta beside the "
             "CPU's count)")
    n9 = mesh_phase(dev)
    by_phase["flash_attention"]["9"] = n9
    rows["flash_attention"]["launches"] += n9

    # -- 10. the collectives and expert parallelism ---------------------------
    phase(10, "the collectives at world size 1 on a one-rank NCCL group: "
              f"{MOE_ARCH}'s MoE layer through apply_ep and "
              f"apply_ep_decode, the compressed psum over {LM_ARCH}'s "
              f"gradients, a one-stage pipeline")
    collective_phase(card, dev)

    print(json.dumps({"kernels": [rows[k] for k in REPLACES]}))
    print(card.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card.name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
