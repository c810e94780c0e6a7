#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each of which exits non-zero on a failed check:
  1. the card's name and power limit; build the CUDA kernels from csrc/,
     one nvcc per source, all started together; each instantiation's
     registers and spills (ptxas), and the serving instantiations' shared
     memory and CTAs per SM;
  2. each kernel (flash attention, the SSD scan) against its plain PyTorch
     version on the card, over the JAX package's test shapes, the serving
     paths' shapes and the bf16 tensor-core paths' shapes (flash also held
     to a relative L2 error over its whole output), and timed at
     both serving waves beside the plain version, its bound and, where one
     exists, a PyTorch library call, as eager calls and as device time
     over a CUDA graph; and the flash training kernels' forward and
     backward at olmo-1b's training shape, each beside its bound, with the
     plain version's and `scaled_dot_product_attention`'s forward and
     backward;
  3. the attention path: full-width smollm-135m (random weights from a
     seed) served by `ServeEngine`, 8 prompts of 512 tokens and 4 of 128,
     32 new tokens each; the launch counts must show that every layer's
     prefill attention went through the flash kernel;
  3b. the Mamba path: full-width mamba2-1.3b served the same way; every
     layer's prefill scan must go through the SSD kernel;
  3e. after 3 and after 3b, for each model, last-position logits of one prompt prefilled
     through the kernel against the same prompt half prefilled, half
     decoded token by token through the plain decode path over the cache
     (for mamba2-1.3b held in fp32 activations, printed in bf16);
  3f. the MoE path (after 3b): full-width granite-moe-3b-a800m (40 experts
     padded to 48, top-8) served the same way, every layer's prefill
     attention through the flash kernel and the scan never; its parameter
     and active counts, memory, and capacities printed; a decode step
     profiled (host enqueue, device busy, launches, top kernels). Then 3e
     on a drop-free copy of it (capacity factor = expert count: a batched
     prefill drops tokens over capacity, a decode step never does); granite
     cut to 2 layers on the card and on the host CPU from one set of
     weights, prefill logits of 2 prompts of 128, `lm_loss` with its aux
     term and the router and expert gradients held in fp32 activations,
     bf16 and the share of routing decisions that agree printed; and
     reduced jamba-1.5-large-398b (attention, Mamba and MoE blocks in one
     stack, both kernels) on the card against the host;
  3g. the encoder-decoder path (after 3f): full-width whisper-large-v3
     (32 encoder and 32 decoder layers, random weights from a seed) through
     the port's driver (`repro_torch.launch.serve`), 8 requests of 1500
     stub frames, an 8-token decoder prompt and 32 new tokens each, its
     weights published to and restored from a simulated store at 10 ms a
     request and 2000 MB/s; every encoder layer's self-attention through
     the flash kernel unmasked and every decoder layer's prompt through it
     causal (64 launches), no scan, ids in range. Then whisper cut to 2
     encoder and 2 decoder layers on the card and on the host CPU from one
     set of weights: encoder states, prefill logits, 8 decode steps,
     `encdec_loss` and its gradients held in fp32 activations, bf16
     printed; full-depth whisper's teacher-forced logits against an
     8-token prefill and token-by-token decode on the card, held in fp32
     activations, bf16 printed; the driver's restore split (reader,
     digest, staging, host-to-device waits) and a profile of a warm
     full-size prefill (launches, device busy and idle share, top kernels);
  3h. int8 weight-only serving (after 3g): full-width, full-depth
     codeqwen1.5-7b (32 layers, 32/32 heads of 128) through the port's
     driver with --quant int8, 8 prompts of 512 tokens and 32 new tokens
     each, its fp32 weights published to and restored from a simulated
     store at 10 ms a request and 2000 MB/s, then quantized on the card:
     the reference's 10 quantized tensors, every layer's prefill attention
     through the flash kernel at head dim 128 (32 launches), no scan, ids
     in range; peak memory, the restore split and the host's MemAvailable
     printed. Then codeqwen cut to 2 layers: quantized on the card and on
     the host CPU from one set of weights, q and scale equal bit for bit;
     the int8 model's prefill logits and 8 decode steps, card vs host, held
     in fp32 activations, bf16 printed. Full depth on the card: int8
     against a bf16 copy of the same weights, max |diff| over max |logit|
     below 0.35 (tests/test_quant.py); a warm decode step and a warm
     prefill profiled with each (launches, host enqueue, device busy and
     idle share, top kernels) and the dequantization chain of each replayed
     alone beside its bytes' bound. Then examples/torch/serve_batched.py in
     a process of its own must exit 0 with its OK line;
  3c. restore: full-width smollm-135m weights published to a simulated
     object store (10 ms a request, 160 MB/s) and restored onto the card
     with rolling prefetch (through `ServeEngine.from_store`, which then
     serves phase 3's traffic and must give the same greedy tokens), with
     the sequential baseline, and with rolling into a disk cache twice (the
     second restore with no store GET); then a bf16 copy of the weights the
     same way. Every leaf bit-exact and on the card; seconds, GETs, bytes
     and the wait on the reader vs on host-to-device copies printed;
  3d. training: full-width smollm-135m (fp32 parameters, bf16 activations,
     batch 8 x 256) trained for 40 steps by the port's driver
     (`repro_torch.launch.train`) from token shards in a simulated object
     store, through the rolling-prefetch loader and the device feeder, with
     write-behind checkpoints every 20 steps to a simulated store at 10 ms a
     request and 1000 MB/s; the loss must be finite and not climb (the
     shards are uniform random tokens), the scan may not launch and the
     attention must train through the flash kernel with its backward. A
     second run resumes from the step-20 checkpoint and must repeat the
     first run's losses from step 21 on; the same state is restored and
     saved again, timed; the loss of the driver's first batch, trained on
     repeatedly, must fall; two steps of the same parameters and batches
     (fp32 activations, batch 2 x 128) on the card and on the host CPU must
     agree; a profiled window shows where a step's time goes; and the
     forward-only entries must refuse a CUDA input that requires grad.
     Tokens/s, step ms, the feeder's wait, peak memory, save and restore
     seconds, and the loader's GETs and bytes printed;
  4. the paper's two use cases (examples/torch/streamline_analysis.py):
     the streamline-length histogram and bundle recognition on the card,
     read through the example's simulated store (20 ms a request, 45 MB/s)
     over the example's dataset (4 shards, 2.3 MB) and a larger one (8
     shards of 10,000 streamlines, 39 MB); warm-up, sequential, then
     rolling, whose results must be identical; seconds, speed-up, GETs,
     bytes and the wait on the reader printed, and the card's idle share
     from its work replayed alone. The larger dataset's runs on the host
     CPU must agree with the card's: lengths within 1e-5 relative, the
     same bin and label for every row not within 1e-4 of a bin edge, of
     the threshold or of a tie. Then examples/torch/train_lm_e2e.py at its
     defaults in a process of its own must exit 0 with its OK line;
  5. the mesh tooling (after 4), in a one-rank NCCL group: full-width
     olmo-1b (16 layers, d 2048, 16 heads of 128, non-parametric
     LayerNorm, random weights from a seed) placed by TRAIN_RULES on a
     1 x 1 CUDA `DeviceMesh`, saved to a simulated store at 10 ms a request
     and 2000 MB/s, restored through `ft.elastic.restore_resharded` onto a
     DECODE_TP_RULES template (every leaf's placements the template's, its
     logical array bit-equal), one wave of 8 prompts of 512 tokens and 32
     decode steps served from the restored tree (16 flash launches, no
     scan), olmo-1b cut to 2 layers on the card and on the host CPU in fp32
     activations (prefill and decode logits, loss, gradients), flash timed
     at the wave's shape (8, 16, 512, 128), a post-reshard snapshot at step
     1 restored bit-equal; seconds, restore split and peak memory printed.
     Then examples/torch/elastic_restore.py on the card and on 8 CPU ranks,
     each in a process of its own, both at once while phase 6's dry-run
     processes trace, must exit 0 with its OK line;
  6. the sharded forward (after 5), in a one-rank NCCL group of its own
     on a 1 x 1 CUDA mesh: full-width olmo-1b in fp32 activations,
     `Model.loss` on 2 x 512 tokens and every leaf's gradient through the
     `DTensor` path under TRAIN_RULES (every `constrain` active) against
     the plain path on the same weights, then under DECODE_RULES a
     prefill of 8 x 512 and 8 decode steps, each held to 1e-4; (6a) one
     `train.build_train_step` step (remat, fp32 activations) of full-width
     olmo-1b under TRAIN_RULES through the `DTensor` path against the plain
     step from the same weights and fresh moments, at 1 microbatch of
     2 x 512 tokens and 2 of 2 x 512: loss, grad_norm, lr, every moment and
     every update p_new - p_old held to 1e-4, peak memory printed; a bf16
     prefill of the same wave through the `DTensor` path, its 16 flash
     launches through `local_map` counted (counts set to 0 just before)
     and the first held to its plain version at the bf16 and relative L2
     limits; mamba2-1.3b at full width cut to 2 blocks, a `DTensor`
     prefill whose 2 scan launches go through `local_map`, the first held
     to its plain version, and its logits to the plain path's; (6b) the
     same 2 blocks' fp32 `Model.loss` and every gradient under
     TRAIN_RULES against the plain path (1e-4), the training scan
     (`ssd_chunked`) run on local shards only and no kernel launched; the
     `DTensor` TrainState of reduced olmo-1b saved by
     `CheckpointManager.maybe_save` and restored onto its mesh
     bit-equal; and, each in a process of its own started at the phase's
     start, `python -m repro_torch.launch.dryrun` for olmo-1b's
     prefill_32k, decode_32k and (6c) train_4k (the whole train step) on
     the 16 x 16 mesh (a ``fake`` group of 256 ranks, nothing allocated),
     their report lines and seconds printed;
  7. each phase's seconds on the host clock, a line each (``phase NAME:
     S s``), then a JSON line of the kernels' numbers, then the result
     line.

Needs a CUDA device and the repository's src/ beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s and bf16 / fp32
# tensor-core FLOP/s, for the least time a kernel could take.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS_S = {"torch.bfloat16": 989e12, "torch.float32": 495e12}

FLASH_CASES = [
    # (b, hq, hkv, sq, sk, d, causal, dtype): the JAX package's test sweep ...
    (1, 4, 4, 256, 256, 64, True, "float32"),
    (2, 8, 2, 256, 256, 128, True, "float32"),
    (1, 8, 1, 128, 128, 64, True, "float32"),
    (1, 4, 4, 128, 384, 64, False, "float32"),
    (2, 4, 2, 256, 256, 64, True, "bfloat16"),
    (1, 2, 2, 512, 512, 128, True, "bfloat16"),
    (1, 4, 4, 128, 128, 32, False, "float32"),
    # ... causal with Sq != Sk (top-left mask), a ragged length, the reduced
    # configs' head dim, and the serving path's wave shapes.
    (1, 2, 2, 128, 256, 64, True, "float32"),
    (2, 9, 3, 200, 200, 64, True, "bfloat16"),
    (2, 3, 1, 12, 12, 16, True, "bfloat16"),
    (4, 9, 3, 128, 128, 64, True, "bfloat16"),
    (8, 9, 3, 512, 512, 64, True, "bfloat16"),
    # ... granite-moe-3b-a800m's serving waves and its fp32 cross-check, and
    # reduced jamba's attention block ...
    (8, 24, 8, 512, 512, 64, True, "bfloat16"),
    (4, 24, 8, 128, 128, 64, True, "bfloat16"),
    (2, 24, 8, 128, 128, 64, True, "float32"),
    (2, 4, 1, 64, 64, 16, True, "bfloat16"),
    (2, 4, 1, 64, 64, 16, True, "float32"),
    # ... whisper-large-v3's encoder self-attention (8 requests of 1500
    # frames, 20 heads of 64, unmasked; the last k tile holds 28 of its 64
    # columns), its decoder's 8-token prompt (one partial tile, causal), and
    # their fp32 twins ...
    (8, 20, 20, 1500, 1500, 64, False, "bfloat16"),
    (8, 20, 20, 1500, 1500, 64, False, "float32"),
    (8, 20, 20, 8, 8, 64, True, "bfloat16"),
    (8, 20, 20, 8, 8, 64, True, "float32"),
    # ... and the bf16 tensor-core kernel's paths: head dims 16, 32 and
    # 128, causal Sq != Sk, ragged non-causal.
    (1, 4, 2, 256, 256, 16, True, "bfloat16"),
    (1, 4, 2, 256, 256, 32, True, "bfloat16"),
    (2, 4, 2, 200, 200, 128, True, "bfloat16"),
    (1, 2, 2, 128, 256, 64, True, "bfloat16"),
    (1, 4, 2, 77, 130, 32, False, "bfloat16"),
    # codeqwen1.5-7b's serving waves (MHA, 32 heads of 128: the D = 128
    # instantiation on a model path) and its fp32 card-vs-host shape; last
    # in the list, so the earlier cases keep their seeds.
    (8, 32, 32, 512, 512, 128, True, "bfloat16"),
    (4, 32, 32, 128, 128, 128, True, "bfloat16"),
    (2, 32, 32, 128, 128, 128, True, "float32"),
    # olmo-1b's serving wave (MHA, 16 heads of 128) and its fp32
    # card-vs-host shape.
    (8, 16, 16, 512, 512, 128, True, "bfloat16"),
    (2, 16, 16, 128, 128, 128, True, "float32"),
]
SLICE_SHAPE = (8, 9, 3, 512, 512, 64, True, "bfloat16")
WAVE2_SHAPE = (4, 9, 3, 128, 128, 64, True, "bfloat16")
GRANITE_SHAPE = (8, 24, 8, 512, 512, 64, True, "bfloat16")
WHISPER_SHAPE = (8, 20, 20, 1500, 1500, 64, False, "bfloat16")
CODEQWEN_SHAPE = (8, 32, 32, 512, 512, 128, True, "bfloat16")
CODEQWEN_WAVE2 = (4, 32, 32, 128, 128, 128, True, "bfloat16")
OLMO_SHAPE = (8, 16, 16, 512, 512, 128, True, "bfloat16")
TRAIN_SHAPE = (8, 16, 16, 2048, 2048, 128, True, "bfloat16")   # olmo-1b's training attention
SMOLLM_TRAIN_SHAPE = (8, 9, 3, 256, 256, 64, True, "bfloat16")  # smollm-135m's, phase 3d's run
# The training kernels against the plain version's fp32 autograd on the same
# bf16 inputs, as tests/test_torch_cuda_kernels.py holds them: o, dq, dk and
# dv by a relative L2 error of 1e-2 (five bf16 roundings' worth: q, k, v and
# dO as given, P and dS before their products, each output once); lse, fp32
# throughout, to 1e-4 absolute.
TRAIN_REL_TOL, TRAIN_LSE_TOL = 1e-2, 1e-4
SSD_CASES = [
    # (b, s, h, g, p, n, chunk, dtype): the JAX package's test sweep ...
    (1, 128, 4, 1, 32, 32, 32, "float32"),
    (2, 256, 8, 2, 64, 64, 64, "float32"),
    (1, 512, 4, 4, 64, 128, 128, "float32"),
    (1, 256, 4, 1, 64, 128, 256, "float32"),
    (2, 256, 4, 1, 32, 64, 64, "bfloat16"),
    # ... the serving path's two waves of mamba2-1.3b (the 128-token wave
    # padded to one 256-row chunk), and two groups at the slice's widths.
    (8, 512, 64, 1, 64, 128, 256, "bfloat16"),
    (4, 256, 64, 1, 64, 128, 256, "bfloat16"),
    (2, 512, 8, 2, 64, 128, 256, "bfloat16"),
    # ... reduced jamba's Mamba blocks (P 16, N 16, chunk 32) ...
    (2, 64, 8, 1, 16, 16, 32, "bfloat16"),
    (2, 64, 8, 1, 16, 16, 32, "float32"),
    # ... and the bf16 tensor-core kernel's paths: P 16 and 128, N = 20
    # (padded, ordinary loads), Q = 100, two groups.
    (1, 128, 4, 1, 16, 64, 64, "bfloat16"),
    (1, 256, 2, 1, 128, 128, 128, "bfloat16"),
    (2, 128, 4, 1, 32, 20, 64, "bfloat16"),
    (1, 200, 4, 2, 32, 64, 100, "bfloat16"),
    (2, 256, 8, 2, 64, 128, 128, "bfloat16"),
]
SSD_SLICE_SHAPE = (8, 512, 64, 1, 64, 128, 256, "bfloat16")
# The simulated weight store of the restore phase: the JAX serving driver's
# default (10 ms a request, 80 MB/s) at twice the bandwidth, which halves
# the time of the phase's two saves and eight restores.
RESTORE_URI = "sims3://weights?latency_ms=10&bw_mbps=160"
# The training phase's checkpoint store: the JAX training driver's 10 ms a
# request at 1000 MB/s instead of its 50 MB/s, at which each save of the
# 1.6 GB TrainState would take about 32 s.
TRAIN_CKPT_URI = "sims3://{bucket}?latency_ms=10&bw_mbps=1000"
# The driver's flags but a write depth of 16: its saves use --blocksize
# (256 KiB) as the part size, 6,150 parts a save, and at the default depth 2
# their 10 ms latencies alone take 31 s.
TRAIN_ARGS = ["--arch", "smollm-135m", "--full", "--steps", "40", "--batch", "8",
              "--seq-len", "256", "--ckpt-interval", "20", "--log-every", "10",
              "--write-depth", "16", "--device", "cuda", "--seed", "0"]
# The driver's shards are uniform random tokens: the loss can only fall
# from the initial ~10.92 towards ln(49152) = 10.80, and 40 steps at lr 3e-4
# move it less than the batch-to-batch noise. So the driver's run is held
# to finite losses that do not climb, and learning is shown on one batch
# trained on repeatedly, where no sampling noise hides the fall.
CLIMB_TOL = 0.05           # nats, mean of steps 31-40 over mean of steps 1-5
OVERFIT_STEPS, OVERFIT_FALL = 10, 0.1   # steps on one batch; least fall, nats
RESUME_TOL = 1e-3          # relative, resumed vs uninterrupted losses
CROSS_TOL = 1e-4           # relative, card vs host CPU in fp32 activations
# The encoder-decoder phase: the serving driver's flags at full width, its
# weight store at 25x the driver's default bandwidth (publishing and
# restoring 6.41 GB at 80 MB/s would take about 160 s).
WHISPER_ARGS = ["--arch", "whisper-large-v3", "--full", "--batch", "8", "--prompt-len", "1500",
                "--gen", "32", "--store", "sims3://whisper?latency_ms=10&bw_mbps=2000",
                "--device", "cuda", "--seed", "0"]
# The int8 serving phase: the driver at full width and depth with --quant
# int8, its weight store at 25x the driver's default bandwidth (as
# whisper's); the reference's count of quantized tensors for codeqwen1.5-7b
# (pinned in tests/test_torch_quant.py) and its limit on int8 logits' drift,
# max |diff| over max |logit| (tests/test_quant.py).
CODEQWEN_ARGS = ["--arch", "codeqwen1.5-7b", "--full", "--quant", "int8", "--batch", "8",
                 "--prompt-len", "512", "--gen", "32", "--store",
                 "sims3://codeqwen?latency_ms=10&bw_mbps=2000", "--device", "cuda", "--seed", "0"]
CODEQWEN_QUANTIZED = 10
QUANT_RATIO_TOL = 0.35
# The mesh phase: full-width olmo-1b's weights saved and restored through a
# simulated store at whisper's and codeqwen's 10 ms a request and 2000 MB/s.
MESH_URI = "sims3://mesh?latency_ms=10&bw_mbps=2000"
# The sharded-forward phase: the DTensor path against the plain path in fp32
# activations (|a - b| <= tol * (1 + |b|); the loss relative; each leaf's
# gradient as a relative L2 error), and the dry-run's cells.
SHARDED_TOL = 1e-4
DRYRUN_CELLS = ("prefill_32k", "decode_32k", "train_4k")
TOL = {"float32": 2e-3, "bfloat16": 2e-2}     # rtol = atol, tests/test_kernels.py
# The flash kernel is also held to |out - ref| / |ref| over the whole output
# (L2 norms). Over 1500 keys an output is about 0.04 in size, so the
# elementwise limits above would pass an unmasked ragged tail: its 36
# padding columns read as zero keys grow each softmax sum, and shrink the
# output, by about 1.5%, three times the bf16 limit here.
REL_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
WHOLE_STACK_TOL = 0.15                         # tests/test_archs.py


def ptxas_summary(path: str) -> list[str]:
    """One line per kernel instantiation from `nvcc -Xptxas -v`: registers
    and spill bytes."""
    if not os.path.exists(path):
        return []
    out, name, spills = [], "?", "spills not reported"
    with open(path) as f:
        for line in f:
            if m := re.search(r"Compiling entry function '(\w+)'", line):
                name = m.group(1)
                if k := re.search(r"\d+([a-z_]+(?:bf16|f32|dq|dkdv)_kernel)I(\w*?)EEv", name):
                    args = re.findall(r"L[ib](\d+)E", k.group(2) + "E")
                    name = f"{k.group(1)}<{', '.join(args)}>"
            elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
                spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            elif m := re.search(r"Used (\d+) registers", line):
                out.append(f"{name}: {m.group(1)} registers, {spills}")
    return out


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


PHASE_SECONDS: dict[str, float] = {}


@contextlib.contextmanager
def phase_clock(name: str):
    """Time the block on the host clock into `PHASE_SECONDS[name]`; `main`
    prints them before its last two lines."""
    t = time.perf_counter()
    try:
        yield
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t


def cuda_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Median over `reps` CUDA-event windows of `inner` calls each, in ms."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(torch, fn, reps: int = 15, inner: int = 10) -> float:
    """Device time of one call, in ms: `inner` calls captured in one CUDA
    graph, the median over `reps` timed replays. Unlike `cuda_ms`, the
    host's launch overhead (the wrapper's checks, ctypes) drops out, so at
    small shapes this is the kernel's own time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def flash_inputs(torch, case, seed: int):
    """q, k, v as (B, H, S, D) views of (B, S, H, D) tensors, the layout the
    model hands the kernel."""
    b, hq, hkv, sq, sk, d, _, dtype = case
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dt = getattr(torch, dtype)

    def make(h, s):
        return torch.randn((b, s, h, d), generator=g, device="cuda").to(dt).transpose(1, 2)

    return make(hq, sq), make(hkv, sk), make(hkv, sk)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_FLOPS_S[str(dtype)]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_work(q, k, causal: bool) -> tuple[int, int]:
    """Bytes (q, k, v read once, o written once) and the visible work, 4 D
    operations per visible (row, column) pair."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    nbytes = (2 * b * hq * sq * d + 2 * b * hkv * sk * d) * q.element_size()
    visible = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    return nbytes, 4 * d * visible * b * hq


def sdpa_call(torch, q, k, v, causal: bool = True):
    """The library yardstick: one `scaled_dot_product_attention` call on k/v
    expanded to the q heads."""
    group = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(group, dim=1)
    ve = v.repeat_interleave(group, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, ke, ve, is_causal=causal)


def phase_kernels(torch, fa) -> dict:
    worst = {}
    for i, case in enumerate(FLASH_CASES):
        q, k, v = flash_inputs(torch, case, seed=i)
        causal, dtype = case[6], case[7]
        out = fa.flash_attention_cuda(q, k, v, causal=causal)
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if out.dtype != q.dtype or out.shape != q.shape:
            fail(f"flash {case}: got {out.dtype} {tuple(out.shape)}")
        err = (out.float() - ref.float()).abs()
        tol = TOL[dtype]
        rel = (err.norm() / ref.float().norm()).item()
        ok = bool((err <= tol + tol * ref.float().abs()).all()) and rel <= REL_TOL[dtype]
        print(f"flash {case}: max|diff| {err.max().item():.3e} (tol {tol}), relative "
              f"{rel:.3e} (tol {REL_TOL[dtype]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"flash kernel disagrees with its plain version at {case}")
        worst[case] = err.max().item()

    b, hq, hkv, sq, sk, d, causal, dtype = SLICE_SHAPE
    q, k, v = flash_inputs(torch, SLICE_SHAPE, seed=1)
    nbytes, flops = flash_work(q, k, causal)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    sdpa = sdpa_call(torch, q, k, v)
    ms = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=True))
    library_ms = cuda_ms(torch, sdpa)
    ms2 = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    print(f"flash at {SLICE_SHAPE}: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
          f"sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
    print(f"flash at {SLICE_SHAPE}: {bound_ms / statistics.median([ms, ms2]):.1%} of its bound, "
          f"{statistics.median([ms, ms2]) / library_ms:.2f}x sdpa's time")
    dev_ms = graph_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    dev_sdpa = graph_ms(torch, sdpa)
    print(f"flash at {SLICE_SHAPE}, device time (CUDA graph): kernel {dev_ms:.4f} ms, sdpa "
          f"{dev_sdpa:.4f} ms; {bound_ms / dev_ms:.1%} of its bound, {dev_ms / dev_sdpa:.2f}x "
          f"sdpa's time")
    flash_timing(torch, fa, WAVE2_SHAPE, "the 128-token wave", seed=2)
    flash_timing(torch, fa, GRANITE_SHAPE, "granite-moe-3b-a800m's 512-token wave", seed=3)
    whisper = flash_timing(torch, fa, WHISPER_SHAPE, "whisper-large-v3's encoder", seed=4)
    codeqwen = [flash_timing(torch, fa, CODEQWEN_SHAPE, "codeqwen1.5-7b's 512-token wave, D 128",
                             seed=5),
                flash_timing(torch, fa, CODEQWEN_WAVE2, "codeqwen1.5-7b's 128-token wave, D 128",
                             seed=6)]
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:34",
        "max_abs_err": worst[SLICE_SHAPE],
        "ms": statistics.median([ms, ms2]),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "whisper_encoder": whisper,
        "codeqwen_waves": codeqwen,
    }


def flash_timing(torch, fa, case, what: str, seed: int) -> dict:
    """The kernel at `case`: the eager median (CUDA events), the device time
    over a CUDA graph, the plain version's and SDPA's times, and the bound."""
    causal = case[6]
    q, k, v = flash_inputs(torch, case, seed=seed)
    nbytes, flops = flash_work(q, k, causal)
    bound_ms, bound_by = bound(nbytes, flops, q.dtype)
    sdpa = sdpa_call(torch, q, k, v, causal=causal)
    kernel = functools.partial(fa.flash_attention_cuda, q, k, v, causal=causal)
    ms = cuda_ms(torch, kernel)
    plain_ms = cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                       reps=5, inner=2)
    library_ms = cuda_ms(torch, sdpa)
    dev_ms, dev_sdpa = graph_ms(torch, kernel), graph_ms(torch, sdpa)
    print(f"flash at {case} ({what}): kernel {ms:.4f} ms, device time (CUDA graph) "
          f"{dev_ms:.4f} ms; plain {plain_ms:.4f} ms; sdpa {library_ms:.4f} ms, device "
          f"{dev_sdpa:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP); {bound_ms / dev_ms:.1%} of its bound, "
          f"{dev_ms / dev_sdpa:.2f}x sdpa's device time")
    return {"shape": list(case), "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "library_device_ms": dev_sdpa}


def train_flash_work(q, k, causal: bool) -> tuple[int, int, int, int]:
    """Bytes and visible work of the training forward and backward: the
    forward reads q, k, v and writes o and lse; the backward reads q, k, v,
    o, dO and lse and writes dq, dk, dv. Work: the forward's two products
    (4 D operations per visible pair), the backward's five (S again, dP, dV,
    dQ, dK: 10 D)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    el = q.element_size()
    qo, kv, lse = b * hq * sq * d * el, b * hkv * sk * d * el, b * hq * sq * 4
    visible = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    pairs = visible * b * hq
    return 2 * qo + 2 * kv + lse, 4 * qo + 4 * kv + lse, 4 * d * pairs, 10 * d * pairs


def check_train_kernels(torch, fa, case, q, k, v, dout) -> dict:
    """Run the training forward and backward on q, k, v and dout at `case`
    and hold o, lse, dq, dk and dv to `flash_attention_plain`'s fp32
    autograd on the same inputs; fail on a miss. Returns the errors."""
    causal = case[6]
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v, causal=causal)
    dq, dk, dv = fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout, causal=causal)
    live = [t.float().requires_grad_() for t in (q, k, v)]
    want_o = fa.flash_attention_plain(*live, causal=causal)
    want_o.backward(dout.float())
    group = q.shape[1] // k.shape[1]
    s = q.float() @ k.float().repeat_interleave(group, 1).transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        s = s.masked_fill(torch.ones_like(s, dtype=torch.bool).triu(1), float("-inf"))
    want_lse = torch.logsumexp(s, dim=-1)
    del s
    sq = q.shape[2]
    errs = {"lse": (lse[..., :sq] - want_lse).abs().max().item()}
    for name, got, want in (("o", o, want_o.detach()), ("dq", dq, live[0].grad),
                            ("dk", dk, live[1].grad), ("dv", dv, live[2].grad)):
        errs[name] = ((got.float() - want).norm() / want.norm()).item()
    past_sq = bool(torch.isinf(lse[..., sq:]).all())
    ok = (past_sq and errs["lse"] <= TRAIN_LSE_TOL
          and all(errs[n] <= TRAIN_REL_TOL for n in ("o", "dq", "dk", "dv")))
    print(f"flash training {case} against the plain version's fp32 autograd: relative L2 "
          f"{', '.join(f'{n} {errs[n]:.3e}' for n in ('o', 'dq', 'dk', 'dv'))} (tol "
          f"{TRAIN_REL_TOL}); lse max|diff| {errs['lse']:.3e} (tol {TRAIN_LSE_TOL}), +inf past "
          f"Sq: {past_sq} {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"flash training kernels disagree with the plain version at {case}")
    return errs


def phase_train_kernels(torch, fa) -> dict:
    """The training kernels at olmo-1b's shape, causal, and at smollm-135m's
    (D 64, GQA groups of 3), each held to the plain version's fp32 autograd
    (`check_train_kernels`). At olmo-1b's shape, the forward (with lse) and
    the backward timed apart (CUDA events over eager calls), each beside its
    bound, the plain version under autograd (fp32 scores) and
    `scaled_dot_product_attention`'s forward and backward as the library's
    yardstick, which the port never calls."""
    b, hq, hkv, sq, sk, d, causal, _ = TRAIN_SHAPE
    q, k, v = flash_inputs(torch, TRAIN_SHAPE, seed=7)
    dout = torch.randn(q.shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(8)).to(q.dtype)
    fwd_bytes, bwd_bytes, fwd_flops, bwd_flops = train_flash_work(q, k, causal)
    fwd_bound, fwd_by = bound(fwd_bytes, fwd_flops, q.dtype)
    bwd_bound, bwd_by = bound(bwd_bytes, bwd_flops, q.dtype)
    o, lse = fa.flash_attention_train_fwd_cuda(q, k, v, causal=causal)

    def fwd():
        fa.flash_attention_train_fwd_cuda(q, k, v, causal=causal)

    def bwd():
        fa.flash_attention_train_bwd_cuda(q, k, v, o, lse, dout, causal=causal)

    def plain():
        live = [t.detach().requires_grad_() for t in (q, k, v)]
        fa.flash_attention_plain(*live, causal=causal).backward(dout)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    group = hq // hkv

    def library():
        live = [t.detach().requires_grad_() for t in (q, k.repeat_interleave(group, 1),
                                                      v.repeat_interleave(group, 1))]
        sdpa(*live, is_causal=causal).backward(dout)

    fwd_ms, bwd_ms = cuda_ms(torch, fwd), cuda_ms(torch, bwd)
    plain_ms = cuda_ms(torch, plain, reps=5, inner=2)
    library_ms = cuda_ms(torch, library)
    fwd_ms2, bwd_ms2 = cuda_ms(torch, fwd), cuda_ms(torch, bwd)
    fwd_ms, bwd_ms = statistics.median([fwd_ms, fwd_ms2]), statistics.median([bwd_ms, bwd_ms2])
    print(f"flash training at {TRAIN_SHAPE}: forward {fwd_ms:.4f} ms (bound {fwd_bound:.4f} ms, "
          f"{fwd_by}: {fwd_flops / 1e9:.1f} GFLOP, {fwd_bytes / 1e6:.1f} MB; "
          f"{fwd_bound / fwd_ms:.1%} of it), backward {bwd_ms:.4f} ms (bound {bwd_bound:.4f} ms, "
          f"{bwd_by}: {bwd_flops / 1e9:.1f} GFLOP, {bwd_bytes / 1e6:.1f} MB; "
          f"{bwd_bound / bwd_ms:.1%} of it); forward and backward {fwd_ms + bwd_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, sdpa (library) {library_ms:.4f} ms: "
          f"{(fwd_ms + bwd_ms) / library_ms:.2f}x the library's time")
    for which in ("train_forward", "dq", "dkdv"):
        blocks, smem = fa.occupancy(torch.bfloat16, d, kernel=which)
        print(f"occupancy flash {which} D {d}: {smem} bytes of shared memory, {blocks} "
              f"CTAs per SM")
    errors = {str(TRAIN_SHAPE): check_train_kernels(torch, fa, TRAIN_SHAPE, q, k, v, dout)}
    small = flash_inputs(torch, SMOLLM_TRAIN_SHAPE, seed=9)
    small_dout = torch.randn(small[0].shape, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(10)).to(small[0].dtype)
    errors[str(SMOLLM_TRAIN_SHAPE)] = check_train_kernels(torch, fa, SMOLLM_TRAIN_SHAPE, *small,
                                                          small_dout)
    return {"shape": list(TRAIN_SHAPE), "forward_ms": fwd_ms, "backward_ms": bwd_ms,
            "forward_bound_ms": fwd_bound, "backward_bound_ms": bwd_bound,
            "plain_ms": plain_ms, "library_ms": library_ms, "errors": errors}


def ssd_inputs(torch, case, seed: int, initial: bool = True):
    """x, dt_a, B, C and an entering state with the JAX tests' scales."""
    b, s, h, g, p, n, _, dtype = case
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    dt = getattr(torch, dtype)

    def make(shape, scale):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = make((b, s, h, p), 0.5).to(dt)
    dt_a = -make((b, s, h), 0.3).abs()
    bp, cp = make((b, s, g, n), 0.3).to(dt), make((b, s, g, n), 0.3).to(dt)
    init = make((b, h, p, n), 0.2) if initial else None
    return x, dt_a, bp, cp, init


def ssd_close(torch, got, ref, tol: float):
    err = (got.float() - ref.float()).abs()
    return err.max().item(), bool((err <= tol + tol * ref.float().abs()).all())


def phase_ssd_kernel(torch, ssd) -> dict:
    worst = {}
    for i, case in enumerate(SSD_CASES):
        chunk, dtype = case[6], case[7]
        for initial in (False, True):
            x, dt_a, bp, cp, init = ssd_inputs(torch, case, seed=100 + i, initial=initial)
            y, h = ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
            y_ref, h_ref = ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=chunk, initial_state=init)
            torch.cuda.synchronize()
            if y.dtype != x.dtype or y.shape != x.shape or h.shape != h_ref.shape:
                fail(f"ssd {case}: got y {y.dtype} {tuple(y.shape)}, state {tuple(h.shape)}")
            tol = TOL[dtype]
            (ey, oky), (eh, okh) = ssd_close(torch, y, y_ref, tol), ssd_close(torch, h, h_ref, tol)
            print(f"ssd {case} {'initial' if initial else 'zero'} state: max|diff| y {ey:.3e}, "
                  f"state {eh:.3e} (tol {tol}) {'ok' if oky and okh else 'FAIL'}")
            if not (oky and okh):
                fail(f"ssd kernel disagrees with its plain version at {case}")
            worst[case] = max(worst.get(case, 0.0), ey, eh)

    # Two halves through the kernel, the state carried, equal one pass.
    x, dt_a, bp, cp, _ = ssd_inputs(torch, (1, 256, 4, 1, 32, 64, 64, "float32"), seed=7,
                                    initial=False)
    y_full, h_full = ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=64)
    y1, h1 = ssd.ssd_scan_cuda(x[:, :128], dt_a[:, :128], bp[:, :128], cp[:, :128], chunk=64)
    y2, h2 = ssd.ssd_scan_cuda(x[:, 128:], dt_a[:, 128:], bp[:, 128:], cp[:, 128:], chunk=64,
                               initial_state=h1)
    (ey, oky) = ssd_close(torch, torch.cat([y1, y2], dim=1), y_full, 1e-4)
    (eh, okh) = ssd_close(torch, h2, h_full, 1e-4)
    print(f"ssd continuation (two halves vs one pass): max|diff| y {ey:.3e}, state {eh:.3e} "
          f"(tol 1e-4) {'ok' if oky and okh else 'FAIL'}")
    if not (oky and okh):
        fail("ssd kernel: two halves with the carried state differ from one pass")

    b, s, h, g, p, n, q, dtype = SSD_SLICE_SHAPE
    x, dt_a, bp, cp, init = ssd_inputs(torch, SSD_SLICE_SHAPE, seed=1)
    elem = x.element_size()
    # x and y, B and C in x's dtype; dt_a, the entering and final state fp32.
    nbytes = (2 * x.numel() + bp.numel() + cp.numel()) * elem + dt_a.numel() * 4 \
        + 2 * init.numel() * 4
    flops = b * h * (s // q) * (2 * (q * (q + 1) // 2) * (n + p) + 4 * q * n * p)
    bound_ms, bound_by = bound(nbytes, flops, x.dtype)
    ms = cuda_ms(torch, lambda: ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=q, initial_state=init))
    plain_ms = cuda_ms(torch, lambda: ssd.ssd_scan_plain(x, dt_a, bp, cp, chunk=q,
                                                         initial_state=init), reps=5, inner=2)
    ms2 = cuda_ms(torch, lambda: ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=q, initial_state=init))
    print(f"ssd at {SSD_SLICE_SHAPE}: kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP); library call: none (no single PyTorch call "
          f"computes this scan)")
    print(f"ssd at {SSD_SLICE_SHAPE}: {bound_ms / statistics.median([ms, ms2]):.1%} of its bound; "
          f"ratio to a library call: none")
    dev_ms = graph_ms(torch, lambda: ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=q,
                                                       initial_state=init))
    print(f"ssd at {SSD_SLICE_SHAPE}, device time (CUDA graph): kernel {dev_ms:.4f} ms; "
          f"{bound_ms / dev_ms:.1%} of its bound")
    wave2 = SSD_CASES[SSD_CASES.index(SSD_SLICE_SHAPE) + 1]
    x, dt_a, bp, cp, init = ssd_inputs(torch, wave2, seed=2)
    ms_wave2 = cuda_ms(torch, lambda: ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=q,
                                                        initial_state=init))
    dev_wave2 = graph_ms(torch, lambda: ssd.ssd_scan_cuda(x, dt_a, bp, cp, chunk=q,
                                                          initial_state=init))
    print(f"ssd at {wave2} (the padded 128-token wave): kernel {ms_wave2:.4f} ms, device time "
          f"(CUDA graph) {dev_wave2:.4f} ms")
    return {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:35",
        "max_abs_err": worst[SSD_SLICE_SHAPE],
        "ms": statistics.median([ms, ms2]),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def phase_serve(torch, np, cfg, model, params, kernels: dict, path: str,
                make_engine=None) -> tuple[int, dict]:
    """Serve the fixed traffic through `ServeEngine`, built on `params` in
    memory, or by `make_engine(engine_class)` (e.g. from the object store).
    Every kernel's count is set to 0 just before the run and read just
    after: the kernel named `path` must have launched once per layer per
    wave, the others never. Returns `path`'s launches and each request's
    greedy tokens."""
    from repro_torch.serve import Request, ServeEngine

    class Engine(ServeEngine):
        """Also counts the non-finite logits of every step, on the card: one
        small reduction per step and no extra sync; read after the run."""
        nonfinite = 0

        def _greedy(self, logits):
            real = logits[:, : self.model.cfg.vocab_size]
            self.nonfinite = self.nonfinite + (~torch.isfinite(real)).sum()
            return super()._greedy(logits)

    rng = np.random.default_rng(0)
    # Warm-up (cuBLAS handles, allocator) outside the counted run.
    warm = Engine(model, params, max_batch=8, device="cuda")
    warm.submit(Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 64), max_new_tokens=2))
    warm.run()

    engine = (Engine(model, params, max_batch=8, device="cuda") if make_engine is None
              else make_engine(Engine))
    lens = [512] * 8 + [128] * 4
    for i, n in enumerate(lens):
        engine.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                              max_new_tokens=32))
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    results = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in kernels.items()}
    st = engine.stats
    want = cfg.num_layers * st.waves
    print(f"serve {cfg.name}: {st.requests} requests in {st.waves} waves, "
          f"{st.generated_tokens} tokens, {st.decode_steps} decode steps, wall {wall:.3f}s")
    print(f"serve {cfg.name}: prefill {st.prefill_tokens / st.prefill_s:.1f} tok/s "
          f"({st.prefill_tokens} tokens in {st.prefill_s:.4f}s), decode "
          f"{(st.generated_tokens - st.requests) / st.decode_s:.1f} tok/s "
          f"({st.generated_tokens - st.requests} tokens in {st.decode_s:.4f}s)")
    print(f"serve {cfg.name}: kernel launches {counts} (want {path}: {cfg.num_layers} layers x "
          f"{st.waves} waves = {want}, every other kernel 0)")
    if st.waves != 2 or len(results) != len(lens):
        fail(f"want 2 waves and {len(lens)} results, got {st.waves} and {len(results)}")
    if counts != {name: want if name == path else 0 for name in kernels}:
        fail(f"{cfg.name}: kernel launches {counts}; want {path} {want}, every other 0")
    for r in results:
        if len(r.tokens) != 32 or r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: {len(r.tokens)} tokens, ids outside [0, vocab)")
    nonfinite = int(engine.nonfinite)
    if nonfinite:
        fail(f"{nonfinite} non-finite logits during serving")
    return counts[path], {r.rid: r.tokens.tolist() for r in results}


def prefill_vs_decode(torch, np, kernel, cfg, model, params):
    """Last-position logits of one 32-token prompt prefilled through the
    kernel, and of its first 16 tokens prefilled (through the kernel too)
    then 16 decoded token by token over the cache. Returns both, fp32."""
    from repro_torch.models import lm as LM

    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 32))).cuda()
    before = kernel.launches
    full, _ = model.prefill(params, {"inputs": ids})
    if kernel.launches - before != cfg.num_layers:
        fail(f"{cfg.name}: prefill launched the kernel {kernel.launches - before} times, "
             f"want {cfg.num_layers}")
    logits, caches = LM.lm_prefill(params, cfg, ids[:, :16], max_len=32)
    for t in range(16, 32):
        logits, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
    v = cfg.vocab_size
    return full[:, :v].float(), logits[:, :v].float()


def check_close(torch, cfg, a, b, tol: float, what: str) -> None:
    err = (a - b).abs()
    ok = bool(torch.isfinite(a).all()) and bool((err <= tol + tol * b.abs()).all())
    print(f"{cfg.name}: prefill-through-kernel vs token-by-token decode{what}: max|diff| "
          f"{err.max().item():.3e} (tol {tol}), argmax {int(a.argmax())} vs {int(b.argmax())}")
    if not ok:
        fail(f"{cfg.name}: prefill through the kernel disagrees with plain decode over the "
             f"cache{what}")


def phase_prefill_vs_decode(torch, np, kernel, cfg, model, params) -> None:
    check_close(torch, cfg, *prefill_vs_decode(torch, np, kernel, cfg, model, params),
                WHOLE_STACK_TOL, "")


def phase_fp32_prefill_vs_decode(torch, np, kernel, cfg, model, params) -> None:
    """The Mamba and MoE models' check, which shows that decode continues
    from the scan kernel's final state or the flash kernel's KV cache. In
    bf16, the serving dtype, the two paths round differently at every
    layer: over 48 layers of random Mamba weights that spread exceeds the
    whole-stack tolerance whatever computes the scan, and in MoE a token
    whose router probabilities nearly tie goes to another expert on each
    path. So the bf16 numbers are printed only. With the activations in
    fp32 (`layers.COMPUTE_DTYPE`) the paths differ only in summation order,
    and they are held to the fp32 kernel tolerance."""
    from repro_torch.models import layers as L

    a, b = prefill_vs_decode(torch, np, kernel, cfg, model, params)
    err = (a - b).abs()
    print(f"{cfg.name}: prefill-through-kernel vs token-by-token decode, bf16 activations: "
          f"max|diff| {err.max().item():.3e}, argmax {int(a.argmax())} vs {int(b.argmax())} "
          f"(printed only)")
    if not bool(torch.isfinite(a).all() and torch.isfinite(b).all()):
        fail(f"{cfg.name}: non-finite logits in the prefill-vs-decode check")
    L.COMPUTE_DTYPE = torch.float32
    try:
        a, b = prefill_vs_decode(torch, np, kernel, cfg, model, params)
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16
    check_close(torch, cfg, a, b, TOL["float32"], ", fp32 activations")


def routing_spy(M):
    """Wrap `models.moe.route` to keep each call's chosen experts, sorted per
    token, on the host. Returns (the list they go to, a function that
    restores `route`)."""
    real, picks = M.route, []

    def spy(p, cfg, x):
        out = real(p, cfg, x)
        picks.append(out[2].sort(dim=-1).values.cpu())
        return out

    M.route = spy
    return picks, lambda: setattr(M, "route", real)


def routing_agreement(a: list, b: list) -> float:
    """Share of (token, choice) entries, over every MoE call, where two runs
    picked the same expert."""
    same = sum(int((x == y).sum()) for x, y in zip(a, b))
    return same / sum(x.numel() for x in a)


def moe_run(torch, cfg, params, ids, labels, grad_paths):
    """One forward of `ids` (logits at every position, fp32, real vocab)
    with the kernels where the device has them, then `lm_loss` with its aux
    term and the gradients of the leaves at `grad_paths`. Returns logits,
    loss, gradients and the experts each MoE call picked, on the host."""
    from repro_torch import tree
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as M

    picks, restore = routing_spy(M)
    try:
        with torch.no_grad():
            h, _, _ = LM.lm_hidden(params, cfg, ids)
            logits = LM.logits_from_hidden(params, cfg, h)[..., :cfg.vocab_size].cpu()
        # The forward's routing only: the loss routes the same tokens again,
        # and its remat once more in the backward pass.
        forward_picks = list(picks)
        if labels is None:
            return logits, None, [], forward_picks
        live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        loss = LM.lm_loss(live, cfg, ids, labels, q_chunk=ids.shape[1],
                          loss_chunk=ids.shape[1])
        leaves = [functools.reduce(dict.__getitem__, path.split("."), live)
                  for path in grad_paths]
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
        return logits, float(loss.detach()), grads, forward_picks
    finally:
        restore()


def phase_moe_cross_check(torch, np, kernels: dict) -> None:
    """Full-width granite-moe-3b-a800m cut to 2 layers, one set of weights
    made on the card and copied to the host CPU: prefill logits of 2
    prompts of 128 (flash attention on the card, the plain version on the
    host), `lm_loss` with its aux term and the gradients of the router and
    expert weights (in bf16 the card's attention through the flash training
    kernels, in fp32 the plain path on both). Held with fp32 activations,
    where the two sides differ only in summation order and a routing flip
    at a near-tie stays unlikely; the bf16 numbers and each run's share of
    routing decisions that agree are printed."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"), num_layers=2)
    model = make_model(cfg)
    card = model.init(0, device="cuda")
    host = tree.map_leaves(lambda t: t.cpu(), card)
    print(f"moe cross-check: {cfg.name} at 2 layers, {model.param_count() / 1e9:.3f} B "
          f"parameters")
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)))
    inputs, labels = ids[:, :-1], ids[:, 1:]
    paths = [f"layers.block0.ffn.{leaf}" for leaf in ("w_router", "w_up", "w_gate", "w_down")]
    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            flash = kernels["flash_attention"]
            flash.launches = flash.backward_launches = 0
            t0 = time.perf_counter()
            lc, loss_c, gc, pc = moe_run(torch, cfg, card, inputs.cuda(), labels.cuda(),
                                         paths)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            launched = flash.launches
            t0 = time.perf_counter()
            lh, loss_h, gh, ph = moe_run(torch, cfg, host, inputs, labels, paths)
            t_host = time.perf_counter() - t0
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        agree = routing_agreement(pc, ph)
        err = (lc - lh).abs()
        tol = TOL["float32"]
        ok_logits = bool(torch.isfinite(lc).all()) and bool((err <= tol + tol * lh.abs()).all())
        rel_loss = abs(loss_c - loss_h) / abs(loss_h)
        grad_err = {p.rsplit(".", 1)[1]: (float((a - b).norm() / b.norm()))
                    for p, a, b in zip(paths, gc, gh)}
        held = dtype == "float32"
        print(f"moe cross-check {dtype} activations: logits max|diff| {err.max().item():.3e}"
              f"{f' (tol {tol})' if held else ''}; loss card {loss_c!r}, host cpu {loss_h!r}, "
              f"relative diff {rel_loss:.3e}{f' (tol {CROSS_TOL})' if held else ''}; grads "
              f"relative L2 {', '.join(f'{k} {v:.3e}' for k, v in grad_err.items())}; routing "
              f"agrees on {agree:.4%} of {sum(x.numel() for x in pc)} choices; "
              f"{launched} flash launches; card {t_card:.2f} s, host cpu {t_host:.2f} s"
              f"{'' if held else ' (printed only)'}")
        # The no-grad forward launches the serving kernel once a layer. In
        # bf16 the loss's attention trains through the flash kernel: its
        # forward and the period's recompute in every layer, its backward in
        # every layer after block 0's attention (the gradients taken are
        # block 0's FFN's). In fp32 the loss takes the plain path.
        trained = dtype == "bfloat16"
        want = (cfg.num_layers * (3 if trained else 1), cfg.num_layers - 1 if trained else 0)
        if (launched, flash.backward_launches) != want:
            fail(f"moe cross-check: {launched} flash launches and {flash.backward_launches} "
                 f"backward, want {want}")
        if held and not (ok_logits and math.isfinite(loss_c) and rel_loss <= CROSS_TOL
                         and all(v <= CROSS_TOL for v in grad_err.values())):
            fail("moe cross-check: the card disagrees with the host CPU in fp32 activations")
    del card, host


def phase_jamba(torch, np, kernels: dict) -> dict:
    """Reduced jamba-1.5-large-398b (one period: an attention+MoE block and
    seven Mamba blocks, MoE on every other one; head dim 16, scan chunk 32)
    on the card against the host CPU: one stack that launches both kernels
    and routes through MoE. Logits of 2 prompts of 64 held with fp32
    activations, bf16 printed. Returns each kernel's launches in the
    fp32 pass."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import make_model

    cfg = get_config("jamba-1.5-large-398b").reduced()
    card = make_model(cfg).init(0, device="cuda")
    host = tree.map_leaves(lambda t: t.cpu(), card)
    ids = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 64)))
    want = {"flash_attention": sum(bd.mixer == "attn" for bd in cfg.pattern) * cfg.periods,
            "ssd_scan": sum(bd.mixer == "mamba" for bd in cfg.pattern) * cfg.periods}
    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            for mod in kernels.values():
                mod.launches = 0
            lc, _, _, pc = moe_run(torch, cfg, card, ids.cuda(), None, [])
            counts = {name: mod.launches for name, mod in kernels.items()}
            lh, _, _, ph = moe_run(torch, cfg, host, ids, None, [])
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        err = (lc - lh).abs()
        tol = TOL["float32"]
        ok = bool(torch.isfinite(lc).all()) and bool((err <= tol + tol * lh.abs()).all())
        held = dtype == "float32"
        print(f"{cfg.name} {dtype} activations, card vs host cpu: logits max|diff| "
              f"{err.max().item():.3e}{f' (tol {tol})' if held else ' (printed only)'}; "
              f"routing agrees on {routing_agreement(pc, ph):.4%}; kernel launches "
              f"{counts} (want {want})")
        if counts != want:
            fail(f"{cfg.name}: kernel launches {counts}, want {want}")
        if held and not ok:
            fail(f"{cfg.name}: the card disagrees with the host CPU in fp32 activations")
    return counts


def device_summary(events) -> tuple[int, list, float]:
    """From a profiler's `key_averages()`: kernel launches, the device's
    events by self time (most first), and their total device ms."""
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                                           "cudaLaunchKernelExC"))
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: e.self_device_time_total, reverse=True)
    return launches, kernels, sum(e.self_device_time_total for e in kernels) / 1e3


def moe_decode_profile(torch, np, cfg, model, params) -> None:
    """Where a granite decode step's time goes (batch 8 over a 512-token
    prefill, capacity 1): host enqueue against the device timeline over 3
    steps (CUDA events), then `torch.profiler` over 2: kernel launches, the
    device's busy time and idle share, the kernels that take the most device
    time, among them the per-step fp32 -> bf16 casts of the expert
    weights."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm as LM

    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (8, 520))).cuda()
    with torch.no_grad():
        _, caches = LM.lm_prefill(params, cfg, ids[:, :512], max_len=520)
        pos = iter(range(512, 520))

        def step():
            nonlocal caches
            t = next(pos)
            _, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            step()
        host_ms = (time.perf_counter() - t0) / 3 * 1e3
        end.record()
        torch.cuda.synchronize()
        print(f"moe decode profile: host enqueue {host_ms:.1f} ms a step, device timeline "
              f"{start.elapsed_time(end) / 3:.1f} ms (3 steps of batch 8, no sync inside)")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    launches, kernels, busy_ms = device_summary(prof.key_averages())
    busy_ms /= 2
    print(f"moe decode profile (under the profiler): {launches / 2:.0f} kernel launches a "
          f"step, device busy {busy_ms:.1f} ms of a {wall_ms:.1f} ms step "
          f"(idle {1 - busy_ms / wall_ms:.1%})")
    for e in kernels[:6]:
        print(f"moe decode profile: device {e.self_device_time_total / 1e3 / 2:.2f} ms a step "
              f"({e.count // 2} calls): {e.key[:90]}")


def phase_moe(torch, np, kernels: dict) -> tuple[int, dict]:
    """The MoE path: full-width granite-moe-3b-a800m (random weights from
    seed 0) served like the other models, every layer's prefill attention
    through the flash kernel and no scan; a profile of its decode step; its
    drop-free copy's prefill against token-by-token decode; the 2-layer
    card-vs-host check; reduced jamba through both kernels. Returns
    granite's flash launches and reduced jamba's launches by kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.models import moe as M

    t_phase = time.perf_counter()
    cfg = get_config("granite-moe-3b-a800m")
    model = make_model(cfg)
    params = model.init(0, device="cuda")
    print(f"{cfg.name}: {model.param_count() / 1e9:.3f} B parameters, "
          f"{model.active_param_count() / 1e9:.3f} B active, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; {cfg.moe_num_experts} "
          f"experts padded to {cfg.moe_padded_experts}, top-{cfg.moe_top_k}, capacity "
          f"{M.capacity(cfg, 512)} / {M.capacity(cfg, 128)} / {M.capacity(cfg, 1)} slots an "
          f"expert at 512 / 128 / 1 tokens a row")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, _ = phase_serve(torch, np, cfg, model, params, kernels, "flash_attention")
    print(f"serve {cfg.name}: phase {time.perf_counter() - t0:.1f} s with warm-up, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    moe_decode_profile(torch, np, cfg, model, params)
    # Batched prefill drops tokens over capacity and single-token decode
    # never does (a 32-token prompt gets 8 slots an expert), so this check
    # runs a drop-free copy: the capacity factor equal to the expert count.
    free = dataclasses.replace(cfg, moe_capacity_factor=float(cfg.moe_num_experts))
    phase_fp32_prefill_vs_decode(torch, np, kernels["flash_attention"], free,
                                 make_model(free), params)
    del params
    phase_moe_cross_check(torch, np, kernels)
    jamba = phase_jamba(torch, np, kernels)
    print(f"moe phase: {time.perf_counter() - t_phase:.1f} s")
    return launches, jamba


def whisper_run(torch, cfg, params, enc, ids, grads: bool) -> dict:
    """Whisper's outputs on `params`' device, on the host: encoder states,
    the prefill logits of `ids`' first 8 tokens, the logits of 8 decode
    steps over the rest, and with `grads` `encdec_loss` of `ids` (each
    token's label the next) and every leaf's gradient; the flash launches
    of the forward passes."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import encdec as ED

    device = tree.flatten(params)[0].device
    enc, ids = enc.to(device), ids.to(device)
    before = fa.launches
    out = {}
    with torch.no_grad():
        out["encoder states"] = ED.encode(params, cfg, enc).float().cpu()
        logits, caches = ED.encdec_prefill(params, cfg, enc, ids[:, :8], max_len=16)
        out["prefill logits"] = logits[:, :cfg.vocab_size].cpu()
        steps = []
        for t in range(8, 16):
            logits, caches = ED.encdec_decode_step(params, cfg, ids[:, t:t + 1], caches, t)
            steps.append(logits[:, :cfg.vocab_size].cpu())
        out["decode logits"] = torch.stack(steps, dim=1)
        del caches
    out["launches"] = fa.launches - before
    if grads:
        live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        loss = ED.encdec_loss(live, cfg, enc, ids[:, :-1], ids[:, 1:], loss_chunk=16)
        out["loss"] = float(loss.detach())
        out["grads"] = [g.cpu() for g in torch.autograd.grad(loss, tree.flatten(live))]
    return out


def phase_whisper_cross_check(torch, np) -> None:
    """Full-width whisper-large-v3 cut to 2 encoder and 2 decoder layers, one
    set of weights made on the card and copied to the host CPU; 2 requests
    of 1500 frames and 17 tokens: encoder states, prefill logits (the flash
    kernel on the card, the plain version on the host), 8 decode steps,
    `encdec_loss` and every leaf's gradient. Held to CROSS_TOL in fp32
    activations (the k biases' gradients, zero but for rounding, against
    1e-3 of the largest leaf gradient's norm); bf16 printed."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config("whisper-large-v3"), num_layers=2, enc_layers=2)
    card = make_model(cfg).init(0, device="cuda")
    host = tree.map_leaves(lambda t: t.cpu(), card)
    rng = np.random.default_rng(13)
    enc = torch.from_numpy(rng.standard_normal((2, 1500, cfg.d_model), dtype=np.float32))
    enc = enc.to(torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 17)))
    want_launches = 2 * cfg.enc_layers + cfg.num_layers
    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            t0 = time.perf_counter()
            got = whisper_run(torch, cfg, card, enc, ids, grads=True)
            torch.cuda.synchronize()
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            want = whisper_run(torch, cfg, host, enc, ids, grads=True)
            t_host = time.perf_counter() - t0
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        held = dtype == "float32"
        errs = {}
        for key in ("encoder states", "prefill logits", "decode logits"):
            a, b = got[key], want[key]
            errs[key] = (a - b).abs().max().item()
            errs[key + " ok"] = bool(torch.isfinite(a).all()) and bool(
                ((a - b).abs() <= CROSS_TOL + CROSS_TOL * b.abs()).all())
        rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        largest = max(g.norm() for g in want["grads"])
        grad_err = max(float((a - b).norm() / torch.maximum(b.norm(), 1e-3 * largest))
                       for a, b in zip(got["grads"], want["grads"]))
        print(f"whisper cross-check {dtype} activations, card vs host cpu (2 + 2 layers, 2 x "
              f"1500 frames): max|diff| encoder states {errs['encoder states']:.3e}, prefill "
              f"logits {errs['prefill logits']:.3e}, 8 decode steps' logits "
              f"{errs['decode logits']:.3e}; loss card {got['loss']!r}, host cpu "
              f"{want['loss']!r}, relative diff {rel_loss:.3e}; worst leaf gradient relative L2 "
              f"{grad_err:.3e}{f' (tol {CROSS_TOL})' if held else ' (printed only)'}; "
              f"{got['launches']} flash launches (want {want_launches}); card {t_card:.2f} s, "
              f"host cpu {t_host:.2f} s")
        if got["launches"] != want_launches:
            fail(f"whisper cross-check: {got['launches']} flash launches, want {want_launches}")
        if held and not (all(errs[k + " ok"] for k in ("encoder states", "prefill logits",
                                                        "decode logits"))
                         and math.isfinite(got["loss"]) and rel_loss <= CROSS_TOL
                         and grad_err <= CROSS_TOL):
            fail("whisper cross-check: the card disagrees with the host CPU in fp32 activations")
    del card, host


def phase_whisper_prefill_vs_decode(torch, np, cfg, params) -> None:
    """Full-depth whisper-large-v3 on the card alone, 2 requests of 1500
    frames: teacher-forced `decode_train` logits of 16 tokens against an
    8-token `encdec_prefill` and 8 `encdec_decode_step`s over the self and
    cross caches. Held to CROSS_TOL in fp32 activations, bf16 printed."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM

    rng = np.random.default_rng(14)
    enc = torch.from_numpy(rng.standard_normal((2, 1500, cfg.d_model), dtype=np.float32))
    enc = enc.to("cuda", torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16))).cuda()
    v = cfg.vocab_size
    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            with torch.no_grad():
                h = ED.decode_train(params, cfg, ED.encode(params, cfg, enc), ids)
                ref = LM.logits_from_hidden(params, cfg, h)[..., :v]
                logits, caches = ED.encdec_prefill(params, cfg, enc, ids[:, :8], max_len=16)
                got = [logits[:, :v]]
                for t in range(8, 16):
                    logits, caches = ED.encdec_decode_step(params, cfg, ids[:, t:t + 1],
                                                           caches, t)
                    got.append(logits[:, :v])
                del caches
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        a, b = torch.stack(got, dim=1).float(), ref[:, 7:].float()
        err = (a - b).abs()
        held = dtype == "float32"
        ok = bool(torch.isfinite(a).all()) and bool((err <= CROSS_TOL + CROSS_TOL * b.abs()).all())
        print(f"{cfg.name}: teacher-forced logits vs 8-token prefill then 8 decode steps, "
              f"{dtype} activations: max|diff| {err.max().item():.3e}"
              f"{f' (tol {CROSS_TOL})' if held else ' (printed only)'}; argmax agrees on "
              f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.2%} of 18 positions")
        if held and not ok:
            fail(f"{cfg.name}: prefill and decode disagree with teacher forcing in fp32 "
                 f"activations")


def whisper_prefill_profile(torch, np, cfg, params) -> None:
    """Where the driver's prefill time goes once warm (8 requests of 1500
    frames, an 8-token prompt, bf16 activations): the host clock against the
    device timeline over 3 calls (CUDA events), then `torch.profiler` over
    1: kernel launches, the device's busy time and idle share, and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import encdec as ED

    rng = np.random.default_rng(15)
    enc = torch.from_numpy(rng.standard_normal((8, 1500, cfg.d_model), dtype=np.float32))
    enc = enc.to("cuda", torch.bfloat16)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 8))).cuda()

    def prefill():
        return ED.encdec_prefill(params, cfg, enc, ids, max_len=40, q_chunk=512)

    with torch.no_grad():
        prefill()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            prefill()
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
        print(f"whisper prefill profile (warm): wall {wall_ms:.1f} ms a call, device timeline "
              f"{start.elapsed_time(end) / 3:.1f} ms (3 calls, no sync inside)")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    launches, kernels, busy_ms = device_summary(prof.key_averages())
    print(f"whisper prefill profile (under the profiler): {launches} kernel launches, device "
          f"busy {busy_ms:.1f} ms of a {wall_ms:.1f} ms call (idle {1 - busy_ms / wall_ms:.1%})")
    for e in kernels[:8]:
        print(f"whisper prefill profile: device {e.self_device_time_total / 1e3:.2f} ms "
              f"({e.count} calls): {e.key[:90]}")


def phase_whisper(torch, np, kernels: dict) -> int:
    """The encoder-decoder path: full-width whisper-large-v3 served by the
    port's driver (the kernels' counts set to 0 just before and read just
    after: one unmasked flash launch per encoder layer and one causal per
    decoder layer, no scan), then the 2-layer card-vs-host check and the
    full-depth prefill-vs-decode check. Returns the driver run's flash
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import make_model

    t_phase = time.perf_counter()
    cfg = get_config("whisper-large-v3")
    model = make_model(cfg)
    cross_bytes = (2 * cfg.num_layers * 8 * 1500 * cfg.num_kv_heads * cfg.head_dim * 2)
    print(f"{cfg.name}: {model.param_count():,} parameters ({model.param_count() * 4 / 1e9:.2f} "
          f"GB in fp32), {cfg.enc_layers} encoder and {cfg.num_layers} decoder layers; cross "
          f"caches at 8 x 1500 frames {cross_bytes / 1e9:.2f} GB in bf16")
    log = RestoreLog()
    ckpt_log = logging.getLogger("repro_torch.ckpt")
    ckpt_log.setLevel(logging.INFO)
    ckpt_log.addHandler(log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    try:
        out = serve.main(WHISPER_ARGS)
        torch.cuda.synchronize()
    finally:
        ckpt_log.removeHandler(log)
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in kernels.items()}
    for sp in log.splits:
        print(f"serve {cfg.name}: the driver's restore waited {sp['reader_s']:.3f} s on the "
              f"reader and {sp['h2d_wait_s']:.3f} s on host-to-device copies (digest "
              f"{sp['digest_s']:.3f} s, staging {sp['stage_s']:.3f} s, restore loop "
              f"{sp['total_s']:.3f} s)")
    want = {"flash_attention": cfg.enc_layers + cfg.num_layers, "ssd_scan": 0}
    print(f"serve {cfg.name} (launch.serve {' '.join(WHISPER_ARGS)}): {wall:.1f} s with publish "
          f"and restore; peak {(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above "
          f"the {base / 1e9:.2f} GB held before; kernel launches {counts} (want {want})")
    if counts != want:
        fail(f"{cfg.name}: kernel launches {counts}, want {want}")
    if out.shape != (8, 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"{cfg.name}: generated ids of shape {out.shape} in [{out.min()}, {out.max()}], "
             f"want (8, 32) in [0, {cfg.vocab_size})")
    phase_whisper_cross_check(torch, np)
    params = model.init(1, device="cuda")
    phase_whisper_prefill_vs_decode(torch, np, cfg, params)
    whisper_prefill_profile(torch, np, cfg, params)
    del params
    print(f"encoder-decoder phase: {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_attention"]


def mem_available_gb() -> float:
    """The host's MemAvailable (/proc/meminfo), in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def same_bits(torch, a, b) -> bool:
    """Equal dtype, shape and bytes, wherever each tensor lies."""
    a, b = a.detach().cpu().contiguous(), b.detach().cpu().contiguous()
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def recorded_dequants(fn) -> list:
    """Run `fn()` once and return the (QTensor, dtype) of every `QTensor.to`
    call it made: the dequantizations of one prefill or decode step."""
    from repro_torch.models.quant import QTensor

    real, calls = QTensor.to, []

    def spy(self, dtype):
        calls.append((self, dtype))
        return real(self, dtype)

    QTensor.to = spy
    try:
        fn()
    finally:
        QTensor.to = real
    return calls


def quant_profile(torch, np, cfg, model, params, label: str, what: str) -> dict:
    """Where a warm codeqwen1.5-7b `what` ("decode": a step of batch 8 over a
    512-token prefill; "prefill": 8 prompts of 512) spends its time with
    `params` (int8 or bf16 weights): the host enqueue against the device
    timeline over 3 calls (CUDA events), `torch.profiler` over 2 (launches,
    device busy, idle share, top kernels), and, for int8, the dequantization
    chain of one call (every `QTensor.to` it made, replayed alone, timed with
    CUDA events) beside its bytes' bound."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm as LM

    ids = torch.from_numpy(np.random.default_rng(16).integers(0, cfg.vocab_size,
                                                              (8, 520))).cuda()
    out: dict = {}
    with torch.no_grad():
        if what == "decode":
            _, caches = LM.lm_prefill(params, cfg, ids[:, :512], max_len=520)
            pos = iter(range(512, 520))

            def call():
                nonlocal caches
                t = next(pos)
                _, caches = model.decode_step(params, ids[:, t:t + 1], caches, t)
        else:
            def call():
                LM.lm_prefill(params, cfg, ids[:, :512], max_len=520)

        calls = recorded_dequants(call)        # also the warm-up
        call()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(3):
            call()
        out["host_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        end.record()
        torch.cuda.synchronize()
        out["timeline_ms"] = start.elapsed_time(end) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                call()
            torch.cuda.synchronize()
            out["wall_ms"] = (time.perf_counter() - t0) / 2 * 1e3
    launches, kernels, busy_ms = device_summary(prof.key_averages())
    out["launches"], out["busy_ms"] = launches / 2, busy_ms / 2
    print(f"codeqwen {what} profile, {label} weights (warm, batch 8): host enqueue "
          f"{out['host_ms']:.1f} ms a call, device timeline {out['timeline_ms']:.1f} ms (3 calls, "
          f"no sync inside); under the profiler {out['launches']:.0f} kernel launches a call, "
          f"device busy {out['busy_ms']:.1f} ms of a {out['wall_ms']:.1f} ms call (idle "
          f"{1 - out['busy_ms'] / out['wall_ms']:.1%})")
    for e in kernels[:6]:
        print(f"codeqwen {what} profile, {label}: device {e.self_device_time_total / 1e3 / 2:.2f} "
              f"ms a call ({e.count // 2} calls): {e.key[:90]}")
    if calls:
        elems = sum(qt.q.numel() for qt, _ in calls)
        # q read (1 B), the fp32 product written and read (4 + 4 B), the
        # result written in the activations' dtype (2 B).
        nbytes = sum(qt.q.numel() * (1 + 4 + 4 + torch.empty(0, dtype=dt).element_size())
                     for qt, dt in calls)

        def replay():
            for qt, dt in calls:
                qt.to(dt)

        out["dequant_ms"] = cuda_ms(torch, replay, reps=5, inner=2)
        out["dequant_bound_ms"] = nbytes / PEAK_BYTES_S * 1e3
        print(f"codeqwen {what} profile, {label}: the dequantization chain of one call, "
              f"{len(calls)} QTensor.to calls over {elems / 1e9:.3f} G int8 elements, replayed "
              f"alone: {out['dequant_ms']:.3f} ms of device time against its bytes' bound "
              f"{out['dequant_bound_ms']:.3f} ms ({nbytes / 1e9:.1f} GB: int8 read, fp32 "
              f"written and read, bf16 written; {out['dequant_bound_ms'] / out['dequant_ms']:.1%}"
              f" of it); {out['dequant_ms'] / out['timeline_ms']:.1%} of the call's device "
              f"timeline")
    return out


def phase_codeqwen_cross_check(torch, np, cfg) -> None:
    """codeqwen1.5-7b at full width cut to 2 layers, one set of fp32 weights
    made on the card and copied to the host CPU: quantized on each, `q` and
    `scale` equal bit for bit; then the int8 model's prefill logits (2
    prompts of 128; the flash kernel on the card, the plain version on the
    host) and 8 decode steps, held to CROSS_TOL in fp32 activations, bf16
    printed."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import make_model
    from repro_torch.models.quant import quantize_params

    small = dataclasses.replace(cfg, num_layers=2)
    model = make_model(small)
    card = model.init(2, device="cuda")
    host = tree.map_leaves(lambda t: t.cpu(), card)
    t0 = time.perf_counter()
    q_card, n_card = quantize_params(card)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    q_host, n_host = quantize_params(host)
    t_host = time.perf_counter() - t0
    del card
    pairs = list(zip(tree.flatten(q_card), tree.flatten(q_host)))
    equal = sum(same_bits(torch, a, b) for a, b in pairs)
    print(f"codeqwen quantization, card vs host cpu ({small.num_layers} layers at full width, "
          f"{model.param_count() / 1e9:.3f} B parameters): {n_card} / {n_host} tensors "
          f"quantized; {equal} of {len(pairs)} leaves (q, scale and the unquantized) equal bit "
          f"for bit; card {t_card:.2f} s, host cpu {t_host:.2f} s")
    if n_card != n_host or equal != len(pairs):
        fail("codeqwen: quantization on the card differs from the host CPU's")

    rng = np.random.default_rng(17)
    ids = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 136)))
    v = small.vocab_size

    def run(params, device):
        x = ids.to(device)
        before = fa.launches
        with torch.no_grad():
            logits, caches = LM.lm_prefill(params, small, x[:, :128], max_len=136)
            got = [logits[:, :v]]
            for t in range(128, 136):
                logits, caches = LM.lm_decode_step(params, small, x[:, t:t + 1], caches, t)
                got.append(logits[:, :v])
        return torch.stack(got, dim=1).float().cpu(), fa.launches - before

    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            t0 = time.perf_counter()
            a, launches = run(q_card, "cuda")
            t_card = time.perf_counter() - t0
            t0 = time.perf_counter()
            b, _ = run(q_host, "cpu")
            t_host = time.perf_counter() - t0
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        held = dtype == "float32"
        err = (a - b).abs()
        ok = bool(torch.isfinite(a).all()) and bool((err <= CROSS_TOL + CROSS_TOL * b.abs()).all())
        print(f"codeqwen int8 cross-check {dtype} activations, card vs host cpu (2 x 128-token "
              f"prefill, 8 decode steps): max|diff| prefill logits {err[:, 0].max().item():.3e}, "
              f"decode logits {err[:, 1:].max().item():.3e}"
              f"{f' (tol {CROSS_TOL})' if held else ' (printed only)'}; argmax agrees on "
              f"{(a.argmax(-1) == b.argmax(-1)).float().mean().item():.2%} of 18 positions; "
              f"{launches} flash launches (want {small.num_layers}); card {t_card:.2f} s, host "
              f"cpu {t_host:.2f} s")
        if launches != small.num_layers:
            fail(f"codeqwen cross-check: {launches} flash launches, want {small.num_layers}")
        if held and not ok:
            fail("codeqwen int8: the card disagrees with the host CPU in fp32 activations")
    del q_card, q_host, host


def phase_codeqwen_int8_vs_bf16(torch, np, cfg, model) -> None:
    """Full-depth codeqwen1.5-7b on the card, one set of weights quantized
    and not (a bf16 copy): the logits of a 64-token prefill and 8 decode
    steps (2 prompts, the bf16 model's greedy tokens fed to both) held to
    the reference's limit, max |diff| / max |logit| < QUANT_RATIO_TOL; then
    the profiles of a warm decode step and a warm prefill with each."""
    from repro_torch import tree
    from repro_torch.models import lm as LM
    from repro_torch.models.quant import quantize_params

    params = model.init(1, device="cuda")
    q_params, _ = quantize_params(params)
    bf16 = tree.map_leaves(lambda t: t.to(torch.bfloat16), params)
    del params
    torch.cuda.synchronize()
    print(f"codeqwen int8 vs bf16: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated "
          f"with both trees on the card")
    ids = torch.from_numpy(np.random.default_rng(18).integers(0, cfg.vocab_size, (2, 72))).cuda()
    v = cfg.vocab_size
    ratios, agree = [], []

    def record(lb, lq):
        a, b = lb[:, :v].float(), lq[:, :v].float()
        ratios.append(((a - b).abs().max() / (a.abs().max() + 1e-6)).item())
        agree.append((a.argmax(-1) == b.argmax(-1)).float().mean().item())
        return a.argmax(-1, keepdim=True)

    with torch.no_grad():
        lb, cb = LM.lm_prefill(bf16, cfg, ids[:, :64], max_len=72)
        lq, cq = LM.lm_prefill(q_params, cfg, ids[:, :64], max_len=72)
        for t in range(64, 72):
            tok = record(lb, lq)
            lb, cb = LM.lm_decode_step(bf16, cfg, tok, cb, t)
            lq, cq = LM.lm_decode_step(q_params, cfg, tok, cq, t)
        record(lb, lq)
    del cb, cq
    worst = max(ratios)
    print(f"codeqwen int8 vs bf16 weights, full depth (2 x 64-token prefill, 8 decode steps): "
          f"max|diff| / max|logit| worst {worst:.4f} (limit {QUANT_RATIO_TOL}, "
          f"tests/test_quant.py), per call {', '.join(f'{r:.4f}' for r in ratios)}; greedy "
          f"tokens agree on {statistics.mean(agree):.2%}")
    if not (math.isfinite(worst) and worst < QUANT_RATIO_TOL):
        fail(f"codeqwen: int8 logits drift {worst:.4f} of the logit range from bf16's")

    for what in ("decode", "prefill"):
        q = quant_profile(torch, np, cfg, model, q_params, "int8", what)
        b = quant_profile(torch, np, cfg, model, bf16, "bf16", what)
        print(f"codeqwen {what} profile: int8 takes {q['timeline_ms']:.1f} ms of device timeline "
              f"against bf16's {b['timeline_ms']:.1f} ms ({q['timeline_ms'] / b['timeline_ms']:.2f}"
              f"x); device busy {q['busy_ms']:.1f} against {b['busy_ms']:.1f} ms, a difference "
              f"of {q['busy_ms'] - b['busy_ms']:.1f} ms beside the dequantization chain's "
              f"{q['dequant_ms']:.1f} ms")
    del q_params, bf16


def phase_codeqwen(torch, np, kernels: dict) -> int:
    """int8 weight-only serving: full-width, full-depth codeqwen1.5-7b served
    by the port's driver with --quant int8 (the kernels' counts set to 0 just
    before and read just after: one causal flash launch per layer at head
    dim 128, no scan; the reference's count of quantized tensors), then the
    2-layer quantization and card-vs-host checks, the full-depth int8 vs
    bf16 check and profiles, and examples/torch/serve_batched.py in a
    process of its own. Returns the driver run's flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.io.stores import clear_store_cache
    from repro_torch.launch import serve
    from repro_torch.models import make_model

    t_phase = time.perf_counter()
    cfg = get_config("codeqwen1.5-7b")
    model = make_model(cfg)
    print(f"{cfg.name}: {model.param_count():,} parameters ({model.param_count() * 4 / 1e9:.2f} "
          f"GB in fp32), {cfg.num_layers} layers, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}; host MemAvailable {mem_available_gb():.1f} GB at the phase's start "
          f"(the simulated store holds the fp32 publish in host memory)")
    counted = []
    real_quantize = serve.quantize_params

    def counting(params):
        out = real_quantize(params)
        counted.append(out[1])
        return out

    log = RestoreLog()
    ckpt_log = logging.getLogger("repro_torch.ckpt")
    ckpt_log.setLevel(logging.INFO)
    ckpt_log.addHandler(log)
    serve.quantize_params = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    try:
        out = serve.main(CODEQWEN_ARGS)
        torch.cuda.synchronize()
    finally:
        ckpt_log.removeHandler(log)
        serve.quantize_params = real_quantize
    wall = time.perf_counter() - t0
    counts = {name: mod.launches for name, mod in kernels.items()}
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    clear_store_cache()      # the 32.8 GB publish lives in the cached store
    gc.collect()
    for sp in log.splits:
        print(f"serve {cfg.name}: the driver's restore waited {sp['reader_s']:.3f} s on the "
              f"reader and {sp['h2d_wait_s']:.3f} s on host-to-device copies (digest "
              f"{sp['digest_s']:.3f} s, staging {sp['stage_s']:.3f} s, restore loop "
              f"{sp['total_s']:.3f} s)")
    want = {"flash_attention": cfg.num_layers, "ssd_scan": 0}
    print(f"serve {cfg.name} (launch.serve {' '.join(CODEQWEN_ARGS)}): {wall:.1f} s with publish, "
          f"restore and quantization; peak {peak:.2f} GB above the {base / 1e9:.2f} GB held "
          f"before; {counted} tensors quantized (want [{CODEQWEN_QUANTIZED}]); kernel launches "
          f"{counts} (want {want}); host MemAvailable {mem_available_gb():.1f} GB after")
    if counts != want:
        fail(f"{cfg.name}: kernel launches {counts}, want {want}")
    if counted != [CODEQWEN_QUANTIZED]:
        fail(f"{cfg.name}: quantized {counted} tensors, want [{CODEQWEN_QUANTIZED}]")
    if out.shape != (8, 32) or out.min() < 0 or out.max() >= cfg.vocab_size:
        fail(f"{cfg.name}: generated ids of shape {out.shape} in [{out.min()}, {out.max()}], "
             f"want (8, 32) in [0, {cfg.vocab_size})")
    phase_codeqwen_cross_check(torch, np, cfg)
    phase_codeqwen_int8_vs_bf16(torch, np, cfg, model)
    run_example("serve_batched", "OK")
    print(f"int8 serving phase: {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_attention"]


class RestoreLog(logging.Handler):
    """Keeps the split of wall time that each restore logs on its record
    (`restore_split`: reader, digest, staging and host-to-device wait)."""

    def __init__(self) -> None:
        super().__init__(logging.INFO)
        self.splits: list[dict] = []

    def emit(self, record) -> None:
        if hasattr(record, "restore_split"):
            self.splits.append(record.restore_split)


def count_store_gets(store) -> list:
    """Count the store's data GETs (range and coalesced-range requests; the
    manifest GET and the size HEADs are metadata): one entry per call,
    appended by whichever engine thread makes it."""
    calls: list = []
    for name in ("get_range", "get_ranges"):
        fn = getattr(store, name)

        def counted(*args, _fn=fn, **kw):
            calls.append(1)
            return _fn(*args, **kw)

        setattr(store, name, counted)
    return calls


def check_restored(torch, want: dict, got: dict, what: str) -> None:
    """Every leaf bit-exact (`torch.equal`, dtype and shape) and on the card."""
    from repro_torch.ckpt.manager import _flatten

    want, got = _flatten(want), _flatten(got)
    if len(got) != len(want):
        fail(f"restore {what}: {len(got)} leaves, want {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        if not b.is_cuda or b.dtype != a.dtype or b.shape != a.shape or not torch.equal(a, b):
            fail(f"restore {what}: leaf {i} is {b.dtype} {tuple(b.shape)} on {b.device}, "
                 f"want {a.dtype} {tuple(a.shape)} on the card, bit-exact")


def phase_restore(torch, np, cfg, model, params, kernels: dict, tokens: dict) -> None:
    """Publish full-width weights to a simulated object store and restore
    them onto the card: rolling (through `ServeEngine.from_store`,
    which then serves the serve phase's traffic and must give its tokens),
    sequential, and rolling into a disk cache under build/ twice, the second
    time with no store GET. Then the same restores of a bf16 copy."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.ckpt.manager import _flatten
    from repro_torch.io import IOPolicy, open_store

    store = open_store(RESTORE_URI)
    gets = count_store_gets(store)
    log = RestoreLog()
    ckpt_log = logging.getLogger("repro_torch.ckpt")
    ckpt_log.setLevel(logging.INFO)
    ckpt_log.propagate = False
    ckpt_log.addHandler(log)
    cache_root = os.path.join(ROOT, "build", "restore_cache")
    shutil.rmtree(cache_root, ignore_errors=True)
    t_phase = time.perf_counter()

    def measured(label: str, restore):
        """Run `restore()` and return what it returns; print its seconds,
        data GETs, bytes moved over the link and the split of its wall
        time."""
        g0, b0, n0 = len(gets), store.link.bytes_moved, len(log.splits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = restore()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if len(log.splits) != n0 + 1:
            fail(f"restore {label}: logged {len(log.splits) - n0} restore records, want 1")
        sp = log.splits[-1]
        print(f"restore {label}: {dt:.3f} s, {len(gets) - g0} store GETs, "
              f"{(store.link.bytes_moved - b0) / 1e6:.1f} MB moved; main thread waited "
              f"{sp['reader_s']:.3f} s on the reader and {sp['h2d_wait_s']:.3f} s on "
              f"host-to-device copies (digest {sp['digest_s']:.3f} s, staging "
              f"{sp['stage_s']:.3f} s, restore loop {sp['total_s']:.3f} s)")
        return tree

    for dtype in ("float32", "bfloat16"):
        tree = (params if dtype == "float32"
                else model.init(0, device="cuda", param_dtype=torch.bfloat16))
        prefix = f"weights_{dtype}"
        leaves = _flatten(tree)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        t0 = time.perf_counter()
        save_checkpoint(store, prefix, 0, tree, policy=IOPolicy(write_depth=4))
        print(f"save {dtype}: {time.perf_counter() - t0:.3f} s, {nbytes / 1e6:.1f} MB in "
              f"{len(leaves)} leaves to {RESTORE_URI}")

        def policy(engine: str) -> IOPolicy:   # the driver's restore policy
            return IOPolicy(engine=engine, depth=2, eviction_interval_s=0.2)

        if dtype == "float32":
            engines = []

            def from_store(cls):
                engines.append(measured(
                    f"{dtype} rolling (ServeEngine.from_store)",
                    lambda: cls.from_store(model, store, prefix, tree, device="cuda")))
                return engines[-1]

            launches, served = phase_serve(torch, np, cfg, model, tree, kernels,
                                           "flash_attention", make_engine=from_store)
            check_restored(torch, tree, engines[0].params, f"{dtype} rolling")
            if served != tokens:
                fail("greedy tokens served from the store differ from the in-memory run's")
            print(f"serve from the store: {len(served)} requests, greedy tokens identical to "
                  f"the in-memory run's, {launches} flash launches")
            del engines
        else:
            got = measured(f"{dtype} rolling",
                           lambda: restore_checkpoint(store, prefix, tree, device="cuda",
                                                      policy=policy("rolling"))[0])
            check_restored(torch, tree, got, f"{dtype} rolling")
            del got
        got = measured(f"{dtype} sequential",
                       lambda: restore_checkpoint(store, prefix, tree, device="cuda",
                                                  policy=policy("sequential"))[0])
        check_restored(torch, tree, got, f"{dtype} sequential")
        del got
        cache = os.path.join(cache_root, dtype)
        for run in ("cold", "warm"):
            g0 = len(gets)
            got = measured(f"{dtype} rolling, cache_dir {run}",
                           lambda: restore_checkpoint(store, prefix, tree, device="cuda",
                                                      policy=policy("rolling"), cache_dir=cache,
                                                      cache_capacity=2 * nbytes)[0])
            check_restored(torch, tree, got, f"{dtype} cache_dir {run}")
            del got
            if run == "warm" and len(gets) != g0:
                fail(f"warm restore from {cache} made {len(gets) - g0} store GETs, want 0")
        del tree
    ckpt_log.removeHandler(log)
    shutil.rmtree(cache_root, ignore_errors=True)
    print(f"restore phase: {time.perf_counter() - t_phase:.1f} s")


def copy_step(src, dst, prefix: str, step: int) -> int:
    """Copy one committed checkpoint's objects between simulated stores;
    returns the bytes copied."""
    n = 0
    for meta in src.backing.list_objects(f"{prefix}/step_{step:08d}/"):
        data = src.backing.get(meta.key)
        dst.backing.put(meta.key, data)
        n += len(data)
    return n


def phase_train_overfit(torch) -> None:
    """The driver's train step, config and first batch (from its simulated
    store, through the rolling-prefetch loader), trained on repeatedly: with
    no sampling noise the loss must fall by OVERFIT_FALL at least."""
    from repro_torch.configs import get_config
    from repro_torch.data import LoaderConfig, PrefetchingDataLoader
    from repro_torch.io import IOPolicy
    from repro_torch.launch import train
    from repro_torch.models import make_model
    from repro_torch.store import MemTier
    from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state

    cfg = get_config("smollm-135m")
    model = make_model(cfg)
    store = train.build_data_store(8, 200_000, cfg.vocab_size, 0.01, 50e6)
    loader = PrefetchingDataLoader(store, store.list_objects("data/"), [MemTier(8 << 20)],
                                   LoaderConfig(seq_len=256, batch_size=8,
                                                policy=IOPolicy(blocksize=256 << 10)))
    try:
        inputs, labels = next(iter(loader.batches(max_batches=1)))
    finally:
        loader.close()
    batch = {"inputs": torch.from_numpy(inputs).cuda(), "labels": torch.from_numpy(labels).cuda()}
    state = init_train_state(model, 0, device="cuda")
    step = build_train_step(model, AdamWConfig(total_steps=40, warmup_steps=2),
                            StepConfig(q_chunk=256, loss_chunk=256))
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, m = step(state, batch)
        losses.append(m["loss"])
    losses = torch.stack(losses).tolist()
    print(f"train, one batch {OVERFIT_STEPS} times: losses {[round(x, 4) for x in losses]}")
    if not (all(map(math.isfinite, losses)) and losses[-1] <= losses[0] - OVERFIT_FALL):
        fail(f"training on one batch: the loss did not fall by {OVERFIT_FALL}")


def phase_train_cross_check(torch, np) -> None:
    """Two train steps of full-width smollm-135m from the same parameters
    and batches on the card and on the host CPU, fp32 activations (the
    card's bf16 matmuls and the CPU's round differently), batch 2 x 128:
    loss and grad_norm held to CROSS_TOL. Parameters are made on the CPU and
    copied, since a CUDA generator draws other numbers."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state

    cfg = get_config("smollm-135m")
    model = make_model(cfg)
    step = build_train_step(model, AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=40),
                            StepConfig(q_chunk=128, loss_chunk=128))
    L.COMPUTE_DTYPE = torch.float32
    try:
        host = init_train_state(model, 0, device="cpu")
        card = tree.map_leaves(lambda t: t.to("cuda"), host)
        rng = np.random.default_rng(7)
        worst = 0.0
        for i in range(2):
            ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)))
            t0 = time.perf_counter()
            host, mh = step(host, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
            t_host = time.perf_counter() - t0
            ids = ids.cuda()
            card, mc = step(card, {"inputs": ids[:, :-1], "labels": ids[:, 1:]})
            for key in ("loss", "grad_norm", "lr"):
                a, b = float(mc[key]), float(mh[key])
                rel = abs(a - b) / abs(b)
                worst = max(worst, rel)
                print(f"train cross-check step {i + 1} {key}: card {a!r}, host cpu {b!r}, "
                      f"relative diff {rel:.3e} (tol {CROSS_TOL})")
                if not (math.isfinite(a) and rel <= CROSS_TOL):
                    fail(f"train step on the card disagrees with the host CPU on {key}")
            print(f"train cross-check step {i + 1}: host cpu step {t_host:.2f} s")
        diff = max((a.cpu() - b).abs().max().item()
                   for a, b in zip(tree.flatten(card.params), tree.flatten(host.params)))
        print(f"train cross-check: params after 2 steps max|diff| {diff:.3e} (printed only); "
              f"worst metric relative diff {worst:.3e}")
    finally:
        L.COMPUTE_DTYPE = torch.bfloat16


def phase_train_profile(torch, np) -> None:
    """Where a training step's time goes: the driver's step (full-width
    smollm-135m, batch 8 x 256, bf16 activations, remat) on one fixed batch,
    as host enqueue time against device time over 3 steps (CUDA events),
    then `torch.profiler` over 2 steps: kernel launches, the device's busy
    time by kernel and its idle share, and the host operators that cost the
    most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state

    model = make_model(get_config("smollm-135m"))
    state = init_train_state(model, 0, device="cuda")
    step = build_train_step(model, AdamWConfig(total_steps=40, warmup_steps=2),
                            StepConfig(q_chunk=256, loss_chunk=256))
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 49152, (8, 257))).cuda()
    batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(3):
        state, _ = step(state, batch)
    host_ms = (time.perf_counter() - t0) / 3 * 1e3
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"train profile: host enqueue {host_ms:.1f} ms a step, device timeline "
          f"{start.elapsed_time(end) / 3:.1f} ms, wall {wall_ms:.1f} ms (3 steps, no sync inside)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 2 * 1e3
    events = prof.key_averages()
    launches, kernels, busy_ms = device_summary(events)
    busy_ms /= 2
    print(f"train profile (under the profiler): {launches / 2:.0f} kernel launches a step, "
          f"device busy {busy_ms:.1f} ms of a {wall_ms:.1f} ms step "
          f"(idle {1 - busy_ms / wall_ms:.1%})")
    for e in kernels[:6]:
        print(f"train profile: device {e.self_device_time_total / 1e3 / 2:.2f} ms a step "
              f"({e.count // 2} calls): {e.key[:90]}")
    hosts = sorted((e for e in events if e.device_type.name == "CPU"),
                   key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in hosts[:6]:
        print(f"train profile: host {e.self_cpu_time_total / 1e3 / 2:.1f} ms a step "
              f"({e.count // 2} calls): {e.key[:90]}")


def phase_train(torch, np, kernels: dict) -> None:
    """Train full-width smollm-135m from the simulated object store through
    the port's driver, resume from its step-20 checkpoint, time a restore
    and a save of the TrainState, cross-check two steps against the host
    CPU, and show that the forward-only entries refuse inputs that need
    grad. The kernels' counts are set to 0 right before the first run and
    read right after it: smollm-135m's attention (D 64, bf16) trains through
    the flash kernel with its backward, so each step must launch the
    forward twice a layer (the forward and remat's recompute) and the
    backward once, and the scan never (training takes the plain SSD)."""
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.io import open_store
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import make_model
    from repro_torch.train import init_train_state

    t_phase = time.perf_counter()
    uri_a = TRAIN_CKPT_URI.format(bucket="train-a")
    uri_b = TRAIN_CKPT_URI.format(bucket="train-b")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for mod in kernels.values():
        mod.launches = 0
    kernels["flash_attention"].backward_launches = 0
    a = train.main(TRAIN_ARGS + ["--ckpt-store", uri_a])
    counts = {name: mod.launches for name, mod in kernels.items()}
    backward = kernels["flash_attention"].backward_launches
    peak = torch.cuda.max_memory_allocated() - base
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    layers = get_config("smollm-135m").num_layers
    want = {"flash_attention": 2 * steps * layers, "ssd_scan": 0}
    print(f"train: {steps} steps of {layers} layers launched {counts}, flash backward "
          f"{backward}; want {want}, flash backward {steps * layers}")
    if counts != want or backward != steps * layers:
        fail(f"training's launches: {counts}, {backward} flash backward")
    losses = a.losses
    if len(losses) != 40 or not all(math.isfinite(x) for x in losses):
        fail(f"training: {len(losses)} losses, finite: {all(map(math.isfinite, losses))}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-10:])
    print(f"train losses (steps 1-40): {[round(x, 4) for x in losses]}")
    print(f"train: mean loss of steps 1-5 {first:.4f}, of steps 31-40 {last:.4f} "
          f"(uniform tokens: floor ln(49152) = {math.log(49152):.4f})")
    if not last <= first + CLIMB_TOL:
        fail("training: the loss climbed")
    steady = a.step_ms[2:]          # the first steps allocate and warm cuBLAS
    step_ms = statistics.median(steady)
    tokens_step = 8 * 256
    print(f"train: {a.tokens} tokens in {a.wall_s:.2f} s wall ({a.tokens / a.wall_s:.0f} tok/s "
          f"with checkpoints and warm-up); median step {step_ms:.2f} ms on the device timeline "
          f"(steps 3-40, min {min(steady):.2f}, max {max(steady):.2f}) = "
          f"{tokens_step / step_ms * 1e3:.0f} tok/s")
    print(f"train: feeder wait per step median {statistics.median(a.feeder_wait_s) * 1e3:.3f} ms, "
          f"max {max(a.feeder_wait_s) * 1e3:.3f} ms, total {sum(a.feeder_wait_s):.3f} s; "
          f"peak device memory {peak / 1e9:.3f} GB above the {base / 1e9:.3f} GB held before")
    totals = a.fs_stats["totals"]
    print(f"train loader: {totals['store_requests']} store GETs, {totals['bytes_fetched']} bytes "
          f"fetched, {totals['bytes_read']} bytes read by the loader")

    # Resume: the step-20 checkpoint alone in a store of its own.
    store_a, store_b = open_store(uri_a), open_store(uri_b)
    nbytes = copy_step(store_a, store_b, "ckpt", 20)
    b = train.main(TRAIN_ARGS + ["--ckpt-store", uri_b])
    if b.start_step != 20 or len(b.losses) != 20:
        fail(f"resume: started at {b.start_step} with {len(b.losses)} steps, want 20 and 20")
    rel = max(abs(x - y) / abs(y) for x, y in zip(b.losses, losses[20:]))
    exact = b.losses == losses[20:]
    print(f"train resume: restored {nbytes / 1e9:.3f} GB (step 20) in {b.restore_s:.3f} s, "
          f"steps 21-40 losses {'bit for bit equal to' if exact else 'differ from'} the "
          f"uninterrupted run's (max relative diff {rel:.3e}, tol {RESUME_TOL})")
    if not rel <= RESUME_TOL:
        fail("the resumed run's losses differ from the uninterrupted run's")
    same = sum(store_a.backing.get(m.key) == store_b.backing.get(m.key)
               for m in store_a.backing.list_objects("ckpt/step_00000040/")
               if not m.key.endswith("MANIFEST.json"))
    print(f"train resume: {same} of the step-40 TrainState's leaves byte-identical across "
          f"the two runs")

    # A TrainState restore and save at the store's speed, timed alone.
    model = make_model(get_config("smollm-135m"))
    template = init_train_state(model, 0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = restore_checkpoint(store_a, "ckpt", template, step=40, device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    del template
    store_c = open_store(TRAIN_CKPT_URI.format(bucket="train-c"))
    t0 = time.perf_counter()
    save_checkpoint(store_c, "ckpt", 40, state)
    t_save = time.perf_counter() - t0
    print(f"train state: {nbytes / 1e9:.3f} GB; restore (rolling, onto the card) "
          f"{t_restore:.3f} s, save (write-behind) {t_save:.3f} s at {uri_a}")
    del state

    phase_train_overfit(torch)
    phase_train_cross_check(torch, np)
    phase_train_profile(torch, np)
    counts = {name: mod.launches for name, mod in kernels.items()}

    # The kernels' entries refuse a CUDA input that requires grad.
    q = torch.randn((1, 2, 64, 64), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    x = torch.randn((1, 256, 2, 64), device="cuda", dtype=torch.bfloat16, requires_grad=True)
    dt_a = -torch.rand((1, 256, 2), device="cuda")
    bc = torch.randn((1, 256, 1, 64), device="cuda", dtype=torch.bfloat16)
    for name, call in (("flash_attention", lambda: ops.flash_attention(q, q, q)),
                       ("ssd_scan", lambda: ops.ssd_scan(x, dt_a, bc, bc))):
        try:
            call()
        except RuntimeError as e:
            print(f"train: ops.{name} on a CUDA input that requires grad raises: {e}")
        else:
            fail(f"ops.{name} took a CUDA input that requires grad")
    if {name: mod.launches for name, mod in kernels.items()} != counts:
        fail("a refused call launched a kernel")
    print(f"train phase: {time.perf_counter() - t_phase:.1f} s")


# Phase 4: the paper's use cases. The example's dataset, and a larger one
# (8 shards of 10,000 streamlines, 40 points on average, about 39 MB) read
# through the example's store (20 ms a request, 45 MB/s). The paper's
# dataset is 500 GB, which one pass at 45 MB/s would take about 3 h over.
LARGE_TRK = dict(seed=2, shards=8, streamlines=10_000, mean_points=40)
LENGTH_RTOL = 1e-5     # card vs host, fp32 sums in another order
EDGE_RTOL = 1e-4       # a length this near a bin edge may fall either side
LABEL_TOL = 1e-4       # a distance this near 8.0, or the other distance, likewise


def load_example(name: str):
    """A script under examples/torch/ as a module, without running it."""
    import importlib.util

    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def bin_of(np, x, edges):
    """np.histogram's bin of each value (the last bin holds its right edge)."""
    return np.minimum(np.searchsorted(edges, x, side="right") - 1, len(edges) - 2)


def near_an_edge(np, x, edges):
    return np.any(np.abs(x[:, None] - edges[None, :]) <= EDGE_RTOL * np.abs(edges[None, :]),
                  axis=1)


def check_histograms(np, card, host) -> None:
    """The card's lengths within LENGTH_RTOL of the host's, and every row's
    bin the same, except rows near a bin edge of either side."""
    a = card.values.cpu().numpy().astype(np.float64)
    b = host.values.numpy().astype(np.float64)
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    if not err <= LENGTH_RTOL:
        fail(f"histogram: card and host lengths differ by {err:.3e} relative (tol {LENGTH_RTOL})")
    ea, eb = np.histogram_bin_edges(a, bins=len(card.result)), \
        np.histogram_bin_edges(b, bins=len(host.result))
    exempt = near_an_edge(np, a, ea) | near_an_edge(np, b, eb)
    moved = int(np.sum(bin_of(np, a, ea)[~exempt] != bin_of(np, b, eb)[~exempt]))
    diff = int(np.abs(card.result - host.result).sum())
    print(f"use cases, large, histogram, card vs host: lengths max relative diff {err:.3e} "
          f"(tol {LENGTH_RTOL}); {int(exempt.sum())} of {len(a)} rows within {EDGE_RTOL} of a "
          f"bin edge (exempt); {moved} other rows in another bin; counts differ by {diff}")
    if moved or (diff and not exempt.any()):
        fail("histogram: card and host bins differ")


def check_labels(torch, np, sa, card, host) -> None:
    """The card's labels equal the host's, except rows whose best distance
    lies within LABEL_TOL of the threshold or whose two distances lie within
    LABEL_TOL of each other."""
    if not torch.equal(card.values.cpu(), host.values):
        fail("bundle: the resampled points differ between card and host")
    d_cst, d_arc = sa.distances(host.values, *sa.references("cpu"))
    d_cst, d_arc = d_cst.numpy(), d_arc.numpy()
    exempt = (np.abs(np.minimum(d_cst, d_arc) - sa.THRESHOLD) < LABEL_TOL) | \
        (np.abs(d_cst - d_arc) < LABEL_TOL)
    differ = card.result != host.result
    counts = np.bincount(host.result, minlength=3)
    print(f"use cases, large, bundle, card vs host: labels {counts.tolist()} (0/1/2) on the "
          f"host; {int(exempt.sum())} of {len(exempt)} rows within {LABEL_TOL} of the threshold "
          f"or a tie (exempt); {int(differ.sum())} labels differ, {int((differ & ~exempt).sum())} "
          f"of them outside the exempt rows")
    if (differ & ~exempt).any():
        fail("bundle: card and host labels differ")


def device_share(torch, np, sa, objects: dict, card: dict) -> None:
    """The card's share of the large dataset's rolling runs: the same device
    work (host-to-device copies and compute, batch for batch) replayed from
    memory between CUDA events, against each run's seconds."""
    import io

    from repro_torch.data.trk import iter_streamlines_multi

    blob = b"".join(objects[k] for k in sorted(objects))
    points = [sl.points for sl in iter_streamlines_multi(io.BytesIO(blob), len(blob))]
    pts = np.zeros((len(points), sa.MAX_POINTS, 3), np.float32)
    n_pts = np.zeros(len(points), np.int64)
    for i, p in enumerate(points):
        n = min(len(p), sa.MAX_POINTS)
        pts[i, :n], n_pts[i] = p[:n], n
    resampled = sa.resample_batch(points)
    ref_cst, ref_arc = sa.references("cuda")

    def histogram_work():
        for i in range(0, len(pts), sa.BATCH):
            sa.lengths_of(torch.from_numpy(pts[i:i + sa.BATCH]).to("cuda"),
                          torch.from_numpy(n_pts[i:i + sa.BATCH]).to("cuda"))

    def bundle_work():
        sa.classify(torch.from_numpy(resampled).to("cuda"), ref_cst, ref_arc).cpu()

    for usecase, work in (("histogram", histogram_work), ("bundle", bundle_work)):
        work()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        work()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        run_s = card["large", usecase].seconds
        print(f"use cases, large, {usecase}: the card's work (copies and compute) replayed "
              f"alone takes {ms:.3f} ms, {ms / 1e3 / run_s:.3%} of the rolling run's "
              f"{run_s:.3f} s: the card is idle {1 - ms / 1e3 / run_s:.2%} of it")


def phase_usecases(torch, np) -> None:
    """The paper's two use cases (examples/torch/streamline_analysis.py) on
    the card, sequential against rolling, over the example's dataset and a
    larger one; the larger on the host CPU too, held against the card; then
    the training example (examples/torch/train_lm_e2e.py) at its defaults in
    a process of its own."""
    from repro_torch.data.trk import synth_trk

    t_phase = time.perf_counter()
    sa = load_example("streamline_analysis")
    rng = np.random.default_rng(LARGE_TRK["seed"])
    large = {f"large/shard{i}.trk": synth_trk(rng, LARGE_TRK["streamlines"],
                                               mean_points=LARGE_TRK["mean_points"])
             for i in range(LARGE_TRK["shards"])}
    card = {}
    for dname, objects in (("example", sa.example_dataset()), ("large", large)):
        print(f"use cases, {dname}: {len(objects)} shards, "
              f"{sum(map(len, objects.values()))} bytes at {sa.STORE_URI}")
        for usecase, fn in sa.USE_CASES.items():
            fn("rolling", "cuda", objects)   # warm-up
            seq = fn("sequential", "cuda", objects)
            roll = fn("rolling", "cuda", objects)
            for mode, run in (("sequential", seq), ("rolling", roll)):
                if run.values.device.type != "cuda":
                    fail(f"{usecase}: its tensors lie on {run.values.device}, not the card")
                print(f"use cases, {dname}, {usecase}, {mode}: {run.seconds:.3f} s, "
                      f"{run.store_gets} GETs, {run.bytes_fetched} bytes, waiting on the reader "
                      f"{run.read_wait_s:.3f} s ({run.read_wait_s / run.seconds:.1%} of the loop)")
            same = np.array_equal(seq.result, roll.result)
            print(f"use cases, {dname}, {usecase}: speed-up {seq.seconds / roll.seconds:.3f}x; "
                  f"results identical: {same}; values bit-equal: "
                  f"{torch.equal(seq.values, roll.values)}")
            if not same:
                fail(f"{usecase} ({dname}): sequential and rolling results differ")
            card[dname, usecase] = roll

    device_share(torch, np, sa, large, card)

    for usecase, fn in sa.USE_CASES.items():
        host = fn("rolling", "cpu", large)
        print(f"use cases, large, {usecase}, host CPU, rolling: {host.seconds:.3f} s")
        if usecase == "histogram":
            check_histograms(np, card["large", usecase], host)
        else:
            check_labels(torch, np, sa, card["large", usecase], host)

    run_example("train_lm_e2e", "OK: ")
    print(f"use-case phase: {time.perf_counter() - t_phase:.1f} s")


def run_example(name: str, ok: str, args: tuple = ()) -> None:
    """examples/torch/<name>.py with `args` (its defaults) in a process of
    its own: it must exit 0 and print a line that starts with `ok`."""
    run_examples([(name, ok, args)])


def run_examples(runs: list) -> None:
    """`run_example` for each (name, ok, args) of `runs`, the processes
    started together and each waited for in turn."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    procs = [(name, ok, args, subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", "torch", f"{name}.py"), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT))
        for name, ok, args in runs]
    try:
        for name, ok, args, proc in procs:
            stdout, stderr = proc.communicate(timeout=600)
            lines = stdout.strip().splitlines()
            what = " ".join((name, *args))
            for line in lines:
                print(f"{what}: {line}")
            print(f"{what}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s")
            if proc.returncode != 0 or not any(line.startswith(ok) for line in lines):
                print(stderr[-3000:], file=sys.stderr)
                fail(f"examples/torch/{name}.py {' '.join(args)} failed on the card")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def lm_run(torch, cfg, params, ids) -> dict:
    """A decoder-only model's outputs on `params`' device, on the host: the
    last-position logits of `ids`' first half prefilled, the logits of 8
    decode steps over the next 8 tokens, `lm_loss` of `ids` (each token's
    label the next) and every leaf's gradient; the flash launches of the
    forward passes."""
    from repro_torch import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm as LM

    device = tree.flatten(params)[0].device
    ids = ids.to(device)
    half = ids.shape[1] // 2
    before = fa.launches
    out = {}
    with torch.no_grad():
        logits, caches = LM.lm_prefill(params, cfg, ids[:, :half], max_len=half + 8)
        out["prefill logits"] = logits[:, :cfg.vocab_size].float().cpu()
        steps = []
        for t in range(half, half + 8):
            logits, caches = LM.lm_decode_step(params, cfg, ids[:, t:t + 1], caches, t)
            steps.append(logits[:, :cfg.vocab_size].float().cpu())
        out["decode logits"] = torch.stack(steps, dim=1)
        del caches
    out["launches"] = fa.launches - before
    live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
    loss = LM.lm_loss(live, cfg, ids[:, :-1], ids[:, 1:], loss_chunk=64)
    out["loss"] = float(loss.detach())
    out["grads"] = [g.cpu() for g in torch.autograd.grad(loss, tree.flatten(live))]
    return out


def phase_olmo_cross_check(torch, np) -> None:
    """Full-width olmo-1b cut to 2 layers, one set of weights made on the
    card and copied to the host CPU; 2 prompts of 128 tokens: prefill logits
    (the flash kernel on the card, the plain version on the host), 8 decode
    steps, `lm_loss` and every leaf's gradient. Held to CROSS_TOL in fp32
    activations, as whisper's; bf16 printed. Its non-parametric LayerNorm
    runs on the card here first."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2)
    card = make_model(cfg).init(0, device="cuda")
    host = tree.map_leaves(lambda t: t.cpu(), card)
    rng = np.random.default_rng(17)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 129)))
    for dtype in ("bfloat16", "float32"):
        L.COMPUTE_DTYPE = getattr(torch, dtype)
        try:
            got = lm_run(torch, cfg, card, ids)
            want = lm_run(torch, cfg, host, ids)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        held = dtype == "float32"
        errs, ok = {}, True
        for key in ("prefill logits", "decode logits"):
            a, b = got[key], want[key]
            errs[key] = (a - b).abs().max().item()
            ok = ok and bool(torch.isfinite(a).all()) and bool(
                ((a - b).abs() <= CROSS_TOL + CROSS_TOL * b.abs()).all())
        rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        largest = max(g.norm() for g in want["grads"])
        grad_err = max(float((a - b).norm() / torch.maximum(b.norm(), 1e-3 * largest))
                       for a, b in zip(got["grads"], want["grads"]))
        print(f"olmo cross-check {dtype} activations, card vs host cpu (2 layers, 2 x 128 "
              f"tokens): max|diff| prefill logits {errs['prefill logits']:.3e}, 8 decode steps' "
              f"logits {errs['decode logits']:.3e}; loss card {got['loss']!r}, host cpu "
              f"{want['loss']!r}, relative diff {rel_loss:.3e}; worst leaf gradient relative L2 "
              f"{grad_err:.3e}{f' (tol {CROSS_TOL})' if held else ' (printed only)'}; "
              f"{got['launches']} flash launches (want {cfg.num_layers})")
        if got["launches"] != cfg.num_layers:
            fail(f"olmo cross-check: {got['launches']} flash launches, want {cfg.num_layers}")
        if held and not (ok and math.isfinite(got["loss"]) and rel_loss <= CROSS_TOL
                         and grad_err <= CROSS_TOL):
            fail("olmo cross-check: the card disagrees with the host CPU in fp32 activations")
    del card, host


def same_tree(torch, want: list, got: list, what: str) -> None:
    """`got`'s leaves are DTensors whose logical arrays equal `want`'s
    tensors bit for bit (dtype and shape too)."""
    if len(got) != len(want):
        fail(f"{what}: {len(got)} leaves, want {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        full = b.full_tensor()
        if not full.is_cuda or full.dtype != a.dtype or not torch.equal(full, a):
            fail(f"{what}: leaf {i} is {full.dtype} {tuple(full.shape)} on {full.device}, "
                 f"want {a.dtype} {tuple(a.shape)} on the card, bit-exact")


def phase_mesh(torch, np, fa, kernels: dict) -> tuple[int, dict]:
    """The mesh tooling on the card, in a one-rank NCCL group (destroyed at
    the end): full-width olmo-1b placed by TRAIN_RULES on a 1 x 1 CUDA mesh,
    saved through a simulated store, restored by `restore_resharded` onto a
    DECODE_TP_RULES template (placements and bits checked), one wave of 8 x
    512 served from the restored tree (the kernels' counts set to 0 just
    before and read just after: 16 flash launches, no scan), the 2-layer
    card-vs-host check, flash timed at the wave's shape, a post-reshard
    snapshot at step 1 restored again, then examples/torch/elastic_restore.py
    on the card and on 8 CPU ranks. Returns the wave's flash launches and
    the flash timing at its shape."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.ft.elastic import reshard_params, restore_resharded, snapshot_resharded
    from repro_torch.io import IOPolicy, open_store
    from repro_torch.io.stores import clear_store_cache
    from repro_torch.launch.mesh import make_debug_mesh, mesh_host_shard
    from repro_torch.models import make_model
    from repro_torch.models.spec import param_shardings
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.sharding.rules import DECODE_TP_RULES, TRAIN_RULES, ShardingRules

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    log = RestoreLog()
    ckpt_log = logging.getLogger("repro_torch.ckpt")
    ckpt_log.setLevel(logging.INFO)
    ckpt_log.addHandler(log)
    try:
        cfg = get_config("olmo-1b")
        model = make_model(cfg)
        spec = model.spec()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params = model.init(0, device=dev)
        want = tree.flatten(params)
        nbytes = sum(t.numel() * t.element_size() for t in want)
        print(f"{cfg.name}: {model.param_count():,} parameters ({nbytes / 1e9:.3f} GB in fp32), "
              f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_heads} heads of "
              f"{cfg.head_dim}, {len(want)} leaves; host MemAvailable {mem_available_gb():.1f} GB")

        mesh = make_debug_mesh(1, 1)
        rules_a = ShardingRules(mesh, dict(TRAIN_RULES))
        rules_b = ShardingRules(mesh, dict(DECODE_TP_RULES))
        placed = reshard_params(params, spec, rules_a)
        store = open_store(MESH_URI)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(store, "olmo", 0, placed, policy=IOPolicy(write_depth=4))
        save_s = time.perf_counter() - t0
        print(f"mesh save: {save_s:.3f} s, {nbytes / 1e6:.1f} MB in {len(want)} leaves from "
              f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} by TRAIN_RULES to {MESH_URI}")

        template = model.abstract_params(rules_b)
        host_id, num_hosts = mesh_host_shard()
        n0 = len(log.splits)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, _ = restore_resharded(
            store, "olmo", template, host_id=host_id, num_hosts=num_hosts, device=dev,
            policy=IOPolicy(engine="rolling", depth=2, eviction_interval_s=0.2))
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, t_leaves = tree.flatten(restored), tree.flatten(template)
        relaid = sum(a.placements != b.placements
                     for a, b in zip(tree.flatten(placed), got))
        for i, (g, t) in enumerate(zip(got, t_leaves)):
            if g.placements != t.placements or g.device_mesh != mesh:
                fail(f"mesh restore: leaf {i} placed {g.placements}, want {t.placements}")
        same_tree(torch, want, got, "mesh restore")
        if len(log.splits) != n0 + 1:
            fail(f"mesh restore: logged {len(log.splits) - n0} restore records, want 1")
        sp = log.splits[-1]
        print(f"mesh restore (restore_resharded, shard {host_id}/{num_hosts}) onto "
              f"DECODE_TP_RULES: {restore_s:.3f} s; placements equal the template's, "
              f"{relaid} of {len(got)} leaves laid out anew, logical arrays bit-equal; waited "
              f"{sp['reader_s']:.3f} s on the reader and {sp['h2d_wait_s']:.3f} s on "
              f"host-to-device copies (digest {sp['digest_s']:.3f} s, staging "
              f"{sp['stage_s']:.3f} s, restore loop {sp['total_s']:.3f} s)")
        del placed

        # One wave from the restored tree: on a 1 x 1 mesh each shard is
        # the whole leaf.
        local = tree.map_leaves(lambda t: t.to_local(), restored)
        rng = np.random.default_rng(5)
        warm = ServeEngine(model, local, max_batch=8, device=dev)
        warm.submit(Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, 64), max_new_tokens=2))
        warm.run()
        engine = ServeEngine(model, local, max_batch=8, device=dev)
        for i in range(8):
            engine.submit(Request(rid=i, max_new_tokens=33, prompt=rng.integers(
                0, cfg.vocab_size, 512).astype(np.int32)))
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.launches = 0
        results = engine.run()
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in kernels.items()}
        st = engine.stats
        print(f"serve {cfg.name} from the restored tree: {st.requests} requests in {st.waves} "
              f"wave, prefill {st.prefill_s:.4f} s ({st.prefill_tokens} tokens, "
              f"{st.prefill_tokens / st.prefill_s:.1f} tok/s), {st.decode_steps} decode steps, "
              f"decode {(st.generated_tokens - st.requests) / st.decode_s:.1f} tok/s; kernel "
              f"launches {counts} (want flash_attention {cfg.num_layers}, ssd_scan 0); peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB so far")
        if counts != {name: cfg.num_layers if name == "flash_attention" else 0
                      for name in kernels}:
            fail(f"{cfg.name}: kernel launches {counts}, want flash_attention "
                 f"{cfg.num_layers}, every other 0")
        if st.waves != 1 or st.decode_steps != 32 or len(results) != 8:
            fail(f"{cfg.name}: {st.waves} waves, {st.decode_steps} decode steps, "
                 f"{len(results)} results; want 1, 32, 8")
        for r in results:
            if len(r.tokens) != 33 or r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
                fail(f"request {r.rid}: {len(r.tokens)} tokens, ids outside [0, vocab)")
        del warm, engine, local

        phase_olmo_cross_check(torch, np)
        olmo_wave = flash_timing(torch, fa, OLMO_SHAPE, "olmo-1b's 512-token wave, D 128", seed=7)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snapshot_resharded(store, "olmo", 1, restored, param_shardings(spec, rules_b),
                           policy=IOPolicy(write_depth=4))
        snap_s = time.perf_counter() - t0
        if latest_step(store, "olmo") != 1:
            fail(f"mesh snapshot: latest step {latest_step(store, 'olmo')}, want 1")
        del restored
        t0 = time.perf_counter()
        again, manifest = restore_checkpoint(store, "olmo", template, device=dev,
                                             policy=IOPolicy(engine="rolling", depth=2,
                                                             eviction_interval_s=0.2))
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        if manifest["step"] != 1:
            fail(f"mesh snapshot: restored step {manifest['step']}, want 1")
        same_tree(torch, want, tree.flatten(again), "mesh snapshot restore")
        print(f"mesh snapshot (snapshot_resharded) at step 1: {snap_s:.3f} s; latest_step 1; "
              f"its restore {again_s:.3f} s, bit-equal; peak "
              f"{(torch.cuda.max_memory_allocated() - base) / 1e9:.2f} GB above the "
              f"{base / 1e9:.2f} GB held before the phase")
        del again, params, want
    finally:
        ckpt_log.removeHandler(log)
        dist.destroy_process_group()
    clear_store_cache()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh phase (before the examples): {time.perf_counter() - t_phase:.1f} s")
    return counts["flash_attention"], olmo_wave


def start_dryruns() -> dict:
    """`python -m repro_torch.launch.dryrun` for each of olmo-1b's
    DRYRUN_CELLS on the 16 x 16 mesh, each in a process of its own (the
    card is not used): {cell: (start time, process)}."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    return {cell: (time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "olmo-1b", "--shape", cell,
         "--out", os.path.join(ROOT, "build", "dryrun")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)) for cell in DRYRUN_CELLS}


def first_launch(mod, name: str):
    """Wrap `mod.<name>` so that its first call's inputs (copies: a cache
    passed in is written after the call) and output are kept; returns
    (records, restore)."""
    real = getattr(mod, name)
    seen: list = []

    def copy(x):
        return x.clone() if hasattr(x, "clone") else x

    def wrapper(*args, **kw):
        if seen:
            return real(*args, **kw)
        kept = ([copy(a) for a in args], {k: copy(v) for k, v in kw.items()})
        out = real(*args, **kw)
        seen.append((*kept, out))
        return out

    setattr(mod, name, wrapper)
    return seen, lambda: setattr(mod, name, real)


def split_on_batch(rules, t):
    """`t` (the same global value on every rank) split on ``batch`` under
    `rules`; itself with no rules."""
    if rules is None:
        return t
    from torch.distributed.tensor import distribute_tensor

    sh = rules.sharding(("batch",) + (None,) * (t.ndim - 1), tuple(t.shape))
    return distribute_tensor(t, sh.mesh, sh.placements, src_data_rank=None)


def logical(t):
    """A `DTensor`'s logical value (a collective), a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def dtensor_run(torch, cfg, model, params, rules, ids, labels):
    """`Model.loss` of (ids, labels), every leaf's gradient, then a prefill
    of `ids` and 8 decode steps over the next tokens; under `rules` (a
    mesh) the parameters are placed by them and the inputs split on
    ``batch``, else plain. Returns logical tensors."""
    from repro_torch import tree
    from repro_torch.ft.elastic import reshard_params
    from repro_torch.models import lm as LM
    from repro_torch.sharding.rules import use_rules

    def full(t):
        return logical(t).detach().float().cpu()

    if rules is not None:
        params = reshard_params(params, model.spec(), rules)
    out = {}
    with use_rules(rules):
        if labels is not None:
            live = tree.map_leaves(lambda t: t.detach().requires_grad_(True), params)
            loss = model.loss(live, dict(inputs=split_on_batch(rules, ids),
                                         labels=split_on_batch(rules, labels)))
            out["loss"] = float(full(loss))
            out["grads"] = [full(g) for g in torch.autograd.grad(loss, tree.flatten(live))]
            del live, loss
        else:
            with torch.no_grad():
                s = ids.shape[1] - 8
                logits, caches = LM.lm_prefill(params, cfg, split_on_batch(rules, ids[:, :s]),
                                               max_len=s + 8)
                out["prefill"] = full(logits)
                steps = []
                for t in range(s, s + 8):
                    logits, caches = model.decode_step(
                        params, split_on_batch(rules, ids[:, t:t + 1]), caches, t)
                    steps.append(full(logits))
                out["decode"] = torch.stack(steps, dim=1)
                del caches
    return out


def worst_leaf_rel(torch, got: list, want: list) -> float:
    """The largest relative L2 error over the leaves, each against its own
    norm or a thousandth of the largest leaf's, whichever is larger."""
    largest = max(float(b.norm()) for b in want)
    return max(float((a.float() - b.float()).norm() / max(float(b.norm()), 1e-3 * largest))
               for a, b in zip(got, want))


def train_step_run(torch, model, params, rules, ids, labels, microbatches: int) -> dict:
    """One `train.build_train_step` step (remat on, AdamW's defaults) from
    fresh moments: under `rules` the parameters and moments laid out by
    them and the batch split on ``batch`` (the `DTensor` path), else plain.
    Returns the metrics as floats and, leaf by leaf, the update p_new -
    p_old and the new moments as logical tensors on the card."""
    from repro_torch import tree
    from repro_torch.ft.elastic import reshard_params
    from repro_torch.sharding.rules import use_rules
    from repro_torch.train import AdamWConfig, StepConfig, TrainState, build_train_step, init_state

    if rules is not None:
        params = reshard_params(params, model.spec(), rules)
    state = TrainState(params, init_state(params))
    step = build_train_step(model, AdamWConfig(), StepConfig(microbatches=microbatches))
    with use_rules(rules):
        new, metrics = step(state, {"inputs": split_on_batch(rules, ids),
                                    "labels": split_on_batch(rules, labels)})
    out = {k: float(logical(v)) for k, v in metrics.items()}
    out["update"] = [logical(a) - logical(b) for a, b in zip(tree.flatten(new.params),
                                                             tree.flatten(params))]
    out["m"] = [logical(t) for t in tree.flatten(new.opt.m)]
    out["v"] = [logical(t) for t in tree.flatten(new.opt.v)]
    return out


def phase_sharded_train_step(torch, cfg, model, params, mesh, rng, dev, kernels: dict) -> dict:
    """Phase 6a: full-width olmo-1b's train step through the `DTensor` path
    (TRAIN_RULES on the one-rank mesh) against the plain path from the same
    weights and fresh state, fp32 activations (the caller sets them): one
    microbatch of 2 x 512 tokens, then 2 microbatches of 2 x 512 (a
    `DTensor` microbatch of one row cannot be flattened: `DTensor` reads
    the merge of a split dim of size 1 as its removal). Loss, grad_norm and
    lr relative; every moment and every update p_new - p_old (at warmup lr
    is 3e-6, so the parameters themselves would hide an error) as each
    leaf's relative L2 error. Neither kernel may launch (training takes
    the plain paths); returns the launch counts over both steps."""
    from repro_torch.sharding.rules import TRAIN_RULES, ShardingRules

    rules = ShardingRules(mesh, dict(TRAIN_RULES))
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.launches = 0
    for micro in (1, 2):
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2 * micro, 513))).to(dev)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        want = train_step_run(torch, model, params, None, ids[:, :-1], ids[:, 1:], micro)
        got = train_step_run(torch, model, params, rules, ids[:, :-1], ids[:, 1:], micro)
        torch.cuda.synchronize()
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("loss", "grad_norm", "lr")}
        leaves = {k: worst_leaf_rel(torch, got[k], want[k]) for k in ("update", "m", "v")}
        print(f"sharded olmo-1b train step, fp32, TRAIN_RULES, {micro} microbatch(es) of "
              f"{ids.shape[0] // micro} x {ids.shape[1] - 1} tokens: loss DTensor {got['loss']!r}, "
              f"plain {want['loss']!r}; grad_norm {got['grad_norm']!r} / {want['grad_norm']!r}; lr "
              f"{got['lr']!r} / {want['lr']!r}; relative diffs "
              f"{', '.join(f'{k} {v:.3e}' for k, v in rel.items())}; "
              f"worst leaf relative L2 of {len(got['update'])} leaves: "
              f"{', '.join(f'{k} {v:.3e}' for k, v in leaves.items())} (tol {SHARDED_TOL}); peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"{time.perf_counter() - t0:.1f} s")
        if not all(v <= SHARDED_TOL for v in (*rel.values(), *leaves.values())):
            fail(f"sharded train step ({micro} microbatches): the DTensor path disagrees with "
                 f"the plain path")
        del got, want
        gc.collect()
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    counts = {name: mod.launches for name, mod in kernels.items()}
    if any(counts.values()):
        fail(f"sharded train step: kernel launches {counts}, want none")
    return counts


def phase_sharded_mamba_grads(torch, kernels: dict, mcfg, mmodel, mparams, mesh, ids) -> dict:
    """Phase 6b: mamba2-1.3b (full width, 2 blocks) `Model.loss` and every
    gradient, fp32 activations (the caller sets them), through the
    `DTensor` path under TRAIN_RULES against the plain path: the training
    scan (`ssd_chunked`, differentiable) must run on local shards through
    `local_map` only, and neither kernel may launch."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models import ssd as S
    from repro_torch.sharding.rules import TRAIN_RULES, ShardingRules

    t0 = time.perf_counter()
    real = S.ssd_chunked
    calls = {"local": 0, "DTensor": 0}

    def spy(x, *args, **kw):
        calls["DTensor" if isinstance(x, DTensor) else "local"] += 1
        return real(x, *args, **kw)

    S.ssd_chunked = spy
    try:
        torch.cuda.synchronize()
        for mod in kernels.values():
            mod.launches = 0
        got = dtensor_run(torch, mcfg, mmodel, mparams, ShardingRules(mesh, dict(TRAIN_RULES)),
                          ids[:, :-1], ids[:, 1:])
        torch.cuda.synchronize()
        counts = {name: mod.launches for name, mod in kernels.items()}
    finally:
        S.ssd_chunked = real
    want = dtensor_run(torch, mcfg, mmodel, mparams, None, ids[:, :-1], ids[:, 1:])
    rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    grad_err = worst_leaf_rel(torch, got["grads"], want["grads"])
    print(f"sharded mamba2-1.3b (2 blocks, d {mcfg.d_model}) loss, fp32, TRAIN_RULES (2 x 512 "
          f"tokens, {len(got['grads'])} leaves): loss DTensor {got['loss']!r}, plain "
          f"{want['loss']!r}, relative diff {rel_loss:.3e}; gradients worst leaf relative L2 "
          f"{grad_err:.3e} (tol {SHARDED_TOL}); training scan calls {calls} (want only local "
          f"shards, through local_map); kernel launches {counts} (want 0); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (rel_loss <= SHARDED_TOL and grad_err <= SHARDED_TOL):
        fail("sharded mamba loss: the DTensor path disagrees with the plain path")
    if calls["DTensor"] or calls["local"] < 2 * mcfg.num_layers or any(counts.values()):
        fail("sharded mamba loss: the training scan did not go through local_map alone")
    return counts


def close_to(torch, a, b, tol: float) -> tuple[float, bool]:
    err = (a - b).abs()
    return err.max().item(), bool(torch.isfinite(a).all()) and bool(
        (err <= tol + tol * b.abs()).all())


def phase_sharded(torch, np, fa, ssd, kernels: dict, dry: dict | None = None) -> dict:
    """The sharded forward on the card (phase 6): see the module docstring.
    `dry` holds the dry-run's processes if they were started already
    (`start_dryruns`), else they start here. Returns the flash and scan
    launches of its DTensor prefills and train steps, by name."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch import tree
    from repro_torch.ckpt import CheckpointManager, restore_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.ft.elastic import reshard_params, reshard_tree
    from repro_torch.io.stores import clear_store_cache
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import make_model
    from repro_torch.models.spec import param_shardings
    from repro_torch.sharding.rules import DECODE_RULES, TRAIN_RULES, ShardingRules, use_rules
    from repro_torch.store.local import MemStore
    from repro_torch.train import abstract_train_state, init_train_state

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun")
    dry = dry or start_dryruns()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)
    launches = {}
    try:
        mesh = make_debug_mesh(1, 1)
        cfg = get_config("olmo-1b")
        model = make_model(cfg)
        params = model.init(0, device=dev)
        rng = np.random.default_rng(23)
        ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 513))).to(dev)
        L.COMPUTE_DTYPE = torch.float32
        try:
            t0 = time.perf_counter()
            got = dtensor_run(torch, cfg, model, params,
                                   ShardingRules(mesh, dict(TRAIN_RULES)), ids[:, :-1], ids[:, 1:])
            want = dtensor_run(torch, cfg, model, params, None, ids[:, :-1], ids[:, 1:])
            rel_loss = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            grad_err = worst_leaf_rel(torch, got["grads"], want["grads"])
            grad_max = max(float((a - b).abs().max()) for a, b in zip(got["grads"], want["grads"]))
            print(f"sharded olmo-1b loss, fp32, TRAIN_RULES on mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} (2 x 512 tokens, "
                  f"{len(got['grads'])} leaves): loss DTensor {got['loss']!r}, plain "
                  f"{want['loss']!r}, relative diff {rel_loss:.3e}; gradients max|diff| "
                  f"{grad_max:.3e}, worst leaf relative L2 {grad_err:.3e} (tol {SHARDED_TOL}); "
                  f"{time.perf_counter() - t0:.1f} s")
            if not (rel_loss <= SHARDED_TOL and grad_err <= SHARDED_TOL):
                fail("sharded loss: the DTensor path disagrees with the plain path")
            del got, want

            t0 = time.perf_counter()
            wave = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 520))).to(dev)
            decode_rules = ShardingRules(mesh, dict(DECODE_RULES))
            got = dtensor_run(torch, cfg, model, params, decode_rules, wave, None)
            want = dtensor_run(torch, cfg, model, params, None, wave, None)
            errs = {k: close_to(torch, got[k], want[k], SHARDED_TOL) for k in ("prefill", "decode")}
            print(f"sharded olmo-1b serving, fp32, DECODE_RULES (8 x 512 prefill, 8 decode "
                  f"steps): max|diff| prefill logits {errs['prefill'][0]:.3e}, decode logits "
                  f"{errs['decode'][0]:.3e} (tol {SHARDED_TOL}); "
                  f"{time.perf_counter() - t0:.1f} s")
            if not all(ok for _, ok in errs.values()):
                fail("sharded serving: the DTensor path disagrees with the plain path")
            del got, want
            launches["olmo-1b-dtensor-train-step"] = phase_sharded_train_step(
                torch, cfg, model, params, mesh, rng, dev, kernels)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16

        # bf16: the wave's prefill through the DTensor path; every layer's
        # attention through flash on the local shard.
        seen, restore = first_launch(fa, "flash_attention_cuda")
        try:
            placed = reshard_params(params, model.spec(), decode_rules)
            prompt = distribute_tensor(wave[:, :512], mesh, decode_rules.sharding(
                ("batch", None), (8, 512)).placements, src_data_rank=None)
            torch.cuda.synchronize()
            for mod in kernels.values():
                mod.launches = 0
            with use_rules(decode_rules), torch.no_grad():
                logits, _ = LM.lm_prefill(placed, cfg, prompt)
            torch.cuda.synchronize()
            counts = {name: mod.launches for name, mod in kernels.items()}
        finally:
            restore()
        (q, k, v), kw, o = seen[0]
        ref = fa.flash_attention_plain(q, k, v, **kw)
        err = (o.float() - ref.float()).abs()
        rel = (err.norm() / ref.float().norm()).item()
        tol = TOL["bfloat16"]
        ok = bool((err <= tol + tol * ref.float().abs()).all()) and rel <= REL_TOL["bfloat16"]
        print(f"sharded olmo-1b prefill, bf16, DECODE_RULES: kernel launches {counts} through "
              f"local_map (want flash_attention {cfg.num_layers}, ssd_scan 0); the first at "
              f"{tuple(q.shape)} {q.dtype} vs its plain version max|diff| "
              f"{err.max().item():.3e} (tol {tol}), relative {rel:.3e} (tol "
              f"{REL_TOL['bfloat16']}); logits {type(logits).__name__} finite "
              f"{bool(torch.isfinite(logits.full_tensor()).all())}")
        if counts != {"flash_attention": cfg.num_layers, "ssd_scan": 0} or not ok:
            fail("sharded prefill: flash launches or its output are wrong")
        launches["olmo-1b-dtensor-local_map"] = counts
        del placed, params, logits, seen, q, k, v, o, ref

        # mamba2-1.3b at full width, 2 blocks: the scan through local_map.
        mcfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2)
        mmodel = make_model(mcfg)
        mparams = mmodel.init(0, device=dev)
        mprompt = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (4, 512))).to(dev)
        seen, restore = first_launch(ssd, "ssd_scan_cuda")
        try:
            mplaced = reshard_params(mparams, mmodel.spec(), decode_rules)
            torch.cuda.synchronize()
            for mod in kernels.values():
                mod.launches = 0
            with use_rules(decode_rules), torch.no_grad():
                mlogits, _ = LM.lm_prefill(mplaced, mcfg, distribute_tensor(
                    mprompt, mesh, decode_rules.sharding(("batch", None), (4, 512)).placements,
                    src_data_rank=None))
            torch.cuda.synchronize()
            mcounts = {name: mod.launches for name, mod in kernels.items()}
        finally:
            restore()
        with torch.no_grad():
            plain_logits, _ = LM.lm_prefill(mparams, mcfg, mprompt)
        args, kw, (y, h) = seen[0]
        ry, rh = ssd.ssd_scan_plain(*args, **kw)
        ey, oky = ssd_close(torch, y, ry, TOL["bfloat16"])
        eh, okh = ssd_close(torch, h, rh, TOL["bfloat16"])
        lerr = (mlogits.full_tensor().float() - plain_logits.float()).abs().max().item()
        print(f"sharded mamba2-1.3b (2 blocks, d {mcfg.d_model}) prefill, bf16, DECODE_RULES: "
              f"kernel launches {mcounts} through local_map (want ssd_scan {mcfg.num_layers}, "
              f"flash_attention 0); the first scan at {tuple(args[0].shape)} vs its plain "
              f"version max|diff| y {ey:.3e}, state {eh:.3e} (tol {TOL['bfloat16']}); logits "
              f"DTensor vs plain path max|diff| {lerr:.3e} (both through the kernel)")
        if mcounts != {"flash_attention": 0, "ssd_scan": mcfg.num_layers} or not (oky and okh):
            fail("sharded mamba prefill: scan launches or its output are wrong")
        launches["mamba2-1.3b-2-blocks-dtensor-local_map"] = mcounts
        del mplaced, mlogits, plain_logits, seen, args, y, h, ry, rh
        L.COMPUTE_DTYPE = torch.float32
        try:
            ids = torch.from_numpy(rng.integers(0, mcfg.vocab_size, (2, 513))).to(dev)
            launches["mamba2-1.3b-2-blocks-dtensor-train"] = phase_sharded_mamba_grads(
                torch, kernels, mcfg, mmodel, mparams, mesh, ids)
        finally:
            L.COMPUTE_DTYPE = torch.bfloat16
        del mparams

        # CheckpointManager.maybe_save of a DTensor TrainState.
        small = make_model(get_config("olmo-1b").reduced())
        rules = ShardingRules(mesh, dict(TRAIN_RULES))
        state = init_train_state(small, 0, device=dev)
        shard = param_shardings(small.spec(), rules)
        state = type(state)(params=reshard_tree(state.params, shard),
                            opt=type(state.opt)(step=state.opt.step,
                                                m=reshard_tree(state.opt.m, shard),
                                                v=reshard_tree(state.opt.v, shard)))
        store = MemStore()
        mgr = CheckpointManager(store, "sharded", interval_steps=1)
        t0 = time.perf_counter()
        mgr.maybe_save(1, state, force=True)
        mgr.wait()
        save_s = time.perf_counter() - t0
        template = abstract_train_state(small, rules)
        t0 = time.perf_counter()
        back, manifest = restore_checkpoint(store, "sharded", template, device=dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want_leaves, got_leaves = tree.flatten(state), tree.flatten(back)
        same = sum(
            (b.placements == a.placements if isinstance(a, DTensor) else True) and torch.equal(
                (b.full_tensor() if isinstance(b, DTensor) else b).cpu(),
                (a.full_tensor() if isinstance(a, DTensor) else a).cpu())
            for a, b in zip(want_leaves, got_leaves))
        print(f"sharded TrainState (reduced olmo-1b, {len(want_leaves)} leaves, "
              f"{sum(isinstance(t, DTensor) for t in want_leaves)} DTensors): "
              f"CheckpointManager.maybe_save + wait {save_s:.3f} s, restore onto the mesh "
              f"{restore_s:.3f} s; {same} of {len(want_leaves)} leaves bit-equal with their "
              f"placements; manifest step {manifest['step']}")
        if same != len(want_leaves) or manifest["step"] != 1:
            fail("sharded TrainState: the restore is not the saved state")
        del state, back
    finally:
        dist.destroy_process_group()
    clear_store_cache()
    gc.collect()
    torch.cuda.empty_cache()

    for cell, (t0, proc) in dry.items():
        stdout, stderr = proc.communicate(timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            print(stderr[-3000:], file=sys.stderr)
            fail(f"dry-run olmo-1b {cell} exited {proc.returncode}")
        with open(os.path.join(out_dir, f"olmo-1b__{cell}__pod16x16.json")) as f:
            rec = json.load(f)
        line = stdout.strip().splitlines()[-1]
        print(f"dry-run olmo-1b {cell} (process of its own, done {secs:.1f} s after it "
              f"started; traced in {rec['lower_s']} s): {line.strip()}; "
              f"{rec['flops_per_chip']:.4e} FLOP, {rec['bytes_per_chip']:.4e} B, "
              f"{rec['coll_bytes_per_chip']:.4e} collective B a chip; H100 terms derived from "
              f"published peaks")
    print(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA GPU")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} GPUs visible; this smoke run drives one "
             f"(set CUDA_VISIBLE_DEVICES to one card)")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import make_model

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip())
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # One nvcc per source, all started together.
    kernels = {"flash_attention": fa, "ssd_scan": ssd}

    def timed_build(mod) -> float:
        t = time.perf_counter()
        mod._library()
        return time.perf_counter() - t

    t_start = time.perf_counter()
    with phase_clock("build"):
        with ThreadPoolExecutor(len(kernels)) as pool:
            builds = {name: pool.submit(timed_build, mod) for name, mod in kernels.items()}
            built = {name: f.result() for name, f in builds.items()}
    print(f"build: {', '.join(f'{n} in {t:.1f}s' for n, t in built.items())}; "
          f"{PHASE_SECONDS['build']:.1f}s in all")
    for name in kernels:
        for line in ptxas_summary(os.path.join(ROOT, "build", f"{name}.ptxas.txt")):
            print(f"ptxas {name}: {line}")
    for dt in ("bfloat16", "float32"):
        for d in (64, 128):
            blocks, smem = fa.occupancy(getattr(torch, dt), d)
            print(f"occupancy flash {dt} D {d}: {smem} bytes of shared memory, {blocks} CTAs "
                  f"per SM")
        blocks, smem = ssd.occupancy(getattr(torch, dt), 64, 128, 256)
        print(f"occupancy ssd {dt} P 64, N 128, Q 256: {smem} bytes of shared memory, "
              f"{blocks} CTAs per SM")

    with phase_clock("kernels"):
        flash = phase_kernels(torch, fa)
        flash["training"] = phase_train_kernels(torch, fa)
        scan = phase_ssd_kernel(torch, ssd)

    with phase_clock("serve smollm-135m, restore"):
        cfg = get_config("smollm-135m")
        model = make_model(cfg)
        params = model.init(0, device="cuda")
        flash["launches"], tokens = phase_serve(torch, np, cfg, model, params, kernels,
                                                "flash_attention")
        phase_prefill_vs_decode(torch, np, fa, cfg, model, params)
        phase_restore(torch, np, cfg, model, params, kernels, tokens)
        del params

    with phase_clock("serve mamba2-1.3b"):
        cfg = get_config("mamba2-1.3b")
        model = make_model(cfg)
        params = model.init(0, device="cuda")
        print(f"{cfg.name}: {model.param_count() / 1e9:.3f} B parameters, "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        scan["launches"], _ = phase_serve(torch, np, cfg, model, params, kernels, "ssd_scan")
        phase_fp32_prefill_vs_decode(torch, np, ssd, cfg, model, params)
        del params

    with phase_clock("moe"):
        granite, jamba = phase_moe(torch, np, kernels)
    with phase_clock("whisper"):
        whisper = phase_whisper(torch, np, kernels)
    with phase_clock("codeqwen int8"):
        codeqwen = phase_codeqwen(torch, np, kernels)
    # phase_serve fails unless granite's serve run launched no scan, and
    # phase_whisper and phase_codeqwen unless whisper's and codeqwen's did not.
    flash["launches_by_config"] = {"smollm-135m": flash["launches"],
                                   "granite-moe-3b-a800m": granite,
                                   "jamba-1.5-large-398b-reduced": jamba["flash_attention"],
                                   "whisper-large-v3": whisper,
                                   "codeqwen1.5-7b-int8": codeqwen}
    scan["launches_by_config"] = {"mamba2-1.3b": scan["launches"], "granite-moe-3b-a800m": 0,
                                  "jamba-1.5-large-398b-reduced": jamba["ssd_scan"],
                                  "whisper-large-v3": 0, "codeqwen1.5-7b-int8": 0}

    with phase_clock("train"):
        phase_train(torch, np, kernels)
    with phase_clock("use cases"):
        phase_usecases(torch, np)
    with phase_clock("mesh"):
        olmo, flash["olmo_wave"] = phase_mesh(torch, np, fa, kernels)
    flash["launches_by_config"]["olmo-1b"] = olmo
    scan["launches_by_config"]["olmo-1b"] = 0    # phase_mesh fails unless it was 0
    # The dry-run's processes trace on the host while the mesh phase's
    # examples run (they print no time that the tracing would disturb).
    dry = start_dryruns()
    with phase_clock("mesh examples"):
        run_examples([("elastic_restore", "OK", ("--device", "cuda")),
                      ("elastic_restore", "OK", ("--device", "cpu"))])
    print(f"mesh phase examples: {PHASE_SECONDS['mesh examples']:.1f} s")
    with phase_clock("sharded"):
        sharded = phase_sharded(torch, np, fa, ssd, kernels, dry)
    for name, counts in sharded.items():
        flash["launches_by_config"][name] = counts["flash_attention"]
        scan["launches_by_config"][name] = counts["ssd_scan"]
    PHASE_SECONDS["all"] = time.perf_counter() - t_start

    rows = [flash, scan]
    for row in rows:
        for key, val in row.items():
            if isinstance(val, float) and not math.isfinite(val):
                fail(f"{row['name']}: kernel number {key} is not finite")
    for name, secs in PHASE_SECONDS.items():
        print(f"phase {name}: {secs:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
