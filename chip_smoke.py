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
     paths' shapes and the bf16 tensor-core paths' shapes, and timed at
     both serving waves beside the plain version, its bound and, where one
     exists, a PyTorch library call, as eager calls and as device time
     over a CUDA graph;
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
     shards are uniform random tokens), and neither kernel may launch. A
     second run resumes from the step-20 checkpoint and must repeat the
     first run's losses from step 21 on; the same state is restored and
     saved again, timed; the loss of the driver's first batch, trained on
     repeatedly, must fall; two steps of the same parameters and batches
     (fp32 activations, batch 2 x 128) on the card and on the host CPU must
     agree; a profiled window shows where a step's time goes; and the
     kernels' entries must refuse a CUDA input that requires grad.
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
  5. a JSON line of the kernels' numbers, then the result line.

Needs a CUDA device and the repository's src/ beside this file.
"""

from __future__ import annotations

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
    # ... and the bf16 tensor-core kernel's paths: head dims 16, 32 and
    # 128, causal Sq != Sk, ragged non-causal.
    (1, 4, 2, 256, 256, 16, True, "bfloat16"),
    (1, 4, 2, 256, 256, 32, True, "bfloat16"),
    (2, 4, 2, 200, 200, 128, True, "bfloat16"),
    (1, 2, 2, 128, 256, 64, True, "bfloat16"),
    (1, 4, 2, 77, 130, 32, False, "bfloat16"),
]
SLICE_SHAPE = (8, 9, 3, 512, 512, 64, True, "bfloat16")
WAVE2_SHAPE = (4, 9, 3, 128, 128, 64, True, "bfloat16")
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
TOL = {"float32": 2e-3, "bfloat16": 2e-2}     # rtol = atol, tests/test_kernels.py
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
                if k := re.search(r"\d+([a-z_]+(?:bf16|f32)_kernel)I(\w*?)EEv", name):
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


def sdpa_call(torch, q, k, v):
    """The library yardstick: one `scaled_dot_product_attention` call on k/v
    expanded to the q heads."""
    group = q.shape[1] // k.shape[1]
    ke = k.repeat_interleave(group, dim=1)
    ve = v.repeat_interleave(group, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, ke, ve, is_causal=True)


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
        ok = bool((err <= tol + tol * ref.float().abs()).all())
        print(f"flash {case}: max|diff| {err.max().item():.3e} (tol {tol}) "
              f"{'ok' if ok else 'FAIL'}")
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
    q, k, v = flash_inputs(torch, WAVE2_SHAPE, seed=2)
    nbytes2, flops2 = flash_work(q, k, causal)
    bound2, _ = bound(nbytes2, flops2, q.dtype)
    sdpa = sdpa_call(torch, q, k, v)
    ms_wave2 = cuda_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    sdpa_wave2 = cuda_ms(torch, sdpa)
    print(f"flash at {WAVE2_SHAPE} (the 128-token wave): kernel {ms_wave2:.4f} ms, sdpa "
          f"{sdpa_wave2:.4f} ms, bound {bound2:.4f} ms; {bound2 / ms_wave2:.1%} of its bound, "
          f"{ms_wave2 / sdpa_wave2:.2f}x sdpa's time")
    dev_ms = graph_ms(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    dev_sdpa = graph_ms(torch, sdpa)
    print(f"flash at {WAVE2_SHAPE}, device time (CUDA graph): kernel {dev_ms:.4f} ms, sdpa "
          f"{dev_sdpa:.4f} ms; {bound2 / dev_ms:.1%} of its bound, {dev_ms / dev_sdpa:.2f}x "
          f"sdpa's time")
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
    }


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


def phase_mamba_prefill_vs_decode(torch, np, kernel, cfg, model, params) -> None:
    """The Mamba model's check, which shows that decode continues from the
    scan kernel's final state. In bf16, the serving dtype, the two paths
    round differently at every layer, and over 48 layers of random weights
    that spread exceeds the whole-stack tolerance whatever computes the
    scan, so the bf16 numbers are printed only. With the activations in
    fp32 (`layers.COMPUTE_DTYPE`) the paths differ only in the scan's
    arithmetic, and they are held to the fp32 kernel tolerance."""
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
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernelEx",
                                                           "cudaLaunchKernelExC"))
    kernels = sorted((e for e in events if e.device_type.name == "CUDA"),
                     key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 2
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
    CPU, and show that the kernels' entries refuse inputs that need grad.
    The kernels' counts are set to 0 before the first run and must read 0
    after the last: training takes the plain paths."""
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
    for mod in kernels.values():
        mod.launches = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    a = train.main(TRAIN_ARGS + ["--ckpt-store", uri_a])
    peak = torch.cuda.max_memory_allocated() - base
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
    print(f"train: kernel launches while training {counts} (want every one 0)")
    if any(counts.values()):
        fail(f"training launched a forward-only kernel: {counts}")

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
    if any(mod.launches for mod in kernels.values()):
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

    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    res = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "torch",
                                                       "train_lm_e2e.py")],
                         capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    for line in res.stdout.strip().splitlines():
        print(f"train_lm_e2e: {line}")
    print(f"train_lm_e2e: exit {res.returncode} in {time.perf_counter() - t0:.1f} s")
    if res.returncode != 0 or "\nOK: " not in "\n" + res.stdout:
        print(res.stderr[-3000:], file=sys.stderr)
        fail("examples/torch/train_lm_e2e.py failed on the card")
    print(f"use-case phase: {time.perf_counter() - t_phase:.1f} s")


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

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        builds = {name: pool.submit(timed_build, mod) for name, mod in kernels.items()}
        built = {name: f.result() for name, f in builds.items()}
    print(f"build: {', '.join(f'{n} in {t:.1f}s' for n, t in built.items())}; "
          f"{time.perf_counter() - t0:.1f}s in all")
    for name in kernels:
        for line in ptxas_summary(os.path.join(ROOT, "build", f"{name}.ptxas.txt")):
            print(f"ptxas {name}: {line}")
    for dt in ("bfloat16", "float32"):
        blocks, smem = fa.occupancy(getattr(torch, dt), 64)
        print(f"occupancy flash {dt} D 64: {smem} bytes of shared memory, {blocks} CTAs per SM")
        blocks, smem = ssd.occupancy(getattr(torch, dt), 64, 128, 256)
        print(f"occupancy ssd {dt} P 64, N 128, Q 256: {smem} bytes of shared memory, "
              f"{blocks} CTAs per SM")

    flash = phase_kernels(torch, fa)
    scan = phase_ssd_kernel(torch, ssd)

    cfg = get_config("smollm-135m")
    model = make_model(cfg)
    params = model.init(0, device="cuda")
    flash["launches"], tokens = phase_serve(torch, np, cfg, model, params, kernels,
                                            "flash_attention")
    phase_prefill_vs_decode(torch, np, fa, cfg, model, params)
    phase_restore(torch, np, cfg, model, params, kernels, tokens)
    del params

    cfg = get_config("mamba2-1.3b")
    model = make_model(cfg)
    params = model.init(0, device="cuda")
    print(f"{cfg.name}: {model.param_count() / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    scan["launches"], _ = phase_serve(torch, np, cfg, model, params, kernels, "ssd_scan")
    phase_mamba_prefill_vs_decode(torch, np, ssd, cfg, model, params)
    del params

    phase_train(torch, np, kernels)
    phase_usecases(torch, np)

    rows = [flash, scan]
    for row in rows:
        for key, val in row.items():
            if isinstance(val, float) and not math.isfinite(val):
                fail(f"{row['name']}: kernel number {key} is not finite")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
