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
  4. / 4b. for each model, last-position logits of one prompt prefilled
     through the kernel against the same prompt half prefilled, half
     decoded token by token through the plain decode path over the cache
     (for mamba2-1.3b held in fp32 activations, printed in bf16);
  5. a JSON line of the kernels' numbers, then the result line.

Needs a CUDA device and the repository's src/ beside this file.
"""

from __future__ import annotations

import json
import math
import os
import re
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


def phase_serve(torch, np, cfg, model, params, kernels: dict, path: str) -> int:
    """Serve the fixed traffic through `ServeEngine`. Every kernel's count is
    set to 0 just before the run and read just after: the kernel named
    `path` must have launched once per layer per wave, the others never.
    Returns `path`'s launches."""
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

    engine = Engine(model, params, max_batch=8, device="cuda")
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
    return counts[path]


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
    flash["launches"] = phase_serve(torch, np, cfg, model, params, kernels, "flash_attention")
    phase_prefill_vs_decode(torch, np, fa, cfg, model, params)
    del params

    cfg = get_config("mamba2-1.3b")
    model = make_model(cfg)
    params = model.init(0, device="cuda")
    print(f"{cfg.name}: {model.param_count() / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    scan["launches"] = phase_serve(torch, np, cfg, model, params, kernels, "ssd_scan")
    phase_mamba_prefill_vs_decode(torch, np, ssd, cfg, model, params)

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
