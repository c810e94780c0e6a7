"""The benchmark's frame: one process runs one cell once.

`main` reads the cell by name (``workloads/<cell>.json``), its configuration
(``configs/<config>.json``) and its traffic (``traffic/<traffic>.json``),
runs the traffic's driver (``drivers/<driver>.py``), reads the metrics that
``BENCHMARK.json`` asks of the cell through one reader file each
(``metrics/<metric>.py``), and prints one JSON line. A new configuration,
traffic mix, cell or metric is a new file found by its name; nothing here
names one.

A driver's `run(ctx)` returns a `Run`: the set-up seconds, the measured
window, what was attempted and failed, the comparison with the reference
(`checks`: name -> (value, limit)), the peak device memory and, with
``--trace 1``, a `TraceSummary` of the profiler's timeline.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import re
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

# A configuration file's keys and the program's `ModelConfig` fields they
# must equal (after the file's `port_overrides`).
PORT_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "expand": "ssm_expand",
    "state_size": "ssm_state",
    "n_groups": "ssm_ngroups",
    "chunk_size": "ssm_chunk",
    "conv_kernel": "ssm_conv_kernel",
}


class BenchError(RuntimeError):
    """A run that cannot give a result: it prints none and exits non-zero."""


# --------------------------------------------------------------------------- #
# Finding things by name
# --------------------------------------------------------------------------- #
def _name_ok(name: str) -> str:
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}", name):
        raise BenchError(f"not a name: {name!r}")
    return name


def data_file(kind: str, name: str, root: Path = HERE) -> dict:
    path = root / kind / f"{_name_ok(name)}.json"
    if not path.is_file():
        raise BenchError(f"no {kind} file {path}")
    return json.loads(path.read_text())


def code_file(kind: str, name: str, root: Path = HERE):
    """The module ``<root>/<kind>/<name>.py``, loaded from its path."""
    path = root / kind / f"{_name_ok(name)}.py"
    if not path.is_file():
        raise BenchError(f"no {kind} file {path}")
    mod_name = f"gpubench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict


def load_cell(name: str, root: Path = HERE) -> Cell:
    wl = data_file("workloads", name, root)
    return Cell(name=name, workload=wl, config=data_file("configs", wl["config"], root),
                traffic=data_file("traffic", wl["traffic"], root))


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics of `bench` (BENCHMARK.json) that the cell reports: with
    `trace` the per-layer ones, else the end-to-end ones. A metric with a
    ``workloads`` key belongs to the cells it lists; a per-layer one without
    it to every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def port_config(config: dict):
    """The program's `ModelConfig` of `config`'s ``arch``, with its
    ``port_overrides``; refuses one whose widths differ from the file's."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(config["arch"]), **config.get("port_overrides", {}))
    head_dim = cfg.ssm_head_dim if config["block"] == "mamba2" else cfg.head_dim
    pairs = [(k, getattr(cfg, f)) for k, f in PORT_KEYS.items() if k in config]
    pairs.append(("head_dim", head_dim))
    for key, value in pairs:
        if not math.isclose(float(config[key]), float(value), rel_tol=0, abs_tol=0):
            raise BenchError(f"{config['name']}: the program's {key} is {value}, the "
                             f"configuration states {config[key]}")
    return cfg


# --------------------------------------------------------------------------- #
# What a run gives
# --------------------------------------------------------------------------- #
@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    units: int                                   # steps traced
    launches: int = 0                            # kernels (not copies) run
    kernels: dict = field(default_factory=dict)  # device op name -> [count, seconds]
    gaps: dict = field(default_factory=dict)     # what the host did -> idle seconds

    def kernel(self, fragment: str) -> tuple[int, float]:
        """Calls and device seconds of the kernels whose name holds `fragment`."""
        hits = [v for k, v in self.kernels.items() if fragment in k]
        return sum(c for c, _ in hits), sum(s for _, s in hits)


@dataclass
class Run:
    driver: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    span_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    checks: dict = field(default_factory=dict)   # name -> (value, limit)
    memory_peak_bytes: int = 0
    steps: int = 0                                # steps in the window
    tokens: int = 0                               # tokens of those steps
    step_ms: list = field(default_factory=list)   # device ms a step
    feeder_wait_s: list = field(default_factory=list)
    traced: list = field(default_factory=list)    # the traced units' shapes
    trace: TraceSummary | None = None

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values()) and bool(self.checks)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float


# --------------------------------------------------------------------------- #
# The profiler's timeline
# --------------------------------------------------------------------------- #
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW_SPAN = "gpubench.traced"


def _merged(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events: list, points: list) -> list:
    """For each of the sorted `points`, the name of the innermost of the
    nested `events` ((start, end, name), one thread) that holds it, or
    None."""
    events = sorted(events, key=lambda e: (e[0], -e[1]))
    stack: list = []
    out, i = [], 0
    for t in points:
        while i < len(events) and events[i][0] <= t:
            while stack and stack[-1][1] < events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def summarize_trace(trace: dict, units: int) -> TraceSummary:
    """Device busy time (the union of kernel, copy and memset intervals), the
    kernels by name, and the idle gaps by what the host's main thread was
    doing, inside the ``gpubench.traced`` span of a Chrome trace."""
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW_SPAN]
    if not spans:
        raise BenchError("the trace has no window span")
    w = spans[0]
    t0, t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    tid = w.get("tid")
    dev, host, notes = [], [], []
    kernels: dict = {}
    launches = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            dev.append((a, b))
            launches += cat == "kernel"
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += (b - a) * 1e-6
        elif e.get("tid") == tid and cat in _HOST_CATS and e["name"] != WINDOW_SPAN:
            host.append((a, b, e["name"]))
        elif e.get("tid") == tid and cat == "user_annotation" and e["name"] != WINDOW_SPAN:
            notes.append((a, b, e["name"]))
    busy = _merged(dev)
    gaps, edge = [], t0
    for a, b in busy:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if t1 > edge:
        gaps.append((edge, t1))
    mids = [(a + b) / 2 for a, b in gaps]
    doing = _innermost(host, mids)
    span = _innermost(notes, mids)
    by_what: dict = {}
    for (a, b), op, note in zip(gaps, doing, span):
        label = f"{note or 'outside spans'} / {op or 'python'}"
        by_what[label] = by_what.get(label, 0.0) + (b - a) * 1e-6
    return TraceSummary(window_s=(t1 - t0) * 1e-6,
                        busy_s=sum(b - a for a, b in busy) * 1e-6,
                        units=units, launches=launches, kernels=kernels, gaps=by_what)


@contextlib.contextmanager
def no_span(name: str):
    """A host span that records nothing (an untraced window)."""
    yield


class Tracer:
    """The profiler (host and CUDA activity) over the `units` steps that a
    traced run runs before its window, inside a ``gpubench.traced``
    span; the window after it runs untraced, so that the host-clock
    metrics of a traced run are those of an untraced one. Off, it does
    nothing."""

    def __init__(self, on: bool, units: int, device: str) -> None:
        self.on, self.limit, self.device = on, units, device
        self._prof = self._span = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self, units: int) -> TraceSummary:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                summary = summarize_trace(json.load(f), units)
        finally:
            os.unlink(path)
        self._prof = self._span = None
        return summary

    def span(self, name: str):
        """A host span in the trace."""
        from torch.profiler import record_function

        return record_function(name)


# --------------------------------------------------------------------------- #
# The result line
# --------------------------------------------------------------------------- #
def print_setup(ctx: Context, marks: list) -> None:
    """Where set-up went: each mark's seconds since the one before (the
    first since process start), on standard error."""
    prev, parts = ctx.t_start, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.3f} s")
        prev = t
    print("setup: " + ", ".join(parts), file=sys.stderr)


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(run: Run, device: str, chips: int) -> dict:
    import torch

    if device.startswith("cuda"):
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    info = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def power_limit_w() -> str:
    """The card's power limit as `nvidia-smi` reports it, or "unknown"."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def read_metrics(run: Run, chosen: list[dict], root: Path = HERE) -> dict:
    out = {}
    for m in chosen:
        reader = code_file("metrics", m["name"], root)
        value = reader.read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise BenchError(f"metric {m['name']} read {value}")
        out[m["name"]] = {"value": value, "unit": reader.UNIT}
    return out


def breakdown(trace: TraceSummary) -> dict:
    ops = sorted(trace.kernels.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
    gaps = sorted(trace.gaps.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"device_ops": [[k[:160], v[1]] for k, v in ops],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}


def result_line(run: Run, metrics: dict, device: dict) -> dict:
    line = {"correct": run.correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device}
    if run.trace is not None:
        line["breakdown"] = breakdown(run.trace)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return line


def execute(ctx: Context, bench: dict, root: Path = HERE) -> dict:
    """Run the cell and return its result line (no chip look: the caller
    has made it)."""
    cell = ctx.cell
    driver = code_file("drivers", cell.traffic["driver"], root)
    run = driver.run(ctx)
    found = loaded_forbidden()
    if found:
        raise BenchError(f"modules loaded in this process: {', '.join(found)}")
    chosen = metrics_for(bench, cell.name, ctx.trace)
    metrics = read_metrics(run, chosen, root)
    line = result_line(run, metrics, device_info(run, ctx.device, cell.workload["chips"]))
    if ctx.device.startswith("cuda"):
        print(f"power limit: {power_limit_w()}", file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    return line


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        bench_path = HERE.parent / "BENCHMARK.json"
        if not bench_path.is_file():
            raise BenchError(f"no {bench_path}")
        bench = json.loads(bench_path.read_text())
        cell = load_cell(args.workload)
        import torch

        chips = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise BenchError(f"the cell needs {chips} CUDA device(s); "
                             f"{torch.cuda.device_count()} visible")
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=t_start)
        line = execute(ctx, bench)
    except (BenchError, ImportError) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(line))
    sys.stdout.flush()
    return 0
