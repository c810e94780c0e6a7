"""Training driver: the program's train step, fed by its rolling-prefetch
loader from token shards in a simulated object store.

Set-up draws fp32 weights and the shards from the seed, puts the shards in
a `SimS3Store` behind the traffic's link, builds one train state and one
feed (`PrefetchingDataLoader` under `DeviceFeeder`), and drives the first
steps through them: those steps warm every shape, and the reference
follows each of them after the window. The window runs steps of that same state
and feed while fewer than ``--seconds`` have passed since it began.

Compared after the window: every batch the loader delivered against the
rows the benchmark wrote; each checked step's loss; each leaf's norm of the
first step's gradient, as the optimizer got it (its first moment after one
step, unclipped by the step's reported norm); each leaf's norm of the
parameters' change over the checked steps.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from gpubench import harness
from gpubench import traffic as T
from gpubench.reference import lm as ref
from gpubench.reference.train import adamw_steps, leaves, paths
from gpubench.weights import make_params


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """The system under test: one train state, one step, one feed."""

    def __init__(self, ctx: harness.Context) -> None:
        from repro_torch.data import LoaderConfig, PrefetchingDataLoader
        from repro_torch.data.loader import DeviceFeeder
        from repro_torch.data.tokens import write_token_shard
        from repro_torch.io import IOPolicy
        from repro_torch.models import make_model
        from repro_torch.store import LinkModel, MemTier, SimS3Store
        from repro_torch.train import AdamWConfig, StepConfig, TrainState, build_train_step
        from repro_torch.train.optimizer import init_state

        c, t = ctx.cell.config, ctx.cell.traffic
        self.ctx, self.c, self.t = ctx, c, t
        self.device = torch.device(ctx.device)
        self.cfg = harness.port_config(c)
        model = make_model(self.cfg)
        self.params0 = make_params(model.spec(), ctx.seed, dtype=torch.float32,
                                   device=self.device)
        self.shards = T.token_shards(ctx.seed, t["shards"], t["tokens_per_shard"],
                                     c["vocab_size"], t["shard_dtype"])
        link = t["link"]
        self.store = SimS3Store(link=LinkModel(latency_s=link["latency_ms"] / 1e3,
                                               bandwidth_Bps=link["bandwidth_mbps"] * 1e6))
        for i, shard in enumerate(self.shards):
            self.store.backing.put(f"data/tok{i:04d}.bin", write_token_shard(shard))
        ld = t["loader"]
        self.loader = PrefetchingDataLoader(
            self.store, self.store.list_objects("data/"), [MemTier(ld["tier_bytes"])],
            LoaderConfig(seq_len=t["seq_len"], batch_size=t["batch"],
                         policy=IOPolicy(engine=ld["engine"], blocksize=ld["blocksize"],
                                         depth=ld["prefetch_depth"],
                                         eviction_interval_s=ld["eviction_interval_s"],
                                         autotune=ld["autotune"])))
        self.feeder = DeviceFeeder(self.loader.batches(), depth=ld["feeder_depth"],
                                   device=self.device)
        self.batches = iter(self.feeder)
        self.opt = AdamWConfig(**t["optimizer"])
        self.step = build_train_step(model, self.opt, StepConfig(**t["step"]))
        self.state = TrainState(self.params0, init_state(self.params0, self.opt))
        self.delivered: list = []    # each step's (inputs, labels) on the device
        self.metrics: list = []

    def one_step(self) -> None:
        inputs, labels = next(self.batches)
        self.delivered.append((inputs, labels))
        self.state, m = self.step(self.state, {"inputs": inputs, "labels": labels})
        self.metrics.append(m)

    def first_steps(self) -> dict:
        """The set-up steps, each one compared; the program's side of the
        comparison."""
        out: dict = {}
        for k in range(self.t["checked_steps"]):
            self.one_step()
            if k == 0:
                # The optimizer's first moment after one step is (1 - b1) x
                # the clipped gradient; the clip's scale from the reported norm.
                gnorm = self.metrics[0]["grad_norm"]
                scale = torch.clamp(self.opt.grad_clip_norm / (gnorm + 1e-9), max=1.0)
                out["grad"] = torch.stack([m.float().norm() for m in leaves(self.state.opt.m)]) \
                    / ((1 - self.opt.b1) * scale)
        out["change"] = torch.stack([(p.float() - p0.float()).norm() for p, p0 in
                                     zip(leaves(self.state.params), leaves(self.params0))])
        out["loss"] = torch.stack([m["loss"] for m in self.metrics])
        self.params0 = None
        sync(self.device)
        return {k: v.double().cpu() for k, v in out.items()}

    def close(self) -> None:
        self.feeder.close()
        self.loader.close()
        self.state = self.step = None


def measure(prog: Program, run: harness.Run, seconds: float, tracer: harness.Tracer) -> None:
    """With tracing on, first the profiled steps; then steps of the same
    state and feed for `seconds`."""
    marks: list = []

    def mark():
        if prog.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    def step(span, waits=None):
        with span("feeder.wait"):
            w0 = time.perf_counter()
            inputs, labels = next(prog.batches)
            if waits is not None:
                waits.append(time.perf_counter() - w0)
        if waits is not None:
            mark()
        with span("train.step"):
            prog.delivered.append((inputs, labels))
            prog.state, m = prog.step(prog.state, {"inputs": inputs, "labels": labels})
            prog.metrics.append(m)
        return tuple(inputs.shape)

    if tracer.on:
        tracer.start()
        run.traced = [step(tracer.span) for _ in range(tracer.limit)]
        run.trace = tracer.stop(len(run.traced))
    first = len(prog.metrics)
    sync(prog.device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step(harness.no_span, run.feeder_wait_s)
    mark()
    sync(prog.device)
    run.span_s = time.perf_counter() - t0
    if prog.device.type == "cuda":
        run.step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        run.step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    window = prog.metrics[first:]
    run.steps = run.attempted = len(window)
    run.tokens = sum(int(x.numel()) for x, _ in prog.delivered[first:])
    losses = torch.stack([m["loss"] for m in window]).double().cpu() if window else []
    run.failed = int(sum(not np.isfinite(v) for v in np.asarray(losses)))


def tokens_wrong(prog: Program) -> int:
    """Rows the loader delivered that differ from what the benchmark wrote."""
    stream = np.concatenate(prog.shards)
    wrong = 0
    t = prog.t
    for step, (inputs, labels) in enumerate(prog.delivered):
        want_in, want_lab = T.batch_of(stream, step, t["batch"], t["seq_len"])
        got_in, got_lab = inputs.cpu().numpy(), labels.cpu().numpy()
        wrong += int(np.sum(np.any((got_in != want_in) | (got_lab != want_lab), axis=1)))
    return wrong


def reference_side(ctx: harness.Context, pr: ref.Precision = ref.FP32) -> dict:
    """The reference's losses, first gradient and change over the checked
    steps, from the seed's weights made again and the rows the benchmark
    wrote."""
    c, t = ctx.cell.config, ctx.cell.traffic
    device = torch.device(ctx.device)
    from repro_torch.models import make_model   # the spec's shapes only

    spec = make_model(harness.port_config(c)).spec()
    params0 = make_params(spec, ctx.seed, dtype=torch.float32, device=device)
    stream = np.concatenate(T.token_shards(ctx.seed, t["shards"], t["tokens_per_shard"],
                                           c["vocab_size"], t["shard_dtype"]))
    batches = []
    for k in range(t["checked_steps"]):
        x, y = T.batch_of(stream, k, t["batch"], t["seq_len"])
        batches.append((torch.from_numpy(x).long().to(device),
                        torch.from_numpy(y).long().to(device)))
    out = adamw_steps(params0, c, batches, t["optimizer"], pr, chunk=t["step"]["loss_chunk"])
    out["paths"] = paths(spec)
    return out


def compare(prog_side: dict, ref_side: dict) -> dict:
    """The numbers compared. ``loss_gap``: the worse checked step's loss
    gap (``loss_gap_first``: the first step's). ``grad_gap`` and
    ``update_gap``: the worst leaf's gap of gradient norms and of change
    norms, each against the larger of the reference's norm of that leaf and
    of the median leaf (``..._median``: the median leaf's gap). Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = (prog_side["loss"] - ref_side["loss"]).abs()

    def gaps(p, r, keep=None):
        gap = (p - r).abs() / torch.maximum(r, r.median())
        return gap if keep is None else gap[keep]

    g = ref_side["grad"]
    keep = g >= 1e-3 * g.median()
    grad = gaps(prog_side["grad"], g)
    update = gaps(prog_side["change"], ref_side["change"], keep)
    return {"loss_gap": float(loss.max()), "loss_gap_first": float(loss[0]),
            "grad_gap": float(grad.max()), "grad_gap_median": float(grad.median()),
            "update_gap": float(update.max()), "update_gap_median": float(update.median()),
            "leaves_left_out": int((~keep).sum()),
            "grad_gap_leaf": ref_side["paths"][int(grad.argmax())]}


def checks(nums: dict, wrong: int, limits: dict) -> dict:
    """What decides `correct`: the rows delivered wrong (none allowed) and
    each number that the cell's `limits` name, name -> (value, limit)."""
    out = {"tokens_wrong": (float(wrong), 0.0)}
    out.update((name, (nums[name], limit)) for name, limit in limits.items())
    return out


def run(ctx: harness.Context) -> harness.Run:
    t, c = ctx.cell.traffic, ctx.cell.config
    marks = [("imports", time.perf_counter())]
    prog = Program(ctx)
    marks.append(("weights, shards and feed", time.perf_counter()))
    prog_side = prog.first_steps()
    marks.append(("set-up steps", time.perf_counter()))
    run = harness.Run(driver="train", config=c, traffic=t)
    run.setup_s = time.perf_counter() - ctx.t_start
    harness.print_setup(ctx, marks)
    measure(prog, run, ctx.seconds, harness.Tracer(ctx.trace, t["trace_units"], ctx.device))
    if prog.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(prog.device)
    wrong = tokens_wrong(prog)
    prog.close()
    del prog
    if ctx.device.startswith("cuda"):
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    nums = compare(prog_side, reference_side(ctx))
    print(f"reference: {t['checked_steps']} steps in {time.perf_counter() - t_ref:.2f} s; "
          f"{nums['leaves_left_out']} leaves left out of the change", file=sys.stderr)
    run.checks = checks(nums, wrong, ctx.cell.workload["limits"])
    print("readings: " + ", ".join(f"{k} {v!r}" for k, v in nums.items()), file=sys.stderr)
    print(f"window: {run.steps} steps, median device step "
          f"{statistics.median(run.step_ms) if run.step_ms else 0.0:.2f} ms", file=sys.stderr)
    return run
