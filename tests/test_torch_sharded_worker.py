"""The sharded forward on 8 gloo ranks, for tests/test_torch_sharded_forward.py.

  PYTHONPATH=src python tests/test_torch_sharded_worker.py OUT.json [--ops] [ARCH ...]

Spawns one world of 8 CPU processes (gloo, rendezvous through a file). On a
(4, 2) ("data", "model") mesh every rank runs each config's reduced model
in fp32 activations, its parameters laid out by each rules table
(TRAIN_RULES, DECODE_RULES, DECODE_TP_RULES) and its inputs split on
``batch``: the loss and every leaf's gradient, a prefill and two decode
steps. Each rank also runs the same calls with no mesh on the same
weights and inputs. Rank 0 writes, per config and table, the largest
difference of each result from the unsharded one, as max |a - b| and as
max |a - b| / (1 + |b|); the test holds them to its limit; and how often
the sharded loss and gradients ran the training scan (`ssd_chunked`) on
local shards and on `DTensor`s. With ``--ops``
the ranks also call the kernels' entries (`kernels.ops`) on `DTensor`s
laid out whole (replicated; batch on ``data`` and heads on ``model``) and
split on a sequence dim, and record each result's largest difference from
the plain version on the logical inputs, or the error raised; and split a
batch split on ``data`` into microbatches (`train_step._split_batch`), and
run one train step of a reduced MoE config on the mesh and without it
(`train_step_checks`). The module
holds no test of its own: pytest imports it and collects nothing.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree as T
from repro_torch.configs import all_configs, get_config
from repro_torch.ft.elastic import reshard_params
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.sharding.rules import (
    DECODE_RULES,
    DECODE_TP_RULES,
    TRAIN_RULES,
    ShardingRules,
    use_rules,
)

RANKS = 8
MESH = (4, 2)
TABLES = {"TRAIN_RULES": TRAIN_RULES, "DECODE_RULES": DECODE_RULES,
          "DECODE_TP_RULES": DECODE_TP_RULES}
BATCH, SEQ, DEC_PROMPT, STEPS = 8, 32, 8, 2
JOIN_TIMEOUT_S = 600


def inputs(cfg) -> dict:
    """The same numpy-seeded inputs on every rank: a training batch, a
    prompt and the decode steps' tokens (embeddings for a VLM)."""
    rng = np.random.default_rng(0)

    def ids(*shape):
        return torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))

    def emb(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))

    out = {"labels": ids(BATCH, SEQ)}
    if cfg.is_encdec:
        out.update(enc=emb(BATCH, SEQ, cfg.d_model), dec=ids(BATCH, SEQ),
                   prompt=ids(BATCH, DEC_PROMPT), steps=ids(BATCH, STEPS))
    elif cfg.embed_inputs:
        out.update(inputs=emb(BATCH, SEQ, cfg.d_model), prompt=emb(BATCH, SEQ, cfg.d_model),
                   steps=emb(BATCH, STEPS, cfg.d_model))
    else:
        out.update(inputs=ids(BATCH, SEQ), prompt=ids(BATCH, SEQ), steps=ids(BATCH, STEPS))
    return out


def forward(model, params, data: dict, rules: ShardingRules | None) -> dict:
    """Loss, gradients, prefill and decode logits, as logical tensors; and
    the training scan's calls during the loss and gradients, by whether
    its input was a local shard or a `DTensor`."""
    from repro_torch.models import ssd as S

    cfg = model.cfg

    def place(t):
        if rules is None:
            return t
        sharding = rules.sharding(("batch",) + (None,) * (t.ndim - 1), tuple(t.shape))
        return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)

    def full(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    d = {k: place(v) for k, v in data.items()}
    out = {}
    with use_rules(rules):
        live = T.map_leaves(lambda t: t.detach().requires_grad_(True), params)
        batch = (dict(enc_inputs=d["enc"], dec_ids=d["dec"], labels=d["labels"])
                 if cfg.is_encdec else dict(inputs=d["inputs"], labels=d["labels"]))
        calls = {"local": 0, "DTensor": 0}
        real = S.ssd_chunked

        def counted(x, *args, **kw):
            calls["DTensor" if isinstance(x, DTensor) else "local"] += 1
            return real(x, *args, **kw)

        S.ssd_chunked = counted
        try:
            loss = model.loss(live, batch)
            out["loss"] = full(loss)
            leaves = T.flatten(live)
            # A VLM's inputs are embeddings: its table gets no gradient (zero).
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            S.ssd_chunked = real
        out["scan_calls"] = calls
        out["grads"] = [torch.zeros(t.shape) if g is None else full(g)
                        for t, g in zip(leaves, grads)]
        with torch.no_grad():
            if cfg.is_encdec:
                logits, caches = ED.encdec_prefill(params, cfg, d["enc"], d["prompt"],
                                                   max_len=DEC_PROMPT + STEPS)
                start = DEC_PROMPT
            else:
                logits, caches = LM.lm_prefill(params, cfg, d["prompt"], max_len=SEQ + STEPS)
                start = SEQ
            out["prefill"] = full(logits)
            steps = []
            for t in range(STEPS):
                logits, caches = model.decode_step(params, d["steps"][:, t:t + 1], caches,
                                                   start + t)
                steps.append(full(logits))
            out["decode"] = torch.stack(steps, dim=1)
    return out


def diff(a: torch.Tensor, b: torch.Tensor) -> list[float]:
    d = (a.double() - b.double()).abs()
    return [float(d.max()), float((d / (1 + b.double().abs())).max())]


def ops_checks(mesh) -> dict:
    """`ops.flash_attention` and `ops.ssd_scan` on DTensors: whole layouts
    go through `local_map` to the plain version on each rank's shard and
    must equal the plain version on the logical inputs; a layout split on
    a sequence dim raises. `ops.flash_attention_train` under autograd on
    heads split across ranks, with k/v split alike or, of one kv head,
    replicated: its output and q/k/v gradients against the plain tensors'."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd

    gen = torch.Generator().manual_seed(0)
    q = torch.randn(8, 4, 64, 16, generator=gen)
    k = torch.randn(8, 2, 64, 16, generator=gen)
    v = torch.randn(8, 2, 64, 16, generator=gen)
    x = torch.randn(8, 64, 4, 16, generator=gen)
    dt_a = -torch.rand(8, 64, 4, generator=gen)
    b = torch.randn(8, 64, 1, 16, generator=gen)
    c = torch.randn(8, 64, 1, 16, generator=gen)
    init = torch.randn(8, 4, 16, 16, generator=gen)
    dout = torch.randn(8, 4, 64, 16, generator=gen)
    want_fa = fa.flash_attention_plain(q, k, v, causal=True)
    want_y, want_h = ssd.ssd_scan_plain(x, dt_a, b, c, chunk=32, initial_state=init)

    def place(t, placements):
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    out = {}
    layouts = {"replicated": ([Replicate(), Replicate()], [Replicate(), Replicate()]),
               "batch_heads": ([Shard(0), Shard(1)], [Shard(0), Shard(2)])}
    for name, (attn, scan) in layouts.items():
        got = ops.flash_attention(place(q, attn), place(k, attn), place(v, attn), causal=True)
        out[f"flash_{name}"] = [float((got.full_tensor() - want_fa).abs().max()),
                                [str(p) for p in got.placements]]
        init_pl = [p if not isinstance(p, Shard) or p.dim == 0 else Shard(1) for p in scan]
        y, h = ops.ssd_scan(place(x, scan), place(dt_a, scan), place(b, scan[:1] + [Replicate()]),
                            place(c, scan[:1] + [Replicate()]), chunk=32,
                            initial_state=place(init, init_pl))
        out[f"ssd_{name}"] = [max(float((y.full_tensor() - want_y).abs().max()),
                                  float((h.full_tensor() - want_h).abs().max())),
                              [str(p) for p in y.placements]]
    train_layouts = {"batch_heads": ([Shard(0), Shard(1)], k, v),
                     "kv_replicated": ([Shard(0), Replicate()], k[:, :1], v[:, :1])}
    for name, (kv_pl, kk, vv) in train_layouts.items():
        plain = [t.clone().requires_grad_() for t in (q, kk, vv)]
        want = ops.flash_attention_train(*plain, causal=True)
        want.backward(dout)
        live = [place(t, pl).requires_grad_()
                for t, pl in ((q, [Shard(0), Shard(1)]), (kk, kv_pl), (vv, kv_pl))]
        got = ops.flash_attention_train(*live, causal=True)
        got.backward(place(dout, list(got.placements)))
        errs = [diff(got.full_tensor().detach(), want.detach())[1]]
        errs += [diff(t.grad.full_tensor(), w.grad)[1] for t, w in zip(live, plain)]
        out[f"train_{name}"] = {"rel": max(errs),
                                "placements": [str(p) for p in got.placements],
                                "grads": [isinstance(t.grad, DTensor) for t in live]}
    from repro_torch.train.train_step import _split_batch

    rows = torch.arange(16 * 3).reshape(16, 3)
    dt_rows = place(rows, [Shard(0), Replicate()])
    micro = _split_batch({"x": dt_rows}, 2)
    local = 16 // mesh.size(0)
    want = [torch.cat([rows[r * local + i * local // 2:r * local + (i + 1) * local // 2]
                       for r in range(mesh.size(0))]) for i in range(2)]
    out["split_batch"] = {
        "placements": [[str(p) for p in m["x"].placements] for m in micro],
        "shapes": [list(m["x"].shape) for m in micro],
        "equal": [bool(torch.equal(m["x"].full_tensor(), w)) for m, w in zip(micro, want)],
    }
    for name, call in (
            ("flash_seq", lambda: ops.flash_attention(
                place(q, [Shard(0), Replicate()]), place(k, [Shard(0), Shard(2)]),
                place(v, [Shard(0), Shard(2)]))),
            ("ssd_seq", lambda: ops.ssd_scan(
                place(x, [Shard(0), Shard(1)]), place(dt_a, [Shard(0), Shard(1)]),
                place(b, [Shard(0), Shard(1)]), place(c, [Shard(0), Shard(1)]), chunk=32))):
        try:
            call()
            out[name] = "no error"
        except ValueError as e:
            out[name] = f"ValueError: {e}"
    return out


def train_step_checks(mesh) -> dict:
    """One `build_train_step` step of reduced granite-moe-3b-a800m (an MoE
    config: its expert weights' gradients come out of the backward pass
    as partial sums over the batch's axis) laid out by TRAIN_RULES, in fp32
    activations, against the same step with no mesh: the largest
    difference of the loss, the gradient norm, every moment and every
    update (p_new - p), and how many gradients were laid out anew as
    their parameters (`train_step._laid_out_as`)."""
    from repro_torch.train import AdamWConfig, TrainState, build_train_step, init_state
    from repro_torch.train import train_step as TS

    model = make_model(get_config("granite-moe-3b-a800m").reduced())
    params = model.init(0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (BATCH, SEQ + 1)))
    relaid = []
    real = TS._laid_out_as

    def counted(g, p):
        out = real(g, p)
        relaid.append(out is not g)
        return out

    def step(rules):
        p = params if rules is None else reshard_params(params, model.spec(), rules)
        batch = {"inputs": ids[:, :-1], "labels": ids[:, 1:]}
        if rules is not None:
            batch = {k: distribute_tensor(v, mesh, rules.sharding(
                ("batch", None), tuple(v.shape)).placements, src_data_rank=None)
                for k, v in batch.items()}
        with use_rules(rules):
            new, metrics = build_train_step(model, AdamWConfig())(TrainState(p, init_state(p)),
                                                                  batch)

        def full(t):
            return t.full_tensor() if isinstance(t, DTensor) else t

        return ([full(v) for v in metrics.values()]
                + [full(a) - full(b) for a, b in zip(T.flatten(new.params), T.flatten(p))]
                + [full(t) for t in T.flatten(new.opt)])

    TS._laid_out_as = counted
    try:
        got = step(ShardingRules(mesh, dict(TRAIN_RULES)))
    finally:
        TS._laid_out_as = real
    want = step(None)
    return {"diff": max((diff(a, b) for a, b in zip(got, want)), key=lambda x: x[1]),
            "n": len(got), "relaid": sum(relaid)}


def run(names: list[str], with_ops: bool) -> dict:
    L.COMPUTE_DTYPE = torch.float32
    mesh = make_mesh_compat(MESH, ("data", "model"), device_type="cpu")
    results = {}
    for name in names:
        t0 = time.perf_counter()
        cfg = get_config(name).reduced()
        model = make_model(cfg)
        params = model.init(0, device="cpu")
        data = inputs(cfg)
        want = forward(model, params, data, None)
        results[name] = {}
        done = {}
        for table_name, table in TABLES.items():
            # DECODE_RULES equals TRAIN_RULES entry for entry: one run serves both.
            key = json.dumps(table, sort_keys=True)
            if key in done:
                results[name][table_name] = results[name][done[key]]
                continue
            done[key] = table_name
            rules = ShardingRules(mesh, dict(table))
            got = forward(model, reshard_params(params, model.spec(), rules), data, rules)
            results[name][table_name] = {
                "loss": diff(got["loss"], want["loss"]),
                "grads": max((diff(a, b) for a, b in zip(got["grads"], want["grads"])),
                             key=lambda x: x[1]),
                "prefill": diff(got["prefill"], want["prefill"]),
                "decode": diff(got["decode"], want["decode"]),
                "n_grads": len(got["grads"]),
                "scan_calls": got["scan_calls"],
            }
        results[name]["seconds"] = time.perf_counter() - t0
    if with_ops:
        results["ops"] = ops_checks(mesh)
        results["train_step"] = train_step_checks(mesh)
    return results


def rank_main(rank: int, workdir: str, names: list[str], out: str, with_ops: bool) -> None:
    torch.set_num_threads(1)    # one core a rank, not every core each
    dist.init_process_group("gloo", init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=RANKS)
    try:
        results = run(names, with_ops)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    finally:
        dist.destroy_process_group()


def main(argv: list[str]) -> int:
    out, rest = argv[0], argv[1:]
    with_ops = "--ops" in rest
    names = [a for a in rest if a != "--ops"] or sorted(all_configs())
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=rank_main, args=(r, workdir, names, out, with_ops))
                 for r in range(RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"FAIL: rank exit codes {codes}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
