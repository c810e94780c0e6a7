"""Multi-pod dry-run on the port: trace every (arch x input-shape) cell on
the production meshes and extract roofline terms; the port of the JAX
package's ``launch/dryrun.py``.

It needs no card and allocates nothing, as the reference (which forces 512
host CPU devices) compiles without a TPU. The 16 x 16 and 2 x 16 x 16
meshes are ``fake`` process groups of 256 and 512 ranks in this one
process (``torch.distributed``'s fake backend, a `HashStore` rendezvous):
this process is rank 0, every tensor a ``meta`` stand-in, laid out by the
rules as a `DTensor`. A cell's function (the whole train step, or the
model's prefill or decode step, under `use_rules`) is traced by `make_fx`
around a wrapper that takes rank 0's local shards, wraps them with
`DTensor.from_local` and returns its outputs' `to_local()`: the graph is
one rank's work, with `DTensor`'s communication as functional
collectives, which `roofline.graph_parse` reads as the reference reads
the optimized HLO. ``lower_s`` is that trace's time; nothing is compiled
(``compile_s`` 0).

A train cell is `train.build_train_step`'s step (loss, backward with each
period recomputed, AdamW) on `abstract_train_state` and the batch's
specs: the backward and the recompute of `torch.utils.checkpoint` are in
the traced graph. The reference donates the state to its step, so the
record's ``alias_bytes`` is the rank's share of the state's bytes.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \
      [--microbatches 2] [--moments-dtype bfloat16]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--meshes pod16x16]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch.configs import SHAPES, all_configs, get_config, shapes_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.models import layers as L
from repro_torch.models.api import make_model
from repro_torch.roofline.analysis import analyze_graph
from repro_torch.sharding.rules import DECODE_RULES, TRAIN_RULES, ShardingRules, use_rules
from repro_torch.train import AdamWConfig, StepConfig, abstract_train_state, build_train_step


def start_fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``fake`` process group of `world_size`
    ranks (collectives move no data). The fake backend is registered here
    when no one has: `torch.testing` registers it on import, which
    library code does not use."""
    from torch._C._distributed_c10d import FakeProcessGroup

    if "FAKE" not in getattr(dist.Backend, "_plugins", {}):
        def create(common_opts, backend_opts):
            if hasattr(FakeProcessGroup, "_create_internal"):
                return FakeProcessGroup._create_internal(
                    common_opts.group_rank, common_opts.group_size, backend_opts)
            return FakeProcessGroup(common_opts.group_rank, common_opts.group_size)

        dist.Backend.register_backend("fake", create, extended_api=True,
                                      devices=["cpu", "cuda"])
    dist.init_process_group("fake", store=dist.HashStore(), rank=0, world_size=world_size)


def _mesh_and_rules(shape_kind: str, multi_pod: bool):
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    table = DECODE_RULES if shape_kind == "decode" else TRAIN_RULES
    return mesh, ShardingRules(mesh, dict(table))


def _leaves(tree, out: list) -> list:
    """The tensors of `tree` (dicts, lists, tuples and NamedTuples such as
    the `TrainState`, dataclasses such as the caches and `QTensor`), in a
    fixed order."""
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _leaves(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _leaves(getattr(tree, f.name), out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def _rebuild(tree, leaves):
    """`tree` with its tensors taken in `_leaves` order from `leaves`."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_rebuild(v, leaves) for v in tree]
        return type(tree)(*children) if hasattr(tree, "_fields") else type(tree)(children)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _rebuild(getattr(tree, f.name), leaves)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tree


def trace_per_rank(fn, args: tuple, rules: ShardingRules):
    """One rank's graph of ``fn(*args)`` under `rules`: `make_fx` (fake
    tensors) over a wrapper that takes the local shards of `args`' tensors,
    wraps the sharded ones with `DTensor.from_local` (their global shapes
    and strides given) and returns the local shards of the outputs.
    Grad mode is off around `fn`; a train step turns it on for its loss and
    backward. Returns (graph module with dead code removed, the local
    ``meta`` inputs)."""
    leaves = _leaves(args, [])
    local = [t.to_local() if isinstance(t, DTensor) else t for t in leaves]
    layouts = [(t.device_mesh, t.placements, t.shape, t.stride()) if isinstance(t, DTensor)
               else None for t in leaves]

    def per_rank(*shards):
        wrapped = [DTensor.from_local(s, lay[0], lay[1], run_check=False, shape=lay[2],
                                      stride=lay[3]) if lay else s
                   for s, lay in zip(shards, layouts)]
        with use_rules(rules), torch.no_grad():
            out = fn(*_rebuild(args, iter(wrapped)))
        return [t.to_local() if isinstance(t, DTensor) else t for t in _leaves(out, [])]

    gm = make_fx(per_rank, tracing_mode="fake")(*local)
    gm.graph.eliminate_dead_code()
    gm.recompile()
    return gm, local


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    microbatches: int = 1,
    q_chunk: int = 512,
    moments_dtype: str = "float32",
    quant: str | None = None,   # "int8": TP-only weight-only-quant decode
    verbose: bool = True,
):
    """Trace one cell on rank 0 of its mesh's fake group (started here and
    destroyed before returning) and read its roofline terms; returns
    (report dict, graph module)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if dist.is_initialized():
        raise RuntimeError("a process group is live: the dry-run starts its own fake group")
    model = make_model(cfg)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    start_fake_group(512 if multi_pod else 256)
    try:
        mesh, rules = _mesh_and_rules(shape.kind, multi_pod)
        chips = mesh.size()
        t0 = time.time()
        alias_bytes = 0
        with use_rules(rules):
            if shape.kind == "train":
                step_cfg = StepConfig(microbatches=microbatches, q_chunk=q_chunk)
                opt_cfg = AdamWConfig(moments_dtype=moments_dtype)
                state = abstract_train_state(model, rules, opt_cfg=opt_cfg)
                batch = input_specs(model, shape, rules)
                gm, local = trace_per_rank(build_train_step(model, opt_cfg, step_cfg),
                                           (state, batch), rules)
                # The state is donated to the step: its local shards, the
                # first of the graph's inputs.
                alias_bytes = sum(t.numel() * t.element_size()
                                  for t in local[:len(_leaves(state, []))])
                tokens = shape.global_batch * shape.seq_len
            elif shape.kind == "prefill":
                params = model.abstract_params(rules, param_dtype=L.COMPUTE_DTYPE)
                batch = input_specs(model, shape, rules)
                gm, local = trace_per_rank(
                    lambda p, b: model.prefill(p, b, q_chunk=q_chunk), (params, batch), rules)
                tokens = shape.global_batch * shape.seq_len
            else:  # decode
                if quant == "int8":
                    from repro_torch.models.quant import abstract_quantized_params
                    from repro_torch.sharding.rules import DECODE_TP_RULES

                    params = abstract_quantized_params(
                        model.spec(), ShardingRules(mesh, dict(DECODE_TP_RULES)))
                else:
                    params = model.abstract_params(rules, param_dtype=L.COMPUTE_DTYPE)
                spec = input_specs(model, shape, rules)
                # The caches hold seq_len - 1 positions on the host, so the
                # new token's position (spec["position"]) is seq_len - 1.
                position = shape.seq_len - 1
                gm, local = trace_per_rank(
                    lambda p, i, c: model.decode_step(p, i, c, position),
                    (params, spec["inputs"], spec["caches"]), rules)
                tokens = shape.global_batch  # one new token per sequence
        t_lower = time.time() - t0

        report = analyze_graph(
            gm, local,
            arch=arch,
            shape=shape_name,
            kind=shape.kind,
            mesh_name=mesh_name,
            chips=chips,
            n_active_params=model.active_param_count(),
            tokens=tokens,
            alias_bytes=alias_bytes,
        )
    finally:
        dist.destroy_process_group()
    out = report.to_dict()
    out["lower_s"] = round(t_lower, 2)
    out["compile_s"] = 0.0
    out["microbatches"] = microbatches
    out["param_count"] = model.param_count()
    out["active_param_count"] = model.active_param_count()
    if verbose:
        print(report.memory_stats)
        print({"flops": report.flops_per_chip, "bytes accessed": report.bytes_per_chip,
               "graph nodes": len(gm.graph.nodes)})
        print(report.summary_line())
    return out, gm


def run_cells(cells, *, meshes=("pod16x16", "pod2x16x16"), out_dir=None,
              microbatches=1, moments_dtype="float32", stop_on_error=False):
    results = []
    for arch, shape_name in cells:
        cfg = get_config(arch)
        applicable = {s.name for s in shapes_for(cfg)}
        for mesh_name in meshes:
            multi_pod = mesh_name == "pod2x16x16"
            key = f"{arch}__{shape_name}__{mesh_name}"
            if shape_name not in applicable:
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "status": "skipped",
                       "reason": ("long_500k requires sub-quadratic sequence mixing "
                                  "(full-attention arch); see DESIGN.md")}
                results.append(rec)
                print(f"SKIP  {key}: {rec['reason']}")
                _write(out_dir, key, rec)
                continue
            try:
                t0 = time.time()
                rec, _ = lower_cell(
                    arch, shape_name, multi_pod=multi_pod,
                    microbatches=microbatches, moments_dtype=moments_dtype, verbose=False,
                )
                rec["status"] = "ok"
                rec["wall_s"] = round(time.time() - t0, 2)
                print(
                    f"OK    {key}: lower={rec['lower_s']}s "
                    f"dom={rec['dominant']} tc={rec['t_compute']:.2e} "
                    f"tm={rec['t_memory']:.2e} tcoll={rec['t_collective']:.2e}",
                    flush=True,
                )
            except Exception as e:  # repro: allow[RP005] — recorded per cell; re-raised when stop_on_error
                rec = {
                    "arch": arch, "shape": shape_name, "mesh": mesh_name,
                    "status": "error", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:],
                }
                print(f"FAIL  {key}: {rec['error'][:300]}", flush=True)
                if stop_on_error:
                    raise
            results.append(rec)
            _write(out_dir, key, rec)
    return results


def _write(out_dir, key, rec) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, key + ".json"), "w") as f:
        json.dump(rec, f, indent=2, default=str)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true",
                    help="all (arch x shape) cells")
    ap.add_argument("--multi-pod", action="store_true",
                    help="use the 2x16x16 multi-pod mesh (single-cell mode)")
    ap.add_argument("--meshes", default="pod16x16,pod2x16x16",
                    help="comma list for --all mode")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--moments-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="optimizer moment storage (train cells)")
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="weight-only int8 TP-only layout (decode cells)")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = [
            (arch, shape_name)
            for arch in sorted(all_configs())
            for shape_name in SHAPES
        ]
        results = run_cells(
            cells,
            meshes=tuple(args.meshes.split(",")),
            out_dir=args.out,
            microbatches=args.microbatches,
            moments_dtype=args.moments_dtype,
            stop_on_error=args.stop_on_error,
        )
        ok = sum(r.get("status") == "ok" for r in results)
        skip = sum(r.get("status") == "skipped" for r in results)
        err = sum(r.get("status") == "error" for r in results)
        print(f"\n== dry-run complete: {ok} ok, {skip} skipped, {err} failed ==")
        if err:
            raise SystemExit(1)
        return

    if not args.arch or not args.shape:
        ap.error("--arch and --shape required (or --all)")
    rec, _ = lower_cell(
        args.arch, args.shape,
        multi_pod=args.multi_pod,
        microbatches=args.microbatches,
        moments_dtype=args.moments_dtype,
        quant=args.quant,
    )
    rec["status"] = "ok"
    if args.microbatches != 1 or args.quant or args.moments_dtype != "float32":
        # Non-default knobs: don't clobber the baseline artifact.
        args.out = args.out.rstrip("/") + "_variants"
    _write(args.out, f"{args.arch}__{args.shape}__"
           f"{'pod2x16x16' if args.multi_pod else 'pod16x16'}", rec)


if __name__ == "__main__":
    main()
