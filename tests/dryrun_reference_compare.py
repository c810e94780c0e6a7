"""Dry-run cells on both sides: the port's `lower_cell` and the JAX
package's, the reference in a process of its own that forces 512 host
devices before importing JAX. Prints one JSON line per cell: each side's
per-chip product FLOPs (the reference's dots, `analyze_hlo`), collective
bytes and bytes, its dominant term (both sides' counts over the same H100
peaks, `roofline.analysis.HW_H100`), and the port's over the reference's;
besides, each side's argument bytes (``args``: the rank's shards of the
weights, caches and inputs, what a step must read at least once), the
port's ``temp`` bytes, and the reference's ``coll_tuples``: the bytes of
its tuple-shaped collectives (XLA's combined all-reduces of several
partial sums, its MoE all-to-alls), which `analyze_hlo` counts as 0 and
``coll`` leaves out (counted here by its own rules, the tuple's bytes as
one array's).

  PYTHONPATH=src python tests/dryrun_reference_compare.py ARCH SHAPE [ARCH SHAPE ...]
      [--layers N] [--microbatches N] [--multi-pod | --mesh MESH] [--jobs J] [--top K]
  PYTHONPATH=src python tests/dryrun_reference_compare.py --serving [--mesh both]
      [--layers 2] [--jobs 6]
  PYTHONPATH=src python tests/dryrun_reference_compare.py --training [--mesh both]
      [--layers 2] [--jobs 4] [--top 10]

`--serving` adds every serving cell (every config's prefill_32k and
decode_32k, and long_500k where the config has it), `--training` every
train cell (every config's train_4k). `--mesh` is
pod16x16, pod2x16x16 or both (`--multi-pod` is pod2x16x16). `--layers`
cuts each config to N layers on both sides, rounded up to a whole number
of its block pattern (jamba's 8), registered under the name ARCH-Nl.
Cells run `--jobs` at a time, each in a process of its own (a dry-run holds
one fake process group), the reference beside the port. `--top K` adds each
side's K largest products, memory traffic and collectives, a collective
as (bytes, kind, shape, dtype); the reference's bf16 all-reduces, which XLA's CPU backend
promotes to f32 and which it counts at bf16 bytes, read "bf16 (promoted
to f32)". Not a test: pytest collects
nothing here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = r"""
import os, sys, json, dataclasses, math, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.configs import base
from repro.launch.dryrun import lower_cell
from repro.roofline.hlo_parse import _DTYPE_BYTES, COLLECTIVES, analyze_hlo, parse_module
arch, shape = sys.argv[1], sys.argv[2]
layers, micro, multi = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5] == "1"
top = int(sys.argv[6]) if len(sys.argv) > 6 else 0
name = arch
if layers:
    name = f"{arch}-{layers}l"
    base.register(dataclasses.replace(base.get_config(arch), num_layers=layers, name=name))
rec, compiled = lower_cell(name, shape, multi_pod=multi, microbatches=micro, verbose=False)
text = compiled.as_text()
cost = analyze_hlo(text)


def untupled(text):
    # The module with each tuple-shaped collective's shape written as one
    # u8 array of the tuple's bytes: `analyze_hlo` counts a tuple as 0.
    pat = re.compile(r"^(\s*(?:ROOT\s+)?%[\w.\-]+\s*=\s*)\(([^()]*)\)(\s+(?:all-reduce|"
                     r"all-gather|reduce-scatter|all-to-all|collective-permute)\()")
    def nbytes(parts):
        return sum(_DTYPE_BYTES[m.group(1)] * math.prod(int(d) for d in m.group(2).split(",") if d)
                   for m in re.finditer(r"(\w+)\[([0-9,]*)\]", parts))
    return "\n".join(pat.sub(lambda m: f"{m.group(1)}u8[{nbytes(m.group(2))}]{{0}}{m.group(3)}", l)
                     for l in text.splitlines())


out = {"flops": cost.flops, "coll": cost.collective_bytes,
       "coll_tuples": analyze_hlo(untupled(text)).collective_bytes - cost.collective_bytes,
       "bytes": rec["bytes_per_chip"], "model_flops": rec["model_flops_total"],
       "args": rec["memory_stats"].get("argument_bytes")}
if top:
    out["top_flops"] = [[r[0], r[2], str(r[3])] for r in cost.top_flops[:top]]
    out["top_traffic"] = [[r[0], r[2], str(r[3])] for r in cost.top_traffic[:top]]
    dtypes = {}
    for comp in parse_module(text)[0].values():
        for i in comp.instrs:
            if i.opcode in COLLECTIVES:
                promoted = i.opcode.startswith("all-reduce") and "promoted" in i.attrs
                dtypes[(i.opcode.replace("-start", ""), i.shape)] = (
                    "bf16 (promoted to f32)" if promoted else i.dtype)
    out["top_collectives"] = [[r[0], r[2], str(r[3]), dtypes.get((r[2], r[3]), "?")]
                              for r in cost.top_collectives[:top]]
print(json.dumps(out))
"""
MESH_NAMES = ("pod16x16", "pod2x16x16")


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}


def cut_layers(arch: str, layers: int) -> int:
    """`layers` rounded up to a whole number of the config's block pattern
    (0: the config's own depth)."""
    if not layers:
        return 0
    from repro_torch.configs import get_config

    period = len(get_config(arch).pattern)
    return -(-layers // period) * period


def serving_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import all_configs, shapes_for

    return [(arch, s.name) for arch, cfg in sorted(all_configs().items())
            for s in shapes_for(cfg) if s.kind != "train"]


def training_cells() -> list[tuple[str, str]]:
    from repro_torch.configs import all_configs, shapes_for

    return [(arch, s.name) for arch, cfg in sorted(all_configs().items())
            for s in shapes_for(cfg) if s.kind == "train"]


def dominant(flops: float, coll: float, nbytes: float) -> str:
    from repro_torch.roofline.analysis import HW_H100

    terms = {"compute": flops / HW_H100["peak_flops"], "memory": nbytes / HW_H100["hbm_bw"],
             "collective": coll / HW_H100["link_bw"]}
    return max(terms, key=terms.get)


def _port_top(gm, k: int) -> dict:
    import torch

    from repro_torch.roofline.graph_parse import analyze_graph_module

    inputs = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
              for v in (n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder")]
    cost = analyze_graph_module(gm, inputs)
    dtypes = {n.name: str(n.meta["val"].dtype).replace("torch.", "")
              for n in gm.graph.nodes if isinstance(n.meta.get("val"), torch.Tensor)}
    return {"top_flops": [[r[0], r[2], str(r[3])] for r in cost.top_flops[:k]],
            "top_traffic": [[r[0], r[2], str(r[3])] for r in cost.top_traffic[:k]],
            "top_collectives": [[r[0], r[2], str(r[3]), dtypes.get(r[4], "?")]
                                for r in cost.top_collectives[:k]]}


def lower_both(arch: str, shape: str, layers: int, microbatches: int = 1,
               multi_pod: bool = False, top: int = 0) -> tuple[dict, object, dict]:
    """(the port's `lower_cell` record, its graph, the reference's record
    with its dominant term) of one cell: the reference in a subprocess
    started first, the port in this process while it runs."""
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, arch, shape, str(layers), str(microbatches),
         str(int(multi_pod)), str(top)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO)

    from repro_torch.configs import base, get_config
    from repro_torch.launch.dryrun import lower_cell

    name = arch
    if layers:
        name = f"{arch}-{layers}l"
        if name not in base.all_configs():
            base.register(dataclasses.replace(get_config(arch), num_layers=layers, name=name))
    try:
        rec, gm = lower_cell(name, shape, multi_pod=multi_pod, microbatches=microbatches,
                             verbose=False)
        out, err = ref_proc.communicate(timeout=3600)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    if ref_proc.returncode != 0:
        raise RuntimeError(f"reference {name} {shape}: {err[-3000:]}")
    ref = json.loads(out.strip().splitlines()[-1])
    ref["dominant"] = dominant(ref["flops"], ref["coll"], ref["bytes"])
    return rec, gm, ref


def collectives(gm) -> list[tuple[str, tuple, int]]:
    """(kind, the shape it moves, the elements it moves) of every
    collective in the port's graph: a reduce-scatter's operand, any
    other's output. A functional all-gather stacks its shards on dim 0."""
    import torch

    from repro_torch.roofline.graph_parse import COLLECTIVES

    out = []
    for n in gm.graph.nodes:
        target = n.target
        if not (n.op == "call_function" and isinstance(target, torch._ops.OpOverload)
                and target.namespace == "_c10d_functional"):
            continue
        kind = COLLECTIVES.get(target._schema.name.split("::")[-1])
        if kind is None:
            continue
        val = n.args[0].meta["val"] if kind == "reduce-scatter" else n.meta.get("val")
        if isinstance(val, torch.Tensor):
            out.append((kind, tuple(val.shape), val.numel()))
    return out


def compare_cell(arch: str, shape: str, layers: int, microbatches: int, multi_pod: bool,
                 top: int = 0) -> dict:
    """Both sides of one cell, and the port's counts over the reference's."""
    rec, gm, ref = lower_both(arch, shape, layers, microbatches, multi_pod, top)
    port = {"flops": rec["flops_per_chip"], "coll": rec["coll_bytes_per_chip"],
            "bytes": rec["bytes_per_chip"], "model_flops": rec["model_flops_total"],
            "dominant": rec["dominant"], "args": rec["memory_stats"]["argument_bytes"],
            "temp": rec["memory_stats"]["temp_bytes"]}
    if top:
        port.update(_port_top(gm, top))
    name = f"{arch}-{layers}l" if layers else arch
    keys = ("flops", "coll", "bytes", "model_flops")
    return {"cell": f"{name} {shape} microbatches {microbatches}", "arch": arch,
            "shape": shape, "layers": layers,
            "mesh": MESH_NAMES[int(multi_pod)], "port": port, "reference": ref,
            "lower_s": rec["lower_s"],
            "port_over_reference": {k: port[k] / ref[k] if ref[k] else None for k in keys}}


def _run_one(arch: str, shape: str, layers: int, microbatches: int, multi_pod: bool,
             top: int) -> dict:
    """One cell in a process of its own; its JSON line, or an error record."""
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--one", arch, shape,
         "--layers", str(layers), "--microbatches", str(microbatches), "--top", str(top)]
        + (["--multi-pod"] if multi_pod else []),
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=7200)
    if res.returncode != 0:
        return {"cell": f"{arch} {shape}", "mesh": MESH_NAMES[int(multi_pod)],
                "error": res.stderr[-2000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("cells", nargs="*", help="ARCH SHAPE pairs")
    ap.add_argument("--serving", action="store_true", help="every serving cell")
    ap.add_argument("--training", action="store_true", help="every train cell")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", choices=MESH_NAMES + ("both",), default=None)
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--top", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if len(args.cells) % 2:
        ap.error("cells are ARCH SHAPE pairs")
    if args.one:
        print(json.dumps(compare_cell(args.cells[0], args.cells[1], args.layers,
                                      args.microbatches, args.multi_pod, args.top)))
        return
    cells = list(zip(args.cells[::2], args.cells[1::2]))
    if args.serving:
        cells += serving_cells()
    if args.training:
        cells += training_cells()
    if not cells:
        ap.error("no cell: give ARCH SHAPE pairs, --serving or --training")
    mesh = args.mesh or ("pod2x16x16" if args.multi_pod else "pod16x16")
    pods = [m == "pod2x16x16" for m in (MESH_NAMES if mesh == "both" else (mesh,))]
    jobs = [(arch, shape, cut_layers(arch, args.layers), args.microbatches, multi, args.top)
            for multi in pods for arch, shape in cells]
    failed = 0
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for rec in pool.map(lambda j: _run_one(*j), jobs):
            failed += "error" in rec
            print(json.dumps(rec), flush=True)
    if failed:
        sys.exit(f"{failed} of {len(jobs)} cells failed")


if __name__ == "__main__":
    main()
