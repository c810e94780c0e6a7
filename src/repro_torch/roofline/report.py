"""EXPERIMENTS.md §Dry-run + §Roofline table generator.

  PYTHONPATH=src python -m repro_torch.roofline.report --dryrun-dir reports/dryrun

Prints markdown tables from the dry-run artifacts; EXPERIMENTS.md embeds
the output.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(path: str) -> list[dict]:
    recs = []
    for fn in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(fn) as f:
            recs.append(json.load(f))
    return recs


def _gb(x) -> str:
    return f"{x / 1e9:.2f}"


def _note(r: dict) -> str:
    dom = r["dominant"]
    arch, shape = r["arch"], r["shape"]
    if dom == "collective":
        kinds = r.get("coll_breakdown", {}).get("bytes", {})
        top = max(kinds, key=kinds.get) if kinds else "?"
        return (f"{top} dominates — overlap collectives with compute "
                f"(TPU latency-hiding scheduler) or reshard the source tensor")
    if dom == "memory":
        if r["kind"] == "decode":
            return ("KV/weight streaming — fuse reads (flash-decode kernel), "
                    "quantize weights/KV")
        return ("activation traffic — Pallas flash/SSD kernels keep the "
                "score/state chain in VMEM")
    return "compute-bound — at roofline; raise per-chip utilization via bigger tiles"


def dryrun_table(recs: list[dict]) -> str:
    lines = [
        "| arch | shape | mesh | status | compile_s | args GB/chip | temp GB/chip | collectives (count by kind) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"], r.get("mesh", ""))):
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | SKIP | — | — | — | "
                f"{r['reason'][:60]}… |"
            )
            continue
        if r.get("status") != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | **ERROR** | — | — | — | "
                f"{r.get('error', '')[:60]} |"
            )
            continue
        ms = r["memory_stats"]
        counts = r.get("coll_breakdown", {}).get("count", {})
        cstr = ", ".join(f"{k}:{int(v)}" for k, v in sorted(counts.items()))
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['compile_s']} | "
            f"{_gb(ms.get('argument_bytes', 0))} | {_gb(ms.get('temp_bytes', 0))} | "
            f"{cstr} |"
        )
    return "\n".join(lines)


def roofline_table(recs: list[dict], mesh: str = "pod16x16") -> str:
    lines = [
        "| arch | shape | t_compute s | t_memory s | t_collective s | dominant | MODEL_FLOPS | useful ratio | what moves the dominant term |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh:
            continue
        if r.get("status") == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | "
                f"long_500k needs sub-quadratic mixing (full-attention arch) |"
            )
            continue
        if r.get("status") != "ok":
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute']:.3e} | "
            f"{r['t_memory']:.3e} | {r['t_collective']:.3e} | "
            f"**{r['dominant']}** | {r['model_flops_total']:.2e} | "
            f"{r['useful_flops_ratio']:.2f} | {_note(r)} |"
        )
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="reports/dryrun")
    ap.add_argument("--section", default="all",
                    choices=["all", "dryrun", "roofline"])
    args = ap.parse_args()
    recs = load(args.dryrun_dir)
    if args.section in ("all", "dryrun"):
        print("### Dry-run artifacts (both meshes)\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("all", "roofline"):
        print("### Roofline terms (single-pod 16x16, 256 chips)\n")
        print(roofline_table(recs, "pod16x16"))
        print()
        print("### Roofline terms (multi-pod 2x16x16, 512 chips)\n")
        print(roofline_table(recs, "pod2x16x16"))


if __name__ == "__main__":
    main()
