"""Dry-run profiler: trace one cell and print the top contributors to each
roofline term; the port of the JAX package's ``roofline/inspect.py``.

  PYTHONPATH=src python -m repro_torch.roofline.inspect --arch granite-moe-3b-a800m \
      --shape prefill_32k [--multi-pod] [--top 15]
"""

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.roofline.graph_parse import analyze_graph_module

    rec, gm = lower_cell(
        args.arch, args.shape,
        multi_pod=args.multi_pod,
        microbatches=args.microbatches,
        verbose=False,
    )
    import torch

    inputs = [torch.empty_strided(v.shape, v.stride(), dtype=v.dtype, device="meta")
              for v in (n.meta["val"] for n in gm.graph.nodes if n.op == "placeholder")]
    cost = analyze_graph_module(gm, inputs)
    print(f"== {args.arch} x {args.shape} "
          f"({'pod2x16x16' if args.multi_pod else 'pod16x16'}) ==")
    print(f"terms: tc={rec['t_compute']:.3e}s tm={rec['t_memory']:.3e}s "
          f"tcoll={rec['t_collective']:.3e}s dom={rec['dominant']} "
          f"useful={rec['useful_flops_ratio']:.3f}")
    print(f"memory_analysis: {rec['memory_stats']}")

    def show(title, rows, unit):
        print(f"\n-- top {title} --")
        for val, mult, op, shape, hint in rows[: args.top]:
            print(f"  {val:12.3e} {unit}  x{mult:<6.0f} {op:<18s} "
                  f"{str(shape):<28s} {hint}")

    show("collectives (per-chip bytes)", cost.top_collectives, "B")
    show("traffic (per-chip bytes)", cost.top_traffic, "B")
    show("flops (per-chip)", cost.top_flops, "F")


if __name__ == "__main__":
    main()
