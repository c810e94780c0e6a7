#!/usr/bin/env python3
"""The readings a training cell's limits are set from, in one process on
the card:

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--control-only] [--out FILE]

For each of `--seeds`, the program's numbers of a sound run: the cell's
set-up steps (no window), compared with the fp32 reference. For each of
`--control-seeds`, the control and a planted fault, each against the fp32
reference: the reference in float8 in the program's place, and the program
with half of each batch left out (`faults.half_batch`). A step that returns
its state unchanged reads 1 on ``update_gap`` by its definition and needs no
run. `--control-only` reads the control alone, with no program.

Each row is judged by the cell's own limits through the checks that decide
a run's `correct` (`drivers/train.py`'s `checks`): a sound row has to read
true, a control or fault row false. One JSON line a reading, on standard
output and in `--out`. The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import faults, harness  # noqa: E402
from gpubench.reference import lm as ref  # noqa: E402


def _free(device: str) -> None:
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()


def judged(kind: str, nums: dict, wrong: int, ctx, drv) -> dict:
    """A reading's row: its numbers and whether the cell's limits call it
    correct."""
    run = harness.Run(driver="train", config=ctx.cell.config, traffic=ctx.cell.traffic)
    run.checks = drv.checks(nums, wrong, ctx.cell.workload["limits"])
    return {"kind": kind, "correct": run.correct, "tokens_wrong": wrong, **nums}


def readings(ctx, control: bool, control_only: bool = False) -> list:
    drv = harness.code_file("drivers", "train")
    if control_only:
        ref_side = drv.reference_side(ctx)
        _free(ctx.device)
        f8 = drv.reference_side(ctx, ref.FP8)
        return [judged("control_fp8_reference", drv.compare(f8, ref_side), 0, ctx, drv)]

    def program_side():
        prog = drv.Program(ctx)
        side = prog.first_steps()
        wrong = drv.tokens_wrong(prog)
        prog.close()
        del prog
        _free(ctx.device)
        return side, wrong

    side, wrong = program_side()
    ref_side = drv.reference_side(ctx)
    _free(ctx.device)
    row = judged("program", drv.compare(side, ref_side), wrong, ctx, drv)
    row.update(loss=side["loss"].tolist(), ref_loss=ref_side["loss"].tolist())
    rows = [row]
    if control:
        f8 = drv.reference_side(ctx, ref.FP8)
        _free(ctx.device)
        rows.append(judged("control_fp8_reference", drv.compare(f8, ref_side), 0, ctx, drv))
        with faults.half_batch():
            half, half_wrong = program_side()
        rows.append(judged("fault_half_batch", drv.compare(half, ref_side), half_wrong, ctx,
                           drv))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--control-only", action="store_true",
                    help="the control against the reference, no program")
    args = ap.parse_args()
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for seed in seeds + [s for s in controls if s not in seeds]:
            t0 = time.perf_counter()
            ctx = harness.Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                                  device=args.device, t_start=t0)
            for row in readings(ctx, seed in controls, args.control_only):
                row.update(cell=cell.name, seed=seed, seconds=time.perf_counter() - t0)
                line = json.dumps(row)
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
            _free(args.device)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
