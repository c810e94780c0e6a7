"""One dry-run cell on both sides: the port's `lower_cell` and the JAX
package's, the reference in a process of its own that forces 512 host
devices before importing JAX. Prints each side's per-chip product FLOPs
(the reference's dots, `analyze_hlo`), collective bytes and bytes, and
the port's over the reference's.

  PYTHONPATH=src python tests/dryrun_reference_compare.py ARCH SHAPE [--layers N]
      [--microbatches N] [--multi-pod]

`--layers` cuts the config to N layers on both sides (registered under
the name ARCH-Nl). Not a test: pytest collects nothing here.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE = """
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.configs import base
from repro.launch.dryrun import lower_cell
from repro.roofline.hlo_parse import analyze_hlo
arch, shape = sys.argv[1], sys.argv[2]
layers, micro, multi = int(sys.argv[3]), int(sys.argv[4]), sys.argv[5] == "1"
name = arch
if layers:
    name = f"{arch}-{layers}l"
    base.register(dataclasses.replace(base.get_config(arch), num_layers=layers, name=name))
rec, compiled = lower_cell(name, shape, multi_pod=multi, microbatches=micro, verbose=False)
cost = analyze_hlo(compiled.as_text())
print(json.dumps({"flops": cost.flops, "coll": cost.collective_bytes,
                  "bytes": rec["bytes_per_chip"], "model_flops": rec["model_flops_total"]}))
"""


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REFERENCE, args.arch, args.shape, str(args.layers),
                          str(args.microbatches), str(int(args.multi_pod))],
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=3600)
    if res.returncode != 0:
        sys.exit(res.stderr[-3000:])
    ref = json.loads(res.stdout.strip().splitlines()[-1])

    from repro_torch.configs import base, get_config
    from repro_torch.launch.dryrun import lower_cell

    name = args.arch
    if args.layers:
        name = f"{args.arch}-{args.layers}l"
        base.register(dataclasses.replace(get_config(args.arch), num_layers=args.layers,
                                          name=name))
    rec, _ = lower_cell(name, args.shape, multi_pod=args.multi_pod,
                        microbatches=args.microbatches, verbose=False)
    port = {"flops": rec["flops_per_chip"], "coll": rec["coll_bytes_per_chip"],
            "bytes": rec["bytes_per_chip"], "model_flops": rec["model_flops_total"]}
    print(json.dumps({"cell": f"{name} {args.shape} microbatches {args.microbatches}",
                      "port": port, "reference": ref, "lower_s": rec["lower_s"],
                      "port_over_reference": {k: port[k] / ref[k] if ref[k] else None
                                              for k in port}}))


if __name__ == "__main__":
    main()
