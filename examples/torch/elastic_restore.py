"""Elastic scaling on the PyTorch port: save a sharded parameter tree on one
mesh, restore it onto a different topology (grow/shrink) purely through
the checkpoint template, and snapshot the resized tree.

  PYTHONPATH=src python examples/torch/elastic_restore.py               # one rank per GPU
  PYTHONPATH=src python examples/torch/elastic_restore.py --device cpu  # 8 gloo ranks

Each rank is a process of its own in one `torch.distributed` group (NCCL
on the GPUs, gloo on the CPU); the ranks share a `local://` store in a
directory. On the CPU the tree goes from a (4, 2) mesh to a (2, 4) one,
as the JAX package's example does; on n GPUs from (n, 1) to (1, n). When
both meshes have one shape (one GPU), the restore lays the tree out by
another rules table instead, so its layout still changes.
"""

import argparse
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.ckpt import latest_step, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.ft import snapshot_resharded
from repro_torch.ft.elastic import reshard_params, restore_resharded
from repro_torch.io import IOPolicy, open_store
from repro_torch.launch.mesh import make_mesh_compat, mesh_host_shard
from repro_torch.models import make_model
from repro_torch.models.spec import param_shardings
from repro_torch.sharding.rules import DECODE_TP_RULES, TRAIN_RULES, ShardingRules

CPU_RANKS = 8
JOIN_TIMEOUT_S = 600


def local_slice(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """The part of the logical array `x` this rank should hold: each mesh
    dimension in order narrows the dimension it shards to this rank's
    piece (JAX's major-to-minor order over composite axes)."""
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if p.is_shard():
            n = x.shape[p.dim] // mesh.size(m)
            x = x.narrow(p.dim, coord[m] * n, n)
    return x


def rank_main(rank: int, world: int, device_type: str, workdir: str) -> None:
    backend = "nccl" if device_type == "cuda" else "gloo"
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device_type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)    # one core a rank, not every core each
    dist.init_process_group(backend, init_method=f"file://{workdir}/pg", rank=rank,
                            world_size=world,
                            device_id=device if device_type == "cuda" else None)
    try:
        run(rank, world, device, workdir)
    finally:
        dist.destroy_process_group()


def report(*args) -> None:
    if dist.get_rank() == 0:
        print(*args, flush=True)


def run(rank: int, world: int, device: torch.device, workdir: str) -> None:
    cfg = get_config("olmo-1b").reduced()
    model = make_model(cfg)
    spec = model.spec()
    shape_a = (4, 2) if device.type == "cpu" else (world, 1)
    shape_b = shape_a[::-1]

    # --- train-time topology ---------------------------------------------------
    mesh_a = make_mesh_compat(shape_a, ("data", "model"), device_type=device.type)
    params = model.init(0, device=device)
    placed = reshard_params(params, spec, ShardingRules(mesh_a, dict(TRAIN_RULES)))

    store = open_store(f"local://{workdir}/store")
    save_checkpoint(store, "elastic", 0, placed, policy=IOPolicy(write_depth=4))
    report(f"saved on mesh {dict(zip(mesh_a.mesh_dim_names, mesh_a.shape))} "
           f"({world} {device.type} ranks)")

    # --- restore onto a DIFFERENT topology -------------------------------------
    mesh_b = make_mesh_compat(shape_b, ("data", "model"), device_type=device.type)
    table, table_name = TRAIN_RULES, "TRAIN_RULES"
    if shape_b == shape_a:
        table, table_name = DECODE_TP_RULES, "DECODE_TP_RULES"
    rules_b = ShardingRules(mesh_b, dict(table))
    shardings_b = param_shardings(spec, rules_b)
    template = model.abstract_params(rules_b)
    host_id, num_hosts = mesh_host_shard()
    restored, _ = restore_resharded(
        store, "elastic", template, host_id=host_id, num_hosts=num_hosts,
        policy=IOPolicy(engine="rolling", depth=2, eviction_interval_s=0.2), device=device)

    # --- verify bit-identical logical arrays, new physical layout --------------
    for a, b, t in zip(T.flatten(params), T.flatten(restored), T.flatten(template)):
        if b.placements != t.placements or b.device_mesh != mesh_b:
            raise AssertionError(f"restored placements {b.placements}, want {t.placements}")
        if not torch.equal(b.to_local(), local_slice(a, mesh_b, b.placements)):
            raise AssertionError(f"rank {rank}: its shard is not its slice of the array")
        if not torch.equal(b.full_tensor(), a):
            raise AssertionError("restored logical array differs from the saved one")
    n_resharded = sum(s is not None for s in T.flatten(shardings_b))
    report(f"restored onto mesh {dict(zip(mesh_b.mesh_dim_names, mesh_b.shape))} by "
           f"{table_name}: values identical, {n_resharded} sharded leaves re-laid-out")

    # --- snapshot the resized job so the reshard is immediately crash-safe -----
    snapshot_resharded(store, "elastic", 1, restored, shardings_b,
                       policy=IOPolicy(write_depth=4))
    if latest_step(store, "elastic") != 1:
        raise AssertionError("the post-reshard snapshot is not the latest step")
    report("OK: elastic restore verified; post-reshard snapshot committed")


def launch(device_type: str, workdir: str) -> int:
    """Start one process per rank and wait for all of them; a rank that
    fails or outlives the timeout fails the run (the others are stopped)."""
    world = CPU_RANKS if device_type == "cpu" else torch.cuda.device_count()
    if world < 1:
        raise SystemExit("no GPU visible: pass --device cpu")
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, device_type, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    failed = []
    try:
        for r, p in enumerate(procs):
            p.join(max(0.0, deadline - time.monotonic()))
            if p.is_alive() or p.exitcode != 0:
                failed.append(r)
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
    if failed:
        print(f"FAIL: rank {failed[0]} did not finish cleanly (exit codes "
              f"{[p.exitcode for p in procs]})", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="directory for the ranks' rendezvous file and the local:// store "
                         "(default: a temporary directory, removed at the end)")
    args = ap.parse_args(argv)
    if args.workdir is not None:
        os.makedirs(args.workdir, exist_ok=True)
        return launch(args.device, os.path.abspath(args.workdir))
    with tempfile.TemporaryDirectory() as workdir:
        return launch(args.device, workdir)


if __name__ == "__main__":
    sys.exit(main())
