"""End-to-end training driver: object-store data -> Rolling Prefetch ->
device feed -> train step -> async checkpoints -> crash-safe resume, on the
GPU by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --full \
      --steps 50 --batch 8 --seq-len 256 --mode rolling
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 4 --batch 2 --seq-len 32 --ckpt-store local:///tmp/ckpt

The default is the reduced config; pass --full for the full architecture.
One process drives one device: a resume restores the whole checkpoint.
Run it again with the same --ckpt-store to resume from its newest
checkpoint.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.ckpt.manager import CheckpointManager, latest_step, restore_checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataCursor, LoaderConfig, PrefetchingDataLoader, synth_token_shard
from repro_torch.data.loader import DeviceFeeder
from repro_torch.io import IOPolicy, open_store
from repro_torch.launch.mesh import mesh_host_shard
from repro_torch.models import make_model
from repro_torch.spans import StepClock
from repro_torch.store import LinkModel, MemTier, SimS3Store
from repro_torch.train import (
    AdamWConfig,
    StepConfig,
    build_train_step,
    init_train_state,
)
from repro_torch.utils import get_logger

log = get_logger("launch.train")


def build_data_store(n_shards: int, tokens_per_shard: int, vocab: int,
                     latency_s: float, bandwidth_Bps: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    store = SimS3Store(
        link=LinkModel(latency_s=latency_s, bandwidth_Bps=bandwidth_Bps)
    )
    for i in range(n_shards):
        store.backing.put(
            f"data/tok{i:04d}.bin", synth_token_shard(rng, tokens_per_shard, vocab)
        )
    return store


def _with_cursor(loader: PrefetchingDataLoader):
    """The loader's batches, each with the data cursor just after it. The
    feeder's thread runs ahead of the train loop, so the loader's live
    cursor is past the step being trained; a checkpoint records the cursor
    of the batch its step consumed, and a resume continues from there."""
    for inputs, labels in loader.batches():
        yield inputs, labels, loader.cursor.to_dict()


@dataclass
class TrainResult:
    """What one run did: per-step metrics from `start_step` on, and where
    its time went."""

    start_step: int
    losses: list[float] = field(default_factory=list)
    grad_norms: list[float] = field(default_factory=list)
    lrs: list[float] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)      # device timeline on CUDA
    feeder_wait_s: list[float] = field(default_factory=list)  # host, per step
    tokens: int = 0
    wall_s: float = 0.0
    restore_s: float | None = None
    fs_stats: dict = field(default_factory=dict)


def main(argv: list[str] | None = None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--mode", default="rolling",
                    choices=["rolling", "sequential"])
    ap.add_argument("--prefetch-depth", type=int, default=2)
    ap.add_argument("--blocksize", type=int, default=256 << 10)
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--ckpt-store", default=None,
                    help="checkpoint store URI (mem://, local:///path, "
                         "sims3://bucket?latency_ms=...); default builds a "
                         "sims3:// URI from --s3-latency/--s3-bandwidth")
    ap.add_argument("--write-depth", type=int, default=2,
                    help="concurrent write-behind part uploads for saves")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--s3-latency", type=float, default=0.01)
    ap.add_argument("--s3-bandwidth", type=float, default=50e6)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0, help="parameter init seed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg)
    log.warning("arch=%s params=%.2fM device=%s", cfg.name,
                model.param_count() / 1e6, device)

    # --- data ---------------------------------------------------------------
    data_store = build_data_store(
        n_shards=8,
        tokens_per_shard=max(200_000, args.batch * (args.seq_len + 1) * 16),
        vocab=cfg.vocab_size,
        latency_s=args.s3_latency,
        bandwidth_Bps=args.s3_bandwidth,
    )
    # Checkpoints address their store by URI through the registry; any
    # registered backend works without touching this driver.
    ckpt_uri = args.ckpt_store or (
        f"sims3://ckpt?latency_ms={args.s3_latency * 1e3:g}"
        f"&bw_mbps={args.s3_bandwidth / 1e6:g}"
    )
    ckpt_store = open_store(ckpt_uri)
    write_policy = IOPolicy(write_depth=args.write_depth,
                            blocksize=args.blocksize)

    # --- resume or init ------------------------------------------------------
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    step_cfg = StepConfig(
        microbatches=args.microbatches,
        q_chunk=min(512, args.seq_len),
        loss_chunk=min(512, args.seq_len),
    )
    train_step = build_train_step(model, opt_cfg, step_cfg)

    state = init_train_state(model, args.seed, device=device)
    start_step, cursor = 0, DataCursor()
    restore_s = None
    resume = latest_step(ckpt_store, "ckpt")
    if resume is not None:
        t0 = time.perf_counter()
        # Multi-process mesh: each host prefetch-warms only its
        # rendezvous-owned slice of the checkpoint stream (a peer://
        # ckpt store serves the rest over the LAN). Single process:
        # shard=None, the plain full restore.
        host_id, num_hosts = mesh_host_shard()
        state, manifest = restore_checkpoint(
            ckpt_store, "ckpt", state, device=device,
            shard=(host_id, num_hosts) if num_hosts > 1 else None,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        restore_s = time.perf_counter() - t0
        start_step = manifest["step"]
        cursor = DataCursor.from_dict(manifest["extra"].get("cursor", cursor.to_dict()))
        log.warning("resumed from step %d in %.2fs", start_step, restore_s)

    loader = PrefetchingDataLoader(
        data_store,
        data_store.list_objects("data/"),
        [MemTier(8 << 20)],
        LoaderConfig(
            seq_len=args.seq_len,
            batch_size=args.batch,
            policy=IOPolicy(
                engine=args.mode,
                blocksize=args.blocksize,
                depth=args.prefetch_depth,
                eviction_interval_s=0.2,
                autotune=True,
            ),
        ),
        cursor=cursor,
    )
    ckpt = CheckpointManager(ckpt_store, "ckpt",
                             interval_steps=args.ckpt_interval,
                             policy=write_policy)

    # --- loop ----------------------------------------------------------------
    result = TrainResult(start_step=start_step, restore_s=restore_s)
    metrics_log: list[dict] = []
    clock = StepClock(device)
    feeder = DeviceFeeder(_with_cursor(loader), depth=2, device=device)
    try:
        it = iter(feeder)
        last_cursor = cursor.to_dict()
        last_saved = start_step if resume is not None else None
        t0 = time.time()
        for step in range(start_step, args.steps):
            t_wait = time.perf_counter()
            inputs, labels, last_cursor = next(it)
            result.feeder_wait_s.append(time.perf_counter() - t_wait)
            clock.mark()
            state, metrics = train_step(state, {"inputs": inputs, "labels": labels})
            metrics_log.append(metrics)
            result.tokens += inputs.shape[0] * inputs.shape[1]
            if (step + 1) % args.log_every == 0 or step + 1 == args.steps:
                dt = time.time() - t0
                print(
                    f"step={step + 1} loss={float(metrics['loss']):.4f} "
                    f"grad_norm={float(metrics['grad_norm']):.3f} "
                    f"lr={float(metrics['lr']):.2e} tok/s={result.tokens / dt:.0f}"
                )
            if ckpt.maybe_save(step + 1, state, extra={"cursor": last_cursor}):
                last_saved = step + 1
        clock.mark()
        if last_saved != args.steps:
            ckpt.maybe_save(args.steps, state, force=True, extra={"cursor": last_cursor})
        ckpt.wait()
        result.wall_s = time.time() - t0
    finally:
        feeder.close()
        loader.close()
    result.step_ms = clock.step_ms()
    if metrics_log:
        per_step = {k: torch.stack([m[k] for m in metrics_log]).tolist()
                    for k in ("loss", "grad_norm", "lr")}
        result.losses, result.grad_norms, result.lrs = (
            per_step["loss"], per_step["grad_norm"], per_step["lr"])
    result.fs_stats = loader.fs_stats().snapshot()
    print("loader fs stats:", result.fs_stats)
    print(f"done: {args.steps} steps, {result.tokens} tokens, "
          f"{result.wall_s:.1f}s wall")
    return result


if __name__ == "__main__":
    main()
