"""End-to-end LM training on the GPU with the full production substrate,
including a mid-run simulated crash and automatic resume (the PyTorch
counterpart of examples/train_lm_e2e.py):

  object store -> Rolling Prefetch loader -> device copy -> train step
  -> async checkpoints -> (crash) -> restore + data-cursor resume -> finish

  PYTHONPATH=src python examples/torch/train_lm_e2e.py [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import LoaderConfig, PrefetchingDataLoader, synth_token_shard
from repro_torch.ft import RestartManager, run_with_restarts
from repro_torch.io import IOPolicy, open_store
from repro_torch.models import make_model
from repro_torch.store import MemTier
from repro_torch.train import AdamWConfig, StepConfig, build_train_step, init_train_state


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--seed", type=int, default=0, help="data and parameter init seed")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def train(args: argparse.Namespace):
    """Train through one injected crash; returns the `TrainLoopResult`."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to run on the host)")

    cfg = get_config(args.arch).reduced()
    model = make_model(cfg)
    print(f"training {cfg.name}: {model.param_count() / 1e3:.0f}k params, "
          f"{args.steps} steps on {device}, crash injected at step {args.steps // 2}")

    rng = np.random.default_rng(args.seed)
    data_store = open_store("sims3://data?latency_ms=5&bw_mbps=60", fresh=True)
    for i in range(6):
        data_store.backing.put(
            f"tok{i}.bin", synth_token_shard(rng, 400_000, cfg.vocab_size)
        )
    ckpt_store = open_store("sims3://ckpt?latency_ms=5&bw_mbps=60", fresh=True)

    opt = AdamWConfig(lr=1e-3, total_steps=args.steps,
                      warmup_steps=args.steps // 10)
    step = build_train_step(
        model, opt, StepConfig(q_chunk=min(512, args.seq_len),
                               loss_chunk=min(512, args.seq_len))
    )

    def train_step(state, inputs, labels):
        return step(state, {"inputs": torch.from_numpy(inputs).to(device),
                            "labels": torch.from_numpy(labels).to(device)})

    def make_loader(cursor):
        return PrefetchingDataLoader(
            data_store, data_store.backing.list_objects(),
            [MemTier(8 << 20)],
            LoaderConfig(seq_len=args.seq_len, batch_size=args.batch,
                         policy=IOPolicy(engine="rolling",
                                         blocksize=256 << 10,
                                         eviction_interval_s=0.2)),
            cursor=cursor,
        )

    mgr = RestartManager(ckpt_store, "e2e", ckpt_interval=20,
                         write_policy=IOPolicy(write_depth=4,
                                               blocksize=256 << 10),
                         device=str(device))
    return run_with_restarts(
        total_steps=args.steps,
        make_initial_state=lambda: init_train_state(model, args.seed, device=device),
        make_loader=make_loader,
        train_step=train_step,
        restart_mgr=mgr,
        crash_at={args.steps // 2},
    )


def main(argv: list[str] | None = None):
    args = parse_args(argv)
    result = train(args)
    first, last = result.losses[0], result.losses[-1]
    print(f"finished: {result.final_step} steps, {result.restarts} restart(s)")
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'no improvement'})")
    assert result.restarts == 1 and result.final_step == args.steps
    assert last < first, "loss should decrease over training"
    print("OK: crash survived, training converged through the restart")
    return result


if __name__ == "__main__":
    main()
