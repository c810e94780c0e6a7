"""Restart management: resume training from the last committed checkpoint.

Thousand-node contract: any host may die at any step. Recovery =
(1) find the newest committed manifest (atomicity guaranteed by
manifest-last saves), (2) restore params/optimizer (rolling-prefetch
overlapped), (3) restore the data cursor so each host's deterministic
shard plan resumes where it left off, (4) continue. `run_with_restarts`
drives that loop and is exercised by the crash-injection tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.ckpt.manager import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
)
from repro_torch.data.loader import DataCursor
from repro_torch.io import IOPolicy, open_store
from repro_torch.store.base import ObjectStore
from repro_torch.utils import get_logger

log = get_logger("ft.restart")


@dataclass
class RestartManager:
    """`store` may be an `ObjectStore` or a registry URI
    (``"sims3://ckpt?latency_ms=10"``); `write_policy` carries the
    write-behind knobs for periodic snapshot saves.

    ``cache_dir`` points restores at a persistent journaled `DirTier`:
    blocks cached during one restore survive the process, so the NEXT
    restart (the whole point of this manager) restores warm — zero store
    GETs for blocks still on local disk, torn blocks discarded by
    checksum at recovery.

    ``device`` is where restores put the state (the GPU unless the caller
    asks for the CPU)."""

    store: ObjectStore | str
    prefix: str
    ckpt_interval: int = 50
    keep_last: int = 3
    write_policy: IOPolicy | None = None
    cache_dir: str | None = None
    cache_capacity: int | None = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        self.store = open_store(self.store)

    def resume_point(self) -> int | None:
        return latest_step(self.store, self.prefix)

    def restore(self, template, *, policy: IOPolicy | None = None,
                mode: str | None = None):
        """Returns (state, step, cursor) or None if no checkpoint exists.
        ``policy`` selects the restore reader engine (default rolling);
        ``mode`` is the deprecated string spelling."""
        step = self.resume_point()
        if step is None:
            return None
        state, manifest = restore_checkpoint(
            self.store, self.prefix, template, step=step,
            policy=policy, mode=mode,
            cache_dir=self.cache_dir, cache_capacity=self.cache_capacity,
            device=self.device,
        )
        cursor = DataCursor.from_dict(
            manifest["extra"].get("cursor", DataCursor().to_dict())
        )
        log.info("resumed from step %d", step)
        return state, step, cursor

    def manager(self) -> CheckpointManager:
        return CheckpointManager(
            self.store, self.prefix,
            interval_steps=self.ckpt_interval, keep_last=self.keep_last,
            policy=self.write_policy,
        )


@dataclass
class TrainLoopResult:
    final_step: int
    restarts: int
    losses: list = field(default_factory=list)


def run_with_restarts(
    *,
    total_steps: int,
    make_initial_state: Callable[[], object],
    make_loader: Callable[[DataCursor], object],
    train_step: Callable,
    restart_mgr: RestartManager,
    template_fn: Callable[[], object] | None = None,
    max_restarts: int = 10,
    crash_at: set[int] | None = None,
) -> TrainLoopResult:
    """Run `train_step` to `total_steps`, surviving injected crashes.

    `crash_at`: steps at which a simulated failure raises (testing hook);
    each crash abandons in-memory state, then the loop restores from the
    store exactly as a replacement host would.
    """
    crash_at = set(crash_at or ())
    restarts = 0
    losses: list = []

    while True:
        template = (template_fn or make_initial_state)()
        resumed = restart_mgr.restore(template)
        if resumed is None:
            state, step, cursor = make_initial_state(), 0, DataCursor()
        else:
            state, step, cursor = resumed
        loader = make_loader(cursor)
        ckpt = restart_mgr.manager()
        try:
            for inputs, labels in loader.batches():
                if step >= total_steps:
                    break
                if step in crash_at:
                    crash_at.discard(step)
                    raise RuntimeError(f"injected crash at step {step}")
                state, metrics = train_step(state, inputs, labels)
                step += 1
                losses.append(float(metrics["loss"]))
                ckpt.maybe_save(
                    step, state, extra={"cursor": loader.cursor.to_dict()}
                )
            ckpt.maybe_save(step, state, force=True,
                            extra={"cursor": loader.cursor.to_dict()})
            ckpt.wait()
            loader.close()
            return TrainLoopResult(final_step=step, restarts=restarts,
                                   losses=losses)
        except RuntimeError as e:
            loader.close()
            restarts += 1
            log.warning("crash (%s); restart %d", e, restarts)
            if restarts > max_restarts:
                raise
