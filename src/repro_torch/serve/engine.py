"""Batched serving engine: request queue -> padded-batch prefill -> masked
decode waves with early retirement. The port of the JAX package's
``serve/engine.py``.

Each wave admits up to `max_batch` queued requests of the SAME prompt
length (length-bucketed: padding would let real tokens attend to garbage),
prefills them together (on the card, attention layers through the flash
kernel and Mamba layers through the SSD scan kernel), then decodes step by
step. Finished sequences (EOS or their own token budget) are masked out;
the wave retires when every member finishes, and the queue refills the
next wave. Greedy argmax and retirement run on the host, from one copy of
the logits per step. `ServeEngine.from_store` cold-starts an engine from
checkpointed weights streamed through Rolling Prefetch: serving cold-start
is the paper's sequential-object-stream case.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.ckpt.manager import restore_checkpoint
from repro_torch.io import IOPolicy
from repro_torch.models import lm as LM
from repro_torch.models.api import Model
from repro_torch.utils import get_logger

log = get_logger("serve.engine")


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (prompt_len,) int32 token ids
    max_new_tokens: int
    eos_id: int | None = None


@dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray          # generated ids (<= max_new_tokens)
    prompt_len: int
    latency_s: float


@dataclass
class ServeStats:
    waves: int = 0
    requests: int = 0
    prefill_tokens: int = 0
    generated_tokens: int = 0
    decode_steps: int = 0
    prefill_s: float = 0.0      # host clock, prefill through its first argmax
    decode_s: float = 0.0       # host clock, decode steps through their argmax
    wall_s: float = 0.0

    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 pad_id: int = 0, device="cuda") -> None:
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.pad_id = pad_id
        self.device = torch.device(device)
        self.queue: list[Request] = []
        self.stats = ServeStats()

    @classmethod
    def from_store(cls, model: Model, store, prefix: str, template, *,
                   policy=None, step: int | None = None, max_batch: int = 8,
                   pad_id: int = 0, device="cuda") -> "ServeEngine":
        """Cold-start an engine on `device` from checkpointed weights in an
        object store, streamed through the `PrefetchFS` facade: pass
        ``policy=IOPolicy(engine="rolling", depth=...)`` to overlap leaf
        fetches with the host-to-device copies (serving cold-start is the
        paper's sequential multi-object stream). `template` gives the
        tree's structure (tensors or ``meta`` tensors)."""
        # Serving cold-start is the latency-critical restore class: under
        # an HSM hierarchy its blocks admit into (and are protected in)
        # the top tier, so a concurrent bulk scan cannot flush the weights
        # a replica re-reads on every restart.
        if policy is None:
            # Mirrors restore_checkpoint's own default policy, plus the
            # serve class.
            policy = IOPolicy(engine="rolling", blocksize=8 << 20, depth=2,
                              eviction_interval_s=0.2, io_class="serve")
        elif policy.io_class == "default":
            policy = policy.replace(io_class="serve")
        params, _ = restore_checkpoint(store, prefix, template, step=step,
                                       policy=policy, device=device)
        return cls(model, params, max_batch=max_batch, pad_id=pad_id, device=device)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    # ------------------------------------------------------------------ #
    def _admit_wave(self) -> list[Request]:
        """Length-bucketed admission: the oldest request sets the wave's
        prompt length; other same-length requests join up to max_batch."""
        if not self.queue:
            return []
        want = len(self.queue[0].prompt)
        wave, rest = [], []
        for r in self.queue:
            if len(r.prompt) == want and len(wave) < self.max_batch:
                wave.append(r)
            else:
                rest.append(r)
        self.queue = rest
        return wave

    def _greedy(self, logits: torch.Tensor) -> np.ndarray:
        """Argmax over the real vocab, on the host."""
        return logits[:, : self.model.cfg.vocab_size].cpu().numpy().argmax(axis=-1)

    def run(self, max_waves: int | None = None) -> list[RequestResult]:
        """Drain the queue; returns per-request results."""
        results: list[RequestResult] = []
        cfg = self.model.cfg
        t_start = time.perf_counter()
        while self.queue and (max_waves is None or self.stats.waves < max_waves):
            wave = self._admit_wave()
            t_wave = time.perf_counter()
            batch_ids = np.stack([r.prompt for r in wave]).astype(np.int64)
            b, s = batch_ids.shape
            budget = max(r.max_new_tokens for r in wave)

            # Prefill with decode headroom.
            caches = LM.make_stack_cache(cfg, b, s + budget, device=self.device)
            h, caches = LM.lm_hidden(
                self.params, cfg, torch.from_numpy(batch_ids).to(self.device),
                caches=caches, update_cache=True, q_chunk=min(512, s),
            )
            tok = self._greedy(LM.logits_from_hidden(self.params, cfg, h[:, -1:, :])[:, 0])
            t_decode = time.perf_counter()
            self.stats.prefill_s += t_decode - t_wave
            self.stats.prefill_tokens += b * s

            generated = np.full((b, budget), -1, np.int64)
            done = np.zeros(b, bool)
            for i, r in enumerate(wave):
                generated[i, 0] = tok[i]
                if (r.eos_id is not None and tok[i] == r.eos_id) or \
                        r.max_new_tokens <= 1:
                    done[i] = True

            step = 1
            while not done.all() and step < budget:
                ids = torch.from_numpy(tok[:, None].astype(np.int64)).to(self.device)
                logits_t, caches = self.model.decode_step(
                    self.params, ids, caches, s + step - 1)
                self.stats.decode_steps += 1
                tok = self._greedy(logits_t)
                for i, r in enumerate(wave):
                    if done[i]:
                        continue
                    generated[i, step] = tok[i]
                    if (r.eos_id is not None and tok[i] == r.eos_id) or \
                            step + 1 >= r.max_new_tokens:
                        done[i] = True
                step += 1
            self.stats.decode_s += time.perf_counter() - t_decode

            latency = time.perf_counter() - t_wave
            for i, r in enumerate(wave):
                toks = generated[i][generated[i] >= 0]
                results.append(RequestResult(
                    rid=r.rid, tokens=toks, prompt_len=s, latency_s=latency,
                ))
                self.stats.generated_tokens += len(toks)
            self.stats.waves += 1
            self.stats.requests += len(wave)
            log.info("wave %d: %d requests, prompt %d, %d steps",
                     self.stats.waves, b, s, step)
        self.stats.wall_s = time.perf_counter() - t_start
        return results
