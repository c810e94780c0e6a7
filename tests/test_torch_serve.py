"""The port's serving engine and driver on the CPU: the port's engine against
the JAX package's on the same weights and queue, in memory and cold-started
from an object store (`ServeEngine.from_store`), tests/test_serve_engine.py
mirrored against `repro_torch.serve.ServeEngine` (wave batching, early
retirement, batched == single-request decoding), plus the driver with its
store-restore flags."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import serve as jax_serve
from repro.ckpt import manager as jax_ckpt
from repro.configs import get_config as jax_get_config
from repro.io import open_store as jax_open_store
from repro.models import lm as JLM
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.io import open_store
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import serve as serve_main
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.serve import Request, ServeEngine

# The two engines' logits are held to the repo's bf16 tolerance as an absolute
# bound (tests/test_kernels.py); where JAX's top-2 margin exceeds twice that
# bound, no error within it can flip the greedy token, so the tokens must agree.
TOL = 2e-2
MARGIN = 2 * TOL

# (prompt length, max_new_tokens) per request. With max_batch 3 the queue runs
# in three waves: rids 0, 2, 3 (length 8), then 1, 4 (length 12), then 5.
QUEUE = [(8, 5), (12, 4), (8, 3), (8, 6), (12, 2), (8, 4)]
EOS_RID = 2
PROMPT_SEED = 4


def _record_waves(monkeypatch, lm_module):
    """Group the logits an engine computes by wave: the engine makes one
    stack cache per wave, so each `make_stack_cache` call opens a new list."""
    waves: list[list[np.ndarray]] = []
    make_cache = lm_module.make_stack_cache

    def opening(*args, **kwargs):
        waves.append([])
        return make_cache(*args, **kwargs)

    monkeypatch.setattr(lm_module, "make_stack_cache", opening)
    return waves


def _run_jax_engine(monkeypatch, engine, requests):
    """Serve `requests` through an engine of the JAX package; returns its
    results, stats and per-wave logits (prefill, then each decode step)."""
    with monkeypatch.context() as mp:
        waves = _record_waves(mp, JLM)
        to_logits = JLM.logits_from_hidden

        def prefill_logits(*args):
            out = to_logits(*args)
            if not isinstance(out, jax.core.Tracer):   # not the jitted decode
                waves[-1].append(np.asarray(out[:, 0], np.float32))
            return out

        decode = engine._decode

        def decode_logits(*args):
            logits, caches = decode(*args)
            waves[-1].append(np.asarray(logits, np.float32))
            return logits, caches

        mp.setattr(JLM, "logits_from_hidden", prefill_logits)
        engine._decode = decode_logits
        for r in requests:
            engine.submit(r)
        results = engine.run()
    return results, engine.stats, waves


def _run_torch_engine(monkeypatch, engine, requests):
    with monkeypatch.context() as mp:
        waves = _record_waves(mp, LM)
        greedy = engine._greedy

        def recording(logits):
            waves[-1].append(logits.float().numpy().copy())
            return greedy(logits)

        engine._greedy = recording
        for r in requests:
            engine.submit(r)
        results = engine.run()
    return results, engine.stats, waves


def _shared_weights(cfg, seed: int) -> dict:
    """One set of weights for both engines, the same in every process: the
    port's seeded init as nested dicts of numpy arrays. (JAX's init salts each
    leaf's key with the process's string hash, so its weights change from run
    to run, and with them the greedy margins this test relies on.)"""
    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}

    return to_numpy(make_model(cfg).init(seed, device="cpu"))


def _engines(name: str, weights: dict, via_store: bool):
    """The JAX package's engine and the port's on `weights`: built in
    memory, or each cold-started by its own `ServeEngine.from_store` from a
    checkpoint its own package saved to a simulated-S3 store (free link),
    and then holding the weights bit for bit."""
    jmodel = jax_make_model(jax_get_config(name).reduced())
    model = make_model(get_config(name).reduced())
    jparams = jax.tree.map(jnp.asarray, weights)
    params = params_from_numpy(weights, "cpu")
    if not via_store:
        return (jax_serve.ServeEngine(jmodel, jparams, max_batch=3),
                ServeEngine(model, params, max_batch=3, device="cpu"))
    jstore = jax_open_store(f"sims3://serve-{name}?latency_ms=0")
    store = open_store(f"sims3://serve-{name}?latency_ms=0")
    jax_ckpt.save_checkpoint(jstore, "weights", 0, jparams)
    save_checkpoint(store, "weights", 0, params)
    jengine = jax_serve.ServeEngine.from_store(jmodel, jstore, "weights", jparams,
                                               max_batch=3)
    engine = ServeEngine.from_store(model, store, "weights",
                                    params_from_numpy(weights, "meta"),
                                    max_batch=3, device="cpu")
    for got in (jax.tree.map(np.asarray, jengine.params), engine.params):
        np.testing.assert_equal(got, weights)
    return jengine, engine


def _check_engine_matches_jax(monkeypatch, name: str, seed: int = 0,
                              via_store: bool = False) -> None:
    """The port's engine and the JAX package's serve one queue on one set of
    weights, carried to each side from numpy: several waves, mixed prompt
    lengths and budgets, one request that stops at EOS. While a row's greedy
    tokens agree, every step's logits agree within TOL (so both decode at the
    same positions), tokens agree wherever JAX's top-2 margin is clear, and
    the stats agree."""
    jcfg = jax_get_config(name).reduced()
    cfg = get_config(name).reduced()
    jmodel = jax_make_model(jcfg)
    weights = _shared_weights(cfg, seed=seed)
    jparams = jax.tree.map(jnp.asarray, weights)
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n, _ in QUEUE]

    def queue(request_cls, eos=None):
        return [request_cls(rid=i, prompt=prompts[i], max_new_tokens=budget,
                            eos_id=eos if i == EOS_RID else None)
                for i, (_, budget) in enumerate(QUEUE)]

    # EOS: the JAX engine's first token for EOS_RID in the same first wave.
    probe = jax_serve.ServeEngine(jmodel, jparams, max_batch=3)
    for r in queue(jax_serve.Request):
        probe.submit(r)
    eos = int({r.rid: r.tokens[0] for r in probe.run(max_waves=1)}[EOS_RID])

    jengine, engine = _engines(name, weights, via_store)
    jres, jstats, jwaves = _run_jax_engine(monkeypatch, jengine, queue(jax_serve.Request, eos))
    tres, tstats, twaves = _run_torch_engine(monkeypatch, engine, queue(Request, eos))
    first = np.sort(jwaves[0][0][1, : cfg.vocab_size])[-2:]   # EOS_RID is row 1 of wave 1
    assert first[1] - first[0] > MARGIN, "the EOS request's first token must be clear"

    assert [r.rid for r in tres] == [r.rid for r in jres] == [0, 2, 3, 1, 4, 5]
    assert (tstats.waves, tstats.requests, tstats.decode_steps, tstats.generated_tokens) == (
        jstats.waves, jstats.requests, jstats.decode_steps, jstats.generated_tokens)
    assert tstats.waves == 3 and tstats.prefill_tokens == sum(n for n, _ in QUEUE)
    assert [len(w) for w in twaves] == [len(w) for w in jwaves]

    v = cfg.vocab_size
    rows = iter(zip(tres, jres))
    clear = 0
    for jw, tw in zip(jwaves, twaves):
        for i in range(jw[0].shape[0]):
            tr, jr = next(rows)
            assert tr.prompt_len == jr.prompt_len
            agree = True
            for step, (jl, tl) in enumerate(zip(jw, tw)):
                np.testing.assert_allclose(tl[i, :v], jl[i, :v], rtol=0, atol=TOL,
                                           err_msg=f"rid {tr.rid} step {step}")
                top2 = np.sort(jl[i, :v])[-2:]
                if top2[1] - top2[0] > MARGIN:
                    clear += 1
                    assert tl[i, :v].argmax() == jl[i, :v].argmax(), (tr.rid, step)
                if tl[i, :v].argmax() != jl[i, :v].argmax():
                    agree = False      # the rows now decode different tokens
                    break
            if agree:
                np.testing.assert_array_equal(tr.tokens, jr.tokens, err_msg=f"rid {tr.rid}")
    assert clear > 0
    eos_result = next(r for r in tres if r.rid == EOS_RID)
    assert eos_result.tokens.tolist() == [eos]     # retired at its first token


def test_engine_matches_jax_engine(monkeypatch):
    _check_engine_matches_jax(monkeypatch, "smollm-135m")


def test_mamba_engine_matches_jax_engine(monkeypatch):
    """The same queue on reduced mamba2-1.3b: prompts of 8 and 12 tokens are
    padded to one 32-token chunk for the scan, decode continues from the
    scan's final state. Weights seed 5: the EOS request's first token has a
    top-2 margin of 0.274 there (seed 0's is 0.015, below MARGIN)."""
    _check_engine_matches_jax(monkeypatch, "mamba2-1.3b", seed=5)


def test_engine_from_store_matches_jax_engine_from_store(monkeypatch):
    _check_engine_matches_jax(monkeypatch, "smollm-135m", via_store=True)


def test_mamba_engine_from_store_matches_jax_engine_from_store(monkeypatch):
    _check_engine_matches_jax(monkeypatch, "mamba2-1.3b", seed=5, via_store=True)


def _setup(max_batch=4):
    cfg = get_config("smollm-135m").reduced()
    model = make_model(cfg)
    params = model.init(0, device="cpu")
    return cfg, model, params, ServeEngine(model, params, max_batch=max_batch, device="cpu")


def test_batched_matches_single_request():
    """A wave of identical-length requests must produce the same tokens as
    serving each request alone."""
    cfg, model, params, engine = _setup(max_batch=3)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32) for _ in range(3)]
    for i, p in enumerate(prompts):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=6))
    batched = {r.rid: r.tokens for r in engine.run()}

    for i, p in enumerate(prompts):
        solo_engine = ServeEngine(model, params, max_batch=1, device="cpu")
        solo_engine.submit(Request(rid=0, prompt=p, max_new_tokens=6))
        solo = solo_engine.run()[0].tokens
        np.testing.assert_array_equal(batched[i], solo,
                                      err_msg=f"request {i} diverges in batch")


def test_length_bucketing_separates_waves():
    cfg, model, params, engine = _setup(max_batch=8)
    rng = np.random.default_rng(1)
    for i, n in enumerate([8, 8, 12, 8, 12]):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=3))
    results = engine.run()
    assert len(results) == 5
    assert engine.stats.waves == 2  # one 8-length wave, one 12-length wave
    assert engine.stats.requests == 5
    assert engine.stats.prefill_tokens == 3 * 8 + 2 * 12


def test_eos_retires_early():
    cfg, model, params, engine = _setup(max_batch=2)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, 8).astype(np.int32)
    # Find the greedy first token, then use it as EOS for one request.
    probe = ServeEngine(model, params, max_batch=1, device="cpu")
    probe.submit(Request(rid=0, prompt=prompt, max_new_tokens=1))
    first = probe.run()[0].tokens[0]

    engine.submit(Request(rid=0, prompt=prompt, max_new_tokens=10, eos_id=int(first)))
    engine.submit(Request(rid=1, prompt=prompt, max_new_tokens=4))
    results = {r.rid: r for r in engine.run()}
    assert len(results[0].tokens) == 1          # stopped at EOS immediately
    assert len(results[1].tokens) == 4          # ran its full budget


def test_queue_drains_across_waves():
    cfg, model, params, engine = _setup(max_batch=2)
    rng = np.random.default_rng(3)
    for i in range(5):
        engine.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, 8).astype(np.int32), max_new_tokens=2))
    before = fa.launches
    results = engine.run()
    assert fa.launches == before   # CPU tensors take the plain version
    assert len(results) == 5
    assert engine.stats.waves == 3  # 2 + 2 + 1
    assert engine.stats.generated_tokens == sum(len(r.tokens) for r in results)
    assert engine.stats.tokens_per_s() > 0
    assert all(0 <= t < cfg.vocab_size for r in results for t in r.tokens)


def test_driver_runs_on_cpu(capsys):
    serve_main.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "weight restore (rolling): " in out
    assert "prefill:" in out and "tok/s" in out
    assert "decoded 3 tokens x 2 seqs" in out


def test_driver_serves_mamba_on_cpu(capsys):
    before = ssd.launches
    serve_main.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--batch", "2",
                     "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "prefill:" in out and "decoded 3 tokens x 2 seqs" in out
    assert ssd.launches == before   # CPU tensors take the plain version


def test_driver_samples_with_temperature(capsys):
    serve_main.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "3",
                     "--temperature", "0.7", "--seed", "5"])
    assert "decoded 3 tokens x 2 seqs" in capsys.readouterr().out


def _sample_ids(out: str) -> str:
    return next(line for line in out.splitlines() if line.startswith("sample token ids:"))


@pytest.mark.parametrize("flags", [["--restore-mode", "sequential"], ["--autotune"],
                                   ["--cache-dir"]], ids=["sequential", "autotune", "cache-dir"])
def test_driver_restores_through_the_store(capsys, tmp_path, flags):
    """The driver publishes, restores and serves through any restore flag,
    with the tokens of a plain rolling restore; with --cache-dir a second
    run (a restarted replica) restores from the warm disk cache."""
    base = ["--device", "cpu", "--store", "sims3://w?latency_ms=0", "--batch", "2",
            "--prompt-len", "16", "--gen", "8"]
    if flags == ["--cache-dir"]:
        flags = ["--cache-dir", str(tmp_path / "wcache")]
    serve_main.main(base)
    want = _sample_ids(capsys.readouterr().out)
    for _ in range(2 if "--cache-dir" in flags else 1):
        serve_main.main(base + flags)
        out = capsys.readouterr().out
        mode = "sequential" if "sequential" in flags else "rolling"
        assert f"weight restore ({mode}): " in out
        assert ("[cache: " in out) == ("--cache-dir" in flags)
        assert _sample_ids(out) == want
