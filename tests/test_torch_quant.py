"""The port's weight-only int8 quantization (`repro_torch.models.quant`)
against the JAX package's `repro.models.quant`, on the CPU.

Quantization is held bit for bit: the same leaves, the same count for every
registered config, equal int8 ``q`` and fp32 ``scale`` (both sides divide in
fp32 and round half to even). The quantized models run on the reference's
own quantized weights, carried across by `bridge.params_from_numpy`, with
fp32 activations on both sides; those weights are the reference's
quantization of the port's seeded init, the same in every process (the
reference's init salts each leaf with the process's string hash). With
fp32 activations the reference's caches are made fp32 too: its
`make_cache` and `make_mamba_cache` bind bf16 as a default when the module
is imported (a test-side default; no reference file changes). Quantized
checkpoints interchange with the JAX package's byte for byte. The tests of
tests/test_quant.py are mirrored against the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jax_ckpt
from repro.configs import all_configs as jax_all_configs
from repro.configs import get_config as jax_get_config
from repro.io import open_store as jax_open_store
from repro.models import layers as JL
from repro.models import lm as JLM
from repro.models import make_model as jax_make_model
from repro.models import quant as JQ
from repro.models import ssd as JS
from repro.sharding import rules as JR
from repro_torch import tree
from repro_torch.bridge import params_from_numpy
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.io import open_store
from repro_torch.launch import serve as serve_main
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models.quant import (
    QTensor,
    abstract_quantized_params,
    quantize_array,
    quantize_params,
    quantized_bytes,
)
from repro_torch.models.spec import tree_map

CONFIGS = sorted(jax_all_configs())
# The reference's counts for the reduced configs (its `quantize_params` on
# its own init); the full configs give the same.
COUNTS = {"codeqwen1.5-7b": 10, "command-r-plus-104b": 7, "dbrx-132b": 7,
          "granite-moe-3b-a800m": 7, "jamba-1.5-large-398b": 91,
          "llava-next-mistral-7b": 7, "mamba2-1.3b": 9, "olmo-1b": 7, "smollm-135m": 7,
          "whisper-large-v3": 32}
# Quantized stacks, fp32 activations, on the same int8 weights: the sides
# differ only in summation order (tests/test_torch_encdec.py's fp32 limit).
FP32_TOL = 1e-4
_bucket = itertools.count()


def _to_numpy(t: dict) -> dict:
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}


def _weights(cfg, seed: int = 0) -> dict:
    """The port's seeded fp32 init of `cfg` as nested dicts of numpy arrays."""
    return _to_numpy(make_model(cfg).init(seed, device="cpu"))


def _jax_quantized(np_tree: dict):
    """The reference's quantization of a numpy tree: (tree of jax arrays and
    JAX QTensors, count)."""
    return JQ.quantize_params(jax.tree.map(jnp.asarray, np_tree))


def _carried(jq) -> dict:
    """A JAX quantized tree carried into the port through the bridge."""
    return params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _dtype_name(a) -> str:
    if isinstance(a, torch.Tensor):
        return str(a.dtype).removeprefix("torch.")
    return np.dtype(a.dtype).name


def _assert_leaves_equal(port_tree, jax_tree) -> None:
    """The two trees' leaves in `jax.tree_util`'s order: same count, and each
    pair of one dtype and shape, equal bit for bit."""
    got, want = tree.flatten(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _dtype_name(g) == _dtype_name(w), i
        assert tuple(g.shape) == tuple(w.shape), i
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"leaf {i}")


def _port_qpaths(t, path: str = "") -> list[str]:
    if isinstance(t, dict):
        return [p for k in sorted(t) for p in _port_qpaths(t[k], f"{path}[{k!r}]")]
    return [path] if isinstance(t, QTensor) else []


def _jax_qpaths(t) -> list[str]:
    flat = jax.tree_util.tree_flatten_with_path(
        t, is_leaf=lambda x: isinstance(x, JQ.QTensor))[0]
    return [jax.tree_util.keystr(p) for p, x in flat if isinstance(x, JQ.QTensor)]


# --------------------------------------------------------------------------- #
# quantize_array, bit for bit
# --------------------------------------------------------------------------- #
def _array(shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape, dtype=np.float32) * 0.3).astype(np.float32)


def _with_zero_channel(shape, seed: int) -> np.ndarray:
    w = _array(shape, seed)
    w[..., 3] = 0.0      # one all-zero output channel: the reference's scale 1
    return w


def _with_ties(shape, seed: int) -> np.ndarray:
    """Channel 0 holds 127 and values whose quotient by its scale (exactly
    1.0) lies halfway between two integers: round half to even on both
    sides."""
    w = _array(shape, seed)
    col = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5], np.float32)
    w[: len(col), 0] = col
    w[len(col):, 0] = 0.0
    return w


ARRAYS = {
    "2d": lambda: _array((64, 32), 1),
    "2d_zero_channel": lambda: _with_zero_channel((48, 16), 2),
    "2d_ties": lambda: _with_ties((16, 8), 3),
    "3d_zero_channel": lambda: _with_zero_channel((3, 64, 48), 4),
    "4d": lambda: _array((2, 4, 16, 24), 5),
    "4d_zero_channel": lambda: _with_zero_channel((2, 3, 8, 8), 6),
}


@pytest.mark.parametrize("kind", sorted(ARRAYS))
def test_quantize_array_matches_jax_bit_for_bit(kind):
    w = ARRAYS[kind]()
    want = JQ.quantize_array(jnp.asarray(w))
    got = quantize_array(torch.from_numpy(w))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert tuple(got.scale.shape) == want.scale.shape
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale))
    np.testing.assert_array_equal(w, ARRAYS[kind]())     # the input is untouched


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kind", ["2d_ties", "3d_zero_channel", "4d"])
def test_dequantize_matches_jax_astype_bit_for_bit(kind, dtype):
    """`QTensor.to` (``q * scale``, one promotion) equals the reference's
    ``(q.astype(f32) * scale).astype(dtype)``."""
    w = ARRAYS[kind]()
    want = JQ.quantize_array(jnp.asarray(w)).astype(getattr(jnp, dtype))
    got = quantize_array(torch.from_numpy(w)).to(getattr(torch, dtype))
    assert _dtype_name(got) == dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_quantize_array_of_a_bf16_weight_matches_jax():
    """A bf16 weight is quantized from its fp32 value, as the reference's
    ``astype(float32)`` does."""
    w = _array((32, 16), 7)
    wj = jnp.asarray(w, jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    want, got = JQ.quantize_array(wj), quantize_array(wt)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale))


# --------------------------------------------------------------------------- #
# quantize_params: the same leaves and counts as the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", CONFIGS)
def test_reduced_config_quantizes_the_references_leaves(name):
    """Every registered config, reduced, on one set of weights: the same
    quantized paths, the same count (pinned), and every leaf bit for bit."""
    np_w = _weights(get_config(name).reduced())
    jq, jn = _jax_quantized(np_w)
    tq, n = quantize_params(params_from_numpy(np_w, "cpu"))
    assert n == jn == COUNTS[name]
    assert _port_qpaths(tq) == _jax_qpaths(jq)
    _assert_leaves_equal(tq, jq)


@pytest.mark.parametrize("name", CONFIGS)
def test_full_config_count_matches_jax(name):
    """At full width and depth, on `meta` tensors (no memory): the port's
    `quantize_params` and `abstract_quantized_params` quantize the leaves
    the reference's `abstract_quantized_params` does."""
    spec = make_model(get_config(name)).spec()
    meta = tree_map(lambda s: torch.empty(s.shape, device="meta"), spec)
    tq, n = quantize_params(meta)
    abstract = JQ.abstract_quantized_params(jax_make_model(jax_get_config(name)).spec(), None)
    assert n == len(_jax_qpaths(abstract)) == COUNTS[name]
    assert _port_qpaths(tq) == _port_qpaths(abstract_quantized_params(spec)) \
        == _jax_qpaths(abstract)


def test_codeqwen_full_quantized_elements():
    """codeqwen1.5-7b at full size, from its spec: 8,190,038,016 parameters,
    7,432,699,904 of them quantized; the tree of int8 weights, fp32 scales
    and the unquantized leaves in fp32 (embedding and head) is 10.47 GB."""
    model = make_model(get_config("codeqwen1.5-7b"))
    meta = tree_map(lambda s: torch.empty(s.shape, device="meta"), model.spec())
    tq, n = quantize_params(meta)
    q_elems = sum(x.q.numel() for x in jax.tree_util.tree_leaves(
        tq, is_leaf=lambda x: isinstance(x, QTensor)) if isinstance(x, QTensor))
    assert (model.param_count(), n, q_elems) == (8_190_038_016, 10, 7_432_699_904)
    assert quantized_bytes(tq) == 10_466_639_872


# --------------------------------------------------------------------------- #
# Quantized models against the reference
# --------------------------------------------------------------------------- #
@pytest.fixture
def fp32_activations(monkeypatch):
    """Both packages' activations in fp32, and the reference's caches too."""
    monkeypatch.setattr(JL, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(L, "COMPUTE_DTYPE", torch.float32)
    monkeypatch.setattr(JL.make_cache, "__defaults__", (jnp.float32, 0))
    monkeypatch.setattr(JS.make_mamba_cache, "__defaults__", (jnp.float32,))


def _close(got: torch.Tensor, want, err_msg: str) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=FP32_TOL, atol=FP32_TOL, err_msg=err_msg)


@pytest.mark.parametrize("name", ["codeqwen1.5-7b", "granite-moe-3b-a800m", "mamba2-1.3b"])
def test_quantized_prefill_and_decode_match_jax(name, fp32_activations):
    """Reduced configs on the reference's int8 weights: prefill logits, then
    4 greedy decode steps (the reference's tokens fed to both), within
    FP32_TOL. codeqwen's attention (QKV biases quantized too) goes through
    the flash entry, mamba2's through the scan entry, granite's experts
    through the quantized `bmm`s."""
    jcfg, cfg = jax_get_config(name).reduced(), get_config(name).reduced()
    jq, _ = _jax_quantized(_weights(cfg, seed=1))
    tq = _carried(jq)
    b, s, steps, v = 2, 16, 4, cfg.vocab_size
    ids = np.random.default_rng(1).integers(0, v, (b, s))
    jl, jc = JLM.lm_prefill(jq, jcfg, jnp.asarray(ids, jnp.int32), max_len=s + steps)
    tl, tc = LM.lm_prefill(tq, cfg, torch.from_numpy(ids), max_len=s + steps)
    _close(tl[:, :v], np.asarray(jl)[:, :v], "prefill logits")
    for t in range(s, s + steps):
        tok = np.asarray(jl)[:, :v].argmax(-1)[:, None]
        jl, jc = JLM.lm_decode_step(jq, jcfg, jnp.asarray(tok, jnp.int32), jc, t)
        tl, tc = LM.lm_decode_step(tq, cfg, torch.from_numpy(tok), tc, t)
        _close(tl[:, :v], np.asarray(jl)[:, :v], f"decode step {t}")


def test_quantized_whisper_serves_like_its_dequantized_copy():
    """Reduced whisper-large-v3 with 2 encoder and 2 decoder periods: its
    2-D stacked biases (``bo``, ``b_up``, ``b_down``, (periods, d)) keep one
    scale for all periods, which `QTensor.unbind` shares out. Prefill and
    decode on the int8 tree equal, bit for bit, the same run on the fp32
    tree its leaves dequantize to."""
    from repro_torch.models import encdec as ED

    cfg = dataclasses.replace(get_config("whisper-large-v3").reduced(),
                              num_layers=2, enc_layers=2)
    tq, n = quantize_params(make_model(cfg).init(2, device="cpu"))
    bo = tq["layers"]["block0"]["attn"]["bo"]
    assert n == 32 and bo.shape == (2, cfg.d_model) and bo.scale.shape == (1, cfg.d_model)
    deq = _dequantized(tq)
    rng = np.random.default_rng(2)
    enc = torch.from_numpy(rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32))
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12)))
    outs = []
    for params in (tq, deq):
        logits, caches = ED.encdec_prefill(params, cfg, enc.to(torch.bfloat16), ids[:, :8],
                                           max_len=12)
        got = [logits]
        for t in range(8, 12):
            logits, caches = ED.encdec_decode_step(params, cfg, ids[:, t:t + 1], caches, t)
            got.append(logits)
        outs.append(torch.stack(got))
    assert torch.equal(outs[0], outs[1])


def _dequantized(t):
    """`t` with every QTensor replaced by its fp32 dequantization."""
    if isinstance(t, dict):
        return {k: _dequantized(v) for k, v in t.items()}
    return t.to(torch.float32) if isinstance(t, QTensor) else t


def test_unbind_views_dequantize_like_the_stack():
    """Each period's view dequantizes to that period's rows of the whole
    stacked leaf, with a per-period scale (>= 3-D) and with one scale
    shared across periods (2-D)."""
    for shape in [(3, 8, 5), (3, 7)]:
        qt = quantize_array(torch.from_numpy(_array(shape, 8)))
        whole = qt.to(torch.float32)
        parts = qt.unbind(0)
        assert len(parts) == 3 and all(isinstance(p, QTensor) for p in parts)
        for i, p in enumerate(parts):
            assert p.shape == shape[1:] and p.ndim == len(shape) - 1
            assert torch.equal(p.to(torch.float32), whole[i])
    with pytest.raises(ValueError, match="axis 0"):
        qt.unbind(1)


# --------------------------------------------------------------------------- #
# Trees and checkpoints
# --------------------------------------------------------------------------- #
def _codeqwen_quantized():
    """Reduced codeqwen1.5-7b quantized by the reference and carried over:
    (JAX tree, port tree)."""
    jq, _ = _jax_quantized(_weights(get_config("codeqwen1.5-7b").reduced(), seed=3))
    return jq, _carried(jq)


def test_flatten_order_matches_jax_tree_util_on_a_quantized_tree():
    """`tree.flatten` gives a QTensor's (q, scale) in place of the leaf, in
    `jax.tree_util`'s order, and `unflatten` rebuilds the QTensors."""
    jq, tq = _codeqwen_quantized()
    _assert_leaves_equal(tq, jq)
    again = tree.unflatten(tq, iter(tree.flatten(tq)))
    assert _port_qpaths(again) == _port_qpaths(tq)
    doubled = tree.map_leaves(lambda t: t.clone(), tq)
    assert isinstance(doubled["layers"]["block0"]["attn"]["wq"], QTensor)
    _assert_leaves_equal(doubled, jq)


def test_abstract_tree_matches_the_concrete_tree_and_jax():
    """The `meta` abstract tree has the concrete tree's leaves (shape; the
    int8 and fp32 dtypes of q and scale, bf16 elsewhere as the reference's
    dry-run stand-ins) and the reference's abstract tree's."""
    name = "codeqwen1.5-7b"
    model = make_model(get_config(name).reduced())
    tq, _ = quantize_params(model.init(0, device="cpu", param_dtype=torch.bfloat16))
    abstract = abstract_quantized_params(model.spec(), None)
    want = JQ.abstract_quantized_params(
        jax_make_model(jax_get_config(name).reduced()).spec(), None)
    a_leaves, c_leaves = tree.flatten(abstract), tree.flatten(tq)
    w_leaves = jax.tree_util.tree_leaves(want)
    assert len(a_leaves) == len(c_leaves) == len(w_leaves)
    for a, c, w in zip(a_leaves, c_leaves, w_leaves):
        assert a.device.type == "meta"
        assert a.shape == c.shape and a.dtype == c.dtype
        assert tuple(a.shape) == w.shape and _dtype_name(a) == _dtype_name(w)


def test_abstract_tree_with_rules_waits_for_the_mesh_tooling():
    """The mesh tooling has come: rules without a mesh give the unsharded
    tree, and rules over a (2, 2) mesh (a ``fake`` process group, no data
    moved) shard it as the reference does. tests/test_torch_sharding.py
    holds every config at full size against the reference."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.sharding.rules import DECODE_TP_RULES, ShardingRules

    name = "smollm-135m"
    spec = make_model(get_config(name).reduced()).spec()
    plain = tree.flatten(abstract_quantized_params(spec))
    no_mesh = tree.flatten(abstract_quantized_params(spec, ShardingRules(None)))
    assert [(t.shape, t.dtype, type(t)) for t in plain] == \
        [(t.shape, t.dtype, type(t)) for t in no_mesh]
    devs = np.array(jax.devices()[:1] * 4).reshape(2, 2)
    jrules = JR.ShardingRules(jax.sharding.Mesh(devs, ("data", "model")),
                              dict(JR.DECODE_TP_RULES))
    want = jax.tree_util.tree_leaves(JQ.abstract_quantized_params(
        jax_make_model(jax_get_config(name).reduced()).spec(), jrules))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        rules = ShardingRules(make_debug_mesh(2, 2, device_type="cpu"), dict(DECODE_TP_RULES))
        got = tree.flatten(abstract_quantized_params(spec, rules))
    finally:
        dist.destroy_process_group()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and _dtype_name(g) == _dtype_name(w)
        assert tuple(g.to_local().shape) == w.sharding.shard_shape(w.shape)


def _uri(tag: str) -> str:
    return f"sims3://quant{tag}{next(_bucket)}?latency_ms=0"


def test_jax_saved_quantized_checkpoint_restores_into_port():
    jq, _ = _codeqwen_quantized()
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    jax_ckpt.save_checkpoint(jstore, "ckpt", 2, jq)
    for meta in jstore.backing.list_objects(""):
        store.backing.put(meta.key, jstore.backing.get(meta.key))
    template = abstract_quantized_params(
        make_model(get_config("codeqwen1.5-7b").reduced()).spec())
    restored, manifest = restore_checkpoint(store, "ckpt", template, device="cpu")
    assert manifest["step"] == 2
    assert isinstance(restored["layers"]["block0"]["ffn"]["w_up"], QTensor)
    _assert_leaves_equal(restored, jq)


def test_port_saved_quantized_checkpoint_restores_into_jax():
    jq, tq = _codeqwen_quantized()
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    save_checkpoint(store, "ckpt", 2, tq)
    for meta in store.backing.list_objects(""):
        jstore.backing.put(meta.key, store.backing.get(meta.key))
    template = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), jq)
    restored, manifest = jax_ckpt.restore_checkpoint(jstore, "ckpt", template)
    assert manifest["step"] == 2
    assert isinstance(restored["layers"]["block0"]["ffn"]["w_up"], JQ.QTensor)
    _assert_leaves_equal(tq, restored)


def test_both_sides_store_identical_quantized_objects():
    """The same quantized weights saved by each package: byte-identical leaf
    objects, and manifests equal apart from the save time."""
    jq, tq = _codeqwen_quantized()
    jstore, store = jax_open_store(_uri("j")), open_store(_uri("t"))
    jman = jax_ckpt.save_checkpoint(jstore, "ckpt", 4, jq)
    tman = save_checkpoint(store, "ckpt", 4, tq)
    keys = sorted(m.key for m in jstore.backing.list_objects(""))
    assert keys == sorted(m.key for m in store.backing.list_objects(""))
    for key in keys:
        jb, tb = jstore.backing.get(key), store.backing.get(key)
        if key.endswith("MANIFEST.json"):
            jb, tb = json.loads(jb), json.loads(tb)
            jb.pop("saved_unix_time"), tb.pop("saved_unix_time")
        assert jb == tb, key
    jman.pop("saved_unix_time"), tman.pop("saved_unix_time")
    assert jman == tman
    # 10 QTensors of two leaves; two tables and three norm scales.
    assert len(tman["leaves"]) == len(tree.flatten(tq)) == 2 * 10 + 5


# --------------------------------------------------------------------------- #
# tests/test_quant.py, mirrored
# --------------------------------------------------------------------------- #
def test_quantize_roundtrip_error_bounded():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 32), dtype=np.float32))
    qt = quantize_array(w)
    assert qt.q.dtype == torch.int8
    deq = qt.to(torch.float32)
    # Per-channel symmetric int8: error <= scale/2 per element.
    err = (deq - w).abs()
    bound = w.abs().amax(dim=0, keepdim=True) / 127.0
    assert bool((err <= bound * 0.51 + 1e-7).all())


def test_norms_and_embeddings_stay_unquantized():
    model = make_model(get_config("smollm-135m").reduced())
    qparams, n = quantize_params(model.init(0, device="cpu", param_dtype=torch.bfloat16))
    assert n > 0
    assert not isinstance(qparams["embed"]["table"], QTensor)
    assert not isinstance(qparams["final_norm"]["scale"], QTensor)
    assert isinstance(qparams["layers"]["block0"]["attn"]["wq"], QTensor)


def test_quantized_decode_close_to_bf16():
    """Decode logits with int8 weights track the bf16 logits within the
    reference's limit: max |diff| over the logit range below 0.35."""
    cfg = get_config("olmo-1b").reduced()
    model = make_model(cfg)
    params = model.init(0, device="cpu", param_dtype=torch.bfloat16)
    qparams, _ = quantize_params(params)
    b, s = 2, 16
    caches = model.make_decode_caches(b, s, filled=True, device="cpu")
    qcaches = model.make_decode_caches(b, s, filled=True, device="cpu")
    ids = torch.ones((b, 1), dtype=torch.long)
    logits, _ = model.decode_step(params, ids, caches, s - 1)
    qlogits, _ = model.decode_step(qparams, ids, qcaches, s - 1)
    a, qa = logits[:, : cfg.vocab_size].float(), qlogits[:, : cfg.vocab_size].float()
    scale = a.abs().max() + 1e-6
    assert float((a - qa).abs().max() / scale) < 0.35


def test_quantized_bytes_halve_vs_bf16():
    """Block weights drop to about half their bf16 footprint."""
    model = make_model(get_config("olmo-1b").reduced())
    params = model.init(0, device="cpu", param_dtype=torch.bfloat16)
    qparams, _ = quantize_params(params)
    assert quantized_bytes(qparams["layers"]) < 0.62 * quantized_bytes(params["layers"])


# --------------------------------------------------------------------------- #
# The driver
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["codeqwen1.5-7b", "mamba2-1.3b", "whisper-large-v3"])
def test_driver_quant_int8_prints_the_references_count(name, capsys):
    out = serve_main.main(["--device", "cpu", "--arch", name, "--quant", "int8",
                           "--store", _uri("drv"), "--batch", "2", "--prompt-len", "16",
                           "--gen", "4"])
    text = capsys.readouterr().out
    assert f"quantized {COUNTS[name]} weight tensors to int8 (weight-only)" in text
    assert text.index("weight restore") < text.index("quantized") < text.index("prefill")
    assert out.shape == (2, 4) and out.min() >= 0 and out.max() < get_config(name).vocab_size


def test_driver_without_quant_quantizes_nothing(capsys):
    serve_main.main(["--device", "cpu", "--arch", "codeqwen1.5-7b", "--store", _uri("drv"),
                     "--batch", "1", "--prompt-len", "8", "--gen", "2"])
    assert "quantized" not in capsys.readouterr().out

