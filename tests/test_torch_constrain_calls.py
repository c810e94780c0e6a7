"""The port's layout calls against the JAX package's: a spy on both
packages' `constrain` shows that each config's loss, prefill and decode
make the same calls, with the same logical axes, in the same order, under
each rules table. The port runs on ``meta`` stand-ins laid out on a
``fake`` (4, 2) group; the reference is traced by `jax.eval_shape` under
rules on a (4, 2) mesh of one repeated CPU device, its spy recording
without constraining. No reference file changes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.models.encdec as jax_ED
import repro.models.layers as jax_L
import repro.models.lm as jax_LM
import repro.models.moe as jax_M
import repro.models.ssd as jax_S
from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.sharding import rules as jax_rules
from repro_torch.configs import ShapeConfig, all_configs, get_config
from repro_torch.launch.dryrun import start_fake_group
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.launch.specs import input_specs
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import make_model
from repro_torch.models import moe as M
from repro_torch.models import ssd as S
from repro_torch.sharding import rules as port_rules

TABLES = ["TRAIN_RULES", "DECODE_RULES", "DECODE_TP_RULES"]


@pytest.fixture
def fake_group():
    """`start(world)`: this process as rank 0 of a ``fake`` group;
    destroyed at teardown."""
    def start(world: int) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()
        start_fake_group(world)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


PORT_MODULES = (L, LM, M, S, ED)
JAX_MODULES = (jax_L, jax_LM, jax_M, jax_S, jax_ED)
SPY_SHAPES = {"loss": ShapeConfig("t", "train", 32, 8),
              "prefill": ShapeConfig("p", "prefill", 32, 8),
              "decode": ShapeConfig("d", "decode", 32, 8)}


def spy(monkeypatch, modules, real, record: list, passthrough: bool) -> None:
    def fake(x, *axes):
        record.append(tuple(axes))
        return real(x, *axes) if passthrough else x

    for mod in modules:
        monkeypatch.setattr(mod, "constrain", fake)


def port_calls(monkeypatch, arch: str, fn: str, table: str) -> list:
    """The port's `constrain` calls for `fn` on ``meta`` stand-ins laid out
    on a fake (4, 2) mesh."""
    cfg = get_config(arch).reduced()
    model = make_model(cfg)
    mesh = make_mesh_compat((4, 2), ("data", "model"), device_type="cpu")
    rules = port_rules.ShardingRules(mesh, dict(getattr(port_rules, table)))
    shape = SPY_SHAPES[fn]
    record: list = []
    with port_rules.use_rules(rules), torch.no_grad():
        params = model.abstract_params(rules)
        spec = input_specs(model, shape, rules)
        spy(monkeypatch, PORT_MODULES, port_rules.constrain, record, passthrough=True)
        if fn == "loss":
            model.loss(params, spec)
        elif fn == "prefill":
            model.prefill(params, spec)
        else:
            model.decode_step(params, spec["inputs"], spec["caches"], shape.seq_len - 1)
    monkeypatch.undo()
    return record


def jax_calls(monkeypatch, arch: str, fn: str, table: str) -> list:
    """The reference's `constrain` calls for `fn` under the same rules on a
    (4, 2) mesh of one repeated CPU device, traced by `jax.eval_shape` on
    abstract parameters (the spy records and returns its input)."""
    cfg = jax_get_config(arch).reduced()
    model = jax_make_model(cfg)
    devs = np.array(jax.devices()[:1] * 8).reshape(4, 2)
    rules = jax_rules.ShardingRules(jax.sharding.Mesh(devs, ("data", "model")),
                                    dict(getattr(jax_rules, table)))
    params = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          model.abstract_params())
    shape = SPY_SHAPES[fn]
    b, s = shape.global_batch, shape.seq_len
    record: list = []
    ids = jax.ShapeDtypeStruct((b, s), jnp.int32)
    emb = jax.ShapeDtypeStruct((b, s, cfg.d_model), jnp.bfloat16)
    spy(monkeypatch, JAX_MODULES, None, record, passthrough=False)
    with jax_rules.use_rules(rules):
        if fn == "loss":
            batch = (dict(enc_inputs=emb, dec_ids=ids, labels=ids) if cfg.is_encdec else
                     dict(inputs=emb if cfg.embed_inputs else ids, labels=ids))
            jax.eval_shape(model.loss, params, batch)
        elif fn == "prefill":
            batch = (dict(enc_inputs=emb, dec_prompt=jax.ShapeDtypeStruct(
                (b, cfg.dec_prefill_len), jnp.int32)) if cfg.is_encdec
                else dict(inputs=emb if cfg.embed_inputs else ids))
            jax.eval_shape(model.prefill, params, batch)
        else:
            one = (jax.ShapeDtypeStruct((b, 1, cfg.d_model), jnp.bfloat16)
                   if cfg.embed_inputs and not cfg.is_encdec
                   else jax.ShapeDtypeStruct((b, 1), jnp.int32))
            caches = jax.eval_shape(lambda: model.make_decode_caches(b, s, filled=True))
            jax.eval_shape(model.decode_step, params, one, caches,
                           jax.ShapeDtypeStruct((), jnp.int32))
    monkeypatch.undo()
    return record


def parallel_block_order(calls: list) -> list:
    """The reference's calls in the order of the port's parallel block
    (Cohere's), which computes the FFN's hidden state before the attention
    output's product (`models.lm.products_saved_first`): each attention
    output's layout (``residual``) right before an FFN hidden state's
    (``tp``) comes after it."""
    out = list(calls)
    for i in range(len(out) - 1):
        if out[i] == ("batch", None, "residual") and out[i + 1] == ("batch", None, "tp"):
            out[i], out[i + 1] = out[i + 1], out[i]
    return out


@pytest.mark.parametrize("fn", ["loss", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(all_configs()))
def test_constrain_calls_match_reference(monkeypatch, fake_group, arch, fn):
    """Each reduced config (one period, one query chunk, one loss chunk:
    the reference traces each scan body once, the port runs each loop
    once) makes the reference's layout calls, in order, under every
    table; a parallel block's in its own order (`parallel_block_order`)."""
    fake_group(8)
    for table in TABLES:
        want = jax_calls(monkeypatch, arch, fn, table)
        if get_config(arch).parallel_block:
            want = parallel_block_order(want)
        got = port_calls(monkeypatch, arch, fn, table)
        assert want, (arch, fn, table)
        assert got == want, (arch, fn, table)


def test_recompute_in_the_backward_pass_lays_out_as_the_forward(monkeypatch, fake_group):
    """`Model.loss` remats each period: the backward pass recomputes it,
    on the card on autograd's own thread, where the ambient rules (per
    thread) are not set. Run here outside `use_rules`, the recompute must
    make the forward period's layout calls again (head mode included), up
    to its last product, which it need not recompute."""
    fake_group(8)
    cfg = get_config("olmo-1b").reduced()
    model = make_model(cfg)
    mesh = make_mesh_compat((4, 2), ("data", "model"), device_type="cpu")
    rules = port_rules.ShardingRules(mesh, dict(port_rules.TRAIN_RULES))
    record: list = []
    with port_rules.use_rules(rules):
        params = {k: v for k, v in model.abstract_params(rules).items()}
        from repro_torch import tree

        live = tree.map_leaves(lambda t: t.requires_grad_(True), params)
        spec = input_specs(model, SPY_SHAPES["loss"], rules)
        spy(monkeypatch, PORT_MODULES, port_rules.constrain, record, passthrough=True)
        loss = model.loss(live, spec)
    forward = list(record)
    record.clear()
    torch.autograd.grad(loss, tree.flatten(live))
    monkeypatch.undo()
    assert ("batch", None, "heads", None) in forward
    # The period's calls, not lm_hidden's first. The recompute stops once
    # every tensor the backward saved is back: before the period's last
    # product (the MLP's down projection, whose output nothing saves), so
    # without that product's layout call.
    assert forward[-1] == ("batch", None, "residual")
    assert record == forward[1:-1]
