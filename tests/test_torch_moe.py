"""The port's Mixture-of-Experts layer against the JAX package's, on the CPU.

Both sides get the same seeded numpy inputs and weights. fp32 runs hold
the algorithm (2e-3), bf16 runs the rounding (2e-2), the tolerances of
tests/test_torch_layers.py; the aux loss is held to 1e-6 and gradients,
as the relative L2 error per leaf, to 1e-4 (tests/test_torch_train.py).
The cases cover padded experts, tokens over capacity (the trash slot),
router ties, the capacity rule, the active parameter count and the
combine's order of additions."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import make_model as jax_make_model
from repro.models import moe as JM
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import make_model
from repro_torch.models import moe as M

DTYPES = [(jnp.float32, 2e-3), (jnp.bfloat16, 2e-2)]
DTYPE_IDS = ["fp32", "bf16"]
MOE = ["dbrx-132b", "granite-moe-3b-a800m", "jamba-1.5-large-398b"]
AUX_TOL = 1e-6
GRAD_TOL = 1e-4
S = 16

# Reduced granite (4 experts, top-2, capacity 16 at 16 tokens: nothing
# drops), padded to 8 experts, at a capacity factor that must drop
# (4 experts x 4 slots < 16 tokens x 2 choices), and reduced dbrx and jamba.
CASES = {
    "granite": ("granite-moe-3b-a800m", {}),
    "padded": ("granite-moe-3b-a800m", {"moe_pad_multiple": 8}),
    "overflow": ("granite-moe-3b-a800m", {"moe_capacity_factor": 0.5}),
    "dbrx": ("dbrx-132b", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
}


def _cfgs(name: str, reduced: bool = True, **changes):
    jcfg, cfg = jax_get_config(name), get_config(name)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return dataclasses.replace(jcfg, **changes), dataclasses.replace(cfg, **changes)


def _np_params(cfg, rng) -> dict:
    """Seeded numpy weights for `moe_spec`, scaled like its fan-in init."""
    return {k: (rng.standard_normal(s.shape) * s.init[1] ** -0.5).astype(np.float32)
            for k, s in JM.moe_spec(cfg).items()}


def _inputs(jcfg, seed: int, dtype, b: int = 2, s: int = S, params: dict | None = None):
    """(jax params, torch params, jax x, torch x) from one seed."""
    rng = np.random.default_rng(seed)
    params = _np_params(jcfg, rng) if params is None else params
    x = jnp.asarray(rng.standard_normal((b, s, jcfg.d_model), dtype=np.float32), dtype)
    return ({k: jnp.asarray(v) for k, v in params.items()}, params_from_numpy(params, "cpu"),
            x, tensor_from_numpy(np.asarray(x), "cpu"))


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("case", list(CASES))
def test_moe_matches_jax(case, dtype, tol):
    name, changes = CASES[case]
    jcfg, cfg = _cfgs(name, **changes)
    jp, p, jx, x = _inputs(jcfg, 0, dtype)
    if case == "padded":
        assert (cfg.moe_num_experts, cfg.moe_padded_experts) == (4, 8)
    if case == "overflow":
        assert M.capacity(cfg, S) * cfg.moe_num_experts < S * cfg.moe_top_k
    want_y, want_aux = JM.moe(jp, jcfg, jx)
    y, aux = M.moe(p, cfg, x)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert aux.dtype == torch.float32 and aux.ndim == 0
    _close(y, want_y, tol)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def test_padded_experts_take_no_token():
    """The padding experts' weights do not reach the output: masked to
    -1e30 before the softmax, they never win a top-k place."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", moe_pad_multiple=8)
    _, p, _, x = _inputs(jcfg, 1, jnp.float32)
    y, aux = M.moe(p, cfg, x)
    for leaf in ("w_up", "w_gate", "w_down"):
        p[leaf][cfg.moe_num_experts:] = 1e3
    p["w_router"][:, cfg.moe_num_experts:] = 1e3
    y2, aux2 = M.moe(p, cfg, x)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


@pytest.mark.parametrize("pad", [1, 8], ids=["unpadded", "padded"])
def test_zero_router_picks_the_reference_experts(pad):
    """A zero router ties every real expert: the reference's top_k takes
    the lowest indices, and so must the port. Capacity then decides which
    tokens each of those experts takes."""
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", moe_pad_multiple=pad)
    rng = np.random.default_rng(2)
    params = _np_params(jcfg, rng)
    params["w_router"][:] = 0.0
    jp, p, jx, x = _inputs(jcfg, 2, jnp.float32, params=params)
    want_y, want_aux = JM.moe(jp, jcfg, jx)
    y, aux = M.moe(p, cfg, x)
    _close(y, want_y, 2e-3)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL
    # Every token in experts 0..k-1, each weighted 1/k (nothing drops: 16
    # slots an expert), and expert 0 takes every first choice.
    k, e = cfg.moe_top_k, cfg.moe_padded_experts
    assert M.capacity(cfg, S) >= S
    every = M._experts(p, cfg, x[:, None].expand(-1, e, -1, -1))
    _close(y, (every[:, :k].sum(dim=1) / k).numpy(), 2e-3)
    assert float(aux) == pytest.approx(e / cfg.moe_num_experts, rel=1e-6)


@pytest.mark.parametrize("changes", [{}, {"moe_capacity_factor": 1.0},
                                     {"moe_capacity_factor": 0.5}],
                         ids=["published", "factor1", "factor0.5"])
@pytest.mark.parametrize("name", MOE)
def test_capacity_matches_jax(name, changes):
    jcfg, cfg = _cfgs(name, reduced=False, **changes)
    for tokens in (1, 8, 32, 128, 512):
        assert M.capacity(cfg, tokens) == JM.capacity(jcfg, tokens), tokens


def test_granite_capacities_at_the_serving_shapes():
    cfg = get_config("granite-moe-3b-a800m")
    assert (M.capacity(cfg, 512), M.capacity(cfg, 128), M.capacity(cfg, 1)) == (128, 32, 1)
    assert cfg.moe_padded_experts == 48


@pytest.mark.parametrize("name", MOE)
def test_active_param_count_matches_jax(name):
    jcfg, cfg = _cfgs(name, reduced=False)
    jm, m = jax_make_model(jcfg), make_model(cfg)
    assert m.param_count() == jm.param_count()
    assert m.active_param_count() == jm.active_param_count()
    if name == "granite-moe-3b-a800m":
        assert (m.param_count(), m.active_param_count()) == (3_903_555_072, 1_004_137_574)


def test_active_param_count_of_a_dense_model_is_its_count():
    m = make_model(get_config("smollm-135m"))
    assert m.active_param_count() == m.param_count()


@pytest.mark.parametrize("case", ["granite", "padded", "overflow"])
def test_moe_grads_match_jax(case):
    """Gradients of a weighted sum of the output plus the aux loss, w.r.t.
    every weight and the input, against `jax.grad`."""
    name, changes = CASES[case]
    jcfg, cfg = _cfgs(name, **changes)
    jp, p, jx, x = _inputs(jcfg, 3, jnp.float32)
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jloss(params, xx):
        y, aux = JM.moe(params, jcfg, xx)
        return jnp.sum(y * r) + 10.0 * aux

    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jp, jx)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    xg = x.clone().requires_grad_(True)
    y, aux = M.moe(live, cfg, xg)
    (torch.sum(y * torch.from_numpy(r)) + 10.0 * aux).backward()
    for key, got, want in [*[(k, live[k].grad, want_p[k]) for k in live], ("x", xg.grad, want_x)]:
        want = np.asarray(want)
        err = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert err <= GRAD_TOL, f"{key}: relative L2 error {err:.3e}"


def test_combine_matches_the_reference_scatter_add_bit_for_bit():
    """The reference's bf16 scatter-add (its slot_tok / yflat form) and the
    port's per-token gather, on the same weighted slot outputs: equal bits,
    overflow included."""
    rng = np.random.default_rng(5)
    b, s, k, e, cap, d = 2, 24, 4, 8, 8, 32
    n_slots = e * cap
    slots, slot_toks = [], []
    for _ in range(b):
        flat = np.concatenate([rng.permutation(e)[:k] for _ in range(s)])
        onehot = np.eye(e, dtype=np.int64)[flat]
        pos = (np.cumsum(onehot, 0) * onehot).sum(-1) - 1
        slot = np.where(pos < cap, flat * cap + pos, n_slots)
        st = np.full(n_slots + 1, s)
        st[slot] = np.arange(s * k) // k
        slots.append(slot)
        slot_toks.append(st[:n_slots])
    assert (np.stack(slots) == n_slots).any()     # some choices overflow
    yw = jnp.asarray(rng.standard_normal((b, n_slots, d)).astype(np.float32) * 3, jnp.bfloat16)
    want = jax.vmap(lambda st, yf: jnp.zeros((s + 1, d), yf.dtype).at[st].add(yf))(
        jnp.asarray(np.stack(slot_toks)), yw)[:, :s]
    got = M.combine(tensor_from_numpy(np.asarray(yw), "cpu"),
                    torch.from_numpy(np.stack(slots)).reshape(b, s, k))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_moe_is_deterministic():
    jcfg, cfg = _cfgs("granite-moe-3b-a800m", moe_capacity_factor=0.5)
    _, p, _, x = _inputs(jcfg, 6, jnp.bfloat16)
    y1, aux1 = M.moe(p, cfg, x)
    y2, aux2 = M.moe(p, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
