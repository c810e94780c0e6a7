"""The sharded forward of the MoE and Mamba configs (dbrx, granite,
mamba2), reduced, on a (4, 2) mesh of 8 gloo ranks under each rules table:
the loss, every leaf's gradient, a prefill and two decode steps equal the
unsharded forward within 1e-4 in fp32 activations. A world of its own, as
the attention-only configs (tests/test_torch_sharded_forward.py) and the
hybrid jamba (tests/test_torch_sharded_forward_hybrid.py) have, so that
each file stays short."""

from __future__ import annotations

import pytest

from test_torch_sharded_forward import TABLES, check_training_scan, check_world, run_world

MIXER_CONFIGS = ["dbrx-132b", "granite-moe-3b-a800m", "mamba2-1.3b"]


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    return run_world(tmp_path_factory, MIXER_CONFIGS)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", MIXER_CONFIGS)
def test_sharded_forward_equals_unsharded(gloo_world, arch, table):
    check_world(gloo_world, arch, table)


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", ["mamba2-1.3b"])
def test_training_scan_runs_on_local_shards(gloo_world, arch, table):
    """The loss and gradients above (held to 1e-4 against unsharded) took
    the training scan rank by rank through `local_map`."""
    check_training_scan(gloo_world, arch, table)
