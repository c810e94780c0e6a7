"""The port's copies of the JAX package's framework-free modules (the
PrefetchFS I/O stack, the store and cache tiers, the fault-injection store,
the peer tier, the prefetch engines, the hashing and timing helpers, the
token and streamline codecs) have not drifted from the reference: after the
``repro.`` -> ``repro_torch.`` rename each source equals the reference's, so
the reference's own tests (tests/test_rolling_prefetch.py,
test_io_facade.py, test_cache_tiers.py, test_write_pipeline.py,
test_integrity.py, test_hsm.py, test_adaptive_read.py, test_resilience.py,
test_peer.py, test_multihost.py, test_codecs_property.py) vouch for the
copies. A short list of modules differs on purpose; the behaviour tests
named beside each take the place of this check."""

from __future__ import annotations

import ast
import difflib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "src", "repro")
PORT = os.path.join(REPO, "src", "repro_torch")

COPIED = [
    "utils/hashing.py", "utils/timing.py",
    "store/base.py", "store/link.py", "store/local.py", "store/sim_s3.py",
    "store/tiers.py", "store/hsm.py",
    "core/plan.py", "core/cost_model.py", "core/autotune.py", "core/rolling.py",
    "core/sequential.py", "core/__init__.py",
    "io/retry.py", "io/integrity.py", "io/policy.py", "io/registry.py",
    "io/reader.py", "io/write.py", "io/engines.py", "io/__init__.py",
    "ckpt/__init__.py",
    # Equal after the rename: it re-exports the copied hashing and timing
    # helpers beside the port's own logging.
    "utils/__init__.py",
    # The token-shard and streamline codecs (numpy only), and the data
    # package's exports of both beside the port's loader.
    "data/tokens.py", "data/trk.py", "data/__init__.py",
    # The fault-injection store and the store package's exports.
    "store/faults.py", "store/__init__.py",
    # The peer tier, and the facade's hooks for it: PrefetchFS adopts a
    # PeerAwareStore's hierarchy, and `peer://` opens one.
    "peer/protocol.py", "peer/client.py", "peer/group.py", "peer/server.py",
    "peer/tier.py", "peer/store.py", "peer/sim.py", "peer/__init__.py",
    "io/fs.py", "io/stores.py",
]

# Modules that differ from the reference, why, and what checks them instead.
DIFFERENT = {
    # Rewritten for torch; trees walk tuples and NamedTuples too
    # (tests/test_torch_ckpt.py, tests/test_torch_restart.py).
    "ckpt/manager.py": "torch",
    # The loader's classes are the reference's (below); the device feeder
    # is rewritten for torch (tests/test_torch_data.py).
    "data/loader.py": "torch DeviceFeeder",
    # RestartManager restores onto its `device` (tests/test_torch_restart.py).
    "ft/restart.py": "restore device",
    # ft/elastic.py (resharding) is part of the sharding slice.
    "ft/__init__.py": "no elastic",
}


def _renamed_reference(rel: str) -> str:
    with open(os.path.join(REF, rel)) as f:
        return re.sub(r"\brepro\.", "repro_torch.", f.read())


def _port(rel: str) -> str:
    with open(os.path.join(PORT, rel)) as f:
        return f.read()


@pytest.mark.parametrize("rel", COPIED)
def test_copy_matches_reference(rel):
    want, got = _renamed_reference(rel), _port(rel)
    diff = "".join(difflib.unified_diff(want.splitlines(True), got.splitlines(True),
                                        f"src/repro/{rel} (renamed)", f"src/repro_torch/{rel}"))
    assert got == want, diff


@pytest.mark.parametrize("rel", sorted(DIFFERENT))
def test_listed_modules_differ_from_reference(rel):
    """Each module on the list exists on both sides and differs, so the list
    holds no module that could be held to the copy check instead."""
    assert _port(rel) != _renamed_reference(rel)


def test_every_copied_module_is_accounted_for():
    """No module of the copied packages is left out of both lists, and the
    module left for a later slice (ft/elastic.py) is absent."""
    listed = set(COPIED) | set(DIFFERENT)
    for pkg in ("io", "core", "store", "ckpt", "data", "ft", "peer"):
        for name in os.listdir(os.path.join(PORT, pkg)):
            if name.endswith(".py"):
                assert f"{pkg}/{name}" in listed, f"{pkg}/{name}"
    for later in ("ft/elastic.py",):
        assert not os.path.exists(os.path.join(PORT, later)), later


def _definitions(source: str) -> dict[str, str]:
    tree = ast.parse(source)
    return {node.name: ast.get_source_segment(source, node) for node in tree.body
            if isinstance(node, (ast.ClassDef, ast.FunctionDef))}


def test_loader_differs_only_by_the_device_feeder():
    """loader.py keeps the reference's LoaderConfig, DataCursor and
    PrefetchingDataLoader, source for source; only DeviceFeeder (and the
    imports it needs) is the port's own."""
    want, got = _definitions(_renamed_reference("data/loader.py")), \
        _definitions(_port("data/loader.py"))
    assert sorted(want) == sorted(got)
    for name in want:
        if name != "DeviceFeeder":
            assert got[name] == want[name], name
    assert got["DeviceFeeder"] != want["DeviceFeeder"]


def test_restart_differs_only_by_the_restore_device():
    """restart.py is the reference with RestartManager's `device` field,
    its docstring, and the restore call passing it on."""
    want = _renamed_reference("ft/restart.py")
    got = _port("ft/restart.py")
    got = got.replace(
        '\n\n    ``device`` is where restores put the state (the GPU unless the caller\n'
        '    asks for the CPU)."""', '"""')
    got = got.replace('    device: str = "cuda"\n', "")
    got = got.replace("            device=self.device,\n", "")
    assert got == want

