"""The port's copies of the JAX package's framework-free modules (the
PrefetchFS I/O stack, the store and cache tiers, the prefetch engines, the
hashing and timing helpers) have not drifted from the reference: after the
``repro.`` -> ``repro_torch.`` rename each source equals the reference's, so
the reference's own I/O tests (tests/test_rolling_prefetch.py,
test_io_facade.py, test_cache_tiers.py, test_write_pipeline.py,
test_integrity.py, test_hsm.py, test_adaptive_read.py) vouch for the
copies. A short list of modules differs on purpose; the behaviour tests
named beside each take the place of this check."""

from __future__ import annotations

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
]

# Modules that differ from the reference, why, and what checks them instead.
DIFFERENT = {
    # The peer tier is a later slice: no lazy import of PeerAwareStore, the
    # peer store is always None (tests/test_torch_ckpt.py, test_torch_serve.py).
    "io/fs.py": "peer hook",
    # No `peer://` scheme: it raises the unknown-scheme error (below).
    "io/stores.py": "peer scheme",
    # store/faults.py is not copied, so neither are its exports.
    "store/__init__.py": "no faults",
    # Rewritten for torch (tests/test_torch_ckpt.py).
    "ckpt/manager.py": "torch",
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


PEER_STAND_IN = """\
        # A `peer://` composite store (the JAX package's peer tier) is a
        # later slice of the port: no store opened here carries a peer
        # hierarchy, so there is no peer telemetry to fold into stats().
        self._peer_store = None
"""


def test_fs_differs_only_by_the_peer_hook():
    """fs.py is the reference with its lazy peer-store adoption replaced by
    a peer store that is always None."""
    want = _renamed_reference("io/fs.py")
    start = want.index("        # A `peer://` composite store likewise")
    end = want.index("        self.policy = policy if policy is not None else IOPolicy()")
    assert "PeerAwareStore" in want[start:end]
    assert _port("io/fs.py") == want[:start] + PEER_STAND_IN + want[end:]


def test_stores_differs_only_by_the_peer_scheme():
    """stores.py is the reference without its last factory, `peer://`."""
    want = _renamed_reference("io/stores.py")
    cut = want.index('\n\n@register_store("peer")')
    assert want[cut:].count("@register_store") == 1
    assert _port("io/stores.py") == want[:cut] + "\n"


def test_every_copied_module_is_accounted_for():
    """No module of the copied packages is left out of both lists, and the
    modules left for later slices (store/faults.py, the peer tier) are
    absent."""
    listed = set(COPIED) | set(DIFFERENT)
    for pkg in ("io", "core", "store", "ckpt"):
        for name in os.listdir(os.path.join(PORT, pkg)):
            if name.endswith(".py"):
                assert f"{pkg}/{name}" in listed, f"{pkg}/{name}"
    assert not os.path.exists(os.path.join(PORT, "store", "faults.py"))
    assert not os.path.exists(os.path.join(PORT, "peer"))


def test_peer_scheme_is_unknown_to_the_port():
    from repro_torch.io import open_store

    with pytest.raises(ValueError, match="unknown store scheme 'peer'"):
        open_store("peer://?self=0&peers=0@127.0.0.1:9100")
