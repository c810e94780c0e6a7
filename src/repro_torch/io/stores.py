"""URI-addressed object-store registry: ``open_store`` + ``@register_store``.

The producer-side mirror of the reader-engine registry: call sites name a
store by URI instead of hand-constructing backend objects, so new backends
(a real S3 binding, an HTTP gateway, a sharded meta-store) plug in without
touching loader, checkpoint, serving, or benchmark code::

    from repro_torch.io import open_store

    store = open_store("mem://scratch")                 # in-memory bucket
    store = open_store("local:///data/ckpts")           # real directory
    store = open_store("sims3://bucket?latency_ms=40&bw_mbps=200")

``PrefetchFS`` accepts the same URIs directly:
``PrefetchFS("sims3://bucket?latency_ms=40")``.

Built-in schemes:

  * ``mem://name`` — dict-backed `MemStore` (no simulated link cost);
  * ``local://path`` / ``local:///abs/path`` — `DirStore` over a real
    directory;
  * ``sims3://bucket?...`` — `SimS3Store` behind a `LinkModel`. Query
    params (all optional): ``latency_ms``, ``bw_mbps``, ``jitter``,
    ``seed``, ``fail_prob``, plus ``put_latency_ms``/``put_bw_mbps`` for
    an asymmetric upload link.

Opened stores are cached per canonical URI, so two components that name
the same bucket share one instance (a producer's writes are visible to a
consumer opened from the same URI). Pass ``fresh=True`` to bypass the
cache — benchmarks do this so A/B arms never share simulated link state.

New backends register a factory taking the parsed `StoreURI`::

    @register_store("s3")
    def _open_real_s3(uri: StoreURI) -> ObjectStore:
        return RealS3Store(bucket=uri.netloc, **uri.params)
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Mapping
from urllib.parse import parse_qsl, quote, urlsplit

from repro_torch.store.base import ObjectStore
from repro_torch.store.link import LinkModel
from repro_torch.store.local import DirStore, MemStore
from repro_torch.store.sim_s3 import SimS3Store

StoreFactory = Callable[["StoreURI"], ObjectStore]


@dataclass(frozen=True)
class StoreURI:
    """A parsed store address: ``scheme://netloc/path?params``."""

    scheme: str
    netloc: str
    path: str
    params: Mapping[str, str] = field(default_factory=dict)

    @property
    def location(self) -> str:
        """netloc + path joined — the bucket/directory the URI names
        (``local://rel/dir`` -> ``rel/dir``, ``local:///abs`` -> ``/abs``)."""
        return self.netloc + self.path

    def canonical(self) -> str:
        """Injective normal form used as the instance-cache key: scheme is
        already lowercased by the parser, params are sorted AND
        re-percent-encoded. The re-encoding matters: ``parse_qsl``
        decodes escapes, so joining raw values would collapse e.g.
        ``?a=1&b=2`` and ``?a=1%26b%3D2`` (one param whose VALUE is
        "1&b=2") into the same key — two different stores would silently
        share one cached instance (one LinkModel, one state)."""
        query = "&".join(
            f"{quote(k, safe='')}={quote(v, safe='')}"
            for k, v in sorted(self.params.items())
        )
        return f"{self.scheme}://{self.netloc}{self.path}" + (
            f"?{query}" if query else ""
        )

    def float_param(self, key: str, default: float | None = None) -> float | None:
        raw = self.params.get(key)
        if raw is None:
            return default
        try:
            return float(raw)
        except ValueError:
            raise ValueError(
                f"store URI param {key}={raw!r} is not a number"
            ) from None

    def require_known_params(self, known: set[str]) -> None:
        unknown = set(self.params) - known
        if unknown:
            raise ValueError(
                f"unknown store URI params for {self.scheme!r}: "
                f"{', '.join(sorted(unknown))}; known: {', '.join(sorted(known))}"
            )


def parse_store_uri(uri: str) -> StoreURI:
    if "://" not in uri:
        raise ValueError(
            f"not a store URI: {uri!r} (expected scheme://..., e.g. mem://, "
            f"local:///path, sims3://bucket?latency_ms=40)"
        )
    parts = urlsplit(uri)
    if not parts.scheme:
        raise ValueError(f"store URI has no scheme: {uri!r}")
    params = dict(parse_qsl(parts.query, keep_blank_values=True))
    return StoreURI(
        scheme=parts.scheme, netloc=parts.netloc, path=parts.path, params=params
    )


_REGISTRY: dict[str, StoreFactory] = {}
_CACHE: dict[str, ObjectStore] = {}
# Reentrant: composite factories (hsm://) resolve their backing store
# through open_store while the cache lock is held.
_CACHE_LOCK = threading.RLock()


def register_store(scheme: str):
    """Decorator binding a factory ``(StoreURI) -> ObjectStore`` to a URI
    scheme; existing call sites reach the new backend by URI alone."""

    def deco(factory: StoreFactory) -> StoreFactory:
        if scheme in _REGISTRY:
            raise ValueError(f"store scheme {scheme!r} already registered")
        _REGISTRY[scheme] = factory
        return factory

    return deco


def available_stores() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def open_store(target: ObjectStore | str, *, fresh: bool = False) -> ObjectStore:
    """Resolve `target` to an `ObjectStore`.

    An existing store instance passes through untouched; a URI string
    dispatches through the scheme registry. Same canonical URI -> same
    cached instance, unless ``fresh=True`` (always build a new store, and
    leave the cache alone).
    """
    if isinstance(target, ObjectStore):
        return target
    if not isinstance(target, str):
        raise TypeError(
            f"open_store expects an ObjectStore or URI string, got "
            f"{type(target).__name__}"
        )
    uri = parse_store_uri(target)
    try:
        factory = _REGISTRY[uri.scheme]
    except KeyError:
        raise ValueError(
            f"unknown store scheme {uri.scheme!r}; "
            f"available: {', '.join(available_stores())}"
        ) from None
    if fresh:
        return factory(uri)
    key = uri.canonical()
    with _CACHE_LOCK:
        store = _CACHE.get(key)
        if store is None:
            store = _CACHE[key] = factory(uri)
        return store


def clear_store_cache() -> None:
    """Forget cached per-URI instances (tests and benchmark harnesses)."""
    with _CACHE_LOCK:
        _CACHE.clear()


# --------------------------------------------------------------------------- #
# built-in schemes
# --------------------------------------------------------------------------- #
@register_store("mem")
def _open_mem(uri: StoreURI) -> ObjectStore:
    uri.require_known_params(set())
    return MemStore()


@register_store("local")
def _open_local(uri: StoreURI) -> ObjectStore:
    uri.require_known_params(set())
    if not uri.location:
        raise ValueError("local:// URI needs a directory path")
    return DirStore(uri.location)


@register_store("sims3")
def _open_sims3(uri: StoreURI) -> ObjectStore:
    uri.require_known_params(
        {"latency_ms", "bw_mbps", "jitter", "seed", "fail_prob",
         "rps_limit", "rps_burst", "rps_penalty",
         "put_latency_ms", "put_bw_mbps"}
    )
    name = uri.location or "s3"
    rps_limit = uri.float_param("rps_limit")
    rps_burst = uri.float_param("rps_burst")
    rps_penalty = uri.float_param("rps_penalty", 0.0) or 0.0
    link = LinkModel(
        latency_s=(uri.float_param("latency_ms", 0.0) or 0.0) / 1e3,
        bandwidth_Bps=(
            uri.float_param("bw_mbps") * 1e6
            if uri.float_param("bw_mbps") is not None
            else float("inf")
        ),
        jitter=uri.float_param("jitter", 0.0) or 0.0,
        seed=int(uri.float_param("seed", 0) or 0),
        fail_prob=uri.float_param("fail_prob", 0.0) or 0.0,
        rps_limit=rps_limit if rps_limit is not None else float("inf"),
        rps_burst=rps_burst,
        rps_penalty=rps_penalty,
        name=name,
    )
    put_link = None
    if "put_latency_ms" in uri.params or "put_bw_mbps" in uri.params:
        # Jitter/seed/fault-injection/rate-limits apply to BOTH
        # directions (each direction gets its own token bucket); only
        # the latency/bandwidth shape is asymmetric.
        put_link = LinkModel(
            latency_s=(
                uri.float_param("put_latency_ms", link.latency_s * 1e3) or 0.0
            ) / 1e3,
            bandwidth_Bps=(
                uri.float_param("put_bw_mbps") * 1e6
                if uri.float_param("put_bw_mbps") is not None
                else link.bandwidth_Bps
            ),
            jitter=link.jitter,
            seed=link.seed,
            fail_prob=link.fail_prob,
            rps_limit=link.rps_limit,
            rps_burst=link.rps_burst,
            rps_penalty=link.rps_penalty,
            name=f"{name}.put",
        )
    return SimS3Store(link=link, put_link=put_link)


@register_store("hsm")
def _open_hsm(uri: StoreURI) -> ObjectStore:
    """Composite hierarchical-storage-manager store::

        hsm://?mem=64MB&disk=/scratch/cache:1GB&backing=mem://bucket

    Assembles cache tiers (level order mem, disk, shared) + an `HSMIndex`
    around the ``backing`` store; `PrefetchFS` adopts the hierarchy. A
    backing URI carrying its own query string must be percent-encoded
    (``backing=sims3%3A%2F%2Fb%3Flatency_ms%3D40``), since a bare ``&``
    would be read as the next hsm param. See `repro_torch.store.hsm.build_hsm`.
    """
    from repro_torch.store.hsm import build_hsm

    return build_hsm(uri, open_inner=open_store)


@register_store("peer")
def _open_peer(uri: StoreURI) -> ObjectStore:
    """Composite distributed-prefetch store::

        peer://?self=0&peers=0@127.0.0.1:9100,1@127.0.0.1:9101
              &backing=sims3%3A%2F%2Fbucket%3Flatency_ms%3D40

    Routes block reads to their rendezvous-hashed home host before
    touching the backing store; composes with ``hsm://`` via a
    percent-encoded ``backing=`` (the peer layer adopts that hierarchy).
    See `repro_torch.peer.store.build_peer` for the full parameter grammar and
    README "Distributed prefetch" for the protocol.
    """
    from repro_torch.peer.store import build_peer

    return build_peer(uri, open_inner=open_store)
