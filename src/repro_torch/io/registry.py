"""Reader-engine registry: new engines plug in without touching call sites.

An engine is a factory ``(store, files, tiers, policy) -> Reader`` bound to
a name with ``@register_reader("name")``. `PrefetchFS` dispatches
``IOPolicy.engine`` through this table, so a real-S3, async, or sharded
engine lands by registering itself — loader, checkpoint restore, serving,
and benchmarks pick it up through the same `fs.open` they already call.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

# Factory signature: (store, files, tiers, policy) -> Reader
ReaderFactory = Callable[..., object]


@dataclass(frozen=True)
class EngineSpec:
    name: str
    factory: ReaderFactory
    needs_tiers: bool = False   # whether the FS must supply cache tiers
    accepts_tuner: bool = False  # factory takes a tuner= kwarg (closed loop)
    accepts_index: bool = False  # factory takes an index= kwarg (shared cache)


_REGISTRY: dict[str, EngineSpec] = {}


def register_reader(name: str, *, needs_tiers: bool = False,
                    accepts_tuner: bool = False,
                    accepts_index: bool = False):
    """Class/function decorator registering a reader engine factory.

    ``accepts_tuner`` engines receive the filesystem's `BlockSizeTuner`
    as a ``tuner=`` keyword and are expected to feed it observed request
    timings / compute gaps — that is the closed autotune loop.

    ``accepts_index`` engines receive the filesystem's shared `CacheIndex`
    as an ``index=`` keyword (None when the FS has no tiers): single-flight
    fetches, refcounted eviction, and warm cross-open/-restart reuse.
    """

    def deco(factory: ReaderFactory) -> ReaderFactory:
        if name in _REGISTRY:
            raise ValueError(f"reader engine {name!r} already registered")
        _REGISTRY[name] = EngineSpec(name=name, factory=factory,
                                     needs_tiers=needs_tiers,
                                     accepts_tuner=accepts_tuner,
                                     accepts_index=accepts_index)
        return factory

    return deco


def engine_spec(name: str) -> EngineSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown reader engine {name!r}; "
            f"available: {', '.join(available_engines())}"
        ) from None


def available_engines() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
