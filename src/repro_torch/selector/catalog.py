"""Resource catalogs: the selectable-configuration universe per substrate.

A :class:`ResourceCatalog` is an *ordered* collection of selectable
configurations.  Order matters: it is the deterministic tie-break of the
ranking, and it fixes the column order of every runtime/price matrix the
selector builds.  Each entry exposes

  * a hashable ``id`` (the paper's config index, a mesh name, ...),
  * resource totals (``describe``) for capacity-style baselines, and
  * an ``hourly_cost`` under the *current* price source (§II-D: prices are
    applied at selection time, never baked into the trace).

Two implementations ship here — GCP VM clusters (paper Table II) and TPU
slices (DESIGN.md §3) — but anything with ids and prices fits: GPU fleets,
spot markets, on-prem partitions.
"""
from __future__ import annotations

from typing import (Any, Dict, Hashable, Iterable, Iterator, List, Mapping,
                    Optional, Protocol, Sequence, Tuple, runtime_checkable)

import numpy as np

from repro_torch.core.costmodel import LinearPriceModel, TpuPriceModel
from repro_torch.core.trace import CloudConfig


class PriceTable:
    """Mutable per-entry $/h quotes — the live-market price source.

    Model-based sources (:class:`LinearPriceModel`, :class:`TpuPriceModel`)
    derive an entry's price from its resources; a ``PriceTable`` instead
    holds one *current* quote per entry id, so a streaming market feed can
    move a single spot price without touching the rest of the universe
    (DESIGN.md §6).  Every :class:`BaseCatalog` resolves it transparently
    via :meth:`BaseCatalog.hourly_cost`.

    Mutation goes through :meth:`apply` (absolute re-quotes, never
    relative), which bumps :attr:`version`.  ``SelectionService`` keys
    its ranking caches on that version, so quotes applied directly to a
    service-owned table are never masked by a stale cached ranking —
    they force a cold recompute; routing them through
    ``SelectionService.reprice`` instead gets the incremental path.
    """

    def __init__(self, prices: Mapping[Hashable, float]):
        #: bumped on every :meth:`apply` (consumers key caches on it).
        self.version = 0
        self._prices: Dict[Hashable, float] = self._validated(prices)

    @classmethod
    def from_catalog(cls, catalog: "BaseCatalog",
                     price_source: Optional[Any] = None) -> "PriceTable":
        """Snapshot a catalog's current prices as the mutable base quotes."""
        return cls({e: catalog.hourly_cost(e, price_source)
                    for e in catalog.ids()})

    @staticmethod
    def _validated(prices: Mapping[Hashable, float]) -> Dict[Hashable, float]:
        out: Dict[Hashable, float] = {}
        for entry_id, price in prices.items():
            if not price > 0:
                raise ValueError(
                    f"non-positive price {price!r} for {entry_id!r}")
            out[entry_id] = float(price)
        return out

    def apply(self, deltas: Mapping[Hashable, float]) -> None:
        """Apply absolute re-quotes ``{entry_id: new $/h}``; one epoch.

        All-or-nothing: the whole batch is validated before any entry is
        assigned, so a bad quote can never leave the table (and its
        version) half-updated against version-keyed ranking caches.
        """
        if not deltas:
            return
        self._prices.update(self._validated(deltas))
        self.version += 1

    def __getitem__(self, entry_id: Hashable) -> float:
        return self._prices[entry_id]

    def __contains__(self, entry_id: Hashable) -> bool:
        return entry_id in self._prices

    def __len__(self) -> int:
        return len(self._prices)

    def __iter__(self) -> Iterator[Hashable]:
        return iter(self._prices)

    def items(self) -> Iterable[Tuple[Hashable, float]]:
        return self._prices.items()


@runtime_checkable
class ResourceCatalog(Protocol):
    """Substrate-agnostic view of the selectable configurations."""

    def ids(self) -> Sequence[Hashable]:
        """Stable, ordered entry ids (ranking tie-break order)."""
        ...

    def entry(self, entry_id: Hashable) -> Any:
        """The native configuration object behind ``entry_id``."""
        ...

    def describe(self, entry_id: Hashable) -> Mapping[str, float]:
        """Resource totals, e.g. ``{"cores": 64, "mem_gib": 256}``."""
        ...

    def hourly_cost(self, entry_id: Hashable,
                    price_source: Optional[Any] = None) -> float:
        """Current $/h for the entry under ``price_source`` (or the
        catalog's default)."""
        ...


class BaseCatalog:
    """Shared plumbing: ordered id index + vectorized price lookup."""

    def __init__(self, entry_ids: Sequence[Hashable],
                 default_price_source: Optional[Any] = None):
        self._ids: List[Hashable] = list(entry_ids)
        if len(set(self._ids)) != len(self._ids):
            raise ValueError("duplicate catalog entry ids")
        self._pos = {e: i for i, e in enumerate(self._ids)}
        self.default_price_source = default_price_source

    def ids(self) -> Sequence[Hashable]:
        return list(self._ids)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, entry_id: Hashable) -> bool:
        return entry_id in self._pos

    def position(self, entry_id: Hashable) -> int:
        return self._pos[entry_id]

    def _price(self, price_source: Optional[Any]) -> Any:
        src = price_source if price_source is not None \
            else self.default_price_source
        if src is None:
            raise ValueError("no price source given and no catalog default")
        return src

    def price_vector(self, price_source: Optional[Any] = None) -> np.ndarray:
        """$/h for every entry, aligned with :meth:`ids` (float64)."""
        src = self._price(price_source)
        return np.asarray([self.hourly_cost(e, src) for e in self._ids],
                          dtype=np.float64)

    def hourly_cost(self, entry_id: Hashable,
                    price_source: Optional[Any] = None) -> float:
        """Current $/h: a :class:`PriceTable` source is resolved directly
        (live-market quotes); anything else goes through the substrate's
        :meth:`_entry_cost` model."""
        src = self._price(price_source)
        if isinstance(src, PriceTable):
            return src[entry_id]
        return self._entry_cost(entry_id, src)

    # subclass responsibility
    def entry(self, entry_id: Hashable) -> Any:
        raise NotImplementedError

    def describe(self, entry_id: Hashable) -> Mapping[str, float]:
        raise NotImplementedError

    def _entry_cost(self, entry_id: Hashable, price_source: Any) -> float:
        """Model-based $/h for ``entry_id`` under a resolved source."""
        raise NotImplementedError


class IdentityCatalog(BaseCatalog):
    """Entries are their own ids; pricing comes from the price source
    (typically a :class:`PriceTable`).  The minimal catalog for synthetic
    universes — benchmarks, replay harnesses, property tests."""

    def entry(self, entry_id: Hashable) -> Hashable:
        return entry_id

    def describe(self, entry_id: Hashable) -> Mapping[str, float]:
        return {}


class GcpVmCatalog(BaseCatalog):
    """GCP VM cluster configurations (paper Table II) priced per resource."""

    def __init__(self, configs: Sequence[CloudConfig],
                 price: Optional[LinearPriceModel] = None):
        super().__init__([c.index for c in configs],
                         default_price_source=price)
        self._configs = {c.index: c for c in configs}

    def entry(self, entry_id: Hashable) -> CloudConfig:
        return self._configs[entry_id]

    def describe(self, entry_id: Hashable) -> Mapping[str, float]:
        c = self._configs[entry_id]
        return {"cores": float(c.total_cores),
                "mem_gib": float(c.total_mem_gib),
                "nodes": float(c.scale_out)}

    def _entry_cost(self, entry_id: Hashable,
                    price_source: LinearPriceModel) -> float:
        return price_source(self._configs[entry_id])


class TpuSliceCatalog(BaseCatalog):
    """TPU slice x mesh-split options priced per chip-hour (DESIGN.md §3).

    Entries are duck-typed ``MeshOption``-likes
    (:mod:`repro_torch.core.tpu_flora`): anything with ``.name``,
    ``.chips`` and ``.hourly_cost(price_model)``.
    """

    def __init__(self, options: Sequence[Any],
                 price: Optional[TpuPriceModel] = None):
        super().__init__([o.name for o in options],
                         default_price_source=price)
        self._options = {o.name: o for o in options}

    def entry(self, entry_id: Hashable) -> Any:
        return self._options[entry_id]

    def describe(self, entry_id: Hashable) -> Mapping[str, float]:
        o = self._options[entry_id]
        return {"chips": float(o.chips)}

    def _entry_cost(self, entry_id: Hashable,
                    price_source: TpuPriceModel) -> float:
        return self._options[entry_id].hourly_cost(price_source)
