"""Reconfigurable network (C3): split the ring into independent sub-rings.

The port of the JAX package's ``core/rings.py``.  The ESL router splits
an 8-device ring into 2x4 or 4x2 rings so several models serve
concurrently with no cross-ring interference and no rewiring.  In the
port the ring is a ``torch.distributed`` process group of ``total``
ranks; :class:`RingConfig` computes the disjoint sub-ring groups that
the collectives of :mod:`repro_torch.core.dist` confine themselves to,
and :func:`rank_groups` gives the rank lists of independent sub-rings.
:func:`sub_ring` is the port's counterpart of the reference's
``submeshes`` (which carves a JAX mesh into congruent sub-meshes): it
splits a world of ranks into those sub-rings and gives each rank its
sub-ring's index and handle, on which one ring-parallel engine runs.
:class:`Grid` describes a ``("data", "model")`` grid of ranks (the
reference's 2-D serving mesh): rank ``l = d * tp + m``, model innermost,
its model and data sub-rings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class RingConfig:
    total: int                  # ranks on the model ring
    ring_size: int              # ranks per sub-ring

    def __post_init__(self):
        if self.ring_size < 1 or self.total % self.ring_size:
            raise ValueError(f"a ring of {self.total} ranks does not split "
                             f"into sub-rings of {self.ring_size}")

    @property
    def n_rings(self) -> int:
        return self.total // self.ring_size

    def groups(self) -> List[List[int]]:
        """The ranks of each sub-ring: the groups collectives confine to."""
        return [list(range(r * self.ring_size, (r + 1) * self.ring_size))
                for r in range(self.n_rings)]

    def ring_of(self, idx: int) -> int:
        return idx // self.ring_size

    def perm_within_rings(self, up: bool = True) -> List[Tuple[int, int]]:
        """ppermute (source, destination) pairs that never cross a ring
        boundary."""
        pairs = []
        for g in self.groups():
            n = len(g)
            for i, src in enumerate(g):
                dst = g[(i + 1) % n] if up else g[(i - 1) % n]
                pairs.append((src, dst))
        return pairs

    def validate_disjoint(self) -> bool:
        seen = set()
        for g in self.groups():
            if seen & set(g):
                return False
            seen |= set(g)
        return True


@dataclass(frozen=True)
class Grid:
    """A ``("data", "model")`` grid of ``dwidth * tp`` ranks, model
    innermost as the reference's mesh lays it out (rank ``l = d * tp +
    m``, ``src/repro/models/moe.py``'s linear EP index)."""
    dwidth: int                 # ranks on the data axis
    tp: int                     # ranks on the model axis

    def __post_init__(self):
        if self.dwidth < 1 or self.tp < 1:
            raise ValueError(f"grid data {self.dwidth} x model {self.tp}: "
                             "both must be >= 1")

    axes = ("data", "model")

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.dwidth, self.tp)

    @property
    def total(self) -> int:
        return self.dwidth * self.tp

    def coords(self, rank: int) -> Tuple[int, int]:
        """(d, m) of world rank ``rank``."""
        if not 0 <= rank < self.total:
            raise ValueError(f"rank {rank} is not on a grid of {self.total}")
        return divmod(int(rank), self.tp)

    def rank_of(self, d: int, m: int) -> int:
        return d * self.tp + m

    def model_groups(self) -> List[List[int]]:
        """Model sub-ring d: ranks ``d*tp .. d*tp + tp - 1``."""
        return [[self.rank_of(d, m) for m in range(self.tp)]
                for d in range(self.dwidth)]

    def data_groups(self) -> List[List[int]]:
        """Data sub-ring m: ranks ``m, m + tp, ..``."""
        return [[self.rank_of(d, m) for d in range(self.dwidth)]
                for m in range(self.tp)]


def reconfigure(total: int, ring_size: int) -> RingConfig:
    """Paper's 2/4/8-device reconfiguration, generalized to any divisor."""
    return RingConfig(total, ring_size)


def rank_groups(total: int, ring_size: int) -> List[List[int]]:
    """The ranks of each independent sub-ring of a ``total``-rank ring:
    one model per group (multi-tenant), its collectives confined to it."""
    return reconfigure(total, ring_size).groups()


def sub_ring(ring, ring_size: int):
    """(index of the sub-ring holding this rank, its
    :class:`repro_torch.core.dist.SubRing`) when the world ``ring``
    splits into independent sub-rings of ``ring_size`` ranks (every rank
    calls this at the same point; the split is made once and reused).
    No collective of one sub-ring involves another's ranks."""
    cfg = reconfigure(ring.size, ring_size)
    return cfg.ring_of(ring.rank), ring.split(cfg.groups())
