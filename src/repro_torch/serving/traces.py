"""Deterministic bursty multi-tenant request traces (a copy of the
reference's ``benchmarks/traces.py``).

A tail-latency run needs load that looks like production — bursty
arrivals, several tenants, shared per-tenant system prompts — and
replays bit-identically across processes.  So everything here is a pure
function of :class:`TraceConfig`: arrivals come from a seeded numpy
generator (exponential gaps for ``"poisson"``, heavy-tailed Pareto gaps
for ``"pareto"``: many near-simultaneous arrivals separated by long
lulls), and prompts are drawn from per-tenant pools that all open with
that tenant's fixed system prefix (block-aligned, so the prefix cache
and the affinity router have something to hit).  Nothing reads the
clock or ``hash()``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class TraceRequest:
    rid: int
    tenant: str
    arrival_s: float              # offset from the trace's start
    prompt: Tuple[int, ...]
    max_new_tokens: int


@dataclass(frozen=True)
class TraceConfig:
    seed: int = 0
    requests: int = 16
    tenants: int = 3
    arrival: str = "pareto"       # "poisson" | "pareto" (bursty)
    rate_rps: float = 100.0       # mean arrival rate (1 / mean gap)
    pareto_shape: float = 1.5     # tail index; smaller = burstier
    prefix_len: int = 32          # shared per-tenant system prefix
                                  # (block-align it to the pool for hits)
    tail_min: int = 4             # per-request unique suffix length
    tail_max: int = 24
    max_new_min: int = 4
    max_new_max: int = 16
    vocab: int = 256              # token ids in [1, vocab): keep it
                                  # under the serving model's vocabulary
    tenant_names: Tuple[str, ...] = field(default=())

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError(f"requests={self.requests} must be >= 1")
        if self.tenants < 1:
            raise ValueError(f"tenants={self.tenants} must be >= 1")
        if self.arrival not in ("poisson", "pareto"):
            raise ValueError(f"arrival={self.arrival!r} not in "
                             "('poisson', 'pareto')")
        if self.rate_rps <= 0:
            raise ValueError(f"rate_rps={self.rate_rps} must be > 0")
        if self.pareto_shape <= 1.0:
            raise ValueError(
                f"pareto_shape={self.pareto_shape} must be > 1 "
                "(shape <= 1 has no finite mean gap)")
        if not (0 < self.tail_min <= self.tail_max):
            raise ValueError(f"need 0 < tail_min <= tail_max, got "
                             f"({self.tail_min}, {self.tail_max})")
        if not (0 < self.max_new_min <= self.max_new_max):
            raise ValueError(f"need 0 < max_new_min <= max_new_max, got "
                             f"({self.max_new_min}, {self.max_new_max})")
        if self.prefix_len < 0:
            raise ValueError(f"prefix_len={self.prefix_len} must be >= 0")
        if self.vocab < 2:
            raise ValueError(f"vocab={self.vocab} must be >= 2")


def tenant_prefixes(cfg: TraceConfig) -> List[List[int]]:
    """Each tenant's fixed system prefix (one seeded stream per
    tenant)."""
    out = []
    for t in range(cfg.tenants):
        rng = np.random.Generator(np.random.PCG64(cfg.seed * 1000003 + t))
        out.append(rng.integers(1, cfg.vocab,
                                size=cfg.prefix_len).tolist())
    return out


def generate_trace(cfg: TraceConfig) -> List[TraceRequest]:
    """``cfg.requests`` requests sorted by arrival time; the same config
    gives the same trace in every process (PCG64 is stable)."""
    rng = np.random.Generator(np.random.PCG64(cfg.seed))
    mean_gap = 1.0 / cfg.rate_rps
    if cfg.arrival == "poisson":
        gaps = rng.exponential(mean_gap, size=cfg.requests)
    else:
        # Lomax (Pareto II) gaps scaled to the same mean: xm * (U^(-1/a)
        # - 1) with xm = mean * (a - 1) has mean ``mean_gap`` and a heavy
        # tail — most gaps tiny (a burst), a few huge (the lull)
        a = cfg.pareto_shape
        xm = mean_gap * (a - 1.0)
        gaps = xm * (rng.pareto(a, size=cfg.requests))
    arrivals = np.cumsum(gaps)
    arrivals -= arrivals[0]                      # first request at t=0
    prefixes = tenant_prefixes(cfg)
    names = (cfg.tenant_names if cfg.tenant_names
             else tuple(f"tenant{t}" for t in range(cfg.tenants)))
    if len(names) != cfg.tenants:
        raise ValueError(f"{len(names)} tenant_names for "
                         f"{cfg.tenants} tenants")
    reqs: List[TraceRequest] = []
    for i in range(cfg.requests):
        t = int(rng.integers(0, cfg.tenants))
        tail_n = int(rng.integers(cfg.tail_min, cfg.tail_max + 1))
        tail = rng.integers(1, cfg.vocab, size=tail_n).tolist()
        max_new = int(rng.integers(cfg.max_new_min, cfg.max_new_max + 1))
        reqs.append(TraceRequest(
            rid=i, tenant=names[t], arrival_s=float(arrivals[i]),
            prompt=tuple(prefixes[t] + tail), max_new_tokens=max_new))
    return reqs
