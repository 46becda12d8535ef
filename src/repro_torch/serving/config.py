"""Typed engine construction config — a copy of the reference's
``serving/config.py`` ``EngineConfig``.

The fields and defaults are the reference's, so one configuration reads
the same in both packages; every subsystem a field selects is ported
(``budget_ms`` and ``max_pending`` are read by the async front end,
:mod:`repro_torch.serving.frontend`).
The chaos spec is parsed at construction, as the reference parses it.  As in the
reference, the engine checks the knobs that depend on the model (the
paged pool that int8/fp8 storage and speculation need) and the
speculation knobs (``speculate`` in ``SPECULATE``, ``draft_k >= 1``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.serving.ft import parse_chaos

KV_DTYPES = ("auto", "float16", "fp16", "bfloat16", "bf16", "float32",
             "fp32", "int8", "fp8", "float8_e4m3fn")
W_DTYPES = ("auto", "int8")
SPECULATE = ("off", "ngram", "model")


@dataclass(frozen=True)
class EngineConfig:
    """Scalar construction knobs of an :class:`LPUEngine`."""
    # core batch/sequence geometry
    slots: int = 4
    max_seq: int = 256
    eos_id: Optional[int] = None
    # paged KV pool
    paged: Optional[bool] = None       # None = auto (attention-only stacks)
    block_size: int = 0                # 0 = min(LANE, max_seq)
    num_blocks: int = 0                # 0 = budget- or dense-equivalent
    kv_budget_bytes: int = 0           # per-rank budget for the pool
    min_bucket: int = 16               # smallest pow2 prefill bucket
    # kernel dataflow
    paged_kernel: str = "auto"         # auto | stream | gather
    block_s: int = 0                   # flash-chunk override (gather/dense)
    # sampling loop
    sampling: str = "fused"            # fused | host
    steps_per_sync: int = 1            # fused window length
    pipeline: bool = True              # dispatch window k+1 before k's sync
    # prefill
    prefill_chunk: int = 0             # 0 = monolithic bucketed prefill
    prefix_cache: bool = False
    # speculation
    speculate: str = "off"             # off | ngram | model
    draft_k: int = 4
    # precision
    kv_dtype: str = "auto"             # auto|float16|bfloat16|float32|
                                       # int8|fp8 — pool storage precision
    w_dtype: str = "auto"              # auto|int8 — streamed weights
    # fault tolerance (repro_torch.serving.ft)
    chaos: str = ""                    # "" = off; else "kind@step[:ring],..."
                                       # with kinds ring|stall|nan|corrupt
    max_migrations: int = 3            # migrations per request before it
                                       # ends as a structured failure
    heartbeat_timeout_s: float = 30.0  # ring liveness timeout (virtual
                                       # seconds in a chaos run)
    ft_straggler_drain: bool = False   # drain a straggler-flagged ring
    # serving front end
    affinity: str = "least_loaded"     # fleet routing: least_loaded|prefix
    budget_ms: float = 0.0             # the front end's per-step SLO
                                       # budget (0 = off)
    max_pending: int = 0               # the front end's admission bound
                                       # (0 = unbounded)

    def __post_init__(self):
        if self.affinity not in ("least_loaded", "prefix"):
            raise ValueError(f"affinity={self.affinity!r} not in "
                             "('least_loaded', 'prefix')")
        if self.budget_ms < 0:
            raise ValueError(f"budget_ms={self.budget_ms} must be >= 0")
        if self.max_pending < 0:
            raise ValueError(f"max_pending={self.max_pending} must be >= 0")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype={self.kv_dtype!r} not in "
                             f"{KV_DTYPES}")
        if self.w_dtype not in W_DTYPES:
            raise ValueError(f"w_dtype={self.w_dtype!r} not in {W_DTYPES}")
        if self.chaos:
            parse_chaos(self.chaos)    # fail at construction, not mid-run
        if self.max_migrations < 0:
            raise ValueError(
                f"max_migrations={self.max_migrations} must be >= 0")
        if self.heartbeat_timeout_s <= 0:
            raise ValueError(
                f"heartbeat_timeout_s={self.heartbeat_timeout_s} "
                "must be > 0")

    def with_overrides(self, **kw) -> "EngineConfig":
        """A copy with the given fields replaced (frozen-safe)."""
        return replace(self, **kw)
