"""Typed engine construction config — a copy of the reference's
``serving/config.py`` ``EngineConfig``.

The fields and defaults are the reference's, so one configuration reads
the same in both packages.  Knobs whose subsystem has not been ported
yet (:data:`UNPORTED`: chunked prefill, prefix cache, speculation,
quantized weights, fault tolerance, the async front end) are kept here,
and :class:`repro_torch.serving.engine.LPUEngine` rejects any value
other than the default with ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional

KV_DTYPES = ("auto", "float16", "fp16", "bfloat16", "bf16", "float32",
             "fp32", "int8", "fp8", "float8_e4m3fn")
W_DTYPES = ("auto", "int8")


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
    # fault tolerance
    chaos: str = ""
    max_migrations: int = 3
    heartbeat_timeout_s: float = 30.0
    ft_straggler_drain: bool = False
    # serving front end
    affinity: str = "least_loaded"
    budget_ms: float = 0.0
    max_pending: int = 0

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


# field -> the later slice of the port that brings its subsystem
UNPORTED = {
    "prefill_chunk": "chunked prefill", "prefix_cache": "prefix cache",
    "speculate": "speculation", "draft_k": "speculation",
    "chaos": "fault tolerance",
    "max_migrations": "fault tolerance",
    "heartbeat_timeout_s": "fault tolerance",
    "ft_straggler_drain": "fault tolerance", "affinity": "front end",
    "budget_ms": "front end", "max_pending": "front end",
}
DEFAULTS = {f.name: f.default for f in fields(EngineConfig)}
