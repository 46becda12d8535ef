"""Physical execution plan — the HyperDex *memory-mapper* output.

A copy of the JAX package's ``compiler/plan.py`` (numpy only): the
stored GQA head layout (:class:`AttnPlan`), the KV storage precision
(:class:`KVPrecision`) and the padded model layout
(:class:`PhysicalPlan`).  The port keeps the reference's field names
and values so a plan can be compared field by field across packages.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class AttnPlan:
    """Stored (physical) GQA head layout for one tensor-parallel group.

    * ``dup == 1`` (n_kv >= tp): kv heads padded to a multiple of tp and
      sharded; q heads follow their groups.
    * ``dup > 1``  (n_kv < tp): ``kv_shards = gcd(n_kv, tp)`` shards, each
      *duplicated* across ``dup = tp/kv_shards`` adjacent ranks; the shard's
      query heads are split across those ranks (padded to a multiple of dup).

    ``q_to_kv`` maps every stored query head to its stored KV head; by
    construction the mapping is rank-local.
    """

    tp: int
    n_heads: int            # logical q heads
    n_kv_heads: int         # logical kv heads
    d_head: int
    kv_shards: int
    dup: int
    q_per_rank: int
    kv_per_rank: int
    hp: int                 # stored q heads  = q_per_rank * tp
    gp: int                 # stored kv heads = kv_per_rank * tp
    q_to_kv: Tuple[int, ...]        # len hp, stored-kv index per stored-q
    q_orig: Tuple[int, ...]         # len hp, original q head or -1 (padding)
    kv_orig: Tuple[int, ...]        # len gp, original kv head or -1

    @property
    def q_to_kv_local(self) -> np.ndarray:
        """(tp, q_per_rank) local kv index (within-rank) per local q head."""
        m = np.asarray(self.q_to_kv, np.int32).reshape(self.tp, self.q_per_rank)
        base = (np.arange(self.tp, dtype=np.int32) * self.kv_per_rank)[:, None]
        return m - base

    @property
    def block_regular(self) -> bool:
        """True when every rank's local q->kv map is ``i // gs`` with one
        uniform group size ``gs = q_per_rank // kv_per_rank`` — the layout
        the paged decode kernel assumes (q heads reshape to (G, gs) with
        no per-head gather)."""
        if self.q_per_rank % max(self.kv_per_rank, 1):
            return False
        gs = self.q_per_rank // self.kv_per_rank
        want = np.repeat(np.arange(self.kv_per_rank, dtype=np.int32), gs)
        return bool((self.q_to_kv_local == want[None, :]).all())

    @property
    def waste_q(self) -> float:
        real = sum(1 for o in self.q_orig if o >= 0)
        return self.hp / max(real, 1)

    @property
    def kv_storage_factor(self) -> float:
        """Stored kv heads / logical kv heads (padding + duplication)."""
        return self.gp / max(self.n_kv_heads, 1)


def plan_attention(n_heads: int, n_kv_heads: int, d_head: int,
                   tp: int) -> AttnPlan:
    g = n_kv_heads
    gs = max(1, n_heads // max(g, 1))
    if g >= tp:
        # pad kv to a multiple of tp; groups stay intact
        gp = _ceil_to(g, tp)
        hp = gp * gs
        kv_per_rank = gp // tp
        q_per_rank = hp // tp
        q_to_kv = [j // gs for j in range(hp)]
        q_orig = [j if (j // gs) < g else -1 for j in range(hp)]
        kv_orig = [c if c < g else -1 for c in range(gp)]
        return AttnPlan(tp, n_heads, n_kv_heads, d_head, tp, 1,
                        q_per_rank, kv_per_rank, hp, gp,
                        tuple(q_to_kv), tuple(q_orig), tuple(kv_orig))
    # n_kv < tp: shard what divides, duplicate the rest
    kv_shards = math.gcd(g, tp)
    dup = tp // kv_shards
    kv_per_shard = g // kv_shards
    qps = gs * kv_per_shard                      # real q heads per shard
    qps_pad = _ceil_to(qps, dup)
    q_per_rank = qps_pad // dup
    kv_per_rank = kv_per_shard
    hp = kv_shards * qps_pad
    gp = kv_per_rank * tp                        # includes dup copies
    q_to_kv, q_orig, kv_orig = [], [], []
    for r in range(tp):
        s, p = divmod(r, dup)
        for i in range(q_per_rank):
            m = p * q_per_rank + i               # index within the shard
            real = m < qps
            c = min(m // gs, kv_per_shard - 1)
            q_to_kv.append(r * kv_per_rank + c)
            q_orig.append(s * qps + m if real else -1)
        for c in range(kv_per_rank):
            kv_orig.append(s * kv_per_shard + c)
    return AttnPlan(tp, n_heads, n_kv_heads, d_head, kv_shards, dup,
                    q_per_rank, kv_per_rank, hp, gp,
                    tuple(q_to_kv), tuple(q_orig), tuple(kv_orig))


@dataclass(frozen=True)
class MoEPlan:
    n_experts: int
    ep: int                  # expert-parallel degree
    ffn_split: int           # per-expert FFN split degree
    experts_per_rank: int
    d_ff_expert_shard: int
    expert_axes: Tuple[str, ...]
    capacity_factor: float


# itemsize table for storage dtypes numpy cannot name
_STORE_ITEMSIZE = {"float8_e4m3fn": 1, "bfloat16": 2}


@dataclass(frozen=True)
class KVPrecision:
    """Resolved KV-pool storage precision (the engine's ``kv_dtype`` knob).

    ``auto`` stores at ``plan.cache_dtype``; ``float16``/``bfloat16``/
    ``float32`` cast on store with no side arrays; ``int8`` and ``fp8``
    store quantized values with a per-(token-row, kv-head) absmax scale
    kept in a side array next to the pool.
    """

    requested: str                 # the knob value ("auto", "int8", ...)
    store_dtype: str               # pool leaf dtype name
    scale_dtype: Optional[str]     # side-array dtype; None = not quantized
    qmax: float                    # symmetric clip bound (0 = not quantized)

    @property
    def quantized(self) -> bool:
        return self.scale_dtype is not None

    @property
    def itemsize(self) -> int:
        if self.store_dtype in _STORE_ITEMSIZE:
            return _STORE_ITEMSIZE[self.store_dtype]
        return np.dtype(self.store_dtype).itemsize

    @property
    def scale_itemsize(self) -> int:
        return np.dtype(self.scale_dtype).itemsize if self.quantized else 0

    def bytes_per_row_head(self, d_head: int) -> int:
        """Stored bytes of one token's one kv head (values + its scale)."""
        return d_head * self.itemsize + self.scale_itemsize


def resolve_kv_precision(kv_dtype: str, cache_dtype: str) -> KVPrecision:
    """Map the ``kv_dtype`` knob onto a :class:`KVPrecision`
    (``fp8`` resolves to ``float8_e4m3fn``)."""
    kd = (kv_dtype or "auto").lower()
    if kd == "auto":
        return KVPrecision("auto", cache_dtype, None, 0.0)
    if kd in ("float16", "fp16"):
        return KVPrecision("float16", "float16", None, 0.0)
    if kd in ("bfloat16", "bf16"):
        return KVPrecision("bfloat16", "bfloat16", None, 0.0)
    if kd in ("float32", "fp32"):
        return KVPrecision("float32", "float32", None, 0.0)
    if kd == "int8":
        return KVPrecision("int8", "int8", "float16", 127.0)
    if kd in ("fp8", "float8_e4m3fn"):
        return KVPrecision("fp8", "float8_e4m3fn", "float16", 448.0)
    raise ValueError(f"unknown kv_dtype {kv_dtype!r} (expected auto, "
                     "float16, bfloat16, float32, int8 or fp8)")


@dataclass(frozen=True)
class PhysicalPlan:
    arch: str
    mode: str                        # 'train' | 'serve'
    mesh_axes: Optional[Tuple[str, ...]]  # None => single device (tp=1)
    mesh_shape: Tuple[int, ...]
    tp: int
    tp_axis: Optional[str]
    dp_axes: Tuple[str, ...]         # batch-sharding axes
    fsdp_axes: Tuple[str, ...]       # parameter/optimizer sharding (train)
    attn: Optional[AttnPlan]
    d_ff_shard: int                  # padded d_ff / tp
    d_ff_padded: int
    vocab_padded: int
    moe: Optional[MoEPlan]
    esl_overlap: bool = True         # C2 on (ring-overlapped) vs blocking
    esl_chunks: int = 4              # column chunks per ring step batch
    seq_shard_kv: bool = False
    kv_seq_axis: Optional[str] = None
    remat: str = "block"             # 'none' | 'block'
    scan_unroll: bool = False
    use_kernels: bool = False
    compute_dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    cache_dtype: str = "float32"
    logits_fp32: bool = True
    # logical-axis -> mesh-axes rule table: empty in the port (no
    # jax.sharding; tensor parallelism arrives with its own slice)
    rules: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2, default=lambda o: list(o)
                          if isinstance(o, (tuple, np.ndarray)) else str(o))

    @property
    def dp(self) -> int:
        if self.mesh_axes is None:
            return 1
        sizes = dict(zip(self.mesh_axes, self.mesh_shape))
        out = 1
        for a in self.dp_axes:
            out *= sizes[a]
        return out
