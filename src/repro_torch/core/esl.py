"""ESL — Expandable Synchronization Link, as collective matmuls on a ring
of ranks.

The port of the JAX package's ``core/esl.py``.  The paper (C2):
tensor-parallel vector-matrix products are split into column chunks;
each chunk's partial product is streamed around a ring of peers while
the next chunk computes, so compute, transmit and receive overlap and
only a small tail remains.  Two primitives cover a transformer:

* :func:`ag_matmul` — column-parallel matmul consuming a *scattered*
  activation (each rank holds D/tp of the input vector).  The input
  chunks rotate around the ring while each rank multiplies the chunk it
  holds with the matching row block of its local weight tile.

* :func:`rs_matmul` — row-parallel matmul producing a *scattered*
  output.  Each rank walks the output column blocks in ring order,
  adding its contribution to the partial sum it just received and
  passing it on.  The blocks are summed in the reference's order (rank
  r adds block ``(r + 1 + s) % tp`` at step s), so the rounding is the
  reference's.

``overlap=True`` issues each hop with ``async_op=True`` before the next
chunk's product is launched and waits for it after.  What overlaps
depends on the ring's backend (:mod:`repro_torch.core.dist`): on NCCL (a
card per rank) the hop runs on NCCL's stream over the link while the
product runs on the compute stream, and the wait orders the compute
stream after the hop without the host (inside a CUDA graph too); on
gloo (the CPU, or ranks sharing one card) the hop is a host-staged
send/receive, so the host's transfer overlaps the device's product and
nothing of a device link is involved.  ``overlap=False`` is the
*typical processor* baseline: the full matmul followed by a blocking
``psum`` / ``all_gather``.  Both modes compute the same values, and
keep their order of chunks and of sums on either backend.

**Sub-rings (C3)**: ``ring=RingConfig(total, ring_size)`` confines every
collective to the caller's sub-ring: ppermute pairs from
``ring.perm_within_rings`` and gathers/reductions over
``ring.groups()``; ``tp`` is then the ring size and the weight block
index the rank within its ring.

Every function is the plain local matmul when ``axis is None`` or
``tp == 1``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import dist
from repro_torch.core.dist import Ring
from repro_torch.core.rings import RingConfig


def _ring_perm(tp: int, up: bool = True):
    if up:
        return [(i, (i + 1) % tp) for i in range(tp)]
    return [(i, (i - 1) % tp) for i in range(tp)]


def _ring_env(axis: Ring, tp: int, ring: Optional[RingConfig], up: bool):
    """(rank within the ring, ppermute pairs, groups) for a maybe-grouped
    ring.  Sub-ring groups are contiguous rank ranges, so the in-ring
    rank is ``rank % ring_size``."""
    r = dist.axis_index(axis)
    if ring is None:
        return r, _ring_perm(tp, up), None
    if tp != ring.ring_size:
        raise ValueError(f"tp={tp} is not the sub-ring size "
                         f"{ring.ring_size}")
    return r % ring.ring_size, ring.perm_within_rings(up), ring.groups()


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def _plus(y: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    return y + b if b is not None else y


# ---------------------------------------------------------------------------
# column-parallel: scattered input -> head/ffn-sharded output
# ---------------------------------------------------------------------------

def ag_matmul(x: torch.Tensor, w: torch.Tensor, *, axis: Optional[Ring],
              tp: int, overlap: bool = True,
              scattered_in: Optional[bool] = None,
              b: Optional[torch.Tensor] = None,
              ring: Optional[RingConfig] = None) -> torch.Tensor:
    """y_loc = (allgather(x) @ w_loc) + b_loc.

    x: (..., D/tp) scattered on the last dim when ``scattered_in`` (the
    ESL convention; defaults to ``overlap``), or already full (..., D).
    w: (D, N_loc) the local column tile.  -> (..., N_loc)."""
    return _plus(ag_matmuls(x, (w,), axis=axis, tp=tp, overlap=overlap,
                            scattered_in=scattered_in, ring=ring)[0], b)


def ag_matmuls(x: torch.Tensor, ws, *, axis: Optional[Ring], tp: int,
               overlap: bool = True, scattered_in: Optional[bool] = None,
               ring: Optional[RingConfig] = None) -> list:
    """[allgather(x) @ w_loc for each tile w_loc of ``ws``]: one pass of
    the input's chunks around the ring feeds every tile, as the
    reference's one ``ag_matmul`` over the tiles' concatenation does
    (mamba's in_x|in_z, an expert's wg|wu), without copying the tiles
    together.  Each output column sums the same products in the same
    order as the concatenated product's."""
    if axis is None or tp == 1:
        return [_mm(x, w) for w in ws]
    if scattered_in is None:
        scattered_in = overlap
    if not scattered_in:
        return [_mm(x, w) for w in ws]
    d_loc = x.shape[-1]

    def w_block(w, i):                # rows of block i (a view, no copy)
        return w[i * d_loc:(i + 1) * d_loc]
    r, perm, groups = _ring_env(axis, tp, ring, up=True)
    if not overlap:
        xf = dist.all_gather(x, axis, dim=-1, groups=groups)
        return [_mm(xf, w) for w in ws]
    # ESL: rotate the input chunks around the ring; the next chunk is on
    # its way while the product of the one held is computed
    pending = dist.ppermute(x, axis, perm, async_op=True)
    acc = [_mm(x, w_block(w, r)) for w in ws]
    for s in range(1, tp):
        chunk = pending.wait()
        if s + 1 < tp:
            pending = dist.ppermute(chunk, axis, perm, async_op=True)
        src = (r - s) % tp                  # rank whose chunk we now hold
        acc = [a + _mm(chunk, w_block(w, src)) for a, w in zip(acc, ws)]
    return acc


# ---------------------------------------------------------------------------
# row-parallel: sharded input -> scattered (or replicated) output
# ---------------------------------------------------------------------------

def rs_matmul(x: torch.Tensor, w: torch.Tensor, *, axis: Optional[Ring],
              tp: int, overlap: bool = True, scatter_out: bool = True,
              b: Optional[torch.Tensor] = None,
              ring: Optional[RingConfig] = None) -> torch.Tensor:
    """y = sum over ranks of (x_loc @ w_loc), reduced across the ring.

    x: (..., M_loc); w: (M_loc, D_out).  ``scatter_out=True`` returns
    (..., D_out/tp) (reduce-scatter, the ESL form); False the full
    (..., D_out).  ``b`` (D_out,) is added once, to the sum."""
    if axis is None or tp == 1:
        return _plus(_mm(x, w), b)
    if not overlap:
        _, _, groups = _ring_env(axis, tp, ring, up=False)
        y = _mm(x, w)
        if scatter_out:
            y = dist.psum_scatter(y, axis, dim=-1, groups=groups)
            if b is not None:
                y = y + _bias_slice(b, axis, tp, ring=ring)
            return y
        return _plus(dist.psum(y, axis, groups=groups), b)
    c = w.shape[-1] // tp

    def w_block(i):                   # columns of block i (a view)
        return w[:, i * c:(i + 1) * c]
    r, perm, groups = _ring_env(axis, tp, ring, up=False)
    # the reduce-scatter fused with the matmul: at each step add our
    # contribution to the block travelling toward its home rank; the
    # next block's product runs while the partial sum is on the wire
    acc = _mm(x, w_block((r + 1) % tp))
    for s in range(1, tp):
        pending = dist.ppermute(acc, axis, perm, async_op=True)
        part = _mm(x, w_block((r + 1 + s) % tp))
        acc = pending.wait() + part
    # acc holds block r (the scattered output)
    if b is not None:
        acc = acc + _bias_slice(b, axis, tp, ring=ring)
    if scatter_out:
        return acc
    return dist.all_gather(acc, axis, dim=-1, groups=groups)


def _bias_slice(b: torch.Tensor, axis: Optional[Ring], tp: int,
                ring: Optional[RingConfig] = None) -> torch.Tensor:
    if axis is None or tp == 1:
        return b
    r = dist.axis_index(axis)
    if ring is not None:
        r = r % ring.ring_size
    c = b.shape[-1] // tp
    return b[..., r * c:(r + 1) * c]


# ---------------------------------------------------------------------------
# helpers for scattered-activation mode
# ---------------------------------------------------------------------------

def gather_scattered(x: torch.Tensor, *, axis: Optional[Ring],
                     tp: int) -> torch.Tensor:
    """(..., D/tp) -> (..., D): explicit all-gather (at mode edges)."""
    if axis is None or tp == 1:
        return x
    return dist.all_gather(x, axis, dim=-1)


def scatter_full(x: torch.Tensor, *, axis: Optional[Ring],
                 tp: int) -> torch.Tensor:
    """(..., D) -> (..., D/tp): this rank's shard of a replicated array."""
    if axis is None or tp == 1:
        return x
    r = dist.axis_index(axis)
    c = x.shape[-1] // tp
    return x[..., r * c:(r + 1) * c]


def vec_slice(v: torch.Tensor, *, axis: Optional[Ring],
              tp: int) -> torch.Tensor:
    """This rank's shard of a replicated vector parameter."""
    return scatter_full(v, axis=axis, tp=tp)


def full_vec(v: torch.Tensor, *, axis: Optional[Ring], tp: int,
             scattered_activations: bool) -> torch.Tensor:
    """Vector parameters are stored model-sharded (rule 'vec'): in
    scattered mode the local shard is what elementwise ops need; in the
    blocking baseline (full activations) it is gathered, once per
    parameter (:func:`repro_torch.core.dist.all_gather_param`)."""
    if axis is None or tp == 1 or scattered_activations:
        return v
    return dist.all_gather_param(v, axis)


# ---------------------------------------------------------------------------
# collective-latency accounting (consumed by core.latency_model)
# ---------------------------------------------------------------------------

def sync_bytes_per_token(d_model: int, tp: int, dtype_bytes: int = 2,
                         overlap: bool = True) -> dict:
    """Wire bytes per activation vector of one row-parallel sync on a
    ring: a ring all-reduce moves 2*(tp-1)/tp * D bytes per device; the
    ESL form moves the same bytes off the critical path, leaving one
    chunk hop (D/tp bytes) serialized."""
    full = d_model * dtype_bytes
    wire = 2 * (tp - 1) / tp * full
    exposed = (full / tp) if overlap else wire
    return {"wire_bytes": wire, "exposed_bytes": exposed}
