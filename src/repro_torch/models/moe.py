"""Mixture-of-Experts layer at tp=1 (the port of the reference's
``models/moe.py`` for ``env.model is None``).

Expert weights keep the reference's rank-major stored layout
``(W, Ecell, D, ffh)`` / ``(W, Ecell, ffh, D)``; on one device W = 1 and
Ecell holds every expert.  Routing is top-k over the router's softmax;
dispatch is capacity-based (top-C rows per expert, static shapes), with
overflow dropped as in the reference's Switch discipline.

Like the reference's single-device path (``_moe_local_all``) every
expert runs on its top-C rows at every call, routed or not: an expert
that no token picked still computes C rows whose gates are zero.  The
expert products are plain ``torch.matmul``s, as the reference leaves
them to XLA.  Ties keep the reference's order: ``lax.top_k`` returns the
lowest index first among equal values, which a stable descending sort
reproduces (``torch.topk`` promises no order among ties).  Experts add
into the output in expert order 0..E-1, as ``out.at[idx].add`` does.

A shared expert (llama4: ``n_shared_experts``) runs on every row after
the routed experts, as the reference's branch does: the gated product
of ``wg`` and ``wu`` (the reference streams them as one concatenated
matmul; its columns are the same products), then ``wd``, its hidden
width ``n_shared_experts x d_ff_shard`` (the dense ``d_ff``), added to
the routed output.

Not ported yet (raises ``NotImplementedError``): the reference's expert
parallelism over the model ring (``_moe_model_parallel``) and over data
x model (``_moe_data_model``): the tensor-parallel slice serves the
dense stacks, and expert parallelism is a slice of its own.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import activate

Params = Dict[str, torch.Tensor]


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def moe_layout(plan) -> Tuple[int, int, int, int, int, int]:
    """(W, split, n_groups, Ecell, E_pad, ffh) for the plan's MoE."""
    m = plan.moe
    sizes = dict(zip(plan.mesh_axes or (), plan.mesh_shape))
    w = 1
    for a in m.expert_axes:
        w *= sizes.get(a, 1)
    w = max(w, 1)
    split = m.ffn_split
    n_groups = max(w // max(split, 1), 1)
    e_pad = _ceil_to(m.n_experts, n_groups)
    ecell = e_pad // n_groups
    return w, split, n_groups, ecell, e_pad, m.d_ff_expert_shard


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest values, ties
    broken towards the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: Params, xf: torch.Tensor, cfg, plan):
    """xf: (T, D) tokens.  Returns top-k (ids, gates, probs)."""
    m = cfg.moe
    e_pad = moe_layout(plan)[4]
    logits = xf.float() @ p["router"].float()
    if e_pad > m.n_experts:
        keep = torch.arange(e_pad, device=xf.device) < m.n_experts
        logits = torch.where(keep, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, -1)
    gates, ids = _top(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return ids, gates, probs


def _lb_loss(probs: torch.Tensor, ids: torch.Tensor,
             n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss."""
    hot = F.one_hot(ids, probs.shape[-1]).float()           # (T,k,E)
    frac_tokens = hot.sum(1).mean(0)
    frac_probs = probs.mean(0)
    return n_experts * (frac_tokens * frac_probs).sum()


def _expert_ffn(wg, wu, wd, xt: torch.Tensor, activation: str):
    """xt: (..., C, D); expert mats (D, ffh)/(ffh, D)."""
    return (activate(xt @ wg, activation) * (xt @ wu)) @ wd


def _select_topc(score: torch.Tensor, cap: int):
    """Indices of up to ``cap`` rows with score > 0, lowest index first
    among equal scores (as ``lax.top_k``), and their validity."""
    vals, idx = _top(score, cap)
    return idx, vals > 0


def _capacity(T: int, k: int, buckets: int, cf: float) -> int:
    c = int(math.ceil(T * k * cf / max(buckets, 1)))
    return max(8, _ceil_to(c, 8))


def _moe_local_all(p: Params, xt: torch.Tensor, ids: torch.Tensor,
                   gates: torch.Tensor, cfg, plan) -> torch.Tensor:
    """Single-device path: every expert on its top-C rows, in order."""
    e_pad = moe_layout(plan)[4]
    T, D = xt.shape
    cap = min(_capacity(T, ids.shape[-1], e_pad, plan.moe.capacity_factor),
              T)
    out = torch.zeros((T, D), dtype=xt.dtype, device=xt.device)
    wg, wu, wd = p["wg"][0], p["wu"][0], p["wd"][0]       # (E_pad, ...)
    for e in range(e_pad):
        match = ids == e                                    # (T,k)
        score = match.float().amax(-1)
        gate = torch.where(match, gates, 0.0).sum(-1)
        idx, valid = _select_topc(score, cap)
        y = _expert_ffn(wg[e], wu[e], wd[e], xt[idx], cfg.activation)
        y = y * (gate[idx] * valid)[:, None].to(y.dtype)
        out.index_add_(0, idx, y)
    return out


def moe_fwd(p: Params, x: torch.Tensor, *, cfg, plan
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D).  Returns (y (B,S,D), aux_loss)."""
    if plan.moe.expert_axes:
        raise NotImplementedError(
            "expert parallelism (_moe_model_parallel, _moe_data_model) "
            "is not ported yet: the ring serves the dense stacks")
    xt = x.reshape(-1, x.shape[-1])
    ids, gates, probs = _route(p, xt, cfg, plan)
    aux = _lb_loss(probs, ids, cfg.moe.n_experts)
    out = _moe_local_all(p, xt, ids, gates, cfg, plan)
    if "shared" in p:
        sh = p["shared"]
        out = out + _expert_ffn(sh["wg"], sh["wu"], sh["wd"], xt,
                                cfg.activation)
    return out.reshape(x.shape), aux
