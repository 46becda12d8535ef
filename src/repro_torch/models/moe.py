"""Mixture-of-Experts layer (the port of the reference's
``models/moe.py``): every expert on one device, or spread over the
model ring.

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

On the model ring (``env``; the plan's expert axes ``("model",)``) the
experts are spread as the reference's ``_moe_model_parallel`` spreads
them: rank l holds expert group ``l // ffn_split`` (``Ecell`` experts)
and FFN part ``l % ffn_split`` of each.  Tokens are whole on every rank
(gathered from the scattered activations under ESL overlap, full in
the blocking baseline), so every rank routes them alike and selects
each of its experts' top-C rows locally; the ranks' partial outputs
(and FFN parts) are added over the ring in rank order, into the
scattered form (``psum_scatter``) under overlap or whole (``psum``)
in the blocking baseline: the layer's one row-parallel sync.  A shared
expert is column-tiled like a dense MLP (``ag_matmul`` of wg|wu in one
pass, ``rs_matmul`` of wd).

A giant MoE served on a ``("data", "model")`` grid (the plan's expert
axes ``("data", "model")``, W = dwidth x tp cells) runs the reference's
``_moe_data_model``: each rank's tokens are its data row's; model column
m buckets the (token, expert) assignments whose cell has column m by
the data row that owns that cell, keeping the highest gates under each
bucket's capacity, sends the buckets and their (token, expert, gate)
records over the data ring (two ``all_to_all``), runs its own cell's
``Ecell`` experts on what it received (each expert on every received
row, masked), sends the gated results back (one ``all_to_all``) and
adds them into token order; the model ring's sum then adds the cells'
FFN parts as above.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dist, esl
from repro_torch.core.dist import AxisEnv, model_rank, on_ring, ring_axis
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


def _moe_experts(p: Params, xt: torch.Tensor, ids: torch.Tensor,
                 gates: torch.Tensor, cfg, plan, first: int = 0
                 ) -> torch.Tensor:
    """The experts ``first .. first + Ecell - 1`` held here (``p``'s
    ``(1, Ecell, ...)`` stack; on one device every expert), each on its
    top-C rows, added in expert order."""
    e_pad = moe_layout(plan)[4]
    T, D = xt.shape
    cap = min(_capacity(T, ids.shape[-1], e_pad, plan.moe.capacity_factor),
              T)
    out = torch.zeros((T, D), dtype=xt.dtype, device=xt.device)
    wg, wu, wd = p["wg"][0], p["wu"][0], p["wd"][0]       # (Ecell, ...)
    for c in range(wg.shape[0]):
        match = ids == first + c                            # (T,k)
        score = match.float().amax(-1)
        gate = torch.where(match, gates, 0.0).sum(-1)
        idx, valid = _select_topc(score, cap)
        y = _expert_ffn(wg[c], wu[c], wd[c], xt[idx], cfg.activation)
        y = y * (gate[idx] * valid)[:, None].to(y.dtype)
        out.index_add_(0, idx, y)
    return out


def _moe_data_model(p: Params, xt: torch.Tensor, ids: torch.Tensor,
                    gates: torch.Tensor, cfg, plan, env: AxisEnv
                    ) -> torch.Tensor:
    """Experts over data x model (the reference's ``_moe_data_model``):
    column ``m`` forwards an assignment (t, e) iff the (group(e), part)
    cell whose model column is ``m`` exists, i.e. ``h* = (m - group(e) *
    split) mod tp`` with ``h* < split``; its destination data row is
    ``(group(e) * split + h*) // tp``.  Returns this rank's partial
    output (T, D), before the model ring's sum."""
    tp = env.tp
    _, split, n_groups, ecell, _, _ = moe_layout(plan)
    T, D = xt.shape
    k = ids.shape[-1]
    dwidth = env.dwidth
    cap = min(_capacity(T, k, dwidth * max(1, n_groups // dwidth),
                        plan.moe.capacity_factor), T * k)
    m_idx = model_rank(env)
    dev = xt.device
    ids_f = ids.reshape(-1)                                 # (T*k,)
    gates_f = gates.reshape(-1)
    tok_of = torch.arange(T, device=dev).repeat_interleave(k)
    grp = ids_f // ecell
    h_star = torch.remainder(m_idx - grp * split, tp)
    sendable = h_star < split
    dest = (grp * split + h_star) // tp                     # (T*k,)
    bx, bm = [], []
    for dd in range(dwidth):
        score = (sendable & (dest == dd)).float()
        # prefer high-gate assignments under capacity pressure
        idx, valid = _select_topc(score * (1.0 + gates_f), cap)
        ok = valid & (score[idx] > 0)
        tok = tok_of[idx]
        bx.append(xt[tok] * ok[:, None].to(xt.dtype))
        bm.append(torch.stack([tok.float(), ids_f[idx].float(),
                               gates_f[idx] * ok], -1))
    bx = torch.stack(bx)                                    # (dwidth, cap, D)
    bm = torch.stack(bm)                                    # (dwidth, cap, 3)
    rx = dist.all_to_all(bx, env.data)
    rm = dist.all_to_all(bm, env.data)
    # this rank's cell: group g_mine, FFN part l % split (its weights)
    l = dist.axis_index(env.data) * tp + m_idx
    first = l // split * ecell
    r_ids = rm[..., 1].long()                               # (dwidth, cap)
    r_gate = rm[..., 2]
    wg, wu, wd = p["wg"][0], p["wu"][0], p["wd"][0]         # (Ecell, ...)
    y = torch.zeros_like(rx)
    for c in range(ecell):
        mask = ((r_ids == first + c) & (r_gate > 0))[..., None]
        yc = _expert_ffn(wg[c], wu[c], wd[c], rx * mask.to(rx.dtype),
                         cfg.activation)
        y = y + yc * mask.to(yc.dtype)
    y = y * r_gate[..., None].to(y.dtype)
    back = dist.all_to_all(y, env.data)
    out = torch.zeros((T, D), dtype=xt.dtype, device=dev)
    for dd in range(dwidth):
        out.index_add_(0, bm[dd, :, 0].long(), back[dd])
    return out


def moe_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
            env: Optional[AxisEnv] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D), or on the ring (``env``) (B,S,D/tp) scattered under
    ESL overlap.  Returns (y in x's convention, aux_loss).  On a grid
    whose plan spreads the experts over data x model the rows are the
    rank's data row's, dispatched by :func:`_moe_data_model`."""
    ring = on_ring(env)
    axis, tp = ring_axis(env)
    overlap = plan.esl_overlap
    data_model = len(plan.moe.expert_axes) > 1
    if data_model and (env is None or env.data is None):
        raise ValueError(
            f"experts over {plan.moe.expert_axes} need the rank's grid "
            "(the AxisEnv of a ('data', 'model') mesh)")
    xf = esl.gather_scattered(x, axis=axis, tp=tp) if overlap else x
    xt = xf.reshape(-1, xf.shape[-1])
    ids, gates, probs = _route(p, xt, cfg, plan)
    aux = _lb_loss(probs, ids, cfg.moe.n_experts)
    if data_model:
        out = _moe_data_model(p, xt, ids, gates, cfg, plan, env)
    elif ring:
        # _moe_model_parallel: this rank's expert group (and FFN part)
        _, split, _, ecell, _, _ = moe_layout(plan)
        out = _moe_experts(p, xt, ids, gates, cfg, plan,
                           first=model_rank(env) // split * ecell)
    else:
        out = _moe_experts(p, xt, ids, gates, cfg, plan)
    if ring:
        # the experts' partials and FFN parts, added over the ring
        out = (dist.psum_scatter(out, axis, dim=-1) if overlap
               else dist.psum(out, axis))
    if "shared" in p:
        sh = p["shared"]
        if ring:
            gg, uu = esl.ag_matmuls(x.reshape(-1, x.shape[-1]),
                                    (sh["wg"], sh["wu"]), axis=axis, tp=tp,
                                    overlap=overlap)
            out = out + esl.rs_matmul(activate(gg, cfg.activation) * uu,
                                      sh["wd"], axis=axis, tp=tp,
                                      overlap=overlap, scatter_out=overlap)
        else:
            out = out + _expert_ffn(sh["wg"], sh["wu"], sh["wd"], xt,
                                    cfg.activation)
    return out.reshape(x.shape), aux
