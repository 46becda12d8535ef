"""Step builders: the port of the reference's ``core/steps.py``
``build_train_step`` (its local, ``mesh=None``, path),
``build_prefill_step`` and ``build_serve_step`` (at tp=1 and on the
model ring).

* ``train_step(params, opt_state, batch)`` — forward and backward in
  eager autograd, the optional microbatched accumulation, then the
  optimizer's update in place; returns (params, opt_state, {"loss",
  "aux", "grad_norm", "lr"}).

These are the entry points that feed a family's extra inputs: whisper's
encoder ``frames`` and a vlm's ``patch_embeds`` (the engine serves a vlm
as a text decoder and refuses an encoder-decoder), over the model's
dense cache (``model.init_cache(batch, max_seq)``), which both steps
update in place.

* ``prefill_step(params, cache, tokens, frames=None, patch_embeds=None)``
  — the summarization stage: the prompt (B, S) (after n_patches patch
  rows for a vlm) fills the cache; returns (the greedy next token (B,)
  int32, cache).  ``frames`` reach only an encoder-decoder and
  ``patch_embeds`` only a vlm, as in the reference.
* ``serve_step(params, cache, tokens, positions)`` — one generation
  step: tokens (B, 1) at ``positions`` (B,), each row's resident length
  (for a vlm it counts the patches); returns (next token (B,), cache).

The serving steps' ring form (the reference's ``shard_map`` steps):
``mesh`` is the rank's :class:`repro_torch.core.dist.Ring` inside
:func:`repro_torch.core.dist.run_ranks`, the model planned for
``("model",), (tp,)``, ``params`` the rank's shards
(:func:`repro_torch.weights.init_shard`) and the cache the model's
``init_cache`` at the rank's heads.  Each rank's step returns the same
global greedy token: the argmax of its vocab columns, all-gathered
with its value, the first index among equal maxima.

On a ``("data", "model")`` grid (the model planned for ``("data",
"model"), (dwidth, tp)``, ``mesh`` the world ring of ``dwidth * tp``
ranks) the steps take the global batch: a rank runs its data row's
rows when the batch splits over ``data`` (``meta["env"].dp``), or the
whole batch when it does not (a hybrid at batch 1 whose KV sequence is
sharded over ``data``), and one ``all_gather`` over ``data`` returns
every row's token on every rank (the reference's ``out_specs=P(dp)``).
Its cache is ``model.init_cache(batch, max_seq, env=meta["env"])``.

The train step on a mesh (the reference's ``shard_map`` step): ``mesh``
is the rank's ring, the model planned in train mode for the ring or
the grid, the parameters the rank's shards (on a grid each
FSDP-sharded over ``data`` as well); see :func:`build_train_step`.  The
int8 gradient sync over a pod axis raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.core import dist
from repro_torch.core.dist import AxisEnv, make_axis_env, on_ring
from repro_torch.device import dtype_of
from repro_torch.models.common import map_leaves
from repro_torch.models.transformer import EMBED_GROUP, sharded_xent
from repro_torch.tree import tree_flatten, tree_paths
from repro_torch.weights import leaf_axes, mesh_axes_of

Params = Dict[str, Any]


def _greedy(logits: torch.Tensor, env: AxisEnv) -> torch.Tensor:
    """(B, S, V_pad) -> (B,) int32 argmax of the last row (the first
    index among equal values, as ``jnp.argmax``).  On the ring the
    logits are the rank's (B, S, V_pad/tp) columns: each rank's local
    max and its global index are all-gathered (rank order), and the
    first index among equal maxima wins, the tp=1 argmax."""
    lg = logits[:, -1].float()
    loc_idx = lg.argmax(-1)
    if not on_ring(env):
        return loc_idx.to(torch.int32)
    v_loc = lg.shape[-1]
    loc_val = lg.gather(-1, loc_idx[:, None])
    glob = loc_idx[:, None] + dist.model_rank(env) * v_loc
    vals = dist.all_gather(loc_val, env.model, dim=-1)       # (B, tp)
    globs = dist.all_gather(glob, env.model, dim=-1)         # (B, tp)
    best = vals.argmax(-1)
    return globs.gather(-1, best[:, None])[:, 0].to(torch.int32)


def _rows(env: AxisEnv, batch: int) -> slice:
    """The global batch rows this rank runs: its data row's block when
    the batch is split over ``data``, else every row."""
    if not env.dp:
        return slice(None)
    if batch % env.dp_width:
        raise ValueError(f"a batch of {batch} does not split over "
                         f"{env.dp_width} data rows")
    per = batch // env.dp_width
    d = dist.axis_index(env.data)
    return slice(d * per, (d + 1) * per)


def _all_rows(tok: torch.Tensor, env: AxisEnv) -> torch.Tensor:
    """Every data row's tokens (B,), in row order, on every rank."""
    return dist.all_gather(tok, env.data, dim=0) if env.dp else tok


def _serving_env(model, mesh, batch: int, what: str) -> AxisEnv:
    """The serving step's AxisEnv: tp 1 without a mesh, else the
    rank's ``mesh`` (a :class:`repro_torch.core.dist.Ring` of the plan's
    tp, or the world ring of a grid)."""
    if mesh is not None and not isinstance(mesh, dist.Ring):
        raise TypeError(f"{what}: mesh is the rank's repro_torch.core."
                        f"dist.Ring (run_ranks), not a "
                        f"{type(mesh).__name__}")
    if mesh is not None and model.plan.mesh_axes is None:
        raise ValueError(f"{what}: a ring needs a plan built for it "
                         "(mesh_axes ('model',) or ('data', 'model'))")
    return make_axis_env(model.plan, batch=batch, ring=mesh)


# ---------------------------------------------------------------------------
# FSDP bookkeeping derived from the plan's rule table
# ---------------------------------------------------------------------------

_STACK_GROUPS = {"blocks": "block", "enc_blocks": "enc_block",
                 "dec_blocks": "dec_block"}


def _fsdp_dim(path: str, plan):
    """The FSDP-sharded dim of the leaf at ``path`` (None where it is
    not FSDP'd): the dim whose logical axis the rule table maps to
    exactly the plan's ``fsdp_axes``."""
    fsdp = tuple(plan.fsdp_axes)
    if not fsdp:
        return None
    for i, a in enumerate(leaf_axes(path)):
        r = plan.rules.get(a)
        if r is not None and ((r,) if isinstance(r, str)
                              else tuple(r)) == fsdp:
            return i
    return None


def fsdp_dims_tree(params: Params, plan) -> Params:
    """Per-leaf index of the FSDP-sharded dim (None where the leaf is
    not FSDP'd)."""
    return map_leaves(params, lambda t, path: _fsdp_dim(path, plan))


def _drop_lead(dims: Params) -> Params:
    """Stacked-layer dims -> the dims of one layer's views."""
    return map_leaves(dims, lambda d, _: None if d is None else d - 1)


def make_gather_fn(plan, env: AxisEnv, dims: Params) -> Callable:
    """``gather_fn(group, subtree)``: each leaf of ``subtree`` (the
    ``"embed"`` group's top-level leaves, or one layer's views of the
    ``"block"``, ``"enc_block"`` or ``"dec_block"`` stack) all-gathered
    over the data ring on its FSDP dim, then cast to
    ``plan.compute_dtype`` (the masters stay as they are)."""
    groups = {g: _drop_lead(dims[k]) for k, g in _STACK_GROUPS.items()
              if k in dims}
    groups["embed"] = {k: v for k, v in dims.items() if k in EMBED_GROUP}
    compute = dtype_of(plan.compute_dtype)

    def cast(w, _):
        if w.is_floating_point() and w.dtype != compute:
            return w.to(compute)
        return w

    def gather_fn(group: str, subtree: Params) -> Params:
        return map_leaves(dist.gather_tree(subtree, env, groups[group]),
                          cast)
    return gather_fn


def _check_heads(plan) -> None:
    """A ring trains the logical heads one to one: a padded head's
    output projection would take a gradient (its query is zero, its
    attention uniform), and duplicated kv heads would part after an
    update, so such a layout raises."""
    a = plan.attn
    if plan.tp <= 1 or a is None:
        return
    q, kv = list(a.q_orig), list(a.kv_orig)
    if min(q) < 0 or min(kv) < 0 or len(set(kv)) != len(kv):
        raise NotImplementedError(
            f"training at tp={plan.tp} with {a.n_heads} heads over "
            f"{a.n_kv_heads} kv heads: the ring's layout pads or "
            "duplicates heads, whose training is not ported (pick a tp "
            "that divides both)")


def build_train_step(model, optimizer, mesh, global_batch: int,
                     aux_weight: float = 0.01, accum_steps: int = 1,
                     compress_pod_grads: bool = False
                     ) -> Tuple[Callable, Dict[str, Any]]:
    """fwd + bwd (+ microbatched gradient accumulation) + optimizer.

    The loss is the token-mean cross-entropy ``lsum / max(cnt, 1)`` plus
    ``aux_weight`` times the MoE auxiliary loss averaged over the
    layers; a vlm's patch rows carry label -1 (no loss).  Floating
    leaves are cast to ``plan.compute_dtype`` inside the differentiated
    region, so the gradients, like the masters, keep the parameters'
    dtype (the reference's ``gather_cast``).  ``accum_steps > 1`` splits
    the batch into that many microbatches along rows and accumulates
    their gradients in float32, then divides by ``accum_steps`` (as the
    loss and aux).

    ``optimizer.apply(params, grads, opt_state, norm_sq=...)`` returns
    (params, opt_state, metrics); the step adds its metrics to the
    loss's.  One path serves every mesh: with no ring the syncs, the
    psums and the data mean are identities and ``norm_sq`` sums every
    leaf's squares.

    On a mesh (``mesh`` the rank's :class:`repro_torch.core.dist.Ring`
    inside :func:`repro_torch.core.dist.run_ranks`, the model planned
    in train mode for ``("model",), (tp,)`` or ``("data", "model"),
    (dwidth, tp)``) every rank runs the step on its shards
    (:func:`repro_torch.weights.init_shard`) and its data row's rows of
    the global batch (``batch`` holds only those rows).  The forward gathers the FSDP-sharded parameters over
    ``data`` (:func:`make_gather_fn`); the loss is ``psum(lsum) /
    psum(cnt)`` over the data ring; each rank's copy of the objective is
    seeded with ``1 / ranks``, so with the collectives' adjoint
    backward (:mod:`repro_torch.core.dist`) the shares of every rank add
    to the gradient of the objective counted once.  The gathers'
    backward reduce-scatters an FSDP'd leaf's gradient to its shard; a
    leaf replicated over ``data`` or over ``model`` has its shares
    summed over that ring (the reference's ``_sync_grads``, which sums
    over ``data`` only).  The optimizer gets ``norm_sq``, the squared
    global norm summed over the world with a replicated leaf counted
    once.  ``aux`` reports the data rows' mean.  The result is the tp=1
    step's; an MoE on a data axis routes each data row's tokens with
    its own capacity and auxiliary loss, as the reference's mesh step
    does.  A pod axis and its int8 sync (``compress_pod_grads``)
    raise."""
    if compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads: the int8 sync (compressed_psum) runs over "
            "a pod axis, which the port's meshes do not have")
    cfg, plan = model.cfg, model.plan
    if mesh is not None:
        if not isinstance(mesh, dist.Ring):
            raise TypeError("build_train_step: mesh is the rank's "
                            "repro_torch.core.dist.Ring (run_ranks), not a "
                            f"{type(mesh).__name__}")
        if plan.mesh_axes is None:
            raise ValueError("build_train_step: a ring needs a plan built "
                             "for it (mesh_axes ('model',) or ('data', "
                             "'model'))")
        _check_heads(plan)
    env = make_axis_env(plan, batch=global_batch, ring=mesh) \
        if mesh is not None else AxisEnv(None, 1)
    fwd_env = env if mesh is not None else None
    compute = dtype_of(plan.compute_dtype)
    n_ranks = env.ranks

    def loss_fn(p, mb, gather_fn):
        logits, _, aux = model.forward(
            p, mb["tokens"], mode="train", frames=mb.get("frames"),
            patch_embeds=mb.get("patch_embeds"), with_aux=True,
            env=fwd_env, gather_fn=gather_fn)
        labels = mb["labels"]
        if "patch_embeds" in mb:
            # the image prefix carries no next-token loss
            pad = torch.full(mb["patch_embeds"].shape[:2], -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], 1)
        lsum, cnt = sharded_xent(logits, labels, env)
        lsum, cnt = dist.psum_dp(lsum, env), dist.psum_dp(cnt, env)
        loss = lsum / torch.clamp(cnt, min=1).float()
        aux_m = aux / max(cfg.n_layers, 1)
        return loss + aux_weight * aux_m, loss, aux_m

    meta: Dict[str, Any] = {"global_batch": global_batch,
                            "accum_steps": accum_steps, "env": env}
    cache: Dict[str, Any] = {}

    def layout(params):
        """The params' leaves' FSDP dims, rings to sync over and norm
        counting in flatten order, and the gather_fn; made once."""
        if not cache:
            paths = tree_paths(params)
            cache.update(
                dims=[_fsdp_dim(p, plan) for p in paths],
                gather=(make_gather_fn(plan, env,
                                       fsdp_dims_tree(params, plan))
                        if env.fsdp else None),
                sync=[_sync_axes(p, plan, env) for p in paths],
                counted=[_counted(p, plan, env) for p in paths])
        return cache

    def grads_of(params, mb):
        lay = layout(params)
        leaves, treedef = tree_flatten(params)
        xs = [p.detach().requires_grad_() if p.is_floating_point() else p
              for p in leaves]
        diff = [x for x in xs if x.requires_grad]
        gather_fn = lay["gather"]
        # an FSDP'd leaf is gathered as the f32 master, then cast
        cast = [x.to(compute) if x.is_floating_point() and
                (gather_fn is None or lay["dims"][i] is None) else x
                for i, x in enumerate(xs)]
        total, loss, aux = loss_fn(treedef.unflatten(cast), mb, gather_fn)
        seed = (torch.full_like(total, 1.0 / n_ranks) if n_ranks > 1
                else None)
        got = iter(torch.autograd.grad(total, diff, grad_outputs=seed,
                                       allow_unused=True))
        grads = []
        for x in xs:
            g = next(got) if x.requires_grad else None
            # a leaf the loss does not reach has a zero gradient
            grads.append(torch.zeros_like(x) if g is None else g)
        return treedef.unflatten(grads), loss.detach(), aux.detach()

    def inner(params, batch):
        if accum_steps <= 1:
            return grads_of(params, batch)
        rows = batch["tokens"].shape[0]
        if rows % accum_steps:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{accum_steps} microbatches")
        per = rows // accum_steps
        leaves, treedef = tree_flatten(params)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss = aux = torch.zeros((), dtype=torch.float32,
                                 device=leaves[0].device)
        for i in range(accum_steps):
            mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
            g, l_, a = grads_of(params, mb)
            for s, gl in zip(acc, tree_flatten(g)[0]):
                s.add_(gl.float())
            loss, aux = loss + l_, aux + a
        grads = treedef.unflatten([s / accum_steps for s in acc])
        return grads, loss / accum_steps, aux / accum_steps

    def sync_grads(grads):
        """Sum the shares of a leaf replicated over a ring (FSDP'd
        leaves were reduce-scattered by their gathers' backward)."""
        leaves, treedef = tree_flatten(grads)
        out = []
        for g, axes in zip(leaves, cache["sync"]):
            for ring in axes:
                g = dist.psum(g, ring)
            out.append(g)
        return treedef.unflatten(out)

    def norm_sq(gs):
        """The squared global norm: each rank's squares of the leaves it
        counts, summed over the world."""
        local = torch.zeros((), dtype=torch.float32, device=gs[0].device)
        for g, mine in zip(gs, cache["counted"]):
            if mine:
                local = local + torch.sum(torch.square(g.float()))
        return dist.psum(local, env.world)

    def step(params, opt_state, batch):
        grads, loss, aux = inner(params, _rank_rows(batch, env,
                                                    global_batch))
        params, opt_state, gmetrics = optimizer.apply(
            params, sync_grads(grads), opt_state, norm_sq=norm_sq)
        return params, opt_state, {"loss": loss,
                                   "aux": dist.pmean_dp(aux, env),
                                   **gmetrics}

    return step, meta


def _sync_axes(path: str, plan, env: AxisEnv) -> List[dist.Ring]:
    """The rings over which a leaf's gradient shares are summed: ``data``
    where the leaf is not sharded over it, ``model`` likewise."""
    axes = mesh_axes_of(path, plan)
    out = []
    if env.data is not None and env.dwidth > 1 and "data" not in axes:
        out.append(env.data)
    if on_ring(env) and "model" not in axes:
        out.append(env.model)
    return out


def _counted(path: str, plan, env: AxisEnv) -> bool:
    """Whether this rank counts the leaf in the global norm: a leaf
    replicated over a ring is counted by that ring's rank 0 only."""
    axes = mesh_axes_of(path, plan)
    if env.data is not None and "data" not in axes and env.data.rank:
        return False
    if on_ring(env) and "model" not in axes and env.model.rank:
        return False
    return True


def _rank_rows(batch: Dict[str, torch.Tensor], env: AxisEnv,
               global_batch: int) -> Dict[str, torch.Tensor]:
    """The batch, checked to hold this rank's data row's share of the
    global batch."""
    rows = batch["tokens"].shape[0]
    if rows * env.dp_width != global_batch:
        raise ValueError(f"a batch of {rows} rows is not a data row's share "
                         f"of the global batch {global_batch} over "
                         f"{env.dp_width} rows")
    return batch


def build_serve_step(model, mesh, batch: int, max_seq: int
                     ) -> Tuple[Callable, Dict[str, Any]]:
    """One-token generation step (the LPU's target loop)."""
    env = _serving_env(model, mesh, batch, "build_serve_step")

    @torch.no_grad()
    def step(params, cache, tokens, positions):
        rows = _rows(env, tokens.shape[0])
        logits, cache = model.forward(params, tokens[rows], mode="decode",
                                      positions=positions[rows],
                                      cache=cache, env=env)
        return _all_rows(_greedy(logits, env), env), cache

    return step, {"batch": batch, "max_seq": max_seq, "env": env}


def build_prefill_step(model, mesh, batch: int, max_seq: int
                       ) -> Tuple[Callable, Dict[str, Any]]:
    """Summarization stage: consume the prompt, emit the cache and the
    greedy token of its last row."""
    env = _serving_env(model, mesh, batch, "build_prefill_step")
    family = model.cfg.family

    @torch.no_grad()
    def step(params, cache, tokens, frames=None, patch_embeds=None):
        rows = _rows(env, tokens.shape[0])
        frames = frames[rows] if family == "encdec" and \
            frames is not None else None
        patch_embeds = patch_embeds[rows] if family == "vlm" and \
            patch_embeds is not None else None
        logits, cache = model.forward(
            params, tokens[rows], mode="prefill", cache=cache,
            frames=frames, patch_embeds=patch_embeds, env=env)
        return _all_rows(_greedy(logits, env), env), cache

    return step, {"batch": batch, "max_seq": max_seq, "env": env}
