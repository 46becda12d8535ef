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

A mesh in the train step raises ``NotImplementedError`` (FSDP and the
gradient sync are not ported), as does its int8 gradient sync over a
pod axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core import dist
from repro_torch.core.dist import AxisEnv, make_axis_env, on_ring
from repro_torch.device import dtype_of
from repro_torch.models.transformer import sharded_xent
from repro_torch.tree import tree_flatten

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


def _local(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: a mesh is not ported to the train step yet (FSDP "
            "gathers and the gradient sync); pass mesh=None")


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
    dtype (the reference's ``gather_cast`` at tp=1).  ``accum_steps >
    1`` splits the batch into that many microbatches along rows and
    accumulates their gradients in float32, then divides by
    ``accum_steps`` (as the loss and aux).

    ``optimizer.apply(params, grads, opt_state)`` returns (params,
    opt_state, metrics); the step adds its metrics to the loss's."""
    _local(mesh, "build_train_step")
    if compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads: the int8 sync runs over a pod axis, which "
            "arrives with the port's mesh slice")
    cfg, plan = model.cfg, model.plan
    compute = dtype_of(plan.compute_dtype)

    def loss_fn(p, mb):
        logits, _, aux = model.forward(
            p, mb["tokens"], mode="train", frames=mb.get("frames"),
            patch_embeds=mb.get("patch_embeds"), with_aux=True)
        labels = mb["labels"]
        if "patch_embeds" in mb:
            # the image prefix carries no next-token loss
            pad = torch.full(mb["patch_embeds"].shape[:2], -1,
                             dtype=labels.dtype, device=labels.device)
            labels = torch.cat([pad, labels], 1)
        lsum, cnt = sharded_xent(logits, labels)
        loss = lsum / torch.clamp(cnt, min=1).float()
        aux_m = aux / max(cfg.n_layers, 1)
        return loss + aux_weight * aux_m, loss, aux_m

    def grads_of(params, mb):
        leaves, treedef = tree_flatten(params)
        xs = [p.detach().requires_grad_() if p.is_floating_point() else p
              for p in leaves]
        diff = [x for x in xs if x.requires_grad]
        cast = [x.to(compute) if x.is_floating_point() else x for x in xs]
        total, loss, aux = loss_fn(treedef.unflatten(cast), mb)
        got = iter(torch.autograd.grad(total, diff, allow_unused=True))
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

    def step(params, opt_state, batch):
        grads, loss, aux = inner(params, batch)
        metrics = {"loss": loss, "aux": aux}
        params, opt_state, gmetrics = optimizer.apply(params, grads,
                                                      opt_state)
        metrics.update(gmetrics)
        return params, opt_state, metrics

    return step, {"global_batch": global_batch, "accum_steps": accum_steps}


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
