"""Rank functions of the tests of training on a mesh of ranks
(``tests/test_torch_train_mesh.py`` and
``tests/test_torch_train_mesh_families.py`` on the CPU,
``tests/test_torch_train_mesh_cuda.py`` on 4 cards).

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, import nothing of JAX or of ``tests.`` (the card
machine's copy imports this file by path) and take only picklable
arguments: numpy trees in the tp=1 layout, numpy batches and dicts of
knobs.

A case trains a reduced config on one mesh: ``shape`` is ``(tp,)`` for
the ``("model",)`` ring or ``(dwidth, tp)`` for the ``("data",
"model")`` grid.  Each rank takes its shard of the tp=1 tree (relaid
to the mesh's layout, then cut by the plan's rule table), runs the
port's train step, and the case's record holds the loss, the metrics,
and the gradients or parameters gathered to the plan's global tensors
and relaid to the tp=1 layout, as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

TRAIN_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


class FirstGrads:
    """An optimizer that keeps a copy of the gradients of its first
    update and applies the wrapped one."""

    def __init__(self, opt):
        self.opt, self.first = opt, None

    def apply(self, params, grads, state, norm_sq):
        from repro_torch.tree import tree_map
        if self.first is None:
            self.first = tree_map(lambda g: g.detach().clone(), grads)
        return self.opt.apply(params, grads, state, norm_sq=norm_sq)


class PassThrough:
    """An optimizer whose update returns the gradients as the
    parameters, and the global norm the step's ``norm_sq`` gives."""

    def apply(self, params, grads, state, norm_sq):
        from repro_torch.tree import tree_leaves
        return grads, state, {
            "grad_norm": torch.sqrt(norm_sq(tree_leaves(grads)))}


def mesh_plan(cfg, shape, overlap=False, **kw):
    """The port's train plan of ``cfg`` on ``shape``: ``None`` (one
    device), ``(tp,)`` (the model ring) or ``(dwidth, tp)`` (the
    grid)."""
    from repro_torch.compiler.mapper import plan_model
    kw = dict(TRAIN_F32, **kw)
    if shape is None:
        return plan_model(cfg, None, (1,), "train", esl_overlap=overlap,
                          **kw)
    axes = ("model",) if len(shape) == 1 else ("data", "model")
    return plan_model(cfg, axes, tuple(shape), "train",
                      esl_overlap=overlap, **kw)


def case_cfg(name, depth=None):
    """The port's reduced ``name``, or its full-width config cut to
    ``depth`` layers."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=depth) if depth else \
        cfg.reduced()


def to_torch(tree, device="cpu"):
    return {k: to_torch(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, copy=True)).to(device)
            for k, v in tree.items()}


def to_numpy(tree):
    return {k: to_numpy(v) if isinstance(v, dict)
            else v.detach().float().cpu().numpy() for k, v in tree.items()}


def rank_shard(ring, cfg, plan, tree, device="cpu"):
    """This rank's shard of the tp=1 numpy ``tree`` on ``plan``'s mesh."""
    from repro_torch.weights import relayout, shard_params, tp1_plan
    full = relayout(to_torch(tree, device), cfg, tp1_plan(cfg, plan), plan)
    return shard_params(full, plan, ring.rank)


def global_tp1(tree, cfg, plan, env):
    """A tree of shards gathered to the plan's global tensors and relaid
    to the tp=1 layout, as numpy (every rank gathers)."""
    from repro_torch.weights import gather_shard, relayout, tp1_plan
    full = gather_shard(tree, plan, env)
    return to_numpy(relayout(full, cfg, plan, tp1_plan(cfg, plan)))


def _batch(case, device="cpu"):
    return {k: torch.from_numpy(v).to(device)
            for k, v in case["batch"].items()}


def run_case(ring, case, device="cpu"):
    """One case on ``ring`` (the world of ``prod(shape)`` ranks): the
    port's train step, with the pass-through optimizer (``steps`` 1,
    the record's ``grads``) or AdamW (the record's ``params`` after
    ``steps`` steps and each step's metrics).  Keys of ``case``:
    ``name``, ``shape``, ``tree``, ``batch`` (or ``batches``, one a
    step), optional ``overlap``, ``remat``, ``accum``, ``compute``,
    ``aux_weight``, ``adamw`` (lr), ``steps``, ``depth``."""
    from repro_torch.core.steps import build_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, get_schedule
    cfg = case_cfg(case["name"], case.get("depth"))
    kw = {}
    if "remat" in case:
        kw["remat"] = case["remat"]
    if "compute" in case:
        kw["compute_dtype"] = case["compute"]
    plan = mesh_plan(cfg, case["shape"], case.get("overlap", False), **kw)
    model = build_model(cfg, plan, device)
    params = rank_shard(ring, cfg, plan, case["tree"], device)
    steps = case.get("steps", 1)
    if case.get("adamw"):
        opt = FirstGrads(AdamW(lr=get_schedule("cosine", case["adamw"], 1,
                                               10)))
        state = opt.opt.init(params)
    else:
        opt, state = PassThrough(), None
    batches = case.get("batches") or [case["batch"]] * steps
    gb = batches[0]["tokens"].shape[0]
    step, meta = build_train_step(model, opt, ring, gb,
                                  aux_weight=case.get("aux_weight", 0.01),
                                  accum_steps=case.get("accum", 1))
    env = meta["env"]
    # the step takes this rank's data row's rows of the global batch
    per = gb // env.dp_width
    lo = per * (env.data.rank if env.data is not None else 0)
    metrics = []
    for b in batches[:steps]:
        mine = {k: v[lo:lo + per] for k, v in b.items()}
        out, state, m = step(params, state,
                             _batch(dict(case, batch=mine), device))
        metrics.append({k: float(v) for k, v in m.items()})
        if case.get("adamw"):
            params = out
    rec = {"metrics": metrics}
    if case.get("adamw"):
        rec["params"] = global_tp1(params, cfg, plan, env)
        rec["grads1"] = global_tp1(opt.first, cfg, plan, env)
        rec["replicas"] = replica_digest(params, plan, env)
    else:
        rec["grads"] = global_tp1(out, cfg, plan, env)
    if case.get("ckpt_dir"):
        from repro_torch.checkpoint.checkpoint import CheckpointManager
        from repro_torch.weights import gather_shard
        tree = {"params": params, "opt": state}
        CheckpointManager(case["ckpt_dir"]).save(
            steps - 1, tree, extra={"next_step": steps},
            shard=(plan, env))
        rec["state"] = {k: to_numpy(gather_shard(t, plan, env))
                        for k, t in (("params", params), ("m", state.m),
                                     ("v", state.v))}
    return rec


def run_tp1(case, device="cpu"):
    """The port's tp=1 step on ``case`` (its tree, batches, optimizer
    and knobs; no mesh): {"metrics", "grads" or "params"} as numpy."""
    from repro_torch.core.steps import build_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import AdamW, get_schedule
    cfg = case_cfg(case["name"], case.get("depth"))
    kw = {}
    if "remat" in case:
        kw["remat"] = case["remat"]
    if "compute" in case:
        kw["compute_dtype"] = case["compute"]
    model = build_model(cfg, mesh_plan(cfg, None, **kw), device)
    params = to_torch(case["tree"], device)
    steps = case.get("steps", 1)
    if case.get("adamw"):
        opt = FirstGrads(AdamW(lr=get_schedule("cosine", case["adamw"], 1,
                                               10)))
        state = opt.opt.init(params)
    else:
        opt, state = PassThrough(), None
    batches = case.get("batches") or [case["batch"]] * steps
    step, _ = build_train_step(model, opt, None,
                               batches[0]["tokens"].shape[0],
                               aux_weight=case.get("aux_weight", 0.01),
                               accum_steps=case.get("accum", 1))
    metrics = []
    for b in batches[:steps]:
        out, state, m = step(params, state, _batch(dict(case, batch=b),
                                                  device))
        metrics.append({k: float(v) for k, v in m.items()})
        if case.get("adamw"):
            params = out
    if case.get("adamw"):
        return {"metrics": metrics, "params": to_numpy(out),
                "grads1": to_numpy(opt.first)}
    return {"metrics": metrics, "grads": to_numpy(out)}


def adam_params_err(got, want, lr):
    """Parameters after AdamW steps against their twin's.  AdamW moves
    an element by up to ``lr`` a step whatever its gradient's size, so
    where an element's gradient is rounding (the twins' gradients differ
    at ~1e-6 x max) its update may differ by up to 2 x lr; the
    gradients themselves are held strictly elsewhere.  Returns (the
    largest share of a leaf's elements past 1e-5 x its max, that leaf,
    the largest |got - want| / lr)."""
    flat_g = dict(_flat(got))
    share, at, loose = 0.0, None, 0.0
    for k, w in _flat(want):
        d = np.abs(flat_g[k] - w)
        past = float(np.mean(d > 1e-5 * (float(np.abs(w).max()) or 1.0)))
        if past > share:
            share, at = past, k
        loose = max(loose, float(d.max()) / lr)
    return share, at, loose


def max_leaf_err(got, want):
    """(largest |got - want| / max |want| over the leaves, its path),
    leaves whose ``want`` is below 1e-6 x the tree's largest (round-off
    of a zero gradient) left out."""
    flat_g, flat_w = dict(_flat(got)), dict(_flat(want))
    top = max(float(np.abs(v).max()) for v in flat_w.values())
    worst, at = 0.0, None
    for k, w in flat_w.items():
        scale = float(np.abs(w).max())
        if scale < 1e-6 * top:
            continue
        e = float(np.abs(flat_g[k] - w).max()) / scale
        if e > worst:
            worst, at = e, k
    return worst, at


def _flat(tree, path=""):
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            yield from _flat(v, p)
        else:
            yield p, np.asarray(v)


def card_rank(ring, spec):
    """The card test's rank function (rehearsed on gloo on the CPU):
    ``spec["cases"]`` on this world (TF32 off on a card), then rank 0
    runs the port's tp=1 step of each case on its own device and
    returns, per case, the losses and the largest leaf error of the
    gathered gradients or parameters against it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    recs = {c["key"]: run_case(ring, c, ring.device) for c in spec["cases"]}
    out = {}
    if ring.rank == 0:
        for c in spec["cases"]:
            want = run_tp1(c, ring.device)
            got = recs[c["key"]]
            if c.get("adamw"):
                share, at, loose = adam_params_err(
                    got["params"], want["params"], c["adamw"])
                err = max_leaf_err(got["grads1"], want["grads1"]) + (
                    share, at, loose / (2 * c.get("steps", 1)))
            else:
                err = max_leaf_err(got["grads"], want["grads"]) + (
                    0.0, None, 0.0)
            out[c["key"]] = {
                "losses": [m["loss"] for m in got["metrics"]],
                "tp1_losses": [m["loss"] for m in want["metrics"]],
                "err": err, "replicas": got.get("replicas")}
    ring.gather_object(None)
    return out


def replica_digest(params, plan, env):
    """For every leaf, whether it is bit-equal on every rank of each
    ring it is replicated over (the world's records compared on rank
    0): {path: bool}."""
    from repro_torch.weights import _leaves, mesh_axes_of
    out = {}
    for path, t in _leaves(params):
        axes = mesh_axes_of(path, plan)
        same = True
        for name in ("data", "model"):
            ring = env.axis(name)
            if ring is None or ring.size < 2 or name in axes:
                continue
            parts = ring.gather_object(t.detach().cpu().numpy().tobytes())
            same = same and all(p == parts[0] for p in parts)
        out[path] = same
    return out


def make_batch(cfg, rows=4, seq=16, seed=0, ignored=3):
    """numpy batch from ``default_rng(seed)``: tokens and labels (the
    first ``ignored`` labels of row 0 are -1), whisper's frames, a vlm's
    patch embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, seq), dtype=np.int32)
    labels = rng.integers(0, cfg.vocab_size, (rows, seq), dtype=np.int32)
    labels[0, :ignored] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = (0.1 * rng.standard_normal(
            (rows, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)
    if cfg.vlm is not None:
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (rows, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim))
        ).astype(np.float32)
    return batch


def mesh_tree(tree, cfg, shape, **plan_kw):
    """The tp=1 numpy ``tree`` stored at the mesh plan's layout (the
    plan's global tensors), as numpy."""
    from repro_torch.weights import relayout, tp1_plan
    plan = mesh_plan(cfg, shape, **plan_kw)
    return to_numpy(relayout(to_torch(tree), cfg, tp1_plan(cfg, plan), plan))


def tp1_tree(tree, cfg, shape, **plan_kw):
    """A mesh plan's global numpy ``tree`` relaid to the tp=1 layout."""
    from repro_torch.weights import relayout, tp1_plan
    plan = mesh_plan(cfg, shape, **plan_kw)
    return to_numpy(relayout(to_torch(tree), cfg, plan, tp1_plan(cfg, plan)))


# The reference's train step on a mesh of fake host devices, run by
# ``tests/util.py`` ``run_multidevice`` with ``IN``/``OUT`` file paths:
# each case's gradients through a pass-through optimizer (global arrays
# at the mesh plan's layout) and its metrics, pickled.
REFERENCE_MESH = """
import pickle
import numpy as np, jax, jax.numpy as jnp
from repro.core.compat import make_mesh
from repro.compiler.mapper import plan_model
from repro.configs import get_config
from repro.core.steps import build_train_step
from repro.models.registry import build_model


class PassThrough:
    def apply(self, params, grads, state):
        return grads, state, {}


with open(IN, "rb") as f:
    cases = pickle.load(f)
out = {}
for c in cases:
    cfg = get_config(c["name"]).reduced()
    axes = ("model",) if len(c["shape"]) == 1 else ("data", "model")
    plan = plan_model(cfg, axes, c["shape"], "train", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan)
    mesh = make_mesh(c["shape"], axes)
    step, _ = build_train_step(model, PassThrough(), mesh,
                               c["batch"]["tokens"].shape[0])
    g, _, m = jax.jit(step)(jax.tree.map(jnp.asarray, c["tree"]), None,
                            {k: jnp.asarray(v) for k, v in c["batch"].items()})
    out[c["key"]] = (jax.tree.map(np.asarray, g),
                     {k: float(v) for k, v in m.items()})
with open(OUT, "wb") as f:
    pickle.dump(out, f)
"""


def cases_rank(ring, cases):
    """Every case of ``cases`` (each on a mesh of ``ring.size`` ranks),
    in order, on this world's devices: {key: record} (rank 0's)."""
    return {c["key"]: run_case(ring, c, ring.device) for c in cases}


def mesh_rank(ring, jobs):
    """``jobs["cases"]`` (:func:`cases_rank`) and, with
    ``jobs["adjoints"]``, :func:`adjoint_errors` on the world ring."""
    out = {"cases": cases_rank(ring, jobs.get("cases", []))}
    if jobs.get("adjoints"):
        out["adjoints"] = ring.gather_object(adjoint_errors(ring))
    return out


def adjoint_errors(ring, seed=5):
    """For each collective and ESL product under autograd: this rank's
    gradient of the objective sum_r <out_r, y_r> (each rank seeds its
    own term) against the same gradient of the objective written
    out in plain torch over every rank's inputs (gathered outside
    autograd).  Returns {name: max abs difference}."""
    from repro_torch.core import dist, esl
    n, r = ring.size, ring.rank
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    def every(make):
        return [make() for _ in range(n)]       # every rank's, in order
    perm = [(i, (i + 1) % n) for i in range(n)]
    src = {d: s for s, d in perm}
    d_in, cols = 4 * n, 3 * n
    cases = {
        "all_gather_last": (every(lambda: rand(2, 3)),
                            lambda x: dist.all_gather(x, ring, dim=-1),
                            lambda X, q: torch.cat(X, -1)),
        "all_gather_0": (every(lambda: rand(2, 3)),
                         lambda x: dist.all_gather(x, ring, dim=0),
                         lambda X, q: torch.cat(X, 0)),
        "psum": (every(lambda: rand(2, 3)),
                 lambda x: dist.psum(x, ring),
                 lambda X, q: sum(X)),
        "pmean": (every(lambda: rand(2, 3)),
                  lambda x: dist.pmean(x, ring),
                  lambda X, q: sum(X) / n),
        "psum_scatter": (every(lambda: rand(2, 2 * n)),
                         lambda x: dist.psum_scatter(x, ring, dim=-1),
                         lambda X, q: sum(X).chunk(n, -1)[q]),
        "ppermute": (every(lambda: rand(2, 3)),
                     lambda x: dist.ppermute(x, ring, perm),
                     lambda X, q: X[src[q]]),
        "ppermute_async": (every(lambda: rand(2, 3)),
                           lambda x: dist.ppermute(x, ring, perm,
                                                   async_op=True).wait(),
                           lambda X, q: X[src[q]]),
        "all_to_all": (every(lambda: rand(n, 2)),
                       lambda x: dist.all_to_all(x, ring),
                       lambda X, q: torch.stack([X[j][q]
                                                 for j in range(n)])),
    }
    W = every(lambda: rand(d_in, cols // n))       # column tiles
    V = every(lambda: rand(cols // n, d_in))       # row tiles
    for ov in (False, True):
        tag = "overlap" if ov else "blocking"
        cases[f"ag_matmul_{tag}"] = (
            every(lambda: rand(2, d_in // n)),
            lambda x, ov=ov: esl.ag_matmul(x, W[r], axis=ring, tp=n,
                                           overlap=ov, scattered_in=True),
            lambda X, q: torch.cat(X, -1) @ W[q])
        for so in (True, False):
            cases[f"rs_matmul_{tag}_{'scatter' if so else 'full'}"] = (
                every(lambda: rand(2, cols // n)),
                lambda x, ov=ov, so=so: esl.rs_matmul(
                    x, V[r], axis=ring, tp=n, overlap=ov, scatter_out=so),
                lambda X, q, so=so: (
                    sum(x @ v for x, v in zip(X, V)).chunk(n, -1)[q] if so
                    else sum(x @ v for x, v in zip(X, V))))
    out = {}
    for name, (xs, op, plain) in cases.items():
        x = xs[r].clone().requires_grad_()
        got_out = op(x)
        ys = every(lambda: rand(*got_out.shape))
        (gx,) = torch.autograd.grad((got_out * ys[r]).sum(), x)
        X = [t.clone().requires_grad_() for t in xs]
        total = sum((plain(X, q) * ys[q]).sum() for q in range(n))
        want = torch.autograd.grad(total, X)[r]
        out[name] = float((gx - want).abs().max())
    return out


def train_rank(ring, kw):
    """``run_training`` on this rank's mesh (``kw``: its keywords with
    ``name``, ``tp``, optional ``crash`` step and ``depth``): rank 0's
    losses, or ``"crashed"`` when the injected failure fired on every
    rank."""
    from repro_torch.launch.ft import FailureInjector
    from repro_torch.launch.train import run_training
    kw = dict(kw)
    cfg = case_cfg(kw.pop("name"), kw.pop("depth", None))
    crash = kw.pop("crash", None)
    inj = FailureInjector([crash]) if crash is not None else None
    try:
        return run_training(cfg=cfg, mesh=ring, injector=inj,
                            log_every=1000, **kw)[2]
    except RuntimeError as e:
        if crash is None or f"injected failure at step {crash}" not in str(e):
            raise
        return "crashed"


def _float64_everywhere():
    """Make this process compute every float in float64: ``.float()``,
    ``.to(torch.float32)`` and f32 allocations give float64, so a model
    whose code casts to f32 runs wholly in f64.  For a spawned rank
    only: it changes torch for the whole process."""
    f32, f64 = torch.float32, torch.float64
    torch.set_default_dtype(f64)
    torch.Tensor.float = lambda self, *a, **k: self.double()
    to = torch.Tensor.to

    def to64(self, *a, **k):
        a = tuple(f64 if x is f32 else x for x in a)
        if k.get("dtype") is f32:
            k["dtype"] = f64
        return to(self, *a, **k)
    torch.Tensor.to = to64
    for name in ("zeros", "ones", "full", "empty"):
        make = getattr(torch, name)

        def made(*a, _make=make, **k):
            if k.get("dtype") is f32:
                k["dtype"] = f64
            return _make(*a, **k)
        setattr(torch, name, made)


def f64_rank(ring, cases):
    """Each of ``cases`` (trees in float64, compute "float64") on this
    world with every float in float64, then rank 0's largest leaf error
    of its gathered gradients against the port's tp=1 step in float64:
    {key: (error, leaf)}."""
    _float64_everywhere()
    got = {c["key"]: run_case(ring, c, ring.device) for c in cases}
    out = {}
    if ring.rank == 0:
        for c in cases:
            out[c["key"]] = max_leaf_err(got[c["key"]]["grads"],
                                         run_tp1(c, ring.device)["grads"])
    ring.gather_object(None)
    return out
