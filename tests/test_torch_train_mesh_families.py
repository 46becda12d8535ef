"""Every assigned family's train step on a mesh of gloo ranks against the
JAX reference's, on the CPU.

Each family at ``.reduced()`` in f32 (the reference's ``Model.init``
weights, biases and learned positions redrawn by
``tests/torch_dense_util.py`` ``perturbed``), batch 4 x 16 from
``numpy.random.default_rng(0)`` with row 0's first 3 labels -1, blocking
ESL, remat none, one step through a pass-through optimizer, on the
``("model",)`` ring of 2 ranks and the ``("data", "model")`` grids of
2 x 2 and 2 x 1.  The port's gradients, gathered to the plan's global
tensors and relaid to the tp=1 layout, are held

* to the reference's **tp=1** step: loss and aux at rtol 1e-5, every
  leaf with ``tests/test_torch_train_step.py``'s ``assert_grads_close``
  (rtol 1e-4, atol 1e-5 x the leaf's max; rwkv 3e-5, and 5e-4 on a mesh
  with a model ring: its chunked WKV sums products of exponentials of
  cumulative decays, which amplify the rounding of the ring's
  column-tile products into its gradients, up to 2.9e-4 x max in
  ``tmix/w_o`` at ``(2,)``, while in float64 the ring's gradients are
  the tp=1 step's to 1.1e-13 x max, ROADMAP §3 and
  ``tests/test_torch_train_mesh.py::
  test_rwkv_ring_backward_exact_in_float64``);
* to the reference's **mesh step divided by N** (N the mesh's devices,
  run on fake host devices in one subprocess): its gradients come out N
  times the tp=1 gradients (ROADMAP §3), and
  :func:`test_reference_mesh_gradients_are_n_times_tp1` records that.

An MoE (granite, llama4, jamba) on a data axis routes each data row's
tokens with its own capacity and auxiliary loss, as the reference's
mesh step does, so its step is not the tp=1 function: there it is held
to the reference's mesh step / N, its aux to the mean of the
reference's per-row aux, and, with ``aux_weight=0`` (no drop at these
capacities), to the reference's tp=1 step.  On a mesh with a model ring
the reference's router gradient is one model rank's share (a leaf
replicated over ``model`` is not summed over it, ROADMAP §3), so there
the port's router is held to the tp=1 step on ``(2,)`` and to the
reference's ``(2, 1)`` step / 2 on ``(2, 2)``.  The same holds for
every leaf replicated over ``model`` (rwkv's ``tmix/mix_w1`` and
``tmix/decay_w1`` too): on a mesh with a model ring the reference's
gradient of such a leaf is one rank's share, so those leaves are held
to the tp=1 step and to the reference's step without a model ring.
rwkv is held to the reference's mesh step at 5e-4 x max on every mesh
(that step sums in yet another order than its tp=1 step: at ``(2, 1)``
one entry of ``cmix/w_r`` sits 3.4e-5 x max from the port's).

Cost in one process ~125 s: two fake-device subprocesses of the
reference (15 jitted mesh steps each) run beside two spawns of gloo
ranks (4 and 2 ranks) and the reference's jitted tp=1 steps.
"""
import os
import pickle
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import AxisEnv as JaxAxisEnv
from repro.core.steps import build_train_step as jax_build_train_step
from repro.models.registry import build_model as jax_build_model
from repro_torch.configs import ASSIGNED
from repro_torch.core.dist import run_ranks
from tests.test_torch_train_step import assert_grads_close
from tests.torch_dense_util import one_torch_thread  # noqa: F401
from tests.torch_dense_util import perturbed
from tests.torch_train_mesh_util import (REFERENCE_MESH, case_cfg,
                                         cases_rank, make_batch, mesh_tree,
                                         tp1_tree)
from tests.util import run_multidevice

FAMILIES = sorted(ASSIGNED)
MOE = ("granite-moe-3b-a800m", "jamba-v0.1-52b",
       "llama4-maverick-400b-a17b")
MESHES = ((2,), (2, 2), (2, 1))
TRAIN_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")


class PassThrough:
    def apply(self, params, grads, state):
        return grads, state, {}


def _n(shape):
    return int(np.prod(shape))


def _div(tree, n):
    return {k: _div(v, n) if isinstance(v, dict) else v / n
            for k, v in tree.items()}


def _jax_pair(name):
    """(reference model, its perturbed tp=1 params as numpy)."""
    jcfg = jax_get_config(name).reduced()
    jmodel = jax_build_model(jcfg, jax_plan_model(jcfg, None, (1,), "train",
                                                  **TRAIN_F32))
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, perturbed(jax.tree.map(np.asarray, jparams))


def _ref_tp1(jmodel, tree, batch, **kw):
    step, _ = jax_build_train_step(jmodel, PassThrough(), None,
                                   batch["tokens"].shape[0], **kw)
    g, _, m = jax.jit(step)(jax.tree.map(jnp.asarray, tree), None,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, g), {k: float(v) for k, v in m.items()}


def _row_aux(jmodel, tree, batch, rows):
    """The mean over the data rows of the reference's auxiliary loss on
    each row's share of the batch (per layer, as the step reports it)."""
    per = batch["tokens"].shape[0] // rows
    env = JaxAxisEnv(None, 1, (), 1, ())
    out = []
    for d in range(rows):
        _, _, aux = jmodel.forward(jax.tree.map(jnp.asarray, tree),
                                   jnp.asarray(batch["tokens"][d * per:
                                                               (d + 1) * per]),
                                   env=env, mode="train")
        out.append(float(aux) / jmodel.cfg.n_layers)
    return float(np.mean(out))


@pytest.fixture(scope="module")
def runs():
    trees, batches, jmodels = {}, {}, {}
    for name in FAMILIES:
        jmodels[name], trees[name] = _jax_pair(name)
        batches[name] = make_batch(case_cfg(name))
    ref_cases = [dict(key=(name, shape), name=name, shape=shape,
                      tree=mesh_tree(trees[name], case_cfg(name), shape),
                      batch=batches[name])
                 for name in FAMILIES for shape in MESHES]
    ref_out, errors = {}, []

    def reference(part):
        try:
            run_reference(part)
        except BaseException as e:       # re-raised after the join
            errors.append(e)

    def run_reference(part):
        with tempfile.TemporaryDirectory() as d:
            src, dst = os.path.join(d, "in.pkl"), os.path.join(d, "out.pkl")
            with open(src, "wb") as f:
                pickle.dump(part, f)
            run_multidevice(f"IN, OUT = {src!r}, {dst!r}\n" + REFERENCE_MESH,
                            n_devices=4, timeout=900)
            with open(dst, "rb") as f:
                ref_out.update(pickle.load(f))
    # two subprocesses, each compiling half the reference's mesh steps
    threads = [threading.Thread(target=reference, args=(ref_cases[i::2],))
               for i in range(2)]
    for t in threads:
        t.start()
    cases = {n: [] for n in (2, 4)}
    for name in FAMILIES:
        for shape in MESHES:
            c = dict(key=(name, shape, 0.01), name=name, shape=shape,
                     tree=trees[name], batch=batches[name])
            cases[_n(shape)].append(c)
            if name in MOE and len(shape) == 2:
                cases[_n(shape)].append(dict(c, key=(name, shape, 0.0),
                                             aux_weight=0.0))
    port = dict(run_ranks(cases_rank, 4, cases[4], device="cpu", threads=1))
    port.update(run_ranks(cases_rank, 2, cases[2], device="cpu", threads=1))
    tp1 = {name: _ref_tp1(jmodels[name], trees[name], batches[name])
           for name in FAMILIES}
    tp1_aux0 = {name: _ref_tp1(jmodels[name], trees[name], batches[name],
                               aux_weight=0.0) for name in MOE}
    row_aux = {name: _row_aux(jmodels[name], trees[name], batches[name], 2)
               for name in MOE}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    assert len(ref_out) == len(ref_cases)
    ref_mesh = {k: (tp1_tree(g, case_cfg(k[0]), k[1]), m)
                for k, (g, m) in ref_out.items()}
    return dict(port=port, tp1=tp1, tp1_aux0=tp1_aux0, row_aux=row_aux,
                ref_mesh=ref_mesh)


def _atol(name, shape):
    if name != "rwkv6-7b":
        return 1e-5
    return 5e-4 if shape[-1] > 1 else 3e-5


def _model_replicated(name):
    """The paths of ``name``'s leaves that no dim shards over ``model``
    (the router, rwkv's low-rank mixers)."""
    from repro_torch.weights import _leaves, mesh_axes_of
    from repro_torch.models.common import init_params
    from tests.torch_train_mesh_util import mesh_plan
    cfg = case_cfg(name)
    plan = mesh_plan(cfg, (2,))
    return {p for p, _ in _leaves(init_params(cfg, plan, 0, "cpu"))
            if "model" not in mesh_axes_of(p, plan)}


def _split(tree, paths, path=""):
    """(``tree`` without the leaves at ``paths``, {path: leaf} of
    them)."""
    rest, taken = {}, {}
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            r, t = _split(v, paths, p)
            rest[k] = r
            taken.update(t)
        elif p in paths:
            taken[p] = v
        else:
            rest[k] = v
    return rest, taken


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", FAMILIES)
def test_family_mesh_step_equals_reference_tp1(runs, name, shape):
    """Loss, aux and every gathered gradient against the reference's
    tp=1 step (an MoE on a data axis: aux against the rows' mean, and
    the gradients of its ``aux_weight=0`` step)."""
    got = runs["port"][(name, shape, 0.01)]
    g1, m1 = runs["tp1"][name]
    m = got["metrics"][0]
    np.testing.assert_allclose(m["loss"], m1["loss"], rtol=1e-5)
    moe_data = name in MOE and len(shape) == 2
    if moe_data:
        np.testing.assert_allclose(m["aux"], runs["row_aux"][name],
                                   rtol=1e-5)
        got0 = runs["port"][(name, shape, 0.0)]
        g0, m0 = runs["tp1_aux0"][name]
        np.testing.assert_allclose(got0["metrics"][0]["loss"], m0["loss"],
                                   rtol=1e-5)
        assert_grads_close(_torch(got0["grads"]), g0,
                           atol_frac=_atol(name, shape))
        return
    np.testing.assert_allclose(m["aux"], m1["aux"], rtol=1e-5, atol=1e-7)
    assert_grads_close(_torch(got["grads"]), g1,
                       atol_frac=_atol(name, shape))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", FAMILIES)
def test_family_mesh_step_equals_reference_mesh_over_n(runs, name, shape):
    """Loss and every gathered gradient against the reference's own mesh
    step, its gradients divided by N; an MoE's router on a mesh with a
    model ring against the reference's step without one (see the
    module's docstring)."""
    got = runs["port"][(name, shape, 0.01)]
    gm, mm = runs["ref_mesh"][(name, shape)]
    np.testing.assert_allclose(got["metrics"][0]["loss"], mm["loss"],
                               rtol=1e-5)
    want = _div(gm, _n(shape))
    atol = 5e-4 if name == "rwkv6-7b" else 1e-5
    rep = _model_replicated(name) if shape[-1] > 1 else set()
    if rep:
        got_rest, got_rep = _split(got["grads"], rep)
        want_rest, _ = _split(want, rep)
        assert_grads_close(_torch(got_rest), want_rest, atol_frac=atol)
        if len(shape) == 1:
            want_rep = _split(runs["tp1"][name][0], rep)[1]
        else:
            want_rep = _split(_div(runs["ref_mesh"][(name, (2, 1))][0], 2),
                              rep)[1]
        assert_grads_close(_torch(got_rep), want_rep, atol_frac=atol)
        return
    assert_grads_close(_torch(got["grads"]), want, atol_frac=atol)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_reference_mesh_gradients_are_n_times_tp1(runs, shape):
    """The finding ROADMAP §3 logs: the reference's mesh step gives every
    gradient N times its tp=1 step's, N the mesh's devices, for every
    family but the leaves replicated over ``model`` on a mesh with a
    model ring (the router, rwkv's low-rank mixers); the port's
    gradients are the tp=1 step's.  The sum of |g| over the other
    leaves is N times the tp=1 sum within 1e-4, and granite's router's
    factor there lies between 1 and N - 0.5."""
    n = _n(shape)
    for name in FAMILIES:
        gm = runs["ref_mesh"][(name, shape)][0]
        g1 = runs["tp1"][name][0]
        if name in MOE and len(shape) == 2:
            continue                  # its own function on a data axis
        if shape[-1] > 1:
            rep = _model_replicated(name)
            gm, g1 = _split(gm, rep)[0], _split(g1, rep)[0]
        tot_m = sum(float(np.abs(v).sum()) for v in _flat(gm))
        tot_1 = sum(float(np.abs(v).sum()) for v in _flat(g1))
        np.testing.assert_allclose(tot_m / tot_1, n, rtol=1e-4,
                                   err_msg=name)
    if shape[-1] > 1:
        gm = runs["ref_mesh"][("granite-moe-3b-a800m", shape)][0]
        want = runs["tp1"]["granite-moe-3b-a800m"][0] if len(shape) == 1 \
            else runs["ref_mesh"][("granite-moe-3b-a800m", (2, 1))][0]
        div = 1 if len(shape) == 1 else 2
        rep = _model_replicated("granite-moe-3b-a800m")
        r_m = sum(float(np.abs(v).sum()) for v in _split(gm, rep)[1].values())
        r_1 = sum(float(np.abs(v).sum())
                  for v in _split(want, rep)[1].values())
        factor = r_m / (r_1 / div)
        assert 1.0 < factor < n - 0.5, factor


def _flat(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield np.asarray(v)


def _torch(tree):
    import torch
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}
