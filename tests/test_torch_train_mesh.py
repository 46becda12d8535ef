"""Training on a mesh of gloo ranks on the CPU: the collectives' adjoints,
the ESL products' backward, the grid's train step beside the JAX
reference's tp=1 step, checkpoints of a sharded state and the elastic
restart.

* every differentiable collective (``all_gather`` on two dims, ``psum``,
  ``pmean``, ``psum_scatter``, ``ppermute`` and its asynchronous hop,
  ``all_to_all``) and the ESL ``ag_matmul`` / ``rs_matmul`` in both
  modes, on 2 and 4 ranks, float64: each rank's gradient of sum_r
  <out_r, y_r> equals the same gradient of the objective written out in
  plain torch over every rank's inputs, to 1e-12;
* reduced smollm-135m, f32, batch 4 x 16 from ``default_rng(0)``:
  ESL overlap against blocking in backward on ``(2,)`` and ``(2, 2)``
  (gradients within 1e-5 x each leaf's max); remat block against none
  on the grid, bit for bit; ``accum_steps`` 2 on the grid against the
  reference's tp=1 accumulation 2 (every label counted, so the grid's
  microbatches, one row of each data rank, average like the
  reference's); three AdamW steps on the grid against the reference's
  tp=1 run (losses and ``grad_norm`` at rtol 1e-5, parameters at 1e-5
  x max); bf16 compute at 3e-2; every replicated leaf bit-equal on each
  ring after the steps;
* a grid checkpoint (rank 0 writes the plan's global tensors) that the
  reference's ``CheckpointManager.restore`` takes onto its params and
  optimizer state for the same plan, its manifest the reference's;
* the elastic restart (``tests/test_training.py``'s protocol): trained
  on data 2 x model 1 with a crash at step 12, resumed from the step-8
  checkpoint at data 4 x model 1 and at ``mesh=None``, the tail within
  rtol 1e-4 of the uninterrupted run;
* ``python -m repro_torch.launch.train --reduced --tp 2 --data 2
  --device cpu``; the card test's rank function rehearsed on gloo; the
  refusal of a head layout the ring pads.

Cost in one process ~95 s: spawns of gloo ranks (2 and 4 ranks for the
cases, 4 for the CLI and the card rehearsal, 2 + 2 + 4 for the elastic
restart, 2 and 4 for float64) and the reference's jitted tp=1 steps.
"""
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JaxCkpt
from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.optim import AdamW as JaxAdamW
from repro.optim import OptState as JaxOptState
from repro.optim import get_schedule as jax_get_schedule
from repro.core.steps import build_train_step as jax_build_train_step
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.compiler.mapper import plan_model
from repro_torch.core.dist import Ring, run_ranks
from repro_torch.core.steps import build_train_step
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import run_training
from repro_torch.models.registry import build_model
from tests.test_torch_train_step import assert_grads_close
from tests.torch_dense_util import one_torch_thread  # noqa: F401
from tests.torch_dense_util import perturbed
from tests.torch_train_mesh_util import (adam_params_err, card_rank,
                                         case_cfg, make_batch, mesh_rank,
                                         train_rank)

NAME = "smollm-135m"
GRID = (2, 2)
F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
           param_dtype="float32")
LR = 1e-3
ELASTIC = dict(name=NAME, steps=20, global_batch=4, seq_len=32,
               ckpt_every=8)


class PassThrough:
    def apply(self, params, grads, state):
        return grads, state, {}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


def _jax(plan_kw=F32, shape=None):
    jcfg = jax_get_config(NAME).reduced()
    axes = None if shape is None else ("data", "model")
    return jax_build_model(jcfg, jax_plan_model(jcfg, axes, shape or (1,),
                                                "train", **plan_kw))


def _ref_step(jmodel, tree, batches, opt=None, **kw):
    """The reference's tp=1 step over ``batches``: (metrics per step,
    the last gradients or the final parameters) as numpy."""
    step, _ = jax_build_train_step(jmodel, opt or PassThrough(), None,
                                   batches[0]["tokens"].shape[0], **kw)
    step = jax.jit(step)
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params) if opt is not None else None
    metrics = []
    for b in batches:
        out, state, m = step(params, state,
                             {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        if opt is not None:
            params = out
    return metrics, jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def tree():
    jparams, _ = _jax().init(jax.random.PRNGKey(0))
    return perturbed(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    cfg = case_cfg(NAME)
    batch = make_batch(cfg)
    full = make_batch(cfg, ignored=0)
    steps3 = [make_batch(cfg, seed=s) for s in range(3)]
    ckpt = str(tmp_path_factory.mktemp("grid_ckpt"))
    base = dict(name=NAME, tree=tree, batch=batch)
    four = [dict(base, key=("mode", GRID, ov), shape=GRID, overlap=ov)
            for ov in (False, True)]
    four += [dict(base, key=("remat", GRID, ov), shape=GRID, overlap=ov,
                  remat="block") for ov in (False, True)]
    four += [dict(base, key="accum", shape=GRID, batch=full, accum=2),
             dict(base, key="adamw", shape=GRID, batches=steps3, steps=3,
                  adamw=LR, overlap=True),
             dict(base, key="bf16", shape=GRID, compute="bfloat16"),
             dict(base, key="ckpt", shape=GRID, adamw=LR, ckpt_dir=ckpt)]
    two = [dict(base, key=("mode", (2,), ov), shape=(2,), overlap=ov)
           for ov in (False, True)]
    got = run_ranks(mesh_rank, 4, {"cases": four, "adjoints": True},
                    device="cpu", threads=1)
    got2 = run_ranks(mesh_rank, 2, {"cases": two, "adjoints": True},
                     device="cpu", threads=1)
    jm = _jax()
    ref = {"accum": _ref_step(jm, tree, [full], accum_steps=2),
           "grads": _ref_step(jm, tree, [batch]),
           "adamw": _ref_step(jm, tree, steps3,
                              opt=JaxAdamW(lr=jax_get_schedule(
                                  "cosine", LR, 1, 10))),
           "bf16": _ref_step(_jax(dict(F32, compute_dtype="bfloat16")),
                             tree, [batch])}
    return dict(cases={**got["cases"], **got2["cases"]}, ref=ref,
                adjoints={4: got["adjoints"], 2: got2["adjoints"]},
                ckpt=ckpt)


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives_backward_is_their_adjoint(runs, ranks):
    errs = runs["adjoints"][ranks]
    assert len(errs) == ranks
    for per_rank in errs:
        assert len(per_rank) == 14
        for name, e in per_rank.items():
            assert e < 1e-12, (ranks, name, e)


@pytest.mark.parametrize("shape", [(2,), GRID], ids=["2", "2x2"])
def test_overlap_equals_blocking_in_backward(runs, shape):
    blocking = runs["cases"][("mode", shape, False)]
    overlap = runs["cases"][("mode", shape, True)]
    np.testing.assert_allclose(overlap["metrics"][0]["loss"],
                               blocking["metrics"][0]["loss"], rtol=1e-6)
    assert_grads_close(_torch(overlap["grads"]), blocking["grads"])


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["blocking", "overlap"])
def test_remat_block_equals_none_on_the_grid(runs, overlap):
    """The super-block replayed in backward, its gathers and ring hops
    with it (no early stop), gives remat none's gradients bit for bit."""
    none = runs["cases"][("mode", GRID, overlap)]
    block = runs["cases"][("remat", GRID, overlap)]
    assert block["metrics"] == none["metrics"]
    for k, v in _leaves(none["grads"]):
        assert np.array_equal(_get(block["grads"], k), v), k


def test_accumulation_on_the_grid_equals_reference_tp1(runs):
    got = runs["cases"]["accum"]
    metrics, want = runs["ref"]["accum"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], metrics[0]["loss"],
                               rtol=1e-5)
    assert_grads_close(_torch(got["grads"]), want)


def test_three_adamw_steps_on_the_grid_equal_reference_tp1(runs):
    """Losses and the global norm (one psum over the world of each
    rank's squares, a replicated leaf counted once) at every step, the
    first step's gradients, and the parameters after the third: within
    1e-5 x each leaf's max, but for the elements whose first gradient
    is rounding (below 1e-4 x the leaf's largest), which AdamW's first
    update moves by lr whatever its size: those within 2 x lr a step
    (``adam_params_err``)."""
    got = runs["cases"]["adamw"]
    metrics, want = runs["ref"]["adamw"]
    for mine, ref in zip(got["metrics"], metrics):
        np.testing.assert_allclose(mine["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(mine["grad_norm"], ref["grad_norm"],
                                   rtol=1e-5)
        np.testing.assert_allclose(mine["lr"], ref["lr"], rtol=1e-6)
    g1 = runs["ref"]["grads"][1]
    assert_grads_close(_torch(got["grads1"]), g1)
    share, at, loose = adam_params_err(got["params"], want, LR)
    assert share <= 1e-3, (share, at)
    assert loose <= 2 * 3, loose


def test_bf16_compute_on_the_grid(runs):
    got = runs["cases"]["bf16"]
    metrics, want = runs["ref"]["bf16"]
    np.testing.assert_allclose(got["metrics"][0]["loss"], metrics[0]["loss"],
                               rtol=3e-2)
    assert_grads_close(_torch(got["grads"]), want, rtol=3e-2,
                       atol_frac=3e-2)


def test_replicated_leaves_bit_equal_after_the_steps(runs):
    """Norm scales replicated over ``data`` (and, on the grid, every
    leaf replicated over a ring) hold the same bits on every rank of
    that ring after three AdamW steps."""
    reps = runs["cases"]["adamw"]["replicas"]
    assert reps and all(reps.values()), reps
    assert any("ln" in k for k in reps)


def test_grid_checkpoint_restores_in_the_reference(runs, tree, tmp_path):
    """Rank 0 wrote the grid plan's global tensors: the reference's
    manager restores them onto its params and AdamW state for the same
    plan, bit-equal to the ranks' gathered state, and its own save of
    that tree writes the same manifest (step, treedef, leaf count,
    extra)."""
    rec = runs["cases"]["ckpt"]
    jmodel = _jax(shape=GRID)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    zeros = jax.tree.map(lambda p: np.zeros(p.shape, np.float32), jparams)
    like = {"params": jparams,
            "opt": JaxOptState(step=np.zeros((), np.int32), m=zeros,
                               v=zeros)}
    mgr = JaxCkpt(runs["ckpt"])
    step = mgr.latest_step()
    assert step == 0
    got = mgr.restore(step, like)
    assert int(got["opt"].step) == 1
    for key, tree_ in (("params", got["params"]), ("m", got["opt"].m),
                       ("v", got["opt"].v)):
        for k, v in _leaves(rec["state"][key]):
            assert np.array_equal(np.asarray(_get(tree_, k)), v), (key, k)
    mine = mgr.manifest(step)
    JaxCkpt(tmp_path).save(step, got, extra=mine["extra"])
    ref = JaxCkpt(tmp_path).manifest(step)
    assert sorted(mine) == sorted(ref) == ["extra", "n_leaves", "step",
                                           "time", "treedef"]
    for k in ("step", "treedef", "n_leaves", "extra"):
        assert mine[k] == ref[k], k


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    full = run_ranks(train_rank, 2, dict(ELASTIC, tp=1,
                                         ckpt_dir=str(d / "a")),
                     device="cpu", threads=1)
    crashed = run_ranks(train_rank, 2, dict(ELASTIC, tp=1, crash=12,
                                            ckpt_dir=str(d / "b")),
                        device="cpu", threads=1)
    latest = CheckpointManager(d / "b").latest_step()
    shutil.copytree(d / "b", d / "c")
    wide = run_ranks(train_rank, 4, dict(ELASTIC, tp=1,
                                         ckpt_dir=str(d / "b")),
                     device="cpu", threads=1)
    kw = {k: v for k, v in ELASTIC.items() if k != "name"}
    _, _, alone = run_training(cfg=case_cfg(NAME), ckpt_dir=str(d / "c"),
                               device="cpu", log_every=1000, **kw)
    return dict(full=full, crashed=crashed, latest=latest,
                resumed={"4x1": wide, "none": alone})


@pytest.mark.parametrize("where", ["4x1", "none"])
def test_elastic_restart_at_another_data_width(elastic, where):
    """Trained on data 2 x model 1, crashed at step 12, resumed from the
    step-8 checkpoint at data 4 x model 1 or at ``mesh=None``: the
    resumed steps' losses within rtol 1e-4 of the uninterrupted run's."""
    assert elastic["crashed"] == "crashed"
    assert elastic["latest"] == 7
    got = elastic["resumed"][where]
    assert len(got) == 12                        # steps 8..19
    np.testing.assert_allclose(got, elastic["full"][8:], rtol=1e-4)


def test_cli_trains_on_a_grid(monkeypatch, capfd):
    monkeypatch.setattr(sys, "argv", [
        "train", "--reduced", "--device", "cpu", "--tp", "2", "--data", "2",
        "--steps", "3", "--batch", "4", "--seq", "16"])
    train_mod.main()
    out = capfd.readouterr().out
    assert "[train] mesh: data 2 x model 2, 4 ranks on cpu" in out
    assert "[train] step     2" in out and "[train] done: first loss" in out


def test_card_rank_rehearsed_on_gloo(tree):
    """``tests/test_torch_train_mesh_cuda.py``'s rank function, run on
    gloo ranks on the CPU at its cases: every case within its gate
    against the port's tp=1 step."""
    from tests.test_torch_train_mesh_cuda import CASES, check_card_record
    spec = {"cases": [dict(c, tree=tree) for c in CASES(NAME)]}
    rec = run_ranks(card_rank, 4, spec, device="cpu", threads=1)
    check_card_record(rec, spec["cases"])


@pytest.mark.parametrize("shape", [(2,), GRID], ids=["2", "2x2"])
def test_rwkv_ring_backward_exact_in_float64(tree, shape):
    """Reduced rwkv6-7b's ring gradients sit up to 2.9e-4 x max from the
    tp=1 step's in f32 (its chunked WKV amplifies the rounding of the
    ring's column-tile products, ROADMAP §3); with every float in
    float64 they are the tp=1 step's to 1e-11 x max, blocking and ESL
    overlap: the ring's backward is exact."""
    from tests.torch_train_mesh_util import f64_rank
    jcfg = jax_get_config("rwkv6-7b").reduced()
    jparams, _ = jax_build_model(jcfg, jax_plan_model(
        jcfg, None, (1,), "train", **F32)).init(jax.random.PRNGKey(0))
    t64 = _f64(perturbed(jax.tree.map(np.asarray, jparams)))
    cases = [dict(key=overlap, name="rwkv6-7b", shape=shape, tree=t64,
                  batch=make_batch(case_cfg("rwkv6-7b")),
                  compute="float64", overlap=overlap)
             for overlap in (False, True)]
    got = run_ranks(f64_rank, int(np.prod(shape)), cases, device="cpu",
                    threads=1)
    for overlap, (err, at) in got.items():
        assert err < 1e-11, (overlap, err, at)


def _f64(tree):
    return {k: _f64(v) if isinstance(v, dict) else v.astype(np.float64)
            for k, v in tree.items()}


def test_fsdp_dim_equals_reference():
    """The mapper's ZeRO rule: the first dim the FSDP width divides."""
    from repro.core.dist import fsdp_dim as jax_fsdp_dim
    from repro_torch.core.dist import fsdp_dim
    for shape in ((128, 6, 32), (6, 128), (3, 5), (512, 128), (2,)):
        for width in (1, 2, 4):
            for skip in ((), (0,)):
                assert fsdp_dim(shape, width, skip) == \
                    jax_fsdp_dim(shape, width, skip), (shape, width, skip)


def test_padded_heads_refuse_to_train():
    """At tp 4 reduced smollm's 6 heads are padded to 8: a padded head's
    output projection would learn, so the step refuses the layout."""
    cfg = case_cfg(NAME)
    plan = plan_model(cfg, ("model",), (4,), "train", **F32)
    assert min(plan.attn.q_orig) < 0
    with pytest.raises(NotImplementedError, match="pads or duplicates"):
        build_train_step(build_model(cfg, plan, "cpu"), None,
                         Ring.__new__(Ring), 4)


def _leaves(tree, path=""):
    for k, v in tree.items():
        p = f"{path}/{k}" if path else k
        if isinstance(v, dict):
            yield from _leaves(v, p)
        else:
            yield p, np.asarray(v)


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return np.asarray(tree)
