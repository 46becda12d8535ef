"""The port's training loop, data stream and checkpoints on the CPU, and
against the JAX reference's: ``tests/test_training.py``'s three tests
on the port (the loss falls, a crash and resume is lossless, WSD
trains), ``SyntheticLM`` batches bit-equal to the reference's, the
port's flatten order equal to ``jax.tree_util.tree_flatten``'s, a
checkpoint either package writes resumed by the other with the
writer's uninterrupted tail losses at rtol 1e-4, the checkpoint
manager's contract, the CLI, the refusals, and the serving modes
untouched by the train step's auxiliary-loss keyword.

~25 s in one process, most of it the reference's training runs and jits.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.data.pipeline import _hash64 as jax_hash64
from repro.launch.ft import FailureInjector as JaxFailureInjector
from repro.launch.train import run_training as jax_run_training
from repro.optim import OptState as JaxOptState
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core.steps import build_train_step
from repro_torch.data.pipeline import SyntheticLM, _hash64
from repro_torch.launch import train as train_mod
from repro_torch.launch.ft import FailureInjector
from repro_torch.launch.train import run_training
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, OptState, get_schedule
from repro_torch.tree import tree_flatten, tree_leaves, tree_map
from repro_torch.weights import params_from_jax
from torch_dense_util import one_torch_thread  # noqa: F401

SMALL = dict(steps=20, global_batch=4, seq_len=32, ckpt_every=8,
             log_every=100)


def _cfg():
    return get_config("smollm-135m").reduced()


def _crash(run, **kw):
    """``run`` with an injector firing at step 12: it must raise."""
    with pytest.raises(RuntimeError, match="injected failure at step 12"):
        run(**kw)


# ---------------------------------------------------------------------------
# tests/test_training.py on the port
# ---------------------------------------------------------------------------

def test_loss_decreases():
    _, _, losses = run_training(cfg=_cfg(), steps=30, global_batch=8,
                                seq_len=64, log_every=100, device="cpu")
    assert all(np.isfinite(losses))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.5, (first, last)


def test_checkpoint_restart_losslessness(tmp_path):
    _, _, ref_losses = run_training(cfg=_cfg(), ckpt_dir=str(tmp_path / "a"),
                                    device="cpu", **SMALL)
    _crash(run_training, cfg=_cfg(), ckpt_dir=str(tmp_path / "b"),
           injector=FailureInjector([12]), device="cpu", **SMALL)
    assert CheckpointManager(tmp_path / "b").latest_step() == 7
    _, _, resumed = run_training(cfg=_cfg(), ckpt_dir=str(tmp_path / "b"),
                                 device="cpu", **SMALL)
    assert len(resumed) == 12                    # steps 8..19
    np.testing.assert_allclose(resumed, ref_losses[8:], rtol=1e-4)


def test_wsd_schedule_trains():
    _, _, losses = run_training(cfg=_cfg(), steps=15, global_batch=4,
                                seq_len=32, schedule="wsd", log_every=100,
                                device="cpu")
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# the data stream and the flatten order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_synthetic_batches_bit_equal_to_reference(shard):
    """Every step of two batch sizes, both seeds: tokens and labels
    bit-equal, int32; the hash bit-equal on edge values."""
    x = np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 12345678901234567],
                 dtype=np.uint64)
    assert np.array_equal(_hash64(x), jax_hash64(x))
    for seed in (0, 3):
        ours = SyntheticLM(vocab_size=512, seq_len=33, seed=seed)
        ref = JaxSyntheticLM(vocab_size=512, seq_len=33, seed=seed)
        for gb in (4, 8):
            for step in range(3):
                a, b = ours.batch(step, gb, shard), ref.batch(step, gb, shard)
                assert sorted(a) == sorted(b)
                for k in a:
                    assert a[k].dtype == np.int32 == b[k].dtype
                    assert np.array_equal(a[k], b[k]), (seed, gb, step, k)
    it = ours.stream(8, shard, start_step=2)
    assert np.array_equal(next(it)["tokens"],
                          ours.batch(2, 8, shard)["tokens"])


def test_flatten_order_equals_jax():
    """{"params", "opt": OptState(step, m, v)} flattens in
    ``jax.tree_util.tree_flatten``'s order (keys sorted, the NamedTuple
    in field order): opt.step, opt.m, opt.v, then params; every leaf
    distinct, so a swap would show."""
    from repro.compiler.mapper import plan_model as jax_plan_model
    from repro.models.registry import build_model as jax_build_model
    jcfg = jax_get_config("jamba-v0.1-52b").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "train", esl_overlap=False,
                           remat="none", compute_dtype="float32",
                           param_dtype="float32")
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_config("jamba-v0.1-52b").reduced()
    plan = plan_model(cfg, None, (1,), "train", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    params = params_from_jax(tree, cfg, plan, "cpu")
    m = tree_map(lambda t: t + 1.0, params)
    v = tree_map(lambda t: t + 2.0, params)
    ours = {"params": params,
            "opt": OptState(torch.tensor(5, dtype=torch.int32), m, v)}
    ref = {"params": tree,
           "opt": JaxOptState(np.int32(5),
                              jax.tree.map(lambda t: t + 1.0, tree),
                              jax.tree.map(lambda t: t + 2.0, tree))}
    got, treedef = tree_flatten(ours)
    want = jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want) == treedef.num_leaves
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    back = treedef.unflatten(got)
    assert isinstance(back["opt"], OptState)
    assert back["opt"].m["blocks"]["l0"]["ln1"]["scale"] is \
        m["blocks"]["l0"]["ln1"]["scale"]


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference writes a checkpoint at step 8 and crashes at 12;
    the port resumes it on the same directory and finishes, its tail
    equal to the reference's uninterrupted run at rtol 1e-4."""
    jcfg = jax_get_config("smollm-135m").reduced()
    _, _, ref_losses = jax_run_training(cfg=jcfg, **SMALL)
    _crash(jax_run_training, cfg=jcfg, ckpt_dir=str(tmp_path),
           injector=JaxFailureInjector([12]), **SMALL)
    man = CheckpointManager(tmp_path).manifest(7)
    assert man["extra"]["next_step"] == 8
    _, _, resumed = run_training(cfg=_cfg(), ckpt_dir=str(tmp_path),
                                 device="cpu", **SMALL)
    assert len(resumed) == 12
    np.testing.assert_allclose(resumed, ref_losses[8:], rtol=1e-4)


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    """The other way: the port writes at step 8 and crashes at 12, the
    reference resumes, its tail equal to the port's uninterrupted run
    at rtol 1e-4; the manifest carries the reference's keys."""
    _, _, ours = run_training(cfg=_cfg(), device="cpu", **SMALL)
    _crash(run_training, cfg=_cfg(), ckpt_dir=str(tmp_path),
           injector=FailureInjector([12]), device="cpu", **SMALL)
    man = json.loads((tmp_path / "step_00000007" / "manifest.json")
                     .read_text())
    assert {"step", "treedef", "n_leaves", "time", "extra"} <= set(man)
    assert man["extra"]["next_step"] == 8 and man["step"] == 7
    jcfg = jax_get_config("smollm-135m").reduced()
    _, _, resumed = jax_run_training(cfg=jcfg, ckpt_dir=str(tmp_path),
                                     **SMALL)
    assert len(resumed) == 12
    np.testing.assert_allclose(resumed, ours[8:], rtol=1e-4)


def test_checkpoint_manager_contract(tmp_path):
    """save / save_async + wait / latest_step / restore (dtype and
    device of the template) / manifest / the keep window; a temporary
    directory left by a crash mid-save is never the latest; a bf16
    leaf is refused."""
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"b": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "a": OptState(torch.tensor(3, dtype=torch.int32),
                          {"x": torch.ones(2)}, {"x": torch.zeros(2)})}
    for s in (1, 2):
        mgr.save(s, tree, extra={"next_step": s + 1})
    mgr.save_async(3, tree, extra={"next_step": 4})
    mgr.wait()
    (tmp_path / ".tmp_save_crashed").mkdir()
    (tmp_path / "step_00000009").mkdir()         # no manifest: not a save
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.glob("step_0000000[123]")) == \
        ["step_00000002", "step_00000003"]
    assert mgr.manifest(3)["extra"] == {"next_step": 4}
    assert mgr.manifest(3)["n_leaves"] == 4
    like = tree_map(lambda t: torch.zeros_like(t, dtype=torch.float64)
                    if t.is_floating_point() else torch.zeros_like(t), tree)
    back = mgr.restore(3, like)
    assert back["b"].dtype == torch.float64
    assert torch.equal(back["b"], tree["b"].double())
    assert int(back["a"].step) == 3 and back["a"].step.dtype == torch.int32
    with pytest.raises(ValueError, match="leaf count"):
        mgr.restore(3, {"b": tree["b"]})
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(4, {"w": torch.ones(2, dtype=torch.bfloat16)})
    assert mgr.latest_step() == 3


# ---------------------------------------------------------------------------
# the CLI, refusals, and serving untouched by the aux keyword
# ---------------------------------------------------------------------------

def test_cli_trains_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "train", "--reduced", "--device", "cpu", "--steps", "4",
        "--batch", "2", "--seq", "16", "--schedule", "wsd"])
    train_mod.main()
    out = capsys.readouterr().out
    assert "[train] step     3" in out and "[train] done: first loss" in out


def test_refusals():
    """A mesh and the pod axis's int8 sync arrive with the mesh slice;
    a batch that does not split into the microbatches is refused."""
    cfg = _cfg()
    model = build_model(cfg, plan_model(cfg, None, (1,), "train",
                                        compute_dtype="float32"), "cpu")
    opt = AdamW(lr=get_schedule("cosine", 1e-3, 1, 10))
    with pytest.raises(NotImplementedError, match="mesh"):
        build_train_step(model, opt, object(), 4)
    with pytest.raises(NotImplementedError, match="pod axis"):
        build_train_step(model, opt, None, 4, compress_pod_grads=True)
    with pytest.raises(NotImplementedError, match="mesh"):
        run_training(cfg=cfg, steps=1, global_batch=2, seq_len=8,
                     mesh=object(), device="cpu")
    step, _ = build_train_step(model, opt, None, 3, accum_steps=2)
    params = model.init(0)
    toks = torch.zeros((3, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, opt.init(params), {"tokens": toks, "labels": toks})


def test_serving_logits_untouched_by_the_aux_keyword():
    """Reduced granite (MoE): prefill into a dense cache and 3 decode
    steps with ``with_aux=True`` give logits and caches bit-equal to the
    calls without it; the aux is the MoE layers' loss, positive."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, "cpu")
    params = model.init(0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12), dtype=np.int64))
    runs = []
    for kw in ({}, {"with_aux": True}):
        cache = model.init_cache(2, 32)
        with torch.no_grad():
            out = model.forward(params, toks, mode="prefill", cache=cache,
                                **kw)
            logits = [out[0]]
            tok = out[0][:, -1].argmax(-1)
            for t in range(3):
                out = model.forward(params, tok[:, None], mode="decode",
                                    positions=torch.full((2,), 12 + t),
                                    cache=cache, **kw)
                logits.append(out[0])
                tok = out[0][:, -1].argmax(-1)
        assert len(out) == (3 if kw else 2)
        if kw:
            assert float(out[2]) > 0
        runs.append((logits, cache))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
