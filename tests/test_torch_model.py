"""Logits of the port's model against the JAX reference's on the reduced
smollm-135m, with the reference's weights carried across by
``params_from_jax``: one prefill per sequence, then 8 decode steps on the
paged pool (streamed and gathered) and on the dense cache."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.weights import params_from_jax

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)
LENS = (5, 11)           # prompt lengths of the two sequences
BUCKET, BS, MAX_SEQ, N_STEPS = 16, 8, 64, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return (jmodel, jparams, make_axis_env(jplan)), (model, params)


def _tokens():
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 512, size=n).astype(np.int32) for n in LENS]
    steps = r.integers(1, 512, size=(N_STEPS, len(LENS))).astype(np.int32)
    return prompts, steps


def _tables():
    """Block tables of the two sequences: enough blocks for prompt + 8."""
    tables = np.zeros((len(LENS), MAX_SEQ // BS), np.int32)
    nxt = 1
    for b, n in enumerate(LENS):
        used = -(-(n + N_STEPS) // BS)
        tables[b, :used] = np.arange(nxt, nxt + used)
        nxt += used
    return tables, nxt


def _run_jax(jax_side, layout):
    jmodel, jparams, env = jax_side
    prompts, steps = _tokens()
    tables, n_blocks = _tables()
    paged = layout != "dense"
    cache = jmodel.init_cache(len(LENS), MAX_SEQ, paged=paged,
                              num_blocks=n_blocks, block_size=BS)
    rows = []
    for b, p in enumerate(prompts):
        buf = np.zeros((1, BUCKET), np.int32)
        buf[0, :len(p)] = p
        logits, pc, _ = jmodel.forward(
            jparams, jnp.asarray(buf), env=env, mode="prefill",
            cache=jmodel.init_cache(1, BUCKET),
            positions=jnp.arange(BUCKET)[None])
        rows.append(np.asarray(logits[0, len(p) - 1]))
        if paged:
            cache = jax_kv.scatter_prefill_pages(
                cache, pc, jnp.asarray(tables[b, :BUCKET // BS]))
        else:
            cache = jax_kv.scatter_prefill_dense(cache, pc, jnp.int32(b))
    out = [np.stack(rows)]
    pos = np.array(LENS, np.int32)
    kernel = "stream" if layout == "stream" else "gather"
    fwd = jax.jit(lambda c, t, p: jmodel.forward(
        jparams, t, env=env, mode="decode", positions=p, cache=c,
        block_tables=jnp.asarray(tables) if paged else None,
        paged_kernel=kernel)[:2])
    for s in range(N_STEPS):
        logits, cache = fwd(cache, jnp.asarray(steps[s][:, None]),
                            jnp.asarray(pos + s))
        out.append(np.asarray(logits[:, -1]))
    return out


def _run_port(port_side, layout):
    model, params = port_side
    prompts, steps = _tokens()
    tables, n_blocks = _tables()
    paged = layout != "dense"
    cache = model.init_cache(len(LENS), MAX_SEQ, paged=paged,
                             num_blocks=n_blocks, block_size=BS)
    rows = []
    for b, p in enumerate(prompts):
        buf = np.zeros((1, BUCKET), np.int32)
        buf[0, :len(p)] = p
        logits, pc = model.forward(
            params, torch.from_numpy(buf), mode="prefill",
            cache=model.init_cache(1, BUCKET),
            positions=torch.arange(BUCKET)[None])
        rows.append(logits[0, len(p) - 1].numpy())
        if paged:
            kv_cache.scatter_prefill_pages(
                cache, pc, torch.from_numpy(tables[b, :BUCKET // BS]))
        else:
            kv_cache.scatter_prefill_dense(cache, pc, b)
    out = [np.stack(rows)]
    pos = np.array(LENS, np.int32)
    for s in range(N_STEPS):
        logits, _ = model.forward(
            params, torch.from_numpy(steps[s][:, None]), mode="decode",
            positions=torch.from_numpy(pos + s), cache=cache,
            block_tables=torch.from_numpy(tables) if paged else None,
            paged_kernel="stream" if layout == "stream" else "gather")
        out.append(logits[:, -1].numpy())
    return out


@pytest.mark.parametrize("layout", ["stream", "gather", "dense"])
def test_logits_match_reference(models, layout):
    jax_side, port_side = models
    ref = _run_jax(jax_side, layout)
    mine = _run_port(port_side, layout)
    for step, (m, r) in enumerate(zip(mine, ref)):
        np.testing.assert_allclose(m, r, err_msg=f"step {step}", **TOL)


def test_forward_takes_only_a_resolved_paged_kernel(models):
    _, (model, params) = models
    with pytest.raises(ValueError):
        model.forward(params, torch.ones((1, 1), dtype=torch.long),
                      mode="decode",
                      positions=torch.zeros(1, dtype=torch.int32),
                      cache=model.init_cache(1, 8), paged_kernel="auto")


def test_train_mode_matches_prefill(models):
    _, (model, params) = models
    toks = torch.from_numpy(_tokens()[0][1][None])
    train, _ = model.forward(params, toks, mode="train")
    prefill, _ = model.forward(params, toks, mode="prefill",
                               cache=model.init_cache(1, toks.shape[1]))
    torch.testing.assert_close(train, prefill)


def test_params_from_jax_keeps_the_stored_layout(models):
    (jmodel, jparams, _), (model, params) = models
    a = model.plan.attn
    blk = params["blocks"]["l0"]["attn"]
    D, L = model.cfg.d_model, model.cfg.n_layers
    assert tuple(blk["wq"].shape) == (L, D, a.hp, a.d_head)
    assert tuple(blk["wk"].shape) == (L, D, a.gp, a.d_head)
    assert tuple(blk["wo"].shape) == (L, a.hp, a.d_head, D)
    assert tuple(params["embed"].shape) == (model.plan.vocab_padded, D)
    np.testing.assert_array_equal(
        blk["wq"].numpy(), np.asarray(jparams["blocks"]["l0"]["attn"]["wq"]))
    bad = jax.tree.map(np.asarray, jparams)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError):
        params_from_jax(bad, model.cfg, model.plan, "cpu")


def test_init_params_matches_reference_shapes_and_scales(models):
    """Same tree, shapes and dtypes as the reference's init; each
    weight's std within 10% of the reference's (different numbers)."""
    (jmodel, jparams, _), (model, _) = models
    mine = init_params(model.cfg, model.plan, seed=0, device="cpu")
    ref = jax.tree.map(np.asarray, jparams)

    def walk(m, r, path=""):
        if isinstance(r, dict):
            assert set(m) == set(r), path
            for k in r:
                walk(m[k], r[k], f"{path}/{k}")
            return
        assert tuple(m.shape) == r.shape, path
        assert str(m.dtype).split(".")[-1] == str(r.dtype), path
        rs, ms = float(r.std()), float(m.float().std())
        assert abs(ms - rs) <= 0.1 * rs + 1e-6, (path, ms, rs)
    walk(mine, ref)
    again = init_params(model.cfg, model.plan, seed=0, device="cpu")
    assert torch.equal(again["embed"], mine["embed"])
    other = init_params(model.cfg, model.plan, seed=1, device="cpu")
    assert not torch.equal(other["embed"], mine["embed"])
