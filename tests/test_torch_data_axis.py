"""The data axis for serving: the port's ``("data", "model")`` grid of
gloo ranks against the reference's ``("data", "model")`` mesh.

* ``plan_model`` and ``summarize`` on the grid field by field against
  the reference's, for every registry config, full and reduced, at
  (2, 2), (2, 4) and (4, 2), a hybrid with ``kv_seq_axis="data"``; the
  batch-axes rule against the reference's ``make_axis_env``;
* ``init_shard`` bit-equal to ``shard_params(relayout(init_params))`` on
  every rank of a 2 x 2 grid, the model shards the same on both data
  rows, each expert cell its own;
* ``_moe_data_model`` on reduced jamba and llama4 with their experts
  forced onto data x model in both packages' plans, against the
  reference's own ``_moe_data_model`` under ``shard_map`` on 4 fake
  devices (ESL overlap and blocking, once with capacity overflow) at
  1e-5, and against the port's tp=1 ``moe_fwd`` where nothing drops;
* decode with reduced jamba's KV sequence sharded over ``data`` at
  data 2 x model 1 and 2 x 2, across the shard boundary: logits against
  the reference's tp=1 forward at 1e-5 (the reference's sharded
  prefill fails, ROADMAP §3: its sharded serve step runs on its tp=1
  cache cut rank-major and gives the same tokens), the cache slices
  after prefill bit-equal to the port's tp=1 cache cut rank-major at
  model 1 and within 1e-5 of the reference's;
* the grid's prefill and serve steps' greedy tokens against the
  reference's steps at tp=1: smollm-135m at batch 4 (batch over
  ``data``, one all-gather a step on the data ring), jamba at batch 1
  (KV over ``data``), llama4 with its experts forced onto data x model;
* what the grid's train plan gives (FSDP over ``data``) and the
  refusals that remain: a pod axis, FSDP over another axis than
  ``data`` and the engine on a data axis.

Cost in one process ~95 s: one fake-device subprocess for the
reference's ``shard_map`` programs, two spawns of gloo ranks (4 ranks,
2 ranks), the reference's jitted tp=1 steps.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.compiler.mapper import summarize as jax_summarize
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env as jax_axis_env
from repro.core.steps import build_prefill_step as jax_prefill_step
from repro.core.steps import build_serve_step as jax_serve_step
from repro_torch.compiler.mapper import plan_model, summarize
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.dist import batch_axes, make_axis_env, run_ranks
from repro_torch.launch.mesh import make_test_mesh, mesh_axes_shape
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.weights import (_leaves, init_shard, params_from_jax,
                                 relayout, shard_params)
from tests.torch_data_axis_util import (SERVE_F32, grid_cfg, grid_plan,
                                        grid_rank, seq_rank)
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    reduced_pair)
from tests.util import run_multidevice

TESTS = os.path.dirname(os.path.abspath(__file__))
SHAPES = ((2, 2), (2, 4), (4, 2))
GRID = (2, 2)
JAMBA, LLAMA4, SMOLLM = "jamba-v0.1-52b", "llama4-maverick-400b-a17b", \
    "smollm-135m"
MOE_NAMES = (JAMBA, LLAMA4)
MOE_X = (4, 16)                 # (B, S): 32 tokens a data row
OVERFLOW_CF = 0.25              # capacity 8 a bucket: ~16 assigned each
SEQ_MAX, SEQ_PROMPT, SEQ_FEED = 32, 14, 5   # shard 16: 14 .. 18 cross it
STEP_MAX, STEP_NEW = 32, 6


def _tree(jparams):
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def pairs():
    return {n: reduced_pair(n) for n in (SMOLLM, JAMBA, LLAMA4)}


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def _moe_block(tree):
    """The in-block index of the first MoE layer of a tree."""
    return next(lj for lj, v in tree["blocks"].items() if "moe" in v)


def _moe_cases(cfg):
    rng = np.random.default_rng(7)
    x = rng.standard_normal(MOE_X + (cfg.d_model,)).astype(np.float32)
    return [dict(key=f"{'overlap' if ov else 'blocking'}-{tag}", overlap=ov,
                 cf=cf, x=x)
            for ov in (True, False)
            for tag, cf in (("fits", None), ("overflow", OVERFLOW_CF))]


# ---------------------------------------------------------------------------
# the reference's shard_map programs, in one fake-device subprocess
# ---------------------------------------------------------------------------

REFERENCE = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
sys.path.insert(0, TESTS)
from torch_data_axis_util import force_data_model
from repro.core.compat import make_mesh, shard_map
from repro.core.dist import AxisEnv
from repro.compiler.mapper import plan_model
from repro.configs import get_config
from repro.models import moe as jmoe
from repro.models.registry import build_model
from repro.core.steps import build_prefill_step, build_serve_step

F32 = dict(remat='none', compute_dtype='float32', param_dtype='float32')
data = dict(np.load(PATH_IN, allow_pickle=True))
out = {}
mesh = make_mesh((2, 2), ('data', 'model'), devices=jax.devices()[:4])
for name in MOE_NAMES:
    spec = data[f'moe|{name}'].item()
    for c in spec['cases']:
        cfg = get_config(name).reduced()
        if c['cf'] is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=c['cf']))
        plan = force_data_model(plan_model(
            cfg, ('data', 'model'), (2, 2), 'serve',
            esl_overlap=c['overlap'], **F32), cfg.moe.d_ff_expert)
        env = AxisEnv('model', 2, (), 1, ('data',))
        p = spec['moe']
        pspec = {'router': P(), 'wg': P(('data', 'model')),
                 'wu': P(('data', 'model')), 'wd': P(('data', 'model'))}
        if 'shared' in p:
            pspec['shared'] = {'wg': P(None, 'model'),
                               'wu': P(None, 'model'),
                               'wd': P('model', None)}
        xs = P('data', None, 'model') if c['overlap'] else \
            P('data', None, None)

        def f(p, x, cfg=cfg, plan=plan, env=env):
            y, aux = jmoe.moe_fwd(p, x, cfg=cfg, plan=plan, env=env)
            return y, aux[None]
        y, aux = jax.jit(shard_map(f, mesh=mesh, in_specs=(pspec, xs),
                                   out_specs=(xs, P(('data', 'model')))),
                         )(p, c['x'])
        out[f'moe|{name}|{c["key"]}'] = np.asarray(y)
        out[f'aux|{name}|{c["key"]}'] = np.asarray(aux)

# the reference's sharded serve step on its tp=1 cache cut rank-major
# (its sharded prefill fails: ROADMAP)
s = data['seq'].item()
cfg = get_config(s['name']).reduced()
for shape in ((2, 1), (2, 2)):
    plan = plan_model(cfg, ('data', 'model'), shape, 'serve',
                      kv_seq_axis='data', **F32)
    m = build_model(cfg, plan)
    smesh = make_mesh(shape, ('data', 'model'),
                      devices=jax.devices()[:shape[0] * shape[1]])
    serve, _ = build_serve_step(m, smesh, 1, s['max_seq'])
    w = shape[0]

    def cut(a):
        if a.ndim == 5:        # (n_sb, B, S, gp, dh) -> rank-major
            return a.reshape(a.shape[0], a.shape[1], w,
                             a.shape[2] // w, *a.shape[3:])
        return a
    cache = jax.tree.map(cut, s['cache'])
    tok = jnp.asarray(s['first'])
    got = [np.asarray(tok)]
    for i in range(s['steps']):
        tok, cache = jax.jit(serve)(s['params'][str(shape)], cache,
                                    tok[:, None],
                                    jnp.asarray([s['P'] + i], jnp.int32))
        got.append(np.asarray(tok))
    out[f'seq|{shape}'] = np.stack(got)
np.savez(PATH_OUT, **out)
print('DONE')
"""


def _jax_tp1_run(jmodel, jparams, prompt, feed, max_seq):
    """The reference's tp=1 forward: prefill of ``prompt`` (1, P) into a
    cache of ``max_seq``, then each token of ``feed`` one decode step
    each: (logits of every step, the cache after prefill)."""
    env = jax_axis_env(jmodel.plan)
    cache = jmodel.init_cache(1, max_seq, dtype=jnp.float32)
    lg, cache, _ = jmodel.forward(jparams, jnp.asarray(prompt), env=env,
                                  mode="prefill", cache=cache)
    rows, after = [np.asarray(lg[:, -1])], jax.tree.map(np.asarray, cache)
    P = prompt.shape[1]
    for i, t in enumerate(feed):
        lg, cache, _ = jmodel.forward(
            jparams, jnp.full((1, 1), int(t), jnp.int32), env=env,
            mode="decode", positions=jnp.asarray([P + i], jnp.int32),
            cache=cache)
        rows.append(np.asarray(lg[:, -1]))
    return np.stack(rows), after


def _jax_tp1_steps(jmodel, jparams, tokens, new, max_seq):
    """The reference's jitted tp=1 prefill and serve steps' tokens."""
    B, P = tokens.shape
    pre, _ = jax_prefill_step(jmodel, None, B, max_seq)
    serve, _ = jax_serve_step(jmodel, None, B, max_seq)
    cache = jmodel.init_cache(B, max_seq, dtype=jnp.float32)
    tok, cache = jax.jit(pre)(jparams, cache, jnp.asarray(tokens))
    got = [np.asarray(tok).tolist()]
    for i in range(new):
        tok, cache = jax.jit(serve)(jparams, cache, tok[:, None],
                                    jnp.full((B,), P + i, jnp.int32))
        got.append(np.asarray(tok).tolist())
    return got


@pytest.fixture(scope="module")
def seq_inputs(pairs):
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, 512, size=(1, SEQ_PROMPT)).astype(np.int32)
    feed = rng.integers(1, 512, size=SEQ_FEED).astype(np.int32)
    (_, _, jmodel, jparams), _ = pairs[JAMBA]
    logits, cache = _jax_tp1_run(jmodel, jparams, prompt, feed, SEQ_MAX)
    return prompt, feed, logits, cache


@pytest.fixture(scope="module")
def reference(pairs, seq_inputs):
    """The reference's ``_moe_data_model`` under ``shard_map`` for every
    case, and its sharded serve step's tokens, from one fake-device
    subprocess."""
    inputs = {}
    for name in MOE_NAMES:
        (jcfg, _, _, jparams), _ = pairs[name]
        cfg = grid_cfg(name)
        tree = _tree(jparams)
        plan1 = grid_plan(cfg, None)
        plan = grid_plan(cfg, GRID, force=True)
        full = relayout(params_from_jax(tree, cfg, plan1, "cpu"), cfg,
                        plan1, plan)
        moe = _numpy(layer_params(full, 0)[_moe_block(tree)]["moe"])
        inputs[f"moe|{name}"] = dict(moe=moe, cases=_moe_cases(cfg))
    prompt, feed, _, _ = seq_inputs
    (_, _, jmodel, jparams), _ = pairs[JAMBA]
    cache = jmodel.init_cache(1, SEQ_MAX, dtype=jnp.float32)
    pre, _ = jax_prefill_step(jmodel, None, 1, SEQ_MAX)
    tok, cache = jax.jit(pre)(jparams, cache, jnp.asarray(prompt))
    cfg, tree = grid_cfg(JAMBA), _tree(jparams)
    plan1 = grid_plan(cfg, None)
    full1 = params_from_jax(tree, cfg, plan1, "cpu")
    # the tp=1 weights stored at each grid's layout (the layouts are the
    # same in both packages)
    grids = {str(shape): _numpy(relayout(full1, cfg, plan1, grid_plan(
        cfg, shape, kv_seq=True))) for shape in ((2, 1), GRID)}
    inputs["seq"] = dict(name=JAMBA, max_seq=SEQ_MAX, P=SEQ_PROMPT,
                         steps=SEQ_FEED, params=grids,
                         cache=jax.tree.map(np.asarray, cache),
                         first=np.asarray(tok))
    with tempfile.TemporaryDirectory() as d:
        pin, pout = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(pin, **{k: np.asarray(v, dtype=object)
                         for k, v in inputs.items()})
        body = (f"PATH_IN, PATH_OUT, TESTS, MOE_NAMES = {pin!r}, {pout!r}, "
                f"{TESTS!r}, {MOE_NAMES!r}\n" + REFERENCE)
        assert "DONE" in run_multidevice(body, n_devices=4, timeout=900)
        ref = dict(np.load(pout))
    ref["tp1_tokens"] = np.asarray(_jax_tp1_steps(
        jmodel, jparams, prompt, SEQ_FEED, SEQ_MAX))[:, 0]
    return ref


# ---------------------------------------------------------------------------
# the port's ranks: one 4-rank spawn (2 x 2), one 2-rank spawn (2 x 1)
# ---------------------------------------------------------------------------

def _step_cases(pairs):
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 512, size=(4, 7)).astype(np.int32)
    jt = rng.integers(1, 512, size=(1, SEQ_PROMPT)).astype(np.int32)
    return [dict(key="smollm", name=SMOLLM, shape=GRID, tokens=toks),
            dict(key="jamba", name=JAMBA, shape=GRID, kv_seq=True,
                 tokens=jt),
            dict(key="llama4", name=LLAMA4, shape=GRID, force=True,
                 tokens=toks)]


@pytest.fixture(scope="module")
def ranks(pairs, seq_inputs):
    """Every task of the 2 x 2 grid in one spawn of 4 gloo ranks, and the
    2 x 1 grid's sequence-sharded decode in one of 2."""
    prompt, feed, _, _ = seq_inputs
    jtree = _tree(pairs[JAMBA][0][3])
    cases = _step_cases(pairs)
    for c in cases:
        c.update(tree=_tree(pairs[c["name"]][0][3]), new=STEP_NEW,
                 max_seq=STEP_MAX)
    moe = {}
    for name in MOE_NAMES:
        tree = _tree(pairs[name][0][3])
        moe[name] = dict(name=name, shape=GRID, tree=tree,
                         block=_moe_block(tree),
                         cases=_moe_cases(grid_cfg(name)))
    seq = {shape: dict(name=JAMBA, shape=shape, overlap=True, tree=jtree,
                       prompt=prompt, feed=feed, max_seq=SEQ_MAX)
           for shape in ((2, 1), GRID)}
    four = run_ranks(grid_rank, 4, dict(moe=moe, steps=dict(cases=cases),
                                        seq=seq[GRID]),
                     device="cpu", threads=1)
    two = run_ranks(seq_rank, 2, seq[(2, 1)], device="cpu", threads=1)
    return dict(four=four, seq={GRID: four["seq"], (2, 1): two},
                cases=cases)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("mesh_axes", "mesh_shape", "tp", "tp_axis", "dp_axes",
               "fsdp_axes", "d_ff_shard", "d_ff_padded", "vocab_padded",
               "seq_shard_kv", "kv_seq_axis", "esl_overlap", "rules")


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_grid_plan_matches_reference(name):
    for reduced in (False, True):
        cfg, jcfg = get_config(name), jax_get_config(name)
        if reduced:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        kv = "data" if cfg.family == "hybrid" else None
        for shape in SHAPES:
            axes, shp = mesh_axes_shape(*shape)
            mine = plan_model(cfg, axes, shp, "serve", kv_seq_axis=kv)
            ref = jax_plan_model(jcfg, axes, shp, "serve", kv_seq_axis=kv)
            for f in PLAN_FIELDS:
                assert getattr(mine, f) == getattr(ref, f), (name, shape, f)
            if ref.attn is not None:
                assert dataclasses.asdict(mine.attn) == \
                    dataclasses.asdict(ref.attn)
            assert (dataclasses.asdict(mine.moe) if mine.moe else None) == \
                (dataclasses.asdict(ref.moe) if ref.moe else None)
            assert summarize(mine) == jax_summarize(ref), (name, shape)
            for b in (1, 2, 3, 4, 8):
                assert batch_axes(mine, b) == jax_axis_env(ref, batch=b).dp
            if kv:
                assert jax_axis_env(ref).kv_seq_width == shape[0]


def test_giant_moes_spread_experts_over_the_grid():
    """The giant-MoE rule fires for both big MoEs at every tp <= 4 of a
    grid: W = dwidth x tp cells, ep = gcd(E, W)."""
    for name in (JAMBA, LLAMA4):
        for shape in SHAPES:
            plan = plan_model(get_config(name), ("data", "model"), shape,
                              "serve")
            w = shape[0] * shape[1]
            assert plan.moe.expert_axes == ("data", "model")
            assert plan.moe.ep * plan.moe.ffn_split == w
            assert moe_mod.moe_layout(plan)[0] == w
    grid = make_test_mesh(GRID)
    assert grid.model_groups() == [[0, 1], [2, 3]]
    assert grid.data_groups() == [[0, 2], [1, 3]]
    assert [grid.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]


@pytest.mark.parametrize("name,batch", [
    (SMOLLM, 4), (SMOLLM, 1), (JAMBA, 1), (JAMBA, 4), ("rwkv6-7b", 4),
    ("whisper-tiny", 4), ("llava-next-34b", 2)])
def test_cache_specs_and_rank_cache_match_reference(name, batch):
    """``Model.cache_specs`` on the grid is the reference's (a tuple per
    ``PartitionSpec``), and each leaf of ``init_cache(env=...)`` is the
    reference's global leaf cut by its spec: the batch over ``dp``, the
    heads and channels over ``model``, a hybrid's KV sequence over
    ``data`` (its rank-major width dim kept as 1)."""
    from repro.models.registry import build_model as jax_build_model
    from repro_torch.core.dist import AxisEnv
    from repro_torch.models.registry import plan_kv_seq_width
    cfg, jcfg = grid_cfg(name), jax_get_config(name).reduced()
    kv = "data" if cfg.family == "hybrid" else None
    kw = dict(kv_seq_axis=kv, **SERVE_F32)
    plan = plan_model(cfg, ("data", "model"), GRID, "serve", **kw)
    jplan = jax_plan_model(jcfg, ("data", "model"), GRID, "serve", **kw)
    jenv = jax_axis_env(jplan, batch=batch)
    env = AxisEnv(None, GRID[1], dp=batch_axes(plan, batch),
                  kv_seq_axis=kv, kv_seq_width=GRID[0] if kv else 1,
                  dwidth=GRID[0])
    model = build_model(cfg, plan, "cpu")
    jmodel = jax_build_model(jcfg, jplan)
    def norm(spec):
        # a PartitionSpec keeps a one-axis tuple as the axis
        return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                     for e in spec)
    specs = jax.tree.map(norm, model.cache_specs(env),
                         is_leaf=lambda x: isinstance(x, tuple))
    want = jax.tree.map(norm, jmodel.cache_specs(jenv),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert specs == want
    assert plan_kv_seq_width(plan) == (GRID[0] if kv else 1)
    sizes = dict(zip(plan.mesh_axes, plan.mesh_shape))
    glob = jmodel.init_cache(batch, 32, abstract=True, dtype=jnp.float32)
    mine = model.init_cache(batch, 32, env=env, dtype=torch.float32)
    leaves = [((lj, k), spec) for lj, c in want.items()
              for k, spec in c.items()] if cfg.family != "encdec" else \
        [((k,), spec) for k, spec in want.items()]
    for path, spec in leaves:
        g, m = glob, mine
        for key in path:
            g, m = g[key], m[key]
        shape = list(g.shape)
        for d, axes in enumerate(spec):
            for a in ((axes,) if isinstance(axes, str) else axes or ()):
                shape[d] //= sizes[a]
        assert tuple(m.shape) == tuple(shape), path


def test_plan_for_cell_shards_a_hybrids_long_context_over_data():
    """The reference's ``plan_for_cell`` rule: a hybrid at the
    ``long_500k`` decode cell shards its KV over ``data``, in f32;
    nothing else does (a train cell on the grid shards its parameters
    over ``data``: FSDP, its KV sequence whole)."""
    from repro_torch.compiler.mapper import plan_for_cell
    from repro_torch.configs.base import SHAPES as CELLS
    for name in (JAMBA, SMOLLM, "rwkv6-7b"):
        cfg = get_config(name)
        for shape in CELLS.values():
            if shape.kind == "train":
                plan = plan_for_cell(cfg, shape, ("data", "model"), GRID)
                assert plan.fsdp_axes == ("data",) and plan.mode == "train"
                assert plan.kv_seq_axis is None
                continue
            plan = plan_for_cell(cfg, shape, ("data", "model"), GRID)
            want = "data" if (cfg.family == "hybrid"
                              and shape.name == "long_500k") else None
            assert plan.kv_seq_axis == want, (name, shape.name)
            assert plan.mode == ("train" if shape.kind == "train"
                                 else "serve")
            if shape.kind == "decode":
                assert plan.param_dtype == "float32"


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    (SMOLLM, {}), (JAMBA, dict(kv_seq=True)), (JAMBA, dict(force=True)),
    (LLAMA4, dict(force=True)), ("rwkv6-7b", {})])
def test_init_shard_bit_equal_on_the_grid(name, kw):
    cfg = grid_cfg(name)
    plan, plan1 = grid_plan(cfg, GRID, **kw), grid_plan(cfg, None)
    full = relayout(init_params(cfg, plan1, seed=0, device="cpu"), cfg,
                    plan1, plan)
    shards = []
    for r in range(4):
        mine = dict(_leaves(init_shard(cfg, plan, r, seed=0, device="cpu")))
        want = dict(_leaves(shard_params(full, plan, r)))
        assert mine.keys() == want.keys()
        for path in want:
            assert torch.equal(mine[path], want[path]), (name, r, path)
        shards.append(mine)
    for path in shards[0]:
        experts = "/moe/w" in path and plan.moe is not None and \
            len(plan.moe.expert_axes) > 1
        for m in range(2):
            same = torch.equal(shards[m][path], shards[2 + m][path])
            assert same != experts or \
                not shards[m][path].any(), (path, m)


# ---------------------------------------------------------------------------
# the giant MoE over data x model
# ---------------------------------------------------------------------------

def _assemble(per_rank, key, overlap):
    """The global (B, S, D) output from every rank's block: data rows
    stacked, model blocks concatenated under ESL overlap (each model
    rank's whole output is the same without it)."""
    by = {r["rank"]: r["out"][key]["y"] for r in per_rank}
    rows = []
    for d in range(GRID[0]):
        blocks = [by[d * GRID[1] + m] for m in range(GRID[1])]
        if overlap:
            rows.append(np.concatenate(blocks, -1))
        else:
            for b in blocks[1:]:
                np.testing.assert_array_equal(b, blocks[0])
            rows.append(blocks[0])
    return np.concatenate(rows, 0)


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_data_model_matches_reference(ranks, reference, name):
    per_rank = ranks["four"]["moe"][name]
    for c in _moe_cases(grid_cfg(name)):
        y = _assemble(per_rank, c["key"], c["overlap"])
        np.testing.assert_allclose(y, reference[f"moe|{name}|{c['key']}"],
                                   rtol=1e-5, atol=1e-5, err_msg=c["key"])
        aux = [r["out"][c["key"]]["aux"] for r in per_rank]
        np.testing.assert_allclose(aux, reference[f"aux|{name}|{c['key']}"],
                                   rtol=1e-5, atol=1e-6)
        # two all-to-alls out and one back over data, nothing else there
        assert {r["out"][c["key"]]["data_collectives"]
                for r in per_rank} == {3}


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_data_model_equals_tp1_where_nothing_drops(ranks, pairs, name):
    per_rank = ranks["four"]["moe"][name]
    (_, _, _, jparams), (cfg, plan1, _, params) = pairs[name]
    p = layer_params(params, 0)[_moe_block(_tree(jparams))]["moe"]
    dropped = False
    for c in _moe_cases(cfg):
        y = _assemble(per_rank, c["key"], c["overlap"])
        with torch.no_grad():
            want, _ = moe_mod.moe_fwd(p, torch.from_numpy(c["x"]), cfg=cfg,
                                      plan=plan1)
        close = np.allclose(y, want.numpy(), rtol=1e-5, atol=1e-5)
        if c["cf"] is None:
            assert close, c["key"]
        else:
            dropped |= not close
    assert dropped, "the overflow cases were meant to drop assignments"


# ---------------------------------------------------------------------------
# KV sequence sharding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), GRID])
def test_seq_sharded_decode_matches_reference(ranks, seq_inputs, reference,
                                              pairs, shape):
    _, _, want, ref_cache = seq_inputs
    per_rank = ranks["seq"][shape]
    cfg = grid_cfg(JAMBA)
    s_loc = SEQ_MAX // shape[0]
    plan = grid_plan(cfg, shape, kv_seq=True)
    # the port's own tp=1 prefill cache, for the bit-equal check
    (_, _, _, _), (_, plan1, model1, params1) = pairs[JAMBA]
    prompt = torch.from_numpy(seq_inputs[0]).long()
    cache1 = model1.init_cache(1, SEQ_MAX)
    with torch.no_grad():
        model1.forward(params1, prompt, mode="prefill", cache=cache1)
    for r in per_rank:
        assert r["dp"] == () and r["kv_seq_width"] == shape[0]
        np.testing.assert_allclose(r["logits"], want[:, :, :r[
            "logits"].shape[-1]], rtol=1e-5, atol=1e-5)
        lo = r["d"] * s_loc
        kv = plan.attn.kv_orig[r["m"] * plan.attn.kv_per_rank:
                               (r["m"] + 1) * plan.attn.kv_per_rank]
        for lj, c in r["after_prefill"].items():
            for k in ("k", "v"):
                mine = c[k][:, :, 0]            # (n_sb, B, S_loc, kpr, dh)
                ref = ref_cache[lj][k][:, :, lo:lo + s_loc][:, :, :, kv]
                np.testing.assert_allclose(mine, ref, rtol=1e-5, atol=1e-5)
                if shape[1] == 1:
                    own = cache1[lj][k][:, :, lo:lo + s_loc].numpy()
                    np.testing.assert_array_equal(mine, own)
        # the new rows landed on the rank that owns their slots only
        for lj, c in r["final"].items():
            rows = np.abs(c["k"][:, :, 0]).sum(axis=(0, 1, 3, 4)) > 0
            own = np.arange(s_loc) + lo < SEQ_PROMPT + SEQ_FEED
            np.testing.assert_array_equal(rows, own)
    # the reference's sharded decode on its tp=1 cache: its tp=1 tokens
    np.testing.assert_array_equal(reference[f"seq|{shape}"][:, 0],
                                  reference["tp1_tokens"])


# ---------------------------------------------------------------------------
# the serving steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["smollm", "jamba", "llama4"])
def test_grid_steps_equal_reference_tp1_steps(ranks, pairs, key):
    case = next(c for c in ranks["cases"] if c["key"] == key)
    (_, _, jmodel, jparams), _ = pairs[case["name"]]
    want = _jax_tp1_steps(jmodel, jparams, case["tokens"], STEP_NEW,
                          STEP_MAX)
    per_rank = ranks["four"]["steps"]
    for r in per_rank:
        got = r["out"][key]
        assert got["tokens"] == want, (key, r["rank"])
    dp = per_rank[0]["out"][key]["dp"]
    assert dp == (() if key == "jamba" else ("data",))
    per_step = {tuple(r["out"][key]["data_per_step"]) for r in per_rank}
    cfg = grid_cfg(case["name"])
    # data-ring collectives a step: the tokens' all-gather when the batch
    # splits over data; pmax + two psums per attention layer with the KV
    # sequence over data; the MoE layers' three all-to-alls
    n_attn = sum(cfg.is_attention_layer(j) for j in range(cfg.n_layers))
    n_moe = cfg.n_layers // cfg.moe.moe_every if key == "llama4" else 0
    want_n = (1 if dp else 0) + (3 * n_attn if key == "jamba" else 0) \
        + 3 * n_moe
    assert per_step == {(want_n,) * STEP_NEW}, (key, per_step)


# ---------------------------------------------------------------------------
# what still raises
# ---------------------------------------------------------------------------

def test_training_on_a_data_axis_raises_naming_fsdp():
    """Training on the grid is planned (FSDP over ``data``, the
    reference's rule table); FSDP over another axis than ``data`` raises
    naming FSDP, a pod axis naming itself, and the int8 sync over a pod
    axis (``compress_pod_grads``) naming itself."""
    from repro_torch.core.steps import build_train_step
    cfg = get_config(SMOLLM).reduced()
    plan = plan_model(cfg, ("data", "model"), GRID, "train")
    ref = jax_plan_model(jax_get_config(SMOLLM).reduced(), ("data", "model"),
                         GRID, "train")
    assert plan.fsdp_axes == ref.fsdp_axes == ("data",)
    assert plan.rules == ref.rules
    assert plan.rules["embed"] == plan.rules["vocab_rep"] == ("data",)
    bad = dataclasses.replace(plan, fsdp_axes=("model",))
    with pytest.raises(NotImplementedError, match="FSDP"):
        make_axis_env(bad, ring=object())
    with pytest.raises(NotImplementedError, match="pod"):
        plan_model(cfg, ("pod", "data", "model"), (2, 2, 2), "serve")
    with pytest.raises(NotImplementedError, match="compress_pod_grads"):
        build_train_step(build_model(cfg, plan, "cpu"), None, None, 4,
                         compress_pod_grads=True)


def test_engine_on_a_data_axis_raises_naming_it():
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = get_config(SMOLLM).reduced()
    plan = plan_model(cfg, ("data", "model"), GRID, "serve", **SERVE_F32)
    with pytest.raises(NotImplementedError,
                       match="the engine on a data axis"):
        LPUEngine(build_model(cfg, plan, "cpu"),
                  init_shard(cfg, plan, 0, device="cpu"),
                  EngineConfig(slots=2, max_seq=64), device="cpu")
