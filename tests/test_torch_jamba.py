"""The port's jamba slice against the JAX reference on the reduced
jamba-v0.1-52b (8 layers in two super-blocks of 4: mamba at in-block
indices 0, 1, 3 and attention at 2, MoE on the odd layers with 8
experts top-2; d 128, 8/2 heads x 32, d_inner 256, d_state 8, vocab
512), with the reference's weights carried across by
``params_from_jax``: config and plan, the weight bridge and init laws,
the mamba block, the MoE layer (also with capacity 1.0 and overflowing
experts), the model's logits over one prefill plus 8 decode steps, the
prefill scatter of the hybrid cache, and the serving engine's greedy
streams."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import _expected_shapes, params_from_jax

ARCH = "jamba"
SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
# f32 end to end; only the order of sums differs between the packages
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_kv_cache.py:179's trace
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
MAX_NEW = 12


def _cfgs(reduced=True):
    cfg, jcfg = get_config(ARCH), jax_get_config("jamba-v0.1-52b")
    return (cfg.reduced(), jcfg.reduced()) if reduced else (cfg, jcfg)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = _cfgs()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    np_params = jax.tree.map(np.asarray, jparams)
    params = params_from_jax(np_params, cfg, plan, "cpu")
    return {"jmodel": jmodel, "jparams": jparams, "env": make_axis_env(jplan),
            "np_params": np_params, "model": model, "params": params}


# ---------------------------------------------------------------------------
# config, plan, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_plan_match_reference(reduced):
    cfg, jcfg = _cfgs(reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for mode, kw in (("serve", SERVE_F32), ("serve", {}), ("train", {})):
        mine = plan_model(cfg, None, (1,), mode, **kw)
        ref = jax_plan_model(jcfg, None, (1,), mode, **kw)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(ref.moe)
        mine, ref = dataclasses.asdict(mine), dataclasses.asdict(ref)
        mine.pop("rules")
        ref.pop("rules")
        assert mine == ref
    moe = plan_model(cfg, None, (1,), "serve").moe
    e = 8 if reduced else 16
    assert (moe.n_experts, moe.ep, moe.ffn_split, moe.experts_per_rank,
            moe.expert_axes) == (e, 1, 1, e, ())
    assert moe.d_ff_expert_shard == (128 if reduced else 14336)
    assert moe.capacity_factor == (8.0 if reduced else 2.0)
    if reduced:   # the reference's hybrid reduction
        assert (cfg.n_layers, cfg.mamba.attn_every, cfg.mamba.attn_offset,
                cfg.moe.n_experts) == (8, 4, 2, 8)
    assert get_config("jamba-v0.1-52b") is get_config("jamba")


def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{pre}{k}/")
        else:
            yield pre + k, v


def test_params_from_jax_round_trips(setup):
    ref = dict(_leaves(setup["np_params"]))
    got = dict(_leaves(setup["params"]))
    assert sorted(got) == sorted(ref)
    for path, arr in ref.items():
        assert np.array_equal(got[path].numpy(), arr), path
        assert got[path].dtype == torch.float32
    cfg, plan = setup["model"].cfg, setup["model"].plan
    for path, shape in (("blocks/l1/moe/wg", (2, 8, 128, 128)),
                        ("blocks/l0/mamba/a_log", (2, 256, 16)),
                        ("blocks/l2/attn/wq", (2, 128, 8, 16))):
        bad = jax.tree.map(lambda a: a, setup["np_params"])
        node = bad
        *parents, leaf = path.split("/")
        for key in parents:
            node = node[key]
        node[leaf] = np.zeros(shape, np.float32)
        with pytest.raises(ValueError, match=path):
            params_from_jax(bad, cfg, plan, "cpu")


@pytest.mark.parametrize("reduced", [True, False])
def test_init_shapes_match_reference(reduced):
    """The reference's (abstract) init tree: the weight bridge's expected
    layout at full width and reduced, and (reduced: the full width takes
    53 GB at depth 8) the port's seeded init with the same tree, shapes
    and dtypes."""
    cfg, jcfg = _cfgs(reduced)
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    ref, _ = jax_build_model(jcfg, jplan).abstract_params()
    ref = {p: tuple(a.shape) for p, a in _leaves(ref)}
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    assert _expected_shapes(cfg, plan) == ref
    if not reduced:
        # depth 8, the card's cut: 13.3e9 parameters, 53 GB in f32
        cut = dataclasses.replace(cfg, n_layers=8)
        n = sum(math.prod(s) for s in _expected_shapes(cut, plan).values())
        assert 13.2e9 < n < 13.4e9
        return
    mine = init_params(cfg, plan, seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in _leaves(mine)} == ref
    assert all(t.dtype == torch.float32 for _, t in _leaves(mine))


def test_init_laws_follow_reference():
    """Std of every random leaf and the fixed leaves, on the reduced
    config (D 128, d_inner 256, d_ff_expert 128, K 4, dt_rank 16)."""
    cfg, _ = _cfgs()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    p = init_params(cfg, plan, seed=0, device="cpu")["blocks"]
    D, d_in, K, r = 128, 256, 4, 16
    laws = {("l0", "mamba", "in_x"): 1 / math.sqrt(D),
            ("l0", "mamba", "in_z"): 1 / math.sqrt(D),
            ("l0", "mamba", "conv_w"): 1 / math.sqrt(K),
            ("l0", "mamba", "x_proj"): 1 / math.sqrt(d_in),
            ("l0", "mamba", "dt_proj"): 1 / math.sqrt(r),
            ("l0", "mamba", "out_proj"): 1 / d_in,
            ("l1", "moe", "router"): 1 / math.sqrt(D),
            ("l1", "moe", "wg"): 1 / math.sqrt(D),
            ("l1", "moe", "wu"): 1 / math.sqrt(D),
            ("l1", "moe", "wd"): 1 / math.sqrt(128),
            ("l0", "mlp", "wg"): 1 / math.sqrt(D),
            ("l2", "attn", "wq"): 1 / math.sqrt(D)}
    for (lj, mod, leaf), std in laws.items():
        got = p[lj][mod][leaf].std().item()
        assert abs(got / std - 1) < 0.1, (lj, mod, leaf, got, std)
    mb = p["l3"]["mamba"]
    want_a = torch.log(torch.arange(1, 9, dtype=torch.float32))
    assert torch.equal(mb["a_log"], want_a.expand_as(mb["a_log"]))
    assert torch.equal(mb["d_skip"], torch.ones_like(mb["d_skip"]))
    for leaf in ("dt_bias", "conv_b"):
        assert torch.equal(mb[leaf], torch.zeros_like(mb[leaf]))
    assert set(p) == {"l0", "l1", "l2", "l3"}
    assert {k for k in p["l2"]} == {"ln1", "attn", "ln2", "mlp"}
    assert {k for k in p["l3"]} == {"ln1", "mamba", "ln2", "moe"}


def test_single_super_block_is_stacked_as_views():
    """One super-block (jamba cut to one block, as on the card): its
    leaves are stacked as views of the drawn tree, never copied, so the
    peak stays at the model plus one leaf."""
    cfg, _ = _cfgs()
    cfg = dataclasses.replace(cfg, n_layers=4)
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    blocks = init_params(cfg, plan, seed=0, device="cpu")["blocks"]
    leaves = dict(_leaves(blocks))
    assert all(t.shape[0] == 1 and t._base is not None
               for t in leaves.values())


# ---------------------------------------------------------------------------
# mamba block / MoE layer
# ---------------------------------------------------------------------------

def _block(tree, lj, i):
    return jax.tree.map(lambda a: a[i], tree["blocks"][lj])


def _torch_block(params, lj, i):
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"][lj])


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_mamba_fwd_matches_reference(setup, with_state, S):
    model = setup["model"]
    cfg, plan = model.cfg, model.plan
    jp = _block(setup["jparams"], "l3", 1)["mamba"]
    p = _torch_block(setup["params"], "l3", 1)["mamba"]
    x = _x(2, S, cfg.d_model, seed=S)
    g = np.random.default_rng(7)
    conv = g.standard_normal((2, cfg.mamba.d_conv - 1, 256)).astype(
        np.float32)
    ssm = (0.1 * g.standard_normal((2, 256, cfg.mamba.d_state))).astype(
        np.float32)
    jst = ({"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
           if with_state else None)
    st = ({"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(ssm)}
          if with_state else None)
    yr, str_ = jax_mamba.mamba_fwd(jp, jnp.asarray(x),
                                   cfg=setup["jmodel"].cfg,
                                   plan=setup["jmodel"].plan,
                                   env=setup["env"], state=jst)
    before = (scan_ops.mamba_scan.launches,
              scan_ops.mamba_scan_fused.launches)
    y, st2 = mamba_mod.mamba_fwd(p, torch.from_numpy(x), cfg=cfg, plan=plan,
                                 state=st)
    assert (scan_ops.mamba_scan.launches,
            scan_ops.mamba_scan_fused.launches) == before  # CPU: plain
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **LAYER_TOL)
    for key in ("conv", "ssm"):
        np.testing.assert_allclose(st2[key].numpy(), np.asarray(str_[key]),
                                   **LAYER_TOL)
    # the oracle switch computes the same function
    y_plain, _ = mamba_mod.mamba_fwd(p, torch.from_numpy(x), cfg=cfg,
                                     plan=plan, state=st, use_kernels=False)
    assert torch.equal(y_plain, y)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 5])
def test_mamba_fwd_equals_the_unfused_path_bit_for_bit(setup, monkeypatch,
                                                      with_state, S):
    """The layer's output and state through the fused entry's plain
    version equal the former PyTorch producers + plain scan, bit for bit."""
    model = setup["model"]
    p = _torch_block(setup["params"], "l3", 1)["mamba"]
    x = torch.from_numpy(_x(2, S, model.cfg.d_model, seed=S + 1))
    g = np.random.default_rng(8)
    st = ({"conv": torch.from_numpy(g.standard_normal(
              (2, model.cfg.mamba.d_conv - 1, 256)).astype(np.float32)),
           "ssm": torch.from_numpy((0.1 * g.standard_normal(
               (2, 256, model.cfg.mamba.d_state))).astype(np.float32))}
          if with_state else None)
    kw = dict(cfg=model.cfg, plan=model.plan, state=st)
    y, new = mamba_mod.mamba_fwd(p, x, **kw)
    monkeypatch.setattr(mamba_mod, "mamba_scan_fused_ref", _unfused_scan)
    y_old, old = mamba_mod.mamba_fwd(p, x, use_kernels=False, **kw)
    assert torch.equal(y, y_old)
    assert all(torch.equal(new[k], old[k]) for k in ("conv", "ssm"))


def test_causal_conv_matches_reference():
    g = np.random.default_rng(2)
    x = g.standard_normal((2, 6, 10)).astype(np.float32)
    w = g.standard_normal((4, 10)).astype(np.float32)
    b = g.standard_normal((10,)).astype(np.float32)
    st = g.standard_normal((2, 3, 10)).astype(np.float32)
    for state in (None, st):
        yr, sr = jax_mamba._causal_conv(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
            None if state is None else jnp.asarray(state))
        y, s = mamba_mod._causal_conv(
            torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
            None if state is None else torch.from_numpy(state))
        np.testing.assert_array_equal(y.numpy(), np.asarray(yr))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sr))


def _moe_case(setup, capacity=None, skew=0.0, T=(2, 5), seed=0):
    model, jmodel = setup["model"], setup["jmodel"]
    cfg, plan, jplan = model.cfg, model.plan, jmodel.plan
    if capacity is not None:
        plan = dataclasses.replace(plan, moe=dataclasses.replace(
            plan.moe, capacity_factor=capacity))
        jplan = dataclasses.replace(jplan, moe=dataclasses.replace(
            jplan.moe, capacity_factor=capacity))
    jp = _block(setup["jparams"], "l1", 0)["moe"]
    p = _torch_block(setup["params"], "l1", 0)["moe"]
    x = _x(*T, cfg.d_model, seed=seed)
    if skew:
        # pull every token towards expert 0's router column: overflow
        col = np.asarray(jp["router"])[:, 0]
        x = x + skew * col / np.linalg.norm(col)
    yr, auxr = jax_moe.moe_fwd(jp, jnp.asarray(x), cfg=jmodel.cfg,
                               plan=jplan, env=setup["env"])
    y, aux = moe_mod.moe_fwd(p, torch.from_numpy(x), cfg=cfg, plan=plan)
    return x, y, aux, yr, auxr, plan, p


@pytest.mark.parametrize("T", [(2, 5), (4, 1), (1, 24)])
def test_moe_fwd_matches_reference(setup, T):
    _, y, aux, yr, auxr, _, _ = _moe_case(setup, T=T, seed=sum(T))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(auxr), **MOE_TOL)


@pytest.mark.parametrize("skew", [0.0, 40.0])
def test_moe_capacity_one_with_overflow_matches_reference(setup, skew):
    """Capacity 1.0 (the reduced config's 8.0 never drops a token): the
    skewed case sends more tokens to one expert than its capacity, so
    the top-C selection drops some, and which ones depends on the order
    among equal scores (lowest index first, as ``lax.top_k``)."""
    x, y, aux, yr, auxr, plan, p = _moe_case(setup, capacity=1.0, skew=skew,
                                             T=(1, 40), seed=11)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(auxr), **MOE_TOL)
    cfg = setup["model"].cfg
    ids, _, _ = moe_mod._route(p, torch.from_numpy(x[0]), cfg, plan)
    counts = torch.bincount(ids.reshape(-1), minlength=8)
    if skew:
        # tokens were dropped: the no-drop sum differs
        assert counts.max().item() > moe_mod._capacity(40, 2, 8, 1.0)
        full, _ = moe_mod.moe_fwd(p, torch.from_numpy(x), cfg=cfg,
                                  plan=setup["model"].plan)
        assert not torch.allclose(full, y)


def test_select_topc_breaks_ties_to_the_lowest_index():
    score = torch.tensor([0., 1., 1., 0., 1., 1., 1., 0.])
    idx, valid = moe_mod._select_topc(score, 4)
    assert idx.tolist() == [1, 2, 4, 5] and valid.all()
    vals, ref_idx = jax.lax.top_k(jnp.asarray(score.numpy()), 4)
    assert idx.tolist() == np.asarray(ref_idx).tolist()
    idx, valid = moe_mod._select_topc(score, 7)
    assert idx.tolist() == [1, 2, 4, 5, 6, 0, 3]
    assert valid.tolist() == [True] * 5 + [False] * 2


# ---------------------------------------------------------------------------
# model logits: one prefill per sequence + 8 decode steps
# ---------------------------------------------------------------------------

LENS = (5, 11)
N_STEPS = 8


def _tokens():
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 512, size=n).astype(np.int32) for n in LENS]
    steps = r.integers(1, 512, size=(N_STEPS, len(LENS))).astype(np.int32)
    return prompts, steps


def _run_jax(setup):
    jmodel, jparams, env = setup["jmodel"], setup["jparams"], setup["env"]
    prompts, steps = _tokens()
    cache = jmodel.init_cache(len(LENS), 64)
    rows = []
    for b, p in enumerate(prompts):
        n = len(p)
        logits, pc, _ = jmodel.forward(
            jparams, jnp.asarray(p[None]), env=env, mode="prefill",
            cache=jmodel.init_cache(1, n), positions=jnp.arange(n)[None])
        rows.append(np.asarray(logits[0, n - 1]))
        cache = jax_kv.scatter_prefill_dense(cache, pc, jnp.int32(b))
    pos = np.array(LENS, np.int32)
    for t in range(N_STEPS):
        logits, cache, _ = jmodel.forward(
            jparams, jnp.asarray(steps[t][:, None]), env=env, mode="decode",
            positions=jnp.asarray(pos), cache=cache)
        rows.append(np.asarray(logits[:, -1]))
        pos = pos + 1
    return rows, cache


def _run_torch(setup, use_kernels=True):
    model, params = setup["model"], setup["params"]
    prompts, steps = _tokens()
    cache = model.init_cache(len(LENS), 64)
    rows = []
    for b, p in enumerate(prompts):
        n = len(p)
        logits, pc = model.forward(params, torch.from_numpy(p[None]),
                                   mode="prefill",
                                   cache=model.init_cache(1, n),
                                   positions=torch.arange(n)[None],
                                   use_kernels=use_kernels)
        rows.append(logits[0, n - 1].numpy())
        kv_cache.scatter_prefill_dense(cache, pc, b)
    pos = torch.tensor(LENS, dtype=torch.int32)
    for t in range(N_STEPS):
        logits, _ = model.forward(params, torch.from_numpy(steps[t][:, None]),
                                  mode="decode", positions=pos, cache=cache,
                                  use_kernels=use_kernels)
        rows.append(logits[:, -1].numpy())
        pos = pos + 1
    return rows, cache


def test_logits_match_reference(setup):
    ref_rows, ref_cache = _run_jax(setup)
    rows, cache = _run_torch(setup)
    assert len(rows) == len(ref_rows) == len(LENS) + N_STEPS
    for got, want in zip(rows, ref_rows):
        np.testing.assert_allclose(got, want, **LOGIT_TOL)
    assert set(cache) == set(ref_cache) == {"l0", "l1", "l2", "l3"}
    for lj, c in cache.items():
        for key, t in c.items():
            np.testing.assert_allclose(t.numpy(),
                                       np.asarray(ref_cache[lj][key]),
                                       **LOGIT_TOL)
    # the plain-scan oracle switch computes the same function
    plain_rows, _ = _run_torch(setup, use_kernels=False)
    for got, want in zip(plain_rows, rows):
        np.testing.assert_array_equal(got, want)


def _unfused_scan(dt, x, a, b, c, h0):
    """The mamba layer's scan before the fused entry: da and bx formed by
    PyTorch as (B,S,C,N) tensors, then the plain scan."""
    da = torch.exp(dt[..., None] * a)
    bx = (dt * x)[..., None] * b[:, :, None, :]
    return mamba_scan_ref(da.contiguous(), bx.contiguous(), c, h0)


def test_logits_equal_the_unfused_path_bit_for_bit(setup, monkeypatch):
    """The fused entry leaves the CPU results as they were: logits over
    prefill + 8 decode steps and every cache entry, bit for bit."""
    rows, cache = _run_torch(setup)
    monkeypatch.setattr(mamba_mod, "mamba_scan_fused_ref", _unfused_scan)
    old_rows, old_cache = _run_torch(setup, use_kernels=False)
    for got, want in zip(rows, old_rows):
        np.testing.assert_array_equal(got, want)
    for lj, c in cache.items():
        for key, t in c.items():
            assert torch.equal(t, old_cache[lj][key]), (lj, key)


def test_cache_layout_and_bytes_match_reference(setup):
    model, jmodel = setup["model"], setup["jmodel"]
    cache = model.init_cache(3, 64)
    ref = jmodel.init_cache(3, 64)
    assert set(cache) == set(ref)
    for lj, c in cache.items():
        assert set(c) == set(ref[lj]), lj
        for key, t in c.items():
            r = ref[lj][key]
            assert tuple(t.shape) == tuple(r.shape), (lj, key)
            assert str(t.dtype).split(".")[-1] == str(r.dtype), (lj, key)
    assert set(cache["l2"]) == {"k", "v"}
    assert set(cache["l0"]) == {"conv", "ssm"}
    assert kv_cache.cache_bytes(cache) == jax_kv.cache_bytes(ref)
    half = model.init_cache(3, 64, dtype=torch.float16)
    assert half["l0"]["conv"].dtype == torch.float16
    assert half["l0"]["ssm"].dtype == torch.float32
    assert not model.supports_paged_kv()
    with pytest.raises(ValueError, match="paged KV"):
        model.init_cache(3, 64, paged=True, num_blocks=4, block_size=16)


def test_hybrid_refuses_paged_modes(setup):
    model, params = setup["model"], setup["params"]
    with pytest.raises(NotImplementedError, match="paged pool"):
        model.forward(params, torch.ones((1, 4), dtype=torch.long),
                      mode="chunk_prefill", cache=model.init_cache(1, 4))


# ---------------------------------------------------------------------------
# prefill scatter of the hybrid cache
# ---------------------------------------------------------------------------

def test_scatter_prefill_dense_replaces_states_and_fills_kv(setup):
    """Mamba ``conv``/``ssm`` leaves of the slot are replaced wholesale and
    the attention layer's k/v fill the slot's sequence prefix, as the
    reference's ``scatter_prefill_dense`` does; other slots are
    untouched."""
    model = setup["model"]
    g = np.random.default_rng(3)

    def rand_tree(c):
        return {lj: {k: g.standard_normal(tuple(t.shape)).astype(np.float32)
                     for k, t in leaves.items()} for lj, leaves in c.items()}
    full = rand_tree(model.init_cache(3, 64))
    pre = rand_tree(model.init_cache(1, 7))
    want = jax_kv.scatter_prefill_dense(
        jax.tree.map(jnp.asarray, full), jax.tree.map(jnp.asarray, pre),
        jnp.int32(1))
    cache = jax.tree.map(lambda a: torch.from_numpy(a.copy()), full)
    kv_cache.scatter_prefill_dense(cache, jax.tree.map(torch.from_numpy, pre),
                                   1)
    for lj, c in cache.items():
        for key, t in c.items():
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(want[lj][key]))
            np.testing.assert_array_equal(t[:, 0].numpy(), full[lj][key][:, 0])
            if key in ("k", "v"):
                np.testing.assert_array_equal(t[:, 1, :7].numpy(),
                                              pre[lj][key][:, 0])
                np.testing.assert_array_equal(t[:, 1, 7:].numpy(),
                                              full[lj][key][:, 1, 7:])
            else:
                np.testing.assert_array_equal(t[:, 1].numpy(),
                                              pre[lj][key][:, 0])


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_streams(setup):
    return JaxEngine(setup["jmodel"], setup["jparams"],
                     JaxEngineConfig(slots=3, max_seq=64, paged=False)
                     ).generate(PROMPTS, max_new_tokens=MAX_NEW)


ENGINES = {
    "default": dict(),
    "s4-window": dict(steps_per_sync=4),
    "host-sampling": dict(sampling="host"),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_streams_match_reference(setup, ref_streams, name):
    eng = LPUEngine(setup["model"], setup["params"],
                    EngineConfig(slots=3, max_seq=64, **ENGINES[name]),
                    device="cpu")
    assert not eng.paged and not eng.bucketed
    before = (scan_ops.mamba_scan.launches,
              scan_ops.mamba_scan_fused.launches)
    got = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    assert got == ref_streams
    assert (scan_ops.mamba_scan.launches,
            scan_ops.mamba_scan_fused.launches) == before  # CPU: plain
    assert eng.stats.tokens == len(PROMPTS) * (MAX_NEW - 1)
    # prefill at the exact prompt length: one per distinct length
    assert eng.stats.prefill_traces == len({len(p) for p in PROMPTS})


def test_engine_output_independent_of_min_bucket(setup):
    """After tests/test_serving.py:170: recurrent state folds every
    prefill position in, so prompts are never padded to a bucket."""
    outs = []
    for mb in (4, 32):
        eng = LPUEngine(setup["model"], setup["params"],
                        EngineConfig(slots=2, max_seq=64, min_bucket=mb),
                        device="cpu")
        assert not eng.paged and not eng.bucketed
        outs.append(eng.generate([[1, 2, 3, 4, 5], [6, 7]],
                                 max_new_tokens=4))
    assert outs[0] == outs[1]


def test_engine_bytes_and_paged_refusal(setup):
    """Analytic bytes moved per decode step: the two attention layers'
    dense k/v (read once) plus the six mamba states read and written
    (the reference counts every layer as attention)."""
    eng = LPUEngine(setup["model"], setup["params"],
                    EngineConfig(slots=3, max_seq=64), device="cpu")
    slots, max_seq, gp, dh, d_in, N, K = 3, 64, 2, 32, 256, 8, 4
    kv = 2 * 2 * slots * max_seq * gp * dh * 4
    state = 6 * slots * ((K - 1) * d_in + d_in * N) * 4
    assert eng.kv_cache_bytes() == kv + state
    assert eng.kv_bytes_moved_per_step() == kv + 2 * state == 602112
    assert eng.dense_equiv_bytes() == kv + state
    with pytest.raises(ValueError, match="paged KV"):
        LPUEngine(setup["model"], setup["params"],
                  EngineConfig(slots=3, max_seq=64, paged=True),
                  device="cpu")


def test_serve_cli_jamba(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "jamba", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--max-seq",
                       "64"])
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    out = capsys.readouterr().out
    assert "kv=dense" in out
    assert "mamba_scan_fused kernel launches=0" in out
    assert "x 6 mamba layers" in out
