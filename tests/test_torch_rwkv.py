"""The port's rwkv slice against the JAX reference on the reduced
rwkv6-7b (2 layers, d 128, 4 heads x 32, d_ff 256, vocab 512), with the
reference's weights carried across by ``params_from_jax``: config and
plan, the weight bridge, time mix / channel mix, the model's logits over
one prefill plus 8 decode steps, the prefill scatter of the recurrent
state, and the serving engine's greedy streams."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models import rwkv as jax_rwkv
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.kernels.rwkv_scan import ops as scan_ops
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import _expected_shapes, params_from_jax
from tests.torch_dense_util import one_torch_thread  # noqa: F401

ARCH = "rwkv6-7b"
SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
# f32 end to end; only the order of sums differs between the packages
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# tests/test_kv_cache.py:179's trace
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7]]
MAX_NEW = 12


def _cfgs(reduced=True):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
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
        mine = dataclasses.asdict(plan_model(cfg, None, (1,), mode, **kw))
        ref = dataclasses.asdict(jax_plan_model(jcfg, None, (1,), mode, **kw))
        mine.pop("rules")
        ref.pop("rules")
        assert mine == ref


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
    bad = jax.tree.map(lambda a: a, setup["np_params"])
    bad["blocks"]["l0"]["tmix"]["w_o"] = np.zeros((1, 2, 3), np.float32)
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="tmix/w_o"):
        params_from_jax(bad, cfg, setup["model"].plan, "cpu")


@pytest.mark.parametrize("reduced", [True, False])
def test_init_shapes_match_reference(reduced):
    """The reference's (abstract) init tree: the weight bridge's expected
    layout at full width and reduced, and the port's seeded init (reduced:
    the full width takes 30 GB) with the same tree, shapes and dtypes."""
    cfg, jcfg = _cfgs(reduced)
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    ref, _ = jax_build_model(jcfg, jplan).abstract_params()
    ref = {p: tuple(a.shape) for p, a in _leaves(ref)}
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    assert _expected_shapes(cfg, plan) == ref
    if reduced:
        mine = init_params(cfg, plan, seed=0, device="cpu")
        assert {p: tuple(t.shape) for p, t in _leaves(mine)} == ref
        assert all(t.dtype == torch.float32 for _, t in _leaves(mine))
        tm = mine["blocks"]["l0"]["tmix"]
        assert torch.equal(tm["ln_x"], torch.ones_like(tm["ln_x"]))
        for key, scale in (("mu_x", 0.5), ("decay_w0", 1.0),
                           ("bonus_u", 0.5)):
            assert 0.4 * scale < tm[key].abs().max() <= scale, key
        assert torch.equal(mine["ln_f"]["bias"],
                           torch.zeros_like(mine["ln_f"]["bias"]))


# ---------------------------------------------------------------------------
# time mix / channel mix
# ---------------------------------------------------------------------------

def _layer(params, i=0):
    return {k: v[i] if not isinstance(v, dict) else
            {kk: vv[i] for kk, vv in v.items()}
            for k, v in params["blocks"]["l0"].items()}


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 6])
def test_time_mix_matches_reference(setup, with_state, S):
    model = setup["model"]
    cfg, plan = model.cfg, model.plan
    jp = jax.tree.map(lambda a: a[1], setup["jparams"]["blocks"]["l0"])
    p = _layer(setup["params"], 1)
    x = _x(2, S, cfg.d_model, seed=S)
    H, dh = plan.attn.hp, cfg.rwkv.head_dim
    g = np.random.default_rng(7)
    shift = g.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    wkv = (0.1 * g.standard_normal((2, H, dh, dh))).astype(np.float32)
    jst = ({"shift": jnp.asarray(shift), "wkv": jnp.asarray(wkv)}
           if with_state else None)
    st = ({"shift": torch.from_numpy(shift), "wkv": torch.from_numpy(wkv)}
          if with_state else None)
    yr, str_ = jax_rwkv.time_mix_fwd(
        jp["tmix"], jnp.asarray(x), cfg=setup["jmodel"].cfg,
        plan=setup["jmodel"].plan, env=setup["env"], state=jst)
    y, st2 = rwkv_mod.time_mix_fwd(p["tmix"], torch.from_numpy(x), cfg=cfg,
                                   plan=plan, state=st)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **LAYER_TOL)
    if with_state:
        for key in ("shift", "wkv"):
            np.testing.assert_allclose(st2[key].numpy(),
                                       np.asarray(str_[key]), **LAYER_TOL)
    else:
        assert st2 is None and str_ is None


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 6])
def test_channel_mix_matches_reference(setup, with_state, S):
    model = setup["model"]
    jp = jax.tree.map(lambda a: a[0], setup["jparams"]["blocks"]["l0"])
    p = _layer(setup["params"], 0)
    x = _x(3, S, model.cfg.d_model, seed=10 + S)
    prev = _x(3, 1, model.cfg.d_model, seed=20)
    yr, sr = jax_rwkv.channel_mix_fwd(
        jp["cmix"], jnp.asarray(x), cfg=setup["jmodel"].cfg,
        plan=setup["jmodel"].plan, env=setup["env"],
        state=jnp.asarray(prev) if with_state else None)
    y, s = rwkv_mod.channel_mix_fwd(
        p["cmix"], torch.from_numpy(x), cfg=model.cfg, plan=model.plan,
        state=torch.from_numpy(prev) if with_state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **LAYER_TOL)
    if with_state:
        np.testing.assert_allclose(s.numpy(), np.asarray(sr), **LAYER_TOL)
    else:
        assert s is None and sr is None


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
            cache=jmodel.init_cache(1, n),
            positions=jnp.arange(n)[None])
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
                                   positions=torch.arange(n)[None])
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
    for key, t in cache["l0"].items():
        np.testing.assert_allclose(t.numpy(), np.asarray(ref_cache["l0"][key]),
                                   **LOGIT_TOL)
    # the plain-scan oracle switch computes the same function
    plain_rows, _ = _run_torch(setup, use_kernels=False)
    for got, want in zip(plain_rows, rows):
        np.testing.assert_array_equal(got, want)


def test_cache_layout_and_bytes_match_reference(setup):
    model, jmodel = setup["model"], setup["jmodel"]
    cache = model.init_cache(3, 64)
    ref = jmodel.init_cache(3, 64)
    assert set(cache) == set(ref) == {"l0"}
    for key, t in cache["l0"].items():
        r = ref["l0"][key]
        assert tuple(t.shape) == tuple(r.shape), key
        assert str(t.dtype).split(".")[-1] == str(r.dtype), key
    assert cache["l0"]["wkv"].dtype == torch.float32
    assert kv_cache.cache_bytes(cache) == jax_kv.cache_bytes(ref)
    half = model.init_cache(3, 64, dtype=torch.float16)
    assert half["l0"]["shift_t"].dtype == torch.float16
    assert half["l0"]["wkv"].dtype == torch.float32
    with pytest.raises(ValueError, match="paged KV"):
        model.init_cache(3, 64, paged=True, num_blocks=4, block_size=16)


def test_rwkv_refuses_paged_modes(setup):
    model, params = setup["model"], setup["params"]
    with pytest.raises(NotImplementedError, match="paged pool"):
        model.forward(params, torch.ones((1, 4), dtype=torch.long),
                      mode="chunk_prefill", cache=model.init_cache(1, 4))
    # the oracle switch is the rwkv recurrence's; attention layers refuse it
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    dense = build_model(cfg, plan, "cpu")
    with pytest.raises(ValueError, match="use_kernels"):
        dense.forward(dense.init(0), torch.ones((1, 4), dtype=torch.long),
                      mode="train", use_kernels=False)


# ---------------------------------------------------------------------------
# prefill scatter of the recurrent state
# ---------------------------------------------------------------------------

def test_scatter_prefill_dense_replaces_state(setup):
    """The slot's state leaves are replaced wholesale, as the reference's
    ``scatter_prefill_dense`` does; other slots are untouched."""
    model = setup["model"]
    g = np.random.default_rng(3)
    full = {k: g.standard_normal(tuple(t.shape)).astype(np.float32)
            for k, t in model.init_cache(3, 64)["l0"].items()}
    pre = {k: g.standard_normal(tuple(t.shape)).astype(np.float32)
           for k, t in model.init_cache(1, 7)["l0"].items()}
    want = jax_kv.scatter_prefill_dense(
        {"l0": {k: jnp.asarray(v) for k, v in full.items()}},
        {"l0": {k: jnp.asarray(v) for k, v in pre.items()}}, jnp.int32(1))
    cache = {"l0": {k: torch.from_numpy(v.copy()) for k, v in full.items()}}
    kv_cache.scatter_prefill_dense(
        cache, {"l0": {k: torch.from_numpy(v) for k, v in pre.items()}}, 1)
    for key in full:
        np.testing.assert_array_equal(cache["l0"][key].numpy(),
                                      np.asarray(want["l0"][key]))
        np.testing.assert_array_equal(cache["l0"][key][:, 1].numpy(),
                                      pre[key][:, 0])
        np.testing.assert_array_equal(cache["l0"][key][:, 0].numpy(),
                                      full[key][:, 0])


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
    "s4-no-pipeline": dict(steps_per_sync=4, pipeline=False),
    "host-sampling": dict(sampling="host"),
}


@pytest.mark.parametrize("name", list(ENGINES))
def test_engine_streams_match_reference(setup, ref_streams, name):
    eng = LPUEngine(setup["model"], setup["params"],
                    EngineConfig(slots=3, max_seq=64, **ENGINES[name]),
                    device="cpu")
    assert not eng.paged and not eng.bucketed
    before = scan_ops.rwkv_scan.launches
    got = eng.generate(PROMPTS, max_new_tokens=MAX_NEW)
    assert got == ref_streams
    assert scan_ops.rwkv_scan.launches == before   # CPU: the plain version
    # the first token of each stream comes from its prefill row
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


def test_engine_state_accounting_and_paged_refusal(setup):
    eng = LPUEngine(setup["model"], setup["params"],
                    EngineConfig(slots=3, max_seq=64), device="cpu")
    state = eng.kv_cache_bytes()
    cfg = setup["model"].cfg
    H, dh = setup["model"].plan.attn.hp, cfg.rwkv.head_dim
    assert state == cfg.n_layers * 3 * 4 * (2 * cfg.d_model + H * dh * dh)
    assert eng.kv_bytes_moved_per_step() == 2 * state
    assert eng.dense_equiv_bytes() == state
    with pytest.raises(ValueError, match="paged KV"):
        LPUEngine(setup["model"], setup["params"],
                  EngineConfig(slots=3, max_seq=64, paged=True),
                  device="cpu")


def test_serve_cli_rwkv(capsys):
    from repro_torch.launch import serve
    outs = serve.main(["--arch", "rwkv6-7b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4", "--max-seq",
                       "64"])
    assert len(outs) == 3 and all(len(o) == 4 for o in outs)
    out = capsys.readouterr().out
    assert "kv=dense" in out
    assert "rwkv_scan kernel launches=0" in out
