"""The port's MoE stacks against the JAX reference at reduced size, f32:
granite-moe-3b (MoE in every layer, top-8 of 40 reduced to top-2 of 8)
and llama4-maverick (a dense layer and an MoE layer per super-block,
top-1, and a shared expert).  ``moe_fwd`` with and without the shared
expert, with capacity overflow and with tied router scores, within
1e-5; logits of a prefill plus 8 decode steps within 1e-4; the port
engine's greedy streams equal to the reference engine's, monolithic and
in chunks of 8 (every bias redrawn non-zero by
``tests/torch_dense_util.py``)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import make_axis_env
from repro.models import moe as jax_moe
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import layer_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from tests.torch_dense_util import one_torch_thread, reduced_pair  # noqa: F401

NAMES = ["granite", "llama4"]
# the super-block index of each model's MoE layer
MOE_LAYER = {"granite": "l0", "llama4": "l1"}
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
MAX_NEW = 12


@pytest.fixture(scope="module")
def pairs():
    return {name: reduced_pair(name) for name in NAMES}


def _moe_params(pair, shared=True):
    (_, jplan, jmodel, jparams), (cfg, plan, model, params) = pair
    lj = MOE_LAYER[cfg.name.split("-")[0]]
    jp = {k: v[0] for k, v in jparams["blocks"][lj]["moe"].items()
          if k != "shared"}
    p = dict(layer_params(params, 0)[lj]["moe"])
    if shared and "shared" in jparams["blocks"][lj]["moe"]:
        jp["shared"] = {k: v[0] for k, v in
                        jparams["blocks"][lj]["moe"]["shared"].items()}
    elif not shared:
        p.pop("shared", None)
    return jp, p


def _moe_case(pair, x, capacity=None, shared=True, router=None):
    (_, jplan, jmodel, _), (cfg, plan, _, _) = pair
    if capacity is not None:
        plan = dataclasses.replace(plan, moe=dataclasses.replace(
            plan.moe, capacity_factor=capacity))
        jplan = dataclasses.replace(jplan, moe=dataclasses.replace(
            jplan.moe, capacity_factor=capacity))
    jp, p = _moe_params(pair, shared)
    if router is not None:
        jp["router"] = jnp.asarray(router)
        p["router"] = torch.from_numpy(router)
    yr, auxr = jax_moe.moe_fwd(jp, jnp.asarray(x), cfg=jmodel.cfg,
                               plan=jplan, env=make_axis_env(jplan))
    y, aux = moe_mod.moe_fwd(p, torch.from_numpy(x), cfg=cfg, plan=plan)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), **MOE_TOL)
    np.testing.assert_allclose(aux.item(), float(auxr), **MOE_TOL)
    return y, p, plan


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


@pytest.mark.parametrize("T", [(2, 5), (4, 1), (1, 24)])
@pytest.mark.parametrize("name", NAMES)
def test_moe_fwd_matches_reference(pairs, name, T):
    """llama4's MoE layer with its shared expert, and without it (the
    routed experts alone), granite's (no shared expert)."""
    pair = pairs[name]
    x = _x(*T, pair[1][0].d_model, seed=sum(T))
    y, p, _ = _moe_case(pair, x)
    if name == "llama4":
        assert "shared" in p
        routed, _, _ = _moe_case(pair, x, shared=False)
        # the shared expert adds a non-zero term
        assert not torch.allclose(routed, y)


@pytest.mark.parametrize("name", NAMES)
def test_moe_capacity_overflow_matches_reference(pairs, name):
    """Capacity 1.0 and every token pulled towards expert 0's router
    column: more tokens pick it than its capacity holds, so the top-C
    selection drops some (which ones: the lowest index first among
    equal scores, as ``lax.top_k``)."""
    pair = pairs[name]
    cfg = pair[1][0]
    jp, _ = _moe_params(pair)
    col = np.asarray(jp["router"])[:, 0]
    # a pull of 10 sends every token to expert 0 and keeps the outputs
    # O(1), where f32 sums agree to 1e-5
    x = _x(1, 40, cfg.d_model, seed=11) + 10.0 * col / np.linalg.norm(col)
    y, p, plan = _moe_case(pair, x, capacity=1.0)
    ids, _, _ = moe_mod._route(p, torch.from_numpy(x[0]), cfg, plan)
    k = cfg.moe.top_k
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.moe.n_experts)
    assert counts.max().item() > moe_mod._capacity(40, k, cfg.moe.n_experts,
                                                   1.0)
    full, _ = moe_mod.moe_fwd(p, torch.from_numpy(x), cfg=cfg,
                              plan=pair[1][1])
    assert not torch.allclose(full, y)


@pytest.mark.parametrize("name", NAMES)
def test_moe_tied_router_scores_match_reference(pairs, name):
    """Router columns 2 and 5 made equal to column 0 (and 3 to 1): every
    token's probabilities tie across those experts, so top-k picks among
    them by index alone, lowest first, in both packages."""
    pair = pairs[name]
    cfg = pair[1][0]
    jp, _ = _moe_params(pair)
    router = np.array(jp["router"])
    router[:, 2] = router[:, 5] = router[:, 0]
    router[:, 3] = router[:, 1]
    x = _x(2, 6, cfg.d_model, seed=5)
    _, p, plan = _moe_case(pair, x, router=router)
    ids, _, _ = moe_mod._route(p, torch.from_numpy(x.reshape(12, -1)), cfg,
                               plan)
    jids, _, _ = jax_moe._route(
        {"router": jnp.asarray(router)}, jnp.asarray(x.reshape(12, -1)),
        pair[0][2].cfg, pair[0][1])
    assert ids.tolist() == np.asarray(jids).tolist()


@pytest.mark.parametrize("name", NAMES)
def test_logits_prefill_and_decode_match_reference(pairs, name):
    """A batch of 2 prefilled over 5 tokens into a dense cache, then 8
    decode steps: logits within 1e-4 of the reference's forward."""
    (_, jplan, jmodel, jparams), (cfg, _, model, params) = pairs[name]
    env = make_axis_env(jplan, batch=2)
    jpre = jax.jit(functools.partial(jmodel.forward, env=env,
                                     mode="prefill"))
    jdec = jax.jit(functools.partial(jmodel.forward, env=env,
                                     mode="decode"))
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 5)).astype(np.int32)
    jc = jmodel.init_cache(2, 32, dtype=jnp.float32)
    jl, jc, _ = jpre(jparams, jnp.asarray(toks), cache=jc)
    c = model.init_cache(2, 32, dtype=torch.float32)
    lg, c = model.forward(params, torch.from_numpy(toks).long(),
                          mode="prefill", cache=c)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(8):
        nt = rng.integers(1, cfg.vocab_size, size=(2, 1)).astype(np.int32)
        pos = np.full((2,), 5 + t, np.int32)
        jl, jc, _ = jdec(jparams, jnp.asarray(nt), positions=jnp.asarray(pos),
                         cache=jc)
        lg, c = model.forward(params, torch.from_numpy(nt).long(),
                              mode="decode", positions=torch.from_numpy(pos),
                              cache=c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)


def _prompts():
    r = np.random.default_rng(1)
    return [[int(t) for t in r.integers(1, 512, size=n)]
            for n in (3, 9, 17, 6, 25, 2)]


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("name", NAMES)
def test_engine_streams_match_reference_engine(pairs, name, chunk):
    """The port's engine on the paged pool (kernel 1's plain version on
    the CPU), monolithic prefill or chunks of 8, against the reference's
    engine on the same weights: greedy streams equal, the pool
    balanced, kernel 1's callers exact."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = pairs[name]
    kw = dict(slots=3, max_seq=64, block_size=16, prefill_chunk=chunk)
    prompts = _prompts()
    eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
    got = eng.generate(prompts, max_new_tokens=MAX_NEW)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw)).generate(
        prompts, max_new_tokens=MAX_NEW)
    assert got == ref
    eng.check_pool_balanced()
    assert eng.paged and eng.paged_kernel == "stream"
    assert (eng.stats.prefill_chunks > 0) == bool(chunk)
    # equality means something only if the streams are not one token
    # repeated
    assert len(set().union(*got)) >= 4
    assert max(len(set(s)) for s in got) >= 4


def test_kv_bytes_count_every_layer_of_an_moe_stack(pairs):
    """An MoE stack is attention-only: the analytic KV bytes per step
    count all its layers' k/v, as for a dense stack."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = pairs["llama4"]
    kw = dict(slots=3, max_seq=64, block_size=16)
    eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw))
    a = model.plan.attn
    want = 2 * cfg.n_layers * 3 * 64 * a.gp * a.d_head * 4
    assert eng.kv_bytes_moved_per_step() == want == \
        ref.kv_bytes_moved_per_step()
