"""The port's vlm (llava-next-34b, reduced: 8 patches of 64) against the
JAX reference, f32: the forward with ``patch_embeds`` (the projector,
the patches before the text, positions re-based over both) in train
mode, then a prefill and decode steps at positions that count the
patches, as ``tests/test_smoke_archs.py`` drives it, within 1e-4; the
port's prefill and serve steps (``repro_torch/core/steps.py``) give the
reference steps' tokens; the engine serves llava as a text decoder, as
the reference's engine does (every bias redrawn non-zero by
``tests/torch_dense_util.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import make_axis_env
from repro.core.steps import build_prefill_step as jax_build_prefill_step
from repro.core.steps import build_serve_step as jax_build_serve_step
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.core.steps import build_prefill_step, build_serve_step
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from tests.torch_dense_util import one_torch_thread, reduced_pair  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX = 2, 4, 32


@pytest.fixture(scope="module")
def pair():
    return reduced_pair("llava")


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    patches = (0.1 * rng.standard_normal(
        (B, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim))).astype(np.float32)
    return toks, patches


def test_train_forward_with_patches_matches_reference(pair):
    (_, jplan, jmodel, jparams), (cfg, _, model, params) = pair
    toks, patches = _inputs(cfg)
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(toks),
                              env=make_axis_env(jplan, batch=B),
                              mode="train", patch_embeds=jnp.asarray(patches))
    lg, _ = model.forward(params, torch.from_numpy(toks).long(), mode="train",
                          patch_embeds=torch.from_numpy(patches))
    assert lg.shape[1] == cfg.vlm.n_patches + S
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)
    # the patches change every row after them
    plain, _ = model.forward(params, torch.from_numpy(toks).long(),
                             mode="train")
    assert not torch.allclose(plain, lg[:, cfg.vlm.n_patches:], atol=1e-3)


def test_prefill_with_patches_then_decode_matches_reference(pair):
    """Prefill (B, S) text after n_patches patch rows into a dense cache,
    then 6 decode steps from position n_patches + S: logits within 1e-4,
    and the cache's patch rows filled."""
    (_, jplan, jmodel, jparams), (cfg, _, model, params) = pair
    env = make_axis_env(jplan, batch=B)
    toks, patches = _inputs(cfg)
    jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks), env=env,
                               mode="prefill", cache=jc,
                               patch_embeds=jnp.asarray(patches))
    c = model.init_cache(B, MAX, dtype=torch.float32)
    lg, c = model.forward(params, torch.from_numpy(toks).long(),
                          mode="prefill", cache=c,
                          patch_embeds=torch.from_numpy(patches))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)
    n = cfg.vlm.n_patches + S
    k = c["l0"]["k"]
    assert k[:, :, :n].abs().amax(-1).gt(0).all() and not k[:, :, n:].any()
    rng = np.random.default_rng(2)
    for t in range(6):
        nt = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full((B,), n + t, np.int32)
        jl, jc, _ = jmodel.forward(jparams, jnp.asarray(nt), env=env,
                                   mode="decode", positions=jnp.asarray(pos),
                                   cache=jc)
        lg, c = model.forward(params, torch.from_numpy(nt).long(),
                              mode="decode", positions=torch.from_numpy(pos),
                              cache=c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_steps_give_the_reference_steps_tokens(pair):
    """The port's prefill step with patch embeddings, then 8 serve steps
    at positions counting the patches, against the reference's
    ``build_prefill_step`` / ``build_serve_step`` (mesh None, jitted):
    the same greedy tokens."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = pair
    toks, patches = _inputs(cfg, seed=4)
    n = cfg.vlm.n_patches + S
    jpre, _ = jax_build_prefill_step(jmodel, None, B, MAX)
    jserve, _ = jax_build_serve_step(jmodel, None, B, MAX)
    jpre, jserve = jax.jit(jpre), jax.jit(jserve)
    jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
    jt, jc = jpre(jparams, jc, jnp.asarray(toks),
                  patch_embeds=jnp.asarray(patches))
    pre, _ = build_prefill_step(model, None, B, MAX)
    serve, _ = build_serve_step(model, None, B, MAX)
    c = model.init_cache(B, MAX, dtype=torch.float32)
    t, c = pre(params, c, torch.from_numpy(toks).long(),
               patch_embeds=torch.from_numpy(patches))
    ref, got = [np.asarray(jt)], [t.numpy()]
    for i in range(8):
        pos = np.full((B,), n + i, np.int32)
        jt, jc = jserve(jparams, jc, jt[:, None], jnp.asarray(pos))
        t, c = serve(params, c, t[:, None].long(), torch.from_numpy(pos))
        ref.append(np.asarray(jt))
        got.append(t.numpy())
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    assert len(set(np.stack(got).ravel().tolist())) >= 4


def test_steps_refuse_a_mesh(pair):
    """The steps take the rank's ring as their mesh (their ring form:
    tests/test_torch_tp_multimodal.py): any other mesh is refused, and so
    is a tp plan without one or a ring beside a tp=1 plan."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.models.registry import build_model
    model = pair[1][2]
    cfg = pair[1][0]
    tp2 = build_model(cfg, plan_model(cfg, ("model",), (2,), "serve"), "cpu")
    for build in (build_prefill_step, build_serve_step):
        with pytest.raises(TypeError, match="Ring"):
            build(model, object(), B, MAX)
        with pytest.raises(ValueError, match="ring"):
            build(tp2, None, B, MAX)


def test_engine_serves_text_as_the_reference_engine(pair):
    """The engine serves llava from the paged pool as a text decoder
    (the reference's engine passes no patch embeddings): streams equal
    to the reference engine's."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = pair
    r = np.random.default_rng(5)
    prompts = [[int(t) for t in r.integers(1, cfg.vocab_size, size=n)]
               for n in (3, 9, 17, 6)]
    kw = dict(slots=2, max_seq=64, block_size=16)
    eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
    got = eng.generate(prompts, max_new_tokens=10)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw)).generate(
        prompts, max_new_tokens=10)
    assert got == ref and eng.paged
    eng.check_pool_balanced()
    assert max(len(set(s)) for s in got) >= 4
