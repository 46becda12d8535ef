"""The port's encoder-decoder (whisper-tiny, reduced: 2 + 2 layers of
128, 16 frames) against the JAX reference, f32, every bias and the
learned positions redrawn non-zero (``tests/torch_dense_util.py``): the
non-causal encoder, the train-mode forward, a prefill (encoder once,
cross K/V into the cache) and decode steps reading the cross K/V
without rewriting them, within 1e-4; the port's prefill and serve steps
give the tokens of the reference's ``build_prefill_step`` /
``build_serve_step(model, None, ...)`` loop; the engine and the CLI
refuse the family, naming ``core/steps.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import make_axis_env
from repro.core.steps import build_prefill_step as jax_build_prefill_step
from repro.core.steps import build_serve_step as jax_build_serve_step
from repro.models import whisper as jax_wh
from repro_torch.core.steps import build_prefill_step, build_serve_step
from repro_torch.launch import serve
from repro_torch.models import whisper as wh
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from tests.torch_dense_util import one_torch_thread, reduced_pair  # noqa: F401

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
B, S, MAX = 2, 4, 32


@pytest.fixture(scope="module")
def pair():
    return reduced_pair("whisper-tiny")


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    frames = (0.1 * rng.standard_normal(
        (B, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)
    return toks, frames


def test_encoder_matches_reference(pair):
    (_, jplan, jmodel, jparams), (cfg, plan, _, params) = pair
    _, frames = _inputs(cfg)
    ref = jax_wh.run_encoder(jparams, jnp.asarray(frames), cfg=jmodel.cfg,
                             plan=jplan, env=make_axis_env(jplan, batch=B),
                             gather_fn=lambda path, t: t)
    got = wh.run_encoder(params, torch.from_numpy(frames), cfg=cfg,
                         plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **LOGIT_TOL)
    # non-causal: the first frame's state depends on the last frame
    late = frames.copy()
    late[:, -1] += 1.0
    moved = wh.run_encoder(params, torch.from_numpy(late), cfg=cfg,
                           plan=plan)
    assert not torch.allclose(moved[:, 0], got[:, 0])


def test_train_forward_matches_reference(pair):
    (_, jplan, jmodel, jparams), (cfg, _, model, params) = pair
    toks, frames = _inputs(cfg, seed=2)
    jl, _, _ = jmodel.forward(jparams, jnp.asarray(toks),
                              env=make_axis_env(jplan, batch=B),
                              mode="train", frames=jnp.asarray(frames))
    lg, _ = model.forward(params, torch.from_numpy(toks).long(),
                          mode="train", frames=torch.from_numpy(frames))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_prefill_and_decode_match_reference(pair):
    """Prefill (the encoder runs once, every layer's cross K/V stored),
    then 8 decode steps: logits within 1e-4 of the reference's, the
    stored cross K/V equal to the reference's and never rewritten by a
    decode step."""
    (_, jplan, jmodel, jparams), (cfg, _, model, params) = pair
    env = make_axis_env(jplan, batch=B)
    toks, frames = _inputs(cfg, seed=3)
    jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
    jl, jc, _ = jmodel.forward(jparams, jnp.asarray(toks), env=env,
                               mode="prefill", cache=jc,
                               frames=jnp.asarray(frames))
    c = model.init_cache(B, MAX, dtype=torch.float32)
    lg, c = model.forward(params, torch.from_numpy(toks).long(),
                          mode="prefill", cache=c,
                          frames=torch.from_numpy(frames))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)
    for key in ("k", "v", "ck", "cv"):
        np.testing.assert_allclose(c[key].numpy(), np.asarray(jc[key]),
                                   **LOGIT_TOL)
    cross = {k: c[k].clone() for k in ("ck", "cv")}
    rng = np.random.default_rng(4)
    for t in range(8):
        nt = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
        pos = np.full((B,), S + t, np.int32)
        jl, jc, _ = jmodel.forward(jparams, jnp.asarray(nt), env=env,
                                   mode="decode", positions=jnp.asarray(pos),
                                   cache=jc)
        lg, c = model.forward(params, torch.from_numpy(nt).long(),
                              mode="decode", positions=torch.from_numpy(pos),
                              cache=c)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **LOGIT_TOL)
    for k, v in cross.items():
        assert torch.equal(c[k], v), k
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]),
                               **LOGIT_TOL)


def test_serve_steps_give_the_reference_loops_tokens(pair):
    """Greedy tokens of the port's prefill step + 12 serve steps equal
    the reference's ``build_prefill_step`` / ``build_serve_step(model,
    None, ...)`` loop (jitted) on the same weights and frames."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = pair
    toks, frames = _inputs(cfg, seed=5)
    jpre, _ = jax_build_prefill_step(jmodel, None, B, MAX)
    jserve, _ = jax_build_serve_step(jmodel, None, B, MAX)
    jpre, jserve = jax.jit(jpre), jax.jit(jserve)
    jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
    jt, jc = jpre(jparams, jc, jnp.asarray(toks), frames=jnp.asarray(frames))
    pre, _ = build_prefill_step(model, None, B, MAX)
    step, _ = build_serve_step(model, None, B, MAX)
    c = model.init_cache(B, MAX, dtype=torch.float32)
    t, c = pre(params, c, torch.from_numpy(toks).long(),
               frames=torch.from_numpy(frames))
    ref, got = [np.asarray(jt)], [t.numpy()]
    for i in range(12):
        pos = np.full((B,), S + i, np.int32)
        jt, jc = jserve(jparams, jc, jt[:, None], jnp.asarray(pos))
        t, c = step(params, c, t[:, None].long(), torch.from_numpy(pos))
        ref.append(np.asarray(jt))
        got.append(t.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    assert len(set(np.stack(got).ravel().tolist())) >= 4


def test_engine_and_cli_refuse_encdec(pair):
    (_, _, _, _), (cfg, _, model, params) = pair
    with pytest.raises(ValueError, match="core/steps.py"):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64),
                  device="cpu")
    with pytest.raises(ValueError, match="core/steps.py"):
        serve.main(["--arch", "whisper-tiny", "--reduced", "--device",
                    "cpu"])


def test_paged_modes_are_refused(pair):
    (_, _, _, _), (cfg, _, model, params) = pair
    assert not model.supports_paged_kv()
    with pytest.raises(ValueError, match="paged"):
        model.init_cache(B, MAX, paged=True, num_blocks=4, block_size=16)
    with pytest.raises(ValueError, match="paged pool"):
        model.forward(params, torch.ones((1, 4), dtype=torch.long),
                      mode="chunk_prefill")
    with pytest.raises(ValueError, match="frames"):
        model.forward(params, torch.ones((1, 4), dtype=torch.long),
                      mode="prefill", cache=model.init_cache(1, MAX))
