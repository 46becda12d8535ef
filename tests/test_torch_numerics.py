"""Norm, rope, activations, MLP and the flash-attention cores of the port
against the JAX reference in f32, on the same numpy inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models import attention, common, mlp

TOL = dict(rtol=1e-5, atol=1e-5)
SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(mine, ref, **tol):
    np.testing.assert_allclose(mine.detach().numpy(), np.asarray(ref),
                               **(tol or TOL))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    r = _rng(1)
    x = r.standard_normal((2, 5, 64)).astype(np.float32) * 3
    p = {"scale": r.standard_normal(64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = r.standard_normal(64).astype(np.float32)
    mine = common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), kind)
    ref = jax_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), kind)
    _close(mine, ref)


@pytest.mark.parametrize("kind", ["silu", "gelu", "relu", "relu2"])
def test_activate(kind):
    x = _rng(2).standard_normal((4, 33)).astype(np.float32) * 4
    _close(common.activate(torch.from_numpy(x), kind),
           jax_common.activate(jnp.asarray(x), kind))


@pytest.mark.parametrize("dh", [32, 64])
def test_rope_half_split(dh):
    r = _rng(3)
    x = r.standard_normal((2, 7, 3, dh)).astype(np.float32)
    pos = r.integers(0, 500, size=(2, 7)).astype(np.int32)
    _close(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0),
           jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0),
           rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(common.rope_freqs(dh, 1e4).numpy(),
                               np.asarray(jax_common.rope_freqs(dh, 1e4)),
                               rtol=1e-6)


def test_big_neg():
    assert common.big_neg() == float(jax_common.big_neg(jnp.float32))


@pytest.mark.parametrize("reduced", [True, False])
def test_mlp_fwd(reduced):
    cfg = get_config("smollm-135m")
    jcfg = jax_get_config("smollm-135m")
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    r = _rng(4)
    D, ff = cfg.d_model, plan.d_ff_padded
    p = {"wg": r.standard_normal((D, ff)) / np.sqrt(D),
         "wu": r.standard_normal((D, ff)) / np.sqrt(D),
         "wd": r.standard_normal((ff, D)) / np.sqrt(ff)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 3, D)).astype(np.float32)
    mine = mlp.mlp_fwd({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x), cfg=cfg, plan=plan)
    ref = jax_mlp.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), cfg=jcfg, plan=jplan,
                          env=make_axis_env(jplan))
    _close(mine, ref)


@pytest.mark.parametrize("causal,chunk", [(True, 512), (True, 4),
                                          (False, 8)])
def test_flash_attention(causal, chunk):
    r = _rng(5)
    q = r.standard_normal((2, 6, 3, 32)).astype(np.float32)
    k = r.standard_normal((2, 10, 3, 32)).astype(np.float32)
    v = r.standard_normal((2, 10, 3, 32)).astype(np.float32)
    off = np.array([4, 2], np.int32)
    vl = np.array([10, 7], np.int32)
    mine = attention.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_offset=torch.from_numpy(off), kv_valid_len=torch.from_numpy(vl),
        chunk=chunk)
    ref = jax_attn.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_offset=jnp.asarray(off), kv_valid_len=jnp.asarray(vl), chunk=chunk)
    _close(mine, ref)


@pytest.mark.parametrize("fold", [False, True])
def test_flash_decode_chunked(fold):
    """Dense decode core, GQA through the kmap, with the new token."""
    r = _rng(6)
    B, S, qpr, kpr, dh = 3, 24, 6, 2, 32
    q = r.standard_normal((B, 1, qpr, dh)).astype(np.float32)
    k = r.standard_normal((B, S, kpr, dh)).astype(np.float32)
    v = r.standard_normal((B, S, kpr, dh)).astype(np.float32)
    kn = r.standard_normal((B, 1, kpr, dh)).astype(np.float32)
    vn = r.standard_normal((B, 1, kpr, dh)).astype(np.float32)
    vl = np.array([5, 24, 13], np.int32)
    kmap = np.repeat(np.arange(kpr), qpr // kpr)
    extra = (dict(k_new=torch.from_numpy(kn), v_new=torch.from_numpy(vn))
             if fold else {})
    jextra = (dict(k_new=jnp.asarray(kn), v_new=jnp.asarray(vn))
              if fold else {})
    mine = attention._flash_decode_chunked(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(kmap),
        kv_valid_len=torch.from_numpy(vl), chunk=8, **extra)
    ref = jax_attn._flash_decode_chunked(
        *(jnp.asarray(a) for a in (q, k, v)), jnp.asarray(kmap),
        kv_valid_len=jnp.asarray(vl), chunk=8, **jextra)
    _close(mine, ref)
