"""The port's C1 streamlined chain (``repro_torch/core/streamline.py``)
against the JAX reference's (``repro/core/streamline.py``, kernels in
interpret mode) on the reduced smollm-135m, with the reference's weights
carried across by ``params_from_jax``: ``decode_layer`` on every cache
kind and weight dtype, ``chunk_prefill_layer``, ``verify_layer``,
``stream_bytes_per_layer``; then the stacked chain against the port's
own model, and the chunk/verify-vs-sequential properties on the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core import streamline as jax_sl
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core import streamline as sl
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import layer_params, lm_logits
from repro_torch.models.common import apply_norm
from repro_torch.serving import kv_cache
from repro_torch.weights import params_from_jax

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
# f32 end to end: the two packages differ only in summation order
TOL = dict(rtol=1e-4, atol=1e-4)
B, BS, T = 2, 8, 4
POS = np.array([5, 11], np.int32)
QDTYPES = {"int8": (torch.int8, jnp.int8),
           "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["l0"])
    p = layer_params(params, 0)["l0"]
    return dict(jcfg=jcfg, jplan=jplan, jp=jp, cfg=cfg, plan=plan, p=p,
                params=params)


def _rng_arrays(plan, seed=0):
    a = plan.attn
    r = np.random.default_rng(seed)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(x=f(B, 128), dense_k=f(B, 32, a.gp, a.d_head),
                dense_v=f(B, 32, a.gp, a.d_head),
                pool_k=f(2 * T + 1, BS, a.gp, a.d_head),
                pool_v=f(2 * T + 1, BS, a.gp, a.d_head))


def _caches(arr, kind):
    """(port cache, reference cache, port table, reference table)."""
    if kind == "dense":
        c = {"k": arr["dense_k"], "v": arr["dense_v"]}
        return ({k: torch.from_numpy(v.copy()) for k, v in c.items()},
                {k: jnp.asarray(v) for k, v in c.items()}, None, None)
    tables = np.arange(1, 2 * T + 1, dtype=np.int32).reshape(B, T)
    if kind in QDTYPES:
        t_dt, j_dt = QDTYPES[kind]
        port, ref = {}, {}
        for key in ("k", "v"):
            q, s = kv_cache.quantize_kv_rows(
                torch.from_numpy(arr["pool_" + key]), t_dt, torch.float16)
            port[key], port[key + "_scale"] = q, s
            jq, js = jax_kv.quantize_kv_rows(
                jnp.asarray(arr["pool_" + key]), j_dt, jnp.float16)
            ref[key], ref[key + "_scale"] = jq, js
    else:
        port = {k: torch.from_numpy(arr["pool_" + k].copy()) for k in "kv"}
        ref = {k: jnp.asarray(arr["pool_" + k]) for k in "kv"}
    return port, ref, torch.from_numpy(tables), jnp.asarray(tables)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t.astype(jnp.float32))


# (cache kind, paged dataflow, w_dtype)
CASES = [("dense", "auto", "auto"), ("pool", "stream", "auto"),
         ("pool", "gather", "auto"), ("int8", "stream", "auto"),
         ("fp8", "stream", "auto"), ("pool", "stream", "int8")]


@pytest.mark.parametrize("kind,mode,w_dtype", CASES)
def test_decode_layer_matches_reference(setup, kind, mode, w_dtype):
    s = setup
    arr = _rng_arrays(s["plan"])
    cache, jcache, tb, jtb = _caches(arr, kind)
    y, out = sl.decode_layer(
        s["p"], torch.from_numpy(arr["x"]), cache, torch.from_numpy(POS),
        cfg=s["cfg"], plan=s["plan"], block_table=tb, paged_kernel=mode,
        w_dtype=w_dtype)
    jy, jout = jax.jit(lambda p_, x_, c_, pos_, tb_: jax_sl.decode_layer(
        p_, x_, c_, pos_, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True, block_table=tb_, paged_kernel=mode,
        w_dtype=w_dtype))(s["jp"], jnp.asarray(arr["x"]), jcache,
                          jnp.asarray(POS), jtb)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert out is cache and set(out) == set(jout)      # updated in place
    for key in out:
        if kind in QDTYPES and key in ("k", "v"):
            # the new rows' quantized values may round one step apart:
            # compare what attention reads, the dequantized rows
            got = kv_cache.dequantize_kv(out[key], out[key + "_scale"])
            want = jax_kv.dequantize_kv(jout[key], jout[key + "_scale"])
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-2, atol=1e-2)
        else:
            np.testing.assert_allclose(_np(out[key]), _np(jout[key]),
                                       rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("mode", ["stream", "gather"])
def test_chunk_prefill_layer_matches_reference(setup, mode):
    s = setup
    arr = _rng_arrays(s["plan"], seed=1)
    table = np.arange(1, T + 1, dtype=np.int32)
    C, start, n_valid = 4, 3, 3
    xs = arr["pool_k"].reshape(-1)[:C * 128].reshape(C, 128)
    pool = {k: torch.from_numpy(arr["pool_" + k].copy()) for k in "kv"}
    jpool = {k: jnp.asarray(arr["pool_" + k]) for k in "kv"}
    y, out = sl.chunk_prefill_layer(
        s["p"], torch.from_numpy(xs), pool, torch.from_numpy(table), start,
        n_valid, cfg=s["cfg"], plan=s["plan"], paged_kernel=mode)
    jy, jout = jax.jit(lambda *a: jax_sl.chunk_prefill_layer(
        *a, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True, paged_kernel=mode))(
        s["jp"], jnp.asarray(xs), jpool, jnp.asarray(table),
        jnp.int32(start), jnp.int32(n_valid))
    np.testing.assert_allclose(y.numpy()[:n_valid],
                               np.asarray(jy)[:n_valid], **TOL)
    for key in "kv":
        # block 0 takes the padded rows, in an order neither side fixes
        np.testing.assert_allclose(out[key][1:].numpy(),
                                   np.asarray(jout[key])[1:],
                                   rtol=1e-4, atol=1e-5)


def test_verify_layer_matches_reference(setup):
    s = setup
    arr = _rng_arrays(s["plan"], seed=2)
    cache, jcache, _, _ = _caches(arr, "pool")
    table = np.arange(1, T + 1, dtype=np.int32)
    Q = 3
    tabs = np.broadcast_to(table, (Q, T)).copy()
    posn = np.arange(6, 6 + Q, dtype=np.int32)
    xs = arr["x"][np.arange(Q) % B] * np.arange(1, Q + 1)[:, None]
    y, out = sl.verify_layer(s["p"], torch.from_numpy(xs), cache,
                             torch.from_numpy(tabs), torch.from_numpy(posn),
                             cfg=s["cfg"], plan=s["plan"])
    jy, jout = jax.jit(lambda *a: jax_sl.verify_layer(
        *a, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True))(s["jp"], jnp.asarray(xs), jcache,
                         jnp.asarray(tabs), jnp.asarray(posn))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    for key in "kv":
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("kv_len", [0, 511, 4096])
def test_stream_bytes_per_layer_equal(reduced, kv_len):
    jcfg = jax_get_config("smollm-135m")
    cfg = get_config("smollm-135m")
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    assert sl.stream_bytes_per_layer(cfg, plan, kv_len) == \
        jax_sl.stream_bytes_per_layer(jcfg, jplan, kv_len)


def test_w_dtype_is_checked(setup):
    s = setup
    arr = _rng_arrays(s["plan"])
    cache, _, _, _ = _caches(arr, "dense")
    with pytest.raises(ValueError):
        sl.decode_layer(s["p"], torch.from_numpy(arr["x"]), cache,
                        torch.from_numpy(POS), cfg=s["cfg"], plan=s["plan"],
                        w_dtype="fp4")


# ---------------------------------------------------------------------------
# the port on its own: the stacked chain against the model, and the
# chunk / verify windows against sequential decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["stream", "dense"])
def test_stacked_chain_equals_model_decode(setup, kind):
    """30 layers in the full model, 2 here: decode_layer stacked, then
    ln_f and the logits, equal model.forward(mode="decode") at 1e-4 over
    4 teacher-forced steps after a prefill."""
    s = setup
    cfg, plan, params = s["cfg"], s["plan"], s["params"]
    model = build_model(cfg, plan, "cpu")
    r = np.random.default_rng(4)
    lens = (5, 11)
    bucket, max_seq = 16, 32
    paged = kind == "stream"
    tables = np.arange(1, 1 + B * (max_seq // BS), dtype=np.int32).reshape(
        B, max_seq // BS)
    cache = model.init_cache(B, max_seq, paged=paged,
                             num_blocks=1 + B * (max_seq // BS),
                             block_size=BS)
    for b, n in enumerate(lens):
        buf = np.zeros((1, bucket), np.int64)
        buf[0, :n] = r.integers(1, 512, size=n)
        _, pc = model.forward(params, torch.from_numpy(buf), mode="prefill",
                              cache=model.init_cache(1, bucket),
                              positions=torch.arange(bucket)[None])
        if paged:
            kv_cache.scatter_prefill_pages(
                cache, pc, torch.from_numpy(tables[b, :bucket // BS]))
        else:
            kv_cache.scatter_prefill_dense(cache, pc, b)
    chain = {k: v.clone() for k, v in cache["l0"].items()}
    tb = torch.from_numpy(tables) if paged else None
    pos = torch.tensor(lens, dtype=torch.int32)
    for step in range(4):
        tok = torch.from_numpy(r.integers(1, 512, size=(B, 1)))
        want, _ = model.forward(params, tok, mode="decode", positions=pos,
                                cache=cache, block_tables=tb)
        x = params["embed"][tok[:, 0]]
        for i in range(cfg.n_layers):
            lc = {k: v[i] for k, v in chain.items()}
            x, _ = sl.decode_layer(layer_params(params, i)["l0"], x, lc, pos,
                                   cfg=cfg, plan=plan, block_table=tb,
                                   paged_kernel="stream")
        got = lm_logits(params, apply_norm(params["ln_f"], x, cfg.norm),
                        cfg, plan)
        np.testing.assert_allclose(got.numpy(), want[:, -1].numpy(),
                                   err_msg=f"step {step}", **TOL)
        pos = pos + 1
    for k in chain:
        np.testing.assert_allclose(chain[k].numpy(),
                                   cache["l0"][k].numpy(), rtol=1e-5,
                                   atol=1e-5)


# The reference's versions of these two properties assert bit equality
# of the pools and fail by ~7e-7 (ROADMAP.md queue 3): on the CPU a
# (C, D) matmul and C (1, D) matmuls block their sums differently.  The
# port holds them at 1e-5 here; on the card its gemv is row-independent
# and chip_smoke.py reports the chunk's largest difference.
SEQ_TOL = dict(rtol=1e-5, atol=1e-5)


def _sequential(s, xs, pool, table, n):
    ys = []
    for i in range(n):
        y, pool = sl.decode_layer(s["p"], xs[i:i + 1], pool,
                                  torch.tensor([i], dtype=torch.int32),
                                  cfg=s["cfg"], plan=s["plan"],
                                  block_table=table[None])
        ys.append(y[0])
    return torch.stack(ys), pool


def _empty_pool(plan):
    a = plan.attn
    return {k: torch.zeros((T + 1, BS, a.gp, a.d_head)) for k in "kv"}


def test_chunk_layer_matches_sequential_decode(setup):
    """One chunk_prefill_layer call over S tokens (2 chunks, the second
    padded, a chunk boundary that is not a block boundary) equals feeding
    them one at a time through decode_layer."""
    s = setup
    table = torch.arange(1, T + 1, dtype=torch.int32)
    S, C = 13, 8
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S, 128)).astype(np.float32))
    ys, seq_pool = _sequential(s, xs, _empty_pool(s["plan"]), table, S)
    pool = _empty_pool(s["plan"])
    y1, pool = sl.chunk_prefill_layer(s["p"], xs[:C], pool, table, 0, C,
                                      cfg=s["cfg"], plan=s["plan"])
    chunk2 = torch.cat([xs[C:], torch.zeros((2 * C - S, 128))])
    y2, pool = sl.chunk_prefill_layer(s["p"], chunk2, pool, table, C, S - C,
                                      cfg=s["cfg"], plan=s["plan"])
    torch.testing.assert_close(torch.cat([y1, y2[:S - C]]), ys, **SEQ_TOL)
    for key in "kv":
        torch.testing.assert_close(pool[key][1:], seq_pool[key][1:],
                                   **SEQ_TOL)


def test_verify_layer_matches_sequential_decode(setup):
    """One verify_layer call over a slot's K+1 queries (crossing a block
    boundary) equals feeding them one at a time through decode_layer."""
    s = setup
    table = torch.arange(1, T + 1, dtype=torch.int32)
    S0, K1 = 6, 4
    xs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (S0 + K1, 128)).astype(np.float32))
    ys, seq_pool = _sequential(s, xs, _empty_pool(s["plan"]), table,
                               S0 + K1)
    _, pool = _sequential(s, xs, _empty_pool(s["plan"]), table, S0)
    y_v, pool = sl.verify_layer(
        s["p"], xs[S0:], pool, table[None].expand(K1, T).contiguous(),
        torch.arange(S0, S0 + K1, dtype=torch.int32), cfg=s["cfg"],
        plan=s["plan"])
    torch.testing.assert_close(y_v, ys[S0:], **SEQ_TOL)
    for key in "kv":
        torch.testing.assert_close(pool[key][1:], seq_pool[key][1:],
                                   **SEQ_TOL)
