"""The port's int8/fp8 KV pool against the JAX reference on the reduced
smollm-135m (f32, weights carried across by ``params_from_jax``):
absmax quantization bit for bit, the pool's scale leaves and honest
bytes, the quantizing scatters, the decode / chunk / verify layers on a
quantized pool against the reference's layers (its Pallas kernel in
interpret mode for ``stream``) with the same pool given to both, and the
engine's greedy streams against the reference's int8/fp8 engine, plus
prefix sharing, preemption and the drift bound against the f32 pool."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models import attention as jax_attn
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import one_torch_thread  # noqa: F401

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py's f32 bound
GAP = 1e-4                            # streams may part only at a near tie
QDTYPES = {"int8": (torch.int8, jnp.int8),
           "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}
# tests/test_quantized_kv.py's trace
PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11]]
KW = dict(slots=2, max_seq=64, paged=True, block_size=16)


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


@pytest.fixture(scope="module")
def setup(jax_setup):
    _, jparams = jax_setup
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return model, params


def _engine(setup, **kw):
    model, params = setup
    return LPUEngine(model, params, EngineConfig(**{**KW, **kw}),
                     device="cpu")


def _to_torch(a) -> torch.Tensor:
    """A numpy / jax array as a torch tensor (fp8 through its bytes)."""
    a = np.asarray(a)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.uint8).numpy() if t.dtype == torch.float8_e4m3fn \
        else t.numpy()


# ---------------------------------------------------------------------------
# quantization math: bit for bit against the reference
# ---------------------------------------------------------------------------

def _rows(case):
    r = np.random.default_rng(11)
    rows = r.standard_normal((6, 8, 3, 32)).astype(np.float32)
    if case == "zero_rows":
        rows[1] = 0.0
        rows[4, 2, 1] = 0.0
    elif case == "outliers":
        rows[0, 3, 1, 7] = 1e4
        rows[2, 0, 0, :] *= 1e-6
        rows[5, 5, 2, 0] = -3e3
    return rows


@pytest.mark.parametrize("case", ["normal", "zero_rows", "outliers"])
@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_quantize_kv_rows_bit_equal_reference(case, qname):
    """Same seeded rows through both packages: the stored codes and the
    f16 scales are bit-equal; all-zero rows get scale 0 and dequantize
    to exact zeros, outliers stay finite."""
    t_dt, j_dt = QDTYPES[qname]
    rows = _rows(case)
    q, sc = kv_cache.quantize_kv_rows(torch.from_numpy(rows), t_dt,
                                      torch.float16)
    jq, jsc = jax_kv.quantize_kv_rows(jnp.asarray(rows), j_dt, jnp.float16)
    np.testing.assert_array_equal(_bits(q), np.asarray(jq).view(np.uint8)
                                  if qname == "fp8" else np.asarray(jq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
    deq = kv_cache.dequantize_kv(q, sc)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jax_kv.dequantize_kv(jq, jsc)))
    assert torch.isfinite(deq).all()
    zero = (rows == 0).all(-1)
    assert (sc.numpy()[zero] == 0).all() and (deq.numpy()[zero] == 0).all()


# ---------------------------------------------------------------------------
# the pool: scale leaves, honest bytes, bytes moved
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_pool_scale_leaves_and_honest_bytes(jax_setup, setup, qname):
    """Every layer's pool holds int8/fp8 values and zeroed f16 scales
    shaped like the values without dh; the reported bytes are the
    leaves' and equal per-rank block bytes x blocks, as in the
    reference engine."""
    jmodel, jparams = jax_setup
    eng = _engine(setup, kv_dtype=qname)
    c = eng.cache["l0"]
    assert set(c) == {"k", "v", "k_scale", "v_scale"}
    assert c["k"].dtype == QDTYPES[qname][0]
    assert c["k_scale"].dtype == torch.float16
    assert c["k_scale"].shape == c["k"].shape[:-1]
    assert (c["k_scale"] == 0).all() and (c["v_scale"] == 0).all()
    a = eng.plan.attn
    per_block = kv_cache.per_rank_block_bytes(
        eng.cfg.n_layers, a.kv_per_rank, a.d_head, eng.block_size,
        eng.kv_prec.itemsize, eng.kv_prec.scale_itemsize)
    assert eng.kv_cache_bytes() == kv_cache.cache_bytes(eng.cache) \
        == per_block * eng.num_blocks
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**KW, kv_dtype=qname))
    assert eng.kv_cache_bytes() == ref.kv_cache_bytes()
    assert eng.kv_bytes_moved_per_step() == ref.kv_bytes_moved_per_step()


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_moved_bytes_price_the_real_leaves(setup, qname):
    """``kv_bytes_moved_per_step`` prices a row and kv head at
    ``bytes_per_row_head``; that is what the pool's leaves hold (dh
    codes and one scale), and against an f16 pool the ratio is
    (dh + 2) / (2 dh)."""
    eng = _engine(setup, kv_dtype=qname)
    c = eng.cache["l0"]
    dh = eng.plan.attn.d_head
    assert eng.kv_prec.bytes_per_row_head(dh) == \
        c["k"].element_size() * dh + c["k_scale"].element_size()
    f16 = _engine(setup, kv_dtype="float16")
    assert "k_scale" not in f16.cache["l0"]
    assert eng.kv_bytes_moved_per_step() * 2 * dh == \
        f16.kv_bytes_moved_per_step() * (dh + 2)


# ---------------------------------------------------------------------------
# scatters: quantized at pool-write time
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_scatter_prefill_pages_quantizes_like_reference(qname):
    """A bucket cache scattered into a quantized pool: codes and scales
    bit-equal to the reference's scatter, pad entries on the null block
    (left out: which pad row wins there is unordered)."""
    t_dt, j_dt = QDTYPES[qname]
    r = np.random.default_rng(3)
    n_sb, N, bs, G, dh, S = 2, 6, 4, 2, 8, 16
    dn = {k: r.standard_normal((n_sb, 1, S, G, dh)).astype(np.float32)
          for k in "kv"}
    table = np.array([3, 1, 0, 0], np.int32)

    def pool(mk, dt, sdt, zeros):
        return {"l0": {"k": zeros((n_sb, N, bs, G, dh), dt),
                       "v": zeros((n_sb, N, bs, G, dh), dt),
                       "k_scale": zeros((n_sb, N, bs, G), sdt),
                       "v_scale": zeros((n_sb, N, bs, G), sdt)}}
    mine = pool(None, t_dt, torch.float16,
                lambda s, d: torch.zeros(s, dtype=d))
    kv_cache.scatter_prefill_pages(
        mine, {"l0": {k: torch.from_numpy(v) for k, v in dn.items()}},
        torch.from_numpy(table))
    ref = jax_kv.scatter_prefill_pages(
        pool(None, j_dt, jnp.float16, jnp.zeros),
        {"l0": {k: jnp.asarray(v) for k, v in dn.items()}},
        jnp.asarray(table))
    for leaf in ("k", "v", "k_scale", "v_scale"):
        got = _to_torch(ref["l0"][leaf])
        np.testing.assert_array_equal(_bits(mine["l0"][leaf][:, 1:]),
                                      _bits(got[:, 1:]))
    assert (mine["l0"]["k_scale"][:, 2] == 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "scales"])
def test_scatter_spec_rows_matches_reference(quant):
    """Per-query tables: each row lands at (its table[pos // bs], pos %
    bs); invalid rows go to the null block.  Values and scale pages
    alike, against the reference."""
    r = np.random.default_rng(5)
    N, bs, G, dh, T = 7, 4, 2, 8, 3
    shape = (N, bs, G) if quant else (N, bs, G, dh)
    pages = r.standard_normal(shape).astype(np.float32)
    tables = np.array([[2, 5, 0], [2, 5, 0], [6, 1, 3], [6, 1, 3],
                       [0, 0, 0]], np.int32)
    positions = np.array([3, 4, 9, 10, 0], np.int32)
    valid = np.array([True, True, True, False, True])
    rows = r.standard_normal((5,) + shape[2:]).astype(np.float32)
    got = kv_cache.scatter_spec_rows(
        torch.from_numpy(pages.copy()), torch.from_numpy(rows),
        torch.from_numpy(tables), torch.from_numpy(positions),
        torch.from_numpy(valid)).numpy()
    want = np.asarray(jax_kv.scatter_spec_rows(
        jnp.asarray(pages), jnp.asarray(rows), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2, 3], rows[0])   # pos 3: block 2
    np.testing.assert_array_equal(got[5, 0], rows[1])   # pos 4: block 5
    np.testing.assert_array_equal(got[3, 1], rows[2])   # pos 9: block 3


# ---------------------------------------------------------------------------
# the layers on a quantized pool, against the reference's layers
# ---------------------------------------------------------------------------

def _quant_pool(qname, N, bs, G, dh, seed):
    """A seeded f32 pool quantized by the reference: (port pool, the
    same values for the reference).  Block 0 keeps zero scales."""
    _, j_dt = QDTYPES[qname]
    r = np.random.default_rng(seed)
    jpool = {}
    for key in ("k", "v"):
        f = r.standard_normal((N, bs, G, dh)).astype(np.float32)
        f[0] = 0.0
        q, s = jax_kv.quantize_kv_rows(jnp.asarray(f), j_dt, jnp.float16)
        jpool[key], jpool[key + "_scale"] = q, s
    return {k: _to_torch(v) for k, v in jpool.items()}, jpool


def _layer(jax_setup, setup):
    jmodel, jparams = jax_setup
    model, params = setup
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["l0"]["attn"])
    p = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    return jmodel, jp, model, p


def _deq(pool, key, idx=slice(None)):
    return kv_cache.dequantize_kv(pool[key][idx], pool[key + "_scale"][idx])


def _check_pool(pool, jpool, skip_null=True):
    """The port's pool after the layer against the reference's new pool:
    dequantized rows within one quantization step of the row (K and V
    come from f32 products of both packages, so a code may round one
    step apart where a value sits on a rounding edge)."""
    lo = 1 if skip_null else 0
    for key in ("k", "v"):
        got = _deq(pool, key)[lo:]
        want = kv_cache.dequantize_kv(_to_torch(jpool[key]),
                                      _to_torch(jpool[key + "_scale"]))[lo:]
        step = pool[key + "_scale"][lo:].float()[..., None]
        assert ((got - want).abs() <= step * 1.001 + 1e-6).all(), key


@pytest.mark.parametrize("mode", ["stream", "gather"])
@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_decode_attention_quantized_matches_reference(jax_setup, setup,
                                                      mode, qname):
    """Decode on a quantized pool: the new row quantized first, its
    dequantized round-trip folded into kernel 1 (stream) or the gather
    oracle, then stored with its scale; output within 1e-4 of the
    reference layer, the stored row equal to the reference's update."""
    jmodel, jp, model, p = _layer(jax_setup, setup)
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    N, bs, T, B = 10, 8, 3, 3
    pool, jpool = _quant_pool(qname, N, bs, a.gp, a.d_head, seed=21)
    x = np.random.default_rng(22).standard_normal(
        (B, 1, cfg.d_model)).astype(np.float32)
    tables = np.array([[3, 1, 5], [2, 7, 0], [4, 0, 0]], np.int32)
    positions = np.array([20, 13, 0], np.int32)
    jout, upd = jax_attn.decode_attention(
        jp, jnp.asarray(x), cfg=jmodel.cfg, plan=jmodel.plan,
        env=make_axis_env(jmodel.plan, batch=B), cache=jpool,
        positions=jnp.asarray(positions),
        block_table=jnp.asarray(tables), paged_kernel=mode)
    out = attn.decode_attention(
        p, torch.from_numpy(x), cfg=cfg, plan=plan, cache=pool,
        positions=torch.from_numpy(positions),
        block_table=torch.from_numpy(tables), paged_kernel=mode)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    for key in ("k", "v"):
        blk = tables[np.arange(B), positions // bs]
        got = _deq(pool, key, (blk, positions % bs))
        want = kv_cache.dequantize_kv(_to_torch(upd[key + "_new"])[:, 0],
                                      _to_torch(upd[key + "_scale_new"])[:, 0])
        step = pool[key + "_scale"][blk, positions % bs].float()[..., None]
        assert ((got - want).abs() <= step * 1.001 + 1e-6).all()


# (start, C, n_valid): a chunk inside one block, one crossing two blocks
# with padded rows, one from position 0
CHUNKS = [(5, 8, 6), (13, 8, 8), (0, 8, 3)]


@pytest.mark.parametrize("mode", ["stream", "gather"])
@pytest.mark.parametrize("qname", ["int8", "fp8"])
@pytest.mark.parametrize("start,C,n_valid", CHUNKS)
def test_chunk_prefill_quantized_matches_reference(jax_setup, setup, mode,
                                                   qname, start, C,
                                                   n_valid):
    """A chunk into a quantized pool: rows quantized at pool-write time
    and read back as stored; output within 1e-4 of the reference."""
    jmodel, jp, model, p = _layer(jax_setup, setup)
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    pool, jpool = _quant_pool(qname, 6, 8, a.gp, a.d_head, seed=start + C)
    x = np.random.default_rng(start).standard_normal(
        (1, C, cfg.d_model)).astype(np.float32)
    table = np.array([[3, 1, 5, 0]], np.int32)
    positions = (start + np.arange(C, dtype=np.int32))[None]
    jout, jcache = jax_attn.chunk_prefill_attention(
        jp, jnp.asarray(x), cfg=jmodel.cfg, plan=jmodel.plan,
        env=make_axis_env(jmodel.plan, batch=1),
        positions=jnp.asarray(positions), cache=jpool,
        block_table=jnp.asarray(table),
        kv_valid_len=jnp.int32(start + n_valid), paged_kernel=mode)
    out = attn.chunk_prefill_attention(
        p, torch.from_numpy(x), cfg=cfg, plan=plan,
        positions=torch.from_numpy(positions), cache=pool,
        block_table=torch.from_numpy(table),
        kv_valid_len=torch.tensor(start + n_valid, dtype=torch.int32),
        paged_kernel=mode)
    np.testing.assert_allclose(out[0, :n_valid].numpy(),
                               np.asarray(jout)[0, :n_valid], **TOL)
    _check_pool(pool, jcache)


@pytest.mark.parametrize("mode", ["stream", "gather"])
@pytest.mark.parametrize("qname", ["f32", "int8", "fp8"])
def test_verify_attention_matches_reference(jax_setup, setup, mode, qname):
    """A verify window of 3 slots x (K+1 = 4) queries, one table per
    query: slot 0 at positions 6..9 (crossing the bs = 8 boundary),
    slot 1 at 13..16, slot 2 idle on the null block.  The window's rows
    are scattered first, then read: output within 1e-4 of the reference
    layer for the live queries, the pool equal off the null block."""
    jmodel, jp, model, p = _layer(jax_setup, setup)
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    N, bs = 9, 8
    if qname == "f32":
        r = np.random.default_rng(31)
        f = {k: r.standard_normal((N, bs, a.gp, a.d_head)).astype(np.float32)
             for k in "kv"}
        pool = {k: torch.from_numpy(v.copy()) for k, v in f.items()}
        jpool = {k: jnp.asarray(v) for k, v in f.items()}
    else:
        pool, jpool = _quant_pool(qname, N, bs, a.gp, a.d_head, seed=31)
    K1 = 4
    slot_tables = np.array([[3, 1, 5], [2, 7, 4], [0, 0, 0]], np.int32)
    tables = np.repeat(slot_tables, K1, axis=0)
    positions = np.concatenate([6 + np.arange(K1), 13 + np.arange(K1),
                                np.zeros(K1)]).astype(np.int32)
    lens = np.where(np.arange(3 * K1) < 2 * K1, positions + 1, 1
                    ).astype(np.int32)
    x = np.random.default_rng(32).standard_normal(
        (1, 3 * K1, cfg.d_model)).astype(np.float32)
    jout, jcache = jax_attn.verify_attention(
        jp, jnp.asarray(x), cfg=jmodel.cfg, plan=jmodel.plan,
        env=make_axis_env(jmodel.plan, batch=1),
        positions=jnp.asarray(positions[None]), cache=jpool,
        block_tables=jnp.asarray(tables), kv_valid_len=jnp.asarray(lens),
        paged_kernel=mode)
    out = attn.verify_attention(
        p, torch.from_numpy(x), cfg=cfg, plan=plan,
        positions=torch.from_numpy(positions[None]), cache=pool,
        block_tables=torch.from_numpy(tables),
        kv_valid_len=torch.from_numpy(lens), paged_kernel=mode)
    live = 2 * K1
    np.testing.assert_allclose(out[0, :live].numpy(),
                               np.asarray(jout)[0, :live], **TOL)
    if qname == "f32":
        for key in ("k", "v"):
            np.testing.assert_allclose(pool[key][1:].numpy(),
                                       np.asarray(jcache[key])[1:], **TOL)
    else:
        _check_pool(pool, jcache)


def test_quantized_pool_without_scales_is_refused(setup):
    """An int8 pool that lost its scale leaves would be read as raw
    codes: every paged layer refuses it."""
    model, params = setup
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    p = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    pool = {k: torch.zeros((4, 8, a.gp, a.d_head), dtype=torch.int8)
            for k in "kv"}
    with pytest.raises(ValueError, match="scale"):
        attn.verify_attention(
            p, torch.zeros((1, 2, cfg.d_model)), cfg=cfg, plan=plan,
            positions=torch.tensor([[0, 1]], dtype=torch.int32), cache=pool,
            block_tables=torch.ones((2, 2), dtype=torch.int32),
            kv_valid_len=torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="scale"):
        attn.decode_attention(
            p, torch.zeros((1, 1, cfg.d_model)), cfg=cfg, plan=plan,
            cache=pool, positions=torch.zeros(1, dtype=torch.int32),
            block_table=torch.ones((1, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the engine: streams against the reference's int8/fp8 engine
# ---------------------------------------------------------------------------

def _replay_gaps(model, params, qname, prompt, stream):
    """Top-2 logit gaps of the port's own int8/fp8 path along ``stream``
    (prompt prefilled in f32 and scattered quantized, then one decode
    step per token against the quantized pool): row j is the step that
    picked ``stream[j]``."""
    t_dt = QDTYPES[qname][0]
    n = len(prompt)
    bucket = 16
    while bucket < n:
        bucket *= 2
    pc = model.init_cache(1, bucket)
    buf = torch.zeros((1, bucket), dtype=torch.long)
    buf[0, :n] = torch.tensor(prompt)
    logits, pc = model.forward(params, buf, mode="prefill", cache=pc,
                               positions=torch.arange(bucket)[None])
    rows = [logits[0, n - 1]]
    bs, T = 16, 4
    pool = model.init_cache(1, 64, paged=True, num_blocks=T + 1,
                            block_size=bs, dtype=t_dt,
                            scale_dtype=torch.float16)
    table = torch.arange(1, T + 1, dtype=torch.int32)
    kv_cache.scatter_prefill_pages(pool, pc, table[:bucket // bs])
    for j, tok in enumerate(stream[:-1]):
        logits, _ = model.forward(
            params, torch.tensor([[tok]]), mode="decode",
            positions=torch.tensor([n + j], dtype=torch.int32), cache=pool,
            block_tables=table[None], paged_kernel="gather")
        rows.append(logits[0, -1])
    rows = torch.stack(rows)
    top = rows.topk(2, -1).values
    return (top[:, 0] - top[:, 1]).numpy(), rows.argmax(-1).tolist()


def _assert_agree(model, params, qname, prompts, got, want):
    """Equal streams, or apart only where the port's own quantized
    path has a top-2 gap <= GAP (asserted, and printed)."""
    for p, g, w in zip(prompts, got, want):
        if g == w:
            continue
        at = next(i for i, (a, b) in enumerate(zip(g, w)) if a != b)
        gap = _replay_gaps(model, params, qname, p, g)[0][at]
        print(f"{qname}: prompt {p} parts at token {at}, top-2 gap {gap}")
        assert gap <= GAP, (p, at, gap)


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_gap_replay_reproduces_the_engine(setup, qname):
    """The replay that prices a parting re-derives each engine stream:
    its argmax along a stream is the stream itself."""
    model, params = setup
    outs = _engine(setup, kv_dtype=qname).generate(PROMPTS,
                                                   max_new_tokens=8)
    for p, o in zip(PROMPTS, outs):
        assert _replay_gaps(model, params, qname, p, o)[1] == o


@pytest.mark.parametrize("mode", ["stream", "gather"])
@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_engine_streams_match_reference_engine(jax_setup, setup, mode,
                                               qname):
    """The port's int8/fp8 engine against the reference's with the same
    knobs, through kernel 1's plain version (stream) and the gather
    oracle; the pool balanced after the drain."""
    jmodel, jparams = jax_setup
    model, params = setup
    kw = dict(KW, kv_dtype=qname, paged_kernel=mode)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw)).generate(
        PROMPTS, max_new_tokens=8)
    eng = _engine(setup, kv_dtype=qname, paged_kernel=mode)
    got = eng.generate(PROMPTS, max_new_tokens=8)
    eng.check_pool_balanced()
    _assert_agree(model, params, qname, PROMPTS, got, ref)


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_engine_stream_matches_gather(setup, qname):
    """Both dataflows fold the same quantize -> dequantize round-trip of
    the new token: their streams agree token for token."""
    outs = {m: _engine(setup, kv_dtype=qname, paged_kernel=m).generate(
        PROMPTS, max_new_tokens=8) for m in ("stream", "gather")}
    assert outs["stream"] == outs["gather"]


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_engine_prefix_sharing_parity(setup, qname):
    """Shared-prefix admissions map quantized blocks and their scales
    into other tables: streams equal the cold-start run's."""
    sys_prompt = [7, 3, 5, 2, 9, 4, 8, 6] * 4       # 2 full blocks
    prompts = [sys_prompt + [t] for t in (11, 12, 13)]
    outs = {}
    for on in (False, True):
        eng = _engine(setup, slots=3, kv_dtype=qname, prefix_cache=on)
        outs[on] = eng.generate(prompts, max_new_tokens=8)
        eng.check_pool_balanced()
        if on:
            assert eng.stats.prefix_hit_blocks > 0
    assert outs[True] == outs[False]


@pytest.mark.parametrize("qname,chunk", [("int8", 0), ("int8", 8),
                                         ("fp8", 8)])
def test_engine_preemption_parity(setup, qname, chunk):
    """A pool too small for every stream preempts and recomputes; the
    recomputed rows requantize to the same stored values, so streams
    equal the uncontended run's.  fp8 is held with chunked prefill on
    both runs: a monolithic prefill attends the prompt's f32 rows, a
    recompute then differs by the quantization noise, and the
    reference's fp8 engine parts there too (next test)."""
    big = _engine(setup, slots=3, kv_dtype=qname,
                  prefill_chunk=chunk).generate(PROMPTS, max_new_tokens=20)
    small = _engine(setup, slots=3, block_size=8, num_blocks=5,
                    kv_dtype=qname, prefill_chunk=chunk)
    got = small.generate(PROMPTS, max_new_tokens=20)
    assert small.stats.preemptions > 0
    small.check_pool_balanced()
    assert got == big


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_engine_preemption_matches_reference_engine(jax_setup, setup,
                                                    qname):
    """The same small pool with monolithic prefill: the port's streams
    equal the reference engine's, recompute included (for fp8 both
    part from the uncontended run at the same tokens)."""
    jmodel, jparams = jax_setup
    model, params = setup
    kw = dict(KW, slots=3, block_size=8, num_blocks=5, kv_dtype=qname)
    ref_eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw))
    ref = ref_eng.generate(PROMPTS, max_new_tokens=20)
    eng = _engine(setup, **kw)
    got = eng.generate(PROMPTS, max_new_tokens=20)
    assert eng.stats.preemptions == ref_eng.stats.preemptions > 0
    eng.check_pool_balanced()
    _assert_agree(model, params, qname, PROMPTS, got, ref)


@pytest.mark.parametrize("qname", ["int8", "fp8"])
def test_engine_drift_bound(setup, qname):
    """Greedy streams of the quantized pool keep a common prefix with
    the f32 pool's of at least 0.75 on average, the reference's bound
    (tests/test_quantized_kv.py)."""
    of = _engine(setup).generate(PROMPTS, max_new_tokens=8)
    oq = _engine(setup, kv_dtype=qname).generate(PROMPTS, max_new_tokens=8)
    agree = []
    for a, b in zip(oq, of):
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        agree.append(k / min(len(a), len(b)))
    assert sum(agree) / len(agree) >= 0.75, agree


def test_engine_chunked_quantized_matches_monolithic(setup):
    """Chunks of 5 into the int8 pool (quantized at pool-write time, as
    the monolithic prefill's scatter is) give the monolithic run's
    streams."""
    mono = _engine(setup, kv_dtype="int8").generate(PROMPTS,
                                                    max_new_tokens=8)
    eng = _engine(setup, kv_dtype="int8", prefill_chunk=5)
    assert eng.generate(PROMPTS, max_new_tokens=8) == mono
    assert eng.stats.prefill_chunks > 0
    eng.check_pool_balanced()
