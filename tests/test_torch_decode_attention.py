"""The port's decode attention (plain versions, as the wrappers run them
on CPU tensors) against the JAX reference's kernels in interpret mode and
its oracles: the paged kernel 1 with fp, int8 and fp8 pools, and the
dense kernel 2; plus the null-block property on the port itself, and
both kernels' split plan with CPU replays of their split-and-merge."""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import (
    decode_attention_pallas, paged_decode_attention_pallas)
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro.serving import kv_cache as jax_kv
from repro_torch.compiler.plan import plan_attention
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      gather_kv_pages,
                                                      paged_decode_attention_ref)
from repro_torch.serving import kv_cache
from tests.torch_dense_util import one_torch_thread  # noqa: F401

# (B, H, G, dh, bs, T, N): reduced test shapes and smollm's head geometry
SHAPES = [(3, 4, 2, 32, 8, 4, 13), (3, 6, 2, 32, 16, 3, 10),
          (4, 9, 3, 64, 16, 4, 17)]
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def _inputs(B, H, G, dh, bs, T, N, seed=0):
    """numpy inputs: ragged lengths with one empty row, distinct blocks
    per row, table tails on the null block 0."""
    r = np.random.default_rng(seed)
    lengths = np.array([0] + list(r.integers(1, T * bs + 1, size=B - 1)),
                       np.int32)
    tables = np.zeros((B, T), np.int32)
    nxt = 1
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        tables[b, :used] = (np.arange(used) + nxt) % (N - 1) + 1
        nxt += used
    arrays = dict(
        q=r.standard_normal((B, H, dh)), kp=r.standard_normal((N, bs, G, dh)),
        vp=r.standard_normal((N, bs, G, dh)), kn=r.standard_normal((B, G, dh)),
        vn=r.standard_normal((B, G, dh)))
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return arrays, tables, lengths


def _port(a, tables, lengths, fold, dtype):
    t = {k: torch.from_numpy(v).to(dtype) for k, v in a.items()}
    extra = dict(k_new=t["kn"], v_new=t["vn"]) if fold else {}
    return ops.paged_decode_attention(
        t["q"], t["kp"], t["vp"], torch.from_numpy(tables),
        torch.from_numpy(lengths), **extra).float().numpy()


def _jax(a, tables, lengths, fold, dtype, oracle):
    j = {k: jnp.asarray(v).astype(dtype) for k, v in a.items()}
    extra = dict(k_new=j["kn"], v_new=j["vn"]) if fold else {}
    args = (j["q"], j["kp"], j["vp"], jnp.asarray(tables),
            jnp.asarray(lengths))
    if oracle:
        if fold:      # the reference's mask-scatter oracle of the fold
            out = jax_paged_decode_attention(*args, use_pallas=False,
                                             **extra)
        else:
            gs = j["q"].shape[1] // j["kp"].shape[2]
            out = jax_paged_ref(j["q"], jnp.repeat(j["kp"], gs, axis=2),
                                jnp.repeat(j["vp"], gs, axis=2),
                                *args[3:])
    else:
        out = paged_decode_attention_pallas(*args, interpret=True, **extra)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", [False, True], ids=["pallas", "ref"])
def test_matches_reference_kernel_and_oracle(shape, fold, dtype, oracle):
    a, tables, lengths = _inputs(*shape)
    mine = _port(a, tables, lengths, fold, getattr(torch, dtype))
    ref = _jax(a, tables, lengths, fold, getattr(jnp, dtype), oracle)
    tol = TOL[dtype]
    # row 0 has length 0: without the fold both return the mean of every
    # V row of its table, with the fold the folded token
    np.testing.assert_allclose(mine, ref, rtol=tol, atol=tol)


def test_plain_version_is_softmax_over_valid_rows():
    """Direct definition on one row: softmax over the valid positions
    plus the folded token."""
    a, tables, lengths = _inputs(2, 4, 2, 16, 8, 3, 7, seed=3)
    lengths[0] = 5
    out = _port(a, tables, lengths, True, torch.float32)
    k = gather_kv_pages(torch.from_numpy(a["kp"]),
                        torch.from_numpy(tables))[0, :5, 0]
    v = gather_kv_pages(torch.from_numpy(a["vp"]),
                        torch.from_numpy(tables))[0, :5, 0]
    k = torch.cat([k, torch.from_numpy(a["kn"])[0, :1]])
    v = torch.cat([v, torch.from_numpy(a["vn"])[0, :1]])
    q = torch.from_numpy(a["q"])[0, 0]
    p = torch.softmax(k @ q / 4.0, 0)
    np.testing.assert_allclose(out[0, 0], (p @ v).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_empty_row_returns_fold_or_zeros():
    """A length-0 row returns the folded token, or without the fold the
    mean of the V rows of its whole table (all T tiles, null block
    included), as the reference does."""
    a, tables, lengths = _inputs(3, 4, 2, 32, 8, 4, 13)
    with_fold = _port(a, tables, lengths, True, torch.float32)
    np.testing.assert_allclose(with_fold[0].reshape(2, 2, 32),
                               np.repeat(a["vn"][0][:, None], 2, 1),
                               rtol=1e-6)
    mean = a["vp"][tables[0]].reshape(-1, 2, 32).mean(0)     # (G, dh)
    np.testing.assert_allclose(
        _port(a, tables, lengths, False, torch.float32)[0].reshape(2, 2, 32),
        np.repeat(mean[:, None], 2, 1), rtol=1e-5, atol=1e-6)


def _check_null_block_inert(fill, len0, len1, fold):
    a, _, _ = _inputs(2, 4, 2, 16, 8, 4, 9, seed=5)
    lengths = np.array([len0, len1], np.int32)
    # row b owns blocks 1+4b.. for its used tiles; the tail rides block 0
    tables = np.zeros((2, 4), np.int32)
    for b, n in enumerate(lengths):
        used = -(-int(n) // 8)
        tables[b, :used] = 1 + 4 * b + np.arange(used)
    base = _port(a, tables, lengths, fold, torch.float32)
    a["kp"][0] = fill
    a["vp"][0] = fill
    scribbled = _port(a, tables, lengths, fold, torch.float32)
    # the property holds for rows that attend something: a length-0 row
    # without the fold averages its whole table, null block included
    rows = (lengths > 0) | fold
    assert np.isfinite(scribbled[rows]).all()
    np.testing.assert_array_equal(base[rows], scribbled[rows])


# 1e30 itself is not an f32: hypothesis refuses it as a width-32 bound
F32_1E30 = float(np.float32(1e30))

try:
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(fill=st.floats(-F32_1E30, F32_1E30, allow_nan=False,
                          allow_infinity=False, width=32),
           len0=st.integers(0, 32), len1=st.integers(0, 32),
           fold=st.booleans())
    def test_null_block_never_contributes(fill, len0, len1, fold):
        _check_null_block_inert(fill, len0, len1, fold)
except ImportError:        # no hypothesis: fixed adversarial examples
    @pytest.mark.parametrize("fill,len0,len1,fold",
                             [(0.0, 1, 1, True), (1e30, 3, 16, True),
                              (-1e30, 16, 2, False), (-7.5, 0, 9, True)])
    def test_null_block_never_contributes(fill, len0, len1, fold):
        _check_null_block_inert(fill, len0, len1, fold)


def test_cpu_wrapper_takes_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    kernel launch."""
    ops.paged_decode_attention.launches = 0
    a, tables, lengths = _inputs(*SHAPES[0])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = ops.paged_decode_attention(
        t["q"], t["kp"], t["vp"], torch.from_numpy(tables),
        torch.from_numpy(lengths), k_new=t["kn"], v_new=t["vn"])
    want = paged_decode_attention_ref(
        t["q"], t["kp"], t["vp"], torch.from_numpy(tables),
        torch.from_numpy(lengths), k_new=t["kn"], v_new=t["vn"])
    assert torch.equal(got, want)
    assert ops.paged_decode_attention.launches == 0


def test_scales_dequantize_in_the_plain_version():
    a, tables, lengths = _inputs(*SHAPES[0])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    ks = torch.rand(t["kp"].shape[:3]) + 0.5
    vs = torch.rand(t["vp"].shape[:3]) + 0.5
    tb, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    got = ops.paged_decode_attention(t["q"], t["kp"], t["vp"], tb, ln,
                                     k_scale=ks, v_scale=vs)
    want = ops.paged_decode_attention(t["q"], t["kp"] * ks[..., None],
                                      t["vp"] * vs[..., None], tb, ln)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# int8 / fp8 pools (kernel 1's quantized path)
# ---------------------------------------------------------------------------

QDTYPES = {"int8": (torch.int8, jnp.int8),
           "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn)}


def _quantized_pools(a, qname):
    """Both packages quantize the same f32 pools with f16 scales; their
    stored bytes must agree (any disagreement would be logged in
    ROADMAP.md queue 3)."""
    t_dt, j_dt = QDTYPES[qname]
    port, ref = {}, {}
    for key in ("kp", "vp"):
        q, sc = kv_cache.quantize_kv_rows(torch.from_numpy(a[key]), t_dt,
                                          torch.float16)
        jq, jsc = jax_kv.quantize_kv_rows(jnp.asarray(a[key]), j_dt,
                                          jnp.float16)
        np.testing.assert_array_equal(
            q.view(torch.uint8).numpy(),
            np.asarray(jq).view(np.uint8))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))
        port[key], ref[key] = (q, sc), (jq, jsc)
    return port, ref


@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("qname", ["int8", "fp8"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("oracle", [False, True], ids=["pallas", "ref"])
def test_quantized_pool_matches_reference(shape, qname, fold, oracle):
    a, tables, lengths = _inputs(*shape, seed=7)
    port, ref = _quantized_pools(a, qname)
    t = {k: torch.from_numpy(a[k]) for k in ("q", "kn", "vn")}
    extra = dict(k_new=t["kn"], v_new=t["vn"]) if fold else {}
    mine = ops.paged_decode_attention(
        t["q"], port["kp"][0], port["vp"][0], torch.from_numpy(tables),
        torch.from_numpy(lengths), k_scale=port["kp"][1],
        v_scale=port["vp"][1], **extra).numpy()
    jextra = dict(k_new=jnp.asarray(a["kn"]),
                  v_new=jnp.asarray(a["vn"])) if fold else {}
    args = (jnp.asarray(a["q"]), ref["kp"][0], ref["vp"][0],
            jnp.asarray(tables), jnp.asarray(lengths))
    scales = dict(k_scale=ref["kp"][1], v_scale=ref["vp"][1])
    if oracle:
        want = jax_paged_decode_attention(*args, use_pallas=False,
                                          **scales, **jextra)
    else:
        want = paged_decode_attention_pallas(*args, interpret=True,
                                             **scales, **jextra)
    np.testing.assert_allclose(mine, np.asarray(want), **TOL_F32)


def test_quantize_kv_rows_zero_rows_and_roundtrip():
    rows = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (5, 3, 16)).astype(np.float32))
    rows[2, 1] = 0.0
    for t_dt in (torch.int8, torch.float8_e4m3fn):
        q, sc = kv_cache.quantize_kv_rows(rows, t_dt, torch.float16)
        assert q.dtype == t_dt and sc.shape == (5, 3)
        assert sc[2, 1] == 0 and (kv_cache.dequantize_kv(q, sc)[2, 1] == 0
                                  ).all()
        err = (kv_cache.dequantize_kv(q, sc) - rows).abs().max().item()
        assert err < 0.1
    assert kv_cache.qmax_for_dtype(torch.int8) == 127.0
    assert kv_cache.qmax_for_dtype(torch.float8_e4m3fn) == 448.0
    with pytest.raises(ValueError):
        kv_cache.qmax_for_dtype(torch.float16)


# ---------------------------------------------------------------------------
# dense decode attention (kernel 2)
# ---------------------------------------------------------------------------

TOL_F32 = dict(rtol=1e-4, atol=1e-4)
# (B, H, G, dh, S, block_s of the reference kernel)
DENSE_SHAPES = [(3, 4, 2, 32, 32, 8), (4, 9, 3, 64, 48, 16)]


def _dense_inputs(B, H, G, dh, S, seed=0):
    r = np.random.default_rng(seed)
    lengths = np.array([0, S] + list(r.integers(1, S, size=B - 2)),
                       np.int32)
    arrays = dict(q=r.standard_normal((B, H, dh)),
                  k=r.standard_normal((B, S, G, dh)),
                  v=r.standard_normal((B, S, G, dh)))
    return {k: v.astype(np.float32) for k, v in arrays.items()}, lengths


@pytest.mark.parametrize("shape", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("oracle", [False, True], ids=["pallas", "ref"])
def test_dense_matches_reference_kernel_and_oracle(shape, dtype, oracle):
    B, H, G, dh, S, block_s = shape
    a, lengths = _dense_inputs(B, H, G, dh, S)
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in a.items()}
    mine = ops.decode_attention(t["q"], t["k"], t["v"],
                                torch.from_numpy(lengths)).float().numpy()
    j = {k: jnp.asarray(v).astype(getattr(jnp, dtype)) for k, v in a.items()}
    if oracle:
        gs = H // G
        want = jax_decode_ref(j["q"], jnp.repeat(j["k"], gs, axis=2),
                              jnp.repeat(j["v"], gs, axis=2),
                              jnp.asarray(lengths))
    else:
        want = decode_attention_pallas(j["q"], j["k"], j["v"],
                                       jnp.asarray(lengths), block_s=block_s,
                                       interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(mine, np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # row 0 (length 0) is the mean of all S V rows
    mean = a["v"][0].mean(0)                                 # (G, dh)
    np.testing.assert_allclose(
        mine[0].reshape(G, H // G, dh),
        np.repeat(mean[:, None], H // G, 1), rtol=tol, atol=tol)


def test_dense_equals_paged_on_the_same_rows():
    """The dense plain version over a gathered view equals the paged one
    over the pool: the table only redirects where rows live."""
    a, tables, lengths = _inputs(*SHAPES[2])
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    tb, ln = torch.from_numpy(tables), torch.from_numpy(lengths)
    paged = ops.paged_decode_attention(t["q"], t["kp"], t["vp"], tb, ln)
    dense = ops.decode_attention(t["q"], gather_kv_pages(t["kp"], tb),
                                 gather_kv_pages(t["vp"], tb), ln)
    torch.testing.assert_close(paged, dense, rtol=0, atol=0)


def test_dense_broadcast_cache_and_launch_count():
    """A cache broadcast over the batch (stride 0) is read as is, and the
    CPU wrapper counts no launch."""
    a, lengths = _dense_inputs(3, 4, 2, 32, 32)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    k1 = t["k"][:1].expand(3, -1, -1, -1)
    v1 = t["v"][:1].expand(3, -1, -1, -1)
    ops.decode_attention.launches = 0
    got = ops.decode_attention(t["q"], k1, v1, torch.from_numpy(lengths))
    want = decode_attention_ref(t["q"], k1.contiguous(), v1.contiguous(),
                                torch.from_numpy(lengths))
    assert torch.equal(got, want)
    assert ops.decode_attention.launches == 0


# kernel 2's split plan (ops.dense_plan; csrc/decode_split.cuh)
MAX_SMEM = 227 * 1024          # shared memory one block may use (H100)
MAX_CLUSTER = 16               # Hopper's largest (non-portable) cluster


def _share(n, rank):
    """Block ``rank``'s rows [lo, hi) of a row's n attended positions, as
    ``share_of`` in csrc/decode_split.cuh computes them."""
    share = -(-n // ops.SPLIT)
    lo = min(n, rank * share)
    return lo, min(n, lo + share)


def _smem(gs, dh, item, L, stages):
    """``smem_bytes`` of csrc/decode_split.cuh: the K/V tiles, then q,
    the scores, the softmax state, the merge weights, the folded k, the
    row scales and SPLIT + 1 merge slots (the ranks and the fold)."""
    pitch = -(-dh * item // 16) * 16 + 16
    parts = ops.SPLIT + 1
    return stages * 2 * L * pitch + 4 * (
        gs * dh + gs * L + (4 + parts) * ops.MAX_GROUP + dh + stages * 2 * L
        + parts * (2 * ops.MAX_GROUP + gs * dh))


def _split_replay(q, k, v, lengths):
    """The dense kernel's arithmetic in float64 on the CPU: each row's
    attended positions cut into SPLIT shares walked in tiles of the
    plan's L rows (online softmax), the shares' (m, l, acc) merged in
    rank order as rank 0 merges them."""
    B, H, dh = q.shape
    S, G = k.shape[1], k.shape[2]
    gs = H // G
    L, stages = ops.dense_plan(S, dh, 4)
    out = np.zeros((B, H, dh))
    for b in range(B):
        n = min(int(lengths[b]), S)
        uniform = n <= 0
        cover = S if uniform else n
        for g in range(G):
            qs = q[b, g * gs:(g + 1) * gs].astype(np.float64) / np.sqrt(dh)
            parts = []
            for rank in range(ops.SPLIT):
                lo, hi = _share(cover, rank)
                assert -(-(hi - lo) // L) <= (1 if stages == 1 else hi - lo)
                m, l, acc = np.full(gs, -1e30), np.zeros(gs), \
                    np.zeros((gs, dh))
                for r0 in range(lo, hi, L):
                    kt = k[b, r0:min(hi, r0 + L), g].astype(np.float64)
                    vt = v[b, r0:min(hi, r0 + L), g].astype(np.float64)
                    sc = np.zeros((gs, len(kt))) if uniform else qs @ kt.T
                    m_new = np.maximum(m, sc.max(1))
                    p = np.exp(sc - m_new[:, None])
                    c = np.exp(m - m_new)
                    l, acc, m = l * c + p.sum(1), acc * c[:, None] + p @ vt, \
                        m_new
                parts.append((m, l, acc))
            M = np.max([m for m, _, _ in parts], 0)
            lt = sum(l * np.exp(m - M) for m, l, _ in parts)
            at = sum(a * np.exp(m - M)[:, None] for m, _, a in parts)
            out[b, g * gs:(g + 1) * gs] = at / np.maximum(lt, 1e-30)[:, None]
    return out


def test_dense_plan_at_the_chain_shape():
    """The C1 chain's dense shape (B 4, G 3, dh 64, S 512, f32): one tile
    of 32 rows per block, a single stage, and 16 x 3 x 4 = 192 blocks,
    more than the card's 132 SMs, in clusters within Hopper's limit."""
    assert ops.dense_plan(512, 64, 4) == (32, 1)
    assert ops.SPLIT * 3 * 4 == 192 >= 132
    assert ops.SPLIT <= MAX_CLUSTER
    assert _smem(3, 64, 4, 32, 1) <= 48 * 1024


@pytest.mark.parametrize("S", [1, 3, 15, 16, 17, 100, 511, 512, 513, 1000,
                               1024, 1025, 4096])
@pytest.mark.parametrize("dh", [32, 64, 100, 128, 256])
@pytest.mark.parametrize("item", [2, 4])
def test_dense_plan_depends_on_S_and_row_bytes(S, dh, item):
    """S below one split (S < 16), S not a multiple of SPLIT * L, and the
    widest rows: L within its limits, two stages exactly when a share can
    exceed one tile, shared memory within a block's limit, and shares
    that tile [0, n) for every length n."""
    L, stages = ops.dense_plan(S, dh, item)
    assert 1 <= L <= ops.MAX_TILE_ROWS
    assert L == 1 or L * dh * item <= ops.TILE_BYTES
    per = -(-S // ops.SPLIT)
    assert stages == (1 if per <= L else 2)
    assert _smem(ops.MAX_GROUP, dh, item, L, stages) <= MAX_SMEM
    for n in sorted({1, L, L + 1, ops.SPLIT * L, ops.SPLIT * L + 1, S - 1,
                     S}):
        if not 1 <= n <= S:
            continue
        spans = [_share(n, r) for r in range(ops.SPLIT)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(hi - lo <= per for lo, hi in spans)
        if stages == 1:
            assert all(hi - lo <= L for lo, hi in spans)


@pytest.mark.parametrize("S", [5, 48, 100, 512, 1030])
def test_dense_split_replay_matches_plain_and_reference(S):
    """The kernel's split, tiles and rank-order merge, replayed on the
    CPU, equal the plain version and the reference's oracle at lengths
    on split and tile boundaries (0, 1, L, L+1, SPLIT*L, S)."""
    B, H, G, dh = 6, 6, 2, 32
    L, _ = ops.dense_plan(S, dh, 4)
    lengths = np.array([min(n, S) for n in
                        (0, 1, L, L + 1, ops.SPLIT * L, S)], np.int32)
    r = np.random.default_rng(S)
    q, k, v = (r.standard_normal(shape).astype(np.float32) for shape in
               ((B, H, dh), (B, S, G, dh), (B, S, G, dh)))
    got = _split_replay(q, k, v, lengths)
    plain = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v),
                                 torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, plain, **TOL_F32)
    gs = H // G
    want = jax_decode_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), gs, 2),
                          jnp.repeat(jnp.asarray(v), gs, 2),
                          jnp.asarray(lengths))
    np.testing.assert_allclose(got, np.asarray(want), **TOL_F32)


# kernel 1's split: the dense kernel's plan at S = T * bs, shares that
# cross pool blocks, the block table as the row address, the fold as a
# 17th partial merged after the ranks (csrc/paged_decode_attention.cu)
PAGED_SPLIT = [(16, 5), (64, 34)]      # (bs, T): one stage; two stages


def _paged_split_replay(q, kf, vf, tables, lengths, item, kn=None,
                        vn=None):
    """The paged kernel's arithmetic in float64 on the CPU over the
    dequantized pool ``kf``/``vf`` (N, bs, G, dh): each row's attended
    positions cut into SPLIT shares walked in tiles of the plan's L rows,
    each position looked up through the block table; the shares'
    (m, l, acc) merged in rank order and the folded token's
    (q.k_new, 1, v_new) after them.  -> (out, {(b, table index) read})."""
    B, H, dh = q.shape
    _, bs, G, _ = kf.shape
    T = tables.shape[1]
    S, gs = T * bs, H // G
    L, stages = ops.dense_plan(S, dh, item)
    fold = kn is not None
    out = np.zeros((B, H, dh))
    read = set()
    for b in range(B):
        uniform = lengths[b] <= 0 and not fold
        n = S if uniform else min(max(int(lengths[b]), 0), S)
        for g in range(G):
            qs = q[b, g * gs:(g + 1) * gs].astype(np.float64) / np.sqrt(dh)
            parts = []
            for rank in range(ops.SPLIT):
                lo, hi = _share(n, rank)
                assert -(-(hi - lo) // L) <= (1 if stages == 1 else hi - lo)
                m, l, acc = np.full(gs, -1e30), np.zeros(gs), \
                    np.zeros((gs, dh))
                for p0 in range(lo, hi, L):
                    pos = np.arange(p0, min(hi, p0 + L))
                    read.update((b, int(t)) for t in pos // bs)
                    blk = tables[b, pos // bs]
                    kt = kf[blk, pos % bs, g].astype(np.float64)
                    vt = vf[blk, pos % bs, g].astype(np.float64)
                    sc = np.zeros((gs, len(pos))) if uniform else qs @ kt.T
                    m_new = np.maximum(m, sc.max(1))
                    p = np.exp(sc - m_new[:, None])
                    c = np.exp(m - m_new)
                    l, acc, m = l * c + p.sum(1), acc * c[:, None] + p @ vt, \
                        m_new
                parts.append((m, l, acc))
            if fold:
                parts.append((qs @ kn[b, g].astype(np.float64), np.ones(gs),
                              np.tile(vn[b, g].astype(np.float64), (gs, 1))))
            M = np.max([m for m, _, _ in parts], 0)
            lt = sum(l * np.exp(m - M) for m, l, _ in parts)
            at = sum(a * np.exp(m - M)[:, None] for m, _, a in parts)
            out[b, g * gs:(g + 1) * gs] = at / np.maximum(lt, 1e-30)[:, None]
    return out, read


def _paged_split_inputs(bs, T, seed, G=2, gs=2, dh=32):
    """Lengths on every share and pool-block boundary (0, 1, 15, 16, 17,
    bs - 1, bs, bs + 1, 2*bs + 1, L, L + 1, SPLIT*L, S - 1, S, and one
    whose shares of 5 or 9 rows straddle blocks), each row's blocks drawn
    out of order, table tails on the null block 0."""
    S = T * bs
    L, _ = ops.dense_plan(S, dh, 4)
    lens = sorted({n for n in (0, 1, 15, 16, 17, bs - 1, bs, bs + 1,
                               2 * bs + 1, L, L + 1, ops.SPLIT * L, S - 1,
                               S, 16 * 5 - 3, 16 * 9 - 1) if 0 <= n <= S})
    B, H = len(lens), G * gs
    N = B * T + 1
    r = np.random.default_rng(seed)
    perm = r.permutation(N - 1) + 1
    tables = np.zeros((B, T), np.int32)
    for b, n in enumerate(lens):
        used = -(-n // bs)
        tables[b, :used] = perm[b * T:b * T + used]
    a = dict(q=r.standard_normal((B, H, dh)),
             kp=r.standard_normal((N, bs, G, dh)),
             vp=r.standard_normal((N, bs, G, dh)),
             kn=r.standard_normal((B, G, dh)),
             vn=r.standard_normal((B, G, dh)))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return a, tables, np.array(lens, np.int32)


@pytest.mark.parametrize("bs_T", PAGED_SPLIT, ids=["1stage", "2stages"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("pool", ["float32", "int8", "fp8"])
def test_paged_split_replay_matches_plain_and_reference(bs_T, fold, pool):
    """Kernel 1's shares, tiles, table lookups, fold and rank-order
    merge, replayed on the CPU, equal the plain version and the
    reference's oracle at lengths on every share and pool-block
    boundary, for an fp pool and for int8 / fp8 pools with their scales;
    no table entry at or past ceil(length / bs) is read, except by a
    length-0 row without the fold (the mean of its whole table)."""
    _check_paged_split_replay(bs_T, fold, pool, G=2, gs=2, dh=32)


# the paper's OPT models: multi-head attention (one query head per kv
# head, G = H) at dh 64 (opt-1.3b) and 128 (opt-6.7b)
OPT_HEADS = {"gs1-dh64": (4, 1, 64), "gs1-dh128": (3, 1, 128)}


@pytest.mark.parametrize("heads", list(OPT_HEADS))
@pytest.mark.parametrize("bs_T", PAGED_SPLIT, ids=["1stage", "2stages"])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8", "fp8"])
def test_paged_split_replay_at_opt_heads(heads, bs_T, fold, pool):
    """The same replay at OPT's head shapes: gs 1 (G = H), dh 64 and
    128, for f32, bf16 (the paper's protocol), int8 and fp8 pools."""
    G, gs, dh = OPT_HEADS[heads]
    _check_paged_split_replay(bs_T, fold, pool, G=G, gs=gs, dh=dh)


def _check_paged_split_replay(bs_T, fold, pool, G, gs, dh):
    bs, T = bs_T
    a, tables, lengths = _paged_split_inputs(bs, T, bs + T, G, gs, dh)
    if pool == "bfloat16":
        # the new row as a bf16 plan computes it (the reference's oracle
        # stores it into the gathered bf16 view before attending it)
        for key in ("kn", "vn"):
            a[key] = torch.from_numpy(a[key]).bfloat16().float().numpy()
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    extra = dict(k_new=t["kn"], v_new=t["vn"]) if fold else {}
    jextra = dict(k_new=jnp.asarray(a["kn"]),
                  v_new=jnp.asarray(a["vn"])) if fold else {}
    if pool == "float32":
        kp, vp, item, scales, jscales = t["kp"], t["vp"], 4, {}, {}
        jk, jv = jnp.asarray(a["kp"]), jnp.asarray(a["vp"])
        kf, vf = a["kp"], a["vp"]
    elif pool == "bfloat16":
        kp, vp = t["kp"].bfloat16(), t["vp"].bfloat16()
        item, scales, jscales = 2, {}, {}
        kf, vf = kp.float().numpy(), vp.float().numpy()
        jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (kf, vf))
    else:
        port, ref = _quantized_pools(a, pool)
        (kp, ks), (vp, vs) = port["kp"], port["vp"]
        item, scales = 1, dict(k_scale=ks, v_scale=vs)
        jk, jv = ref["kp"][0], ref["vp"][0]
        jscales = dict(k_scale=ref["kp"][1], v_scale=ref["vp"][1])
        kf = kv_cache.dequantize_kv(kp, ks).numpy()
        vf = kv_cache.dequantize_kv(vp, vs).numpy()
    got, read = _paged_split_replay(a["q"], kf, vf, tables, lengths, item,
                                    a["kn"] if fold else None,
                                    a["vn"] if fold else None)
    for b, n in enumerate(lengths):
        if n > 0 or fold:
            assert all(i < -(-int(n) // bs) for bb, i in read if bb == b)
    plain = ops.paged_decode_attention(
        t["q"], kp, vp, torch.from_numpy(tables), torch.from_numpy(lengths),
        **scales, **extra).numpy()
    np.testing.assert_allclose(got, plain, **TOL_F32)
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(a["q"]), jk, jv, jnp.asarray(tables),
        jnp.asarray(lengths), use_pallas=False, **jscales, **jextra))
    # the reference's gather oracle writes the folded token at position
    # `length` of the gathered view, so a full row with the fold is
    # outside its domain (the position is clamped onto the last row)
    rows = (lengths < T * bs) | (not fold)
    np.testing.assert_allclose(got[rows], want[rows], **TOL_F32)


@pytest.mark.parametrize("S", [1, 16, 80, 512, 2176, 4096])
@pytest.mark.parametrize("dh", [32, 64, 100, 256])
@pytest.mark.parametrize("item", [1, 2, 4])
def test_paged_plan_depends_on_S_and_row_bytes(S, dh, item):
    """Kernel 1 plans in C (``tile_plan``) as ``dense_plan`` does, from
    T * bs and the pool's item size only: every (bs, T) with the same
    S shares the plan, L stays within its limits and shared memory within
    a block's limit at the widest group (int8 / fp8 pools included); the
    C constants are the wrapper's."""
    plans = {ops.dense_plan(bs * (S // bs), dh, item)
             for bs in (1, 2, 4, 8, 16) if S % bs == 0}
    assert len(plans) == 1
    L, stages = plans.pop()
    assert 1 <= L <= ops.MAX_TILE_ROWS
    assert L == 1 or L * dh * item <= ops.TILE_BYTES
    assert stages == (1 if -(-S // ops.SPLIT) <= L else 2)
    assert _smem(ops.MAX_GROUP, dh, item, L, stages) <= MAX_SMEM
    src = (Path(ops.__file__).parent / "csrc" / "decode_split.cuh"
           ).read_text()
    for name, want in (("kSplit", ops.SPLIT),
                       ("kMaxTileRows", ops.MAX_TILE_ROWS),
                       ("kTileBytes", ops.TILE_BYTES)):
        assert f"constexpr int {name} = {want};" in src


def test_paged_plan_at_the_main_path_shape():
    """smollm-135m's pool (bs 128, T 4, dh 64): one tile of 32 rows per
    block in f32 and int8 alike, 16 x 3 x 4 = 192 blocks at slots 4, and
    33,888 bytes of shared memory in f32."""
    assert ops.dense_plan(4 * 128, 64, 4) == ops.dense_plan(4 * 128, 64, 1) \
        == (32, 1)
    assert _smem(3, 64, 4, 32, 1) == 33888


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("item", [1, 2, 4])
def test_paged_plan_at_opt_shapes(dh, item):
    """OPT's pool at the engine's max_seq 2048 (bs 128, T 16): one query
    head per kv head fits a block's shared memory at every pool item
    size, with 16 x 32 blocks per slot (dh 64: opt-1.3b; dh 128:
    opt-6.7b)."""
    L, stages = ops.dense_plan(16 * 128, dh, item)
    assert 1 <= L <= ops.MAX_TILE_ROWS and stages == 2
    assert _smem(1, dh, item, L, stages) <= MAX_SMEM


class _Plan:
    def __init__(self, attn, arch="test"):
        self.attn, self.arch = attn, arch


@pytest.mark.parametrize("heads,bs,want", [
    ((9, 3, 64), 128, "stream"),        # smollm-135m
    ((6, 2, 32), 16, "stream"),         # its reduced form
    ((9, 3, 64), 512, "gather"),        # block beyond the kernel's tile
    ((36, 2, 64), 16, "gather"),        # 18 query heads per kv head
    ((4, 1, 512), 16, "gather"),        # d_head beyond 256
    ((32, 32, 64), 128, "stream"),      # opt-1.3b: one query head per kv
    ((32, 32, 128), 128, "stream"),     # opt-6.7b
])
def test_resolve_paged_kernel(heads, bs, want):
    plan = _Plan(plan_attention(*heads, 1))
    assert ops.resolve_paged_kernel(plan, bs, "auto") == want
    assert ops.resolve_paged_kernel(plan, bs, "gather") == "gather"
    if want == "gather":
        with pytest.raises(ValueError):
            ops.resolve_paged_kernel(plan, bs, "stream")
    with pytest.raises(ValueError):
        ops.resolve_paged_kernel(plan, bs, "bogus")
