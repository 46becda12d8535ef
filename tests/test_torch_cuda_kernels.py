"""The port's CUDA kernels against their plain versions on the card:
paged decode attention (fp, int8 and fp8 pools), dense decode attention,
the decode GEMV, one streamlined decode layer with kernels vs plain, the
WKV recurrence and the selective scan (both entries).

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      paged_decode_attention_ref)
from repro_torch.kernels.gemv import ops as gemv_ops
from repro_torch.kernels.gemv.ref import gemv_ref
from repro_torch.kernels.mamba_scan import ops as mamba_ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)
from repro_torch.kernels.rwkv_scan import ops as rwkv_ops
from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
from repro_torch.serving.kv_cache import quantize_kv_rows

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, torch.float16: 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU form)")
    return torch.device("cuda")


def _inputs(dev, B, H, G, dh, bs, T, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    N = B * T + 1
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    lengths = torch.randint(0, T * bs + 1, (B,), generator=g, device=dev)
    lengths[0] = 0
    tables = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b in range(B):
        used = -(-int(lengths[b]) // bs)
        tables[b, :used] = torch.arange(1 + b * T, 1 + b * T + used)
    return (r(B, H, dh).to(dtype), r(N, bs, G, dh).to(dtype),
            r(N, bs, G, dh).to(dtype), tables, lengths.to(torch.int32),
            r(B, G, dh).to(dtype), r(B, G, dh).to(dtype))


@pytest.mark.parametrize("shape", [(4, 9, 3, 64, 128, 4), (3, 4, 2, 32, 8, 5),
                                   (2, 16, 2, 128, 64, 3),
                                   (2, 8, 8, 256, 16, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("fold", [False, True])
def test_paged_kernel_matches_plain(dev, shape, dtype, fold):
    q, kp, vp, tb, ln, kn, vn = _inputs(dev, *shape, dtype)
    extra = dict(k_new=kn, v_new=vn) if fold else {}
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, tb, ln, **extra)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(q, kp, vp, tb, ln, **extra)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_paged_kernel_refuses_what_it_cannot_run(dev):
    q, kp, vp, tb, ln, kn, vn = _inputs(dev, 2, 4, 2, 32, 8, 3,
                                        torch.float32)
    with pytest.raises(ValueError):       # scales only with an int8/fp8 pool
        ops.paged_decode_attention(q, kp, vp, tb, ln,
                                   k_scale=kp[..., 0], v_scale=vp[..., 0])
    with pytest.raises(ValueError):       # an int8 pool needs its scales
        ops.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                   tb, ln)
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp, vp, tb.long(), ln)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp.transpose(1, 2).contiguous()
                                   .transpose(1, 2), vp, tb, ln)


@pytest.mark.parametrize("qdt", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("shape", [(4, 9, 3, 64, 128, 4), (3, 4, 2, 32, 8, 5)])
@pytest.mark.parametrize("fold", [False, True])
def test_quantized_pool_matches_plain(dev, qdt, shape, fold):
    q, kp, vp, tb, ln, kn, vn = _inputs(dev, *shape, torch.float32)
    kq, ks = quantize_kv_rows(kp, qdt, torch.float16)
    vq, vs = quantize_kv_rows(vp, qdt, torch.float16)
    extra = dict(k_new=kn, v_new=vn) if fold else {}
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kq, vq, tb, ln, k_scale=ks,
                                     v_scale=vs, **extra)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(q, kq, vq, tb, ln, k_scale=ks,
                                      v_scale=vs, **extra)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# kernel 1's split (csrc/decode_split.cuh) at its edges: bs 16, T 5, so
# S = 80 and a full row's shares of 5 positions cross pool blocks
SPLIT_BS, SPLIT_T = 16, 5
SPLIT_LENGTHS = (0, 1, 15, 16, 17, SPLIT_BS - 1, SPLIT_BS, SPLIT_BS + 1,
                 SPLIT_T * SPLIT_BS)
POOL_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int8,
               torch.float8_e4m3fn]


def _split_case(dev, pool_dtype, seed=8, H=9, G=3, dh=64):
    """Kernel 1's inputs at the split's edge lengths, each row's blocks
    drawn out of order from a shuffled pool, table tails on the null
    block 0; an int8 / fp8 pool is quantized from an f32 one (q stays
    f32).  -> (q, kp, vp, tables, lengths, kn, vn, scales)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, bs, T = len(SPLIT_LENGTHS), SPLIT_BS, SPLIT_T
    N = B * T + 1
    quant = pool_dtype in (torch.int8, torch.float8_e4m3fn)
    qdt = torch.float32 if quant else pool_dtype
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    tables = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b, n in enumerate(SPLIT_LENGTHS):
        used = -(-n // bs)
        tables[b, :used] = perm[b * T:b * T + used]
    kp, vp = r(N, bs, G, dh), r(N, bs, G, dh)
    scales = {}
    if quant:
        kp, ks = quantize_kv_rows(kp, pool_dtype, torch.float16)
        vp, vs = quantize_kv_rows(vp, pool_dtype, torch.float16)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32, device=dev)
    return (r(B, H, dh).to(qdt), kp, vp, tables, lengths,
            r(B, G, dh).to(qdt), r(B, G, dh).to(qdt), scales)


@pytest.mark.parametrize("pool_dtype", POOL_DTYPES)
@pytest.mark.parametrize("fold", [False, True])
def test_paged_kernel_split_boundaries(dev, pool_dtype, fold):
    """Lengths 0, 1, 15, 16, 17, bs - 1, bs, bs + 1 and T*bs, shares
    that cross pool blocks of tables out of order: within tolerance of
    the plain version; each row alone bit-equal to its row in the batch;
    the length-0 row the mean of its table's V rows (v_new with the
    fold); the null block inert under extreme fills."""
    q, kp, vp, tb, ln, kn, vn, sc = _split_case(dev, pool_dtype)
    extra = dict(k_new=kn, v_new=vn) if fold else {}
    before = ops.paged_decode_attention.launches
    got = ops.paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
    torch.cuda.synchronize()
    assert ops.paged_decode_attention.launches == before + 1
    want = paged_decode_attention_ref(q, kp, vp, tb, ln, **sc, **extra)
    tol = TOL.get(pool_dtype, 1e-4)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    B, H, dh = q.shape
    G = kp.shape[2]
    for b in range(B):
        one = {k: v[b:b + 1] for k, v in extra.items()}
        alone = ops.paged_decode_attention(q[b:b + 1], kp, vp, tb[b:b + 1],
                                           ln[b:b + 1], **sc, **one)
        assert torch.equal(alone[0], got[b])
    if fold:
        row0 = vn[0].float()[:, None].expand(-1, H // G, -1)
    else:
        v0 = vp[tb[0].long()].float()                     # (T, bs, G, dh)
        if sc:
            v0 = v0 * sc["v_scale"][tb[0].long()].float()[..., None]
        row0 = v0.reshape(-1, G, dh).mean(0)[:, None].expand(-1, H // G, -1)
    torch.testing.assert_close(got[0].float().reshape(G, H // G, dh), row0,
                               rtol=tol, atol=tol)
    # the null block scribbled: no row that attends something changes
    for fill in (1e30, -1e30):
        kz, vz = kp.clone(), vp.clone()
        scz = {k: v.clone() for k, v in sc.items()}
        if sc:      # the largest stored values and scales
            big = 127.0 if pool_dtype == torch.int8 else 448.0
            for v in scz.values():
                v[0] = 65504.0 if fill > 0 else -65504.0
        else:
            big = min(abs(fill), torch.finfo(pool_dtype).max)
        for t, val in ((kz, big if fill > 0 else -big), (vz, -big)):
            t[0] = torch.full(t.shape[1:], val, device=dev).to(pool_dtype)
        out = ops.paged_decode_attention(q, kz, vz, tb, ln, **scz, **extra)
        keep = (ln > 0) | fold
        assert torch.isfinite(out).all()
        assert torch.equal(out[keep], got[keep])


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8,
                                        torch.float8_e4m3fn])
@pytest.mark.parametrize("fold", [False, True])
def test_paged_kernel_propagates_a_nan_row(dev, pool_dtype, fold):
    """One NaN row in two tables (the length-17 row's last position in
    K, the full row's position 33 in V): a NaN K/V value of an f32 pool,
    a NaN scale of an int8 pool, NaN codes of an fp8 pool.  Every head
    of the two rows that attend it is NaN, as the reference's Pallas
    kernel gives (its ``jnp.maximum`` keeps a NaN), so the engine's
    finite-logits guard sees a corrupted block; every other row is
    bit-equal to its output without the NaN."""
    q, kp, vp, tb, ln, kn, vn, sc = _split_case(dev, pool_dtype)
    extra = dict(k_new=kn, v_new=vn) if fold else {}
    clean = ops.paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
    hit = {4: (16, "k"), len(SPLIT_LENGTHS) - 1: (33, "v")}
    for b, (pos, which) in hit.items():
        assert pos < SPLIT_LENGTHS[b]
        blk = int(tb[b, pos // SPLIT_BS])
        if pool_dtype == torch.int8:
            t = sc["k_scale" if which == "k" else "v_scale"]
        else:
            t = kp if which == "k" else vp
        t[blk, pos % SPLIT_BS] = torch.tensor(float("nan"),
                                              device=dev).to(t.dtype)
    got = ops.paged_decode_attention(q, kp, vp, tb, ln, **sc, **extra)
    torch.cuda.synchronize()
    for b in range(len(SPLIT_LENGTHS)):
        if b in hit:
            assert torch.isnan(got[b]).all()
        else:
            assert torch.equal(got[b], clean[b])


# kernel 1 as speculative verify calls it: slots x (K+1) single-token
# queries, each slot's table repeated K+1 times, lengths pos+1 .. pos+K+1
VERIFY_POS = (72, 295, 506, 0)


def _verify_case(dev, pool_dtype, positions=VERIFY_POS, K1=5, H=9, G=3,
                 dh=64, bs=128, T=4, seed=9):
    """(q, kp, vp, tables, lengths, scales) of one verify window: slot b's
    blocks drawn out of order from a shuffled pool, its table tail on
    the null block; an int8 / fp8 pool quantized from an f32 one."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(positions)
    N = B * T + 1
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    perm = torch.randperm(N - 1, generator=g, device=dev) + 1
    slot_tables = torch.zeros((B, T), dtype=torch.int32, device=dev)
    for b, p in enumerate(positions):
        used = -(-(p + K1) // bs)
        slot_tables[b, :used] = perm[b * T:b * T + used]
    kp, vp = r(N, bs, G, dh), r(N, bs, G, dh)
    scales = {}
    if pool_dtype in (torch.int8, torch.float8_e4m3fn):
        kp, ks = quantize_kv_rows(kp, pool_dtype, torch.float16)
        vp, vs = quantize_kv_rows(vp, pool_dtype, torch.float16)
        scales = dict(k_scale=ks, v_scale=vs)
    tables = slot_tables.repeat_interleave(K1, 0).contiguous()
    lengths = (torch.tensor(positions, device=dev)[:, None] + 1
               + torch.arange(K1, device=dev)).reshape(-1).to(torch.int32)
    return r(B * K1, H, dh), kp, vp, tables, lengths, scales


@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.int8,
                                        torch.float8_e4m3fn])
@pytest.mark.parametrize("shape", [dict(), dict(K1=3, H=4, G=2, dh=32, bs=8,
                                                T=5, positions=(5, 30, 0))])
def test_paged_kernel_at_the_verify_shape(dev, pool_dtype, shape):
    """Q = slots x (K+1) queries with per-query tables: the kernel within
    1e-4 of its plain version, and each query alone bit-identical to its
    row in the batch."""
    q, kp, vp, tb, ln, sc = _verify_case(dev, pool_dtype, **shape)
    got = ops.paged_decode_attention(q, kp, vp, tb, ln, **sc)
    want = paged_decode_attention_ref(q, kp, vp, tb, ln, **sc)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    for i in range(q.shape[0]):
        alone = ops.paged_decode_attention(q[i:i + 1], kp, vp, tb[i:i + 1],
                                           ln[i:i + 1], **sc)
        assert torch.equal(alone[0], got[i]), i


@pytest.mark.parametrize("kv_dtype", ["auto", "int8", "fp8"])
def test_engine_speculation_on_the_card(dev, kv_dtype):
    """The reduced smollm-135m served on the card with n-gram speculation
    on an f32 / int8 / fp8 pool: streams equal the plain run's and the
    gather oracle's, kernel 1 launched once per layer per decode step
    and per verify round, the pool balanced."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = model.init(seed=0)
    motif = [3, 1, 4, 1]
    prompts = [motif * 6, motif * 5, [7, 9, 11]]
    kw = dict(slots=2, max_seq=128, block_size=16, kv_dtype=kv_dtype)
    outs = {}
    for name, extra in (("plain", {}),
                        ("spec", dict(speculate="ngram", draft_k=4)),
                        ("gather", dict(speculate="ngram", draft_k=4,
                                        paged_kernel="gather"))):
        eng = LPUEngine(model, params, EngineConfig(**kw, **extra),
                        device=dev)
        before = ops.paged_decode_attention.launches
        outs[name] = eng.generate(prompts, max_new_tokens=12)
        launches = ops.paged_decode_attention.launches - before
        st = eng.stats
        want = 0 if name == "gather" else \
            cfg.n_layers * (st.device_decode_steps + st.spec_rounds)
        assert launches == want, (name, launches, want)
        eng.check_pool_balanced()
        if name == "spec":
            assert st.spec_rounds > 0 and st.accepted_tokens > 0
    assert outs["spec"] == outs["plain"] == outs["gather"]


@pytest.mark.parametrize("kv_dtype", ["auto", "int8", "fp8"])
def test_engine_corrupt_block_on_the_card(dev, kv_dtype):
    """A two-ring fleet of the reduced smollm-135m on the card with a
    pool block corrupted in place (NaN in every floating pool tensor:
    f32 K/V, int8 scales, fp8 codes and scales): the guard raises
    ``nan_logits`` through kernel 1, the ring is rebuilt with its cache
    zeroed in place, and the streams equal the fault-free fleet's."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import MultiRingEngine
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = model.init(seed=0)
    prompts = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11]]
    kw = dict(slots=2, max_seq=64, block_size=16, kv_dtype=kv_dtype,
              heartbeat_timeout_s=4.0)
    outs = {}
    for chaos in ("", "corrupt@4"):
        fleet = MultiRingEngine(model, params, None, rings=2, device=dev,
                                config=EngineConfig(**kw, chaos=chaos))
        outs[chaos] = fleet.generate(prompts, max_new_tokens=8)
        for eng in fleet.engines:
            eng.check_pool_balanced()
            for c in eng.cache.values():
                for t in c.values():
                    if t.is_floating_point():
                        assert torch.isfinite(t.float()).all()
    failed = [e for e in fleet.events if e.kind == "ring_failed"]
    assert [e.detail["reason"] for e in failed] == ["nan_logits"]
    assert outs["corrupt@4"] == outs[""]


@pytest.mark.parametrize("shape", [(4, 9, 3, 64, 512), (3, 4, 2, 32, 100),
                                   (2, 16, 2, 128, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dense_kernel_matches_plain(dev, shape, dtype):
    B, H, G, dh, S = shape
    g = torch.Generator(device=dev).manual_seed(1)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    q, k, v = r(B, H, dh), r(B, S, G, dh), r(B, S, G, dh)
    ln = torch.randint(1, S + 1, (B,), generator=g, device=dev)
    ln[0] = 0
    ln = ln.to(torch.int32)
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    want = decode_attention_ref(q, k, v, ln)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    # a cache broadcast over the batch is read in place
    kb, vb = k[:1].expand(B, -1, -1, -1), v[:1].expand(B, -1, -1, -1)
    torch.testing.assert_close(
        ops.decode_attention(q, kb, vb, ln).float(),
        decode_attention_ref(q, kb, vb, ln).float(), rtol=TOL[dtype],
        atol=TOL[dtype])


def _dense_case(dev, B, H, G, dh, S, dtype, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    return r(B, H, dh), r(B, S, G, dh), r(B, S, G, dh)


@pytest.mark.parametrize("S", [5, 15, 512, 1030])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_dense_kernel_split_boundaries(dev, S, dtype):
    """Lengths on the split's share and tile boundaries (0, 1, L, L+1,
    SPLIT*L, S) at S below the cluster's 16 blocks, the chain's S and an
    S whose shares take two tiles; each row computed alone equals its
    row inside the batch bit for bit."""
    L, _ = ops.dense_plan(S, 64, torch.tensor([], dtype=dtype).element_size())
    lens = [min(n, S) for n in (0, 1, L, L + 1, ops.SPLIT * L, S)]
    q, k, v = _dense_case(dev, len(lens), 9, 3, 64, S, dtype)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = ops.decode_attention(q, k, v, ln)
    torch.cuda.synchronize()
    want = decode_attention_ref(q, k, v, ln)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    for b in range(len(lens)):
        alone = ops.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                     ln[b:b + 1])
        assert torch.equal(alone[0], got[b])
    assert torch.equal(ops.decode_attention(q, k, v, ln), got)


def test_dense_kernel_broadcast_cache_at_the_chunk_shape(dev):
    """The chunked prefill's call: C = 64 queries over one request's
    cache broadcast over the batch (stride 0), lengths start + i + 1."""
    C, S, start = 64, 512, 300
    q, k, v = _dense_case(dev, C, 9, 3, 64, S, torch.float32)
    kb, vb = k[:1].expand(C, -1, -1, -1), v[:1].expand(C, -1, -1, -1)
    ln = torch.arange(start + 1, start + C + 1, dtype=torch.int32,
                      device=dev)
    before = ops.decode_attention.launches
    got = ops.decode_attention(q, kb, vb, ln)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == before + 1
    torch.testing.assert_close(got, decode_attention_ref(q, kb, vb, ln),
                               rtol=1e-4, atol=1e-4)
    for i in (0, 17, C - 1):
        assert torch.equal(ops.decode_attention(q[i:i + 1], kb[:1], vb[:1],
                                                ln[i:i + 1])[0], got[i])


@pytest.mark.parametrize("KN", [(5, 576), (100, 37), (1000, 33), (33, 1),
                                (1500, 4224), (576, 3071)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16,
                                 torch.float16, torch.int8])
def test_gemv_kernel_plan_edges(dev, KN, wdt):
    """K below one stage and not a multiple of it, odd N and N = 1, a
    split wider than one x chunk (K 1500 on 132 column tiles), int8 with
    bias; rows 1 / 4 / 64 agree bit for bit."""
    K, N = KN
    g = torch.Generator(device=dev).manual_seed(7)
    xdt = torch.float32 if wdt == torch.int8 else wdt
    x = torch.randn((64, K), generator=g, device=dev).to(xdt)
    w = torch.randn((K, N), generator=g, device=dev) / K ** 0.5
    b = torch.randn((N,), generator=g, device=dev).to(xdt)
    scale = None
    if wdt == torch.int8:
        w, scale = gemv_ops.quantize_weight(w)
    else:
        w = w.to(wdt)
    got = gemv_ops.gemv(x, w, b, w_scale=scale)
    torch.cuda.synchronize()
    tol = 1e-4 if xdt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(),
                               gemv_ref(x, w, b, w_scale=scale).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(gemv_ops.gemv(x[:4], w, b, w_scale=scale), got[:4])
    assert torch.equal(gemv_ops.gemv(x[5:6], w, b, w_scale=scale)[0], got[5])


@pytest.mark.parametrize("KN", [(576, 960), (576, 576), (576, 3072),
                                (1536, 576), (100, 37)])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("bias", [False, True])
def test_gemv_kernel_matches_plain(dev, KN, wdt, bias):
    K, N = KN
    g = torch.Generator(device=dev).manual_seed(2)
    xdt = torch.float32 if wdt == torch.int8 else wdt
    x = torch.randn((64, K), generator=g, device=dev).to(xdt)
    w = torch.randn((K, N), generator=g, device=dev)
    b = torch.randn((N,), generator=g, device=dev).to(xdt) if bias else None
    scale = None
    if wdt == torch.int8:
        w, scale = gemv_ops.quantize_weight(w)
    else:
        w = w.to(wdt)
    before = gemv_ops.gemv.launches
    got = gemv_ops.gemv(x[:4], w, b, w_scale=scale)
    torch.cuda.synchronize()
    assert gemv_ops.gemv.launches == before + 1
    tol = 1e-4 if xdt == torch.float32 else 3e-2
    want = gemv_ref(x[:4], w, b, w_scale=scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    # row b does not depend on the call's row count: bit for bit
    for i in range(4):
        assert torch.equal(gemv_ops.gemv(x[i:i + 1], w, b, w_scale=scale)[0],
                           got[i])
    assert torch.equal(gemv_ops.gemv(x, w, b, w_scale=scale)[:4], got)
    assert torch.equal(gemv_ops.gemv(x[:4], w, b, w_scale=scale), got)


def test_decode_layer_kernels_match_plain(dev):
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core import streamline as sl
    from repro_torch.models.common import init_params
    from repro_torch.models.transformer import layer_params
    cfg = get_config("smollm-135m")
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    p = layer_params(init_params(cfg, plan, seed=0, device=dev), 0)["l0"]
    a = plan.attn
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((4, cfg.d_model), generator=g, device=dev)
    pool = torch.randn((17, 128, a.gp, a.d_head), generator=g, device=dev)
    tables = torch.arange(1, 17, dtype=torch.int32, device=dev).reshape(4, 4)
    pos = torch.tensor([0, 77, 300, 510], dtype=torch.int32, device=dev)
    outs = {}
    for use in (True, False):
        cache = {"k": pool.clone(), "v": pool.clone() * 0.5}
        outs[use], _ = sl.decode_layer(p, x, cache, pos, cfg=cfg, plan=plan,
                                       use_kernels=use, block_table=tables,
                                       paged_kernel="stream")
    torch.testing.assert_close(outs[True], outs[False], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 16, 1, 8), (2, 64, 2, 16),
                                   (2, 32, 4, 32), (4, 1, 64, 64),
                                   (1, 37, 3, 64), (2, 5, 2, 100),
                                   (1, 3, 2, 128)])
def test_rwkv_scan_kernel_matches_plain(dev, shape):
    """Kernel 4 against its plain version: the reference test's shapes,
    the decode shape, an odd S, and dh off the template widths."""
    B, S, H, dh = shape
    g = torch.Generator(device=dev).manual_seed(4)
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    w = 0.8 + 0.199 * torch.rand((B, S, H, dh), generator=g, device=dev)
    args = (r(B, S, H, dh), 0.3 * r(B, S, H, dh), r(B, S, H, dh), w,
            0.2 * r(H, dh), 0.1 * r(B, H, dh, dh))
    before = rwkv_ops.rwkv_scan.launches
    y, s = rwkv_ops.rwkv_scan(*args)
    torch.cuda.synchronize()
    assert rwkv_ops.rwkv_scan.launches == before + 1
    yr, sr = rwkv_scan_ref(*args)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s, sr, rtol=1e-4, atol=1e-4)
    # the plain version repeats the kernel's order of rounding: same bits
    assert torch.equal(y, yr) and torch.equal(s, sr)
    # deterministic: a second launch gives the same bits
    y2, s2 = rwkv_ops.rwkv_scan(*args)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.parametrize("dh", [32, 33, 64, 100, 128])
@pytest.mark.parametrize("BH", [(1, 1), (1, 7), (4, 16), (4, 64)])
@pytest.mark.parametrize("S", [1, 5])
def test_rwkv_scan_kernel_bit_equal_across_widths(dev, dh, BH, S):
    """Kernel 4's column blocks at dh 32, 64, 100 and 128 (and 33, off
    the 16-byte copies) and B*H from 1 to 256: bit-equal to its plain
    version."""
    B, H = BH
    g = torch.Generator(device=dev).manual_seed(dh + 7 * H)
    r = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    w = 0.8 + 0.199 * torch.rand((B, S, H, dh), generator=g, device=dev)
    args = (r(B, S, H, dh), 0.3 * r(B, S, H, dh), r(B, S, H, dh), w,
            0.2 * r(H, dh), 0.1 * r(B, H, dh, dh))
    y, s = rwkv_ops.rwkv_scan(*args)
    yr, sr = rwkv_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(s, sr)


def test_rwkv_scan_kernel_refuses_what_it_cannot_run(dev):
    args = [torch.zeros(shape, device=dev) for shape in
            ((1, 2, 1, 8),) * 4 + ((1, 8), (1, 1, 8, 8))]
    with pytest.raises(TypeError):
        rwkv_ops.rwkv_scan(*[a.double() for a in args])
    with pytest.raises(ValueError):
        rwkv_ops.rwkv_scan(torch.zeros((1, 8, 1, 2), device=dev)
                           .permute(0, 3, 2, 1), *args[1:])
    with pytest.raises(ValueError):
        rwkv_ops.rwkv_scan(*args[:5], torch.zeros((1, 1, 8, 4), device=dev))
    big = [torch.zeros((1, 1, 1, 129), device=dev)] * 4
    with pytest.raises(ValueError):
        rwkv_ops.rwkv_scan(*big, torch.zeros((1, 129), device=dev),
                           torch.zeros((1, 1, 129, 129), device=dev))


def _mamba_inputs(dev, B, S, C, N, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    da = torch.exp(-torch.rand((B, S, C, N), generator=g, device=dev))
    return (da, 0.1 * torch.randn((B, S, C, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (1, 64, 128, 16),
                                   (4, 1, 8192, 16), (1, 64, 8192, 16),
                                   (2, 37, 200, 16), (1, 5, 100, 6),
                                   (2, 3, 130, 33), (1, 70, 64, 64)])
def test_mamba_scan_kernel_matches_plain(dev, shape):
    """Kernel 5 against its plain version: the reference test's shapes,
    the engine's decode and prefill shapes of jamba, an odd S and C
    (ragged last block, more than one cc chunk), N off the float4 path
    and off the template widths."""
    args = _mamba_inputs(dev, *shape)
    before = mamba_ops.mamba_scan.launches
    y, h = mamba_ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert mamba_ops.mamba_scan.launches == before + 1
    yr, hr = mamba_scan_ref(*args)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hr, rtol=1e-4, atol=1e-4)
    # the plain version repeats the kernel's order of rounding: same bits
    assert torch.equal(y, yr) and torch.equal(h, hr)
    y2, h2 = mamba_ops.mamba_scan(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_mamba_scan_kernel_refuses_what_it_cannot_run(dev):
    args = _mamba_inputs(dev, 1, 2, 8, 4)
    with pytest.raises(TypeError):
        mamba_ops.mamba_scan(*[a.double() for a in args])
    with pytest.raises(ValueError):
        mamba_ops.mamba_scan(args[0].transpose(1, 2).contiguous()
                             .transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        mamba_ops.mamba_scan(*args[:3], torch.zeros((1, 8, 5), device=dev))
    big = _mamba_inputs(dev, 1, 2, 8, 65)
    with pytest.raises(ValueError, match="d_state"):
        mamba_ops.mamba_scan(*big)


# kernel 5's two entries at chip_smoke.MAMBA_CHECK_SHAPES and at ragged
# shapes: N in {1, 5, 16, 64} (one to eight lanes, a ragged lane group), C
# below and off a block's channels, S off the chunk (several ring refills)
MAMBA_SHAPES = [(1, 32, 8, 8), (2, 128, 16, 16), (2, 64, 32, 8),
                (4, 1, 8192, 16), (1, 64, 8192, 16), (1, 512, 8192, 16),
                (1, 33, 20, 1), (2, 70, 45, 5), (1, 37, 100, 16),
                (2, 9, 19, 64), (3, 65, 130, 33), (1, 1, 7, 3),
                (1, 100, 40, 64)]


def _fused_inputs(dev, B, S, C, N, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, C), generator=g, device=dev) - 2.0)
    a = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev).float())
                   + 0.1 * torch.randn((C, N), generator=g, device=dev))
    return (dt, torch.randn((B, S, C), generator=g, device=dev), a,
            torch.randn((B, S, N), generator=g, device=dev),
            torch.randn((B, S, N), generator=g, device=dev),
            0.1 * torch.randn((B, C, N), generator=g, device=dev))


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_mamba_scan_fused_kernel_matches_plain(dev, shape):
    """Entry (b) against its plain version, bit for bit: the kernel's
    expf is the CUDA math library's, which torch.exp runs too."""
    args = _fused_inputs(dev, *shape)
    before = (mamba_ops.mamba_scan.launches,
              mamba_ops.mamba_scan_fused.launches)
    y, h = mamba_ops.mamba_scan_fused(*args)
    torch.cuda.synchronize()
    assert (mamba_ops.mamba_scan.launches,
            mamba_ops.mamba_scan_fused.launches) == (before[0],
                                                     before[1] + 1)
    yr, hr = mamba_scan_fused_ref(*args)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hr, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    y2, h2 = mamba_ops.mamba_scan_fused(*args)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
def test_mamba_scan_kernel_matches_plain_at_ragged_shapes(dev, shape):
    """Entry (a) at the same shapes, bit for bit, one launch a call."""
    args = _mamba_inputs(dev, *shape, seed=7)
    before = mamba_ops.mamba_scan.launches
    y, h = mamba_ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert mamba_ops.mamba_scan.launches == before + 1
    yr, hr = mamba_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_mamba_scan_fused_kernel_refuses_what_it_cannot_run(dev):
    args = _fused_inputs(dev, 1, 2, 8, 4)
    with pytest.raises(TypeError):
        mamba_ops.mamba_scan_fused(*[t.double() for t in args])
    with pytest.raises(ValueError):
        mamba_ops.mamba_scan_fused(args[0].transpose(1, 2).contiguous()
                                   .transpose(1, 2), *args[1:])
    with pytest.raises(ValueError):
        mamba_ops.mamba_scan_fused(*args[:5],
                                   torch.zeros((1, 8, 5), device=dev))
    with pytest.raises(ValueError):
        mamba_ops.mamba_scan_fused(*args[:2], args[2].cpu(), *args[3:])
    big = _fused_inputs(dev, 1, 2, 8, 65)
    with pytest.raises(ValueError, match="d_state"):
        mamba_ops.mamba_scan_fused(*big)
