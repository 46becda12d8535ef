"""The port's paged decode attention (plain version, as its wrapper runs
it on CPU tensors) against the JAX reference's kernel 1 in interpret
mode and its oracle, plus the null-block property on the port itself."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.decode_attention import \
    paged_decode_attention_pallas
from repro.kernels.decode_attention.ops import \
    paged_decode_attention as jax_paged_decode_attention
from repro.kernels.decode_attention.ref import \
    paged_decode_attention_ref as jax_paged_ref
from repro_torch.compiler.plan import plan_attention
from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import (gather_kv_pages,
                                                      paged_decode_attention_ref)

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
    rows = np.ones(len(lengths), bool)
    if not fold:
        # a row with nothing to attend: the port returns zeros, the
        # reference the mean of every gathered V row (logged as a
        # disagreement in ROADMAP.md queue 3)
        empty = lengths == 0
        assert (mine[empty] == 0).all()
        rows = ~empty
    np.testing.assert_allclose(mine[rows], ref[rows], rtol=tol, atol=tol)


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
    a, tables, lengths = _inputs(3, 4, 2, 32, 8, 4, 13)
    with_fold = _port(a, tables, lengths, True, torch.float32)
    np.testing.assert_allclose(with_fold[0].reshape(2, 2, 32),
                               np.repeat(a["vn"][0][:, None], 2, 1),
                               rtol=1e-6)
    assert (_port(a, tables, lengths, False, torch.float32)[0] == 0).all()


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
    assert np.isfinite(scribbled).all()
    np.testing.assert_array_equal(base, scribbled)


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


class _Plan:
    def __init__(self, attn, arch="test"):
        self.attn, self.arch = attn, arch


@pytest.mark.parametrize("heads,bs,want", [
    ((9, 3, 64), 128, "stream"),        # smollm-135m
    ((6, 2, 32), 16, "stream"),         # its reduced form
    ((9, 3, 64), 512, "gather"),        # block beyond the kernel's tile
    ((36, 2, 64), 16, "gather"),        # 18 query heads per kv head
    ((4, 1, 512), 16, "gather"),        # d_head beyond 256
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
