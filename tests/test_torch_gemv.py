"""The port's decode GEMV (plain version, as its wrapper runs it on CPU
tensors) against the JAX reference's kernel 3 in interpret mode and its
oracle, the port's int8 weight quantizer against the reference's, and
the kernel's plan (`gemv_plan`)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gemv.gemv import gemv_pallas
from repro.kernels.gemv.ops import quantize_weight as jax_quantize_weight
from repro.kernels.gemv.ref import gemv_ref as jax_gemv_ref
from repro_torch.kernels.gemv import ops
from repro_torch.kernels.gemv.ref import gemv_ref

# tests/test_kernels.py's tolerances
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
# (B, K, N): 128-aligned, as the reference's TPU tiles need
SHAPES = [(1, 128, 128), (4, 256, 384), (3, 384, 256)]


def _inputs(B, K, N, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((B, K)).astype(np.float32),
            r.standard_normal((K, N)).astype(np.float32),
            r.standard_normal((N,)).astype(np.float32))


def _jax(x, w, b, dtype, oracle, w_scale=None):
    jx = jnp.asarray(x).astype(dtype)
    jw = jnp.asarray(w) if w.dtype == np.int8 else \
        jnp.asarray(w).astype(dtype)
    jb = None if b is None else jnp.asarray(b).astype(dtype)
    js = None if w_scale is None else jnp.asarray(w_scale)
    if oracle:
        out = jax_gemv_ref(jx, jw, jb, w_scale=js)
    else:
        out = gemv_pallas(jx, jw, jb, w_scale=js, block_k=128, block_n=128,
                          interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("oracle", [False, True], ids=["pallas", "ref"])
def test_matches_reference_kernel_and_oracle(shape, dtype, bias, oracle):
    x, w, b = _inputs(*shape)
    b = b if bias else None
    tdt = getattr(torch, dtype)
    mine = ops.gemv(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                    None if b is None else torch.from_numpy(b).to(tdt))
    assert mine.dtype == tdt
    want = _jax(x, w, b, getattr(jnp, dtype), oracle)
    np.testing.assert_allclose(mine.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("oracle", [False, True], ids=["pallas", "ref"])
def test_int8_weight_matches_reference(shape, bias, oracle):
    x, w, b = _inputs(*shape, seed=3)
    b = b if bias else None
    qw, sc = ops.quantize_weight(torch.from_numpy(w))
    mine = ops.gemv(torch.from_numpy(x), qw,
                    None if b is None else torch.from_numpy(b), w_scale=sc)
    want = _jax(x, qw.numpy(), b, jnp.float32, oracle, w_scale=sc.numpy())
    np.testing.assert_allclose(mine.numpy(), want, **TOL["float32"])


@pytest.mark.parametrize("K,N", [(128, 256), (192, 320), (64, 7)])
def test_quantize_weight_matches_reference(K, N):
    w = np.random.default_rng(K).standard_normal((K, N)).astype(np.float32)
    w[:, 0] = 0.0                         # an all-zero column: scale 0
    q, sc = ops.quantize_weight(torch.from_numpy(w))
    jq, jsc = jax_quantize_weight(jnp.asarray(w))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=0,
                               atol=1e-7)
    assert sc[0] == 0 and (q[:, 0] == 0).all()


def test_cpu_wrapper_takes_the_plain_version():
    x, w, b = (torch.from_numpy(t) for t in _inputs(*SHAPES[1]))
    ops.gemv.launches = 0
    assert torch.equal(ops.gemv(x, w, b), gemv_ref(x, w, b))
    assert ops.gemv.launches == 0


def test_rows_do_not_depend_on_the_batch():
    """Row b of a (B, K) call matches the same row alone.  On the card the
    kernel makes them bit-identical (its split depends on (K, N) only;
    chip_smoke.py and the cuda tests check that); the CPU's BLAS blocks a
    matrix of rows differently from one row, hence the f32 tolerance."""
    x, w, b = (torch.from_numpy(t) for t in _inputs(6, 256, 384))
    full = ops.gemv(x, w, b)
    for i in range(6):
        torch.testing.assert_close(ops.gemv(x[i:i + 1], w, b)[0], full[i],
                                   **TOL["float32"])
    assert all(1 <= ops.gemv_plan(k, n)[0] <= ops.MAX_CLUSTER
               for k, n in [(576, 960), (576, 576), (576, 3072),
                            (1536, 576), (16, 8)])


# the four gemvs of a full-width smollm-135m layer in the C1 chain, and
# the plan's numbers the kernel's source note states for them
CHAIN_SHAPES = {(576, 960): (8, 30), (576, 576): (8, 18),
                (576, 3072): (4, 96), (1536, 576): (8, 18)}
SMS = 132                                  # an H100's streaming processors


@pytest.mark.parametrize("KN", sorted(CHAIN_SHAPES))
def test_plan_fills_the_card_at_the_chain_shapes(KN):
    """At least one block per SM (132) for one row group, within one
    cluster of at most MAX_CLUSTER K splits."""
    ksplit, n_tiles = ops.gemv_plan(*KN)
    assert (ksplit, n_tiles) == CHAIN_SHAPES[KN]
    assert ksplit * n_tiles >= SMS
    assert 1 <= ksplit <= ops.MAX_CLUSTER


@pytest.mark.parametrize("K,N", [(5, 7), (31, 576), (32, 33), (33, 1),
                                 (100, 37), (1536, 1), (576, 8192),
                                 (100000, 3)])
def test_plan_edges(K, N):
    """K below one stage, K not a multiple of the stage, N not a multiple
    of the tile or of 4, N so wide that one split fills the card: every
    split holds at least one weight row, the cluster limit holds, and
    the plan is a function of (K, N) alone."""
    ksplit, n_tiles = ops.gemv_plan(K, N)
    assert n_tiles == -(-N // ops.TILE_N)
    assert 1 <= ksplit <= ops.MAX_CLUSTER
    kc = -(-K // ksplit)                      # rows per split (csrc/gemv.cu)
    assert (ksplit - 1) * kc < K              # no split is empty
    if K <= ops.STAGE_K:
        assert ksplit == 1
    if n_tiles >= ops.TARGET_BLOCKS:
        assert ksplit == 1
    elif K >= ops.MAX_CLUSTER * ops.STAGE_K:
        assert ksplit * n_tiles >= ops.TARGET_BLOCKS or \
            ksplit == ops.MAX_CLUSTER
    assert ops.gemv_plan(K, N) == (ksplit, n_tiles)
