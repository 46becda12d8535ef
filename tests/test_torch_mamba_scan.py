"""Kernel 5 (the selective scan) of the port against the JAX reference.

On CPU tensors the port's dispatch (``kernels/mamba_scan/ops.py``) runs
the plain PyTorch version; it is held against the reference's
``mamba_scan_pallas`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), its ``mamba_scan_ref`` and the
chunked associative scan ``models/mamba.py:_ssm_scan`` that the port's
kernel replaces on the model's path.  Inputs are drawn with numpy and
handed to both packages.  The fused entry's plain version
(``mamba_scan_fused_ref``) is held bit for bit against the jamba model's
former PyTorch producers of da and bx followed by ``mamba_scan_ref``, and
against the reference's kernel fed the reference's own da and bx.  The
kernel's plan (``ops.mamba_plan``) is checked against the constants of
``csrc/mamba_scan.cu``, and a CPU replay of the kernel's staging, lane
split and sum order against the plain versions.  The CUDA kernel itself
is checked on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import mamba_scan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan_ref
from repro.models.mamba import _ssm_scan as jax_ssm_scan
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)

# f32 throughout; only the order of the sums over n differs between the
# packages (and the Pallas kernel's per-step loop)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, C, N, seed=0):
    """The distributions of tests/test_kernels.py::test_mamba_scan."""
    g = np.random.default_rng(seed)
    f = np.float32
    return (g.uniform(0.5, 0.99, (B, S, C, N)).astype(f),
            (0.1 * g.standard_normal((B, S, C, N))).astype(f),
            g.standard_normal((B, S, N)).astype(f),
            (0.1 * g.standard_normal((B, C, N))).astype(f))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **SCAN_TOL)


def _port(args):
    before = ops.mamba_scan.launches
    y, h = ops.mamba_scan(*(torch.from_numpy(a) for a in args))
    assert ops.mamba_scan.launches == before      # CPU: the plain version
    return y, h


# the shapes of tests/test_kernels.py:56-57, and the decode step
PALLAS_SHAPES = [(1, 32, 8, 8), (2, 128, 16, 16), (2, 64, 32, 8),
                 (4, 8, 64, 16)]


@pytest.mark.parametrize("B,S,C,N", PALLAS_SHAPES)
def test_dispatch_matches_reference_kernel(B, S, C, N):
    args = _inputs(B, S, C, N)
    y, h = _port(args)
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, C)
    assert tuple(h.shape) == (B, C, N)
    jargs = [jnp.asarray(a) for a in args]
    block_s = 32 if S % 32 == 0 else S
    yp, hp = mamba_scan_pallas(*jargs, block_s=block_s, block_c=8,
                               interpret=True)
    yr, hr = jax_scan_ref(*jargs)
    for want_y, want_h in ((yp, hp), (yr, hr)):
        _close(y, want_y)
        _close(h, want_h)


# shapes the Pallas kernel refuses (S or C off its tiles) and the S = 1
# decode step: the port's kernel has no such rule, the ref is the oracle
@pytest.mark.parametrize("B,S,C,N", [(4, 1, 24, 16), (1, 5, 12, 8),
                                     (2, 13, 7, 3), (3, 1, 5, 6)])
def test_dispatch_matches_reference_oracle_any_shape(B, S, C, N):
    args = _inputs(B, S, C, N, seed=S)
    y, h = _port(args)
    yr, hr = jax_scan_ref(*(jnp.asarray(a) for a in args))
    _close(y, yr)
    _close(h, hr)


@pytest.mark.parametrize("S", [1, 7, 64, 130])
def test_replaces_the_models_chunked_scan(S):
    """The port runs kernel 5 where the reference's ``mamba_fwd`` runs its
    chunked associative scan (prefill, chunk 128) or its inline step."""
    args = _inputs(2, S, 16, 8, seed=10 + S)
    args = (np.exp(-np.abs(args[0] - 0.5)).astype(np.float32),) + args[1:]
    y, h = _port(args)
    yr, hr = jax_ssm_scan(*(jnp.asarray(a) for a in args))
    _close(y, yr)
    _close(h, hr)


def test_plain_version_sums_left_to_right():
    """The plain version repeats the kernel's rounding order: the same as
    a float64 scan within f32 rounding, and its own step order exactly."""
    args = _inputs(2, 9, 10, 16, seed=3)
    y, h = mamba_scan_ref(*(torch.from_numpy(a) for a in args))
    y64, h64 = mamba_scan_ref(*(torch.from_numpy(a).double() for a in args))
    _close(y, y64.float())
    _close(h, h64.float())
    # two half-length scans chained through the state give the same bits
    first = [torch.from_numpy(a[:, :4]) if a.ndim > 2 and i < 3 else None
             for i, a in enumerate(args)]
    y1, h1 = mamba_scan_ref(first[0], first[1], first[2],
                            torch.from_numpy(args[3]))
    y2, h2 = mamba_scan_ref(*(torch.from_numpy(a[:, 4:]) for a in args[:3]),
                            h1)
    assert torch.equal(torch.cat([y1, y2], 1), y) and torch.equal(h2, h)


def test_dispatch_refuses_other_devices():
    """Only CPU tensors take the plain version; any other device needs
    the kernel, and a device without one raises."""
    args = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 8, 4)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.mamba_scan(*args)


@pytest.mark.parametrize("bad,err,match", [
    (dict(da=torch.float64), TypeError, "float32"),
    (dict(c=torch.float16), TypeError, "float32"),
    (dict(h0=(1, 8, 5)), ValueError, "h0"),
    (dict(bx="strided"), ValueError, "contiguous"),
    (dict(N=65), ValueError, "d_state"),
])
def test_kernel_argument_checks(bad, err, match):
    """What the wrapper checks on a CUDA tensor before it builds or
    launches anything (``ops.check_args``), run here on CPU tensors."""
    N = bad.get("N", 4)
    shapes = {"da": (1, 2, 8, N), "bx": (1, 2, 8, N), "c": (1, 2, N),
              "h0": (1, 8, N)}
    args = []
    for name, shape in shapes.items():
        spec = bad.get(name)
        t = torch.zeros(spec if isinstance(spec, tuple) else shape,
                        dtype=spec if isinstance(spec, torch.dtype)
                        else torch.float32)
        if spec == "strided":
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        args.append(t)
    with pytest.raises(err, match=match):
        ops.check_args(*args)
    assert ops.check_args(*(torch.zeros(s) for s in (
        (2, 3, 8, 16), (2, 3, 8, 16), (2, 3, 16), (2, 8, 16)))) == \
        (2, 3, 8, 16)


# ---------------------------------------------------------------------------
# the fused entry: dt, x, a, b, c, h0 -> the scan of exp(dt*a), (dt*x)*b
# ---------------------------------------------------------------------------

def _fused_inputs(B, S, C, N, seed=0):
    """dt after softplus, x, a = -exp(a_log) with jamba's a_log =
    log(1..N) plus noise, b, c, h0: the model's distributions."""
    g = np.random.default_rng(seed)
    f = np.float32
    dt = np.log1p(np.exp(g.standard_normal((B, S, C)) - 2.0)).astype(f)
    a_log = np.log(np.arange(1, N + 1))[None, :] + \
        0.1 * g.standard_normal((C, N))
    return (dt, g.standard_normal((B, S, C)).astype(f),
            (-np.exp(a_log)).astype(f),
            g.standard_normal((B, S, N)).astype(f),
            g.standard_normal((B, S, N)).astype(f),
            (0.1 * g.standard_normal((B, C, N))).astype(f))


def _model_producers(dt, x, a, b):
    """``models/mamba.py``'s da and bx as the model formed them before the
    fused entry (the same expressions as the reference's mamba.py)."""
    da = torch.exp(dt[..., None] * a)                  # (B,S,d_in,N)
    bx = (dt * x.float())[..., None] * b.float()[:, :, None, :]
    return da.contiguous(), bx.contiguous()


FUSED_SHAPES = [(1, 1, 8, 4), (4, 1, 64, 16), (2, 9, 37, 5), (1, 40, 16, 16),
                (2, 3, 12, 33)]


@pytest.mark.parametrize("B,S,C,N", FUSED_SHAPES)
def test_fused_plain_version_is_the_models_producers_then_the_scan(B, S, C,
                                                                    N):
    """Bit for bit: the model's CPU results are what they were."""
    dt, x, a, b, c, h0 = (torch.from_numpy(t) for t in
                          _fused_inputs(B, S, C, N, seed=S + N))
    da, bx = _model_producers(dt, x, a, b)
    yr, hr = mamba_scan_ref(da, bx, c.contiguous(), h0)
    before = (ops.mamba_scan.launches, ops.mamba_scan_fused.launches)
    y, h = ops.mamba_scan_fused(dt, x, a, b, c, h0)
    assert (ops.mamba_scan.launches, ops.mamba_scan_fused.launches) == \
        before                                    # CPU: the plain version
    assert torch.equal(y, yr) and torch.equal(h, hr)
    y2, h2 = mamba_scan_fused_ref(dt, x, a, b, c, h0)
    assert torch.equal(y2, y) and torch.equal(h2, h)


def _jax_discretize(dt, x, a, b):
    """The reference's da and bx (src/repro/models/mamba.py:161-163)."""
    dt, x, a, b = (jnp.asarray(t) for t in (dt, x, a, b))
    return (jnp.exp(dt[..., None] * a),
            (dt * x)[..., None] * b[:, :, None, :])


@pytest.mark.parametrize("B,S,C,N", [(1, 32, 8, 8), (2, 64, 16, 16),
                                     (2, 128, 32, 8)])
def test_fused_matches_reference_kernel_and_chunked_scan(B, S, C, N):
    """The fused plain version against the reference's Pallas kernel (in
    interpret mode) and its chunked ``_ssm_scan``, both fed the
    reference's own da and bx from the same numpy inputs."""
    args = _fused_inputs(B, S, C, N, seed=B * S)
    y, h = ops.mamba_scan_fused(*(torch.from_numpy(t) for t in args))
    da, bx = _jax_discretize(*args[:4])
    c, h0 = jnp.asarray(args[4]), jnp.asarray(args[5])
    yp, hp = mamba_scan_pallas(da, bx, c, h0, block_s=32, block_c=8,
                               interpret=True)
    ys, hs = jax_ssm_scan(da, bx, c, h0)
    for want_y, want_h in ((yp, hp), (ys, hs)):
        _close(y, want_y)
        _close(h, want_h)


@pytest.mark.parametrize("B,S,C,N", [(4, 1, 24, 16), (1, 5, 12, 8),
                                     (2, 13, 7, 3)])
def test_fused_matches_reference_oracle_any_shape(B, S, C, N):
    args = _fused_inputs(B, S, C, N, seed=7 + S)
    y, h = ops.mamba_scan_fused(*(torch.from_numpy(t) for t in args))
    da, bx = _jax_discretize(*args[:4])
    yr, hr = jax_scan_ref(da, bx, jnp.asarray(args[4]), jnp.asarray(args[5]))
    _close(y, yr)
    _close(h, hr)


def test_fused_dispatch_refuses_other_devices():
    args = [torch.from_numpy(t).to("meta") for t in _fused_inputs(1, 2, 8, 4)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.mamba_scan_fused(*args)


@pytest.mark.parametrize("bad,err,match", [
    (dict(dt=torch.float64), TypeError, "float32"),
    (dict(a=torch.float16), TypeError, "float32"),
    (dict(x=(1, 2, 9)), ValueError, "x"),
    (dict(b=(1, 3, 4)), ValueError, "b"),
    (dict(h0=(1, 8, 5)), ValueError, "h0"),
    (dict(c="strided"), ValueError, "contiguous"),
    (dict(N=65), ValueError, "d_state"),
])
def test_fused_argument_checks(bad, err, match):
    """What the fused entry checks on a CUDA tensor before it builds or
    launches anything (``ops.check_fused_args``), run on CPU tensors."""
    N = bad.get("N", 4)
    shapes = {"dt": (1, 2, 8), "x": (1, 2, 8), "a": (8, N), "b": (1, 2, N),
              "c": (1, 2, N), "h0": (1, 8, N)}
    args = []
    for name, shape in shapes.items():
        spec = bad.get(name)
        t = torch.zeros(spec if isinstance(spec, tuple) else shape,
                        dtype=spec if isinstance(spec, torch.dtype)
                        else torch.float32)
        if spec == "strided":
            t = t.transpose(1, 2).contiguous().transpose(1, 2)
        args.append(t)
    with pytest.raises(err, match=match):
        ops.check_fused_args(*args)
    assert ops.check_fused_args(*(torch.zeros(s) for s in (
        (2, 3, 8), (2, 3, 8), (8, 16), (2, 3, 16), (2, 3, 16),
        (2, 8, 16)))) == (2, 3, 8, 16)


# ---------------------------------------------------------------------------
# the kernel's plan (ops.mamba_plan; make_plan in csrc/mamba_scan.cu)
# ---------------------------------------------------------------------------

MAX_SMEM = 232448     # an H100 block's shared memory


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("shape", [(1, 512, 8192, 16), (4, 1, 8192, 16),
                                   (1, 64, 8192, 16)])
def test_plan_fills_the_card_at_jamba_shapes(shape, fused):
    """At least one block per SM (132) at the decode and prefill shapes:
    4 lanes of 4 states per channel, 32 channels per block of 128."""
    plan = ops.mamba_plan(*shape, fused=fused)
    assert plan["blocks"] >= 132
    assert (plan["lanes"], plan["npl"], plan["channels"]) == (4, 4, 32)
    B, S, C, _ = shape
    assert plan["blocks"] == B * C // 32
    assert plan["chunks"] * plan["chunk"] >= S > \
        (plan["chunks"] - 1) * plan["chunk"]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("N", list(range(1, 65)))
def test_plan_lanes_cover_N_and_fit_shared_memory(N, fused):
    """Every N up to 64: the lanes hold at least N states, half as many
    lanes would not; shared memory stays within a block's limit at any S;
    the ring holds at most STAGES chunks."""
    for S in (1, 2, 31, 32, 33, 64, 512, 4096):
        p = ops.mamba_plan(1, S, 8192, N, fused=fused)
        assert p["lanes"] * p["npl"] >= N
        assert p["lanes"] == 1 or p["lanes"] // 2 * p["npl"] < N
        assert p["lanes"] in (1, 2, 4, 8) and p["channels"] * p["lanes"] \
            == ops.THREADS
        assert 1 <= p["chunk"] <= min(S, ops.MAX_CHUNK)
        assert 1 <= p["stages"] <= ops.STAGES
        assert p["smem_bytes"] <= MAX_SMEM


def test_plan_constants_are_the_kernels():
    src = (Path(ops.__file__).parent / "csrc" / "mamba_scan.cu").read_text()
    for name, want in (("kThreads", ops.THREADS),
                       ("kMaxChunk", ops.MAX_CHUNK),
                       ("kStageFloats", ops.STAGE_FLOATS),
                       ("kRowStageFloats", ops.ROW_STAGE_FLOATS),
                       ("kStages", ops.STAGES),
                       ("kBarrierBytes", ops.BARRIER_BYTES)):
        assert re.search(rf"constexpr int {name} = {want};", src), name
    assert ops.BARRIER_BYTES == 2 * ops.STAGES * 8   # full + empty, 8 B each


# ---------------------------------------------------------------------------
# a CPU replay of the kernel: its staging ring, lane split and sum order
# ---------------------------------------------------------------------------

def _replay(fused, args):
    """Run csrc/mamba_scan.cu's index arithmetic and arithmetic order on
    the CPU, one block at a time, the 128 threads as numpy lanes: every
    chunk staged into its ring slot by the copy loops of ``issue_chunk``
    (unwritten shared memory is NaN), the lanes' states from h0 (and a),
    each step's update, the sum over n passed left to right from lane to
    lane, y stored by lane L-1, the state stored at the end."""
    f32 = np.float32
    if fused:
        dt, x, a, bm, cc, h0 = args
        B, S, C = dt.shape
    else:
        da, bx, cc, h0 = args
        B, S, C, _ = da.shape
    N = h0.shape[-1]
    p = ops.mamba_plan(B, S, C, N, fused=fused)
    L, NPL, CB, T = p["lanes"], p["npl"], p["channels"], p["chunk"]
    ST, NC, NP = p["stages"], p["chunks"], L * NPL
    per_step = 2 * CB + 2 * NP if fused else 2 * CB * NP + NP
    tid = np.arange(ops.THREADS)
    cl, g = tid // L, tid % L
    n0 = g * NPL
    nvalid = np.clip(N - n0, 0, NPL)
    y = np.full((B, S, C), np.nan, f32)
    h_out = np.full((B, C, N), np.nan, f32)
    flat = {k: v.reshape(-1) for k, v in
            (zip(("dt", "x", "a", "bm", "cc", "h0"), args) if fused else
             zip(("da", "bx", "cc", "h0"), args))}

    def issue(ring, b, c0, k):
        ring[k % ST] = np.nan
        st = ring[k % ST]
        t0 = k * T
        steps = min(T, S - t0)
        row0 = b * S + t0
        if fused:
            for i in range(steps * CB):
                t, c_l = divmod(i, CB)
                if c0 + c_l < C:
                    src = (row0 + t) * C + c0 + c_l
                    st[2 * i] = flat["dt"][src]
                    st[2 * i + 1] = flat["x"][src]
            rest = 2 * T * CB
            for i in range(steps * N):
                t, n = divmod(i, N)
                st[rest + t * 2 * NP + n] = flat["bm"][row0 * N + i]
                st[rest + t * 2 * NP + NP + n] = flat["cc"][row0 * N + i]
        else:
            cbv = min(CB, C - c0)
            row = cbv * N
            for i in range(steps * row):
                t, e = divmod(i, row)
                c_l, n = divmod(e, N)
                src = ((row0 + t) * C + c0) * N + e
                dst = (t * CB + c_l) * NP + n
                st[dst] = flat["da"][src]
                st[T * CB * NP + dst] = flat["bx"][src]
            rest = 2 * T * CB * NP
            for i in range(steps * N):
                t, n = divmod(i, N)
                st[rest + t * NP + n] = flat["cc"][row0 * N + i]

    for b in range(B):
        for c0 in range(0, C, CB):
            c = c0 + cl
            live = c < C
            ring = np.full((ST, T * per_step), np.nan, f32)
            for k in range(ST):
                issue(ring, b, c0, k)
            h = np.zeros((ops.THREADS, NPL), f32)
            a_r = np.zeros((ops.THREADS, NPL), f32)
            for j in range(NPL):
                ok = live & (j < nvalid)
                srow = (b * C + c[ok]) * N + n0[ok] + j
                h[ok, j] = flat["h0"][srow]
                if fused:
                    a_r[ok, j] = flat["a"][c[ok] * N + n0[ok] + j]
            for k in range(NC):
                st = ring[k % ST]
                t0 = k * T
                for t in range(min(T, S - t0)):
                    if fused:
                        dtv = st[2 * (t * CB + cl)]
                        xv = st[2 * (t * CB + cl) + 1]
                        dtx = dtv * xv
                        base = 2 * T * CB + t * 2 * NP + n0
                        for j in range(NPL):
                            dav = torch.exp(torch.from_numpy(
                                dtv * a_r[:, j])).numpy()
                            bxv = dtx * st[base + j]
                            h[:, j] = dav * h[:, j] + bxv
                        terms = h * np.stack(
                            [st[base + NP + j] for j in range(NPL)], 1)
                    else:
                        dat = (t * CB + cl) * NP + n0
                        ct = 2 * T * CB * NP + t * NP + n0
                        for j in range(NPL):
                            h[:, j] = st[dat + j] * h[:, j] + \
                                st[T * CB * NP + dat + j]
                        terms = h * np.stack([st[ct + j]
                                              for j in range(NPL)], 1)
                    acc = np.zeros(ops.THREADS, f32)
                    for r in range(L):
                        if r == 0:
                            s, js = terms[:, 0].copy(), range(1, NPL)
                        else:     # __shfl_up_sync(acc, 1, L)
                            s = np.where(g > 0, acc[tid - 1], acc)
                            js = range(NPL)
                        for j in js:
                            s = np.where(j < nvalid, s + terms[:, j], s)
                        acc = np.where(g == r, s, acc)
                    out = live & (g == L - 1)
                    y[b, t0 + t, c[out]] = acc[out]
                nxt = k - 1 + ST
                if k >= 1 and nxt < NC:
                    issue(ring, b, c0, nxt)
            for j in range(NPL):
                ok = live & (j < nvalid)
                h_out.reshape(-1)[(b * C + c[ok]) * N + n0[ok] + j] = h[ok, j]
    return torch.from_numpy(y), torch.from_numpy(h_out)


@pytest.mark.parametrize("B,S,C,N", [(2, 9, 37, 5), (1, 70, 40, 16),
                                     (1, 3, 20, 1), (2, 5, 17, 12),
                                     (1, 4, 9, 33), (1, 2, 24, 64)])
def test_replay_of_the_kernel_equals_the_plain_versions(B, S, C, N):
    """Both entries, replayed with a ragged last block (C off the block's
    channels), a ragged lane group (N off the lanes' states), S over
    several chunks and ring refills: bit-equal to the plain versions."""
    fargs = _fused_inputs(B, S, C, N, seed=B + S + C + N)
    y, h = _replay(True, fargs)
    yr, hr = mamba_scan_fused_ref(*(torch.from_numpy(t) for t in fargs))
    assert torch.equal(y, yr) and torch.equal(h, hr)
    sargs = _inputs(B, S, C, N, seed=N)
    y, h = _replay(False, sargs)
    yr, hr = mamba_scan_ref(*(torch.from_numpy(t) for t in sargs))
    assert torch.equal(y, yr) and torch.equal(h, hr)
