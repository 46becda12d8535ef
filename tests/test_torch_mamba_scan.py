"""Kernel 5 (the selective scan) of the port against the JAX reference.

On CPU tensors the port's dispatch (``kernels/mamba_scan/ops.py``) runs
the plain PyTorch version; it is held against the reference's
``mamba_scan_pallas`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it), its ``mamba_scan_ref`` and the
chunked associative scan ``models/mamba.py:_ssm_scan`` that the port's
kernel replaces on the model's path.  Inputs are drawn with numpy and
handed to both packages.  The CUDA kernel itself is checked on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import mamba_scan_pallas
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan_ref
from repro.models.mamba import _ssm_scan as jax_ssm_scan
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

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
