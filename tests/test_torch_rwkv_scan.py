"""Kernel 4 (the WKV recurrence) of the port against the JAX reference.

On CPU tensors the port's dispatch (``kernels/rwkv_scan/ops.py``) runs
the plain PyTorch version; it is held against the reference's
``rwkv_scan`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``rwkv_scan_ref``.  The port's
``wkv_scan`` / ``wkv_chunked`` (``models/rwkv.py``) are held against the
reference's.  Inputs are drawn with numpy and handed to both packages.
The CUDA kernel itself is checked on the card
(``tests/test_torch_cuda_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import rwkv_scan as jax_rwkv_scan
from repro.kernels.rwkv_scan import rwkv_scan_ref as jax_rwkv_scan_ref
from repro.models.rwkv import wkv_chunked as jax_wkv_chunked
from repro.models.rwkv import wkv_scan as jax_wkv_scan
from repro_torch.kernels.rwkv_scan import ops
from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref
from repro_torch.models import rwkv as rwkv_mod

# f32 throughout; only the order of the sums differs between the two
# packages (and the Pallas kernel's per-step loop)
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
# chunked: the same formula in both packages, einsums summed in another order
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, S, H, dh, wmin=0.8, seed=0):
    """The distributions of tests/test_kernels.py::test_rwkv_scan."""
    g = np.random.default_rng(seed)
    f = np.float32
    r = g.standard_normal((B, S, H, dh)).astype(f)
    k = (0.3 * g.standard_normal((B, S, H, dh))).astype(f)
    v = g.standard_normal((B, S, H, dh)).astype(f)
    w = g.uniform(wmin, 0.999, (B, S, H, dh)).astype(f)
    u = (0.2 * g.standard_normal((H, dh))).astype(f)
    s0 = (0.1 * g.standard_normal((B, H, dh, dh))).astype(f)
    return r, k, v, w, u, s0


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# the shapes of tests/test_kernels.py:71-72
KERNEL_SHAPES = [(1, 16, 1, 8), (2, 64, 2, 16), (2, 32, 4, 32)]


@pytest.mark.parametrize("B,S,H,dh", KERNEL_SHAPES)
def test_dispatch_matches_reference_kernel(B, S, H, dh):
    args = _inputs(B, S, H, dh)
    before = ops.rwkv_scan.launches
    y, s = ops.rwkv_scan(*(torch.from_numpy(a) for a in args))
    assert ops.rwkv_scan.launches == before      # CPU: the plain version
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, H, dh)
    jargs = [jnp.asarray(a) for a in args]
    yp, sp = jax_rwkv_scan(*jargs)                # Pallas, interpret mode
    yr, sr = jax_rwkv_scan_ref(*jargs)
    for want_y, want_s in ((yp, sp), (yr, sr)):
        _close(y, want_y, SCAN_TOL)
        _close(s, want_s, SCAN_TOL)


@pytest.mark.parametrize("S", [1, 7])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_wkv_scan_matches_reference(S, use_kernels):
    args = _inputs(3, S, 4, 16, seed=S)
    y, s = rwkv_mod.wkv_scan(*(torch.from_numpy(a) for a in args),
                             use_kernels=use_kernels)
    yr, sr = jax_wkv_scan(*(jnp.asarray(a) for a in args))
    _close(y, yr, SCAN_TOL)
    _close(s, sr, SCAN_TOL)


@pytest.mark.parametrize("chunk", [8, 32, 64])
@pytest.mark.parametrize("S", [7, 32, 100])
def test_wkv_chunked_matches_reference(chunk, S):
    args = _inputs(2, S, 3, 16, wmin=0.2)
    y, s = rwkv_mod.wkv_chunked(*(torch.from_numpy(a) for a in args),
                                chunk=chunk)
    yr, sr = jax_wkv_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    assert tuple(y.shape) == (2, S, 3, 16)
    _close(y, yr, CHUNK_TOL)
    _close(s, sr, CHUNK_TOL)


def test_wkv_chunked_extreme_decay():
    """tests/test_rwkv_chunked.py's extreme decay (w down to 1e-6): every
    decay exponent is clipped to [-60, 0], so nothing blows up, and the
    port agrees with the reference's chunked form and (within the
    reference test's 1e-3) with the per-step scan."""
    args = _inputs(2, 64, 2, 16, wmin=1e-6, seed=3)
    targs = [torch.from_numpy(a) for a in args]
    y, s = rwkv_mod.wkv_chunked(*targs, chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = jax_wkv_chunked(*(jnp.asarray(a) for a in args), chunk=32)
    _close(y, yr, CHUNK_TOL)
    _close(s, sr, CHUNK_TOL)
    ys, ss = rwkv_mod.wkv_scan(*targs)
    _close(y, ys, dict(rtol=1e-3, atol=1e-3))
    _close(s, ss, dict(rtol=1e-3, atol=1e-3))


def test_plain_version_is_the_reference_oracle():
    """rwkv_scan_ref against the reference's oracle at S = 1, the decode
    shape the kernel carries (4 slots, several heads)."""
    args = _inputs(4, 1, 8, 32, seed=9)
    y, s = rwkv_scan_ref(*(torch.from_numpy(a) for a in args))
    yr, sr = jax_rwkv_scan_ref(*(jnp.asarray(a) for a in args))
    _close(y, yr, SCAN_TOL)
    _close(s, sr, SCAN_TOL)


def test_dispatch_refuses_other_devices():
    """Only CPU tensors take the plain version; any other device needs
    the kernel, and a device without one raises."""
    args = [torch.from_numpy(a).to("meta") for a in _inputs(1, 2, 1, 8)]
    with pytest.raises(ValueError, match="no kernel"):
        ops.rwkv_scan(*args)
