"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py``.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref

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
    with pytest.raises(NotImplementedError):
        ops.paged_decode_attention(q, kp, vp, tb, ln,
                                   k_scale=kp[..., 0], v_scale=vp[..., 0])
    with pytest.raises(TypeError):
        ops.paged_decode_attention(q, kp, vp, tb.long(), ln)
    with pytest.raises(ValueError):
        ops.paged_decode_attention(q, kp.transpose(1, 2).contiguous()
                                   .transpose(1, 2), vp, tb, ln)
