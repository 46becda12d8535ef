"""Mamba (S6) block of the jamba hybrid stack (the port of the
reference's ``models/mamba.py``).

On the model ring (``env``) d_inner is column-tiled, as the reference
tiles it: each rank holds d_inner/tp channels of in_x|in_z (one ESL
``ag_matmul`` pass feeds both tiles), of the conv, of dt_proj, a_log,
d_skip and the state; the small dt/B/C projection ``x_proj`` is
row-parallel, its partial sums added over the ring in rank order
(``dist.psum``), and out_proj streams its partials back through
``rs_matmul``.  Each rank runs the scan on its own (B, S, d_inner/tp, N)
channels.  At tp=1 (no ``env``) the ESL products are plain products and
the psum is the identity.  The selective scan
runs on the hand-written Hopper kernel (``kernels/mamba_scan``, kernel 5)
at every sequence length: the prefill scan and the S = 1 decode step
alike, through its fused entry, which forms da = exp(dt*A) and
bx = dt*x*B in registers: the (B,S,d_inner,N) tensors are never
written.  The reference's chunked associative scan ``_ssm_scan`` (its
prefill path) and its inline decode step have no counterpart here: on
the card the kernel carries every scan, on the CPU its plain version
does.  ``use_kernels=False`` takes the plain version on the card too:
the oracle switch ``chip_smoke.py`` uses, and train mode's path (the
forward passes it there: the kernel has no backward, and its plain
version is differentiable).

Decode carries (conv_state, ssm_state): constant memory per token.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dist, esl
from repro_torch.core.dist import AxisEnv, ring_axis
from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
from repro_torch.kernels.mamba_scan.ref import mamba_scan_fused_ref

Params = Dict[str, torch.Tensor]


def mamba_dims(cfg, plan) -> Tuple[int, int]:
    """(d_inner_padded, d_inner_shard)."""
    d_in = cfg.mamba.expand * cfg.d_model
    pad = ((d_in + plan.tp - 1) // plan.tp) * plan.tp
    return pad, pad // plan.tp


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over seq.  x: (B,S,C); w: (K,C).

    The reference's explicit sum over the K taps (not ``F.conv1d``: the
    same rounding as the reference, and no cuDNN TF32).  Returns (y,
    new_state) with state = the last K-1 inputs (for decode)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], 1)
    y = sum(xp[:, i:i + S, :] * w[i] for i in range(K))
    return y + b, xp[:, xp.shape[1] - (K - 1):, :]


def mamba_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
              state: Optional[Dict[str, torch.Tensor]] = None,
              use_kernels: bool = True, env: Optional[AxisEnv] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,D), or on the ring (``env``) (B,S,D/tp) scattered under
    ESL overlap.  state: the decode carry {"conv": (B,K-1,d_in), "ssm":
    (B,d_in,N) f32} or None (zero state), d_in the rank's channels on
    the ring.  Returns (y in x's convention, new_state); the state is
    returned, not written."""
    m = cfg.mamba
    B = x.shape[0]
    axis, tp = ring_axis(env)
    overlap = plan.esl_overlap
    xs, z = esl.ag_matmuls(x, (p["in_x"], p["in_z"]), axis=axis, tp=tp,
                           overlap=overlap)            # (B,S,d_in)

    xs, new_conv = _causal_conv(xs, p["conv_w"], p["conv_b"],
                                state["conv"] if state is not None else None)
    xs = F.silu(xs)

    # dt/B/C: the row-parallel small projection, summed over the ring
    dbc = dist.psum(xs @ p["x_proj"], axis)
    dt, bmat, cmat = torch.split(dbc, [m.dt_rank, m.d_state, m.d_state], -1)
    dt = dt @ p["dt_proj"] + p["dt_bias"]
    dt = dt.float()
    dt = torch.logaddexp(dt, torch.zeros((), dtype=dt.dtype,
                                         device=dt.device))  # softplus

    a = -torch.exp(p["a_log"].float())                 # (d_in,N)

    h0 = (state["ssm"] if state is not None else
          torch.zeros((B, xs.shape[-1], m.d_state), dtype=torch.float32,
                      device=x.device))
    # da = exp(dt*a) and bx = (dt*x)*b are formed inside the scan
    scan = mamba_scan_fused if use_kernels else mamba_scan_fused_ref
    y, h = scan(dt.contiguous(), xs.float().contiguous(), a.contiguous(),
                bmat.float().contiguous(), cmat.float().contiguous(),
                h0.contiguous())

    y = y.to(xs.dtype) + xs * p["d_skip"]
    y = y * F.silu(z)
    out = esl.rs_matmul(y, p["out_proj"], axis=axis, tp=tp,
                        overlap=overlap, scatter_out=overlap)
    return out, {"conv": new_conv, "ssm": h}


def init_mamba_state(cfg, plan, batch: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """One layer's zeroed decode carry: conv (batch, K-1, d_in) in the
    cache dtype, ssm (batch, d_in, N) in f32; on the ring one rank's,
    d_in its d_inner/tp channels (the reference's ``cache_specs`` shard
    both on ``mamba_inner``)."""
    m = cfg.mamba
    _, d_in = mamba_dims(cfg, plan)
    return {"conv": torch.zeros((batch, m.d_conv - 1, d_in), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, d_in, m.d_state),
                               dtype=torch.float32, device=device)}
