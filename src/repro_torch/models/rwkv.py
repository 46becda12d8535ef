"""RWKV6 ("Finch") at tp=1 — attention-free, data-dependent per-channel
decay (the port of the reference's ``models/rwkv.py``).

Decode has no KV cache: per layer the state is one (head_dim x
head_dim) matrix per head plus two shift vectors, so a token costs the
weight stream.  Recurrence:

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(-exp(w0 + lora_w(x_t)))

As in the reference, :func:`time_mix_fwd` runs the chunked formulation
(:func:`wkv_chunked`, plain PyTorch) for S > 1 and the per-step
recurrence (:func:`wkv_scan`) for S = 1; the latter is the hand-written
Hopper kernel (``kernels/rwkv_scan``).  ``use_kernels=False`` takes the
kernel's plain version instead: the oracle switch ``chip_smoke.py`` uses,
and train mode's path at S = 1 (the forward passes it there: the kernel
has no backward, and its plain version is differentiable).
On the model ring (``env``) the heads (``head_dim`` blocks of the
projections) are column tiles, as the reference tiles them: r/k/v/g
and the decay's low-rank output stream through ``ag_matmul`` onto the
rank's heads, the token shift, decay, bonus and the WKV recurrence stay
on them (kernel 4 runs on the rank's (B, 1, H/tp, dh) in decode), and
w_o streams its partials back through ``rs_matmul``; channel mix tiles
its FFN the same way and its receptance by columns of d_model.  The
``vec`` parameters (the lerps' mu) and mix_w2's d_model columns are
stored model-sharded: with scattered activations (ESL overlap) they
are what the rank's channels need, in the blocking baseline they are
gathered once (:func:`repro_torch.core.dist.all_gather_param`).  At
tp=1 the ESL matmuls are plain products and the gathers the identity.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dist, esl
from repro_torch.core.dist import AxisEnv, ring_axis
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref

Params = Dict[str, Any]

_MIX = ("r", "k", "v", "g", "w")


def rwkv_dims(cfg, plan) -> Tuple[int, int, int]:
    """(heads_padded_total, heads_per_rank, head_dim)."""
    a = plan.attn
    return a.hp, a.q_per_rank, cfg.rwkv.head_dim


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1}; ``prev`` is the carried last token for decode/continuation."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev.to(x.dtype), x[:, :-1]], 1)


# ---------------------------------------------------------------------------
# WKV recurrence
# ---------------------------------------------------------------------------

def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             use_kernels: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: (B,S,H,dh) f32; u: (H,dh); s0: (B,H,dh,dh) f32.

    Returns (y (B,S,H,dh), s_final): the per-step recurrence, on the
    Hopper kernel (or, with ``use_kernels=False``, its plain version)."""
    fn = rwkv_scan if use_kernels else rwkv_scan_ref
    return fn(*(t.float().contiguous() for t in (r, k, v, w, u, s0)))


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV, the reference's prefill formulation: the state is
    carried across chunks and the recurrence inside a chunk becomes
    dense products.  Every decay exponent is <= 0 (the cumulative log
    decay L is non-increasing), clipped to [-60, 0] as in the reference.
    Matches :func:`wkv_scan` to ~1e-4."""
    B, S, H, dh = r.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    n = (S + pad) // chunk

    def to_chunks(t):
        return t.reshape(B, n, chunk, H, dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc = to_chunks(r), to_chunks(k), to_chunks(v)  # (n,B,H,C,dh)
    lw = torch.log(torch.clamp(to_chunks(w), min=1e-38))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                device=r.device), diagonal=-1)
    s = s0
    ys = []
    for c in range(n):
        rb, kb, vb, lwb = rc[c], kc[c], vc[c], lw[c]     # (B,H,C,dh)
        L = torch.cumsum(lwb, dim=2)                      # inclusive
        L_in = L - lwb                                    # exclusive
        Lc = L[:, :, -1:, :]                              # (B,H,1,dh)
        # carry contribution: (r_t * exp(L_{t-1})) . S
        y_carry = torch.einsum("bhtd,bhdv->bhtv", rb * torch.exp(L_in), s)
        # intra-chunk: M[t,s] = sum_d r_t exp(L_{t-1}-L_s) k_s, s < t
        decay = torch.exp(torch.clamp(L_in[:, :, :, None, :]
                                      - L[:, :, None, :, :], -60.0, 0.0))
        m = (rb[:, :, :, None, :] * decay * kb[:, :, None, :, :]).sum(-1)
        y_intra = torch.einsum("bhts,bhsv->bhtv", m * tri, vb)
        # diagonal bonus
        y_diag = (rb * u[None, :, None, :] * kb).sum(-1, keepdim=True) * vb
        # state update: S' = exp(Lc) . S + sum_s (k_s exp(Lc - L_s)) v_s
        k_dec = kb * torch.exp(torch.clamp(Lc - L, -60.0, 0.0))
        s = torch.exp(Lc[:, :, 0, :, None]) * s + \
            torch.einsum("bhsd,bhsv->bhdv", k_dec, vb)
        ys.append(y_carry + y_intra + y_diag)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, n * chunk, H, dh)
    return y[:, :S], s


# ---------------------------------------------------------------------------
# time mix / channel mix
# ---------------------------------------------------------------------------

def _vslice(v: torch.Tensor, env: Optional[AxisEnv], plan) -> torch.Tensor:
    """A 'vec' parameter (stored model-sharded) as the activations need
    it: the rank's shard in scattered mode, gathered (once) in the
    blocking baseline."""
    axis, tp = ring_axis(env)
    return esl.full_vec(v, axis=axis, tp=tp,
                        scattered_activations=plan.esl_overlap)


def _mix_w2_local(w2: torch.Tensor, i: int, env: Optional[AxisEnv],
                  plan) -> torch.Tensor:
    """mix_w2[i]: stored (lora, D/tp) ('embed_scatter'); in the blocking
    baseline the lerp target x is full, so it is gathered (once)."""
    axis, _ = ring_axis(env)
    w = w2[i]
    if plan.esl_overlap or axis is None:
        return w
    return dist.all_gather_param(w, axis)


def time_mix_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 use_kernels: bool = True, env: Optional[AxisEnv] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D), or on the ring (``env``) (B,S,D/tp) scattered under
    ESL overlap.  state: {'shift': (B,1,D[/tp]), 'wkv': (B,H,dh,dh)}
    decode carry (H the rank's heads on the ring).  Returns (out in x's
    convention, new state or None); the caller writes the new state
    into its cache."""
    hp, hpr, dh = rwkv_dims(cfg, plan)
    axis, tp = ring_axis(env)
    overlap = plan.esl_overlap
    B, S = x.shape[0], x.shape[1]
    prev = state["shift"] if state is not None else None
    dx = _shift(x, prev) - x

    def ag(t, w):
        return esl.ag_matmul(t, w, axis=axis, tp=tp, overlap=overlap)

    # data-dependent token-shift lerps (low-rank adjusted)
    xm = x + dx * _vslice(p["mu_x"], env, plan)
    lora = torch.tanh(ag(xm, p["mix_w1"])).reshape(B, S, 5, -1)
    mixed = {}
    for i, nm in enumerate(_MIX):
        adj = lora[:, :, i] @ _mix_w2_local(p["mix_w2"], i, env, plan)
        mixed[nm] = x + dx * (_vslice(p[f"mu_{nm}"], env, plan) + adj)

    r = ag(mixed["r"], p["w_r"])
    kk = ag(mixed["k"], p["w_k"])
    vv = ag(mixed["v"], p["w_v"])
    g = F.silu(ag(mixed["g"], p["w_g"]))
    dlo = torch.tanh(ag(mixed["w"], p["decay_w1"]))
    dw = dlo @ p["decay_w2"]
    w = torch.exp(-torch.exp((p["decay_w0"] + dw).float()))  # (B,S,C), (0,1)

    u = p["bonus_u"].float().reshape(hpr, dh)
    shp = (B, S, hpr, dh)
    rr, kk4, vv4, ww = (t.float().reshape(shp) for t in (r, kk, vv, w))
    s0 = (state["wkv"].float() if state is not None else
          torch.zeros((B, hpr, dh, dh), dtype=torch.float32,
                      device=x.device))
    if S > 1:
        y, s_fin = wkv_chunked(rr, kk4, vv4, ww, u, s0)
    else:
        y, s_fin = wkv_scan(rr, kk4, vv4, ww, u, s0,
                            use_kernels=use_kernels)

    # per-head group norm
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 1e-5)
    y = y.reshape(B, S, hpr * dh) * p["ln_x"]
    y = y.to(x.dtype) * g

    out = esl.rs_matmul(y, p["w_o"], axis=axis, tp=tp, overlap=overlap,
                        scatter_out=overlap)
    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1:, :], "wkv": s_fin}
    return out, new_state


def channel_mix_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
                    state: Optional[torch.Tensor] = None,
                    env: Optional[AxisEnv] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B,S,D), or on the ring (B,S,D/tp) scattered under ESL
    overlap.  state: (B,1,D[/tp]) previous-token carry (decode)."""
    axis, tp = ring_axis(env)
    overlap = plan.esl_overlap
    dx = _shift(x, state) - x
    xk = x + dx * _vslice(p["mu_k"], env, plan)
    xr = x + dx * _vslice(p["mu_r"], env, plan)
    kk = torch.square(F.relu(esl.ag_matmul(xk, p["w_k"], axis=axis, tp=tp,
                                           overlap=overlap)))
    y = esl.rs_matmul(kk, p["w_v"], axis=axis, tp=tp, overlap=overlap,
                      scatter_out=overlap)
    # receptance: column tiles, so r matches the scattered output
    rr = esl.ag_matmul(xr, p["w_r"], axis=axis, tp=tp, overlap=overlap)
    if not overlap:
        rr = esl.gather_scattered(rr, axis=axis, tp=tp)
    y = torch.sigmoid(rr.float()).to(y.dtype) * y
    new_state = x[:, -1:, :] if state is not None else None
    return y, new_state


def init_rwkv_state(cfg, plan, batch: int, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Zeroed decode carry of one rwkv layer: the shifts in ``dtype``
    (the cache dtype), the WKV state in f32.  On the ring one rank's, as
    the reference's ``cache_specs`` shard it: the WKV state on the
    rank's heads, the shifts on its d_model/tp channels when the
    activations are scattered (ESL overlap) and whole in the blocking
    baseline."""
    hp, hpr, dh = rwkv_dims(cfg, plan)
    d = cfg.d_model
    if plan.tp > 1 and plan.esl_overlap:
        d //= plan.tp
    shift = (batch, 1, d)
    return {"shift_t": torch.zeros(shift, dtype=dtype, device=device),
            "shift_c": torch.zeros(shift, dtype=dtype, device=device),
            "wkv": torch.zeros((batch, hpr, dh, dh), dtype=torch.float32,
                               device=device)}
