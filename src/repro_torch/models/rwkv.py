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
kernel's plain version instead: the oracle switch ``chip_smoke.py`` uses.
At tp=1 the reference's ESL matmuls (``ag_matmul``/``rs_matmul``) are
plain products and its vector slicing is the identity.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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

def time_mix_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
                 state: Optional[Dict[str, torch.Tensor]] = None,
                 use_kernels: bool = True
                 ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B,S,D).  state: {'shift': (B,1,D), 'wkv': (B,H,dh,dh)} decode
    carry.  Returns (out (B,S,D), new state or None); the caller writes
    the new state into its cache."""
    hp, hpr, dh = rwkv_dims(cfg, plan)
    B, S = x.shape[0], x.shape[1]
    prev = state["shift"] if state is not None else None
    dx = _shift(x, prev) - x

    # data-dependent token-shift lerps (low-rank adjusted)
    xm = x + dx * p["mu_x"]
    lora = torch.tanh(xm @ p["mix_w1"]).reshape(B, S, 5, -1)
    mixed = {}
    for i, nm in enumerate(_MIX):
        adj = lora[:, :, i] @ p["mix_w2"][i]
        mixed[nm] = x + dx * (p[f"mu_{nm}"] + adj)

    r = mixed["r"] @ p["w_r"]
    kk = mixed["k"] @ p["w_k"]
    vv = mixed["v"] @ p["w_v"]
    g = F.silu(mixed["g"] @ p["w_g"])
    dlo = torch.tanh(mixed["w"] @ p["decay_w1"])
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

    out = y @ p["w_o"]
    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1:, :], "wkv": s_fin}
    return out, new_state


def channel_mix_fwd(p: Params, x: torch.Tensor, *, cfg, plan,
                    state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B,S,D).  state: (B,1,D) previous-token carry (decode)."""
    dx = _shift(x, state) - x
    xk = x + dx * p["mu_k"]
    xr = x + dx * p["mu_r"]
    kk = torch.square(F.relu(xk @ p["w_k"]))
    y = kk @ p["w_v"]
    rr = xr @ p["w_r"]
    y = torch.sigmoid(rr.float()).to(y.dtype) * y
    new_state = x[:, -1:, :] if state is not None else None
    return y, new_state


def init_rwkv_state(cfg, plan, batch: int, dtype: torch.dtype,
                    device) -> Dict[str, torch.Tensor]:
    """Zeroed decode carry of one rwkv layer: the shifts in ``dtype``
    (the cache dtype), the WKV state in f32."""
    hp, hpr, dh = rwkv_dims(cfg, plan)
    shift = (batch, 1, cfg.d_model)
    return {"shift_t": torch.zeros(shift, dtype=dtype, device=device),
            "shift_c": torch.zeros(shift, dtype=dtype, device=device),
            "wkv": torch.zeros((batch, hp, dh, dh), dtype=torch.float32,
                               device=device)}
