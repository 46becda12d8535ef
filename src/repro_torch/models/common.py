"""Model substrate: seeded parameter init, norms, activations, rope.

Parameters are plain nested dicts of tensors in the JAX package's
*stored* layout (``models/common.py`` there), so one tree converts 1:1
between the packages (:func:`repro_torch.weights.params_from_jax`).
Decoder layers are stacked on a leading super-block axis under
``params["blocks"]``, exactly as the reference's layer scan stores them.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.device import dtype_of, resolve_device

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Normalization / activations / rope
# --------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm / LayerNorm with the arithmetic in f32."""
    dt = x.dtype
    x = x.float()
    if kind == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    var = x.square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if kind == "relu":
        return F.relu(x)
    if kind == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(kind)


def rope_freqs(d_head: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh), positions: broadcastable to (..., S).

    Half-split layout (the first and second halves of ``Dh`` rotate as
    pairs), not the interleaved one — as in the reference."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                 # (Dh/2,)
    ang = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def big_neg() -> float:
    """The reference's mask fill: half the most negative f32."""
    return torch.finfo(torch.float32).min / 2


# --------------------------------------------------------------------------
# Seeded initialization (same shapes, stored layouts and std as the
# reference's InitCtx.param / param_from; not the same numbers)
# --------------------------------------------------------------------------

class _Init:
    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))
        self.device = device
        self.dtype = dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32) * std

    def param(self, shape, scale: float = 1.0) -> torch.Tensor:
        """InitCtx.param(init="normal"): std = scale / sqrt(shape[0])."""
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        return self.normal(shape, scale / math.sqrt(max(fan_in, 1))
                           ).to(self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def heads(self, shape, std: float, orig, axis: int) -> torch.Tensor:
        """A stored-head weight: logical heads drawn, then placed along
        ``axis`` by the plan's ``q_orig``/``kv_orig`` map (padding = 0)."""
        cols = torch.as_tensor(orig, dtype=torch.long, device=self.device)
        n_logical = shape[axis]
        w = self.normal(shape, std)
        w = w.index_select(axis, cols.clamp(0, n_logical - 1))
        keep = (cols >= 0).view([-1 if d == axis else 1
                                 for d in range(w.dim())])
        return torch.where(keep, w, torch.zeros((), device=self.device)
                           ).to(self.dtype)


def _init_attention(ini: _Init, cfg, plan) -> Params:
    a = plan.attn
    D = cfg.d_model
    s_in = 1.0 / math.sqrt(D)
    s_out = 1.0 / math.sqrt(max(a.n_heads * a.d_head, 1))
    g = max(a.n_kv_heads, 1)
    return {
        "wq": ini.heads((D, a.n_heads, a.d_head), s_in, a.q_orig, 1),
        "wk": ini.heads((D, g, a.d_head), s_in, a.kv_orig, 1),
        "wv": ini.heads((D, g, a.d_head), s_in, a.kv_orig, 1),
        "wo": ini.heads((a.n_heads, a.d_head, D), s_out, a.q_orig, 0),
    }


def _init_mlp(ini: _Init, cfg, plan) -> Params:
    D, ff = cfg.d_model, plan.d_ff_shard * plan.tp
    return {"wg": ini.param((D, ff)), "wu": ini.param((D, ff)),
            "wd": ini.param((ff, D))}


def init_params(cfg, plan, seed: int = 0, device=None) -> Params:
    """Random weights for a dense decoder, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (``cuda`` unless the caller asks
    for the CPU, as every entry point of the port).

    Shapes, stored layouts and standard deviations follow the
    reference's ``InitCtx.param``/``param_from`` (tied embedding
    (vocab_padded, D), wq (D, hp, dh), wk/wv (D, gp, dh), wo (hp, dh, D),
    norm scales of one), with decoder layers stacked on a leading
    super-block axis; the numbers differ from the reference's."""
    if cfg.family != "dense" or cfg.moe is not None:
        raise NotImplementedError(
            f"init_params: family {cfg.family!r} arrives with its own slice")
    if cfg.qkv_bias or cfg.norm != "rmsnorm" or not cfg.mlp_gated:
        raise NotImplementedError(
            "init_params covers the llama-style decoder (no qkv bias, "
            "rmsnorm, gated MLP) of this slice")
    ini = _Init(seed, resolve_device(device), dtype_of(plan.param_dtype))
    D = cfg.d_model
    params: Params = {}
    if cfg.tie_embeddings:
        params["embed"] = ini.param((plan.vocab_padded, D))
    else:
        params["embed_in"] = ini.param((cfg.vocab_size, D))
        params["head"] = ini.param((D, plan.vocab_padded))
    layers = []
    for _ in range(cfg.n_layers):
        layers.append({"ln1": {"scale": ini.ones((D,))},
                       "attn": _init_attention(ini, cfg, plan),
                       "ln2": {"scale": ini.ones((D,))},
                       "mlp": _init_mlp(ini, cfg, plan)})
    params["blocks"] = {"l0": _stack(layers)}
    params["ln_f"] = {"scale": ini.ones((D,))}
    return params


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, 0)
