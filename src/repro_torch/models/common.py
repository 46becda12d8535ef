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

from repro_torch.core.dist import pmean
from repro_torch.device import dtype_of, resolve_device

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Normalization / activations / rope
# --------------------------------------------------------------------------

def apply_norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-5,
               stats_axis=None) -> torch.Tensor:
    """RMSNorm / LayerNorm with the arithmetic in f32.

    ``stats_axis`` (a :class:`repro_torch.core.dist.Ring`): the hidden
    dim is *scattered* over the ring (ESL scattered-activation mode), so
    the mean and the variance are combined with a ``pmean`` over it —
    the distributed norm that keeps activations scattered."""
    dt = x.dtype
    x = x.float()
    if kind == "layernorm":
        mean = x.mean(-1, keepdim=True)
        if stats_axis is not None:
            mean = pmean(mean, stats_axis)
        x = x - mean
    var = x.square().mean(-1, keepdim=True)
    if stats_axis is not None:
        var = pmean(var, stats_axis)
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
        # scaled in place: a 3.8 GB expert leaf is held once, not twice
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32).mul_(std)

    def param(self, shape, scale: float = 1.0) -> torch.Tensor:
        """InitCtx.param(init="normal"): std = scale / sqrt(shape[0])."""
        fan_in = shape[0] if len(shape) > 1 else max(shape[0], 1)
        return self.normal(shape, scale / math.sqrt(max(fan_in, 1))
                           ).to(self.dtype)

    def uniform(self, shape, scale: float) -> torch.Tensor:
        """InitCtx.param(init="uniform"): U(-scale, scale)."""
        u = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return ((2 * u - 1) * scale).to(self.dtype)

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

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
    p = {
        "wq": ini.heads((D, a.n_heads, a.d_head), s_in, a.q_orig, 1),
        "wk": ini.heads((D, g, a.d_head), s_in, a.kv_orig, 1),
        "wv": ini.heads((D, g, a.d_head), s_in, a.kv_orig, 1),
        "wo": ini.heads((a.n_heads, a.d_head, D), s_out, a.q_orig, 0),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((a.hp, a.d_head))
        p["bk"] = ini.zeros((a.gp, a.d_head))
        p["bv"] = ini.zeros((a.gp, a.d_head))
    return p


def mlp_has_bias(cfg) -> bool:
    """The reference's rule (``transformer.init_layer``): an ungated MLP
    under layernorm (OPT, GPT3) carries ``bi``/``bd``; no other does."""
    return cfg.norm == "layernorm" and not cfg.mlp_gated


def _init_mlp(ini: _Init, cfg, plan) -> Params:
    D, ff = cfg.d_model, plan.d_ff_shard * plan.tp
    p = ({"wg": ini.param((D, ff)), "wu": ini.param((D, ff))}
         if cfg.mlp_gated else {"wi": ini.param((D, ff))})
    p["wd"] = ini.param((ff, D))
    if mlp_has_bias(cfg):
        p["bi"], p["bd"] = ini.zeros((ff,)), ini.zeros((D,))
    return p


def _init_norm(ini: _Init, D: int, kind: str) -> Params:
    p = {"scale": ini.ones((D,))}
    if kind == "layernorm":
        p["bias"] = ini.zeros((D,))
    return p


def _init_time_mix(ini: _Init, cfg, plan) -> Params:
    """The reference's ``rwkv.init_time_mix`` (tp=1: the padded head width
    is the model's)."""
    r, D = cfg.rwkv, cfg.d_model
    dproj = plan.attn.hp * r.head_dim
    p: Params = {"mu_x": ini.uniform((D,), 0.5)}
    for nm in ("r", "k", "v", "g", "w"):
        p[f"mu_{nm}"] = ini.uniform((D,), 0.5)
    p["mix_w1"] = ini.param((D, 5 * r.mix_lora))
    p["mix_w2"] = ini.param((5, r.mix_lora, D), scale=0.1)
    for nm in ("r", "k", "v", "g"):
        p[f"w_{nm}"] = ini.param((D, dproj))
    p["w_o"] = ini.param((dproj, D))
    p["decay_w0"] = ini.uniform((dproj,), 1.0)
    p["decay_w1"] = ini.param((D, r.decay_lora))
    p["decay_w2"] = ini.param((r.decay_lora, dproj), scale=0.1)
    p["bonus_u"] = ini.uniform((dproj,), 0.5)
    p["ln_x"] = ini.ones((dproj,))
    return p


def _init_channel_mix(ini: _Init, cfg, plan) -> Params:
    """The reference's ``rwkv.init_channel_mix``."""
    D, ff = cfg.d_model, plan.d_ff_padded
    return {"mu_k": ini.uniform((D,), 0.5), "mu_r": ini.uniform((D,), 0.5),
            "w_k": ini.param((D, ff)), "w_v": ini.param((ff, D)),
            "w_r": ini.param((D, D))}


def _init_mamba(ini: _Init, cfg, plan) -> Params:
    """The reference's ``mamba.init_mamba`` (tp=1: d_inner unpadded)."""
    m, D = cfg.mamba, cfg.d_model
    d_in = m.expand * D
    a_log = torch.log(torch.arange(1, m.d_state + 1, dtype=torch.float32,
                                   device=ini.device))
    return {
        "in_x": ini.param((D, d_in)), "in_z": ini.param((D, d_in)),
        "conv_w": ini.param((m.d_conv, d_in)),
        "conv_b": ini.zeros((d_in,)),
        "x_proj": ini.param((d_in, m.dt_rank + 2 * m.d_state)),
        "dt_proj": ini.param((m.dt_rank, d_in)),
        "dt_bias": ini.zeros((d_in,)),
        "a_log": a_log.expand(d_in, m.d_state).contiguous().to(ini.dtype),
        "d_skip": ini.ones((d_in,)),
        # the reference's scale 1/sqrt(d_in) is divided by sqrt(fan_in)
        # again: std 1/d_in
        "out_proj": ini.param((d_in, D), scale=1.0 / math.sqrt(d_in)),
    }


def _init_moe(ini: _Init, cfg, plan, put) -> Params:
    """The reference's ``moe.init_moe`` at tp=1: one rank (W = 1) holds
    every expert, no FFN split; expert leaves (1, E, D, ffh) / (1, E, ffh,
    D) with std 1/sqrt(D) and 1/sqrt(d_ff_expert), router std
    1/sqrt(D); with ``n_shared_experts``, a ``shared`` expert of hidden
    width ``n_shared_experts x d_ff_shard`` (wg/wu (D, dsh) std
    1/sqrt(D), wd (dsh, D) std 1/sqrt(dsh)).  ``put(tree, name)`` maps
    each entry as soon as it is drawn: an expert stack is the largest
    leaf of any model (jamba's 1.9 GB in bf16)."""
    from repro_torch.models.moe import moe_layout
    w, _, _, ecell, e_pad, ffh = moe_layout(plan)
    D = cfg.d_model
    s1, s2 = 1.0 / math.sqrt(D), 1.0 / math.sqrt(max(ffh, 1))
    p = {"router": put(ini.param((D, e_pad)), "router"),
         "wg": put(ini.normal((w, ecell, D, ffh), s1).to(ini.dtype), "wg"),
         "wu": put(ini.normal((w, ecell, D, ffh), s1).to(ini.dtype), "wu"),
         "wd": put(ini.normal((w, ecell, ffh, D), s2).to(ini.dtype), "wd")}
    if cfg.moe.n_shared_experts:
        dsh = cfg.moe.n_shared_experts * plan.d_ff_shard * plan.tp
        p["shared"] = put({"wg": ini.param((D, dsh)),
                           "wu": ini.param((D, dsh)),
                           "wd": ini.param((dsh, D))}, "shared")
    return p


def init_super_block(ini: _Init, cfg, plan, put):
    """One super-block of a hybrid or MoE stack, ``l0..l{sb-1}``, drawn
    layer by layer: attention or mamba by ``cfg.is_attention_layer(j)``,
    MoE or MLP by ``cfg.is_moe_layer(j)``, as the reference's
    ``init_layer``.  Yields ("l{j}", the layer's tree, each part mapped
    by ``put(part, "blocks/l{j}/<name>")`` as soon as it is drawn, an
    MoE's leaf by leaf), each layer drawn only when asked for."""
    from repro_torch.models.transformer import super_block_size
    D = cfg.d_model
    for j in range(super_block_size(cfg)):
        pre = f"blocks/l{j}/"
        p: Params = {"ln1": put(_init_norm(ini, D, cfg.norm), pre + "ln1")}
        if cfg.is_attention_layer(j):
            p["attn"] = put(_init_attention(ini, cfg, plan), pre + "attn")
        else:
            p["mamba"] = put(_init_mamba(ini, cfg, plan), pre + "mamba")
        p["ln2"] = put(_init_norm(ini, D, cfg.norm), pre + "ln2")
        if cfg.is_moe_layer(j):
            p["moe"] = _init_moe(ini, cfg, plan, lambda t, name, pre=pre:
                                 put(t, pre + "moe/" + name))
        else:
            p["mlp"] = put(_init_mlp(ini, cfg, plan), pre + "mlp")
        yield f"l{j}", p


def init_params(cfg, plan, seed: int = 0, device=None) -> Params:
    """Random weights for any family of the reference, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (``cuda``
    unless the caller asks for the CPU, as every entry point of the
    port).

    Shapes, stored layouts and init laws follow the reference's
    ``InitCtx.param``/``param_from`` (dense: tied embedding
    (vocab_padded, D) or untied ``embed_in``/``head``, wq (D, hp, dh),
    wk/wv (D, gp, dh), wo (hp, dh, D), norm scales of one; with the
    config's options, zero ``bq`` (hp, dh) and ``bk``/``bv`` (gp, dh),
    zero layernorm ``bias``, the ungated ``wi``/``wd`` with zero
    ``bi``/``bd`` (:func:`mlp_has_bias`) and learned ``pos_embed``
    (max_seq, D) of std 1/sqrt(max_seq); vlm: the dense tree and a
    ``projector`` (patch_embed_dim, D) of std 1/sqrt(patch_embed_dim);
    rwkv: untied ``embed_in`` (vocab, D) and ``head`` (D, vocab_padded),
    layernorm scale and bias, ``tmix``/``cmix`` with uniform ``mu_*``,
    ``decay_w0`` and ``bonus_u``; hybrid and moe: super-blocks
    ``l0..l{sb-1}`` of attention or mamba with MoE or MLP, see
    :func:`init_super_block`; encdec: whisper's tree,
    :func:`repro_torch.models.whisper.init_encdec`), with decoder layers
    stacked on a leading super-block axis; the numbers differ from the
    reference's.  Layers are drawn one by one into the stacked
    tensors, so the peak is the model plus one layer; a single
    super-block (jamba at depth 8, llama4 at depth 2) is stacked as
    views, so the peak is the model plus one leaf."""
    ini = _Init(seed, resolve_device(device), dtype_of(plan.param_dtype))
    if cfg.family == "encdec":
        from repro_torch.models.whisper import init_encdec
        return init_encdec(ini, cfg, plan)
    return draw_params(ini, cfg, plan)


def map_leaves(tree, fn, path: str = ""):
    """``fn(leaf, path)`` over a nested dict, the same nesting back."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(tree, path)


def draw_params(ini: _Init, cfg, plan, leaf=None) -> Params:
    """:func:`init_params`' tree of every family but encdec, drawn from
    ``ini`` in its order.  ``leaf(t, path)``, where given, maps each leaf
    as soon as it is drawn (a stacked layer's leaf without its layer
    axis, at ``blocks/l0/...``), before the next is drawn: this is how
    a rank of the ring keeps only its slice of each
    (``weights.init_shard``)."""
    def put(tree, path):
        return tree if leaf is None else map_leaves(tree, leaf, path)
    D = cfg.d_model
    params: Params = {}
    if cfg.tie_embeddings:
        params["embed"] = put(ini.param((plan.vocab_padded, D)), "embed")
    else:
        params["embed_in"] = put(ini.param((cfg.vocab_size, D)), "embed_in")
        params["head"] = put(ini.param((D, plan.vocab_padded)), "head")
    if cfg.positional == "learned":
        params["pos_embed"] = put(ini.param((cfg.max_seq, D)), "pos_embed")
    if cfg.vlm is not None:
        params["projector"] = put(ini.param((cfg.vlm.patch_embed_dim, D)),
                                  "projector")

    if cfg.family in ("hybrid", "moe"):
        from repro_torch.models.transformer import n_super_blocks
        params["blocks"] = _stacked_parts(
            n_super_blocks(cfg), lambda: init_super_block(ini, cfg, plan,
                                                          put))
    else:
        if cfg.family == "rwkv":
            def layer():
                return {"ln1": _init_norm(ini, D, cfg.norm),
                        "tmix": _init_time_mix(ini, cfg, plan),
                        "ln2": _init_norm(ini, D, cfg.norm),
                        "cmix": _init_channel_mix(ini, cfg, plan)}
        else:
            def layer():
                return _init_dense_layer(ini, cfg, plan)
        params["blocks"] = {"l0": _stacked(
            cfg.n_layers, lambda: put(layer(), "blocks/l0"))}
    params["ln_f"] = put(_init_norm(ini, D, cfg.norm), "ln_f")
    return params


def _init_dense_layer(ini: _Init, cfg, plan) -> Params:
    D = cfg.d_model
    return {"ln1": _init_norm(ini, D, cfg.norm),
            "attn": _init_attention(ini, cfg, plan),
            "ln2": _init_norm(ini, D, cfg.norm),
            "mlp": _init_mlp(ini, cfg, plan)}


def _stacked(n: int, make) -> Params:
    """``n`` trees from ``make()``, stacked leaf by leaf on a new leading
    axis (:func:`_stacked_parts` of one part)."""
    return _stacked_parts(n, lambda: iter([("", make())]))[""]


def _stacked_parts(n: int, make_parts) -> Params:
    """``n`` draws of ``make_parts()``, an iterator of (key, tree) pairs
    drawn one at a time (a super-block's layers), each tree stacked leaf
    by leaf on a new leading axis under its key and written into the
    stack as soon as it is drawn: the peak is the stack and one tree
    (one layer of jamba, not its super-block of eight).  With ``n`` 1
    the trees are stacked as views (``unsqueeze``): no copy, so a model
    that is one super-block (jamba at depth 8) is never held twice."""
    def view(t):
        if isinstance(t, dict):
            return {k: view(v) for k, v in t.items()}
        return t.unsqueeze(0)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                           device=t.device)

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    out: Params = {}
    for i in range(n):
        for key, tree in make_parts():
            if i == 0:
                out[key] = view(tree) if n == 1 else alloc(tree)
            if n > 1:
                put(out[key], tree, i)
            del tree
    return out
