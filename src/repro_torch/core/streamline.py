"""Streamlined decode chain (C1) on the port's hand-written kernels.

The LPU's thesis: a generation step costs the weight-stream time, so the
decode path is a chain of bandwidth-bound streamed ops with no
reshaping between them:

    gemv(QKV, fused)  ->  decode attention (paged or dense)
 -> gemv(O) -> gemv(FC1 gate|up, fused) -> gemv(FC2)

A port of the reference's ``core/streamline.py``.  Every matmul is the
Hopper GEMV (``kernels/gemv``), attention is the paged kernel streaming
through the block table or the dense kernel (``kernels/decode_attention``).
``use_kernels=False`` takes the plain PyTorch versions: the oracle switch
the tests and ``chip_smoke.py`` use.  On CPU tensors the wrappers run the
plain versions anyway, so the two settings agree there.

Unlike the reference, whose arrays are immutable, the layer updates the
KV cache in place (the dense cache, or the shared pool and, for an
int8/fp8 pool, its scales); the returned cache dict holds the same
tensors.  As in the reference, the fused wq|wk|wv and wg|wu weights are
concatenated, and with ``w_dtype="int8"`` every weight is quantized, on
every call.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      paged_decode_attention,
                                                      resolve_paged_kernel)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_ref, paged_decode_attention_ref)
from repro_torch.kernels.gemv.ops import gemv, quantize_weight
from repro_torch.kernels.gemv.ref import gemv_ref
from repro_torch.models.common import apply_norm, apply_rope
from repro_torch.serving.kv_cache import quantize_kv_rows, scatter_chunk_rows

Params = Dict[str, Any]

W_DTYPES = ("auto", "int8")


def _mm(x2d: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], *,
        use_kernels: bool, quantize: bool = False) -> torch.Tensor:
    mm = gemv if use_kernels else gemv_ref
    if quantize:
        # int8 weight stream: per-output-column absmax scales, applied
        # once at the kernel's f32 flush
        qw, ws = quantize_weight(w)
        return mm(x2d, qw, b, w_scale=ws)
    return mm(x2d, w, b)


def _attend_dense(q, k, v, lengths, use_kernels):
    fn = decode_attention if use_kernels else decode_attention_ref
    return fn(q.contiguous(), k, v, lengths)


def _attend_paged(q, kc, vc, tables, lengths, use_kernels, **scales):
    fn = paged_decode_attention if use_kernels \
        else paged_decode_attention_ref
    return fn(q.contiguous(), kc, vc, tables, lengths, **scales)


def _qkv(p: Params, h: torch.Tensor, plan, *, use_kernels: bool,
         quantize: bool = False):
    """Fused QKV gemv: (R, D) -> q (R, qpr, dh), k, v (R, kpr, dh)."""
    a = plan.attn
    R, D = h.shape
    qpr, kpr, dh = a.q_per_rank, a.kv_per_rank, a.d_head
    wqkv = torch.cat([p["attn"]["wq"].reshape(D, qpr * dh),
                      p["attn"]["wk"].reshape(D, kpr * dh),
                      p["attn"]["wv"].reshape(D, kpr * dh)], -1)
    bqkv = None
    if "bq" in p["attn"]:
        bqkv = torch.cat([p["attn"][k].reshape(-1)
                          for k in ("bq", "bk", "bv")])
    qkv = _mm(h, wqkv, bqkv, use_kernels=use_kernels, quantize=quantize)
    q, k_new, v_new = torch.split(qkv, [qpr * dh, kpr * dh, kpr * dh], -1)
    return (q.reshape(R, qpr, dh), k_new.reshape(R, kpr, dh),
            v_new.reshape(R, kpr, dh))


def _out_and_mlp(p: Params, x: torch.Tensor, attn: torch.Tensor, *, cfg,
                 plan, use_kernels: bool, quantize: bool = False
                 ) -> torch.Tensor:
    """O gemv + residual, then the MLP's gemvs + residual."""
    a = plan.attn
    R, D = x.shape
    wo = p["attn"]["wo"].reshape(a.q_per_rank * a.d_head, D)
    x = x + _mm(attn.reshape(R, -1), wo, None, use_kernels=use_kernels,
                quantize=quantize)
    h = apply_norm(p["ln2"], x, cfg.norm)
    if "wg" in p["mlp"]:
        w1 = torch.cat([p["mlp"]["wg"], p["mlp"]["wu"]], -1)
        gu = _mm(h, w1, None, use_kernels=use_kernels, quantize=quantize)
        g, u = torch.chunk(gu, 2, -1)
        act = F.silu(g) * u if cfg.activation == "silu" else \
            F.gelu(g, approximate="tanh") * u
    else:
        act = _mm(h, p["mlp"]["wi"], p["mlp"].get("bi"),
                  use_kernels=use_kernels, quantize=quantize)
        act = F.relu(act) if cfg.activation == "relu" else \
            F.gelu(act, approximate="tanh")
    y = _mm(act, p["mlp"]["wd"], p["mlp"].get("bd"),
            use_kernels=use_kernels, quantize=quantize)
    return x + y


def decode_layer(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 positions: torch.Tensor, *, cfg, plan,
                 use_kernels: bool = True,
                 block_table: Optional[torch.Tensor] = None,
                 paged_kernel: str = "auto",
                 w_dtype: str = "auto"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer, one token per row, single device.

    x: (B, D); cache: {'k','v': (B, S, G, dh)}; positions: (B,) int32.
    Returns (y (B, D), cache) with the cache updated in place (the same
    tensors).  Weights in the mapper's stored layout.

    Paged mode (``block_table`` (B, T) int32 given): cache k/v are the
    shared block pool (N, bs, G, dh).  The new token's KV is written to
    physical block ``table[b, pos // bs]`` at offset ``pos % bs``, then
    attention reads the updated pool over ``positions + 1`` tokens.
    ``paged_kernel``: ``"stream"`` runs the paged kernel straight through
    the block table; ``"gather"`` materializes the per-request view and
    runs the dense kernel on it; ``"auto"`` streams when the plan allows
    (:func:`resolve_paged_kernel`).

    Quantized pool (``k_scale``/``v_scale`` (N, bs, G) present): the new
    rows are quantized when written and dequantized in the kernel's tile
    loop, so the current token is attended through its quantized round
    trip.  ``w_dtype="int8"`` streams every gemv's weight as int8 with
    per-output-column scales.
    """
    if w_dtype not in W_DTYPES:
        raise ValueError(f"w_dtype={w_dtype!r} not in {W_DTYPES}")
    qw = w_dtype == "int8"
    a = plan.attn
    B = x.shape[0]

    h = apply_norm(p["ln1"], x, cfg.norm)
    q, k_new, v_new = _qkv(p, h, plan, use_kernels=use_kernels, quantize=qw)
    if cfg.positional == "rope":
        q = apply_rope(q[:, None], positions[:, None], cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new[:, None], positions[:, None],
                           cfg.rope_theta)[:, 0]

    kc, vc = cache["k"], cache["v"]
    lengths = (positions + 1).to(torch.int32)
    pos = positions.long()
    quantized = block_table is not None and "k_scale" in cache
    if block_table is not None:
        # pool scatter: one (G, dh) row per sequence; idle slots all
        # target the null block 0 (masked by the valid length)
        bs = kc.shape[1]
        blk = block_table.long().gather(1, (pos // bs)[:, None])[:, 0]
        off = pos % bs
        scales = {}
        if quantized:
            ks, vs = cache["k_scale"], cache["v_scale"]
            kq, ksc = quantize_kv_rows(k_new, kc.dtype, ks.dtype)
            vq, vsc = quantize_kv_rows(v_new, vc.dtype, vs.dtype)
            kc[blk, off], vc[blk, off] = kq, vq
            ks[blk, off], vs[blk, off] = ksc, vsc
            scales = dict(k_scale=ks, v_scale=vs)
        else:
            kc[blk, off] = k_new.to(kc.dtype)
            vc[blk, off] = v_new.to(vc.dtype)
        mode = resolve_paged_kernel(plan, bs, paged_kernel)
        if mode == "stream":
            attn = _attend_paged(q, kc, vc, block_table, lengths,
                                 use_kernels, **scales)
        else:
            T = block_table.shape[1]
            tbl = block_table.long()
            k_view = kc[tbl].reshape(B, T * bs, *kc.shape[2:])
            v_view = vc[tbl].reshape(B, T * bs, *vc.shape[2:])
            if quantized:
                k_view = k_view.float() * scales["k_scale"][tbl].reshape(
                    B, T * bs, a.kv_per_rank)[..., None].float()
                v_view = v_view.float() * scales["v_scale"][tbl].reshape(
                    B, T * bs, a.kv_per_rank)[..., None].float()
            attn = _attend_dense(q, k_view, v_view, lengths, use_kernels)
    else:
        rows = torch.arange(B, device=x.device)
        kc[rows, pos] = k_new.to(kc.dtype)
        vc[rows, pos] = v_new.to(vc.dtype)
        attn = _attend_dense(q, kc, vc, lengths, use_kernels)
    y = _out_and_mlp(p, x, attn, cfg=cfg, plan=plan,
                     use_kernels=use_kernels, quantize=qw)
    return y, cache


def chunk_prefill_layer(p: Params, x: torch.Tensor,
                        cache: Dict[str, torch.Tensor],
                        block_table: torch.Tensor,
                        start: Union[int, torch.Tensor],
                        n_valid: Union[int, torch.Tensor], *, cfg, plan,
                        use_kernels: bool = True,
                        paged_kernel: str = "auto"
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer over ONE prefill chunk, single device.

    The chunk's C rows run through the same gemvs as decode, and
    attention treats the chunk as C single-token queries over the
    request's (broadcast) block table with per-query lengths
    ``start + i + 1``: causality over history and the chunk's own prefix
    falls out of the kernel's length masking.

    x: (C, D); cache: {'k','v': (N, bs, G, dh)} the shared pool, updated
    in place; block_table: (T,) int32; start: absolute offset of the
    chunk; n_valid: valid rows (padded tail rows go to the null block 0).
    Returns (y (C, D), cache).
    """
    C = x.shape[0]
    dev = x.device
    h = apply_norm(p["ln1"], x, cfg.norm)
    q, k_new, v_new = _qkv(p, h, plan, use_kernels=use_kernels)
    start = torch.as_tensor(start, dtype=torch.int32, device=dev)
    end = start + torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
    positions = start + torch.arange(C, dtype=torch.int32, device=dev)
    if cfg.positional == "rope":
        q = apply_rope(q[None], positions[None], cfg.rope_theta)[0]
        k_new = apply_rope(k_new[None], positions[None], cfg.rope_theta)[0]

    valid = positions < end
    kc = scatter_chunk_rows(cache["k"], k_new, block_table, positions, valid)
    vc = scatter_chunk_rows(cache["v"], v_new, block_table, positions, valid)
    bs = kc.shape[1]
    lens = torch.minimum(positions + 1, end).to(torch.int32)
    T = block_table.shape[0]
    mode = resolve_paged_kernel(plan, bs, paged_kernel)
    if mode == "stream":
        tabs = block_table[None].expand(C, T).contiguous()
        attn = _attend_paged(q, kc, vc, tabs, lens, use_kernels)
    else:
        tbl = block_table.long()
        k_view = kc[tbl].reshape(1, T * bs, *kc.shape[2:]).expand(
            C, T * bs, *kc.shape[2:])
        v_view = vc[tbl].reshape(1, T * bs, *vc.shape[2:]).expand(
            C, T * bs, *vc.shape[2:])
        attn = _attend_dense(q, k_view, v_view, lens, use_kernels)
    y = _out_and_mlp(p, x, attn, cfg=cfg, plan=plan, use_kernels=use_kernels)
    return y, cache


def verify_layer(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 block_tables: torch.Tensor, positions: torch.Tensor, *, cfg,
                 plan, use_kernels: bool = True, paged_kernel: str = "auto",
                 w_dtype: str = "auto"
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder layer over one speculative verify window.

    The window flattens every slot's (last token + k drafts) into Q
    single-token queries, each with its own block table and position —
    exactly the streamed decode dataflow: :func:`decode_layer` writes all
    Q new KV rows into the pool first, then attends each query over
    ``positions + 1`` tokens, so draft i sees drafts < i of its window.

    x: (Q, D); block_tables: (Q, T); positions: (Q,).
    """
    return decode_layer(p, x, cache, positions, cfg=cfg, plan=plan,
                        use_kernels=use_kernels, block_table=block_tables,
                        paged_kernel=paged_kernel, w_dtype=w_dtype)


def stream_bytes_per_layer(cfg, plan, kv_len: int) -> int:
    """Analytic bytes streamed per token per layer (latency model input),
    at 2 bytes per weight and KV element, as in the reference."""
    a = plan.attn
    d = cfg.d_model
    wbytes = 2 * (d * (a.hp + 2 * a.gp) * a.d_head // plan.tp
                  + a.hp * a.d_head * d // plan.tp)
    n_mat = 3 if cfg.mlp_gated else 2
    wbytes += 2 * n_mat * d * plan.d_ff_padded // plan.tp
    kv_bytes = 2 * 2 * kv_len * (a.gp // plan.tp) * a.d_head
    return wbytes + kv_bytes
