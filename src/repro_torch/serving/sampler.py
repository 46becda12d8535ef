"""Token sampler on a ``torch.Generator``.

The port of the reference's ``serving/sampler.py``:

* :func:`sample_local` — temperature / top-k / top-p over full logits
  rows with one static :class:`SamplingParams`;
* :func:`sample_batched` — the fused form the engine runs on the device
  every decode step, with per-slot parameters as tensors;
* :func:`sample_sharded_batched` / :func:`sample_sharded` — the ring
  form for vocab-sharded logits: each rank pre-selects its local
  top-``MAX_LOCAL_K``, only the (tp x k) candidates are all-gathered,
  and every rank draws from them with an identically seeded generator,
  so the sampled ids agree ring-wide without a broadcast;
* :func:`speculative_verify_batched` / :func:`spec_verify_rows` — the
  rejection sampling of a speculative verify window (every slot's, or
  one slot's), which accepts a prefix of a deterministic drafter's
  proposal and keeps every emitted token an exact draw from the
  filtered target distribution; :func:`speculative_verify_sharded` —
  its ring form over vocab-sharded verify rows, on the same (tp x k)
  candidates as the ring's sampler.

Both share one filter chain (temperature -> top-k -> top-p, the top-p
cutoff being the SMALLEST kept logit, as the reference fixed it) and
draw a categorical sample with the exponential race (argmax of
``logits - log E``, E ~ Exp(1)).  Greedy rows (temperature <= 0) are the
argmax of the raw row and consume no random numbers.  The draws cannot
match JAX's threefry bit for bit; tests compare distributions.  Where the
reference splits one key per verify position (``split_spec_rng_chain``),
the port draws independent numbers per position from the generator.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dist


class SamplingParams(NamedTuple):
    temperature: float = 1.0
    top_k: int = 0              # 0 = off
    top_p: float = 1.0          # 1 = off


def filter_rows(lg_raw: torch.Tensor, temps: torch.Tensor,
                top_ks: torch.Tensor, top_ps: torch.Tensor) -> torch.Tensor:
    """Temperature / top-k / top-p filter over logits rows (B, V) with
    per-row parameters (B,): the rows scaled by temperature with
    everything outside the support set to ``-inf``, so
    ``softmax(filter_rows(...))`` is the distribution each row samples
    from (the reference's ``_filter_row``, batched)."""
    V = lg_raw.shape[-1]
    lg = lg_raw.float() / temps.float().clamp_min(1e-6)[:, None]
    asc = lg.sort(-1).values
    k_idx = (V - top_ks.long().clamp(1, V))[:, None]
    kth = asc.gather(-1, k_idx)
    lg = torch.where((top_ks > 0)[:, None] & (lg < kth), -torch.inf, lg)
    desc = lg.sort(-1, descending=True).values
    probs = torch.softmax(desc, -1)
    cum = probs.cumsum(-1)
    keep = cum - probs < top_ps.float()[:, None]
    cutoff = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
    return torch.where((top_ps < 1.0)[:, None] & (lg < cutoff),
                       -torch.inf, lg)


def _draw(lg: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One categorical draw per row of (B, V) logits (``-inf`` = never)."""
    e = torch.empty_like(lg).exponential_(generator=generator)
    return (lg - e.log()).argmax(-1)


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, stochastic: bool = True
                   ) -> torch.Tensor:
    """Per-slot sampling of (B, V) logits -> (B,) int32 token ids.

    ``temps``/``top_ks``/``top_ps`` (B,) live on the logits' device.
    ``stochastic=False`` (the caller knows every row is greedy) skips the
    filter and the draw, so greedy batches consume no random numbers."""
    greedy = logits.float().argmax(-1)
    if not stochastic:
        return greedy.to(torch.int32)
    drawn = _draw(filter_rows(logits, temps, top_ks, top_ps), generator)
    return torch.where(temps <= 0.0, greedy, drawn).to(torch.int32)


MAX_LOCAL_K = 64


def sample_sharded_batched(logits_loc: torch.Tensor,
                           generator: torch.Generator, temps: torch.Tensor,
                           top_ks: torch.Tensor, top_ps: torch.Tensor,
                           stochastic: bool = True,
                           axis: Optional[dist.Ring] = None, tp: int = 1
                           ) -> torch.Tensor:
    """Per-slot sampling of vocab-sharded logits (B, V/tp) -> (B,) int32
    global ids, the same on every rank of ``axis``.

    Each rank takes its local top-``MAX_LOCAL_K`` values and global ids,
    the (B, tp x k) candidates are all-gathered (rank order), and
    :func:`sample_batched` draws over them with the rank's generator,
    seeded alike on every rank: greedy rows take the lowest id among the
    candidates' maxima (:func:`first_max`), which is the global argmax.
    As in the reference, a stochastic row samples from the candidates, so
    a filter wider than tp x k candidates is cut to them.  ``axis=None`` or ``tp == 1`` is
    :func:`sample_batched`."""
    if axis is None or tp == 1:
        return sample_batched(logits_loc, generator, temps, top_ks, top_ps,
                              stochastic)
    v_loc = logits_loc.shape[-1]
    vals, idx = logits_loc.float().topk(min(MAX_LOCAL_K, v_loc), -1)
    gidx = idx + dist.axis_index(axis) * v_loc
    vals_all = dist.all_gather(vals, axis, dim=-1)
    gidx_all = dist.all_gather(gidx, axis, dim=-1)
    greedy = first_max(vals_all, gidx_all)
    if not stochastic:
        return greedy.to(torch.int32)
    drawn = _draw(filter_rows(vals_all, temps, top_ks, top_ps), generator)
    drawn = gidx_all.gather(-1, drawn[:, None])[:, 0]
    return torch.where(temps <= 0.0, greedy, drawn).to(torch.int32)


def first_max(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The lowest global id among the equal maxima of each row of the
    candidates ``vals`` (..., C) whose ids are ``ids``: the argmax of the
    whole row, whatever order each rank's top-k gave its ties (a row
    with a NaN gives its lowest candidate id)."""
    top = vals.amax(-1, keepdim=True)
    hit = (vals == top) | top.isnan()
    return ids.masked_fill(~hit, torch.iinfo(ids.dtype).max).amin(-1)


def sample_sharded(logits_loc: torch.Tensor, generator: torch.Generator,
                   params: SamplingParams, axis: Optional[dist.Ring],
                   tp: int) -> torch.Tensor:
    """(B, V/tp) vocab-sharded logits -> (B,) global ids with one static
    parameter set: the single-call form of
    :func:`sample_sharded_batched`."""
    B, dev = logits_loc.shape[0], logits_loc.device
    return sample_sharded_batched(
        logits_loc, generator,
        torch.full((B,), params.temperature, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), params.top_p, device=dev),
        params.temperature > 0.0, axis, tp)


def sample_local(logits: torch.Tensor, generator: torch.Generator,
                 params: SamplingParams) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32 ids with one static parameter set."""
    B = logits.shape[0]
    if params.temperature <= 0.0:
        return logits.float().argmax(-1).to(torch.int32)
    dev = logits.device
    return sample_batched(
        logits, generator,
        torch.full((B,), params.temperature, device=dev),
        torch.full((B,), params.top_k, dtype=torch.int32, device=dev),
        torch.full((B,), params.top_p, device=dev))


# ---------------------------------------------------------------------------
# speculative decoding: rejection sampling of a verify window
# ---------------------------------------------------------------------------

def speculative_verify_batched(logits: torch.Tensor, draft: torch.Tensor,
                               generator: torch.Generator,
                               temps: torch.Tensor, top_ks: torch.Tensor,
                               top_ps: torch.Tensor, stochastic: bool = True
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rejection sampling of one verify window for every slot.

    logits: (B, K+1, V) verify rows, row i scoring the token after
    verify position i; draft: (B, K) the proposed tokens; per-slot
    ``temps``/``top_ks``/``top_ps`` (B,) on the logits' device.  Returns
    ``(out (B, K+1) int32, n_acc (B,) int32)``: slot b emits
    ``out[b, :n_acc[b] + 1]``.

    The drafter is deterministic, so its proposal is one-hot and the
    rule is: accept ``draft[i]`` with probability ``p_i(draft[i])``
    (``p_i`` the softmax of the :func:`filter_rows`-filtered row i), else
    emit a draw from ``p_i`` with the draft masked out; after K accepts,
    a bonus draw from ``p_K``.  Every emitted token is then an exact
    draw from ``p_i`` whatever the drafter proposed, and a draft of zero
    mass is never accepted.  Each position takes its own uniform and
    its own categorical draw (the exponential race), independent of the
    others.  Greedy rows (temperature <= 0) take the argmax of each raw
    row, and ``n_acc`` counts the leading drafts equal to it: the
    sequential greedy stream, token for token.  ``stochastic=False``
    (the caller knows every row is greedy) skips the filter and the
    draws, so greedy windows consume no random numbers."""
    return _verify_window(logits, None, draft, generator, temps, top_ks,
                          top_ps, stochastic)


def speculative_verify_sharded(logits_loc: torch.Tensor,
                               draft: torch.Tensor,
                               generator: torch.Generator,
                               temps: torch.Tensor, top_ks: torch.Tensor,
                               top_ps: torch.Tensor, stochastic: bool = True,
                               axis: Optional[dist.Ring] = None, tp: int = 1
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring form of :func:`speculative_verify_batched` for
    vocab-sharded verify rows (B, K+1, V/tp) -> ``(out, n_acc)`` in
    global ids, the same on every rank of ``axis``.

    As :func:`sample_sharded_batched` does: each rank takes its local
    top-``MAX_LOCAL_K`` of every row and turns the indices into global
    ids, only the (B, K+1, tp x k) candidates are all-gathered (rank
    order), and the accept and resample draws run on that set with the
    rank's generator, seeded alike on every rank.  Greedy verification
    takes :func:`first_max` of the candidates, the tp=1 argmax exactly;
    a stochastic row samples from the candidates (a filter wider than
    them is cut to them), and a draft outside them has no mass there and
    is never accepted.  ``axis=None`` or ``tp == 1`` is
    :func:`speculative_verify_batched`."""
    if axis is None or tp == 1:
        return speculative_verify_batched(logits_loc, draft, generator,
                                          temps, top_ks, top_ps, stochastic)
    v_loc = logits_loc.shape[-1]
    vals, idx = logits_loc.float().topk(min(MAX_LOCAL_K, v_loc), -1)
    gidx = idx + dist.axis_index(axis) * v_loc
    return _verify_window(dist.all_gather(vals, axis, dim=-1),
                          dist.all_gather(gidx, axis, dim=-1), draft,
                          generator, temps, top_ks, top_ps, stochastic)


def _verify_window(vals: torch.Tensor, ids: Optional[torch.Tensor],
                   draft: torch.Tensor, generator: torch.Generator,
                   temps: torch.Tensor, top_ks: torch.Tensor,
                   top_ps: torch.Tensor, stochastic: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection sampling of :func:`speculative_verify_batched` over
    (B, K+1, C) raw logits of a candidate set whose global ids are
    ``ids`` (B, K+1, C), or the whole vocabulary (``ids=None``)."""
    B, K1, C = vals.shape
    K = K1 - 1
    lg_raw = vals.float()

    def glob(i):                      # candidate index -> global id
        return i if ids is None else ids.gather(-1, i[..., None])[..., 0]
    g_out = (lg_raw.argmax(-1) if ids is None else first_max(lg_raw, ids))
    draft = draft.long()
    out, match = g_out, g_out[:, :K] == draft
    if stochastic:
        # each slot's parameters over its K+1 rows (an expand: no host
        # sync, so the fused verify round captures as one graph)
        rep = lambda t: t[:, None].expand(B, K1).reshape(-1)  # noqa: E731
        lg = filter_rows(lg_raw.reshape(B * K1, C), rep(temps),
                         rep(top_ks), rep(top_ps)).reshape(B, K1, C)
        probs = torch.softmax(lg, -1)
        masked = lg.clone()
        if ids is None:
            p_draft = probs[:, :K].gather(-1, draft[..., None])[..., 0]
            masked[:, :K].scatter_(-1, draft[..., None], -torch.inf)
        else:
            is_d = ids[:, :K] == draft[..., None]
            p_draft = torch.where(is_d, probs[:, :K], 0.0).sum(-1)
            masked[:, :K] = torch.where(is_d, -torch.inf, lg[:, :K])
        u = torch.rand((B, K), generator=generator, device=vals.device)
        acc = u < p_draft
        drawn = glob(_draw(masked, generator))               # (B, K+1)
        s_out = torch.cat([torch.where(acc, draft, drawn[:, :K]),
                           drawn[:, K:]], 1)
        greedy = (temps <= 0.0)[:, None]
        out = torch.where(greedy, g_out, s_out)
        match = torch.where(greedy, match, acc)
    n_acc = match.int().cumprod(-1).sum(-1)
    return out.to(torch.int32), n_acc.to(torch.int32)


def spec_verify_rows(rows: torch.Tensor, draft: torch.Tensor,
                     generator: torch.Generator,
                     params: SamplingParams) -> Tuple[torch.Tensor, int]:
    """One slot's verify window over its (K+1, V) rows with one static
    parameter set: the host-sampling oracle's form of
    :func:`speculative_verify_batched`.  Returns ``(out (K+1,), n_acc)``;
    a greedy slot consumes no random numbers."""
    dev = rows.device
    out, n_acc = speculative_verify_batched(
        rows[None], draft[None], generator,
        torch.tensor([params.temperature], device=dev),
        torch.tensor([params.top_k], dtype=torch.int32, device=dev),
        torch.tensor([params.top_p], device=dev),
        params.temperature > 0.0)
    return out[0], int(n_acc[0])
