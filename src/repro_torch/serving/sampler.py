"""Token sampler on a ``torch.Generator``.

The port of the reference's ``serving/sampler.py`` at tp=1:

* :func:`sample_local` — temperature / top-k / top-p over full logits
  rows with one static :class:`SamplingParams`;
* :func:`sample_batched` — the fused form the engine runs on the device
  every decode step, with per-slot parameters as tensors.

Both share one filter chain (temperature -> top-k -> top-p, the top-p
cutoff being the SMALLEST kept logit, as the reference fixed it) and
draw a categorical sample with the exponential race (argmax of
``logits - log E``, E ~ Exp(1)).  Greedy rows (temperature <= 0) are the
argmax of the raw row and consume no random numbers.  The draws cannot
match JAX's threefry bit for bit; tests compare distributions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


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
