"""Draft-token proposers for speculative decoding — a copy of the
reference's ``serving/drafter.py``.

The engine's speculative path is draft-and-verify: a *drafter* proposes
up to ``k`` continuation tokens per decode slot on the host, the engine
scores all ``k+1`` positions in ONE verify forward (the queries are the
paged kernel's batch, one table each), and rejection sampling accepts a
prefix.  Rejection sampling works for any proposal, so a bad draft costs
acceptance, never correctness:

* :class:`NGramDrafter` — self-speculation by suffix match: find the
  longest recent n-gram suffix of the sequence that occurred earlier
  and propose the tokens that followed it.  No extra FLOPs; on
  repetitive text (code, templated output, greedy loops) it predicts
  the target well.
* :class:`ModelDrafter` — a small model of the port (e.g. smollm-135m
  ``reduced()``) decoded greedily.  Stateless between calls: each
  proposal re-scores the whole context through power-of-two bucketed
  prefill forwards, so a rejected window needs no rollback.

Drafters are deterministic: the verify rule assumes a one-hot proposal
(accept draft ``d`` with probability ``p(d)``), and greedy parity with
plain decoding needs the drafts to be a pure function of the visible
tokens.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


class NGramDrafter:
    """Propose the continuation of the longest matched suffix n-gram.

    For context ``t_0 .. t_{n-1}``, try suffix lengths ``max_n .. min_n``:
    if the length-m suffix occurs earlier in the context, propose the
    token that followed its MOST RECENT earlier occurrence, append it
    and repeat, up to ``k`` tokens.  Returns ``[]`` on a cold miss (the
    engine then runs a plain round)."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"({min_n}, {max_n})")
        self.max_n = max_n
        self.min_n = min_n

    def _next(self, toks: List[int]) -> Optional[int]:
        """Predict ONE token: longest suffix n-gram, most recent match."""
        n = len(toks)
        for m in range(min(self.max_n, n - 1), self.min_n - 1, -1):
            pat = toks[n - m:]
            # j = exclusive end of an earlier occurrence; it may overlap
            # the suffix (periodic text, period < m)
            for j in range(n - 1, m - 1, -1):
                if toks[j - m:j] == pat:
                    return toks[j]
        return None

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        ext = [int(t) for t in tokens]
        out: List[int] = []
        for _ in range(k):
            t = self._next(ext)
            if t is None:
                break
            out.append(t)
            ext.append(t)
        return out


class ModelDrafter:
    """Greedy draft proposals from a small model of the port.

    Runs the draft model's dense prefill forward over the whole visible
    context, padded to a power-of-two bucket (right padding is invisible
    to the causal rows before it), on the model's own device, and
    extends the context greedily token by token: ``k`` forwards per
    proposal.  No state is kept between calls, so rejected windows and
    preemption need no draft-side rollback.  The draft model runs at
    tp 1 even when the target serves on the model ring (as the
    reference's builds its own tp=1 env): each rank holds the whole
    draft model on its own device, and the same weights and the same
    streams give every rank the same drafts without a broadcast."""

    def __init__(self, model, params, max_seq: int = 2048):
        if model.plan.tp != 1:
            raise ValueError(
                f"the draft model is planned for tp={model.plan.tp}: it "
                "runs whole on each rank's device (plan it with mesh None)")
        self.model = model
        self.params = params
        self.max_seq = max_seq

    def _last_row(self, toks: List[int]) -> torch.Tensor:
        n = len(toks)
        bucket = 1
        while bucket < n:
            bucket *= 2
        dev = self.model.device
        buf = torch.zeros((1, bucket), dtype=torch.long, device=dev)
        buf[0, :n] = torch.tensor(toks, dtype=torch.long, device=dev)
        logits, _ = self.model.forward(
            self.params, buf, mode="prefill",
            positions=torch.arange(bucket, device=dev)[None],
            cache=self.model.init_cache(1, bucket))
        return logits[0, n - 1]

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        toks = [int(t) for t in tokens]
        out: List[int] = []
        for _ in range(k):
            if len(toks) >= self.max_seq:
                break
            nxt = int(self._last_row(toks).argmax())
            out.append(nxt)
            toks.append(nxt)
        return out


class ProposalLog:
    """A drafter whose every proposal is kept, in order, in
    ``proposals``: on a ring every rank must propose the same drafts,
    which the ranks' logs show."""

    def __init__(self, inner):
        self.inner = inner
        self.proposals: List[List[int]] = []

    def propose(self, tokens: Sequence[int], k: int) -> List[int]:
        p = self.inner.propose(tokens, k)
        self.proposals.append([int(t) for t in p])
        return p


def make_drafter(kind: str, *, draft_model=None, draft_params=None,
                 max_seq: int = 2048) -> Optional[object]:
    """The drafter for ``EngineConfig(speculate=...)``: None for
    ``"off"``, an :class:`NGramDrafter` for ``"ngram"``, a
    :class:`ModelDrafter` for ``"model"`` (which needs ``draft_model`` /
    ``draft_params``, e.g. smollm-135m ``reduced()``)."""
    if kind == "off":
        return None
    if kind == "ngram":
        return NGramDrafter()
    if kind == "model":
        if draft_model is None or draft_params is None:
            raise ValueError(
                "speculate='model' needs draft_model/draft_params "
                "(a small model, e.g. smollm-135m reduced)")
        return ModelDrafter(draft_model, draft_params, max_seq=max_seq)
    raise ValueError(f"unknown speculate mode {kind!r}")
