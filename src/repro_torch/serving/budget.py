"""Latency-budget (SLO) step scheduling for the async front end (a copy of
the reference's ``serving/budget.py``).

The engine has two per-step latency knobs:

* ``steps_per_sync`` (S) — decode tokens fused into one device window
  before the host syncs.  A bigger S amortizes dispatch and sync
  (throughput) but delays reconciliation by S tokens (tail latency): a
  window is the granularity at which tokens reach users.
* ``prefill_chunk`` (C) — prompt tokens made resident per step in
  chunked-prefill mode.  A bigger C admits faster (the admitting
  request's TTFT) but each chunk occupies the step for longer,
  stretching every in-flight stream's inter-token gap.

:class:`BudgetScheduler` picks both before every step so one engine step
fits a caller-given latency budget: an EWMA of *measured* per-decode-step
and per-chunk-token times, seeded from the analytic prior
(:func:`repro_torch.core.latency_model.step_time_prior`).

Chunk widths are quantized to powers of two: the engine keeps one
program per chunk width (on the card a captured CUDA graph), so a
free-running C would trade its latency gain back as captures.  A window
size costs one program per S as well, and S is bounded by
``MAX_STEPS_PER_SYNC``.
"""
from __future__ import annotations

from typing import Optional, Tuple

ALPHA = 0.25               # EWMA weight of one new measurement
MAX_STEPS_PER_SYNC = 16    # the largest window planned
MIN_CHUNK = 8              # the narrowest chunk planned


def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class BudgetScheduler:
    """EWMA-tracked per-step latency model and knob planner.

    Parameters
    ----------
    budget_ms:
        Target wall time of ONE engine step.  The planner picks the
        largest S (and C) whose predicted cost stays under it.
    prior_step_s:
        Analytic seed of the per-decode-step EWMA (seconds), normally
        ``step_time_prior(cfg, n_devices, hw)``.  ``0`` falls back to
        ``budget_ms`` itself (first window = 1 step, then measure).  It
        seeds the per-prefill-token EWMA too (one prompt token ~ one
        decode step's compute bounds the chunked path from above); the
        first measured chunk corrects it.
    max_chunk:
        The widest chunk planned.
    """

    def __init__(self, budget_ms: float, *, prior_step_s: float = 0.0,
                 max_chunk: int = 256):
        if budget_ms <= 0:
            raise ValueError(f"budget_ms={budget_ms} must be > 0")
        if max_chunk < MIN_CHUNK:
            raise ValueError(f"max_chunk={max_chunk} must be >= "
                             f"{MIN_CHUNK}")
        self.budget_s = budget_ms * 1e-3
        self.max_chunk = int(max_chunk)
        self.mu_step = float(prior_step_s) or self.budget_s
        self.mu_tok = self.mu_step
        self.observed_windows = 0
        self.observed_chunks = 0
        self.planned: list = []         # (chunk, steps) telemetry trail

    # -- measurement ---------------------------------------------------

    def observe_window(self, dt_s: float, steps: int) -> None:
        """Fold one measured decode window (``steps`` fused device steps
        in ``dt_s`` seconds) into the per-step EWMA."""
        if steps < 1 or dt_s < 0:
            return
        x = dt_s / steps
        self.mu_step += ALPHA * (x - self.mu_step)
        self.observed_windows += 1

    def observe_chunk(self, dt_s: float, tokens: int) -> None:
        """Fold one measured prefill chunk into the per-token EWMA."""
        if tokens < 1 or dt_s < 0:
            return
        x = dt_s / tokens
        self.mu_tok += ALPHA * (x - self.mu_tok)
        self.observed_chunks += 1

    def observe_tick(self, dt_s: float, steps: int, chunks: int,
                     tokens: int) -> None:
        """Fold one engine step of ``dt_s`` seconds that ran ``steps``
        decode steps and ``chunks`` prefill chunks of ``tokens`` prompt
        tokens in all (the front end's pump tick)."""
        if steps and not chunks:
            self.observe_window(dt_s, steps)
        elif chunks and not steps:
            self.observe_chunk(dt_s, tokens)
        elif steps and chunks:
            # a mixed tick (a prefill chunk AND a decode window in one
            # step): split the measured wall between the phases in
            # proportion to the model's current predictions.  Skipping
            # mixed ticks would never train the EWMA on a fully
            # interleaved load, and the split still converges: the phase
            # the model underestimates takes a larger share of the
            # residual on the next update.
            pred_w = self.mu_step * steps
            pred_c = self.mu_tok * max(tokens, 1)
            total = pred_w + pred_c
            if total > 0:
                self.observe_window(dt_s * pred_w / total, steps)
                self.observe_chunk(dt_s * pred_c / total, max(tokens, 1))

    # -- planning ------------------------------------------------------

    def plan_steps(self) -> int:
        """Largest fused window predicted to fit the budget."""
        s = int(self.budget_s / max(self.mu_step, 1e-9))
        return max(1, min(s, MAX_STEPS_PER_SYNC))

    def plan_chunk(self) -> int:
        """Largest pow2 chunk width predicted to fit the budget."""
        c = int(self.budget_s / max(self.mu_tok, 1e-9))
        c = max(MIN_CHUNK, min(c, self.max_chunk))
        return _pow2_floor(c)

    def plan(self, *, chunked: bool = True,
             fused: bool = True) -> Tuple[Optional[int], int]:
        """One (prefill_chunk, steps_per_sync) decision for the next
        engine step.  ``chunked=False`` (the engine prefills
        monolithically) returns ``None`` for the chunk, so the caller
        leaves that knob alone; ``fused=False`` (host sampling) pins S
        to 1."""
        chunk = self.plan_chunk() if chunked else None
        steps = self.plan_steps() if fused else 1
        self.planned.append((chunk, steps))
        return chunk, steps
