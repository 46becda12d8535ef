"""Serving fault-tolerance policies: detection, chaos, and clocks — a
copy of the reference's ``serving/ft.py`` (pure Python, as it is there).

The ROADMAP's fleet-scale story ("millions of users") dies on the first
wedged ring unless failure is a first-class input, so the policies that
used to sit unused beside the training driver live here now, driven by
per-ring *serving* telemetry:

* :class:`StragglerMonitor` — EWMA/σ step-time outlier detection over
  an engine's measured ``step()`` wall time.  ``mu0`` seeds the mean
  from the analytic latency model
  (:func:`repro_torch.core.latency_model.step_time_prior`) so detection is
  armed before the warmup window closes.
* :class:`HeartbeatTracker` — per-ring liveness with a configurable
  timeout and an **injected clock** (any ``() -> float`` callable;
  defaults to ``time.time``), so liveness transitions are testable
  without sleeping.  :meth:`HeartbeatTracker.revive` returns a rebuilt
  ring to rotation.
* :class:`FailureInjector` — deterministic chaos.  The legacy
  ``fail_at_steps`` / :meth:`FailureInjector.maybe_fail` contract (raise
  once at a configured step) is kept for the training driver; serving
  uses :func:`parse_chaos` specs and :meth:`FailureInjector.fire`,
  which returns each configured :class:`ChaosEvent` exactly once when
  its (step, ring) comes up.
* :class:`RingFailure` — the structured exception an engine raises when
  it detects (or chaos injects) a ring-level fault;
  ``MultiRingEngine.step`` catches it and runs the drain → migrate →
  rebuild cycle instead of crashing the fleet.
* :class:`ManualClock` — a deterministic clock for liveness tests and
  chaos runs: ``clock()`` reads it, ``advance(dt)`` moves it.

Recovery is *recompute*-shaped, like preemption: a failed ring's
in-flight requests resume from ``Request.resume_tokens()`` on a
surviving ring, so greedy token streams are bit-identical to a
fault-free run (tests/test_torch_fault_tolerance.py holds the port to the
reference's fleet).
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class Event:
    kind: str            # 'straggler' | 'worker_failed' | 'rebalance' |
                         # 'ring_failed' | 'ring_rebuilt' |
                         # 'request_failed' | 'request_rejected'
    step: int
    detail: dict


CHAOS_KINDS = ("ring", "stall", "nan", "corrupt")


@dataclass(frozen=True)
class ChaosEvent:
    """One deterministic fault: ``kind`` fires at engine step ``step``
    on ring ``ring`` (and never again).

    * ``ring``    — the engine raises :class:`RingFailure` outright
                    (a crashed/partitioned ring).
    * ``stall``   — the engine stops making progress (a wedged window);
                    only the heartbeat timeout can clear it.
    * ``nan``     — the next decode program's logits are poisoned with
                    NaN *on device*, exercising the finite-logits guard.
    * ``corrupt`` — a resident KV pool block is overwritten with NaN,
                    exercising the same guard one hop downstream.
    """
    kind: str
    step: int
    ring: int = 0


def parse_chaos(spec: str) -> List[ChaosEvent]:
    """Parse a ``--chaos`` spec: comma-separated ``kind@step[:ring]``.

    Example: ``"ring@3,stall@5:1,nan@7,corrupt@9:0"`` — a ring failure
    at step 3 of ring 0, a stalled window at step 5 of ring 1, NaN
    logits at step 7 of ring 0, a corrupted pool block at step 9 of
    ring 0.  Steps count an engine's own ``step()`` calls from 1.
    """
    events: List[ChaosEvent] = []
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            kind, rest = part.split("@", 1)
            if ":" in rest:
                step_s, ring_s = rest.split(":", 1)
            else:
                step_s, ring_s = rest, "0"
            step, ring = int(step_s), int(ring_s)
        except ValueError:
            raise ValueError(
                f"bad chaos event {part!r}: expected kind@step[:ring]")
        if kind not in CHAOS_KINDS:
            raise ValueError(
                f"bad chaos kind {kind!r}: expected one of {CHAOS_KINDS}")
        if step < 1 or ring < 0:
            raise ValueError(
                f"bad chaos event {part!r}: step >= 1, ring >= 0")
        events.append(ChaosEvent(kind, step, ring))
    return events


class RingFailure(RuntimeError):
    """A ring-level fault detected (or injected) inside an engine step.

    Carries enough structure for the supervisor's recovery path and the
    event log: ``reason`` ('injected_ring_failure' | 'nan_logits' |
    'heartbeat_timeout' | 'straggler'), the engine step and ring id,
    and a free-form ``detail`` dict.
    """

    def __init__(self, reason: str, step: int = 0, ring: int = 0,
                 detail: Optional[dict] = None):
        super().__init__(f"[ring {ring}] {reason} at step {step}")
        self.reason = reason
        self.step = step
        self.ring = ring
        self.detail = detail or {}


class ManualClock:
    """A deterministic injectable clock: ``clock()`` reads seconds,
    ``advance(dt)`` moves time forward.  Chaos runs and liveness tests
    use it so a 30 s heartbeat timeout never means 30 s of wall time."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class StragglerMonitor:
    """EWMA + variance step-time tracking; flags > mu + k*sigma.

    ``mu0`` (optional) seeds the running mean from a prior — serving
    seeds it with the analytic latency model's step-time estimate
    (:func:`repro_torch.core.latency_model.step_time_prior`) so the very
    first slow step can already be judged against *something* instead
    of silently becoming the baseline.
    """

    def __init__(self, alpha: float = 0.1, k_sigma: float = 3.0,
                 warmup: int = 5, cooldown: int = 20,
                 min_slack: float = 0.25, mu0: Optional[float] = None):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup
        self.cooldown = cooldown
        self.min_slack = min_slack     # never flag < (1+slack)*mu drift
        self.mu: Optional[float] = mu0
        self.var: float = 0.0
        self.n = 0
        self._last_flag = -10 ** 9
        self.events: List[Event] = []

    def record(self, step: int, dt: float) -> Optional[Event]:
        self.n += 1
        if self.mu is None:
            self.mu = dt
            return None
        thresh = max(self.mu + self.k * math.sqrt(self.var + 1e-12),
                     self.mu * (1.0 + self.min_slack))
        flagged = (self.n > self.warmup and dt > thresh
                   and step - self._last_flag >= self.cooldown)
        # EWMA update (skip outliers so one straggler doesn't poison mu)
        if not flagged:
            d = dt - self.mu
            self.mu += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if flagged:
            self._last_flag = step
            ev = Event("straggler", step,
                       {"dt": dt, "mu": self.mu, "thresh": thresh})
            self.events.append(ev)
            return ev
        return None


class HeartbeatTracker:
    """Per-worker (per-ring) liveness with an injected clock.

    ``clock`` is any ``() -> float``; explicit ``now=`` arguments win
    over it call by call (the pre-existing test contract).  A worker
    whose last beat is older than ``timeout_s`` is reported failed by
    :meth:`check` exactly once; :meth:`revive` clears the failed mark
    and restamps the beat — the rebuilt-ring half of drain/rebuild.
    """

    def __init__(self, n_workers: int, timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.time):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[int, float] = {i: clock()
                                       for i in range(n_workers)}
        self.failed: List[int] = []

    def beat(self, worker: int, now: Optional[float] = None):
        self.last[worker] = now if now is not None else self.clock()

    def check(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else self.clock()
        newly = [w for w, t in self.last.items()
                 if now - t > self.timeout and w not in self.failed]
        self.failed.extend(newly)
        return newly

    def revive(self, worker: int, now: Optional[float] = None):
        """Return a rebuilt worker to rotation: clear its failed mark
        and restamp its beat so it is judged fresh from now on."""
        if worker in self.failed:
            self.failed.remove(worker)
        self.beat(worker, now)


class FailureInjector:
    """Deterministic chaos, two contracts:

    * legacy (training driver): ``fail_at_steps`` raises RuntimeError
      the first time each configured step is reached
      (:meth:`maybe_fail`).
    * serving: ``chaos`` is a list of :class:`ChaosEvent`; :meth:`fire`
      returns each event exactly once when its (step, ring) matches —
      the caller decides what the kind means.  The fired-set survives
      an engine rebuild, so a replayed step number cannot re-fire.
    """

    def __init__(self, fail_at_steps: Sequence[int] = (),
                 chaos: Sequence[ChaosEvent] = ()):
        self.fail_at = set(fail_at_steps)
        self.fired = set()
        self.chaos = list(chaos)
        self._chaos_fired: set = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"[chaos] injected failure at step {step}")

    def fire(self, step: int, ring: int = 0) -> List[ChaosEvent]:
        """Chaos events configured for (step, ring), each at most once."""
        out: List[ChaosEvent] = []
        for idx, ev in enumerate(self.chaos):
            if ev.step == step and ev.ring == ring \
                    and idx not in self._chaos_fired:
                self._chaos_fired.add(idx)
                out.append(ev)
        return out
