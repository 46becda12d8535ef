"""Async streaming front end over the port's :class:`LPUEngine` or
:class:`MultiRingEngine` (a copy of the reference's
``serving/frontend.py``).

The blocking ``submit/step/drain`` API measures throughput; users feel
per-request latency.  This module is the seam between the two: an
asyncio front end that

* streams tokens out as each decode window is read back —
  :meth:`AsyncFrontend.submit` returns a :class:`TokenStream` (an async
  iterator) fed by the engine's ``stream_cb`` the moment the host sees
  each token;
* bounds admission — at most ``max_pending`` streams in flight, beyond
  which ``submit`` raises a structured :class:`AdmissionRejected`
  (backpressure at the edge, not an unbounded queue in the scheduler);
* cancels for real — :meth:`TokenStream.cancel` releases the request's
  slot and pool blocks between steps (``LPUEngine.cancel``);
* drives SLO scheduling — with a :class:`repro_torch.serving.budget.
  BudgetScheduler` attached, every pump tick re-plans ``prefill_chunk``
  and ``steps_per_sync`` from the measured step-time EWMA before
  stepping the engine (``LPUEngine.set_step_knobs``; on the card a new
  value captures its program once, inside the tick that first meets
  it);
* emits telemetry — an optional :class:`repro_torch.serving.tracker.
  Tracker` receives per-window ``EngineStats`` deltas (snapshot and diff
  through :class:`EngineTap`) and a per-request TTFT / ms-per-token
  record at each stream's end.

Concurrency model: ONE event loop, no threads.  The pump task calls the
engine's synchronous ``step()`` and yields (``await asyncio.sleep(0)``)
between steps, so consumers drain their queues at window granularity.
That keeps greedy token streams identical to the blocking path's (the
same engine stepping in the same order) and makes cancellation
race-free: every front-end entry point runs between engine steps.
Unlike the reference, a step that raises ends every stream in flight as
failed before the pump dies, and :meth:`AsyncFrontend.stop` re-raises
it: no consumer waits forever on a dead pump.  And no reference cycle
holds the engine: a stream refers to its front end weakly, and a
finished request drops its ``stream_cb`` (a bound method of the front
end; a fleet keeps its failed requests), so a dropped engine and its
CUDA graphs are freed by reference count, at once.
"""
from __future__ import annotations

import asyncio
import time
import weakref
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence

from repro_torch.serving.budget import BudgetScheduler
from repro_torch.serving.engine import LPUEngine, MultiRingEngine
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.tracker import (EngineTap, NullTracker,
                                         RequestTimeline, Tracker)


class AdmissionRejected(RuntimeError):
    """Structured backpressure: the front end's in-flight window is full.
    Carries the numbers a client needs to back off, so none parses a
    message."""

    def __init__(self, pending: int, limit: int):
        self.pending = pending
        self.limit = limit
        super().__init__(
            f"admission rejected: {pending} streams in flight >= "
            f"max_pending={limit}")


class TokenStream:
    """One request's async token stream.

    ``async for tok in stream`` yields generated token ids as the engine
    reads them back; iteration ends when the request completes, fails or
    is cancelled — ``status`` / ``error`` say which.  The tokens so far
    are kept in ``tokens`` (the blocking path's ``results[rid]``).
    """

    def __init__(self, rid: int, frontend: "AsyncFrontend",
                 timeline: RequestTimeline):
        self.rid = rid
        self.tokens: List[int] = []
        self.status = "streaming"     # -> completed | failed | cancelled
        self.error: Optional[str] = None
        self.timeline = timeline
        self._pending: Deque[int] = deque()
        self._event = asyncio.Event()
        self._frontend = weakref.ref(frontend)

    @property
    def done(self) -> bool:
        return self.status != "streaming"

    def _push(self, tok: int) -> None:
        self.tokens.append(tok)
        self._pending.append(tok)
        self._event.set()

    def _finish(self, status: str, error: Optional[str] = None) -> None:
        self.status = status
        self.error = error
        self._event.set()

    def __aiter__(self) -> "TokenStream":
        return self

    async def __anext__(self) -> int:
        while True:
            if self._pending:
                return self._pending.popleft()
            if self.done:
                raise StopAsyncIteration
            self._event.clear()
            await self._event.wait()

    async def drain(self) -> List[int]:
        """Consume the stream to its end; returns all its tokens."""
        async for _ in self:
            pass
        return self.tokens

    async def cancel(self) -> bool:
        """Abort this stream and free its engine resources.  True if the
        cancellation landed (False: it had already finished, or its front
        end is gone)."""
        frontend = self._frontend()
        return frontend is not None and frontend.cancel(self.rid)


class AsyncFrontend:
    """Async serving facade over one engine or a host fleet.

    Use as an async context manager::

        async with AsyncFrontend(engine, max_pending=64) as fe:
            stream = fe.submit(prompt, max_new_tokens=32)
            async for tok in stream: ...

    ``max_pending`` and the budget default to the engine's
    ``EngineConfig`` (``max_pending``, ``budget_ms``).  ``counters`` is
    the admission ledger; at any quiet point ``completed + failed +
    cancelled == submitted`` (``rejected`` counts submits that never
    reached the engine).
    """

    def __init__(self, engine, *, max_pending: Optional[int] = None,
                 budget: Optional[BudgetScheduler] = None,
                 tracker: Optional[Tracker] = None):
        self.engine = engine
        self.engines: List[LPUEngine] = (
            list(engine.engines) if isinstance(engine, MultiRingEngine)
            else [engine])
        if any(e.tp > 1 for e in self.engines):
            # its decisions (the budget, arrival times) come from each
            # rank's wall clock and could differ between ranks, whose
            # collectives would then no longer pair up
            raise NotImplementedError(
                "the async front end over a ring-parallel engine (tp > 1) "
                "is not ported yet: its wall-clock decisions would differ "
                "between ranks")
        cfg = self.engines[0].config
        self.max_pending = (cfg.max_pending if max_pending is None
                            else int(max_pending))
        if budget is None and cfg.budget_ms > 0:
            budget = BudgetScheduler(cfg.budget_ms)
        self.budget = budget
        self.tracker = tracker if tracker is not None else NullTracker()
        self._taps = [EngineTap(e, ring=i)
                      for i, e in enumerate(self.engines)]
        self._streams: Dict[int, TokenStream] = {}
        self._inflight: Dict[int, TokenStream] = {}
        self.counters = dict(submitted=0, completed=0, failed=0,
                             cancelled=0, rejected=0)
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._idle.set()
        self._closing = False
        self._task: Optional[asyncio.Task] = None

    # -- lifecycle -----------------------------------------------------

    async def __aenter__(self) -> "AsyncFrontend":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def start(self) -> None:
        if self._task is None:
            self._closing = False
            self._task = asyncio.create_task(self._pump())

    async def stop(self) -> None:
        """Finish in-flight work, stop the pump, flush the tracker."""
        self._closing = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None
        self.tracker.finish()

    async def join(self) -> None:
        """Wait until every in-flight stream has ended."""
        await self._idle.wait()

    # -- submission / cancellation -------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               params: Optional[SamplingParams] = None,
               tenant: Optional[str] = None) -> TokenStream:
        """Admit one request; returns its :class:`TokenStream`.  Raises
        :class:`AdmissionRejected` when ``max_pending`` streams are in
        flight already: backpressure, not queueing."""
        if self.max_pending and len(self._inflight) >= self.max_pending:
            self.counters["rejected"] += 1
            self.tracker.log({"kind": "event", "t": time.perf_counter(),
                              "name": "admission_rejected",
                              "pending": len(self._inflight),
                              "limit": self.max_pending})
            raise AdmissionRejected(len(self._inflight), self.max_pending)
        t0 = time.perf_counter()
        rid = self.engine.submit(list(prompt), max_new_tokens, params,
                                 stream_cb=self._on_token)
        stream = TokenStream(rid, self, RequestTimeline(rid, t0,
                                                        tenant=tenant))
        self._streams[rid] = stream
        self._inflight[rid] = stream
        self.counters["submitted"] += 1
        self._idle.clear()
        self._wake.set()
        return stream

    def cancel(self, rid: int) -> bool:
        """Abort one in-flight stream; frees its slot and pool blocks.
        False if the request had already finished."""
        stream = self._inflight.get(rid)
        if stream is None:
            return False
        if self.engine.cancel(rid) is None:
            # no longer in the engine: it finished inside the current
            # pump tick and is finalized when step() returns
            return False
        self._finalize(rid, "cancelled")
        return True

    # -- the pump ------------------------------------------------------

    def _on_token(self, rid: int, tok: int) -> None:
        stream = self._streams.get(rid)
        if stream is None:            # a request submitted around us
            return
        stream.timeline.on_token(time.perf_counter())
        stream._push(tok)

    def _finalize(self, rid: int, status: str,
                  error: Optional[str] = None) -> None:
        stream = self._inflight.pop(rid, None)
        if stream is None:
            return
        self.counters[status] += 1
        stream._finish(status, error)
        self.tracker.log(stream.timeline.record(status,
                                                time.perf_counter()))
        if not self._inflight:
            self._idle.set()

    def _apply_budget(self) -> None:
        for eng in self.engines:
            chunk, steps = self.budget.plan(
                chunked=eng.prefill_chunk > 0,
                fused=eng.sampling == "fused")
            eng.set_step_knobs(prefill_chunk=chunk, steps_per_sync=steps)

    def _observe_budget(self, dt_s: float, deltas: List[Dict[str, int]]
                        ) -> None:
        self.budget.observe_tick(
            dt_s, sum(d.get("steps", 0) for d in deltas),
            sum(d.get("prefill_chunks", 0) for d in deltas),
            sum(d.get("prefill_chunks", 0) * e.prefill_chunk
                for d, e in zip(deltas, self.engines)))

    def _tick(self) -> None:
        """One engine step with SLO planning and telemetry around it."""
        if self.budget is not None:
            self._apply_budget()
        t0 = time.perf_counter()
        done = self.engine.step()
        dt = time.perf_counter() - t0
        deltas = []
        for tap in self._taps:
            before = dict(tap._prev)
            rec = tap.emit(self.tracker, time.perf_counter(),
                           dt_ms=dt * 1e3)
            deltas.append(rec["delta"] if rec is not None else
                          {k: 0 for k in before})
        if self.budget is not None:
            self._observe_budget(dt, deltas)
        for req in done:
            if req.rid not in self._inflight:
                continue
            req.stream_cb = None       # a fleet keeps its failed requests
            if req.failed:
                self._finalize(req.rid, "failed", req.error)
            else:
                self._finalize(req.rid, "completed")

    async def _pump(self) -> None:
        while True:
            if not self.engine.has_work():
                if self._closing:
                    return
                self._wake.clear()
                # test again: a submit may have landed before clear()
                if self.engine.has_work() or self._closing:
                    continue
                await self._wake.wait()
                continue
            try:
                self._tick()
            except BaseException as exc:
                # an engine step that raised ends every stream in flight
                # as failed, so no consumer waits on a dead pump; stop()
                # re-raises the exception
                for rid in list(self._inflight):
                    self._finalize(rid, "failed", repr(exc))
                raise
            # yield, so consumers drain at window granularity
            await asyncio.sleep(0)


async def serve_trace(frontend: AsyncFrontend, trace,
                      speed: float = 1.0) -> List[Optional[TokenStream]]:
    """Replay a :mod:`repro_torch.serving.traces` trace against a front
    end: submit each request at ``arrival_s / speed`` (wall), collect
    every stream and wait for the engine to go quiet.  A rejected submit
    is recorded as ``None``, so callers can count them."""
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    streams: List[Optional[TokenStream]] = []
    for req in trace:
        delay = req.arrival_s / speed - (loop.time() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            streams.append(frontend.submit(
                req.prompt, req.max_new_tokens, tenant=req.tenant))
        except AdmissionRejected:
            streams.append(None)
    await frontend.join()
    return streams


async def submit_admitted(frontend: AsyncFrontend, prompt: Sequence[int],
                          max_new_tokens: int = 32,
                          params: Optional[SamplingParams] = None,
                          tenant: Optional[str] = None):
    """Submit once the front end admits: after each
    :class:`AdmissionRejected` wait for every stream in flight to end
    (``join()``) and try again.  Returns (the stream, its rejections)."""
    rejections = 0
    while True:
        try:
            return frontend.submit(prompt, max_new_tokens, params,
                                   tenant), rejections
        except AdmissionRejected:
            rejections += 1
            await frontend.join()
