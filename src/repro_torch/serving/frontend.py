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

On a ring (an engine with ``mesh=ring``, or a mesh fleet), where every
rank is a process running the same engine logic, the front end lives
on world rank 0: the event loop, its consumers, arrival times,
``max_pending`` admission, cancels, the budget's ``plan`` /
``observe_tick`` and the tracker.  Its submits and cancels become
*orders*, and before each tick rank 0 sends the tick's orders (the
submits with their rids, prompts and sampling parameters, the cancels,
the step knobs) to every rank over the world's
:class:`repro_torch.core.dist.Agreement`; every rank, rank 0 too,
applies them in the same order and steps, so every rank's engine makes
the same decisions.  The other ranks run :meth:`AsyncFrontend.follow`
until rank 0's front end stops.  Streams, rejections and the tracker's
records exist on rank 0 only; every rank keeps a crc32 of the orders it
applied (``orders_crc``), so a caller can show that all applied the same
ones.  A lone ring is the case of one ring of the same rule.

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
import zlib
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
        # on a ring: world rank 0 decides and orders every rank
        self.world = world_of(engine)
        self.leader = self.world is None or self.world.rank == 0
        self._agreement = (self.world.agreement()
                           if self.world is not None else None)
        self._orders: List[tuple] = []
        self.orders_crc = 0
        self.orders_applied = 0
        cfg = self.engines[0].config
        self.max_pending = (cfg.max_pending if max_pending is None
                            else int(max_pending))
        if budget is None and cfg.budget_ms > 0:
            budget = BudgetScheduler(cfg.budget_ms)
        self.budget = budget if self.leader else None
        self.tracker = (tracker if tracker is not None and self.leader
                        else NullTracker())
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
        if not self.leader:
            raise RuntimeError("the front end runs on world rank 0; the "
                               "other ranks call follow()")
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

    def follow(self) -> None:
        """A rank other than world 0 of a ring: apply rank 0's orders
        and step, tick after tick, until rank 0's front end stops."""
        if self.leader:
            raise RuntimeError("world rank 0 runs the front end (start)")
        while True:
            orders = self._agreement.announce()
            if orders is None:
                return
            self._apply(orders)
            if self.engine.has_work():
                self.engine.step()

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
        if self.world is None:
            rid = self.engine.submit(list(prompt), max_new_tokens, params,
                                     stream_cb=self._on_token)
        else:
            # an order, applied on every rank at the next tick; its rid is
            # the one the engine will give it there
            prompt = list(prompt)
            self._local_engine().check_prompt(prompt)
            rid = self.engine._rid + sum(o[0] == "submit"
                                         for o in self._orders)
            self._orders.append(("submit", rid, prompt, max_new_tokens,
                                 params))
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
        if self.world is not None:
            # between ticks a stream in flight is in the engine (or in an
            # order before this one): the cancel lands at the next tick
            self._orders.append(("cancel", rid))
            self._wake.set()
        elif self.engine.cancel(rid) is None:
            # no longer in the engine: it finished inside the current
            # pump tick and is finalized when step() returns
            return False
        self._finalize(rid, "cancelled")
        return True

    def _local_engine(self) -> LPUEngine:
        """The engine of this rank (a mesh fleet's own ring's)."""
        return getattr(self.engine, "local", None) or self.engines[0]

    def _apply(self, orders: List[tuple]) -> None:
        """Apply a tick's orders in their order (every rank of a ring the
        same ones), each folded into ``orders_crc``."""
        for o in orders:
            if o[0] == "submit":
                _, rid, prompt, new, params = o
                cb = self._on_token if self.leader else None
                got = self.engine.submit(prompt, new, params, stream_cb=cb)
                if got != rid:
                    raise RuntimeError(f"order for rid {rid} got {got}")
            elif o[0] == "cancel":
                if self.engine.cancel(o[1]) is None:
                    raise RuntimeError(f"cancel of {o[1]} found nothing")
            else:
                _, i, chunk, steps = o
                self.engines[i].set_step_knobs(prefill_chunk=chunk,
                                               steps_per_sync=steps)
            self.orders_crc = zlib.crc32(repr(o).encode(), self.orders_crc)
            self.orders_applied += 1

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

    def _budget_orders(self) -> List[tuple]:
        out = []
        for i, eng in enumerate(self.engines):
            chunk, steps = self.budget.plan(
                chunked=eng.prefill_chunk > 0,
                fused=eng.sampling == "fused")
            out.append(("knobs", i, chunk, steps))
        return out

    def _observe_budget(self, dt_s: float, deltas: List[Dict[str, int]]
                        ) -> None:
        self.budget.observe_tick(
            dt_s, sum(d.get("steps", 0) for d in deltas),
            sum(d.get("prefill_chunks", 0) for d in deltas),
            sum(d.get("prefill_chunks", 0) * e.prefill_chunk
                for d, e in zip(deltas, self.engines)))

    def _tick(self) -> None:
        """One engine step with SLO planning and telemetry around it; on
        a ring the tick's orders go to every rank first."""
        orders, self._orders = self._orders, []
        if self.budget is not None:
            orders += self._budget_orders()
        if self._agreement is not None:
            self._agreement.announce(orders)
        self._apply(orders)
        if not self.engine.has_work():
            return
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

    def _busy(self) -> bool:
        return bool(self._orders) or self.engine.has_work()

    async def _pump(self) -> None:
        while True:
            if not self._busy():
                if self._closing:
                    if self._agreement is not None:
                        self._agreement.announce(None)   # followers end
                    return
                self._wake.clear()
                # test again: a submit may have landed before clear()
                if self._busy() or self._closing:
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


def world_of(engine):
    """The world ring whose ranks all run ``engine`` (a mesh fleet's, or
    a ring-parallel engine's whole ring), or None for an engine of one
    process.  An engine on one sub-ring alone is refused: the other
    sub-rings' ranks would not follow."""
    world = getattr(engine, "world", None)
    if world is not None:
        return world
    ring = getattr(engine, "ring", None)
    if ring is None:
        return None
    if getattr(ring, "world", None) is not None:
        raise ValueError("a front end over one sub-ring's engine: put it "
                         "over the mesh fleet (MultiRingEngine) instead")
    return ring


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
