"""Static inputs and captured programs of the engine's device steps: the
port's counterpart of the reference's jitted programs (the decode window
and verify round, the prefill, the prefill chunk, the first-token
sampler and the block copy; ``src/repro/serving/engine.py``
``_window``, ``_verify``, ``:486-493``).

* :class:`StagedBuffer` — one persistent int32 device buffer holding
  named fields (f32 fields are bit views), fed from pinned host staging
  with ``non_blocking=True``.  The staging is double-buffered, and a
  stage is rewritten only once its previous copy has run.  The buffer
  keeps a host mirror of what the device holds, so an upload that would
  change nothing is skipped.
* :class:`Programs` — an engine's programs by key.  On the card each is
  a ``torch.cuda.CUDAGraph`` captured once, after one eager warm-up, all
  in one memory pool (shared with another :class:`Programs` given as
  ``share``); on the CPU the warm-up runs and the function the program
  was built from is the program: every later run calls that function,
  never the caller's current one, as a replay runs what was captured.
  A program's function reads and writes only static buffers, so a
  replay needs no host work beyond its uploads.
  A capture records the kernel launches it made
  (:func:`repro_torch.kernels.held_launches`) and, on a ring, the
  collectives, hops and bytes it made
  (:func:`repro_torch.core.dist.held_counters`); every replay adds them
  back, so launch and collective counts read the same as an eager
  run's.  On an NCCL ring a capture records the ring's collectives as
  graph nodes; it is made in ``thread_local`` mode, so NCCL's watchdog
  thread, which queries its own events, cannot invalidate it.  The
  cyclic collector is held off while a graph is captured: an object it
  frees there (another engine's graph, in a reference cycle a caller
  dropped) would invalidate the capture.
"""
from __future__ import annotations

import contextlib
import gc
from dataclasses import dataclass, field
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.dist import held_counters

Field = Tuple[str, Tuple[int, ...], str]   # (name, shape, "i32" | "f32")


class StagedBuffer:
    """Named int32 / f32 fields packed into one device buffer."""

    def __init__(self, fields: Sequence[Field], device: torch.device):
        self.device = torch.device(device)
        self._layout: Dict[str, Tuple[int, int, Tuple[int, ...], str]] = {}
        off = 0
        for name, shape, kind in fields:
            size = int(np.prod(shape))
            self._layout[name] = (off, size, tuple(shape), kind)
            off += size
        self.size = off
        self.dev = torch.zeros(off, dtype=torch.int32, device=self.device)
        self.view: Dict[str, torch.Tensor] = {}
        for name, (o, n, shape, kind) in self._layout.items():
            t = self.dev[o:o + n].view(shape)
            self.view[name] = t.view(torch.float32) if kind == "f32" else t
        pin = self.device.type == "cuda"
        self._stage = [torch.zeros(off, dtype=torch.int32, pin_memory=pin)
                       for _ in range(2)]
        self._copied: list = [None, None]
        self._next = 0
        self.mirror: Optional[np.ndarray] = None   # None = unknown

    def fields(self, flat: np.ndarray) -> Dict[str, np.ndarray]:
        """Writable numpy views of each field of a packed host array."""
        out = {}
        for name, (o, n, shape, kind) in self._layout.items():
            a = flat[o:o + n].reshape(shape)
            out[name] = a.view(np.float32) if kind == "f32" else a
        return out

    def pack(self, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        """The packed host array of ``arrays`` (every field given)."""
        flat = np.zeros(self.size, np.int32)
        for name, view in self.fields(flat).items():
            a = np.asarray(arrays[name])
            view[...] = a.reshape(view.shape) if a.size == view.size else a
        return flat

    def upload(self, flat: np.ndarray) -> bool:
        """Copy ``flat`` into the device buffer unless the buffer already
        holds it.  Returns whether a copy was enqueued."""
        flat = np.asarray(flat, np.int32).reshape(-1)
        if self.mirror is not None and np.array_equal(self.mirror, flat):
            return False
        i = self._next
        self._next ^= 1
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        self._stage[i].numpy()[...] = flat
        self.dev.copy_(self._stage[i], non_blocking=True)
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._copied[i] = ev
        self.mirror = flat.copy()
        return True


@contextlib.contextmanager
def collector_off():
    """The cyclic collector held off inside the block (as it was
    after)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@dataclass
class Program:
    graph: Optional["torch.cuda.CUDAGraph"]
    launches: Dict[str, int] = field(default_factory=dict)
    fn: Optional[Callable[[], None]] = None   # the CPU's program
    replays: int = 0
    collectives: Dict[str, float] = field(default_factory=dict)  # a ring's


class Programs:
    """An engine's programs by key, captured on first use.  ``share``:
    another :class:`Programs` whose memory pool and capture stream these
    programs use too.  ``ring``: the rank's
    :class:`repro_torch.core.dist.Ring` when the programs run on the
    model ring (its counters held in warm-ups and captures, added back
    per replay)."""

    def __init__(self, device: torch.device,
                 share: Optional["Programs"] = None, ring=None):
        self.device = torch.device(device)
        self.ring = ring
        self._by_key: Dict[Hashable, Program] = {}
        # never a reference to self, so the programs and their graphs
        # are freed with their engine, by reference count
        self._share = share
        self._pool = None
        self._stream = None
        self.captures = 0
        self.replays = 0
        self.warm_launches: Dict[str, int] = {}   # made by the warm-ups

    def get(self, key: Hashable, fn: Callable[[], None], *,
            generator: Optional[torch.Generator],
            held: Callable) -> Program:
        """The program of ``key``; built from ``fn`` on first use inside
        ``held()`` (the caller's guard that gives the warm-up dead
        inputs and undoes its writes).  ``generator`` is registered with
        a graph that draws from it."""
        prog = self._by_key.get(key)
        if prog is None:
            with held():
                prog = self._capture(fn, generator)
            self._by_key[key] = prog
        return prog

    def _capture(self, fn, generator) -> Program:
        cuda = self.device.type == "cuda"
        own = self._share or self
        if cuda and own._stream is None:
            own._pool = torch.cuda.graph_pool_handle()
            own._stream = torch.cuda.Stream(self.device)
        # the warm-up counts nothing
        with kernels.held_launches() as warm, held_counters(self.ring):
            if cuda:
                own._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
                with torch.cuda.stream(own._stream):
                    fn()
                torch.cuda.current_stream(self.device).wait_stream(
                    own._stream)
            else:
                fn()
        for k, n in warm.items():
            self.warm_launches[k] = self.warm_launches.get(k, 0) + n
        if not cuda:
            return Program(None, fn=fn)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        kw = ({"capture_error_mode": "thread_local"}
              if self.ring is not None and self.ring.nccl else {})
        with kernels.held_launches() as made, collector_off(), \
                held_counters(self.ring) as ring_made:
            with torch.cuda.graph(graph, pool=own._pool,
                                  stream=own._stream, **kw):
                fn()
        self.captures += 1
        return Program(graph, made, collectives=ring_made)

    def run(self, prog: Optional[Program], fn: Callable[[], None]) -> None:
        """Replay ``prog``'s graph and add its launches (and its
        collectives to the ring's counters).  With no graph
        (the CPU) call the function ``prog`` was built from, as a replay
        would run what its capture recorded (``fn`` only for a program
        made without one); with no program (the eager twin) call
        ``fn``."""
        if prog is None:
            fn()
            return
        if prog.graph is None:
            (prog.fn or fn)()
            return
        prog.graph.replay()
        kernels.add_launches(prog.launches)
        if self.ring is not None:
            self.ring.add_counters(prog.collectives)
        prog.replays += 1
        self.replays += 1

    def replays_of(self, kind: str) -> int:
        """Replays of the programs whose key starts with ``kind``."""
        return sum(p.replays for k, p in self._by_key.items()
                   if k[0] == kind)
