"""Request-level scheduler: admission, bucketed prefill, preemption.

A copy of the reference's ``serving/scheduler.py`` (``SeqSlot``,
``Scheduler`` and ``RingRouter``; the reference module imports its JAX ``kv_cache``, so the
port keeps its own).  All policy is host-side: the device programs only
ever see a full slot batch plus block tables.

* **Admission** — FIFO: a queued request is admitted when a slot is free
  AND (paged mode) the block pool can cover its prompt; prompt lengths
  are padded to power-of-two buckets.  With a prefix index the longest
  cached chain of full blocks is pinned into the new table first and
  only the tail's blocks are allocated.
* **Chunked admission** (``admit_next(chunk=C)``) — only the first
  chunk's blocks are reserved; :meth:`Scheduler.chunk_reserve` grows the
  block set one chunk per engine step, and the sequence joins decode
  windows once its prompt is resident (``SeqSlot.prefilling``).
* **Growth** — before every decode step each decode-ready sequence must
  own the block its next token lands in; a multi-step window or a
  speculative verify window reserves its whole lookahead up front
  (:meth:`Scheduler.reserve_lookahead`), or falls back to one step.
* **Preemption** — when growth cannot be satisfied, the most recently
  admitted *other* sequence is evicted (recompute-style: its blocks are
  freed, it re-enters the queue front, and its tokens so far are
  re-prefilled on re-admission).
* **Routing** — :class:`RingRouter` sends a fleet's request to the ring
  with the fewest outstanding tokens (:meth:`Scheduler.pending_tokens`),
  or to the deepest owner of its prompt's cached prefix.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Sequence, Tuple

from repro_torch.serving.kv_cache import (BlockPool, PrefixCache,
                                          blocks_for, bucket_for)


def queued_load(req) -> int:
    """A queued request's outstanding tokens: its tokens still to make
    resident and its remaining decode budget."""
    return len(req.resume_tokens()) + max(req.max_new_tokens - len(req.out),
                                          0)


@dataclass
class SeqSlot:
    """An active request's per-slot serving state.  ``pos`` is the
    number of tokens resident in KV: prompt + generated-so-far for a
    decode-ready sequence; under chunked prefill it starts at the cached
    prefix and advances one chunk at a time (``prefilled == pos`` until
    the prompt is resident)."""
    req: "object"                 # repro_torch.serving.engine.Request
    pos: int                      # tokens resident in KV cache
    blocks: List[int] = field(default_factory=list)
    admit_seq: int = 0            # admission order (monotonic)
    resumed: bool = False         # re-admitted after preemption
    last_token: int = 0           # sampled but not yet fed to the model
    prefilled: int = 0            # prompt tokens resident (chunked mode)
    prefill_target: int = 0       # prompt tokens to make resident (0 =
                                  # monolithic prefill, done at admit)
    cached: int = 0               # prompt tokens covered by a prefix hit
    frozen: bool = False          # held out of a decode round (a mesh
                                  # fleet's admission pass)

    @property
    def prefilling(self) -> bool:
        """True while the prompt is only partly resident (or the slot is
        ``frozen``): the slot takes no part in decode windows (its table
        row stays null)."""
        return self.frozen or self.prefilled < self.prefill_target


class Scheduler:
    """Slot + block-pool bookkeeping for the serving engine.

    ``pool`` is None in dense mode: every slot owns an implicit
    max_seq-sized region, capacity checks reduce to the max_seq bound and
    preemption never triggers.
    """

    def __init__(self, slots: int, max_seq: int,
                 pool: Optional[BlockPool] = None, min_bucket: int = 16,
                 prefix: Optional[PrefixCache] = None):
        self.slots = slots
        self.max_seq = max_seq
        self.pool = pool
        self.prefix = prefix
        self.min_bucket = min_bucket
        if pool is not None:
            self.min_bucket = max(min_bucket, pool.block_size)
            assert max_seq % pool.block_size == 0, \
                (max_seq, pool.block_size)
        self.queue: Deque = deque()
        self.active: List[Optional[SeqSlot]] = [None] * slots
        self.preemptions = 0
        self._admit_counter = 0
        # requests that can NEVER be admitted (their resume state
        # outgrew the pool): popped off the queue with a reason instead
        # of raising — one oversized request must not take down the
        # co-tenants sharing this engine.  The engine harvests these
        # via :meth:`take_rejected` and surfaces a structured
        # per-request failure.
        self.rejected: List[Tuple[object, str]] = []

    # -- queries ----------------------------------------------------------

    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.active)

    def num_active(self) -> int:
        return sum(1 for s in self.active if s is not None)

    def pending_tokens(self) -> int:
        """Outstanding work in tokens: queued prompts still to prefill
        plus every request's remaining decode budget (host-side only;
        the load :class:`RingRouter` balances on)."""
        return sum(load for _, load in self.loads())

    def in_flight(self) -> list:
        """The requests in flight: active sequences in admission order,
        then the queue (the order a ring drain orphans them in)."""
        active = sorted((s for s in self.active if s is not None),
                        key=lambda s: s.admit_seq)
        return [s.req for s in active] + list(self.queue)

    def loads(self) -> List[Tuple[int, int]]:
        """(rid, outstanding tokens) of every request in flight, in
        :meth:`in_flight` order: an active request's remaining decode
        budget (at least 1), a queued one's :func:`queued_load`."""
        active = {s.req.rid for s in self.active if s is not None}
        return [(r.rid, max(r.max_new_tokens - len(r.out), 1)
                 if r.rid in active else queued_load(r))
                for r in self.in_flight()]

    def bucket(self, n_tokens: int) -> int:
        return bucket_for(n_tokens, self.max_seq, self.min_bucket)

    # -- admission --------------------------------------------------------

    def check_fits(self, prompt) -> None:
        """Raise ``ValueError`` when ``prompt`` needs more blocks than
        the pool can ever grant."""
        if self.pool is not None:
            need = blocks_for(len(prompt), self.pool.block_size)
            if need > self.pool.num_blocks - 1:
                raise ValueError(
                    f"prompt needs {need} blocks but the pool only has "
                    f"{self.pool.num_blocks - 1} allocatable blocks")

    def submit(self, req) -> None:
        self.check_fits(req.prompt)
        self.queue.append(req)

    def admit_next(self, chunk: int = 0) -> Optional[SeqSlot]:
        """Admit the head of the queue if a slot and blocks are available.

        ``chunk == 0`` (monolithic prefill): the whole prompt's blocks
        are reserved and ``pos`` starts fully resident — the engine runs
        one bucketed prefill immediately after.  ``chunk > 0``: only the
        first chunk's blocks are reserved, the slot starts at ``pos ==
        prefilled == cached`` with ``prefill_target`` the prompt length,
        and the engine makes the prompt resident one chunk per step.

        With a prefix index the cached chain is pinned (shared) BEFORE
        the tail is allocated, so ``alloc``'s LRU eviction cannot recycle
        the blocks the hit needs; on shortfall the pin is rolled back.

        A queue head that can never fit — the whole pool is free yet
        still short of its resume-state blocks — is **rejected**, not
        raised over: it is popped into :attr:`rejected` with a reason
        and the next queued request gets its chance in the same call.

        Returns the newly filled SeqSlot (prefill is the engine's job)
        or None when nothing can be admitted right now.
        """
        while self.queue:
            free_slot = next((i for i, s in enumerate(self.active)
                              if s is None), None)
            if free_slot is None:
                return None
            req = self.queue[0]
            tokens = req.resume_tokens()
            n_tok = len(tokens)
            blocks: List[int] = []
            shared: List[int] = []
            cached = 0
            if self.pool is not None:
                if self.prefix is not None:
                    shared, cached = self.prefix.match(tokens)
                    if shared:
                        self.pool.share(shared)
                reserve = min(n_tok, cached + chunk) if chunk else n_tok
                need = blocks_for(reserve, self.pool.block_size) \
                    - len(shared)
                got = self.pool.alloc(max(need, 0))
                if got is None:
                    if shared:
                        self.pool.free(shared)    # unpin; index kept
                    if self.num_active() == 0 and \
                            self.pool.num_used == 0:
                        # whole pool free yet still short: this request
                        # can never be admitted (its resume state
                        # outgrew the pool after preemption) — reject
                        # it and move on to the next queued request
                        self.queue.popleft()
                        self.rejected.append((req, (
                            f"needs "
                            f"{blocks_for(reserve, self.pool.block_size)}"
                            f" blocks but the pool holds only "
                            f"{self.pool.num_blocks - 1}; increase "
                            f"num_blocks")))
                        continue
                    return None      # pool pressure: wait for finishes
                blocks = shared + got
                if shared:
                    self.prefix.note_hit(shared, cached)
            self.queue.popleft()
            seq = SeqSlot(req=req, pos=cached if chunk else n_tok,
                          blocks=blocks, admit_seq=self._admit_counter,
                          resumed=bool(req.out),
                          prefilled=cached if chunk else 0,
                          prefill_target=n_tok if chunk else 0,
                          cached=cached)
            self._admit_counter += 1
            self.active[free_slot] = seq
            return seq
        return None

    def take_rejected(self) -> List[Tuple[object, str]]:
        """Hand off (request, reason) pairs rejected since the last
        call — exactly once, like the engine's results buffer."""
        out, self.rejected = self.rejected, []
        return out

    def slot_of(self, seq: SeqSlot) -> int:
        return self.active.index(seq)

    def prefilling(self) -> List[SeqSlot]:
        """Active sequences whose prompt is still partly resident, in
        admission order (the engine serves them one chunk per step,
        round-robin)."""
        return sorted((s for s in self.active
                       if s is not None and s.prefilling),
                      key=lambda s: s.admit_seq)

    def num_decoding(self) -> int:
        """Active sequences that take part in decode windows (fully
        prefilled); the complement of :meth:`prefilling`."""
        return sum(1 for s in self.active
                   if s is not None and not s.prefilling)

    # -- growth / preemption ----------------------------------------------

    def chunk_reserve(self, seq: SeqSlot, chunk: int,
                      allow_preempt: bool = False) -> bool:
        """Reserve the blocks the next prefill chunk of ``seq`` lands in:
        every block up to ``min(prefilled + chunk, prefill_target)``
        tokens; True once they are owned.  Without ``allow_preempt``
        (the engine sets it only when no decode stream could free
        blocks) nothing is allocated on shortfall and False is returned:
        the caller retries next step.  With it, the newest other
        sequences are preempted until the blocks fit."""
        target = min(seq.prefilled + chunk, seq.prefill_target)
        while True:
            short = blocks_for(target, self.pool.block_size) \
                - len(seq.blocks)
            if short <= 0:
                return True
            got = self.pool.alloc(short)
            if got is not None:
                seq.blocks.extend(got)
                return True
            if not allow_preempt:
                return False
            victim = self._pick_victim(exclude=seq)
            if victim is None:
                raise RuntimeError(
                    "KV block pool exhausted by a single prefilling "
                    "sequence; increase num_blocks or lower max_seq")
            self._preempt(victim)

    def ensure_decode_capacity(self) -> List[SeqSlot]:
        """Guarantee every decode-ready sequence owns the block its next
        token writes into, preempting the newest other sequences if the
        pool is exhausted.  Prefilling sequences are skipped (their
        growth is chunk-driven) but stay possible victims.  Returns the
        list of preempted SeqSlots."""
        if self.pool is None:
            return []
        preempted: List[SeqSlot] = []
        for i in range(self.slots):
            seq = self.active[i]
            if seq is None or seq.prefilling:
                continue
            need_blocks = blocks_for(seq.pos + 1, self.pool.block_size)
            while len(seq.blocks) < need_blocks:
                got = self.pool.alloc(1)
                if got is not None:
                    seq.blocks.extend(got)
                    continue
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    raise RuntimeError(
                        "KV block pool exhausted by a single sequence; "
                        "increase num_blocks or lower max_seq")
                self._preempt(victim)
                preempted.append(victim)
        return preempted

    def cow_alloc(self, seq: SeqSlot, allow_preempt: bool = True
                  ) -> Optional[int]:
        """One fresh block for a copy-on-write split of a shared block in
        ``seq``'s table, with decode growth's grow-or-preempt policy;
        None when the pool is dry and ``allow_preempt`` is False."""
        while True:
            got = self.pool.alloc(1)
            if got is not None:
                return got[0]
            if not allow_preempt:
                return None
            victim = self._pick_victim(exclude=seq)
            if victim is None:
                raise RuntimeError(
                    "KV block pool exhausted by a copy-on-write split; "
                    "increase num_blocks")
            self._preempt(victim)

    def reserve_lookahead(self, steps: int, draft_k: int = 0) -> bool:
        """All-or-nothing block reservation for a multi-step decode window.

        The engine's fused ``steps_per_sync`` window runs ``steps`` decode
        steps with no host boundary in between, so every active sequence
        must own the blocks its next ``steps`` tokens land in BEFORE
        dispatch.  Unlike :meth:`ensure_decode_capacity` this NEVER
        preempts: lookahead must not evict resident work, so on
        shortfall nothing is allocated and the caller falls back to
        single-step dispatch (where the usual grow-or-preempt policy
        applies).  Reserved-but-unused blocks stay owned by the sequence
        and are freed at release.  Prefilling sequences sit windows out
        and are skipped.

        ``draft_k``: the extra rows of a speculative verify window, which
        writes KV at ``pos .. pos + steps + draft_k - 1`` before the host
        knows how many drafts were accepted; without them an all-accept
        window crossing a block boundary would scatter into the null
        block.
        """
        if self.pool is None:
            return True
        needs = []
        for seq in self.active:
            if seq is None or seq.prefilling:
                continue
            target = min(seq.pos + steps + draft_k, self.max_seq)
            short = blocks_for(target, self.pool.block_size) \
                - len(seq.blocks)
            if short > 0:
                needs.append((seq, short))
        if sum(n for _, n in needs) > self.pool.num_free:
            return False
        for seq, n in needs:
            seq.blocks.extend(self.pool.alloc(n))
        return True

    def _pick_victim(self, exclude: SeqSlot) -> Optional[SeqSlot]:
        cands = [s for s in self.active
                 if s is not None and s is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda s: s.admit_seq)

    def _preempt(self, seq: SeqSlot) -> None:
        slot = self.slot_of(seq)
        self.pool.free(seq.blocks)
        seq.blocks = []
        self.active[slot] = None
        self.queue.appendleft(seq.req)
        self.preemptions += 1

    # -- release ----------------------------------------------------------

    def release(self, seq: SeqSlot) -> None:
        slot = self.slot_of(seq)
        if self.pool is not None and seq.blocks:
            self.pool.free(seq.blocks)
        seq.blocks = []
        self.active[slot] = None


class RingRouter:
    """Per-ring admission across a fleet's engines (paper C3).

    Stateless beyond its routed counts: a request goes to the ring with
    the least outstanding tokens (ties -> lowest ring id, so an idle
    fleet fills round-robin).  Not work-stealing: once placed, a
    request's KV lives in one ring's pool.

    Prefix affinity (``EngineConfig.affinity="prefix"``): the fleet
    probes every ring's ``PrefixCache.peek`` (counting nothing, touching
    no LRU entry) and passes the per-ring cached-token counts; the
    deepest owner wins, and least-loaded decides when no ring owns any
    of the prompt.
    """

    def __init__(self, n_rings: int):
        assert n_rings >= 1
        self.n_rings = n_rings
        self.routed = [0] * n_rings
        self.affinity_routed = [0] * n_rings

    def route(self, loads: Sequence[int],
              affinity: Optional[Sequence[int]] = None) -> int:
        """The target ring of one request, given per-ring loads
        (:meth:`Scheduler.pending_tokens`) and optional per-ring
        prefix-affinity scores (deepest owner wins, ties -> lowest ring
        id, all zero -> least loaded)."""
        assert len(loads) == self.n_rings, (len(loads), self.n_rings)
        if affinity is not None:
            assert len(affinity) == self.n_rings, \
                (len(affinity), self.n_rings)
            best = max(affinity)
            if best > 0:
                ring = min(i for i in range(self.n_rings)
                           if affinity[i] == best)
                self.routed[ring] += 1
                self.affinity_routed[ring] += 1
                return ring
        ring = min(range(self.n_rings), key=lambda i: (loads[i], i))
        self.routed[ring] += 1
        return ring
