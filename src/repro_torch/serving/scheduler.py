"""Request-level scheduler: admission, bucketed prefill, preemption.

A copy of the reference's ``serving/scheduler.py`` (``SeqSlot`` and
``Scheduler``; the reference module imports its JAX ``kv_cache``, so the
port keeps its own), cut to the monolithic-prefill path this slice
serves: the prefix-cache, chunked-admission, copy-on-write and
speculative-lookahead branches come back with their slices.  All policy
is host-side: the device programs only ever see a full slot batch plus
block tables.

* **Admission** — FIFO: a queued request is admitted when a slot is free
  AND (paged mode) the block pool can cover its prompt; prompt lengths
  are padded to power-of-two buckets.
* **Growth** — before every decode step each active sequence must own
  the block its next token lands in.
* **Preemption** — when growth cannot be satisfied, the most recently
  admitted *other* sequence is evicted (recompute-style: its blocks are
  freed, it re-enters the queue front, and its tokens so far are
  re-prefilled on re-admission).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional, Tuple

from repro_torch.serving.kv_cache import BlockPool, blocks_for, bucket_for


@dataclass
class SeqSlot:
    """An active request's per-slot serving state.  ``pos`` is the
    number of tokens resident in KV: prompt + generated-so-far."""
    req: "object"                 # repro_torch.serving.engine.Request
    pos: int                      # tokens resident in KV cache
    blocks: List[int] = field(default_factory=list)
    admit_seq: int = 0            # admission order (monotonic)
    resumed: bool = False         # re-admitted after preemption
    last_token: int = 0           # sampled but not yet fed to the model


class Scheduler:
    """Slot + block-pool bookkeeping for the serving engine.

    ``pool`` is None in dense mode: every slot owns an implicit
    max_seq-sized region, capacity checks reduce to the max_seq bound and
    preemption never triggers.
    """

    def __init__(self, slots: int, max_seq: int,
                 pool: Optional[BlockPool] = None, min_bucket: int = 16):
        self.slots = slots
        self.max_seq = max_seq
        self.pool = pool
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

    def bucket(self, n_tokens: int) -> int:
        return bucket_for(n_tokens, self.max_seq, self.min_bucket)

    # -- admission --------------------------------------------------------

    def submit(self, req) -> None:
        if self.pool is not None:
            need = blocks_for(len(req.prompt), self.pool.block_size)
            if need > self.pool.num_blocks - 1:
                raise ValueError(
                    f"prompt needs {need} blocks but the pool only has "
                    f"{self.pool.num_blocks - 1} allocatable blocks")
        self.queue.append(req)

    def admit_next(self) -> Optional[SeqSlot]:
        """Admit the head of the queue if a slot and blocks are available.

        The whole prompt's blocks are reserved at admission and ``pos``
        starts fully resident — the engine runs one bucketed prefill
        immediately after.

        A queue head that can never fit — the whole pool is free yet
        still short of its resume-state blocks — is **rejected**, not
        raised over: it is popped into :attr:`rejected` with a reason
        and the next queued request gets its chance in the same call,
        so one oversized request can neither livelock admission nor
        kill the engine its co-tenants share (the engine turns the
        rejection into a structured per-request failure).

        Returns the newly filled SeqSlot (prefill is the engine's job)
        or None when nothing can be admitted right now.
        """
        while self.queue:
            free_slot = next((i for i, s in enumerate(self.active)
                              if s is None), None)
            if free_slot is None:
                return None
            req = self.queue[0]
            n_tok = len(req.resume_tokens())
            blocks: List[int] = []
            if self.pool is not None:
                need = blocks_for(n_tok, self.pool.block_size)
                got = self.pool.alloc(need)
                if got is None:
                    if self.num_active() == 0 and \
                            self.pool.num_used == 0:
                        # whole pool free yet still short: this request
                        # can never be admitted (its resume state
                        # outgrew the pool after preemption) — reject
                        # it and move on to the next queued request
                        self.queue.popleft()
                        self.rejected.append((req, (
                            f"needs {need} blocks but the pool holds "
                            f"only {self.pool.num_blocks - 1}; increase "
                            f"num_blocks")))
                        continue
                    return None      # pool pressure: wait for finishes
                blocks = got
            self.queue.popleft()
            seq = SeqSlot(req=req, pos=n_tok, blocks=blocks,
                          admit_seq=self._admit_counter,
                          resumed=bool(req.out))
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

    # -- growth / preemption ----------------------------------------------

    def ensure_decode_capacity(self) -> List[SeqSlot]:
        """Guarantee every active sequence owns the block its next token
        writes into, preempting the newest other sequences if the pool
        is exhausted.  Returns the list of preempted SeqSlots."""
        if self.pool is None:
            return []
        preempted: List[SeqSlot] = []
        for i in range(self.slots):
            seq = self.active[i]
            if seq is None:
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

    def reserve_lookahead(self, steps: int) -> bool:
        """All-or-nothing block reservation for a multi-step decode window.

        The engine's fused ``steps_per_sync`` window runs ``steps`` decode
        steps with no host boundary in between, so every active sequence
        must own the blocks its next ``steps`` tokens land in BEFORE
        dispatch.  Unlike :meth:`ensure_decode_capacity` this NEVER
        preempts: lookahead must not evict resident work, so on
        shortfall nothing is allocated and the caller falls back to
        single-step dispatch (where the usual grow-or-preempt policy
        applies).  Reserved-but-unused blocks stay owned by the sequence
        and are freed at release.
        """
        if self.pool is None:
            return True
        needs = []
        for seq in self.active:
            if seq is None:
                continue
            target = min(seq.pos + steps, self.max_seq)
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
