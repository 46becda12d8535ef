"""Continuous-batching serving engine at tp=1 (the port of the
reference's ``serving/engine.py`` ``LPUEngine``).

* **API** — blocking ``generate(prompts, ...)`` plus non-blocking
  ``submit(request) / step() / drain()``.
* **Scheduler** — a fixed decode batch of ``slots``; queued requests are
  admitted at step boundaries (:class:`repro_torch.serving.scheduler.
  Scheduler`), finished sequences release their slot and blocks.
* **Families** — the dense decoder (paged or dense KV), the
  attention-free rwkv stack and the jamba hybrid (mamba + attention +
  MoE).  The recurrent families keep their per-slot state in the dense
  cache (``supports_paged_kv`` is False) and replace it wholesale when a
  slot is admitted: rwkv's decode recurrence runs on the WKV kernel,
  every mamba scan (prefill and decode) on the selective-scan kernel, and
  a hybrid's attention layers keep dense per-slot k/v beside the states.
* **KV cache** — paged by default: a shared pool of fixed-size blocks
  with per-request block tables.  Decode **streams** KV tiles straight
  from the pool through the hand-written paged decode-attention kernel
  (``paged_kernel="stream"``); ``"gather"`` keeps the copy-then-attend
  path as the oracle.  ``paged=False`` is the dense per-slot cache.
  Unlike the reference's functional cache, the pool is updated **in
  place**: each layer's kernel reads the pool, folds in the new token,
  and only then is the new row scattered.
* **Prefill** — per request at batch 1, padded to power-of-two buckets
  (a recurrent family prefills at the exact prompt length: padded tokens
  would fold into its state); the resulting cache is copied into the pool
  (or the slot's dense region).
* **Preemption** — when the pool is exhausted the newest sequence is
  evicted and re-prefilled later (recompute).
* **Fused sampling** — by default the sampler runs on the device after
  each decode step and only token ids reach the host.
  ``steps_per_sync=S`` runs S decode steps per host readback (the
  reference's ``lax.scan`` window becomes a Python loop of S device
  steps with the finish rules applied on the device), and ``pipeline``
  enqueues window k+1 off window k's device state before reading window
  k back.  ``sampling="host"`` reads the logits row back every step (the
  parity oracle).

Not in this slice (each raises ``NotImplementedError``): a mesh / tp > 1,
the int8/fp8 KV pool, and any value other than the default of a config
field whose subsystem is not ported (``serving.config.UNPORTED``:
chunked prefill, the prefix cache, speculation, fault tolerance, the
front end).  ``w_dtype`` is carried as the reference carries it, for
telemetry: the engine's decode keeps the fp weights at any value.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from repro_torch.compiler.plan import resolve_kv_precision
from repro_torch.device import dtype_of, resolve_device
from repro_torch.kernels.decode_attention.ops import resolve_paged_kernel
from repro_torch.serving.config import DEFAULTS, UNPORTED, EngineConfig
from repro_torch.serving.kv_cache import (LANE, BlockPool,
                                          assert_pool_balanced, cache_bytes,
                                          per_rank_block_bytes,
                                          pool_blocks_for_budget,
                                          scatter_prefill_dense,
                                          scatter_prefill_pages)
from repro_torch.serving.sampler import (SamplingParams, sample_batched,
                                         sample_local)
from repro_torch.serving.scheduler import Scheduler, SeqSlot

StreamCB = Callable[[int, int], None]   # (request_id, token)


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    params: SamplingParams = SamplingParams()
    out: List[int] = field(default_factory=list)
    done: bool = False
    stream_cb: Optional[StreamCB] = None
    failed: bool = False          # rejected: can never fit the pool
    error: Optional[str] = None

    def resume_tokens(self) -> List[int]:
        """Tokens whose KV must be resident before decoding continues:
        the prompt, plus after preemption every generated token but the
        last (sampled, not yet fed through the model)."""
        if not self.out:
            return list(self.prompt)
        return list(self.prompt) + list(self.out[:-1])


@dataclass
class EngineStats:
    steps: int = 0
    tokens: int = 0
    busy_slot_steps: int = 0
    slot_steps: int = 0
    wall: float = 0.0
    preemptions: int = 0
    prefill_traces: int = 0       # distinct prefill buckets run
    prefills: int = 0             # total prefill launches (incl. resume)
    peak_pool_blocks: int = 0     # high-water block-pool occupancy
    host_syncs: int = 0           # blocking device->host readbacks
    prefill_syncs: int = 0        # ...of which sample a prefill row
    bytes_to_host: int = 0        # payload bytes of those readbacks
    overrun_tokens: int = 0       # sampled in a window, discarded by host
    decode_stalls: int = 0        # prefills run while decode streams were
                                  # in flight (each froze every stream)
    rejected_requests: int = 0    # admissions rejected with a structured
                                  # per-request failure
    device_decode_steps: int = 0  # decode forwards dispatched (each runs
                                  # every layer's decode attention once)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.wall if self.wall else 0.0

    @property
    def occupancy(self) -> float:
        return self.busy_slot_steps / max(self.slot_steps, 1)

    @property
    def bytes_to_host_per_token(self) -> float:
        return self.bytes_to_host / max(self.tokens, 1)

    @property
    def syncs_per_token(self) -> float:
        return self.host_syncs / max(self.tokens, 1)


class LPUEngine:
    """Slot-based continuous-batching decode engine on one device.

    ``LPUEngine(model, params, config=EngineConfig(...), device=...,
    seed=...)``; ``config`` defaults to ``EngineConfig()``.  ``device``
    defaults to ``cuda`` and raises when there is none: pass
    ``device="cpu"`` to run the plain PyTorch path.  ``seed`` seeds the
    sampler's ``torch.Generator``."""

    def __init__(self, model, params,
                 config: Optional[EngineConfig] = None, *,
                 mesh=None, seed: int = 0, device=None):
        c = EngineConfig() if config is None else config
        self.config = c
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "mesh / tensor parallelism (tp > 1) arrives with the port's "
                "tp slice; this engine runs on one device")
        for knob, subsystem in UNPORTED.items():
            if getattr(c, knob) != DEFAULTS[knob]:
                raise NotImplementedError(
                    f"{knob}={getattr(c, knob)!r} arrives with the "
                    f"{subsystem} slice of the port")
        self.model = model
        self.cfg = model.cfg
        self.plan = model.plan
        if model.device.type != self.device.type:
            raise ValueError(f"model built for {model.device}, engine on "
                             f"{self.device}")
        if params["embed" if "embed" in params else "embed_in"
                  ].device.type != self.device.type:
            raise ValueError(f"params are not on {self.device}")
        if self.device.type == "cuda":
            # f32 products and convolutions in full f32 (no TF32), as the
            # reference computes them: greedy streams are compared exactly
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params = params
        self.slots = c.slots
        self.max_seq = c.max_seq
        self.eos_id = c.eos_id
        self.tp = 1
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

        paged = c.paged if c.paged is not None else model.supports_paged_kv()
        self.paged = paged
        self.kv_prec = resolve_kv_precision(c.kv_dtype, self.plan.cache_dtype)
        if self.kv_prec.quantized:
            raise NotImplementedError(
                f"kv_dtype={c.kv_dtype!r} (int8/fp8 pool) arrives with the "
                "quantized-KV slice of the port")
        self.kv_dtype = self.kv_prec.store_dtype
        self.w_dtype = c.w_dtype
        if c.paged_kernel not in ("auto", "stream", "gather"):
            raise ValueError(f"paged_kernel={c.paged_kernel!r} not in "
                             "('auto', 'stream', 'gather')")
        if c.sampling not in ("fused", "host"):
            raise ValueError(f"sampling={c.sampling!r} not in "
                             "('fused', 'host')")
        if c.steps_per_sync < 1:
            raise ValueError(
                f"steps_per_sync={c.steps_per_sync} must be >= 1")
        if c.steps_per_sync > 1 and c.sampling != "fused":
            raise ValueError("steps_per_sync > 1 needs fused sampling: "
                             "the host path must read logits every step")
        self.sampling = c.sampling
        self.steps_per_sync = int(c.steps_per_sync)
        self.pipeline = bool(c.pipeline)
        self.block_s = int(c.block_s)
        self.bucketed = model.supports_paged_kv()
        if paged:
            self.block_size = c.block_size or min(LANE, self.max_seq)
            if self.max_seq % self.block_size:
                raise ValueError(f"max_seq={self.max_seq} is not a multiple "
                                 f"of block_size={self.block_size}")
            self.table_len = self.max_seq // self.block_size
            num_blocks = c.num_blocks
            if not num_blocks and c.kv_budget_bytes:
                a = self.plan.attn
                num_blocks = pool_blocks_for_budget(
                    c.kv_budget_bytes,
                    per_rank_block_bytes(
                        self.cfg.n_layers, a.kv_per_rank, a.d_head,
                        self.block_size, self.kv_prec.itemsize,
                        self.kv_prec.scale_itemsize))
            self.num_blocks = num_blocks or (self.slots * self.table_len + 1)
        else:
            self.block_size = self.max_seq
            self.table_len = 1
            self.num_blocks = self.slots
        pool = self._init_kv_state()
        self.paged_kernel = (resolve_paged_kernel(
            self.plan, self.block_size, c.paged_kernel) if self.paged
            else None)
        if self.block_s and self.paged_kernel == "stream" and \
                self.block_s != self.block_size:
            raise ValueError(
                "the streamed paged kernel's KV tile IS the pool "
                f"block_size ({self.block_size}); block_s={self.block_s} "
                "conflicts (use block_size, or the gather/dense paths "
                "where block_s sets the flash chunk)")
        self.sched = Scheduler(self.slots, self.max_seq, pool, c.min_bucket)
        self.stats = EngineStats()
        self._results: Dict[int, List[int]] = {}
        self._rid = 0
        self._buckets_traced: Set[int] = set()

    def _init_kv_state(self) -> Optional[BlockPool]:
        """A zeroed cache (pool or dense), fresh block tables and — paged
        — a fresh :class:`BlockPool`."""
        store = (None if self.kv_prec.requested == "auto"
                 else dtype_of(self.kv_prec.store_dtype))
        if self.paged:
            self.cache = self.model.init_cache(
                self.slots, self.max_seq, paged=True,
                num_blocks=self.num_blocks, block_size=self.block_size,
                dtype=store)
            self.block_tables = np.zeros((self.slots, self.table_len),
                                         np.int32)
            return BlockPool(self.num_blocks, self.block_size)
        self.cache = self.model.init_cache(self.slots, self.max_seq,
                                           dtype=store)
        self.block_tables = None
        return None

    def check_pool_balanced(self) -> None:
        """Raise unless every pool block's refcount balances to zero."""
        if self.sched.pool is not None:
            assert_pool_balanced(self.sched.pool)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- device steps --------------------------------------------------

    def _decode_fn(self, tokens: torch.Tensor, positions: torch.Tensor,
                   tables: Optional[torch.Tensor]) -> torch.Tensor:
        """One decode forward for the whole slot batch; the cache is
        updated in place.  Returns the (slots, V_pad) logits rows."""
        logits, _ = self.model.forward(
            self.params, tokens, mode="decode", positions=positions,
            cache=self.cache, block_tables=tables,
            paged_kernel=self.paged_kernel or "gather",
            block_s=self.block_s)
        self.stats.device_decode_steps += 1
        return logits[:, -1]

    def _window_fn(self, S: int, tables, last, pos, n_out, alive, temps,
                   top_ks, top_ps, max_new, stochastic: bool):
        """``S`` decode steps with sampling and the finish rules applied
        on the device; no host sync inside.  A slot that hits eos / its
        token budget / max_seq drops out of ``alive`` and is frozen: its
        (last, pos) stop advancing, so later steps rewrite the same KV
        row with the same value.  Returns the (S, slots) token matrix and
        the carry."""
        eos = -1 if self.eos_id is None else self.eos_id
        toks_all = []
        for _ in range(S):
            row = self._decode_fn(last[:, None], pos, tables)
            toks = sample_batched(row, self.gen, temps, top_ks, top_ps,
                                  stochastic)
            live = alive.to(torch.int32)
            n_out = n_out + live
            pos = pos + live
            fin = (n_out >= max_new) | (toks == eos) | \
                (pos >= self.max_seq - 1)
            last = torch.where(alive, toks, last)
            alive = alive & ~fin
            toks_all.append(toks)
        return torch.stack(toks_all), (last, pos, n_out, alive)

    def _prefill_fn(self, tokens: torch.Tensor, true_len: int):
        """Batch-1 prefill of a bucket-padded prompt into a fresh bucket
        cache.  Returns (last-valid-token logits row, filled cache)."""
        S = tokens.shape[1]
        cache = self.model.init_cache(1, S)
        positions = torch.arange(S, device=self.device)[None]
        logits, cache = self.model.forward(
            self.params, tokens, mode="prefill", cache=cache,
            positions=positions)
        return logits[0, true_len - 1], cache

    # -- sampling ------------------------------------------------------

    def _sample(self, logits_np: np.ndarray, row: torch.Tensor,
                params: SamplingParams) -> int:
        """Host-path sampling of one row already copied to the host."""
        if params.temperature <= 0.0:
            return int(np.argmax(logits_np))
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += 4
        return int(sample_local(row[None], self.gen, params)[0])

    def _sample_first(self, row: torch.Tensor,
                      params: SamplingParams) -> int:
        """Sample the prefill row per the engine's sampling mode (fused:
        only the token id crosses to the host)."""
        if self.sampling == "fused":
            d = self.device
            tok = sample_batched(
                row[None], self.gen,
                torch.tensor([params.temperature], device=d),
                torch.tensor([params.top_k], dtype=torch.int32, device=d),
                torch.tensor([params.top_p], device=d),
                params.temperature > 0.0)
            self.stats.host_syncs += 1
            self.stats.prefill_syncs += 1
            self.stats.bytes_to_host += 4
            return int(tok[0])
        row_np = row.cpu().numpy()
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += row_np.nbytes
        before = self.stats.host_syncs
        tok = self._sample(row_np, row, params)
        self.stats.prefill_syncs += 1 + self.stats.host_syncs - before
        return tok

    # -- prefill + admission -------------------------------------------

    def _refresh_tables(self) -> None:
        """Mirror decode-ready sequences' block lists into the (slots, T)
        table the decode steps read.  Empty slots stay all-zero: their
        don't-care writes land in the null block.  A fresh array every
        time: on the CPU ``torch.from_numpy`` shares its memory."""
        if not self.paged:
            return
        tables = np.zeros((self.slots, self.table_len), np.int32)
        for slot, seq in enumerate(self.sched.active):
            if seq is not None and seq.blocks:
                tables[slot, :len(seq.blocks)] = seq.blocks
        self.block_tables = tables

    def _should_finish(self, seq: SeqSlot, tok: int) -> bool:
        req = seq.req
        return (len(req.out) >= req.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)
                or seq.pos >= self.max_seq - 1)

    def _finish(self, seq: SeqSlot) -> Request:
        req = seq.req
        req.done = True
        self._results[req.rid] = req.out
        self.sched.release(seq)
        return req

    def _do_prefill(self, seq: SeqSlot) -> Optional[Request]:
        """Monolithic bucketed prefill of a just-admitted sequence; its
        cache is copied into the pool (or the slot's dense region).
        Returns the request if it finished immediately."""
        tokens = seq.req.resume_tokens()
        if self.sched.num_active() > 0:
            self.stats.decode_stalls += 1
        bucket = (self.sched.bucket(len(tokens)) if self.bucketed
                  else len(tokens))
        buf = np.zeros((1, bucket), np.int32)
        buf[0, :len(tokens)] = tokens
        row, pc = self._prefill_fn(self._to_dev(buf), len(tokens))
        self._buckets_traced.add(bucket)
        self.stats.prefills += 1
        if self.paged:
            table = np.zeros((bucket // self.block_size,), np.int32)
            table[:len(seq.blocks)] = seq.blocks
            scatter_prefill_pages(self.cache, pc, self._to_dev(table))
        else:
            scatter_prefill_dense(self.cache, pc, self.sched.slot_of(seq))
        return self._finish_prefill(seq, row)

    def _finish_prefill(self, seq: SeqSlot, row) -> Optional[Request]:
        """Restore the last sampled token (preemption resume) or sample
        the first one from the prefill row, then apply the finish rules."""
        req = seq.req
        if seq.resumed:
            seq.last_token = req.out[-1]
            return None
        tok = self._sample_first(row, req.params)
        req.out.append(tok)
        seq.last_token = tok
        if req.stream_cb:
            req.stream_cb(req.rid, tok)
        if self._should_finish(seq, tok):
            return self._finish(seq)
        return None

    # -- public API ----------------------------------------------------

    def submit(self, prompt: Union[Request, Sequence[int]],
               max_new_tokens: int = 32,
               params: Optional[SamplingParams] = None,
               stream_cb: Optional[StreamCB] = None) -> int:
        """Enqueue a request (non-blocking).  Returns its request id."""
        if isinstance(prompt, Request):
            req = prompt
        else:
            req = Request(self._rid, list(prompt), max_new_tokens,
                          params or SamplingParams(0.0, 0, 1.0),
                          stream_cb=stream_cb)
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) >= self.max_seq:
            raise ValueError(
                f"prompt length {len(req.prompt)} >= max_seq "
                f"{self.max_seq}: no room to decode")
        self._rid = max(self._rid, req.rid) + 1
        self.sched.submit(req)
        return req.rid

    def step(self) -> List[Request]:
        """One scheduler round: admit + prefill, then one decode round
        for the whole slot batch.  Returns requests finished this round."""
        t0 = time.perf_counter()
        try:
            return self._step()
        finally:
            self.stats.wall += time.perf_counter() - t0

    def _step(self) -> List[Request]:
        finished: List[Request] = []
        while True:
            seq = self.sched.admit_next()
            if seq is None:
                break
            done = self._do_prefill(seq)
            if done is not None:
                finished.append(done)
        finished += self._harvest_rejections()
        self.sched.ensure_decode_capacity()     # may preempt (recompute)
        self.stats.preemptions = self.sched.preemptions
        if self.sched.pool is not None:
            self.stats.peak_pool_blocks = max(self.stats.peak_pool_blocks,
                                              self.sched.pool.num_used)
        if self.sched.num_active() == 0:
            return finished
        if self.sampling == "fused":
            finished += self._fused_decode_round()
        else:
            finished += self._host_decode_step()
        self.stats.prefill_traces = len(self._buckets_traced)
        return finished

    def _harvest_rejections(self) -> List[Request]:
        """Requests that can never fit the pool end as structured
        per-request failures (see ``Scheduler.take_rejected``)."""
        finished: List[Request] = []
        for req, why in self.sched.take_rejected():
            req.done = True
            req.failed = True
            req.error = why
            self._results[req.rid] = req.out
            self.stats.rejected_requests += 1
            finished.append(req)
        return finished

    # -- host-sampled decode (the parity oracle) -----------------------

    def _host_decode_step(self) -> List[Request]:
        """One decode step whose full (slots, vocab) logits cross to the
        host, sampled there slot by slot."""
        self._refresh_tables()
        toks = np.zeros((self.slots, 1), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for slot, seq in enumerate(self.sched.active):
            if seq is not None:
                toks[slot, 0] = seq.last_token
                pos[slot] = seq.pos
        tables = self._to_dev(self.block_tables) if self.paged else None
        logits = self._decode_fn(self._to_dev(toks), self._to_dev(pos),
                                 tables)
        logits_np = logits.cpu().numpy()
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += logits_np.nbytes
        finished: List[Request] = []
        self.stats.steps += 1
        self.stats.slot_steps += self.slots
        for slot, seq in enumerate(self.sched.active):
            if seq is None:
                continue
            req = seq.req
            self.stats.busy_slot_steps += 1
            self.stats.tokens += 1
            tok = self._sample(logits_np[slot], logits[slot], req.params)
            req.out.append(tok)
            seq.pos += 1
            seq.last_token = tok
            if req.stream_cb:
                req.stream_cb(req.rid, tok)
            if self._should_finish(seq, tok):
                finished.append(self._finish(seq))
        return finished

    # -- fused decode: multi-step windows ------------------------------

    def _slot_state(self) -> Tuple[tuple, tuple, bool]:
        """Host slot state -> the window's carry, per-slot sampling
        parameters (small uploads) and whether any slot samples."""
        B = self.slots
        last = np.zeros((B,), np.int32)
        pos = np.zeros((B,), np.int32)
        n_out = np.zeros((B,), np.int32)
        alive = np.zeros((B,), bool)
        temps = np.zeros((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        max_new = np.zeros((B,), np.int32)
        for slot, seq in enumerate(self.sched.active):
            if seq is None:
                continue
            sp = seq.req.params
            last[slot] = seq.last_token
            pos[slot] = seq.pos
            n_out[slot] = len(seq.req.out)
            alive[slot] = True
            temps[slot] = sp.temperature
            top_ks[slot] = sp.top_k
            top_ps[slot] = sp.top_p
            max_new[slot] = seq.req.max_new_tokens
        stochastic = bool((temps[alive] > 0.0).any())
        carry = tuple(self._to_dev(a) for a in (last, pos, n_out, alive))
        samp = tuple(self._to_dev(a)
                     for a in (temps, top_ks, top_ps, max_new))
        return carry, samp, stochastic

    def _admission_waiting(self) -> bool:
        """A queued request AND a free slot: windows shrink to one step so
        admission latency stays at the single-step baseline's."""
        return bool(self.sched.queue) and \
            any(s is None for s in self.sched.active)

    def _may_survive(self, steps: int) -> bool:
        """Could any decode-ready slot still be alive after ``steps``
        more tokens?  (Budget/length check only.)"""
        for seq in self.sched.active:
            if seq is None:
                continue
            if (seq.req.max_new_tokens - len(seq.req.out)) > steps and \
                    (self.max_seq - 1 - seq.pos) > steps:
                return True
        return False

    def _dispatch_window(self, win: int, carry: tuple, samp: tuple,
                         stochastic: bool):
        """Enqueue one window (the device runs it asynchronously).
        Returns ((win, token matrix, active snapshot), device carry)."""
        tables = self._to_dev(self.block_tables) if self.paged else None
        tok_mat, carry = self._window_fn(win, tables, *carry, *samp,
                                         stochastic)
        snapshot = [s is not None for s in self.sched.active]
        return (win, tok_mat, snapshot), carry

    def _reconcile(self, handle) -> List[Request]:
        """Read a window's token matrix back (the ONE device->host sync
        per window) and replay the finish rules the device applied:
        tokens of slots that finished earlier are overrun and dropped."""
        win, tok_mat, dispatch_active = handle
        toks = tok_mat.cpu().numpy()                   # (win, slots)
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += toks.nbytes
        finished: List[Request] = []
        for s in range(win):
            if self.sched.num_active() == 0:
                self.stats.overrun_tokens += \
                    (win - s) * sum(dispatch_active)
                break
            self.stats.steps += 1
            self.stats.slot_steps += self.slots
            for slot, seq in enumerate(self.sched.active):
                if seq is None:
                    if dispatch_active[slot]:
                        self.stats.overrun_tokens += 1
                    continue
                req = seq.req
                self.stats.busy_slot_steps += 1
                self.stats.tokens += 1
                tok = int(toks[s, slot])
                req.out.append(tok)
                seq.pos += 1
                seq.last_token = tok
                if req.stream_cb:
                    req.stream_cb(req.rid, tok)
                if self._should_finish(seq, tok):
                    finished.append(self._finish(seq))
        return finished

    def _fused_decode_round(self) -> List[Request]:
        """One fused decode round: up to two windows.

        The window is ``steps_per_sync`` long when no admission is
        waiting and the scheduler can reserve the whole window's blocks
        without preemption, else one step.  With ``pipeline`` and an
        empty queue, window k+1 is enqueued off window k's device carry
        before window k is read back: the host prepares the next window
        while the device still runs this one, and the device-side finish
        masking keeps the chained carry exact."""
        S = self.steps_per_sync
        win = S if (S > 1 and not self._admission_waiting()
                    and self.sched.reserve_lookahead(S)) else 1
        self._refresh_tables()
        carry, samp, stochastic = self._slot_state()
        h1, dev_carry = self._dispatch_window(win, carry, samp, stochastic)
        h2 = None
        if self.pipeline and not self.sched.queue \
                and self._may_survive(win) \
                and self.sched.reserve_lookahead(2 * win):
            self._refresh_tables()
            h2, _ = self._dispatch_window(win, dev_carry, samp, stochastic)
        finished = self._reconcile(h1)
        if h2 is not None:
            finished += self._reconcile(h2)
        return finished

    def drain(self) -> Dict[int, List[int]]:
        """Step until the queue and all slots are empty; returns
        {rid: generated tokens} finished since the last drain."""
        while self.sched.has_work():
            self.step()
        self.stats.prefill_traces = len(self._buckets_traced)
        out, self._results = self._results, {}
        return out

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 params: Optional[SamplingParams] = None,
                 stream_cb: Optional[StreamCB] = None) -> List[List[int]]:
        """HF-like entry point: batch of prompts -> generated ids."""
        rids = [self.submit(list(p), max_new_tokens, params,
                            stream_cb=stream_cb) for p in prompts]
        results = self.drain()
        return [results[r] for r in rids]

    # -- monitoring ----------------------------------------------------

    def kv_cache_bytes(self) -> int:
        """Bytes held by the KV cache (block pool or dense slot cache)."""
        return cache_bytes(self.cache)

    def per_rank_kv_bytes(self) -> int:
        return self.kv_cache_bytes() // self.tp

    def kv_bytes_moved_per_step(self) -> int:
        """Analytic KV bytes moved per decode step: the resident span V
        for the dense and streamed paths, 3V for the gather oracle (read
        the pool, write the view, read the view back).  A recurrent
        family's state is read whole and written whole every step: twice
        its bytes.  A hybrid stack counts its attention layers' k/v and
        twice its mamba states (``conv``, ``ssm``)."""
        cfg = self.cfg
        if cfg.family == "rwkv":
            return 2 * self.kv_cache_bytes()
        a = self.plan.attn
        row = self.kv_prec.bytes_per_row_head(a.d_head)
        n_attn = sum(cfg.is_attention_layer(i) for i in range(cfg.n_layers))
        v = 2 * n_attn * self.slots * self.table_len \
            * self.block_size * a.gp * row
        v = 3 * v if self.paged_kernel == "gather" else v
        states = {lj: c for lj, c in self.cache.items() if "ssm" in c}
        return v + 2 * cache_bytes(states)

    def dense_equiv_bytes(self) -> int:
        """Bytes a dense (slots, max_seq) cache of this model would take."""
        if not self.paged:
            return self.kv_cache_bytes()
        per_tok = self.kv_cache_bytes() // (self.num_blocks
                                            * self.block_size)
        return per_tok * self.slots * self.max_seq

    def decode_block_s(self) -> int:
        """KV tile of the decode path: the pool block when streaming,
        else the flash chunk (``block_s`` or 2048, clamped to max_seq)."""
        if self.paged and self.paged_kernel == "stream":
            return self.block_size
        return min(self.block_s or 2048, self.max_seq)
