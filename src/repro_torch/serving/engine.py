"""Continuous-batching serving engine (the port of the reference's
``serving/engine.py`` ``LPUEngine``), on one device or as one rank of
the model ring.

* **API** — blocking ``generate(prompts, ...)`` plus non-blocking
  ``submit(request) / step() / drain()``.
* **Scheduler** — a fixed decode batch of ``slots``; queued requests are
  admitted at step boundaries (:class:`repro_torch.serving.scheduler.
  Scheduler`), finished sequences release their slot and blocks.
* **Families** — the dense decoder (paged or dense KV), the MoE
  stacks (granite, llama4 with its shared expert) and the vlm (llava,
  served as a text decoder: the reference's engine passes no patch
  embeddings), all attention-only and so on the paged pool, the
  attention-free rwkv stack and the jamba hybrid (mamba + attention +
  MoE).  An encoder-decoder (whisper) is refused: its prefill needs the
  encoder's frames, which no engine path carries; it is served through
  :mod:`repro_torch.core.steps`.  The recurrent families keep their
  per-slot state in the dense cache (``supports_paged_kv`` is False)
  and replace it wholesale when a slot is admitted: rwkv's decode
  recurrence runs on the WKV kernel, every mamba scan (prefill and
  decode) on the selective-scan kernel, and a hybrid's attention layers
  keep dense per-slot k/v beside the states.
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
  (or the slot's dense region).  With ``prefill_chunk=C`` (paged pool
  only) the prompt instead becomes resident C tokens per ``step()``, its
  K/V scattered into the pool chunk by chunk while the same step still
  dispatches a decode window, so a long prompt never freezes the
  streams in flight (``decode_stalls`` stays 0).  Each chunk's queries
  are the paged kernel's batch, one broadcast block table, lengths
  ``start + i + 1``.
* **Prefix cache** — with ``prefix_cache=True`` (paged pool only) a
  block-aligned hash index over prompt prefixes lets a new request map
  resident blocks (refcounted) into its table and prefill only the tail;
  a shared block is copied (copy-on-write) before a write into it, and
  cached blocks at refcount zero are recycled LRU-first.
* **Quantized KV** — ``kv_dtype="int8"|"fp8"`` (paged pool only)
  stores K/V as int8 or ``float8_e4m3fn`` with one f16 absmax scale per
  row and kv head in ``k_scale``/``v_scale`` leaves beside the values.
  Every row is quantized at pool-write time (prefill, chunk, decode,
  verify), the paged kernel dequantizes in its tile loop, and decode
  folds the dequantized round-trip of its new row.
* **Speculative decoding** — ``speculate="ngram"|"model"`` (or a
  ``drafter=`` object; paged pool only): a host-side drafter proposes
  up to ``draft_k`` tokens per slot, ONE verify forward scores every
  slot's K+1 positions (the queries are the paged kernel's batch, one
  block table each) and rejection sampling accepts a per-slot prefix.
  Rejected rows roll back logically: ``pos`` advances over emitted
  tokens only, and the stale rows are masked and later overwritten.
* **Preemption** — when the pool is exhausted the newest sequence is
  evicted and re-prefilled later (recompute).
* **Fused sampling** — by default the sampler runs on the device after
  each decode step and only token ids reach the host.
  ``steps_per_sync=S`` runs S decode steps per host readback with the
  finish rules applied on the device, and ``pipeline`` enqueues window
  k+1 off window k's device state before reading window k back.
  ``sampling="host"`` reads the logits row back every step (the parity
  oracle).
* **One program per device step** — as the reference jits its
  ``lax.scan`` window once per S, its fused verify round once per K,
  its prefill once per bucket, its chunk program once per C, its
  first-token sampler, its block copy and its host-sampled decode step,
  the engine runs each of them as the replay of a CUDA graph
  (:mod:`repro_torch.serving.graphs`), keyed by ``("window", S,
  stochastic)``, ``("verify", K, stochastic)``, ``("prefill",
  bucket)``, ``("chunk", C)`` (chunks and prefix tails alike),
  ``("sample", stochastic)``, ``("cow",)`` and ``("host_decode",)``.
  Every value that changes between calls — tokens, lengths, block
  tables, slot, carry, sampling arrays — is read inside the program
  from a persistent device buffer, never baked in as a Python number;
  the host uploads only what changed and reads back token ids (one per
  prefill).  The monolithic prefill allocates its bucket's scratch
  cache inside its graph, scatters it into the pool and copies its last
  valid logits row into the sampler's static row; the sampler is a
  program of its own, so a non-final chunk draws nothing.  The graphs
  are captured on first use, after one eager warm-up on dead inputs (a
  dense or recurrent cache and the generator are restored around it).
  On the CPU the same functions run on the same buffers, each program
  the function it was first built from.  ``graphs=False`` runs them
  eagerly on the card too: the eager twin, as ``jax.disable_jit`` is
  the reference's.  The exact-length prefill of a recurrent stack
  (rwkv, jamba) stays eager: one program per prompt length would
  capture again for every new length.

* **Fault tolerance** — ``chaos="kind@step[:ring],..."`` injects
  deterministic faults (:mod:`repro_torch.serving.ft`): ``ring`` raises
  :class:`RingFailure`, ``stall`` wedges the engine, ``nan`` poisons the
  next decode window's logits on the device (a flag in the window's
  static buffer, read inside the captured program), ``corrupt``
  overwrites a resident pool block with NaN in place.  The window also
  writes an (S, slots) "row was finite" matrix beside its tokens, read
  back in the same one copy; the host raises ``RingFailure("nan_logits")``
  at the first bad step, before that step's tokens commit.
  :meth:`LPUEngine.reset` drains the engine: it zeroes every cache
  tensor in place (each captured program holds their addresses), keeps
  every program, rebuilds the host side (pool, prefix index, scheduler)
  and returns the orphaned requests.  :class:`MultiRingEngine` (a host
  fleet: N engines on one device, sharing one set of weight tensors; or
  a mesh fleet: sub-rings of ring-parallel engines, a process per rank,
  that agree once a round) routes requests, supervises the rings' steps
  and runs drain -> migrate (the recompute-resume path) -> rebuild on a
  ring failure, a heartbeat timeout or, with ``ft_straggler_drain``, a
  straggler.

* **Step knobs** — :meth:`LPUEngine.set_step_knobs` retunes
  ``steps_per_sync`` and ``prefill_chunk`` between steps (the seam the
  async front end's SLO budget scheduler drives,
  :mod:`repro_torch.serving.frontend`).  A new S or C costs one program
  (on the card one capture, counted in ``graph_captures``); a new S
  first gets its window output buffer, which keeps its address for the
  engine's life, because the captured window writes into it.

* **Ring parallelism (C2)** — ``LPUEngine(model, shards, config,
  mesh=ring)`` in every rank of a ring spawned by
  :func:`repro_torch.core.dist.run_ranks` (the model planned for
  ``("model",), (tp,)``, ``shards`` the rank's leaves from
  :func:`repro_torch.weights.init_shard` or
  :func:`repro_torch.weights.shard_params`) is the reference's
  ``shard_map`` engine: each rank holds its slice of the weights and its
  own pool of kv_per_rank heads with the same block ids on every rank,
  and runs the same deterministic host logic (scheduler, block pool,
  prefix cache) on the same submissions.  Every matmul is an ESL
  collective matmul; the logits stay vocab-sharded, and the window
  samples from the all-gathered (tp x k) candidates with identically
  seeded generators (:func:`sample_sharded_batched`), so every rank
  draws the same token and none broadcasts a decision.  The NaN guard's
  verdict is agreed ring-wide by a ``psum``.  The dense and MoE stacks
  from the paged pool or the dense cache, with monolithic or chunked
  prefill, the prefix cache, preemption, fused (or host) sampling and
  both ESL modes; rwkv and the hybrid (mamba + attention + MoE) from
  their dense per-slot state, each rank's slice of it (rwkv's WKV state
  on the rank's heads, mamba's conv and ssm on its channels, the shifts
  on its channels under overlap and whole in the blocking baseline),
  prefilled eagerly at the exact prompt length.  On an NCCL ring (a card per rank) every program the tp=1
  engine captures is captured on every rank, at the same key and in the
  same order (every rank runs the same host logic), its collectives
  inside the graph and the NaN guard's verdict on the device; a replay
  adds its capture's collectives to ``ring.counters``.  A gloo ring's
  collectives (the CPU, or ranks sharing one card) cannot be captured,
  so ``graphs=True`` on it raises and its steps run eagerly.  A vlm
  serves there as a text decoder.  Speculation composes with the ring
  as at tp=1: every rank's drafter proposes the same drafts from the
  same streams (the n-gram drafter's tokens are replicated; the model
  drafter runs its draft model at tp 1 on the rank's own device), the
  verify window runs on the rank's heads and pool, and the fused round
  verifies from the all-gathered (tp x k) candidates of each row with
  identically seeded generators (:func:`speculative_verify_sharded`),
  while the host-sampled round gathers the rows whole on every rank.
  The mesh fleet runs one such engine per sub-ring
  (:class:`MultiRingEngine` with ``mesh=ring``); an encoder-decoder has
  no engine path on any mesh.

``w_dtype`` is carried as the reference carries it, for telemetry: the
engine's decode keeps the fp weights at any value.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from dataclasses import fields as dc_fields
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Set, Tuple, Union)

import numpy as np
import torch

from repro_torch.compiler.plan import resolve_kv_precision
from repro_torch.core import dist as ring_dist
from repro_torch.core import esl
from repro_torch.core.dist import make_axis_env
from repro_torch.device import dtype_of, resolve_device
from repro_torch.kernels.decode_attention.ops import resolve_paged_kernel
from repro_torch.serving.config import SPECULATE, EngineConfig
from repro_torch.serving.drafter import make_drafter
from repro_torch.serving.ft import (Event, FailureInjector, HeartbeatTracker,
                                    ManualClock, RingFailure,
                                    StragglerMonitor, parse_chaos)
from repro_torch.serving.graphs import Programs, StagedBuffer
from repro_torch.serving.kv_cache import (LANE, BlockPool, PrefixCache,
                                          assert_pool_balanced, cache_bytes,
                                          copy_pool_block,
                                          per_rank_block_bytes,
                                          pool_blocks_for_budget,
                                          scatter_prefill_dense,
                                          scatter_prefill_pages)
from repro_torch.serving.sampler import (SamplingParams, sample_local,
                                         sample_sharded_batched,
                                         spec_verify_rows,
                                         speculative_verify_sharded)
from repro_torch.serving.scheduler import (RingRouter, Scheduler, SeqSlot,
                                           queued_load)

StreamCB = Callable[[int, int], None]   # (request_id, token)
FLEET_ROUND_S = 1.0   # one fleet round on a chaotic fleet's ManualClock


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    params: SamplingParams = SamplingParams()
    out: List[int] = field(default_factory=list)
    done: bool = False
    stream_cb: Optional[StreamCB] = None
    failed: bool = False          # structured failure: rejected (can
                                  # never fit the pool) or out of
                                  # migrations; ``error`` says why
    error: Optional[str] = None
    cancelled: bool = False       # aborted by the caller: done, not
                                  # failed (the partial stream is kept)

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
    prefill_chunks: int = 0       # chunk launches (chunked prefill mode)
    decode_stalls: int = 0        # monolithic prefills run while other
                                  # decode streams were in flight (each
                                  # froze them; 0 in chunked mode)
    prefix_lookups: int = 0       # admissions that consulted the index
    prefix_hits: int = 0          # ...that admitted with shared blocks
    prefix_hit_blocks: int = 0    # pool blocks mapped from the index
    prefill_tokens_saved: int = 0 # prompt tokens not prefilled thanks to
                                  # prefix hits
    evicted_blocks: int = 0       # cached refcount-0 blocks recycled by
                                  # the pool's LRU
    cow_blocks: int = 0           # copy-on-write splits of shared blocks
    rejected_requests: int = 0    # admissions rejected with a structured
                                  # per-request failure
    device_decode_steps: int = 0  # decode forwards dispatched (each runs
                                  # every layer's decode attention once)
    graph_captures: int = 0       # programs captured (every kind)
    graph_replays: int = 0        # ...and replayed
    spec_rounds: int = 0          # speculative verify rounds (one verify
                                  # forward each)
    draft_tokens: int = 0         # drafter-proposed tokens verified
    accepted_tokens: int = 0      # ...accepted by rejection sampling
    ring_failures: int = 0        # drain/rebuild cycles of this engine
    migrated_requests: int = 0    # in-flight requests taken over from a
                                  # failed ring (recompute resume)
    retries: int = 0              # recovery resubmissions admitted here
                                  # (incl. back onto a lone rebuilt ring)
    cancelled_requests: int = 0   # aborted via cancel()

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

    @property
    def prefix_hit_rate(self) -> float:
        """Share of prefix-index lookups that mapped a shared block."""
        return self.prefix_hits / max(self.prefix_lookups, 1)

    @property
    def acceptance_rate(self) -> float:
        """Share of drafter-proposed tokens the verify pass accepted
        (real proposals only, never the padding of slots the drafter
        had nothing for)."""
        return self.accepted_tokens / max(self.draft_tokens, 1)

    @property
    def accepted_per_window(self) -> float:
        """Mean accepted draft tokens per speculative round: each one is
        a decode step the engine did not run."""
        return self.accepted_tokens / max(self.spec_rounds, 1)


# the supervision's own counters, kept by a mesh fleet's view of each ring
# (every rank applies the same supervision); a ring's record carries the
# others
SUPERVISED = ("ring_failures", "migrated_requests", "retries")
STATS_FIELDS = tuple(f.name for f in dc_fields(EngineStats)
                     if f.name not in SUPERVISED)


def checked_knobs(eng, prefill_chunk: Optional[int],
                  steps_per_sync: Optional[int]
                  ) -> Tuple[Optional[int], Optional[int]]:
    """The step knobs :meth:`LPUEngine.set_step_knobs` would set on
    ``eng`` (an engine or a fleet's view of one: its ``sampling``,
    ``paged`` and ``prefill_chunk``), checked: raises as the engine's
    constructor does, and for a chunked engine asked to go back to
    monolithic prefill."""
    s = c = None
    if steps_per_sync is not None:
        s = int(steps_per_sync)
        if s < 1:
            raise ValueError(f"steps_per_sync={s} must be >= 1")
        if s > 1 and eng.sampling != "fused":
            raise ValueError("steps_per_sync > 1 needs fused sampling")
    if prefill_chunk is not None:
        c = int(prefill_chunk)
        if c < 0:
            raise ValueError(f"prefill_chunk={c} must be >= 0")
        if c and not eng.paged:
            raise ValueError("prefill_chunk needs the paged KV pool")
        if c == 0 and eng.prefill_chunk:
            raise ValueError(
                "cannot leave chunked-prefill mode mid-serve: "
                "admitted prompts may be partially resident")
    return c, s


def refuse_encdec(cfg) -> None:
    """Raise for an encoder-decoder config: the reference's engine has no
    path for one (its prefill needs the encoder's frames)."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{cfg.name}: the engine has no encoder-decoder path (its "
            "prefill needs the encoder's frames); serve it through "
            "repro_torch/core/steps.py (build_prefill_step, "
            "build_serve_step)")


class LPUEngine:
    """Slot-based continuous-batching decode engine on one device.

    ``LPUEngine(model, params, config=EngineConfig(...), device=...,
    seed=...)``; ``config`` defaults to ``EngineConfig()``.  ``device``
    defaults to ``cuda`` and raises when there is none: pass
    ``device="cpu"`` to run the plain PyTorch path.  ``seed`` seeds the
    sampler's ``torch.Generator``.  ``drafter=`` injects a proposer (any
    object with ``propose(tokens, k)``) and turns speculation on;
    ``speculate="model"`` needs ``draft_model``/``draft_params``.
    ``graphs=False`` runs the device steps eagerly instead of replaying
    their captured CUDA graphs (the eager twin; on the CPU nothing is
    captured either way).  ``mesh``: the rank's
    :class:`repro_torch.core.dist.Ring` when the engine is one rank of
    the model ring (a model planned for it, ``params`` the rank's
    shards; ``graphs=False`` on a gloo ring)."""

    def __init__(self, model, params,
                 config: Optional[EngineConfig] = None, *,
                 mesh=None, seed: int = 0, device=None, drafter=None,
                 draft_model=None, draft_params=None, graphs: bool = True):
        c = EngineConfig() if config is None else config
        self.config = c
        self.device = resolve_device(device)
        refuse_encdec(model.cfg)
        if model.plan.mesh_axes is not None and \
                "data" in model.plan.mesh_axes:
            # the reference's paged engine serves a ("data", "model")
            # mesh (its dense cache does not: ROADMAP)
            raise NotImplementedError(
                f"the engine on a data axis (a plan for "
                f"{model.plan.mesh_axes}{model.plan.mesh_shape}) is not "
                "ported yet: serve the grid through core/steps.py's "
                "build_prefill_step / build_serve_step, or plan the engine "
                "for the ring ('model',)")
        self._check_ring(model, params, mesh, graphs)
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
        if self.cfg.positional == "learned" and \
                self.max_seq > self.cfg.max_seq:
            # the window rule keeps every position below max_seq, so this
            # bound keeps every lookup inside the table (on the card a
            # lookup past it is a device-side assert; the reference's
            # take fills NaN there)
            raise ValueError(
                f"max_seq={self.max_seq} exceeds {self.cfg.name}'s learned "
                f"position table of {self.cfg.max_seq} rows")
        self.eos_id = c.eos_id
        self.env = make_axis_env(self.plan, batch=self.slots, ring=mesh)
        self.ring = mesh
        self.tp = self.env.tp
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

        paged = c.paged if c.paged is not None else model.supports_paged_kv()
        self.paged = paged
        self.kv_prec = resolve_kv_precision(c.kv_dtype, self.plan.cache_dtype)
        if self.kv_prec.quantized and not paged:
            raise ValueError(
                f"kv_dtype={c.kv_dtype!r} needs the paged KV pool: the "
                "scales live beside pool blocks; dense caches store fp")
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
        if c.prefill_chunk < 0:
            raise ValueError(f"prefill_chunk={c.prefill_chunk} must be >= 0")
        if c.prefill_chunk and not self.paged:
            raise ValueError(
                "prefill_chunk needs the paged KV pool (attention-only "
                "stacks); dense / recurrent-state caches prefill "
                "monolithically")
        self.prefill_chunk = int(c.prefill_chunk)
        if c.prefix_cache and not self.paged:
            raise ValueError(
                "prefix_cache needs the paged KV pool (attention-only "
                "stacks); the dense per-slot cache cannot share blocks")
        self.prefix = PrefixCache(pool) if c.prefix_cache else None
        if c.speculate not in SPECULATE:
            raise ValueError(f"speculate={c.speculate!r} not in {SPECULATE}")
        if c.draft_k < 1:
            raise ValueError(f"draft_k={c.draft_k} must be >= 1")
        if c.speculate == "model" and draft_model is not None and \
                draft_model.cfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"the draft model's vocabulary ({draft_model.cfg.vocab_size}"
                f") is not the target's ({self.cfg.vocab_size}): its "
                "embedding cannot read the target's tokens")
        self.drafter = drafter if drafter is not None else make_drafter(
            c.speculate, draft_model=draft_model, draft_params=draft_params,
            max_seq=self.max_seq)
        if self.drafter is not None and not self.paged:
            raise ValueError(
                "speculate needs the paged KV pool: the verify pass "
                "scatters draft KV per query through block tables")
        self.speculate = ("off" if self.drafter is None
                          else c.speculate if c.speculate != "off"
                          else "custom")
        self.draft_k = int(c.draft_k)
        # fault tolerance: ``ring_id`` is stamped by MultiRingEngine (a
        # lone engine is ring 0); the injector's fired set lives outside
        # what reset() rebuilds, so an event fires once per engine
        self.ring_id = 0
        self.events: List[Event] = []
        self._step_no = 0
        self._stalled = False
        self._poison_next = False
        self._free_after_admit = 0
        self.injector: Optional[FailureInjector] = None
        if c.chaos:
            chaos_events = parse_chaos(c.chaos)
            if self.drafter is not None:
                raise ValueError(
                    "chaos injection does not compose with speculative "
                    "decoding yet: the verify path has no finite-logits "
                    "guard, so a NaN fault could commit tokens")
            if not self.paged and \
                    any(e.kind == "corrupt" for e in chaos_events):
                raise ValueError(
                    "chaos kind 'corrupt' poisons a KV pool block and "
                    "needs the paged pool (dense caches have no blocks)")
            self.injector = FailureInjector(chaos=chaos_events)
        self.sched = Scheduler(self.slots, self.max_seq, pool, c.min_bucket,
                               prefix=self.prefix)
        self.stats = EngineStats()
        # the stats fields assigned from subsystem counters (scheduler,
        # pool, prefix index) add these bases, banked by reset() before
        # it rebuilds those subsystems from zero: the stats stay monotone
        self._ctr_base = dict(preemptions=0, evicted_blocks=0,
                              prefix_lookups=0, prefix_hits=0,
                              prefix_hit_blocks=0, prefill_tokens_saved=0)
        self._results: Dict[int, List[int]] = {}
        self._rid = 0
        self._chunk_rr = -1           # admit_seq of the last chunk served
        self._buckets_traced: Set = set()
        # the window's static inputs (carry + sampling arrays + the chaos
        # poison flag, tables) and its outputs by length (_window_out);
        # the verify round's by K
        self.graphs = bool(graphs)
        self._programs = Programs(self.device, ring=mesh)
        B = self.slots
        self._win = StagedBuffer(
            [(n, (B,), "i32") for n in ("last", "pos", "n_out", "alive",
                                        "top_ks", "max_new")]
            + [(n, (B,), "f32") for n in ("temps", "top_ps")]
            + [("poison", (1,), "i32")], self.device)
        self._tables = (StagedBuffer([("tables", (B, self.table_len), "i32")],
                                     self.device) if self.paged else None)
        self._win_out, self._tok_out, self._ok_out = {}, {}, {}
        self._ver: Dict[int, StagedBuffer] = {}
        self._ver_out: Dict[int, torch.Tensor] = {}
        # the admission side's programs (prefill, chunk, first-token
        # sampler, block copy) and the host-sampled decode step, in the
        # windows' memory pool, with their static inputs by key; the
        # prefill and the chunk write their last valid logits row into
        # _row, which the sampler reads, writing its token into _first
        self._admit = Programs(self.device, share=self._programs, ring=mesh)
        self._bufs: Dict[tuple, StagedBuffer] = {}
        v_pad = (params["head"].shape[-1] if "head" in params
                 else params["embed"].shape[0])
        self._row = torch.zeros((v_pad,), dtype=dtype_of(
            self.plan.compute_dtype), device=self.device)
        self._first = torch.zeros((1,), dtype=torch.int32,
                                  device=self.device)
        self._host_logits = None      # (slots, V_pad), at first use

    def _check_ring(self, model, params, mesh, graphs: bool) -> None:
        """Refuse what the ring does not run: a plan and a ring that
        disagree, the full tree in place of the rank's shards, and a
        captured program on a gloo ring (an NCCL ring's are
        captured)."""
        plan = model.plan
        if mesh is None:
            if plan.tp > 1:
                raise ValueError(
                    f"a plan for tp={plan.tp} needs mesh=the rank's ring "
                    "(repro_torch.core.dist.run_ranks)")
            return
        if plan.mesh_axes != ("model",):
            raise ValueError(f"a ring needs a plan built for it (mesh_axes "
                             f"('model',)); the plan has {plan.mesh_axes}")
        if plan.tp != mesh.size:
            raise ValueError(f"plan built for tp={plan.tp}, ring of "
                             f"{mesh.size} ranks")
        if mesh.device != self.device:
            raise ValueError(f"ring on {mesh.device}, engine on "
                             f"{self.device}")
        v_loc = (params["head"].shape[-1] if "head" in params
                 else params["embed"].shape[0])
        if v_loc * plan.tp != plan.vocab_padded:
            raise ValueError(
                f"params hold {v_loc} vocab columns, a rank's shard of "
                f"{plan.vocab_padded} is {plan.vocab_padded // plan.tp}: "
                "pass the rank's leaves (weights.shard_params)")
        if graphs and mesh.backend == "gloo":
            raise ValueError(
                "graphs=True on a gloo ring: a gloo collective cannot be "
                "captured in a CUDA graph; pass graphs=False (the ring's "
                "steps run eagerly)")

    def _full_row(self, rows: torch.Tensor) -> torch.Tensor:
        """Logits rows whole: on the ring the ranks' vocab columns
        gathered (the host-sampling path reads every column)."""
        if self.tp == 1:
            return rows
        return esl.gather_scattered(rows, axis=self.ring, tp=self.tp)

    def _window_out(self, S: int) -> torch.Tensor:
        """The output buffer of the S-step window, made at first use: the
        (S, slots) int32 token matrix and bool finite-row matrix in one
        byte buffer (``_tok_out[S]`` and ``_ok_out[S]`` are views), read
        back in one copy.  It is made before the window's program is
        built, outside any capture, and never replaced (``reset()`` keeps
        it): the captured window writes to its address."""
        buf = self._win_out.get(S)
        if buf is None:
            B = self.slots
            buf = torch.zeros((5 * S * B,), dtype=torch.uint8,
                              device=self.device)
            self._win_out[S] = buf
            self._tok_out[S] = buf[:4 * S * B].view(torch.int32).view(S, B)
            self._ok_out[S] = buf[4 * S * B:].view(torch.bool).view(S, B)
        return buf

    def _init_kv_state(self) -> Optional[BlockPool]:
        """A zeroed cache (pool or dense) and :meth:`_fresh_tables`."""
        store = (None if self.kv_prec.requested == "auto"
                 else dtype_of(self.kv_prec.store_dtype))
        if self.paged:
            self.cache = self.model.init_cache(
                self.slots, self.max_seq, paged=True,
                num_blocks=self.num_blocks, block_size=self.block_size,
                dtype=store,
                scale_dtype=(dtype_of(self.kv_prec.scale_dtype)
                             if self.kv_prec.quantized else None))
        else:
            self.cache = self.model.init_cache(self.slots, self.max_seq,
                                               dtype=store)
        return self._fresh_tables()

    def _fresh_tables(self) -> Optional[BlockPool]:
        """Fresh block tables and — paged — a fresh :class:`BlockPool`."""
        if not self.paged:
            self.block_tables = None
            return None
        self.block_tables = np.zeros((self.slots, self.table_len), np.int32)
        return BlockPool(self.num_blocks, self.block_size)

    def reset(self) -> List[Request]:
        """Drain this ring: drop every KV block, table and scheduling
        structure and rebuild them empty — the rebuild half of a ring
        drain/rebuild cycle.  Returns the orphaned in-flight requests
        (active sequences in admission order, then the queue) for the
        fleet to migrate through the recompute-resume path.

        The reference builds a fresh zeroed cache; here every cache
        tensor is zeroed in place instead, because each captured program
        holds the addresses of the cache, its static buffers and its
        outputs.  The zeroing is enqueued on the current stream, after a
        window still in flight (a pipelined window whose handle the fault
        dropped), and it clears a NaN block before a later sequence
        reuses it.  Every program is kept; the host side (pool, prefix
        index, scheduler, block tables) is rebuilt, and every static
        buffer's mirror is dropped: a dropped window left a device carry
        the mirror does not know.  Finished results, stats and the
        injector's fired set survive."""
        orphans = self.sched.in_flight()
        for name in self._ctr_base:
            self._ctr_base[name] = getattr(self.stats, name)
        for c in self.cache.values():
            for t in c.values():
                t.zero_()
        pool = self._fresh_tables()
        self.prefix = PrefixCache(pool) if self.prefix is not None else None
        self.sched = Scheduler(self.slots, self.max_seq, pool,
                               self.config.min_bucket, prefix=self.prefix)
        self._chunk_rr = -1
        self._stalled = False
        self._poison_next = False
        self._free_after_admit = 0
        self._drop_mirrors()
        return orphans

    def check_pool_balanced(self) -> None:
        """Raise unless every pool block's refcount balances to zero."""
        if self.sched.pool is not None:
            assert_pool_balanced(self.sched.pool, self.prefix)

    # -- chaos injection -----------------------------------------------

    def _chaos_tick(self) -> None:
        """Fire this step's chaos events (each once): ``ring`` raises
        :class:`RingFailure`, ``stall`` wedges the engine until the
        fleet's heartbeat timeout drains it, ``nan`` poisons the next
        decode window's logits on the device and ``corrupt`` a resident
        pool block; the finite-logits guard then detects both."""
        if self.injector is None:
            return
        for ev in self.injector.fire(self._step_no, self.ring_id):
            self.events.append(Event("chaos", self._step_no,
                                     {"kind": ev.kind,
                                      "ring": self.ring_id}))
            if ev.kind == "ring":
                raise RingFailure("injected_ring_failure", self._step_no,
                                  self.ring_id)
            if ev.kind == "stall":
                self._stalled = True
            elif ev.kind == "nan":
                self._poison_next = True
            elif ev.kind == "corrupt":
                self._corrupt_pool_block()

    def _corrupt_pool_block(self) -> None:
        """Set the first decode-ready sequence's first resident block to
        NaN, in place, in every floating cache tensor: K/V of an fp pool,
        the scales of an int8 pool, codes and scales of an fp8 pool.  The
        next decode's logits then go non-finite as under a real memory
        fault, through the paged kernel."""
        blk = None
        for seq in self.sched.active:
            if seq is not None and not seq.prefilling and seq.blocks:
                blk = seq.blocks[0]
                break
        if blk is None:
            return                   # nothing resident: the fault hits air
        for c in self.cache.values():
            for t in c.values():
                if t.is_floating_point():
                    t[:, blk] = float("nan")

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _drop_mirrors(self) -> None:
        """Forget what every static buffer's host mirror says the device
        holds, so the next dispatch uploads."""
        for buf in (self._win, self._tables, *self._ver.values(),
                    *self._bufs.values()):
            if buf is not None:
                buf.mirror = None

    # -- device steps --------------------------------------------------

    def _decode_fn(self, tokens: torch.Tensor, positions: torch.Tensor,
                   tables: Optional[torch.Tensor]) -> torch.Tensor:
        """One decode forward for the whole slot batch; the cache is
        updated in place.  Returns the (slots, V_pad) logits rows.  The
        caller counts it in ``device_decode_steps`` (a captured window
        runs it only at capture)."""
        logits, _ = self.model.forward(
            self.params, tokens, mode="decode", positions=positions,
            cache=self.cache, block_tables=tables,
            paged_kernel=self.paged_kernel or "gather",
            block_s=self.block_s, env=self.env)
        return logits[:, -1]

    def _window_fn(self, S: int, stochastic: bool) -> None:
        """``S`` decode steps with sampling and the finish rules applied
        on the device, reading the block tables, the carry ``(last, pos,
        n_out, alive)`` and the sampling arrays from the static buffers:
        no host sync and no host-made tensor inside, so it captures as
        one graph.  A slot that hits eos / its token budget / max_seq
        drops out of ``alive`` and is frozen: its (last, pos) stop
        advancing, so later steps rewrite the same KV row with the same
        value.  The chaos flag ``poison`` marks every row as not finite
        (the guard then refuses the whole window before any of its tokens
        commits) and is consumed (zeroed) by the window that reads it.
        On the ring each rank checks its vocab columns and the verdict is
        agreed by a ``psum`` (one poisoned rank refuses the window on
        every rank), and the tokens are drawn from the all-gathered
        candidates, the same on every rank.
        Writes the (S, slots) token matrix into ``_tok_out[S]``, whether
        each row was finite into ``_ok_out[S]`` (the NaN guard's input),
        and the carry back into its buffers."""
        w = self._win.view
        tables = self._tables.view["tables"] if self.paged else None
        eos = -1 if self.eos_id is None else self.eos_id
        last, pos, n_out = w["last"], w["pos"], w["n_out"]
        alive = w["alive"] != 0
        poison = w["poison"] != 0
        toks_all, oks_all = [], []
        for _ in range(S):
            row = self._decode_fn(last[:, None], pos, tables)
            ok = torch.isfinite(row).all(-1) & ~poison
            if self.tp > 1:
                ok = ring_dist.psum(ok.to(torch.int32), self.ring) == self.tp
            oks_all.append(ok)
            toks = sample_sharded_batched(
                row, self.gen, w["temps"], w["top_ks"], w["top_ps"],
                stochastic, self.ring, self.tp)
            live = alive.to(torch.int32)
            n_out = n_out + live
            pos = pos + live
            fin = (n_out >= w["max_new"]) | (toks == eos) | \
                (pos >= self.max_seq - 1)
            last = torch.where(alive, toks, last)
            alive = alive & ~fin
            toks_all.append(toks)
        torch.stack(toks_all, out=self._tok_out[S])
        torch.stack(oks_all, out=self._ok_out[S])
        for name, t in (("last", last), ("pos", pos), ("n_out", n_out),
                        ("alive", alive)):
            w[name].copy_(t)
        w["poison"].zero_()

    def _carry_after(self, toks: np.ndarray) -> None:
        """Replay on the host mirror of the window's state buffer what a
        window that sampled ``toks`` (S, slots) did to its carry, so the
        mirror stays what the device holds (the same rules as
        :meth:`_window_fn`)."""
        if self._win.mirror is None:
            return
        m = self._win.fields(self._win.mirror)
        eos = -1 if self.eos_id is None else self.eos_id
        for row in toks:
            live = m["alive"] != 0
            m["n_out"] += live
            m["pos"] += live
            fin = (m["n_out"] >= m["max_new"]) | (row == eos) | \
                (m["pos"] >= self.max_seq - 1)
            m["last"][...] = np.where(live, row, m["last"])
            m["alive"][...] = live & ~fin
        m["poison"][...] = 0

    @contextlib.contextmanager
    def _held(self, dead: Callable[[], None]):
        """Guard of a program's warm-up and capture: ``dead()`` uploads
        inputs that leave every slot dead (the warm-up's K/V writes land
        in the null block); a dense or recurrent cache, which the
        forward rewrites for every slot, dead or alive, is saved and
        restored, and so is the generator's state; every static buffer's
        mirror is dropped, so the next dispatch uploads."""
        dead()
        gen = self.gen.get_state()
        saved = None if self.paged else [
            (t, t.clone()) for c in self.cache.values() for t in c.values()]
        try:
            yield
        finally:
            for t, copy in saved or ():
                t.copy_(copy)
            self.gen.set_state(gen)
            self._drop_mirrors()

    def _program(self, key, fn: Callable[[], None], stochastic: bool,
                 dead: Callable[[], None],
                 programs: Optional[Programs] = None):
        """The captured program of ``key`` in ``programs`` (the windows'
        by default; None for the eager twin)."""
        if not self.graphs:
            return None
        return (programs or self._programs).get(
            key, fn, generator=self.gen if stochastic else None,
            held=lambda: self._held(dead))

    def _run_static(self, key: tuple, fields, body: Callable,
                    inputs: Dict, dead: Dict, stochastic: bool = False
                    ) -> None:
        """Upload ``inputs`` into the static buffer of ``key`` (``fields``,
        made at first use) and run ``body(buffer views)`` as the program
        of ``key`` in ``_admit`` (captured on first use after a warm-up
        on ``dead``)."""
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = StagedBuffer(fields, self.device)
        fn = lambda: body(buf.view)                          # noqa: E731
        prog = self._program(key, fn, stochastic,
                             lambda: buf.upload(buf.pack(dead)), self._admit)
        buf.upload(buf.pack(inputs))
        self._admit.run(prog, fn)

    def _prefill_fn(self, S: int, v: Dict[str, torch.Tensor]) -> None:
        """Batch-1 prefill of a prompt padded to ``S`` (``v["tokens"]``
        (1, S), its length ``v["true_len"]`` (1,)) into a scratch bucket
        cache, scattered into the pool through ``v["table"]`` (S // bs,)
        or into the dense cache's slot ``v["slot"]`` (1,); the last valid
        token's logits row goes to the sampler's static row.  Under
        capture the scratch cache comes from the graphs' pool and is not
        held between replays."""
        cache = self.model.init_cache(1, S)
        positions = torch.arange(S, device=self.device)[None]
        logits, cache = self.model.forward(
            self.params, v["tokens"], mode="prefill", cache=cache,
            positions=positions, env=self.env)
        self._row.copy_(logits[0].index_select(0, v["true_len"] - 1)[0])
        if self.paged:
            scatter_prefill_pages(self.cache, cache, v["table"])
        else:
            scatter_prefill_dense(self.cache, cache, v["slot"])

    def _chunk_fn(self, C: int, v: Dict[str, torch.Tensor]) -> None:
        """ONE prefill chunk of C rows straight against the pool: the
        ``v["n_valid"]`` tokens of ``v["tokens"]`` (1, C) at positions
        ``v["start"] + i``, their K/V scattered through the request's
        table ``v["table"]`` (T,) and their queries attending the
        resident history plus the chunk's causal prefix (see
        :func:`repro_torch.models.attention.chunk_prefill_attention`).
        The logits row of the chunk's last valid token goes to the
        sampler's static row (read after the final chunk only)."""
        start, n_valid = v["start"], v["n_valid"]
        positions = (start + torch.arange(C, dtype=torch.int32,
                                          device=self.device))[None]
        logits, _ = self.model.forward(
            self.params, v["tokens"], mode="chunk_prefill",
            positions=positions, cache=self.cache,
            block_tables=v["table"][None],
            paged_kernel=self.paged_kernel or "gather",
            kv_valid_len=(start + n_valid).reshape(()), env=self.env)
        self._row.copy_(logits[0].index_select(0, n_valid - 1)[0])

    def _run_chunk(self, seq: SeqSlot, tokens: List[int], start: int,
                   n_valid: int, C: int) -> None:
        """Run the chunk program of C on ``tokens[start:start +
        n_valid]`` of ``seq`` (a prefill chunk, or a prefix hit's tail)."""
        buf = np.zeros((1, C), np.int32)
        buf[0, :n_valid] = tokens[start:start + n_valid]
        table = np.zeros((self.table_len,), np.int32)
        table[:len(seq.blocks)] = seq.blocks
        # dead inputs: one valid row at position 0 and a zero table, so
        # every K/V row lands in the null block and no query of kernel 1
        # has length 0
        self._run_static(
            ("chunk", C),
            [("tokens", (1, C), "i32"), ("start", (1,), "i32"),
             ("n_valid", (1,), "i32"), ("table", (self.table_len,), "i32")],
            lambda v: self._chunk_fn(C, v),
            dict(tokens=buf, start=start, n_valid=n_valid, table=table),
            dict(tokens=0, start=0, n_valid=1, table=0))
        self._buckets_traced.add(("chunk", C))
        self.stats.prefills += 1

    def _verify_fwd(self, tokens: torch.Tensor, positions: torch.Tensor,
                    tables: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        """ONE speculative verify forward: every slot's (last token + K
        drafts) as a (1, slots*(K+1)) batch of single-token queries with
        per-query (Q, T) tables and (Q,) spans ``pos + 1`` (see
        :func:`repro_torch.models.attention.verify_attention`).  The
        drafts' K/V land in the pool in place; rows past the accepted
        prefix stay there, masked by length and overwritten by the next
        round.  Returns the (Q, V_pad) logits, on the ring the rank's
        (Q, V_pad/tp) columns."""
        logits, _ = self.model.forward(
            self.params, tokens, mode="verify", positions=positions,
            cache=self.cache, block_tables=tables,
            paged_kernel=self.paged_kernel or "gather", kv_valid_len=lens,
            env=self.env)
        return logits[0]

    # -- sampling ------------------------------------------------------

    def _sample(self, logits_np: np.ndarray, row: torch.Tensor,
                params: SamplingParams) -> int:
        """Host-path sampling of one row already copied to the host."""
        if params.temperature <= 0.0:
            return int(np.argmax(logits_np))
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += 4
        return int(sample_local(row[None], self.gen, params)[0])

    def _sample_fn(self, stochastic: bool,
                   v: Dict[str, torch.Tensor]) -> None:
        """The fused first-token sampler: the static prefill row sampled
        with ``v``'s (temp, top_k, top_p), its token into ``_first``."""
        self._first.copy_(sample_sharded_batched(
            self._row[None], self.gen, v["temp"], v["top_k"], v["top_p"],
            stochastic, self.ring, self.tp))

    def _sample_first(self, params: SamplingParams) -> int:
        """Sample the prefill row per the engine's sampling mode (fused:
        the sampler's program, keyed by ``stochastic``; only the token id
        crosses to the host)."""
        row = self._row
        if self.sampling == "fused":
            stochastic = params.temperature > 0.0
            self._run_static(
                ("sample", stochastic),
                [("temp", (1,), "f32"), ("top_k", (1,), "i32"),
                 ("top_p", (1,), "f32")],
                lambda v: self._sample_fn(stochastic, v),
                dict(temp=params.temperature, top_k=params.top_k,
                     top_p=params.top_p),
                dict(temp=0.0, top_k=0, top_p=1.0), stochastic=stochastic)
            self.stats.host_syncs += 1
            self.stats.prefill_syncs += 1
            self.stats.bytes_to_host += 4
            return int(self._first.cpu()[0])
        row = self._full_row(row)
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
        table the decode steps read.  Empty and still-prefilling slots
        stay all-zero: their don't-care writes land in the null block,
        so a window never touches a partly resident prompt.  A fresh
        array every time, never an in-place rewrite: the host decode
        step hands it to ``torch.from_numpy``, which shares its memory
        on the CPU."""
        if not self.paged:
            return
        tables = np.zeros((self.slots, self.table_len), np.int32)
        for slot, seq in enumerate(self.sched.active):
            if seq is not None and seq.blocks and not seq.prefilling:
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
        cache is copied into the pool (or the slot's dense region).  A
        prefix hit prefills only its tail (:meth:`_prefill_tail`).  A
        prefill that runs while other decode streams are in flight froze
        them: ``decode_stalls`` counts it.  Returns the request if it
        finished immediately."""
        tokens = seq.req.resume_tokens()
        if self.sched.num_decoding() > 1:       # streams besides seq
            self.stats.decode_stalls += 1
        if seq.cached:
            return self._prefill_tail(seq, tokens)
        n = len(tokens)
        slot = self.sched.slot_of(seq)
        if self.bucketed:
            bucket = self.sched.bucket(n)
            buf = np.zeros((1, bucket), np.int32)
            buf[0, :n] = tokens
            fields = [("tokens", (1, bucket), "i32"),
                      ("true_len", (1,), "i32")]
            inputs = dict(tokens=buf, true_len=n)
            dead = dict(tokens=0, true_len=1)
            if self.paged:
                nb = bucket // self.block_size
                table = np.zeros((nb,), np.int32)
                table[:len(seq.blocks)] = seq.blocks
                fields.append(("table", (nb,), "i32"))
                inputs.update(table=table)
                dead.update(table=0)
            else:
                fields.append(("slot", (1,), "i32"))
                inputs.update(slot=slot)
                dead.update(slot=0)
            self._run_static(("prefill", bucket), fields,
                             lambda v: self._prefill_fn(bucket, v), inputs,
                             dead)
        else:
            # a recurrent stack prefills at the exact length (padding
            # would fold into its state), eagerly: a program per length
            # would capture again for every new prompt length
            bucket = n
            self._prefill_fn(n, dict(
                tokens=self._to_dev(np.asarray([tokens], np.int32)),
                true_len=self._to_dev(np.asarray([n], np.int32)),
                slot=self._to_dev(np.asarray([slot], np.int32))))
        self._buckets_traced.add(bucket)
        self.stats.prefills += 1
        return self._finish_prefill(seq)

    def _prefill_tail(self, seq: SeqSlot, tokens: List[int]
                      ) -> Optional[Request]:
        """Prefill only the un-cached tail of a prefix hit, through the
        chunk program padded to a pow2 bucket; a shared block the tail
        writes into (a hit capped mid-block) is copied on write first."""
        n, start = len(tokens), seq.cached
        self._ensure_writable(seq, start, n)
        self._run_chunk(seq, tokens, start, n - start,
                        self.sched.bucket(n - start))
        return self._finish_prefill(seq)

    def _ensure_writable(self, seq: SeqSlot, lo: int, hi: int,
                         allow_preempt: bool = True) -> bool:
        """Copy-on-write guard: before K/V for positions ``[lo, hi)`` of
        ``seq`` is scattered, each block of that span referenced by more
        than one table is copied into a fresh block (on the current
        stream, so in order with every window and chunk), the fresh
        block swapped into ``seq``'s table and the original released.
        Returns False when a fresh block cannot be had without
        preemption and ``allow_preempt`` is False (the chunk path
        retries next step).  Sole-owner blocks are written in place:
        hits are capped at ``n - 1``, so such a write re-stores the same
        token's K/V."""
        if self.sched.pool is None or hi <= lo:
            return True
        bs = self.block_size
        for li in range(lo // bs, (hi - 1) // bs + 1):
            if li >= len(seq.blocks):
                break
            old = seq.blocks[li]
            if self.sched.pool.ref[old] <= 1:
                continue
            new = self.sched.cow_alloc(seq, allow_preempt)
            if new is None:
                return False
            self._run_static(
                ("cow",), [("pair", (2,), "i32")],
                lambda v: copy_pool_block(self.cache, v["pair"][:1],
                                          v["pair"][1:]),
                dict(pair=[old, new]), dict(pair=0))
            seq.blocks[li] = new
            self.sched.pool.free([old])
            self.stats.cow_blocks += 1
        return True

    def _cow_pending(self, seq: SeqSlot, lo: int, hi: int) -> bool:
        """True while a block of the span is still shared (the guard has
        not run, or could not finish)."""
        pool = self.sched.pool
        if pool is None or hi <= lo:
            return False
        bs = self.block_size
        top = min((hi - 1) // bs + 1, len(seq.blocks))
        return any(pool.ref[seq.blocks[li]] > 1
                   for li in range(lo // bs, top))

    def _finish_prefill(self, seq: SeqSlot) -> Optional[Request]:
        """Shared tail of every prefill path once the prompt is resident:
        register it in the prefix index, then restore the last sampled
        token (preemption resume) or sample the first one from the
        prefill row, and apply the finish rules."""
        req = seq.req
        if self.prefix is not None:
            self.prefix.register(req.resume_tokens(), seq.blocks)
        if seq.resumed:
            seq.last_token = req.out[-1]
            return None
        tok = self._sample_first(req.params)
        req.out.append(tok)
        seq.last_token = tok
        if req.stream_cb:
            req.stream_cb(req.rid, tok)
        if self._should_finish(seq, tok):
            return self._finish(seq)
        return None

    def _run_prefill_chunk(self, seq: SeqSlot) -> Optional[Request]:
        """Make the next ``prefill_chunk`` prompt tokens of ``seq``
        resident; on the final chunk hand off to :meth:`_finish_prefill`.
        The caller has reserved the chunk's blocks and run the
        copy-on-write guard.  Returns the request if it finished."""
        tokens = seq.req.resume_tokens()
        C = self.prefill_chunk
        start = seq.prefilled
        n_valid = min(C, len(tokens) - start)
        if self._cow_pending(seq, start, start + n_valid):
            raise RuntimeError("chunk scatter into a shared block")
        self._run_chunk(seq, tokens, start, n_valid, C)
        seq.prefilled = seq.pos = start + n_valid
        self.stats.prefill_chunks += 1
        if seq.prefilling:
            return None              # more chunks next step
        return self._finish_prefill(seq)

    def _admit_and_chunk(self) -> List[Request]:
        """Chunked-mode admission: admit while slots and first-chunk
        blocks allow, then run ONE prefill chunk — the step's prefill
        budget — for one prefilling sequence, round-robin by admission
        order from the last one served, so a long prompt cannot hold a
        short one's first token hostage.  The decode window dispatched
        later in the same step is what keeps the streams moving."""
        finished: List[Request] = []
        while self.sched.admit_next(chunk=self.prefill_chunk) is not None:
            pass
        cands = self.sched.prefilling()
        i = next((j for j, s in enumerate(cands)
                  if s.admit_seq > self._chunk_rr), 0)
        for seq in cands[i:] + cands[:i]:
            # preempt only when no decode stream could free blocks
            allow_preempt = self.sched.num_decoding() == 0
            if not self.sched.chunk_reserve(seq, self.prefill_chunk,
                                            allow_preempt=allow_preempt):
                continue             # pool pressure: try the next seq
            nxt = min(seq.prefilled + self.prefill_chunk,
                      seq.prefill_target)
            if not self._ensure_writable(seq, seq.prefilled, nxt,
                                         allow_preempt=allow_preempt):
                continue             # no block for the copy: next seq
            self._chunk_rr = seq.admit_seq
            done = self._run_prefill_chunk(seq)
            if done is not None:
                finished.append(done)
            break                    # ONE chunk per step
        return finished

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
        self.check_prompt(req.prompt)
        self._rid = max(self._rid, req.rid) + 1
        self.sched.submit(req)
        return req.rid

    def check_prompt(self, prompt: Sequence[int]) -> None:
        """Raise ``ValueError`` for a prompt this engine can never serve:
        empty, with no room to decode, or needing more blocks than the
        pool has."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_seq:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_seq "
                f"{self.max_seq}: no room to decode")
        self.sched.check_fits(prompt)

    def cancel(self, rid: int) -> Optional[Request]:
        """Abort one request between steps: pop it from the queue, or
        release its slot and blocks (a shared prefix block just drops a
        reference).  The partial stream is kept in the results.  Returns
        the request, or None when ``rid`` is not in flight here.  Safe
        on the host alone: ``step()`` reads back every window it
        dispatched before it returns, so no program still writes into
        the freed blocks."""
        req = None
        for r in self.sched.queue:
            if r.rid == rid:
                self.sched.queue.remove(r)
                req = r
                break
        else:
            for seq in self.sched.active:
                if seq is not None and seq.req.rid == rid:
                    self.sched.release(seq)
                    req = seq.req
                    break
        if req is None:
            return None
        req.done = True
        req.cancelled = True
        self._results[rid] = req.out
        self.stats.cancelled_requests += 1
        self.events.append(Event("request_cancelled", self._step_no,
                                 {"rid": rid, "tokens": len(req.out)}))
        return req

    def has_work(self) -> bool:
        """True while the queue or any slot holds an unfinished request
        (the signal :meth:`drain` loops on; the async front end's pump
        idles on it)."""
        return self.sched.has_work()

    def set_step_knobs(self, prefill_chunk: Optional[int] = None,
                       steps_per_sync: Optional[int] = None) -> None:
        """Retune the per-step latency knobs between steps: the seam the
        SLO budget scheduler (:mod:`repro_torch.serving.budget`) drives.

        A new ``steps_per_sync`` costs one window program (on the card a
        capture, on the first window of that length) and its output
        buffer; a new chunk width one chunk program (the budget
        scheduler quantizes widths to powers of two to bound them).  The
        checks are the constructor's; besides, a chunked engine never
        drops back to ``prefill_chunk=0``: a sequence in the middle of
        its prefill would starve (only chunked admission feeds it), and
        a monolithic prefill cannot resume a half-resident prompt."""
        c, s = checked_knobs(self, prefill_chunk, steps_per_sync)
        if s is not None:
            self.steps_per_sync = s
        if c is not None:
            self.prefill_chunk = c

    def step(self) -> List[Request]:
        """One scheduler round: admit + prefill, then one decode round
        for the whole slot batch.  Returns requests finished this round.
        A ring-level fault raises :class:`RingFailure` (the fleet
        recovers it)."""
        t0 = time.perf_counter()
        try:
            return self._step()
        finally:
            self.stats.wall += time.perf_counter() - t0
            self.stats.graph_captures = (self._programs.captures
                                         + self._admit.captures)
            self.stats.graph_replays = (self._programs.replays
                                        + self._admit.replays)

    def _step(self) -> List[Request]:
        self._step_no += 1
        self._chaos_tick()
        if self._stalled:
            # injected stall: no progress this step or any later one; the
            # fleet's heartbeat tracker notices and drains the ring
            return []
        finished: List[Request] = []
        if self.prefill_chunk:
            finished += self._admit_and_chunk()
        else:
            while True:
                seq = self.sched.admit_next()
                if seq is None:
                    break
                done = self._do_prefill(seq)
                if done is not None:
                    finished.append(done)
        # what an admission pass later in this round may still fill
        self._free_after_admit = sum(s is None for s in self.sched.active)
        finished += self._harvest_rejections()
        self.sched.ensure_decode_capacity()     # may preempt (recompute)
        self._sched_stats()
        if self.sched.num_decoding() == 0:
            return finished
        finished += self._decode_round()
        self.stats.prefill_traces = len(self._buckets_traced)
        return finished

    def admission_pass(self) -> List[Request]:
        """The rest of this round's :meth:`step` for requests submitted
        after it ran (a mesh fleet's orphans, migrated here from an
        earlier ring in the same round): admit them into the slots the
        step's admission left free, then one decode round of theirs
        alone, every other slot frozen out of it as a prefilling slot
        is.  The reference's rings step one after another, so there this
        ring's one step of the round admits and decodes the orphans
        beside its own requests; the pass gives them the same tokens in
        the same round, at the cost of a decode round of its own.  No
        step number and no chaos tick: the round's step already took
        them.  Returns the requests finished."""
        t0 = time.perf_counter()
        try:
            return self._admission_pass()
        finally:
            self.stats.wall += time.perf_counter() - t0
            self.stats.graph_captures = (self._programs.captures
                                         + self._admit.captures)
            self.stats.graph_replays = (self._programs.replays
                                        + self._admit.replays)

    def _admission_pass(self) -> List[Request]:
        if self._stalled:
            return []
        old = [s for s in self.sched.active if s is not None]
        finished: List[Request] = []
        if self.prefill_chunk:
            finished += self._admit_and_chunk()
        else:
            for _ in range(self._free_after_admit):
                seq = self.sched.admit_next()
                if seq is None:
                    break
                done = self._do_prefill(seq)
                if done is not None:
                    finished.append(done)
        self._free_after_admit = sum(s is None for s in self.sched.active)
        finished += self._harvest_rejections()
        self.sched.ensure_decode_capacity()     # may preempt (recompute)
        self._sched_stats()
        frozen = [s for s in old
                  if s in self.sched.active and not s.prefilling]
        for s in frozen:
            s.frozen = True
        try:
            if self.sched.num_decoding():
                finished += self._decode_round()
        finally:
            for s in frozen:
                s.frozen = False
        self.stats.prefill_traces = len(self._buckets_traced)
        return finished

    def _decode_round(self) -> List[Request]:
        """One decode round of the decode-ready slots, in the engine's
        mode: a speculative round, fused windows or the host-sampled
        step."""
        if self.drafter is not None:
            return self._spec_decode_round()
        if self.sampling == "fused":
            return self._fused_decode_round()
        return self._host_decode_step()

    def _sched_stats(self) -> None:
        """The scheduler's, pool's and prefix index's counters onto
        ``stats``."""
        st, base = self.stats, self._ctr_base
        st.preemptions = base["preemptions"] + self.sched.preemptions
        if self.sched.pool is not None:
            st.peak_pool_blocks = max(st.peak_pool_blocks,
                                      self.sched.pool.num_used)
            st.evicted_blocks = base["evicted_blocks"] \
                + self.sched.pool.evicted_blocks
        if self.prefix is not None:
            st.prefix_lookups = base["prefix_lookups"] + self.prefix.lookups
            st.prefix_hits = base["prefix_hits"] + self.prefix.hits
            st.prefix_hit_blocks = base["prefix_hit_blocks"] \
                + self.prefix.hit_blocks
            st.prefill_tokens_saved = base["prefill_tokens_saved"] \
                + self.prefix.tokens_saved

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
            self.events.append(Event("request_rejected", self._step_no,
                                     {"rid": req.rid, "why": why}))
            finished.append(req)
        return finished

    # -- host-sampled decode (the parity oracle) -----------------------

    def _host_decode_fn(self, v: Dict[str, torch.Tensor]) -> None:
        """The host-sampled decode forward on its static buffers: the
        (slots, V_pad) logits rows into ``_host_logits``."""
        self._host_logits.copy_(self._full_row(self._decode_fn(
            v["tokens"], v["pos"], v["tables"] if self.paged else None)))

    def _host_decode_step(self) -> List[Request]:
        """One decode step (its program keyed ``("host_decode",)``) whose
        full (slots, vocab) logits cross to the host, sampled there slot
        by slot."""
        self._refresh_tables()
        B = self.slots
        toks = np.zeros((B, 1), np.int32)
        pos = np.zeros((B,), np.int32)
        for slot, seq in enumerate(self.sched.active):
            if seq is not None and not seq.prefilling:
                toks[slot, 0] = seq.last_token
                pos[slot] = seq.pos
        if self._host_logits is None:
            self._host_logits = torch.zeros(
                (B, self._row.shape[0] * self.tp), dtype=self._row.dtype,
                device=self.device)
        fields = [("tokens", (B, 1), "i32"), ("pos", (B,), "i32")]
        inputs = dict(tokens=toks, pos=pos)
        if self.paged:
            fields.append(("tables", (B, self.table_len), "i32"))
            inputs.update(tables=self.block_tables)
        self._run_static(("host_decode",), fields, self._host_decode_fn,
                         inputs, dict(tokens=0, pos=0, tables=0))
        logits = self._host_logits
        self.stats.device_decode_steps += 1
        logits_np = logits.cpu().numpy()
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += logits_np.nbytes
        if self._poison_next:
            # chaos "nan": poison the host copy, so the guard below trips
            self._poison_next = False
            logits_np = np.full_like(logits_np, np.nan)
        act = [slot for slot, seq in enumerate(self.sched.active)
               if seq is not None and not seq.prefilling]
        bad = [slot for slot in act if not np.isfinite(logits_np[slot]).all()]
        if bad:
            raise RingFailure("nan_logits", self._step_no, self.ring_id,
                              {"slots": bad})
        finished: List[Request] = []
        self.stats.steps += 1
        self.stats.slot_steps += self.slots
        for slot, seq in enumerate(self.sched.active):
            if seq is None or seq.prefilling:
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

    def _slot_arrays(self) -> Tuple[tuple, tuple, bool]:
        """Host slot state -> the window's carry ``(last, pos, n_out,
        alive)``, the per-slot sampling arrays ``(temps, top_ks, top_ps,
        max_new)`` and whether any alive slot samples.  Only
        decode-ready slots are ``alive``; empty and prefilling slots stay
        dead zeros, frozen by the window."""
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
            if seq is None or seq.prefilling:
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
        return ((last, pos, n_out, alive), (temps, top_ks, top_ps, max_new),
                stochastic)

    def _admission_waiting(self) -> bool:
        """A queued request AND a free slot: windows shrink to one step so
        admission latency stays at the single-step baseline's."""
        return bool(self.sched.queue) and \
            any(s is None for s in self.sched.active)

    def _may_survive(self, steps: int) -> bool:
        """Could any decode-ready slot still be alive after ``steps``
        more tokens?  (Budget/length check only.)"""
        for seq in self.sched.active:
            if seq is None or seq.prefilling:
                continue
            if (seq.req.max_new_tokens - len(seq.req.out)) > steps and \
                    (self.max_seq - 1 - seq.pos) > steps:
                return True
        return False

    def _window_state(self, state: Optional[tuple],
                      poison: bool = False) -> np.ndarray:
        """The packed state buffer of ``state`` = ``(carry, samp)`` from
        :meth:`_slot_arrays`, or of a batch with every slot dead, with
        the chaos flag ``poison``."""
        if state is None:
            B = self.slots
            z = np.zeros((B,), np.int32)
            state = ((z, z, z, z), (np.zeros((B,), np.float32), z,
                                    np.ones((B,), np.float32), z))
        (last, pos, n_out, alive), (temps, top_ks, top_ps, max_new) = state
        return self._win.pack(dict(
            last=last, pos=pos, n_out=n_out, alive=alive, temps=temps,
            top_ks=top_ks, top_ps=top_ps, max_new=max_new,
            poison=int(poison)))

    def _dead_window(self) -> None:
        self._win.upload(self._window_state(None))
        if self.paged:
            self._tables.upload(np.zeros_like(self.block_tables))

    def _dispatch_window(self, win: int, stochastic: bool,
                         state: Optional[tuple]):
        """Enqueue one window (the device runs it asynchronously): its
        program (captured on first use), then the uploads of what
        changed — the block tables, and ``state`` (``(carry, samp)``;
        None continues off the device carry of the window before) — then
        the replay.  A pending chaos ``nan`` rides in the uploaded state
        as the poison flag (a window chained off the device carry never
        has one pending: the window before consumed it).  The output
        (tokens and finite-row flags) is cloned at once: the next replay
        rewrites ``_win_out``.  Returns (win, output bytes, active
        snapshot)."""
        out = self._window_out(win)
        fn = lambda: self._window_fn(win, stochastic)       # noqa: E731
        prog = self._program(("window", win, stochastic), fn, stochastic,
                             self._dead_window)
        if self.paged:
            self._tables.upload(self.block_tables)
        if state is not None:
            self._win.upload(self._window_state(state, self._poison_next))
            self._poison_next = False
        self._programs.run(prog, fn)
        self.stats.device_decode_steps += win
        snapshot = [s is not None and not s.prefilling
                    for s in self.sched.active]
        return win, out.clone(), snapshot

    def _reconcile(self, handle) -> List[Request]:
        """Read a window's tokens and finite-row flags back (the ONE
        device->host sync per window) and replay the finish rules the
        device applied: tokens of slots that finished earlier are overrun
        and dropped.  The NaN guard runs per window step before that
        step's tokens commit: the first step whose sampled-from row was
        non-finite for a dispatched slot raises :class:`RingFailure`, so
        no token at or after the fault reaches a request."""
        win, out, dispatch_active = handle
        host = out.cpu().numpy()
        n = win * self.slots
        toks = host[:4 * n].view(np.int32).reshape(win, self.slots)
        oks = host[4 * n:].view(np.bool_).reshape(win, self.slots)
        self.stats.host_syncs += 1
        self.stats.bytes_to_host += toks.nbytes + oks.nbytes
        self._carry_after(toks)
        finished: List[Request] = []
        for s in range(win):
            bad = [slot for slot in range(self.slots)
                   if dispatch_active[slot] and not oks[s, slot]]
            if bad:
                raise RingFailure("nan_logits", self._step_no, self.ring_id,
                                  {"window_step": s, "slots": bad})
            if self.sched.num_decoding() == 0:
                self.stats.overrun_tokens += \
                    (win - s) * sum(dispatch_active)
                break
            self.stats.steps += 1
            self.stats.slot_steps += self.slots
            for slot, seq in enumerate(self.sched.active):
                if seq is None or seq.prefilling:
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
        carry, samp, stochastic = self._slot_arrays()
        h1 = self._dispatch_window(win, stochastic, (carry, samp))
        h2 = None
        if self.pipeline and not self.sched.queue \
                and self._may_survive(win) \
                and self.sched.reserve_lookahead(2 * win):
            self._refresh_tables()
            h2 = self._dispatch_window(win, stochastic, None)
        finished = self._reconcile(h1)
        if h2 is not None:
            finished += self._reconcile(h2)
        return finished

    def _verify_fn(self, K: int, stochastic: bool) -> None:
        """The fused verify round for draft length ``K`` on its static
        buffers: the verify forward, then the rejection sampling of
        every slot (on the ring from each row's all-gathered candidates,
        the same on every rank); writes ``out`` (B, K+1) and ``n_acc``
        (B,) side by side into ``_ver_out[K]``."""
        v, B, K1 = self._ver[K].view, self.slots, K + 1
        rows = self._verify_fwd(v["tokens"], v["positions"], v["tables"],
                                v["lens"]).reshape(B, K1, -1)
        out, n_acc = speculative_verify_sharded(
            rows, v["draft"], self.gen, v["temps"], v["top_ks"],
            v["top_ps"], stochastic, self.ring, self.tp)
        self._ver_out[K][:, :K1].copy_(out)
        self._ver_out[K][:, K1].copy_(n_acc)

    def _verify_round(self, K: int, stochastic: bool,
                      inputs: Dict[str, np.ndarray]) -> np.ndarray:
        """Upload one round's ``inputs`` and run the verify program of
        ``(K, stochastic)`` (captured on first use).  Returns the (B,
        K+2) host array of ``out`` and ``n_acc``: the round's one host
        read."""
        B, K1, T = self.slots, K + 1, self.table_len
        Q = B * K1
        buf = self._ver.get(K)
        if buf is None:
            buf = self._ver[K] = StagedBuffer(
                [("tokens", (1, Q), "i32"), ("positions", (1, Q), "i32"),
                 ("lens", (Q,), "i32"), ("tables", (Q, T), "i32"),
                 ("draft", (B, K), "i32"), ("top_ks", (B,), "i32"),
                 ("temps", (B,), "f32"), ("top_ps", (B,), "f32")],
                self.device)
            self._ver_out[K] = torch.zeros((B, K1 + 1), dtype=torch.int32,
                                           device=self.device)
        ones = np.ones((B,), np.float32)

        def dead():
            buf.upload(buf.pack(dict(
                tokens=0, positions=0, lens=0, tables=0, draft=0, top_ks=0,
                temps=0.0, top_ps=ones)))
        fn = lambda: self._verify_fn(K, stochastic)         # noqa: E731
        prog = self._program(("verify", K, stochastic), fn, stochastic, dead)
        buf.upload(buf.pack(inputs))
        self._programs.run(prog, fn)
        return self._ver_out[K].cpu().numpy()

    def _spec_decode_round(self) -> List[Request]:
        """One draft-and-verify speculative round.

        Per decode-ready slot the drafter proposes up to ``draft_k``
        tokens from the request's visible stream; ONE verify forward
        scores all K+1 positions of every slot and rejection sampling
        accepts a per-slot prefix.  Slots the drafter had nothing for
        ride along with zero drafts: the rule is exact for any
        deterministic proposal, so only the acceptance counters (real
        proposals) depend on the drafter.  The copy-on-write guard runs
        BEFORE the speculative write, so a rejected row never lands in a
        block another table references.  Rejected positions roll back
        logically (``pos`` advances over emitted tokens only).  A round
        that cannot speculate (no proposal, no room before max_seq, or
        no blocks for the window without preemption) runs one plain
        round instead.  With fused sampling only the ``(out, n_acc)``
        int32 vectors cross to the host; the host oracle reads the
        verify rows back."""
        K = self.draft_k
        for seq in self.sched.active:
            if seq is not None and not seq.prefilling:
                K = min(K, self.max_seq - 1 - seq.pos)
        props: Dict[int, List[int]] = {}
        if K >= 1:
            for slot, seq in enumerate(self.sched.active):
                if seq is None or seq.prefilling:
                    continue
                p = self.drafter.propose(
                    list(seq.req.prompt) + list(seq.req.out), K)[:K]
                if p:
                    props[slot] = [int(t) for t in p]
        if K < 1 or not props \
                or not self.sched.reserve_lookahead(1, draft_k=K):
            return (self._fused_decode_round() if self.sampling == "fused"
                    else self._host_decode_step())
        for seq in self.sched.active:
            if seq is not None and not seq.prefilling:
                self._ensure_writable(seq, seq.pos, seq.pos + K + 1)
        self._refresh_tables()
        (last, pos, _, alive), (temps, top_ks, top_ps, _), stochastic = \
            self._slot_arrays()
        B, K1 = self.slots, K + 1
        draft = np.zeros((B, K), np.int32)
        real = np.zeros((B,), np.int32)
        for slot, p in props.items():
            draft[slot, :len(p)] = p
            real[slot] = len(p)
        toks = np.concatenate([last[:, None], draft], 1)
        positions = np.where(alive[:, None],
                             pos[:, None] + np.arange(K1, dtype=np.int32),
                             0).astype(np.int32)
        lens = np.where(alive[:, None], positions + 1, 1).astype(np.int32)
        tables = np.repeat(self.block_tables, K1, axis=0)
        self.stats.spec_rounds += 1
        if self.sampling == "fused":
            res = self._verify_round(K, stochastic, dict(
                tokens=toks, positions=positions, lens=lens, tables=tables,
                draft=draft, temps=temps, top_ks=top_ks, top_ps=top_ps))
            out, n_acc = res[:, :K1], res[:, K1]
            self.stats.host_syncs += 1
            self.stats.bytes_to_host += res.nbytes
        else:
            # on the ring every rank gathers the rows whole and runs the
            # oracle on them, as the reference's host round reads them
            rows = self._full_row(self._verify_fwd(
                self._to_dev(toks.reshape(1, B * K1)),
                self._to_dev(positions.reshape(1, B * K1)),
                self._to_dev(tables), self._to_dev(lens.reshape(-1))))
            rows = rows.reshape(B, K1, -1)
            rows_np = rows.cpu().numpy()
            self.stats.host_syncs += 1
            self.stats.bytes_to_host += rows_np.nbytes
            out = np.zeros((B, K1), np.int32)
            n_acc = np.zeros((B,), np.int32)
            for slot, seq in enumerate(self.sched.active):
                if alive[slot]:
                    o, n = spec_verify_rows(rows[slot],
                                            self._to_dev(draft[slot]),
                                            self.gen, seq.req.params)
                    out[slot], n_acc[slot] = o.cpu().numpy(), n
        finished: List[Request] = []
        self.stats.steps += 1
        self.stats.slot_steps += self.slots
        for slot, seq in enumerate(self.sched.active):
            if seq is None or seq.prefilling:
                continue
            req = seq.req
            self.stats.busy_slot_steps += 1
            n = int(n_acc[slot])
            self.stats.draft_tokens += int(real[slot])
            self.stats.accepted_tokens += min(n, int(real[slot]))
            emit = [int(t) for t in out[slot, :n + 1]]
            for j, tok in enumerate(emit):
                self.stats.tokens += 1
                req.out.append(tok)
                seq.pos += 1
                seq.last_token = tok
                if req.stream_cb:
                    req.stream_cb(req.rid, tok)
                if self._should_finish(seq, tok):
                    self.stats.overrun_tokens += len(emit) - j - 1
                    finished.append(self._finish(seq))
                    break
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
        """Bytes held by the KV cache (block pool or dense slot cache),
        over every rank of the ring: each holds 1/tp of the heads."""
        return cache_bytes(self.cache) * self.tp

    def per_rank_kv_bytes(self) -> int:
        """KV bytes resident on ONE ring rank (heads shard 1/tp)."""
        return self.kv_cache_bytes() // self.tp

    def pending_load(self) -> int:
        """Outstanding tokens (queued + active): the router's signal."""
        return self.sched.pending_tokens()

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


class _Outcome(NamedTuple):
    """One ring's part of a fleet round, as the supervision reads it."""
    idle: bool
    done: Sequence[Request] = ()
    failure: Optional[Tuple[str, dict]] = None
    dt: float = 0.0
    progressed: bool = True


class RingView:
    """Every rank's host view of one sub-ring of a mesh fleet: the
    ring's agreed counters (``stats``), events, requests in flight with
    their outstanding tokens (``pending_load``, ``has_work``) and step
    knobs, the same on every rank.  Each round's record of the ring
    (its sub-ring rank 0's) replaces them; between rounds the fleet's
    submits, migrations and cancels update them on every rank alike.
    On the ranks of the ring itself the view also drives its
    :class:`LPUEngine` (``local``): a submit, cancel or reset there is
    applied to the engine too."""

    def __init__(self, ring_id: int, engine: "LPUEngine",
                 fleet: "MultiRingEngine", local: bool):
        self.ring_id = ring_id
        self.local = engine if local else None
        # weakly: a view holding its fleet would put the fleet, its
        # engine and their NCCL graphs in a cycle, freed by the cyclic
        # collector at any later point (inside another engine's capture,
        # or after the process group is gone) instead of by reference
        # count when the caller drops it
        self._fleet = weakref.ref(fleet)
        self.config = engine.config
        self.injector = engine.injector
        self.sampling = engine.sampling
        self.paged = engine.paged
        self.prefill_chunk = engine.prefill_chunk
        self.steps_per_sync = engine.steps_per_sync
        self._kv_bytes = engine.per_rank_kv_bytes()
        self.stats = EngineStats()
        self.events: List[Event] = []
        self.step_no = 0
        self.loads: Dict[int, int] = {}   # rid -> outstanding tokens,
                                          # in reset() order

    def pending_load(self) -> int:
        return sum(self.loads.values())

    def has_work(self) -> bool:
        return bool(self.loads)

    def per_rank_kv_bytes(self) -> int:
        return self._kv_bytes

    def set_step_knobs(self, prefill_chunk: Optional[int] = None,
                       steps_per_sync: Optional[int] = None) -> None:
        c, s = checked_knobs(self, prefill_chunk, steps_per_sync)
        if self.local is not None:
            self.local.set_step_knobs(c, s)
        if s is not None:
            self.steps_per_sync = s
        if c is not None:
            self.prefill_chunk = c

    def submit(self, req: Request) -> None:
        self.loads[req.rid] = queued_load(req)
        if self.local is not None:
            self._fleet()._run_locally(req)

    def cancel(self, rid: int) -> Optional[Request]:
        """The engine's cancel, on the view: the request ends as
        cancelled with its stream so far."""
        if rid not in self.loads:
            return None
        del self.loads[rid]
        fleet = self._fleet()
        req = fleet._reqs.pop(rid)
        if self.local is not None:
            got = self.local.cancel(rid)
            if got is None or list(got.out) != req.out:
                raise RuntimeError(f"ring {self.ring_id}: request {rid} "
                                   "left its engine apart from the view")
            del fleet._local[rid]
        req.done = True
        req.cancelled = True
        fleet._results[rid] = req.out
        self.stats.cancelled_requests += 1
        self.events.append(Event("request_cancelled", self.step_no,
                                 {"rid": rid, "tokens": len(req.out)}))
        return req

    def reset(self) -> List[Request]:
        """Drain the ring: its requests in flight, in the engine's
        orphan order, and on its own ranks the engine's reset."""
        rids = list(self.loads)
        self.loads = {}
        fleet = self._fleet()
        if self.local is not None:
            got = [r.rid for r in self.local.reset()]
            if got != rids:
                raise RuntimeError(f"ring {self.ring_id} orphaned {got}, "
                                   f"its view {rids}")
            for rid in got:
                del fleet._local[rid]
        return [fleet._reqs[rid] for rid in rids]

    def apply(self, rec: dict) -> None:
        """Take the ring's record of a round (see
        :meth:`MultiRingEngine._record`)."""
        for k, v in rec["stats"].items():
            setattr(self.stats, k, v)
        start, new = rec["events"]
        del self.events[start:]
        self.events.extend(new)
        self.step_no = rec["step_no"]
        self.loads = dict(rec["loads"])


class MultiRingEngine:
    """A supervised fleet of :class:`LPUEngine` rings (paper C3), in one
    of two forms.

    *Host fleet* (``mesh=None, rings=N``): N engines on one device, every
    one over the same weight tensors, each with its own KV pool,
    scheduler and captured programs.  ``step()`` runs the rings one
    after another from one host thread, as the reference does.

    *Mesh fleet* (``mesh`` = the rank's world :class:`repro_torch.core.
    dist.Ring`, ``ring_size`` = tp): the world of ``mesh.size`` ranks
    splits into ``mesh.size // ring_size`` disjoint sub-rings
    (:func:`repro_torch.core.rings.sub_ring`, the reference's
    ``submeshes``), and each rank runs one ring-parallel engine on its
    sub-ring's handle, over ``params`` (the rank's shards at its place in
    its sub-ring, :func:`repro_torch.weights.init_shard`; ``model``
    planned for one sub-ring, ``("model",), (ring_size,)``).  Every rank
    calls the fleet's methods in the same order (``submit``, ``step``,
    ``cancel``...).  A round steps only the rank's own sub-ring (idle or
    not, every rank joins the round); then one :class:`repro_torch.core.
    dist.Agreement` over the world (a gloo group of its own) gives every
    rank each ring's record, its sub-ring rank 0's: whether it stepped,
    its ``RingFailure``, its step time, its requests in flight with
    their outstanding tokens, the tokens each request emitted and which
    finished, its counters and new events.  From those every rank runs
    the same supervision code as the host fleet, in the same order, and
    reaches the same decisions.  No other collective crosses sub-rings.
    Every rank holds the fleet's host view (``engines`` are
    :class:`RingView` s; ``local`` is the rank's own engine), so
    ``submit``, ``cancel``, ``generate``, ``drain``, ``per_ring_stats()``
    and ``fleet_counters()`` give the same on every rank.  A request's
    ``stream_cb`` is called from the agreed tokens after each round.
    Rings step concurrently, so an orphan that an earlier ring's failure
    sends to a later ring reaches it after its step: in such a round,
    and only then, the later ring runs an admission pass after the
    agreement (:meth:`_mesh_pass`: the orphans admitted into the slots
    its step left free and decoded in a round of their own) and one
    more agreement shares its record, so the orphans advance in the
    same round as on the reference's sequential rings.
    ``affinity="prefix"`` gathers every ring's prefix peek of a prompt
    at its submit.  Wall-clock heartbeats read world rank 0's clock,
    carried in its record.

    Requests are routed per ring by :class:`repro_torch.serving.
    scheduler.RingRouter` (least outstanding tokens, or with
    ``affinity="prefix"`` the ring whose prefix index owns the deepest
    prefix of the prompt).  The fleet's tokens/s is total tokens over
    the fleet's wall time in ``step()``, never the sum of per-ring rates.

    Fault tolerance: a :class:`RingFailure` raised by a ring (injected,
    or the finite-logits guard), a ring silent past the heartbeat
    timeout or, with ``ft_straggler_drain``, a straggler step starts the
    recovery: drain the ring (:meth:`LPUEngine.reset` returns its
    orphans and rebuilds it in place), migrate the orphans to the least
    loaded surviving ring through the recompute-resume path
    (``Request.resume_tokens``), and return the rebuilt ring to rotation
    (:meth:`HeartbeatTracker.revive`).  A request migrated
    ``max_migrations`` times already ends with ``failed=True`` and an
    ``error``, never an exception.  A fleet with a chaotic ring runs on a
    :class:`ManualClock` (one fleet round = 1 s), so heartbeat timeouts
    are step-deterministic.  ``**engine_kw`` goes to every ring's
    :class:`LPUEngine` (``device``, ``graphs``, ``seed``, a drafter's
    model...)."""

    def __init__(self, model, params, mesh=None, *, ring_size: int = 0,
                 rings: int = 0, config: Optional[EngineConfig] = None,
                 step_prior_s: float = 0.0, **engine_kw):
        self.world = None
        self.local: Optional[LPUEngine] = None
        if mesh is not None:
            self._init_mesh(model, params, mesh, ring_size, config,
                            engine_kw)
        else:
            if rings < 1:
                raise ValueError("host fleets need rings >= 1")
            if model.plan.mesh_axes is not None:
                raise ValueError(
                    "host-fleet mode needs a mesh-free plan "
                    f"(got mesh_axes={model.plan.mesh_axes})")
            self.ring_cfg = None
            self.engines = [LPUEngine(model, params, config, **engine_kw)
                            for _ in range(rings)]
            for i, eng in enumerate(self.engines):
                eng.ring_id = i
        self.router = RingRouter(len(self.engines))
        self.ring_of: Dict[int, int] = {}
        self._rid = 0
        c = self.engines[0].config
        self.max_migrations = c.max_migrations
        self.affinity = c.affinity
        chaotic = any(e.injector is not None for e in self.engines)
        self._clock = ManualClock() if chaotic else time.time
        # a mesh fleet's wall clock is world rank 0's, read into every
        # rank's ManualClock each round, so every rank judges alike
        self._agreed_wall = self.world is not None and not chaotic
        if self._agreed_wall:
            self._clock = ManualClock(self.agreement.announce(
                time.time() if self.world.rank == 0 else None))
        self.hb = HeartbeatTracker(len(self.engines),
                                   timeout_s=c.heartbeat_timeout_s,
                                   clock=self._clock)
        self.monitors = [StragglerMonitor(mu0=step_prior_s or None)
                         for _ in self.engines]
        self.ft_straggler_drain = c.ft_straggler_drain
        self.events: List[Event] = []
        self._migrations: Dict[int, int] = {}   # rid -> resubmissions
        self.failed: Dict[int, Request] = {}    # rid -> failed request
        self._round = 0
        self._later: set = set()   # rings an earlier ring's orphans
                                   # reached this round (mesh fleet)
        self.wall = 0.0

    def _init_mesh(self, model, params, mesh, ring_size: int, config,
                   engine_kw) -> None:
        from repro_torch.core.dist import Ring, SubRing
        from repro_torch.core.rings import reconfigure, sub_ring
        if not isinstance(mesh, Ring) or isinstance(mesh, SubRing):
            raise TypeError(
                f"a mesh fleet's mesh is the rank's world ring "
                f"(repro_torch.core.dist.Ring, from run_ranks), not "
                f"{type(mesh).__name__}")
        if ring_size < 1:
            raise ValueError("mesh fleets need ring_size >= 1")
        self.ring_cfg = reconfigure(mesh.size, ring_size)
        if not self.ring_cfg.validate_disjoint():
            raise ValueError(f"sub-rings {self.ring_cfg.groups()} overlap")
        if model.plan.tp != ring_size:
            raise ValueError(f"model planned for tp={model.plan.tp}, "
                             f"ring_size={ring_size}")
        self.world = mesh
        self.ring_index, self.sub = sub_ring(mesh, ring_size)
        self.agreement = mesh.agreement()
        self.local = LPUEngine(model, params, config, mesh=self.sub,
                               **engine_kw)
        self.local.ring_id = self.ring_index
        self.engines = [RingView(j, self.local, self, j == self.ring_index)
                        for j in range(self.ring_cfg.n_rings)]
        self._reqs: Dict[int, Request] = {}     # rid -> request in flight
        self._local: Dict[int, Request] = {}    # ...its copy in ``local``
        self._results: Dict[int, List[int]] = {}
        self._events_sent = 0

    @property
    def n_rings(self) -> int:
        return len(self.engines)

    @property
    def tokens_per_s(self) -> float:
        """Total tokens over the fleet's wall time in ``step()``."""
        tokens = sum(e.stats.tokens for e in self.engines)
        return tokens / self.wall if self.wall else 0.0

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               params: Optional[SamplingParams] = None,
               stream_cb: Optional[StreamCB] = None) -> int:
        """Route to the prefix-owning ring (``affinity="prefix"``) or the
        least loaded one; returns a fleet-wide request id."""
        prompt = list(prompt)
        if self.world is not None:
            self.local.check_prompt(prompt)
        aff = self._peeks(prompt) if self.affinity == "prefix" else None
        ring = self.router.route(
            [e.pending_load() for e in self.engines], affinity=aff)
        req = Request(self._rid, prompt, max_new_tokens,
                      params or SamplingParams(0.0, 0, 1.0),
                      stream_cb=stream_cb)
        self._rid += 1
        if self.world is not None:
            self._reqs[req.rid] = req
        self.engines[ring].submit(req)
        self.ring_of[req.rid] = ring
        return req.rid

    def _peeks(self, prompt: List[int]) -> List[int]:
        """Every ring's prefix-cache peek of ``prompt``; on a mesh fleet
        each ring's own ranks peek and the agreement gathers them."""
        def peek(eng):
            return eng.prefix.peek(prompt) if eng.prefix is not None else 0
        if self.world is None:
            return [peek(e) for e in self.engines]
        got = self.agreement.gather(peek(self.local))
        return [got[g[0]] for g in self.ring_cfg.groups()]

    def _run_locally(self, req: Request) -> None:
        """Submit the fleet's request ``req`` to this rank's engine (a
        copy with its stream so far: a migrated orphan resumes through
        the recompute path)."""
        copy = Request(req.rid, list(req.prompt), req.max_new_tokens,
                       req.params, out=list(req.out))
        self._local[req.rid] = copy
        self.local.submit(copy)

    def cancel(self, rid: int) -> Optional[Request]:
        """Abort one in-flight request on the ring that holds it now
        (``ring_of`` follows migrations).  None if it already finished or
        failed."""
        ring = self.ring_of.get(rid)
        if ring is None:
            return None
        return self.engines[ring].cancel(rid)

    def step(self) -> List[Request]:
        """One supervised round over every ring that has work.  An idle
        ring heartbeats for free; a working ring beats only when its
        round made progress (a decode step or a prefill, or it ran out of
        work), so a wedged ring goes silent and the timeout check at the
        end of the round drains it."""
        t_round = time.perf_counter()
        self._round += 1
        done: List[Request] = []
        self._later: set = set()
        outcomes = (self._host_outcomes() if self.world is None
                    else self._mesh_outcomes())
        for i, o in enumerate(outcomes):
            if i in self._later and o.failure is None:
                # orphans of an earlier ring reached this one after its
                # step: the reference's sequential round steps them here
                o = self._mesh_pass(i, o)
            if o.idle:
                self.hb.beat(i)
                continue
            if o.failure is not None:
                done.extend(self._on_ring_failure(i, *o.failure))
                continue
            done.extend(o.done)
            ev = self.monitors[i].record(self._round, o.dt)
            if ev is not None:
                self.events.append(Event("straggler", self._round,
                                         {"ring": i, **ev.detail}))
                if self.ft_straggler_drain:
                    done.extend(self._on_ring_failure(
                        i, "straggler", dict(ev.detail)))
                    continue
            if o.progressed:
                self.hb.beat(i)
        if isinstance(self._clock, ManualClock) and not self._agreed_wall:
            self._clock.advance(FLEET_ROUND_S)
        for i in self.hb.check():
            done.extend(self._on_ring_failure(
                i, "heartbeat_timeout", {"timeout_s": self.hb.timeout}))
        self.wall += time.perf_counter() - t_round
        return done

    def _host_outcomes(self) -> Iterator[_Outcome]:
        """Each ring's step in turn, as the supervision consumes them: a
        ring steps after the earlier rings' recoveries (an orphan
        migrated to a later ring steps in the same round)."""
        for eng in self.engines:
            if not eng.sched.has_work():
                yield _Outcome(True)
                continue
            before = eng.stats.steps + eng.stats.prefills
            t0 = time.perf_counter()
            try:
                done = eng.step()
            except RingFailure as f:
                yield _Outcome(False, failure=(f.reason, dict(f.detail)))
                continue
            dt = time.perf_counter() - t0
            progressed = (eng.stats.steps + eng.stats.prefills) > before \
                or not eng.sched.has_work()
            yield _Outcome(False, done, None, dt, progressed)

    def _mesh_outcomes(self) -> List[_Outcome]:
        """This rank's sub-ring steps (every rank of it alike), then the
        round's agreement; every ring's record (its sub-ring rank 0's)
        is applied to the fleet's view and read as the ring's outcome."""
        eng = self.local
        rec = dict(idle=not eng.sched.has_work(), failure=None, dt=0.0,
                   progressed=True, returned=[])
        if not rec["idle"]:
            before = eng.stats.steps + eng.stats.prefills
            t0 = time.perf_counter()
            try:
                rec["returned"] = [r.rid for r in eng.step()]
            except RingFailure as f:
                rec["failure"] = (f.reason, dict(f.detail))
            rec["dt"] = time.perf_counter() - t0
            rec["progressed"] = \
                (eng.stats.steps + eng.stats.prefills) > before \
                or not eng.sched.has_work()
        rec.update(self._record())
        if self._agreed_wall and self.world.rank == 0:
            rec["now"] = time.time()
        got = self.agreement.gather(rec)
        if self._agreed_wall:
            self._clock.t = got[0]["now"]
        out = []
        for j, g in enumerate(self.ring_cfg.groups()):
            r = got[g[0]]
            done = self._apply(j, r)
            out.append(_Outcome(r["idle"], done, r["failure"], r["dt"],
                                r["progressed"]))
        return out

    def _mesh_pass(self, j: int, o: _Outcome) -> _Outcome:
        """Ring ``j``'s admission pass for the orphans an earlier ring
        sent it this round, after the round's agreement: its own ranks
        run :meth:`LPUEngine.admission_pass` (or, when the ring was idle
        at its step, the step itself, which the reference's ring takes
        only for the orphans), then one more agreement gives every rank
        the ring's record.  Returns the ring's outcome of the round: its
        step's and the pass's together."""
        rec = dict(failure=None, dt=0.0, progressed=True, returned=[])
        if self.ring_index == j:
            eng = self.local
            before = eng.stats.steps + eng.stats.prefills
            t0 = time.perf_counter()
            try:
                got = eng.step() if o.idle else eng.admission_pass()
                rec["returned"] = [r.rid for r in got]
            except RingFailure as f:
                rec["failure"] = (f.reason, dict(f.detail))
            rec["dt"] = time.perf_counter() - t0
            rec["progressed"] = \
                (eng.stats.steps + eng.stats.prefills) > before \
                or not eng.sched.has_work()
            rec.update(self._record())
        got = self.agreement.gather(rec)
        r = got[self.ring_cfg.groups()[j][0]]
        done = self._apply(j, r)
        return _Outcome(False, list(o.done) + done, r["failure"],
                        o.dt + r["dt"], o.progressed or r["progressed"])

    def _record(self) -> dict:
        """This rank's sub-ring's state after its step: requests in
        flight with their outstanding tokens, each request's new tokens
        and which finished, the counters (but the supervision's), the
        events not yet sent and the engine's step number."""
        eng = self.local
        tokens, finished = [], []
        for rid, copy in list(self._local.items()):
            new = copy.out[len(self._reqs[rid].out):]
            if new:
                tokens.append((rid, list(new)))
            if copy.done:
                finished.append((rid, copy.failed, copy.error))
                del self._local[rid]
        eng._results.clear()          # the fleet keeps the results
        start, self._events_sent = self._events_sent, len(eng.events)
        return dict(
            loads=eng.sched.loads(), tokens=tokens, finished=finished,
            stats={k: getattr(eng.stats, k) for k in STATS_FIELDS},
            events=(start, eng.events[start:]), step_no=eng._step_no)

    def _apply(self, j: int, rec: dict) -> List[Request]:
        """Ring ``j``'s record on this rank's view: each request's new
        tokens (its ``stream_cb`` called), the finished ones ended, the
        ring's view replaced.  Returns the requests its step returned."""
        for rid, new in rec["tokens"]:
            req = self._reqs[rid]
            for tok in new:
                req.out.append(tok)
                if req.stream_cb:
                    req.stream_cb(rid, tok)
        returned = set(rec["returned"])
        done = []
        for rid, failed, error in rec["finished"]:
            req = self._reqs.pop(rid)
            req.done, req.failed, req.error = True, failed, error
            self._results[rid] = req.out
            if rid in returned:
                done.append(req)
        self.engines[j].apply(rec)
        return done

    def _on_ring_failure(self, i: int, reason: str,
                         detail: dict) -> List[Request]:
        """Drain -> migrate -> rebuild ring ``i``.  Returns the requests
        that ran out of migrations (now structured failures)."""
        eng = self.engines[i]
        eng.stats.ring_failures += 1
        self.events.append(Event("ring_failed", self._round,
                                 {"ring": i, "reason": reason, **detail}))
        orphans = eng.reset()
        self.hb.revive(i)
        self.events.append(Event("ring_rebuilt", self._round,
                                 {"ring": i, "orphans": len(orphans)}))
        failed: List[Request] = []
        for req in orphans:
            got = self._migrate(req, i)
            if got is not None:
                failed.append(got)
        return failed

    def _migrate(self, req: Request, source: int) -> Optional[Request]:
        """Resubmit one orphan through the recompute-resume path on the
        least loaded other ring (the rebuilt ring itself when it is
        alone).  Returns the request if its migrations are used up."""
        n = self._migrations.get(req.rid, 0)
        if n >= self.max_migrations:
            req.done = True
            req.failed = True
            req.error = (f"retries exhausted: migrated {n}x "
                         f"(max_migrations={self.max_migrations})")
            self.failed[req.rid] = req
            if self.world is not None:
                del self._reqs[req.rid]
            self.events.append(Event("request_failed", self._round,
                                     {"rid": req.rid, "migrations": n}))
            return req
        self._migrations[req.rid] = n + 1
        others = [j for j in range(len(self.engines)) if j != source]
        ring = min(others or [source],
                   key=lambda j: (self.engines[j].pending_load(), j))
        tgt = self.engines[ring]
        tgt.submit(req)
        if self.world is not None and ring > source:
            self._later.add(ring)
        self.ring_of[req.rid] = ring
        tgt.stats.retries += 1
        if ring != source:
            tgt.stats.migrated_requests += 1
        return None

    def has_work(self) -> bool:
        return any(e.has_work() for e in self.engines)

    def drain(self) -> Dict[int, List[int]]:
        """Step until every ring is idle; returns {rid: generated tokens}
        of everything finished since the last drain, failed requests'
        partial streams included (``Request.failed`` / ``error``; the
        fleet keeps the requests in ``failed``)."""
        while self.has_work():
            self.step()
        out: Dict[int, List[int]] = {}
        if self.world is None:
            for eng in self.engines:
                out.update(eng.drain())
        else:
            out, self._results = self._results, {}
        for rid, req in self.failed.items():
            out[rid] = req.out
        return out

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 32,
                 params: Optional[SamplingParams] = None,
                 stream_cb: Optional[StreamCB] = None) -> List[List[int]]:
        rids = [self.submit(list(p), max_new_tokens, params,
                            stream_cb=stream_cb) for p in prompts]
        results = self.drain()
        return [results[r] for r in rids]

    def per_ring_stats(self) -> List[EngineStats]:
        return [e.stats for e in self.engines]

    def fleet_counters(self) -> Dict[str, int]:
        """The fleet's fault-tolerance counters, summed over its rings."""
        stats = self.per_ring_stats()
        return {
            "ring_failures": sum(s.ring_failures for s in stats),
            "migrated_requests": sum(s.migrated_requests for s in stats),
            "retries": sum(s.retries for s in stats),
            "rejected_requests": sum(s.rejected_requests for s in stats),
            "failed_requests": len(self.failed),
            "submitted": self._rid,
            "events": len(self.events)
            + sum(len(e.events) for e in self.engines),
        }
