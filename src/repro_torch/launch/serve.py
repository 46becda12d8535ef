"""Serving driver of the port: build a model with seeded random weights
and run the engine on a batch of random prompts.

    python -m repro_torch.launch.serve                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --prefill-chunk 64 --prefix-cache on
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --kv-dtype int8 --speculate ngram --draft-k 4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b  # card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite  # card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --rings 2 --chaos ring@2,nan@5
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --budget-ms 5 --max-pending 2 --tracker t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --tp 2 [--no-overlap] [--speculate ngram]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \
        --tp 2                                     # a card per rank
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \
        --tp 2 --shared-card                       # both ranks on one card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba \
        --reduced --device cpu --tp 2
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-v0.1-52b --tp 2               # two cards, 52 GB each
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-34b --tp 2               # two cards, its text
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --tp 2 --rings 2 [--chaos ring@2]   # the mesh fleet
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced \
        --device cpu --tp 2 --budget-ms 5 --max-pending 2 --tracker t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-66b \
        --tp 2 --rings 2                           # four cards

``--arch`` takes any name or alias of the port's registry: the dense
decoders (smollm-135m, the paper's opt-1.3b/6.7b/30b/66b and gpt3-20b,
qwen1.5-4b, deepseek-coder-33b, minicpm-2b), the MoE stacks granite
(granite-moe-3b-a800m) and llama4 (llama4-maverick-400b-a17b, its
shared expert), llava (llava-next-34b, served as a text decoder: the
engine passes no patch embeddings), rwkv6-7b and jamba.  whisper-tiny
(an encoder-decoder) is refused with the engine's message: it is served
through ``repro_torch.core.steps``.  A
config with learned positions (OPT, GPT3) refuses ``--max-seq`` past its
position table.  Runs on the CUDA device unless ``--device cpu`` is
given (and fails when there is none).  Prints the stats lines of the
reference's ``launch/serve.py`` plus the launch count of the family's
kernel: the paged decode attention (dense decoders), the WKV recurrence
(rwkv) or the selective scan (hybrid: every mamba layer, prefill and
decode), 0 on the CPU, where the plain versions run.  ``--prefill-chunk C``
makes prompts resident C tokens per step, interleaved with decode
windows, and ``--prefix-cache on`` maps a cached block-aligned prompt
prefix into a new request's table (both on the paged pool only); every
chunk and prefix tail runs the paged kernel too.  ``--kv-dtype
int8|fp8`` stores the pool quantized (one f16 scale per row and kv
head).  ``--speculate ngram|model`` with ``--draft-k K`` drafts K tokens
per slot (n-gram suffix match, or greedy decoding of a reduced
smollm-135m with its own seed, over the target's vocabulary) and
verifies every slot's drafts in one forward, the paged kernel's batch
being the slots' K+1 queries.  ``--rings N`` (N > 1) or ``--chaos``
serves through the supervised host fleet (``MultiRingEngine``: N engines
on the one device over the same weights), with the reference's
``--max-migrations``, ``--heartbeat-timeout`` (virtual seconds under
chaos) and ``--affinity``; on the CPU each ring's straggler monitor is
seeded with the latency model's step-time prior at the LPU-FPGA point
(on the card with none: its warm-up takes the first measured steps),
and the fleet prints the reference's per-ring and ``ft:`` lines.  ``--budget-ms
B`` (SLO step budget: the knobs ``prefill_chunk`` / ``steps_per_sync``
retuned before every step from a measured EWMA seeded by the same
prior, or on the card by the budget itself), ``--max-pending N``
(admission bound with structured backpressure) or ``--tracker PATH`` (jsonl telemetry: per-window
``EngineStats`` deltas and per-request TTFT / ms-per-token records)
routes the batch through the async front end
(:mod:`repro_torch.serving.frontend`) instead of the blocking
``generate()``, and prints the reference's front-end summary lines.
The latency model's prior is taken at the LPU-FPGA point on the CPU
(where the fleet and the front end are held to the reference's) and
not at all on the card: the copied H100 roofline point gave smollm-135m
0.333 ms a step against ~10 ms measured, so healthy steps read as
stragglers.

``--tp N`` serves the dense, MoE (granite, llama4), vlm (llava, as a
text decoder), rwkv and hybrid (jamba) stacks tensor-parallel over a
ring of N ranks, each a process (:func:`repro_torch.core.dist.run_ranks`), each
drawing only its slice of the tp=1 weights (seed 0) at the ring's
layout (:func:`repro_torch.weights.init_shard`): the streams are the
tp=1 run's.  On CUDA each rank owns a card (rank r on ``cuda:r``) over
NCCL, its steps on captured CUDA graphs; a machine with fewer than N
cards raises and names both counts.  ``--shared-card`` puts every rank
on the one card over gloo instead, its steps eager (a gloo collective
cannot be captured).  On the CPU (``--device cpu``) the ranks run over
gloo, eagerly.  Rank 0 prints the reference's lines, the backend, the
ranks' cards and the family kernel's launches on each rank.  ``--no-overlap`` is the blocking baseline (full
matmuls, then ``psum``/``all_gather``) instead of the ESL overlap.
``--speculate ngram|model`` composes with ``--tp``: every rank drafts
the same tokens (the model drafter whole on each rank's device) and
the ring verifies them in one forward on its heads.  ``--tp N --rings
R`` (R > 1, or ``--chaos``) serves through the mesh fleet: ``N x R``
ranks (on CUDA rank r on ``cuda:r``; a machine with fewer cards raises
and names both counts) in R sub-rings of N, each sub-ring a
ring-parallel engine over its own shards of the same weights, the
fleet's supervision agreed by every rank once a round
(:class:`repro_torch.serving.engine.MultiRingEngine` with
``mesh=ring``); rank 0 prints the fleet's lines and the agreement's
cost.  ``--budget-ms``, ``--max-pending`` and ``--tracker`` put the
async front end on world rank 0, which orders every rank
(:meth:`repro_torch.serving.frontend.AsyncFrontend.follow`), over one
ring or over the mesh fleet.  whisper-tiny is refused by the engine on
any mesh.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import numpy as np
import torch

from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core.dist import run_ranks
from repro_torch.core.latency_model import LPU_FPGA, step_time_prior
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import (LPUEngine, MultiRingEngine,
                                        refuse_encdec)
from repro_torch.serving.sampler import SamplingParams


def wants_frontend(args) -> bool:
    """Whether the batch goes through the async front end."""
    return args.budget_ms > 0 or args.max_pending > 0 or bool(args.tracker)


def serve_async(engine, args, prompts, sp, prior):
    """Drive the batch through the async streaming front end instead of
    the blocking ``generate()`` loop: the path ``--budget-ms`` /
    ``--max-pending`` / ``--tracker`` select.  A rejected submit is
    retried once the engine has gone quiet (a CLI batch has nowhere else
    to send its load), and the per-request TTFT / ms-per-token summary
    of the streams' timelines is printed at the end.  ``prior``: the
    latency model's step time that seeds the budget's EWMA."""
    import asyncio

    from repro_torch.serving.budget import BudgetScheduler
    from repro_torch.serving.frontend import AsyncFrontend, submit_admitted
    from repro_torch.serving.tracker import JsonlTracker

    budget = None
    if args.budget_ms > 0:
        budget = BudgetScheduler(args.budget_ms, prior_step_s=prior,
                                 max_chunk=args.max_seq)
    tracker = JsonlTracker(args.tracker) if args.tracker else None
    retries = 0

    async def go():
        nonlocal retries
        async with AsyncFrontend(engine, budget=budget,
                                 tracker=tracker) as fe:
            streams = []
            for p in prompts:
                stream, n = await submit_admitted(fe, p, args.max_new, sp)
                streams.append(stream)
                retries += n
            outs = [await s.drain() for s in streams]
        return fe, streams, outs

    fe, streams, outs = asyncio.run(go())
    tl = [s.timeline for s in streams if s.timeline.t_first is not None]
    ttft = sorted(t.ttft_ms for t in tl)
    mpt = sorted(t.ms_per_token for t in tl if t.tokens >= 2)
    c = fe.counters
    print(f"[serve] frontend: {c['completed']} completed "
          f"{c['failed']} failed {c['cancelled']} cancelled "
          f"({c['rejected']} backpressure rejections, {retries} retried)")
    if fe.world is not None:
        print(f"[serve] frontend orders: {fe.orders_applied} applied on "
              f"each of {fe.world.size} ranks, crc32 {fe.orders_crc:08x}")
    if ttft:
        print(f"[serve] ttft p50/max {ttft[len(ttft) // 2]:.1f}/"
              f"{ttft[-1]:.1f} ms"
              + (f", ms/token p50/max {mpt[len(mpt) // 2]:.2f}/"
                 f"{mpt[-1]:.2f}" if mpt else ""))
    if budget is not None:
        print(f"[serve] budget={args.budget_ms}ms: {len(budget.planned)} "
              f"plans, mu_step {budget.mu_step * 1e3:.3f} ms "
              f"({budget.observed_windows} windows, "
              f"{budget.observed_chunks} chunks observed)")
    if tracker is not None:
        print(f"[serve] tracker: {tracker.written} records -> "
              f"{tracker.path}")
    return outs


def family_kernel(cfg):
    """The hand kernel whose launches the driver reports: kernel 4 for
    rwkv, kernel 5's fused entry for the hybrid, kernel 1 otherwise."""
    return {"rwkv": rwkv_scan, "hybrid": mamba_scan_fused}.get(
        cfg.family, paged_decode_attention)


def prior_point(dev):
    """The latency model's hardware point that seeds the step-time
    prior: LPU-FPGA on the CPU, where the fleet and the front end are
    held to the reference's; none on the card, where the monitors'
    warm-up takes the first measured steps and the budget starts from
    itself (both roofline points, LPU-FPGA's 0.859 ms and the copied
    H100's 0.333 ms a step for smollm-135m, sit far below the card's
    ~10 ms, so healthy steps read as stragglers)."""
    return LPU_FPGA if dev.type == "cpu" else None


def step_prior(cfg, tp: int, dev, args) -> float:
    """The step-time prior (seconds; 0 = none) of the straggler monitors
    and the budget's EWMA (:func:`prior_point`)."""
    point = prior_point(dev)
    if point is None:
        return 0.0
    return step_time_prior(cfg, tp, point, kv_len=args.max_seq,
                           steps_per_sync=args.steps_per_sync)


def fleet_of(args) -> bool:
    """Whether the run serves through a supervised fleet."""
    return args.rings > 1 or bool(args.chaos)


def placement_of(args):
    """The ranks' placement ``--tp`` asks for (:func:`repro_torch.core.
    dist.rank_devices`): none on the CPU; on CUDA a card per rank, or
    the one card with ``--shared-card``."""
    if args.shared_card and args.tp <= 1:
        raise ValueError("--shared-card places the ranks of --tp N > 1")
    if args.device == "cpu":
        return "shared_card" if args.shared_card else None
    return "shared_card" if args.shared_card else "card_per_rank"


def serve_rank(ring, argv):
    """One rank of ``--tp N`` (a ring of N ranks) or ``--tp N --rings R``
    (the mesh fleet: R sub-rings of N): the model planned for one ring,
    this rank's slice of the tp=1 weights (seed 0) at its place in its
    ring, its engine or its fleet (on graphs over NCCL, eager over
    gloo), the batch (blocking, or through the front end on rank 0,
    which the others follow); rank 0 prints."""
    from repro_torch.core.rings import sub_ring
    from repro_torch.serving.frontend import AsyncFrontend
    from repro_torch.weights import init_shard
    args = _parser().parse_args(argv)
    dev = ring.device
    tp = args.tp
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = plan_model(cfg, ("model",), (tp,), "serve",
                      esl_overlap=not args.no_overlap, remat="none",
                      compute_dtype="float32", param_dtype="float32")
    fleet = fleet_of(args)
    mine = sub_ring(ring, tp)[1] if fleet else ring
    params = init_shard(cfg, plan, mine.rank, seed=0, device=dev)
    model = build_model(cfg, plan, dev)
    draft_model, draft_params = _draft(cfg, args, dev)
    prior = step_prior(cfg, tp, dev, args)
    kw = dict(device=dev, graphs=ring.nccl, draft_model=draft_model,
              draft_params=draft_params)
    if fleet:
        engine = MultiRingEngine(model, params, ring, ring_size=tp,
                                 config=_engine_config(args),
                                 step_prior_s=prior, **kw)
    else:
        engine = LPUEngine(model, params, _engine_config(args), mesh=ring,
                           **kw)
    prompts, sp = _batch(cfg, args)
    kernel = family_kernel(cfg)
    kernel.launches = 0
    mine.reset_counters()
    if not wants_frontend(args):
        outs = engine.generate(prompts, max_new_tokens=args.max_new,
                               params=sp)
    elif ring.rank == 0:
        outs = serve_async(engine, args, prompts, sp, prior)
    else:
        AsyncFrontend(engine).follow()
        outs = None
    launches = ring.gather_object(kernel.launches)
    cards = ring.gather_object(
        f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
        else str(dev))
    if ring.rank != 0:
        return outs
    mode = "ESL overlap" if plan.esl_overlap else "blocking"
    graphs = ("graphs on" if ring.nccl else
              f"graphs off: a {ring.backend} collective is not captured")
    if fleet:
        _print_fleet(engine, args, dev, kernel, outs, f"tp={tp} each")
        print(f"[serve] mesh fleet: {ring.size} ranks, {mode}, "
              f"{ring.backend} sub-rings, {graphs}")
        st = engine.local.stats
    else:
        st = engine.stats
        _print_engine(engine, cfg, args, dev, st, outs,
                      f"tp={tp} ({mode}, {ring.backend} ring, {graphs})",
                      kernel)
    print(f"[serve] ring: backend {ring.backend}, ranks on {cards}")
    steps = max(st.device_decode_steps, 1)
    c = mine.counters
    print(f"[serve] ring: {c['collectives']} collectives, "
          f"{c['hops']} ppermute hops, {c['staged_bytes']} host-staged "
          f"bytes on rank 0 ({c['collectives'] / steps:.1f} collectives "
          f"per decode step); {kernel.__name__} launches per rank "
          f"{launches}")
    if fleet:
        a = engine.agreement.counters
        print(f"[serve] fleet agreement: {a['rounds']} rounds, "
              f"{a['objects']} objects, {a['bytes']} bytes, "
              f"{a['seconds'] * 1e3 / max(a['rounds'], 1):.3f} host ms a "
              f"round on rank 0; world-ring collectives "
              f"{ring.counters['collectives']}")
    return outs


def _draft(cfg, args, dev):
    """(draft model, its params) for ``--speculate model``, else (None,
    None): its own small model, reduced smollm-135m seeded apart over
    the target's vocabulary, at tp 1 on ``dev`` (on the ring every rank
    holds it whole, so every rank drafts alike)."""
    if args.speculate != "model":
        return None, None
    dcfg = replace(get_config("smollm-135m").reduced(),
                   vocab_size=cfg.vocab_size)
    dplan = plan_model(dcfg, None, (1,), "serve", esl_overlap=False,
                       remat="none", compute_dtype="float32",
                       param_dtype="float32")
    draft_model = build_model(dcfg, dplan, dev)
    return draft_model, draft_model.init(seed=1)


def _batch(cfg, args):
    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size,
                                size=rng.randint(2, 10)))
               for _ in range(args.requests)]
    return prompts, SamplingParams(args.temperature, args.top_k, args.top_p)


def _engine_config(args) -> EngineConfig:
    return EngineConfig(slots=args.slots, max_seq=args.max_seq,
                        paged=False if args.dense else None,
                        block_size=args.block_size,
                        num_blocks=args.num_blocks,
                        kv_budget_bytes=args.kv_budget_mb << 20,
                        min_bucket=args.min_bucket,
                        paged_kernel=args.paged_kernel,
                        sampling=args.sampling,
                        steps_per_sync=args.steps_per_sync,
                        kv_dtype=args.kv_dtype,
                        prefill_chunk=args.prefill_chunk,
                        prefix_cache=args.prefix_cache == "on",
                        speculate=args.speculate, draft_k=args.draft_k,
                        chaos=args.chaos,
                        max_migrations=args.max_migrations,
                        heartbeat_timeout_s=args.heartbeat_timeout,
                        affinity=args.affinity,
                        budget_ms=args.budget_ms,
                        max_pending=args.max_pending)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--tp", type=int, default=1,
                    help="ESL ring width: ranks (processes) serving one "
                         "model tensor-parallel (dense, MoE, vlm, rwkv and "
                         "hybrid stacks)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="blocking collectives baseline (vs ESL overlap)")
    ap.add_argument("--shared-card", action="store_true",
                    help="with --tp N on CUDA: every rank on the one card "
                         "over gloo, steps eager (default: a card per "
                         "rank over NCCL, steps on CUDA graphs)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-slot KV cache")
    ap.add_argument("--block-size", type=int, default=0,
                    help="tokens per KV block (0 = min(128, max_seq))")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool size incl. null block "
                         "(0 = dense-equivalent capacity)")
    ap.add_argument("--kv-budget-mb", type=int, default=0,
                    help="KV budget in MiB (sizes the pool when "
                         "--num-blocks is 0)")
    ap.add_argument("--min-bucket", type=int, default=16,
                    help="smallest power-of-two prefill bucket")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=("auto", "stream", "gather"),
                    help="paged decode dataflow: stream KV tiles through "
                         "the paged kernel, gather the contiguous view "
                         "(oracle), or auto")
    ap.add_argument("--sampling", default="fused",
                    choices=("fused", "host"),
                    help="fused: sample on the device, only token ids "
                         "reach the host; host: per-token logits readback")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="decode steps per host sync (fused sampling only)")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=("auto", "float16", "bfloat16", "float32",
                             "int8", "fp8"),
                    help="KV pool storage precision: fp dtypes cast on "
                         "store; int8/fp8 quantize each row and kv head "
                         "with an f16 absmax scale (paged only)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: make prompts resident N "
                         "tokens per step, interleaved with decode "
                         "windows (paged only; 0 = monolithic bucketed "
                         "prefill)")
    ap.add_argument("--prefix-cache", default="off",
                    choices=("on", "off"),
                    help="prefix caching: admissions whose prompt hits "
                         "a cached block-aligned prefix map the shared "
                         "blocks (refcounted, copy-on-write) into their "
                         "table and prefill only the tail (paged only)")
    ap.add_argument("--speculate", default="off",
                    choices=("off", "ngram", "model"),
                    help="speculative decoding: draft k tokens per slot "
                         "(ngram: suffix match over the visible stream; "
                         "model: a reduced smollm-135m drafter), verify "
                         "them all in one forward and accept a "
                         "rejection-sampled prefix (paged only)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per speculative round")
    ap.add_argument("--rings", type=int, default=1,
                    help="rings of the fleet (> 1: the fleet): engines on "
                         "the one device over the same weights, or with "
                         "--tp N sub-rings of N ranks each (the mesh "
                         "fleet)")
    ap.add_argument("--chaos", default="",
                    help="deterministic fault injection: comma-separated "
                         "kind@step[:ring] with kinds ring|stall|nan|"
                         "corrupt (e.g. 'ring@3,nan@7:1'); forces the "
                         "supervised fleet")
    ap.add_argument("--max-migrations", type=int, default=3,
                    help="recompute-migrations per request before it "
                         "ends as a structured failure")
    ap.add_argument("--heartbeat-timeout", type=float, default=30.0,
                    help="ring liveness timeout in (virtual, under "
                         "chaos) seconds before drain/rebuild")
    ap.add_argument("--affinity", default="least_loaded",
                    choices=("least_loaded", "prefix"),
                    help="fleet routing: least-loaded, or the ring whose "
                         "prefix cache owns the prompt's deepest "
                         "block-aligned prefix (needs --prefix-cache on)")
    ap.add_argument("--budget-ms", type=float, default=0.0,
                    help="per-step latency budget (SLO): the async front "
                         "end retunes prefill_chunk / steps_per_sync "
                         "each step from a measured EWMA seeded by the "
                         "latency model's step-time prior (0 = off; "
                         "forces the async front end)")
    ap.add_argument("--max-pending", type=int, default=0,
                    help="front-end admission bound: in-flight streams "
                         "above it are rejected with a structured "
                         "AdmissionRejected (0 = unbounded; forces the "
                         "async front end)")
    ap.add_argument("--tracker", default="",
                    help="write per-window EngineStats deltas and "
                         "per-request TTFT / ms-per-token records to "
                         "this jsonl file (forces the async front end)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    refuse_encdec(cfg)
    if args.tp > 1:
        world = args.tp * (args.rings if fleet_of(args) else 1)
        placement = placement_of(args)
        if args.device != "cpu" and placement == "card_per_rank":
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if have < world:
                raise RuntimeError(
                    f"--tp {args.tp} x {world // args.tp} ring(s), a card "
                    f"per rank, needs {world} cards; this machine has "
                    f"{have}")
        return run_ranks(serve_rank, world, argv, device=args.device,
                         placement=placement)
    dev = resolve_device(args.device)
    if args.reduced:
        cfg = cfg.reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = model.init(seed=0)
    draft_model, draft_params = _draft(cfg, args, dev)
    econf = _engine_config(args)
    # the latency model's step time on the CPU (none on the card): each
    # ring's straggler monitor starts from it, and so does the front
    # end's step budget
    prior = step_prior(cfg, 1, dev, args)
    fleet = fleet_of(args)
    if fleet:
        engine = MultiRingEngine(model, params, None,
                                 rings=max(args.rings, 1), config=econf,
                                 step_prior_s=prior, device=dev,
                                 draft_model=draft_model,
                                 draft_params=draft_params)
    else:
        engine = LPUEngine(model, params, econf, device=dev,
                           draft_model=draft_model,
                           draft_params=draft_params)

    prompts, sp = _batch(cfg, args)
    kernel = family_kernel(cfg)
    kernel.launches = 0
    if wants_frontend(args):
        outs = serve_async(engine, args, prompts, sp, prior)
    else:
        outs = engine.generate(prompts, max_new_tokens=args.max_new,
                               params=sp)
    if fleet:
        _print_fleet(engine, args, dev, kernel, outs, "tp=1 each")
        return outs
    _print_engine(engine, cfg, args, dev, engine.stats, outs, "tp=1",
                  kernel)
    return outs


def _print_fleet(engine, args, dev, kernel, outs, tp_text):
    """The reference's fleet lines (per ring, routes, ``ft:``) and the
    family kernel's launches (this process's: on a mesh fleet rank 0's,
    its own ring's)."""
    print(f"[serve] {len(outs)} requests over {engine.n_rings} "
          f"sub-rings ({tp_text}), routed {engine.router.routed}, "
          f"{engine.tokens_per_s:.1f} tok/s over the fleet's wall, "
          f"device={dev}")
    for i, (eng, st) in enumerate(zip(engine.engines,
                                      engine.per_ring_stats())):
        print(f"[serve]   ring{i}: {st.tokens} tokens, "
              f"{st.tokens_per_s:.1f} tok/s, occ {st.occupancy:.2f}, "
              f"kv/rank {eng.per_rank_kv_bytes()} B")
    fc = engine.fleet_counters()
    print(f"[serve] ft: chaos={args.chaos or 'off'} "
          f"ring_failures={fc['ring_failures']} "
          f"migrated={fc['migrated_requests']} "
          f"retries={fc['retries']} "
          f"rejected={fc['rejected_requests']} "
          f"failed={fc['failed_requests']} "
          f"events={fc['events']}")
    st = engine.per_ring_stats()
    print(f"[serve] {kernel.__name__} kernel launches={kernel.launches} "
          f"(device decode steps "
          f"{sum(s.device_decode_steps for s in st)} over the rings)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}")


def _print_engine(engine, cfg, args, dev, st, outs, tp_text,
                  kernel=paged_decode_attention):
    """The reference's stats lines of one engine's run."""
    mode = f"paged/{engine.paged_kernel}" if engine.paged else "dense"
    print(f"[serve] {len(outs)} requests, {st.tokens} tokens, "
          f"{st.tokens_per_s:.1f} tok/s, occupancy {st.occupancy:.2f}, "
          f"{st.steps} decode steps, {tp_text}, device={dev}")
    print(f"[serve] kv={mode} dtype={engine.kv_dtype} "
          f"w_dtype={engine.w_dtype} bytes={engine.kv_cache_bytes()} "
          f"(per-rank {engine.per_rank_kv_bytes()}, "
          f"dense-equiv {engine.dense_equiv_bytes()}), "
          f"kv_moved/step={engine.kv_bytes_moved_per_step()}, "
          f"prefill traces={st.prefill_traces}, "
          f"preemptions={st.preemptions}")
    print(f"[serve] sampling={engine.sampling} "
          f"steps_per_sync={engine.steps_per_sync}: "
          f"{st.host_syncs} host syncs "
          f"({st.syncs_per_token:.2f}/token), "
          f"{st.bytes_to_host_per_token:.1f} B->host/token, "
          f"overrun={st.overrun_tokens}, "
          f"block_s={engine.decode_block_s()}, "
          f"graphs: {st.graph_captures} captured, {st.graph_replays} "
          "replays")
    print(f"[serve] prefill_chunk={engine.prefill_chunk}: "
          f"{st.prefill_chunks} chunks, decode_stalls={st.decode_stalls}")
    print(f"[serve] prefix_cache={args.prefix_cache}: "
          f"hit_rate={st.prefix_hit_rate:.2f} "
          f"({st.prefix_hits}/{st.prefix_lookups}), "
          f"hit_blocks={st.prefix_hit_blocks}, "
          f"prefill_tokens_saved={st.prefill_tokens_saved}, "
          f"cow={st.cow_blocks}, evicted={st.evicted_blocks}")
    print(f"[serve] speculate={engine.speculate} "
          f"draft_k={engine.draft_k}: {st.spec_rounds} rounds, "
          f"acceptance={st.acceptance_rate:.2f} "
          f"({st.accepted_tokens}/{st.draft_tokens}), "
          f"accepted/window={st.accepted_per_window:.2f}")
    if cfg.family == "hybrid":
        n_mamba = sum(not cfg.is_attention_layer(i)
                      for i in range(cfg.n_layers))
        print(f"[serve] {kernel.__name__} kernel launches={kernel.launches} "
              f"((device decode steps {st.device_decode_steps} + prefills "
              f"{st.prefills}) x {n_mamba} mamba layers)")
    else:
        print(f"[serve] {kernel.__name__} kernel launches={kernel.launches} "
              f"((device decode steps {st.device_decode_steps} + verify "
              f"rounds {st.spec_rounds} + prefill chunks and prefix tails)"
              f" x {cfg.n_layers} layers)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}")


if __name__ == "__main__":
    main()
