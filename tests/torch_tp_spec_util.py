"""Rank functions of the tests of speculation and of the multimodal
stacks on the model ring (``tests/test_torch_tp_spec.py``,
``tests/test_torch_tp_multimodal.py`` on the CPU,
``tests/test_torch_tp_spec_cuda.py`` on 2 or more cards).

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, import nothing of JAX and take only picklable
arguments (numpy trees in the tp=1 layout, dicts of knobs).
:func:`spec_rank` runs several tasks per spawn.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")


def ring_model(ring, name, tree, overlap):
    """(cfg, plan, model, this rank's shards) of reduced ``name`` on the
    ring, on the rank's device: the tp=1 ``tree`` (numpy, the
    reference's layout) stored at the ring's layout and sliced, or (no
    tree) the shard drawn alone from seed 0 (``weights.init_shard``)."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.weights import (init_shard, params_from_jax, relayout,
                                     shard_params)
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, ("model",), (ring.size,), "serve",
                      esl_overlap=overlap, **SERVE_F32)
    dev = ring.device
    if tree is None:
        params = init_shard(cfg, plan, ring.rank, device=dev)
    else:
        plan1 = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                           **SERVE_F32)
        params = shard_params(relayout(params_from_jax(
            tree, cfg, plan1, dev), cfg, plan1, plan), plan, ring.rank)
    return cfg, plan, build_model(cfg, plan, dev), params


def draft_model(cfg, device):
    """The serve driver's draft model for ``cfg``: reduced smollm-135m
    over the target's vocabulary, seed 1, at tp 1 on ``device``."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    dcfg = dataclasses.replace(get_config("smollm-135m").reduced(),
                               vocab_size=cfg.vocab_size)
    dplan = plan_model(dcfg, None, (1,), "serve", esl_overlap=False,
                       **SERVE_F32)
    model = build_model(dcfg, dplan, device)
    return model, model.init(seed=1)


def serve_spec(ring, name, tree, overlap, scenarios, graphs=False):
    """Each scenario {key, prompts, max_new, conf} served by this rank's
    engine on the ring (``conf["speculate"]`` "model" gets the serve
    driver's draft model), its drafter's proposals recorded, after a
    warm-up request (on graphs: the captures); returns every rank's
    {key: (streams, counters)}, kernel 1's launches and what they should
    be counted over the served run."""
    from repro_torch.kernels import read_launches, reset_launches
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.drafter import ProposalLog
    from repro_torch.serving.engine import LPUEngine
    cfg, _, model, params = ring_model(ring, name, tree, overlap)
    out = {}
    for sc in scenarios:
        kw = {}
        if sc["conf"].get("speculate") == "model":
            kw = dict(zip(("draft_model", "draft_params"),
                          draft_model(cfg, ring.device)))
        eng = LPUEngine(model, params, EngineConfig(**sc["conf"]),
                        mesh=ring, device=ring.device, graphs=graphs, **kw)
        if graphs:
            eng.generate(sc["prompts"][:1], max_new_tokens=8)
            eng.stats = type(eng.stats)()
        rec = None
        if eng.drafter is not None:
            rec = eng.drafter = ProposalLog(eng.drafter)
        reset_launches()
        ring.reset_counters()
        streams = eng.generate(sc["prompts"], max_new_tokens=sc["max_new"])
        if ring.device.type == "cuda":
            torch.cuda.synchronize(ring.device)
        eng.check_pool_balanced()
        st = eng.stats
        tails = st.prefix_hits if eng.prefix is not None and \
            not eng.prefill_chunk else 0
        out[sc["key"]] = (streams, {
            "kernel1_want": cfg.n_layers * (
                st.device_decode_steps + st.spec_rounds + st.prefill_chunks
                + tails),
            "spec_rounds": st.spec_rounds, "draft_tokens": st.draft_tokens,
            "accepted_tokens": st.accepted_tokens,
            "preemptions": st.preemptions, "prefix_hits": st.prefix_hits,
            "prefill_chunks": st.prefill_chunks,
            "device_decode_steps": st.device_decode_steps,
            "host_syncs": st.host_syncs, "graph_replays": st.graph_replays,
            "launches": read_launches(),
            "collectives": ring.counters["collectives"],
            "staged_bytes": ring.counters["staged_bytes"],
            "proposals": rec.proposals if rec is not None else None})
    return ring.gather_object(out)


def verify_sharded(ring, cases):
    """Each case {logits (b, K+1, V), draft (b, K), temps, top_ks,
    top_ps (b,), seed, stochastic, repeat} through
    ``speculative_verify_sharded`` on this rank's vocab columns, every
    slot repeated ``repeat`` times, with a generator seeded ``seed``;
    returns every rank's [(out, n_acc)]."""
    from repro_torch.serving.sampler import speculative_verify_sharded
    res = []
    for c in cases:
        v = c["logits"].shape[-1]
        w = v // ring.size

        def t(a):
            return torch.from_numpy(a).repeat_interleave(c["repeat"], 0)
        loc = t(c["logits"][..., ring.rank * w:(ring.rank + 1) * w].copy())
        g = torch.Generator().manual_seed(c["seed"])
        out, n = speculative_verify_sharded(
            loc, t(c["draft"]), g, t(c["temps"]), t(c["top_ks"]),
            t(c["top_ps"]), c["stochastic"], ring, ring.size)
        res.append((out.numpy(), n.numpy()))
    return ring.gather_object(res)


def steps(ring, name, tree, overlap, tokens, extra, n_serve, max_seq):
    """The ring's ``build_prefill_step`` over ``tokens`` (B, S) with
    ``extra`` ({"frames"} or {"patch_embeds"}, numpy), then ``n_serve``
    serve steps, each fed the token before; then the logits (gathered
    whole) of a prefill and of decode steps fed the same tokens,
    through the model's forward with the rank's env.  Returns (every
    rank's tokens (B, n_serve + 1), rank 0's logits (B, 1 + n_serve,
    V_pad))."""
    from repro_torch.core import esl
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    cfg, plan, model, params = ring_model(ring, name, tree, overlap)
    dev = ring.device
    tok = torch.from_numpy(tokens).long().to(dev)
    kw = {k: torch.from_numpy(v).to(dev) for k, v in extra.items()}
    B, S = tok.shape
    n0 = S + (cfg.vlm.n_patches if "patch_embeds" in kw else 0)
    pre, meta = build_prefill_step(model, ring, B, max_seq)
    serve, _ = build_serve_step(model, ring, B, max_seq)
    env = meta["env"]
    cache = model.init_cache(B, max_seq, dtype=torch.float32)
    t, cache = pre(params, cache, tok, **kw)
    toks = [t]
    for i in range(n_serve):
        pos = torch.full((B,), n0 + i, dtype=torch.int32, device=dev)
        t, cache = serve(params, cache, toks[-1][:, None].long(), pos)
        toks.append(t)
    out = torch.stack(toks, 1)
    cache = model.init_cache(B, max_seq, dtype=torch.float32)
    with torch.no_grad():
        lg, _ = model.forward(params, tok, mode="prefill", cache=cache,
                              env=env, **kw)
        rows = [esl.gather_scattered(lg[:, -1:], axis=ring, tp=ring.size)]
        for i in range(n_serve):
            lg, _ = model.forward(
                params, out[:, i:i + 1].long(), mode="decode",
                positions=torch.full((B,), n0 + i, dtype=torch.int32,
                                     device=dev),
                cache=cache, env=env)
            rows.append(esl.gather_scattered(lg, axis=ring, tp=ring.size))
    logits = torch.cat(rows, 1).cpu().numpy()
    got = ring.gather_object(out.cpu().numpy())
    return got, logits


def spec_rank(ring, tasks):
    """Several tasks in one spawn: {key: (function name, kwargs)} with
    the functions of this module; returns {key: result}."""
    fns = {f.__name__: f for f in (serve_spec, verify_sharded, steps,
                                   kernel1_verify)}
    return {key: fns[fn](ring, **kw) for key, (fn, kw) in tasks.items()}


def counts(ids):
    vals, n = np.unique(np.asarray(ids), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, n)}


def kernel1_verify(ring, name, slots=4, k1=5, seed=0):
    """Kernel 1 on this rank's card at the verify shape of reduced
    ``name``'s rank heads (``slots`` x ``k1`` queries, a table each, a
    bf16 pool), against its plain version, outside any counted run:
    {max_abs_err, finite, shape}."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.kernels import held_launches
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.kernels.decode_attention.ref import \
        paged_decode_attention_ref
    cfg = get_config(name).reduced()
    a = plan_model(cfg, ("model",), (ring.size,), "serve").attn
    dev, dt, bs, T = ring.device, torch.bfloat16, 16, 4
    g = torch.Generator(device=dev).manual_seed(seed + ring.rank)
    Q = slots * k1
    q = torch.randn((Q, a.q_per_rank, a.d_head), generator=g,
                    device=dev).to(dt)
    kp, vp = (torch.randn((1 + slots * T, bs, a.kv_per_rank, a.d_head),
                          generator=g, device=dev).to(dt) for _ in range(2))
    tables = (1 + torch.arange(slots * T, dtype=torch.int32, device=dev)
              ).reshape(slots, T).repeat_interleave(k1, 0)
    start = torch.tensor([3, 17, 40, 58], device=dev)[:slots]
    lens = (start[:, None] + torch.arange(1, k1 + 1, device=dev)
            ).reshape(-1).to(torch.int32)
    with held_launches():
        got = paged_decode_attention(q, kp, vp, tables, lens)
    want = paged_decode_attention_ref(q, kp, vp, tables, lens)
    torch.cuda.synchronize(dev)
    return {"max_abs_err": (got.float() - want.float()).abs().max().item(),
            "finite": bool(torch.isfinite(got).all()),
            "shape": [Q, a.q_per_rank, a.kv_per_rank, a.d_head]}


def steps_tp1(name, tokens, extra, n_serve, max_seq, device):
    """:func:`steps`' tokens at tp 1 on ``device`` (the shard's weights:
    ``init_params`` seed 0), the reference for a ring drawn alone."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.models.registry import build_model
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      **SERVE_F32)
    model = build_model(cfg, plan, device)
    params = model.init(seed=0)
    tok = torch.from_numpy(tokens).long().to(device)
    kw = {k: torch.from_numpy(v).to(device) for k, v in extra.items()}
    B, S = tok.shape
    n0 = S + (cfg.vlm.n_patches if "patch_embeds" in kw else 0)
    pre, _ = build_prefill_step(model, None, B, max_seq)
    serve, _ = build_serve_step(model, None, B, max_seq)
    t, cache = pre(params, model.init_cache(B, max_seq,
                                            dtype=torch.float32), tok, **kw)
    toks = [t]
    for i in range(n_serve):
        pos = torch.full((B,), n0 + i, dtype=torch.int32, device=device)
        t, cache = serve(params, cache, toks[-1][:, None].long(), pos)
        toks.append(t)
    return torch.stack(toks, 1).cpu().numpy()
