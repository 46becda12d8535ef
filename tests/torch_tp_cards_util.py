"""Rank functions of the tests of the ring on its own cards
(``tests/test_torch_tp_cards.py`` on the CPU, ``tests/test_torch_tp_cards_
cuda.py`` on 2 or more cards).

:func:`repro_torch.core.dist.run_ranks` spawns each rank as a fresh
process that imports the function it runs, so the functions live here,
at module level, importing nothing of JAX.  On the CPU a gloo ring can
stand in for NCCL (``as_nccl``): its ``backend`` then reads ``"nccl"``,
so the NCCL code of every collective runs over gloo's transport, and an
engine captures its programs as it does on an NCCL ring (on the CPU a
program is the function it was built from).
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

SERVE_F32 = dict(remat="none", compute_dtype="float32",
                 param_dtype="float32")
BIAS_LEAVES = ("bq", "bk", "bv", "bi", "bd", "bias")
REDRAW_SEED = 20


def redraw_std(cfg):
    """{leaf: std} of the leaves an OPT or GPT3 test model redraws
    non-zero (the init's biases are zero), as ``chip_smoke.py`` does."""
    return dict(dict.fromkeys(BIAS_LEAVES, 0.02),
                pos_embed=1.0 / math.sqrt(cfg.max_seq))


def tp1_tree(cfg, seed=0):
    """The tp=1 tree of reduced ``cfg`` on the CPU: ``init_params``, and
    for learned positions the redrawn biases and table."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.models.common import init_params
    from repro_torch.weights import redraw
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      **SERVE_F32)
    tree = init_params(cfg, plan, seed=seed, device="cpu")
    if cfg.positional == "learned":
        redraw(tree, redraw_std(cfg), REDRAW_SEED)
    return plan, tree


def shard(cfg, plan, rank, device, seed=0):
    """This rank's shard drawn alone: ``init_shard`` and, for learned
    positions, ``redraw_shard``."""
    from repro_torch.weights import init_shard, redraw_shard
    params = init_shard(cfg, plan, rank, seed=seed, device=device)
    if cfg.positional == "learned":
        redraw_shard(params, cfg, plan, rank, redraw_std(cfg), REDRAW_SEED)
    return params


@contextlib.contextmanager
def as_nccl(ring, on: bool):
    """The ring's backend read as ``"nccl"`` inside the block (``on``)."""
    was = ring.backend
    if on:
        ring.backend = "nccl"
    try:
        yield
    finally:
        ring.backend = was


def collectives(ring):
    """Every collective on a seeded tensor of this rank (and, on 4
    ranks, on the 2x2 sub-rings), as numpy, with the counters."""
    from repro_torch.core import dist
    n, dev = ring.size, ring.device
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(
        ring.rank)).to(dev)
    ring.reset_counters()
    out = {"psum": dist.psum(x, ring), "pmax": dist.pmax(x, ring),
           "pmean": dist.pmean(x, ring),
           "all_gather": dist.all_gather(x, ring, dim=-1),
           "all_gather0": dist.all_gather(x, ring, dim=0),
           "psum_scatter": dist.psum_scatter(x, ring, dim=-1),
           "ppermute_up": dist.ppermute(
               x, ring, [(i, (i + 1) % n) for i in range(n)]),
           "ppermute_down_async": dist.ppermute(
               x, ring, [(i, (i - 1) % n) for i in range(n)],
               async_op=True).wait(),
           "ppermute_0_to_1": dist.ppermute(x, ring, [(0, 1)])}
    if n == 4:
        groups = [[0, 1], [2, 3]]
        out["sub_psum"] = dist.psum(x, ring, groups=groups)
        out["sub_psum_scatter"] = dist.psum_scatter(x, ring, dim=-1,
                                                    groups=groups)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["counters"] = {k: v for k, v in ring.counters.items()
                       if k != "seconds"}
    return out


def serve(ring, name, overlap, conf, prompts, max_new, graphs):
    """Reduced ``name`` served by this rank's engine on its own shard:
    (streams, the ring's counters over the run, parameters gathered
    once, kernel 1 launches, graph replays)."""
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import \
        paged_decode_attention
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, ("model",), (ring.size,), "serve",
                      esl_overlap=overlap, **SERVE_F32)
    params = shard(cfg, plan, ring.rank, ring.device)
    ring._gathered.clear()
    eng = LPUEngine(build_model(cfg, plan, ring.device), params,
                    EngineConfig(**conf), mesh=ring, device=ring.device,
                    graphs=graphs)
    ring.reset_counters()
    paged_decode_attention.launches = 0
    streams = eng.generate(prompts, max_new_tokens=max_new)
    eng.check_pool_balanced()
    st = eng.stats
    return {"streams": streams,
            "counters": {k: v for k, v in ring.counters.items()
                         if k != "seconds"},
            "gathered": len(ring._gathered),
            "launches": paged_decode_attention.launches,
            "launches_want": cfg.n_layers * (st.device_decode_steps
                                             + st.prefill_chunks),
            "replays": st.graph_replays,
            "device_decode_steps": st.device_decode_steps,
            "prefill_chunks": st.prefill_chunks}


def cards_rank(ring, tasks):
    """Each task of ``tasks`` ({key: (kind, kwargs)}; kinds
    ``collectives`` and ``serve``, each with ``nccl``: run as an NCCL
    ring) on this rank; returns every rank's {key: result}."""
    out = {}
    for key, (kind, kw) in tasks.items():
        kw = dict(kw)
        with as_nccl(ring, kw.pop("nccl", False)):
            out[key] = (collectives(ring) if kind == "collectives"
                        else serve(ring, **kw))
    return ring.gather_object(out)


def assert_same(a, b, what=""):
    """Results of two runs equal: arrays bit for bit, the rest ==."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            assert_same(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, (what, a, b)
