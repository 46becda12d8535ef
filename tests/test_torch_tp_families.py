"""The rwkv, hybrid (mamba + attention + MoE) and MoE families on the
model ring: gloo ranks on the CPU, each a spawned process with its
shards (tests/torch_tp_families_util.py), held to the reference at
tp=1.

* ``plan_model`` on the ring equals the reference's, field by field and
  in its ``summarize``, for granite, jamba, llama4 and rwkv6-7b (full
  and reduced) at tp 1, 2 and 4, and for a reduced MoE of 2 experts at
  tp 4 (``ffn_split`` 2: each expert's FFN split over two ranks).
* ``init_shard`` is bit-equal to ``shard_params(relayout(init_params))``
  for every family and rank, the experts rank-major.
* ``mamba_fwd``, ``time_mix_fwd`` / ``channel_mix_fwd`` and ``moe_fwd``
  (llama4's with its shared expert; the 2-expert MoE at tp 4), at tp 2
  and 4, in ESL overlap and in blocking, gathered from the ranks, are
  within 1e-5 of the reference's tp=1 layer on the same weights, their
  new states too.
* Greedy engine streams of reduced rwkv6-7b, jamba, granite and llama4
  at tp 2 (overlap and blocking) and tp 4 equal the reference engine's
  tp=1 streams, granite once under preemption (both preempt); rwkv and
  jamba with ``graphs=True`` on a gloo ring standing in for NCCL (the
  dense-state decode window as a program) equal their eager twins;
  each rank's state cache is its slice.
* The ring's remaining refusals (the giant MoE's data x model experts);
  the CLI's ``--tp 2 --arch jamba-v0.1-52b``.

Cost in one process ~3 min: three spawns of ranks (2, 4 and the CLI's
2, one torch thread each) and five reference engines.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.compiler.mapper import summarize as jax_summarize
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env as jax_axis_env
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models import rwkv as jax_rwkv
from repro.models.registry import build_model as jax_build_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model, summarize
from repro_torch.configs import get_config
from repro_torch.core.dist import AxisEnv, run_ranks
from repro_torch.launch import serve as serve_cli
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import init_params
from repro_torch.weights import (_leaves, init_shard, relayout,
                                 shard_params, tp1_plan)
from tests.torch_dense_util import (one_torch_thread,  # noqa: F401
                                    perturbed, reference_compile_cache)
from tests.torch_tp_families_util import families_rank, reduced_cfg

NAMES = ("rwkv6-7b", "jamba-v0.1-52b", "granite-moe-3b-a800m",
         "llama4-maverick-400b-a17b")
F32 = dict(remat="none", compute_dtype="float32", param_dtype="float32")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
MODES = {"overlap": True, "blocking": False}
MAX_NEW = 12
PROMPTS = [[int(t) for t in np.random.default_rng(1).integers(
    1, 512, size=n)] for n in (3, 9, 17, 6, 25, 2)]
RECURRENT = ("rwkv6-7b", "jamba-v0.1-52b")
CONFS = {"stream": dict(slots=3, max_seq=64, block_size=16),
         "dense": dict(slots=3, max_seq=64, paged=False),
         "preempt": dict(slots=3, max_seq=64, block_size=8, num_blocks=9,
                         steps_per_sync=4)}
# (name, conf) served by the reference at tp=1 and the port's rings
SERVED = {"rwkv6-7b": ("dense",), "jamba-v0.1-52b": ("dense",),
          "granite-moe-3b-a800m": ("stream", "preempt"),
          "llama4-maverick-400b-a17b": ("stream",)}
# the rings' runs: (tp, mode, conf) of each model
RUNS = {2: [(m, c) for m in MODES for c in ("dense", "stream")]
        + [("overlap", "preempt")],
        4: [("overlap", c) for c in ("dense", "stream")]
        + [("blocking", "dense")]}
# (block, layer) of each model's layer cases
LAYERS = {"jamba-v0.1-52b": (("l3", "mamba"), ("l1", "moe")),
          "rwkv6-7b": (("l0", "tmix"), ("l0", "cmix")),
          "granite-moe-3b-a800m": (("l0", "moe"),),
          "llama4-maverick-400b-a17b": (("l1", "moe"),)}
MOE2 = "granite-moe-3b-a800m"          # its reduced MoE cut to 2 experts


def _jcfg(name, n_experts=None):
    jcfg = jax_get_config(name).reduced()
    if n_experts:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_experts=n_experts))
    return jcfg


def _ref(name, n_experts=None):
    """(jcfg, jplan, jmodel, jax params, the numpy tree) of reduced
    ``name`` at tp=1, every bias redrawn non-zero."""
    jcfg = _jcfg(name, n_experts)
    jplan = jax_plan_model(jcfg, None, (1,), "serve", esl_overlap=False,
                           **F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    tree = perturbed(jax.tree.map(np.asarray, jparams))
    return jcfg, jplan, jmodel, jax.tree.map(jnp.asarray, tree), tree


@pytest.fixture(scope="module")
def refs():
    out = {n: _ref(n) for n in NAMES}
    out["moe2"] = _ref(MOE2, 2)
    return out


# ---------------------------------------------------------------------------
# plans and shards
# ---------------------------------------------------------------------------

PLAN_CASES = [(n, tp, None) for n in NAMES for tp in (1, 2, 4)] + \
    [(MOE2, 4, 2)]


@pytest.mark.parametrize("name,tp,n_experts", PLAN_CASES)
def test_plan_matches_reference(name, tp, n_experts):
    axes = None if tp == 1 else ("model",)
    for reduced in (False, True) if n_experts is None else (True,):
        cfg, jcfg = get_config(name), jax_get_config(name)
        if reduced:
            cfg, jcfg = reduced_cfg(name, n_experts), _jcfg(name, n_experts)
        for overlap in (True, False):
            mine = plan_model(cfg, axes, (tp,), "serve",
                              esl_overlap=overlap, **F32)
            ref = jax_plan_model(jcfg, axes, (tp,), "serve",
                                 esl_overlap=overlap, **F32)
            a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
            if tp == 1:          # the port keeps no rule table off a mesh
                a.pop("rules"), b.pop("rules")
            else:
                assert mine.rules == ref.rules
            assert a == b
            assert summarize(mine) == jax_summarize(ref)
            if n_experts:
                assert (mine.moe.ep, mine.moe.ffn_split,
                        mine.moe.experts_per_rank) == (2, 2, 1)


SHARD_CASES = [(n, tp, None) for n in NAMES for tp in (2, 4)] + \
    [(MOE2, 4, 2)]


@pytest.mark.parametrize("name,tp,n_experts", SHARD_CASES)
def test_init_shard_bit_equal_to_sliced_tree(name, tp, n_experts):
    cfg = reduced_cfg(name, n_experts)
    plan = plan_model(cfg, ("model",), (tp,), "serve", **F32)
    plan1 = tp1_plan(cfg, plan)
    tree1 = init_params(cfg, plan1, seed=3, device="cpu")
    full = relayout(tree1, cfg, plan1, plan)
    if cfg.moe is not None:
        # rank-major experts: rank l holds group l // split, part l % split
        w = full["blocks"][LAYERS.get(name, (("l0", "moe"),))[-1][0]][
            "moe"]["wg"]
        one = tree1["blocks"][LAYERS.get(name, (("l0", "moe"),))[-1][0]][
            "moe"]["wg"][:, 0]
        split, ecell = plan.moe.ffn_split, w.shape[2]
        ffh = w.shape[-1]
        for r in range(tp):
            g, h = divmod(r, split)
            assert torch.equal(w[:, r], one[:, g * ecell:(g + 1) * ecell, :,
                                          h * ffh:(h + 1) * ffh])
    for rank in range(tp):
        want = dict(_leaves(shard_params(full, plan, rank)))
        got = dict(_leaves(init_shard(cfg, plan, rank, seed=3,
                                      device="cpu")))
        assert list(got) == list(want)
        for path, t in want.items():
            assert got[path].dtype == t.dtype, path
            assert torch.equal(got[path], t), (name, tp, rank, path)


# ---------------------------------------------------------------------------
# the rings' runs
# ---------------------------------------------------------------------------

def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _state(jcfg, jplan, layer, B, seed):
    """A random decode carry of one layer at tp=1 (numpy)."""
    g = np.random.default_rng(seed)
    D = jcfg.d_model
    if layer == "mamba":
        m = jcfg.mamba
        d_in = m.expand * D
        return {"conv": g.standard_normal((B, m.d_conv - 1, d_in)).astype(
            np.float32), "ssm": (0.1 * g.standard_normal(
                (B, d_in, m.d_state))).astype(np.float32)}
    shift = g.standard_normal((B, 1, D)).astype(np.float32)
    if layer == "cmix":
        return {"shift": shift}
    hp, dh = jplan.attn.hp, jcfg.rwkv.head_dim
    return {"shift": shift, "wkv": (0.1 * g.standard_normal(
        (B, hp, dh, dh))).astype(np.float32)}


def _layer_cases(name, jcfg, jplan):
    """Each layer of ``name`` in both modes: the recurrences at S 5 and
    (decode) S 1 with a carried state, the MoE over 2 x 3 tokens."""
    out = []
    for block, layer in LAYERS.get(name, (("l0", "moe"),)):
        for S in ((3,) if layer == "moe" else (5, 1)):
            for mode, ov in MODES.items():
                st = None if layer == "moe" else _state(jcfg, jplan, layer,
                                                        2, S)
                out.append(dict(key=(block, layer, S, mode), layer=layer,
                                block=block, overlap=ov,
                                x=_x(2, S, jcfg.d_model, S), state=st))
    return out


def _ring_tasks(refs, tp):
    tasks = {}
    for name in NAMES:
        *_, tree = refs[name]
        jcfg, jplan = refs[name][:2]
        tasks["layers", name] = ("layers", dict(
            name=name, tree=tree, cases=_layer_cases(name, jcfg, jplan)))
        for mode, conf in RUNS[tp]:
            if conf not in SERVED[name]:
                continue
            tasks["serve", name, mode, conf] = ("serve", dict(
                name=name, overlap=MODES[mode], conf=CONFS[conf],
                prompts=PROMPTS, max_new=MAX_NEW, tree=tree))
        if tp == 2 and name in RECURRENT:
            # the dense-state decode window captured as on NCCL, beside
            # its eager twin (both over gloo's transport)
            for mode, ov in MODES.items():
                for graphs in (True, False):
                    tasks["nccl", name, mode, graphs] = ("serve", dict(
                        name=name, overlap=ov, conf=dict(
                            CONFS["dense"], steps_per_sync=4),
                        prompts=PROMPTS, max_new=MAX_NEW, tree=tree,
                        graphs=graphs, nccl=True))
    if tp == 4:
        jcfg, jplan, *_, tree = refs["moe2"]
        tasks["layers", "moe2"] = ("layers", dict(
            name=MOE2, tree=tree, n_experts=2,
            cases=_layer_cases("moe2", jcfg, jplan)))
    return tasks


@pytest.fixture(scope="module")
def rings(refs):
    return {tp: run_ranks(families_rank, tp, _ring_tasks(refs, tp),
                          device="cpu", threads=1) for tp in (2, 4)}


def _ref_layer(refs, which, case):
    """The reference's tp=1 layer on ``case`` (numpy out)."""
    jcfg, jplan, _, jparams, _ = refs[which]
    env = jax_axis_env(jplan)
    p = jax.tree.map(lambda t: t[0], jparams["blocks"][case["block"]])
    x = jnp.asarray(case["x"])
    st = ({k: jnp.asarray(v) for k, v in case["state"].items()}
          if case["state"] else None)
    kw = dict(cfg=jcfg, plan=jplan, env=env)
    layer = case["layer"]
    if layer == "mamba":
        y, new = jax_mamba.mamba_fwd(p["mamba"], x, state=st, **kw)
        return {"y": y, "state": new}
    if layer == "tmix":
        y, new = jax_rwkv.time_mix_fwd(p["tmix"], x, state=st, **kw)
        return {"y": y, "state": new}
    if layer == "cmix":
        y, new = jax_rwkv.channel_mix_fwd(p["cmix"], x, state=st["shift"],
                                          **kw)
        return {"y": y, "state": {"shift": new}}
    y, aux = jax_moe.moe_fwd(p["moe"], x, **kw)
    return {"y": y, "aux": aux}


LAYER_IDS = [(tp, n, b, l, S, m) for tp in (2, 4)
             for n in NAMES + (("moe2",) if tp == 4 else ())
             for b, l in LAYERS.get(n, (("l0", "moe"),))
             for S in ((3,) if l == "moe" else (5, 1)) for m in MODES]


@pytest.mark.parametrize("tp,name,block,layer,S,mode", LAYER_IDS)
def test_ring_layer_matches_reference_tp1(refs, rings, tp, name, block,
                                          layer, S, mode):
    jcfg, jplan = refs[name][:2]
    case = next(c for c in _layer_cases(name, jcfg, jplan)
                if c["key"] == (block, layer, S, mode))
    want = _ref_layer(refs, name, case)
    for r, res in enumerate(rings[tp]):
        got = res["layers", name][block, layer, S, mode]
        np.testing.assert_allclose(got["y"], np.asarray(want["y"]),
                                   err_msg=f"rank {r}", **LAYER_TOL)
        for k, v in (want.get("state") or {}).items():
            np.testing.assert_allclose(got["state"][k], np.asarray(v),
                                       err_msg=f"{k} rank {r}", **LAYER_TOL)
        if "aux" in want:
            np.testing.assert_allclose(got["aux"], float(want["aux"]),
                                       **LAYER_TOL)


@pytest.fixture(scope="module")
def tp1(refs):
    """{(name, conf): (the reference engine's streams, its preemptions)}."""
    out = {}
    for name, confs in SERVED.items():
        _, _, jmodel, jparams, _ = refs[name]
        for conf in confs:
            eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**CONFS[conf]))
            out[name, conf] = (eng.generate(PROMPTS, max_new_tokens=MAX_NEW),
                               eng.stats.preemptions)
    return out


SERVE_IDS = [(tp, n, m, c) for tp in (2, 4) for n in NAMES
             for m, c in RUNS[tp] if c in SERVED[n]]


@pytest.mark.parametrize("tp,name,mode,conf", SERVE_IDS)
def test_ring_streams_match_reference_tp1(rings, tp1, refs, tp, name, mode,
                                          conf):
    want, ref_pre = tp1[name, conf]
    jcfg, jplan = refs[name][:2]
    for r, res in enumerate(rings[tp]):
        got = res["serve", name, mode, conf]
        assert got["streams"] == want, (tp, name, mode, conf, r)
        assert got["launches"] == 0                 # the CPU: plain
        assert got["counters"]["staged_bytes"] == 0
        assert (got["counters"]["hops"] > 0) == (mode == "overlap")
        if conf == "preempt":
            assert ref_pre > 0 and got["preemptions"] > 0
        # each rank's state cache is its slice of the reference's
        for lj, shapes in got["cache_shapes"].items():
            if "wkv" in shapes:
                d = jcfg.d_model // (tp if mode == "overlap" else 1)
                assert shapes["wkv"][2] == jplan.attn.hp // tp
                assert shapes["shift_t"][-1] == shapes["shift_c"][-1] == d
            if "ssm" in shapes:
                d_in = jcfg.mamba.expand * jcfg.d_model // tp
                assert shapes["ssm"][2] == shapes["conv"][-1] == d_in


@pytest.mark.parametrize("name", RECURRENT)
@pytest.mark.parametrize("mode", list(MODES))
def test_nccl_window_graphs_match_eager_twin(rings, name, mode):
    """rwkv and jamba at tp 2 with graphs=True on a ring standing in for
    NCCL: the decode windows run as programs (on the CPU a program is
    the function it was built from; the exact-length prefill stays
    eager), the streams, decode steps and ring hops equal the eager
    twin's on every rank."""
    for r, res in enumerate(rings[2]):
        g, e = res["nccl", name, mode, True], res["nccl", name, mode, False]
        assert g["streams"] == e["streams"] == rings[2][0][
            "nccl", name, mode, True]["streams"], r
        assert g["device_decode_steps"] == e["device_decode_steps"] > 0
        assert g["counters"]["hops"] == e["counters"]["hops"]


# ---------------------------------------------------------------------------
# refusals, the CLI
# ---------------------------------------------------------------------------

def test_moe_data_model_raises_with_its_name():
    """The giant MoE's experts over data x model (``_moe_data_model``)
    run on a ``("data", "model")`` grid: without the rank's grid (a
    model ring's AxisEnv) they raise naming it; a serving plan on the
    grid spreads a giant MoE's experts over both axes, the batch over
    ``data``, and a train plan there raises naming FSDP."""
    cfg = get_config("granite").reduced()
    plan = plan_model(cfg, ("model",), (2,), "serve", **F32)
    plan = dataclasses.replace(plan, moe=dataclasses.replace(
        plan.moe, expert_axes=("data", "model")))
    with pytest.raises(ValueError, match="grid"):
        moe_mod.moe_fwd({}, torch.zeros((1, 1, cfg.d_model // 2)), cfg=cfg,
                        plan=plan, env=AxisEnv(object(), 2))
    grid = plan_model(get_config("llama4"), ("data", "model"), (2, 2),
                      "serve")
    assert grid.dp_axes == ("data",) and grid.tp == 2
    assert grid.moe.expert_axes == ("data", "model")
    assert grid.rules["experts"] == ("data", "model")
    with pytest.raises(NotImplementedError, match="FSDP"):
        plan_model(cfg, ("data", "model"), (2, 2), "train")


def test_cli_tp2_jamba_cpu(capfd):
    argv = ["--arch", "jamba-v0.1-52b", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "6"]
    one = serve_cli.main(argv)
    capfd.readouterr()
    two = serve_cli.main(argv + ["--tp", "2"])
    out = capfd.readouterr().out
    assert two == one
    assert "tp=2 (ESL overlap, gloo ring, graphs off" in out
    assert "mamba_scan_fused launches per rank [0, 0]" in out
