"""The port's dense configs beyond smollm-135m against the JAX
reference's: the paper's OPT and GPT3-20B models (qkv bias, learned
positions, layernorm with a bias, the ungated ReLU/GELU MLP with biases)
and the llama-style qwen1.5-4b (qkv bias), deepseek-coder-33b and
minicpm-2b.  Config and plan field for field, the init tree and laws,
the weight bridge's checks, logits of a prefill plus 8 decode steps on
the paged pool (stream and gather) and the dense cache, the C1 chain's
layers, and one bf16 case; every bias and ``pos_embed`` of the carried
weights is redrawn non-zero (``tests/torch_dense_util.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core import streamline as jax_sl
from repro.core.dist import make_axis_env
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import PAPER_MODELS, get_config
from repro_torch.core import streamline as sl
from repro_torch.models.common import init_params
from repro_torch.models.transformer import add_positional, layer_params
from repro_torch.serving import kv_cache
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import (BIAS_LEAVES, SERVE_BF16, SERVE_F32,
                                    one_torch_thread,  # noqa: F401
                                    perturbed, reduced_pair)

NAMES = ["opt-1.3b", "opt-6.7b", "gpt3-20b", "qwen1.5-4b",
         "deepseek-coder-33b", "minicpm-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)
LENS = (5, 11)
BUCKET, BS, MAX_SEQ, N_STEPS = 16, 8, 64, 8


def _pair(pkg_get, name, reduced):
    cfg = pkg_get(name)
    return cfg.reduced() if reduced else cfg


def test_registry_knows_every_dense_config():
    for name in NAMES + ["opt-30b", "opt-66b", "qwen", "deepseek",
                         "minicpm"]:
        get_config(name)
    assert set(PAPER_MODELS) == {"opt-1.3b", "opt-6.7b", "opt-30b",
                                 "opt-66b", "gpt3-20b"}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES + ["opt-30b", "opt-66b"])
def test_config_and_plan_match_reference(name, reduced):
    """Config and plan field for field (the plan's jax.sharding rule
    table excluded)."""
    mine, ref = _pair(get_config, name, reduced), \
        _pair(jax_get_config, name, reduced)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for kw in (SERVE_F32, {}):
        p = dataclasses.asdict(plan_model(mine, None, (1,), "serve", **kw))
        r = dataclasses.asdict(jax_plan_model(ref, None, (1,), "serve",
                                              **kw))
        p.pop("rules")
        r.pop("rules")
        assert p == r


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    else:
        yield path, tree


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_reference_tree_and_laws(name):
    """The port's init_params gives the reference's tree: leaf paths,
    shapes and dtypes; biases zero, norm scales one, and the std of
    every leaf of 16384 elements or more within 5% of the
    reference's."""
    jcfg = jax_get_config(name).reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    mine = dict(_leaves(init_params(cfg, plan, seed=0, device="cpu")))
    ref = {k: np.asarray(v) for k, v in _leaves(jparams)}
    assert set(mine) == set(ref)
    for path, r in ref.items():
        m = mine[path]
        assert tuple(m.shape) == r.shape, path
        assert str(m.dtype).split(".")[-1] == str(r.dtype), path
        leaf = path.split("/")[-1]
        if leaf in BIAS_LEAVES:
            assert not m.any() and not r.any(), path
        elif leaf == "scale":
            assert bool((m == 1).all()) and (r == 1).all(), path
        elif r.size >= 16384:
            rs, ms = float(r.std()), float(m.std())
            assert abs(ms / rs - 1) < 0.05, (path, ms, rs)
    if cfg.positional == "learned":
        std = float(mine["pos_embed"].std())
        assert abs(std * np.sqrt(cfg.max_seq) - 1) < 0.05


# ---------------------------------------------------------------------------
# the weight bridge
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_tree():
    jcfg = jax_get_config("opt-1.3b").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    cfg = get_config("opt-1.3b").reduced()
    return jax.tree.map(np.asarray, jparams), cfg, \
        plan_model(cfg, None, (1,), "serve", **SERVE_F32)


@pytest.mark.parametrize("leaf", ["pos_embed", "blocks/l0/attn/bq",
                                  "blocks/l0/mlp/bi", "blocks/l0/ln2/bias",
                                  "ln_f/bias"])
def test_bridge_checks_the_new_leaves(opt_tree, leaf):
    """A new leaf with the wrong shape is refused, and so is a tree
    without it."""
    tree, cfg, plan = opt_tree
    bad = jax.tree.map(lambda t: t, tree)
    *head, last = leaf.split("/")
    node = bad
    for k in head:
        node = node[k]
    node[last] = node[last][..., :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, cfg, plan, "cpu")
    del node[last]
    with pytest.raises(ValueError, match="lacks"):
        params_from_jax(bad, cfg, plan, "cpu")


def test_bridge_refuses_an_unknown_leaf(opt_tree):
    tree, cfg, plan = opt_tree
    bad = jax.tree.map(lambda t: t, tree)
    bad["blocks"]["l0"]["mlp"]["wg"] = bad["blocks"]["l0"]["mlp"]["wi"]
    with pytest.raises(ValueError, match="not a leaf"):
        params_from_jax(bad, cfg, plan, "cpu")
    bad = jax.tree.map(lambda t: t, tree)
    bad["head"] = bad["embed"].T
    with pytest.raises(ValueError, match="not a leaf"):
        params_from_jax(bad, cfg, plan, "cpu")


@pytest.mark.parametrize("name", ["smollm-135m", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_bridge_carries_the_earlier_families_unchanged(name):
    jcfg = jax_get_config(name).reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jparams, _ = jax_build_model(jcfg, jplan).init(jax.random.PRNGKey(0))
    cfg = get_config(name).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    tree = jax.tree.map(np.asarray, jparams)
    got = dict(_leaves(params_from_jax(tree, cfg, plan, "cpu")))
    want = dict(_leaves(tree))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), w, err_msg=path)


def test_positions_past_the_table_read_its_last_row():
    """add_positional never indexes past ``pos_embed`` (on the card that
    would be a device-side assert): a padded row's position past the
    table reads the last row."""
    cfg = get_config("opt-1.3b").reduced()
    pe = torch.randn(cfg.max_seq, 4)
    x = torch.zeros(1, 3, 4)
    pos = torch.tensor([[0, cfg.max_seq - 1, cfg.max_seq + 5]])
    y = add_positional({"pos_embed": pe}, x, pos, cfg)
    torch.testing.assert_close(y[0], pe[[0, -1, -1]])
    rope = get_config("qwen1.5-4b").reduced()
    assert add_positional({}, x, pos, rope) is x


# ---------------------------------------------------------------------------
# logits: prefill + 8 decode steps, paged (stream, gather) and dense
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return reduced_pair(request.param)


def _tokens():
    r = np.random.default_rng(0)
    prompts = [r.integers(1, 512, size=n).astype(np.int32) for n in LENS]
    steps = r.integers(1, 512, size=(N_STEPS, len(LENS))).astype(np.int32)
    return prompts, steps


def _tables():
    tables = np.zeros((len(LENS), MAX_SEQ // BS), np.int32)
    nxt = 1
    for b, n in enumerate(LENS):
        used = -(-(n + N_STEPS) // BS)
        tables[b, :used] = np.arange(nxt, nxt + used)
        nxt += used
    return tables, nxt


def _run_jax(ref, layout):
    jcfg, jplan, jmodel, jparams = ref
    env = make_axis_env(jplan)
    prompts, steps = _tokens()
    tables, n_blocks = _tables()
    paged = layout != "dense"
    cache = jmodel.init_cache(len(LENS), MAX_SEQ, paged=paged,
                              num_blocks=n_blocks, block_size=BS)
    prefill = jax.jit(lambda t: jmodel.forward(
        jparams, t, env=env, mode="prefill",
        cache=jmodel.init_cache(1, BUCKET),
        positions=jnp.arange(BUCKET)[None])[:2])
    rows = []
    for b, p in enumerate(prompts):
        buf = np.zeros((1, BUCKET), np.int32)
        buf[0, :len(p)] = p
        logits, pc = prefill(jnp.asarray(buf))
        rows.append(np.asarray(logits[0, len(p) - 1].astype(jnp.float32)))
        if paged:
            cache = jax_kv.scatter_prefill_pages(
                cache, pc, jnp.asarray(tables[b, :BUCKET // BS]))
        else:
            cache = jax_kv.scatter_prefill_dense(cache, pc, jnp.int32(b))
    out = [np.stack(rows)]
    pos = np.array(LENS, np.int32)
    fwd = jax.jit(lambda c, t, p: jmodel.forward(
        jparams, t, env=env, mode="decode", positions=p, cache=c,
        block_tables=jnp.asarray(tables) if paged else None,
        paged_kernel="stream" if layout == "stream" else "gather")[:2])
    for s in range(N_STEPS):
        logits, cache = fwd(cache, jnp.asarray(steps[s][:, None]),
                            jnp.asarray(pos + s))
        out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
    return out


def _run_port(port, layout):
    cfg, plan, model, params = port
    prompts, steps = _tokens()
    tables, n_blocks = _tables()
    paged = layout != "dense"
    cache = model.init_cache(len(LENS), MAX_SEQ, paged=paged,
                             num_blocks=n_blocks, block_size=BS)
    rows = []
    for b, p in enumerate(prompts):
        buf = np.zeros((1, BUCKET), np.int32)
        buf[0, :len(p)] = p
        logits, pc = model.forward(
            params, torch.from_numpy(buf), mode="prefill",
            cache=model.init_cache(1, BUCKET),
            positions=torch.arange(BUCKET)[None])
        rows.append(logits[0, len(p) - 1].float().numpy())
        if paged:
            kv_cache.scatter_prefill_pages(
                cache, pc, torch.from_numpy(tables[b, :BUCKET // BS]))
        else:
            kv_cache.scatter_prefill_dense(cache, pc, b)
    out = [np.stack(rows)]
    pos = np.array(LENS, np.int32)
    for s in range(N_STEPS):
        logits, _ = model.forward(
            params, torch.from_numpy(steps[s][:, None]), mode="decode",
            positions=torch.from_numpy(pos + s), cache=cache,
            block_tables=torch.from_numpy(tables) if paged else None,
            paged_kernel="stream" if layout == "stream" else "gather")
        out.append(logits[:, -1].float().numpy())
    return out


@pytest.mark.parametrize("layout", ["stream", "gather", "dense"])
def test_logits_match_reference(pair, layout):
    ref, port = pair
    want = _run_jax(ref, layout)
    got = _run_port(port, layout)
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {step}", **TOL)


def test_bf16_logits_match_reference():
    """Reduced opt-1.3b with bf16 weights and compute, paged stream."""
    ref, port = reduced_pair("opt-1.3b", SERVE_BF16)
    assert port[3]["blocks"]["l0"]["attn"]["bq"].dtype == torch.bfloat16
    for step, (g, w) in enumerate(zip(_run_port(port, "stream"),
                                      _run_jax(ref, "stream"))):
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2,
                                   err_msg=f"step {step}")


# ---------------------------------------------------------------------------
# the C1 chain on OPT and GPT3-20B layers, against the reference's
# core/streamline.py (its kernels in interpret mode)
# ---------------------------------------------------------------------------

CHAIN_TOL = dict(rtol=1e-5, atol=1e-5)
B, T = 2, 4
POS = np.array([5, 11], np.int32)


@pytest.fixture(scope="module", params=["opt-1.3b", "gpt3-20b"])
def layer(request):
    (jcfg, jplan, _, jparams), (cfg, plan, _, params) = \
        reduced_pair(request.param)
    r = np.random.default_rng(3)
    a = plan.attn
    pool = {k: r.standard_normal((2 * T + 1, BS, a.gp, a.d_head)).astype(
        np.float32) for k in "kv"}
    x = r.standard_normal((B, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, jplan=jplan,
                jp=jax.tree.map(lambda t: t[0], jparams["blocks"]["l0"]),
                cfg=cfg, plan=plan, p=layer_params(params, 0)["l0"],
                pool=pool, x=x)


def _pools(s):
    return ({k: torch.from_numpy(v.copy()) for k, v in s["pool"].items()},
            {k: jnp.asarray(v) for k, v in s["pool"].items()})


def _assert_pools(out, jout, rows=slice(None)):
    for key in "kv":
        np.testing.assert_allclose(out[key][rows].numpy(),
                                   np.asarray(jout[key])[rows], **CHAIN_TOL)


def test_chain_decode_layer_matches_reference(layer):
    s = layer
    pool, jpool = _pools(s)
    tables = np.arange(1, 2 * T + 1, dtype=np.int32).reshape(B, T)
    y, out = sl.decode_layer(
        s["p"], torch.from_numpy(s["x"]), pool, torch.from_numpy(POS),
        cfg=s["cfg"], plan=s["plan"], block_table=torch.from_numpy(tables),
        paged_kernel="stream")
    jy, jout = jax.jit(lambda p_, x_, c_, pos_, tb_: jax_sl.decode_layer(
        p_, x_, c_, pos_, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True, block_table=tb_, paged_kernel="stream"))(
        s["jp"], jnp.asarray(s["x"]), jpool, jnp.asarray(POS),
        jnp.asarray(tables))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **CHAIN_TOL)
    _assert_pools(out, jout)


def test_chain_chunk_prefill_layer_matches_reference(layer):
    s = layer
    pool, jpool = _pools(s)
    table = np.arange(1, T + 1, dtype=np.int32)
    C, start, n_valid = 4, 3, 3
    xs = np.concatenate([s["x"], s["x"][::-1] * 0.5])
    y, out = sl.chunk_prefill_layer(
        s["p"], torch.from_numpy(xs), pool, torch.from_numpy(table), start,
        n_valid, cfg=s["cfg"], plan=s["plan"], paged_kernel="stream")
    jy, jout = jax.jit(lambda *a: jax_sl.chunk_prefill_layer(
        *a, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True, paged_kernel="stream"))(
        s["jp"], jnp.asarray(xs), jpool, jnp.asarray(table),
        jnp.int32(start), jnp.int32(n_valid))
    assert xs.shape[0] == C
    np.testing.assert_allclose(y.numpy()[:n_valid],
                               np.asarray(jy)[:n_valid], **CHAIN_TOL)
    # block 0 takes the padded rows, in an order neither side fixes
    _assert_pools(out, jout, slice(1, None))


def test_chain_verify_layer_matches_reference(layer):
    s = layer
    pool, jpool = _pools(s)
    table = np.arange(1, T + 1, dtype=np.int32)
    Q = 3
    tabs = np.broadcast_to(table, (Q, T)).copy()
    posn = np.arange(6, 6 + Q, dtype=np.int32)
    xs = s["x"][np.arange(Q) % B] * np.arange(1, Q + 1)[:, None]
    y, out = sl.verify_layer(s["p"], torch.from_numpy(xs), pool,
                             torch.from_numpy(tabs), torch.from_numpy(posn),
                             cfg=s["cfg"], plan=s["plan"])
    jy, jout = jax.jit(lambda *a: jax_sl.verify_layer(
        *a, cfg=s["jcfg"], plan=s["jplan"], use_kernels=True,
        interpret=True))(s["jp"], jnp.asarray(xs), jpool,
                         jnp.asarray(tabs), jnp.asarray(posn))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **CHAIN_TOL)
    _assert_pools(out, jout)


def test_perturbed_weights_carry_every_bias(layer):
    """The chain tests run on non-zero biases (bq, bk, bv, bi, bd and the
    layernorms')."""
    p = layer["p"]
    for mod, leaf in (("attn", "bq"), ("attn", "bk"), ("attn", "bv"),
                      ("mlp", "bi"), ("mlp", "bd"), ("ln1", "bias"),
                      ("ln2", "bias")):
        assert float(p[mod][leaf].std()) > 0.01, (mod, leaf)
    assert perturbed({"bq": np.zeros(3)})["bq"].any()
