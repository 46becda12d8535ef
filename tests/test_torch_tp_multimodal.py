"""whisper-tiny's encoder-decoder and llava-next-34b's patches on the
model ring, through the ring form of ``repro_torch/core/steps.py``:
gloo ranks on the CPU, each a spawned process with its shards and its
dense cache (tests/torch_tp_spec_util.py), held to the reference at
tp=1 (f32, reduced, every bias and the learned positions redrawn
non-zero by ``tests/torch_dense_util.py``).

* ``build_prefill_step`` over 4-token prompts (with 16 frames, or 8
  patch embeddings before the text), then 6 ``build_serve_step`` steps:
  at tp 2 (ESL overlap and blocking) and tp 4 every rank's tokens equal
  the reference's ``build_prefill_step`` / ``build_serve_step`` at
  ``mesh=None`` (jitted) on the same weights, and the logits of the
  same prefill and decode steps, gathered from the ranks, are within
  1e-5 of the reference's.
* ``init_shard`` (each rank's shard drawn alone) is bit-equal to
  ``shard_params`` of the tp=1 tree at the ring's layout for every leaf
  of both (llava's projector, whisper's encoder, decoder, ``lnx``,
  ``xattn``, ``ln_enc``), ``redraw_shard`` too; at tp 4 whisper's pad
  heads (reduced: 2 heads padded to 4; whole: 6 padded to 8) have zero
  q/k/v columns, biases and output rows in every attention.

Cost in one process ~30 s: two spawns of ranks (2 and 4, one torch
thread each) and the reference's jitted steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dist import make_axis_env as jax_axis_env
from repro.core.steps import build_prefill_step as jax_build_prefill_step
from repro.core.steps import build_serve_step as jax_build_serve_step
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core.dist import run_ranks
from repro_torch.models.common import init_params
from repro_torch.weights import (_leaves, init_shard, redraw, redraw_shard,
                                 relayout, shard_params, tp1_plan)
from tests.torch_dense_util import (BIAS_LEAVES, BIAS_STD,  # noqa: F401
                                    one_torch_thread, reduced_pair)
from tests.torch_tp_spec_util import SERVE_F32, spec_rank

NAMES = ("whisper-tiny", "llava-next-34b")
B, S, MAX, N_SERVE = 2, 4, 32, 6
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
RUNS = {2: (True, False), 4: (True,)}


@pytest.fixture(scope="module")
def pairs():
    return {name: reduced_pair(name) for name in NAMES}


def _inputs(cfg):
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.family == "encdec":
        extra = {"frames": (0.1 * rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)}
    else:
        extra = {"patch_embeds": (0.1 * rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim))
        ).astype(np.float32)}
    return toks, extra


@pytest.fixture(scope="module")
def reference(pairs):
    """{name: (tokens (B, 1 + N_SERVE), logits (B, 1 + N_SERVE, V_pad))}
    of the reference's jitted steps at mesh=None, and its forward's
    logits of the same prefill and decode steps."""
    out = {}
    for name, ((_, jplan, jmodel, jparams), (cfg, _, _, _)) in pairs.items():
        toks, extra = _inputs(cfg)
        jx = {k: jnp.asarray(v) for k, v in extra.items()}
        n0 = S + (cfg.vlm.n_patches if cfg.vlm is not None else 0)
        pre, _ = jax_build_prefill_step(jmodel, None, B, MAX)
        serve, _ = jax_build_serve_step(jmodel, None, B, MAX)
        pre, serve = jax.jit(pre), jax.jit(serve)
        jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
        t, jc = pre(jparams, jc, jnp.asarray(toks), **jx)
        got = [np.asarray(t)]
        for i in range(N_SERVE):
            pos = jnp.full((B,), n0 + i, jnp.int32)
            t, jc = serve(jparams, jc, t[:, None], pos)
            got.append(np.asarray(t))
        got = np.stack(got, 1)
        env = jax_axis_env(jplan, batch=B)
        jc = jmodel.init_cache(B, MAX, dtype=jnp.float32)
        lg, jc, _ = jmodel.forward(jparams, jnp.asarray(toks), env=env,
                                   mode="prefill", cache=jc, **jx)
        rows = [np.asarray(lg[:, -1:])]
        for i in range(N_SERVE):
            lg, jc, _ = jmodel.forward(
                jparams, jnp.asarray(got[:, i:i + 1]), env=env,
                mode="decode", positions=jnp.full((B,), n0 + i, jnp.int32),
                cache=jc)
            rows.append(np.asarray(lg))
        out[name] = (got, np.concatenate(rows, 1))
    return out


@pytest.fixture(scope="module")
def rings(pairs):
    """{tp: rank 0's {(name, overlap): (every rank's tokens, logits)}}."""
    out = {}
    for tp, modes in RUNS.items():
        tasks = {}
        for name, ((_, _, _, jparams), (cfg, _, _, _)) in pairs.items():
            toks, extra = _inputs(cfg)
            for ov in modes:
                tasks[name, ov] = ("steps", dict(
                    name=name, tree=jax.tree.map(np.asarray, jparams),
                    overlap=ov, tokens=toks, extra=extra, n_serve=N_SERVE,
                    max_seq=MAX))
        out[tp] = run_ranks(spec_rank, tp, tasks, device="cpu", threads=1)
    return out


CASES = [(tp, ov, name) for tp, modes in RUNS.items() for ov in modes
         for name in NAMES]


@pytest.mark.parametrize("tp,overlap,name", CASES)
def test_ring_steps_give_the_reference_tokens(rings, reference, tp,
                                              overlap, name):
    want, _ = reference[name]
    per_rank, _ = rings[tp][name, overlap]
    assert len(per_rank) == tp
    for got in per_rank:
        np.testing.assert_array_equal(got, want)
    assert len(set(want.ravel().tolist())) >= 3


@pytest.mark.parametrize("tp,overlap,name", CASES)
def test_ring_logits_within_1e5(rings, reference, tp, overlap, name):
    _, want = reference[name]
    _, got = rings[tp][name, overlap]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def _plans(name, tp, full=False):
    cfg = get_config(name)
    cfg = cfg if full else cfg.reduced()
    plan = plan_model(cfg, ("model",), (tp,), "serve", **SERVE_F32)
    return cfg, plan, tp1_plan(cfg, plan)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("tp", [2, 4])
def test_init_shard_bit_equal_to_sliced_tree(name, tp):
    """Every leaf of every rank's shard drawn alone equals the tp=1
    tree at the ring's layout, sliced; the biases and positions redrawn
    by ``redraw_shard`` equal ``redraw``'s, sliced."""
    cfg, plan, plan1 = _plans(name, tp)
    std = dict(dict.fromkeys(BIAS_LEAVES, BIAS_STD), pos_embed=0.1)
    full = init_params(cfg, plan1, seed=3, device="cpu")
    redraw(full, std, 20)
    full = relayout(full, cfg, plan1, plan)
    for rank in range(tp):
        want = dict(_leaves(shard_params(full, plan, rank)))
        got = init_shard(cfg, plan, rank, seed=3, device="cpu")
        redraw_shard(got, cfg, plan, rank, std, 20)
        got = dict(_leaves(got))
        assert list(got) == list(want)
        for path, t in want.items():
            assert torch.equal(got[path], t), (name, tp, rank, path)
    if cfg.vlm is not None:
        assert want["projector"].shape == (cfg.vlm.patch_embed_dim,
                                           cfg.d_model // tp)


def _pad_heads_zero(cfg, plan, rank, shard):
    """The rank's pad q heads (``q_orig`` -1) and pad kv heads: zero
    columns of wq/wk/wv and their biases, zero rows of wo, in the
    encoder's and the decoder's self- and cross-attention.  Returns how
    many pad heads the rank holds."""
    a = plan.attn
    qpr, kpr = a.q_per_rank, a.kv_per_rank
    q_pad = [i for i in range(qpr) if a.q_orig[rank * qpr + i] < 0]
    kv_pad = [i for i in range(kpr) if a.kv_orig[rank * kpr + i] < 0]
    for stack, owner in (("enc_blocks", "attn"), ("dec_blocks", "attn"),
                         ("dec_blocks", "xattn")):
        p = shard[stack][owner]
        for i in q_pad:
            for t in (p["wq"][:, :, i], p["bq"][:, i], p["wo"][:, i]):
                assert not t.any(), (stack, owner, i)
        for i in kv_pad:
            for k in ("wk", "wv"):
                assert not p[k][:, :, i].any()
            for k in ("bk", "bv"):
                assert not p[k][:, i].any()
    return len(q_pad) + len(kv_pad)


@pytest.mark.parametrize("full", [False, True])
def test_whisper_pad_heads_are_zero_at_tp4(full):
    """Reduced whisper (2 heads padded to 4) on every rank, and whole
    whisper-tiny (6 heads padded to 8) on its last rank, which holds
    both pad heads: their weights are zero, so they add nothing."""
    cfg, plan, _ = _plans("whisper-tiny", 4, full)
    ranks = [3] if full else range(4)
    pads = 0
    for rank in ranks:
        shard = init_shard(cfg, plan, rank, seed=0, device="cpu")
        redraw_shard(shard, cfg, plan, rank,
                     dict.fromkeys(BIAS_LEAVES, BIAS_STD), 20)
        pads += _pad_heads_zero(cfg, plan, rank, shard)
    assert pads == (4 if full else 2)
