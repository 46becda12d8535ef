"""The port's chunked prefill against the JAX reference on the reduced
smollm-135m (f32, weights carried across by ``params_from_jax``):
``chunk_prefill_attention`` (stream through the paged kernel's plain
version, and the gather oracle) and the engine's chunk interleave, whose
greedy streams must equal the reference engine's with the same knob and
the port's own monolithic run, with a balanced pool after every run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.core.dist import make_axis_env
from repro.models import attention as jax_attn
from repro.models.registry import build_model as jax_build_model
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import one_torch_thread  # noqa: F401

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
VOCAB = 512     # smollm reduced()
TOL = dict(rtol=1e-4, atol=1e-4)      # tests/test_kernels.py's f32 bound


def _prompts(seed, lengths):
    """tests/test_chunked_prefill.py's seeded prompts, chosen there for a
    top-2 greedy margin >= 5e-3 at every sampled step."""
    rng = np.random.RandomState(seed)
    return [list(map(int, rng.randint(1, VOCAB, size=n)))
            for n in lengths]


# 4 short prompts + one 39-token prompt (several chunks at every size)
PROMPTS = _prompts(11, (7, 5, 3, 4, 39))
KW = dict(slots=3, max_seq=64, paged=True, block_size=16)


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = jax_get_config("smollm-135m").reduced()
    jplan = jax_plan_model(jcfg, None, (1,), "serve", **SERVE_F32)
    jmodel = jax_build_model(jcfg, jplan)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


@pytest.fixture(scope="module")
def setup(jax_setup):
    _, jparams = jax_setup
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, plan,
                             "cpu")
    return model, params


@pytest.fixture(scope="module")
def mono_ref(setup):
    """The port's monolithic-prefill streams on the shared trace."""
    model, params = setup
    eng = LPUEngine(model, params, EngineConfig(**KW), device="cpu")
    return eng.generate(PROMPTS, max_new_tokens=8)


def _engine(setup, **kw):
    model, params = setup
    return LPUEngine(model, params, EngineConfig(**{**KW, **kw}),
                     device="cpu")


# ---------------------------------------------------------------------------
# the layer: chunk_prefill_attention against the reference's
# ---------------------------------------------------------------------------

# (start, C, n_valid): a chunk inside one block, one crossing two blocks
# with padded rows, one from position 0
CHUNKS = [(5, 8, 6), (13, 8, 8), (0, 8, 3)]


@pytest.mark.parametrize("mode", ["stream", "gather"])
@pytest.mark.parametrize("start,C,n_valid", CHUNKS)
def test_chunk_prefill_attention_matches_reference(jax_setup, setup, mode,
                                                   start, C, n_valid):
    """Same layer weights, pool, table and chunk through both packages:
    the attention output and every pool row within 1e-4."""
    jmodel, jparams = jax_setup
    model, params = setup
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    N, bs, T = 6, 8, 4
    r = np.random.default_rng(start + C)
    pool_k = r.standard_normal((N, bs, a.gp, a.d_head)).astype(np.float32)
    pool_v = r.standard_normal((N, bs, a.gp, a.d_head)).astype(np.float32)
    x = r.standard_normal((1, C, cfg.d_model)).astype(np.float32)
    table = np.array([[3, 1, 5, 0]], np.int32)
    positions = (start + np.arange(C, dtype=np.int32))[None]
    valid_len = start + n_valid

    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["l0"]["attn"])
    jout, jcache = jax_attn.chunk_prefill_attention(
        jp, jnp.asarray(x), cfg=jmodel.cfg, plan=jmodel.plan,
        env=make_axis_env(jmodel.plan, batch=1),
        positions=jnp.asarray(positions),
        cache={"k": jnp.asarray(pool_k), "v": jnp.asarray(pool_v)},
        block_table=jnp.asarray(table),
        kv_valid_len=jnp.int32(valid_len), paged_kernel=mode)

    p = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    cache = {"k": torch.from_numpy(pool_k.copy()),
             "v": torch.from_numpy(pool_v.copy())}
    out = attn.chunk_prefill_attention(
        p, torch.from_numpy(x), cfg=cfg, plan=plan,
        positions=torch.from_numpy(positions), cache=cache,
        block_table=torch.from_numpy(table),
        kv_valid_len=torch.tensor(valid_len, dtype=torch.int32),
        paged_kernel=mode)
    assert out.shape == (1, C, cfg.d_model)
    np.testing.assert_allclose(out[0, :n_valid].numpy(),
                               np.asarray(jout)[0, :n_valid], **TOL)
    for key in ("k", "v"):
        got = cache[key].numpy()
        np.testing.assert_allclose(got[1:], np.asarray(jcache[key])[1:],
                                   **TOL)
        # the null block took only the pad rows; the rest of the pool is
        # untouched outside the chunk's rows
        assert np.array_equal(got[2], (pool_k if key == "k" else pool_v)[2])


def test_chunk_prefill_refuses_quantized_pool(setup):
    """An int8 pool without its scale leaves is refused (its codes would
    be read as values); with them the chunk is quantized into the pool
    (the int8/fp8 cases against the reference are in
    tests/test_torch_quantized_kv.py)."""
    model, params = setup
    cfg, plan = model.cfg, model.plan
    a = plan.attn
    p = {k: v[0] for k, v in params["blocks"]["l0"]["attn"].items()}
    pool = {k: torch.zeros((4, 8, a.gp, a.d_head), dtype=torch.int8)
            for k in "kv"}
    args = dict(cfg=cfg, plan=plan,
                positions=torch.arange(4, dtype=torch.int32)[None],
                block_table=torch.tensor([[1, 2]], dtype=torch.int32),
                kv_valid_len=torch.tensor(4, dtype=torch.int32))
    x = torch.ones((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="scale"):
        attn.chunk_prefill_attention(p, x, cache=pool, **args)
    pool.update({k + "_scale": torch.zeros((4, 8, a.gp),
                                           dtype=torch.float16)
                 for k in "kv"})
    out = attn.chunk_prefill_attention(p, x, cache=pool, **args)
    assert torch.isfinite(out).all()
    assert (pool["k_scale"][1, :4] > 0).all() and \
        (pool["k_scale"][1, 4:] == 0).all()


# ---------------------------------------------------------------------------
# the engine: chunked == reference chunked == monolithic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [4, 16, 40])
def test_chunked_matches_reference_and_monolithic(jax_setup, setup,
                                                  mono_ref, chunk):
    """A sub-block chunk (4 < block 16), a block-aligned one (16) and one
    that crosses blocks mid-chunk (40), on a trace with a 39-token
    prompt: streams equal the reference engine's with the same knob and
    the port's monolithic run; one chunk trace, no stall."""
    jmodel, jparams = jax_setup
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(
        **KW, prefill_chunk=chunk)).generate(PROMPTS, max_new_tokens=8)
    eng = _engine(setup, prefill_chunk=chunk)
    got = eng.generate(PROMPTS, max_new_tokens=8)
    assert got == ref == mono_ref
    st = eng.stats
    assert st.decode_stalls == 0
    assert st.prefill_chunks > len(PROMPTS) or chunk >= 40
    assert st.prefill_traces == 1
    eng.check_pool_balanced()


VARIANTS = {
    "gather": dict(paged_kernel="gather"),
    "host-sampling": dict(sampling="host"),
    "s4-window": dict(steps_per_sync=4),
    "s4-no-pipeline": dict(steps_per_sync=4, pipeline=False),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_chunked_parity_variants(setup, mono_ref, name):
    """The chunk honours the engine's paged dataflow seam and the host
    sampling oracle, and interleaves with 4-step windows with and
    without the pipeline: prefilling slots are frozen null-block rows
    inside a window."""
    eng = _engine(setup, prefill_chunk=8, **VARIANTS[name])
    assert eng.generate(PROMPTS, max_new_tokens=8) == mono_ref
    eng.check_pool_balanced()


def test_chunked_parity_under_preemption(setup):
    """A pool too small for the working set preempts while prompts are
    chunk-prefilling; streams equal the roomy monolithic run."""
    prompts = _prompts(100, (7, 5, 3, 4))
    ref = _engine(setup).generate(prompts, max_new_tokens=10)
    eng = _engine(setup, block_size=8, num_blocks=4, prefill_chunk=4)
    got = eng.generate(prompts, max_new_tokens=10)
    assert eng.stats.preemptions > 0, "pool was meant to force preemption"
    assert got == ref
    eng.check_pool_balanced()


def test_mid_prefill_preemption_restarts_cleanly(setup):
    """The 40-token prompt, admitted first, is evicted while only part of
    it is resident (10 chunks of 4); it is re-chunked from scratch on
    re-admission, and both streams equal their runs alone."""
    long_prompt, short_prompt = _prompts(308, (40, 3))
    kw = dict(slots=2)
    ref0 = _engine(setup, **kw).generate([long_prompt], max_new_tokens=4)[0]
    ref1 = _engine(setup, **kw).generate([short_prompt],
                                         max_new_tokens=20)[0]
    eng = _engine(setup, slots=2, block_size=8, num_blocks=7,
                  prefill_chunk=4)
    r0 = eng.submit(long_prompt, max_new_tokens=4)
    r1 = eng.submit(short_prompt, max_new_tokens=20)
    got = eng.drain()
    assert eng.stats.preemptions > 0, "pool was meant to force preemption"
    assert eng.stats.prefill_chunks > 11
    assert got[r0] == ref0 and got[r1] == ref1
    eng.check_pool_balanced()


def test_prefill_chunk_requires_paged(setup):
    model, params = setup
    with pytest.raises(ValueError, match="paged"):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                              paged=False, prefill_chunk=8),
                  device="cpu")
    with pytest.raises(ValueError):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                              prefill_chunk=-1),
                  device="cpu")


# ---------------------------------------------------------------------------
# interleave: decode never stalls while a long prompt admits
# ---------------------------------------------------------------------------

def _stall_run(setup, prefill_chunk):
    """Two short streams decode; a 64-token prompt arrives after 3 steps.
    Returns (engine, streams, steps in which no short stream advanced)."""
    got = {}

    def cb(rid, tok):
        got.setdefault(rid, []).append(tok)

    p0, p1, p_long = _prompts(208, (3, 4, 64))
    eng = _engine(setup, max_seq=128, prefill_chunk=prefill_chunk)
    r0 = eng.submit(p0, max_new_tokens=40, stream_cb=cb)
    r1 = eng.submit(p1, max_new_tokens=40, stream_cb=cb)
    for _ in range(3):
        eng.step()
    r2 = eng.submit(p_long, max_new_tokens=4, stream_cb=cb)
    stalled = 0
    for _ in range(40):
        before = (len(got.get(r0, [])), len(got.get(r1, [])))
        eng.step()
        if (len(got.get(r0, [])), len(got.get(r1, []))) == before:
            stalled += 1
        if r2 in got:
            break
    eng.drain()
    eng.check_pool_balanced()
    return eng, [got[r] for r in (r0, r1, r2)], stalled


def test_decode_stall_regression(setup):
    """While the long prompt becomes resident chunk by chunk, every
    in-flight stream gains a token each step and ``decode_stalls`` stays
    0; the monolithic run stalls on the same trace; streams agree."""
    chunked, got_c, stalled_c = _stall_run(setup, 8)
    assert chunked.stats.decode_stalls == 0
    assert stalled_c == 0, \
        f"{stalled_c} steps produced no tokens on active streams"
    mono, got_m, _ = _stall_run(setup, 0)
    assert mono.stats.decode_stalls >= 1
    assert got_c == got_m


def test_decode_stalls_count_only_frozen_streams(setup):
    """A monolithic prefill with no other stream in flight froze nothing:
    one request alone, or requests admitted one at a time after the
    previous one finished, count no stall."""
    eng = _engine(setup)
    for p in PROMPTS[:3]:
        eng.generate([p], max_new_tokens=4)
    assert eng.stats.prefills == 3
    assert eng.stats.decode_stalls == 0
