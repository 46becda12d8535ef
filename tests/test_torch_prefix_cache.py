"""The port's prefix cache and copy-on-write against the JAX reference:
a seeded replay of the block pool and the prefix index on both copies,
state equal after every operation, and the engine on the reduced
smollm-135m (f32, weights through ``params_from_jax``) with greedy
streams and prefix counters equal to the reference engine's with the
same knobs, and a balanced pool after every run."""
import jax
import numpy as np
import pytest

from repro.compiler.mapper import plan_model as jax_plan_model
from repro.configs import get_config as jax_get_config
from repro.models.registry import build_model as jax_build_model
from repro.serving import kv_cache as jax_kv
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.serving import kv_cache
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.weights import params_from_jax
from tests.torch_dense_util import one_torch_thread  # noqa: F401

SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")
VOCAB = 512     # smollm reduced()
COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_hit_blocks",
            "prefill_tokens_saved", "evicted_blocks", "cow_blocks",
            "preemptions")


def _shared_prompts(seed, sys_len, tails):
    """tests/test_prefix_cache.py's seeded system prompt + tails (seeds
    chosen there for robust greedy margins); the last prompt is the bare
    system prompt, so the n - 1 cap forces a tail into a shared block."""
    rng = np.random.RandomState(seed)
    sysp = list(map(int, rng.randint(1, VOCAB, size=sys_len)))
    return [sysp + list(map(int, rng.randint(1, VOCAB, size=n)))
            for n in tails] + [list(sysp)]


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


def _both(jax_setup, setup, prompts, max_new, **kw):
    """(port engine, its streams, reference streams, reference stats)
    for one knob set."""
    jmodel, jparams = jax_setup
    model, params = setup
    ref_eng = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw))
    ref = ref_eng.generate(prompts, max_new_tokens=max_new)
    eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
    got = eng.generate(prompts, max_new_tokens=max_new)
    eng.check_pool_balanced()
    for name in COUNTERS:
        assert getattr(eng.stats, name) == getattr(ref_eng.stats, name), name
    return eng, got, ref


# ---------------------------------------------------------------------------
# host side: the pool and the index, replayed against the reference
# ---------------------------------------------------------------------------

def _state(pool, index):
    return (list(pool.ref), list(pool._free), list(pool._lru),
            sorted(pool._cached), pool.num_free, pool.evicted_blocks,
            dict(index._by_hash), dict(index._by_block), index.lookups,
            index.hits, index.hit_blocks, index.tokens_saved)


def _call(fn, *a):
    try:
        return fn(*a)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_index_replay_matches_reference(seed):
    """One seeded sequence of alloc, share (live and parked blocks, and
    refused shares of free blocks), mark_cached, free (and refused double
    frees), touch, register, match with its pin, note_hit and peek —
    with allocations that drain the free list and evict from the LRU —
    applied to both copies: every result and the whole state (refcounts,
    free list, LRU order, cached set, evictions, index maps, counters)
    equal after every operation, and both balanced after the drain."""
    r = np.random.default_rng(seed)
    bs = 4
    pools = [kv_cache.BlockPool(10, bs), jax_kv.BlockPool(10, bs)]
    idx = [kv_cache.PrefixCache(pools[0]), jax_kv.PrefixCache(pools[1])]
    live = [[], []]                    # block lists each copy holds
    prompts = [list(map(int, r.integers(1, 6, size=n)))
               for n in (9, 12, 8, 5)]
    for _ in range(400):
        op = int(r.integers(0, 9))
        n = int(r.integers(0, 4))
        pick = int(r.integers(1 << 30))
        toks = list(prompts[pick % len(prompts)])
        toks = toks[:max(1, len(toks) - n)] + [int(t) for t in
                                               r.integers(1, 6, size=n)]
        res = []
        for k in range(2):
            pool, index = pools[k], idx[k]
            if op == 0:
                got = pool.alloc(n + 1)
                if got:
                    live[k].append(got)
                res.append(got)
            elif op == 1 and live[k]:
                res.append(pool.free(live[k].pop(pick % len(live[k]))))
            elif op == 2 and live[k]:
                blocks = live[k][pick % len(live[k])]
                pool.share(blocks)
                live[k].append(list(blocks))
                res.append(blocks)
            elif op == 3:
                # a block id that may be live, parked or free
                b = 1 + pick % (pool.num_blocks - 1)
                got = _call(pool.share, [b])
                if got is None:
                    live[k].append([b])
                res.append(got)
            elif op == 4 and live[k]:
                blocks = live[k][pick % len(live[k])]
                res.append(pool.mark_cached(blocks[0]))
            elif op == 5 and live[k]:
                res.append(index.register(toks,
                                          live[k][pick % len(live[k])]))
            elif op == 6:
                shared, cached = index.match(toks)
                if shared:
                    pool.share(shared)
                    index.note_hit(shared, cached)
                    live[k].append(list(shared))
                res.append((shared, cached))
            elif op == 7:
                res.append(index.peek(toks))
                pool.touch([1 + pick % (pool.num_blocks - 1)])
            else:
                res.append(_call(pool.free, [1 + pick % (pool.num_blocks
                                                         - 1)]))
                if res[-1] is None:   # a live reference went: forget one
                    b = 1 + pick % (pool.num_blocks - 1)
                    t = next(t for t in live[k] if b in t)
                    t.remove(b)
                    if not t:
                        live[k].remove(t)
        assert res[0] == res[1], (op, res)
        assert _state(pools[0], idx[0]) == _state(pools[1], idx[1]), op
    for k in range(2):
        for blocks in live[k]:
            pools[k].free(blocks)
    kv_cache.assert_pool_balanced(pools[0], idx[0])
    jax_kv.assert_pool_balanced(pools[1], idx[1])
    assert pools[0].evicted_blocks > 0
    assert idx[0].hits > 0


def test_block_pool_share_refcount_lru_and_eviction():
    """A cached block parks in the LRU at ref 0 (still counted free),
    revives on share, and is recycled only after the plain free list
    drains — on_evict once per block, LRU-oldest first."""
    evicted = []
    pool = kv_cache.BlockPool(num_blocks=5, block_size=8)
    pool.on_evict = evicted.append
    a, b = pool.alloc(2)
    pool.mark_cached(a)
    pool.mark_cached(b)
    pool.share([a])
    assert pool.ref[a] == 2
    pool.free([a])
    assert pool.ref[a] == 1
    pool.free([a, b])
    assert pool.num_free == 4
    pool.share([b])
    assert pool.ref[b] == 1 and pool.num_free == 3
    pool.free([b])
    got = pool.alloc(4)
    assert evicted == [a, b] and pool.evicted_blocks == 2
    assert a in got and b in got
    with pytest.raises(ValueError, match="share of free"):
        kv_cache.BlockPool(num_blocks=4, block_size=8).share([2])
    with pytest.raises(ValueError, match="mark_cached of free"):
        kv_cache.BlockPool(num_blocks=4, block_size=8).mark_cached(1)


def test_prefix_cache_match_register_eviction():
    """Full blocks hit in order, the cap leaves one tail token, a
    diverging block ends the chain, and eviction drops the entry."""
    pool = kv_cache.BlockPool(num_blocks=6, block_size=4)
    cache = kv_cache.PrefixCache(pool)
    toks = list(range(100, 111))
    blocks = pool.alloc(3)
    cache.register(toks, blocks)
    assert cache.match(toks[:8]) == (blocks[:2], 7)
    assert cache.peek(toks[:8]) == 7
    assert cache.match(toks + [1, 2]) == (blocks[:2], 8)
    assert cache.match(toks[:4] + [9, 9, 9, 9, 9]) == (blocks[:1], 4)
    assert cache.match([1, 2, 3]) == ([], 0)
    assert cache.lookups == 4
    pool.free(blocks)
    pool.alloc(4)
    assert pool.evicted_blocks == 1
    assert cache.match(toks) == ([], 0)
    with pytest.raises(AssertionError, match="leaked"):
        kv_cache.assert_pool_balanced(pool, cache)


def test_copy_pool_block_copies_every_leaf_in_place():
    import torch
    cache = {"l0": {"k": torch.randn(2, 5, 4, 3, 8),
                    "v": torch.randn(2, 5, 4, 3, 8)}}
    before = {k: v.clone() for k, v in cache["l0"].items()}
    leaf = cache["l0"]["k"]
    kv_cache.copy_pool_block(cache, 3, 1)
    assert cache["l0"]["k"] is leaf
    for k in "kv":
        got = cache["l0"][k]
        assert torch.equal(got[:, 1], before[k][:, 3])
        assert torch.equal(got[:, [0, 2, 3, 4]], before[k][:, [0, 2, 3, 4]])


# ---------------------------------------------------------------------------
# the engine: prefix hits are invisible in the streams
# ---------------------------------------------------------------------------

KW = dict(slots=3, max_seq=64, paged=True, block_size=16)


def test_prefix_on_matches_off(jax_setup, setup):
    """A 3-block system prompt shared by 4 requests (the last an exact
    block multiple): on equals off and the reference engine with the
    same knob, while the prefix run skips the resident prefill."""
    prompts = _shared_prompts(7, 48, (7, 5, 3))
    model, params = setup
    off = LPUEngine(model, params, EngineConfig(**KW), device="cpu")
    ref_off = off.generate(prompts, max_new_tokens=8)
    eng, got, ref = _both(jax_setup, setup, prompts, 8, prefix_cache=True,
                          **KW)
    assert got == ref == ref_off
    st = eng.stats
    assert st.prefix_hits >= 3 and st.prefix_hit_blocks >= 9
    assert st.prefill_tokens_saved >= 3 * 48 - 1
    assert 0 < st.prefix_hit_rate <= 1
    assert off.stats.prefix_hits == off.stats.prefill_tokens_saved == 0


def test_cow_on_concurrent_divergence(jax_setup, setup):
    """Two identical prompts at once share their blocks; the second's
    tail write into the shared last block copies it first, so neither
    stream is corrupted."""
    rng = np.random.RandomState(13)
    p = list(map(int, rng.randint(1, VOCAB, size=32)))
    kw = dict(slots=2, max_seq=64, paged=True, block_size=16)
    model, params = setup
    ref_off = LPUEngine(model, params, EngineConfig(**kw),
                        device="cpu").generate([p, p], max_new_tokens=8)
    eng, got, ref = _both(jax_setup, setup, [list(p), list(p)], 8,
                          prefix_cache=True, **kw)
    assert got == ref == ref_off
    assert eng.stats.cow_blocks >= 1
    assert eng.stats.prefill_tokens_saved > 0


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_composes_with_prefix(jax_setup, setup, chunk):
    """Chunked prefill with the prefix cache: only the un-cached tail is
    chunked, and the streams equal the monolithic cold run."""
    prompts = _shared_prompts(3, 48, (7, 5, 3))
    model, params = setup
    cold = LPUEngine(model, params, EngineConfig(**KW),
                     device="cpu").generate(prompts, max_new_tokens=8)
    eng, got, ref = _both(jax_setup, setup, prompts, 8, prefix_cache=True,
                          prefill_chunk=chunk, **KW)
    assert got == ref == cold
    assert eng.stats.prefill_tokens_saved > 0
    assert eng.stats.decode_stalls == 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_preemption_with_shared_blocks(jax_setup, setup, chunk):
    """Recompute preemption while shared blocks sit in several tables,
    under pool pressure that also evicts cold cached blocks: victims drop
    only their own references, every stream equals the dense run, and no
    reference leaks."""
    prompts = _shared_prompts(21, 16, (3, 5, 2, 4))
    model, params = setup
    dense = LPUEngine(model, params, EngineConfig(slots=3, max_seq=64,
                                                  paged=False),
                      device="cpu").generate(prompts, max_new_tokens=20)
    eng, got, ref = _both(jax_setup, setup, prompts, 20, slots=3,
                          max_seq=64, paged=True, block_size=8,
                          num_blocks=6, prefix_cache=True,
                          prefill_chunk=chunk)
    st = eng.stats
    assert st.preemptions > 0, "pool was meant to force preemption"
    assert st.prefix_hits > 0 and st.prefill_tokens_saved > 0
    assert st.evicted_blocks > 0
    assert got == ref == dense


def test_prefix_cache_requires_paged(setup):
    model, params = setup
    with pytest.raises(ValueError, match="paged"):
        LPUEngine(model, params, EngineConfig(slots=2, max_seq=64,
                                              paged=False,
                                              prefix_cache=True),
                  device="cpu")
