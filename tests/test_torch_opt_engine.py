"""Greedy streams of the port's engine on the reduced opt-1.3b (qkv bias,
learned positions, layernorm with a bias, the ungated ReLU MLP with
biases) against the reference's ``LPUEngine`` on the same weights, every
bias and ``pos_embed`` redrawn non-zero (``tests/torch_dense_util.py``):
the paged pool streamed and gathered, a pool that preempts, chunked
prefill with the prefix cache, the int8 pool and n-gram speculation;
then the learned-position bound of the engine."""
import numpy as np
import pytest

from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import LPUEngine as JaxEngine
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from tests.torch_dense_util import one_torch_thread, reduced_pair  # noqa: F401

MAX_NEW = 16


def _prompts():
    r = np.random.default_rng(1)
    return [[int(t) for t in r.integers(1, 512, size=n)]
            for n in (3, 9, 17, 6, 25, 2)]


def _shared_prompts():
    """A 20-token system prompt ahead of each tail: the requests admitted
    after the first three hit its first block of 16."""
    r = np.random.default_rng(2)
    sys_prompt = [int(t) for t in r.integers(1, 512, size=20)]
    return [sys_prompt + [int(t) for t in r.integers(1, 512, size=n)]
            for n in (4, 11, 7, 9, 2)]


@pytest.fixture(scope="module")
def opt():
    return reduced_pair("opt-1.3b")


AXES = {
    "stream": (dict(block_size=16, paged_kernel="stream"), _prompts),
    "gather": (dict(block_size=16, paged_kernel="gather"), _prompts),
    "preempt": (dict(block_size=8, num_blocks=9, steps_per_sync=4),
                _prompts),
    "chunk8-prefix": (dict(block_size=16, prefill_chunk=8,
                           prefix_cache=True), _shared_prompts),
    "int8-pool": (dict(block_size=16, kv_dtype="int8"), _prompts),
    "ngram-k2": (dict(block_size=16, speculate="ngram", draft_k=2),
                 _prompts),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_greedy_streams_match_reference_engine(opt, axis):
    (_, _, jmodel, jparams), (_, _, model, params) = opt
    kw, prompts_fn = AXES[axis]
    kw = dict(slots=3, max_seq=64, **kw)
    prompts = prompts_fn()
    eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
    got = eng.generate(prompts, max_new_tokens=MAX_NEW)
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw)).generate(
        prompts, max_new_tokens=MAX_NEW)
    assert got == ref
    eng.check_pool_balanced()
    # equality means something only if the streams are not one token
    # repeated: at least 4 distinct tokens in all, and in some stream
    assert len(set().union(*got)) >= 4
    assert max(len(set(s)) for s in got) >= 4
    st = eng.stats
    if axis == "preempt":
        assert st.preemptions > 0
    if axis == "chunk8-prefix":
        assert st.prefill_chunks > 0 and st.prefix_hits > 0
    if axis == "ngram-k2":
        assert st.spec_rounds > 0 and st.accepted_tokens > 0


def test_engine_refuses_max_seq_past_the_position_table(opt):
    (_, _, _, _), (cfg, _, model, params) = opt
    with pytest.raises(ValueError, match="position table"):
        LPUEngine(model, params, EngineConfig(
            slots=2, max_seq=2 * cfg.max_seq), device="cpu")
    LPUEngine(model, params, EngineConfig(slots=2, max_seq=cfg.max_seq),
              device="cpu")


def test_positions_stay_inside_the_table_to_the_max_seq_rule(opt):
    """max_seq = the table's 128 rows; a prompt of 100 tokens asking for
    64 more ends on the max_seq rule inside a 4-step window.  Every
    position the engine passes (every prefill and decode row) stays
    below max_seq, and the stream equals the reference engine's, whose
    lookup would fill NaN past the table."""
    (_, _, jmodel, jparams), (cfg, _, model, params) = opt
    seen = []
    forward = model.forward

    def spy(params_, tokens, *, mode, positions=None, **kw):
        if positions is not None:
            seen.append((mode, int(positions.max())))
        return forward(params_, tokens, mode=mode, positions=positions,
                       **kw)
    model.forward = spy
    try:
        kw = dict(slots=2, max_seq=cfg.max_seq, block_size=16,
                  steps_per_sync=4)
        r = np.random.default_rng(3)
        prompts = [[int(t) for t in r.integers(1, 512, size=n)]
                   for n in (100, 5)]
        eng = LPUEngine(model, params, EngineConfig(**kw), device="cpu")
        got = eng.generate(prompts, max_new_tokens=64)
    finally:
        del model.forward
    ref = JaxEngine(jmodel, jparams, JaxEngineConfig(**kw)).generate(
        prompts, max_new_tokens=64)
    assert got == ref
    # the long request stopped on the max_seq rule, not its budget
    assert len(prompts[0]) + len(got[0]) == cfg.max_seq
    # the slot freezes at pos = max_seq - 1 and the window's later steps
    # rewrite that row: the table's last row, never past it
    decode = [p for mode, p in seen if mode == "decode"]
    assert decode and max(decode) == cfg.max_seq - 1
    assert max(p for _, p in seen) < cfg.max_seq
    eng.check_pool_balanced()
