"""The engine's captured programs on the card against its eager twin
(``graphs=False``): decode windows, verify rounds, monolithic prefills,
prefill chunks, prefix tails, the first-token sampler and the
copy-on-write block copy; reduced smollm-135m (paged pool streamed and
gathered, the dense cache, n-gram speculation, sampled streams, chunks,
the prefix cache), opt-1.3b, rwkv6-7b and jamba, random weights from
seed 0.

Streams, every counter but the wall clock, and the kernels' launch
counts must be equal; the graph run must have captured and replayed,
one capture per program key, and every admission program it built must
have replayed.
Sampled streams are equal too: the warm-up restores the generator, and
a replay draws the Philox numbers the eager ops would.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test, never at import).  On a machine with a card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_graphs.py``.
"""
import pytest
import torch

from repro_torch import kernels
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.models.common import init_params
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.serving.sampler import SamplingParams

pytestmark = pytest.mark.cuda

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11],
           [3, 1, 4, 1, 5, 9, 2, 6], [2, 7], [5, 6, 5, 6, 5, 6, 5, 6]]
# a 16-token system prompt (two blocks of 8) served alone first, then
# prompts that share it: tails of 3 and 5 tokens, and the bare prompt,
# whose 1-token tail copies a shared block on write
SYS = [int(t) for t in range(40, 56)]
SHARED = [SYS + [7, 8, 9], SYS + [1, 2, 3, 4, 5], list(SYS)]
SERVE_F32 = dict(esl_overlap=False, remat="none", compute_dtype="float32",
                 param_dtype="float32")

CASES = {
    "smollm-stream-s4": ("smollm-135m", dict(block_size=16,
                                             steps_per_sync=4), None),
    "smollm-gather-s8": ("smollm-135m", dict(block_size=16,
                                             paged_kernel="gather",
                                             steps_per_sync=8), None),
    "smollm-dense-s4": ("smollm-135m", dict(paged=False, steps_per_sync=4),
                        None),
    "smollm-preempt-s4": ("smollm-135m", dict(block_size=8, num_blocks=7,
                                              steps_per_sync=4), None),
    "smollm-ngram-k3": ("smollm-135m", dict(block_size=16,
                                            speculate="ngram", draft_k=3),
                        None),
    "smollm-sampled-s4": ("smollm-135m", dict(block_size=16,
                                              steps_per_sync=4),
                          SamplingParams(0.8, 20, 0.9)),
    "opt-s8": ("opt-1.3b", dict(block_size=16, steps_per_sync=8), None),
    "rwkv-s4": ("rwkv6-7b", dict(steps_per_sync=4), None),
    "jamba-s4": ("jamba", dict(steps_per_sync=4), None),
    "smollm-chunk5-s4": ("smollm-135m", dict(block_size=8, prefill_chunk=5,
                                             steps_per_sync=4), None),
    "smollm-prefix-cow": ("smollm-135m", dict(block_size=8,
                                              prefix_cache=True), None),
    "smollm-chunk8-prefix": ("smollm-135m", dict(block_size=8,
                                                 prefill_chunk=8,
                                                 prefix_cache=True), None),
    "smollm-host-sampling": ("smollm-135m", dict(block_size=16,
                                                 sampling="host"), None),
}
# the admission programs each run must have built and replayed (default:
# the monolithic prefill and the first-token sampler; a recurrent
# stack's exact-length prefill stays eager)
ADMISSION = {"smollm-chunk5-s4": ("chunk", "sample"),
             "smollm-prefix-cow": ("prefill", "chunk", "sample", "cow"),
             "smollm-chunk8-prefix": ("chunk", "sample", "cow"),
             "smollm-host-sampling": ("prefill", "host_decode"),
             "rwkv-s4": ("sample",), "jamba-s4": ("sample",)}


KERNEL = {"smollm-135m": {"paged_decode_attention"},
          "opt-1.3b": {"paged_decode_attention"}, "rwkv6-7b": {"rwkv_scan"},
          "jamba": {"mamba_scan_fused"}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs capture only there)")
    return torch.device("cuda")


def _serve(dev, arch, kw, params_s, graphs):
    cfg = get_config(arch).reduced()
    plan = plan_model(cfg, None, (1,), "serve", **SERVE_F32)
    model = build_model(cfg, plan, dev)
    params = init_params(cfg, plan, seed=0, device=dev)
    eng = LPUEngine(model, params, EngineConfig(slots=3, max_seq=64, **kw),
                    device=dev, graphs=graphs, seed=1)
    kernels.reset_launches()
    prompts = PROMPTS
    if kw.get("prefix_cache"):
        eng.generate([SYS], max_new_tokens=2)
        prompts = SHARED
    out = eng.generate(prompts, max_new_tokens=24, params=params_s)
    torch.cuda.synchronize()
    return out, eng, kernels.read_launches()


@pytest.mark.parametrize("case", list(CASES))
def test_captured_programs_match_eager_twin(dev, case):
    arch, kw, params_s = CASES[case]
    got, eng, launches = _serve(dev, arch, kw, params_s, graphs=True)
    eager, twin, twin_launches = _serve(dev, arch, kw, params_s,
                                        graphs=False)
    assert got == eager
    st, tw = dict(vars(eng.stats)), dict(vars(twin.stats))
    for k in ("wall", "graph_captures", "graph_replays"):
        st.pop(k)
        tw.pop(k)
    assert st == tw
    # the kernel the path runs launched, and only it (the gather oracle
    # and the dense cache attend in plain PyTorch)
    assert launches == twin_launches
    plain = kw.get("paged_kernel") == "gather" or kw.get("paged") is False
    assert {k for k, n in launches.items() if n} == (
        set() if plain else KERNEL[arch])
    assert eng.stats.graph_captures > 0 and eng.stats.graph_replays > 0
    assert twin.stats.graph_captures == twin.stats.graph_replays == 0
    # one capture per key, and every admission program replayed
    adm = eng._admit
    assert eng.stats.graph_captures == len(eng._programs._by_key) + \
        len(adm._by_key)
    kinds = ADMISSION.get(case, ("prefill", "sample"))
    assert {k[0] for k in adm._by_key} == set(kinds)
    assert all(adm.replays_of(k) > 0 for k in kinds), adm._by_key
    eng.check_pool_balanced()
