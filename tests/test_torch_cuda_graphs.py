"""The engine's captured decode windows and verify rounds on the card
against its eager twin (``graphs=False``): reduced smollm-135m (paged
pool streamed and gathered, the dense cache, n-gram speculation, sampled
streams), opt-1.3b, rwkv6-7b and jamba, random weights from seed 0.

Streams, every counter but the wall clock, and the kernels' launch
counts must be equal; the graph run must have captured and replayed.
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
}


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
    out = eng.generate(PROMPTS, max_new_tokens=24, params=params_s)
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
    eng.check_pool_balanced()
