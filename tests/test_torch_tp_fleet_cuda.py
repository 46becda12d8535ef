"""The mesh fleet on cards of its own (NCCL, rank r on ``cuda:r``), at
small size: the cases of ``chip_smoke.py --only tp_fleet`` (phase 17).

Reduced smollm-135m as 2 rings x tp 2 on 4 cards in ESL overlap (the
ring's hops are point-to-point on each sub-ring's communicator), each
rank drawing its shard at its place in its sub-ring, chunks of 8: with
``graphs=True`` (every window and chunk replayed from a CUDA graph
captured with its sub-ring's NCCL collectives inside) the eager twin's
streams and the
tp=1 engine's on cuda:0, the same on every rank, kernel 1 launched once
per layer per decode step and chunk on every rank, nothing on the world
group and nothing staged through the host; the front end on rank 0 over
it streams the same tokens, every rank's orders equal.

Marked ``cuda``: skips below 4 cards (decided inside the fixture, never
at import).  On a machine with 4 or more cards: ``PYTHONPATH=src python
-m pytest -q -m cuda tests/test_torch_tp_fleet_cuda.py`` (~1 min and
the kernels' build, ~2-3 min).
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dist import run_ranks

# by its own name: an environment with a ``tests`` package of its own
# (the card machine's has one) shadows ``tests.`` imports of this
# directory, in this process and in the spawned ranks
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tp_fleet_util import card_fleet_rank  # noqa: E402

pytestmark = pytest.mark.cuda

PROMPTS = [[int(t) for t in np.random.RandomState(13).randint(
    1, 512, size=n)] for n in (7, 19, 12, 9, 3, 25)]
CONF = dict(slots=2, max_seq=64, block_size=16, prefill_chunk=8)
NEW = 10


@pytest.fixture(scope="module")
def on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    from repro_torch.compiler.mapper import plan_model
    from repro_torch.configs import get_config
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import LPUEngine
    cfg = get_config("smollm-135m").reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    dev = torch.device("cuda", 0)
    tp1 = LPUEngine(build_model(cfg, plan, dev),
                    init_params(cfg, plan, seed=0, device=dev),
                    EngineConfig(**CONF), device=dev).generate(
                        PROMPTS, max_new_tokens=NEW)
    per_rank = run_ranks(card_fleet_rank, 4, dict(
        name="smollm-135m", conf=CONF, prompts=PROMPTS, new=NEW),
        device="cuda", placement="card_per_rank", timeout_s=300)
    return tp1, per_rank


def test_fleet_on_graphs_equals_eager_twin_and_tp1(on_cards):
    tp1, per_rank = on_cards
    for r in per_rank:
        g, e = r[True], r[False]
        assert g["streams"] == e["streams"] == tp1
        assert g["routed"] == e["routed"] == per_rank[0][True]["routed"]
        assert g["fleet_counters"] == per_rank[0][True]["fleet_counters"]
        assert g["replays"] > 0 and e["replays"] == 0
        assert g["collectives"] == e["collectives"] > 0


def test_kernel1_exact_and_nothing_crosses_sub_rings(on_cards):
    _, per_rank = on_cards
    for r in per_rank:
        for graphs in (True, False):
            run = r[graphs]
            assert run["launches"] == run["want"] > 0
            assert run["world"] == 0 and run["staged"] == 0


def test_frontend_over_the_fleet_on_cards(on_cards):
    tp1, per_rank = on_cards
    outs, statuses, counters = per_rank[0]["frontend"]
    assert outs == tp1 and set(statuses) == {"completed"}
    assert len({r["orders"] for r in per_rank}) == 1
