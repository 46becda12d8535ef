"""The ring on cards of its own (NCCL, rank r on ``cuda:r``), held to
the gloo ring on the CPU and to its own eager twin.

* Every collective of ``repro_torch.core.dist`` on device tensors over
  NCCL gives the bits the gloo ring gives for the same inputs on the
  CPU, with the same counts and nothing staged through the host.
* Reduced opt-1.3b (overlap, blocking, and blocking with a prefill in
  chunks of 8) and smollm-135m served by engines whose ranks drew
  only their shards, with ``graphs=True`` (every step replayed from a
  CUDA graph captured with NCCL's collectives inside): the streams of
  the eager twin on the same ring, the same on every rank, kernel 1's
  launches exact on every rank, the collectives counted per replay
  equal to the eager twin's (the blocking baseline's parameter gathers
  made once, in the warm-ups), replays > 0.

Marked ``cuda``: each test skips below 2 cards (decided inside the
test, never at import); the 4-rank cases below 4 cards.  On a machine
with 2 or more cards:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tp_cards_cuda.py``
(~2 min with the kernels' build).
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dist import run_ranks

# by its own name: an environment with a ``tests`` package of its own
# (the card machine's has one) shadows ``tests.`` imports of this
# directory, in this process and in the spawned ranks, which are handed
# this process's sys.path
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_tp_cards_util import assert_same, cards_rank  # noqa: E402

pytestmark = pytest.mark.cuda

CONF = dict(slots=3, max_seq=64, block_size=16)
PROMPTS = [[int(t) for t in np.random.default_rng(1).integers(
    1, 512, size=n)] for n in (3, 9, 17, 6, 25, 2)]
# (model, ESL overlap, prefill chunk: None for the bucketed prefill)
SERVED = (("opt-1.3b", True, None), ("opt-1.3b", False, None),
          ("opt-1.3b", False, 8), ("smollm-135m", True, None))


def _need(tp):
    if not torch.cuda.is_available() or torch.cuda.device_count() < tp:
        pytest.skip(f"needs {tp} CUDA cards")


@pytest.fixture(scope="module")
def on_cards():
    """Every task on a ring of 2 and (with 4 cards) of 4, NCCL."""
    _need(2)
    out = {}
    for tp in (2, 4):
        if torch.cuda.device_count() < tp:
            continue
        tasks = {"collectives": ("collectives", {})}
        for name, overlap, chunk in SERVED:
            conf = dict(CONF, prefill_chunk=chunk) if chunk else CONF
            for graphs in (False, True):
                tasks[name, overlap, chunk, graphs] = ("serve", dict(
                    name=name, overlap=overlap, conf=conf, prompts=PROMPTS,
                    max_new=12, graphs=graphs))
        out[tp] = run_ranks(cards_rank, tp, tasks, device="cuda",
                            placement="card_per_rank")
    return out


@pytest.fixture(scope="module")
def on_cpu():
    """The collectives on a gloo ring of 2 and 4 ranks on the CPU."""
    return {tp: run_ranks(cards_rank, tp,
                          {"collectives": ("collectives", {})},
                          device="cpu", threads=1) for tp in (2, 4)}


@pytest.mark.parametrize("tp", [2, 4])
def test_nccl_collectives_match_gloo_ring(on_cards, on_cpu, tp):
    _need(tp)
    for r, (card, cpu) in enumerate(zip(on_cards[tp], on_cpu[tp])):
        assert_same(card["collectives"], cpu["collectives"], f"rank {r}")
        assert card["collectives"]["counters"]["staged_bytes"] == 0


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name,overlap,chunk", SERVED)
def test_nccl_graph_engine_matches_eager_twin(on_cards, tp, name, overlap,
                                              chunk):
    _need(tp)
    ranks = on_cards[tp]
    for res in ranks:
        g, e = res[name, overlap, chunk, True], res[name, overlap, chunk,
                                                    False]
        assert g["streams"] == e["streams"] == ranks[0][
            name, overlap, chunk, True]["streams"]
        assert g["replays"] > 0 and e["replays"] == 0
        assert g["prefill_chunks"] == e["prefill_chunks"]
        assert (g["prefill_chunks"] > 0) == bool(chunk)
        for run in (g, e):
            assert run["launches"] == run["launches_want"] > 0
            assert run["counters"]["staged_bytes"] == 0
        assert g["counters"]["hops"] == e["counters"]["hops"]
        assert g["counters"]["collectives"] + g["gathered"] == \
            e["counters"]["collectives"]
