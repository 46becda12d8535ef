"""The rwkv, hybrid and MoE families on a ring of cards of their own
(NCCL, rank r on ``cuda:r``), held to their plain versions and to their
own eager twins.

* Kernels 4 (WKV scan) and 5 (the selective scan's fused entry) on every
  rank's card at the ranks' shapes, rwkv6-7b's 64 heads of 64 and
  jamba's 8192 channels of 16 states over 2 and 4 ranks, against their
  plain versions: finite, within 1e-4 (bit-equal at these shapes so far).
* Reduced rwkv6-7b, jamba, granite and llama4 at tp 2 in ESL overlap
  and (rwkv, jamba) in blocking, each rank drawing only its shard, with
  ``graphs=True`` (the decode windows replayed from CUDA graphs
  captured with NCCL's collectives inside; the recurrent stacks'
  exact-length prefill eager): the eager twin's streams on every rank,
  the family kernel launched exactly once per layer per decode step
  (mamba: and per prefill) on every rank, nothing staged through the
  host, replays > 0.

Marked ``cuda``: each test skips below 2 cards (decided inside the
fixture, never at import).  On a machine with 2 or more cards:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_tp_families_cuda.py`` (~2 min with the kernels' build).
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
from torch_tp_families_util import families_rank  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = 1e-4
SHAPES = {"rwkv": [(b, 1, 64 // tp, 64) for tp in (2, 4) for b in (1, 4)],
          "mamba": [(b, 1, 8192 // tp, 16) for tp in (2, 4)
                    for b in (1, 4)] + [(1, 32, 4096, 16)]}
PROMPTS = [[int(t) for t in np.random.default_rng(1).integers(
    1, 512, size=n)] for n in (3, 9, 17, 6)]
# (model, ESL overlap, the engine's knobs)
SERVED = (("rwkv6-7b", True, dict(paged=False)),
          ("rwkv6-7b", False, dict(paged=False)),
          ("jamba-v0.1-52b", True, dict(paged=False)),
          ("jamba-v0.1-52b", False, dict(paged=False)),
          ("granite-moe-3b-a800m", True, dict(block_size=16)),
          ("llama4-maverick-400b-a17b", True, dict(block_size=16)))


@pytest.fixture(scope="module")
def on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    tasks = {"kernels": ("kernels", dict(shapes=SHAPES))}
    for name, overlap, knobs in SERVED:
        for graphs in (False, True):
            tasks[name, overlap, graphs] = ("serve", dict(
                name=name, overlap=overlap,
                conf=dict(slots=4, max_seq=64, steps_per_sync=4, **knobs),
                prompts=PROMPTS, max_new=12, graphs=graphs))
    return run_ranks(families_rank, 2, tasks, device="cuda",
                     placement="card_per_rank")


def test_scans_at_the_ranks_shapes(on_cards):
    for r, res in enumerate(on_cards):
        for call, e in res["kernels"].items():
            assert e["finite"] and e["max_abs_err"] <= TOL, (r, call, e)


@pytest.mark.parametrize("name,overlap,knobs", SERVED)
def test_ring_graphs_match_eager_twin(on_cards, name, overlap, knobs):
    for r, res in enumerate(on_cards):
        g, e = res[name, overlap, True], res[name, overlap, False]
        assert g["streams"] == e["streams"] == on_cards[0][
            name, overlap, True]["streams"], r
        assert g["replays"] > 0 and e["replays"] == 0
        for run in (g, e):
            assert run["launches"] == run["launches_want"] > 0, (r, run)
            assert run["counters"]["staged_bytes"] == 0
        assert g["counters"]["hops"] == e["counters"]["hops"]
