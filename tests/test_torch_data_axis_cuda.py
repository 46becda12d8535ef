"""The serving steps on a ``("data", "model")`` grid of cards of its own
(NCCL, rank (d, m) on ``cuda:(2d + m)``): phase 18 (a) and the f32 part
of (b) of ``chip_smoke.py --only data_axis`` at reduced depth.

* opt-1.3b at full width, 2 layers, f32, batch 8 over data 2 x model 2:
  the greedy tokens of the prefill step and 8 serve steps equal the
  tp=1 steps' on cuda:0 (or part only at a top-2 gap <= 1e-4 of the
  tp=1 model), one all-gather a step on the data ring;
* jamba-v0.1-52b at full width, one super-block (8 layers: 1 attention,
  7 mamba, 4 MoE with the experts over data x model), f32, batch 1 with
  its KV sequence over ``data``: a prompt of 1020 into shards of 1024,
  then 8 steps across the boundary, held to tp=1's the same way;
  kernel 5 launched 7 x (1 + 8) times on every rank.

Marked ``cuda``: skips below 4 cards (decided inside the fixture, never
at import).  On a machine with 4 or more cards: ``PYTHONPATH=src python
-m pytest -q -m cuda tests/test_torch_data_axis_cuda.py`` (~2 min and
the kernels' build).
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.dist import run_ranks

# by its own name: an environment with a ``tests`` package of its own
# shadows ``tests.`` imports of this directory, here and in the ranks
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_data_axis_util import grid_cfg, grid_plan, steps_rank  # noqa

pytestmark = pytest.mark.cuda

NEW = 8
RNG = np.random.default_rng(18)
CASES = [dict(key="opt", name="opt-1.3b", depth=2, shape=(2, 2),
              tokens=RNG.integers(1, 50272, size=(8, 16)).astype(np.int32),
              max_seq=64),
         dict(key="jamba", name="jamba-v0.1-52b", depth=8, shape=(2, 2),
              kv_seq=True,
              tokens=RNG.integers(1, 65536, size=(1, 1020)).astype(np.int32),
              max_seq=2048)]


def _tp1(case, dev):
    """The tp=1 steps' tokens on ``dev`` and a function giving the top-2
    gap of the logits after a prefix."""
    from repro_torch.core.steps import build_prefill_step, build_serve_step
    from repro_torch.models.common import init_params
    from repro_torch.models.registry import build_model
    cfg = grid_cfg(case["name"], depth=case["depth"])
    plan = grid_plan(cfg, None)
    # the tp=1 tree whose shards every rank draws (weights.init_shard)
    params = init_params(cfg, plan, seed=0, device=dev)
    model = build_model(cfg, plan, dev)
    toks = torch.from_numpy(case["tokens"]).long().to(dev)
    B, P = toks.shape
    pre, _ = build_prefill_step(model, None, B, case["max_seq"])
    serve, _ = build_serve_step(model, None, B, case["max_seq"])
    with torch.no_grad():
        tok, cache = pre(params, model.init_cache(B, case["max_seq"]), toks)
        got = [tok.tolist()]
        for i in range(NEW):
            tok, cache = serve(params, cache, tok[:, None].long(),
                               torch.full((B,), P + i, dtype=torch.int32,
                                          device=dev))
            got.append(tok.tolist())
    del cache

    def gap(prefix):
        with torch.no_grad():
            lg, _ = model.forward(params, torch.tensor([prefix], device=dev),
                                  mode="prefill",
                                  cache=model.init_cache(1, case["max_seq"]))
        top = lg[0, -1].float().topk(2).values
        return float(top[0] - top[1])
    return got, gap


@pytest.fixture(scope="module")
def on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")
    per_rank = run_ranks(steps_rank, 4, dict(cases=[
        dict(c, tree=None, new=NEW) for c in CASES]), device="cuda",
        placement="card_per_rank", timeout_s=600)
    return per_rank


@pytest.mark.parametrize("key", ["opt", "jamba"])
def test_grid_steps_equal_tp1_on_cards(on_cards, key):
    case = next(c for c in CASES if c["key"] == key)
    got = on_cards[0]["out"][key]["tokens"]
    for r in on_cards:
        assert r["out"][key]["tokens"] == got
    want, gap = _tp1(case, torch.device("cuda", 0))
    rows_got, rows_want = np.array(got).T, np.array(want).T
    for b, (g, w) in enumerate(zip(rows_got, rows_want)):
        at = next((j for j, (u, v) in enumerate(zip(g, w)) if u != v), None)
        if at is not None:
            prefix = list(case["tokens"][b]) + list(g[:at])
            assert gap(prefix) <= 1e-4, (key, b, at)
    torch.cuda.empty_cache()


def test_data_ring_collectives_and_kernel5_on_cards(on_cards):
    for r in on_cards:
        assert r["out"]["opt"]["dp"] == ("data",)
        assert r["out"]["opt"]["data_per_step"] == [1] * NEW
        assert r["out"]["jamba"]["dp"] == ()
        # pmax and two psums of the one attention layer, and the four
        # MoE layers' three all-to-alls over data, a step
        assert r["out"]["jamba"]["data_per_step"] == [3 + 4 * 3] * NEW
        assert r["out"]["jamba"]["kernel5_launches"] == 7 * (1 + NEW)
