"""Training on a ``("data", "model")`` grid of cards of its own (NCCL,
rank (d, m) on ``cuda:(2d + m)``, eager autograd): the grid's train step
against the port's tp=1 step on cuda:0, TF32 off.

* reduced smollm-135m, f32, batch 4 x 16: one step's gradients in
  blocking and in ESL overlap with remat block (the super-block replayed
  in backward with its gathers and ring hops), and three AdamW steps in
  overlap (losses, parameters, every replicated leaf bit-equal on its
  ring);
* opt-1.3b at full width, 2 layers, f32, batch 4 x 64 (on cards only):
  one step's gradients in blocking.

Gates: losses at rtol 1e-5, gathered gradients (for AdamW its first
step's) at 1e-5 x each leaf's max (a leaf whose tp=1 gradient is
round-off of zero left out); after AdamW, at most 1e-3 of a leaf's
elements past 1e-5 x its max and every element within 2 x lr a step
(AdamW moves an element by up to lr whatever its gradient's size, so
an element whose gradient is rounding may step the other way).
``tests/test_torch_train_mesh.py::test_card_rank_rehearsed_on_gloo``
runs the same rank function on gloo ranks on the CPU.

Marked ``cuda``: skips below 4 cards (decided inside the test, never at
import).  On a machine with 4 or more cards: ``PYTHONPATH=src python -m
pytest -q -m cuda tests/test_torch_train_mesh_cuda.py`` (~1 min; no
kernel is built: training launches none).
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
from torch_train_mesh_util import card_rank, case_cfg, make_batch  # noqa

pytestmark = pytest.mark.cuda

GRID = (2, 2)


def CASES(name, card=False):
    """The cases (without their tree) on reduced ``name``; on cards also
    opt-1.3b's (with its ``depth``)."""
    cfg = case_cfg(name)
    batch = make_batch(cfg)
    cases = [dict(key="blocking", name=name, shape=GRID, batch=batch),
             dict(key="overlap_remat", name=name, shape=GRID,
                  batch=batch, overlap=True, remat="block"),
             dict(key="adamw", name=name, shape=GRID, overlap=True,
                  adamw=1e-3, steps=3,
                  batches=[make_batch(cfg, seed=s) for s in range(3)])]
    if card:
        opt = case_cfg("opt-1.3b", depth=2)
        cases.append(dict(key="opt-1.3b", name="opt-1.3b", depth=2,
                          shape=GRID, batch=make_batch(opt, seq=64)))
    return cases


def check_card_record(rec, cases):
    """The gates of every case of ``cases`` on the rank function's
    record."""
    assert sorted(rec) == sorted(c["key"] for c in cases)
    for c in cases:
        r = rec[c["key"]]
        np.testing.assert_allclose(r["losses"], r["tp1_losses"], rtol=1e-5,
                                   err_msg=c["key"])
        err, at, share, where, loose = r["err"]
        assert err <= 1e-5, (c["key"], err, at)
        assert share <= 1e-3 and loose <= 1.0, (c["key"], share, where,
                                                loose)
        if r["replicas"] is not None:
            assert r["replicas"] and all(r["replicas"].values()), r


def test_grid_train_step_on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 or more CUDA cards")
    from repro_torch.models.common import init_params
    from torch_train_mesh_util import mesh_plan, to_numpy
    cases = []
    for c in CASES("smollm-135m", card=True):
        cfg = case_cfg(c["name"], c.get("depth"))
        tree = to_numpy(init_params(cfg, mesh_plan(cfg, None), 0, "cpu"))
        cases.append(dict(c, tree=tree))
    rec = run_ranks(card_rank, 4, {"cases": cases}, device="cuda",
                    placement="card_per_rank", timeout_s=600)
    check_card_record(rec, cases)
