"""Speculation and the multimodal stacks on a ring of cards of their
own (NCCL, rank r on ``cuda:r``), at small size: the cases of
``chip_smoke.py --only tp_spec_mm`` (phase 16).

* Kernel 1 on every rank's card at the verify shape (4 slots x 5
  queries, a table each, bf16 pool) of reduced llava's rank heads,
  against its plain version within 3e-2.
* Reduced smollm-135m and llava at tp 2 in ESL overlap, each rank
  drawing only its shard, with the n-gram drafter at ``draft_k`` 4:
  with ``graphs=True`` (every fused verify round replayed from a CUDA
  graph captured with NCCL's collectives inside) the eager twin's
  streams on every rank, the same drafts on every rank, kernel 1
  launched exactly once per layer per decode step, verify round, chunk
  and prefix tail, nothing staged through the host; the host-sampled
  round's streams equal to the fused round's.
* Reduced whisper-tiny (4-token prompts, 16 frames) and llava (8 patch
  embeddings) through the ring's ``build_prefill_step`` and 6 serve
  steps: every rank's tokens equal the tp=1 steps' on cuda:0.

Marked ``cuda``: each test skips below 2 cards (decided inside the
fixture, never at import).  On a machine with 2 or more cards:
``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_tp_spec_cuda.py`` (~2 min with the kernels' build).
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
from torch_tp_spec_util import spec_rank, steps_tp1  # noqa: E402

pytestmark = pytest.mark.cuda

PROMPTS = [[int(t) for t in np.random.RandomState(11).randint(
    1, 512, size=n)] for n in (7, 5, 12, 9)]
SPEC = dict(slots=4, max_seq=64, block_size=16, speculate="ngram",
            draft_k=4)
NAMES = ("smollm-135m", "llava-next-34b")
B, S, MAX, N_SERVE = 2, 4, 32, 6


def _inputs(name):
    from repro_torch.configs import get_config
    cfg = get_config(name).reduced()
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    if cfg.family == "encdec":
        extra = {"frames": (0.1 * rng.standard_normal(
            (B, cfg.encdec.enc_seq, cfg.d_model))).astype(np.float32)}
    else:
        extra = {"patch_embeds": (0.1 * rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim))
        ).astype(np.float32)}
    return toks, extra


@pytest.fixture(scope="module")
def on_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards")
    tasks = {"kernel": ("kernel1_verify", dict(name="llava-next-34b"))}
    for name in NAMES:
        for graphs in (False, True):
            tasks[name, graphs] = ("serve_spec", dict(
                name=name, tree=None, overlap=True, graphs=graphs,
                scenarios=[dict(key="fused", conf=SPEC, prompts=PROMPTS,
                                max_new=12),
                           dict(key="host", conf=dict(SPEC, sampling="host"),
                                prompts=PROMPTS, max_new=12)]))
    for name in ("whisper-tiny", "llava-next-34b"):
        toks, extra = _inputs(name)
        tasks["steps", name] = ("steps", dict(
            name=name, tree=None, overlap=True, tokens=toks, extra=extra,
            n_serve=N_SERVE, max_seq=MAX))
    return run_ranks(spec_rank, 2, tasks, device="cuda",
                     placement="card_per_rank")


def test_kernel1_at_the_verify_shape(on_cards):
    e = on_cards["kernel"]
    assert e["finite"] and e["max_abs_err"] <= 3e-2, e


@pytest.mark.parametrize("name", NAMES)
def test_verify_rounds_on_graphs_match_eager_twin(on_cards, name):
    g, e = on_cards[name, True], on_cards[name, False]
    for r in range(2):
        for key in ("fused", "host"):
            gs, gst = g[r][key]
            es, est = e[r][key]
            assert gs == es == g[0]["fused"][0], (name, r, key)
            assert gst["proposals"] == g[0][key][1]["proposals"]
            for st in (gst, est):
                assert st["spec_rounds"] > 0 and st["staged_bytes"] == 0
                got = st["launches"]["paged_decode_attention"]
                assert got == st["kernel1_want"] > 0, (name, r, key, st)
        assert g[r]["fused"][1]["graph_replays"] > 0
        assert e[r]["fused"][1]["graph_replays"] == 0


@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-34b"])
def test_ring_steps_equal_tp1(on_cards, name):
    toks, extra = _inputs(name)
    want = steps_tp1(name, toks, extra, N_SERVE, MAX,
                     torch.device("cuda", 0))
    per_rank, _ = on_cards["steps", name]
    for got in per_rank:
        np.testing.assert_array_equal(got, want)
