"""Serving steps at tp=1: the port of the local (``mesh=None``) paths of
the reference's ``core/steps.py`` ``build_prefill_step`` and
``build_serve_step``.

These are the entry points that feed a family's extra inputs: whisper's
encoder ``frames`` and a vlm's ``patch_embeds`` (the engine serves a vlm
as a text decoder and refuses an encoder-decoder), over the model's
dense cache (``model.init_cache(batch, max_seq)``), which both steps
update in place.

* ``prefill_step(params, cache, tokens, frames=None, patch_embeds=None)``
  — the summarization stage: the prompt (B, S) (after n_patches patch
  rows for a vlm) fills the cache; returns (the greedy next token (B,)
  int32, cache).  ``frames`` reach only an encoder-decoder and
  ``patch_embeds`` only a vlm, as in the reference.
* ``serve_step(params, cache, tokens, positions)`` — one generation
  step: tokens (B, 1) at ``positions`` (B,), each row's resident length
  (for a vlm it counts the patches); returns (next token (B,), cache).

A mesh raises ``NotImplementedError`` (the tensor-parallel slice);
``build_train_step`` arrives with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

Params = Dict[str, Any]


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V_pad) -> (B,) int32 argmax of the last row (the first
    index among equal values, as ``jnp.argmax``)."""
    return logits[:, -1].float().argmax(-1).to(torch.int32)


def _local(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{what}: a mesh (tensor parallelism) arrives with the port's "
            "tp slice; pass mesh=None")


def build_serve_step(model, mesh, batch: int, max_seq: int
                     ) -> Tuple[Callable, Dict[str, Any]]:
    """One-token generation step (the LPU's target loop)."""
    _local(mesh, "build_serve_step")

    @torch.no_grad()
    def step(params, cache, tokens, positions):
        logits, cache = model.forward(params, tokens, mode="decode",
                                      positions=positions, cache=cache)
        return _greedy(logits), cache

    return step, {"batch": batch, "max_seq": max_seq}


def build_prefill_step(model, mesh, batch: int, max_seq: int
                       ) -> Tuple[Callable, Dict[str, Any]]:
    """Summarization stage: consume the prompt, emit the cache and the
    greedy token of its last row."""
    _local(mesh, "build_prefill_step")
    family = model.cfg.family

    @torch.no_grad()
    def step(params, cache, tokens, frames=None, patch_embeds=None):
        logits, cache = model.forward(
            params, tokens, mode="prefill", cache=cache,
            frames=frames if family == "encdec" else None,
            patch_embeds=patch_embeds if family == "vlm" else None)
        return _greedy(logits), cache

    return step, {"batch": batch, "max_seq": max_seq}
