"""How far a model's bf16 logits move under another order of sums.

Prefills two seeded prompts of 24 tokens through a reduced config of
each named model (seed 0 weights, the port's ``init_params`` /
``init_shard``) at tp=1 in f32 and bf16, and on a ring of two gloo
ranks in f32 and bf16 (ESL overlap and blocking), and prints the
largest absolute difference of the logits between them, beside the
largest logit.  The ring in f32 agrees with tp=1 in f32 to rounding;
the ring's bf16 logits are then as far from tp=1's bf16 logits as the
model's own bf16 logits are from its f32 ones, when that distance is
large (a model whose bf16 rounding moves its logits by more than the
bf16 near-tie rule's 3e-2 + 3e-2 x |top-1| cannot be held to it).

    PYTHONPATH=src python tools/ring_drift_probe/probe.py \
        jamba-v0.1-52b smollm-135m

CPU only (~1 min a model).
"""
import sys

import numpy as np
import torch

from repro_torch.core.dist import run_ranks

SEQ, ROWS = 24, 2


def _tokens():
    return np.random.default_rng(0).integers(1, 512, size=(ROWS, SEQ)
                                             ).tolist()


def _logits(model, params, tokens, env=None):
    tok = torch.tensor(tokens)
    S = tok.shape[1]
    with torch.no_grad():
        lg, _ = model.forward(params, tok, mode="prefill",
                              cache=model.init_cache(tok.shape[0], S),
                              positions=torch.arange(S).expand(
                                  tok.shape[0], S), env=env)
    return lg.float()


def _plan(cfg, dtype, mesh, overlap=False):
    from repro_torch.compiler.mapper import plan_model
    return plan_model(cfg, ("model",) if mesh else None, (mesh or 1,),
                      "serve", esl_overlap=overlap, remat="none",
                      compute_dtype=dtype, param_dtype=dtype)


def ring_rank(ring, name, dtype, overlap):
    """The ring's logits, gathered whole, of this rank's shard."""
    from repro_torch.configs import get_config
    from repro_torch.core import esl
    from repro_torch.core.dist import make_axis_env
    from repro_torch.models.registry import build_model
    from repro_torch.weights import init_shard
    cfg = get_config(name).reduced()
    plan = _plan(cfg, dtype, ring.size, overlap)
    params = init_shard(cfg, plan, ring.rank, seed=0, device="cpu")
    lg = _logits(build_model(cfg, plan, "cpu"), params, _tokens(),
                 make_axis_env(plan, ring=ring))
    return esl.gather_scattered(lg, axis=ring, tp=ring.size)[
        ..., :cfg.vocab_size].numpy()


def tp1(name, dtype):
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    cfg = get_config(name).reduced()
    model = build_model(cfg, _plan(cfg, dtype, 0), "cpu")
    return _logits(model, model.init(0), _tokens())[
        ..., :cfg.vocab_size].numpy()


def main(names):
    for name in names:
        f32, b16 = tp1(name, "float32"), tp1(name, "bfloat16")
        print(f"{name} (reduced): largest logit {np.abs(f32).max():.4f}; "
              f"tp=1 bf16 vs f32 {np.abs(b16 - f32).max():.4g}")
        for overlap in (True, False):
            ring = {dt: run_ranks(ring_rank, 2, name, dt, overlap,
                                  device="cpu", threads=1)
                    for dt in ("float32", "bfloat16")}
            print(f"  tp 2 {'overlap' if overlap else 'blocking'}: f32 vs "
                  f"tp=1 f32 {np.abs(ring['float32'] - f32).max():.4g}, "
                  f"bf16 vs tp=1 bf16 "
                  f"{np.abs(ring['bfloat16'] - b16).max():.4g}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["jamba-v0.1-52b", "smollm-135m"])
