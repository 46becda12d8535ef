"""End-to-end training driver: data -> step -> checkpoint/restart — the
port of the reference's ``launch/train.py`` at one device.

``run_training`` is the reference's loop:
  * the deterministic synthetic data stream (count-invariant indexing,
    :mod:`repro_torch.data.pipeline`), batches bit-equal to the
    reference's;
  * the eager train step (:func:`repro_torch.core.steps.build_train_step`)
    with AdamW over the cosine or WSD schedule;
  * periodic *atomic* checkpoints in the reference's format and crash
    auto-resume from the latest one, at its ``extra["next_step"]``; a
    checkpoint the reference wrote resumes here and the other way round;
  * the straggler monitor and ``FailureInjector`` crashes.

It runs on the card unless ``device`` asks for the CPU.  A mesh (data
parallelism, FSDP, the pod axis's int8 sync, elastic restart under
another dp width) arrives with the port's mesh slice and raises.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --batch 8 --seq 128 [--reduced] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.core.steps import build_train_step
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.ft import FailureInjector, StragglerMonitor
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, get_schedule


def run_training(*, cfg, steps: int, global_batch: int, seq_len: int,
                 mesh=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 20, lr: float = 3e-4,
                 schedule: str = "cosine", seed: int = 0,
                 injector: Optional[FailureInjector] = None,
                 esl_overlap: bool = False, log_every: int = 10,
                 param_dtype: str = "float32",
                 compute_dtype: str = "float32", device=None):
    """Train ``cfg`` for ``steps`` steps from seeded random weights (or
    from the latest checkpoint in ``ckpt_dir``).  Returns (params,
    opt_state, the losses of the steps this call ran)."""
    if mesh is not None:
        raise NotImplementedError(
            "run_training: a mesh (data parallelism, FSDP, elastic "
            "restart) arrives with the port's mesh slice; pass mesh=None")
    dev = resolve_device(device)
    plan = plan_model(cfg, None, (1,), "train", esl_overlap=esl_overlap,
                      remat="none", compute_dtype=compute_dtype,
                      param_dtype=param_dtype)
    model = build_model(cfg, plan, dev)
    opt = AdamW(lr=get_schedule(schedule, lr, max(steps // 20, 1), steps))
    step_fn, _ = build_train_step(model, opt, None, global_batch)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor()

    params = model.init(seed)
    opt_state = opt.init(params)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        state = mgr.restore(s, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = int(mgr.manifest(s)["extra"]["next_step"])
        print(f"[train] resumed from checkpoint step {s} -> "
              f"continuing at data step {start}")

    losses = []
    for step in range(start, steps):
        if injector is not None:
            injector.maybe_fail(step)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step, global_batch).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        ev = monitor.record(step, dt)
        if ev:
            print(f"[train][ft] straggler flagged: {ev.detail}")
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state},
                     extra={"next_step": step + 1, "loss": loss})
    if mgr is not None:
        mgr.save(steps - 1, {"params": params, "opt": opt_state},
                 extra={"next_step": steps, "loss": losses[-1]})
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config (CPU-feasible)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--esl-overlap", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    _, _, losses = run_training(
        cfg=cfg, steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, ckpt_dir=args.ckpt_dir, lr=args.lr,
        schedule=args.schedule, esl_overlap=args.esl_overlap,
        device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} -> "
          f"last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
