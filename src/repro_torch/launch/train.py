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

It runs on the card unless ``device`` asks for the CPU.

On a mesh (``mesh`` the rank's :class:`repro_torch.core.dist.Ring`
inside :func:`repro_torch.core.dist.run_ranks`, every rank calling
``run_training`` alike) the model is planned for the ``("model",)``
ring of ``tp`` ranks or, when the world holds more, the ``("data",
"model")`` grid of ``world / tp`` data rows (FSDP over ``data``).  Each
rank draws its shard (:func:`repro_torch.weights.init_shard`, the tp=1
weights' slice), reads its data row's rows of each step's batch (the
stream does not depend on the rank count), runs the mesh's train step
and keeps its own straggler monitor; the injector fires on every rank
at the same step.  Checkpoints hold the plan's global tensors (rank 0
writes them after a gather), and resume restores the latest at whatever
data width the new run has, or at ``mesh=None``: the reference's
elastic restart.  The pod axis's int8 sync is not ported.

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 50 --batch 8 --seq 128 [--reduced] [--device cpu] \\
      [--tp 2 --data 2]
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
from repro_torch.weights import init_shard


def mesh_of(ring, tp: Optional[int] = None):
    """(mesh axes, mesh shape) of a world ``ring`` trained at ``tp``:
    the ``("model",)`` ring when the world is ``tp`` ranks, else the
    ``("data", "model")`` grid of ``world / tp`` data rows."""
    tp = ring.size if tp is None else int(tp)
    if tp < 1 or ring.size % tp:
        raise ValueError(f"tp={tp} does not divide a world of {ring.size} "
                         "ranks")
    if tp == ring.size:
        return ("model",), (tp,)
    return ("data", "model"), (ring.size // tp, tp)


def run_training(*, cfg, steps: int, global_batch: int, seq_len: int,
                 mesh=None, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 20, lr: float = 3e-4,
                 schedule: str = "cosine", seed: int = 0,
                 injector: Optional[FailureInjector] = None,
                 esl_overlap: bool = False, log_every: int = 10,
                 param_dtype: str = "float32",
                 compute_dtype: str = "float32", device=None,
                 tp: Optional[int] = None):
    """Train ``cfg`` for ``steps`` steps from seeded random weights (or
    from the latest checkpoint in ``ckpt_dir``).  Returns (params,
    opt_state, the losses of the steps this call ran); on a mesh the
    rank's shards.  ``mesh``: the rank's ring, trained at ``tp`` (its
    size by default; fewer makes a grid, :func:`mesh_of`), on the
    ring's device."""
    if mesh is not None:
        from repro_torch.core.dist import Ring
        if not isinstance(mesh, Ring):
            raise TypeError("run_training: mesh is the rank's repro_torch."
                            "core.dist.Ring (run_ranks), not a "
                            f"{type(mesh).__name__}")
        axes, shape = mesh_of(mesh, tp)
        dev = mesh.device
    else:
        axes, shape = None, (1,)
        dev = resolve_device(device)
    plan = plan_model(cfg, axes, shape, "train", esl_overlap=esl_overlap,
                      remat="none", compute_dtype=compute_dtype,
                      param_dtype=param_dtype)
    model = build_model(cfg, plan, dev)
    opt = AdamW(lr=get_schedule(schedule, lr, max(steps // 20, 1), steps))
    step_fn, meta = build_train_step(model, opt, mesh, global_batch)
    env = meta["env"]
    rank0 = mesh is None or mesh.rank == 0
    shard = (plan, env) if mesh is not None else None
    rows = (0, 1)
    if env.dp:
        rows = (env.data.rank, env.dp_width)

    data = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq_len,
                       seed=seed)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    monitor = StragglerMonitor()

    if mesh is None:
        params = model.init(seed)
    else:
        params = init_shard(cfg, plan, mesh.rank, seed, device=dev)
    opt_state = opt.init(params)
    start = 0
    if mgr is not None and mgr.latest_step() is not None:
        s = mgr.latest_step()
        state = mgr.restore(s, {"params": params, "opt": opt_state},
                            shard=(plan, mesh.rank) if mesh is not None
                            else None)
        params, opt_state = state["params"], state["opt"]
        start = int(mgr.manifest(s)["extra"]["next_step"])
        if rank0:
            print(f"[train] resumed from checkpoint step {s} -> "
                  f"continuing at data step {start}")

    losses = []
    for step in range(start, steps):
        if injector is not None:
            injector.maybe_fail(step)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch(step, global_batch, rows).items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        ev = monitor.record(step, dt)
        if ev:
            print(f"[train][ft] straggler flagged: {ev.detail}")
        losses.append(loss)
        if rank0 and (step % log_every == 0 or step == steps - 1):
            print(f"[train] step {step:5d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:7.1f} ms")
        if mgr is not None and (step + 1) % ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state},
                     extra={"next_step": step + 1, "loss": loss},
                     shard=shard)
    if mgr is not None:
        mgr.save(steps - 1, {"params": params, "opt": opt_state},
                 extra={"next_step": steps, "loss": losses[-1]},
                 shard=shard)
    return params, opt_state, losses


def _train_rank(ring, kw):
    """One rank of the CLI's mesh: rank 0's losses."""
    cfg = get_config(kw.pop("arch"))
    if kw.pop("reduced"):
        cfg = cfg.reduced()
    return run_training(cfg=cfg, mesh=ring, **kw)[2]


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
    ap.add_argument("--tp", type=int, default=1,
                    help="ranks on the model ring (ESL tensor parallelism)")
    ap.add_argument("--data", type=int, default=1,
                    help="data rows of the grid (FSDP over them)")
    args = ap.parse_args()

    kw = dict(steps=args.steps, global_batch=args.batch, seq_len=args.seq,
              ckpt_dir=args.ckpt_dir, lr=args.lr, schedule=args.schedule,
              esl_overlap=args.esl_overlap)
    if args.tp * args.data > 1:
        from repro_torch.core.dist import run_ranks
        dev = resolve_device(args.device)
        world = args.tp * args.data
        print(f"[train] mesh: data {args.data} x model {args.tp}, {world} "
              f"ranks on {dev.type}")
        losses = run_ranks(
            _train_rank, world,
            dict(kw, arch=args.arch, reduced=args.reduced, tp=args.tp),
            device=dev, threads=1 if dev.type == "cpu" else None,
            placement="card_per_rank" if dev.type == "cuda" else None)
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        _, _, losses = run_training(cfg=cfg, device=args.device, **kw)
    print(f"[train] done: first loss {losses[0]:.4f} -> "
          f"last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
