"""The serving ring's description.

The port of the JAX package's ``launch/mesh.py`` ``make_serving_mesh``.
There it builds a 1-D ``model`` mesh of ``tp * rings`` devices, which
``core/rings.submeshes`` carves into ``rings`` sub-rings of ``tp``.  In
the port a rank is a process (:func:`repro_torch.core.dist.run_ranks`)
on a card of its own over NCCL, or on the CPU or one shared card over
gloo, as its caller places it (:func:`repro_torch.core.dist.
rank_devices`), so the mesh is the ring's description: a
:class:`repro_torch.core.rings.RingConfig` of ``tp * rings`` ranks in
sub-rings of ``tp``; a model for one ring is planned with
``plan_model(cfg, ("model",), (tp,), ...)``.  The reference's TPU
constants are not carried over.
"""
from __future__ import annotations

from repro_torch.core.rings import RingConfig, reconfigure


def make_serving_mesh(tp: int = 1, rings: int = 1) -> RingConfig:
    """``tp * rings`` ranks on the ``model`` ring, in ``rings`` sub-rings
    of ``tp`` ranks each."""
    if tp < 1 or rings < 1:
        raise ValueError(f"tp={tp} and rings={rings} must be >= 1")
    return reconfigure(tp * rings, tp)
