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
``plan_model(cfg, ("model",), (tp,), ...)``.  A ``("data", "model")``
grid of ranks (:func:`make_test_mesh`, :func:`mesh_axes_shape`) is a
:class:`repro_torch.core.rings.Grid`; a model for it is planned with
``plan_model(cfg, ("data", "model"), (dwidth, tp), "serve")``.  The
reference's TPU constants are not carried over.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from repro_torch.core.rings import Grid, RingConfig, reconfigure


def make_serving_mesh(tp: int = 1, rings: int = 1) -> RingConfig:
    """``tp * rings`` ranks on the ``model`` ring, in ``rings`` sub-rings
    of ``tp`` ranks each."""
    if tp < 1 or rings < 1:
        raise ValueError(f"tp={tp} and rings={rings} must be >= 1")
    return reconfigure(tp * rings, tp)


def mesh_axes_shape(dwidth: int, tp: int
                    ) -> Tuple[Tuple[str, str], Tuple[int, int]]:
    """(axes, shape) of a serving grid of ``dwidth`` data rows of ``tp``
    model ranks: the reference's ``mesh_axes_shape`` without its
    16-chip pod."""
    return Grid(dwidth, tp).axes, Grid(dwidth, tp).shape


def make_test_mesh(shape: Sequence[int] = (2, 4),
                   axes: Sequence[str] = ("data", "model")) -> Grid:
    """The grid of ``shape`` on ``("data", "model")`` (the reference's
    ``make_test_mesh``); any other axes raise."""
    if tuple(axes) != Grid.axes or len(shape) != 2:
        raise ValueError(f"mesh {tuple(axes)}{tuple(shape)}: the port's "
                         "grid is ('data', 'model')")
    return Grid(int(shape[0]), int(shape[1]))
