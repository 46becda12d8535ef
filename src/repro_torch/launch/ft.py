"""Compatibility shim, as the reference's ``launch/ft.py``: the
fault-tolerance policies live in :mod:`repro_torch.serving.ft`; the
training driver and its tests import them from here."""
from repro_torch.serving.ft import (Event, FailureInjector,  # noqa: F401
                                    HeartbeatTracker, StragglerMonitor)

__all__ = ["Event", "FailureInjector", "HeartbeatTracker",
           "StragglerMonitor"]
