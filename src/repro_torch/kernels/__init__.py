"""The port's hand-written Hopper kernels, and the one registry of the
wrappers that count their launches.

Each wrapper in :func:`counted` adds one to its ``launches`` where it
launches its kernel, and nowhere else.  A captured CUDA graph launches
its kernels without calling the wrappers, so the engine records the
counts a capture made (:func:`held_launches`) and adds them back on
every replay (:func:`add_launches`).

No kernel has a backward: each wrapper refuses an input that requires
grad while autograd records (:func:`refuse_autograd`), on the card and
on the CPU alike, so a kernel's output can never stand in a graph
without its history.  The training path runs the kernels' plain
versions.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import torch


def refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise when autograd is recording and one of ``tensors`` requires
    grad: the kernel's output would carry no autograd history, and
    everything upstream of it would get a wrong gradient in silence."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward and an input requires "
            "grad; differentiate through its plain version (the models' "
            "train mode does) or call it under torch.no_grad()")


def counted() -> Tuple:
    """Every wrapper whose ``launches`` counts its kernel's launches."""
    from repro_torch.kernels.decode_attention.ops import (
        decode_attention, paged_decode_attention)
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.mamba_scan.ops import (mamba_scan,
                                                    mamba_scan_fused)
    from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
    return (gemv, paged_decode_attention, decode_attention, rwkv_scan,
            mamba_scan, mamba_scan_fused)


def read_launches() -> Dict[str, int]:
    """{wrapper name: launches} of every counted wrapper."""
    return {fn.__name__: fn.launches for fn in counted()}


def reset_launches() -> None:
    for fn in counted():
        fn.launches = 0


def add_launches(made: Dict[str, int]) -> None:
    """Add ``made`` ({wrapper name: launches}) to the counters."""
    for fn in counted():
        fn.launches += made.get(fn.__name__, 0)


@contextlib.contextmanager
def held_launches() -> Iterator[Dict[str, int]]:
    """A block whose launches must not count (a warm-up, a graph
    capture): yields a dict that holds, once the block ends, the
    launches each wrapper made in it; the counters are then restored."""
    fns = counted()
    before = [fn.launches for fn in fns]
    made: Dict[str, int] = {}
    try:
        yield made
    finally:
        for fn, b in zip(fns, before):
            made[fn.__name__] = fn.launches - b
            fn.launches = b
