"""What one collective of the port's ring costs with two ranks on one
card.

    python3 tools/ring_probe/probe.py

Needs one CUDA card.  Spawns two ranks through
``repro_torch.core.dist.run_ranks`` (gloo, as ``chip_smoke.py``'s phase
13 does) and times, per call, host wall over 300 calls after a warm-up:
a send/receive pair (``ppermute``) and the port's ``psum`` (one round
of sends and receives, folded in rank order) on 4 and 4096 float32
elements, on CPU tensors and staged from the card; gloo's own
``all_reduce`` of the same CPU tensors (the call the port's ``psum``
does not use); the staged ``psum`` with three (4, 2048) x (2048, 2048)
products before each call (the two ranks' kernels time-sliced on the
card); and the three products with a synchronisation alone.  Prints the
card and one JSON line of ms per call, rank 0's.
"""
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

N_CALLS = 300


def _timed(fn, sync):
    for _ in range(10):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(N_CALLS):
        fn()
    sync()
    return (time.perf_counter() - t0) / N_CALLS * 1e3


def probe_rank(ring):
    import torch
    import torch.distributed as tdist

    from repro_torch.core import dist
    card = ring.device
    out = {}

    def cuda_sync():
        torch.cuda.synchronize()

    def products(h, w):
        for _ in range(3):
            h = torch.tanh(h @ w)
        return h

    w = torch.randn(2048, 2048, device=card)
    h = torch.randn(4, 2048, device=card)
    for where in ("cpu", "cuda"):
        ring.device = torch.device(where)
        for n in (4, 4096):
            x = torch.randn(n, device=where)
            out[f"ppermute/{where}/{n}"] = _timed(
                lambda: dist.ppermute(x, ring, [(0, 1), (1, 0)]), cuda_sync)
            out[f"psum/{where}/{n}"] = _timed(
                lambda: dist.psum(x, ring), cuda_sync)
            if where == "cpu":
                out[f"gloo_all_reduce/cpu/{n}"] = _timed(
                    lambda: tdist.all_reduce(x.clone()), cuda_sync)
    ring.device = card
    x = torch.randn(4, device=card)
    out["psum/cuda/4 after 3 products"] = _timed(
        lambda: (products(h, w), dist.psum(x, ring)), cuda_sync)
    out["3 products + synchronize"] = _timed(
        lambda: (products(h, w), cuda_sync()), cuda_sync)
    return out


if __name__ == "__main__":
    import chip_smoke as cs
    from repro_torch.core.dist import run_ranks
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"ring_probe_ms": run_ranks(probe_rank, 2,
                                                 device="cuda")}))
