"""What one collective of the port's ring costs: two ranks sharing one
card over gloo, or (``--cards``) 2 and 4 ranks on cards of their own
over NCCL.

    python3 tools/ring_probe/probe.py            # one card
    python3 tools/ring_probe/probe.py --cards    # 2 or more cards

Spawns the ranks through ``repro_torch.core.dist.run_ranks``.

On one card (gloo, as ``chip_smoke.py``'s phase 13 runs them) it times,
per call, host wall over 300 calls after a warm-up: a send/receive pair
(``ppermute``) and the port's ``psum`` (one round of sends and
receives, folded in rank order) on 4 and 4096 float32 elements, on CPU
tensors and staged from the card; gloo's own ``all_reduce`` of the same
CPU tensors (the call the port's ``psum`` does not use); the staged
``psum`` with three (4, 2048) x (2048, 2048) products before each call
(the two ranks' kernels time-sliced on the card); and the three products
with a synchronisation alone.

With ``--cards`` (NCCL, rank r on ``cuda:r``, as phase 14 runs them) it
prints ``nvidia-smi topo -m`` and, for 2 and for 4 ranks (as many as the
machine has cards), times the port's ``ppermute`` (one hop around the
ring), ``psum`` and ``all_gather`` at a decode size (4096 bf16 elements,
8 KB: a few tokens' activations) and a prefill size (32 x 9216 bf16, 576
KB: the protocol's 32-token prompt at opt-66b's width): eager (host wall
over 300 calls, then a synchronisation) and replayed from a CUDA graph
that captured 100 calls (device time by CUDA events over 5 replays).

Prints the card and one JSON line of ms per call, rank 0's.
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


SIZES = {"decode": (4096,), "prefill": (32, 9216)}
GRAPH_CALLS = 100
GRAPH_REPLAYS = 5


def cards_rank(ring):
    """Each collective at each size, eager and replayed from a graph, on
    this rank's own card over NCCL."""
    import torch

    from repro_torch.core import dist
    n = ring.size
    calls = {
        "ppermute": lambda x: dist.ppermute(
            x, ring, [(i, (i + 1) % n) for i in range(n)]),
        "psum": lambda x: dist.psum(x, ring),
        "all_gather": lambda x: dist.all_gather(x, ring, dim=-1)}
    out = {}
    for size, shape in SIZES.items():
        x = torch.randn(shape, device=ring.device).to(torch.bfloat16)
        for name, fn in calls.items():
            key = f"{name}/{size}/{x.numel() * x.element_size()}B"
            out[f"{key}/eager"] = _timed(lambda: fn(x),
                                         torch.cuda.synchronize)
            graph = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(x)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(g, pool=graph,
                                  capture_error_mode="thread_local"):
                for _ in range(GRAPH_CALLS):
                    fn(x)
            g.replay()
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            for _ in range(GRAPH_REPLAYS):
                g.replay()
            t1.record()
            torch.cuda.synchronize()
            out[f"{key}/graph"] = t0.elapsed_time(t1) / (
                GRAPH_REPLAYS * GRAPH_CALLS)
            del g
    out["staged_bytes"] = ring.counters["staged_bytes"]
    return out


if __name__ == "__main__":
    import chip_smoke as cs
    import torch

    from repro_torch.core.dist import run_ranks
    print(cs.nvidia_smi(), flush=True)
    if "--cards" in sys.argv[1:]:
        n = torch.cuda.device_count()
        if n < 2:
            sys.exit(f"--cards needs 2 or more cards; this machine has {n}")
        print(cs.smi_query("topo", "-m"), flush=True)
        print(json.dumps({"ring_probe_nccl_ms": {
            f"tp{tp}": run_ranks(cards_rank, tp, device="cuda",
                                 placement="card_per_rank")
            for tp in (2, 4) if tp <= n}}))
    else:
        print(json.dumps({"ring_probe_ms": run_ranks(
            probe_rank, 2, device="cuda", placement="shared_card")}))
