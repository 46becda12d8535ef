"""Phase 19 (a) of ``chip_smoke.py`` on one card: opt-6.7b at full width
cut to ``--depth`` layers on the data 2 x model 2 grid, its four ranks
sharing the card over gloo, against its tp=1 twin, in each ``--dtype``.
Prints one JSON line a dtype: the losses, the global gradient norms,
step 1's largest gradient errors by leaf (a share of the leaf's max,
the padded vocab rows cut) and the parameters' after 3 AdamW steps.

The sums and their order are those of the grid on four cards over NCCL
(every collective adds its parts in rank order), so the numbers are
the same bits at a fraction of the cost, and a rank's fault shows
without four cards.

    python3 tools/train_mesh_probe/probe.py --depth 2 --dtype float32 float64

Needs one card (~80 s a dtype at depth 2; at depth 4 in float64 a rank
died there, memory suspected, not traced).  ``--cpu`` runs it on gloo
ranks on the CPU at reduced widths (~15 s a dtype).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke  # noqa: E402
from repro_torch.core.dist import run_ranks  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--dtype", nargs="+", default=["float32", "float64"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    a = dict(chip_smoke.TM_A, depth=args.depth)
    if args.cpu:
        a.update(batch=4, seq=32)
    for dt in args.dtype:
        t = time.perf_counter()
        spec = {"dtype": dt, "reduced": args.cpu, "a": a}
        kw = (dict(device="cpu", threads=1) if args.cpu else
              dict(device="cuda", placement="shared_card"))
        rec = run_ranks(chip_smoke.tm_twin_rank, 4, spec, timeout_s=900,
                        **kw)
        rec["wall_s"] = time.perf_counter() - t
        rec["failures"] = chip_smoke.tm_twin_failures(rec, {"a": a})
        print(json.dumps({dt: rec}), flush=True)


if __name__ == "__main__":
    main()
