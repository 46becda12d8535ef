"""Where the first design of kernel 4 (the WKV recurrence) spent its time.

    python3 tools/rwkv_scan_probe/probe.py

Needs one CUDA card and ``nvcc``.  Builds ``probe.cu`` (the first
design's kernel with its state traffic switched off piece by piece) into
``build/rwkv_scan_probe/`` and times each variant with ``chip_smoke``'s
``time_ms`` at the decode shape (4, 1, 64, 64) and at a prefill length
(1, 512, 64, 64), beside the port's current ``rwkv_scan`` kernel,
PyTorch's copy of the same state bytes and the timing floor.  Prints the
card and one JSON line of device ms.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan  # noqa: E402

VARIANTS = ("first_design", "state_load_only", "state_store_only",
            "no_state", "empty")


def load_probe():
    out_dir = os.path.join(ROOT, "build", "rwkv_scan_probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "probe.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(HERE, "probe.cu")], check=True)
    fn = ctypes.CDLL(so).probe
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main():
    if not torch.cuda.is_available():
        print("rwkv_scan_probe: no CUDA device", file=sys.stderr)
        return 1
    fn = load_probe()
    dev = torch.device("cuda")
    out = {"card": cs.nvidia_smi(), "floor_ms": cs.time_floor(torch, dev)[0]}
    for shape in (cs.RWKV_DECODE, cs.RWKV_PREFILL):
        B, S, H, dh = shape
        args = cs.rwkv_inputs(torch, dev, shape, seed=20)
        n = cs.sets_for(4 * sum(a.numel() for a in args))
        sets = [tuple(a.clone() for a in args)
                + (torch.empty_like(args[0]), torch.empty_like(args[5]))
                for _ in range(n)]
        stream = torch.cuda.current_stream().cuda_stream
        iters, warm = (200, 20) if S == 1 else (20, 3)

        def variant(mode):
            def call(i):
                err = fn(*[t.data_ptr() for t in sets[i]], B, S, H, dh,
                         mode, stream)
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")
            return call
        res = {name: cs.time_ms(torch, variant(mode), n, iters, warm)[0]
               for mode, name in enumerate(VARIANTS)}
        res["current_kernel"] = cs.time_ms(
            torch, lambda i: rwkv_scan(*sets[i][:6]), n, iters, warm)[0]
        res["torch_state_copy"] = cs.time_ms(
            torch, lambda i: sets[i][7].copy_(sets[i][5]), n)[0]
        out["x".join(map(str, shape))] = res
        del sets
    print(out["card"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
