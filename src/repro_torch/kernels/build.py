"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` source with a plain C interface, compiled by
``nvcc`` into a shared library and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries are built at first use
into ``build/repro_torch_kernels/`` at the root of the checkout, named
by a hash of the source, its headers and the flags, so an edited source
rebuilds and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per missing source, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "repro_torch_kernels"

# kernel name -> source, relative to this directory
SOURCES: Dict[str, str] = {
    "paged_decode_attention":
        "decode_attention/csrc/paged_decode_attention.cu",
    "decode_attention": "decode_attention/csrc/decode_attention.cu",
    "gemv": "gemv/csrc/gemv.cu",
    "rwkv_scan": "rwkv_scan/csrc/rwkv_scan.cu",
    "mamba_scan": "mamba_scan/csrc/mamba_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_path(name: str) -> Path:
    return KERNEL_DIR / SOURCES[name]


def library_path(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers
    beside it (``*.cuh``) and the flags."""
    src = source_path(name)
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns {name: seconds} for the
    libraries built (empty when all were present); raises with the
    compiler's output when a build fails.  The ptxas report (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source_path(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    took: Dict[str, float] = {}
    failed = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return took


def build_log(name: str) -> str:
    """The compiler's report of the last build of ``name``."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
