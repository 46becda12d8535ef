"""Analytic token-latency simulator — the ASIC-simulator analog (C5); a
copy of the reference's ``core/latency_model.py``.

The LPU evaluation rests on a cycle-accurate simulator; we reproduce its
*published* numbers with a three-term analytic model derived from the
same reasoning the paper uses:

    t_token = stream_time + vector_time + exposed_sync_time

* stream_time   = (active_param_bytes + kv_bytes) / (N * BW)
                  — the C1 term: decode is weight streaming.
* vector_time   = L * (a + b * d_model / N)
                  — per-layer VXE work (norms, softmax, residual) that
                  does not overlap the stream; it tensor-parallelizes
                  with the ring (d/N), with a fixed per-layer issue cost
                  ``a``.  (a, b) are calibrated on the paper's four OPT
                  latencies — our analog of their RTL calibration.
* exposed_sync  = overlap ? per-layer ring *tail* (one chunk hop)
                          : full ring all-reduce per sync point
                  — the C2 term; 2 sync points per layer (attn out + FC2).

The same model produces Fig. 2a (bandwidth utilization), Fig. 7a
(ms/token), Fig. 7b (energy efficiency via system power), and Fig. 7c
(strong scaling), each validated against the paper's claims in
EXPERIMENTS.md §Paper-validation.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass(frozen=True)
class HWConfig:
    name: str
    mem_bw: float                  # bytes/s per device
    link_bw: float                 # bytes/s per ring direction per device
    system_power_w: float = 0.0    # full-system wall power (fig 7b)
    peak_flops: float = 0.0

    def scaled(self, n: int) -> "HWConfig":
        return self


# paper hardware points
LPU_ASIC = HWConfig("lpu-asic-3.28TBps", mem_bw=3.28e12, link_bw=12.5e9,
                    system_power_w=86.0, peak_flops=32 * 64 * 2 * 1e9)
LPU_FPGA = HWConfig("lpu-fpga-460GBps", mem_bw=460e9, link_bw=12.5e9,
                    system_power_w=76.0, peak_flops=16 * 64 * 2 * 220e6)
H100 = HWConfig("h100", mem_bw=3.35e12, link_bw=450e9,
                system_power_w=550.0, peak_flops=989e12)
L4 = HWConfig("l4", mem_bw=300e9, link_bw=32e9, system_power_w=72.0,
              peak_flops=121e12)
TPU_V5E = HWConfig("tpu-v5e", mem_bw=819e9, link_bw=50e9,
                   system_power_w=200.0, peak_flops=197e12)

# calibrated on the paper's OPT table (see fit_vector_params)
VEC_A_S = 6.0e-6
VEC_B_S_PER_DIM = 4.0e-9


def decode_stream_bytes(cfg: ArchConfig, kv_len: int,
                        dtype_bytes: int = 2) -> float:
    """Weight bytes read from HBM per generated token (all devices)."""
    return cfg.active_params() * dtype_bytes


def kv_stream_bytes(cfg: ArchConfig, kv_len: int,
                    dtype_bytes: int = 2) -> float:
    return cfg.kv_bytes_per_token(dtype_bytes) * kv_len


def token_latency(cfg: ArchConfig, n_devices: int, hw: HWConfig, *,
                  overlap: bool = True, kv_len: int = 1024,
                  vec_a: float = VEC_A_S, vec_b: float = VEC_B_S_PER_DIM,
                  vec_c: float = 0.0, dtype_bytes: int = 2,
                  shard_kv: bool = False) -> Dict[str, float]:
    """ms/token of the generation stage + per-term breakdown.

    ``shard_kv=False`` models the LPU's memory map: the mapper shards
    *weights* across the ring; the KV stream is per-device (this is the
    only reading under which the paper's 66B/2-dev latency, the OPT
    table and the 5.43x scaling figure are mutually consistent).  Our
    TPU mapper shards KV by heads (`shard_kv=True`) — a beyond-paper
    improvement quantified in the fig7c benchmark.
    """
    stream = decode_stream_bytes(cfg, kv_len, dtype_bytes) \
        / (n_devices * hw.mem_bw)
    kv_div = n_devices if shard_kv else 1
    stream += kv_stream_bytes(cfg, kv_len, dtype_bytes) \
        / (kv_div * hw.mem_bw)
    L = cfg.n_layers
    vec = vec_c + L * (vec_a + vec_b * cfg.d_model / n_devices)
    sync_points = 2 * L
    if n_devices == 1:
        sync = 0.0
    elif overlap:
        # ESL: only the last chunk's hop is exposed per sync point
        chunk = cfg.d_model * dtype_bytes / n_devices
        sync = sync_points * chunk / hw.link_bw
    else:
        # blocking ring all-reduce per sync point
        full = cfg.d_model * dtype_bytes
        sync = sync_points * 2 * (n_devices - 1) / n_devices \
            * full / hw.link_bw
        # plus kernel-relaunch/stall overhead per sync (GPU-style)
        sync += sync_points * 5e-6
    total = stream + vec + sync
    return {
        "ms_per_token": total * 1e3,
        "stream_ms": stream * 1e3,
        "vector_ms": vec * 1e3,
        "sync_ms": sync * 1e3,
        "bandwidth_util": stream / total,
        "tokens_per_s": 1.0 / total,
    }


def step_time_prior(cfg: ArchConfig, n_devices: int, hw: HWConfig, *,
                    kv_len: int = 1024, steps_per_sync: int = 1,
                    overlap: bool = True, dtype_bytes: int = 2) -> float:
    """Expected SECONDS one serving engine ``step()`` takes on ``hw``.

    The serving fault-tolerance layer seeds each ring's
    :class:`repro_torch.serving.ft.StragglerMonitor` with this prior
    (``mu0``), so step-time outlier detection is armed from the first
    measured step instead of treating whatever the first step costs as
    the baseline.  A fused window runs ``steps_per_sync`` decode steps
    per host sync, so the prior scales linearly with the window.
    """
    if steps_per_sync < 1:
        raise ValueError(f"steps_per_sync={steps_per_sync} must be >= 1")
    lat = token_latency(cfg, n_devices, hw, overlap=overlap,
                        kv_len=kv_len, dtype_bytes=dtype_bytes)
    return lat["ms_per_token"] * 1e-3 * steps_per_sync


def fit_vector_params(points: Sequence[Tuple[ArchConfig, int, HWConfig,
                                             int, float]]
                      ) -> Tuple[float, float, float, float]:
    """Least-squares (a, b, c) from published (cfg, N, hw, kv_len, ms).

    Returns (a, b, c, max_rel_err) — reported in the benchmark.
    """
    rows, targets = [], []
    for cfg, n, hw, kv_len, ms in points:
        stream = (decode_stream_bytes(cfg, kv_len) / n
                  + kv_stream_bytes(cfg, kv_len)) / hw.mem_bw
        chunk = cfg.d_model * 2 / n
        sync = 0.0 if n == 1 else 2 * cfg.n_layers * chunk / hw.link_bw
        resid = ms / 1e3 - stream - sync
        rows.append([cfg.n_layers, cfg.n_layers * cfg.d_model / n, 1.0])
        targets.append(resid)
    A = np.asarray(rows)
    t = np.asarray(targets)
    # non-negative least squares via active-set elimination (3 params)
    best, best_err = None, np.inf
    import itertools as _it
    for active in _it.chain.from_iterable(
            _it.combinations(range(3), r) for r in (3, 2, 1)):
        Aa = A[:, list(active)]
        sol, *_ = np.linalg.lstsq(Aa, t, rcond=None)
        if np.any(sol < 0):
            continue
        full = np.zeros(3)
        full[list(active)] = sol
        err = float(np.max(np.abs(A @ full - t) / np.maximum(t, 1e-9)))
        if err < best_err:
            best, best_err = full, err
    if best is None:
        best = np.maximum(np.linalg.lstsq(A, t, rcond=None)[0], 0)
    a, b, c = (float(v) for v in best)
    errs = []
    for cfg, n, hw, kv_len, ms in points:
        got = token_latency(cfg, n, hw, kv_len=kv_len, vec_a=a,
                            vec_b=b, vec_c=c)["ms_per_token"]
        errs.append(abs(got - ms) / ms)
    return a, b, c, max(errs)


def scaling_curve(cfg: ArchConfig, hw: HWConfig, max_devices: int = 8, *,
                  overlap: bool = True, kv_len: int = 1024,
                  vec_a: float = VEC_A_S, vec_b: float = VEC_B_S_PER_DIM,
                  vec_c: float = 0.0, shard_kv: bool = False) -> List[float]:
    """Speedup vs 1 device for 1,2,4,...,max_devices."""
    base = token_latency(cfg, 1, hw, overlap=overlap, kv_len=kv_len,
                         vec_a=vec_a, vec_b=vec_b, vec_c=vec_c,
                         shard_kv=shard_kv)["ms_per_token"]
    out = []
    n = 1
    while n <= max_devices:
        t = token_latency(cfg, n, hw, overlap=overlap, kv_len=kv_len,
                          vec_a=vec_a, vec_b=vec_b, vec_c=vec_c,
                          shard_kv=shard_kv)["ms_per_token"]
        out.append(base / t)
        n *= 2
    return out


def energy_per_token(cfg: ArchConfig, n_devices: int, hw: HWConfig, *,
                     kv_len: int = 1024, overlap: bool = True,
                     vec_a: float = VEC_A_S, vec_b: float = VEC_B_S_PER_DIM,
                     vec_c: float = 0.0) -> Dict[str, float]:
    lat = token_latency(cfg, n_devices, hw, overlap=overlap, kv_len=kv_len,
                        vec_a=vec_a, vec_b=vec_b, vec_c=vec_c)
    power = hw.system_power_w * n_devices
    tps = lat["tokens_per_s"]
    return {
        "tokens_per_s": tps,
        "watts": power,
        "tokens_per_s_per_kw": tps / (power / 1e3),
        "joules_per_token": power / tps,
    }
