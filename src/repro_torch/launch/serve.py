"""Serving driver of the port: build a model with seeded random weights
and run the engine on a batch of random prompts.

    python -m repro_torch.launch.serve                      # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba \
        --reduced --device cpu

Runs on the CUDA device unless ``--device cpu`` is given (and fails when
there is none).  Prints the reference driver's stats lines plus the
launch count of the family's kernel: the paged decode attention (dense
decoders), the WKV recurrence (rwkv) or the selective scan (hybrid:
every mamba layer, prefill and decode), 0 on the CPU, where the plain
versions run.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.compiler.mapper import plan_model
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.mamba_scan.ops import mamba_scan_fused
from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.models.registry import build_model
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import LPUEngine
from repro_torch.serving.sampler import SamplingParams


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-slot KV cache")
    ap.add_argument("--block-size", type=int, default=0,
                    help="tokens per KV block (0 = min(128, max_seq))")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="KV pool size incl. null block "
                         "(0 = dense-equivalent capacity)")
    ap.add_argument("--kv-budget-mb", type=int, default=0,
                    help="KV budget in MiB (sizes the pool when "
                         "--num-blocks is 0)")
    ap.add_argument("--min-bucket", type=int, default=16,
                    help="smallest power-of-two prefill bucket")
    ap.add_argument("--paged-kernel", default="auto",
                    choices=("auto", "stream", "gather"),
                    help="paged decode dataflow: stream KV tiles through "
                         "the paged kernel, gather the contiguous view "
                         "(oracle), or auto")
    ap.add_argument("--sampling", default="fused",
                    choices=("fused", "host"),
                    help="fused: sample on the device, only token ids "
                         "reach the host; host: per-token logits readback")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="decode steps per host sync (fused sampling only)")
    ap.add_argument("--kv-dtype", default="auto",
                    choices=("auto", "float16", "bfloat16", "float32",
                             "int8", "fp8"),
                    help="KV pool storage precision (int8/fp8 arrive "
                         "with a later slice)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    plan = plan_model(cfg, None, (1,), "serve", esl_overlap=False,
                      remat="none", compute_dtype="float32",
                      param_dtype="float32")
    model = build_model(cfg, plan, dev)
    params = model.init(seed=0)
    econf = EngineConfig(slots=args.slots, max_seq=args.max_seq,
                         paged=False if args.dense else None,
                         block_size=args.block_size,
                         num_blocks=args.num_blocks,
                         kv_budget_bytes=args.kv_budget_mb << 20,
                         min_bucket=args.min_bucket,
                         paged_kernel=args.paged_kernel,
                         sampling=args.sampling,
                         steps_per_sync=args.steps_per_sync,
                         kv_dtype=args.kv_dtype)
    engine = LPUEngine(model, params, econf, device=dev)

    rng = np.random.RandomState(0)
    prompts = [list(rng.randint(1, cfg.vocab_size,
                                size=rng.randint(2, 10)))
               for _ in range(args.requests)]
    sp = SamplingParams(args.temperature, args.top_k, args.top_p)
    kernel = {"rwkv": rwkv_scan, "hybrid": mamba_scan_fused}.get(
        cfg.family, paged_decode_attention)
    kernel.launches = 0
    outs = engine.generate(prompts, max_new_tokens=args.max_new, params=sp)
    mode = f"paged/{engine.paged_kernel}" if engine.paged else "dense"
    st = engine.stats
    print(f"[serve] {len(outs)} requests, {st.tokens} tokens, "
          f"{st.tokens_per_s:.1f} tok/s, occupancy {st.occupancy:.2f}, "
          f"{st.steps} decode steps, tp=1, device={dev}")
    print(f"[serve] kv={mode} dtype={engine.kv_dtype} "
          f"w_dtype={engine.w_dtype} bytes={engine.kv_cache_bytes()} "
          f"(per-rank {engine.per_rank_kv_bytes()}, "
          f"dense-equiv {engine.dense_equiv_bytes()}), "
          f"kv_moved/step={engine.kv_bytes_moved_per_step()}, "
          f"prefill traces={st.prefill_traces}, "
          f"preemptions={st.preemptions}")
    print(f"[serve] sampling={engine.sampling} "
          f"steps_per_sync={engine.steps_per_sync}: "
          f"{st.host_syncs} host syncs "
          f"({st.syncs_per_token:.2f}/token), "
          f"{st.bytes_to_host_per_token:.1f} B->host/token, "
          f"overrun={st.overrun_tokens}, "
          f"block_s={engine.decode_block_s()}")
    if cfg.family == "hybrid":
        n_mamba = sum(not cfg.is_attention_layer(i)
                      for i in range(cfg.n_layers))
        print(f"[serve] {kernel.__name__} kernel launches={kernel.launches} "
              f"((device decode steps {st.device_decode_steps} + prefills "
              f"{st.prefills}) x {n_mamba} mamba layers)")
    else:
        print(f"[serve] {kernel.__name__} kernel launches={kernel.launches} "
              f"(device decode steps {st.device_decode_steps} x "
              f"{cfg.n_layers} layers)")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}")
    return outs


if __name__ == "__main__":
    main()
