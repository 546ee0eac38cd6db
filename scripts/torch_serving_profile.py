#!/usr/bin/env python3
"""Where the time of fasttalk_tpu_torch's WebSocket serving path goes, on
one CUDA GPU.

    python3 scripts/torch_serving_profile.py [--sessions 16] [--max-tokens 64]
        [--table PATH] [--kv-layout dense|paged] [--kv-quant none|int8]
        [--max-len 2048] [--pool-blocks 0] [--weight-quant int8|int4]
        [--spec-decode off|ngram|auto]

Serves the main path through ``chip_smoke.serve_main_path`` (llama3.2:1b
at full width, int8 random weights (int4, group 128, with ``--weight-quant
int4``), 16 slots, max_len 2048, prefill chunk 512, dense bf16 KV unless
the KV options say otherwise; one warm-up
session) and drives ``--sessions`` concurrent WebSocket sessions under
``torch.profiler``. Prints:

- wall time, tokens and decode tokens/s of the measured sessions;
- the engine's decode calls and steps in that window, the host time per
  decode step spent enqueueing them (the engine's ``decode_host_s``), and
  the GPU kernel time per decode step (all kernels of the window,
  prefill included, over the decode steps);
- the device busy share (sum of GPU kernel time over the wall time);
- the top GPU kernels and top CPU ops by self time.

With ``--table PATH`` the full profiler table (60 rows by GPU time) is
written to PATH.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=64)
    ap.add_argument("--table", default="",
                    help="write the full profiler table to this file")
    ap.add_argument("--kv-layout", default="dense", choices=("dense", "paged"))
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8"))
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="KV_POOL_BLOCKS of the paged layout (0 = fit)")
    ap.add_argument("--weight-quant", default="int8", choices=("int8", "int4"),
                    help="WEIGHT_QUANT of the served weights")
    ap.add_argument("--spec-decode", default=None,
                    choices=("off", "ngram", "auto"),
                    help="TPU_SPEC_DECODE (default: auto, off with "
                         "--kv-quant int8, which refuses speculation)")
    args = ap.parse_args()
    if args.spec_decode is None:
        args.spec_decode = "off" if args.kv_quant == "int8" else "auto"
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from chip_smoke import drive_sessions, serve_main_path

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)

    async def profiled(engine, port: int):
        before = engine.get_stats()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = await drive_sessions(port, args.sessions, args.max_tokens)
            torch.cuda.synchronize()
        after = engine.get_stats()
        for key in ("decode_calls", "decode_steps", "decode_host_s"):
            out[key] = after[key] - before[key]
        return out, prof

    served, prof = serve_main_path(
        profiled, max_len=args.max_len, weight_quant=args.weight_quant,
        kv_layout=args.kv_layout,
        kv_quant=args.kv_quant, kv_pool_blocks=args.pool_blocks,
        spec_decode=args.spec_decode)
    print(f"sessions={served['sessions']} tokens={served['tokens']} "
          f"wall_s={served['wall_s']} decode_tok_s="
          f"{served['tokens'] / served['wall_s']} errors={len(served['errors'])}")
    events = prof.key_averages()
    gpu_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = max(1, served["decode_steps"])
    print(f"decode calls={served['decode_calls']} "
          f"steps={served['decode_steps']} "
          f"host_enqueue_ms_per_step={served['decode_host_s'] / steps * 1e3} "
          f"gpu_kernel_ms_per_step={gpu_us / steps / 1e3} "
          f"(all kernels of the window, prefill included)")
    print(f"device busy share={gpu_us / 1e6 / served['wall_s']} "
          f"(kernel time {gpu_us / 1e3} ms over {served['wall_s']} s wall)")
    by_gpu = sorted((e for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)[:12]
    print("top GPU kernels (self ms, calls):")
    for e in by_gpu:
        print(f"  {e.self_device_time_total / 1e3:10.3f} {e.count:8d} "
              f"{e.key[:90]}")
    by_cpu = sorted((e for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU),
                    key=lambda e: -e.self_cpu_time_total)[:15]
    print("top CPU ops (self ms, calls):")
    for e in by_cpu:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} {e.count:8d} {e.key[:90]}")
    if args.table:
        os.makedirs(os.path.dirname(os.path.abspath(args.table)),
                    exist_ok=True)
        with open(args.table, "w", encoding="utf-8") as f:
            f.write(events.table(sort_by="self_cuda_time_total",
                                 row_limit=60))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
