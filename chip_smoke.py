#!/usr/bin/env python3
"""Drive fasttalk_tpu_torch's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero and prints
no result line):

1. the card's name and power limit (nvidia-smi); build every CUDA kernel
   of ``fasttalk_tpu_torch/csrc`` with nvcc, one process per source;
2. each kernel, and each tier of the attention kernel (dense or paged,
   bf16 or int8 rows; T = 1, 4 and 8 query positions), against its plain
   PyTorch version on the card at the shapes the Llama-3.2-1B decode step
   and the speculative verify block (16 slots x 8 positions: 128 matmul
   rows, attention at T = 8) give it, with the tolerance stated, then
   timed with CUDA graphs beside its plain version, one PyTorch library
   call computing the same function (where there is one), and its bound;
3. llama3.2:1b at full width (int8 random weights on the card): prefill
   plus decode steps through the kernels against the same forward through
   the plain versions, by logits and greedy tokens, on the dense bf16 cache
   and on the paged int8 pool; then the same with int4 random weights
   (WEIGHT_QUANT=int4, group 128) on the dense bf16 cache;
4. the trained tinychat checkpoint (read in place from
   ``fasttalk_tpu/assets``), the greedy answer to "what color is the sky?"
   with TPU_SPEC_DECODE=ngram equal to the one with it off, with int8
   weights on the dense and the paged bf16 cache and with int4 weights;
   and with int8 weights on the paged int8 pool (spec off); then, with the
   tokenizer given the JSON punctuation (a copy under build/), a
   ``response_format`` json_schema answer with jump-forward on
   (STRUCTURED_JF_MIN=4) equal token for token to the one with it off,
   parsing and meeting the schema; and a session's second turn (its slot's
   token ids) after a radix hit (the session released between the turns)
   and after a park on eviction and a restore (from the pinned host rows,
   and from rows prestaged on the offload thread's stream), equal to the
   never-evicted second turn, on the paged bf16, paged int8 and (park
   only) dense bf16 caches;
5. the WebSocket server in-process through ``build_engine`` (full-width
   llama3.2:1b, int8, 16 slots, max_len 2048, prefill chunk 512, dense
   bf16 KV, the JAX engine's defaults: TPU_SPEC_DECODE=auto, shared
   prefix, batched prefill) with 16 concurrent sessions; the burst must
   run a batched prefill call;
6. the same server on the paged int8 pool (KV_LAYOUT=paged,
   KV_QUANT=int8, max_len 8192, 16-token blocks, 2048 pool blocks: a
   quarter of the dense layout's rows; spec off, as int8 KV requires) with
   16 concurrent sessions;
7. the two other tiers served briefly (dense int8 with spec off, paged
   bf16);
8. WEIGHT_QUANT=int4 served as in phase 5: the layer matmuls run
   ``int4_matmul`` and ``int8_matmul`` must launch no time;
9. speculative decoding (TPU_SPEC_DECODE=ngram, greedy) served on the
   dense bf16 cache (16 sessions x 64 tokens) and on the paged bf16 pool
   (16 tokens), and the dense run again with spec off: the attention
   kernel must launch at T = 8 on both tiers and drafts must be accepted;
   one verify step and one plain step of the served engine are timed with
   CUDA graphs;
10. structured output and client tool calls served beside plain streams
   (phase 5's configuration, STRUCTURED_MODE=auto): one burst, twice (cold:
   the schemas compile in it; warm), of 6 /v1 chat completions with
   ``response_format`` json_schema (3 streamed), one with a forced
   ``tool_choice``, one WebSocket session with the ``structured`` key and 8
   plain /v1 streams of 64 tokens. Every document must parse and meet its
   schema (checked by hand here) and end with "stop", the tool call's
   arguments meet its parameters, every plain stream give 64 tokens, no
   request fail; constrained decode calls and jump-forward tokens must
   have run, and no speculative call beside a constrained slot. One
   constrained step and one plain step are timed with CUDA graphs. Then
   the same with 4 constrained completions on phase 6's paged int8 pool;
11. the KV memory hierarchy, every session sharing one system prompt of
   about 1,000 tokens (``SYSTEM_1K``): (a) the radix cache
   (KV_RADIX_ENABLED) on the paged bf16 pool (max_len 8192, 2048 blocks,
   spec at its default), 16 sessions x 3 turns x 64 tokens, each session
   released after every turn, against the same traffic with the cache off:
   turns 2-3 must prefill at most their delta plus 2 blocks, the tree must
   hit and blocks be aliased, the tree and the pool must pass their
   integrity checks after the drain; (b) the same briefly (16 tokens) on
   the paged int8 pool, one session kept and its system prompt changed
   mid-block so its next turn copies a shared block on write, and one block
   copy held to its rows and scales on the card; (c) host offload
   (KV_HOST_BUDGET_MB=4096) on dense bf16 at max_len 2048: two waves of 16
   sessions x 2 turns, wave B's first turns evict and park wave A, wave
   A's second turns restore and must prefill only their delta; at least
   16 parks and one restore; against the same traffic with the pool off;
   one restore is timed with CUDA events; (d) (c) briefly on the paged int8
   pool. No park or restore may fail in phase 11, and the kernels of each
   part must have launched;
12. the observability stack (``phase12``): phase 5's configuration served
   through ``serve``, the monitoring app on its own port, 16 sessions x 64
   tokens bracketed by ``/profiler/start`` and ``/profiler/stop``; every
   route of the monitoring app must answer, ``/perf``'s programs must
   ``fsum`` to ``device_busy_s`` within its window with every served kind
   busy and ``mfu`` and ``hbm.bw_util`` set, the watchdog must see no
   stall, and a ``/debug/bundle`` must hold ``cuda_trace/``. The union of
   kernel time in the profiler's trace is logged beside ``/perf``'s
   ``device_busy_s``, and host ms a decode step and decode tok/s with the
   stack on and off (``PROF_ENABLED=false``, tracer off). Flight bundles and
   profiler traces go under ``build/`` (``FLIGHT_DIR``,
   ``PROFILER_TRACE_DIR``);
13. the engine's lifecycle (``phase13``) through ``ServerLauncher`` at
   phase 5's width with the agent on: warm-up and a first wave of 16
   sessions, a ``crash_thread`` armed through ``POST /debug/fault``
   mid-burst (one error frame per in-flight session, the supervisor's
   restart, no second KV cache on the card, requests of the crash race
   window served, the greedy control unchanged, a parked session
   restored), then a restart storm that exhausts
   SUPERVISOR_MAX_RESTARTS=2 (``/health`` dead) and a clean shutdown;
14. the fleet router (``phase14``) through ``ServerLauncher`` with
   ``ROUTER_ENABLED``, every replica at phase 5's full width: (a)
   placement and affinity over two replicas (16 sessions x 2 turns); (b)
   failover with resume (a replica's engine shut down under four greedy
   streams: one ``resumed`` frame each, the control equal to its unbroken
   run, ``/health`` degraded, one stitched trace); (c) drain with KV
   migration in process (exact pool bytes, restores, the control equal)
   and over the ``/kv/parked`` wire between two servers; (d) the
   disaggregated prefill tier on the paged bf16 pool with the radix cache
   (8 handoffs, a radix hit of the imported prefix, a failpoint fallback);
   (e) the elastic scaler up to two replicas and back. The bytes allocated
   on the card after each part must be within 64 MiB of the phase's start;
   what holds the card's memory at the phase's start is attributed
   (``memory_owners``);
15. multi-rank serving (``phase15``): each kernel held to its plain
   version at a tp = 2 rank's shard shapes (``check_shard_kernels``);
   NCCL's answer to two ranks on one device written down; then two ranks
   per cluster, each a process of its own on the one card over gloo: (a)
   llama3.2:1b int8 at tp = 2 through the launcher (leader) and a
   follower, 8 WS sessions x 64 tokens, the kernels' launches counted on
   both ranks, and tinychat int8 at tp = 2 against the single-rank
   engine's greedy texts; (b) tinychat int8 at sp = 2, a fresh prompt
   through ring prefill, against the single-rank engine's greedy texts;
   (c) (a)'s follower killed mid-decode: one error frame per in-flight
   session, the cluster dead within two heartbeat intervals, the gateway
   down.

In phases 5-14 the kernels' launch counts are zeroed just before the
sessions and read just after; every kernel of the served path must have
launched. Each served phase logs decode tok/s, TTFT p50/p99 from the
``done`` frames, batched prefill calls, shared-prefix tokens and decode
calls by kind. The line before the last is one JSON object listing the
kernels; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback
from collections import Counter

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 200 * 2**20   # rotate buffers past the 50 MB L2

REPO = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")

# Llama-3.2-1B decode shapes: (K, N) of the seven per-layer matmuls and
# how many of each a layer runs.
LAYER_MATMULS = {(2048, 2048): 2, (2048, 512): 2, (2048, 8192): 2,
                 (8192, 2048): 1}
LAYERS, SLOTS, VOCAB, HIDDEN = 16, 16, 128256, 2048
NQ, NKV, HEAD_DIM, MAX_LEN = 32, 8, 64, 2048
# The speculative verify block: TPU_SPEC_DRAFT (7) drafts + 1 positions, so
# its matmuls take SLOTS * VERIFY_T = 128 rows and attention T = 8.
VERIFY_T = 8
VERIFY_ROWS = SLOTS * VERIFY_T


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls: the calls are
    captured into one CUDA graph and the replay is timed with CUDA events,
    so the host's launch cost (eager PyTorch and ctypes) does not enter the
    figure. The served phases time steps while their server still runs its
    host sampler thread: the garbage collector stays off during the capture
    (a collection on another thread that frees a captured tensor or an
    event ends the capture), and only this thread's calls are checked."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    gc.disable()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for i in range(iters):
                fn(i)
    finally:
        gc.enable()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def copies_for(nbytes: int) -> int:
    return max(1, min(64, math.ceil(L2_FLUSH_BYTES / max(1, nbytes))))


# decode_attend is held slot by slot: each slot's largest |kernel - plain|
# against 1% of that slot's largest |plain| output. Kernel and plain both
# accumulate in f32 and round to bf16 once, and one bf16 step is at most
# 2^-7 (0.78%) of a value, so a right kernel stays under 1%. A slot over a
# long prefix averages hundreds of keys and its outputs are small, so a
# bound taken from the whole batch would let a missed or extra key pass.
ATTEND_SLOT_TOL = 1e-2


def attend_slot_gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[B]: max |got - ref| over slot b's outputs / max |ref| over them."""
    got, ref = got.float().flatten(1), ref.float().flatten(1)
    return (got - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(1e-30)


# ---------------------------------------------------------------- phase 2

INT4_GROUP = 128               # WEIGHT_QUANT_GROUP of the int4 tier


def check_int4_matmul(results: dict) -> None:
    """int4_matmul at the decode-step shapes, G = 128, M = 16, 1 and 128:
    held to 1% of the plain version's largest output; timed beside the
    plain version and ``torch.matmul`` on the pre-dequantized bf16 weight;
    the entry is one decode step at M = 16 (112 calls), with the same step
    at M = 1 in ``ms_m1`` and ``library_ms_m1`` and the verify block's
    M = 128 in ``ms_m128``, ``library_ms_m128`` and ``bound_ms_m128``."""
    from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul, int4_matmul_plain
    from fasttalk_tpu_torch.quantization.int4 import unpack_int4

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
            "ops": 0.0, "ms_m1": 0.0, "library_ms_m1": 0.0, "ms_m128": 0.0,
            "library_ms_m128": 0.0, "bytes_m128": 0.0, "ops_m128": 0.0}
    worst = 0.0
    for (k, n), per_layer in LAYER_MATMULS.items():
        groups = k // INT4_GROUP
        # Each copy has its own scales, as each layer of a decode step does,
        # so neither the packed weights nor the scales stay in L2.
        n_cp = copies_for(k * n // 2 + 4 * groups * n)
        q4s = [torch.randint(0, 256, (k // 2, n), generator=g, device=dev,
                             dtype=torch.uint8) for _ in range(n_cp)]
        ss = [torch.rand((groups, n), generator=g, device=dev) * 0.02 + 1e-3
              for _ in range(n_cp)]
        for m in (SLOTS, 1, VERIFY_ROWS):
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            got = int4_matmul(x, q4s[0], ss[0]).float()
            ref = int4_matmul_plain(x, q4s[0], ss[0]).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-2 * ref.abs().max().item()
            log(f"int4_matmul M={m} K={k} N={n} G={INT4_GROUP}: "
                f"max_abs_err={err:.6g} (tol {tol:.6g})")
            if not err <= tol:
                fail(f"int4_matmul disagrees with its plain version at "
                     f"M={m} K={k} N={n}: {err} > {tol}")
            worst = max(worst, err)
            ms = time_ms(lambda i: int4_matmul(x, q4s[i % n_cp],
                                               ss[i % n_cp]), 50)
            plain = time_ms(lambda i: int4_matmul_plain(x, q4s[i % n_cp],
                                                        ss[i % n_cp]), 10)
            ws = [(unpack_int4(q).float() * s.to(torch.bfloat16).float()
                   .repeat_interleave(INT4_GROUP, 0)).to(torch.bfloat16)
                  for q, s in zip(q4s[:max(1, n_cp // 4)], ss)]
            lib = time_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 50)
            del ws
            nbytes = k * n // 2 + 4 * groups * n + 2 * m * k + 2 * m * n
            ops = 2 * m * k * n
            b_ms, by = bound(nbytes, ops)
            log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
                f"bound_ms={b_ms:.6g} ({by})")
            calls = per_layer * LAYERS
            if m == SLOTS:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("bytes", nbytes),
                                 ("ops", ops)):
                    step[key] += calls * val
            elif m == 1:
                step["ms_m1"] += calls * ms
                step["library_ms_m1"] += calls * lib
            else:
                for key, val in (("ms_m128", ms), ("library_ms_m128", lib),
                                 ("bytes_m128", nbytes), ("ops_m128", ops)):
                    step[key] += calls * val
        del q4s, ss
    b_ms, by = bound(step["bytes"], step["ops"])
    results["int4_matmul"] = {
        "max_abs_err": worst, "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": b_ms, "bound_by": by, "library_ms": step["library_ms"],
        "ms_m1": step["ms_m1"], "library_ms_m1": step["library_ms_m1"],
        "ms_m128": step["ms_m128"], "library_ms_m128": step["library_ms_m128"],
        "bound_ms_m128": bound(step["bytes_m128"], step["ops_m128"])[0],
        "work": "one decode step at M=16: 112 calls over the 4 (K, N) "
                f"shapes, group {INT4_GROUP} (ms_m1, library_ms_m1: the "
                "same step at M=1; *_m128: the verify block's 128 rows)"}


def check_int8_matmul(results: dict) -> None:
    """int8_matmul at the decode-step shapes, M = 16, 1 and 128: held to 1%
    of the plain version's largest output; timed beside the plain version
    and ``torch.matmul`` on the dequantized bf16 weight. The entry is one
    decode step at M = 16 (112 calls), with the same step at M = 1 in
    ``ms_m1`` and ``library_ms_m1``, the verify block's M = 128 in
    ``ms_m128``, ``library_ms_m128`` and ``bound_ms_m128``, and every
    shape's figures in ``shapes``."""
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
            "bytes": 0.0, "ops": 0.0, "ms_m1": 0.0, "library_ms_m1": 0.0,
            "ms_m128": 0.0, "library_ms_m128": 0.0, "bytes_m128": 0.0,
            "ops_m128": 0.0}
    shapes = []
    worst = 0.0
    for (k, n), per_layer in LAYER_MATMULS.items():
        for m in (SLOTS, 1, VERIFY_ROWS):
            n_cp = copies_for(k * n)
            qs = [torch.randint(-127, 128, (k, n), generator=g, device=dev,
                                dtype=torch.int8) for _ in range(n_cp)]
            s = torch.rand((n,), generator=g, device=dev) * 0.02 + 1e-3
            x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
            got = int8_matmul(x, qs[0], s).float()
            ref = int8_matmul_plain(x, qs[0], s).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-2 * ref.abs().max().item()
            log(f"int8_matmul M={m} K={k} N={n}: max_abs_err={err:.6g} "
                f"(tol {tol:.6g})")
            if not err <= tol:
                fail(f"int8_matmul disagrees with its plain version at "
                     f"M={m} K={k} N={n}: {err} > {tol}")
            worst = max(worst, err)
            ms = time_ms(lambda i: int8_matmul(x, qs[i % n_cp], s), 50)
            plain = time_ms(lambda i: int8_matmul_plain(x, qs[i % n_cp], s),
                            10)
            ws = [(q.float() * s).to(torch.bfloat16) for q in qs[:max(
                1, n_cp // 2)]]
            lib = time_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 50)
            del ws
            nbytes = k * n + 4 * n + 2 * m * k + 2 * m * n
            ops = 2 * m * k * n
            b_ms, by = bound(nbytes, ops)
            log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
                f"bound_ms={b_ms:.6g} ({by})")
            shapes.append({"m": m, "k": k, "n": n, "ms": ms,
                           "plain_ms": plain, "library_ms": lib,
                           "bound_ms": b_ms, "max_abs_err": err})
            calls = per_layer * LAYERS
            if m == SLOTS:
                for key, val in (("ms", ms), ("plain_ms", plain),
                                 ("library_ms", lib), ("bound_ms", b_ms),
                                 ("bytes", nbytes), ("ops", ops)):
                    step[key] += calls * val
            elif m == 1:
                step["ms_m1"] += calls * ms
                step["library_ms_m1"] += calls * lib
            else:
                for key, val in (("ms_m128", ms), ("library_ms_m128", lib),
                                 ("bytes_m128", nbytes), ("ops_m128", ops)):
                    step[key] += calls * val
    b_ms, by = bound(step["bytes"], step["ops"])
    results["int8_matmul"] = {
        "max_abs_err": worst, "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": b_ms, "bound_by": by, "library_ms": step["library_ms"],
        "ms_m1": step["ms_m1"], "library_ms_m1": step["library_ms_m1"],
        "ms_m128": step["ms_m128"], "library_ms_m128": step["library_ms_m128"],
        "bound_ms_m128": bound(step["bytes_m128"], step["ops_m128"])[0],
        "shapes": shapes,
        "work": "one decode step at M=16: 112 calls over the 4 (K, N) "
                "shapes (ms_m1, library_ms_m1: the same step at M=1; "
                "*_m128: the verify block's 128 rows)"}


def check_int8_matmul_t(results: dict) -> None:
    """int8_matmul_t over the full lm_head table at M = 16 (the decode
    step), M = 1 (a prefill chunk) and M = 128 (the verify block), held and
    timed as check_int8_matmul does, beside ``F.linear`` on the dequantized
    bf16 table."""
    from fasttalk_tpu_torch.ops.cuda_int8 import (int8_matmul_t,
                                                  int8_matmul_t_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randint(-127, 128, (VOCAB, HIDDEN), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((VOCAB,), generator=g, device=dev) * 0.02 + 1e-3
    worst = 0.0
    entry, shapes = None, []
    for m in (SLOTS, 1, VERIFY_ROWS):
        x = torch.randn((m, HIDDEN), generator=g, device=dev).to(torch.bfloat16)
        got = int8_matmul_t(x, q, s).float()
        ref = int8_matmul_t_plain(x, q, s).float()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = 1e-2 * ref.abs().max().item()
        log(f"int8_matmul_t M={m} V={VOCAB} D={HIDDEN}: max_abs_err={err:.6g} "
            f"(tol {tol:.6g})")
        if not err <= tol:
            fail(f"int8_matmul_t disagrees with its plain version at M={m}: "
                 f"{err} > {tol}")
        worst = max(worst, err)
        ms = time_ms(lambda i: int8_matmul_t(x, q, s), 20)
        plain = time_ms(lambda i: int8_matmul_t_plain(x, q, s), 3, warmup=1)
        w = (q.float() * s[:, None]).to(torch.bfloat16)
        lib = time_ms(lambda i: torch.nn.functional.linear(x, w), 20)
        del w
        nbytes = VOCAB * HIDDEN + 4 * VOCAB + 2 * m * HIDDEN + 2 * m * VOCAB
        b_ms, by = bound(nbytes, 2 * m * VOCAB * HIDDEN)
        log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms={lib:.6g} "
            f"bound_ms={b_ms:.6g} ({by})")
        shapes.append({"m": m, "v": VOCAB, "d": HIDDEN, "ms": ms,
                       "plain_ms": plain, "library_ms": lib,
                       "bound_ms": b_ms, "max_abs_err": err})
        if m == SLOTS:
            entry = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib,
                     "work": "one call at M=16 (the decode step's lm_head; "
                             "ms_m1, library_ms_m1: one call at M=1, a "
                             "prefill chunk's; *_m128: the verify block's)"}
        elif m == 1:
            entry["ms_m1"], entry["library_ms_m1"] = ms, lib
        else:
            entry["ms_m128"], entry["library_ms_m128"] = ms, lib
            entry["bound_ms_m128"] = b_ms
    entry["max_abs_err"] = worst
    entry["shapes"] = shapes
    results["int8_matmul_t"] = entry


# Ragged slot lengths over a 2048-key context: block and tile edges
# (15/16/17, 31-33, 127-129, 511-513), the full context and one key short.
ATTEND_LENGTHS = [1, 15, 16, 17, 127, 128, 129, 2048, 1000, 511, 512, 513,
                  300, 1500, 2047, 33]
BLOCK = 16                      # KV_BLOCK_SIZE of the paged tier


def _int8_kv(shape: tuple, granule: int, g: torch.Generator,
             dev: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    from fasttalk_tpu_torch.ops.kv_quant import kv_quantize

    return kv_quantize(torch.randn(shape, generator=g, device=dev), granule)


def check_attend(results: dict, name: str, *, paged: bool, int8: bool,
                 seed: int) -> None:
    """One tier of the attention kernel at the decode-step shapes: 16 slots,
    lengths ``ATTEND_LENGTHS``; int8 at scale granule G = 1 and 8, T = 1,
    4 and 8 (T*G = 4, 16 and 32 query rows a KV head: one m16 tile, and two);
    paged through shuffled tables over the pool. Each slot is held to
    ATTEND_SLOT_TOL of its own largest output; T = 1, 4 and 8 are timed.
    The reported entry is one decode step (16 layer calls) at T = 1 and
    G = 1 (the served default), with the same step at T = 4 in ``ms_t4``
    and at T = 8 (the verify block) in ``ms_t8``, ``library_ms_t8`` and
    ``bound_ms_t8``."""
    from fasttalk_tpu_torch.ops import cuda_attention as ca
    from fasttalk_tpu_torch.ops.attention import paged_gather_indices

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = MAX_LEN // BLOCK
    elt = 1 if int8 else 2
    row_bytes = NKV * HEAD_DIM * elt
    rows = SLOTS * MAX_LEN
    n_cp = copies_for(2 * rows * row_bytes)
    worst, entry = 0.0, None
    for granule in ((1, NKV) if int8 else (0,)):
        kv = []
        for _ in range(n_cp):
            if int8:
                (k, ks), (v, vs) = (_int8_kv((rows, NKV, HEAD_DIM), granule,
                                             g, dev),
                                    _int8_kv((rows, NKV, HEAD_DIM), granule,
                                             g, dev))
            else:
                k, v = (torch.randn((rows, NKV, HEAD_DIM), generator=g,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(2))
                ks = vs = None
            kv.append((k, v, ks, vs))
        # Paged: the pool holds every slot's blocks, shuffled; dense: the
        # same rows viewed as [B, S, ...].
        perm = torch.randperm(SLOTS * nb, generator=torch.Generator(
            ).manual_seed(seed)).to(torch.int32).to(dev)
        tables = perm.view(SLOTS, nb).contiguous()
        idx = paged_gather_indices(tables, BLOCK).long()

        def call(i: int, q, lengths, fn):
            k, v, ks, vs = kv[i % n_cp]
            if paged:
                return (ca.decode_attend_paged if fn is None else fn)(
                    q, k, v, lengths, tables, block_size=BLOCK,
                    k_scale=ks, v_scale=vs)
            shape = (SLOTS, MAX_LEN)
            return (ca.decode_attend if fn is None else fn)(
                q, k.view(*shape, NKV, HEAD_DIM),
                v.view(*shape, NKV, HEAD_DIM), lengths,
                k_scale=None if ks is None else ks.view(*shape, granule),
                v_scale=None if vs is None else vs.view(*shape, granule))

        plain_fn = (ca.decode_attend_paged_plain if paged
                    else ca.decode_attend_plain)
        for t in (1, 4, 8):
            lens = [max(t, n) for n in ATTEND_LENGTHS]
            lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
            q = torch.randn((SLOTS, t, NQ, HEAD_DIM), generator=g,
                            device=dev).to(torch.bfloat16)
            got = call(0, q, lengths, None).float()
            ref = call(0, q, lengths, plain_fn).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            gaps = attend_slot_gaps(got, ref)
            ws = int(gaps.argmax())
            label = f"{name} T={t}" + (f" G={granule}" if int8 else "")
            log(f"{label} B={SLOTS} keys<={MAX_LEN}: max_abs_err={err:.6g}; "
                f"per slot max|err|/max|ref| "
                f"{[round(x, 6) for x in gaps.tolist()]}, worst "
                f"{gaps[ws].item():.6g} at length {lens[ws]} "
                f"(tol {ATTEND_SLOT_TOL})")
            if not bool((gaps <= ATTEND_SLOT_TOL).all()):
                fail(f"{label} disagrees with its plain version: slot gaps "
                     f"{gaps.tolist()} > {ATTEND_SLOT_TOL}")
            worst = max(worst, err)
            ms = time_ms(lambda i: call(i, q, lengths, None), 50)
            plain = time_ms(lambda i: call(i, q, lengths, plain_fn), 5)
            lib = None
            if not (paged and int8):
                # Library yardstick: SDPA with GQA and a length mask over a
                # dense bf16 [B, H, S, D] copy of the same keys (it reads the
                # whole S; it cannot prune, and it reads no paged int8 pool).
                k, v, ks, vs = kv[0]
                if int8:
                    k = (k.float() * ks[..., None]).to(torch.bfloat16)
                    v = (v.float() * vs[..., None]).to(torch.bfloat16)
                src = (idx if paged else torch.arange(
                    rows, device=dev).view(SLOTS, MAX_LEN))
                kt = k[src].transpose(1, 2).contiguous()
                vt = v[src].transpose(1, 2).contiguous()
                qt = q.transpose(1, 2)
                horizon = (lengths[:, None] - (t - 1)
                           + torch.arange(t, device=dev)[None])
                mask = (torch.arange(MAX_LEN, device=dev)[None, None, None, :]
                        < horizon[:, None, :, None])
                lib = time_ms(lambda i: torch.nn.functional.
                              scaled_dot_product_attention(
                                  qt, kt, vt, attn_mask=mask, enable_gqa=True),
                              50)
                del kt, vt
            live = sum(lens)
            scale_bytes = 2 * live * granule * 4 if int8 else 0
            nbytes = (2 * live * row_bytes + scale_bytes + 2 * q.numel() * 2
                      + 4 * SLOTS + (4 * SLOTS * nb if paged else 0))
            ops = 4 * live * NQ * HEAD_DIM * t
            b_ms, by = bound(nbytes, ops)
            log(f"  ms={ms:.6g} plain_ms={plain:.6g} library_ms="
                f"{'none' if lib is None else f'{lib:.6g}'} "
                f"bound_ms={b_ms:.6g} ({by})")
            if t == 1 and granule in (0, 1):
                calls = LAYERS
                entry = {"ms": calls * ms, "plain_ms": calls * plain,
                         "bound_ms": calls * b_ms, "bound_by": by,
                         "library_ms": None if lib is None else calls * lib,
                         "work": f"one decode step at T=1: 16 calls, B=16, "
                                 f"lengths {lens}"
                                 + (", scale granule 1" if int8 else "")
                                 + (f", {BLOCK}-token blocks" if paged
                                    else "")
                                 + "; ms_t4, *_t8: the same step at T=4 "
                                   "and T=8"}
            elif t == 4 and granule in (0, 1):
                entry["ms_t4"] = LAYERS * ms
            elif granule in (0, 1):
                entry["ms_t8"] = LAYERS * ms
                entry["bound_ms_t8"] = LAYERS * b_ms
                entry["library_ms_t8"] = None if lib is None else LAYERS * lib
        del kv
    entry["max_abs_err"] = worst
    results[name] = entry


# ---------------------------------------------------------------- phase 3

@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel call sites to the plain versions."""
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.ops import (cuda_attention, cuda_int4, cuda_int8,
                                        quant)

    saved = (quant.int8_matmul, quant.int8_matmul_t, quant.int4_matmul,
             llama.decode_attend, llama.decode_attend_paged)
    quant.int8_matmul = cuda_int8.int8_matmul_plain
    quant.int8_matmul_t = cuda_int8.int8_matmul_t_plain
    quant.int4_matmul = cuda_int4.int4_matmul_plain
    llama.decode_attend = cuda_attention.decode_attend_plain
    llama.decode_attend_paged = cuda_attention.decode_attend_paged_plain
    try:
        yield
    finally:
        (quant.int8_matmul, quant.int8_matmul_t, quant.int4_matmul,
         llama.decode_attend, llama.decode_attend_paged) = saved


def check_full_width_model(weight_quant: str, tiers: tuple[str, ...]) -> None:
    """Prefill and 4 decode steps of llama3.2:1b with ``weight_quant``
    random weights, kernels against plain, on each KV tier of ``tiers``
    ("dense bf16", "paged int8"). The paged prefill runs as the engine's
    does: the dense forward over a cache of the tier, its rows then
    scattered into the pool through shuffled block tables."""
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.models.configs import get_model_config
    from fasttalk_tpu_torch.models.loader import init_params_device
    from fasttalk_tpu_torch.ops.attention import paged_gather_indices

    dev = torch.device("cuda")
    cfg = get_model_config("llama3.2:1b")
    t0 = time.monotonic()
    params = init_params_device(cfg, torch.bfloat16, dev,
                                quantize=weight_quant, seed=0,
                                weight_quant_group=INT4_GROUP)
    torch.cuda.synchronize()
    log(f"llama3.2:1b {weight_quant} random init on the card: "
        f"{time.monotonic() - t0:.3f} s")
    b, t, steps, ctx = SLOTS, 64, 4, 512
    nb = ctx // BLOCK
    for kv_tier in tiers:
        tier = f"{weight_quant} weights, {kv_tier}"
        paged = kv_tier.startswith("paged")
        g = torch.Generator(device=dev).manual_seed(4)
        prompt = torch.randint(0, 32000, (b, t), generator=g, device=dev)
        pos = torch.arange(t, device=dev)[None].expand(b, t)
        caches = [llama.init_cache(cfg, b, MAX_LEN, torch.bfloat16, dev,
                                   quantized=paged) for _ in range(2)]
        logits = []
        for cache, ctxm in ((caches[0], contextlib.nullcontext()),
                            (caches[1], plain_kernels())):
            with ctxm:
                lg, _ = llama.forward(
                    params, cfg, prompt, pos, cache,
                    torch.zeros(b, dtype=torch.long, device=dev),
                    blockwise=True,
                    logits_indices=torch.full((b,), t - 1, device=dev))
                logits.append([lg[:, 0]])
        table = None
        if paged:
            table = torch.randperm(b * nb, generator=torch.Generator(
                ).manual_seed(5)).to(torch.int32).to(dev).view(b, nb)
            idx = paged_gather_indices(table, BLOCK).long()
            pools = []
            for cache in caches:
                pool = llama.init_paged_cache(cfg, b * nb, BLOCK,
                                              torch.bfloat16, dev,
                                              quantized=True)
                for dst, src in zip(pool, cache):
                    dst[:, idx.flatten()] = src[:, :, :ctx].flatten(1, 2)
                pools.append(pool)
            caches = pools
        # Decode: both paths are fed the kernel path's greedy tokens.
        cur = logits[0][0].argmax(-1)
        mask = torch.ones(b, dtype=torch.bool, device=dev)
        kw = dict(attn_len=ctx, block_table=table,
                  block_size=BLOCK if paged else 0)
        for i in range(steps):
            p = torch.full((b,), t + i, dtype=torch.long, device=dev)
            lk, _ = llama.forward_decode(params, cfg, cur, p, caches[0], mask,
                                         **kw)
            with plain_kernels():
                lp, _ = llama.forward_decode(params, cfg, cur, p, caches[1],
                                             mask, **kw)
            logits[0].append(lk)
            logits[1].append(lp)
            cur = lk.argmax(-1)
        torch.cuda.synchronize()
        agree = total = 0
        for i, (lk, lp) in enumerate(zip(*logits)):
            span = (lp.max() - lp.min()).item()
            err = (lk - lp).abs().max().item()
            same = (lk.argmax(-1) == lp.argmax(-1)).sum().item()
            agree += same
            total += lk.shape[0]
            log(f"llama3.2:1b {tier} "
                f"{'prefill' if i == 0 else f'decode {i}'}: "
                f"max|kernel-plain|={err:.6g} logit range={span:.6g} "
                f"greedy agree {same}/{lk.shape[0]}")
            if not (math.isfinite(err) and err <= 0.05 * span):
                fail(f"full-width {tier} logits differ beyond 5% of the "
                     f"range: {err}")
        if agree < 0.9 * total:
            fail(f"{tier}: greedy tokens agree on only {agree}/{total} rows")
        del caches
    del params


# ------------------------------------------------------------- phase 4/5

def check_tinychat(weight_quant: str = "int8", **kv) -> tuple[str, dict]:
    """The greedy answer of the trained tinychat checkpoint to "what color
    is the sky?" through ``build_engine`` with ``weight_quant`` and the
    Config settings ``kv``; fails unless it names blue. Returns the text
    and the engine's stats."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    # The checkpoint goes through the loader and its quantization on every
    # run: a prepared cache (one left by the quantize command included)
    # would stand in for the load path under check.
    engine = build_engine(Config(model_name="tinychat", model_path=ASSETS,
                                 weight_quant=weight_quant, decode_slots=4,
                                 max_model_len=512,
                                 default_context_window=512, **kv),
                          device="cuda", prepared_cache=False)
    engine.start()
    try:
        async def run():
            text, final = "", {}
            async for ev in engine.generate(
                    "sky", "sky", [{"role": "user",
                                    "content": "what color is the sky?"}],
                    GenerationParams(max_tokens=48, temperature=0.0,
                                     top_k=0, top_p=1.0)):
                if ev["type"] == "token":
                    text += ev["text"]
                else:
                    final = ev
            return text, final
        text, final = asyncio.run(asyncio.wait_for(run(), timeout=120))
    finally:
        engine.shutdown()
    log(f"tinychat {weight_quant} greedy, {kv or 'dense bf16 KV'}: {text!r} "
        f"({final.get('finish_reason')})")
    if final.get("type") != "done" or "blue" not in text.lower():
        fail(f"tinychat answer is wrong: {text!r} {final}")
    return text, engine.get_stats()


def check_tinychat_spec(weight_quant: str = "int8", **kv) -> None:
    """Greedy tinychat with TPU_SPEC_DECODE=ngram gives the tokens of
    TPU_SPEC_DECODE=off (speculative decoding is a throughput transform),
    and verify blocks really ran."""
    plain, _ = check_tinychat(weight_quant, spec_decode="off", **kv)
    spec, stats = check_tinychat(weight_quant, spec_decode="ngram", **kv)
    if spec != plain:
        fail(f"tinychat {weight_quant} {kv}: ngram greedy {spec!r} differs "
             f"from plain {plain!r}")
    if stats["spec"]["verify_blocks"] <= 0:
        fail(f"tinychat {weight_quant} {kv}: no verify block ran")


# ------------------------------------------------------- phases 4 and 10

def doc_ok(doc, schema: dict) -> bool:
    """Whether ``doc`` meets ``schema``, for the schema subset used here
    (objects with every property required, enums, booleans, strings with
    maxLength), checked by hand and not by the port's schema module."""
    if "enum" in schema:
        return any(doc == v and type(doc) is type(v) for v in schema["enum"])
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        return isinstance(doc, dict) and list(doc) == list(props) and all(
            doc_ok(doc[k], props[k]) for k in props)
    if t == "string":
        return isinstance(doc, str) \
            and len(doc) <= schema.get("maxLength", len(doc))
    if t == "boolean":
        return isinstance(doc, bool)
    return False


def json_tinychat() -> str:
    """A model root holding tinychat whose tokenizer has the JSON
    punctuation and digits as single-byte tokens in the embedding headroom
    (the committed BPE cannot spell "{"); made under build/ from the
    checkpoint in the checkout."""
    import shutil

    src = os.path.join(ASSETS, "tinychat")
    root = os.path.join(REPO, "build", "chip_smoke", "tinychat-json")
    ckpt = os.path.join(root, "tinychat")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(ckpt)
    for name in ("config.json", "tokenizer_config.json", "model.safetensors"):
        shutil.copy(os.path.join(src, name), os.path.join(ckpt, name))
    with open(os.path.join(src, "tokenizer.json")) as f:
        tok = json.load(f)
    vocab = tok["model"]["vocab"]
    next_id = max(vocab.values()) + 1
    for ch in "\"{}[]:,0123456789-+.\\/<>_":
        if ch not in vocab:
            vocab[ch] = next_id
            next_id += 1
    with open(os.path.join(ckpt, "tokenizer.json"), "w") as f:
        json.dump(tok, f)
    return root


# Phase 4's schema: digits are single-byte tokens of the patched tinychat
# vocabulary, so the numeric key is a long forced chain (jump-forward's
# case).
TINYCHAT_SCHEMA = {"type": "object", "properties": {
    "12345678901234567890": {"enum": ["blue", "red"]},
    "name": {"type": "string", "maxLength": 8}}}


def check_tinychat_structured() -> None:
    """The trained tinychat checkpoint (int8 weights, dense bf16 KV) answers
    a ``response_format`` json_schema request greedily: with jump-forward on
    (STRUCTURED_JF_MIN=4, the default) the answer equals the one with it
    off (0) token for token, parses, meets the schema and ends with
    "stop", and jump-forward emitted tokens."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.openai_api import _parse_response_format
    from fasttalk_tpu_torch.utils.config import Config

    spec = _parse_response_format({"response_format": {
        "type": "json_schema",
        "json_schema": {"name": "sky", "schema": TINYCHAT_SCHEMA}}})
    root = json_tinychat()
    answers = {}
    for jf in (4, 0):
        engine = build_engine(Config(model_name="tinychat", model_path=root,
                                     weight_quant="int8", decode_slots=4,
                                     max_model_len=512,
                                     default_context_window=512,
                                     structured_jf_min=jf),
                              device="cuda", prepared_cache=False)
        engine.start()
        try:
            async def run():
                text, final = "", {}
                async for ev in engine.generate(
                        "sky-json", "sky-json",
                        [{"role": "user",
                          "content": "what color is the sky?"}],
                        GenerationParams(max_tokens=64, temperature=0.0,
                                         top_k=0, top_p=1.0,
                                         structured=spec)):
                    if ev["type"] == "token":
                        text += ev["text"]
                    else:
                        final = ev
                return text, final
            text, final = asyncio.run(asyncio.wait_for(run(), timeout=120))
            # The session keeps its slot: prompt and answer token ids.
            slot = engine.slots.lookup("sky-json")
            slot_tokens = list(slot.tokens) if slot is not None else None
            st = engine.get_stats()["structured"]
        finally:
            engine.shutdown()
        answers[jf] = (text, slot_tokens, final.get("finish_reason"),
                       st["jump_forward_tokens"])
        log(f"tinychat int8 response_format json_schema, STRUCTURED_JF_MIN="
            f"{jf}: {text!r} ({final.get('finish_reason')}, "
            f"{st['jump_forward_tokens']} jump-forward tokens)")
    (text, ids, reason, jumped), (text0, ids0, reason0, _) = \
        answers[4], answers[0]
    if (text, ids) != (text0, ids0):
        fail(f"tinychat structured: jump-forward on {text!r} differs from "
             f"off {text0!r}")
    if reason != "stop" or reason0 != "stop":
        fail(f"tinychat structured: finish {reason}/{reason0}, not stop")
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        fail(f"tinychat structured answer does not parse: {text!r}")
    if not doc_ok(doc, TINYCHAT_SCHEMA):
        fail(f"tinychat structured answer misses the schema: {doc!r}")
    if jumped <= 0:
        fail("tinychat structured: jump-forward emitted no token")


# Phase 10's schema: a string, an enum, a boolean and an integer bounded to
# 1..5 (an integer enum: the schema compiler refuses minimum/maximum by
# name). The first key is a hex tag: in the bench BPE every prefix of an
# ordinary word is a token of its own, so word keys force chains of at most
# 2 tokens; this key forces 8-9, the run jump-forward takes at
# STRUCTURED_JF_MIN=4.
SERVED_SCHEMA = {"type": "object", "properties": {
    "0x7f3a9c": {"type": "string", "maxLength": 6},
    "mood": {"enum": ["happy", "sad", "calm"]},
    "urgent": {"type": "boolean"},
    "rating": {"enum": [1, 2, 3, 4, 5]}}}
WEATHER_TOOL = {"type": "function", "function": {
    "name": "get_weather", "description": "Current weather for a city.",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string", "maxLength": 12},
        "units": {"enum": ["C", "F"]}}}}}


async def drive_structured(engine, port: int, constrained: int,
                           plain: int = 8, plain_tokens: int = 64) -> dict:
    """One burst, every request at once: ``constrained`` /v1 chat
    completions with ``response_format`` json_schema (every other one
    streamed), one with ``tools`` and a forced ``tool_choice``, one
    WebSocket session with the ``structured`` session key, and ``plain``
    /v1 streams with ``ignore_eos`` of ``plain_tokens`` tokens. The engine's
    terminal event of every request is kept by session (a wrapper around
    ``generate``, removed after)."""
    import aiohttp

    url = f"http://127.0.0.1:{port}"
    errors: list[str] = []
    terminal: dict[str, dict] = {}
    ended: dict[str, float] = {}
    generate = engine.generate

    async def recording(rid, sid, messages, params):
        async for ev in generate(rid, sid, messages, params):
            if ev["type"] in ("done", "cancelled", "error"):
                terminal[sid] = ev
                ended[sid] = time.monotonic()
            yield ev

    engine.generate = recording
    sampling = {"temperature": 0.7, "repeat_penalty": 1.0}
    rf = {"type": "json_schema",
          "json_schema": {"name": "ticket", "schema": SERVED_SCHEMA}}

    async def chat(http, sid: str, body: dict) -> dict | None:
        body = {**body, "user": sid}
        async with http.post(url + "/v1/chat/completions", json=body) as r:
            if r.status != 200:
                errors.append(f"{sid}: HTTP {r.status} {await r.text()}")
                return None
            if not body.get("stream"):
                out = await r.json()
                choice = out["choices"][0]
                return {"text": choice["message"]["content"],
                        "calls": choice["message"].get("tool_calls", []),
                        "finish": choice["finish_reason"]}
            text, calls, finish, done = "", [], None, False
            async for raw in r.content:
                line = raw.decode().strip()
                if not line.startswith("data: "):
                    continue
                if line == "data: [DONE]":
                    done = True
                    break
                chunk = json.loads(line[6:])
                if "error" in chunk:
                    errors.append(f"{sid}: error frame {chunk['error']}")
                    continue
                choice = chunk["choices"][0]
                text += choice["delta"].get("content") or ""
                calls += choice["delta"].get("tool_calls", [])
                finish = choice["finish_reason"] or finish
            if not done:
                errors.append(f"{sid}: stream ended without [DONE]")
            return {"text": text, "calls": calls, "finish": finish}

    async def ws_session(http, sid: str) -> dict | None:
        async with http.ws_connect(f"{url}/ws/llm") as ws:
            started = json.loads((await ws.receive()).data)
            await ws.send_json({"type": "start_session", "config": {
                "max_tokens": 96, **sampling,
                "structured": {"kind": "json_schema",
                               "schema": SERVED_SCHEMA}}})
            json.loads((await ws.receive()).data)
            await ws.send_json({"type": "user_message",
                                "text": "File a ticket about the weather."})
            text, out = "", None
            while True:
                m = json.loads((await ws.receive()).data)
                if m["type"] == "token":
                    text += m["data"]
                    continue
                if m["type"] == "response_complete":
                    out = {"text": text, "calls": [],
                           "finish": m["stats"]["finish_reason"],
                           "engine_session": started["session_id"]}
                else:
                    errors.append(f"{sid}: {json.dumps(m)}")
                break
            await ws.send_json({"type": "end_session"})
            json.loads((await ws.receive()).data)
        return out

    jobs: dict[str, tuple[str, object]] = {}
    async with aiohttp.ClientSession() as http:
        for i in range(constrained):
            jobs[f"json-{i}"] = ("constrained", chat(http, f"json-{i}", {
                "messages": [{"role": "user",
                              "content": f"File ticket number {i}."}],
                "max_tokens": 96, "stream": i % 2 == 1,
                "response_format": rf, **sampling}))
        jobs["tool-0"] = ("tool", chat(http, "tool-0", {
            "messages": [{"role": "user",
                          "content": "What is the weather in Oslo?"}],
            "max_tokens": 160, "tools": [WEATHER_TOOL], **sampling,
            "tool_choice": {"type": "function",
                            "function": {"name": "get_weather"}}}))
        jobs["ws-0"] = ("ws", ws_session(http, "ws-0"))
        prompts = ["Tell me about the ocean.", "What is a good breakfast?",
                   "Explain how trains work.", "Why is the sky blue?"]
        for i in range(plain):
            jobs[f"plain-{i}"] = ("plain", chat(http, f"plain-{i}", {
                "messages": [{"role": "user",
                              "content": prompts[i % len(prompts)]}],
                "max_tokens": plain_tokens, "ignore_eos": True,
                "temperature": 0.7, "stream": True}))
        t0 = time.monotonic()
        outs = await asyncio.gather(*(c for _, c in jobs.values()))
        wall = time.monotonic() - t0
    del engine.generate
    answers = {sid: {"kind": kind, "answer": out}
               for (sid, (kind, _)), out in zip(jobs.items(), outs)}
    for sid, a in answers.items():
        # A /v1 request's engine session is its "user"; the WebSocket
        # session's is the server's own id.
        key = (a["answer"] or {}).get("engine_session", sid)
        if key in terminal:
            a["done"] = terminal[key]
            a["ended"] = ended[key] - t0
    return {"answers": answers, "errors": errors, "wall_s": wall}


def check_structured_burst(label: str, out: dict, plain_tokens: int) -> dict:
    """Phase 10's checks on one burst; returns its per-kind figures."""
    if out["errors"]:
        fail(f"{label}: errors: {out['errors'][:3]}")
    kinds: dict[str, dict] = {}
    for sid, a in out["answers"].items():
        ans, done = a["answer"], a.get("done")
        if ans is None or done is None or done["type"] != "done":
            fail(f"{label}: {sid} did not complete: {ans} {done}")
        stats = done["stats"]
        k = kinds.setdefault(a["kind"], {"tokens": 0, "ttft_ms": [],
                                         "last_s": 0.0, "requests": 0})
        k["tokens"] += stats["tokens_generated"]
        k["ttft_ms"].append(stats["ttft_ms"])
        k["last_s"] = max(k["last_s"], a["ended"])
        k["requests"] += 1
        if a["kind"] == "plain":
            if stats["tokens_generated"] != plain_tokens:
                fail(f"{label}: {sid} streamed {stats['tokens_generated']} "
                     f"tokens, not {plain_tokens}")
            continue
        if a["kind"] == "tool":
            calls = ans["calls"]
            if ans["finish"] != "tool_calls" or len(calls) != 1 \
                    or calls[0]["function"]["name"] != "get_weather":
                fail(f"{label}: tool call answer {ans}")
            try:
                args = json.loads(calls[0]["function"]["arguments"])
            except json.JSONDecodeError:
                fail(f"{label}: tool arguments do not parse: {calls}")
            if not doc_ok(args, WEATHER_TOOL["function"]["parameters"]):
                fail(f"{label}: tool arguments miss the parameters: {args}")
            continue
        if ans["finish"] != "stop":
            fail(f"{label}: {sid} finished {ans['finish']!r}: {ans['text']!r}")
        try:
            doc = json.loads(ans["text"])
        except json.JSONDecodeError:
            fail(f"{label}: {sid} does not parse: {ans['text']!r}")
        if not doc_ok(doc, SERVED_SCHEMA):
            fail(f"{label}: {sid} misses the schema: {doc!r}")
    for k in kinds.values():
        k["tok_s"] = k["tokens"] / k["last_s"] if k["last_s"] else None
        k["ttft_p50_ms"] = pct(k["ttft_ms"], 50)
        k["ttft_p99_ms"] = pct(k["ttft_ms"], 99)
    return kinds


async def drive_sessions(port: int, n: int, max_tokens: int,
                         temperature: float = 0.7) -> dict:
    import aiohttp

    prompts = ["Tell me about the ocean.", "What is a good breakfast?",
               "Explain how trains work.", "Write a short poem about rain.",
               "Why is the sky blue?", "Give me three tips for sleep.",
               "What is your favourite book?", "How do plants grow?"]

    async def one(i: int, http) -> tuple[int, list[str], float | None]:
        errors = []
        tokens, ttft = 0, None
        async with http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm") as ws:
            first = json.loads((await ws.receive()).data)
            if first["type"] != "session_started":
                errors.append(str(first))
            await ws.send_json({"type": "start_session", "config": {
                "max_tokens": max_tokens, "temperature": temperature,
                "ignore_eos": True}})
            json.loads((await ws.receive()).data)
            await ws.send_json({"type": "user_message",
                                "text": prompts[i % len(prompts)]})
            while True:
                m = json.loads((await ws.receive()).data)
                if m["type"] == "token":
                    continue
                if m["type"] == "response_complete":
                    tokens = m["stats"]["tokens_generated"]
                    ttft = m["stats"]["ttft_ms"]
                else:
                    errors.append(json.dumps(m))
                break
            await ws.send_json({"type": "end_session"})
            json.loads((await ws.receive()).data)
        return tokens, errors, ttft

    async with aiohttp.ClientSession() as http:
        t0 = time.monotonic()
        res = await asyncio.gather(*(one(i, http) for i in range(n)))
        wall = time.monotonic() - t0
    return {"sessions": n, "tokens": sum(r[0] for r in res),
            "errors": [e for r in res for e in r[1]], "wall_s": wall,
            "ttft_ms": sorted(r[2] for r in res if r[2] is not None)}


def serve_main_path(drive, max_len: int = MAX_LEN, weight_quant: str = "int8",
                    **kv):
    """Serve the main path and return ``await drive(engine, port)``.

    Builds the engine through ``build_engine`` as ``python -m
    fasttalk_tpu_torch websocket`` does (llama3.2:1b at full width,
    ``weight_quant`` random weights (int8, or int4 with group 128), 16
    slots, max_len 2048, prefill chunk 512; ``kv`` overrides the KV
    settings of ``Config``, e.g. ``kv_layout="paged"``),
    serves it on an ephemeral localhost port, runs one short warm-up
    session (the first CUDA launches), then hands the port to ``drive``.
    Server and engine are stopped before this returns.
    """
    from aiohttp import web

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    cfg = Config(model_name="llama3.2:1b", model_path="",
                 weight_quant=weight_quant, weight_quant_group=INT4_GROUP,
                 decode_slots=SLOTS, max_model_len=max_len, prefill_chunk=512,
                 default_context_window=max_len, default_max_tokens=64, **kv)
    t0 = time.monotonic()
    engine = build_engine(cfg, device="cuda")
    log(f"build_engine (llama3.2:1b {weight_quant}, 16 slots, max_len "
        f"{max_len}, KV {kv or 'dense bf16'}): {time.monotonic() - t0:.3f} s")
    engine.start()

    async def run():
        runner = web.AppRunner(WebSocketLLMServer(cfg, engine).app)
        await runner.setup()
        try:
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            port = site._server.sockets[0].getsockname()[1]
            warm = await drive_sessions(port, 1, 8)
            if warm["errors"]:
                fail(f"warm-up session failed: {warm['errors']}")
            return await drive(engine, port)
        finally:
            await runner.cleanup()

    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=600))
    finally:
        engine.shutdown()


def pct(values: list[float], q: float) -> float | None:
    """Nearest-rank percentile (None for no values)."""
    if not values:
        return None
    return sorted(values)[min(len(values) - 1,
                              max(0, math.ceil(q / 100 * len(values)) - 1))]


def stat_delta(before: dict, after: dict) -> dict:
    """What the engine did between two ``get_stats()``: decode calls by
    kind, host enqueue time, verify blocks and drafts, batched prefill and
    shared-prefix rows."""
    d = {k: after[k] - before[k] for k in (
        "decode_calls", "decode_steps", "decode_host_s",
        "batched_prefill_calls", "batched_prefill_rows",
        "prefix_tokens_shared")}
    sa, sb = after["spec"], before["spec"]
    for k in ("calls", "steps", "host_s", "verify_blocks", "accepted",
              "drafted"):
        d["spec_" + k if k in ("calls", "steps", "host_s") else k] = \
            sa[k] - sb[k]
    d["plain_calls"] = d["decode_calls"] - d["spec_calls"]
    blocks = d["verify_blocks"]
    d["tokens_per_verify"] = ((d["accepted"] + blocks) / blocks
                              if blocks else None)
    d["spec_host_ms_per_call"] = (1e3 * d["spec_host_s"] / d["spec_calls"]
                                  if d["spec_calls"] else None)
    d["plain_host_ms_per_call"] = (
        1e3 * (d["decode_host_s"] - d["spec_host_s"]) / d["plain_calls"]
        if d["plain_calls"] else None)
    return d


# ----------------------------------------- phases 4 and 11: KV hierarchy

def check_tinychat_multiturn(**kv) -> None:
    """Phase 4, multi-turn: the trained tinychat's second greedy turn of a
    session ("my name is Ada." then "what is my name?", int8 weights, spec
    off) equals the never-evicted answer token for token (the slot's token
    ids) after a radix hit (the session released between the turns; paged
    only) and after a park on eviction and a restore (two other sessions
    fill both slots between the turns), once from the pinned host rows and
    once from rows prestaged before the turn. ``kv``: the KV layout and
    tier."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    msg1 = [{"role": "user", "content": "my name is Ada."}]
    filler = [{"role": "user", "content": "what color is the sky?"}]

    def build(**extra):
        engine = build_engine(Config(
            model_name="tinychat", model_path=ASSETS, weight_quant="int8",
            decode_slots=2, max_model_len=512, default_context_window=512,
            spec_decode="off", kv_park_idle_s=0.0, kv_restore_min_tokens=8,
            **kv, **extra), device="cuda", prepared_cache=False)
        engine.start()
        return engine

    async def turn(engine, rid, sid, msgs):
        text, final = "", {}
        async for ev in engine.generate(rid, sid, msgs, GenerationParams(
                max_tokens=24, temperature=0.0, top_k=0, top_p=1.0)):
            if ev["type"] == "token":
                text += ev["text"]
            else:
                final = ev
        if final.get("type") != "done":
            fail(f"tinychat multi-turn {kv}: {final}")
        return text

    def wait(pred):
        deadline = time.monotonic() + 30
        while not pred():
            if time.monotonic() > deadline:
                fail(f"tinychat multi-turn {kv}: timed out")
            time.sleep(0.01)

    def two_turns(engine, between=None):
        try:
            async def run():
                r1 = await turn(engine, "t1", "A", msg1)
                if between is not None:
                    await between(engine)
                await turn(engine, "t2", "A", msg1 + [
                    {"role": "assistant", "content": r1},
                    {"role": "user", "content": "what is my name?"}])
                return list(engine.slots.lookup("A").tokens)
            tokens = asyncio.run(asyncio.wait_for(run(), timeout=120))
            return tokens, engine.get_stats()
        finally:
            engine.shutdown()

    async def release(engine):
        engine.release_session("A")
        await asyncio.to_thread(wait, lambda: engine.slots.lookup("A") is None)

    async def evict(engine):
        await turn(engine, "f1", "B", filler)
        await turn(engine, "f2", "C", filler)
        await asyncio.to_thread(
            wait, lambda: engine._kv_pool.parked_len("A") > 0)

    async def evict_and_stage(engine):
        # The restore then reads the rows the offload thread uploaded on
        # its side stream (the restore's stream waits for their event).
        await evict(engine)
        engine._kv_offload.prestage("A")
        await asyncio.to_thread(
            wait, lambda: engine._kv_pool.get("A").k_dev is not None)

    want, _ = two_turns(build())
    pool = dict(kv_host_budget_mb=256.0)
    checks = [("park and restore", pool, evict),
              ("prestaged restore", pool, evict_and_stage)]
    if kv.get("kv_layout") == "paged":
        checks.insert(0, ("radix hit", dict(kv_radix_enabled=True), release))
    for name, extra, between in checks:
        got, stats = two_turns(build(**extra), between)
        if name == "radix hit" and stats["kv_radix"]["hits"] < 1:
            fail(f"tinychat multi-turn {kv}: no radix hit")
        if name != "radix hit" and (
                stats["kv_host"]["restored_total"] < 1
                or stats["kv_host"]["restore_failed"]):
            fail(f"tinychat multi-turn {kv}: no clean restore: "
                 f"{stats['kv_host']}")
        if got != want:
            fail(f"tinychat multi-turn {kv}, {name}: turn 2 tokens differ "
                 f"from the never-evicted session's")
        log(f"tinychat multi-turn {kv or 'dense bf16 KV'}, {name}: turn 2 "
            f"equals the never-evicted answer ({len(got)} tokens)")


# About 1,000 tokens of the bench BPE (949 for the sentences alone), so a
# first turn's prompt stays inside the 1024 bucket of one batched prefill.
SYSTEM_1K = " ".join(
    f"Rule {i}: keep every answer short and friendly, name the source when "
    f"you can, and never guess about item {i}." for i in range(38))


async def drive_turns(engine, port: int, waves: list[int], turns: int,
                      max_tokens: int, release: bool, keep: int = 0,
                      temperature: float = 0.7) -> dict:
    """Multi-turn WebSocket sessions sharing ``SYSTEM_1K``: ``waves`` sizes
    the groups of sessions; every turn runs wave after wave (A1, B1, A2,
    B2, ...), the sessions of one wave concurrently. After each turn the
    pool's aliased block count is sampled, and with ``release`` the
    session is released in the engine (its next turn finds no resident
    slot), but for the first ``keep`` sessions, which instead change one
    character in the middle of their system prompt before their second
    turn (``update_config``): that turn's history diverges inside blocks
    the radix tree shares, so they are copied on write. Returns per-stage
    turn results and the peak aliased count."""
    import aiohttp

    peak = {"aliased": 0}

    async def open_session(http, i):
        ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
        first = json.loads((await ws.receive()).data)
        await ws.send_json({"type": "start_session", "config": {
            "max_tokens": max_tokens, "temperature": temperature,
            "ignore_eos": True, "system_prompt": SYSTEM_1K}})
        json.loads((await ws.receive()).data)
        return ws, first.get("session_id")

    async def turn(ws, sid, text, kept, t):
        out = {"errors": [], "tokens": 0, "ttft": None}
        if kept and t == 1:
            await ws.send_json({"type": "update_config", "config": {
                "system_prompt": SYSTEM_1K[:2000] + "X" + SYSTEM_1K[2001:]}})
            m = json.loads((await ws.receive()).data)
            if m["type"] != "config_updated":
                out["errors"].append(json.dumps(m))
        await ws.send_json({"type": "user_message", "text": text})
        while True:
            m = json.loads((await ws.receive()).data)
            if m["type"] == "token":
                continue
            if m["type"] == "response_complete":
                st = m["stats"]
                out.update(tokens=st["tokens_generated"], ttft=st["ttft_ms"],
                           prompt=st["prompt_tokens"],
                           prefill=st["prefill_tokens"])
            else:
                out["errors"].append(json.dumps(m))
            break
        if engine.paged:
            peak["aliased"] = max(peak["aliased"],
                                  engine._kv_blocks.stats()["aliased"])
        if release and not kept:
            engine.release_session(sid)
        return out

    async with aiohttp.ClientSession() as http:
        conns = [[await open_session(http, sum(waves[:w]) + i)
                  for i in range(n)] for w, n in enumerate(waves)]
        stages = []
        t0 = time.monotonic()
        for t in range(turns):
            for w, wave in enumerate(conns):
                res = await asyncio.gather(*(turn(
                    ws, sid, f"Session {w}-{i}: tell me about topic {i}, "
                    f"turn {t}.", w == 0 and i < keep, t)
                    for i, (ws, sid) in enumerate(wave)))
                stages.append({"wave": w, "turn": t, "results": res})
        wall = time.monotonic() - t0
        entry = None
        if engine._kv_pool.enabled:
            # A parked entry to time a restore with after the traffic.
            for wave in conns:
                for _, sid in wave:
                    entry = entry or engine._kv_pool.get(sid)
        for wave in conns:
            for ws, _ in wave:
                await ws.send_json({"type": "end_session"})
                json.loads((await ws.receive()).data)
                await ws.close()
    return {"stages": stages, "wall_s": wall, "peak": peak, "entry": entry,
            "errors": [e for st in stages for r in st["results"]
                       for e in r["errors"]],
            "tokens": sum(r["tokens"] for st in stages
                          for r in st["results"])}


def check_block_copy(engine) -> None:
    """The copy-on-write primitive on the card: one block of the stopped
    engine's int8 pool copied to a free block carries its rows and their
    scales exactly."""
    alloc = engine._kv_blocks
    src = next(b for b in range(alloc.num_blocks) if alloc.ref(b) > 0)
    dst = alloc._free[-1]
    engine._paged_copy_block(src, dst)
    torch.cuda.synchronize()
    bs = engine.kv_block_size
    for name, part in zip(("k", "v", "k_scale", "v_scale"), engine.cache):
        if not torch.equal(part[:, src * bs:(src + 1) * bs],
                           part[:, dst * bs:(dst + 1) * bs]):
            fail(f"block copy {src} -> {dst}: {name} rows differ")
    log(f"block copy {src} -> {dst} on the int8 pool: rows and scales equal")


def time_restore(engine, entry) -> dict:
    """Device ms and GB/s of one restore of a parked entry (the host-to-
    device copy from pinned memory and the write into slot 0, as
    ``_try_restore`` does), CUDA events around 5 runs after the engine is
    stopped (nothing else runs on the card)."""
    from fasttalk_tpu_torch.kvcache.offload import (kv_restore,
                                                    paged_kv_restore, upload)

    engine.shutdown()
    dev = engine.device
    idx = torch.arange(entry.k.shape[1], device=dev)

    def once():
        rows = upload(entry, dev)
        if engine.paged:
            paged_kv_restore(engine.cache, rows, idx)
        else:
            kv_restore(engine.cache, rows, 0)
    once()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        once()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = sorted(times)[2]
    return {"restore_ms": ms, "restore_gb_s": entry.nbytes / ms / 1e6,
            "bytes": entry.nbytes}


def time_verify_step(engine) -> dict:
    """Device ms of one speculative step (draft, the T = 8 verify block
    through the kernels, accept) against one plain decode step, both on the
    served engine's weights and cache at its 16 slots, each slot at
    position 200 of a 512-key bucket with a random token history, sampling
    at temperature 0.7 with repeat penalty 1.1; CUDA-graph timed (the
    engine is stopped first, so nothing else runs on the card). The ratio
    is what a verify step costs in plain steps (TPU_SPEC_BREAKEVEN)."""
    from fasttalk_tpu_torch.engine.decode_steps import (DecodeState,
                                                        plain_steps,
                                                        spec_steps)

    engine.shutdown()
    s, dev, kv_len = engine.num_slots, engine.device, 512
    g = torch.Generator(device=dev).manual_seed(7)

    def state() -> DecodeState:
        def full(value, dtype):
            return torch.full((s,), value, dtype=dtype, device=dev)
        hist = torch.randint(0, 1000, (s, engine.max_len + 1), generator=g,
                             device=dev)
        return DecodeState(
            cur=hist[:, 199].clone(), pos=full(200, torch.int64),
            active=full(True, torch.bool), temps=full(0.7, torch.float32),
            topks=full(40, torch.int64), topps=full(0.9, torch.float32),
            reps=full(1.1, torch.float32), press=full(0.0, torch.float32),
            freqs=full(0.0, torch.float32),
            counts=torch.zeros((s, engine.sample_vocab), dtype=torch.int32,
                               device=dev),
            history=hist, gen=None, rows=torch.arange(s, device=dev),
            fst=full(0, torch.int64))

    kw = dict(sample_vocab=engine.sample_vocab,
              method=engine.sampling_method)
    st = state()
    verify = time_ms(lambda i: spec_steps(
        engine.params, engine.cfg, engine.cache, st, 1, kv_len,
        VERIFY_T - 1, **kw), 10)
    st = state()
    plain = time_ms(lambda i: plain_steps(
        engine.params, engine.cfg, engine.cache, st, 1, kv_len, **kw), 10)
    return {"verify_step_ms": verify, "plain_step_ms": plain,
            "verify_over_plain": verify / plain}


def time_constrained_step(engine) -> dict:
    """Device ms of one constrained decode step (the plain step plus the
    mask gather, unpack and select and the two-gather state advance) against
    one plain step, on the served engine's weights, cache and FSM arena
    tables at its 16 slots: 8 slots in the start state of the arena's
    largest FSM, 8 free; each slot at position 200 of a 512-key bucket,
    temperature 0.7, repeat penalty 1.0; CUDA-graph timed after
    ``engine.shutdown()``."""
    from fasttalk_tpu_torch.engine.decode_steps import (DecodeState,
                                                        FSMTables,
                                                        plain_steps)

    engine.shutdown()
    s, dev, kv_len = engine.num_slots, engine.device, 512
    arena = engine._st_arena
    entry = max(arena._order, key=lambda e: e.fsm.n_states)
    constrained = torch.arange(s, device=dev) < s // 2
    g = torch.Generator(device=dev).manual_seed(11)

    def state() -> DecodeState:
        def full(value, dtype):
            return torch.full((s,), value, dtype=dtype, device=dev)
        return DecodeState(
            cur=torch.randint(0, min(1000, engine.sample_vocab), (s,),
                              generator=g, device=dev),
            pos=full(200, torch.int64), active=full(True, torch.bool),
            temps=full(0.7, torch.float32), topks=full(40, torch.int64),
            topps=full(0.9, torch.float32), reps=full(1.0, torch.float32),
            press=full(0.0, torch.float32), freqs=full(0.0, torch.float32),
            counts=torch.zeros((s, engine.sample_vocab), dtype=torch.int32,
                               device=dev),
            history=None, gen=None, rows=torch.arange(s, device=dev),
            fst=torch.where(constrained,
                            full(entry.base + entry.fsm.start, torch.int64),
                            full(0, torch.int64)))

    tables = FSMTables.upload(arena.masks, arena.nexts, arena.cls,
                              torch.where(constrained,
                                          torch.full((s,), entry.sel,
                                                     device=dev),
                                          torch.zeros((s,), dtype=torch.int64,
                                                      device=dev)), dev)
    kw = dict(sample_vocab=engine.sample_vocab, method=engine.sampling_method)
    st = state()
    fsm = time_ms(lambda i: plain_steps(
        engine.params, engine.cfg, engine.cache, st, 1, kv_len, fsm=tables,
        **kw), 10)
    st = state()
    plain = time_ms(lambda i: plain_steps(
        engine.params, engine.cfg, engine.cache, st, 1, kv_len, **kw), 10)
    return {"constrained_step_ms": fsm, "plain_step_ms": plain,
            "constrained_over_plain": fsm / plain,
            "arena": arena.stats()}


def zero_launches() -> None:
    """Set every kernel wrapper's launch counts to 0."""
    from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                       decode_attend_paged)
    from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

    for fn in (int8_matmul, int8_matmul_t, int4_matmul, decode_attend,
               decode_attend_paged):
        fn.launches = 0
        fn.launches_multi = 0
    decode_attend.launches_int8 = 0
    decode_attend_paged.launches_int8 = 0


def turns_phase(label: str, attend: str, waves: list[int], turns: int,
                max_tokens: int, release: bool, counters: dict,
                keep: int = 0, **kw) -> dict:
    """Phase 11: multi-turn sessions sharing ``SYSTEM_1K`` through the
    WS server (``drive_turns``); the counts are zeroed just before the
    sessions and read just after. The layer matmul, the lm_head and
    ``attend`` must have launched, no frame may be an error, and no
    park or restore may have failed. Returns the turns, the engine's
    stats, the launches and (a pool on) the timed restore."""
    out = {}

    async def measured(engine, port: int) -> dict:
        zero_launches()
        before = engine.get_stats()
        res = await drive_turns(engine, port, waves, turns, max_tokens,
                                release, keep)
        res["launches"] = {k: c() for k, c in counters.items()}
        res["delta"] = stat_delta(before, engine.get_stats())
        out["engine"] = engine
        return res

    res = serve_main_path(measured, **kw)
    res["engine_obj"] = engine = out["engine"]
    res["turns"] = turns
    # serve_main_path has stopped the engine thread: the release and
    # end_session commands ran before its stop, so the pool is drained.
    res["stats"] = stats = engine.get_stats()
    if engine._kv_radix is not None:
        engine._kv_radix.check_integrity()
    if engine.paged:
        engine._kv_blocks.check_leaks()
    if res["entry"] is not None:
        res["restore"] = time_restore(engine, res["entry"])
    res["ttft"] = {}
    for st in res["stages"]:
        ttft = [r["ttft"] for r in st["results"] if r["ttft"] is not None]
        key = f"wave {'AB'[st['wave']]} turn {st['turn'] + 1}"
        res["ttft"][key] = {"p50": pct(ttft, 50), "p99": pct(ttft, 99)}
    host = stats["kv_host"]
    log(f"{label}: {res['tokens']} tokens over "
        f"{sum(len(st['results']) for st in res['stages'])} turns in "
        f"{res['wall_s']:.6g} s, error frames {len(res['errors'])}; TTFT "
        f"ms p50 / p99 by turn: " + "; ".join(
            f"{k} {v['p50']:.6g} / {v['p99']:.6g}"
            for k, v in res["ttft"].items()))
    blocks = {k: v for k, v in stats.get("kv_blocks", {}).items()
              if k != "tables"}
    log(f"  radix: {stats.get('kv_radix')}; kv_blocks: {blocks}; peak "
        f"aliased {res['peak']['aliased']}")
    log(f"  kv_host: parked {host['parked_total']}, restored "
        f"{host['restored_total']}, failed restores "
        f"{host['restore_failed']}, failed parks {host['park_failed']}, "
        f"policy {host['policy']}; restore timed: {res.get('restore')}")
    log(f"  launches: {res['launches']}")
    if res["errors"]:
        fail(f"{label}: error frames: {res['errors'][:3]}")
    if host["restore_failed"] or host["park_failed"]:
        fail(f"{label}: a park or restore failed: {host}")
    for name in ("int8_matmul", "int8_matmul_t", attend):
        if res["launches"][name] <= 0:
            fail(f"{label}: kernel {name} never launched")
    return res


def deltas(res: dict, turn: int, wave: int = 0) -> list[tuple]:
    """(prefill, delta) of each session's turn ``turn`` (1-based >= 2):
    delta = its prompt tokens less its previous turn's."""
    by = {(st["wave"], st["turn"]): st["results"] for st in res["stages"]}
    return [(r["prefill"], r["prompt"] - p["prompt"]) for r, p in zip(
        by[(wave, turn - 1)], by[(wave, turn - 2)])]


def phase11(counters: dict) -> dict:
    """Phase 11: the KV memory hierarchy at full width (llama3.2:1b int8,
    16 slots, prefill chunk 512): 11a the radix cache on the paged bf16
    pool against the radix-off control, 11b the same briefly on the paged
    int8 pool with a copy on write, 11c host offload on dense bf16 against
    the pool-off control, 11d the same briefly on the paged int8 pool. Each
    part is fatal on failure. Returns each part's result and the kernels'
    launches summed over the four parts."""
    # 11a: each session is released after every turn, so only the tree
    # serves turns 2 and 3.
    paged_kw = dict(max_len=8192, kv_layout="paged", kv_block_size=BLOCK,
                    kv_pool_blocks=2048)
    t11 = time.monotonic()
    rad = turns_phase("phase 11a (radix, paged bf16 KV)",
                      "decode_attend_paged", [SLOTS], 3, 64, True, counters,
                      kv_radix_enabled=True, **paged_kw)
    # A part's engine is dropped as soon as the part is done: results kept
    # past it would keep its weights and KV cache on the card (they held
    # 12.9 GB into phases 14 and 15 before).
    rad.pop("engine_obj")
    rad_off = turns_phase("phase 11a control (radix off, paged bf16 KV)",
                          "decode_attend_paged", [SLOTS], 3, 64, True,
                          counters, **paged_kw)
    rad_off.pop("engine_obj")
    for t in (2, 3):
        worst = max(p - d for p, d in deltas(rad, t))
        log(f"  11a turn {t}: prefill - delta, worst session: {worst} tokens")
        if worst > 2 * BLOCK:
            fail(f"phase 11a: turn {t} prefilled {worst} tokens past its "
                 "delta (more than 2 blocks)")
    if rad["stats"]["kv_radix"]["hits"] <= 0 or rad["peak"]["aliased"] <= 0:
        fail("phase 11a: no radix hit or no aliased block")
    # 11b: the same traffic briefly on the paged int8 pool, spec off; one
    # block copy checked on the card for its rows and scales.
    rad8 = turns_phase("phase 11b (radix, paged int8 KV)",
                       "decode_attend_paged[int8]", [SLOTS], 3, 16, True,
                       counters, keep=1, kv_radix_enabled=True,
                       kv_quant="int8", spec_decode="off", **paged_kw)
    blocks8 = rad8["stats"]["kv_blocks"]
    if rad8["stats"]["kv_radix"]["hits"] <= 0 \
            or rad8["peak"]["aliased"] <= 0 or blocks8["cow_copies"] < 1:
        fail(f"phase 11b: no radix hit, aliased block or copy on write: "
             f"{blocks8}")
    check_block_copy(rad8.pop("engine_obj"))
    # 11c: host offload on dense bf16: wave B evicts wave A, wave A's second
    # turns restore; against the same traffic with the pool off.
    off = turns_phase("phase 11c (KV_HOST_BUDGET_MB=4096, dense bf16 KV)",
                      "decode_attend", [SLOTS, SLOTS], 2, 64, False, counters,
                      kv_host_budget_mb=4096.0)
    off.pop("engine_obj")
    off_ctl = turns_phase("phase 11c control (KV_HOST_BUDGET_MB=0)",
                          "decode_attend", [SLOTS, SLOTS], 2, 64, False,
                          counters)
    off_ctl.pop("engine_obj")
    host = off["stats"]["kv_host"]
    delta_only = [p <= d for p, d in deltas(off, 2, wave=0)]
    log(f"  11c wave A turn 2: {sum(delta_only)} of {len(delta_only)} "
        "sessions prefilled only their delta")
    if host["parked_total"] < SLOTS or host["restored_total"] < 1 \
            or not any(delta_only):
        fail(f"phase 11c: parks {host['parked_total']}, restores "
             f"{host['restored_total']}, delta-only turns {sum(delta_only)}")
    # 11d: 11c's traffic briefly on the paged int8 pool.
    off8 = turns_phase("phase 11d (KV_HOST_BUDGET_MB=4096, paged int8 KV)",
                       "decode_attend_paged[int8]", [SLOTS, SLOTS], 2, 16,
                       False, counters, kv_host_budget_mb=4096.0,
                       kv_quant="int8", spec_decode="off", max_len=MAX_LEN,
                       kv_layout="paged", kv_block_size=BLOCK,
                       kv_pool_blocks=2048)
    off8.pop("engine_obj")
    host8 = off8["stats"]["kv_host"]
    if host8["parked_total"] < SLOTS or host8["restored_total"] < 1:
        fail(f"phase 11d: parks {host8['parked_total']}, restores "
             f"{host8['restored_total']}")
    log(f"phase 11: {time.monotonic() - t11:.6g} s")
    launches = {name: sum(x["launches"][name] for x in (rad, rad8, off, off8))
                for name in counters}
    return {"radix_paged_bf16": rad, "radix_off_paged_bf16": rad_off,
            "radix_paged_int8": rad8, "offload_dense_bf16": off,
            "offload_off_dense_bf16": off_ctl, "offload_paged_int8": off8,
            "launches": launches}


# ------------------------------------------------------ phase 12: observability

# Every route of the monitoring app (fasttalk_tpu_torch/monitoring/monitor.py,
# the JAX app's :503-521). POST /debug/fault answers 403, as the JAX app does
# with FAULT_HTTP off; every other route must answer 200.
MONITOR_ROUTES = (
    ("GET", "/health"), ("GET", "/health/ready"), ("GET", "/health/live"),
    ("GET", "/slo"), ("GET", "/perf"), ("POST", "/debug/bundle"),
    ("GET", "/debug/profile"), ("GET", "/debug/fault"),
    ("POST", "/debug/fault"), ("GET", "/events"), ("GET", "/metrics"),
    ("GET", "/metrics.json"), ("GET", "/info"), ("POST", "/profiler/start"),
    ("POST", "/profiler/stop"), ("GET", "/profiler/memory"),
    ("GET", "/debug/requests"), ("GET", "/traces"),
    ("GET", "/traces/{request_id}"))


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def kernel_union_ms(trace_path: str) -> tuple[float, int]:
    """(ms covered by the union of the CUDA kernels' intervals, kernel
    count) in a torch.profiler Chrome trace."""
    with open(trace_path, encoding="utf-8") as fp:
        events = json.load(fp)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                   if e.get("cat") == "kernel" and e.get("ph") == "X")
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3, len(spans)


def phase12(counters: dict) -> dict:
    """Phase 12: phase 5's configuration served through ``serve`` (the
    entry point of ``python -m fasttalk_tpu_torch websocket``), the
    monitoring app on its own port. Runs of 16 sessions x 64 tokens:

    1. bracketed by ``/profiler/start`` and ``/profiler/stop``, the tracer
       and the host sampler on, the step ring cleared just before and
       ``/perf`` read just after, so it covers the window of the
       profiler's trace. The
       layer matmul, the lm_head and ``decode_attend`` must launch. Then
       every route of the monitoring app is read (and the serving port's
       ``/slo``, ``/traces/{id}``, ``/health``, ``/stats``); the phase
       fails on a status other than the expected, a route missing from the
       app, ``/perf`` programs that do not ``fsum`` to ``device_busy_s``,
       ``device_busy_s`` above the window, a served program kind with no
       busy time, a null ``mfu.mfu`` or ``hbm.bw_util``, a watchdog stall
       or cancel, or a ``/debug/bundle`` without ``cuda_trace/``;
    2. host ms a decode step and decode tok/s, no torch.profiler, four
       runs in turn: the stack on, the sampler stopped (``PROF_ENABLED=
       false``), the tracer off as well, the stack on again.
    """
    import aiohttp

    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.monitoring.monitor import build_monitoring_app
    from fasttalk_tpu_torch.observability import reset_observability
    from fasttalk_tpu_torch.observability.flight import get_flight
    from fasttalk_tpu_torch.observability.profiler import get_profiler
    from fasttalk_tpu_torch.observability.trace import get_tracer
    from fasttalk_tpu_torch.serving.server import serve
    from fasttalk_tpu_torch.utils.config import Config

    served_routes = {(r.method, r.resource.canonical)
                     for r in build_monitoring_app().router.routes()
                     if r.method != "HEAD"}
    missing = set(MONITOR_ROUTES) - served_routes
    if missing:
        fail(f"phase 12: routes missing from the monitoring app: {missing}")
    os.environ["PROF_ENABLED"] = "true"
    os.environ["FLIGHT_AUTOPROF_S"] = "1"
    reset_observability()  # the singletons read PROF_* and FLIGHT_* anew
    port, mon_port = free_port(), free_port()
    cfg = Config(model_name="llama3.2:1b", model_path="", weight_quant="int8",
                 decode_slots=SLOTS, max_model_len=MAX_LEN, prefill_chunk=512,
                 default_context_window=MAX_LEN, default_max_tokens=64,
                 host="127.0.0.1", port=port, monitoring_host="127.0.0.1",
                 monitoring_port=mon_port)
    t12 = time.monotonic()
    engine = build_engine(cfg, device="cuda")
    engine.start()
    base = f"http://127.0.0.1:{mon_port}"

    async def run_traffic(label: str) -> dict:
        before = engine.get_stats()
        out = await drive_sessions(port, SLOTS, 64)
        d = stat_delta(before, engine.get_stats())
        if out["errors"]:
            fail(f"phase 12 ({label}): error frames: {out['errors'][:3]}")
        out["tok_s"] = out["tokens"] / out["wall_s"]
        out["host_ms_per_step"] = 1e3 * d["decode_host_s"] / d["decode_steps"]
        out["delta"] = d
        log(f"phase 12 ({label}): {out['tokens']} tokens in "
            f"{out['wall_s']:.6g} s ({out['tok_s']:.6g} decode tok/s), host "
            f"ms a decode step {out['host_ms_per_step']:.6g} "
            f"({d['decode_steps']} steps, {d['decode_calls']} calls, "
            f"{d['spec_calls']} speculative)")
        return out

    async def call(http, method: str, url: str, want: int = 200, **kw):
        async with http.request(method, url, **kw) as r:
            body = await r.read()
            if r.status != want:
                fail(f"phase 12: {method} {url} answered {r.status} "
                     f"(expected {want}): {body[:300]!r}")
            try:
                return json.loads(body)
            except ValueError:
                return body.decode()

    async def run() -> dict:
        stop = asyncio.Event()
        server = asyncio.create_task(serve(cfg, engine, stop))
        try:
            async with aiohttp.ClientSession() as http:
                for _ in range(200):
                    try:
                        await call(http, "GET", base + "/health/ready")
                        break
                    except aiohttp.ClientError:
                        await asyncio.sleep(0.05)
                warm = await drive_sessions(port, 1, 8)
                if warm["errors"]:
                    fail(f"phase 12 warm-up failed: {warm['errors']}")
                # Run 1: /perf and the profiler's trace over one window.
                zero_launches()
                get_tracer().clear()
                started = await call(http, "POST", base + "/profiler/start",
                                     json={"log_dir": "phase12"})
                profiled = await run_traffic("profiled, stack on")
                # /perf's window then ends where the traffic does.
                perf = await call(http, "GET", base + "/perf")
                stopped = await call(http, "POST", base + "/profiler/stop")
                launches = {k: c() for k, c in counters.items()}
                bodies = {}
                for method, path in MONITOR_ROUTES:
                    if path.startswith("/profiler/") and method == "POST":
                        continue  # run around the traffic above
                    if path == "/traces/{request_id}":
                        rid = bodies["/traces"]["completed"][-1]
                        url = base + f"/traces/{rid}"
                    else:
                        url = base + path
                    want = 403 if (method, path) == ("POST",
                                                     "/debug/fault") else 200
                    bodies[path if method == "GET" else method + " " + path] \
                        = await call(http, method, url, want)
                serving = f"http://127.0.0.1:{port}"
                for path in ("/slo", f"/traces/{rid}", "/health", "/stats"):
                    bodies["serving " + path.split("/")[1]] = await call(
                        http, "GET", serving + path)
                # The bundle's timed capture must end before the next run.
                flight = get_flight()
                for _ in range(1200):
                    if flight.bundles_written >= 1:
                        break
                    await asyncio.sleep(0.1)
                # The overhead runs: the stack on, the sampler off (tracer
                # on), both off, then on again.
                runs = {"on": await run_traffic("stack on")}
                get_profiler().stop()
                runs["sampler_off"] = await run_traffic(
                    "PROF_ENABLED=false, tracer on")
                get_tracer().enabled = False
                try:
                    runs["off"] = await run_traffic(
                        "PROF_ENABLED=false, tracer off")
                finally:
                    get_tracer().enabled = True
                get_profiler().start()
                runs["on_again"] = await run_traffic("stack on again")
            stop.set()
            await server
        finally:
            if not server.done():
                server.cancel()
        return {"started": started, "stopped": stopped, "launches": launches,
                "bodies": bodies, "perf": perf, "profiled": profiled,
                "runs": runs}

    try:
        res = asyncio.run(asyncio.wait_for(run(), timeout=600))
    finally:
        engine.shutdown()
    bodies, perf = res["bodies"], res["perf"]
    log(f"  launches in the profiled run: {res['launches']}")
    for name in ("int8_matmul", "int8_matmul_t", "decode_attend"):
        if res["launches"][name] <= 0:
            fail(f"phase 12: kernel {name} never launched")
    progs = perf["programs"]["by_program"]
    busy, wall = perf["programs"]["total_busy_s"], perf["wall"]
    if math.fsum(p["busy_s"] for p in progs) != busy \
            or round(busy, 4) != wall["device_busy_s"]:
        fail(f"phase 12: /perf programs do not fsum to device_busy_s: "
             f"{[p['busy_s'] for p in progs]} vs {busy}")
    if wall["device_busy_s"] > wall["window_s"]:
        fail(f"phase 12: device_busy_s {wall['device_busy_s']} above the "
             f"window {wall['window_s']}")
    kinds: dict[str, float] = {}
    for p in progs:
        kind = p["program"].split(" ")[0]
        kinds[kind] = kinds.get(kind, 0.0) + p["busy_s"]
    d = res["profiled"]["delta"]
    # Every served kind must show busy time: plain and speculative decode
    # calls as the run made them, and prefill (batched or chunked) always.
    for kind, names, calls in (
            ("decode", ("decode",), d["plain_calls"]),
            ("spec", ("spec_decode",), d["spec_calls"]),
            ("prefill", ("batched_prefill", "prefill"), 1)):
        got = sum(kinds.get(n, 0.0) for n in names)
        if calls and got <= 0:
            fail(f"phase 12: {kind} ran {calls} calls but has no busy time "
                 f"in /perf: {kinds}")
    if perf["mfu"]["mfu"] is None or perf["hbm"]["bw_util"] is None:
        fail(f"phase 12: /perf reports mfu {perf['mfu']} / hbm "
             f"{perf['hbm']} on {torch.cuda.get_device_name(0)}")
    wd = bodies["/health"]["watchdog"]
    stalls = [e for e in bodies["/events"]["events"]
              if e["kind"] in ("stall_detected", "watchdog_cancel")]
    if not wd["ok"] or stalls:
        fail(f"phase 12: watchdog stall in normal traffic: {wd}, {stalls}")
    bundle = bodies["POST /debug/bundle"]["dir"]
    bundle_trace = os.path.join(bundle, "cuda_trace", "trace.json")
    if not os.path.isfile(bundle_trace):
        fail(f"phase 12: /debug/bundle {bundle} holds no cuda_trace/: "
             f"{sorted(os.listdir(bundle))}")
    kernel_ms, n_kernels = kernel_union_ms(res["stopped"]["trace"])
    share = wall["device_busy_s"] / wall["window_s"]
    log(f"phase 12: /perf over the profiled run: device_busy_s "
        f"{wall['device_busy_s']} of a {wall['window_s']} s window (busy "
        f"share {share:.6g}), host_gap_s {wall['host_gap_s']}, idle_s "
        f"{wall['idle_s']}; programs {[(p['program'], p['calls'], p['busy_s']) for p in progs]}")
    log(f"  torch.profiler over the same run: {n_kernels} kernels, union of "
        f"kernel time {kernel_ms:.6g} ms ({kernel_ms / 1e3 / wall['window_s']:.6g}"
        f" of the window) against /perf device_busy_s "
        f"{wall['device_busy_s'] * 1e3:.6g} ms")
    log(f"  mfu {perf['mfu']}; hbm {perf['hbm']}; tokens {perf['tokens']}")
    runs = res["runs"]
    log("  observability overhead, host ms a decode step / decode tok/s: "
        + "; ".join(f"{k} {r['host_ms_per_step']:.6g} / {r['tok_s']:.6g}"
                    for k, r in runs.items()))
    log(f"phase 12: {time.monotonic() - t12:.6g} s")
    return {"perf_wall": wall, "busy_share": share,
            "programs": [{k: p[k] for k in ("program", "calls", "busy_s")}
                         for p in progs],
            "mfu": perf["mfu"]["mfu"], "achieved_tflops":
                perf["mfu"]["achieved_tflops"],
            "hbm_bw_util": perf["hbm"]["bw_util"],
            "hbm_read_gbps": perf["hbm"]["read_gbps"],
            "profiler_kernels": n_kernels,
            "profiler_kernel_union_ms": kernel_ms,
            "profiled_run": {k: res["profiled"][k] for k in (
                "tokens", "wall_s", "tok_s", "host_ms_per_step")},
            "overhead_runs": {
                name: {k: r[k] for k in ("tokens", "wall_s", "tok_s",
                                         "host_ms_per_step")}
                for name, r in runs.items()},
            "launches": res["launches"], "bundle": bundle}


PHASE13_CONTROL = {"system_prompt": "You keep a lighthouse. Answer in one "
                                    "short sentence.",
                   "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}


def cuda_memory() -> tuple[int, int]:
    """(bytes allocated, peak bytes allocated) on the card (0, 0 without
    one, as in a CPU rehearsal)."""
    if not torch.cuda.is_available():
        return 0, 0
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()


async def ws_frames(ws, text: str, config: dict | None = None,
                    on_frame=None, timeout: float = 300) -> list[dict]:
    """One turn on an open WS session (``config``: start_session first):
    every frame after the user message, up to and including
    ``response_complete`` or ``error`` (``on_frame`` sees each one as it
    arrives)."""
    if config is not None:
        await ws.send_json({"type": "start_session", "config": config})
        json.loads((await ws.receive(timeout=60)).data)
    await ws.send_json({"type": "user_message", "text": text})
    frames = []
    while True:
        frame = json.loads((await ws.receive(timeout=timeout)).data)
        frames.append(frame)
        if on_frame is not None:
            on_frame(frame)
        if frame["type"] in ("response_complete", "error"):
            return frames


async def ws_turn(ws, text: str, config: dict | None = None,
                  timeout: float = 300) -> tuple[list[str], dict]:
    """One turn on an open WS session: (the token frames' texts, the
    terminal frame)."""
    frames = await ws_frames(ws, text, config, timeout=timeout)
    return [f["data"] for f in frames if f["type"] == "token"], frames[-1]


async def until(pred, timeout: float, what: str, step: float = 0.005,
                phase: str = "phase 13"):
    """Poll ``pred`` (sync or async) until true; fail after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return time.monotonic()
        await asyncio.sleep(step)
    fail(f"{phase}: {what} within {timeout} s")


def phase13(counters: dict) -> dict:
    """Phase 13: the engine's lifecycle through ``ServerLauncher`` (the
    entry point of ``python -m fasttalk_tpu_torch websocket``) at phase 5's
    full width (llama3.2:1b int8, dense bf16 KV, 16 slots, max_len 2048),
    with the tool-calling agent on (``WEB_SEARCH_BACKEND=offline``),
    ``FAULT_HTTP`` on, a host KV pool (``KV_HOST_BUDGET_MB=4096``, idle
    sessions parked after 1 s), the supervisor checking every 0.25 s and
    speculative decoding off (greedy tokens must not depend on which decode
    program ran):

    (a) ``TPU_WARMUP=fast`` (its launches counted), then a first wave of 16
        sessions x 64 tokens: its TTFT p50/p99 is logged and the layer
        matmul, the lm_head and ``decode_attend`` must launch;
    (b) a greedy control session and a session left idle until it parks;
        then ``engine.decode.dispatch=crash_thread;count=1`` armed through
        ``POST /debug/fault`` mid-burst (16 sessions x 512 tokens, armed
        once at least half of them run and 64 decode steps passed): every
        burst session must end with exactly one terminal frame, an error;
        the supervisor must restart the engine (``engine_restarts_total``
        +1, ``/health`` supervisor ok, ``/health/ready`` 200), the allocated
        bytes after the restart must not hold a second KV cache, and the
        peak during it neither. Then a second crash at ``engine.loop.tick``
        with four requests submitted at the engine seam in the crash race
        window (the engine's liveness check held true for the window, as
        tests/test_chaos.py does): all must be served after the restart.
        Once the circuit breaker (opened by the burst's errors) lets
        traffic through again, the control prompt must give the same tokens
        as before the crash, and the parked session's next turn must
        restore its host rows (``restored_total`` +1). The three kernels must launch in the post-restart traffic;
    (c) a restart storm on a second launcher with SUPERVISOR_MAX_RESTARTS=2:
        ``engine.loop.tick=crash_thread`` without a count kills every new
        thread; the supervisor must make exactly 2 attempts, ``/health``
        read ``dead`` and ``/health/ready`` 503, and the launcher then shut
        down cleanly (the engine thread gone).
    """
    import aiohttp

    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.observability import reset_observability
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.utils.config import Config
    from fasttalk_tpu_torch.utils.metrics import get_metrics

    def config(**kw) -> Config:
        return Config(model_name="llama3.2:1b", model_path="",
                      weight_quant="int8", decode_slots=SLOTS,
                      max_model_len=MAX_LEN, prefill_chunk=512,
                      default_context_window=MAX_LEN, default_max_tokens=64,
                      spec_decode="off", host="127.0.0.1", port=0,
                      monitoring_host="127.0.0.1", monitoring_port=0,
                      web_search_backend="offline", fault_http_enabled=True,
                      **kw)

    def counted_restarts(engine) -> list[dict]:
        """Wrap ``engine.restart`` (the supervisor looks it up each tick):
        for each call its ms and the bytes allocated on the card before
        and after it and at its peak."""
        calls: list[dict] = []
        inner = engine.restart

        def restart() -> bool:
            before, _ = cuda_memory()
            if torch.cuda.is_available():
                torch.cuda.reset_peak_memory_stats()
            t = time.monotonic()
            try:
                return inner()
            finally:
                ms = (time.monotonic() - t) * 1e3
                after, peak = cuda_memory()
                calls.append({"ms": ms, "allocated_before": before,
                              "allocated_after": after, "peak": peak})
        engine.restart = restart
        return calls

    # Phase 12 left the flight recorder profiling each bundle for 1 s: an
    # automatic bundle of the crash below would then run torch.profiler
    # beside the restart. Back to the default (0), read anew.
    os.environ["FLIGHT_AUTOPROF_S"] = "0"
    reset_observability()
    # Engines of earlier phases still in reference cycles: gone before the
    # memory readings below.
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    restarts_total = get_metrics().counter("engine_restarts_total")
    t13 = time.monotonic()
    launcher = ServerLauncher(
        config(kv_host_budget_mb=4096.0, kv_park_idle_s=1.0, warmup="fast"),
        device="cuda", watchdog_interval_s=0.25)
    engine = launcher.engine
    if launcher.agent is None or launcher.server.agent is not launcher.agent:
        fail("phase 13: the launcher built no agent with the default "
             "ENABLE_PYDANTIC_AI / ENABLE_TOOLS")
    restart_calls = counted_restarts(engine)
    kv_bytes = sum(x.numel() * x.element_size() for x in engine.cache
                   if x is not None)
    log(f"phase 13: ServerLauncher built (llama3.2:1b int8, agent on) in "
        f"{time.monotonic() - t13:.3f} s; KV cache {kv_bytes} bytes")

    async def post_fault(http, mon: str, body: dict) -> None:
        async with http.post(mon + "/debug/fault", json=body) as r:
            if r.status != 200:
                fail(f"phase 13: POST /debug/fault {body} answered "
                     f"{r.status}: {await r.text()}")

    async def ready(http, mon: str) -> bool:
        try:
            async with http.get(mon + "/health/ready") as r:
                return r.status == 200
        except aiohttp.ClientError:
            return False

    async def get_json(http, url: str) -> dict:
        async with http.get(url) as r:
            return await r.json()

    async def burst_session(http, port: int) -> tuple[int, list[dict]]:
        """One burst session: (token frames, every frame after the last
        token, up to 1 s after the first terminal one)."""
        ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
        await ws.receive(timeout=60)
        tokens, term = await ws_turn(ws, "Write a long story about ships.", {
            "max_tokens": 512, "temperature": 0.7, "ignore_eos": True})
        after = [term]
        try:
            while True:
                after.append(json.loads((await ws.receive(timeout=1.0)).data))
        except asyncio.TimeoutError:
            pass
        await ws.close()
        return len(tokens), after

    async def seam_request(i: int) -> list[dict]:
        """A request submitted at the engine seam (the agent the server
        uses), as one arriving in the crash race window."""
        sid = f"race-{i}"
        events = [ev async for ev in launcher.agent.generate(
            sid, sid, [{"role": "user", "content": f"Count to {i + 3}."}],
            GenerationParams(max_tokens=16, temperature=0.0,
                             ignore_eos=True))]
        launcher.agent.release_session(sid)
        return events

    async def run_ab() -> dict:
        out: dict = {}
        zero_launches()
        t_run = time.monotonic()
        task = asyncio.create_task(launcher.run())
        while "monitoring" not in launcher.addresses:
            if task.done():
                task.result()
                fail("phase 13: the launcher stopped before serving")
            await asyncio.sleep(0.02)
        out["warmup_to_serving_s"] = time.monotonic() - t_run
        out["launches_warmup"] = {k: c() for k, c in counters.items()}
        port = launcher.addresses["serving"][1]
        mon = f"http://127.0.0.1:{launcher.addresses['monitoring'][1]}"
        serving = f"http://127.0.0.1:{port}"
        try:
            async with aiohttp.ClientSession() as http:
                # (a) the first wave after the warm-up.
                zero_launches()
                wave = await drive_sessions(port, SLOTS, 64)
                out["launches_first_wave"] = {k: c()
                                              for k, c in counters.items()}
                if wave["errors"]:
                    fail(f"phase 13 (a): error frames: {wave['errors'][:3]}")
                out["first_wave"] = {
                    "tokens": wave["tokens"], "wall_s": wave["wall_s"],
                    "tok_s": wave["tokens"] / wave["wall_s"],
                    "ttft_p50_ms": pct(wave["ttft_ms"], 50),
                    "ttft_p99_ms": pct(wave["ttft_ms"], 99)}
                # (b) the control, and a session left to park.
                ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
                await ws.receive(timeout=60)
                before, term = await ws_turn(ws, "Why is the sea salty?",
                                             PHASE13_CONTROL)
                await ws.close()
                if term["type"] != "response_complete":
                    fail(f"phase 13 (b): control run failed: {term}")
                park = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
                sid = json.loads((await park.receive(timeout=60)).data)[
                    "session_id"]
                _, term = await ws_turn(park, "Tell me about the ocean.", {
                    "max_tokens": 32, "temperature": 0.0,
                    "ignore_eos": True})
                if term["type"] != "response_complete":
                    fail(f"phase 13 (b): the session to park failed: {term}")
                await until(lambda: engine.parked_kv_info(sid), 30,
                            "the idle session never parked", 0.05)
                out["parked"] = engine.parked_kv_info(sid)
                mem_before, _ = cuda_memory()
                # The burst, and the crash mid-burst.
                restarts0 = restarts_total.value
                steps0 = engine.decode_steps
                burst = [asyncio.create_task(burst_session(http, port))
                         for _ in range(SLOTS)]
                # Mid-burst: the sessions decode, tokens streaming.
                await until(lambda: len(engine._running) >= SLOTS // 2
                            and engine.decode_steps - steps0 >= 64, 120,
                            "the burst never decoded")
                await post_fault(http, mon, {
                    "spec": "engine.decode.dispatch=crash_thread;count=1"})
                t_arm = time.monotonic()
                t_dead = await until(lambda: not engine.check_connection(),
                                     60, "the crash never killed the thread")
                mem_dead, _ = cuda_memory()
                await post_fault(http, mon, {"clear": True})
                t_ready = await until(lambda: ready(http, mon), 120,
                                      "/health/ready never came back", 0.02)
                results = await asyncio.gather(*burst)
                mem_after, _ = cuda_memory()
                restart = restart_calls[0]
                health = await get_json(http, mon + "/health")
                out["crash"] = {
                    "arm_to_dead_ms": (t_dead - t_arm) * 1e3,
                    "crash_to_ready_ms": (t_ready - t_dead) * 1e3,
                    "restart_ms": restart["ms"],
                    "memory_allocated_before": mem_before,
                    "memory_allocated_at_crash": mem_dead,
                    "memory_allocated_after": mem_after,
                    "restart_allocated_before": restart["allocated_before"],
                    "restart_allocated_after": restart["allocated_after"],
                    "restart_peak_allocated": restart["peak"],
                    "kv_cache_bytes": kv_bytes,
                    "burst_token_frames": [n for n, _ in results],
                    "burst_terminals": [[f["type"] for f in fr]
                                        for _, fr in results],
                    "health_status": health["status"],
                    "supervisor": health.get("supervisor")}
                bad = [fr for _, fr in results
                       if len(fr) != 1 or fr[0]["type"] != "error"]
                if bad:
                    fail(f"phase 13 (b): a burst session did not end with "
                         f"exactly one error frame: {bad[:2]}")
                if restarts_total.value - restarts0 != 1:
                    fail(f"phase 13 (b): engine_restarts_total moved by "
                         f"{restarts_total.value - restarts0}, not 1")
                if (health.get("supervisor") or {}).get("state") != "ok":
                    fail(f"phase 13 (b): /health supervisor after the "
                         f"restart: {health.get('supervisor')}")
                if mem_after - mem_before > kv_bytes // 2 \
                        or restart["peak"] - restart["allocated_before"] \
                        > kv_bytes // 2:
                    fail(f"phase 13 (b): a second KV cache on the card: "
                         f"{mem_before} bytes before the burst, {mem_after} "
                         f"after the restart; the restart {restart} (KV "
                         f"cache {kv_bytes})")
                # The post-restart traffic's launches, from here.
                zero_launches()
                # The crash race window: submissions at the engine seam
                # while its liveness check still reads true.
                engine.check_connection = lambda: True
                try:
                    await post_fault(http, mon, {
                        "spec": "engine.loop.tick=crash_thread;count=1"})
                    await until(lambda: not engine._thread.is_alive(), 60,
                                "the loop-tick crash never killed the thread")
                    await post_fault(http, mon, {"clear": True})
                    queued = [asyncio.create_task(seam_request(i))
                              for i in range(4)]
                    # The agent submits each as its first round, "<id>.t0".
                    await until(lambda: sum(rid.startswith("race-")
                                            for rid in engine._by_id) == 4,
                                30, "the race-window requests were not "
                                "queued")
                finally:
                    del engine.__dict__["check_connection"]
                served = await asyncio.wait_for(asyncio.gather(*queued), 120)
                for events in served:
                    if events[-1]["type"] != "done" or sum(
                            e["type"] == "token" for e in events) < 1:
                        fail(f"phase 13 (b): a request queued during the "
                             f"outage was not served: {events[-2:]}")
                out["queued_during_outage"] = [
                    e[-1]["stats"]["tokens_generated"] for e in served]
                # The breaker opened on the burst's errors: wait for it.
                t_breaker = time.monotonic()
                await until(lambda: _breaker_passes(http, serving), 90,
                            "the circuit breaker never half-opened", 0.5)
                out["breaker_wait_s"] = time.monotonic() - t_breaker
                ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
                await ws.receive(timeout=60)
                after, term = await ws_turn(ws, "Why is the sea salty?",
                                            PHASE13_CONTROL)
                await ws.close()
                if term["type"] != "response_complete" or after != before:
                    fail(f"phase 13 (b): the control after the restart "
                         f"differs: {term}, {after[:8]} vs {before[:8]}")
                restored0 = engine.get_stats()["kv_host"]["restored_total"]
                _, term = await ws_turn(park, "And what lives in it?")
                await park.close()
                stats = term.get("stats", {})
                restored = engine.get_stats()["kv_host"]["restored_total"]
                # (The agent's response_complete carries no prefill_tokens:
                # the pool's restore count is the evidence.)
                out["restored_turn"] = {
                    "prompt_tokens": stats.get("prompt_tokens"),
                    "ttft_ms": stats.get("ttft_ms"),
                    "restored": restored - restored0}
                if term["type"] != "response_complete" \
                        or restored - restored0 < 1:
                    fail(f"phase 13 (b): the parked session did not restore "
                         f"after the restart: {term}, restored "
                         f"{restored - restored0}")
                out["launches_after_restart"] = {
                    k: c() for k, c in counters.items()}
                out["restarts_total"] = restarts_total.value - restarts0
        finally:
            launcher.stop()
            await asyncio.wait_for(task, 120)
        return out

    res = asyncio.run(asyncio.wait_for(run_ab(), timeout=900))
    for key in ("launches_warmup", "launches_first_wave",
                "launches_after_restart"):
        for name in ("int8_matmul", "int8_matmul_t", "decode_attend"):
            if res[key][name] <= 0:
                fail(f"phase 13: kernel {name} never launched in "
                     f"{key.replace('launches_', '')}")
    if engine._thread.is_alive():
        fail("phase 13: the engine thread outlived the launcher")
    w, c = res["first_wave"], res["crash"]
    log(f"phase 13 (a): TPU_WARMUP=fast to serving in "
        f"{res['warmup_to_serving_s']:.6g} s; first wave {w['tokens']} "
        f"tokens in {w['wall_s']:.6g} s ({w['tok_s']:.6g} decode tok/s), TTFT "
        f"p50 {w['ttft_p50_ms']} ms, p99 {w['ttft_p99_ms']} ms")
    log(f"phase 13 (b): crash to ready {c['crash_to_ready_ms']:.6g} ms "
        f"(armed to dead {c['arm_to_dead_ms']:.6g} ms; restart() "
        f"{c['restart_ms']:.6g} ms); memory allocated "
        f"{c['memory_allocated_before']} bytes before the burst, "
        f"{c['memory_allocated_at_crash']} at the crash, "
        f"{c['memory_allocated_after']} after; in restart() "
        f"{c['restart_allocated_before']} -> {c['restart_allocated_after']}"
        f", peak {c['restart_peak_allocated']} (KV cache "
        f"{c['kv_cache_bytes']}); /health {c['health_status']}, supervisor "
        f"{c['supervisor']}; token frames before the crash "
        f"{c['burst_token_frames']}")
    log(f"  queued during the outage, served: {res['queued_during_outage']} "
        f"tokens; breaker wait {res['breaker_wait_s']:.6g} s; restored turn "
        f"{res['restored_turn']}; parked {res['parked']}")
    log(f"  launches: warm-up {res['launches_warmup']}, first wave "
        f"{res['launches_first_wave']}, after the restart "
        f"{res['launches_after_restart']}")
    del launcher, engine
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

    # (c) the restart storm.
    storm = ServerLauncher(config(supervisor_max_restarts=2,
                                  supervisor_backoff_s=0.25, warmup="off"),
                           device="cuda", watchdog_interval_s=0.25)
    attempts = counted_restarts(storm.engine)

    async def run_c() -> dict:
        task = asyncio.create_task(storm.run())
        while "monitoring" not in storm.addresses:
            if task.done():
                task.result()
                fail("phase 13 (c): the launcher stopped before serving")
            await asyncio.sleep(0.02)
        port = storm.addresses["serving"][1]
        mon = f"http://127.0.0.1:{storm.addresses['monitoring'][1]}"
        try:
            async with aiohttp.ClientSession() as http:
                first = await drive_sessions(port, 1, 8)
                if first["errors"]:
                    fail(f"phase 13 (c): {first['errors']}")
                await post_fault(http, mon,
                                 {"spec": "engine.loop.tick=crash_thread"})
                t0 = time.monotonic()

                async def dead() -> bool:
                    return (await get_json(http, mon + "/health"))[
                        "status"] == "dead"
                t_dead = await until(dead, 60, "/health never read dead",
                                     0.05)
                await asyncio.sleep(1.0)  # no attempt after exhaustion
                async with http.get(mon + "/health/ready") as r:
                    ready_status = r.status
                health = await get_json(http, mon + "/health")
                await post_fault(http, mon, {"clear": True})
        finally:
            t_stop = time.monotonic()
            storm.stop()
            await asyncio.wait_for(task, 120)
        return {"to_dead_s": t_dead - t0, "attempts": len(attempts),
                "restart_ms": [a["ms"] for a in attempts],
                "ready_status": ready_status,
                "supervisor": health.get("supervisor"),
                "shutdown_s": time.monotonic() - t_stop}

    storm_res = asyncio.run(asyncio.wait_for(run_c(), timeout=300))
    if storm_res["attempts"] != 2 or storm_res["ready_status"] != 503 \
            or (storm_res["supervisor"] or {}).get("state") != "exhausted":
        fail(f"phase 13 (c): the storm did not exhaust the budget as "
             f"expected: {storm_res}")
    if storm.engine._thread.is_alive():
        fail("phase 13 (c): the engine thread outlived the launcher")
    log(f"phase 13 (c): restart storm: {storm_res['attempts']} attempts "
        f"({storm_res['restart_ms']} ms), /health dead after "
        f"{storm_res['to_dead_s']:.6g} s, /health/ready "
        f"{storm_res['ready_status']}, clean shutdown in "
        f"{storm_res['shutdown_s']:.6g} s")
    log(f"phase 13: {time.monotonic() - t13:.6g} s")
    del storm
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {**res, "storm": storm_res}


async def _breaker_passes(http, serving: str) -> bool:
    """The serving port's circuit breaker lets a request through."""
    async with http.get(serving + "/health") as r:
        body = await r.json()
    return body.get("circuit_breaker", {}).get("state") != "open"


# ----------------------------------------------------- phase 14: the fleet

# The greedy control of 14b: its own system prompt (no other session
# shares its rows) and a prompt in a prefill bucket of its own (256 rows;
# the other streams' prompts take 64), so its resume prefills as its
# unbroken run did.
FAILOVER_SYSTEM = " ".join(
    f"Rule {i}: you keep the lighthouse on rock {i} and tell its story "
    "slowly, in full sentences." for i in range(9))
FAILOVER_CONTROL = {"system_prompt": FAILOVER_SYSTEM, "max_tokens": 512,
                    "temperature": 0.0, "ignore_eos": True}
# 14c: a two-turn conversation, greedy, each session with its own system
# prompt; session 0 is the one held to its unmigrated control.
MIGRATE_TURNS = ("Tell me about the ocean.", "And what lives in it?")
# 14d: about 1,500-token prompts sharing a ~700-token prefix; the probe
# session (the prefix and a short question) stays under
# DISAGG_PREFILL_MIN_TOKENS and so places on the decode tier.
DISAGG_MIN_TOKENS = 1024
DISAGG_PREFIX = " ".join(
    f"Note {i}: the harbour log lists ship {i}, its cargo and its crew."
    for i in range(40))
DISAGG_QUESTIONS = 34


def fleet_memory_check(start: int, label: str) -> int:
    """Bytes allocated on the card after a fleet was dropped; fails when
    they exceed ``start`` by more than 64 MiB (a replica still alive)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    now, _ = cuda_memory()
    if now - start > 64 * 2**20:
        fail(f"phase 14 {label}: {now} bytes allocated on the card after "
             f"the fleet was dropped, {start} at the phase's start")
    return now


async def ws_open(http, port: int):
    """A new WS session: (the socket, its session id)."""
    ws = await http.ws_connect(f"ws://127.0.0.1:{port}/ws/llm")
    first = json.loads((await ws.receive(timeout=60)).data)
    if first.get("type") != "session_started":
        fail(f"phase 14: the session did not start: {first}")
    return ws, first["session_id"]


def frame_text(frames: list[dict]) -> str:
    return "".join(f["data"] for f in frames if f["type"] == "token")


def frame_errors(frames: list[dict]) -> list[dict]:
    return [f for f in frames if f["type"] == "error"]


def phase14(counters: dict, phase5: dict) -> dict:
    """Phase 14: the fleet router (``fasttalk_tpu_torch/router/``) through
    ``ServerLauncher`` with ``ROUTER_ENABLED`` (what ``python -m
    fasttalk_tpu_torch websocket`` builds), each replica llama3.2:1b at full
    width and depth with int8 random weights from the seed (the replicas'
    weights are equal), 16 decode slots, 512-token prefill chunks, spec off
    and the agent off (the JAX package's agent passes no ``resumed`` event
    on). Shared prefixes are off in (a)-(c): a greedy control must prefill
    as the run it is held to does.

    (a) ``FLEET_REPLICAS=2``, dense bf16 KV, max_len 2048: 16 WS sessions x
        64 tokens, then a second turn of each; ``/fleet`` must list both
        replicas, both carry sessions, every second turn run on its first
        turn's replica (the router's ``_routes`` while it streams, and 16
        affinity hits), no error frame;
    (b) the same fleet: a greedy control run alone (512 tokens), then the
        control and three more greedy streams of 512 tokens (pinned: the
        control and two others on inproc-0, one on inproc-1); once each has
        2 tokens, the engine carrying the most live streams is shut down
        (``engine.shutdown()`` in an executor). Every
        affected stream must get exactly one ``resumed`` frame, then tokens,
        then ``response_complete``; no error frame; the control's text must
        equal its unbroken run's; ``/health`` must read degraded with one
        dead replica and ``/traces/{id}`` of a resumed stream give one
        stitched trace with one terminal event;
    (c) a fleet with ``KV_HOST_BUDGET_MB=4096`` and idle parking after 1 s:
        a control conversation on inproc-1; sessions pinned to inproc-0
        (one the same conversation as the control), parked when idle; one
        timed migration primes the router's bandwidth EMA (a migration it
        prices from its defaults loses to a re-prefill on this card), then
        ``POST /fleet/drain/inproc-0``: the parked entries must move to
        inproc-1 (``migrated_kv``, the router's counters), the bytes must
        leave inproc-0's pool and reach inproc-1's exactly, each next turn
        must restore on inproc-1 and the control's session equal its
        control token for token. Then two single-engine servers with
        ``KV_MIGRATE_HTTP``: the same conversation parks on the first, its
        entry moves by ``GET ?meta=1``, ``GET``, ``POST`` to the second and
        ``DELETE`` on the first, and its next turn (``/v1``, ``user`` = the
        session) must restore on the second and equal the control;
    (d) ``FLEET_ROLES=prefill,decode`` on the paged bf16 pool with the radix
        cache (max_len 8192, ``KV_POOL_BLOCKS=2048``: each replica's budget
        sees the whole card), ``DISAGG_PREFILL_MIN_TOKENS`` 1024: 8 sessions
        of about 1,500 tokens must each prefill on the prefill replica
        (``prefill_parked``), hand off and restore on the decode replica;
        the prefill replica runs no decode call; a session with the shared
        prefix and a short question must hit the decode replica's radix
        tree; then a ``router.handoff`` error (``count=1``) must fall back
        to mixed placement without an error frame;
    (e) ``FLEET_REPLICAS=1``, ``FLEET_SCALE_MAX=2``: 32 sessions, then 16
        more once the scaler has built a second replica on the card (its
        build off the event loop), which must take new sessions; after the
        burst the scaler must drain back to one replica; no error frame.

    The kernels' counts are zeroed before each part and read after it: the
    layer matmul, the lm_head and ``decode_attend`` must launch in (a), (b),
    (c) and (e), and ``decode_attend_paged`` in (d). The bytes allocated on
    the card after each part must be within 64 MiB of the phase's start.
    """
    import aiohttp
    from aiohttp import web

    from fasttalk_tpu_torch.engine import factory
    from fasttalk_tpu_torch.observability import reset_observability
    from fasttalk_tpu_torch.observability.events import get_events
    from fasttalk_tpu_torch.observability.trace import get_tracer
    from fasttalk_tpu_torch.resilience import failpoints as fp
    from fasttalk_tpu_torch.serving.launcher import ServerLauncher
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    def config(**kw) -> Config:
        base = dict(model_name="llama3.2:1b", model_path="",
                    weight_quant="int8", decode_slots=SLOTS,
                    max_model_len=MAX_LEN, prefill_chunk=512,
                    default_context_window=MAX_LEN, default_max_tokens=64,
                    spec_decode="off", host="127.0.0.1", port=0,
                    monitoring_host="127.0.0.1", monitoring_port=0,
                    enable_agent=False, warmup="off", router_enabled=True,
                    fleet_replicas=2, router_probe_interval_s=0.25)
        base.update(kw)
        return Config(**base)

    def launches() -> dict:
        return {k: c() for k, c in counters.items()}

    def need_launches(label: str, got: dict, names: tuple) -> None:
        for name in names:
            if got[name] <= 0:
                fail(f"phase 14 {label}: kernel {name} never launched")

    async def get_json(http, url: str) -> tuple[int, dict]:
        async with http.get(url) as r:
            return r.status, await r.json()

    async def serving(launcher, body) -> dict:
        task = asyncio.create_task(launcher.run())
        while "monitoring" not in launcher.addresses:
            if task.done():
                task.result()
                fail("phase 14: the launcher stopped before serving")
            await asyncio.sleep(0.02)
        port = launcher.addresses["serving"][1]
        try:
            async with aiohttp.ClientSession() as http:
                return await body(launcher, http, port,
                                  f"http://127.0.0.1:{port}")
        finally:
            launcher.stop()
            await asyncio.wait_for(task, 120)

    def run_fleet(label: str, cfg: Config, body) -> dict:
        reset_observability()
        t = time.monotonic()
        launcher = ServerLauncher(cfg, device="cuda",
                                  watchdog_interval_s=0.25)
        router = launcher.engine
        log(f"phase 14 {label}: ServerLauncher built a FleetRouter of "
            f"{[h.replica_id for h in router.replicas]} in "
            f"{time.monotonic() - t:.6g} s")
        if launcher.agent is not None or type(router).__name__ \
                != "FleetRouter":
            fail(f"phase 14 {label}: the launcher built {router!r}, agent "
                 f"{launcher.agent!r}")
        try:
            return asyncio.run(asyncio.wait_for(
                serving(launcher, body), timeout=900))
        finally:
            for h in list(router.replicas):
                h.engine.shutdown()
            del launcher, router
            reset_observability()

    # The watchdog of an earlier phase's server still holds its engine:
    # released before the reading the phase is held to.
    reset_observability()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    mem_start, _ = cuda_memory()
    t14 = time.monotonic()
    out: dict = {"memory_allocated_start": mem_start,
                 "memory_owners_start": memory_owners("phase 14 start")}

    # ---------------- (a) placement and affinity, (b) failover ----------
    async def part_ab(launcher, http, port, serving_url) -> dict:
        router = launcher.engine
        res: dict = {}
        zero_launches()
        hits0 = router._m_affinity_hits.value
        sessions = [await ws_open(http, port) for _ in range(SLOTS)]
        prompts = ["Tell me about the ocean.", "What is a good breakfast?",
                   "Explain how trains work.",
                   "Write a short poem about rain.", "Why is the sky blue?",
                   "Give me three tips for sleep.",
                   "What is your favourite book?", "How do plants grow?"]
        cfg = {"max_tokens": 64, "temperature": 0.7, "ignore_eos": True}
        t0 = time.monotonic()
        first = await asyncio.gather(*(
            ws_frames(ws, prompts[i % len(prompts)], cfg)
            for i, (ws, _) in enumerate(sessions)))
        wall = time.monotonic() - t0
        homes = {sid: router.affinity.get(sid) for _, sid in sessions}
        seen: dict[str, set] = {}
        sampling = True

        async def sample_routes():
            while sampling:
                for sid, h in list(router._routes.values()):
                    seen.setdefault(sid, set()).add(h.replica_id)
                await asyncio.sleep(0.002)

        sampler = asyncio.create_task(sample_routes())
        second = await asyncio.gather(*(
            ws_frames(ws, "Tell me more about that.")
            for ws, _ in sessions))
        sampling = False
        await sampler
        hits = router._m_affinity_hits.value - hits0
        status, fleet = await get_json(http, serving_url + "/fleet")
        for ws, _ in sessions:
            await ws.close()
        res["a_launches"] = launches()
        errors = [e for fr in first + second for e in frame_errors(fr)]
        done = [fr[-1] for fr in first]
        tokens = sum(f["stats"]["tokens_generated"] for f in done
                     if f["type"] == "response_complete")
        ttft = sorted(f["stats"]["ttft_ms"] for f in done
                      if f["type"] == "response_complete"
                      and f["stats"].get("ttft_ms") is not None)
        placements = {r["replica_id"]: r["placements"]
                      for r in fleet.get("replicas", [])}
        res["a"] = {"tokens": tokens, "wall_s": wall,
                    "tok_s": tokens / wall, "ttft_p50_ms": pct(ttft, 50),
                    "ttft_p99_ms": pct(ttft, 99),
                    "homes": sorted(Counter(homes.values()).items()),
                    "placements": placements, "affinity_hits": hits}
        if errors:
            fail(f"phase 14 (a): error frames: {errors[:3]}")
        if status != 200 or sorted(placements) != ["inproc-0",
                                                    "inproc-1"]:
            fail(f"phase 14 (a): /fleet answered {status}: {fleet}")
        if len(set(homes.values())) != 2 or None in homes.values():
            fail(f"phase 14 (a): sessions did not spread over both "
                 f"replicas: {homes}")
        moved = {sid: (homes[sid], sorted(seen.get(sid, ())))
                 for sid in homes if seen.get(sid, set()) - {homes[sid]}}
        if moved or hits != SLOTS:
            fail(f"phase 14 (a): second turns left their replica: {moved}, "
                 f"affinity hits {hits}")
        need_launches("(a)", res["a_launches"],
                      ("int8_matmul", "int8_matmul_t", "decode_attend"))

        # (b) failover with resume.
        zero_launches()
        ws, _ = await ws_open(http, port)
        ref = await ws_frames(ws, "Tell me the story of the lighthouse.",
                              FAILOVER_CONTROL)
        await ws.close()
        if ref[-1]["type"] != "response_complete":
            fail(f"phase 14 (b): the unbroken control run failed: "
                 f"{ref[-1]}")
        n = 2 * len(router.replicas)
        state: dict = {"kill_t": None}
        streams = [dict(tokens=0, frames=[], resumed_ms=None,
                        next_token_ms=None) for _ in range(n)]

        def watcher(i):
            got = streams[i]

            def on_frame(frame):
                got["frames"].append(frame["type"])
                if frame["type"] == "token":
                    got["tokens"] += 1
                    if got["resumed_ms"] is not None \
                            and got["next_token_ms"] is None:
                        got["next_token_ms"] = (
                            time.monotonic() - state["kill_t"]) * 1e3
                elif frame["type"] == "resumed" \
                        and state["kill_t"] is not None:
                    got["resumed_ms"] = (
                        time.monotonic() - state["kill_t"]) * 1e3
            return on_frame

        async def stream(i: int, ws, text: str, cfg: dict) -> list[dict]:
            frames = await ws_frames(ws, text, cfg, watcher(i), 600)
            await ws.close()
            return frames

        opened = [await ws_open(http, port) for _ in range(n)]
        sids = [sid for _, sid in opened]
        # The control and all but one other stream on inproc-0: it carries
        # the most live streams, the control among them.
        for i, sid in enumerate(sids):
            router.affinity.set(sid, "inproc-1" if i == n - 1
                                else "inproc-0")
        tasks = [asyncio.create_task(stream(
            0, opened[0][0], "Tell me the story of the lighthouse.",
            FAILOVER_CONTROL))]
        await until(lambda: streams[0]["tokens"] >= 1, 120,
                    "the control never streamed", phase="phase 14")
        for i in range(1, n):
            tasks.append(asyncio.create_task(stream(
                i, opened[i][0], prompts[i], {
                    "max_tokens": 512, "temperature": 0.0,
                    "ignore_eos": True})))
        await until(lambda: all(s["tokens"] >= 2 for s in streams), 120,
                    "the failover streams never reached 2 tokens",
                    phase="phase 14")
        owner = {sid: h for sid, h in list(router._routes.values())}
        if set(owner) != set(sids):
            fail(f"phase 14 (b): streams without a route: "
                 f"{set(sids) - set(owner)}")
        target = max(router.replicas,
                     key=lambda h: sum(o is h for o in owner.values()))
        affected = [i for i, sid in enumerate(sids) if owner[sid] is target]
        state["kill_t"] = time.monotonic()
        await asyncio.get_running_loop().run_in_executor(
            None, target.engine.shutdown)
        results = await asyncio.gather(*tasks)
        status, health = await get_json(http, serving_url + "/health")
        resumed_rid = next((t.request_id for t in
                            reversed(get_tracer().completed())
                            if any(s.name == "resume" for s in t.spans)),
                           None)
        trace_status, trace = (await get_json(
            http, f"{serving_url}/traces/{resumed_rid}")) \
            if resumed_rid else (None, {})
        res["b_launches"] = launches()
        stitched = trace.get("stitched") or {}
        res["b"] = {
            "killed": target.replica_id, "streams": n,
            "affected": affected,
            "kill_to_resumed_ms": [streams[i]["resumed_ms"]
                                   for i in affected],
            "kill_to_next_token_ms": [streams[i]["next_token_ms"]
                                      for i in affected],
            "tokens": [streams[i]["tokens"] for i in range(n)],
            "health": {"status": health.get("status"),
                       "fleet": health.get("fleet")},
            "stitched": {k: stitched.get(k) for k in (
                "resumed", "terminal_events", "components", "n_spans")},
            "control_equal": frame_text(results[0]) == frame_text(ref)}
        for i, frames in enumerate(results):
            types = [f["type"] for f in frames]
            if frame_errors(frames) or types[-1] != "response_complete":
                fail(f"phase 14 (b): stream {i} ended {frames[-1]}")
            want = 1 if i in affected else 0
            if types.count("resumed") != want:
                fail(f"phase 14 (b): stream {i} had "
                     f"{types.count('resumed')} resumed frames, not {want}")
            if want and "token" not in types[types.index("resumed"):]:
                fail(f"phase 14 (b): stream {i} had no token after its "
                     "resumed frame")
        if 0 not in affected:
            fail(f"phase 14 (b): the control was not on the killed replica "
                 f"{target.replica_id}: {affected}")
        if not res["b"]["control_equal"]:
            a, b = frame_text(results[0]), frame_text(ref)
            k = next((j for j in range(min(len(a), len(b)))
                      if a[j] != b[j]), min(len(a), len(b)))
            fail(f"phase 14 (b): the resumed control differs from its "
                 f"unbroken run at character {k}: {a[k:k + 40]!r} vs "
                 f"{b[k:k + 40]!r}")
        fleet_h = health.get("fleet") or {}
        if status != 200 or health.get("status") != "degraded" \
                or fleet_h.get("dead") != 1:
            fail(f"phase 14 (b): /health with a dead replica: {status} "
                 f"{health.get('status')} {fleet_h}")
        if trace_status != 200 or stitched.get("resumed", 0) < 1 \
                or stitched.get("terminal_events") != 1:
            fail(f"phase 14 (b): /traces/{resumed_rid}: {trace_status} "
                 f"{res['b']['stitched']}")
        need_launches("(b)", res["b_launches"],
                      ("int8_matmul", "int8_matmul_t", "decode_attend"))
        return res

    ab = run_fleet("(a)-(b)", config(shared_prefix=False), part_ab)
    out.update(ab)
    out["memory_allocated_after_ab"] = fleet_memory_check(mem_start,
                                                         "(a)-(b)")
    a, b = ab["a"], ab["b"]
    log(f"phase 14 (a): 2 replicas, 16 sessions x 64 tokens: {a['tokens']} "
        f"tokens in {a['wall_s']:.6g} s ({a['tok_s']:.6g} decode tok/s; "
        f"phase 5 on one engine: {phase5['tok_s']:.6g}), TTFT p50 "
        f"{a['ttft_p50_ms']} ms, p99 {a['ttft_p99_ms']} ms (phase 5: "
        f"{phase5['ttft_p50_ms']}, {phase5['ttft_p99_ms']}); placements "
        f"{a['placements']}, affinity hits {a['affinity_hits']}")
    log(f"phase 14 (b): killed {b['killed']} carrying streams "
        f"{b['affected']} of {b['streams']}; kill->resumed ms "
        f"{b['kill_to_resumed_ms']}, kill->next token ms "
        f"{b['kill_to_next_token_ms']}; the control equal to its unbroken "
        f"run; /health {b['health']}; stitched trace {b['stitched']}")
    log(f"  launches: (a) {ab['a_launches']}; (b) {ab['b_launches']}")

    # ---------------- (c) drain with KV migration ----------------
    def migrate_cfg(i: int) -> dict:
        return {"system_prompt": f"You keep lighthouse {i}; answer in one "
                                 "short sentence.",
                "max_tokens": 32, "temperature": 0.0, "ignore_eos": True}

    async def part_c(launcher, http, port, serving_url) -> dict:
        router = launcher.engine
        h0, h1 = router.replicas
        e0, e1 = h0.engine, h1.engine
        res: dict = {}
        zero_launches()

        async def pinned(replica: str):
            ws, sid = await ws_open(http, port)
            router.affinity.set(sid, replica)
            return ws, sid

        # The control conversation, on inproc-1.
        cws, csid = await pinned("inproc-1")
        control = [await ws_frames(cws, MIGRATE_TURNS[0], migrate_cfg(0)),
                   await ws_frames(cws, MIGRATE_TURNS[1])]
        # The sessions of inproc-0: the control's conversation alone, three
        # others together, and one to time the priming migration.
        m = [await pinned("inproc-0") for _ in range(5)]
        turn1 = [await ws_frames(m[0][0], MIGRATE_TURNS[0],
                                 migrate_cfg(0))]
        turn1 += await asyncio.gather(*(
            ws_frames(ws, MIGRATE_TURNS[0], migrate_cfg(i))
            for i, (ws, _) in enumerate(m[1:], start=1)))
        for frames in control + turn1:
            if frames[-1]["type"] != "response_complete":
                fail(f"phase 14 (c): a first turn failed: {frames[-1]}")
        sids = [sid for _, sid in m]
        await until(lambda: all(e0.parked_kv_info(s) for s in sids)
                    and e1.parked_kv_info(csid), 60,
                    "the idle sessions never parked", phase="phase 14")
        # One timed migration feeds the router's bandwidth EMA.
        prime = sids.pop()
        status = await asyncio.to_thread(router._migrate_session, prime,
                                         h0, h1)
        if status != "ok":
            fail(f"phase 14 (c): the priming migration: {status}")
        router.affinity.set(prime, "inproc-1")   # as a drain re-pins
        entries = {s: e0.parked_kv_info(s) for s in sids}
        pool0, pool1 = e0._kv_pool.stats(), e1._kv_pool.stats()
        mig0 = router._m_migrations.value
        async with http.post(serving_url + "/fleet/drain/inproc-0") as r:
            drain_status, summary = r.status, await r.json()
        pool0b, pool1b = e0._kv_pool.stats(), e1._kv_pool.stats()
        # The drained replica's slots stay pinned, so its idle tick may
        # park a migrated session again (as the JAX engine's does): those
        # entries are counted back on inproc-0's side.
        reparked = sum(e0.parked_kv_info(s)[1] for s in entries
                       if e0.parked_kv_info(s) is not None)
        landed = {s: e1.parked_kv_info(s) for s in entries}
        homes = {s: router.affinity.get(s) for s in entries}
        moved = sum(nb for _, nb in entries.values())
        restored0 = e1._kv_pool.stats()["restored_total"]
        turn2 = [await ws_frames(m[0][0], MIGRATE_TURNS[1])]
        turn2 += await asyncio.gather(*(
            ws_frames(ws, MIGRATE_TURNS[1]) for ws, _ in m[1:4]))
        restored = e1._kv_pool.stats()["restored_total"] - restored0
        for ws, _ in m + [(cws, csid)]:
            await ws.close()
        events = [e["attrs"] for e in get_events().recent(
            limit=64, kind="router_migration")]
        res["c_launches"] = launches()
        mb = sum(e["bytes"] for e in events) / 2**20
        ms = sum(e["ms"] for e in events)
        res["c"] = {
            "drain_status": drain_status, "summary": summary,
            "entries": entries, "moved_bytes": moved,
            "pool0_bytes": [pool0["bytes"], pool0b["bytes"]],
            "reparked_bytes": reparked,
            "pool1_bytes": [pool1["bytes"], pool1b["bytes"]],
            "migrations": router._m_migrations.value - mig0,
            "restored": restored,
            "inproc_migrations": [(e["bytes"], e["ms"]) for e in events],
            "inproc_mb": mb,
            "inproc_gb_s": (mb / 1024) / (ms / 1e3) if ms else None,
            "control_equal": [frame_text(turn1[0]) == frame_text(
                control[0]), frame_text(turn2[0]) == frame_text(
                control[1])],
            "prompt_tokens": [control[1][-1]["stats"]["prompt_tokens"],
                              turn2[0][-1]["stats"]["prompt_tokens"]]}
        res["c_control_text"] = [frame_text(f) for f in control]
        res["c_control_prompt_tokens"] = \
            control[1][-1]["stats"]["prompt_tokens"]
        errors = [e for fr in control + turn1 + turn2
                  for e in frame_errors(fr)]
        if errors:
            fail(f"phase 14 (c): error frames: {errors[:3]}")
        if drain_status != 200 or summary.get("migrated_kv") != len(sids) \
                or res["c"]["migrations"] != len(sids):
            fail(f"phase 14 (c): the drain migrated {summary} "
                 f"({res['c']['migrations']} migrations), not {len(sids)}")
        if landed != entries or set(homes.values()) != {"inproc-1"}:
            fail(f"phase 14 (c): after the drain the entries on inproc-1 "
                 f"are {landed} (moved {entries}), the sessions pinned to "
                 f"{homes}")
        if pool0b["bytes"] != pool0["bytes"] - moved + reparked \
                or pool1b["bytes"] != pool1["bytes"] + moved:
            fail(f"phase 14 (c): pool bytes not exact: inproc-0 "
                 f"{pool0['bytes']} -> {pool0b['bytes']} (parked again "
                 f"{reparked}), inproc-1 {pool1['bytes']} -> "
                 f"{pool1b['bytes']}, moved {moved}")
        if restored != len(sids):
            fail(f"phase 14 (c): {restored} migrated turns restored on "
                 f"inproc-1, not {len(sids)}")
        if not all(res["c"]["control_equal"]):
            fail(f"phase 14 (c): the migrated conversation differs from "
                 f"its control: {res['c']['control_equal']}: "
                 f"{frame_text(turn2[0])[:80]!r} vs "
                 f"{frame_text(control[1])[:80]!r}")
        need_launches("(c)", res["c_launches"],
                      ("int8_matmul", "int8_matmul_t", "decode_attend"))
        return res

    pool_kw = dict(kv_host_budget_mb=4096.0, kv_park_idle_s=1.0,
                   shared_prefix=False)
    c = run_fleet("(c)", config(**pool_kw), part_c)
    out.update(c)
    out["memory_allocated_after_c"] = fleet_memory_check(mem_start, "(c)")

    # (c) over the wire: two single-engine servers with KV_MIGRATE_HTTP.
    reset_observability()
    wire_cfg = config(router_enabled=False, kv_migrate_http=True, **pool_kw)
    t = time.monotonic()
    src = factory.build_engine(wire_cfg, device="cuda")
    dst = factory.build_engine(wire_cfg, device="cuda")
    log(f"phase 14 (c, wire): two servers' engines built in "
        f"{time.monotonic() - t:.6g} s")

    async def wire() -> dict:
        runners = []
        try:
            urls = []
            for eng in (src, dst):
                eng.start()
                runner = web.AppRunner(WebSocketLLMServer(wire_cfg, eng).app)
                await runner.setup()
                site = web.TCPSite(runner, "127.0.0.1", 0)
                await site.start()
                runners.append(runner)
                urls.append(site._server.sockets[0].getsockname()[1])
            zero_launches()
            async with aiohttp.ClientSession() as http:
                ws, sid = await ws_open(http, urls[0])
                first = await ws_frames(ws, MIGRATE_TURNS[0], migrate_cfg(0))
                await until(lambda: src.parked_kv_info(sid), 60,
                            "the wire session never parked",
                            phase="phase 14")
                base = [f"http://127.0.0.1:{p}/kv/parked/{sid}" for p in urls]
                meta_status, meta = await get_json(http, base[0] + "?meta=1")
                t0 = time.monotonic()
                async with http.get(base[0]) as r:
                    get_status, body = r.status, await r.read()
                t1 = time.monotonic()
                async with http.post(base[1], data=body, headers={
                        "Content-Type": "application/octet-stream"}) as r:
                    post_status, posted = r.status, await r.json()
                t2 = time.monotonic()
                async with http.delete(base[0]) as r:
                    delete_status = r.status
                dst_meta_status, dst_meta = await get_json(
                    http, base[1] + "?meta=1")
                restored0 = dst._kv_pool.stats()["restored_total"]
                history = [{"role": "system",
                            "content": migrate_cfg(0)["system_prompt"]},
                           {"role": "user", "content": MIGRATE_TURNS[0]},
                           {"role": "assistant",
                            "content": frame_text(first)},
                           {"role": "user", "content": MIGRATE_TURNS[1]}]
                async with http.post(
                        f"http://127.0.0.1:{urls[1]}/v1/chat/completions",
                        json={"model": "llama3.2:1b", "messages": history,
                              "user": sid, "max_tokens": 32,
                              "temperature": 0.0, "ignore_eos": True,
                              "repeat_penalty":
                                  wire_cfg.default_repeat_penalty}) as r:
                    v1_status, v1 = r.status, await r.json()
                restored = dst._kv_pool.stats()["restored_total"] - restored0
                await ws.close()
            return {"first": frame_text(first), "meta": [meta_status, meta],
                    "get_status": get_status, "post_status": post_status,
                    "posted": posted, "delete_status": delete_status,
                    "dst_meta": [dst_meta_status, dst_meta],
                    "bytes": len(body), "get_ms": (t1 - t0) * 1e3,
                    "post_ms": (t2 - t1) * 1e3, "v1_status": v1_status,
                    "v1": v1, "restored": restored,
                    "launches": launches()}
        finally:
            for runner in runners:
                await runner.cleanup()

    try:
        w = asyncio.run(asyncio.wait_for(wire(), timeout=600))
    finally:
        src.shutdown()
        dst.shutdown()
        del src, dst
        reset_observability()   # the watchdog holds the last server's engine
    text2 = ((w["v1"].get("choices") or [{}])[0].get("message") or {}).get(
        "content")
    w["second"] = text2
    w["prompt_tokens"] = (w["v1"].get("usage") or {}).get("prompt_tokens")
    w["mb"] = w["bytes"] / 2**20
    w["gb_s"] = (w["mb"] / 1024) / ((w["get_ms"] + w["post_ms"]) / 1e3)
    out["c_wire"] = {k: v for k, v in w.items()
                     if k not in ("v1", "first", "second")}
    out["memory_allocated_after_c_wire"] = fleet_memory_check(
        mem_start, "(c, wire)")
    entry = w["meta"][1]
    if w["meta"][0] != 200 or w["get_status"] != 200 \
            or w["post_status"] != 200 or w["delete_status"] != 200 \
            or w["dst_meta"][0] != 200 \
            or w["dst_meta"][1].get("nbytes") != entry.get("nbytes") \
            or w["posted"].get("nbytes") != entry.get("nbytes"):
        moves = {k: w[k] for k in ("meta", "get_status", "post_status",
                                   "delete_status", "dst_meta")}
        fail(f"phase 14 (c, wire): the /kv/parked moves: {moves}")
    if w["v1_status"] != 200 or w["restored"] != 1:
        fail(f"phase 14 (c, wire): the next turn on the second server: "
             f"{w['v1_status']}, restored {w['restored']}: {w['v1']}")
    if w["first"] != c["c_control_text"][0] \
            or text2 != c["c_control_text"][1] \
            or w["prompt_tokens"] != c["c_control_prompt_tokens"]:
        fail(f"phase 14 (c, wire): the moved conversation differs from the "
             f"control: {w['first'][:60]!r} / {text2!r:.80} vs "
             f"{c['c_control_text'][1][:80]!r}; prompt tokens "
             f"{w['prompt_tokens']} vs {c['c_control_prompt_tokens']}")
    need_launches("(c, wire)", w["launches"],
                  ("int8_matmul", "int8_matmul_t", "decode_attend"))
    cc = c["c"]
    log(f"phase 14 (c): drain of inproc-0 migrated {cc['summary']} "
        f"({cc['migrations']} migrations, {cc['moved_bytes']} bytes); pool "
        f"bytes inproc-0 {cc['pool0_bytes']}, inproc-1 {cc['pool1_bytes']}; "
        f"{cc['restored']} restored on inproc-1; the control equal; in "
        f"process {cc['inproc_mb']:.6g} MB at {cc['inproc_gb_s']} GB/s "
        f"over {cc['inproc_migrations']} (bytes, ms)")
    log(f"phase 14 (c, wire): {w['mb']:.6g} MB by GET {w['get_ms']:.6g} ms "
        f"+ POST {w['post_ms']:.6g} ms ({w['gb_s']:.6g} GB/s); restored on "
        f"the second server, the control equal")
    log(f"  launches: (c) {c['c_launches']}; (c, wire) {w['launches']}")

    # ---------------- (d) the disaggregated prefill tier ----------------
    async def part_d(launcher, http, port, serving_url) -> dict:
        router = launcher.engine
        pre, dec = (h.engine for h in router.replicas)
        res: dict = {}
        zero_launches()
        pre0, dec0 = pre.get_stats(), dec.get_stats()
        ins0 = dec.get_stats()["kv_radix"]["inserted_blocks"]
        sessions = [await ws_open(http, port) for _ in range(8)]
        cfg = {"max_tokens": 32, "temperature": 0.7, "ignore_eos": True}
        texts = [DISAGG_PREFIX + " " + " ".join(
            f"Question {i}.{j}: which ship carried the most cargo on day "
            f"{j}?" for j in range(DISAGG_QUESTIONS)) for i in range(8)]
        frames = await asyncio.gather(*(
            ws_frames(ws, texts[i], cfg) for i, (ws, _) in
            enumerate(sessions)))
        handoffs = [e["attrs"] for e in get_events().recent(
            limit=64, kind="router_disagg_handoff")]
        mid = dec.get_stats()
        # The probe: the shared prefix and a short question, decode-local.
        hits0 = mid["kv_radix"]["hit_tokens"]
        pws, _ = await ws_open(http, port)
        probe = await ws_frames(pws, DISAGG_PREFIX + " Which ship was first?",
                                cfg)
        await pws.close()
        dec1 = dec.get_stats()
        # A handoff fault: falls back to mixed placement, no error frame.
        fb0 = router._m_handoff_fallbacks.value
        fp.activate("router.handoff=error;count=1")
        try:
            fws, _ = await ws_open(http, port)
            fallback = await ws_frames(fws, texts[0] + " Once more.", cfg)
            await fws.close()
        finally:
            fp.clear()
        for ws, _ in sessions:
            await ws.close()
        pre1 = pre.get_stats()
        res["d_launches"] = launches()
        res["d"] = {
            "handoffs": router.disagg.handoffs,
            "prompt_tokens": [f[-1].get("stats", {}).get("prompt_tokens")
                              for f in frames],
            "handoff_ms": [h["settle_ms"] for h in handoffs],
            "handoff_mb": [h["bytes"] / 2**20 for h in handoffs],
            "prefill_parks": pre1["kv_host"]["parked_total"]
            - pre0["kv_host"]["parked_total"],
            "prefill_decode_calls": pre1["decode_calls"]
            - pre0["decode_calls"],
            "decode_restored": mid["kv_host"]["restored_total"]
            - dec0["kv_host"]["restored_total"],
            "radix_inserted": mid["kv_radix"]["inserted_blocks"] - ins0,
            "probe_hit_tokens": dec1["kv_radix"]["hit_tokens"] - hits0,
            "fallbacks": router._m_handoff_fallbacks.value - fb0,
            "kv_blocks": {k: v for k, v in dec1.get("kv_blocks", {}).items()
                          if k != "tables"}}
        d = res["d"]
        errors = [e for fr in frames + [probe, fallback]
                  for e in frame_errors(fr)]
        if errors or any(fr[-1]["type"] != "response_complete"
                         for fr in frames + [probe, fallback]):
            fail(f"phase 14 (d): error frames: {errors[:3]}")
        if d["handoffs"] != 8 or len(handoffs) != 8 \
                or d["prefill_parks"] < 8 or d["decode_restored"] != 8:
            fail(f"phase 14 (d): not every session handed off: {d}")
        if d["prefill_decode_calls"] != 0:
            fail(f"phase 14 (d): the prefill replica ran "
                 f"{d['prefill_decode_calls']} decode calls")
        if d["radix_inserted"] <= 0 or d["probe_hit_tokens"] <= 0:
            fail(f"phase 14 (d): the imported prefixes did not reach the "
                 f"decode replica's radix tree: {d}")
        if d["fallbacks"] != 1:
            fail(f"phase 14 (d): the router.handoff fault did not fall "
                 f"back: {d['fallbacks']}")
        need_launches("(d)", res["d_launches"],
                      ("int8_matmul", "int8_matmul_t",
                       "decode_attend_paged"))
        return res

    d = run_fleet("(d)", config(
        fleet_roles="prefill,decode", kv_layout="paged", kv_block_size=BLOCK,
        kv_pool_blocks=2048, kv_radix_enabled=True, max_model_len=8192,
        default_context_window=8192, kv_host_budget_mb=4096.0,
        disagg_prefill_min_tokens=DISAGG_MIN_TOKENS), part_d)
    out.update(d)
    out["memory_allocated_after_d"] = fleet_memory_check(mem_start, "(d)")
    dd = d["d"]
    log(f"phase 14 (d): {dd['handoffs']} handoffs of prompts of "
        f"{dd['prompt_tokens']} tokens; settle ms {dd['handoff_ms']}, MB "
        f"{dd['handoff_mb']}; prefill replica parks {dd['prefill_parks']}, "
        f"decode calls {dd['prefill_decode_calls']}; decode replica "
        f"restores {dd['decode_restored']}, radix blocks inserted "
        f"{dd['radix_inserted']}, probe hit tokens "
        f"{dd['probe_hit_tokens']}; fallbacks {dd['fallbacks']}")
    log(f"  launches: {d['d_launches']}")

    # ---------------- (e) the elastic scaler ----------------
    async def part_e(launcher, http, port, serving_url) -> dict:
        router, scaler = launcher.engine, launcher.scaler
        res: dict = {}
        zero_launches()
        timing: dict = {}
        inner = scaler.build_replica

        def build_replica(replica_id: str, role: str = "mixed"):
            timing["build_start"] = time.monotonic()
            try:
                return inner(replica_id, role)
            finally:
                timing["build_end"] = time.monotonic()
        scaler.build_replica = build_replica
        cfg = {"max_tokens": 64, "temperature": 0.7, "ignore_eos": True}

        async def one(text: str) -> list[dict]:
            ws, _ = await ws_open(http, port)
            frames = await ws_frames(ws, text, cfg)
            await ws.close()
            return frames

        t0 = time.monotonic()
        burst = [asyncio.create_task(one(f"Tell me fact number {i}."))
                 for i in range(32)]
        t_joined = await until(lambda: len(router.replicas) == 2, 120,
                               "the scaler never added a replica",
                               phase="phase 14")
        new = router.replicas[1]
        placed0 = new.placements
        burst += [asyncio.create_task(one(f"Tell me fact number {i}."))
                  for i in range(32, 48)]
        frames = await asyncio.gather(*burst)
        placed = new.placements - placed0
        wall = time.monotonic() - t0
        t_done = time.monotonic()
        await until(lambda: len(router.replicas) == 1, 120,
                    "the scaler never drained back to one replica",
                    phase="phase 14")
        res["e_launches"] = launches()
        errors = [e for fr in frames for e in frame_errors(fr)]
        tokens = sum(fr[-1]["stats"]["tokens_generated"] for fr in frames
                     if fr[-1]["type"] == "response_complete")
        res["e"] = {"sessions": len(frames), "tokens": tokens,
                    "wall_s": wall, "new_replica": new.replica_id,
                    "placed_on_new": placed,
                    "build_ms": (timing["build_end"] - timing["build_start"])
                    * 1e3,
                    "scale_up_ms": (t_joined - timing["build_start"]) * 1e3,
                    "burst_to_joined_ms": (t_joined - t0) * 1e3,
                    "idle_to_one_replica_s": time.monotonic() - t_done,
                    "scaler": scaler.stats()}
        if errors or any(fr[-1]["type"] != "response_complete"
                         for fr in frames):
            fail(f"phase 14 (e): error frames: {errors[:3]}")
        if placed <= 0:
            fail("phase 14 (e): no session placed on the new replica")
        need_launches("(e)", res["e_launches"],
                      ("int8_matmul", "int8_matmul_t", "decode_attend"))
        return res

    e = run_fleet("(e)", config(
        fleet_replicas=1, fleet_scale_min=1, fleet_scale_max=2,
        fleet_scale_check_s=0.25, fleet_scale_down_idle_s=2.0), part_e)
    out.update(e)
    out["memory_allocated_end"] = fleet_memory_check(mem_start, "(e)")
    ee = e["e"]
    log(f"phase 14 (e): {ee['sessions']} sessions, {ee['tokens']} tokens in "
        f"{ee['wall_s']:.6g} s; scale-up {ee['scale_up_ms']:.6g} ms (engine "
        f"build {ee['build_ms']:.6g} ms; burst to joined "
        f"{ee['burst_to_joined_ms']:.6g} ms), {ee['placed_on_new']} sessions "
        f"on {ee['new_replica']}; back to one replica "
        f"{ee['idle_to_one_replica_s']:.6g} s after the burst; "
        f"{ee['scaler']}")
    log(f"  launches: {e['e_launches']}")
    log(f"phase 14: memory allocated {mem_start} bytes at the start, "
        f"{out['memory_allocated_end']} at the end; "
        f"{time.monotonic() - t14:.6g} s")
    return out



# ------------------------------------------- phase 15: multi-rank serving

# A tp = 2 rank's shards of the Llama-3.2-1B layer matmuls, (K, N) and how
# many a layer runs: column-parallel wq, wk/wv, w_gate/w_up at N/2,
# row-parallel wo and w_down at K/2; the tied head's D/2 columns; 4 of the
# 8 KV heads. Phase 15a serves 8 slots, so the decode rows are 8.
TP2_MATMULS = {(2048, 1024): 1, (2048, 256): 2, (1024, 2048): 1,
               (2048, 4096): 2, (4096, 2048): 1}
# The row-parallel shards (wo, w_down): their partial products stay
# float32 until the sum over "tp" (ops/quant.py ``row_parallel``).
TP2_ROW_PARALLEL = {(1024, 2048), (4096, 2048)}
TP2_SLOTS = 8
# Phase 15a's model: llama3.2:1b at full width and depth, int8 random
# weights from the seed (the tokens a session asks for follow it).
PHASE15_A_MODEL = {"LLM_MODEL": "llama3.2:1b", "MODEL_PATH": "",
                   "WEIGHT_QUANT": "int8"}
PHASE15_A_TOKENS = 64
PHASE15_TINY_PROMPTS = ["what color is the sky?", "tell me about cats.",
                        "my name is Ada.", "what do dogs eat?"]
# 858 tinychat tokens with the chat template: a fresh prompt past one
# rank's KV shard at sp = 2 (TPU_MAX_MODEL_LEN=1536: 768 rows a rank), so it
# prefills through ring attention.
PHASE15_LONG = ("the cat sat in the garden and watched the birds fly over "
                "the old stone wall while the dog slept. ") * 20 \
    + "what did the cat watch?"


def memory_owners(label: str) -> dict:
    """Attribute the bytes allocated on the card to their holders: the
    live ``TorchEngine`` objects the garbage collector finds (shut down or
    not) with the bytes of their cache, params and decode state; every live
    CUDA tensor it sees, by storage, the largest listed by shape; and the
    active bytes of ``torch.cuda.memory_snapshot()``."""
    from fasttalk_tpu_torch.engine.engine import TorchEngine

    import warnings

    gc.collect()
    allocated = active = 0
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        allocated = torch.cuda.memory_allocated()
        active = sum(b["size"] for seg in torch.cuda.memory_snapshot()
                     for b in seg["blocks"]
                     if b["state"] == "active_allocated")
    storages: dict[int, tuple] = {}
    engines = []
    with warnings.catch_warnings():
        # isinstance on every object touches deprecated module attributes.
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            try:
                if isinstance(obj, torch.Tensor) and obj.is_cuda:
                    st = obj.untyped_storage()
                    storages[st.data_ptr()] = (
                        st.nbytes(), tuple(obj.shape),
                        str(obj.dtype).replace("torch.", ""))
                elif isinstance(obj, TorchEngine):
                    engines.append(obj)
            except Exception:
                continue

    def owned(*trees) -> int:
        ptrs: dict[int, int] = {}

        def walk(x):
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    st = x.untyped_storage()
                    ptrs[st.data_ptr()] = st.nbytes()
            elif isinstance(x, dict):
                for v in x.values():
                    walk(v)
            elif isinstance(x, (list, tuple)):
                for v in x:
                    walk(v)
            elif hasattr(x, "__dict__") and not isinstance(x, type):
                for v in vars(x).values():
                    if isinstance(v, (torch.Tensor, dict, list, tuple)):
                        walk(v)
        for t in trees:
            walk(t)
        return sum(ptrs.values())

    eng = [{"closed": e._closed, "started": e._started,
            "model": e.cfg.name,
            "bytes": owned(e.cache, e.params, e._dev)} for e in engines]
    top = sorted(storages.values(), reverse=True)[:10]
    out = {"allocated": allocated, "snapshot_active": active,
           "gc_tensor_bytes": sum(v[0] for v in storages.values()),
           "gc_tensors": len(storages), "engines": eng,
           "largest": [{"bytes": b, "shape": s, "dtype": d}
                       for b, s, d in top]}
    log(f"{label}: memory on the card: allocated {allocated}, "
        f"memory_snapshot active {active}, live CUDA tensors the collector "
        f"sees {out['gc_tensor_bytes']} in {len(storages)} storages; live "
        f"TorchEngine objects {eng}; largest {out['largest']}")
    return out


def launch_counts() -> dict:
    """This process's launch counts of the phase 15 kernels."""
    from fasttalk_tpu_torch.ops.cuda_attention import decode_attend
    from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

    return {"int8_matmul": int8_matmul.launches,
            "int8_matmul_t": int8_matmul_t.launches,
            "decode_attend": decode_attend.launches,
            "int4_matmul": int4_matmul.launches}


def check_shard_kernels(results: dict) -> None:
    """Phase 15, before serving: ``int8_matmul`` at a tp = 2 rank's shard
    shapes (N/2 column-parallel, K/2 row-parallel with float32 partial
    output), ``int8_matmul_t`` over the table's D/2 columns (float32
    partial logits) and ``decode_attend`` on 4 of the 8 KV heads, at phase
    15a's 8 decode rows, each held to its plain version with phase 2's
    tolerances and timed beside it, the library call and its bound (one
    rank's decode step: 112 matmul calls, one head, 16 attention calls).
    A float32 output must also round to the kernel's bf16 output bit for
    bit. Recorded under ``tp2`` of each kernel's entry."""
    from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                       decode_attend_plain)
    from fasttalk_tpu_torch.ops.cuda_int8 import (int8_matmul,
                                                  int8_matmul_plain,
                                                  int8_matmul_t,
                                                  int8_matmul_t_plain)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    m = TP2_SLOTS
    step = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
            "ops": 0.0, "max_abs_err": 0.0}
    for (k, n), per_layer in TP2_MATMULS.items():
        n_cp = copies_for(k * n)
        qs = [torch.randint(-127, 128, (k, n), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(n_cp)]
        s = torch.rand((n,), generator=g, device=dev) * 0.02 + 1e-3
        x = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        out = torch.float32 if (k, n) in TP2_ROW_PARALLEL else None
        got = int8_matmul(x, qs[0], s, out).float()
        ref = int8_matmul_plain(x, qs[0], s, out).float()
        err = (got - ref).abs().max().item()
        tol = 1e-2 * ref.abs().max().item()
        log(f"phase 15 int8_matmul (tp=2 shard) M={m} K={k} N={n} "
            f"out {out or 'bf16'}: max_abs_err={err:.6g} (tol {tol:.6g})")
        if not err <= tol:
            fail(f"int8_matmul disagrees with its plain version at the tp=2 "
                 f"shard M={m} K={k} N={n}: {err} > {tol}")
        if out is not None and not torch.equal(
                got.to(torch.bfloat16), int8_matmul(x, qs[0], s)):
            fail(f"int8_matmul's float32 output at K={k} N={n} does not "
                 "round to its bf16 output")
        ms = time_ms(lambda i: int8_matmul(x, qs[i % n_cp], s, out), 50)
        plain = time_ms(
            lambda i: int8_matmul_plain(x, qs[i % n_cp], s, out), 10)
        ws = [(q.float() * s).to(torch.bfloat16)
              for q in qs[:max(1, n_cp // 2)]]
        lib = time_ms(lambda i: torch.matmul(x, ws[i % len(ws)]), 50)
        del ws
        calls = per_layer * LAYERS
        step["max_abs_err"] = max(step["max_abs_err"], err)
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bytes", k * n + 4 * n + 2 * m * k
                          + (4 if out else 2) * m * n),
                         ("ops", 2 * m * k * n)):
            step[key] += calls * val
    b_ms, by = bound(step.pop("bytes"), step.pop("ops"))
    results["int8_matmul"]["tp2"] = {
        **step, "bound_ms": b_ms, "bound_by": by,
        "work": "one tp=2 rank's decode step at M=8: 112 calls over the 5 "
                "shard (K, N) shapes, wo and w_down with float32 output"}
    log(f"phase 15 int8_matmul tp=2 rank step: {results['int8_matmul']['tp2']}")

    vocab, d = VOCAB, HIDDEN // 2
    q = torch.randint(-127, 128, (vocab, d), generator=g, device=dev,
                      dtype=torch.int8)
    s = torch.rand((vocab,), generator=g, device=dev) * 0.02 + 1e-3
    x = torch.randn((m, d), generator=g, device=dev).to(torch.bfloat16)
    f32 = torch.float32
    got = int8_matmul_t(x, q, s, f32)
    ref = int8_matmul_t_plain(x, q, s, f32)
    err = (got - ref).abs().max().item()
    tol = 1e-2 * ref.abs().max().item()
    log(f"phase 15 int8_matmul_t (tp=2 shard) M={m} V={vocab} D={d} out "
        f"float32: max_abs_err={err:.6g} (tol {tol:.6g})")
    if not err <= tol:
        fail(f"int8_matmul_t disagrees with its plain version at the tp=2 "
             f"shard D={d}: {err} > {tol}")
    if not torch.equal(got.to(torch.bfloat16), int8_matmul_t(x, q, s)):
        fail("int8_matmul_t's float32 output does not round to its bf16 "
             "output")
    del got, ref
    ms = time_ms(lambda i: int8_matmul_t(x, q, s, f32), 20)
    plain = time_ms(lambda i: int8_matmul_t_plain(x, q, s, f32), 3,
                    warmup=1)
    w = (q.float() * s[:, None]).to(torch.bfloat16)
    lib = time_ms(lambda i: torch.nn.functional.linear(x, w), 20)
    del w, q
    b_ms, by = bound(vocab * d + 4 * vocab + 2 * m * d + 4 * m * vocab,
                     2 * m * vocab * d)
    results["int8_matmul_t"]["tp2"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "library_ms": lib,
        "bound_ms": b_ms, "bound_by": by,
        "work": "one call at M=8 over the table's D/2 columns (a tp=2 "
                "rank's float32 partial logits)"}
    log(f"phase 15 int8_matmul_t tp=2: {results['int8_matmul_t']['tp2']}")

    nq, nkv = NQ // 2, NKV // 2
    lengths = torch.tensor(ATTEND_LENGTHS[:m], dtype=torch.int32, device=dev)
    n_cp = copies_for(2 * m * MAX_LEN * nkv * HEAD_DIM * 2)
    ks = [torch.randn((m, MAX_LEN, nkv, HEAD_DIM), generator=g,
                      device=dev).to(torch.bfloat16) for _ in range(n_cp)]
    vs = [torch.randn((m, MAX_LEN, nkv, HEAD_DIM), generator=g,
                      device=dev).to(torch.bfloat16) for _ in range(n_cp)]
    qa = torch.randn((m, nq, HEAD_DIM), generator=g,
                     device=dev).to(torch.bfloat16)
    got = decode_attend(qa, ks[0], vs[0], lengths)
    ref = decode_attend_plain(qa, ks[0], vs[0], lengths)
    gaps = attend_slot_gaps(got, ref)
    err = (got.float() - ref.float()).abs().max().item()
    log(f"phase 15 decode_attend (tp=2: {nkv} of {NKV} KV heads, {m} slots): "
        f"max_abs_err={err:.6g}, worst slot gap {gaps.max().item():.6g} "
        f"(tol {ATTEND_SLOT_TOL})")
    if not bool((gaps <= ATTEND_SLOT_TOL).all()):
        fail(f"decode_attend disagrees with its plain version on a tp=2 "
             f"rank's KV heads: {gaps.tolist()}")
    ms = time_ms(lambda i: decode_attend(qa, ks[i % n_cp], vs[i % n_cp],
                                         lengths), 50)
    plain = time_ms(lambda i: decode_attend_plain(qa, ks[i % n_cp],
                                                  vs[i % n_cp], lengths), 5)
    live = int(lengths.sum().item())
    nbytes = 2 * live * nkv * HEAD_DIM * 2 + 2 * m * nq * HEAD_DIM * 2
    b_ms, by = bound(nbytes, 4 * live * nq * HEAD_DIM)
    results["decode_attend"]["tp2"] = {
        "max_abs_err": err, "ms": ms * LAYERS, "plain_ms": plain * LAYERS,
        "library_ms": None, "bound_ms": b_ms * LAYERS, "bound_by": by,
        "work": f"one tp=2 rank's decode step: {LAYERS} calls, {m} slots "
                f"(lengths ATTEND_LENGTHS[:{m}]), {nkv} KV heads, {nq} query "
                "heads"}
    log(f"phase 15 decode_attend tp=2: {results['decode_attend']['tp2']}")
    del ks, vs
    torch.cuda.empty_cache()


class Cluster:
    """Two ranks of one gloo process group on the card (phase 15): rank 0
    runs ``chip_smoke.py --rank <leader role>``, rank 1 ``chip_smoke.py
    --rank follower`` (``run_spmd_follower``, the follower of ``python -m
    fasttalk_tpu_torch websocket``). SIGUSR2 sets a rank's launch counts to
    0, SIGUSR1 writes them to its file. ``close`` (and a failure) kills
    what is left."""

    def __init__(self, label: str, env: dict, leader_role: str):
        import signal as _signal

        self.label, self._signal = label, _signal
        self.dir = os.path.join(REPO, "build", "phase15",
                                label.replace(" ", "_"))
        os.makedirs(self.dir, exist_ok=True)
        for name in os.listdir(self.dir):
            if name.startswith("rank"):
                os.remove(os.path.join(self.dir, name))
        coord, spmd = free_port(), free_port()
        self.env = {**os.environ, "PYTHONPATH": REPO,
                    "TPU_COORDINATOR_ADDR": f"127.0.0.1:{coord}",
                    "TPU_NUM_PROCESSES": "2",
                    "TPU_SPMD_ADDR": f"127.0.0.1:{spmd}",
                    "TPU_SPMD_FOLLOWERS": "1", "TPU_WARMUP": "off",
                    "ENABLE_PYDANTIC_AI": "false", "PROF_ENABLED": "false",
                    "FLIGHT_DIR": os.path.join(self.dir, "flight"), **env}
        self.procs = []
        for rank, role in ((0, leader_role), (1, "follower")):
            e = dict(self.env, TPU_PROCESS_ID=str(rank),
                     TPU_SPMD_ROLE="leader" if rank == 0 else "follower")
            logf = open(os.path.join(self.dir, f"rank{rank}.log"), "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"),
                 "--rank", role, os.path.join(self.dir, f"rank{rank}.json")],
                cwd=REPO, env=e, stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True), logf))
        # The engine leader zeroes and reads its follower's counts itself.
        with open(os.path.join(self.dir, "rank1.pid"), "w",
                  encoding="utf-8") as f:
            f.write(str(self.procs[1][0].pid))

    def tail(self, rank: int, n: int = 3000) -> str:
        with open(os.path.join(self.dir, f"rank{rank}.log"),
                  encoding="utf-8", errors="replace") as f:
            return f.read()[-n:]

    def check_alive(self) -> None:
        for rank, (p, _) in enumerate(self.procs):
            if p.poll() is not None:
                fail(f"phase 15 {self.label}: rank {rank} exited "
                     f"{p.returncode}:\n{self.tail(rank)}")

    def signal(self, rank: int, sig) -> None:
        self.procs[rank][0].send_signal(sig)

    def counts(self) -> list[dict]:
        """Both ranks' launch counts (SIGUSR1, then their files)."""
        for rank in range(2):
            path = os.path.join(self.dir, f"rank{rank}.counts.json")
            if os.path.exists(path):
                os.remove(path)
            self.signal(rank, self._signal.SIGUSR1)
        out = []
        for rank in range(2):
            path = os.path.join(self.dir, f"rank{rank}.counts.json")
            deadline = time.monotonic() + 30
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    fail(f"phase 15 {self.label}: rank {rank} wrote no "
                         f"launch counts:\n{self.tail(rank)}")
                time.sleep(0.05)
            time.sleep(0.05)
            with open(path, encoding="utf-8") as f:
                out.append(json.load(f))
        return out

    def zero(self) -> None:
        for rank in range(2):
            self.signal(rank, self._signal.SIGUSR2)
        time.sleep(0.2)

    def wait(self, rank: int, timeout: float) -> dict:
        p, _ = self.procs[rank]
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"phase 15 {self.label}: rank {rank} still running after "
                 f"{timeout} s:\n{self.tail(rank)}")
        if p.returncode != 0:
            fail(f"phase 15 {self.label}: rank {rank} exited "
                 f"{p.returncode}:\n{self.tail(rank)}")
        with open(os.path.join(self.dir, f"rank{rank}.json"),
                  encoding="utf-8") as f:
            return json.load(f)

    def close(self) -> None:
        for p, logf in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, self._signal.SIGKILL)
                except OSError:
                    pass
                p.wait()
            logf.close()


def rank_main(role: str, out: str) -> int:
    """One rank of a phase 15 cluster (``chip_smoke.py --rank ROLE OUT``,
    started by ``Cluster``): ``follower`` replays the leader's calls
    (``run_spmd_follower``); ``launcher`` serves the WebSocket gateway
    through ``ServerLauncher`` until SIGTERM or a dead cluster; ``engine``
    builds the leader engine with a ``CallBroadcaster`` and answers the
    greedy prompts of ``PHASE15_PROMPTS`` (JSON) one at a time; it zeroes
    both ranks' launch counts just before the prompts and reads them just
    after (the follower through SIGUSR2 and SIGUSR1, its pid from
    ``rank1.pid``). Writes ``out`` (the launch counts and what it saw) at
    its end."""
    import signal as _signal

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from fasttalk_tpu_torch.ops.cuda_attention import decode_attend
    from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t
    from fasttalk_tpu_torch.utils.config import Config

    def dump(*_):
        path = out.replace(".json", ".counts.json")
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(launch_counts(), f)
        os.replace(path + ".tmp", path)

    def zero(*_):
        for fn in (int8_matmul, int8_matmul_t, decode_attend, int4_matmul):
            fn.launches = 0
        with open(out.replace(".json", ".zeroed"), "w",
                  encoding="utf-8") as f:
            f.write("0")

    _signal.signal(_signal.SIGUSR1, dump)
    _signal.signal(_signal.SIGUSR2, zero)
    config = Config()
    result: dict = {"role": role}
    if role == "follower":
        from fasttalk_tpu_torch.serving.launcher import run_spmd_follower

        run_spmd_follower(config)
    elif role == "launcher":
        from fasttalk_tpu_torch.observability.events import get_events
        from fasttalk_tpu_torch.serving.launcher import ServerLauncher

        launcher = ServerLauncher(config)
        result["mesh"] = launcher.engine.get_model_info()["mesh"]
        launcher.start()
        sink = launcher._spmd_sink
        dead = [e["ts"] for e in get_events().recent(200)
                if e["kind"] == "spmd_cluster_dead"]
        result.update({
            "dead_reason": sink.dead_reason,
            "cluster_dead_at": min(dead) if dead else None,
            "exited_at": time.time(),
            "stats": {k: launcher.engine.get_stats()[k] for k in (
                "decode_calls", "decode_steps", "decode_host_s",
                "batched_prefill_calls", "ring_prefill_calls")}})
    else:
        from fasttalk_tpu_torch.engine.engine import GenerationParams
        from fasttalk_tpu_torch.engine.factory import build_engine
        from fasttalk_tpu_torch.parallel.spmd_serving import CallBroadcaster

        engine = build_engine(config)
        host, port = config.spmd_addr.rsplit(":", 1)
        sink = CallBroadcaster(host, int(port), config.spmd_followers,
                               hb_interval_s=config.spmd_hb_interval_s)
        engine.call_sink = sink
        engine.start()

        async def answer(i: int, text: str) -> str:
            got = ""
            async for ev in engine.generate(
                    f"p{i}", f"p{i}", [{"role": "user", "content": text}],
                    GenerationParams(max_tokens=48, temperature=0.0,
                                     top_k=0, top_p=1.0)):
                if ev["type"] == "token":
                    got += ev["text"]
                elif ev["type"] == "error":
                    raise RuntimeError(f"phase 15 engine leader: {ev}")
            return got

        async def run():
            return [await answer(i, t) for i, t in enumerate(json.loads(
                os.environ["PHASE15_PROMPTS"]))]

        here = os.path.dirname(out)

        def wait_file(name: str) -> str:
            path = os.path.join(here, name)
            deadline = time.monotonic() + 30
            while not os.path.exists(path):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"phase 15 engine leader: no {name}")
                time.sleep(0.05)
            time.sleep(0.05)
            with open(path, encoding="utf-8") as f:
                return f.read()

        def settle() -> None:
            # Until the engine thread has run no call for 0.5 s, then 1 s
            # more for the follower's replay of the last one.
            keys = ("decode_calls", "batched_prefill_calls",
                    "ring_prefill_calls")
            seen = None
            while True:
                now = [engine.get_stats()[k] for k in keys]
                if now == seen:
                    break
                seen = now
                time.sleep(0.5)
            time.sleep(1.0)

        try:
            follower = int(wait_file("rank1.pid"))
            zero()
            os.kill(follower, _signal.SIGUSR2)
            wait_file("rank1.zeroed")
            result["texts"] = asyncio.run(asyncio.wait_for(run(), 300))
            settle()
            result["launches"] = launch_counts()
            os.kill(follower, _signal.SIGUSR1)
            result["follower_launches"] = json.loads(
                wait_file("rank1.counts.json"))
            result["stats"] = {k: engine.get_stats()[k] for k in (
                "decode_calls", "batched_prefill_calls",
                "ring_prefill_calls")}
            result["mesh"] = engine.get_model_info()["mesh"]
        finally:
            engine.shutdown()
            sink.close()
    from fasttalk_tpu_torch.parallel import collectives
    from fasttalk_tpu_torch.parallel.distributed import (process_info,
                                                         shutdown)

    result.setdefault("launches", launch_counts())
    result["collectives"] = collectives.stats()
    result["process"] = process_info()
    shutdown()
    with open(out, "w", encoding="utf-8") as f:
        json.dump(result, f)
    return 0


def nccl_probe_main(out: str) -> int:
    """``chip_smoke.py --nccl-probe OUT``: one rank of two that both take
    ``cuda:0`` and try one NCCL all-reduce. Writes the error NCCL gives
    (it refuses two ranks on one device), or that it ran."""
    import datetime

    import torch.distributed as dist

    rank = int(os.environ["TPU_PROCESS_ID"])
    torch.cuda.set_device(0)
    res = {"rank": rank}
    try:
        dist.init_process_group(
            "nccl", init_method=f"tcp://{os.environ['TPU_COORDINATOR_ADDR']}",
            world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=60))
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res["ran"] = True
        res["sum"] = t.tolist()
    except Exception as e:
        res["ran"] = False
        res["error"] = f"{type(e).__name__}: {e}"[:2000]
    with open(out, "w", encoding="utf-8") as f:
        json.dump(res, f)
    os._exit(0)


async def until_http(url: str, timeout: float, cluster: Cluster) -> None:
    import aiohttp

    deadline = time.monotonic() + timeout
    async with aiohttp.ClientSession() as http:
        while time.monotonic() < deadline:
            cluster.check_alive()
            try:
                async with http.get(url) as r:
                    if r.status == 200:
                        return
            except aiohttp.ClientError:
                pass
            await asyncio.sleep(0.25)
    fail(f"phase 15 {cluster.label}: {url} not up within {timeout} s:\n"
         f"{cluster.tail(0)}")


def nccl_probe() -> dict:
    """NCCL with two ranks on the one card: its answer, written down."""
    d = os.path.join(REPO, "build", "phase15", "nccl_probe")
    os.makedirs(d, exist_ok=True)
    coord = free_port()
    procs = []
    for rank in range(2):
        e = dict(os.environ, PYTHONPATH=REPO, TPU_PROCESS_ID=str(rank),
                 TPU_COORDINATOR_ADDR=f"127.0.0.1:{coord}")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"),
             "--nccl-probe", os.path.join(d, f"rank{rank}.json")],
            cwd=REPO, env=e, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, start_new_session=True))
    res = []
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=120)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, 9)
            p.wait()
        path = os.path.join(d, f"rank{rank}.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                res.append(json.load(f))
        else:
            res.append({"rank": rank, "ran": None,
                        "error": f"no answer within 120 s (exit "
                                 f"{p.returncode})"})
    log(f"phase 15: NCCL with two ranks on cuda:0: {res}")
    return {"ranks": res}


def phase15(counters: dict, phase5: dict, tiny_single: dict) -> dict:
    """Phase 15: multi-rank serving (``fasttalk_tpu_torch/parallel/``) with
    two ranks on the one card over gloo (NCCL refuses two ranks on one
    device: the probe writes its message down), each rank a process of its
    own, as ``python -m fasttalk_tpu_torch websocket`` runs a mesh.

    (a) ``TPU_TP_SIZE=2``: llama3.2:1b at full width and depth, int8 random
        weights from the seed, dense bf16 KV, max_len 2048, 8 slots, spec
        off: a leader (``ServerLauncher``) and a follower. 8 WS sessions x
        64 tokens; decode tok/s and TTFT p50/p99 beside phase 5's (two
        ranks sharing one card say nothing of two cards); the counts of
        both ranks are zeroed just before the sessions and read just
        after: ``int8_matmul``, ``int8_matmul_t`` and ``decode_attend``
        must launch on both, ``int4_matmul`` on neither. Then tinychat
        int8 at tp = 2 must give the single-rank engine's greedy texts
        exactly (the row-parallel partials are float32 and rounded once
        after the sum, where one rank rounds); the launch counts of both
        ranks are zeroed just before the prompts and read just after.
    (b) ``TPU_SP_SIZE=2``: tinychat int8, max_len 1536; a fresh prompt of
        858 tokens prefills through ring attention, and the greedy texts
        equal the single-rank engine's, counted as in (a).
    (c) (a)'s cluster, 8 sessions of up to 512 tokens: the follower is
        killed once every session has a token. Every session must get one
        error frame (none complete), the leader must see the cluster dead
        (its ``spmd_cluster_dead`` event) within 2 heartbeat intervals
        (SPMD_HB_INTERVAL_S=2) and 2 s, and its gateway must shut down (the
        process ends) within 30 s."""
    import signal as _signal

    memory = memory_owners("phase 15 start")
    out: dict = {"memory_start": memory, "nccl": nccl_probe()}
    t15 = time.monotonic()

    # ---------------- (a) + (c): llama3.2:1b, tp = 2 -------------------
    port, mon = free_port(), free_port()
    cluster = Cluster("a_llama_tp2", {
        **PHASE15_A_MODEL, "TPU_TP_SIZE": "2", "TPU_DECODE_SLOTS": str(TP2_SLOTS),
        "TPU_MAX_MODEL_LEN": "2048", "DEFAULT_CONTEXT_WINDOW": "2048",
        "TPU_PREFILL_CHUNK": "512", "TPU_SPEC_DECODE": "off",
        "LLM_HOST": "127.0.0.1", "LLM_PORT": str(port),
        "LLM_MONITORING_HOST": "127.0.0.1", "LLM_MONITORING_PORT": str(mon),
        "SPMD_HB_INTERVAL_S": "2", "SPMD_HB_TIMEOUT_S": "8"}, "launcher")
    try:
        t0 = time.monotonic()
        asyncio.run(until_http(f"http://127.0.0.1:{mon}/health/ready", 300,
                               cluster))
        out["a_ready_s"] = time.monotonic() - t0
        log(f"phase 15a: two ranks of llama3.2:1b tp=2 ready in "
            f"{out['a_ready_s']:.6g} s")
        # One short warm-up session (the first launches), as phase 5's.
        warm = asyncio.run(asyncio.wait_for(drive_sessions(port, 1, 8), 300))
        if warm["errors"]:
            fail(f"phase 15a: warm-up session failed: {warm['errors']}")
        cluster.zero()
        served = asyncio.run(asyncio.wait_for(
            drive_sessions(port, TP2_SLOTS, PHASE15_A_TOKENS), 600))
        time.sleep(0.5)
        lead, fol = cluster.counts()
        served["tok_s"] = served["tokens"] / served["wall_s"]
        served["ttft_p50_ms"] = pct(served["ttft_ms"], 50)
        served["ttft_p99_ms"] = pct(served["ttft_ms"], 99)
        ref = (f"{phase5['tok_s']:.6g} decode tok/s, TTFT p50 "
               f"{phase5['ttft_p50_ms']} / p99 {phase5['ttft_p99_ms']} ms"
               if phase5 else "not run")
        log(f"phase 15a (tp=2, two ranks on one card, gloo): "
            f"{served['sessions']} WS sessions, {served['tokens']} tokens in "
            f"{served['wall_s']:.6g} s ({served['tok_s']:.6g} decode tok/s), "
            f"TTFT p50 {served['ttft_p50_ms']} / p99 "
            f"{served['ttft_p99_ms']} ms, error frames "
            f"{len(served['errors'])}; phase 5 (one rank, 16 sessions) in "
            f"this run: {ref}")
        log(f"  launches: leader {lead}, follower {fol}")
        if served["errors"] \
                or served["tokens"] != TP2_SLOTS * PHASE15_A_TOKENS:
            fail(f"phase 15a: {served['errors'][:3]}, {served['tokens']} "
                 "tokens")
        for name, ranks in (("int8_matmul", (lead, fol)),
                            ("int8_matmul_t", (lead, fol)),
                            ("decode_attend", (lead, fol))):
            if not all(r[name] > 0 for r in ranks):
                fail(f"phase 15a: {name} did not launch on both ranks: "
                     f"{[r[name] for r in ranks]}")
        if lead["int4_matmul"] or fol["int4_matmul"]:
            fail("phase 15a: int4_matmul launched on the int8 path")
        if lead != fol:
            fail(f"phase 15a: the ranks launched different kernels: "
                 f"{lead} against {fol}")
        out["a"] = {k: served[k] for k in ("sessions", "tokens", "wall_s",
                                           "tok_s", "ttft_p50_ms",
                                           "ttft_p99_ms")}
        out["a_launches"] = {"leader": lead, "follower": fol}

        # (c) the follower dies mid-decode.
        async def part_c() -> dict:
            import aiohttp

            frames: list[list[dict]] = [[] for _ in range(TP2_SLOTS)]
            started = [asyncio.Event() for _ in range(TP2_SLOTS)]

            async def one(i, http):
                async with http.ws_connect(
                        f"ws://127.0.0.1:{port}/ws/llm") as ws:
                    json.loads((await ws.receive()).data)
                    await ws.send_json({"type": "start_session", "config": {
                        "max_tokens": 512, "ignore_eos": True}})
                    json.loads((await ws.receive()).data)
                    await ws.send_json({"type": "user_message",
                                        "text": f"tell me story {i}."})
                    while True:
                        msg = await ws.receive(timeout=120)
                        if msg.type != aiohttp.WSMsgType.TEXT:
                            frames[i].append({"type": "closed"})
                            return
                        f = json.loads(msg.data)
                        frames[i].append({**f, "at": time.time()})
                        if f["type"] == "token":
                            started[i].set()
                        if f["type"] in ("response_complete", "error"):
                            return

            async with aiohttp.ClientSession() as http:
                tasks = [asyncio.ensure_future(one(i, http))
                         for i in range(TP2_SLOTS)]
                await asyncio.wait_for(asyncio.gather(
                    *(e.wait() for e in started)), 120)
                killed = time.time()
                os.killpg(cluster.procs[1][0].pid, _signal.SIGKILL)
                await asyncio.wait_for(asyncio.gather(*tasks), 120)
            return {"frames": frames, "killed": killed}

        c = asyncio.run(part_c())
        leader = cluster.wait(0, 60)
        killed = c["killed"]
        errors = [[f for f in fr if f["type"] == "error"]
                  for fr in c["frames"]]
        done = [f for fr in c["frames"] for f in fr
                if f["type"] == "response_complete"]
        first_error = [e[0]["at"] - killed for e in errors if e]
        out["c"] = {
            "error_frames": [len(e) for e in errors],
            "kill_to_error_ms": [1e3 * x for x in first_error],
            "kill_to_cluster_dead_ms": (
                1e3 * (leader["cluster_dead_at"] - killed)
                if leader["cluster_dead_at"] else None),
            "kill_to_exit_ms": 1e3 * (leader["exited_at"] - killed),
            "dead_reason": leader["dead_reason"],
            "error_codes": sorted({e[0].get("code", "") for e in errors
                                   if e})}
        log(f"phase 15c (follower killed mid-decode): {out['c']}")
        if any(len(e) != 1 for e in errors) or done:
            fail(f"phase 15c: every in-flight session must get one error "
                 f"frame: {[len(e) for e in errors]}, {len(done)} completed")
        if leader["dead_reason"] is None \
                or out["c"]["kill_to_cluster_dead_ms"] is None \
                or out["c"]["kill_to_cluster_dead_ms"] > 2 * 2000 + 2000:
            fail(f"phase 15c: the leader did not see the cluster dead "
                 f"within 2 heartbeat intervals: {out['c']}")
        if out["c"]["kill_to_exit_ms"] > 30000:
            fail(f"phase 15c: the gateway took {out['c']['kill_to_exit_ms']}"
                 " ms to shut down")
        out["a_collectives"] = leader["collectives"]
        out["a_process"] = leader["process"]
    finally:
        cluster.close()

    # ---------------- (a) tinychat tp = 2, (b) tinychat sp = 2 ----------
    def tiny_cluster(label, mesh_env, prompts, single, max_len) -> dict:
        cl = Cluster(label, {
            "LLM_MODEL": "tinychat", "MODEL_PATH": ASSETS,
            "WEIGHT_QUANT": "int8", "TPU_DECODE_SLOTS": "4",
            "TPU_MAX_MODEL_LEN": str(max_len),
            "DEFAULT_CONTEXT_WINDOW": str(max_len), "TPU_SPEC_DECODE": "off",
            "PHASE15_PROMPTS": json.dumps(prompts), **mesh_env}, "engine")
        try:
            res = cl.wait(0, 300)
            cl.wait(1, 60)
        finally:
            cl.close()
        log(f"phase {label}: greedy {res['texts']}; stats {res['stats']}; "
            f"launches: leader {res['launches']}, follower "
            f"{res['follower_launches']}")
        if res["texts"] != single:
            fail(f"phase {label}: the greedy texts part from the single-rank "
                 f"engine's: {res['texts']} against {single}")
        return res

    a_tiny = tiny_cluster("15a tinychat tp=2", {"TPU_TP_SIZE": "2"},
                          PHASE15_TINY_PROMPTS, tiny_single["a"], 512)
    b_tiny = tiny_cluster("15b tinychat sp=2", {"TPU_SP_SIZE": "2"},
                          [PHASE15_LONG, PHASE15_TINY_PROMPTS[0]],
                          tiny_single["b"], 1536)
    if b_tiny["stats"]["ring_prefill_calls"] < 1:
        fail("phase 15b: the long fresh prompt took no ring prefill")
    for label, res in (("15a tinychat", a_tiny), ("15b", b_tiny)):
        if res["launches"]["int8_matmul"] <= 0 \
                or res["launches"]["int8_matmul_t"] <= 0:
            fail(f"phase {label}: the int8 kernels did not launch: "
                 f"{res['launches']}")
    if a_tiny["launches"]["decode_attend"] <= 0:
        fail("phase 15a tinychat: decode_attend did not launch")
    for label, res in (("15a tinychat", a_tiny), ("15b", b_tiny)):
        for name in ("int8_matmul", "int8_matmul_t"):
            if res["follower_launches"][name] != res["launches"][name]:
                fail(f"phase {label}: the follower launched {name} "
                     f"{res['follower_launches'][name]} times, the leader "
                     f"{res['launches'][name]}")
    out["a_tinychat"] = {"texts": a_tiny["texts"],
                         "launches": a_tiny["launches"],
                         "follower_launches": a_tiny["follower_launches"]}
    out["b"] = {"texts": b_tiny["texts"], "stats": b_tiny["stats"],
                "launches": b_tiny["launches"],
                "follower_launches": b_tiny["follower_launches"]}
    out["seconds"] = time.monotonic() - t15
    log(f"phase 15 ran {out['seconds']:.6g} s")
    return out


def tinychat_single_texts(device: str = "cuda") -> dict:
    """The single-rank port engine's greedy tinychat int8 texts that phase
    15 holds its clusters to: (a) the short prompts at max_len 512, (b) the
    long prompt and one short one at max_len 1536."""
    from fasttalk_tpu_torch.engine.engine import GenerationParams
    from fasttalk_tpu_torch.engine.factory import build_engine
    from fasttalk_tpu_torch.utils.config import Config

    out = {}
    for key, prompts, max_len in (
            ("a", PHASE15_TINY_PROMPTS, 512),
            ("b", [PHASE15_LONG, PHASE15_TINY_PROMPTS[0]], 1536)):
        engine = build_engine(Config(
            model_name="tinychat", model_path=ASSETS, weight_quant="int8",
            decode_slots=4, max_model_len=max_len,
            default_context_window=max_len, spec_decode="off"),
            device=device)
        engine.start()
        try:
            async def run():
                texts = []
                for i, text in enumerate(prompts):
                    got = ""
                    async for ev in engine.generate(
                            f"s{i}", f"s{i}",
                            [{"role": "user", "content": text}],
                            GenerationParams(max_tokens=48, temperature=0.0,
                                             top_k=0, top_p=1.0)):
                        if ev["type"] == "token":
                            got += ev["text"]
                        elif ev["type"] == "error":
                            fail(f"phase 15 single-rank tinychat: {ev}")
                    texts.append(got)
                return texts
            out[key] = asyncio.run(asyncio.wait_for(run(), 300))
        finally:
            engine.shutdown()
        del engine
    log(f"phase 15 single-rank tinychat greedy texts: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "fasttalk_tpu_torch")):
        print("chip_smoke: fasttalk_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # Flight bundles and profiler traces stay inside the checkout.
    os.environ.setdefault("FLIGHT_DIR", os.path.join(REPO, "build", "flight"))
    os.environ.setdefault("PROFILER_TRACE_DIR",
                          os.path.join(REPO, "build", "profiler_trace"))
    os.environ.setdefault("FLEET_FLIGHT_DIR",
                          os.path.join(REPO, "build", "fleet_flight"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    from fasttalk_tpu_torch.ops import _build
    from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                       decode_attend_paged)
    from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul
    from fasttalk_tpu_torch.ops.cuda_int8 import int8_matmul, int8_matmul_t

    t0 = time.monotonic()
    libs = _build.build()
    log(f"built {sorted(libs)} in {time.monotonic() - t0:.3f} s")

    results: dict = {}
    check_int8_matmul(results)
    check_int8_matmul_t(results)
    check_int4_matmul(results)
    for seed, (name, paged, int8) in enumerate((
            ("decode_attend", False, False),
            ("decode_attend[int8]", False, True),
            ("decode_attend_paged", True, False),
            ("decode_attend_paged[int8]", True, True))):
        check_attend(results, name, paged=paged, int8=int8, seed=3 + seed)
        torch.cuda.empty_cache()
    check_full_width_model("int8", ("dense bf16", "paged int8"))
    torch.cuda.empty_cache()
    check_full_width_model("int4", ("dense bf16",))
    torch.cuda.empty_cache()
    # Phase 4: greedy tinychat, speculative against plain on dense bf16,
    # paged bf16 and int4 weights; the int8 KV tier decodes plain (spec
    # with int8 KV is refused, as in the JAX package).
    check_tinychat_spec()
    check_tinychat_spec(kv_layout="paged")
    check_tinychat_spec(weight_quant="int4")
    check_tinychat(kv_layout="paged", kv_quant="int8", spec_decode="off")
    # Phase 4, structured: a response_format answer, jump-forward on and off.
    check_tinychat_structured()
    # Phase 4, multi-turn: turn 2 after a radix hit and after a park and
    # restore equals the never-evicted turn 2.
    check_tinychat_multiturn(kv_layout="paged")
    check_tinychat_multiturn(kv_layout="paged", kv_quant="int8")
    check_tinychat_multiturn()

    # Launch counters of every kernel and attention tier: (wrapper, the
    # count of this tier's launches).
    counters = {
        "int8_matmul": lambda: int8_matmul.launches,
        "int8_matmul_t": lambda: int8_matmul_t.launches,
        "int4_matmul": lambda: int4_matmul.launches,
        "decode_attend": lambda: (decode_attend.launches
                                  - decode_attend.launches_int8),
        "decode_attend[int8]": lambda: decode_attend.launches_int8,
        "decode_attend_paged": lambda: (decode_attend_paged.launches
                                        - decode_attend_paged.launches_int8),
        "decode_attend_paged[int8]": lambda: decode_attend_paged.launches_int8,
    }

    def served_phase(label: str, attend: str, sessions: int, max_tokens: int,
                     weight_quant: str = "int8", temperature: float = 0.7,
                     batched: bool = False, multi: str | None = None,
                     timed: bool = False, **kw) -> dict:
        """Serve one weight and KV tier; the counts are zeroed just before
        the sessions and read just after. Every kernel of the path (the
        tier's layer matmul, the lm_head and the tier's attention) must have
        launched, and the other tier's layer matmul no time. ``batched``:
        the burst must have run a batched prefill call; ``multi``: that
        attention tier must have launched at T = 8 (the verify block) and
        drafts must have been accepted; ``timed``: also time one verify step
        against one plain step on the card (``time_verify_step``)."""
        async def measured(engine, port: int) -> dict:
            for fn in (int8_matmul, int8_matmul_t, int4_matmul, decode_attend,
                       decode_attend_paged):
                fn.launches = 0
                fn.launches_multi = 0
            decode_attend.launches_int8 = 0
            decode_attend_paged.launches_int8 = 0
            before = engine.get_stats()
            out = await drive_sessions(port, sessions, max_tokens,
                                       temperature)
            out["launches"] = {k: c() for k, c in counters.items()}
            out["launches_multi"] = {
                "decode_attend": decode_attend.launches_multi,
                "decode_attend_paged": decode_attend_paged.launches_multi}
            out["engine"] = after = engine.get_stats()
            out["delta"] = stat_delta(before, after)
            if timed:
                out["step_ms"] = time_verify_step(engine)
            return out

        served = serve_main_path(measured, weight_quant=weight_quant, **kw)
        served["tok_s"] = served["tokens"] / served["wall_s"]
        d = served["delta"]
        log(f"{label}: served {served['sessions']} concurrent WS sessions: "
            f"{served['tokens']} tokens in {served['wall_s']:.6g} s "
            f"({served['tok_s']:.6g} decode tok/s), error frames: "
            f"{len(served['errors'])}")
        ttft = served["ttft_ms"]
        served["ttft_p50_ms"] = pct(ttft, 50)
        served["ttft_p99_ms"] = pct(ttft, 99)
        log(f"  TTFT p50 {served['ttft_p50_ms']} ms, p99 "
            f"{served['ttft_p99_ms']} ms over {len(ttft)} done frames; "
            f"batched prefill calls {d['batched_prefill_calls']} "
            f"({d['batched_prefill_rows']} rows), shared-prefix tokens "
            f"{d['prefix_tokens_shared']}; decode calls {d['decode_calls']} "
            f"({d['spec_calls']} speculative, {d['plain_calls']} plain)")
        if d["spec_calls"]:
            log(f"  speculative: {d['verify_blocks']} verify blocks, "
                f"{d['tokens_per_verify']:.6g} tokens a block, accepted "
                f"{d['accepted']} of {d['drafted']} drafts; host ms a call: "
                f"speculative {d['spec_host_ms_per_call']:.6g}, plain "
                f"{d['plain_host_ms_per_call']}")
        blocks = served["engine"].get("kv_blocks")
        if blocks:
            log(f"  kv_blocks after the sessions: in use {blocks['in_use']} "
                f"of {blocks['total']}")
        if served["errors"]:
            fail(f"{label}: error frames: {served['errors'][:3]}")
        if served["tokens"] <= 0:
            fail(f"{label}: no tokens served")
        log(f"  launches on the served path: {served['launches']}")
        layer_mm, other_mm = (("int4_matmul", "int8_matmul")
                              if weight_quant == "int4"
                              else ("int8_matmul", "int4_matmul"))
        for name in (layer_mm, "int8_matmul_t", attend):
            if served["launches"][name] <= 0:
                fail(f"{label}: kernel {name} never launched on the "
                     "served path")
        if served["launches"][other_mm] != 0:
            fail(f"{label}: {other_mm} launched "
                 f"{served['launches'][other_mm]} times on the "
                 f"{weight_quant} path")
        if batched and d["batched_prefill_calls"] <= 0:
            fail(f"{label}: the burst ran no batched prefill call")
        if multi is not None:
            log(f"  T={VERIFY_T} launches: {served['launches_multi']}")
            if served["launches_multi"][multi] <= 0:
                fail(f"{label}: {multi} never launched at T={VERIFY_T}")
            if d["accepted"] <= 0:
                fail(f"{label}: no draft was accepted")
        if timed:
            log(f"  device ms a step (CUDA graph): {served['step_ms']}")
        return served

    # Phases 5 and 8 serve the JAX engine's defaults (TPU_SPEC_DECODE=auto,
    # TPU_SHARED_PREFIX on, batched prefill); the int8 KV tiers (6, 7a)
    # decode plain, as the JAX package requires.
    served = served_phase("phase 5 (dense bf16 KV)", "decode_attend",
                          SLOTS, 64, batched=True)
    paged = served_phase(
        "phase 6 (paged int8 KV, 2048 blocks of 16)",
        "decode_attend_paged[int8]", SLOTS, 64, max_len=8192,
        kv_layout="paged", kv_quant="int8", kv_block_size=BLOCK,
        kv_pool_blocks=2048, spec_decode="off")
    dense8 = served_phase("phase 7a (dense int8 KV)", "decode_attend[int8]",
                          SLOTS, 16, kv_quant="int8", spec_decode="off")
    paged16 = served_phase("phase 7b (paged bf16 KV)", "decode_attend_paged",
                           SLOTS, 16, kv_layout="paged",
                           kv_block_size=BLOCK)
    int4 = served_phase("phase 8 (WEIGHT_QUANT=int4, dense bf16 KV)",
                        "decode_attend", SLOTS, 64, weight_quant="int4",
                        batched=True)
    # Phase 9: speculative decoding at full width, greedy, every call a
    # verify block (ngram); the same sessions plain for the comparison.
    spec9 = served_phase("phase 9a (TPU_SPEC_DECODE=ngram, greedy, dense "
                         "bf16 KV)", "decode_attend", SLOTS, 64,
                         temperature=0.0, multi="decode_attend", timed=True,
                         spec_decode="ngram")
    plain9 = served_phase("phase 9b (TPU_SPEC_DECODE=off, greedy, dense "
                          "bf16 KV)", "decode_attend", SLOTS, 64,
                          temperature=0.0, spec_decode="off")
    spec9p = served_phase("phase 9c (TPU_SPEC_DECODE=ngram, greedy, paged "
                          "bf16 KV)", "decode_attend_paged", SLOTS, 16,
                          temperature=0.0, multi="decode_attend_paged",
                          spec_decode="ngram", kv_layout="paged",
                          kv_block_size=BLOCK)

    def structured_phase(label: str, attend: str, constrained: int,
                         timed: bool = False, **kw) -> dict:
        """Phase 10: serve a burst of constrained /v1 completions, a forced
        tool call, a structured WebSocket session and 8 plain /v1 streams
        beside them, twice: cold (the schemas compile during the burst)
        and warm (compiled). Counts are zeroed just before the bursts and
        read just after: the layer matmul, the lm_head and ``attend`` must
        have launched. Every constrained answer must meet its schema, every
        plain stream give 64 tokens, no request fail; the engine must have
        made constrained decode calls, emitted jump-forward tokens and no
        speculative call while a constrained slot ran."""
        from fasttalk_tpu_torch.utils.metrics import get_metrics

        async def measured(engine, port: int) -> dict:
            for fn in (int8_matmul, int8_matmul_t, int4_matmul, decode_attend,
                       decode_attend_paged):
                fn.launches = 0
                fn.launches_multi = 0
            decode_attend.launches_int8 = 0
            decode_attend_paged.launches_int8 = 0
            compile_ms = get_metrics().histogram("fsm_compile_ms")
            compile_ms.clear()
            before = engine.get_stats()
            out = {"bursts": [await drive_structured(engine, port,
                                                     constrained)
                              for _ in ("cold", "warm")]}
            out["launches"] = {k: c() for k, c in counters.items()}
            out["engine"] = after = engine.get_stats()
            out["delta"] = stat_delta(before, after)
            out["compile_ms"] = compile_ms.summary()
            out["st"] = {k: after["structured"][k] - before["structured"][k]
                         for k in ("calls", "steps", "host_s",
                                   "jump_forward_tokens")}
            out["spec_constrained_calls"] = (
                after["spec"]["constrained_calls"]
                - before["spec"]["constrained_calls"])
            if timed:
                out["step_ms"] = time_constrained_step(engine)
            return out

        out = serve_main_path(measured, **kw)
        out["kinds"] = {}
        for name, burst in zip(("cold", "warm"), out["bursts"]):
            kinds = out["kinds"][name] = check_structured_burst(
                f"{label}, {name} burst", burst, 64)
            log(f"{label}, {name} burst: "
                f"{sum(k['requests'] for k in kinds.values())} requests in "
                f"{burst['wall_s']:.6g} s, 0 errors; by kind: " + "; ".join(
                    f"{kind} x{k['requests']}: {k['tokens']} tokens, "
                    f"{k['tok_s']:.6g} decode tok/s, TTFT p50 "
                    f"{k['ttft_p50_ms']:.6g} / p99 {k['ttft_p99_ms']:.6g} ms"
                    for kind, k in sorted(kinds.items())))
        d, st = out["delta"], out["st"]
        plain_steps_ = d["decode_steps"] - d["spec_steps"] - st["steps"]
        plain_host = d["decode_host_s"] - d["spec_host_s"] - st["host_s"]
        out["host_ms_step"] = {
            "constrained": (1e3 * st["host_s"] / st["steps"]
                            if st["steps"] else None),
            "plain": 1e3 * plain_host / plain_steps_ if plain_steps_ else None}
        log(f"  FSM compile ms (this burst's misses): {out['compile_ms']}; "
            f"arena: {out['engine']['structured'].get('arena')}")
        log(f"  decode calls {d['decode_calls']} ({st['calls']} constrained, "
            f"{d['spec_calls']} speculative), jump-forward tokens "
            f"{st['jump_forward_tokens']}, speculative calls with a "
            f"constrained slot {out['spec_constrained_calls']}; host ms a "
            f"step: constrained {out['host_ms_step']['constrained']}, plain "
            f"{out['host_ms_step']['plain']}")
        log(f"  launches on the served path: {out['launches']}")
        if st["calls"] <= 0:
            fail(f"{label}: no constrained decode call")
        if st["jump_forward_tokens"] <= 0:
            fail(f"{label}: jump-forward emitted no token")
        if out["spec_constrained_calls"] != 0:
            fail(f"{label}: {out['spec_constrained_calls']} speculative "
                 "calls ran beside a constrained slot")
        for name in ("int8_matmul", "int8_matmul_t", attend):
            if out["launches"][name] <= 0:
                fail(f"{label}: kernel {name} never launched in the burst")
        if timed:
            log(f"  device ms a step (CUDA graph): {out['step_ms']}")
        return out

    # Phase 10: structured output and client tool calls on /v1 and the
    # WebSocket, at the main path's configuration (TPU_SPEC_DECODE=auto,
    # STRUCTURED_MODE=auto), then on phase 6's paged int8 pool.
    st10 = structured_phase("phase 10a (structured, dense bf16 KV)",
                            "decode_attend", 6, timed=True)
    st10p = structured_phase(
        "phase 10b (structured, paged int8 KV, 2048 blocks of 16)",
        "decode_attend_paged[int8]", 4, max_len=8192, kv_layout="paged",
        kv_quant="int8", kv_block_size=BLOCK, kv_pool_blocks=2048,
        spec_decode="off")
    p11 = phase11(counters)
    launches_11 = p11["launches"]
    p12 = phase12(counters)
    p13 = phase13(counters)
    p14 = phase14(counters, served)
    check_shard_kernels(results)
    p15 = phase15(counters, served, tinychat_single_texts())

    launches_st = {"int8_matmul": st10["launches"]["int8_matmul"],
                   "int8_matmul_t": st10["launches"]["int8_matmul_t"],
                   "decode_attend": st10["launches"]["decode_attend"],
                   "decode_attend_paged[int8]":
                       st10p["launches"]["decode_attend_paged[int8]"]}
    launches = {"int8_matmul": served["launches"]["int8_matmul"],
                "int8_matmul_t": served["launches"]["int8_matmul_t"],
                "int4_matmul": int4["launches"]["int4_matmul"],
                "decode_attend": served["launches"]["decode_attend"],
                "decode_attend[int8]":
                    dense8["launches"]["decode_attend[int8]"],
                "decode_attend_paged":
                    paged16["launches"]["decode_attend_paged"],
                "decode_attend_paged[int8]":
                    paged["launches"]["decode_attend_paged[int8]"]}
    # Phase 9's verify-block launches of the two bf16 attention tiers.
    launches_t8 = {
        "decode_attend": spec9["launches_multi"]["decode_attend"],
        "decode_attend_paged": spec9p["launches_multi"]["decode_attend_paged"]}
    attention_src = "fasttalk_tpu_torch/csrc/decode_attention.cu"
    sources = {"int8_matmul": ("fasttalk_tpu_torch/csrc/int8_matmul.cu",
                               "fasttalk_tpu/ops/pallas_int8.py:89"),
               "int8_matmul_t": ("fasttalk_tpu_torch/csrc/int8_matmul.cu",
                                 "fasttalk_tpu/ops/pallas_int8.py:127"),
               "int4_matmul": ("fasttalk_tpu_torch/csrc/int4_matmul.cu",
                               "fasttalk_tpu/ops/pallas_int8.py:242"),
               "decode_attend": (attention_src,
                                 "fasttalk_tpu/ops/pallas_attention.py:153"),
               "decode_attend[int8]": (
                   attention_src, "fasttalk_tpu/ops/pallas_attention.py:153"),
               "decode_attend_paged": (
                   attention_src, "fasttalk_tpu/ops/pallas_attention.py:249"),
               "decode_attend_paged[int8]": (
                   attention_src, "fasttalk_tpu/ops/pallas_attention.py:249")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **{k: r[k] for k in ("ms_m1", "library_ms_m1", "ms_t4",
                                 "ms_m128", "library_ms_m128",
                                 "bound_ms_m128", "ms_t8", "library_ms_t8",
                                 "bound_ms_t8")
               if k in r},
            **({"launches_t8": launches_t8[name]}
               if name in launches_t8 else {}),
            **({"launches_structured": launches_st[name]}
               if name in launches_st else {}),
            "launches_phase11": launches_11[name],
            **({"launches_phase13": {
                part: p13[f"launches_{part}"][name]
                for part in ("warmup", "first_wave", "after_restart")}}
               if name in ("int8_matmul", "int8_matmul_t", "decode_attend")
               else {}),
            "launches_phase14": {
                part: p14[f"{part}_launches"][name]
                for part in ("a", "b", "c", "d", "e")},
            **({"launches_phase15": {
                "a_leader": p15["a_launches"]["leader"][name],
                "a_follower": p15["a_launches"]["follower"][name],
                "a_tinychat_leader": p15["a_tinychat"]["launches"][name],
                "a_tinychat_follower":
                    p15["a_tinychat"]["follower_launches"][name],
                "b_leader": p15["b"]["launches"][name],
                "b_follower": p15["b"]["follower_launches"][name]},
                "tp2": r["tp2"]}
               if name in ("int8_matmul", "int8_matmul_t", "decode_attend")
               else {}),
            "work": r["work"], "card": card})
    result = json.dumps({"kernels": kernels, "served": {
        label: {"sessions": x["sessions"], "tokens": x["tokens"],
                "wall_s": x["wall_s"], "decode_tok_s": x["tok_s"],
                "ttft_p50_ms": x["ttft_p50_ms"],
                "ttft_p99_ms": x["ttft_p99_ms"], **x["delta"],
                **({"step_ms": x["step_ms"]} if "step_ms" in x else {})}
        for label, x in (("dense_bf16", served), ("paged_int8", paged),
                         ("dense_int8", dense8), ("paged_bf16", paged16),
                         ("int4_dense_bf16", int4),
                         ("spec_ngram_dense_bf16", spec9),
                         ("spec_off_dense_bf16", plain9),
                         ("spec_ngram_paged_bf16", spec9p))},
        "structured": {
            label: {"wall_s": [b["wall_s"] for b in x["bursts"]], "kinds": {
                burst: {k: {f: v[f] for f in ("requests", "tokens", "tok_s",
                                              "ttft_p50_ms", "ttft_p99_ms")}
                        for k, v in kinds.items()}
                for burst, kinds in x["kinds"].items()},
                "host_ms_step": x["host_ms_step"],
                "compile_ms": x["compile_ms"], **x["st"],
                "arena": x["engine"]["structured"].get("arena"),
                **({"step_ms": x["step_ms"]} if "step_ms" in x else {})}
            for label, x in (("dense_bf16", st10),
                             ("paged_int8", st10p))},
        "kv_hierarchy": {
            label: {"ttft_ms": x["ttft"], "wall_s": x["wall_s"],
                    "tokens": x["tokens"],
                    "peak_aliased": x["peak"]["aliased"],
                    "kv_radix": x["stats"].get("kv_radix"),
                    "kv_blocks": {k: v for k, v in
                                  x["stats"].get("kv_blocks", {}).items()
                                  if k != "tables"},
                    "kv_host": x["stats"]["kv_host"],
                    "restore": x.get("restore"),
                    "prefill_delta_wave_a": {
                        f"turn {t}": deltas(x, t)
                        for t in range(2, x["turns"] + 1)}}
            for label, x in p11.items() if label != "launches"},
        "observability": {**p12, "card": card},
        "lifecycle": {**{k: v for k, v in p13.items()
                         if not k.startswith("launches_")}, "card": card},
        "fleet": {**{k: v for k, v in p14.items()
                     if not k.endswith("_launches")
                     and not k.startswith("c_control")}, "card": card},
        "multi_rank": {**{k: v for k, v in p15.items()
                          if k != "memory_start"}, "card": card}})
    # The line runs past the tail a remote runner keeps: a copy to a file.
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w",
              encoding="utf-8") as fp:
        fp.write(result + "\n")
    print(result, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--nccl-probe":
        sys.exit(nccl_probe_main(sys.argv[2]))
    if len(sys.argv) == 4 and sys.argv[1] == "--rank":
        sys.exit(rank_main(sys.argv[2], sys.argv[3]))
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
