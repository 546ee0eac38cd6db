"""Performance attribution ledger: where engine wall time actually went.

The port's rewrite of ``fasttalk_tpu/observability/perf.py``: the same
``program_key``, the same ``report`` and ``summary`` shapes, the same
``perf_*`` gauges, over step records whose intervals come from CUDA
events (``DeviceClock``) instead of the host clock.

- **Wall-time decomposition.** The step ring's records are intervals
  on the engine clock (``time.monotonic``). On the card each interval
  is the call's *device span*: a CUDA event recorded before its first
  launch and one after its last launch, placed on the host clock
  through one anchor event (``DeviceClock``). A decode call is ~1,400
  eager launches, so its span includes the idle gaps between them on
  the device: an upper bound on its kernel time, never a host
  dispatch-to-retirement interval (on a host-bound engine that would
  read close to 100% busy). On the CPU the work runs inside the call,
  so the host clock around it is the span. The union of the spans is
  *device-busy* time; the gaps between them split into *host gap*
  (short — dispatch overhead, host-side token handling, admission work
  between calls) and *idle* (long — no work to run), by the
  ``PERF_IDLE_GAP_MS`` threshold (default 250). busy + host_gap + idle
  == the report window, exactly.
- **Padding waste.** Decode calls advance all S slots whether active or
  not (and speculative verify blocks compute draft+1 positions of which
  only the accepted prefix is kept), and prefill pads prompts up to
  power-of-two buckets. Every record carries the token rows it computed
  and the tokens that were actually useful; the waste fraction is
  1 - useful/computed.
- **Occupancy-weighted useful-token throughput.** Useful tokens per
  wall second and per device-busy second, next to the duration-
  weighted mean batch occupancy — the number that says whether low
  tok/s is an empty batch or a slow step.
- **MFU and HBM bandwidth.** Records carry a per-call FLOP estimate
  from the bound model config (2·params per token plus the attention
  term at the call's KV horizon) and the KV and weight bytes the call
  read at their resident element sizes. Achieved rates over the window
  are set against the card's peak, read from
  ``torch.cuda.get_device_name`` (``PEAK_TFLOPS_BF16``,
  ``PEAK_HBM_GBPS``; ``PERF_PEAK_TFLOPS`` and ``PERF_PEAK_HBM_GBPS``
  override). Any other device reports ``null``, never a made-up figure.
- **Compile ledger.** Kept for the report's shape: the port runs eager
  PyTorch and compiles nothing while serving, so it stays empty unless
  a caller notes a compile.

Exposed as ``GET /perf`` on the monitoring port and ``perf_*``
Prometheus gauges (refreshed at scrape time).

Same design constraints as the tracer: cheap (reads the existing ring),
thread-safe, clearable in place for tests, fake-clock drivable
(``report(now=...)``).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any

import torch

from fasttalk_tpu_torch.observability.events import env_float
from fasttalk_tpu_torch.utils.metrics import get_metrics

DEFAULT_WINDOW_S = 60.0
DEFAULT_IDLE_GAP_MS = 250.0

# Peak dense bf16 TFLOP/s and HBM GB/s of one card by device-name
# substring (NVIDIA's data sheets), the longer name first: the H100
# PCIe part before the H100 SXM part (HBM3). Any other device reports
# null rather than a made-up number.
PEAK_TFLOPS_BF16 = (
    ("h100 pcie", 756.0),
    ("h100", 989.0),
)
PEAK_HBM_GBPS = (
    ("h100 pcie", 2000.0),
    ("h100", 3350.0),
)

# Step-ring record names this ledger aggregates (engine/engine.py):
# decode calls, prefill calls, and auxiliary device work (park/restore
# slices, block copies, structured sample-and-place) — the _OP records
# carry no token statistics, only device-busy intervals and a program
# key.
_STEP = "engine_step"
_PREFILL = "engine_prefill"
_OP = "engine_op"

# Host-gap cause taxonomy — mirrors profiler.CAUSE_NAMES (kept literal
# here so the ledger stays importable without the profiler module).
GAP_CAUSES = ("detok", "ws_send", "scheduler", "radix", "gc", "other")


def program_key(kind: str, **attrs: Any) -> str:
    """The canonical program key (JAX ``perf.program_key``): the kind
    and its sorted attributes, so a step record's ``program`` attr names
    the same call shape in both packages."""
    return kind + "".join(f" {k}={attrs[k]}" for k in sorted(attrs))


def _detect_peak(table, device: torch.device | None) -> tuple[float, str]:
    """(the card's peak from ``table``, device name). 0.0 for a device
    the table does not name (the CPU, another card) — the figure then
    reports null."""
    if device is None:
        return 0.0, "unknown"
    if device.type != "cuda":
        return 0.0, device.type
    name = torch.cuda.get_device_name(device)
    low = name.lower()
    for key, peak in table:
        if key in low:
            return peak, name
    return 0.0, name


def detect_peak_tflops(device: torch.device | None) -> tuple[float, str]:
    """(peak bf16 TFLOP/s of the card, device name)."""
    return _detect_peak(PEAK_TFLOPS_BF16, device)


def detect_peak_hbm_gbps(device: torch.device | None) -> tuple[float, str]:
    """(peak HBM GB/s of the card, device name)."""
    return _detect_peak(PEAK_HBM_GBPS, device)


class DeviceClock:
    """Device spans on the host's ``time.monotonic`` clock.

    On the card a mark is a CUDA timing event recorded on the engine
    thread's stream, and a span is the pair of marks around a call's
    launches. One anchor per engine ties the two clocks together: the
    stream is drained once (the only synchronize), an event recorded
    and the host clock read beside it; a later event's time is
    ``anchor_t + anchor.elapsed_time(ev) / 1e3``. A pair is read only
    once the stream has passed it (``done``, or after a host copy
    recorded later has been waited for), so reading never blocks.
    ``maybe_reanchor`` takes the anchor again while the engine is idle,
    at most every ``reanchor_s``, so that drift between the clocks
    stays far below a millisecond. On the CPU the work runs inside the
    call, and a mark is the host clock."""

    def __init__(self, device: torch.device, reanchor_s: float = 10.0):
        self.cuda = device.type == "cuda"
        self.device = device
        self.reanchor_s = reanchor_s
        self._anchor: Any = None
        self._anchor_t = 0.0

    def anchor(self) -> None:
        if not self.cuda:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        t0 = time.monotonic()
        ev.record(stream)
        t1 = time.monotonic()
        ev.synchronize()
        self._anchor, self._anchor_t = ev, 0.5 * (t0 + t1)

    def maybe_reanchor(self, now: float) -> None:
        """Anchor again (engine idle: nothing of it in flight)."""
        if self.cuda and now - self._anchor_t >= self.reanchor_s:
            self.anchor()

    def mark(self) -> Any:
        if not self.cuda:
            return time.monotonic()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def done(mark: Any) -> bool:
        return isinstance(mark, float) or mark.query()

    def to_monotonic(self, mark: Any) -> float:
        if isinstance(mark, float):
            return mark
        return self._anchor_t + self._anchor.elapsed_time(mark) / 1e3


class PerfLedger:
    """Rolling attribution report over the tracer's step ring."""

    def __init__(self, *, tracer: Any = None,
                 window_s: float | None = None,
                 idle_gap_ms: float | None = None,
                 peak_tflops: float | None = None,
                 profiler: Any = None,
                 clock=time.monotonic):
        self.window_s = window_s if window_s is not None \
            else max(1.0, env_float("PERF_WINDOW_S", DEFAULT_WINDOW_S))
        self.idle_gap_ms = idle_gap_ms if idle_gap_ms is not None \
            else max(0.0, env_float("PERF_IDLE_GAP_MS",
                                    DEFAULT_IDLE_GAP_MS))
        # 0 = detect from the bound device lazily (first report).
        self._peak_override = peak_tflops if peak_tflops is not None \
            else env_float("PERF_PEAK_TFLOPS", 0.0)
        self._peak: tuple[float, str] | None = None
        self._hbm_override = env_float("PERF_PEAK_HBM_GBPS", 0.0)
        self._hbm_detected: tuple[float, str] | None = None
        self._device: torch.device | None = None
        self._tracer = tracer
        # The continuous stack sampler (observability/profiler.py):
        # supplies engine-thread cause observations and GC pause
        # intervals for the host-gap decomposition. Injectable in
        # tests; None = the process singleton, resolved lazily.
        self._profiler = profiler
        self._clock = clock
        self._lock = threading.Lock()
        # Model cost estimate (bind_model): FLOPs/token = _flops_base +
        # _flops_per_ctx * kv_len.
        self._model_name = ""
        self._num_slots = 0
        self._dtype = ""
        self._params = 0
        self._flops_base = 0.0
        self._flops_per_ctx = 0.0
        # KV-cache byte facts from the engine (bind_model): the honest
        # per-(slot, position)-row read cost across all layers — int8
        # rows + scales under KV_QUANT=int8, bf16 otherwise. The
        # FLOP/byte side of the attribution never assumes an element
        # size again.
        self._kv_quant = "none"
        self._kv_row_bytes = 0
        # Weight-byte facts (bind_model): what one decode step streams
        # of the RESIDENT weights — bf16, int8+scales, or nibble-packed
        # int4+scales (WEIGHT_QUANT). The bandwidth and FLOP/byte
        # figures read this instead of assuming params x 2 bytes.
        self._weight_quant = "off"
        self._weight_bytes_per_step = 0
        # Which decode attention path the engine routes steps through
        # (bind_model): attribution of the measured figures.
        self._attention_kernel = ""
        # Compile ledger: key -> {kind, count, serving, first/last ts}.
        self._compiles: dict[str, dict[str, Any]] = {}
        # Per-connection token-journey attribution (observability/
        # journey.py): the serving layer feeds each finished journeyed
        # connection's hop totals here, so GET /perf shows where
        # *connections* (not just the process window) spent their wall
        # time — the per-connection form of the host-gap decomposition.
        self._journey_hops: dict[str, float] = {}
        self._journey_frames = 0
        self._journey_conns = 0
        m = get_metrics()
        self._m_busy = m.gauge(
            "perf_device_busy_frac",
            "fraction of the attribution window covered by engine "
            "device calls (decode dispatch-to-retirement union)")
        self._m_gap = m.gauge(
            "perf_host_gap_frac",
            "fraction of the attribution window spent in short gaps "
            "between device calls (host dispatch/consume overhead)")
        self._m_idle = m.gauge(
            "perf_idle_frac",
            "fraction of the attribution window with no device call "
            "and no work (gaps above PERF_IDLE_GAP_MS)")
        self._m_waste = m.gauge(
            "perf_padding_waste_frac",
            "fraction of computed token rows discarded as padding "
            "(inactive decode slots, rejected draft positions, "
            "prefill bucket/group padding)")
        self._m_occ = m.gauge(
            "perf_occupancy",
            "duration-weighted mean batch occupancy of decode calls")
        self._m_tok_s = m.gauge(
            "perf_useful_tok_s",
            "useful tokens per wall second over the attribution window "
            "(decode tokens consumed + prompt tokens prefilled)")
        self._m_mfu = m.gauge(
            "perf_mfu",
            "achieved model FLOP utilisation vs the device peak "
            "(0 when the peak is unknown; see perf_peak_tflops)")
        self._m_peak = m.gauge(
            "perf_peak_tflops",
            "roofline peak used for perf_mfu (0 = unknown device kind "
            "and PERF_PEAK_TFLOPS unset)")
        self._m_kv_gbps = m.gauge(
            "perf_kv_read_gbps",
            "KV-cache bytes the decode calls' attention streamed per "
            "wall second (honest element size: int8+scales under "
            "KV_QUANT=int8)")
        self._m_kv_bw = m.gauge(
            "perf_kv_bw_util",
            "KV attention-read bandwidth vs the device HBM peak "
            "(0 when the peak is unknown; see PERF_PEAK_HBM_GBPS)")
        self._m_w_gbps = m.gauge(
            "perf_weight_read_gbps",
            "weight bytes the decode calls streamed per wall second, at "
            "the resident tier's size (bf16 / int8+scales / int4+scales "
            "under WEIGHT_QUANT)")
        self._m_hbm_bw = m.gauge(
            "perf_hbm_bw_util",
            "combined weight + KV read bandwidth vs the device HBM peak "
            "(0 when the peak is unknown)")
        self._m_compiles = m.counter(
            "perf_serving_compiles_total",
            "program compiles observed while serving traffic")
        self._m_prog_busy = m.labeled_gauge(
            "perf_program_busy_seconds",
            "device-busy seconds attributed to each device program "
            "over the attribution window (overlap split evenly; the "
            "family sums to device_busy_s)", label="program")
        self._m_prog_calls = m.labeled_gauge(
            "perf_program_calls",
            "device calls per device program over the attribution "
            "window", label="program")
        self._m_gap_cause_s = m.labeled_gauge(
            "perf_host_gap_cause_seconds",
            "host-gap seconds by sampled cause over the attribution "
            "window (gc from gc.callbacks pauses; the residual is "
            "'other', so the family sums to host_gap_s)",
            label="cause")
        self._m_gap_cause_frac = m.labeled_gauge(
            "perf_host_gap_cause_frac",
            "host-gap fraction of the attribution window by sampled "
            "cause (the family sums to host_gap_frac)", label="cause")

    # ---------------- wiring ----------------

    def _get_tracer(self):
        if self._tracer is None:
            from fasttalk_tpu_torch.observability.trace import get_tracer

            self._tracer = get_tracer()
        return self._tracer

    def _get_profiler(self):
        if self._profiler is None:
            from fasttalk_tpu_torch.observability.profiler import get_profiler

            self._profiler = get_profiler()
        return self._profiler

    def bind_model(self, model_cfg: Any, num_slots: int,
                   dtype: str = "", kv_quant: str = "none",
                   kv_row_bytes: int = 0, weight_quant: str = "off",
                   weight_bytes_per_step: int = 0,
                   attention_kernel: str = "",
                   device: torch.device | None = None) -> None:
        """Attach the served model's cost estimate (engine __init__).
        FLOPs/token = 2·params (every weight partakes in one multiply-
        accumulate) + 4·layers·q_dim·kv_len (QKᵀ and A·V per head).
        ``kv_row_bytes``: what one attention read of one (slot,
        position) row costs across all layers, at the cache's actual
        element size — int8 rows + scales under KV_QUANT=int8, never
        an assumed bf16. ``weight_bytes_per_step``: what one decode
        step streams of the resident weights, at THEIR actual size
        (WEIGHT_QUANT tier: bf16 / int8+scales / packed int4+scales).
        ``attention_kernel``: which decode attention kernel the engine
        routes steps through (``decode_attend`` or
        ``decode_attend_paged``) — pure attribution. ``device``: the
        engine's device, whose name selects the peaks."""
        with self._lock:
            self._model_name = getattr(model_cfg, "name", "")
            self._num_slots = num_slots
            self._dtype = dtype
            self._kv_quant = kv_quant
            self._kv_row_bytes = int(kv_row_bytes)
            self._weight_quant = weight_quant
            self._weight_bytes_per_step = int(weight_bytes_per_step)
            self._attention_kernel = attention_kernel
            if device != self._device:
                self._device = device
                self._peak = self._hbm_detected = None
            self._params = int(model_cfg.param_count())
            self._flops_base = 2.0 * self._params
            self._flops_per_ctx = 4.0 * model_cfg.num_layers \
                * model_cfg.q_dim

    def call_flops(self, tokens: int, ctx: int) -> float:
        """FLOP estimate for one device call that computed ``tokens``
        useful tokens against a KV horizon of ``ctx`` (0.0 unbound)."""
        return tokens * (self._flops_base + self._flops_per_ctx * ctx)

    def note_compile(self, kind: str, serving: bool = False,
                     **attrs: Any) -> None:
        """Count one program compile under its signature (the JAX
        ledger's compile table; the port's eager engine notes none)."""
        key = program_key(kind, **attrs)
        now = time.time()
        with self._lock:
            entry = self._compiles.get(key)
            if entry is None:
                entry = {"key": key, "kind": kind, "count": 0,
                         "serving": 0, "first_ts": now, "last_ts": now}
                self._compiles[key] = entry
            entry["count"] += 1
            entry["last_ts"] = now
            if serving:
                entry["serving"] += 1
        if serving:
            self._m_compiles.inc()

    def note_journey(self, hops_ms: dict[str, float],
                     frames: int) -> None:
        """Accumulate one finished connection's per-hop wall-time
        totals (serving/server.py, JOURNEY_ENABLED streams only)."""
        with self._lock:
            for name, ms in hops_ms.items():
                self._journey_hops[name] = \
                    self._journey_hops.get(name, 0.0) + float(ms)
            self._journey_frames += int(frames)
            self._journey_conns += 1

    # ---------------- the report ----------------

    def _peak_tflops(self) -> tuple[float, str]:
        if self._peak_override > 0:
            return self._peak_override, "PERF_PEAK_TFLOPS"
        if self._peak is None:
            self._peak = detect_peak_tflops(self._device)
        return self._peak

    def _peak_hbm(self) -> tuple[float, str]:
        if self._hbm_override > 0:
            return self._hbm_override, "PERF_PEAK_HBM_GBPS"
        if self._hbm_detected is None:
            self._hbm_detected = detect_peak_hbm_gbps(self._device)
        return self._hbm_detected

    def report(self, now: float | None = None) -> dict[str, Any]:
        """The ``GET /perf`` body. ``now`` is on the step records'
        clock (time.monotonic in production; fake in tests)."""
        tracer = self._get_tracer()
        now = self._clock() if now is None else now
        records = [r for r in tracer.steps()
                   if r.name in (_STEP, _PREFILL, _OP)]
        horizon = now - self.window_s
        records = [r for r in records if r.t1 > horizon]
        records.sort(key=lambda r: r.t0)
        peak, device = self._peak_tflops()
        with self._lock:
            compiles = [dict(e) for e in self._compiles.values()]
            journey = {
                "connections": self._journey_conns,
                "frames": self._journey_frames,
                "hops_ms": {h: round(v, 3) for h, v
                            in sorted(self._journey_hops.items())},
            }
        compiles.sort(key=lambda e: -e["last_ts"])
        out: dict[str, Any] = {
            "enabled": tracer.enabled,
            "window_s": self.window_s,
            "idle_gap_ms": self.idle_gap_ms,
            "n_decode_calls": sum(1 for r in records
                                  if r.name == _STEP),
            "n_prefill_calls": sum(1 for r in records
                                   if r.name == _PREFILL),
            "n_op_calls": sum(1 for r in records if r.name == _OP),
            "model": {"name": self._model_name, "params": self._params,
                      "slots": self._num_slots, "dtype": self._dtype,
                      "kv_quant": self._kv_quant,
                      "kv_row_bytes": self._kv_row_bytes,
                      "weight_quant": self._weight_quant,
                      "weight_bytes_per_step":
                          self._weight_bytes_per_step,
                      "attention_kernel": self._attention_kernel},
            "compiles": {
                "total": sum(e["count"] for e in compiles),
                "serving": sum(e["serving"] for e in compiles),
                "by_key": compiles,
            },
            "journey": journey,
        }
        peak_hbm, hbm_src = self._peak_hbm()
        if not records:
            out["wall"] = None
            out["programs"] = {"total_busy_s": 0.0, "by_program": []}
            out["host_gap_causes"] = None
            out["tokens"] = None
            out["mfu"] = {"peak_tflops": peak or None,
                          "device": device, "mfu": None}
            out["kv"] = {"bytes_read": 0, "read_gbps": 0.0,
                         "peak_hbm_gbps": peak_hbm or None,
                         "hbm_source": hbm_src, "bw_util": None}
            out["weights"] = {"bytes_read": 0, "read_gbps": 0.0,
                              "bw_util": None}
            out["hbm"] = {"bytes_read": 0, "read_gbps": 0.0,
                          "peak_hbm_gbps": peak_hbm or None,
                          "bw_util": None, "flop_per_byte": None}
            out["ceiling"] = {"hbm_bytes_per_token": None,
                              "ceiling_tok_s": None,
                              "measured_tok_s": None,
                              "frac_of_ceiling": None}
            return out

        # Wall-time decomposition: union the (clipped) call intervals,
        # then classify every gap by the idle threshold. The window
        # starts at the first visible record (or the horizon, whichever
        # is later) so a freshly started process is not reported as
        # mostly idle.
        start = max(horizon, records[0].t0)
        clipped: list[tuple[float, float, str]] = []
        for r in records:
            a, b = max(r.t0, start), min(r.t1, now)
            if b > a:
                clipped.append(
                    (a, b, str(r.attrs.get("program",
                                           "(unattributed)"))))
        merged: list[tuple[float, float]] = []
        for a, b, _ in clipped:
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))

        # Per-program attribution: a boundary sweep over the clipped
        # intervals splits every elementary covered segment evenly
        # among the programs running through it (pipelined decode
        # calls overlap on the in-order device queue — neither owns
        # the wall exclusively). device_busy_s is then DEFINED as the
        # fsum of the per-program totals, so the programs block
        # reconciles with it by construction, not by coincidence:
        # math.fsum over the reported busy_s values reproduces
        # total_busy_s bitwise (fsum is exact in any order).
        starts_at: dict[float, list[str]] = {}
        ends_at: dict[float, list[str]] = {}
        for a, b, prog in clipped:
            starts_at.setdefault(a, []).append(prog)
            ends_at.setdefault(b, []).append(prog)
        prog_parts: dict[str, list[float]] = {}
        active: dict[str, int] = {}
        prev: float | None = None
        for p in sorted(set(starts_at) | set(ends_at)):
            if prev is not None and active and p > prev:
                share = (p - prev) / sum(active.values())
                for prog, n in active.items():
                    prog_parts.setdefault(prog, []).append(share * n)
            for prog in ends_at.get(p, ()):
                active[prog] -= 1
                if not active[prog]:
                    del active[prog]
            for prog in starts_at.get(p, ()):
                active[prog] = active.get(prog, 0) + 1
            prev = p
        prog_busy = {prog: math.fsum(parts)
                     for prog, parts in prog_parts.items()}
        busy = math.fsum(prog_busy.values())

        gap_thresh = self.idle_gap_ms / 1000.0
        host_gap = idle = 0.0
        hg_intervals: list[tuple[float, float]] = []
        cursor = start
        for a, b in merged:
            g = a - cursor
            if g > 0:
                if g > gap_thresh:
                    idle += g
                else:
                    host_gap += g
                    hg_intervals.append((cursor, a))
            cursor = max(cursor, b)
        tail = now - cursor
        if tail > 0:
            if tail > gap_thresh:
                idle += tail
            else:
                host_gap += tail
                hg_intervals.append((cursor, now))
        window = now - start
        frac = (lambda x: round(x / window, 4)) if window > 0 \
            else (lambda x: 0.0)
        out["wall"] = {
            "window_s": round(window, 4),
            "device_busy_s": round(busy, 4),
            "host_gap_s": round(host_gap, 4),
            "idle_s": round(idle, 4),
            "device_busy_frac": frac(busy),
            "host_gap_frac": frac(host_gap),
            "idle_frac": frac(idle),
        }

        # Program stats (calls, tokens) ride the same records.
        prog_calls: dict[str, int] = {}
        prog_tokens: dict[str, int] = {}
        for r in records:
            prog = str(r.attrs.get("program", "(unattributed)"))
            prog_calls[prog] = prog_calls.get(prog, 0) + 1
            prog_tokens[prog] = prog_tokens.get(prog, 0) \
                + int(r.attrs.get("tokens", 0))
        by_program = [
            {"program": prog,
             # busy_s deliberately unrounded: the reconciliation
             # contract (fsum(busy_s) == total_busy_s) survives JSON
             # round-tripping only at full precision.
             "busy_s": prog_busy.get(prog, 0.0),
             "busy_frac_of_window": frac(prog_busy.get(prog, 0.0)),
             "frac_of_busy": round(prog_busy.get(prog, 0.0) / busy, 4)
             if busy > 0 else None,
             "calls": prog_calls.get(prog, 0),
             "tokens": prog_tokens.get(prog, 0)}
            for prog in prog_busy
        ]
        by_program.sort(key=lambda e: (-e["busy_s"], e["program"]))
        out["programs"] = {"total_busy_s": busy,
                           "by_program": by_program}

        # Host-gap cause decomposition: GC pauses are exact
        # (gc.callbacks intervals, clipped to the gap); the remainder
        # of each gap distributes proportionally to what the sampler
        # saw the engine thread doing inside it; whatever no evidence
        # claims — including every gap sampled as "other" and every
        # gap shorter than a sampler tick — lands in the residual
        # "other" bucket, which CLOSES the sum: by-cause seconds (and
        # fractions) total host_gap_s (host_gap_frac) by construction.
        try:
            prof = self._get_profiler()
        except Exception:
            prof = None
        named_parts: dict[str, list[float]] = {}
        for g0, g1 in hg_intervals:
            glen = g1 - g0
            gc_s = 0.0
            counts: dict[str, int] = {}
            if prof is not None:
                # A torn sampler (thread died mid-walk) costs this
                # gap's evidence, never the /perf report.
                try:
                    gc_s = min(glen,
                               max(0.0, prof.gc_overlap_s(g0, g1)))
                    counts = prof.causes_between(g0, g1)
                except Exception:
                    gc_s, counts = 0.0, {}
            if gc_s > 0:
                named_parts.setdefault("gc", []).append(gc_s)
            rest = glen - gc_s
            seen = sum(counts.values())
            if rest > 0 and seen > 0:
                for c in GAP_CAUSES:
                    if c in ("gc", "other"):
                        continue
                    n = counts.get(c, 0)
                    if n:
                        named_parts.setdefault(c, []).append(
                            rest * n / seen)
        named_s = {c: math.fsum(v) for c, v in named_parts.items()}
        other_s = max(0.0, host_gap - math.fsum(named_s.values()))
        cause_s = {c: named_s.get(c, 0.0) for c in GAP_CAUSES}
        cause_s["other"] = other_s
        out["host_gap_causes"] = {
            "host_gap_s": host_gap,
            "host_gap_frac": host_gap / window if window > 0 else 0.0,
            "sampler": {
                "enabled": bool(getattr(prof, "enabled", False)),
                "samples": int(getattr(prof, "samples", 0)),
            },
            "by_cause": {
                c: {"s": cause_s[c],
                    "frac": cause_s[c] / window if window > 0 else 0.0}
                for c in GAP_CAUSES
            },
        }

        # Useful tokens vs computed rows, occupancy, FLOPs, KV bytes.
        decode_tokens = prefill_tokens = 0
        computed_rows = 0
        occ_weight = occ_sum = 0.0
        flops = kv_bytes = weight_bytes = 0.0
        for r in records:
            a = r.attrs
            flops += float(a.get("flops", 0.0))
            if r.name == _STEP:
                decode_tokens += int(a.get("tokens", 0))
                computed_rows += int(a.get("rows",
                                           int(a.get("steps", 0))
                                           * int(a.get("slots", 0))))
                kv_bytes += float(a.get("kv_bytes", 0.0))
                weight_bytes += float(a.get("weight_bytes", 0.0))
                dur = max(0.0, r.t1 - r.t0)
                occ_weight += dur
                occ_sum += dur * float(a.get("occupancy", 0.0))
            elif r.name == _PREFILL:
                prefill_tokens += int(a.get("tokens", 0))
                computed_rows += int(a.get("rows", a.get("tokens", 0)))
        useful = decode_tokens + prefill_tokens
        out["tokens"] = {
            "decode_tokens": decode_tokens,
            "prefill_tokens": prefill_tokens,
            "computed_token_rows": computed_rows,
            "padding_waste_frac": round(1.0 - useful / computed_rows, 4)
            if computed_rows > 0 else None,
            "useful_tok_s": round(useful / window, 2)
            if window > 0 else None,
            "busy_tok_s": round(useful / busy, 2) if busy > 0 else None,
            "occupancy_mean": round(occ_sum / occ_weight, 4)
            if occ_weight > 0 else None,
        }
        achieved = flops / window / 1e12 if window > 0 else 0.0
        out["mfu"] = {
            "flops": flops,
            # Not rounded to fixed decimals: a tiny test model's real
            # achieved TFLOP/s (~1e-5) must not collapse to 0.
            "achieved_tflops": achieved,
            "peak_tflops": peak or None,
            "device": device,
            "mfu": round(achieved / peak, 6) if peak > 0 else None,
        }
        # KV attention-read bandwidth next to MFU: decode is
        # KV-read-bound at scale, and the element size here is the
        # cache's honest one (int8+scales under KV_QUANT=int8) — the
        # halved-bytes win is directly visible as read_gbps dropping
        # (same tok/s) or bw_util headroom appearing.
        kv_gbps = kv_bytes / window / 1e9 if window > 0 else 0.0
        out["kv"] = {
            "bytes_read": kv_bytes,
            "read_gbps": kv_gbps,
            "peak_hbm_gbps": peak_hbm or None,
            "hbm_source": hbm_src,
            "bw_util": round(kv_gbps / peak_hbm, 6)
            if peak_hbm > 0 else None,
        }
        # Weight-read bandwidth at the RESIDENT tier's size (recorded
        # per step by the engine, never recomputed from an assumed
        # bf16): WEIGHT_QUANT=int4 shows up directly as read_gbps
        # dropping ~4x at the same tok/s. The combined "hbm" section is
        # the honest roofline operand — decode arithmetic intensity
        # (flop_per_byte) over weights + KV together.
        w_gbps = weight_bytes / window / 1e9 if window > 0 else 0.0
        out["weights"] = {
            "bytes_read": weight_bytes,
            "read_gbps": w_gbps,
            "bw_util": round(w_gbps / peak_hbm, 6)
            if peak_hbm > 0 else None,
        }
        hbm_bytes = kv_bytes + weight_bytes
        hbm_gbps = kv_gbps + w_gbps
        out["hbm"] = {
            "bytes_read": hbm_bytes,
            "read_gbps": hbm_gbps,
            "peak_hbm_gbps": peak_hbm or None,
            "bw_util": round(hbm_gbps / peak_hbm, 6)
            if peak_hbm > 0 else None,
            "flop_per_byte": round(flops / hbm_bytes, 4)
            if hbm_bytes > 0 else None,
        }
        # First-order roofline ceiling: the tok/s
        # this window would have produced if HBM were saturated at the
        # device peak with the SAME measured per-useful-token byte
        # cost. frac_of_ceiling equals hbm.bw_util by construction —
        # stated here so "measured X tok/s of Y ceiling" reads off one
        # block without re-deriving the division.
        bpt = hbm_bytes / useful if useful > 0 else 0.0
        ceiling = peak_hbm * 1e9 / bpt if bpt > 0 and peak_hbm > 0 \
            else 0.0
        out["ceiling"] = {
            "hbm_bytes_per_token": round(bpt, 2) if bpt > 0 else None,
            "ceiling_tok_s": round(ceiling, 2) if ceiling > 0 else None,
            "measured_tok_s": out["tokens"]["useful_tok_s"],
            "frac_of_ceiling": round(hbm_gbps / peak_hbm, 6)
            if peak_hbm > 0 else None,
        }
        return out

    def summary(self, now: float | None = None) -> dict[str, Any]:
        """Compact one-level digest of ``report``."""
        rep = self.report(now)
        wall = rep.get("wall") or {}
        toks = rep.get("tokens") or {}
        mfu = rep.get("mfu") or {}
        kv = rep.get("kv") or {}
        return {
            "device_busy_frac": wall.get("device_busy_frac"),
            "host_gap_frac": wall.get("host_gap_frac"),
            "idle_frac": wall.get("idle_frac"),
            "occupancy_mean": toks.get("occupancy_mean"),
            "padding_waste_frac": toks.get("padding_waste_frac"),
            "useful_tok_s": toks.get("useful_tok_s"),
            "mfu": mfu.get("mfu"),
            "achieved_tflops": mfu.get("achieved_tflops"),
            "kv_read_gbps": kv.get("read_gbps"),
            "kv_bw_util": kv.get("bw_util"),
            "weight_read_gbps": (rep.get("weights") or {}).get(
                "read_gbps"),
            "hbm_bw_util": (rep.get("hbm") or {}).get("bw_util"),
            "flop_per_byte": (rep.get("hbm") or {}).get("flop_per_byte"),
            "attention_kernel": (rep.get("model") or {}).get(
                "attention_kernel"),
            "ceiling_tok_s": (rep.get("ceiling") or {}).get(
                "ceiling_tok_s"),
            "frac_of_ceiling": (rep.get("ceiling") or {}).get(
                "frac_of_ceiling"),
            "serving_compiles": rep["compiles"]["serving"],
            "host_gap_causes": {
                c: round(v["frac"], 4) for c, v in
                ((rep.get("host_gap_causes") or {}).get("by_cause")
                 or {}).items()
            } or None,
            "programs_top": [
                {"program": e["program"],
                 "busy_s": round(e["busy_s"], 4),
                 "frac_of_busy": e["frac_of_busy"]}
                for e in (rep.get("programs") or {}).get(
                    "by_program", [])[:5]
            ],
        }

    def sample(self, now: float | None = None) -> None:
        """Refresh the perf_* gauges from a fresh report (called by the
        monitoring app before rendering /metrics, like the watchdog's
        heartbeat gauge)."""
        rep = self.report(now)
        wall = rep.get("wall") or {}
        toks = rep.get("tokens") or {}
        mfu = rep.get("mfu") or {}
        kv = rep.get("kv") or {}
        self._m_busy.set(wall.get("device_busy_frac") or 0.0)
        self._m_gap.set(wall.get("host_gap_frac") or 0.0)
        self._m_idle.set(wall.get("idle_frac") or 0.0)
        self._m_waste.set(toks.get("padding_waste_frac") or 0.0)
        self._m_occ.set(toks.get("occupancy_mean") or 0.0)
        self._m_tok_s.set(toks.get("useful_tok_s") or 0.0)
        self._m_mfu.set(mfu.get("mfu") or 0.0)
        self._m_peak.set(mfu.get("peak_tflops") or 0.0)
        self._m_kv_gbps.set(kv.get("read_gbps") or 0.0)
        self._m_kv_bw.set(kv.get("bw_util") or 0.0)
        self._m_w_gbps.set((rep.get("weights") or {}).get("read_gbps")
                           or 0.0)
        self._m_hbm_bw.set((rep.get("hbm") or {}).get("bw_util") or 0.0)
        progs = (rep.get("programs") or {}).get("by_program", [])
        self._m_prog_busy.set_all(
            {e["program"]: round(e["busy_s"], 6) for e in progs})
        self._m_prog_calls.set_all(
            {e["program"]: e["calls"] for e in progs})
        causes = ((rep.get("host_gap_causes") or {}).get("by_cause")
                  or {})
        self._m_gap_cause_s.set_all(
            {c: round(v["s"], 6) for c, v in causes.items()})
        self._m_gap_cause_frac.set_all(
            {c: round(v["frac"], 6) for c, v in causes.items()})

    def clear(self) -> None:
        """Test hook: drop the compile ledger IN PLACE. The model
        binding is construction-time wiring from a live engine (like
        cached metric objects) and survives — clearing it would orphan
        that engine's per-call FLOP feed for the rest of the process."""
        with self._lock:
            self._compiles.clear()
            self._journey_hops.clear()
            self._journey_frames = 0
            self._journey_conns = 0


_perf: PerfLedger | None = None


def get_perf() -> PerfLedger:
    global _perf
    if _perf is None:
        _perf = PerfLedger()
    return _perf


def reset_perf() -> None:
    """Test hook: clear the process-wide ledger in place."""
    if _perf is not None:
        _perf.clear()
