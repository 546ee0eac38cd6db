"""Per-token journey waterfall (docs/OBSERVABILITY.md "The token
journey").

A copy of ``fasttalk_tpu/observability/journey.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

The perf ledger decomposes *process* wall time (device busy / host gap
/ idle); this module decomposes *one connection's* latency the same
way, per emitted token frame: every frame's path from the engine's
blocking device fetch through detokenize, the event-loop hand-off and
the WS write is cut into named hops whose durations **telescope** —
consecutive boundary timestamps, so the hop sums reconcile with
wall-clock TTFT and inter-token gaps exactly by construction, not
within a fudge factor. (The JOURNEY_TOL knob exists for *derived*
checks in scripts/trace_report.py, where rounding and frame caps
apply.)

Boundaries per frame (all ``time.monotonic()``):

  prev ──engine──► w ──device_fetch──► f ──detok_emit──► e
       ──loop_dequeue──► dq ──ws_write──► sent

- ``prev``: the request start (frame 0 — so the "engine" hop covers
  queue wait + prefill + decode compute) or the previous frame's
  ``sent`` (the inter-token decomposition).
- ``w``/``f``/``e``: stamped on the engine thread when the request
  opted in (engine/engine.py attaches them to the token event as the
  ``"j"`` dict): the blocking device-fetch wait start, the fetch
  landing, and the event enqueue. Absent for remote engines — the
  frame degrades to engine → dequeue → ws_write.
- ``dq``/``sent``: stamped on the serving loop (serving/server.py).

Out-of-order stamps (a retirement that batched several requests'
flushes) are clamped forward, which redistributes between adjacent
hops but preserves the telescoping sum.

The recorder is per-connection, bounded (frame arrays cap at
``max_frames``; later frames still count in the totals), and feeds
three surfaces: the ``journey`` block in the WS ``response_complete``
stats, one ``token_journey`` summary span on the request trace (the
offline ``trace_report.py --journey`` input), and the perf ledger's
per-connection host-gap attribution.
"""

from __future__ import annotations

import math
from typing import Any

HOPS = ("engine", "device_fetch", "detok_emit", "loop_dequeue",
        "ws_write")

# Per-hop frame arrays kept on the token_journey span: enough for
# percentile math offline, bounded so a max_tokens=4096 stream cannot
# bloat the trace ring.
MAX_FRAMES = 512


def _percentile(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, math.ceil(q / 100.0 * len(sorted_vals)) - 1))
    return sorted_vals[idx]


class JourneyRecorder:
    """Accumulates one connection's per-frame hop decomposition."""

    def __init__(self, start_mono: float,
                 max_frames: int = MAX_FRAMES):
        self.start = start_mono
        self.max_frames = max(1, max_frames)
        self.frames = 0
        self.dropped = 0
        self._prev = start_mono
        self._last_sent: float | None = None
        self._first_sent: float | None = None
        # hop -> per-frame durations (ms), capped at max_frames
        self._hop_ms: dict[str, list[float]] = {h: [] for h in HOPS}
        # hop -> total over ALL frames (the caps never skew the sums)
        self._hop_total: dict[str, float] = {h: 0.0 for h in HOPS}
        self._ttft_hops: dict[str, float] | None = None

    def frame(self, j: dict[str, float] | None, t_dequeue: float,
              t_sent: float) -> None:
        """Record one emitted token frame. ``j`` is the engine's stamp
        dict ({"w","f","e"}, monotonic) or None for engines that don't
        stamp (remote backends) — the engine-side hops then fold into
        "engine"."""
        j = j or {}
        b = self._prev
        bounds: list[float] = []
        for t in (j.get("w"), j.get("f"), j.get("e"), t_dequeue,
                  t_sent):
            # Clamp forward: boundaries must not run backwards or the
            # telescoping sum breaks.
            b = b if t is None or t < b else t
            bounds.append(b)
        prev = self._prev
        hops: dict[str, float] = {}
        for name, bound in zip(HOPS, bounds):
            hops[name] = (bound - prev) * 1000.0
            prev = bound
        for name, ms in hops.items():
            self._hop_total[name] += ms
            if self.frames < self.max_frames:
                self._hop_ms[name].append(ms)
        if self.frames >= self.max_frames:
            self.dropped += 1
        if self.frames == 0:
            self._ttft_hops = dict(hops)
            self._first_sent = bounds[-1]
        self.frames += 1
        self._last_sent = bounds[-1]
        self._prev = bounds[-1]

    # ---------------- read side ----------------

    def summary(self) -> dict[str, Any]:
        """The connection's waterfall: hop totals + percentiles, the
        TTFT decomposition, and the reconciliation check (hop sums vs
        wall clock — 1.0 by construction)."""
        wall_ms = ((self._last_sent - self.start) * 1000.0
                   if self._last_sent is not None else 0.0)
        hops_sum = sum(self._hop_total.values())
        out: dict[str, Any] = {
            "frames": self.frames,
            "wall_ms": round(wall_ms, 3),
            "hops_sum_ms": round(hops_sum, 3),
            "reconciliation": round(hops_sum / wall_ms, 4)
            if wall_ms > 0 else None,
            "hops_ms": {h: round(v, 3)
                        for h, v in self._hop_total.items()},
        }
        if self._first_sent is not None:
            out["ttft_ms"] = round(
                (self._first_sent - self.start) * 1000.0, 3)
        if self._ttft_hops is not None:
            out["ttft_hops_ms"] = {h: round(v, 3)
                                   for h, v in self._ttft_hops.items()}
        p50: dict[str, float] = {}
        p99: dict[str, float] = {}
        for h, vals in self._hop_ms.items():
            sv = sorted(vals)
            p50[h] = round(_percentile(sv, 50), 3)
            p99[h] = round(_percentile(sv, 99), 3)
        out["hop_p50_ms"] = p50
        out["hop_p99_ms"] = p99
        if self.dropped:
            out["frames_uncounted_in_percentiles"] = self.dropped
        return out

    def span_attrs(self) -> dict[str, Any]:
        """Attrs for the once-per-request ``token_journey`` summary
        span: the summary plus the (capped) per-frame hop arrays the
        offline report computes percentiles from."""
        attrs = self.summary()
        attrs["frames_ms"] = {h: [round(v, 3) for v in vals]
                              for h, vals in self._hop_ms.items()}
        return attrs
