"""Cross-replica trace stitching (docs/OBSERVABILITY.md "Fleet
tracing").

A copy of ``fasttalk_tpu/observability/stitch.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

A request that the router places on replica A, loses to a mid-stream
death, and resumes on replica B leaves its story in up to three
per-process span rings: the router-front process (router + serving
spans, and — for in-proc replicas — the replica spans too, since they
share ONE process tracer), replica A's process and replica B's. This
module defines the wire form of one process's contribution (a
*fragment*: the trace rendered with wall-clock timestamps, so rings
anchored to different monotonic clocks merge) and the join
(``stitch``): one timeline, spans tagged by source, ordered by wall
time, with the resume/terminal accounting the failover tests assert
on.

Fragments travel over ``GET /traces/{request_id}`` on the serving
port (serving/server.py); the router fans the lookup out to every
live replica (router/replica.py fetch_trace, router/router.py
stitched_trace) and the monitoring port's ``/traces/{request_id}``
falls back to the stitched view when the local ring misses — the fix
for the router-fronted 404.
"""

from __future__ import annotations

from typing import Any

from fasttalk_tpu_torch.observability.trace import RequestTrace, Tracer

# Span names that mark a request's terminal serving event. Only the
# serving edge that owns the WS/HTTP stream emits request_complete —
# a stitched trace must contain exactly ONE, however many replicas
# the request visited.
TERMINAL_SPAN = "request_complete"
RESUME_SPAN = "resume"


def trace_fragment(tracer: Tracer, trace: RequestTrace,
                   source: str = "") -> dict[str, Any]:
    """One process's contribution to a fleet trace, in wall-clock
    time (``tracer.to_wall``) so fragments from processes with
    unrelated monotonic anchors order correctly when merged."""
    return {
        "request_id": trace.request_id,
        "session_id": trace.session_id,
        "trace_id": trace.trace_id,
        "phase": trace.phase,
        "finished": trace.finished,
        "dropped_spans": trace.dropped_spans,
        "source": source,
        "attrs": dict(trace.attrs),
        "spans": [{
            "name": s.name,
            "t0": tracer.to_wall(s.t0),
            "t1": tracer.to_wall(s.t1),
            "dur_ms": s.dur_ms,
            "attrs": dict(s.attrs),
        } for s in trace.spans],
    }


def collect_fragments(tracer: Tracer, request_id: str,
                      trace_id: str = "",
                      source: str = "") -> list[dict[str, Any]]:
    """Every local fragment for a request: exact request-id match
    first, then any other trace sharing the fleet trace id (a
    failed-over request re-dispatched under a new local request id on
    this replica)."""
    out: list[dict[str, Any]] = []
    seen: set[int] = set()
    trace = tracer.get(request_id)
    if trace is not None:
        seen.add(id(trace))
        out.append(trace_fragment(tracer, trace, source))
        trace_id = trace_id or trace.trace_id
    for t in tracer.find_by_trace_id(trace_id):
        if id(t) not in seen:
            seen.add(id(t))
            out.append(trace_fragment(tracer, t, source))
    return out


def stitch(fragments: list[dict[str, Any]]) -> dict[str, Any] | None:
    """Merge per-process fragments into ONE cross-replica timeline.

    Spans are tagged with their fragment's source (kept as the span's
    ``component`` attr when the span already carries one — in-proc
    fleets tag at record time, remote fragments at fetch time) and
    ordered by wall-clock start. The summary counts are what the
    failover acceptance asserts: one ``resumed`` marker per failover
    and exactly one terminal event however many replicas served."""
    fragments = [f for f in fragments if f]
    if not fragments:
        return None
    spans: list[dict[str, Any]] = []
    sources: list[str] = []
    request_ids: list[str] = []
    trace_id = ""
    session_id = ""
    finished = False
    for frag in fragments:
        src = frag.get("source") or ""
        if src and src not in sources:
            sources.append(src)
        rid = frag.get("request_id") or ""
        if rid and rid not in request_ids:
            request_ids.append(rid)
        trace_id = trace_id or frag.get("trace_id") or ""
        session_id = session_id or frag.get("session_id") or ""
        finished = finished or bool(frag.get("finished"))
        for s in frag.get("spans", ()):
            row = dict(s)
            attrs = dict(row.get("attrs") or {})
            attrs.setdefault("component", src)
            row["attrs"] = attrs
            row["source"] = src
            spans.append(row)
    spans.sort(key=lambda s: (float(s.get("t0", 0.0)),
                              float(s.get("t1", 0.0))))
    components = sorted({str(s["attrs"].get("component") or "")
                         for s in spans} - {""})
    resumes = sum(1 for s in spans if s["name"] == RESUME_SPAN)
    terminals = sum(1 for s in spans if s["name"] == TERMINAL_SPAN)
    return {
        "trace_id": trace_id,
        "request_ids": request_ids,
        "session_id": session_id,
        "sources": sources,
        "components": components,
        "fragments": len(fragments),
        "finished": finished,
        "resumed": resumes,
        "terminal_events": terminals,
        "n_spans": len(spans),
        "spans": spans,
    }
