"""Trace exporters: Chrome trace-event JSON (Perfetto) and JSONL.

A copy of ``fasttalk_tpu/observability/export.py`` (the port
imports nothing of the JAX package); the two must behave the same on
the same inputs.

Chrome trace-event format (the subset Perfetto and chrome://tracing
load): a top-level ``{"traceEvents": [...]}`` object whose events are
complete spans (``"ph": "X"``) with microsecond ``ts``/``dur``, plus
``"M"`` metadata events naming each row. One pid for the process; one
tid per request (rows sort by first span), tid 0 reserved for the
engine-step telemetry row.

JSONL: one flat object per span — the offline-analysis format
scripts/trace_report.py consumes. Schema per line:

    {"request_id": str|null, "session_id": str, "span": str,
     "ts": epoch-seconds float, "dur_ms": float, "attrs": {...}}

Engine-step records export with ``request_id: null`` and the span name
``engine_step`` so per-request phases and process-level call telemetry
never mix in percentile tables.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterable, TextIO

from fasttalk_tpu_torch.observability.trace import (RequestTrace, StepRecord,
                                                    Tracer)

_ENGINE_TID = 0


def chrome_trace(tracer: Tracer, traces: Iterable[RequestTrace],
                 steps: Iterable[StepRecord] = ()) -> dict[str, Any]:
    """Render traces (+ optional engine-step records) as a Chrome
    trace-event JSON object loadable in Perfetto."""
    events: list[dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 0,
        "args": {"name": "fasttalk-tpu"},
    }, {
        "name": "thread_name", "ph": "M", "pid": 1, "tid": _ENGINE_TID,
        "args": {"name": "engine steps"},
    }]
    for tid, trace in enumerate(traces, start=1):
        events.append({
            "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
            "args": {"name": f"req {trace.request_id}"},
        })
        for span in trace.spans:
            events.append({
                "name": span.name,
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": tracer.to_wall(span.t0) * 1e6,
                "dur": max(0.0, (span.t1 - span.t0) * 1e6),
                "args": {"request_id": trace.request_id,
                         "session_id": trace.session_id, **span.attrs},
            })
        if trace.dropped_spans:
            events.append({
                "name": "spans_dropped", "ph": "I", "pid": 1, "tid": tid,
                "ts": tracer.to_wall(trace.started_mono) * 1e6, "s": "t",
                "args": {"dropped": trace.dropped_spans},
            })
    for rec in steps:
        events.append({
            "name": rec.name,
            "ph": "X",
            "pid": 1,
            "tid": _ENGINE_TID,
            "ts": tracer.to_wall(rec.t0) * 1e6,
            "dur": max(0.0, (rec.t1 - rec.t0) * 1e6),
            "args": dict(rec.attrs),
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def jsonl_dump(tracer: Tracer, traces: Iterable[RequestTrace],
               steps: Iterable[StepRecord] = ()) -> str:
    """Render traces as JSONL (one span per line; trailing newline)."""
    lines: list[str] = []
    for trace in traces:
        for span in trace.spans:
            lines.append(json.dumps({
                "request_id": trace.request_id,
                "session_id": trace.session_id,
                "span": span.name,
                "ts": tracer.to_wall(span.t0),
                "dur_ms": span.dur_ms,
                "attrs": span.attrs,
            }, ensure_ascii=False, default=str))
    for rec in steps:
        lines.append(json.dumps({
            "request_id": None,
            "session_id": "",
            "span": rec.name,
            "ts": tracer.to_wall(rec.t0),
            "dur_ms": (rec.t1 - rec.t0) * 1000.0,
            "attrs": rec.attrs,
        }, ensure_ascii=False, default=str))
    return "\n".join(lines) + ("\n" if lines else "")


_PROM_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"     # metric name
    r"(?:\{(.*)\})?"                   # optional label block
    r" (\S+)"                          # value
    r"(?: ([0-9-]+))?$")               # optional timestamp (dropped)
_PROM_SUFFIXES = ("_bucket", "_sum", "_count")


def _prom_family(name: str) -> str:
    for suffix in _PROM_SUFFIXES:
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def _prom_parse(text: str) -> dict[str, dict[str, Any]]:
    """Exposition text -> family -> {help, type, samples:[(name,
    labels_str, value_str)]}, in family order. Free comments and
    malformed lines are dropped (the merged output is re-validated by
    check_prometheus in tests; a broken replica must not break the
    fleet view)."""
    families: dict[str, dict[str, Any]] = {}

    def fam(name: str) -> dict[str, Any]:
        f = families.get(name)
        if f is None:
            f = {"help": None, "type": None, "samples": []}
            families[name] = f
        return f

    for line in text.splitlines():
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                key = "help" if parts[1] == "HELP" else "type"
                f = fam(parts[2])
                if f[key] is None:
                    f[key] = parts[3] if len(parts) > 3 else ""
            continue
        m = _PROM_SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, value, _ts = m.groups()
        family = _prom_family(name)
        if family not in families and name in families:
            family = name
        fam(family)["samples"].append((name, labels or "", value))
    return families


def merge_prometheus(local_text: str, local_replica: str,
                     remotes: dict[str, str | None]) -> str:
    """Label-merged fleet exposition for ``GET /fleet/metrics``.

    Counters and gauges get a ``replica="<id>"`` label per source;
    histograms are SUMMED across replicas instead (the strict
    validator — and a sane scraper — requires one monotone bucket
    ladder per family, and every replica runs the same bucket
    bounds). The router-front process (router + any in-proc replicas,
    which share one registry) contributes as ``local_replica``;
    unreachable remotes (value None) are noted as free comments so an
    operator sees the gap instead of inferring it from absent
    series."""
    sources: list[tuple[str, dict[str, dict[str, Any]]]] = [
        (local_replica, _prom_parse(local_text))]
    unreachable: list[str] = []
    for rid in sorted(remotes):
        text = remotes[rid]
        if text is None:
            unreachable.append(rid)
        else:
            sources.append((rid, _prom_parse(text)))

    # Family order: local first, then any remote-only families.
    order: list[str] = []
    merged: dict[str, dict[str, Any]] = {}
    for rid, families in sources:
        for name, f in families.items():
            if name not in merged:
                order.append(name)
                merged[name] = {"help": f["help"], "type": f["type"],
                                "per_replica": []}
            m = merged[name]
            if m["help"] is None:
                m["help"] = f["help"]
            if m["type"] is None:
                m["type"] = f["type"]
            m["per_replica"].append((rid, f["samples"]))

    def labelled(labels: str, rid: str) -> str:
        extra = f'replica="{rid}"'
        return f"{labels},{extra}" if labels else extra

    lines: list[str] = []
    for rid in unreachable:
        lines.append(f"# replica {rid} unreachable at scrape time")
    for name in order:
        m = merged[name]
        if m["help"] is not None:
            lines.append(f"# HELP {name} {m['help']}")
        if m["type"] is not None:
            lines.append(f"# TYPE {name} {m['type']}")
        if m["type"] == "histogram":
            # Sum bucket counts / _sum / _count by le across replicas.
            buckets: dict[str, float] = {}
            le_order: list[str] = []
            total_sum = 0.0
            total_count = 0.0
            for rid, samples in m["per_replica"]:
                for sname, labels, value in samples:
                    try:
                        v = float(value)
                    except ValueError:
                        continue
                    if sname.endswith("_bucket"):
                        lem = re.search(r'le="((?:[^"\\]|\\.)*)"',
                                        labels)
                        if lem is None:
                            continue
                        le = lem.group(1)
                        if le not in buckets:
                            le_order.append(le)
                        buckets[le] = buckets.get(le, 0.0) + v
                    elif sname.endswith("_sum"):
                        total_sum += v
                    elif sname.endswith("_count"):
                        total_count += v
            for le in le_order:
                acc = buckets[le]
                acc_s = repr(int(acc)) if acc == int(acc) else repr(acc)
                lines.append(f'{name}_bucket{{le="{le}"}} {acc_s}')
            lines.append(f"{name}_sum {total_sum}")
            cnt = (repr(int(total_count))
                   if total_count == int(total_count)
                   else repr(total_count))
            lines.append(f"{name}_count {cnt}")
        else:
            for rid, samples in m["per_replica"]:
                for sname, labels, value in samples:
                    lines.append(
                        f"{sname}{{{labelled(labels, rid)}}} {value}")
    lines.append("")
    return "\n".join(lines)


def load_jsonl(fp: TextIO) -> list[dict[str, Any]]:
    """Parse a JSONL trace dump, skipping blank lines; raises ValueError
    naming the offending line number on malformed input."""
    records: list[dict[str, Any]] = []
    for i, line in enumerate(fp, start=1):
        line = line.strip()
        if not line:
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"line {i}: not valid JSON ({e})") from e
        if not isinstance(obj, dict) or "span" not in obj:
            raise ValueError(f"line {i}: not a span record")
        records.append(obj)
    return records
