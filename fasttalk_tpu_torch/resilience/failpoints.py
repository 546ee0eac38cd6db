"""Named-failpoint fault injection: prove the recovery paths, not just
ship them.

The last six robustness layers (supervisor restart, circuit breaker,
watchdog force_fail, router failover, KV park/restore, admission
shedding) were each verified by hand-crafted unit mocks. This module is
the common injection seam that lets one *declared* fault exercise the
real stack end to end: every resilience-relevant host-side boundary
fires a **named failpoint**, and an activated rule can turn that call
into an error, a delay, a hang, a corruption or a thread crash —
deterministically, probabilistically, or for the Nth hit only.

Zero hot-path overhead when disabled
------------------------------------
Every call site guards with the module-level flag::

    from fasttalk_tpu_torch.resilience import failpoints as _fp
    ...
    if _fp.enabled:
        _fp.fire("engine.decode.dispatch", request_id=rid)

With no active rules ``enabled`` is ``False`` and the seam costs one
attribute load + branch — nothing else runs, no lock is taken, and no
failpoint code is reachable from inside any jitted program (all sites
are host-side dispatch boundaries; the device graphs are byte-identical
with the subsystem on or off).

Activation
----------
- ``FAULT_POINTS`` env spec, validated by ``utils.config.Config`` at
  startup (a bad spec is a named config error, never a silently
  disabled drill).
- ``POST /debug/fault`` on the monitoring port — **off by default**
  (``FAULT_HTTP=true`` enables it; never in production).

Spec grammar (one line, documented in docs/RESILIENCE.md)::

    FAULT_POINTS ::= clause ("," clause)*
    clause       ::= point "=" action (";" param)*
    action       ::= "error" | "hang" | "corrupt" | "crash_thread"
                   | "delay_ms:" INT
    param        ::= "p=" FLOAT    (fire probability, default 1.0)
                   | "count=" INT  (max fires, default unlimited)
                   | "after=" INT  (skip the first N matching hits)
                   | "match=" STR  (substring of any ctx value, e.g.
                                    a request or session id)

Example::

    FAULT_POINTS="engine.decode.dispatch=error;count=1,\
kv.park.copy=delay_ms:250;p=0.5"

Actions
-------
- ``error``        raise ``FaultInjected`` (or the seam's ``exc=``
                   class, so remote seams raise the transport error
                   type their retry machinery classifies).
- ``delay_ms:N``   sleep N ms at the seam (slowness, not failure).
- ``hang``         block until the rule is cleared (or
                   ``FAULT_HANG_MAX_S``, default 300) — what a wedged
                   device call or dead peer looks like.
- ``corrupt``      ``fire`` returns ``"corrupt"``; seams that can
                   meaningfully corrupt their payload do so, others
                   treat it as a no-op.
- ``crash_thread`` raise ``FaultCrash`` — a ``BaseException`` subclass
                   that escapes every scoped ``except Exception``
                   handler, killing the owning thread the way a real
                   interpreter-level fault would. Only the engine
                   loop's top-level handler catches it (a thread crash
                   there must still terminal-event in-flight requests).

Every fire increments ``fault_injected_total`` (plus a per-point
``fault_injected_<point>_<action>_total``) and emits a coalesced
``fault_injection`` event, which the flight recorder's bundles carry —
an incident capture always shows whether the incident was injected.
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("resilience.failpoints")

# Module-level fast-path flag: call sites read this BEFORE calling
# fire(). Updated (under _lock) whenever rules are activated/cleared.
enabled: bool = False

# The closed catalog of injection points. scripts/check_failpoints.py
# statically verifies (a) every name here is fired by at least one
# call site, (b) every fire() call site uses a name from here, and
# (c) every name is injected by at least one chaos test.
CATALOG: dict[str, str] = {
    "engine.loop.tick":
        "top of every engine-thread loop iteration (crash/hang the "
        "engine thread itself)",
    "engine.decode.dispatch":
        "before a jitted K-step decode call is dispatched",
    "engine.prefill.dispatch":
        "before a prefill device call (chunked and batched paths)",
    "engine.retire.fetch":
        "the blocking wait on a retired decode call's token fetch",
    "kv.block_alloc":
        "paged-KV device block-pool allocation (KV_LAYOUT=paged): "
        "exhaust the pool mid-prefill/decode",
    "kv.park.copy":
        "device->host fetch of a parked session's KV rows (copy "
        "thread)",
    "kv.prestage.copy":
        "best-effort host->device prestage of a parked entry",
    "kv.restore.dispatch":
        "host->device restore of parked KV at admission",
    "remote.connect":
        "remote backend HTTP connect, pre-first-byte (vllm/ollama)",
    "remote.stream":
        "remote backend response stream, per chunk",
    "router.probe":
        "router health/load probe of one replica (error = the probe "
        "cannot reach it: a network partition as the router sees it)",
    "router.place":
        "router placement decision for one request (error sheds the "
        "placement the way a fully-partitioned fleet would)",
    "router.migrate_send":
        "cross-replica KV migration, source-side export of the parked "
        "entry",
    "router.migrate_recv":
        "cross-replica KV migration, target-side import (corrupt = "
        "the transferred entry fails validation and is refused)",
    "router.handoff":
        "disaggregated prefill->decode handoff, between the prefill "
        "leg finishing and the KV landing on the decode replica "
        "(error/hang = the settle fails or wedges: the stream must "
        "fall back to mixed placement with no client-visible error)",
    "serving.ws.send":
        "WebSocket frame send to a client",
    "spmd.send":
        "SPMD leader frame send to followers",
    "spmd.recv":
        "SPMD follower frame receive",
    "structured.compile":
        "structured-output FSM compile on the compiler worker",
}

_ACTIONS = ("error", "delay_ms", "hang", "corrupt", "crash_thread")

# Safety net for `hang`: a forgotten rule must not wedge a test run or
# a drill forever. Overridable for tests.
HANG_MAX_S = float(os.getenv("FAULT_HANG_MAX_S", "300") or 300)


class FaultInjected(RuntimeError):
    """The `error` action's default exception (seams may override the
    class via fire(exc=...) so their retry/classification machinery
    sees the transport error type it expects)."""


class FaultCrash(BaseException):
    """The `crash_thread` action: subclasses BaseException so it
    escapes every scoped ``except Exception`` handler and genuinely
    kills the owning thread — the engine loop's top-level handler is
    the single place that catches it (a crash there must still
    terminal-event in-flight requests and mark the thread stopped)."""


@dataclass
class Rule:
    point: str
    action: str
    arg_ms: float = 0.0        # delay_ms argument
    p: float = 1.0             # fire probability per matching hit
    count: int | None = None   # max fires (None = unlimited)
    after: int = 0             # matching hits to skip first
    match: str = ""            # substring of any ctx value
    hits: int = 0              # matching hits seen
    fired: int = 0             # times the action actually ran

    def to_dict(self) -> dict[str, Any]:
        return {"point": self.point, "action": self.action,
                "arg_ms": self.arg_ms, "p": self.p,
                "count": self.count, "after": self.after,
                "match": self.match, "hits": self.hits,
                "fired": self.fired}


_lock = threading.Lock()
_rules: dict[str, list[Rule]] = {}
_spec: str = ""  # the spec text the active rules came from


def parse_spec(spec: str) -> list[Rule]:
    """Parse a FAULT_POINTS spec into rules. Raises ValueError naming
    every problem (unknown point, unknown action, bad parameter) —
    Config surfaces these as startup errors."""
    rules: list[Rule] = []
    errs: list[str] = []
    for clause in (c.strip() for c in spec.split(",") if c.strip()):
        head, _, tail = clause.partition(";")
        point, sep, action = head.partition("=")
        point = point.strip()
        action = action.strip()
        if not sep:
            errs.append(f"clause {clause!r} must be point=action")
            continue
        if point not in CATALOG:
            errs.append(f"unknown failpoint {point!r} (known: "
                        f"{', '.join(sorted(CATALOG))})")
            continue
        arg_ms = 0.0
        if action.startswith("delay_ms:"):
            raw = action[len("delay_ms:"):]
            action = "delay_ms"
            try:
                arg_ms = float(raw)
                if arg_ms < 0:
                    raise ValueError
            except ValueError:
                errs.append(f"{point}: delay_ms argument must be a "
                            f"non-negative number, got {raw!r}")
                continue
        elif action == "delay_ms":
            # A bare delay_ms would parse as a 0 ms sleep — a silently
            # inert drill, the exact failure mode the validated spec
            # exists to prevent.
            errs.append(f"{point}: delay_ms requires an argument "
                        "(delay_ms:<milliseconds>)")
            continue
        if action not in _ACTIONS:
            errs.append(f"{point}: unknown action {action!r} (known: "
                        f"{', '.join(_ACTIONS)})")
            continue
        rule = Rule(point=point, action=action, arg_ms=arg_ms)
        ok = True
        for param in (p.strip() for p in tail.split(";") if p.strip()):
            key, psep, val = param.partition("=")
            if not psep:
                errs.append(f"{point}: parameter {param!r} must be "
                            "key=value")
                ok = False
                continue
            try:
                if key == "p":
                    rule.p = float(val)
                    if not 0.0 <= rule.p <= 1.0:
                        raise ValueError
                elif key == "count":
                    rule.count = int(val)
                    if rule.count < 1:
                        raise ValueError
                elif key == "after":
                    rule.after = int(val)
                    if rule.after < 0:
                        raise ValueError
                elif key == "match":
                    rule.match = val
                else:
                    errs.append(f"{point}: unknown parameter {key!r} "
                                "(known: p, count, after, match)")
                    ok = False
            except ValueError:
                errs.append(f"{point}: bad value {val!r} for {key}")
                ok = False
        if ok:
            rules.append(rule)
    if errs:
        raise ValueError("invalid FAULT_POINTS spec: " + "; ".join(errs))
    return rules


def activate(spec: str) -> list[Rule]:
    """Replace the active rule set with the parsed spec (empty spec =
    clear). Raises ValueError on a bad spec without touching the
    active rules."""
    global enabled, _spec
    rules = parse_spec(spec)
    with _lock:
        _rules.clear()
        for r in rules:
            _rules.setdefault(r.point, []).append(r)
        _spec = spec if rules else ""
        enabled = bool(_rules)
    if rules:
        log.warning(f"fault injection ACTIVE: {len(rules)} rule(s) "
                    f"from spec {spec!r}")
    return rules


def clear() -> None:
    """Deactivate every rule (also releases any in-progress hang)."""
    global enabled, _spec
    with _lock:
        _rules.clear()
        _spec = ""
        enabled = False


def describe() -> dict[str, Any]:
    """Active-rule + catalog view for GET /debug/fault and /health."""
    with _lock:
        rules = [r.to_dict() for rl in _rules.values() for r in rl]
    return {"enabled": enabled, "spec": _spec, "rules": rules,
            "catalog": dict(CATALOG)}


def active_points() -> list[str]:
    with _lock:
        return sorted(_rules)


def _rule_active(rule: Rule) -> bool:
    """True while `rule` is still in the active set (hang-release
    check; the identity test means clear()/activate() releases every
    parked hang)."""
    with _lock:
        return rule in _rules.get(rule.point, ())


def _select(name: str, ctx: dict[str, Any]) -> list[Rule]:
    """Pick the rules that fire for this hit (shared by fire and
    fire_async); notes metrics/events for each."""
    assert name in CATALOG, f"unregistered failpoint {name!r}"
    to_run: list[Rule] = []
    with _lock:
        rules = _rules.get(name)
        if not rules:
            return to_run
        for rule in rules:
            if rule.match and not any(
                    rule.match in str(v) for v in ctx.values()):
                continue
            rule.hits += 1
            if rule.hits <= rule.after:
                continue
            if rule.count is not None and rule.fired >= rule.count:
                continue
            if rule.p < 1.0 and random.random() >= rule.p:
                continue
            rule.fired += 1
            to_run.append(rule)
    for rule in to_run:
        _note_fired(rule, ctx)
    return to_run


def fire(name: str, exc: type | None = None, **ctx: Any) -> str | None:
    """Evaluate the active rules for failpoint ``name``. Call sites
    MUST guard with ``if failpoints.enabled:`` — that guard is the
    zero-overhead-off contract. Seams that run on the asyncio event
    loop must use :func:`fire_async` instead (a blocking sleep there
    would freeze every stream AND the /debug/fault endpoint needed to
    clear the rule).

    ``exc``: exception class the `error` action raises instead of
    FaultInjected (seams pass their transport error type so retry/
    breaker classification sees a realistic failure).
    ``ctx``: request_id/session_id/... strings the `match` predicate
    tests against.

    Returns ``"corrupt"`` when a corrupt rule fired (the seam decides
    what corruption means), else None.
    """
    out: str | None = None
    for rule in _select(name, ctx):
        if rule.action == "delay_ms":
            time.sleep(rule.arg_ms / 1000.0)
        elif rule.action == "hang":
            deadline = time.monotonic() + HANG_MAX_S
            while _rule_active(rule) and time.monotonic() < deadline:
                time.sleep(0.02)
        else:
            out = _act(rule, name, exc) or out
    return out


async def fire_async(name: str, exc: type | None = None,
                     **ctx: Any) -> str | None:
    """fire() for seams running on the asyncio event loop (WS send,
    remote connect/stream): delay and hang YIELD via asyncio.sleep,
    so one hung stream stays one hung stream — other sessions,
    /health and the /debug/fault clear path keep running. The
    non-sleeping actions share _act with fire(), so sync and async
    seams cannot drift."""
    import asyncio

    out: str | None = None
    for rule in _select(name, ctx):
        if rule.action == "delay_ms":
            await asyncio.sleep(rule.arg_ms / 1000.0)
        elif rule.action == "hang":
            deadline = time.monotonic() + HANG_MAX_S
            while _rule_active(rule) and time.monotonic() < deadline:
                await asyncio.sleep(0.02)
        else:
            out = _act(rule, name, exc) or out
    return out


def _act(rule: Rule, name: str, exc: type | None) -> str | None:
    """The non-sleeping actions (corrupt / crash_thread / error),
    shared verbatim by fire and fire_async."""
    if rule.action == "corrupt":
        return "corrupt"
    if rule.action == "crash_thread":
        raise FaultCrash(f"fault injected at {name}: crash_thread")
    cls = exc if exc is not None else FaultInjected
    raise cls(f"fault injected at {name}: error")


def _note_fired(rule: Rule, ctx: dict[str, Any]) -> None:
    """Metrics + event per fire. Imported lazily-cached singletons;
    never lets observability failures mask the injected fault."""
    try:
        from fasttalk_tpu_torch.observability.events import get_events
        from fasttalk_tpu_torch.utils.metrics import get_metrics

        m = get_metrics()
        m.counter("fault_injected_total",
                  "fault-injection actions executed (all points)").inc()
        slug = rule.point.replace(".", "_")
        m.counter(f"fault_injected_{slug}_{rule.action}_total",
                  f"injected {rule.action} at {rule.point}").inc()
        get_events().emit(
            "fault_injection", severity="warning", coalesce_s=5.0,
            coalesce_key=f"{rule.point}:{rule.action}",
            point=rule.point, action=rule.action, fired=rule.fired,
            **{k: str(v) for k, v in ctx.items()})
        log.warning(f"failpoint fired: {rule.point} -> {rule.action} "
                    f"(fire #{rule.fired})")
    except Exception:  # pragma: no cover - observability must not mask
        pass


def _init_from_env() -> None:
    """Best-effort import-time activation from FAULT_POINTS. A bad
    spec logs an error and stays DISABLED here — utils.config.Config
    validates the same spec and turns it into a startup error, so a
    served process can never run with a typo'd drill silently
    dropped."""
    spec = os.getenv("FAULT_POINTS", "").strip()
    if not spec:
        return
    try:
        activate(spec)
    except ValueError as e:
        log.error(f"FAULT_POINTS ignored: {e}")


_init_from_env()
