"""Multi-rank SPMD serving: leader/follower device-call replication.

Counterpart of ``fasttalk_tpu/parallel/spmd_serving.py`` (:76-417), with
its wire format, frames, heartbeat contract and failure handling copied.
Every rank of a mesh must run the same device calls in the same order,
because the collectives inside them rendezvous across ranks. A serving
engine decides its calls from request timing, so followers decide
nothing: the leader's engine thread publishes each device call it makes
(``TorchEngine._call``: the call kind and its host arguments; device
state is chained locally on every rank by construction) and followers
replay exactly that sequence against their own shards. Sampled tokens
are gathered to every rank (parallel/collectives.py), so the leader
serves every client from its own copy.

Cluster liveness:
- The leader's broadcaster sends a small ``hb`` frame every
  ``SPMD_HB_INTERVAL_S`` (default 2 s) even when no device calls are
  being published, so a dead follower socket is discovered by a failed
  send within a couple of intervals.
- A follower applies ``SPMD_HB_TIMEOUT_S`` (default 8 s) as a recv
  deadline: a leader that stops publishing (crashed, hung, partitioned)
  surfaces as a ConnectionError within the deadline, not a forever-
  blocked recv.
- A dead follower is **fatal for the cluster**: its shards stop
  advancing, so per-rank state can no longer stay identical. The
  broadcaster sends an ``abort`` frame to the survivors, marks itself
  dead (``spmd_cluster_dead`` event), and every later publish raises —
  the engine thread crashes through its ordinary terminal-event path and
  the launcher shuts the gateway down for a cluster restart.

Scope and limits (stated, not hidden):
- The wire format is pickle over a loopback/trusted-network TCP socket
  (cluster-internal, like a collective backend's own plane); do not
  expose it publicly.
- Supervised in-place engine restart is leader-local state surgery and
  is not replicated; multi-rank recovery is a cluster restart.
"""

from __future__ import annotations

import pickle
import queue
import socket
import struct
import threading
import time
from typing import Any

from fasttalk_tpu_torch.resilience import failpoints as _fp
# Env fallbacks are for standalone/test construction only — the
# launcher passes the VALIDATED Config values (spmd_hb_interval_s /
# spmd_hb_timeout_s) explicitly, which is the production path.
from fasttalk_tpu_torch.utils.config import _env_float
from fasttalk_tpu_torch.utils.logger import get_logger

log = get_logger("parallel.spmd_serving")

# The device calls a leader publishes (TorchEngine ``_dc_<kind>``), the
# JAX package's kinds.
CALL_KINDS = frozenset({"decode", "spec", "batched_prefill", "prefill",
                        "ring_prefill", "sample_place", "prefix_copy",
                        "patch", "hist_patch"})

_LEN = struct.Struct("!I")


def _send(conn: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(_LEN.pack(len(payload)) + payload)


def _recv(conn: socket.socket, deadline_s: float | None = None) -> Any:
    """Read one frame. ``deadline_s`` bounds how long we wait for the
    FIRST byte (and each subsequent chunk): with leader heartbeats on
    the wire, a silent peer past the deadline is a dead peer — surface
    a ConnectionError now instead of blocking until some collective
    times out."""
    if _fp.enabled:
        _fp.fire("spmd.recv", exc=ConnectionError)
    # Unconditional: deadline_s=None must mean a BLOCKING recv even on
    # a socket still carrying a connect-time timeout
    # (socket.create_connection(timeout=...) lingers otherwise).
    conn.settimeout(deadline_s)
    try:
        head = b""
        while len(head) < _LEN.size:
            chunk = conn.recv(_LEN.size - len(head))
            if not chunk:
                raise ConnectionError("spmd_serving: peer closed")
            head += chunk
        (n,) = _LEN.unpack(head)
        buf = bytearray()
        while len(buf) < n:
            chunk = conn.recv(min(1 << 20, n - len(buf)))
            if not chunk:
                raise ConnectionError(
                    "spmd_serving: peer closed mid-frame")
            buf += chunk
        return pickle.loads(bytes(buf))
    except (socket.timeout, TimeoutError) as e:
        # deadline_s can only be None here via an exotic caller-set
        # socket timeout; format defensively so the diagnostic is
        # never masked by a TypeError in its own handler.
        within = f"{deadline_s:.1f}s" if deadline_s else "the deadline"
        raise ConnectionError(
            f"spmd_serving: no frame from peer within {within} "
            "(heartbeat deadline) — peer presumed dead") from e


class CallBroadcaster:
    """Leader side: accepts follower connections, then fans every
    engine device-call descriptor out to all of them.

    Attached to the engine as ``engine.call_sink``; the engine thread
    only ENQUEUES — a dedicated sender thread serializes and writes,
    so a stalled follower's TCP window never back-pressures the
    dispatch path, and frame order (including abort-before-dispatch)
    is preserved by the single queue. A heartbeat thread keeps frames
    on the wire while the engine is idle, so follower death is
    detected by a failed send within ~2 heartbeat intervals. A
    follower whose socket errors is **fatal for the cluster**
    (module-scope liveness note): the survivors get an abort frame,
    ``dead_reason`` is set, and every later publish raises.
    ``close()`` may be called from any thread; it flushes the queue,
    sends the stop frame, and joins the sender."""

    def __init__(self, host: str, port: int, n_followers: int,
                 accept_timeout_s: float = 300.0,
                 hb_interval_s: float | None = None):
        self.hb_interval_s = (hb_interval_s if hb_interval_s is not None
                              else _env_float("SPMD_HB_INTERVAL_S", 2.0))
        self.dead_reason: str | None = None
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(accept_timeout_s)
        self._closed = False
        self._conns: list[socket.socket] = []
        log.info(f"spmd leader waiting for {n_followers} follower(s) "
                 f"on {host}:{port}")
        for i in range(n_followers):
            try:
                conn, addr = self._srv.accept()
            except TimeoutError:
                self._srv.close()
                raise TimeoutError(
                    f"spmd_serving: follower {i + 1}/{n_followers} did "
                    f"not connect within {accept_timeout_s:.0f}s — is "
                    "the follower process up and pointed at "
                    f"{host}:{port}?") from None
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            # Send timeout: a HUNG follower (SIGSTOP, wedged device
            # call) fills its TCP window without ever closing the
            # socket — sendall would block _pump forever and the
            # liveness hole would be back for the hang class. A
            # stalled send past this bound raises socket.timeout
            # (an OSError), which _pump turns into _fatal.
            conn.settimeout(max(30.0, 5.0 * self.hb_interval_s))
            self._conns.append(conn)
            log.info(f"spmd follower connected from {addr}")
        self._q: queue.Queue = queue.Queue()
        # First frame on the wire: the leader's heartbeat contract.
        # The INTERVAL is a leader-side setting — followers must not
        # guess it from their own env (a leader with the beacon off
        # and a follower holding the default deadline would declare a
        # healthy idle cluster dead).
        self._q.put(("hello", {"hb_interval_s": self.hb_interval_s}))
        self._sender = threading.Thread(target=self._pump,
                                        name="spmd-sender", daemon=True)
        self._sender.start()
        self._hb = threading.Thread(target=self._heartbeat,
                                    name="spmd-hb", daemon=True)
        self._hb.start()

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def _heartbeat(self) -> None:
        """Leader liveness beacon: one tiny frame per interval,
        regardless of engine activity. Followers skip it; its real job
        is keeping the TCP stream active so a dead follower trips a
        send error promptly (and giving followers a frame to apply
        their recv deadline against)."""
        if self.hb_interval_s <= 0:
            return
        while not self._closed and self.dead_reason is None:
            time.sleep(self.hb_interval_s)
            if self._closed or self.dead_reason is not None:
                return
            self._q.put(("hb", {}))

    def _pump(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self.dead_reason is not None:
                continue  # drain post-fatal enqueues silently
            payload = pickle.dumps(item,
                                   protocol=pickle.HIGHEST_PROTOCOL)
            frame = _LEN.pack(len(payload)) + payload
            for conn in list(self._conns):
                try:
                    if _fp.enabled:
                        _fp.fire("spmd.send", exc=OSError)
                    conn.sendall(frame)
                except OSError as e:
                    # A lost follower's shards stop advancing, so
                    # per-host device state can no longer be identical:
                    # the CLUSTER is dead, not just that socket
                    # (replaying further calls against the survivors
                    # would serve a corrupted cluster until a
                    # collective eventually hung — the exact liveness
                    # hole this closes, VERDICT item 7).
                    self._fatal(f"follower send failed: {e}")
                    break

    def _fatal(self, reason: str) -> None:
        """Mark the cluster dead: abort the surviving followers, close
        every socket, and make later publishes raise (the engine
        thread then crashes through its terminal-event path and the
        launcher shuts the gateway down for a cluster restart). The event
        is in the log before ``dead_reason`` is set, so whoever sees the
        cluster dead finds its ``spmd_cluster_dead`` event."""
        log.critical(f"spmd cluster dead: {reason}; aborting followers "
                     "and refusing further publishes")
        try:
            from fasttalk_tpu_torch.observability.events import get_events

            get_events().emit("spmd_cluster_dead", severity="critical",
                              reason=reason)
        except Exception:
            pass
        self.dead_reason = reason
        abort = pickle.dumps(("abort", {"reason": reason}),
                             protocol=pickle.HIGHEST_PROTOCOL)
        frame = _LEN.pack(len(abort)) + abort
        for conn in self._conns:
            try:
                conn.sendall(frame)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self._conns.clear()

    def __call__(self, kind: str, payload: dict) -> None:
        if self._closed:
            raise RuntimeError("spmd_serving: publish after close()")
        if self.dead_reason is not None:
            raise RuntimeError(
                f"spmd_serving: cluster is dead ({self.dead_reason}); "
                "restart the cluster")
        self._q.put((kind, payload))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._q.put(("stop", {}))
        self._q.put(None)
        self._sender.join(timeout=30)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        self._srv.close()


def follower_loop(engine, host: str, port: int,
                  connect_timeout_s: float = 300.0,
                  hb_timeout_s: float | None = None) -> int:
    """Follower side: connect to the leader and replay its device-call
    stream against this process's engine (same construction, same
    seed, never ``start()``ed — the leader's engine thread is the only
    decision-maker in the cluster): each frame runs the engine's
    ``_dc_<kind>`` with the leader's arguments. Returns the number of
    calls replayed. Blocks until the leader sends "stop".

    ``hb_timeout_s`` (default ``SPMD_HB_TIMEOUT_S``, 8 s) is the recv
    deadline: the leader heartbeats every SPMD_HB_INTERVAL_S, so a
    silent leader past the deadline is dead — the follower raises a
    ConnectionError and exits for a cluster restart instead of
    blocking in recv until a collective times out.

    The connect retries: leader and follower build their engines
    concurrently (the builds rendezvous on collectives), and the
    leader binds its broadcast socket only after ITS build returns —
    a follower that gets there first must wait, not die."""
    if hb_timeout_s is None:
        hb_timeout_s = _env_float("SPMD_HB_TIMEOUT_S", 8.0)
    deadline = time.monotonic() + connect_timeout_s
    while True:
        try:
            conn = socket.create_connection((host, port), timeout=10)
            break
        except (ConnectionRefusedError, socket.timeout, OSError):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"spmd_serving: leader at {host}:{port} not "
                    f"accepting within {connect_timeout_s:.0f}s")
            time.sleep(0.5)
    conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    n = 0
    first = True
    while True:
        # The FIRST frame gets no heartbeat deadline: the leader's
        # broadcaster (and therefore its beacon) only starts after ALL
        # followers have connected, and a sibling may lawfully take up
        # to the leader's accept timeout to arrive — only once frames
        # are flowing does silence mean death.
        kind, p = _recv(conn,
                        deadline_s=None if first
                        else (hb_timeout_s or None))
        first = False
        if kind == "hello":
            # The leader's heartbeat contract (authoritative — each
            # side's env may lawfully differ): beacon OFF means no
            # heartbeats will ever satisfy a deadline, so disable
            # ours; beacon slower than our deadline would declare a
            # healthy idle leader dead, so clamp the deadline to
            # comfortably exceed the advertised interval.
            interval = float(p.get("hb_interval_s", 0.0) or 0.0)
            if interval <= 0:
                hb_timeout_s = 0.0
            elif hb_timeout_s:
                hb_timeout_s = max(hb_timeout_s, 2.5 * interval)
            continue
        if kind == "hb":
            continue  # leader liveness beacon, not a call
        if kind == "stop":
            conn.close()
            log.info(f"spmd follower replayed {n} calls")
            return n
        if kind == "abort":
            # The leader hit a dispatch error AFTER publishing a call:
            # per-host device state can no longer be assumed identical.
            # Fail loudly; multi-host recovery is a cluster restart
            # (module scope note).
            conn.close()
            raise RuntimeError(
                f"spmd_serving: leader aborted the cluster after a "
                f"dispatch error: {p.get('reason')!r}")
        if kind not in CALL_KINDS:
            raise ValueError(f"spmd_serving: unknown call {kind!r}")
        n += 1
        # The engine's replayable device call of that kind, with the
        # leader's host arguments: the same work on this rank's shards,
        # meeting the leader's collectives in the same order.
        getattr(engine, f"_dc_{kind}")(**p)
