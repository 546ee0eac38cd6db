"""Device<->host KV movement for the session offload tier.

The counterpart of ``fasttalk_tpu/kvcache/offload.py`` for PyTorch on a
CUDA stream. Two halves:

- **Tensor copy functions.** ``kv_slice`` / ``paged_kv_slice`` take a
  *device snapshot* of one slot's leading rows (fresh tensors, enqueued on
  the current stream: every later write to the cache, the evicting
  admission's prefill included, is ordered after it), and ``kv_restore`` /
  ``paged_kv_restore`` write stored rows back into a slot. The JAX package
  jits one executable per power-of-two bucket (``make_kv_slice_fn`` :43,
  ``make_kv_restore_fn`` :73, the paged pair :123, :148); PyTorch has no
  executable family to bound, so one function serves every length. A
  paged restore writes only the rows of the blocks the allocator gave the
  slot: there is no dropped out-of-range scatter on CUDA.

- **The copy thread** (``KVOffloader``). The engine thread only snapshots
  on the device and records an event; the copy thread enqueues the copy
  into pinned host memory on a side stream that waits for that event,
  waits for the copy's own event, builds the pool entry and feeds the
  copy's CUDA-event time into the policy's bandwidth EMA. ``prestage``
  uploads a parked entry's rows on the same side stream while its
  follow-up request waits in the admission queue; the restore's stream
  waits for the upload's event.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any

import torch

from fasttalk_tpu_torch.kvcache.hostpool import HostKVPool, ParkedKV
from fasttalk_tpu_torch.kvcache.policy import RestorePolicy
from fasttalk_tpu_torch.resilience import failpoints as _fp
from fasttalk_tpu_torch.utils.logger import get_logger
from fasttalk_tpu_torch.utils.metrics import get_metrics

log = get_logger("kvcache.offload")

Rows = list  # [k, v] or [k, v, k_scale, v_scale] row tensors


def kv_bucket(n: int, max_len: int) -> int:
    """Smallest power of two (min 16) covering ``n``, capped at the cache
    length: the rows a dense park stores (the JAX package's bucket, so an
    entry holds the same bytes)."""
    b = 16
    while b < n:
        b <<= 1
    return min(b, max_len)


def kv_slice(cache, slot: int, rows: int) -> Rows:
    """Device snapshot of one dense slot's leading ``rows`` rows:
    [L, rows, Kv, H] clones of k and v (+ [L, rows, G] scales on the int8
    tier). A clone, not a view: the slot's rows are overwritten by the
    next occupant while the host copy may still be pending."""
    return [x[:, slot, :rows].clone() for x in cache if x is not None]


def paged_kv_slice(cache, read_idx: torch.Tensor) -> Rows:
    """Device snapshot of the pool rows ``read_idx`` (a slot's logical
    rows through its block table): the gather makes fresh tensors."""
    return [x[:, read_idx] for x in cache if x is not None]


def kv_restore(cache, rows: Rows, slot: int) -> None:
    """Write device rows [L, n, ...] into one dense slot's rows 0..n."""
    for part, r in zip((x for x in cache if x is not None), rows):
        part[:, slot, :r.shape[1]] = r


def paged_kv_restore(cache, rows: Rows, write_idx: torch.Tensor) -> None:
    """Write the leading ``len(write_idx)`` device rows into those pool
    rows (the blocks ``ensure`` allocated for the restored prefix)."""
    n = write_idx.shape[0]
    for part, r in zip((x for x in cache if x is not None), rows):
        part[:, write_idx] = r[:, :n]


def host_copy(rows: Rows, ready: Any, stream: Any) -> tuple[Rows, float]:
    """Copy device row tensors into pinned host memory and wait for them.
    On CUDA the copies run on ``stream`` after the ``ready`` event (the
    snapshot) and are timed by CUDA events; on the CPU they are clones,
    timed by the host clock. Returns the host tensors and the seconds the
    copy took. The caller holds ``rows`` until this returns, so the device
    memory cannot be reused while the copy reads it."""
    if rows[0].is_cuda:
        # Pinned buffers first: the timed window holds the copies only.
        host = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True)
                for r in rows]
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for h, r in zip(host, rows):
                h.copy_(r, non_blocking=True)
            end.record(stream)
        end.synchronize()
        return host, start.elapsed_time(end) / 1000.0
    t0 = time.perf_counter()
    host = [r.clone() for r in rows]
    return host, time.perf_counter() - t0


def entry_rows(entry: ParkedKV) -> Rows:
    """The host row tensors of an entry, scales last (int8 tier)."""
    rows = [entry.k, entry.v]
    if entry.k_scale is not None:
        rows += [entry.k_scale, entry.v_scale]
    return rows


def upload(entry: ParkedKV, device: torch.device) -> Rows:
    """An entry's rows on the device, for a restore on the current
    stream: the prestaged copies (the stream waits for their upload and
    marks them used by itself), else an asynchronous copy from the pinned
    host tensors. The caching host allocator keeps a pinned block from
    reuse until the copies that read it have completed, so the entry may
    be dropped right after."""
    if entry.k_dev is not None and entry.v_dev is not None:
        # The prestage sets the event and the scales before k_dev/v_dev.
        staged = [entry.k_dev, entry.v_dev]
        if entry.k_scale is not None:
            staged += [entry.k_scale_dev, entry.v_scale_dev]
        if entry.staged_event is not None:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(entry.staged_event)
            for t in staged:
                t.record_stream(stream)
        return staged
    return [h.to(device, non_blocking=True) for h in entry_rows(entry)]


class KVOffloader:
    """Dedicated copy thread: device-to-host park copies and host-to-device
    prestaging, on one side stream."""

    def __init__(self, pool: HostKVPool, policy: RestorePolicy,
                 device: torch.device):
        self.pool = pool
        self.policy = policy
        self.device = device
        self._stream = None           # the side stream, made at first use
        self._jobs: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._closed = False
        # Sessions with a park copy in flight: dedupes the idle-park tick
        # (and eviction re-parks) while the copy thread lags.
        self._parking_lock = threading.Lock()
        self._parking: set[str] = set()
        self.failed_parks = 0         # park jobs that raised
        m = get_metrics()
        self._m_offload = m.histogram(
            "kv_offload_ms",
            "device→host snapshot latency per parked session (dispatch "
            "to host copy landed)",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000, 4000))
        self._m_restore = m.histogram(
            "kv_restore_ms",
            "host→device restore dispatch latency per admission",
            buckets=(0.5, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1000))

    # ---------------- thread plumbing ----------------

    def _side_stream(self):
        if self._stream is None and self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="kv-offload", daemon=True)
            self._thread.start()

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:
                return
            try:
                job()
            except Exception as e:  # the copy thread must never die
                log.error(f"kv offload job failed: {e}", exc_info=True)

    def submit(self, job) -> None:
        if self._closed:
            return
        self._ensure_thread()
        self._jobs.put(job)

    def shutdown(self) -> None:
        self._closed = True
        if self._thread is not None and self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join(timeout=5)

    # ---------------- park (D2H) ----------------

    def parking(self, session_id: str) -> bool:
        """True while a park copy for this session is in flight."""
        with self._parking_lock:
            return session_id in self._parking

    def park(self, session_id: str, tokens: list[int], kept: int,
             bucket: int, rows: Rows, t0: float) -> None:
        """Finish a park off the engine thread. ``rows``: the device
        snapshot (``kv_slice`` / ``paged_kv_slice``, already enqueued on
        the engine's stream); an event recorded here marks it. The copy
        thread copies it into pinned host memory, inserts the entry into
        the pool and feeds the copy's bandwidth to the policy. A second
        park for a session whose copy is still in flight is dropped (the
        caller re-checks ``parked_len`` later). ``bucket``: the JAX
        package's restore shape, recorded on the entry; ``nbytes`` counts
        the stored rows (int8 rows plus their scale rows on that tier)."""
        with self._parking_lock:
            if session_id in self._parking:
                return
            self._parking.add(session_id)
        ready = None
        if rows[0].is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        stream = self._side_stream()

        def job() -> None:
            try:
                if _fp.enabled:
                    # Chaos seam: a failed copy loses only this snapshot
                    # (the entry is never inserted), never the engine.
                    _fp.fire("kv.park.copy", session_id=session_id)
                host, seconds = host_copy(rows, ready, stream)
                t1 = time.monotonic()
                k, v = host[0], host[1]
                ks, vs = (host[2], host[3]) if len(host) == 4 else (None,
                                                                     None)
                nbytes = sum(h.numel() * h.element_size() for h in host)
                entry = ParkedKV(session_id=session_id, tokens=tokens,
                                 kept=kept, bucket=bucket, k=k, v=v,
                                 k_scale=ks, v_scale=vs, nbytes=nbytes)
                if self.pool.put(entry):
                    self.policy.note_copy(entry.nbytes, max(seconds, 1e-6))
                    self._m_offload.observe(max(t1 - t0, 1e-6) * 1000.0)
            except Exception:
                self.failed_parks += 1
                raise
            finally:
                with self._parking_lock:
                    self._parking.discard(session_id)

        self.submit(job)
        if self._closed:
            # submit dropped the job (shutdown won): release the in-flight
            # mark it would have cleared.
            with self._parking_lock:
                self._parking.discard(session_id)

    # ---------------- prestage (H2D, best-effort) ----------------

    # Prestaged rows (host-pool bytes duplicated on the device awaiting
    # their restore) may hold at most this fraction of the pool budget.
    _PRESTAGE_FRACTION = 0.25

    def prestage(self, session_id: str) -> None:
        """Upload a parked entry's rows to the device on the side stream
        while its follow-up request waits in the admission queue.
        Best-effort: a miss (no entry, the entry consumed or evicted first,
        the staged-bytes cap reached) costs nothing; the restore then
        copies from the pinned host rows itself."""
        def job() -> None:
            if _fp.enabled:
                _fp.fire("kv.prestage.copy", session_id=session_id)
            entry = self.pool.get(session_id)
            if entry is None or entry.k_dev is not None:
                return
            cap = self.pool.budget_bytes * self._PRESTAGE_FRACTION
            if self.pool.staged_bytes() + entry.nbytes > cap:
                return
            stream = self._side_stream()
            if stream is None:
                dev = [h.to(self.device) for h in entry_rows(entry)]
            else:
                with torch.cuda.stream(stream):
                    dev = [h.to(self.device, non_blocking=True)
                           for h in entry_rows(entry)]
                    done = torch.cuda.Event()
                    done.record(stream)
                entry.staged_event = done
            if entry.k_scale is not None:
                # Scales stage with their rows, and before k_dev/v_dev: the
                # restore's staged check keys on those.
                entry.k_scale_dev, entry.v_scale_dev = dev[2], dev[3]
            entry.staged_nbytes = entry.nbytes
            # Single assignments (the interpreter lock makes each atomic);
            # the restore sees both or treats the entry as unstaged.
            entry.k_dev = dev[0]
            entry.v_dev = dev[1]

        self.submit(job)

    def note_restore(self, seconds: float) -> None:
        self._m_restore.observe(seconds * 1000.0)
