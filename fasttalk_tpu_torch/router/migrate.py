"""Cross-replica KV migration: move a parked session's host-KV entry
between replica pools so failover, drain and rebalancing RESTORE
instead of re-prefilling the transcript (docs/ROUTER.md).

The port's counterpart of ``fasttalk_tpu/router/migrate.py``, for
entries that hold torch tensors. The channel is deliberately dumb: one
parked entry (block-trimmed int8/bf16 rows + scales + token ids,
exactly what ``HostKVPool`` holds) moves from the source replica's pool
to the target's. In-proc replicas hand the entry over directly (the
target's ``import_parked_kv`` copies the rows into pinned tensors of its
own); remote replicas ship the ``serialize_parked`` wire form through
the serving port's ``/kv/parked/{session_id}`` endpoints. Either way
the transfer is bracketed by the ``router.migrate_send`` /
``router.migrate_recv`` failpoints and validated before insertion:

- a migration that fails (or corrupts) mid-transfer leaves byte
  accounting EXACT on both pools — the source entry is untouched until
  the target confirmed the import, and the target's ``put`` is atomic;
- a hung migration never wedges the caller — the router runs the
  transfer on a disposable worker thread bounded by
  ``ROUTER_MIGRATE_TIMEOUT_S`` and falls back to re-prefill.

Wire format (byte for byte the JAX package's, so a JAX replica and a
port replica exchange entries): a JSON header (length-prefixed)
carrying the entry metadata + dtype/shape descriptors, followed by the
raw array bytes in declaration order. No pickle anywhere. A bfloat16
array travels as its 2-byte patterns under the dtype name
``bfloat16`` (no ``ml_dtypes`` needed: the port reads and writes them
through an int16 view).
"""

from __future__ import annotations

import json
import struct
import time
from dataclasses import replace
from typing import Any

import numpy as np
import torch

from fasttalk_tpu_torch.kvcache.hostpool import (ParkedKV, entry_problem,
                                                 strip_device)
from fasttalk_tpu_torch.utils.logger import get_logger

__all__ = ["serialize_parked", "deserialize_parked", "transfer",
           "entry_problem", "strip_device"]

log = get_logger("router.migrate")

_MAGIC = b"FTKV1"
_ARRAYS = ("k", "v", "k_scale", "v_scale")
# Wire dtype names and their torch types; bfloat16 crosses as int16 bits.
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8,
           "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64}


def _wire_array(arr: Any) -> tuple[str, np.ndarray]:
    """(dtype name, contiguous numpy array of the bytes) of a host row
    array: a CPU torch tensor (bf16 through its int16 view) or a numpy
    array."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        return str(t.dtype).removeprefix("torch."), t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr.dtype.name, arr


# ---------------- wire form (remote replicas) ----------------

def serialize_parked(entry: ParkedKV) -> bytes:
    """Entry → bytes: MAGIC + u32 header length + JSON header + raw
    array bytes in ``_ARRAYS`` order."""
    header: dict[str, Any] = {
        "session_id": entry.session_id,
        "tokens": list(entry.tokens),
        "kept": entry.kept,
        "bucket": entry.bucket,
        "nbytes": entry.nbytes,
        "arrays": {},
    }
    blobs: list[bytes] = []
    for name in _ARRAYS:
        arr = getattr(entry, name)
        if arr is None:
            continue
        dtype, data = _wire_array(arr)
        header["arrays"][name] = {"dtype": dtype,
                                  "shape": list(data.shape)}
        blobs.append(data.tobytes())
    hdr = json.dumps(header).encode()
    return b"".join([_MAGIC, struct.pack("<I", len(hdr)), hdr, *blobs])


def deserialize_parked(data: bytes) -> ParkedKV:
    """bytes → entry of CPU torch tensors (not pinned: the importing
    engine copies them into its own pinned rows). Raises ValueError on
    anything malformed — callers treat that exactly like a corrupt
    transfer (refused, accounting untouched)."""
    if len(data) < len(_MAGIC) + 4 or not data.startswith(_MAGIC):
        raise ValueError("not a serialized parked-KV entry")
    off = len(_MAGIC)
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    try:
        header = json.loads(data[off:off + hlen].decode())
    except Exception as e:
        raise ValueError(f"bad migration header: {e}") from e
    off += hlen
    arrays: dict[str, Any] = {}
    for name in _ARRAYS:
        arr_descs = header.get("arrays") if isinstance(header, dict) \
            else None
        desc = arr_descs.get(name) if isinstance(arr_descs, dict) \
            else None
        if desc is None:
            arrays[name] = None
            continue
        if not isinstance(desc, dict) or "dtype" not in desc \
                or "shape" not in desc:
            raise ValueError(f"malformed descriptor for array {name}")
        dtype = _DTYPES.get(desc["dtype"]) \
            if isinstance(desc["dtype"], str) else None
        if dtype is None:
            raise ValueError(f"unknown dtype {desc['dtype']!r} in "
                             "migration header")
        try:
            shape = tuple(int(s) for s in desc["shape"])
        except (TypeError, ValueError) as e:
            raise ValueError(f"malformed shape for array {name}") from e
        if any(s < 0 for s in shape):
            raise ValueError(f"malformed shape for array {name}")
        itemsize = torch.empty((), dtype=dtype).element_size()
        n = int(np.prod(shape, dtype=np.int64)) * itemsize
        if off + n > len(data):
            raise ValueError(f"truncated array {name}")
        raw = torch.frombuffer(bytearray(data[off:off + n]),
                               dtype=torch.uint8) if n else \
            torch.empty((0,), dtype=torch.uint8)
        arrays[name] = raw.view(dtype).reshape(shape)
        off += n
    try:
        entry = ParkedKV(
            session_id=str(header["session_id"]),
            tokens=[int(t) for t in header["tokens"]],
            kept=int(header["kept"]), bucket=int(header["bucket"]),
            k=arrays["k"], v=arrays["v"], k_scale=arrays["k_scale"],
            v_scale=arrays["v_scale"], nbytes=int(header["nbytes"]))
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"malformed migration header: {e}") from e
    problem = entry_problem(entry)
    if problem is not None:
        raise ValueError(f"invalid migrated entry: {problem}")
    return entry


# ---------------- the transfer itself ----------------

def transfer(src, dst, session_id: str, traceparent: str | None = None,
             tracer=None,
             request_id: str = "") -> tuple[bool, int, str, int]:
    """Move one parked session's entry ``src`` → ``dst`` (replica
    handles). Returns ``(ok, nbytes, reason, kept)`` — ``kept`` is the
    moved entry's trusted-token count (0 on failure), the identity the
    router's abandoned-worker undo checks before dropping anything. On
    any failure the source entry is left in place (the caller decides
    whether drain semantics then release it) and the target pool is
    untouched.

    Runs on the router's disposable migrate worker thread — both the
    export (remote: an HTTP GET) and the import (remote: an HTTP POST)
    may block; the router bounds the whole call with its timeout.
    ``traceparent`` rides the /kv/parked wire on remote hops; when
    ``tracer`` and ``request_id`` are given, the two legs are recorded
    as ``migrate_send``/``migrate_recv`` spans on the request's trace
    (the caller's ContextVar does not cross into this worker thread, so
    the span plumbing is explicit)."""
    from fasttalk_tpu_torch.resilience import failpoints as _fp

    def span(name: str, t0: float, **attrs) -> None:
        if tracer is not None and request_id and tracer.enabled:
            tracer.add_span(request_id, name, t0, time.monotonic(),
                            session_id=session_id, **attrs)

    t_send = time.monotonic()
    try:
        if _fp.enabled:
            # Chaos seam, source side: a dead/partitioned source looks
            # like an export failure — the fabric must fall back to
            # re-prefill with both pools' accounting intact.
            _fp.fire("router.migrate_send", session_id=session_id,
                     replica=src.replica_id)
        entry = src.export_parked(session_id, traceparent=traceparent)
    except Exception as e:
        span("migrate_send", t_send, replica=src.replica_id, ok=False)
        return False, 0, f"export failed: {e}", 0
    if entry is None:
        span("migrate_send", t_send, replica=src.replica_id, ok=False)
        return False, 0, "no parked entry", 0
    span("migrate_send", t_send, replica=src.replica_id, ok=True,
         nbytes=entry.nbytes)
    t_recv = time.monotonic()
    try:
        if _fp.enabled:
            corrupt = _fp.fire("router.migrate_recv",
                               session_id=session_id,
                               replica=dst.replica_id)
            if corrupt == "corrupt":
                # In-proc corruption: clip the token list so the
                # import validation refuses the entry (the wire form
                # corrupts the same way — a truncated body fails
                # deserialize).
                entry = replace(entry, tokens=entry.tokens[:-1])
        problem = entry_problem(entry)
        if problem is not None:
            span("migrate_recv", t_recv, replica=dst.replica_id,
                 ok=False)
            return False, 0, f"corrupt entry refused: {problem}", 0
        ok = dst.import_parked(entry, traceparent=traceparent)
    except Exception as e:
        span("migrate_recv", t_recv, replica=dst.replica_id, ok=False)
        return False, 0, f"import failed: {e}", 0
    span("migrate_recv", t_recv, replica=dst.replica_id, ok=bool(ok))
    if not ok:
        return False, 0, "target refused the entry", 0
    return True, entry.nbytes, "ok", entry.kept
