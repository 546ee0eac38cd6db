"""Int8 weight-only decode matmuls: hand-written CUDA kernels and their
plain versions.

Source notes (the kernels are ``csrc/int8_matmul.cu``):

- ``int8_matmul`` replaces ``fasttalk_tpu/ops/pallas_int8.py::int8_matmul``
  (:89): ``y[M,N] = (x[M,K] @ q[K,N]) * s[N]``, f32 accumulation, the
  scale applied once in f32 and a single cast to x's dtype. It runs the
  seven per-layer matmuls of a decode step (112 launches per step for
  Llama-3.2-1B). Bound: the weight bytes (a [2048, 8192] ``w_gate`` is
  16.8 MB, about 5 us at 3.35 TB/s). Design: column tiles x split-K blocks
  so even a [2048, 512] weight fills the card, coalesced 4-byte weight
  reads along N, x staged in shared memory, f32 register accumulators,
  each split's partials stored to its own workspace slice and summed in
  split order, scaled and cast by a second small kernel (so the result
  does not depend on block scheduling). Any M, K and N (the TPU kernel's
  128-row and VMEM gates do not apply).
- ``int8_matmul_t`` replaces ``pallas_int8.py::int8_matmul_t`` (:127):
  ``y[M,V] = x[M,D] @ (q[V,D] * s[V])^T``, the tied-embedding lm_head,
  without materialising the transpose. Bound: the [128256, 2048] int8
  table, 262.7 MB (about 78 us); at M=16 its f32 multiply-adds on the
  CUDA cores take longer than the bytes. Design: one block per SM holds x
  in dynamic shared memory as f32; warps stream groups of 32 contiguous
  vocab rows, 4 rows at a time with 16-byte loads (each x value read feeds
  4 rows), and write each group's outputs as one coalesced store per x
  row.

Dispatch rule of every wrapper: a CPU tensor runs the plain version (the
CPU tests hold it against the JAX kernel); a CUDA tensor launches the
kernel or raises. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from fasttalk_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: ctypes.CDLL | None = None
_sm_counts: dict[int, int] = {}

# Shared memory the lm_head kernel may spend on x (f32), under the 227 KB
# a Hopper block can address.
_MT_SMEM_BYTES = 200 * 1024


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("int8_matmul")
        lib.ft_int8_matmul.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.ft_int8_matmul.restype = _I
        lib.ft_int8_matmul_t.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _P]
        lib.ft_int8_matmul_t.restype = _I
        _lib_handle = lib
    return _lib_handle


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _check_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                what: str) -> None:
    if not (x.is_cuda and q.is_cuda and s.is_cuda):
        raise ValueError(f"{what}: x, q and s must all be CUDA tensors")
    if not (x.device == q.device == s.device):
        raise ValueError(f"{what}: x, q and s are on different devices")
    if x.dtype != torch.bfloat16 or q.dtype != torch.int8 \
            or s.dtype != torch.float32:
        raise ValueError(f"{what}: expects x bfloat16, q int8, s float32; "
                         f"got {x.dtype}, {q.dtype}, {s.dtype}")
    if not (x.is_contiguous() and q.is_contiguous() and s.is_contiguous()):
        raise ValueError(f"{what}: x, q and s must be contiguous")


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M, K] @ dequant(q [K, N], s [N]) -> [M, N]."""
    acc = x.to(torch.float32) @ q.to(torch.float32)
    return (acc * s.to(torch.float32)[None, :]).to(x.dtype)


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(q [K, N] int8, s [N]) -> [M, N] (x dtype)."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1 \
            or x.shape[1] != q.shape[0] or s.shape[0] != q.shape[1]:
        raise ValueError(f"int8_matmul: bad shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} s{tuple(s.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s)
    _check_cuda(x, q, s, "int8_matmul")
    m, k = x.shape
    n = q.shape[1]
    col_blocks = _cdiv(n, 256) * _cdiv(m, 16)
    # Split K for about two blocks per SM, but give each split at least 64
    # weight rows: a split reads one byte per row and column and writes
    # 4 * M bytes of partial sums per column, so for the decode batch
    # (M <= 16) from 64 rows on the workspace traffic stays at or under the
    # weight traffic.
    splits = _cdiv(2 * _sm_count(x.device), col_blocks)
    k_per_split = max(64, _cdiv(_cdiv(k, splits), 4) * 4)
    ws = torch.empty((_cdiv(k, k_per_split), m, n), dtype=torch.float32,
                     device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = _lib().ft_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), ws.data_ptr(), y.data_ptr(),
        m, k, n, k_per_split, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def int8_matmul_t_plain(x: torch.Tensor, q: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """Plain version: x [M, D] @ dequant(q [V, D], s [V]).T -> [M, V]."""
    acc = x.to(torch.float32) @ q.to(torch.float32).T
    return (acc * s.to(torch.float32)[None, :]).to(x.dtype)


def int8_matmul_t(x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """x [M, D] @ dequant(q [V, D] int8, s [V]).T -> [M, V] (x dtype)."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1 \
            or x.shape[1] != q.shape[1] or s.shape[0] != q.shape[0]:
        raise ValueError(f"int8_matmul_t: bad shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} s{tuple(s.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_t_plain(x, q, s)
    _check_cuda(x, q, s, "int8_matmul_t")
    m, d = x.shape
    v = q.shape[0]
    if d % 16 == 0 and q.data_ptr() % 16:
        raise ValueError("int8_matmul_t: q must be 16-byte aligned")
    m_tile = next((t for t in (16, 8, 4, 2, 1)
                   if t * d * 4 <= _MT_SMEM_BYTES), None)
    if m_tile is None:
        raise ValueError(f"int8_matmul_t: D={d} exceeds shared memory")
    m_tile = min(m_tile, m)
    y = torch.empty((m, v), dtype=x.dtype, device=x.device)
    err = _lib().ft_int8_matmul_t(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, d, v,
        m_tile, _sm_count(x.device),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul_t")
    int8_matmul_t.launches += 1
    return y


int8_matmul_t.launches = 0
