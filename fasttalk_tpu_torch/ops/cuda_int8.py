"""Int8 weight-only decode matmuls: hand-written CUDA kernels and their
plain versions.

Source notes (the kernels are ``csrc/int8_matmul.cu``, with the shared
mma, conversion and copy pieces in ``csrc/mma_bf16.cuh``; the fragment
mappings are written out in ``ops/mma_layout.py``):

- ``int8_matmul`` replaces ``fasttalk_tpu/ops/pallas_int8.py::int8_matmul``
  (:89): ``y[M,N] = (x[M,K] @ q[K,N]) * s[N]``, f32 accumulation, the
  scale applied once in f32 and a single cast to x's dtype (or none:
  ``out_dtype=torch.float32`` gives a tensor-parallel shard's unrounded
  partial product, which the sum over ranks rounds once). It runs the
  seven per-layer matmuls of a decode step (112 launches per step for
  Llama-3.2-1B). Bound: the weight bytes (a [2048, 8192] ``w_gate`` is
  16.8 MB, about 5 us at 3.35 TB/s); the multiply-adds run on the bf16
  tensor cores (``mma.sync`` m16n8k16, f32 accumulators) on the int8 tile
  converted exactly on chip. Design: 128-column x split-K blocks, weights
  and x staged through a 4-stage ``cp.async`` ring, a lane's B fragment
  read as one word from each of 4 weight rows (byte c feeds n8 tile c),
  up to 4 m16 tiles per block; the (at most 16) splits of a column tile
  run as one thread block cluster and sum their f32 partial tiles in
  split order through distributed shared memory: one launch a call, no
  workspace or counter, and the same bits every call. Any M, K and N
  (the TPU kernel's 128-row and VMEM gates do not apply).
- ``int8_matmul_t`` replaces ``pallas_int8.py::int8_matmul_t`` (:127):
  ``y[M,V] = x[M,D] @ (q[V,D] * s[V])^T``, the tied-embedding lm_head,
  without materialising the transpose. Bound: the [128256, 2048] int8
  table, 262.7 MB (about 78 us). Design: a block owns 128 vocab rows and
  walks D in 128-byte ``cp.async`` stages; a lane reads 16 contiguous
  bytes of one vocab row (4 k-steps of its B fragment) and, through the
  same k permutation, 16 contiguous bf16 of x; each accumulator is one
  output, scaled by s[v] and stored (no cross-lane reduction).

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

_MM_COLS = 128         # columns of an int8_matmul block
_MM_K_STAGE = 64       # weight rows of one ring stage
_MM_MIN_SPLIT = 128    # weight rows of the shortest split (8 k-steps)
_MM_MAX_SPLITS = 16    # the splits of a column tile form one cluster
_MM_BLOCKS_PER_SM = 2  # split-K aims at this many blocks per SM
_M_TILE = 64           # x rows one block covers (4 m16 tiles)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("int8_matmul")
        lib.ft_int8_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _P]
        lib.ft_int8_matmul.restype = _I
        lib.ft_int8_matmul_t.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _P]
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


def _split_rows(k: int, tiles: int, sms: int,
                stage: int = _MM_K_STAGE) -> int:
    """Weight rows per split of a split-K matmul (``int8_matmul``, and
    ``int4_matmul`` with its 128-row stages): enough splits (at most
    ``_MM_MAX_SPLITS``, a cluster) for about ``_MM_BLOCKS_PER_SM`` blocks
    per SM over ``tiles`` column tiles, each a whole number of ``stage``-row
    ring stages and at least ``_MM_MIN_SPLIT`` rows."""
    splits = min(_MM_MAX_SPLITS, _cdiv(_MM_BLOCKS_PER_SM * sms, tiles))
    per = _cdiv(_cdiv(k, splits), stage) * stage
    return max(_MM_MIN_SPLIT, per)


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


def _out_dtype(x: torch.Tensor, out_dtype: torch.dtype | None,
               what: str) -> torch.dtype:
    out = x.dtype if out_dtype is None else out_dtype
    if out not in (x.dtype, torch.float32):
        raise ValueError(f"{what}: out_dtype must be x's dtype or float32, "
                         f"got {out}")
    return out


def int8_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: x [M, K] @ dequant(q [K, N], s [N]) -> [M, N]."""
    acc = x.to(torch.float32) @ q.to(torch.float32)
    out = _out_dtype(x, out_dtype, "int8_matmul")
    return (acc * s.to(torch.float32)[None, :]).to(out)


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [M, K] @ dequant(q [K, N] int8, s [N]) -> [M, N] in x's dtype, or
    in float32 unrounded (``out_dtype=torch.float32``: a tensor-parallel
    shard's partial product, rounded once after the sum over ranks)."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1 \
            or x.shape[1] != q.shape[0] or s.shape[0] != q.shape[1]:
        raise ValueError(f"int8_matmul: bad shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} s{tuple(s.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, q, s, out_dtype)
    _check_cuda(x, q, s, "int8_matmul")
    m, k = x.shape
    n = q.shape[1]
    out = _out_dtype(x, out_dtype, "int8_matmul")
    y = torch.empty((m, n), dtype=out, device=x.device)
    tiles = _cdiv(n, _MM_COLS) * _cdiv(m, _M_TILE)
    k_per_split = _split_rows(k, tiles, _sm_count(x.device))
    err = _lib().ft_int8_matmul(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, k, n,
        k_per_split, int(out == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul")
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def int8_matmul_t_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                        out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: x [M, D] @ dequant(q [V, D], s [V]).T -> [M, V]."""
    acc = x.to(torch.float32) @ q.to(torch.float32).T
    out = _out_dtype(x, out_dtype, "int8_matmul_t")
    return (acc * s.to(torch.float32)[None, :]).to(out)


def int8_matmul_t(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [M, D] @ dequant(q [V, D] int8, s [V]).T -> [M, V] in x's dtype,
    or in float32 unrounded (``out_dtype``, as ``int8_matmul``'s)."""
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1 \
            or x.shape[1] != q.shape[1] or s.shape[0] != q.shape[0]:
        raise ValueError(f"int8_matmul_t: bad shapes x{tuple(x.shape)} "
                         f"q{tuple(q.shape)} s{tuple(s.shape)}")
    if x.device.type == "cpu":
        return int8_matmul_t_plain(x, q, s, out_dtype)
    _check_cuda(x, q, s, "int8_matmul_t")
    m, d = x.shape
    v = q.shape[0]
    out = _out_dtype(x, out_dtype, "int8_matmul_t")
    y = torch.empty((m, v), dtype=out, device=x.device)
    err = _lib().ft_int8_matmul_t(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), y.data_ptr(), m, d, v,
        int(out == torch.float32),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int8_matmul_t")
    int8_matmul_t.launches += 1
    return y


int8_matmul_t.launches = 0
