"""Int4 weight-only decode matmul: the hand-written CUDA kernel and its
plain version.

Source notes (the kernel is ``csrc/int4_matmul.cu``, with the mma,
conversion and copy pieces of ``csrc/mma_bf16.cuh``; the fragment mapping
is written out in ``ops/mma_layout.py``):

- ``int4_matmul`` replaces ``fasttalk_tpu/ops/pallas_int8.py::int4_matmul``
  (:242, body ``_mm4_kernel`` :208): ``y[M,N] = x[M,K] @ W`` with
  ``W[k, n] = bf16(q[k, n] * bf16(s[k / G, n]))``, where ``q`` are the
  sign-extended nibbles of ``q4[K/2, N]`` (row 2j the low nibble of packed
  row j, row 2j+1 the high one); f32 accumulation and one cast to x's
  dtype, no scale after the dot (the group scale varies along K). It runs
  the seven per-layer matmuls of a decode step under ``WEIGHT_QUANT=int4``
  (112 launches per step for Llama-3.2-1B). Bound: the packed bytes plus
  the f32 group scales (0.517 GB per Llama-3.2-1B decode step at M = 16,
  0.161 ms at 3.35 TB/s). Design: ``int8_matmul``'s with nibbles in place
  of bytes: bf16 ``mma.sync`` m16n8k16 with f32 accumulators, a packed
  byte is exactly the mma's k pair of one column (B register), converted
  exactly on chip and scaled by one bf16x2 multiply (the one rounding of
  the TPU kernel); 128-column x split-K blocks whose (at most 16) splits
  sum in split order through a thread block cluster's distributed shared
  memory: one launch a call, no workspace, the same bits on every call.

Dispatch rule: a CPU tensor runs the plain version (the CPU tests hold it
against the JAX kernel); a CUDA tensor launches the kernel or raises.
There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from fasttalk_tpu_torch.ops import _build
from fasttalk_tpu_torch.ops.cuda_int8 import _cdiv, _sm_count, _split_rows
from fasttalk_tpu_torch.quantization.int4 import unpack_int4

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: ctypes.CDLL | None = None

_COLS = 128            # columns of a block
_K_STAGE = 128         # weight rows of one ring stage (64 packed rows)
_M_TILE = 64           # x rows one block covers (4 m16 tiles)


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("int4_matmul")
        lib.ft_int4_matmul.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                       _P]
        lib.ft_int4_matmul.restype = _I
        _lib_handle = lib
    return _lib_handle


def _group(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> int:
    """The scale group G of a call; raises on shapes the kernel does not
    take (odd K, G not dividing K, odd G)."""
    if x.dim() != 2 or q4.dim() != 2 or s.dim() != 2 \
            or s.shape[1] != q4.shape[1]:
        raise ValueError(f"int4_matmul: bad shapes x{tuple(x.shape)} "
                         f"q4{tuple(q4.shape)} s{tuple(s.shape)}")
    k = x.shape[1]
    if k != 2 * q4.shape[0]:
        raise ValueError(f"int4_matmul: x has K={k} columns but q4 packs "
                         f"{2 * q4.shape[0]} rows (K must be even and equal "
                         "twice q4's rows)")
    groups = s.shape[0]
    if groups <= 0 or k % groups or (k // groups) % 2:
        raise ValueError(f"int4_matmul: {groups} scale groups do not split "
                         f"K={k} into even groups")
    return k // groups


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor,
                      s: torch.Tensor) -> torch.Tensor:
    """Plain version: the kernel's arithmetic in PyTorch. The weight is
    ``q * s`` rounded once to x's dtype (the scale first cast to it), the
    product accumulates in f32 and is cast to x's dtype once."""
    group = _group(x, q4, s)
    sx = s.to(x.dtype).to(torch.float32).repeat_interleave(group, 0)
    w = (unpack_int4(q4).to(torch.float32) * sx).to(x.dtype)
    return (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)


def int4_matmul(x: torch.Tensor, q4: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """x [M, K] @ dequant(q4 [K/2, N] uint8, s [K/G, N] f32) -> [M, N]."""
    group = _group(x, q4, s)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4, s)
    if not (x.is_cuda and q4.is_cuda and s.is_cuda):
        raise ValueError("int4_matmul: x, q4 and s must all be CUDA tensors")
    if not (x.device == q4.device == s.device):
        raise ValueError("int4_matmul: x, q4 and s are on different devices")
    if x.dtype != torch.bfloat16 or q4.dtype != torch.uint8 \
            or s.dtype != torch.float32:
        raise ValueError(f"int4_matmul: expects x bfloat16, q4 uint8, s "
                         f"float32; got {x.dtype}, {q4.dtype}, {s.dtype}")
    if not (x.is_contiguous() and q4.is_contiguous() and s.is_contiguous()):
        raise ValueError("int4_matmul: x, q4 and s must be contiguous")
    m, k = x.shape
    n = q4.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    tiles = _cdiv(n, _COLS) * _cdiv(m, _M_TILE)
    k_per_split = _split_rows(k, tiles, _sm_count(x.device), _K_STAGE)
    err = _lib().ft_int4_matmul(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(), m, k, n,
        group, k_per_split, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "int4_matmul")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0
