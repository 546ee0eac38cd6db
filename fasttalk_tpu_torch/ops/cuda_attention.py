"""Decode attention over the dense KV cache: hand-written CUDA kernel and
its plain version.

Source note (the kernel is ``csrc/decode_attention.cu``): ``decode_attend``
replaces ``fasttalk_tpu/ops/pallas_attention.py::decode_attend`` (:153),
bf16 K/V tier, any T >= 1. GQA attention of a short query block against
the cache with per-slot ``lengths`` (keys visible to the block's last
query; query t sees ``length - (T - 1) + t`` keys), online softmax in
f32. In the port it IS the decode attention (the JAX package gates its
kernel behind TPU_USE_PALLAS_ATTENTION). Bound: the bytes of each slot's
live K/V prefix, 32 KiB per key position per layer across 16 slots of
Llama-3.2-1B. Design: one block per (KV head, slot) holding the head's
T*G query rows; the key loop stops at the slot's live length (the TPU
kernel's block-revisit pruning becomes a loop bound); 8 warps take 32-key
tiles, lane = key for the scores and lane = head-dim element for P @ V;
warp states merge once at the end. The int8-scale variant of the TPU
kernel belongs to the int8-KV slice and is not ported here.

Dispatch rule: a CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fasttalk_tpu_torch.ops import _build

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib_handle: ctypes.CDLL | None = None
_NEG_INF = -1e30
MAX_ROWS = 16   # T * G query rows per (slot, KV head) the kernel holds
MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("decode_attention")
        lib.ft_decode_attend.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                         _I, _I, ctypes.c_longlong, _P]
        lib.ft_decode_attend.restype = _I
        _lib_handle = lib
    return _lib_handle


def _horizons(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T]: keys visible to each query of the block."""
    return (lengths.to(torch.int64)[:, None] - (t - 1)
            + torch.arange(t, device=lengths.device)[None, :])


def decode_attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of ``decode_attend`` (same shapes and masking)."""
    single = q.dim() == 3
    if single:
        q = q[:, None]
    b, t, nq, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, t, nkv, g, d).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->btkgs", qg,
                          k.to(torch.float32)) * (d ** -0.5)
    live = (torch.arange(s, device=q.device)[None, None, :]
            < _horizons(lengths, t)[:, :, None])                 # [B, T, S]
    scores = torch.where(live[:, :, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", probs, v.to(torch.float32))
    out = out.reshape(b, t, nq, d).to(q.dtype)
    return out[:, 0] if single else out


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """GQA decode attention with per-slot lengths.

    q [B, Nq, D] or [B, T, Nq, D]; k, v [B, S, Nkv, D] in cache layout (a
    batch-strided slice of the cache is fine); lengths [B] = valid keys
    for the block's last query. Returns the rank of ``q``.
    """
    if q.device.type == "cpu":
        return decode_attend_plain(q, k, v, lengths)
    single = q.dim() == 3
    q4 = q[:, None] if single else q
    b, t, nq, d = q4.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d or nq % k.shape[2]:
        raise ValueError(f"decode_attend: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    s, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    if not (q.is_cuda and k.is_cuda and v.is_cuda and lengths.is_cuda):
        raise ValueError("decode_attend: all operands must be CUDA tensors")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16 or lengths.dtype != torch.int32:
        raise ValueError("decode_attend: expects bfloat16 q/k/v and int32 "
                         "lengths")
    if t * g > MAX_ROWS or d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"decode_attend: T*G={t * g} (max {MAX_ROWS}), "
                         f"D={d} (max {MAX_HEAD_DIM}, multiple of 8)")
    inner = (nkv * d, d, 1)
    if tuple(k.stride()[1:]) != inner or k.stride() != v.stride() \
            or k.stride(0) % 8 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attend: k/v need contiguous [S, Nkv, D] "
                         "rows, a shared batch stride and 16-byte alignment")
    if not q4.is_contiguous() or not lengths.is_contiguous() \
            or lengths.shape != (b,):
        raise ValueError("decode_attend: q and lengths must be contiguous, "
                         "lengths of shape [B]")
    out = torch.empty_like(q4)
    err = _lib().ft_decode_attend(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), b, t, g, nkv, d, s, k.stride(0),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attend")
    decode_attend.launches += 1
    return out[:, 0] if single else out


decode_attend.launches = 0
