"""Decode attention over the KV cache: the hand-written CUDA kernel, dense
and paged, bf16 and int8 rows, and its plain versions.

Source note (the kernel is ``csrc/decode_attention.cu``, one templated
source for the four tiers):

- ``decode_attend`` replaces ``fasttalk_tpu/ops/pallas_attention.py::
  decode_attend`` (:153): the dense cache, bf16 rows, or int8 rows with
  ``k_scale``/``v_scale`` [B, S, G] (the int8 KV tier).
- ``decode_attend_paged`` replaces ``decode_attend_paged`` (:249): the same
  recurrence over a flat row pool [P, Nkv, D] read through per-slot block
  tables [B, nb], bf16 rows or int8 rows with pool scales [P, G].

GQA attention of a short query block (any T >= 1) against the cache with
per-slot ``lengths`` (keys visible to the block's last query; query t sees
``length - (T - 1) + t`` keys), online softmax in f32. In the port it IS
the decode attention (the JAX package gates its kernels behind
TPU_USE_PALLAS_ATTENTION). Bound: the bytes of each slot's live K/V rows,
plus their scales on the int8 tier. Design (flash-decoding on the tensor
cores): the key axis is split into 64-key chunks, ``splits`` blocks per
(KV head, slot, group of 16 query rows) taking every ``splits``-th chunk,
so long and short slots spread over the card alike whatever the lengths
(``splits`` keeps the grid to one wave of resident blocks);
in a block each of 4 warps takes 16 keys of a chunk through its own
``cp.async`` ring; QK^T and P.V run on ``mma.sync`` m16n8k16 (the query
rows are the m16 tile; int8 K/V converted exactly to bf16; P split into
bf16 hi + lo; V^T through ``ldmatrix.trans``), the online softmax in f32;
warps merge in warp order and the splits, one thread block cluster,
combine in split order through distributed shared memory: one launch a
call, no workspace, the same bits on every call.

Dispatch rule: a CPU tensor runs the plain version; a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from fasttalk_tpu_torch.ops import _build
from fasttalk_tpu_torch.ops.cuda_int8 import _cdiv, _sm_count
from fasttalk_tpu_torch.ops.attention import (gather_paged_rows,
                                              paged_gather_indices)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_lib_handle: ctypes.CDLL | None = None
_NEG_INF = -1e30
MAX_HEAD_DIM = 128
CHUNK = 64             # keys a block takes at a time
MAX_SPLITS = 8         # the splits of a (head, slot, row group): a cluster
_resident: dict[tuple[bool, bool, int], int] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("decode_attention")
        lib.ft_decode_attend.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I,
                                         _I, _I, _I, _I, _L, _L, _I, _I, _P]
        lib.ft_decode_attend.restype = _I
        lib.ft_decode_attend_paged.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                               _I, _I, _I, _I, _I, _I, _I, _I,
                                               _I, _P]
        lib.ft_decode_attend_paged.restype = _I
        lib.ft_decode_attend_resident.argtypes = [_I, _I, _I, _P]
        lib.ft_decode_attend_resident.restype = _I
        _lib_handle = lib
    return _lib_handle


def key_splits(keys: int, blocks: int, sms: int, per_sm: int) -> int:
    """How many blocks split the key axis of each (KV head, slot, row
    group): as many as keep the call's grid to one wave, ``per_sm``
    resident blocks on each of ``sms`` SMs over the ``blocks`` (head,
    slot, row group) triples (more splits only add blocks that wait, each
    with its fixed cost), no more than the ``CHUNK``-key chunks of
    ``keys`` addressable keys, at most ``MAX_SPLITS`` (one cluster).
    Shapes alone decide it, never the lengths on the card, so a call needs
    no host read."""
    return max(1, min(MAX_SPLITS, _cdiv(keys, CHUNK),
                      per_sm * sms // max(1, blocks)))


def _splits(keys: int, blocks: int, device: torch.device, int8: bool,
            paged: bool, d: int) -> int:
    """``key_splits`` for a call, with the kernel instance's resident blocks
    per SM asked of the CUDA runtime once."""
    key = (int8, paged, d)
    if key not in _resident:
        got = ctypes.c_int(0)
        _build.check(_lib().ft_decode_attend_resident(
            int(int8), int(paged), d, ctypes.byref(got)),
            "decode_attend occupancy")
        _resident[key] = max(1, got.value)
    return key_splits(keys, blocks, _sm_count(device), _resident[key])


def _horizons(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T]: keys visible to each query of the block."""
    return (lengths.to(torch.int64)[:, None] - (t - 1)
            + torch.arange(t, device=lengths.device)[None, :])


def _dequant_f32(rows: torch.Tensor, scale: torch.Tensor | None
                 ) -> torch.Tensor:
    """Rows [..., Nkv, D] in f32, times their scales [..., G] when given
    (G = 1 or Nkv broadcasts over the KV heads)."""
    rows = rows.to(torch.float32)
    return rows if scale is None else rows * scale.to(torch.float32)[..., None]


def decode_attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, *,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``decode_attend`` (same shapes and masking); int8
    rows dequantize in f32 before the attention, as the TPU kernel does
    after its DMA."""
    single = q.dim() == 3
    if single:
        q = q[:, None]
    b, t, nq, d = q.shape
    s, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    qg = q.reshape(b, t, nkv, g, d).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->btkgs", qg,
                          _dequant_f32(k, k_scale)) * (d ** -0.5)
    live = (torch.arange(s, device=q.device)[None, None, :]
            < _horizons(lengths, t)[:, :, None])                 # [B, T, S]
    scores = torch.where(live[:, :, None, None, :], scores,
                         torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("btkgs,bskd->btkgd", probs, _dequant_f32(v, v_scale))
    out = out.reshape(b, t, nq, d).to(q.dtype)
    return out[:, 0] if single else out


def decode_attend_paged_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, lengths: torch.Tensor,
                              tables: torch.Tensor, *, block_size: int,
                              k_scale: torch.Tensor | None = None,
                              v_scale: torch.Tensor | None = None,
                              ) -> torch.Tensor:
    """Plain version of ``decode_attend_paged``: gather each slot's rows
    (and scale rows) into logical order, then ``decode_attend_plain``."""
    idx = paged_gather_indices(tables, block_size)

    def gather(x):
        return None if x is None else gather_paged_rows(x, idx)
    return decode_attend_plain(q, gather(k), gather(v), lengths,
                               k_scale=gather(k_scale),
                               v_scale=gather(v_scale))


def _check_common(name: str, q4: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, lengths: torch.Tensor,
                  k_scale: torch.Tensor | None,
                  v_scale: torch.Tensor | None, nkv: int) -> tuple[int, int]:
    """Checks shared by both wrappers; returns (G, scale granule)."""
    b, t, nq, d = q4.shape
    tensors = [q4, k, v, lengths] + [x for x in (k_scale, v_scale)
                                     if x is not None]
    if not all(x.is_cuda for x in tensors):
        raise ValueError(f"{name}: all operands must be CUDA tensors")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: pass both k_scale and v_scale or neither")
    want = torch.int8 if k_scale is not None else torch.bfloat16
    if q4.dtype != torch.bfloat16 or k.dtype != want or v.dtype != want \
            or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: expects bfloat16 q, {want} k/v and int32 "
                         "lengths (int8 k/v come with float32 scales)")
    if nq % nkv or d > MAX_HEAD_DIM or (d * k.element_size()) % 16:
        raise ValueError(f"{name}: Nq={nq} must be a multiple of Nkv={nkv}; "
                         f"D={d} at most {MAX_HEAD_DIM} and a whole number "
                         "of 16-byte loads")
    if not q4.is_contiguous() or not lengths.is_contiguous() \
            or lengths.shape != (b,):
        raise ValueError(f"{name}: q and lengths must be contiguous, "
                         "lengths of shape [B]")
    sg = 0
    if k_scale is not None:
        sg = k_scale.shape[-1]
        if sg not in (1, nkv) or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32 \
                or k_scale.shape != v_scale.shape \
                or k_scale.stride() != v_scale.stride() \
                or k_scale.stride(-1) != 1:
            raise ValueError(f"{name}: scales must be float32 [..., G] with "
                             f"G = 1 or Nkv={nkv}, alike, contiguous in G")
    return nq // nkv, sg


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  lengths: torch.Tensor, *,
                  k_scale: torch.Tensor | None = None,
                  v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """GQA decode attention with per-slot lengths over the dense cache.

    q [B, Nq, D] or [B, T, Nq, D]; k, v [B, S, Nkv, D] in cache layout (a
    batch-strided slice of the cache is fine), bf16, or int8 with
    ``k_scale``/``v_scale`` [B, S, G] f32 (G = 1 or Nkv; a batch-strided
    slice is fine); lengths [B] = valid keys for the block's last query.
    Returns the rank of ``q``.
    """
    if q.device.type == "cpu":
        return decode_attend_plain(q, k, v, lengths, k_scale=k_scale,
                                   v_scale=v_scale)
    single = q.dim() == 3
    q4 = q[:, None] if single else q
    b, t, nq, d = q4.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"decode_attend: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    s, nkv = k.shape[1], k.shape[2]
    g, sg = _check_common("decode_attend", q4, k, v, lengths, k_scale,
                          v_scale, nkv)
    el = k.element_size()
    if tuple(k.stride()[1:]) != (nkv * d, d, 1) or k.stride() != v.stride() \
            or (k.stride(0) * el) % 16 or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError("decode_attend: k/v need contiguous [S, Nkv, D] "
                         "rows, a shared batch stride and 16-byte alignment")
    s_bstride = 0
    if k_scale is not None:
        if k_scale.shape != (b, s, sg) or k_scale.stride(1) != sg:
            raise ValueError(f"decode_attend: scales must be [B, S, G] = "
                             f"{(b, s, sg)} with contiguous rows")
        s_bstride = k_scale.stride(0)
    out = torch.empty_like(q4)
    err = _lib().ft_decode_attend(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        lengths.data_ptr(), out.data_ptr(), b, t, g, nkv, d, s, k.stride(0),
        s_bstride, max(sg, 1),
        _splits(s, nkv * b * _cdiv(t * g, 16), q.device, k_scale is not None,
                False, d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attend")
    decode_attend.launches += 1
    if k_scale is not None:
        decode_attend.launches_int8 += 1
    if t > 1:
        decode_attend.launches_multi += 1
    return out[:, 0] if single else out


def decode_attend_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, tables: torch.Tensor, *,
                        block_size: int,
                        k_scale: torch.Tensor | None = None,
                        v_scale: torch.Tensor | None = None) -> torch.Tensor:
    """GQA decode attention over the paged block pool.

    q [B, Nq, D] or [B, T, Nq, D] bf16; k, v the pool [P, Nkv, D], bf16, or
    int8 with ``k_scale``/``v_scale`` [P, G] f32; lengths [B] int32; tables
    [B, nb] int32 pool block ids (slot b's key j is pool row
    ``tables[b, j // block_size] * block_size + j % block_size``; keys end
    at ``nb * block_size``). Returns the rank of ``q``.
    """
    if q.device.type == "cpu":
        return decode_attend_paged_plain(q, k, v, lengths, tables,
                                         block_size=block_size,
                                         k_scale=k_scale, v_scale=v_scale)
    single = q.dim() == 3
    q4 = q[:, None] if single else q
    b, t, nq, d = q4.shape
    if k.dim() != 3 or k.shape != v.shape or k.shape[2] != d \
            or tables.dim() != 2 or tables.shape[0] != b:
        raise ValueError(f"decode_attend_paged: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} "
                         f"tables{tuple(tables.shape)}")
    p, nkv = k.shape[0], k.shape[1]
    g, sg = _check_common("decode_attend_paged", q4, k, v, lengths, k_scale,
                          v_scale, nkv)
    if not tables.is_cuda or tables.dtype != torch.int32 \
            or not tables.is_contiguous():
        raise ValueError("decode_attend_paged: tables must be a contiguous "
                         "int32 CUDA tensor [B, nb]")
    if block_size <= 0 or p % block_size:
        raise ValueError(f"decode_attend_paged: pool rows {p} not divisible "
                         f"by block_size {block_size}")
    if not k.is_contiguous() or not v.is_contiguous() or k.data_ptr() % 16 \
            or v.data_ptr() % 16:
        raise ValueError("decode_attend_paged: the pool must be contiguous "
                         "and 16-byte aligned")
    if k_scale is not None and (k_scale.shape != (p, sg)
                                or not k_scale.is_contiguous()
                                or not v_scale.is_contiguous()):
        raise ValueError(f"decode_attend_paged: scales must be contiguous "
                         f"[P, G] = {(p, sg)}")
    out = torch.empty_like(q4)
    err = _lib().ft_decode_attend_paged(
        q4.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        lengths.data_ptr(), tables.data_ptr(), out.data_ptr(), b, t, g, nkv,
        d, tables.shape[1], block_size, max(sg, 1),
        _splits(tables.shape[1] * block_size, nkv * b * _cdiv(t * g, 16),
                q.device, k_scale is not None, True, d),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attend_paged")
    decode_attend_paged.launches += 1
    if k_scale is not None:
        decode_attend_paged.launches_int8 += 1
    if t > 1:
        decode_attend_paged.launches_multi += 1
    return out[:, 0] if single else out


# Launch counts: ``launches`` counts every launch of the wrapper's kernel,
# ``launches_int8`` those of the int8-row tier among them and
# ``launches_multi`` those with more than one query position (the
# speculative verify block).
decode_attend.launches = 0
decode_attend.launches_int8 = 0
decode_attend.launches_multi = 0
decode_attend_paged.launches = 0
decode_attend_paged.launches_int8 = 0
decode_attend_paged.launches_multi = 0
