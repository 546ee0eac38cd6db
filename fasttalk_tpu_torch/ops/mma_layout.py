"""The fragment mappings of ``csrc/int8_matmul.cu``, written out in Python.

Both kernels feed ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``.
The sum over k does not care which physical k stands behind each logical
k of the instruction, so each kernel permutes k within a step, the same
way on A (x) and B (the weight), until a lane's elements are contiguous in
shared memory. This module states, for every lane, register and half of a
register, which x element and which weight byte the kernel puts there and
which output each accumulator element is, and emulates the kernels tile by
tile through numpy's m16n8k16. The CPU tests check that the mappings are
bijections and that the emulation gives the plain versions' results; the
CUDA source implements the same formulas (its comments cite them).

Notation: lane l of a warp, ``g = l // 4``, ``t = l % 4``; ``reg`` the
32-bit register of an operand, ``half`` its low (0) or high (1) bf16.
"""

from __future__ import annotations

import numpy as np

WARP = 32
MM_COLS_PER_WARP = 32   # int8_matmul: 4 n8 tiles a warp
MT_ROWS_PER_WARP = 32   # int8_matmul_t: 4 n8 tiles (vocab rows) a warp
MT_K_GROUP = 64         # int8_matmul_t: 4 k-steps from one 16-byte read


def _gt(lane: int) -> tuple[int, int]:
    return lane >> 2, lane & 3


# ------------------------------------------- the instruction's own layout

def mma_a_pos(lane: int, reg: int, half: int) -> tuple[int, int]:
    """(row, k) of A[16, 16] held by ``lane``'s A register ``reg``."""
    g, t = _gt(lane)
    return g + 8 * (reg & 1), 2 * t + half + 8 * (reg >> 1)


def mma_b_pos(lane: int, reg: int, half: int) -> tuple[int, int]:
    """(k, n) of B[16, 8] held by ``lane``'s B register ``reg``."""
    g, t = _gt(lane)
    return 2 * t + half + 8 * reg, g


def mma_c_pos(lane: int, i: int) -> tuple[int, int]:
    """(row, n) of C[16, 8] held by ``lane``'s accumulator ``i``."""
    g, t = _gt(lane)
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def _positions(fn, *dims) -> tuple[np.ndarray, np.ndarray]:
    rows, cols = np.zeros(dims, np.int64), np.zeros(dims, np.int64)
    for idx in np.ndindex(*dims):
        rows[idx], cols[idx] = fn(*idx)
    return rows, cols


_A_POS = _positions(mma_a_pos, WARP, 4, 2)
_B_POS = _positions(mma_b_pos, WARP, 2, 2)
_C_POS = _positions(mma_c_pos, WARP, 4)


def mma_m16n8k16(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One warp's ``mma`` on fragments: a [32, 4, 2], b [32, 2, 2],
    c [32, 4] (f32) -> d [32, 4] = A @ B + C, accumulated in f32."""
    am = np.zeros((16, 16), np.float32)
    bm = np.zeros((16, 8), np.float32)
    am[_A_POS] = a
    bm[_B_POS] = b
    return (c + (am @ bm)[_C_POS]).astype(np.float32)


def _logical(kk: int) -> tuple[int, int, int]:
    """Logical k of a step -> (t, reg, half) of the lane holding it."""
    return (kk % 8) // 2, kk // 8, kk % 2


# ------------------------------------------------ int8_matmul (q [K, N])

def mm_phys_k(kk: int) -> int:
    """int8_matmul: the weight row (within a 16-row k-step) behind logical
    k ``kk``: lane t's 2t, 2t+1, 2t+8, 2t+9 are rows 4t .. 4t+3, so its A
    elements are one 8-byte read of an x row."""
    t, reg, half = _logical(kk)
    return 4 * t + 2 * reg + half


def mm_b_source(lane: int, tile: int, reg: int, half: int) -> tuple[int, int]:
    """int8_matmul: (weight row in the k-step, column in the warp's 32)
    of n8 tile ``tile``'s B register: byte ``tile`` of the word the lane
    reads from that row, columns 4g .. 4g+3."""
    k, n = mma_b_pos(lane, reg, half)
    return mm_phys_k(k), 4 * n + tile


def mm_a_source(lane: int, reg: int, half: int) -> tuple[int, int]:
    """int8_matmul: (x row in the m16 tile, x column in the k-step)."""
    row, k = mma_a_pos(lane, reg, half)
    return row, mm_phys_k(k)


def mm_c_dest(lane: int, tile: int, i: int) -> tuple[int, int]:
    """int8_matmul: (output row, output column in the warp's 32) of n8
    tile ``tile``'s accumulator ``i``: lane t holds columns 8t .. 8t+7."""
    row, n = mma_c_pos(lane, i)
    return row, 4 * n + tile


def mm_weight_chunk(row: int, chunk: int) -> int:
    """int8_matmul: where 16-byte chunk ``chunk`` of stage row ``row``
    (128 bytes) sits in shared memory."""
    return chunk ^ (2 * ((row >> 2) & 3))


# --------------------------------------------- int8_matmul_t (q [V, D])

def mt_phys_k(step: int, kk: int) -> int:
    """int8_matmul_t: the D offset (within a 64-wide group of 4 k-steps)
    behind logical k ``kk`` of k-step ``step``: lane t's elements of the
    group are 16t .. 16t+15, one 16-byte read of its vocab row."""
    t, reg, half = _logical(kk)
    return 16 * t + 4 * step + 2 * reg + half


def mt_b_source(lane: int, step: int, tile: int, reg: int,
                half: int) -> tuple[int, int]:
    """int8_matmul_t: (vocab row in the warp's 32, D offset in the group)."""
    k, n = mma_b_pos(lane, reg, half)
    return 8 * tile + n, mt_phys_k(step, k)


def mt_a_source(lane: int, step: int, reg: int,
                half: int) -> tuple[int, int]:
    """int8_matmul_t: (x row in the m16 tile, D offset in the group)."""
    row, k = mma_a_pos(lane, reg, half)
    return row, mt_phys_k(step, k)


def mt_c_dest(lane: int, tile: int, i: int) -> tuple[int, int]:
    """int8_matmul_t: (output row, vocab row in the warp's 32)."""
    row, n = mma_c_pos(lane, i)
    return row, 8 * tile + n


def mt_weight_chunk(row: int, chunk: int) -> int:
    """int8_matmul_t: where 16-byte chunk ``chunk`` of stage row ``row``
    (128 bytes) sits in shared memory."""
    return chunk ^ (4 * (row & 1))


# ------------------------------------------ shared-memory read addresses

MM_ROW_BYTES = 128      # int8_matmul: weight bytes of a stage row
MM_X_STRIDE = 160       # int8_matmul: bytes of an x row in a stage
MT_ROW_BYTES = 128      # int8_matmul_t: weight bytes of a stage row
MT_X_STRIDE = 272       # int8_matmul_t: bytes of an x row in a stage


def mm_b_read(warp: int, lane: int, step: int, e: int) -> int:
    """int8_matmul: byte address (4 bytes read) of ``lane``'s B word from
    row 4t + e of k-step ``step``: columns 32 warp + 4g .. +3."""
    g, t = _gt(lane)
    row = 16 * step + 4 * t + e
    chunk = mm_weight_chunk(row, 2 * warp + (g >> 2))
    return row * MM_ROW_BYTES + 16 * chunk + 4 * (g & 3)


def mm_a_read(lane: int, step: int, upper: int) -> int:
    """int8_matmul: byte address (8 bytes read) of ``lane``'s A elements of
    k-step ``step`` in x row g (``upper`` 0) or g + 8 (``upper`` 1)."""
    g, t = _gt(lane)
    return (g + 8 * upper) * MM_X_STRIDE + 2 * (16 * step + 4 * t)


def mt_b_read(warp: int, lane: int, half: int, tile: int) -> int:
    """int8_matmul_t: byte address (16 bytes read) of ``lane``'s weight
    bytes of n8 tile ``tile`` in 64-byte half ``half`` of a stage."""
    g, t = _gt(lane)
    row = 32 * warp + 8 * tile + g
    return row * MT_ROW_BYTES + 16 * mt_weight_chunk(row, 4 * half + t)


def mt_a_read(lane: int, half: int, upper: int, part: int) -> int:
    """int8_matmul_t: byte address (16 bytes read) of part ``part`` (0, 1)
    of ``lane``'s 16 x elements in half ``half`` of a stage, row g or g + 8."""
    g, t = _gt(lane)
    return (g + 8 * upper) * MT_X_STRIDE + 2 * (64 * half + 16 * t + 8 * part)


def bank_conflicts(addrs: list[int], width: int) -> int:
    """Extra shared-memory wavefronts of one warp-wide read of ``width``
    bytes a lane (4, 8 or 16) at ``addrs``: a phase of 128 / width lanes is
    served at once, and two different 4-byte words on one of the 32 banks
    in a phase cost a wavefront more (the same word is a broadcast)."""
    lanes = 128 // width
    extra = 0
    for p in range(0, WARP, lanes):
        words: dict[int, set[int]] = {}
        for a in addrs[p:p + lanes]:
            for w in range(a // 4, (a + width) // 4):
                words.setdefault(w % 32, set()).add(w)
        extra += max(len(v) for v in words.values()) - 1
    return extra


# ------------------------------------------------------------- emulation

def _pad(a: np.ndarray, rows: int, cols: int) -> np.ndarray:
    out = np.zeros((rows, cols), np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def emulate_int8_matmul(x: np.ndarray, q: np.ndarray, s: np.ndarray,
                        k_per_split: int | None = None) -> np.ndarray:
    """``(x @ q) * s`` in f32 the way ``int8_matmul``'s warps compute it:
    per m16 tile, per 32-column warp slice, per split, per k-step, four n8
    mma from the mapped fragments; the splits' partials summed in split
    order, then scaled."""
    m, k = x.shape
    n = q.shape[1]
    k_per_split = k_per_split or max(16, _cdiv(k, 16) * 16)
    mp, kp, np_ = _cdiv(m, 16) * 16, _cdiv(k, 16) * 16, _cdiv(n, 32) * 32
    xp, qp = _pad(x, mp, kp), _pad(q, kp, np_)
    a_src = _positions(mm_a_source, WARP, 4, 2)
    b_src = _positions(mm_b_source, WARP, 4, 2, 2)
    c_dst = _positions(mm_c_dest, WARP, 4, 4)
    splits = _cdiv(k, k_per_split) if k else 1
    parts = np.zeros((splits, mp, np_), np.float32)
    for sp in range(splits):
        k_end = min(kp, (sp + 1) * k_per_split)
        for m0 in range(0, mp, 16):
            for n0 in range(0, np_, MM_COLS_PER_WARP):
                acc = np.zeros((4, WARP, 4), np.float32)
                for k0 in range(sp * k_per_split, k_end, 16):
                    xa = xp[m0:m0 + 16, k0:k0 + 16]
                    wb = qp[k0:k0 + 16, n0:n0 + MM_COLS_PER_WARP]
                    a = xa[a_src]
                    for tile in range(4):
                        b = wb[b_src[0][:, tile], b_src[1][:, tile]]
                        acc[tile] = mma_m16n8k16(a, b, acc[tile])
                for tile in range(4):
                    rows, cols = c_dst[0][:, tile], c_dst[1][:, tile]
                    parts[sp, m0 + rows, n0 + cols] = acc[tile]
    total = np.zeros((mp, np_), np.float32)
    for sp in range(splits):
        total = total + parts[sp]
    return (total[:m, :n] * s.astype(np.float32)[None, :]).astype(np.float32)


def emulate_int8_matmul_t(x: np.ndarray, q: np.ndarray,
                          s: np.ndarray) -> np.ndarray:
    """``(x @ q.T) * s`` in f32 the way ``int8_matmul_t``'s warps compute
    it: per m16 tile, per 32-row warp slice of the vocab, per 64-wide
    group of D, four k-steps of four n8 mma from the mapped fragments."""
    m, d = x.shape
    v = q.shape[0]
    mp, dp = _cdiv(m, 16) * 16, _cdiv(d, MT_K_GROUP) * MT_K_GROUP
    vp = _cdiv(v, MT_ROWS_PER_WARP) * MT_ROWS_PER_WARP
    xp, qp = _pad(x, mp, dp), _pad(q, vp, dp)
    a_src = _positions(mt_a_source, WARP, 4, 4, 2)
    b_src = _positions(mt_b_source, WARP, 4, 4, 2, 2)
    c_dst = _positions(mt_c_dest, WARP, 4, 4)
    out = np.zeros((mp, vp), np.float32)
    for m0 in range(0, mp, 16):
        for v0 in range(0, vp, MT_ROWS_PER_WARP):
            acc = np.zeros((4, WARP, 4), np.float32)
            for d0 in range(0, dp, MT_K_GROUP):
                xa = xp[m0:m0 + 16, d0:d0 + MT_K_GROUP]
                wb = qp[v0:v0 + MT_ROWS_PER_WARP, d0:d0 + MT_K_GROUP]
                for step in range(4):
                    a = xa[a_src[0][:, step], a_src[1][:, step]]
                    for tile in range(4):
                        b = wb[b_src[0][:, step, tile],
                               b_src[1][:, step, tile]]
                        acc[tile] = mma_m16n8k16(a, b, acc[tile])
            for tile in range(4):
                rows, cols = c_dst[0][:, tile], c_dst[1][:, tile]
                out[m0 + rows, v0 + cols] = acc[tile]
    return (out[:m, :v] * s.astype(np.float32)[None, :]).astype(np.float32)
