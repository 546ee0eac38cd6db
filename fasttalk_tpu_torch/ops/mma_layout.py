"""The fragment mappings of the port's tensor-core kernels, written out in
Python: ``csrc/int8_matmul.cu``, ``csrc/int4_matmul.cu`` and
``csrc/decode_attention.cu``.

The kernels feed ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32``.
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


# ----------------------------------------- int4_matmul (q4 [K/2, N])

def i4_b_source(lane: int, tile: int, reg: int,
                half: int) -> tuple[int, int, int]:
    """int4_matmul: (packed row in the k-step's 8, nibble, column in the
    warp's 32) of n8 tile ``tile``'s B register: the k permutation is
    int8_matmul's (logical 2t, 2t+1, 2t+8, 2t+9 -> weight rows 4t .. 4t+3),
    so register ``reg`` is packed row 2t + reg, byte ``tile`` of the word
    at columns 4g .. 4g+3, and ``half`` its nibble (0 the low one, the
    lower weight row)."""
    k, n = mma_b_pos(lane, reg, half)
    row = mm_phys_k(k)
    return row >> 1, row & 1, 4 * n + tile


def i4_scale_source(lane: int, tile: int, reg: int, k0: int,
                    group: int) -> tuple[int, int]:
    """int4_matmul: (scale row, column in the warp's 32) that multiplies
    both halves of ``lane``'s B register ``reg`` of n8 tile ``tile`` in the
    k-step starting at weight row ``k0``: one bf16 broadcast to the pair,
    whose two rows always share a group (G is even)."""
    prow, _, col = i4_b_source(lane, tile, reg, 0)
    return (k0 + 2 * prow) // group, col


def i4_weight_chunk(prow: int, chunk: int) -> int:
    """int4_matmul: where 16-byte chunk ``chunk`` of packed stage row
    ``prow`` (128 bytes) sits in shared memory."""
    return chunk ^ (2 * ((prow >> 1) & 3))


# ------------------------------------------ shared-memory read addresses

MM_ROW_BYTES = 128      # int8_matmul: weight bytes of a stage row
MM_X_STRIDE = 160       # int8_matmul: bytes of an x row in a stage
MT_ROW_BYTES = 128      # int8_matmul_t: weight bytes of a stage row
MT_X_STRIDE = 272       # int8_matmul_t: bytes of an x row in a stage
I4_ROW_BYTES = 128      # int4_matmul: bytes of a packed stage row
I4_X_STRIDE = 288       # int4_matmul: bytes of an x row in a stage


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


def i4_b_read(warp: int, lane: int, step: int, reg: int) -> int:
    """int4_matmul: byte address (4 bytes read) of ``lane``'s B word from
    packed row 2t + ``reg`` of k-step ``step``: columns 32 warp + 4g .. +3."""
    g, t = _gt(lane)
    prow = 8 * step + 2 * t + reg
    chunk = i4_weight_chunk(prow, 2 * warp + (g >> 2))
    return prow * I4_ROW_BYTES + 16 * chunk + 4 * (g & 3)


def i4_a_read(lane: int, step: int, upper: int) -> int:
    """int4_matmul: byte address (8 bytes read) of ``lane``'s A elements of
    k-step ``step`` in x row g (``upper`` 0) or g + 8 (``upper`` 1)."""
    g, t = _gt(lane)
    return (g + 8 * upper) * I4_X_STRIDE + 2 * (16 * step + 4 * t)


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


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def i4_b_fragment(q4: np.ndarray, s: np.ndarray, group: int, k0: int,
                  n0: int) -> np.ndarray:
    """int4_matmul: the B registers [4 tiles, 32 lanes, 2 regs, 2 halves]
    of the k-step at weight row ``k0`` and the warp's columns ``n0`` ..
    +31, as the kernel builds them: the nibble, sign-extended, times the
    bf16 scale of its pair's group, rounded once to bf16."""
    out = np.zeros((4, WARP, 2, 2), np.float32)
    for idx in np.ndindex(4, WARP, 2, 2):
        tile, lane, reg, half = idx
        prow, nib, col = i4_b_source(lane, tile, reg, half)
        byte = int(q4[k0 // 2 + prow, n0 + col])
        v = (byte >> (4 * nib)) & 0xF
        v = v - 16 if v >= 8 else v
        grp, scol = i4_scale_source(lane, tile, reg, k0, group)
        out[idx] = v * bf16_round(s[grp, n0 + scol])
    return bf16_round(out)


def emulate_int4_matmul(x: np.ndarray, q4: np.ndarray, s: np.ndarray,
                        k_per_split: int | None = None) -> np.ndarray:
    """``x @ W`` in f32 the way ``int4_matmul``'s warps compute it: per m16
    tile, per 32-column warp slice, per split, per k-step, four n8 mma from
    the mapped fragments (B built by ``i4_b_fragment``); the splits'
    partials summed in split order. K a multiple of 16, N of 32."""
    m, k = x.shape
    n = q4.shape[1]
    group = k // s.shape[0]
    k_per_split = k_per_split or k
    mp = _cdiv(m, 16) * 16
    xp = _pad(x, mp, k)
    a_src = _positions(mm_a_source, WARP, 4, 2)
    c_dst = _positions(mm_c_dest, WARP, 4, 4)
    splits = _cdiv(k, k_per_split)
    parts = np.zeros((splits, mp, n), np.float32)
    for sp in range(splits):
        k_end = min(k, (sp + 1) * k_per_split)
        for n0 in range(0, n, MM_COLS_PER_WARP):
            frags = [i4_b_fragment(q4, s, group, k0, n0)
                     for k0 in range(sp * k_per_split, k_end, 16)]
            for m0 in range(0, mp, 16):
                acc = np.zeros((4, WARP, 4), np.float32)
                for i, k0 in enumerate(range(sp * k_per_split, k_end, 16)):
                    a = xp[m0:m0 + 16, k0:k0 + 16][a_src]
                    for tile in range(4):
                        acc[tile] = mma_m16n8k16(a, frags[i][tile], acc[tile])
                for tile in range(4):
                    rows, cols = c_dst[0][:, tile], c_dst[1][:, tile]
                    parts[sp, m0 + rows, n0 + cols] = acc[tile]
    total = np.zeros((mp, n), np.float32)
    for sp in range(splits):
        total = total + parts[sp]
    return total[:m]


# ------------------------------------------ decode attention (QK^T, P.V)

ATT_TILE = 16           # keys a warp takes from each chunk
ATT_WARPS = 4
ATT_CHUNK = ATT_TILE * ATT_WARPS


def qk_a_source(lane: int, kd: int, reg: int, half: int) -> tuple[int, int]:
    """decode_attend: (query row, d) of ``lane``'s A register ``reg`` in
    k-step ``kd`` of D: the block's query rows are the m16 tile as they
    lie (row r is query t = (r0 + r) // G, head g = (r0 + r) % G)."""
    row, k = mma_a_pos(lane, reg, half)
    return row, 16 * kd + k


def qk_b_source(lane: int, tile: int, kd: int, reg: int,
                half: int) -> tuple[int, int]:
    """decode_attend: (key in the warp's 16, d) of n8 tile ``tile``'s B
    register: key row 8 tile + g of the K tile, two consecutive d (one
    32-bit word of a bf16 row, one converted byte pair of an int8 row)."""
    k, n = mma_b_pos(lane, reg, half)
    return 8 * tile + n, 16 * kd + k


def qk_c_dest(lane: int, tile: int, i: int) -> tuple[int, int]:
    """decode_attend: (query row, key in the warp's 16) of score tile
    ``tile``'s accumulator ``i``."""
    row, n = mma_c_pos(lane, i)
    return row, 8 * tile + n


def pv_a_source(lane: int, reg: int, half: int) -> tuple[int, int]:
    """decode_attend: (query row, key) of the P fragment's register ``reg``:
    the score accumulators as they lie, tile ``reg // 2`` and rows g
    (``reg`` even) or g + 8, no shuffle."""
    return qk_c_dest(lane, reg >> 1, 2 * (reg & 1) + half)


def ldmatrix_row(lane: int) -> tuple[int, int]:
    """decode_attend: (key, d offset) of the V row whose 16 bytes ``lane``
    points ldmatrix.x4.trans at, for the pair of n8 tiles of D at 16 dp
    (matrix ``lane // 8``: keys 0-7 or 8-15, d 0-7 or 8-15)."""
    mi = lane >> 3
    return 8 * (mi & 1) + (lane & 7), 8 * (mi >> 1)


def pv_b_source(lane: int, dtile: int, reg: int, half: int) -> tuple[int, int]:
    """decode_attend: (key, d) of ``lane``'s B register ``reg`` for n8 tile
    ``dtile`` of D, as ldmatrix.x4.trans delivers it: register i of the x4
    is matrix i transposed, lane (g, t) receiving its rows 2t, 2t + 1 at
    column g, row rho of matrix i being where lane 8 i + rho points."""
    g, t = _gt(lane)
    matrix = 2 * (dtile & 1) + reg
    key, d0 = ldmatrix_row(8 * matrix + 2 * t + half)
    return key, 16 * (dtile >> 1) + d0 + g


def _frag(src_fn, dims):
    return _positions(src_fn, *dims)


def _att_tile(qp, kt, vt, kscale, vscale, keys, horizon, n_keys, scale_log2,
              state):
    """One warp's 16-key tile, as the kernel runs it: scores on the mma,
    scaled and masked in f32, online softmax per lane row, P split into
    bf16 hi + lo (times the value scale) and P.V on the mma."""
    dk = qp.shape[1] // 16
    m, l_lane, acc = state
    s = np.zeros((2, WARP, 4), np.float32)
    for nt in range(2):
        for kd in range(dk):
            a = qp[_QK_A[kd]]
            b = kt[_QK_B[nt][kd]]
            s[nt] = mma_m16n8k16(a, b, s[nt])
    rows = _C_ROW                       # [32, 4] query row of each element
    kc = np.stack([_C_KEY[0], _C_KEY[1]])          # [2, 32, 4]
    j = keys[kc]
    v = s * np.float32(scale_log2)
    if kscale is not None:
        v = v * kscale[kc]
    live = (j < n_keys) & (j < horizon[rows][None])
    v = np.where(live, v, np.float32(-1e30)).astype(np.float32)
    tmax = np.full(16, -1e30, np.float32)
    np.maximum.at(tmax, np.broadcast_to(rows, v.shape).ravel(), v.ravel())
    m_new = np.maximum(m, tmax)
    corr = np.exp2(m - m_new).astype(np.float32)
    p = np.exp2(v - m_new[rows][None]).astype(np.float32)
    # Lane partial row sums: l = l * corr + (p0 + p1) of tile 0, then tile 1.
    lr = l_lane * corr[_LANE_ROWS]
    for nt in range(2):
        for hh in range(2):
            lr[:, hh] = lr[:, hh] + (p[nt][:, 2 * hh] + p[nt][:, 2 * hh + 1])
    if vscale is not None:
        p = (p * vscale[kc]).astype(np.float32)
    ph = bf16_round(p)
    pl = bf16_round(p - ph)
    acc = acc * corr[_ACC_ROW][None]
    pmat_h = np.zeros((16, 16), np.float32)
    pmat_l = np.zeros((16, 16), np.float32)
    pmat_h[rows, kc[0]] = ph[0]
    pmat_h[rows, kc[1]] = ph[1]
    pmat_l[rows, kc[0]] = pl[0]
    pmat_l[rows, kc[1]] = pl[1]
    a_h, a_l = pmat_h[_PV_A], pmat_l[_PV_A]
    for nd in range(acc.shape[0]):
        b = vt[_PV_B[nd]]
        acc[nd] = mma_m16n8k16(a_h, b, acc[nd])
        acc[nd] = mma_m16n8k16(a_l, b, acc[nd])
    return m_new, lr, acc


def _att_tables(dk: int) -> None:
    global _QK_A, _QK_B, _C_ROW, _C_KEY, _PV_A, _PV_B, _LANE_ROWS, _ACC_ROW
    _QK_A = [_positions(lambda ln, r, h, kd=kd: qk_a_source(ln, kd, r, h),
                        WARP, 4, 2) for kd in range(dk)]
    _QK_B = [[_positions(lambda ln, r, h, nt=nt, kd=kd:
                         qk_b_source(ln, nt, kd, r, h), WARP, 2, 2)
              for kd in range(dk)] for nt in range(2)]
    c = [_positions(lambda ln, i, nt=nt: qk_c_dest(ln, nt, i), WARP, 4)
         for nt in range(2)]
    _C_ROW = c[0][0]
    _C_KEY = (c[0][1], c[1][1])
    _PV_A = _positions(pv_a_source, WARP, 4, 2)
    _PV_B = [_positions(lambda ln, r, h, nd=nd: pv_b_source(ln, nd, r, h),
                        WARP, 2, 2) for nd in range(2 * dk)]
    _LANE_ROWS = np.array([[ln >> 2, (ln >> 2) + 8] for ln in range(WARP)])
    _ACC_ROW = _positions(mma_c_pos, WARP, 4)[0]


def emulate_decode_attend(q, k, v, lengths, splits: int, *, k_scale=None,
                          v_scale=None, tables=None,
                          block_size: int = 0) -> np.ndarray:
    """The attention kernel's arithmetic in numpy, f32: per (KV head, slot,
    group of 16 query rows) and split z, each warp's 16-key tiles of the
    chunks z, z + splits, ... (``_att_tile``), the warps merged in warp
    order, the splits combined in split order. q [B, T, Nq, D] (bf16
    values), k/v dense [B, S, Nkv, D] or, with ``tables``, the pool
    [P, Nkv, D]; int8 rows as their values with scales [B, S, SG] or
    [P, SG]. Returns [B, T, Nq, D] in f32, before the kernel's bf16 cast."""
    q = np.asarray(q, np.float32)
    b_n, t_n, nq, d = q.shape
    nkv = k.shape[-2]
    grp = nq // nkv
    dk = -(-d // 16)
    dp = 16 * dk
    _att_tables(dk)
    paged = tables is not None
    s_keys = tables.shape[1] * block_size if paged else k.shape[1]
    scale_log2 = np.float32(1.4426950408889634 / np.sqrt(d))
    out = np.zeros_like(q)
    for b in range(b_n):
        length = int(lengths[b])
        n_keys = max(0, min(length, s_keys))
        rows_of = np.arange(n_keys)
        if paged:
            rows_of = (tables[b, rows_of // block_size].astype(np.int64)
                       * block_size + rows_of % block_size)
        for h in range(nkv):
            sg = None if k_scale is None else k_scale.shape[-1]
            for r0 in range(0, t_n * grp, 16):
                r_n = min(16, t_n * grp - r0)
                qp = np.zeros((16, dp), np.float32)
                rr = np.arange(r0, r0 + r_n)
                qp[:r_n, :d] = q[b, rr // grp, h * grp + rr % grp]
                horizon = (length - (t_n - 1)
                           + (np.arange(r0, r0 + 16)) // grp)
                parts = []
                for z in range(splits):
                    states = []
                    for w in range(ATT_WARPS):
                        st = (np.full(16, -1e30, np.float32),
                              np.zeros((WARP, 2), np.float32),
                              np.zeros((2 * dk, WARP, 4), np.float32))
                        j0 = z * ATT_CHUNK + ATT_TILE * w
                        while j0 < n_keys:
                            keys = j0 + np.arange(16)
                            ok = keys < n_keys
                            src = rows_of[keys[ok]]
                            kt = np.zeros((16, dp), np.float32)
                            vt = np.zeros((16, dp), np.float32)
                            ksc = vsc = None
                            kk = k[src, h] if paged else k[b, src, h]
                            vv = v[src, h] if paged else v[b, src, h]
                            kt[ok, :d] = kk
                            vt[ok, :d] = vv
                            if k_scale is not None:
                                col = h if sg > 1 else 0
                                ksc = np.zeros(16, np.float32)
                                vsc = np.zeros(16, np.float32)
                                ksc[ok] = (k_scale[src, col] if paged
                                           else k_scale[b, src, col])
                                vsc[ok] = (v_scale[src, col] if paged
                                           else v_scale[b, src, col])
                            st = _att_tile(qp, kt, vt, ksc, vsc, keys,
                                           horizon, n_keys, scale_log2, st)
                            j0 += splits * ATT_CHUNK
                        m, lr, acc = st
                        # Row sums: lanes t ^ 1, then t ^ 2.
                        lsum = lr.reshape(8, 4, 2)
                        lsum = lsum + lsum[:, [1, 0, 3, 2]]
                        lsum = lsum + lsum[:, [2, 3, 0, 1]]
                        l_row = np.concatenate([lsum[:, 0, 0],
                                                lsum[:, 0, 1]])
                        a_mat = np.zeros((16, dp), np.float32)
                        for nd in range(2 * dk):
                            r_, c_ = _positions(mma_c_pos, WARP, 4)
                            a_mat[r_, 8 * nd + c_] = acc[nd]
                        states.append((m, l_row.astype(np.float32), a_mat))
                    mx = np.max([s_[0] for s_ in states], axis=0)
                    lb = np.zeros(16, np.float32)
                    ab = np.zeros((16, dp), np.float32)
                    for m, l_row, a_mat in states:
                        f = np.exp2(m - mx).astype(np.float32)
                        lb = lb + l_row * f
                        ab = ab + a_mat * f[:, None]
                    parts.append((mx, lb, ab))
                mx = np.max([p_[0] for p_ in parts], axis=0)
                lt = np.zeros(16, np.float32)
                at = np.zeros((16, dp), np.float32)
                for m, lb, ab in parts:
                    f = np.exp2(m - mx).astype(np.float32)
                    lt = lt + lb * f
                    at = at + ab * f[:, None]
                res = at[:r_n, :d] / np.maximum(lt[:r_n, None], 1e-30)
                out[b, rr // grp, h * grp + rr % grp] = res
    return out
