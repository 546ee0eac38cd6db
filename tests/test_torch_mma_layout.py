"""The tensor-core fragment layouts of the port's kernels, on the CPU.

``fasttalk_tpu_torch/ops/mma_layout.py`` writes out which x element and
which weight byte each lane's mma registers hold in ``int8_matmul``,
``int8_matmul_t`` and ``int4_matmul``, which output each accumulator is,
and where each lane reads shared memory; and, for the decode-attention
kernel, the QK^T and P.V fragments (scores reused as the P fragment, V^T
through ldmatrix.trans) and the split-key combine. These tests show that
the mappings are bijections, that running them through numpy's m16n8k16
gives the plain versions' results (exactly when every sum is exact in
f32, to f32 rounding otherwise), that the int4 fragments hold the plain
version's bf16 weights bit for bit, that the attention emulation (online
softmax per warp, P as bf16 hi + lo, warps merged in warp order, splits in
split order) matches ``decode_attend_plain`` and ``decode_attend_paged_
plain`` on all four tiers, that a permutation applied to one operand only
(or a key missed) is caught, and that the shared-memory reads are free of
bank conflicts. The kernels themselves run only on the card
(tests/test_torch_kernels.py -m gpu). Also here: the kernel build's
library name follows the shared headers.
"""

import os

import numpy as np
import pytest
import torch

from fasttalk_tpu_torch.ops import _build
from fasttalk_tpu_torch.ops import mma_layout as L
from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul_plain
from fasttalk_tpu_torch.ops.cuda_int8 import (_split_rows, int8_matmul_plain,
                                              int8_matmul_t_plain)


def _cover(fn, dims, shape):
    """How often each cell of ``shape`` is named by ``fn`` over ``dims``."""
    hits = np.zeros(shape, np.int64)
    for idx in np.ndindex(*dims):
        hits[fn(*idx)] += 1
    return hits


@pytest.mark.parametrize("operand", ["a", "b", "c"])
def test_int8_matmul_mapping_is_a_bijection(operand):
    """Per k-step and warp: A covers x[16, 16], B (4 n8 tiles) the weight's
    16 rows x 32 columns, C the output's 16 rows x 32 columns, each cell
    once."""
    fn, dims, shape = {
        "a": (L.mm_a_source, (32, 4, 2), (16, 16)),
        "b": (L.mm_b_source, (32, 4, 2, 2), (16, 32)),
        "c": (L.mm_c_dest, (32, 4, 4), (16, 32)),
    }[operand]
    assert (_cover(fn, dims, shape) == 1).all()


@pytest.mark.parametrize("operand", ["a", "b", "c"])
def test_int8_matmul_t_mapping_is_a_bijection(operand):
    """Per 64-wide group of D (4 k-steps) and warp: A covers x[16, 64], B
    the 32 vocab rows x 64 bytes, C the output's 16 rows x 32 vocab rows."""
    fn, dims, shape = {
        "a": (L.mt_a_source, (32, 4, 4, 2), (16, 64)),
        "b": (L.mt_b_source, (32, 4, 4, 2, 2), (32, 64)),
        "c": (L.mt_c_dest, (32, 4, 4), (16, 32)),
    }[operand]
    assert (_cover(fn, dims, shape) == 1).all()


def test_a_lane_reads_contiguous_elements():
    """What the permutations buy: in ``int8_matmul`` a lane's A elements of
    a row are 4 consecutive x columns (one 8-byte read) and its B bytes of
    tile c sit on rows 4t .. 4t+3 of one column; in ``int8_matmul_t`` a
    lane's 16 elements of a 64-wide group are consecutive on its x row and
    on its vocab row (one 16-byte read each)."""
    for lane in range(32):
        t = lane & 3
        ks = sorted(L.mm_a_source(lane, r, h)[1] for r in (0, 2)
                    for h in (0, 1))
        assert ks == list(range(4 * t, 4 * t + 4))
        rows = sorted(L.mm_b_source(lane, 0, r, h)[0] for r in (0, 1)
                      for h in (0, 1))
        assert rows == ks
        ds = sorted(L.mt_b_source(lane, j, 0, r, h)[1] for j in range(4)
                    for r in (0, 1) for h in (0, 1))
        assert ds == list(range(16 * t, 16 * t + 16))
        ds = sorted(L.mt_a_source(lane, j, r, h)[1] for j in range(4)
                    for r in (0, 2) for h in (0, 1))
        assert ds == list(range(16 * t, 16 * t + 16))


def _case(shape, integer, seed):
    rng = np.random.default_rng(seed)
    m, k = shape[0], shape[1]
    x = (rng.integers(-4, 5, (m, k)) if integer
         else rng.standard_normal((m, k))).astype(np.float32)
    return rng, x


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,k,n,k_per_split", [
    (5, 100, 100, None), (17, 512, 258, 128), (3, 7, 40, None),
    (16, 256, 96, 64), (40, 64, 132, None), (1, 200, 33, 128)])
def test_int8_matmul_emulation_gives_the_plain_result(m, k, n, k_per_split,
                                                      integer):
    """Ragged M, K (K < 16 and K % 16 != 0), N, and split-K summed in split
    order: small-integer x makes every sum exact, so the emulation equals
    ``int8_matmul_plain`` bit for bit; normal x agrees to f32 rounding."""
    rng, x = _case((m, k), integer, m * k + n)
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    s = (rng.random(n) * 0.02 + 1e-3).astype(np.float32)
    got = L.emulate_int8_matmul(x, q, s, k_per_split)
    ref = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(s)).numpy()
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,v,d", [(3, 77, 40), (17, 100, 130), (1, 64, 256),
                                   (16, 33, 8), (20, 129, 200)])
def test_int8_matmul_t_emulation_gives_the_plain_result(m, v, d, integer):
    """Ragged M, V and D (D < 16 and D % 16 != 0), as above."""
    rng, x = _case((m, d), integer, m * v + d)
    q = rng.integers(-127, 128, (v, d)).astype(np.int8)
    s = (rng.random(v) * 0.02 + 1e-3).astype(np.float32)
    got = L.emulate_int8_matmul_t(x, q, s)
    ref = int8_matmul_t_plain(torch.from_numpy(x), torch.from_numpy(q),
                              torch.from_numpy(s)).numpy()
    if integer:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("kernel", ["int8_matmul", "int8_matmul_t"])
def test_a_permutation_on_one_operand_only_is_caught(kernel, monkeypatch):
    """A layout in which A takes the natural k order while B keeps the
    kernel's permutation pairs wrong x and weight elements: the emulation
    then misses the plain result, so the tests above have teeth."""
    rng = np.random.default_rng(3)
    x = rng.integers(-4, 5, (16, 64)).astype(np.float32)
    s = np.ones(32, np.float32)
    if kernel == "int8_matmul":
        q = rng.integers(-127, 128, (64, 32)).astype(np.int8)
        monkeypatch.setattr(L, "mm_a_source", L.mma_a_pos)
        got = L.emulate_int8_matmul(x, q, s)
        ref = x @ q.astype(np.float32)
    else:
        q = rng.integers(-127, 128, (32, 64)).astype(np.int8)
        monkeypatch.setattr(
            L, "mt_a_source",
            lambda lane, step, reg, half: (
                L.mma_a_pos(lane, reg, half)[0],
                16 * step + L.mma_a_pos(lane, reg, half)[1] % 16))
        got = L.emulate_int8_matmul_t(x, q, s)
        ref = x @ q.astype(np.float32).T
    assert not np.array_equal(got, ref)


@pytest.mark.parametrize("read", ["mm_b", "mm_a", "mt_b", "mt_a"])
def test_shared_memory_reads_are_conflict_free(read):
    """Every warp-wide shared-memory read of the two kernels' inner loops
    (B words and A elements) is served without a bank conflict."""
    cases = {
        "mm_b": (4, [[L.mm_b_read(w, ln, st, e) for ln in range(32)]
                     for w in range(4) for st in range(4)
                     for e in range(4)]),
        "mm_a": (8, [[L.mm_a_read(ln, st, u) for ln in range(32)]
                     for st in range(4) for u in range(2)]),
        "mt_b": (16, [[L.mt_b_read(w, ln, h, nt) for ln in range(32)]
                      for w in range(4) for h in range(2)
                      for nt in range(4)]),
        "mt_a": (16, [[L.mt_a_read(ln, h, u, p) for ln in range(32)]
                      for h in range(2) for u in range(2)
                      for p in range(2)]),
    }
    width, reads = cases[read]
    assert [L.bank_conflicts(a, width) for a in reads] == [0] * len(reads)


@pytest.mark.parametrize("kernel", ["int8_matmul", "int8_matmul_t"])
def test_the_weight_swizzle_is_needed_and_a_permutation(kernel,
                                                        monkeypatch):
    """The chunk swizzle permutes each 128-byte stage row's 8 chunks, and
    without it the B reads conflict (the count the swizzle removes)."""
    swz = L.mm_weight_chunk if kernel == "int8_matmul" else L.mt_weight_chunk
    for row in range(128):
        assert sorted(swz(row, j) for j in range(8)) == list(range(8))
    name = "mm_weight_chunk" if kernel == "int8_matmul" else "mt_weight_chunk"
    monkeypatch.setattr(L, name, lambda row, chunk: chunk)
    if kernel == "int8_matmul":
        extra = L.bank_conflicts([L.mm_b_read(0, ln, 0, 0)
                                  for ln in range(32)], 4)
    else:
        extra = L.bank_conflicts([L.mt_b_read(0, ln, 0, 0)
                                  for ln in range(32)], 16)
    assert extra > 0


@pytest.mark.parametrize("k,n", [(2048, 2048), (2048, 512), (2048, 8192),
                                 (8192, 2048), (100, 100), (7, 40)])
def test_split_rows_are_whole_stages(k, n):
    """``int8_matmul``'s split-K choice on a 132-SM card: every split but
    the last is a whole number of 64-row ring stages and at least 128 rows
    (8 k-steps), and a column tile has at most 16 splits (one thread
    block cluster)."""
    tiles = -(-n // 128)
    per = _split_rows(k, tiles, 132)
    splits = -(-k // per)
    assert per % 64 == 0 and per >= 128
    assert (splits - 1) * per < k <= splits * per
    assert 1 <= splits <= 16


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A changed ``csrc/*.cuh`` changes every source's library name, so an
    edited header is never served by a stale build; an unchanged tree
    keeps the name."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src, first = _build._target("k")
    assert src == os.path.join(str(csrc), "k.cu")
    assert _build._target("k")[1] == first
    (csrc / "h.cuh").write_text("// v2\n")
    second = _build._target("k")[1]
    assert second != first
    (csrc / "other.cuh").write_text("// new header\n")
    assert _build._target("k")[1] not in (first, second)
    third = _build._target("k")[1]
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("k")[1] not in (first, second, third)


# ------------------------------------------------------------ int4_matmul

def test_int4_matmul_mapping_is_a_bijection():
    """Per k-step and warp, the B registers of the four n8 tiles name each
    nibble of the 8 packed rows x 32 columns once."""
    hits = np.zeros((8, 2, 32), np.int64)
    for idx in np.ndindex(32, 4, 2, 2):
        lane, tile, reg, half = idx
        hits[L.i4_b_source(lane, tile, reg, half)] += 1
    assert (hits == 1).all()


def test_int4_b_register_is_one_packed_byte_and_one_scale():
    """What the layout buys: a B register's two halves are the two nibbles
    of one packed byte (low nibble in the low half), a lane's B bytes of a
    k-step lie in packed rows 2t and 2t+1 at the same column, and both
    halves of a register share one scale for every even G."""
    for lane in range(32):
        t = lane & 3
        for tile in range(4):
            for reg in range(2):
                lo = L.i4_b_source(lane, tile, reg, 0)
                hi = L.i4_b_source(lane, tile, reg, 1)
                assert (lo[0], lo[2]) == (hi[0], hi[2]) == (2 * t + reg,
                                                            lo[2])
                assert (lo[1], hi[1]) == (0, 1)
                for group in (2, 4, 6, 16, 64, 128):
                    for k0 in (0, 16, 112, 128, 4080):
                        row = k0 + 2 * lo[0]
                        assert L.i4_scale_source(lane, tile, reg, k0,
                                                 group) == (row // group,
                                                            lo[2])
                        assert row // group == (row + 1) // group


def _int4_case(m, k, n, group, integer, seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-4, 5, (m, k)) if integer
         else rng.standard_normal((m, k))).astype(np.float32)
    q4 = rng.integers(0, 256, (k // 2, n)).astype(np.uint8)
    if integer:
        # Power-of-two scales: every weight and every sum is exact in f32.
        s = (2.0 ** rng.integers(-4, 1, (k // group, n))).astype(np.float32)
    else:
        s = (rng.random((k // group, n)) * 0.02 + 1e-3).astype(np.float32)
    return x, q4, s


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,k,n,group,k_per_split", [
    (5, 256, 64, 128, 128), (17, 128, 32, 2, None), (16, 512, 96, 64, 128),
    (1, 256, 32, 16, None), (3, 96, 32, 6, None)])
def test_int4_matmul_emulation_gives_the_plain_result(m, k, n, group,
                                                      k_per_split, integer):
    """Every G (one scale per k-step or several), ragged M, split-K summed
    in split order: with power-of-two scales and small-integer x every sum
    is exact, so the emulation equals ``int4_matmul_plain`` bit for bit;
    with random scales and normal x it agrees to f32 rounding."""
    x, q4, s = _int4_case(m, k, n, group, integer, m * k + n + group)
    got = L.emulate_int4_matmul(x, q4, s, k_per_split)
    ref = (torch.from_numpy(x) @ _plain_weight(q4, s)).numpy()
    if integer:
        np.testing.assert_array_equal(got, ref)
        # The plain version rounds the same sums to bf16 once.
        plain = int4_matmul_plain(torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(q4), torch.from_numpy(s))
        torch.testing.assert_close(torch.from_numpy(got).to(torch.bfloat16),
                                   plain, rtol=0, atol=0)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def _plain_weight(q4, s):
    """The plain version's dequantized weight in f32 (its bf16 values)."""
    k = 2 * q4.shape[0]
    x = torch.eye(k, dtype=torch.bfloat16)
    return int4_matmul_plain(x, torch.from_numpy(q4),
                             torch.from_numpy(s)).to(torch.float32)


@pytest.mark.parametrize("group", [2, 16, 128])
def test_int4_fragments_hold_the_plain_weights_bit_for_bit(group):
    """The B fragments the kernel builds (nibble times bf16 scale, rounded
    once by the bf16x2 multiply) are the plain version's bf16 weights, on
    random scales where the rounding matters."""
    rng = np.random.default_rng(group)
    k, n = 256, 64
    q4 = rng.integers(0, 256, (k // 2, n)).astype(np.uint8)
    s = (rng.random((k // group, n)) * 0.3 + 1e-3).astype(np.float32)
    ref = _plain_weight(q4, s).numpy()
    got = np.zeros_like(ref)
    for n0 in range(0, n, 32):
        for k0 in range(0, k, 16):
            frag = L.i4_b_fragment(q4, s, group, k0, n0)
            for idx in np.ndindex(4, 32, 2, 2):
                tile, lane, reg, half = idx
                prow, nib, col = L.i4_b_source(lane, tile, reg, half)
                got[k0 + 2 * prow + nib, n0 + col] = frag[idx]
    np.testing.assert_array_equal(got, ref)


def test_int4_nibble_pairs_on_one_operand_only_are_caught(monkeypatch):
    """B taking the natural k order while A keeps the permutation pairs
    wrong x and weight elements: the emulation then misses."""
    x, q4, s = _int4_case(16, 64, 32, 16, True, 5)
    ref = L.emulate_int4_matmul(x, q4, s)

    def natural(lane, tile, reg, half):
        k, n = L.mma_b_pos(lane, reg, half)
        return k >> 1, k & 1, 4 * n + tile
    monkeypatch.setattr(L, "i4_b_source", natural)
    assert not np.array_equal(L.emulate_int4_matmul(x, q4, s), ref)


@pytest.mark.parametrize("read", ["b", "a"])
def test_int4_shared_memory_reads_are_conflict_free(read):
    if read == "b":
        reads = [[L.i4_b_read(w, ln, st, r) for ln in range(32)]
                 for w in range(4) for st in range(8) for r in range(2)]
        width = 4
    else:
        reads = [[L.i4_a_read(ln, st, u) for ln in range(32)]
                 for st in range(8) for u in range(2)]
        width = 8
    assert [L.bank_conflicts(a, width) for a in reads] == [0] * len(reads)
    for prow in range(64):
        assert sorted(L.i4_weight_chunk(prow, j) for j in range(8)) == \
            list(range(8))


@pytest.mark.parametrize("k,n,m", [(2048, 2048, 16), (2048, 512, 16),
                                   (2048, 8192, 1), (8192, 2048, 16),
                                   (256, 258, 5), (96, 7, 3), (2048, 512, 130)])
def test_int4_split_rows_are_whole_stages(k, n, m):
    """``int4_matmul``'s split-K on a 132-SM card: whole 128-row stages
    (so no split cuts a nibble pair or a 16-row k-step) and at most 16
    splits, one thread block cluster."""
    tiles = -(-n // 128) * -(-m // 64)
    per = _split_rows(k, tiles, 132, 128)
    splits = -(-k // per)
    assert per % 128 == 0
    assert (splits - 1) * per < k <= splits * per
    assert 1 <= splits <= 16


# ------------------------------------------------------ decode attention

@pytest.mark.parametrize("operand", ["qk_a", "qk_b", "qk_c", "pv_b"])
def test_attention_mappings_are_bijections(operand):
    """Per k-step of D (QK^T) or n8 tile of D (P.V): A covers the 16 query
    rows x 16 d, B (two n8 tiles of keys) the 16 keys x 16 d, the score
    accumulators 16 rows x 16 keys, and the ldmatrix.trans B of P.V the 16
    keys x 8 d of its tile, each cell once."""
    fn, dims, shape = {
        "qk_a": (lambda ln, r, h: L.qk_a_source(ln, 0, r, h), (32, 4, 2),
                 (16, 16)),
        "qk_b": (lambda ln, nt, r, h: L.qk_b_source(ln, nt, 0, r, h),
                 (32, 2, 2, 2), (16, 16)),
        "qk_c": (L.qk_c_dest, (32, 2, 4), (16, 16)),
        "pv_b": (lambda ln, r, h: (L.pv_b_source(ln, 1, r, h)[0],
                                   L.pv_b_source(ln, 1, r, h)[1] - 8),
                 (32, 2, 2), (16, 8)),
    }[operand]
    assert (_cover(fn, dims, shape) == 1).all()


def test_scores_are_the_p_fragment_and_ldmatrix_gives_b():
    """The two facts the kernel leans on: a score tile's accumulators are,
    as they lie in a lane's registers, the A fragment of P.V (row and key
    of every register half); and the registers ldmatrix.x4.trans fills
    from the V tile are B of m16n8k16 (key = the instruction's k, d = its
    n) for both n8 tiles of D it covers."""
    for lane in range(32):
        for reg in range(4):
            for half in range(2):
                assert L.pv_a_source(lane, reg, half) == \
                    L.mma_a_pos(lane, reg, half)
        for dtile in range(8):
            for reg in range(2):
                for half in range(2):
                    k, n = L.mma_b_pos(lane, reg, half)
                    assert L.pv_b_source(lane, dtile, reg, half) == \
                        (k, 8 * dtile + n)


CHUNK = L.ATT_CHUNK
ATT_LENGTHS = [1, CHUNK - 1, CHUNK, CHUNK + 1, 2048]


def _att_case(tier, t, seed, d=32, nkv=2, grp=2, bs=16):
    """Slots of ATT_LENGTHS over a 2048-key context: q, K/V (bf16 values,
    or int8 rows with token scales), dense or in a shuffled pool."""
    from fasttalk_tpu_torch.ops.kv_quant import kv_quantize

    rng = np.random.default_rng(seed)
    b, s = len(ATT_LENGTHS), 2048
    q = torch.from_numpy(rng.standard_normal((b, t, nkv * grp, d)).astype(
        np.float32)).to(torch.bfloat16).float()
    kv = [torch.from_numpy(rng.standard_normal((b, s, nkv, d)).astype(
        np.float32)) for _ in range(2)]
    if "int8" in tier:
        (k, ks), (v, vs) = (kv_quantize(x, 1) for x in kv)
    else:
        k, v = (x.to(torch.bfloat16).float() for x in kv)
        ks = vs = None
    lengths = torch.tensor([max(t, n) for n in ATT_LENGTHS],
                           dtype=torch.int32)
    tables = None
    if "paged" in tier:
        nb = s // bs
        perm = torch.from_numpy(rng.permutation(b * nb).astype(np.int32))
        tables = perm.view(b, nb)
        pool = [torch.zeros((b * nb * bs,) + x.shape[2:], dtype=x.dtype)
                for x in (k, v) + ((ks, vs) if ks is not None else ())]
        idx = (tables.long()[:, :, None] * bs
               + torch.arange(bs)[None, None]).reshape(b, s)
        for dst, src in zip(pool, (k, v, ks, vs)):
            dst[idx.reshape(-1)] = src.reshape((b * s,) + src.shape[2:])
        k, v = pool[0], pool[1]
        if ks is not None:
            ks, vs = pool[2], pool[3]
    return q, k, v, ks, vs, lengths, tables, bs


@pytest.mark.parametrize("t", [1, 4])
@pytest.mark.parametrize("tier", ["dense", "dense int8", "paged",
                                  "paged int8"])
def test_split_key_combine_matches_the_plain_attention(tier, t):
    """The kernel's arithmetic (mma fragments, online softmax per warp,
    P as bf16 hi + lo, warps merged in warp order, splits combined in
    split order) against ``decode_attend_plain`` / ``_paged_plain`` in f32,
    slot by slot, at ragged lengths around a chunk and at 2048 keys, T = 1
    and 4 (T*G = 8: one m16 tile with zero rows), the split count the
    wrapper takes for this batch on a 132-SM card holding one block an
    SM."""
    from fasttalk_tpu_torch.ops.cuda_attention import (
        decode_attend_paged_plain, decode_attend_plain, key_splits)

    q, k, v, ks, vs, lengths, tables, bs = _att_case(tier, t, 7 * t)
    b, _, nq, d = q.shape
    nkv = k.shape[-2]
    splits = key_splits(2048, nkv * b * -(-(t * nq // nkv) // 16), 132, 1)
    assert splits > 1
    if tables is None:
        ref = decode_attend_plain(q, k, v, lengths, k_scale=ks, v_scale=vs)
    else:
        ref = decode_attend_paged_plain(q, k, v, lengths, tables,
                                        block_size=bs, k_scale=ks,
                                        v_scale=vs)
    np_ = (lambda x: None if x is None else x.numpy())
    got = L.emulate_decode_attend(
        q.numpy(), k.float().numpy(), v.float().numpy(), lengths.numpy(),
        splits, k_scale=np_(ks), v_scale=np_(vs), tables=np_(tables),
        block_size=bs)
    ref = ref.numpy()
    for slot in range(b):
        err = np.abs(got[slot] - ref[slot]).max()
        assert err <= 1e-4 * np.abs(ref[slot]).max(), (slot, err)


def test_split_key_emulation_is_held_to_the_keys():
    """The comparison above has teeth: the emulation with one key less on
    a slot (its length cut by one) misses the plain result on that slot."""
    from fasttalk_tpu_torch.ops.cuda_attention import decode_attend_plain

    q, k, v, _, _, lengths, _, _ = _att_case("dense", 1, 3)
    ref = decode_attend_plain(q, k, v, lengths).numpy()
    short = lengths.clone()
    short[3] -= 1
    got = L.emulate_decode_attend(q.numpy(), k.numpy(), v.numpy(),
                                  short.numpy(), 2)
    slot = 3
    assert np.abs(got[slot] - ref[slot]).max() > \
        1e-2 * np.abs(ref[slot]).max()


@pytest.mark.parametrize("keys,blocks,per_sm,want", [
    (2048, 128, 3, 3), (2048, 128, 5, 5), (8192, 128, 3, 3),
    (2048, 256, 3, 1), (2048, 8, 3, 8), (100, 8, 3, 2), (16, 128, 5, 1)])
def test_key_splits_keep_one_wave(keys, blocks, per_sm, want):
    """The split count fills one wave of resident blocks on a 132-SM card
    (16 slots x 8 KV heads: 3 splits where 3 blocks fit an SM, 5 where 5
    do), never more chunks than the keys hold nor more than a cluster of
    8, and at least 1."""
    from fasttalk_tpu_torch.ops.cuda_attention import key_splits

    got = key_splits(keys, blocks, 132, per_sm)
    assert got == want
    assert got * blocks <= max(blocks, 132 * per_sm)
