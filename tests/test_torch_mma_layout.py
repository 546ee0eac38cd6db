"""The tensor-core fragment layouts of ``csrc/int8_matmul.cu``, on the CPU.

``fasttalk_tpu_torch/ops/mma_layout.py`` writes out which x element and
which weight byte each lane's mma registers hold in ``int8_matmul`` and
``int8_matmul_t``, which output each accumulator is, and where each lane
reads shared memory. These tests show that the mappings are bijections,
that running them through numpy's m16n8k16 gives the plain versions'
results (exactly when every sum is exact in f32, to f32 rounding
otherwise), that a permutation applied to one operand only is caught, and
that the shared-memory reads are free of bank conflicts. The kernels
themselves run only on the card (tests/test_torch_kernels.py -m gpu).
Also here: the kernel build's library name follows the shared headers.
"""

import os

import numpy as np
import pytest
import torch

from fasttalk_tpu_torch.ops import _build
from fasttalk_tpu_torch.ops import mma_layout as L
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
