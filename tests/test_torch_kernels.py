"""fasttalk_tpu_torch's CUDA kernels held against their plain versions.

The tests marked ``gpu`` need a CUDA device and nvcc; elsewhere their
fixture skips them. On a machine with the card run

    python -m pytest tests/test_torch_kernels.py -m gpu -q

Tolerances: kernel and plain version both accumulate in f32 and cast to
bf16 once, so they differ by summation order plus at most one bf16
rounding step of the output. The matmuls are held to 1% of the output's
largest magnitude. ``decode_attend`` is held slot by slot, to 1% of each
slot's own largest output (``chip_smoke.attend_slot_gaps``, the criterion
the card run uses); the CPU tests below show that this criterion catches
one key too many or too few at a tile edge and a dropped key tile.
"""

import importlib.util
import os

import pytest
import torch

from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                   decode_attend_plain)
from fasttalk_tpu_torch.ops.cuda_int8 import (int8_matmul, int8_matmul_plain,
                                              int8_matmul_t,
                                              int8_matmul_t_plain)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run "
                    "`python -m pytest tests/test_torch_kernels.py -m gpu` "
                    "on the GPU machine")
    return torch.device("cuda")


def _close(got, ref):
    got, ref = got.float(), ref.float()
    err = (got - ref).abs().max().item()
    assert err <= 1e-2 * ref.abs().max().item(), err


def _int8(shape, gen, device):
    return torch.randint(-127, 128, shape, generator=gen, device=device,
                         dtype=torch.int8)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 2048, 512), (1, 256, 384),
                                   (5, 100, 100), (17, 512, 258),
                                   (40, 64, 1024)])
def test_int8_matmul_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    q = _int8((k, n), g, cuda)
    s = torch.rand((n,), generator=g, device=cuda) * 0.02
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    before = int8_matmul.launches
    _close(int8_matmul(x, q, s), int8_matmul_plain(x, q, s))
    assert int8_matmul.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,v,d", [(16, 4096, 2048), (1, 1000, 256),
                                   (3, 77, 40), (20, 2048, 512)])
def test_int8_matmul_t_matches_plain(cuda, m, v, d):
    g = torch.Generator(device=cuda).manual_seed(m * v + d)
    q = _int8((v, d), g, cuda)
    s = torch.rand((v,), generator=g, device=cuda) * 0.02
    x = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    before = int8_matmul_t.launches
    _close(int8_matmul_t(x, q, s), int8_matmul_t_plain(x, q, s))
    assert int8_matmul_t.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("t,nq,nkv,d", [(1, 32, 8, 64), (3, 8, 2, 32),
                                        (4, 32, 8, 64), (1, 16, 2, 128),
                                        (2, 4, 4, 16)])
def test_decode_attend_matches_plain(cuda, t, nq, nkv, d):
    g = torch.Generator(device=cuda).manual_seed(t * nq + d)
    b, s_full, s = 6, 1024, 512
    cache_k = torch.randn((b, s_full, nkv, d), generator=g,
                          device=cuda).to(torch.bfloat16)
    cache_v = torch.randn((b, s_full, nkv, d), generator=g,
                          device=cuda).to(torch.bfloat16)
    # A batch-strided slice of the cache, as forward_decode passes it.
    k, v = cache_k[:, :s], cache_v[:, :s]
    lengths = torch.tensor([t, 31, 32, 33, 257, 512], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((b, t, nq, d), generator=g, device=cuda).to(torch.bfloat16)
    q_in = q[:, 0] if t == 1 else q
    before = decode_attend.launches
    got = decode_attend(q_in, k, v, lengths)
    assert got.shape == q_in.shape
    gaps = chip_smoke.attend_slot_gaps(got, decode_attend_plain(q_in, k, v,
                                                                lengths))
    assert bool((gaps <= chip_smoke.ATTEND_SLOT_TOL).all()), gaps.tolist()
    assert decode_attend.launches == before + 1


@pytest.mark.gpu
def test_kernels_give_the_same_bits_on_every_call(cuda):
    """Split-K partials and the attention warps' states are summed in a
    fixed order, so repeated calls agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((16, 2048), generator=g, device=cuda).to(torch.bfloat16)
    q = _int8((2048, 512), g, cuda)
    s = torch.rand((512,), generator=g, device=cuda) * 0.02
    first = int8_matmul(x, q, s)
    for _ in range(5):
        assert torch.equal(int8_matmul(x, q, s), first)
    k = torch.randn((4, 1024, 8, 64), generator=g,
                    device=cuda).to(torch.bfloat16)
    qa = torch.randn((4, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    lengths = torch.tensor([1, 129, 700, 1024], dtype=torch.int32,
                           device=cuda)
    first = decode_attend(qa, k, k, lengths)
    for _ in range(5):
        assert torch.equal(decode_attend(qa, k, k, lengths), first)


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda)  # float32 activations
    q = torch.zeros((64, 64), dtype=torch.int8, device=cuda)
    s = torch.ones((64,), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        int8_matmul(x, q, s)
    with pytest.raises(ValueError, match="CUDA"):
        int8_matmul(x.to(torch.bfloat16), q.cpu(), s)
    qa = torch.zeros((2, 40, 4, 32), dtype=torch.bfloat16, device=cuda)
    kv = torch.zeros((2, 64, 1, 32), dtype=torch.bfloat16, device=cuda)
    lengths = torch.ones((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="T\\*G"):
        decode_attend(qa, kv, kv, lengths)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU every wrapper computes its plain version and launches
    nothing (the launch counts stay put)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 64), generator=g)
    q = torch.randint(-127, 128, (64, 32), generator=g, dtype=torch.int8)
    s = torch.rand((32,), generator=g)
    counts = (int8_matmul.launches, int8_matmul_t.launches,
              decode_attend.launches)
    torch.testing.assert_close(int8_matmul(x, q, s),
                               int8_matmul_plain(x, q, s))
    torch.testing.assert_close(int8_matmul_t(x, q.T.contiguous(), s),
                               int8_matmul_t_plain(x, q.T.contiguous(), s))
    kv = torch.randn((3, 16, 2, 16), generator=g)
    qa = torch.randn((3, 4, 16), generator=g)
    lengths = torch.tensor([1, 8, 16], dtype=torch.int32)
    torch.testing.assert_close(decode_attend(qa, kv, kv, lengths),
                               decode_attend_plain(qa, kv, kv, lengths))
    assert counts == (int8_matmul.launches, int8_matmul_t.launches,
                      decode_attend.launches)


@pytest.mark.parametrize("t", [1, 4])
def test_attend_slot_tolerance_catches_a_key_off_and_a_dropped_tile(t):
    """What the per-slot criterion must reject, shown with the plain
    version: one key too few or too many at the 32-key tile edges and at
    127/128/129, and the last 32-key tile of a 2048-key slot left out.
    Slots the fault does not touch stay exactly equal."""
    g = torch.Generator().manual_seed(0)
    b, s, nq, nkv, d = 8, 2048, 8, 2, 64
    lens = [4, 127, 128, 129, 2048, 31, 32, 33]
    k = torch.randn((b, s, nkv, d), generator=g)
    v = torch.randn((b, s, nkv, d), generator=g)
    q = torch.randn((b, t, nq, d), generator=g)
    ref = decode_attend_plain(q, k, v, torch.tensor(lens, dtype=torch.int32))
    faults = [[n + delta if n < s else n for n in lens] for delta in (-1, 1)]
    faults.append([n - 32 if n == s else n for n in lens])
    for wrong in faults:
        gaps = chip_smoke.attend_slot_gaps(decode_attend_plain(
            q, k, v, torch.tensor(wrong, dtype=torch.int32)), ref)
        for slot, (n, m) in enumerate(zip(lens, wrong)):
            if n == m:
                assert gaps[slot].item() == 0.0
            else:
                assert gaps[slot].item() > chip_smoke.ATTEND_SLOT_TOL, \
                    (n, m, gaps[slot].item())
