"""fasttalk_tpu_torch's CUDA kernels held against their plain versions.

The tests marked ``gpu`` need a CUDA device and nvcc; elsewhere their
fixture skips them. On a machine with the card run

    python -m pytest tests/test_torch_kernels.py -m gpu -q

Tolerances: kernel and plain version both accumulate in f32 and cast to
bf16 once (the int8 matmuls multiply on the bf16 tensor cores, where every
int8 weight and bf16 x is exact), so they differ by summation order plus
at most one bf16 rounding step of the output. The matmuls (``int8_matmul``,
``int8_matmul_t``, ``int4_matmul``) are held to 1% of the output's largest
magnitude. ``decode_attend`` and ``decode_attend_paged`` (bf16 and
int8 rows) are held slot by slot, to 1% of each slot's own largest output
(``chip_smoke.attend_slot_gaps``, the criterion the card run uses); the CPU
tests below show that this criterion catches one key too many or too few
at a tile edge, a dropped key tile, a block of another slot read in place
of the slot's own, and the partial last block read one key short or long.
"""

import importlib.util
import os

import pytest
import torch

from fasttalk_tpu_torch.ops.cuda_attention import (decode_attend,
                                                   decode_attend_paged,
                                                   decode_attend_paged_plain,
                                                   decode_attend_plain)
from fasttalk_tpu_torch.ops.cuda_int4 import int4_matmul, int4_matmul_plain
from fasttalk_tpu_torch.ops.cuda_int8 import (int8_matmul, int8_matmul_plain,
                                              int8_matmul_t,
                                              int8_matmul_t_plain)
from fasttalk_tpu_torch.ops.kv_quant import kv_quantize

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
@pytest.mark.parametrize("m,k,n", [
    (16, 2048, 512), (1, 256, 384), (5, 100, 100), (17, 512, 258),
    (40, 64, 1024),
    # The four Llama-3.2-1B decode shapes at M = 16 and M = 1.
    (16, 2048, 2048), (16, 2048, 8192), (16, 8192, 2048), (1, 2048, 2048),
    (1, 2048, 512), (1, 2048, 8192), (1, 8192, 2048),
    # M over one, two and four m16 tiles and past one 64-row block.
    (64, 2048, 512), (17, 1024, 640), (65, 256, 256), (130, 192, 128),
    # N not a multiple of the 128-column tile (16-aligned and not), K not
    # a multiple of 16 (and K < 16), K over many splits.
    (16, 512, 208), (16, 512, 200), (16, 24, 512), (3, 7, 40),
    (16, 1000, 384), (64, 8192, 256)])
def test_int8_matmul_matches_plain(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m * k + n)
    q = _int8((k, n), g, cuda)
    s = torch.rand((n,), generator=g, device=cuda) * 0.02
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    before = int8_matmul.launches
    _close(int8_matmul(x, q, s), int8_matmul_plain(x, q, s))
    assert int8_matmul.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,v,d", [
    (16, 4096, 2048), (1, 1000, 256), (3, 77, 40), (20, 2048, 512),
    # The full-size lm_head at M = 16 and M = 1.
    (16, 128256, 2048), (1, 128256, 2048),
    # M over one, two and four m16 tiles and past one 64-row block; V not
    # a multiple of the 128-row tile (and odd); D not a multiple of 16 (and
    # D < 16) or of the 128-byte stage.
    (17, 1000, 256), (40, 300, 2048), (64, 129, 512), (70, 256, 128),
    (16, 77, 8), (16, 1001, 200), (16, 500, 1040)])
def test_int8_matmul_t_matches_plain(cuda, m, v, d):
    g = torch.Generator(device=cuda).manual_seed(m * v + d)
    q = _int8((v, d), g, cuda)
    s = torch.rand((v,), generator=g, device=cuda) * 0.02
    x = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    before = int8_matmul_t.launches
    _close(int8_matmul_t(x, q, s), int8_matmul_t_plain(x, q, s))
    assert int8_matmul_t.launches == before + 1


def _int4_case(m, k, n, group, gen, device):
    q4 = torch.randint(0, 256, (k // 2, n), generator=gen, device=device,
                       dtype=torch.uint8)
    s = torch.rand((k // group, n), generator=gen, device=device) * 0.02 + 1e-3
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    return x, q4, s


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,group", [
    (16, 2048, 2048, 128), (16, 2048, 512, 128), (16, 2048, 8192, 128),
    (16, 8192, 2048, 128), (1, 2048, 512, 128), (1, 2048, 2048, 128),
    (1, 2048, 8192, 128), (1, 8192, 2048, 128), (16, 2048, 512, 64),
    (5, 256, 258, 64), (40, 192, 1024, 64), (3, 96, 7, 2),
    (17, 1024, 640, 128), (64, 2048, 512, 128), (130, 512, 256, 32),
    (16, 1000, 384, 8), (16, 2046, 200, 6)])
def test_int4_matmul_matches_plain(cuda, m, k, n, group):
    """The four Llama-3.2-1B decode shapes at G = 128 (M = 16 and 1), G =
    64, and ragged shapes: N % 4 != 0 and N % 16 != 0, M over one, two and
    four 16-row tiles and past a 64-row block, K not a multiple of the
    128-row stage, G below a 16-row k-step and not a multiple of 4."""
    g = torch.Generator(device=cuda).manual_seed(m * k + n + group)
    x, q4, s = _int4_case(m, k, n, group, g, cuda)
    before = int4_matmul.launches
    _close(int4_matmul(x, q4, s), int4_matmul_plain(x, q4, s))
    assert int4_matmul.launches == before + 1


@pytest.mark.gpu
def test_int4_matmul_gives_the_same_bits_on_every_call(cuda):
    g = torch.Generator(device=cuda).manual_seed(17)
    x, q4, s = _int4_case(16, 2048, 8192, 128, g, cuda)
    first = int4_matmul(x, q4, s)
    for _ in range(5):
        assert torch.equal(int4_matmul(x, q4, s), first)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 16, 17, 64])
@pytest.mark.parametrize("k,n", [(2048, 8192), (8192, 2048)])
def test_int4_matmul_replays_in_a_cuda_graph(cuda, m, k, n):
    """Captured in a CUDA graph and replayed three times, the kernel gives
    an eager call's bits each time (its splits meet in a cluster, so a
    replay carries no state of the previous one)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x, q4, s = _int4_case(m, k, n, 128, g, cuda)
    eager = int4_matmul(x, q4, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int4_matmul(x, q4, s)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(int4_matmul(x, q4, s), eager)


@pytest.mark.gpu
def test_int4_matmul_refuses_what_the_kernel_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(19)
    x, q4, s = _int4_case(4, 256, 64, 64, g, cuda)
    with pytest.raises(ValueError, match="K must be even"):
        int4_matmul(x[:, :255].contiguous(), q4, s)
    with pytest.raises(ValueError, match="do not split"):
        int4_matmul(x, q4, s[:3].contiguous())
    with pytest.raises(ValueError, match="bfloat16"):
        int4_matmul(x.float(), q4, s)
    with pytest.raises(ValueError, match="CUDA"):
        int4_matmul(x, q4.cpu(), s)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(x, q4.T.contiguous().T, s)


@pytest.mark.gpu
@pytest.mark.parametrize("t,nq,nkv,d", [(1, 32, 8, 64), (3, 8, 2, 32),
                                        (4, 32, 8, 64), (1, 16, 2, 128),
                                        (2, 4, 4, 16), (8, 32, 8, 64)])
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


def _int8_rows(shape, granule, gen, device, scale=1.0):
    """Random K/V rows quantized as the int8 tier stores them."""
    x = torch.randn(shape, generator=gen, device=device) * scale
    return kv_quantize(x, shape[-2] if granule == "head" else 1)


def _paged_case(gen, device, *, b, t, nq, nkv, d, bs, nb, pool_blocks,
                int8, granule="token", k_mult=3.0):
    """A pool with shuffled, distinct blocks per slot, and q/lengths."""
    perm = torch.randperm(pool_blocks, generator=torch.Generator().manual_seed(
        b * nb + bs))[:b * nb]
    tables = perm.view(b, nb).to(torch.int32).to(device)
    shape = (pool_blocks * bs, nkv, d)
    if int8:
        (k, ks), (v, vs) = (_int8_rows(shape, granule, gen, device, k_mult),
                            _int8_rows(shape, granule, gen, device))
    else:
        k = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        ks = vs = None
    q = torch.randn((b, t, nq, d), generator=gen, device=device).to(
        torch.bfloat16)
    return q, k, v, ks, vs, tables


@pytest.mark.gpu
@pytest.mark.parametrize("granule", ["token", "head"])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_decode_attend_int8_matches_plain(cuda, granule, t):
    """Int8 rows with [B, S, G] scales, read from a batch-strided slice of
    a longer cache, as forward_decode passes them."""
    g = torch.Generator(device=cuda).manual_seed(11 * t)
    b, s_full, s, nq, nkv, d = 6, 1024, 512, 32, 8, 64
    (ck, cks), (cv, cvs) = (_int8_rows((b, s_full, nkv, d), granule, g, cuda),
                            _int8_rows((b, s_full, nkv, d), granule, g, cuda))
    k, v, ks, vs = ck[:, :s], cv[:, :s], cks[:, :s], cvs[:, :s]
    lengths = torch.tensor([t, 31, 32, 33, 257, 512], dtype=torch.int32,
                           device=cuda)
    q = torch.randn((b, t, nq, d), generator=g, device=cuda).to(torch.bfloat16)
    before = (decode_attend.launches, decode_attend.launches_int8)
    got = decode_attend(q, k, v, lengths, k_scale=ks, v_scale=vs)
    gaps = chip_smoke.attend_slot_gaps(got, decode_attend_plain(
        q, k, v, lengths, k_scale=ks, v_scale=vs))
    assert bool((gaps <= chip_smoke.ATTEND_SLOT_TOL).all()), gaps.tolist()
    assert (decode_attend.launches, decode_attend.launches_int8) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 4, 8])
def test_decode_attend_paged_matches_plain(cuda, int8, t):
    """Shuffled tables over the pool; lengths at block edges 15/16/17."""
    g = torch.Generator(device=cuda).manual_seed(13 * t + int8)
    b, nq, nkv, d, bs, nb = 6, 32, 8, 64, 16, 32
    q, k, v, ks, vs, tables = _paged_case(
        g, cuda, b=b, t=t, nq=nq, nkv=nkv, d=d, bs=bs, nb=nb,
        pool_blocks=b * nb + 7, int8=int8, granule="head" if t == 4
        else "token")
    lengths = torch.tensor([t, 15, 16, 17, 300, nb * bs], dtype=torch.int32,
                           device=cuda)
    before = decode_attend_paged.launches
    got = decode_attend_paged(q, k, v, lengths, tables, block_size=bs,
                              k_scale=ks, v_scale=vs)
    gaps = chip_smoke.attend_slot_gaps(got, decode_attend_paged_plain(
        q, k, v, lengths, tables, block_size=bs, k_scale=ks, v_scale=vs))
    assert bool((gaps <= chip_smoke.ATTEND_SLOT_TOL).all()), gaps.tolist()
    assert decode_attend_paged.launches == before + 1


@pytest.mark.gpu
def test_kernels_give_the_same_bits_on_every_call(cuda):
    """Split-K partials and the attention warps' states are summed in a
    fixed order, so repeated calls agree bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for k, n in ((2048, 512), (8192, 2048)):
        x = torch.randn((16, k), generator=g, device=cuda).to(torch.bfloat16)
        q = _int8((k, n), g, cuda)
        s = torch.rand((n,), generator=g, device=cuda) * 0.02
        first = int8_matmul(x, q, s)
        for _ in range(5):
            assert torch.equal(int8_matmul(x, q, s), first)
    x = torch.randn((16, 2048), generator=g, device=cuda).to(torch.bfloat16)
    q = _int8((4096, 2048), g, cuda)
    s = torch.rand((4096,), generator=g, device=cuda) * 0.02
    first = int8_matmul_t(x, q, s)
    for _ in range(5):
        assert torch.equal(int8_matmul_t(x, q, s), first)
    k = torch.randn((4, 1024, 8, 64), generator=g,
                    device=cuda).to(torch.bfloat16)
    qa = torch.randn((4, 32, 64), generator=g, device=cuda).to(torch.bfloat16)
    lengths = torch.tensor([1, 129, 700, 1024], dtype=torch.int32,
                           device=cuda)
    first = decode_attend(qa, k, k, lengths)
    for _ in range(5):
        assert torch.equal(decode_attend(qa, k, k, lengths), first)
    (k8, s8), = (_int8_rows((4, 1024, 8, 64), "token", g, cuda),)
    first = decode_attend(qa, k8, k8, lengths, k_scale=s8, v_scale=s8)
    for _ in range(5):
        assert torch.equal(decode_attend(qa, k8, k8, lengths, k_scale=s8,
                                         v_scale=s8), first)
    for int8 in (False, True):
        q, kp, vp, ks, vs, tables = _paged_case(
            g, cuda, b=4, t=1, nq=32, nkv=8, d=64, bs=16, nb=64,
            pool_blocks=300, int8=int8)
        first = decode_attend_paged(q, kp, vp, lengths, tables, block_size=16,
                                    k_scale=ks, v_scale=vs)
        for _ in range(5):
            assert torch.equal(decode_attend_paged(
                q, kp, vp, lengths, tables, block_size=16, k_scale=ks,
                v_scale=vs), first)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16, 2048, 2048), (16, 2048, 512),
                                   (16, 8192, 2048), (1, 2048, 8192),
                                   (40, 1000, 200)])
def test_int8_matmul_replays_in_a_cuda_graph(cuda, m, k, n):
    """Captured in a CUDA graph and replayed three times, the kernel gives
    an eager call's bits each time (split-K shapes included: a replay
    carries no state of the previous one)."""
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=cuda).to(torch.bfloat16)
    q = _int8((k, n), g, cuda)
    s = torch.rand((n,), generator=g, device=cuda) * 0.02
    eager = int8_matmul(x, q, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul(x, q, s)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(int8_matmul(x, q, s), eager)


@pytest.mark.gpu
@pytest.mark.parametrize("m,v,d", [(16, 128256, 2048), (1, 1000, 256),
                                   (40, 77, 40)])
def test_int8_matmul_t_replays_in_a_cuda_graph(cuda, m, v, d):
    """The lm_head kernel captured and replayed three times gives an
    eager call's bits each time."""
    g = torch.Generator(device=cuda).manual_seed(m + v + d)
    x = torch.randn((m, d), generator=g, device=cuda).to(torch.bfloat16)
    q = _int8((v, d), g, cuda)
    s = torch.rand((v,), generator=g, device=cuda) * 0.02
    eager = int8_matmul_t(x, q, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = int8_matmul_t(x, q, s)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 4, 5])
@pytest.mark.parametrize("paged,int8", [(False, False), (False, True),
                                        (True, False), (True, True)])
def test_decode_attend_replays_in_a_cuda_graph(cuda, paged, int8, t):
    """Each attention tier captured in a CUDA graph and replayed three
    times gives an eager call's bits each time, at T*G = 4, 16 and 20 (two
    row groups): the key splits meet in a cluster, so a replay carries no
    state of the previous one, and the split count depends on shapes only."""
    g = torch.Generator(device=cuda).manual_seed(29 * t + 2 * paged + int8)
    b, nq, nkv, d, bs, nb = 6, 32, 8, 64, 16, 64
    q, kp, vp, ks, vs, tables = _paged_case(
        g, cuda, b=b, t=t, nq=nq, nkv=nkv, d=d, bs=bs, nb=nb,
        pool_blocks=b * nb + 3, int8=int8)
    lengths = torch.tensor([t, 63, 64, 65, 700, nb * bs], dtype=torch.int32,
                           device=cuda)
    if paged:
        def call():
            return decode_attend_paged(q, kp, vp, lengths, tables,
                                       block_size=bs, k_scale=ks, v_scale=vs)
    else:
        # The same rows as a dense [B, S, ...] cache.
        shape = (b, nb * bs)
        idx = (tables.long()[:, :, None] * bs
               + torch.arange(bs, device=cuda)).reshape(-1)
        kd, vd = kp[idx].view(*shape, nkv, d), vp[idx].view(*shape, nkv, d)
        ksd = None if ks is None else ks[idx].view(*shape, -1)
        vsd = None if vs is None else vs[idx].view(*shape, -1)

        def call():
            return decode_attend(q, kd, vd, lengths, k_scale=ksd,
                                 v_scale=vsd)
    eager = call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(call(), eager)


@pytest.mark.gpu
def test_int8_matmul_takes_unaligned_views(cuda):
    """Weights or x that are not 16-byte aligned (a view one element in)
    take the kernel's plain-load staging and give the same result."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((16 * 2048 + 1,), generator=g,
                    device=cuda).to(torch.bfloat16)
    q = _int8((2048 * 512 + 1,), g, cuda)
    s = torch.rand((512,), generator=g, device=cuda) * 0.02
    xv, qv = x[1:].view(16, 2048), q[1:].view(2048, 512)
    assert xv.data_ptr() % 16 != 0 and qv.data_ptr() % 16 != 0
    _close(int8_matmul(xv, qv, s), int8_matmul_plain(xv, qv, s))
    qt = q[1:].view(512, 2048)
    st = torch.rand((512,), generator=g, device=cuda) * 0.02
    _close(int8_matmul_t(xv, qt, st), int8_matmul_t_plain(xv, qt, st))


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
    with pytest.raises(ValueError, match="int8 k/v come with float32"):
        decode_attend(qa, kv.to(torch.int8), kv.to(torch.int8), lengths)
    with pytest.raises(ValueError, match="D=200"):
        decode_attend(torch.zeros((2, 1, 4, 200), dtype=torch.bfloat16,
                                  device=cuda),
                      torch.zeros((2, 8, 1, 200), dtype=torch.bfloat16,
                                  device=cuda),
                      torch.zeros((2, 8, 1, 200), dtype=torch.bfloat16,
                                  device=cuda), lengths)
    pool = torch.zeros((100, 1, 32), dtype=torch.bfloat16, device=cuda)
    tables = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="not divisible"):
        decode_attend_paged(qa[:, 0].contiguous(), pool, pool, lengths,
                            tables, block_size=16)


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
    tables = torch.tensor([[2], [0], [1]], dtype=torch.int32)
    pool = kv.reshape(48, 2, 16)
    torch.testing.assert_close(
        decode_attend_paged(qa, pool, pool, lengths, tables, block_size=16),
        decode_attend_paged_plain(qa, pool, pool, lengths, tables,
                                  block_size=16))
    assert counts == (int8_matmul.launches, int8_matmul_t.launches,
                      decode_attend.launches)
    assert decode_attend_paged.launches == 0


def test_int4_matmul_on_the_cpu_is_its_plain_version():
    """A CPU tensor computes the plain version and launches nothing; the
    shape checks run before the device dispatch (odd K, groups that do not
    split K evenly)."""
    g = torch.Generator().manual_seed(1)
    x, q4, s = _int4_case(3, 128, 40, 32, g, "cpu")
    before = int4_matmul.launches
    torch.testing.assert_close(int4_matmul(x, q4, s),
                               int4_matmul_plain(x, q4, s), rtol=0, atol=0)
    assert int4_matmul.launches == before
    with pytest.raises(ValueError, match="K must be even"):
        int4_matmul(x[:, :127], q4, s)
    with pytest.raises(ValueError, match="do not split"):
        int4_matmul(x, q4, s[:3])
    with pytest.raises(ValueError, match="do not split"):
        int4_matmul(x[:, :126], q4[:63], s[:2])


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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 4])
def test_attend_slot_tolerance_catches_a_wrong_paged_read(t, int8):
    """What the per-slot criterion must reject in the paged read, shown
    with the plain version: one of a slot's blocks swapped for a block of
    another slot, and the partial last block read one key short or long
    (lengths 15/17/33 inside a block, 16 at its edge). Slots the fault
    does not touch stay exactly equal."""
    b, nq, nkv, d, bs, nb = 6, 8, 2, 64, 16, 16
    q, k, v, ks, vs, tables = _paged_case(
        torch.Generator().manual_seed(t), "cpu", b=b, t=t, nq=nq, nkv=nkv,
        d=d, bs=bs, nb=nb, pool_blocks=b * nb, int8=int8, k_mult=1.0)
    q, k, v = q.float(), (k if int8 else k.float()), (v if int8 else v.float())
    lens = [15, 16, 17, 33, 100, 255]
    kw = dict(block_size=bs, k_scale=ks, v_scale=vs)
    ref = decode_attend_paged_plain(q, k, v, torch.tensor(
        lens, dtype=torch.int32), tables, **kw)

    def gaps(wrong_lens, wrong_tables):
        return chip_smoke.attend_slot_gaps(decode_attend_paged_plain(
            q, k, v, torch.tensor(wrong_lens, dtype=torch.int32),
            wrong_tables, **kw), ref)

    for slot in range(b):
        # The slot's block holding key 0 replaced by another slot's block.
        swapped = tables.clone()
        swapped[slot, 0] = tables[(slot + 1) % b, 0]
        got = gaps(lens, swapped)
        for other in range(b):
            if other == slot:
                assert got[other].item() > chip_smoke.ATTEND_SLOT_TOL, \
                    (slot, got[other].item())
            else:
                assert got[other].item() == 0.0
    for delta in (-1, 1):
        wrong = [n + delta for n in lens]
        got = gaps(wrong, tables)
        for slot in range(b):
            assert got[slot].item() > chip_smoke.ATTEND_SLOT_TOL, \
                (lens[slot], delta, got[slot].item())
