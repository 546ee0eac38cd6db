"""Batched prefill and shared-prefix reuse in fasttalk_tpu_torch, on the
CPU, mirroring tests/test_shared_prefix.py.

A fresh session whose prompt starts with rows resident in another slot
gets them without a prefill (dense: a row copy rounded down to the 16-token
granule, the JAX engine's count; paged: the source's full blocks aliased,
a partially shared tail block copied); a burst of fresh sessions with one
long system prompt prefills its longest prompt first and gives the shared
rows to the others (on the paged pool by aliasing, where the JAX engine's
dense stamp fails). On a tight pool the aliased sessions fit where copies
would shed, as in the JAX engine. The bar is JAX's: greedy streams
identical to an engine without sharing, the copy safe while the source
decodes, divergent prompts never share, a share that cannot shrink the
prefill bucket is skipped; the port's shared-token count equals the JAX
engine's on the same prompts. A burst of 4 fresh requests prefills in one
batched call, with the streams of one-at-a-time requests.
"""

import asyncio

import jax
import pytest
import torch

from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.slots import SlotManager, _lcp
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from tests._port_isolation import port_isolation  # noqa: F401,E402

TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
SYSTEM = ("You are a terse voice assistant for a realtime app; answer "
          "in one short sentence and never speculate about anything.")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(seed: int) -> dict:
    return init_params(TINY, torch.Generator().manual_seed(seed),
                       torch.float32, "cpu")


def _engine(params, shared=True, **kw) -> TorchEngine:
    opts = dict(num_slots=4, max_len=512, prefill_chunk=64, seed=0,
                dtype=torch.float32, shared_prefix=shared)
    opts.update(kw)
    eng = TorchEngine(TINY, params, ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


async def _stream(eng, rid, messages, n):
    text = ""
    async for ev in eng.generate(rid, f"s-{rid}", messages,
                                 GenerationParams(max_tokens=n, **GREEDY)):
        if ev["type"] == "token":
            text += ev["text"]
        elif ev["type"] == "error":
            raise AssertionError(ev)
    return text


def _gen(eng, rid, prompt, n=24, system=SYSTEM):
    return asyncio.run(asyncio.wait_for(_stream(
        eng, rid, [{"role": "system", "content": system},
                   {"role": "user", "content": prompt}], n), 120))


def _jax_shared_count(prompts) -> float:
    """The JAX engine's shared-prefix tokens over the same sequential
    sessions (test-tiny, byte tokenizer; the count does not depend on
    the weights)."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.llama import init_params as jax_init
    from fasttalk_tpu.utils.metrics import get_metrics as jax_metrics

    cfg = jax_cfg("test-tiny")
    eng = TPUEngine(cfg, jax_init(cfg, jax.random.PRNGKey(3)), JaxBytes(),
                    num_slots=4, max_len=512, prefill_chunk=64, seed=0,
                    shared_prefix=True)
    eng.start()
    counter = jax_metrics().counter("engine_shared_prefix_tokens_total")
    before = counter.value

    async def run():
        for rid, prompt in prompts:
            async for _ in eng.generate(
                    rid, f"s-{rid}", [{"role": "system", "content": SYSTEM},
                                      {"role": "user", "content": prompt}],
                    JaxParams(max_tokens=4, **GREEDY)):
                pass
    try:
        asyncio.run(asyncio.wait_for(run(), 120))
    finally:
        eng.shutdown()
    return counter.value - before


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_shared_prefix_stream_identical_and_counted(layout):
    """Session b's system prompt comes from session a's slot (dense: a
    slice copy; paged: a's blocks aliased), its stream is a cold engine's,
    and the shared count is the JAX engine's."""
    params = _params(3)
    kw = dict(kv_layout="paged", kv_pool_blocks=128) \
        if layout == "paged" else {}
    cold = _engine(params, shared=False, **kw)
    try:
        _gen(cold, "a", "first question")
        ref_b = _gen(cold, "b", "second, different question")
    finally:
        cold.shutdown()
    eng = _engine(params, shared=True, **kw)
    try:
        _gen(eng, "a", "first question")
        before = eng.get_stats()["prefix_tokens_shared"]
        got_b = _gen(eng, "b", "second, different question")
        shared = eng.get_stats()["prefix_tokens_shared"] - before
        if layout == "paged":
            eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert shared > 0
    assert got_b == ref_b
    if layout == "dense":
        assert shared % 16 == 0
        assert shared == _jax_shared_count([("a", "first question"),
                                            ("b", "second, different "
                                                  "question")])


def test_shared_prefix_while_source_decoding():
    """B admitted while A decodes: both streams match a cold engine (the
    copy reads only the source's stable prompt rows)."""
    params = _params(4)

    async def pair(eng):
        async def one(rid, prompt, delay):
            await asyncio.sleep(delay)
            return await _stream(eng, rid, [
                {"role": "system", "content": SYSTEM},
                {"role": "user", "content": prompt}], 48)
        a, b = await asyncio.gather(one("a", "alpha question", 0),
                                    one("b", "beta question", 0.05))
        return {"a": a, "b": b}

    results = {}
    for shared in (False, True):
        eng = _engine(params, shared=shared)
        try:
            results[shared] = asyncio.run(asyncio.wait_for(pair(eng), 120))
        finally:
            eng.shutdown()
    assert results[True] == results[False]


def _burst(params, shared, n=4, system=SYSTEM * 3, **kw):
    eng = _engine(params, shared=shared, max_len=1024, prefill_chunk=512,
                  **kw)
    admit = eng._admit  # one admission group: hold until all are queued
    eng._admit = lambda: len(eng._sched) >= n and admit()

    async def run():
        return await asyncio.gather(*(_stream(
            eng, f"r{i}", [{"role": "system", "content": system},
                           {"role": "user", "content": f"question {i}"}], 16)
            for i in range(n)))
    try:
        texts = asyncio.run(asyncio.wait_for(run(), 120))
        return texts, eng.get_stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_intra_batch_burst_shares_leader_prefix(layout):
    """A cold burst of 4 sessions with one long system prompt: the leader
    prefills, the others get the shared rows (a copy, or the leader's
    blocks aliased) and batch-prefill only their deltas; streams identical
    to a no-sharing engine."""
    params = _params(6)
    kw = dict(kv_layout="paged", kv_pool_blocks=512) \
        if layout == "paged" else {}
    ref, _ = _burst(params, False, **kw)
    got, stats = _burst(params, True, **kw)
    assert got == ref
    assert stats["prefix_tokens_shared"] >= 3 * 64
    # Two waves: the leader alone, then the three members' deltas.
    assert (stats["batched_prefill_calls"],
            stats["batched_prefill_rows"]) == (2, 4)


def test_share_skipped_when_it_cannot_shrink_the_bucket():
    """Two ~1000-token prompts sharing a short prefix in a 1024-row
    engine: stamping would not shrink the 1024 bucket (and a non-zero
    start would not fit it); the share is skipped and the streams match."""
    params = _params(7)
    common = "C" * 100
    prompts = [common + ch * 860 for ch in "ab"]

    def burst(shared):
        eng = _engine(params, shared=shared, num_slots=2, max_len=1024,
                      prefill_chunk=512)

        async def run():
            return await asyncio.gather(*(_stream(
                eng, f"r{i}", [{"role": "user", "content": prompts[i]}], 8)
                for i in range(2)))
        try:
            texts = asyncio.run(asyncio.wait_for(run(), 120))
            return texts, eng.get_stats()["prefix_tokens_shared"]
        finally:
            eng.shutdown()

    off, _ = burst(False)
    on, count = burst(True)
    assert on == off
    assert count == 0


def test_best_shared_prefix_safe_after_divergence_truncation():
    sm = SlotManager(4, 512)
    a = sm.acquire("A")
    a.tokens = list(range(200))
    a.kv_written = 200
    assert sm.reuse_prefix(a, list(range(40)) + [999] * 30) == 40
    assert a.kv_written == 40
    b = sm.acquire("B")
    src, share = sm.best_shared_prefix(b, list(range(60)))
    assert src is a and share == 40
    for la, lb, lim in ((300, 300, 299), (257, 300, 256), (10, 10, 9)):
        x, y = list(range(la)), list(range(lb))
        y[lim // 2] = -1
        naive = next((i for i in range(min(lim, len(x), len(y)))
                      if x[i] != y[i]), min(lim, len(x), len(y)))
        assert _lcp(x, y, lim) == naive


def test_no_share_on_divergent_prompts():
    eng = _engine(_params(5), shared=True)
    try:
        _gen(eng, "a", "hi", 8, system="totally unrelated persona text here")
        _gen(eng, "b", "hi", 8, system="B" * 40)
        assert eng.get_stats()["prefix_tokens_shared"] == 0
    finally:
        eng.shutdown()


def test_burst_of_four_prefills_in_one_batched_call():
    """4 fresh requests arriving together (shared prefix off) prefill in
    one ``[4, bucket]`` call, and each stream is what the request gives
    alone on a fresh engine."""
    params = _params(8)
    prompts = [f"request number {i} about {w}"
               for i, w in enumerate(("cats", "trains", "rain", "tea"))]
    alone = []
    for i, p in enumerate(prompts):
        eng = _engine(params, shared=False)
        try:
            alone.append(_gen(eng, f"a{i}", p, 20))
        finally:
            eng.shutdown()
    eng = _engine(params, shared=False)
    # The burst is held until all four are queued, so the test does not
    # rest on the engine's few-ms coalescing grace under a loaded CPU.
    admit = eng._admit
    eng._admit = lambda: len(eng._sched) >= 4 and admit()

    async def run():
        return await asyncio.gather(*(_stream(
            eng, f"b{i}", [{"role": "system", "content": SYSTEM},
                           {"role": "user", "content": p}], 20)
            for i, p in enumerate(prompts)))
    try:
        together = asyncio.run(asyncio.wait_for(run(), 120))
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert together == alone
    assert (stats["batched_prefill_calls"], stats["batched_prefill_rows"]) \
        == (1, 4)


# ---------------------------------------------------------------------
# The paged tier aliases shared blocks (JAX _paged_alias :2978)
# ---------------------------------------------------------------------

def _jax_tiny(**kw):
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.llama import init_params as jax_init

    cfg = jax_cfg("test-tiny")
    eng = TPUEngine(cfg, jax_init(cfg, jax.random.PRNGKey(3)), JaxBytes(),
                    seed=0, kv_host_budget_mb=0.0, kv_park_idle_s=0.0, **kw)
    eng.start()
    return eng


def _sequential_pinned(eng, params_cls, n=4):
    """n sessions one after another with SYSTEM * 3, all left pinned:
    each terminal event and the pool's stats after the last."""
    async def run():
        ends = []
        for i in range(n):
            async for ev in eng.generate(
                    f"r{i}", f"s{i}", [{"role": "system",
                                        "content": SYSTEM * 3},
                                       {"role": "user",
                                        "content": f"question {i}"}],
                    params_cls(max_tokens=8, ignore_eos=True, **GREEDY)):
                if ev["type"] != "token":
                    ends.append((ev["type"], ev.get("code")))
        return ends
    ends = asyncio.run(asyncio.wait_for(run(), 120))
    st = eng.get_stats()["kv_blocks"]
    return ends, {k: st.get(k) for k in ("in_use", "aliased", "alias_events",
                                         "cow_copies", "tables")}


def test_tight_pool_admits_every_sharing_session_as_jax_does():
    """48 blocks of 16 rows for 4 pinned sessions that share a ~390-token
    system prompt: aliased once, the prompt and the four deltas fit, so
    the JAX engine admits all four; copying the prompt per session (the
    port before aliasing) ran out of blocks and shed with
    kv_blocks_exhausted. Both engines admit, with equal pool stats."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams

    kw = dict(num_slots=4, max_len=1024, prefill_chunk=512,
              kv_layout="paged", kv_pool_blocks=48, kv_reserve_policy="none")
    jeng = _jax_tiny(**kw)
    try:
        want = _sequential_pinned(jeng, JaxParams)
    finally:
        jeng.shutdown()
    eng = _engine(_params(3), **kw)
    try:
        got = _sequential_pinned(eng, GenerationParams)
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert want[0] == [("done", None)] * 4
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["aliased"] > 0


def test_paged_cold_burst_aliases_where_the_jax_engine_fails():
    """A cold burst of 4 fresh sessions with one long system prompt on the
    paged pool. The JAX engine stamps the leader's rows with its dense
    ``_stamp_prefix`` into the 4-D pool and ends every request
    ``internal_error`` (ROADMAP Queue C: the reference deviates). The port's
    members alias the leader's full blocks: the streams equal an engine
    without sharing, and the pool holds fewer blocks than that engine's."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams

    kw = dict(num_slots=4, max_len=1024, prefill_chunk=512,
              kv_layout="paged", kv_pool_blocks=512)
    jeng = _jax_tiny(shared_prefix=True, **kw)
    admit = jeng._admit
    jeng._admit = lambda: len(jeng._sched) >= 4 and admit()

    async def jax_burst():
        async def one(i):
            ends = []
            async for ev in jeng.generate(
                    f"r{i}", f"s-r{i}", [{"role": "system",
                                          "content": SYSTEM * 3},
                                         {"role": "user",
                                          "content": f"question {i}"}],
                    JaxParams(max_tokens=16, **GREEDY)):
                if ev["type"] != "token":
                    ends.append((ev["type"], ev.get("code")))
            return ends
        return await asyncio.gather(*(one(i) for i in range(4)))
    try:
        ends = asyncio.run(asyncio.wait_for(jax_burst(), 120))
    finally:
        jeng.shutdown()
    assert ends == [[("error", "internal_error")]] * 4

    params = _params(6)
    runs = {}
    for shared in (False, True):
        eng = _engine(params, shared=shared, max_len=1024, prefill_chunk=512,
                      kv_layout="paged", kv_pool_blocks=512)
        seen: dict = {}
        consume = eng._consume_token

        def rec(req, tok, seen=seen, consume=consume):
            seen.setdefault(req.request_id, []).append(tok)
            consume(req, tok)
        eng._consume_token = rec
        admit = eng._admit
        eng._admit = lambda eng=eng, admit=admit: (len(eng._sched) >= 4
                                                   and admit())

        async def run(eng=eng):
            return await asyncio.gather(*(_stream(
                eng, f"r{i}", [{"role": "system", "content": SYSTEM * 3},
                               {"role": "user", "content": f"question {i}"}],
                16) for i in range(4)))
        try:
            texts = asyncio.run(asyncio.wait_for(run(), 120))
            runs[shared] = (seen, texts, eng.get_stats())
            eng._kv_blocks.check_leaks()
        finally:
            eng.shutdown()
    assert runs[True][:2] == runs[False][:2]
    stats, plain = runs[True][2], runs[False][2]
    assert stats["prefix_tokens_shared"] >= 3 * 64
    assert stats["kv_blocks"]["alias_events"] > 0
    assert stats["kv_blocks"]["aliased"] > 0
    assert stats["kv_blocks"]["in_use"] < plain["kv_blocks"]["in_use"]
    assert stats["kv_blocks"]["tables"] == plain["kv_blocks"]["tables"]
