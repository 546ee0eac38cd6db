"""The radix prefix cache and block aliasing of fasttalk_tpu_torch on the
CPU, held against the JAX package (tests/test_radix_kv.py,
tests/test_paged_kv.py, tests/test_chaos.py :647-700).

- The block allocator (holds, aliasing, copy-on-write, the pressure
  callback) and the radix tree (chain digests, insert, match, split,
  eviction under ``lru`` and ``fifo``) run the same seeded sequences as the
  JAX package's and must give equal tables, refcounts, free lists, stats,
  digests and eviction order.
- The engine with ``kv_radix=True`` on the paged pool: a released
  session's prefix serves the next session by aliasing, greedy tokens equal
  the radix-off control, turn N prefills only its delta, and the prefill
  counts and radix hits equal the JAX engine's on the same prompts; under
  pool pressure cached blocks are evicted before an admission sheds, the
  ``kv.block_alloc`` failpoint fires before any eviction, and a block a
  slot still references is never evicted; trained tinychat multi-turn
  greedy text equals the JAX engine's token for token.
- Aliasing and copy-on-write: a shared system prompt aliases the source's
  blocks (paged tokens equal the dense control, bf16 and int8 KV); a
  history that diverges inside an aliased block copies that block first
  (rows and int8 scales), and neither referent's stream changes.
"""

import asyncio
import os
import time

import numpy as np
import pytest
import torch

from fasttalk_tpu.kvcache.blocks import BlockAllocator as JaxAllocator
from fasttalk_tpu.kvcache.radix import RadixTree as JaxTree
from fasttalk_tpu.kvcache.radix import chain_digest as jax_digest
from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.kvcache.blocks import BlockAllocator
from fasttalk_tpu_torch.kvcache.radix import RadixTree, chain_digest
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
# Random-weight greedy streams repeat one byte; a repeat penalty makes the
# token ids depend on more of the context.
VARIED = dict(GREEDY, repeat_penalty=1.3)
SYS = ("You are a helpful, careful assistant. Answer briefly and "
       "precisely, in plain text, without preamble. " * 2)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)




# ---------------------------------------------------------------------
# Block allocator and radix tree against the JAX package's
# ---------------------------------------------------------------------

def _reclaim(alloc):
    """A pressure callback for a bare allocator: unhold held blocks no
    table references, lowest id first (the radix tree does this in the
    engine)."""
    def cb(need: int) -> int:
        free = [b for b in sorted(alloc._held) if alloc.ref(b) == 1][:need]
        alloc.unhold(free)
        return len(free)
    return cb


def _same_allocators(ours, ref) -> None:
    assert ours._tables == ref._tables
    assert ours._ref == ref._ref
    assert ours._free == ref._free
    assert ours._held == ref._held
    assert ours.stats(used_tokens=7) == ref.stats(used_tokens=7)
    ours.check_leaks()
    ref.check_leaks()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_allocator_sequence_equals_jax(seed):
    """A seeded sequence of ensure, append_block, alias, alias_blocks,
    hold, unhold, cow_tail, truncate and release (with pressure reclaim of
    holds) on both allocators: equal results, tables, refcounts, free lists,
    holds and stats after every call, and both invariants hold."""
    rng = np.random.default_rng(seed)
    ours, ref = BlockAllocator(24, 4, 4), JaxAllocator(24, 4, 4)
    ours.set_pressure(_reclaim(ours))
    ref.set_pressure(_reclaim(ref))
    ops = ("ensure", "append_block", "alias", "alias_blocks", "hold",
           "unhold", "cow_tail", "truncate", "release")
    done = set()
    for _ in range(400):
        op = ops[rng.integers(len(ops))]
        slot = int(rng.integers(4))
        live = [b for b in range(24) if ref.ref(b) > 0]
        if op == "ensure":
            args = (slot, int(rng.integers(0, 40)))
        elif op == "truncate":
            args = (slot, int(rng.integers(0, 40)))
        elif op in ("append_block", "release"):
            args = (slot,)
        elif op == "cow_tail":
            if not ref.table(slot):
                continue
            args = (slot,)
        elif op in ("alias", "alias_blocks"):
            empty = [s for s in range(4) if not ref.table(s)]
            if not empty:
                continue
            dst = empty[int(rng.integers(len(empty)))]
            if op == "alias":
                args = (int(rng.integers(4)), dst, int(rng.integers(0, 6)))
            else:
                pick = rng.permutation(live)[:int(rng.integers(0, 4))]
                args = (dst, [int(b) for b in pick])
        elif op == "hold":
            args = ([int(b) for b in rng.permutation(live)[:3]],)
        else:  # unhold
            held = sorted(ref._held)
            args = ([int(b) for b in rng.permutation(held)[:2]],)
        got = getattr(ours, op)(*args)
        want = getattr(ref, op)(*args)
        assert got == want, (op, args)
        done.add(op)
        _same_allocators(ours, ref)
    assert done == set(ops)
    assert ours.alias_events == ref.alias_events > 0
    assert ours.cow_copies == ref.cow_copies > 0


def test_chain_digest_is_byte_equal_to_jax():
    """The fleet router's placement key: the same sha1 chain, link by
    link, over token blocks and arbitrary bytes."""
    rng = np.random.default_rng(5)
    d_ours = d_ref = ""
    for _ in range(20):
        chunk = rng.bytes(int(rng.integers(0, 64)))
        d_ours, d_ref = chain_digest(d_ours, chunk), jax_digest(d_ref, chunk)
        assert d_ours == d_ref and len(d_ours) == 40


@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("seed", [0, 1])
def test_radix_tree_sequence_equals_jax(policy, seed):
    """The same inserts (prompts sharing prefixes, so nodes split),
    matches, slot releases and evictions on both trees: equal returns,
    matched chains and digests, stats, allocator state, and the same
    blocks freed in the same order under ``policy``."""
    rng = np.random.default_rng(seed)
    bs, slots = 4, 6
    pair = []
    for alloc_cls, tree_cls in ((BlockAllocator, RadixTree),
                                (JaxAllocator, JaxTree)):
        alloc = alloc_cls(64, bs, slots)
        tree = tree_cls(alloc, evict_policy=policy, token_bytes=8)
        alloc.set_pressure(tree.evict)
        pair.append((alloc, tree))
    stems = [list(rng.integers(0, 5, 24)) for _ in range(3)]

    def prompt():
        stem = stems[int(rng.integers(len(stems)))]
        cut = int(rng.integers(0, len(stem)))
        return [int(t) for t in stem[:cut]] + \
            [int(t) for t in rng.integers(0, 5, int(rng.integers(1, 16)))]

    for _ in range(120):
        op = rng.choice(["insert", "match", "evict", "release"])
        slot = int(rng.integers(slots))
        if op == "insert":
            tokens = prompt()
            written = int(rng.integers(0, len(tokens) + 1))
            res = []
            for alloc, tree in pair:
                alloc.release(slot)
                ok = alloc.ensure(slot, len(tokens))
                res.append((ok, tree.insert(tokens, alloc.table(slot),
                                            written=written)
                            if ok else None))
        elif op == "match":
            tokens = prompt()
            cap = int(rng.integers(1, 8))
            res = [tree.match(tokens, max_blocks=cap) for _, tree in pair]
            if res[0][0]:
                for alloc, tree in pair:
                    tree.note_hit(len(res[0][0]) * bs)
        elif op == "evict":
            need = int(rng.integers(1, 6))
            res = [(tree.evict(need), list(alloc._free)) for alloc, tree
                   in pair]
        else:
            res = [alloc.release(slot) for alloc, _ in pair]
        assert res[0] == res[1], (op, res)
        assert pair[0][1].stats() == pair[1][1].stats()
        assert pair[0][0]._ref == pair[1][0]._ref
        for alloc, tree in pair:
            tree.check_integrity()
            alloc.check_leaks()
    assert pair[0][1].stats()["evicted_blocks"] > 0
    assert pair[0][1].stats()["hits"] > 0


# ---------------------------------------------------------------------
# Engine on test-tiny (tests/test_radix_kv.py :439-663 on the port)
# ---------------------------------------------------------------------

def _params(seed: int = 0):
    return init_params(TINY, torch.Generator().manual_seed(seed),
                       torch.float32, "cpu")


def _engine(params=None, **kw) -> TorchEngine:
    opts = dict(num_slots=4, max_len=512, prefill_chunk=64, seed=0,
                dtype=torch.float32, kv_layout="paged", kv_radix=True,
                kv_host_budget_mb=0.0, kv_park_idle_s=0.0)
    opts.update(kw)
    eng = TorchEngine(TINY, params if params is not None else _params(),
                      ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


def _jax_engine(**kw):
    import jax

    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models import get_model_config as jax_cfg
    from fasttalk_tpu.models import init_params as jax_init

    cfg = jax_cfg("test-tiny")
    opts = dict(num_slots=4, max_len=512, prefill_chunk=64, seed=0,
                kv_layout="paged", kv_radix=True, kv_host_budget_mb=0.0,
                kv_park_idle_s=0.0)
    opts.update(kw)
    eng = TPUEngine(cfg, jax_init(cfg, jax.random.PRNGKey(0)), JaxBytes(),
                    **opts)
    eng.start()
    return eng


def _record(eng) -> dict:
    """Token ids each request consumed, by request id."""
    seen: dict = {}
    consume = eng._consume_token

    def rec(req, tok):
        seen.setdefault(req.request_id, []).append(tok)
        consume(req, tok)
    eng._consume_token = rec
    return seen


def _collect(eng, rid, sid, msgs, n=10, params_cls=GenerationParams,
             **kw):
    async def run():
        out = []
        async for ev in eng.generate(
                rid, sid, msgs, params_cls(max_tokens=n, **{**VARIED,
                                                            **kw})):
            out.append(ev)
        return out
    return asyncio.run(asyncio.wait_for(run(), 120))


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _release(eng, sid):
    eng.release_session(sid)
    assert _wait(lambda: eng.slots.lookup(sid) is None)


def _sys(user):
    return [{"role": "system", "content": SYS},
            {"role": "user", "content": user}]


def _jax_counts(turns, **kw):
    """(prompt_tokens, prefill_tokens) of each turn on the JAX engine,
    each turn a fresh session released after it, and its radix stats."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams

    eng = _jax_engine(**kw)
    try:
        out = []
        for i, msgs in enumerate(turns):
            evs = _collect(eng, f"r{i}", f"t{i}", msgs,
                           params_cls=JaxParams, ignore_eos=True,
                           **GREEDY)
            assert evs[-1]["type"] == "done", evs[-1]
            st = evs[-1]["stats"]
            out.append((st["prompt_tokens"], st["prefill_tokens"]))
            _release(eng, f"t{i}")
        radix = eng.get_stats()["kv_radix"]
        return out, {k: radix[k] for k in ("hits", "hit_tokens",
                                           "inserted_blocks")}
    finally:
        eng.shutdown()


def test_cross_session_hit_equals_control_and_jax():
    """Session A finishes and is released; session B shares only the
    system prompt, so only the tree can serve it. B's tokens equal the
    radix-off engine's, it prefills its prompt less the served chain, the
    hit aliased blocks, and the counts equal the JAX engine's."""
    params = _params(1)
    turns = [_sys("hi A"), _sys("hi B")]
    ctl = _engine(params, kv_radix=False, shared_prefix=False)
    try:
        want = _record(ctl)
        for i, msgs in enumerate(turns):
            _collect(ctl, f"r{i}", f"t{i}", msgs, ignore_eos=True)
            _release(ctl, f"t{i}")
    finally:
        ctl.shutdown()
    eng = _engine(params)
    try:
        got = _record(eng)
        counts = []
        for i, msgs in enumerate(turns):
            evs = _collect(eng, f"r{i}", f"t{i}", msgs, ignore_eos=True)
            assert evs[-1]["type"] == "done", evs[-1]
            st = evs[-1]["stats"]
            counts.append((st["prompt_tokens"], st["prefill_tokens"]))
            _release(eng, f"t{i}")
            eng._kv_radix.check_integrity()
        radix = eng.get_stats()["kv_radix"]
        assert radix["hits"] >= 1 and radix["bytes_saved"] > 0
        assert eng._kv_blocks.alias_events >= 1
        assert counts[1][1] == counts[1][0] - radix["hit_tokens"]
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert got == want
    jax_counts, jax_radix = _jax_counts(turns)
    assert counts == jax_counts
    assert {k: radix[k] for k in jax_radix} == jax_radix


TRANSCRIPT = [
    [{"role": "user", "content": "turn one of a growing transcript"}],
    [{"role": "user", "content": "turn one of a growing transcript"},
     {"role": "assistant", "content": "a first reply of some length"},
     {"role": "user", "content": "follow-up number 0"}],
    [{"role": "user", "content": "turn one of a growing transcript"},
     {"role": "assistant", "content": "a first reply of some length"},
     {"role": "user", "content": "follow-up number 0"},
     {"role": "assistant", "content": "another reply"},
     {"role": "user", "content": "follow-up number 1"}],
]


def test_multiturn_prefill_is_o_delta_and_equals_jax():
    """A growing transcript, a fresh session each turn (released after
    it): turn N prefills at most its delta plus two blocks, and every
    turn's prefill count and the radix hits equal the JAX engine's."""
    eng = _engine(num_slots=2)
    try:
        counts, prev = [], 0
        for i, msgs in enumerate(TRANSCRIPT):
            evs = _collect(eng, f"r{i}", f"t{i}", msgs, ignore_eos=True)
            assert evs[-1]["type"] == "done", evs[-1]
            st = evs[-1]["stats"]
            if i:
                assert st["prefill_tokens"] <= \
                    st["prompt_tokens"] - prev + 2 * 16, (i, st)
            prev = st["prompt_tokens"]
            counts.append((st["prompt_tokens"], st["prefill_tokens"]))
            _release(eng, f"t{i}")
        radix = eng.get_stats()["kv_radix"]
        assert radix["hits"] >= 2
        eng._kv_radix.check_integrity()
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    jax_counts, jax_radix = _jax_counts(TRANSCRIPT, num_slots=2)
    assert counts == jax_counts
    assert {k: radix[k] for k in jax_radix} == jax_radix


def test_admission_reclaims_cached_blocks_instead_of_shedding():
    """A pool mostly held by the tree still admits a prompt that shares
    nothing with it: the pressure callback evicts cached blocks."""
    eng = _engine(num_slots=2, kv_pool_blocks=10, kv_reserve_policy="none")
    try:
        evs = _collect(eng, "r1", "A", [{"role": "user", "content":
                                         "a" * 100}], n=4)
        assert evs[-1]["type"] == "done", evs[-1]
        _release(eng, "A")
        assert eng._kv_radix.stats()["blocks"] >= 6
        evs = _collect(eng, "r2", "B", [{"role": "user", "content":
                                         "b" * 100}], n=4)
        assert evs[-1]["type"] == "done", evs[-1]
        assert eng._kv_radix.stats()["evicted_blocks"] > 0
        eng._kv_radix.check_integrity()
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()


def test_block_alloc_failpoint_fires_before_radix_eviction():
    """An injected ``kv.block_alloc`` failure sheds the admission without
    evicting a cached block (holds and refcounts as they were); with the
    fault cleared the same admission evicts cached blocks and runs, and
    every hold taken by an insert is released by an eviction or held."""
    from fasttalk_tpu_torch.resilience import failpoints as fp

    eng = _engine(kv_pool_blocks=12, kv_reserve_policy="none")
    try:
        alloc, tree = eng._kv_blocks, eng._kv_radix
        evs = _collect(eng, "rx1", "RX", [{"role": "user", "content":
                                           "a" * 100}], n=4)
        assert evs[-1]["type"] == "done", evs[-1]
        _release(eng, "RX")
        assert tree.stats()["blocks"] > 0
        held0 = alloc.held()
        fp.activate("kv.block_alloc=error;count=1")
        msg_b = [{"role": "user", "content": "z" * 120}]
        evs = _collect(eng, "rx2", "RY", msg_b)
        assert evs[-1]["type"] == "error", evs[-1]
        assert evs[-1]["code"] == "kv_blocks_exhausted"
        assert evs[-1]["retry_after"] > 0
        assert tree.stats()["evicted_blocks"] == 0
        assert alloc.held() == held0
        tree.check_integrity()
        alloc.check_leaks()
        fp.clear()
        evs = _collect(eng, "rx3", "RY", msg_b)
        assert evs[-1]["type"] == "done", evs[-1]
        st = tree.stats()
        assert st["evicted_blocks"] > 0
        assert alloc.held() == st["inserted_blocks"] - st["evicted_blocks"]
        tree.check_integrity()
        alloc.check_leaks()
    finally:
        fp.clear()
        eng.shutdown()


def test_radix_pressure_never_evicts_refcounted_blocks():
    """With the whole tree aliased by a resident session (refcount 2),
    nothing is evictable: an admission that needs the blocks sheds, no
    hold is dropped, and the resident session's next turn decodes from its
    blocks with the tokens of an engine that never came under pressure."""
    params = _params(2)
    msg_a = [{"role": "user", "content": "a" * 100}]

    def turns(eng, pressure):
        ids = _record(eng)
        _collect(eng, "rp1", "RA", msg_a, n=6)
        if pressure:
            assert _wait(lambda: eng._kv_radix.stats()["blocks"] > 0)
            assert eng._kv_radix.evictable_blocks() == 0
            held0 = eng._kv_blocks.held()
            evs = _collect(eng, "rp2", "RB",
                           [{"role": "user", "content": "b" * 100}])
            assert evs[-1]["type"] == "error", evs[-1]
            assert evs[-1]["code"] == "kv_blocks_exhausted"
            assert eng._kv_radix.stats()["evicted_blocks"] == 0
            assert eng._kv_blocks.held() == held0
        msg2 = msg_a + [{"role": "assistant", "content": "ok"},
                        {"role": "user", "content": "go on"}]
        evs = _collect(eng, "rp3", "RA", msg2, n=6)
        assert evs[-1]["type"] == "done", evs[-1]
        return ids["rp1"], ids["rp3"]

    ctl = _engine(params, kv_radix=False)
    try:
        want = turns(ctl, False)
    finally:
        ctl.shutdown()
    eng = _engine(params, kv_pool_blocks=12, kv_reserve_policy="none")
    try:
        got = turns(eng, True)
        eng._kv_radix.check_integrity()
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert got == want


@pytest.mark.parametrize("ending", ["budget", "cancel"])
def test_late_writes_of_a_call_in_flight_miss_the_donated_blocks(ending):
    """Pipeline depth 2, 4 steps a call. ``budget``: the first request's 7
    tokens end inside its second call, which wrote rows past its
    ``kv_written``; ``cancel``: it is cancelled mid-stream and finishes
    while another decode call is in flight. The tree takes only the full
    blocks below ``kv_written`` (late writes land at or past it), so the
    session that reuses them next decodes the radix-off engine's tokens."""
    params = _params(3)
    turns = [_sys("first session"), _sys("second session, longer")]

    def first_cancelled(eng):
        async def run():
            async def consume():
                out = []
                async for ev in eng.generate("r0", "t0", turns[0],
                                             GenerationParams(
                                                 max_tokens=200, **VARIED)):
                    out.append(ev)
                return out
            task = asyncio.create_task(consume())
            while not (eng._by_id.get("r0") and
                       eng._by_id["r0"].generated >= 8):
                await asyncio.sleep(0.001)
            eng.cancel("r0")
            return await task
        return asyncio.run(asyncio.wait_for(run(), 120))

    def run(eng):
        ids = _record(eng)
        in_flight = []
        finish = eng._finish

        def note(req, *a, **kw):
            if req.request_id == "r0":
                in_flight.append(len(eng._inflight))
            finish(req, *a, **kw)
        eng._finish = note
        for i, msgs in enumerate(turns):
            if i == 0 and ending == "cancel":
                evs = first_cancelled(eng)
                assert evs[-1]["type"] == "cancelled", evs[-1]
                assert in_flight[0] >= 1
            else:
                evs = _collect(eng, f"r{i}", f"t{i}", msgs, n=7)
                assert evs[-1]["type"] == "done", evs[-1]
            if i == 0:
                slot = eng.slots.lookup("t0")
                assert eng.decode_calls >= 2
                assert slot.kv_written < int(eng._dev.pos[slot.index])
            _release(eng, f"t{i}")
        return ids

    opts = dict(steps_per_call=4, pipeline_depth=2)
    ctl = _engine(params, kv_radix=False, shared_prefix=False, **opts)
    try:
        want = run(ctl)
    finally:
        ctl.shutdown()
    eng = _engine(params, **opts)
    try:
        got = run(eng)
        assert eng._kv_radix.stats()["hits"] >= 1
        eng._kv_radix.check_integrity()
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert got["r1"] == want["r1"]
    if ending == "budget":
        assert got["r0"] == want["r0"]


# ---------------------------------------------------------------------
# Aliasing and copy-on-write (tests/test_paged_kv.py :92-135, :335-420)
# ---------------------------------------------------------------------

def _transcript(eng):
    ids = _record(eng)
    for i in range(3):
        evs = _collect(eng, f"r{i}", f"s{i}", [{"role": "user", "content":
                                                "hello world " * (i + 1)}],
                       n=12)
        assert evs[-1]["type"] == "done", evs[-1]
    evs = _collect(eng, "rmt", "s0", [
        {"role": "user", "content": "hello world "},
        {"role": "assistant", "content": "some reply"},
        {"role": "user", "content": "more"}], n=10)
    assert evs[-1]["type"] == "done", evs[-1]
    for sid in ("pa", "pb"):
        evs = _collect(eng, f"rp-{sid}", sid, _sys(f"hi {sid}"), n=10)
        assert evs[-1]["type"] == "done", evs[-1]
    return ids


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_aliasing_tokens_equal_dense(kv_quant):
    """Fresh sessions, a multi-turn reuse and two sessions sharing a system
    prompt: the paged engine (the second shared session aliases the
    first's full blocks, no row copy) gives the dense engine's tokens."""
    params = _params(4)
    kw = dict(kv_radix=False, spec_decode="off", kv_quant=kv_quant)
    dense = _engine(params, kv_layout="dense", **kw)
    try:
        want = _transcript(dense)
    finally:
        dense.shutdown()
    paged = _engine(params, kv_block_size=16, **kw)
    try:
        got = _transcript(paged)
        alloc = paged._kv_blocks
        assert alloc.alias_events >= 1
        assert alloc.stats()["aliased"] >= 1
        alloc.check_leaks()
    finally:
        paged.shutdown()
    assert got == want


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_divergence_inside_an_aliased_block_copies_it_first(kv_quant):
    """B aliases A's blocks of the shared system prompt; A's next turn
    diverges inside one of those blocks. A's tail block is copied before
    A writes (one copy-on-write, the rows and on int8 the scales carried
    with them), and both sessions decode the tokens of an engine without
    sharing."""
    params = _params(5)
    sys2 = SYS[:40] + "Z" + SYS[41:]

    def run(eng):
        ids = _record(eng)
        _collect(eng, "a1", "A", _sys("hi A"))
        _collect(eng, "b1", "B", _sys("hi B"))
        cow0 = eng._kv_blocks.cow_copies if eng.paged else 0
        _collect(eng, "a2", "A", [{"role": "system", "content": sys2},
                                  {"role": "user", "content": "hi A"}])
        cows = (eng._kv_blocks.cow_copies if eng.paged else 0) - cow0
        _collect(eng, "b2", "B", _sys("hi B") + [
            {"role": "assistant", "content": "hello"},
            {"role": "user", "content": "and B again"}])
        return ids, cows

    kw = dict(kv_radix=False, kv_quant=kv_quant, kv_block_size=16)
    ctl = _engine(params, shared_prefix=False, **kw)
    try:
        want, _ = run(ctl)
    finally:
        ctl.shutdown()
    eng = _engine(params, **kw)
    try:
        got, cows = run(eng)
        alloc = eng._kv_blocks
        assert cows == 1
        assert alloc.alias_events >= 1
        # The divergence is at token 41 + the template's lead tokens: A's
        # block there is its own copy, whose leading rows (and scales)
        # equal B's shared original.
        tok = ByteTokenizer().apply_chat_template(_sys("hi A"))
        tok2 = ByteTokenizer().apply_chat_template(
            [{"role": "system", "content": sys2},
             {"role": "user", "content": "hi A"}])
        at = next(i for i, (x, y) in enumerate(zip(tok, tok2)) if x != y)
        blk, tail = divmod(at, 16)
        assert tail
        a_tab = alloc.table(eng.slots.lookup("A").index)
        b_tab = alloc.table(eng.slots.lookup("B").index)
        assert a_tab[blk] != b_tab[blk] and a_tab[:blk] == b_tab[:blk]
        for part in eng.cache:
            if part is None:
                continue
            a_rows = part[:, a_tab[blk] * 16:a_tab[blk] * 16 + tail]
            b_rows = part[:, b_tab[blk] * 16:b_tab[blk] * 16 + tail]
            assert torch.equal(a_rows, b_rows)
        alloc.check_leaks()
    finally:
        eng.shutdown()
    assert got == want


# ---------------------------------------------------------------------
# Trained tinychat (tests/test_radix_kv.py TestTrainedRadixMultiTurn)
# ---------------------------------------------------------------------

def _tinychat_turns(make, params_cls, drain):
    """Three turns of a growing transcript, a fresh session each (released
    after it): each turn's reply and (prompt, prefill) token counts."""
    eng = make()
    eng.start()
    try:
        msgs = [{"role": "user", "content": "my name is Ada."}]
        replies, counts = [], []
        for turn in range(3):
            evs = _collect(eng, f"tr{turn}", f"tt{turn}", msgs, n=24,
                           params_cls=params_cls, **GREEDY)
            assert evs[-1]["type"] == "done", evs[-1]
            st = evs[-1]["stats"]
            counts.append((st["prompt_tokens"], st["prefill_tokens"]))
            replies.append("".join(e.get("text", "") for e in evs
                                   if e["type"] == "token"))
            drain(eng, f"tt{turn}")
            msgs = msgs + [{"role": "assistant", "content": replies[-1]},
                           {"role": "user",
                            "content": f"follow-up number {turn}"}]
        stats = eng.get_stats()
        if eng._kv_radix is not None:
            eng._kv_radix.check_integrity()
            eng._kv_blocks.check_leaks()
        return replies, counts, stats
    finally:
        eng.shutdown()


def test_trained_radix_multiturn_equals_jax_token_for_token():
    """Trained tinychat, float32, radix on: the port's three replies equal
    the JAX engine's and its own radix-off control's, turns 2-3 prefill at
    most their delta plus two blocks, and the prefill counts and hits equal
    the JAX engine's."""
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.loader import load_params

    ckpt = os.path.join(ASSETS, "tinychat")
    jcfg = jax_cfg("tinychat", ASSETS)
    jparams = jax_load(jcfg, ckpt, jnp.float32)
    cfg = get_model_config("tinychat", ASSETS)
    params = load_params(cfg, ckpt, torch.float32, "cpu")
    common = dict(num_slots=4, max_len=1024, steps_per_call=8,
                  spec_decode="off", kv_layout="paged")

    def port(radix):
        return lambda: TorchEngine(
            cfg, params, load_tokenizer(ASSETS, "tinychat",
                                        template=cfg.chat_template),
            device="cpu", dtype=torch.float32, kv_radix=radix,
            kv_host_budget_mb=0.0, **common)

    def jax_engine():
        return TPUEngine(jcfg, jparams, jax_tok(
            ASSETS, "tinychat", template=jcfg.chat_template),
            dtype=jnp.float32, kv_radix=True, kv_host_budget_mb=0.0,
            **common)

    want, jax_counts, jax_stats = _tinychat_turns(jax_engine, JaxParams,
                                                  _release)
    ctl, _, _ = _tinychat_turns(port(False), GenerationParams, _release)
    got, counts, stats = _tinychat_turns(port(True), GenerationParams,
                                         _release)
    assert got == want == ctl
    assert counts == jax_counts
    for (prompt, prefill), (prev, _) in zip(counts[1:], counts):
        assert prefill <= prompt - prev + 2 * 16
    assert stats["kv_radix"]["hits"] == jax_stats["kv_radix"]["hits"] >= 2
    assert stats["kv_radix"]["bytes_saved"] > 0
