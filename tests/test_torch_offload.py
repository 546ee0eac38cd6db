"""The session host-offload tier of fasttalk_tpu_torch on the CPU, held
against the JAX package (tests/test_kvcache.py, tests/test_paged_kv.py
``TestPagedRestoreFailure``).

- ``HostKVPool`` (budget, LRU, TTL, the release tombstone, ``revive``,
  staged bytes, hit ratio), ``RestorePolicy`` fed the same measurements,
  ``entry_problem`` and the scheduler's wait discount give the JAX
  package's results.
- The engine parks an evicted session and restores it: greedy tokens equal
  a never-evicted control on dense bf16, dense int8, paged bf16 and paged
  int8, the restored turn prefills only its delta, and a parked entry's
  kept rows, stored rows and bytes (int8 scales counted) equal the JAX
  engine's for the same history. A restore that fails at the
  ``kv.restore.dispatch`` failpoint falls back to a full prefill with the
  slot's table empty again. A host copy that lands late (made lazy here,
  as a copy on the card lands after later work was enqueued) still holds
  the evicted session's rows: the park snapshots them on the device first.
- Release against park: a release purges the parked entry; a queued
  follow-up cancelled or expired before admission leaves the entry parked.
- Trained tinychat: park and restore give the JAX engine's text token for
  token, on the dense and the paged cache.
"""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fasttalk_tpu.kvcache import hostpool as jhostpool
from fasttalk_tpu.kvcache import policy as jpolicy
from fasttalk_tpu.kvcache.offload import kv_bucket as jax_kv_bucket
from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.slots import _lcp
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.kvcache import hostpool as thostpool
from fasttalk_tpu_torch.kvcache import offload as toffload
from fasttalk_tpu_torch.kvcache import policy as tpolicy
from fasttalk_tpu_torch.kvcache.blocks import blocks_for
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import init_params
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)
VARIED = dict(GREEDY, repeat_penalty=1.3)
MSG1 = [{"role": "user", "content":
         "this is a reasonably long first turn message for session A"}]
FILLER = [{"role": "user", "content": "filler session occupying a slot"}]
TIERS = {"dense": {}, "dense-int8": dict(kv_quant="int8"),
         "paged": dict(kv_layout="paged"),
         "paged-int8": dict(kv_layout="paged", kv_quant="int8")}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)




# ---------------------------------------------------------------------
# Pool, policy, entry validation and the wait discount (tier-1 units)
# ---------------------------------------------------------------------

def _entry(mod, sid, n_tokens=32, nbytes=1024, now=None):
    kw = {} if now is None else dict(parked_at=now, last_used=now)
    return mod.ParkedKV(session_id=sid, tokens=list(range(n_tokens)),
                        kept=n_tokens, bucket=jax_kv_bucket(n_tokens, 256),
                        k=np.zeros(1), v=np.zeros(1), nbytes=nbytes, **kw)


def _disabled(mod, pool_of):
    pool = pool_of(budget_mb=0.0)
    return [pool.enabled, pool.put(_entry(mod, "a")), pool.get("a")]


def _put_get_take_purge(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    return [pool.put(_entry(mod, "a", nbytes=100)),
            pool.get("a").session_id, pool.parked_len("a"),
            pool.take("a").session_id, pool.get("a"),
            pool.put(_entry(mod, "b")), pool.purge("b"), pool.purge("b")]


def _replace_same_session(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    pool.put(_entry(mod, "a", nbytes=100))
    pool.put(_entry(mod, "a", nbytes=300))
    return []


def _lru_budget(mod, pool_of):
    clock = [0.0]
    pool = pool_of(budget_mb=1.0, clock=lambda: clock[0])
    half = 512 * 1024
    pool.put(_entry(mod, "old", nbytes=half, now=0.0))
    clock[0] = 10.0
    pool.put(_entry(mod, "mid", nbytes=half, now=10.0))
    clock[0] = 20.0
    pool.get("old")
    pool.put(_entry(mod, "new", nbytes=half, now=20.0))
    return [pool.get(s) is None for s in ("mid", "old", "new")]


def _oversized(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    return [pool.put(_entry(mod, "big", nbytes=2 * 1024 * 1024))]


def _ttl(mod, pool_of):
    clock = [0.0]
    pool = pool_of(budget_mb=1.0, ttl_s=5.0, clock=lambda: clock[0])
    pool.put(_entry(mod, "a", now=0.0))
    pool.put(_entry(mod, "b", now=0.0))
    clock[0] = 3.0
    pool.get("b")
    clock[0] = 6.0
    out = [pool.sweep(), pool.get("a") is None, pool.get("b") is None]
    clock[0] = 20.0
    return out + [pool.get("b") is None]


def _tombstone(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    pool.put(_entry(mod, "a"))
    pool.purge("a")
    out = [pool.put(_entry(mod, "a")), pool.get("a") is None]
    pool.revive("a")
    return out + [pool.put(_entry(mod, "a"))]


def _staged(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    pool.put(_entry(mod, "a", nbytes=100))
    pool.put(_entry(mod, "b", nbytes=50))
    out = [pool.staged_bytes()]
    pool.get("a").k_dev = object()
    return out + [pool.staged_bytes(), [
        {k: v for k, v in e.items() if k not in ("parked_s", "idle_s")}
        for e in pool.snapshot()]]


def _hit_ratio(mod, pool_of):
    pool = pool_of(budget_mb=1.0)
    pool.note_lookup(True)
    pool.note_lookup(False)
    return []


POOL_CASES = [_disabled, _put_get_take_purge, _replace_same_session,
              _lru_budget, _oversized, _ttl, _tombstone, _staged, _hit_ratio]


@pytest.mark.parametrize("case", POOL_CASES, ids=lambda f: f.__name__)
def test_host_pool_equals_jax(case):
    """Each tests/test_kvcache.py ``TestHostKVPool`` scenario on both pools:
    the same observations and the same ``stats()`` after it."""
    seen = []
    for mod in (thostpool, jhostpool):
        pools = []

        def pool_of(mod=mod, pools=pools, **kw):
            pools.append(mod.HostKVPool(**kw))
            return pools[-1]
        out = case(mod, pool_of)
        seen.append((out, [p.stats() for p in pools]))
    assert seen[0] == seen[1]


def _feed(policy):
    out = [policy.should_restore(31, 1), policy.restore_saving_s(31, 1),
           policy.should_restore(500, 4 * 1024 * 1024)]
    policy.note_copy(1_000_000, 1.0)
    policy.note_prefill(1000, 1.0)
    out += [policy.should_restore(100, 50_000),
            policy.should_restore(100, 1_000_000),
            policy.restore_saving_s(100, 50_000),
            policy.decide(100, 50_000, local=False, migratable=True)]
    policy.note_copy(3_000_000, 0.5)
    policy.note_prefill(800, 2.0)
    policy.note_migrate(10_000, 0.1)
    out += [policy.should_restore(100, 200_000),
            policy.decide(100, 200_000, migratable=True), policy.stats()]
    return out


@pytest.mark.parametrize("min_tokens", [1, 16, 32])
def test_restore_policy_equals_jax_on_the_same_measurements(min_tokens):
    assert _feed(tpolicy.RestorePolicy(min_tokens)) == \
        _feed(jpolicy.RestorePolicy(min_tokens))


def test_kv_env_defaults_and_bucket_equal_jax(monkeypatch):
    assert tpolicy.kv_env_defaults() == jpolicy.kv_env_defaults()
    monkeypatch.setenv("KV_HOST_BUDGET_MB", "12")
    monkeypatch.setenv("KV_RESTORE_MIN_TOKENS", "bad")
    assert tpolicy.kv_env_defaults() == jpolicy.kv_env_defaults()
    for n in (0, 1, 16, 17, 100, 1000, 5000):
        assert toffload.kv_bucket(n, 2048) == jax_kv_bucket(n, 2048)


def _bad_entries(mod, rows):
    """Entries that ``entry_problem`` must refuse, and one it accepts:
    ``rows(shape, kind)`` makes the package's host arrays."""
    from dataclasses import replace

    k, v = rows((2, 32, 2, 16), "kv"), rows((2, 32, 2, 16), "kv")
    ks, vs = rows((2, 32, 1), "scale"), rows((2, 32, 1), "scale")
    nb = 2 * 2 * 32 * 2 * 16 + 2 * 2 * 32 * 4
    good = mod.ParkedKV(session_id="s", tokens=list(range(20)), kept=20,
                        bucket=32, k=k, v=v, k_scale=ks, v_scale=vs,
                        nbytes=nb)
    return [good, replace(good, kept=0, tokens=[]),
            replace(good, tokens=[1, 2]),
            replace(good, k=rows((2, 32, 2), "kv")),
            replace(good, v=rows((2, 16, 2, 16), "kv")),
            replace(good, bucket=8),
            replace(good, k=rows((2, 8, 2, 16), "kv"),
                    v=rows((2, 8, 2, 16), "kv")),
            replace(good, v_scale=None),
            replace(good, k_scale=rows((2, 16, 1), "scale")),
            replace(good, nbytes=nb + 1)]


def test_entry_problem_equals_jax_on_pinned_tensor_rows():
    """The port's entries hold torch tensors (int8 rows, f32 scales); the
    JAX package's numpy arrays of the same shapes and dtypes: the same
    verdict and message for each entry, and ``strip_device`` drops the
    staged copies."""
    def trows(shape, kind):
        return torch.zeros(shape, dtype=torch.int8 if kind == "kv"
                           else torch.float32)

    def jrows(shape, kind):
        return np.zeros(shape, np.int8 if kind == "kv" else np.float32)

    got = [thostpool.entry_problem(e) for e in _bad_entries(thostpool, trows)]
    want = [jhostpool.entry_problem(e)
            for e in _bad_entries(jhostpool, jrows)]
    assert got == want and got[0] is None and all(got[1:])
    bf16 = thostpool.ParkedKV(
        session_id="s", tokens=[1], kept=1, bucket=16,
        k=torch.zeros((1, 16, 1, 4), dtype=torch.bfloat16),
        v=torch.zeros((1, 16, 1, 4), dtype=torch.bfloat16), nbytes=256,
        k_dev=1, v_dev=2, staged_event=3, staged_nbytes=256)
    assert thostpool.entry_problem(bf16) is None
    stripped = thostpool.strip_device(bf16)
    assert (stripped.k_dev, stripped.staged_event,
            stripped.staged_nbytes) == (None, None, 0)


def test_scheduler_wait_discount_admits_a_cheap_restore_as_jax_does():
    from fasttalk_tpu.scheduling.scheduler import RequestScheduler as JaxSched
    from fasttalk_tpu.utils.errors import AdmissionRejected as JaxRejected
    from fasttalk_tpu_torch.scheduling.scheduler import RequestScheduler
    from fasttalk_tpu_torch.utils.errors import AdmissionRejected

    out = []
    for sched_cls, rejected in ((RequestScheduler, AdmissionRejected),
                                (JaxSched, JaxRejected)):
        s = sched_cls(queue_bound=8, default_deadline_s=30.0, slots=1)
        s.note_service_time(10.0)
        s.submit("r0", "s0")
        s.submit("r1", "s1")
        with pytest.raises(rejected) as ei:
            s.submit("r2", "s2", deadline_s=15.0)
        entry = s.submit("r3", "s3", deadline_s=15.0, wait_discount_s=8.0)
        out.append((ei.value.reason, entry.request_id))
    assert out[0] == out[1] == ("wait_too_long", "r3")


# ---------------------------------------------------------------------
# Engine on test-tiny (tests/test_kvcache.py TestParkRestoreEngine)
# ---------------------------------------------------------------------

def _params(seed=0, dtype=torch.float32):
    return init_params(TINY, torch.Generator().manual_seed(seed), dtype,
                       "cpu")


def _engine(params=None, **kw) -> TorchEngine:
    opts = dict(num_slots=2, max_len=256, prefill_chunk=64, seed=0,
                dtype=torch.float32, kv_host_budget_mb=64.0,
                kv_park_ttl_s=600.0, kv_park_idle_s=0.0,
                kv_restore_min_tokens=8)
    opts.update(kw)
    eng = TorchEngine(TINY, params if params is not None else _params(),
                      ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


def _record(eng) -> dict:
    seen: dict = {}
    consume = eng._consume_token

    def rec(req, tok):
        seen.setdefault(req.request_id, []).append(tok)
        consume(req, tok)
    eng._consume_token = rec
    return seen


def _collect(eng, rid, sid, msgs, n=8, params_cls=GenerationParams, **kw):
    async def run():
        out = []
        async for ev in eng.generate(
                rid, sid, msgs, params_cls(max_tokens=n, **{**VARIED,
                                                            **kw})):
            out.append(ev)
        return out
    return asyncio.run(asyncio.wait_for(run(), 120))


def _text(events):
    return "".join(e.get("text", "") for e in events if e["type"] == "token")


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


def _pin_policy(eng, copy_bps=1e9, prefill_tps=1e3):
    """Fixed measurements, so the restore decision does not depend on the
    machine's timings (parity runs compare decisions, not clocks)."""
    pol = eng._kv_policy
    pol.note_copy = lambda *a: None
    pol.note_prefill = lambda *a: None
    pol._copy_bps, pol._prefill_tps = copy_bps, prefill_tps


MSG2 = MSG1 + [{"role": "assistant", "content": "a first reply"},
               {"role": "user", "content": "and a follow-up"}]


def _two_turns(eng, evict):
    """A's turn, (fillers B and C evict A and park it), A's follow-up: the
    token ids of both turns and the follow-up's done stats."""
    ids = _record(eng)
    _collect(eng, "r1", "A", MSG1)
    if evict:
        _collect(eng, "rb", "B", FILLER)
        _collect(eng, "rc", "C", FILLER)
        assert _wait(lambda: eng._kv_pool.parked_len("A") > 0), \
            "eviction never parked session A"
        assert eng.slots.lookup("A") is None
    evs = _collect(eng, "r2", "A", MSG2)
    assert evs[-1]["type"] == "done", evs[-1]
    return (ids["r1"], ids["r2"]), evs[-1]["stats"]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_park_restore_equals_a_never_evicted_control(tier):
    params = _params(1)
    ctl = _engine(params, kv_host_budget_mb=0.0, **TIERS[tier])
    try:
        want, _ = _two_turns(ctl, evict=False)
        assert not ctl.get_stats()["kv_host"]["enabled"]
    finally:
        ctl.shutdown()
    eng = _engine(params, **TIERS[tier])
    try:
        got, done = _two_turns(eng, evict=True)
        st = eng.get_stats()["kv_host"]
        assert st["restored_total"] == 1 and st["parked_total"] >= 1, st
        assert st["restore_failed"] == st["park_failed"] == 0
        # Only the delta after the restored prefix prefilled.
        assert done["prefill_tokens"] < done["prompt_tokens"] // 2
        if eng.paged:
            eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert got == want


def _jax_entry(**kw):
    """The JAX engine's parked entry of session A after the fillers evict
    it (bf16 cache)."""
    import jax

    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import ByteTokenizer as JaxBytes
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.llama import init_params as jax_init

    cfg = jax_cfg("test-tiny")
    eng = TPUEngine(cfg, jax_init(cfg, jax.random.PRNGKey(0)), JaxBytes(),
                    num_slots=2, max_len=256, prefill_chunk=64,
                    kv_host_budget_mb=64.0, kv_park_idle_s=0.0,
                    kv_restore_min_tokens=8, **kw)
    eng.start()
    try:
        for rid, sid, msgs in (("r1", "A", MSG1), ("rb", "B", FILLER),
                               ("rc", "C", FILLER)):
            _collect(eng, rid, sid, msgs, params_cls=JaxParams,
                     ignore_eos=True, **GREEDY)
        assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
        return eng._kv_pool.get("A")
    finally:
        eng.shutdown()


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_parked_entry_bytes_equal_jax(tier):
    """The same history parks the same entry shape as the JAX engine's:
    kept rows, the restore bucket, the stored rows (dense: the bucket;
    paged: whole blocks) and ``nbytes`` (int8 rows plus their f32 scales);
    the pool accounts those bytes."""
    want = _jax_entry(**TIERS[tier])
    eng = _engine(_params(0, torch.bfloat16), dtype=torch.bfloat16,
                  **TIERS[tier])
    try:
        for rid, sid, msgs in (("r1", "A", MSG1), ("rb", "B", FILLER),
                               ("rc", "C", FILLER)):
            _collect(eng, rid, sid, msgs, ignore_eos=True, **GREEDY)
        assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
        got = eng._kv_pool.get("A")
        assert eng._kv_pool.stats()["bytes"] >= got.nbytes
    finally:
        eng.shutdown()
    assert (got.kept, got.bucket, tuple(got.k.shape), got.nbytes) == \
        (want.kept, want.bucket, want.k.shape, want.nbytes)
    # The kept tokens: the same prompt, and as many generated tokens (the
    # two packages' random weights differ).
    prompt = ByteTokenizer().apply_chat_template(MSG1)
    assert got.tokens[:len(prompt)] == want.tokens[:len(prompt)] == prompt
    assert len(got.tokens) == len(want.tokens)
    assert (got.k_scale is None) == (want.k_scale is None)
    if got.k_scale is not None:
        assert tuple(got.k_scale.shape) == want.k_scale.shape
    if "paged" in tier:
        assert got.k.shape[1] == blocks_for(got.kept, 16) * 16
    assert got.k.is_pinned() is False  # CPU: no pinned memory without CUDA
    assert thostpool.entry_problem(got) is None


@pytest.mark.parametrize("tier", ["dense", "paged"])
def test_failed_restore_falls_back_to_prefill_with_an_empty_table(tier):
    """``kv.restore.dispatch`` fails once: the entry is purged, the slot's
    table is empty again (on the paged pool the same admission then takes
    the alias path from B's resident copy of A's turn, which requires an
    empty table), the request completes with the control's tokens, and the
    engine keeps serving with no block leaked."""
    from fasttalk_tpu_torch.resilience import failpoints as fp

    params = _params(2)
    kw = dict(num_slots=2, kv_block_size=16, **TIERS[tier])

    def run(eng, fail):
        ids = _record(eng)
        _collect(eng, "r1", "A", MSG1)
        _collect(eng, "rb", "B", MSG1)
        _collect(eng, "rc", "C", FILLER)
        if fail:
            assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
            fp.activate("kv.restore.dispatch=error;count=1")
        evs = _collect(eng, "r2", "A", MSG2)
        assert evs[-1]["type"] == "done", evs[-1]
        return ids["r2"]

    ctl = _engine(params, kv_host_budget_mb=0.0, **kw)
    try:
        want = run(ctl, False)
    finally:
        ctl.shutdown()
    eng = _engine(params, **kw)
    try:
        got = run(eng, True)
        fp.clear()
        assert eng.check_connection()
        st = eng.get_stats()
        assert st["kv_host"]["restore_failed"] == 1
        assert st["kv_host"]["restored_total"] == 0
        assert eng._kv_pool.parked_len("A") == 0
        if eng.paged:
            assert st["kv_blocks"]["alias_events"] >= 1
            eng._kv_blocks.check_leaks()
    finally:
        fp.clear()
        eng.shutdown()
    assert got == want


@pytest.mark.parametrize("tier", ["dense", "dense-int8", "paged"])
def test_a_late_host_copy_still_holds_the_evicted_rows(tier, monkeypatch):
    """The park's host copy is held back until the evicting session has
    prefilled and decoded in the slot (on the card a copy lands after work
    enqueued behind it). The restored rows are still the evicted session's:
    the park snapshots them on the device before anything of the new
    occupant is enqueued, so A's follow-up equals the control."""
    params = _params(4)
    release = threading.Event()
    copy = toffload.host_copy

    def late(rows, ready, stream):
        assert release.wait(30)
        return copy(rows, ready, stream)

    ctl = _engine(params, kv_host_budget_mb=0.0, **TIERS[tier])
    try:
        want, _ = _two_turns(ctl, evict=False)
    finally:
        ctl.shutdown()
    monkeypatch.setattr(toffload, "host_copy", late)
    eng = _engine(params, **TIERS[tier])
    try:
        ids = _record(eng)
        _collect(eng, "r1", "A", MSG1)
        _collect(eng, "rb", "B", FILLER)
        _collect(eng, "rc", "C", FILLER)      # evicts A; C writes A's slot
        assert eng._kv_offload.parking("A")
        assert eng._kv_pool.parked_len("A") == 0
        release.set()
        assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
        evs = _collect(eng, "r2", "A", MSG2)
        assert evs[-1]["type"] == "done", evs[-1]
        assert eng.get_stats()["kv_host"]["restored_total"] == 1
        got = (ids["r1"], ids["r2"])
    finally:
        release.set()
        eng.shutdown()
    assert got == want


def test_prestaged_rows_restore_and_the_wait_discount_is_the_saving():
    """A parked session's follow-up: the scheduler's discount is the
    policy's saving for the matched prefix, the rows are staged while the
    request waits (held here until staged), and the restore from the staged
    copies gives the control's tokens."""
    params = _params(5)
    ctl = _engine(params, kv_host_budget_mb=0.0)
    try:
        want, _ = _two_turns(ctl, evict=False)
    finally:
        ctl.shutdown()
    eng = _engine(params)
    _pin_policy(eng)
    try:
        ids = _record(eng)
        _collect(eng, "r1", "A", MSG1)
        _collect(eng, "rb", "B", FILLER)
        _collect(eng, "rc", "C", FILLER)
        assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
        entry = eng._kv_pool.get("A")
        prompt = eng.tokenizer.apply_chat_template(MSG2)
        match = _lcp(entry.tokens, prompt, min(entry.kept, len(prompt) - 1))
        saving = eng._kv_policy.restore_saving_s(match, entry.nbytes)
        assert saving > 0
        assert eng._kv_wait_discount("A", prompt) == pytest.approx(saving)
        admit = eng._admit
        eng._admit = lambda: entry.k_dev is not None and admit()
        evs = _collect(eng, "r2", "A", MSG2)
        assert evs[-1]["type"] == "done", evs[-1]
        assert entry.k_dev is not None and entry.staged_nbytes > 0
        assert eng.get_stats()["kv_host"]["restored_total"] == 1
        got = (ids["r1"], ids["r2"])
    finally:
        eng.shutdown()
    assert got == want


def test_pool_disabled_never_parks_and_release_purges_parked():
    ctl = _engine(kv_host_budget_mb=0.0, num_slots=1)
    try:
        _collect(ctl, "d1", "DA", MSG1)
        _collect(ctl, "d2", "DB", FILLER)  # evicts DA
        time.sleep(0.3)
        assert len(ctl._kv_pool) == 0
        assert ctl.get_stats()["kv_host"]["parked_total"] == 0
    finally:
        ctl.shutdown()
    eng = _engine()
    try:
        _collect(eng, "p1", "R", MSG1)
        _collect(eng, "p2", "F1", FILLER)
        _collect(eng, "p3", "F2", FILLER)  # R evicted -> parked
        assert _wait(lambda: eng._kv_pool.parked_len("R") > 0)
        assert eng.parked_kv_info("R")[0] == eng._kv_pool.parked_len("R")
        _collect(eng, "p4", "F3", FILLER)  # F1 evicted -> parked
        assert _wait(lambda: eng._kv_pool.parked_len("F1") > 0)
        assert eng.drop_parked_kv("F1") and not eng.drop_parked_kv("F1")
        assert eng.parked_kv_info("F1") is None
        eng.release_session("R")
        assert _wait(lambda: eng._kv_pool.parked_len("R") == 0), \
            "release_session leaked the parked entry"
        assert eng.parked_kv_info("R") is None
        assert eng.scheduler_debug()["kv_host"]["sessions"] == 0
    finally:
        eng.shutdown()


class TestReleaseAgainstPark:
    """tests/test_kvcache.py ``TestKVRacesAndRestart`` (its restart cases
    aside: the port has no ``restart()``) on a one-slot engine with idle
    parks."""

    @pytest.fixture(scope="class")
    def seng(self):
        e = _engine(num_slots=1, steps_per_call=4, kv_park_idle_s=0.05)
        yield e
        e.shutdown()

    def _park_p(self, seng):
        if seng._kv_pool.parked_len("P") > 0:
            return
        _collect(seng, f"pk{time.monotonic_ns()}", "P", MSG1)
        assert _wait(lambda: seng._kv_pool.parked_len("P") > 0,
                     timeout=15.0), "idle park never happened"

    async def _occupy(self, seng):
        """Start a long request that holds the only slot; returns its task
        and request id once it has generated a token. The id is new each
        time: a cancel of an earlier occupant still queued for the engine
        thread must not find this one under a reused id."""
        rid = f"occ-{time.monotonic_ns()}"

        async def consume():
            async for _ in seng.generate(
                    rid, "occ-s", FILLER,
                    GenerationParams(max_tokens=200, ignore_eos=True,
                                     **GREEDY)):
                pass

        task = asyncio.create_task(consume())
        deadline = time.monotonic() + 90.0
        while time.monotonic() < deadline:
            req = seng._by_id.get(rid)
            if req is not None and req.generated > 0:
                return task, rid
            await asyncio.sleep(0.01)
        raise AssertionError("occupant never generated a token")

    def test_restore_vs_cancel_race(self, seng):
        self._park_p(seng)
        before = seng.get_stats()["kv_host"]["restored_total"]

        async def scenario():
            occ, occ_id = await self._occupy(seng)
            p_events: list = []

            async def follow_up():
                async for ev in seng.generate(
                        "race-c", "P", MSG1,
                        GenerationParams(max_tokens=4, **GREEDY)):
                    p_events.append(ev)

            task = asyncio.create_task(follow_up())
            deadline = time.monotonic() + 10.0
            while seng.get_stats()["waiting"] < 1 \
                    and time.monotonic() < deadline:
                await asyncio.sleep(0.01)
            seng.cancel("race-c")
            await task
            assert p_events[-1]["type"] == "cancelled"
            seng.cancel(occ_id)
            await occ

        asyncio.run(asyncio.wait_for(scenario(), 120))
        assert seng.get_stats()["kv_host"]["restored_total"] == before
        assert seng._kv_pool.parked_len("P") > 0

    def test_restore_vs_deadline_expiry_race(self, seng):
        self._park_p(seng)
        before = seng.get_stats()["kv_host"]["restored_total"]

        async def scenario():
            occ, occ_id = await self._occupy(seng)
            p_events: list = []
            offset = [0.0]
            seng._sched._clock = lambda: time.monotonic() + offset[0]

            async def follow_up():
                async for ev in seng.generate(
                        "race-d", "P", MSG1,
                        GenerationParams(max_tokens=4, deadline_s=5.0,
                                         **GREEDY)):
                    p_events.append(ev)

            task = asyncio.create_task(follow_up())
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if seng.get_stats()["waiting"] >= 1:
                    break
                await asyncio.sleep(0.005)
            offset[0] = 10.0  # past the deadline; the occupant holds the slot
            await task
            assert p_events[-1]["type"] == "error"
            assert p_events[-1]["code"] == "deadline_expired"
            seng.cancel(occ_id)
            await occ

        asyncio.run(asyncio.wait_for(scenario(), 120))
        assert seng.get_stats()["kv_host"]["restored_total"] == before
        assert seng._kv_pool.parked_len("P") > 0


def test_stats_route_reports_kv_host_and_kv_radix():
    """``GET /stats`` carries the engine's ``kv_host`` (pool, policy) and
    ``kv_radix`` sections, as the JAX server's does."""
    from fasttalk_tpu_torch.serving.server import WebSocketLLMServer
    from fasttalk_tpu_torch.utils.config import Config

    eng = _engine(kv_layout="paged", kv_radix=True)
    try:
        server = WebSocketLLMServer(Config(model_name="test-tiny",
                                           model_path=""), eng)
        body = json.loads(asyncio.run(server._http_stats(None)).text)
    finally:
        eng.shutdown()
    assert body["engine"]["kv_host"]["enabled"] is True
    assert "copy_bytes_per_s" in body["engine"]["kv_host"]["policy"]
    assert body["engine"]["kv_radix"]["evict_policy"] == "lru"


# ---------------------------------------------------------------------
# Trained tinychat against the JAX engine
# ---------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_trained_park_restore_equals_jax_token_for_token(layout):
    """Trained tinychat, float32, two slots: A's turn, two fillers evict
    and park A, A's follow-up restores. The port's texts equal the JAX
    engine's (both with the policy's measurements pinned) and a
    never-evicted control's, and both engines restored once."""
    import jax.numpy as jnp

    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.loader import load_params

    ckpt = os.path.join(ASSETS, "tinychat")
    common = dict(num_slots=2, max_len=512, steps_per_call=8,
                  spec_decode="off", kv_layout=layout, kv_park_idle_s=0.0,
                  kv_restore_min_tokens=8)
    msg1 = [{"role": "user", "content": "my name is Ada."}]
    filler = [{"role": "user", "content": "what color is the sky?"}]

    def turns(eng, params_cls, evict):
        eng.start()
        try:
            if eng._kv_pool.enabled:
                _pin_policy(eng)
            r1 = _text(_collect(eng, "r1", "A", msg1, n=24,
                                params_cls=params_cls, **GREEDY))
            if evict:
                for rid, sid in (("rb", "B"), ("rc", "C")):
                    _collect(eng, rid, sid, filler, n=8,
                             params_cls=params_cls, **GREEDY)
                assert _wait(lambda: eng._kv_pool.parked_len("A") > 0)
            msgs = msg1 + [{"role": "assistant", "content": r1},
                           {"role": "user", "content": "what is my name?"}]
            evs = _collect(eng, "r2", "A", msgs, n=24,
                           params_cls=params_cls, **GREEDY)
            assert evs[-1]["type"] == "done", evs[-1]
            restored = eng.get_stats()["kv_host"]["restored_total"]
            return (r1, _text(evs)), restored
        finally:
            eng.shutdown()

    jcfg = jax_cfg("tinychat", ASSETS)
    want, jax_restored = turns(TPUEngine(
        jcfg, jax_load(jcfg, ckpt, jnp.float32),
        jax_tok(ASSETS, "tinychat", template=jcfg.chat_template),
        dtype=jnp.float32, kv_host_budget_mb=64.0, **common), JaxParams,
        True)
    cfg = get_model_config("tinychat", ASSETS)
    params = load_params(cfg, ckpt, torch.float32, "cpu")

    def port(budget):
        return TorchEngine(cfg, params, load_tokenizer(
            ASSETS, "tinychat", template=cfg.chat_template), device="cpu",
            dtype=torch.float32, kv_host_budget_mb=budget, **common)
    ctl, _ = turns(port(0.0), GenerationParams, False)
    got, restored = turns(port(64.0), GenerationParams, True)
    assert got == want == ctl
    assert restored == jax_restored == 1
