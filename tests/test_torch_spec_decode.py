"""Speculative decoding in fasttalk_tpu_torch (``TPU_SPEC_DECODE``), on the
CPU, mirroring tests/test_spec_decode.py.

The bar is the JAX package's: speculative decoding is a pure throughput
transform. Greedy streams equal plain decoding's token for token (in the
port, and against ``TPUEngine`` with ``spec_decode="ngram"`` on the trained
tinychat checkpoint); budgets, EOS and the context end hold; auto mode
probes and tracks its acceptance EMA; a degenerate loop accepts whole
drafts; the history buffer holds every slot's fed tokens; spec composes
with the shared prefix, the paged tier and concurrent sessions. Sampled
output keeps plain decoding's distribution: at temperature 1 with all
three penalties on, the first two emitted tokens of 4,096 independent
rows are held to plain decoding's by a two-sample chi-square test, and
``penalize_values`` and the verify block's per-position penalties to the
JAX formula.
"""

import asyncio
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency

from fasttalk_tpu_torch.engine.decode_steps import (DecodeState, plain_steps,
                                                    spec_steps,
                                                    verify_penalties)
from fasttalk_tpu_torch.engine.engine import GenerationParams, TorchEngine
from fasttalk_tpu_torch.engine.tokenizer import ByteTokenizer
from fasttalk_tpu_torch.models.configs import get_model_config
from fasttalk_tpu_torch.models.llama import forward, init_cache, init_params
from fasttalk_tpu_torch.ops.sampling import penalize_values
from fasttalk_tpu_torch.utils.metrics import get_metrics
from tests._port_isolation import port_isolation  # noqa: F401,E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "fasttalk_tpu", "assets")
TINY = get_model_config("test-tiny")
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _params(seed: int, zero: bool = False) -> dict:
    p = init_params(TINY, torch.Generator().manual_seed(seed), torch.float32,
                    "cpu")
    if zero:
        p = {k: ({n: torch.zeros_like(t) for n, t in v.items()}
                 if isinstance(v, dict) else torch.zeros_like(v))
             for k, v in p.items()}
    return p


def _engine(params, spec: str, **kw) -> TorchEngine:
    opts = dict(num_slots=4, max_len=512, prefill_chunk=64, seed=0,
                dtype=torch.float32, spec_decode=spec, spec_draft_len=7)
    opts.update(kw)
    eng = TorchEngine(TINY, params, ByteTokenizer(), device="cpu", **opts)
    eng.start()
    return eng


async def _stream(eng, rid: str, messages: list, max_tokens: int,
                  **kw) -> tuple[str, dict]:
    text, final = "", {}
    async for ev in eng.generate(rid, f"s-{rid}", messages,
                                 GenerationParams(max_tokens=max_tokens,
                                                  **{**GREEDY, **kw})):
        if ev["type"] == "token":
            text += ev["text"]
        else:
            final = ev
    return text, final


def _generate(eng, prompt: str, max_tokens: int, rid: str = "r1"):
    return asyncio.run(asyncio.wait_for(_stream(
        eng, rid, [{"role": "user", "content": prompt}], max_tokens), 180))


def _run(params, spec, prompt, max_tokens, **kw):
    eng = _engine(params, spec, **kw)
    try:
        return _generate(eng, prompt, max_tokens), eng.get_stats()
    finally:
        eng.shutdown()


def test_greedy_stream_identical_to_plain_decode():
    params = _params(3)
    (ref, ref_final), _ = _run(params, "off", "the quick brown fox", 48)
    (got, final), stats = _run(params, "ngram", "the quick brown fox", 48)
    assert got == ref
    assert final["stats"]["tokens_generated"] == \
        ref_final["stats"]["tokens_generated"]
    assert final["finish_reason"] == ref_final["finish_reason"]
    assert stats["spec"]["calls"] > 0 and stats["spec"]["verify_blocks"] > 0


def test_auto_mode_greedy_parity_both_regimes():
    """Auto flips between plain (history) and speculative calls from its
    EMA; probing-mostly-plain, always-spec and never-above-threshold runs
    all emit the plain greedy stream."""
    params = _params(3)
    (ref, _), _ = _run(params, "off", "the quick brown fox", 48)
    for breakeven in (1.45, 0.0, 99.0):
        (got, _), _ = _run(params, "auto", "the quick brown fox", 48,
                           spec_breakeven=breakeven)
        assert got == ref, breakeven


def _tinychat_texts(params_cls, make, prompts):
    eng = make()
    eng.start()
    try:
        async def run():
            out = {}
            for rid, msgs, n in prompts:
                params = params_cls(max_tokens=n, **GREEDY)
                text, final = "", {}
                async for ev in eng.generate(rid, f"s-{rid}", msgs, params):
                    if ev["type"] == "token":
                        text += ev["text"]
                    else:
                        final = ev
                out[rid] = (text, final["stats"]["tokens_generated"])
            return out
        return asyncio.run(run()), eng.get_stats()
    finally:
        eng.shutdown()


def test_tinychat_spec_matches_jax_spec_engine():
    """The trained checkpoint, float32: the port with spec_decode="ngram"
    gives the JAX engine's ngram greedy text and token count on each
    prompt, and its own plain text."""
    from fasttalk_tpu.engine.engine import GenerationParams as JaxParams
    from fasttalk_tpu.engine.engine import TPUEngine
    from fasttalk_tpu.engine.tokenizer import load_tokenizer as jax_tok
    from fasttalk_tpu.models.configs import get_model_config as jax_cfg
    from fasttalk_tpu.models.loader import load_params as jax_load
    from fasttalk_tpu_torch.engine.tokenizer import load_tokenizer
    from fasttalk_tpu_torch.models.loader import load_params

    prompts = [
        ("sky", [{"role": "user", "content": "what color is the sky?"}], 48),
        ("alice", [{"role": "user", "content": "my name is Alice."},
                   {"role": "assistant",
                    "content": "Nice to meet you, Alice!"},
                   {"role": "user", "content": "what is my name?"}], 24)]
    ckpt = os.path.join(ASSETS, "tinychat")
    jcfg = jax_cfg("tinychat", ASSETS)
    jax_out, _ = _tinychat_texts(JaxParams, lambda: TPUEngine(
        jcfg, jax_load(jcfg, ckpt, jnp.float32),
        jax_tok(ASSETS, "tinychat", template=jcfg.chat_template),
        num_slots=4, max_len=512, dtype=jnp.float32, steps_per_call=8,
        spec_decode="ngram", shared_prefix=False), prompts)
    cfg = get_model_config("tinychat", ASSETS)
    params = load_params(cfg, ckpt, torch.float32, "cpu")

    def port(spec):
        return lambda: TorchEngine(
            cfg, params, load_tokenizer(ASSETS, "tinychat",
                                        template=cfg.chat_template),
            device="cpu", num_slots=4, max_len=512, dtype=torch.float32,
            steps_per_call=8, spec_decode=spec)
    got, stats = _tinychat_texts(GenerationParams, port("ngram"), prompts)
    plain, _ = _tinychat_texts(GenerationParams, port("off"), prompts)
    assert got == jax_out == plain
    assert "blue" in got["sky"][0].lower() and "Alice" in got["alice"][0]
    assert stats["spec"]["verify_blocks"] > 0


def test_auto_mode_probes_and_tracks_ema():
    """Below break-even auto still probes, so the EMA keeps tracking; on a
    degenerate loop the EMA climbs past the break-even and auto keeps
    taking speculative calls."""
    eng = _engine(_params(3), "auto", spec_breakeven=99.0)
    try:
        _generate(eng, "a b a b a b a b a b a b a b", 64)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert 0 < stats["spec"]["calls"] < stats["decode_calls"]
    assert stats["spec"]["ema_tokens_per_verify"] != 1.0
    eng = _engine(_params(0, zero=True), "auto")
    try:
        _generate(eng, "abc", 200)
        stats = eng.get_stats()
    finally:
        eng.shutdown()
    assert stats["spec"]["ema_tokens_per_verify"] >= 1.45
    assert stats["spec"]["calls"] >= stats["decode_calls"] - 1


def test_full_acceptance_on_degenerate_loop():
    """All-zero weights emit one constant token, so every draft after the
    first block is right: blocks accept the whole draft."""
    hist = get_metrics().histogram("engine_spec_tokens_per_verify")
    before = hist.summary()
    (_, final), stats = _run(_params(0, zero=True), "ngram", "abc", 64)
    after = hist.summary()
    assert final["stats"]["tokens_generated"] == 64
    n = after["count"] - before["count"]
    mean = (after["sum"] - before["sum"]) / n
    assert n >= 8 and mean > 6.0, (n, mean)
    assert stats["spec"]["accepted"] > 0.75 * stats["spec"]["drafted"]


def test_spec_respects_max_tokens_and_eos_semantics():
    """An accepted run past the budget is dropped: exactly max_tokens
    tokens, finish_reason length."""
    (_, final), _ = _run(_params(0, zero=True), "ngram", "abc", 13)
    assert final["stats"]["tokens_generated"] == 13
    assert final["finish_reason"] == "length"


def test_context_end_falls_back_to_plain_decode():
    """Near the cache end there is no room for a verify block: plain calls
    take over and the request ends at the context limit."""
    (_, final), stats = _run(_params(0, zero=True), "ngram", "xy", 2048)
    assert final["finish_reason"] == "length"
    used = final["stats"]["prompt_tokens"] + final["stats"]["tokens_generated"]
    assert used >= 511, final
    assert stats["decode_calls"] > stats["spec"]["calls"] > 0


def test_no_livelock_when_block_exceeds_expected_advance():
    """steps_per_call=2 with a 7-token draft: the KV bucket must hold a
    whole verify block, or the gated call would repeat forever."""
    eng = _engine(_params(0, zero=True), "ngram", num_slots=2,
                  steps_per_call=2)
    try:
        _, final = _generate(eng, "xy", 2048)
    finally:
        eng.shutdown()
    assert final["finish_reason"] == "length"
    used = final["stats"]["prompt_tokens"] + final["stats"]["tokens_generated"]
    assert used >= 511, final


SYSTEM = ("You are a terse assistant; answer in one short sentence. " * 6)


def _burst(params, spec, shared, n=3, **kw):
    eng = _engine(params, spec, max_len=1024, prefill_chunk=512,
                  shared_prefix=shared, **kw)

    async def run():
        outs = await asyncio.gather(*(_stream(
            eng, f"r{i}", [{"role": "system", "content": SYSTEM},
                           {"role": "user", "content": f"q {i}"}], 20)
            for i in range(n)))
        return [t for t, f in outs], [f for t, f in outs]
    try:
        texts, finals = asyncio.run(asyncio.wait_for(run(), 180))
        return texts, finals, eng.get_stats()
    finally:
        eng.shutdown()


def test_spec_with_shared_prefix_still_greedy_identical():
    params = _params(9)
    ref, _, _ = _burst(params, "off", False)
    got, finals, stats = _burst(params, "ngram", True)
    assert got == ref
    assert all(f["type"] == "done" for f in finals)
    assert stats["prefix_tokens_shared"] > 0 and stats["spec"]["calls"] > 0


def test_spec_on_the_paged_tier_still_greedy_identical():
    """The verify block over the paged pool (its masked writes in the sink
    block) gives the dense plain stream, and every block comes back."""
    params = _params(9)
    ref, _, _ = _burst(params, "off", False)
    eng = _engine(params, "ngram", max_len=1024, prefill_chunk=512,
                  kv_layout="paged", kv_pool_blocks=256)

    async def run():
        outs = await asyncio.gather(*(_stream(
            eng, f"r{i}", [{"role": "system", "content": SYSTEM},
                           {"role": "user", "content": f"q {i}"}], 20)
            for i in range(3)))
        for i in range(3):
            eng.release_session(f"s-r{i}")
        await _stream(eng, "sync", [{"role": "user", "content": "x"}], 1)
        return [t for t, _ in outs]
    try:
        got = asyncio.run(asyncio.wait_for(run(), 180))
        stats = eng.get_stats()
        eng._kv_blocks.check_leaks()
    finally:
        eng.shutdown()
    assert got == ref
    assert stats["spec"]["verify_blocks"] > 0


def test_multi_session_spec_concurrent():
    """Concurrent spec sessions get their own budgets: per-slot acceptance
    never moves a token to another request."""
    eng = _engine(_params(5), "ngram")

    async def run():
        outs = await asyncio.gather(*(_stream(
            eng, f"r{i}", [{"role": "user", "content": f"prompt number {i}"}],
            16 + i) for i in range(4)))
        return [f["stats"]["tokens_generated"] for _, f in outs]
    try:
        counts = asyncio.run(asyncio.wait_for(run(), 180))
    finally:
        eng.shutdown()
    assert counts == [16, 17, 18, 19]


@pytest.mark.parametrize("spec,breakeven", [("ngram", 1.45),
                                            ("auto", 99.0)])
def test_history_buffer_holds_each_slots_fed_tokens(spec, breakeven):
    """After generations finish, each slot's device history holds exactly
    the tokens fed to it (prompt rows from the activation patch, then the
    fed or emitted tokens of plain-with-history and spec calls): a wrong
    row would only lower acceptance, so the buffer itself is checked."""
    eng = _engine(_params(5), spec, spec_breakeven=breakeven)

    async def run():
        await asyncio.gather(*(_stream(
            eng, f"r{i}", [{"role": "user", "content": f"tell me {i} " * 3}],
            30 + 5 * i) for i in range(3)))
        # A second turn on session r0 reuses its resident prefix.
        await _stream(eng, "r0", [{"role": "user",
                                   "content": "tell me 0 " * 3},
                                  {"role": "assistant", "content": "ok"},
                                  {"role": "user", "content": "more"}], 12)
    try:
        asyncio.run(asyncio.wait_for(run(), 180))
        hist = eng._dev.history.numpy()
        checked = 0
        for slot in eng.slots.slots:
            if slot.session_id is None:
                continue
            n = slot.kv_written
            assert n > 0
            np.testing.assert_array_equal(hist[slot.index, :n],
                                          np.array(slot.tokens[:n]))
            checked += 1
        assert checked == 3
    finally:
        eng.shutdown()


def test_penalize_values_matches_jax():
    from fasttalk_tpu.ops.sampling import penalize_values as jax_pen

    rng = np.random.default_rng(0)
    lg = rng.normal(size=(3, 5, 40)).astype(np.float32)
    counts = rng.integers(0, 3, size=(3, 1, 40)).astype(np.float32)
    rep = rng.uniform(0.5, 2.0, size=(3, 1, 1)).astype(np.float32)
    pres = rng.uniform(-1, 1, size=(3, 1, 1)).astype(np.float32)
    freq = rng.uniform(-1, 1, size=(3, 1, 1)).astype(np.float32)
    got = penalize_values(*(torch.from_numpy(a) for a in
                            (lg, counts, rep, pres, freq))).numpy()
    want = np.asarray(jax_pen(*(jnp.asarray(a) for a in
                                (lg, counts, rep, pres, freq))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_verify_penalties_are_exact_per_position():
    """Block position j sees the base counts plus d_1..d_j: the port's
    broadcast-and-correct form equals JAX's apply_penalties run position
    by position on explicit counts (1e-6), duplicated and out-of-vocab
    drafts included."""
    from fasttalk_tpu.ops.sampling import apply_penalties as jax_apply

    rng = np.random.default_rng(1)
    s, g, v = 3, 4, 12
    t = g + 1
    lg = rng.normal(size=(s, t, v)).astype(np.float32)
    counts = rng.integers(0, 2, size=(s, v)).astype(np.int32)
    drafts = np.array([[1, 1, 5, 2], [3, 14, 3, 3], [0, 7, 11, 20]])
    reps = np.array([1.3, 0.8, 1.1], np.float32)
    press = np.array([0.5, -0.2, 0.0], np.float32)
    freqs = np.array([0.3, 0.1, -0.4], np.float32)
    got = verify_penalties(torch.from_numpy(lg), torch.from_numpy(counts),
                           torch.from_numpy(drafts), torch.from_numpy(reps),
                           torch.from_numpy(press),
                           torch.from_numpy(freqs)).numpy()
    for j in range(t):
        c = counts.copy()
        for row in range(s):
            for d in drafts[row, :j]:
                if d < v:
                    c[row, d] += 1
        want = np.asarray(jax_apply(jnp.asarray(lg[:, j]), jnp.asarray(c),
                                    jnp.asarray(reps), jnp.asarray(press),
                                    jnp.asarray(freqs)))
        np.testing.assert_allclose(got[:, j], want, rtol=1e-6, atol=1e-6)


# Two-sample chi-square threshold: p < 1e-4 rejects. With fixed seeds the
# draws are deterministic, so the test cannot flake; a wrong penalty or
# acceptance rule moves the second token's distribution by far more.
CHI2_P_MIN = 1e-4


def test_sampled_tokens_keep_plain_decodings_distribution():
    """Temperature 1, top-k/top-p off, repeat 1.5 / presence 0.5 /
    frequency 0.4, the vocabulary cut to 8 ids so the drafts are often
    accepted: 4,096 independent rows decode the same prompt plain and
    speculative; the first and the second emitted token (the second comes
    out of the verify block whenever the first accepted draft matched)
    have the same distribution by a chi-square test at p >= 1e-4, and
    drafts were accepted in at least a fifth of the rows."""
    rows, vocab, draft, ctx = 4096, 8, 3, 64
    params = _params(11)
    prompt = torch.tensor([[1, 2, 3, 1, 2, 3, 1, 2, 4, 1]])
    plen = prompt.shape[1]
    cache = init_cache(TINY, 1, ctx, torch.float32, "cpu")
    forward(params, TINY, prompt, torch.arange(plen)[None], cache,
            torch.zeros(1, dtype=torch.long))

    def run(fn, seed):
        big = type(cache)(*(None if x is None else
                            x.expand(-1, rows, *x.shape[2:]).clone()
                            for x in cache))
        st = DecodeState.zeros(rows, vocab, ctx, torch.device("cpu"), seed)
        st.history[:, :plen] = prompt
        st.cur[:] = 2
        st.pos[:] = plen
        st.active[:] = True
        st.temps[:] = 1.0
        st.reps[:] = 1.5
        st.press[:] = 0.5
        st.freqs[:] = 0.4
        if fn is plain_steps:
            toks = plain_steps(params, TINY, big, st, 2, ctx,
                               sample_vocab=vocab, method="exact")
            return toks[0].numpy(), toks[1].numpy(), None
        out = spec_steps(params, TINY, big, st, 2, ctx, draft,
                         sample_vocab=vocab, method="exact").numpy()
        first = out[0, :, 0]
        n0 = out[0, :, -1]
        second = np.where(n0 >= 2, out[0, :, 1], out[1, :, 0])
        return first, second, n0

    p1, p2, _ = run(plain_steps, 100)
    s1, s2, n0 = run(spec_steps, 200)
    assert (n0 >= 2).mean() >= 0.2, (n0 >= 2).mean()
    for a, b in ((p1, s1), (p2, s2)):
        table = np.stack([np.bincount(a, minlength=vocab),
                          np.bincount(b, minlength=vocab)])
        table = table[:, table.sum(0) > 0]
        p = chi2_contingency(table)[1]
        assert p >= CHI2_P_MIN, (table, p)


def test_verify_block_takes_the_decode_kernels():
    """``forward_decode_multi`` sends the verify block's [B, T, D]
    activations to the seven layer matmuls and the lm_head as [B*T, D]
    rows through the decode kernels' wrappers (here their plain versions,
    on CPU tensors), while ``forward`` (prefill) keeps the dequantized
    product; the T = 8 block's logits equal 8 single-token steps' (1e-4
    of the logit range), the arithmetic greedy parity relies on."""
    from fasttalk_tpu_torch.models import llama
    from fasttalk_tpu_torch.ops import cuda_int8, quant
    from fasttalk_tpu_torch.ops.quant import quantize_params

    params = quantize_params(_params(4))
    calls = []

    def rec(fn):
        def wrapped(x, q, s):
            calls.append((fn.__name__, tuple(x.shape)))
            return fn(x, q, s)
        return wrapped

    saved = quant.int8_matmul, quant.int8_matmul_t
    quant.int8_matmul = rec(cuda_int8.int8_matmul_plain)
    quant.int8_matmul_t = rec(cuda_int8.int8_matmul_t_plain)
    try:
        b, t, plen = 2, 8, 12
        g = torch.Generator().manual_seed(0)
        prompt = torch.randint(0, 256, (b, plen), generator=g)
        block = torch.randint(0, 256, (b, t), generator=g)
        caches = [llama.init_cache(TINY, b, 512, torch.float32, "cpu")
                  for _ in range(2)]
        for cache in caches:
            llama.forward(params, TINY, prompt,
                          torch.arange(plen)[None].expand(b, plen), cache,
                          torch.zeros(b, dtype=torch.long))
        prefill_calls = list(calls)
        calls.clear()
        mask = torch.ones(b, dtype=torch.bool)
        multi, _ = llama.forward_decode_multi(
            params, TINY, block, torch.full((b,), plen), caches[0], mask,
            attn_len=512)
        verify_calls = list(calls)
        steps = torch.stack([llama.forward_decode(
            params, TINY, block[:, j], torch.full((b,), plen + j),
            caches[1], mask, attn_len=512)[0] for j in range(t)], dim=1)
    finally:
        quant.int8_matmul, quant.int8_matmul_t = saved
    assert prefill_calls == []
    layer = [c for c in verify_calls if c[0] == "int8_matmul_plain"]
    head = [c for c in verify_calls if c[0] == "int8_matmul_t_plain"]
    assert len(layer) == 7 * TINY.num_layers and len(head) == 1
    assert all(shape[0] == b * t for _, shape in verify_calls)
    span = (steps.max() - steps.min()).item()
    assert (multi - steps).abs().max().item() <= 1e-4 * span
