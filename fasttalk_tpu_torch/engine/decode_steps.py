"""The decode programs of ``TorchEngine``: plain, history and speculative.

Counterparts of the JAX engine's jitted decode families
(``fasttalk_tpu/engine/engine.py``): ``_get_decode_fn`` (:1839, K plain
steps under ``lax.scan``), its ``with_history`` variant (:1909-1968, the
same steps plus the draft history) and ``_get_spec_decode_fn``
(:2175-2340, K draft-verify-accept steps). Here each is a Python loop of
eager PyTorch ops over ``DecodeState``, the per-slot decode state that
stays on the device between calls; nothing in them waits for the device.

The speculative step, per slot and entirely on the device:

1. the history invariant ``history[s, pos] = cur`` (the fed token);
2. the draft by prompt lookup: the latest earlier occurrence of ``cur`` in
   the slot's history, and the ``draft`` tokens that followed it;
3. the verify block ``cur + drafts`` (T = draft + 1 positions) through
   ``forward_decode_multi``; a slot without T rows of headroom in the KV
   bucket sits the step out (``n_out = 0``);
4. every position sampled in one ``sample_tokens`` call; the longest
   prefix where the sample equals the draft is accepted, and accepted + 1
   tokens are emitted: the first mismatch is the plain-decode sample, so
   the output distribution is plain decoding's;
5. penalties exact per position: every position is penalised against the
   base counts, then the draft columns are re-penalised with their counts
   inside the block; the accepted drafts are then committed to the counts.

Rejected positions leave KV rows past the accepted length that nothing
reads: attention masks at each query's absolute position, and the next
block writes those rows first. The history buffer has one column past
``max_len``, the sink of masked history writes.

The constrained variant (``plain_steps`` given ``FSMTables``; JAX
``_build_fsm_decode`` :2053, ``decode_fsm`` / ``decode_fsm_hist``) runs
the same step with two additions, both on the device: after the
penalties, each slot's logits outside the allowed-token mask of its FSM
state ``masks[fst]`` (packed bits, unpacked to ``[S, sample_vocab]``) are
set to -1e30 before the sampler's candidate preselection; after the
sample, active slots advance ``fst = nexts[fst, cls[sel, tok]]``.
Unconstrained slots ride along in the FREE state (every token allowed, a
self-loop). Without tables the step is exactly the plain one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from fasttalk_tpu_torch.models.configs import ModelConfig
from fasttalk_tpu_torch.models.llama import (KVCache, forward_decode,
                                             forward_decode_multi)
from fasttalk_tpu_torch.ops.sampling import (apply_penalties,
                                             penalize_values, sample_tokens)


@dataclass
class DecodeState:
    """Per-slot decode state kept on the device: the token to feed next,
    its position, whether the slot decodes, the sampling parameters, the
    emitted-token counts of the penalties [S, V], and (speculative
    decoding only) the token history [S, max_len + 1] the drafts come
    from. ``gen`` is the one generator every sample draws from."""

    cur: torch.Tensor
    pos: torch.Tensor
    active: torch.Tensor
    temps: torch.Tensor
    topks: torch.Tensor
    topps: torch.Tensor
    reps: torch.Tensor
    press: torch.Tensor
    freqs: torch.Tensor
    counts: torch.Tensor
    history: torch.Tensor | None
    gen: torch.Generator | None
    rows: torch.Tensor
    fst: torch.Tensor        # FSM state per slot (0 = FREE)

    @classmethod
    def zeros(cls, slots: int, vocab: int, history_len: int,
              device: torch.device, seed: int) -> "DecodeState":
        """All slots idle; ``history_len`` 0 keeps no history."""
        def z(dtype, fill=0):
            return torch.full((slots,), fill, dtype=dtype, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return cls(
            cur=z(torch.int64), pos=z(torch.int64), active=z(torch.bool),
            temps=z(torch.float32), topks=z(torch.int64),
            topps=z(torch.float32, 1), reps=z(torch.float32, 1),
            press=z(torch.float32), freqs=z(torch.float32),
            counts=torch.zeros((slots, vocab), dtype=torch.int32,
                               device=device),
            history=(torch.zeros((slots, history_len + 1), dtype=torch.int64,
                                 device=device) if history_len else None),
            gen=gen, rows=torch.arange(slots, device=device),
            fst=z(torch.int64))


@dataclass
class FSMTables:
    """The structured arena's union tables on the device
    (structured/runtime.py): ``masks`` [N, W] int32 holds the uint32 words
    of each state's allowed-token bits (token t is bit t % 32 of word
    t // 32), ``nexts`` [N, C] the transitions by token class, ``cls``
    [F, V] each FSM's token classes; ``sel`` [S] is each slot's row of
    ``cls`` and ``powers`` [32] the bit of each position."""

    masks: torch.Tensor
    nexts: torch.Tensor
    cls: torch.Tensor
    sel: torch.Tensor
    powers: torch.Tensor

    @classmethod
    def upload(cls, masks: np.ndarray, nexts: np.ndarray, classes: np.ndarray,
               sel: torch.Tensor, device: torch.device) -> "FSMTables":
        """From the arena's numpy tables (``masks`` uint32): the words keep
        their bits as int32, the index tables go to int64."""
        return cls(masks=torch.from_numpy(masks.view(np.int32)).to(device),
                   nexts=torch.from_numpy(nexts).to(device, torch.int64),
                   cls=torch.from_numpy(classes).to(device, torch.int64),
                   sel=sel, powers=bit_powers(device))


def bit_powers(device: torch.device) -> torch.Tensor:
    """[32] int32: 1 << b, with bit 31 the int32 sign bit."""
    return torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int32, device=device),
        torch.arange(32, dtype=torch.int32, device=device))


def unpack_mask(words: torch.Tensor, powers: torch.Tensor,
                vocab: int) -> torch.Tensor:
    """Packed words [..., W] int32 -> allowed [..., vocab] bool."""
    allow = (words[..., None] & powers) != 0
    return allow.reshape(*words.shape[:-1], -1)[..., :vocab]


def fsm_mask(lg: torch.Tensor, fst: torch.Tensor,
             fsm: FSMTables) -> torch.Tensor:
    """Logits [S, V] with every token the slot's state forbids at -1e30."""
    allow = unpack_mask(fsm.masks[fst], fsm.powers, lg.shape[-1])
    return torch.where(allow, lg, torch.full_like(lg, -1e30))


def fsm_advance(fst: torch.Tensor, tok: torch.Tensor, act: torch.Tensor,
                fsm: FSMTables) -> torch.Tensor:
    """The next FSM state of every active slot after sampling ``tok``."""
    return torch.where(act, fsm.nexts[fst, fsm.cls[fsm.sel, tok]], fst)


def plain_steps(params: dict, cfg: ModelConfig, cache: KVCache,
                st: DecodeState, steps: int, kv_len: int, *,
                sample_vocab: int, method: str,
                table: torch.Tensor | None = None,
                block_size: int = 0,
                fsm: FSMTables | None = None) -> torch.Tensor:
    """``steps`` decode steps; returns the sampled tokens [K, S]. Keeps
    the draft history current when ``st.history`` exists (the JAX
    ``with_history`` variant). With ``fsm`` the steps are constrained
    (JAX ``decode_fsm`` / ``decode_fsm_hist``) and ``st.fst`` advances."""
    toks = torch.empty((steps, st.cur.shape[0]), dtype=torch.int64,
                       device=st.cur.device)
    cur, pos, fst = st.cur, st.pos, st.fst
    hist = st.history
    for k in range(steps):
        # A slot that finished mid-pipeline keeps "decoding" until the
        # host reconciles; keep it off the attention horizon.
        act = st.active & (pos < kv_len)
        if hist is not None:
            sink = hist.shape[1] - 1
            hist[st.rows, torch.where(act, pos, sink)] = cur
        # Count the token being FED: every emitted token is counted
        # exactly once at sampling time.
        st.counts.scatter_add_(1, cur[:, None], act.to(torch.int32)[:, None])
        logits, _ = forward_decode(params, cfg, cur, pos, cache, act,
                                   attn_len=kv_len, block_table=table,
                                   block_size=block_size)
        lg = apply_penalties(logits[:, :sample_vocab], st.counts, st.reps,
                             st.press, st.freqs)
        if fsm is not None:
            lg = fsm_mask(lg, fst, fsm)
        cur = sample_tokens(lg, st.gen, st.temps, st.topks, st.topps,
                            method=method)
        if fsm is not None:
            fst = fsm_advance(fst, cur, act, fsm)
        pos = pos + act.to(pos.dtype)
        toks[k] = cur
    st.cur, st.pos, st.fst = cur, pos, fst
    return toks


def draft_tokens(hist: torch.Tensor, cur: torch.Tensor, pos: torch.Tensor,
                 draft: int) -> torch.Tensor:
    """Prompt lookup [S, draft]: the tokens that followed the latest
    occurrence of ``cur`` before ``pos`` in each slot's history (from the
    history's start when there is none)."""
    max_len = hist.shape[1] - 1
    idx = torch.arange(max_len, device=hist.device)
    seen = (hist[:, :max_len] == cur[:, None]) & (idx[None] < pos[:, None])
    j = torch.where(seen, idx[None], torch.full_like(idx[None], -1)) \
        .amax(dim=1)
    start = (j + 1).clamp(0, max_len - 1)
    didx = (start[:, None] + torch.arange(draft, device=hist.device)[None]) \
        .clamp(0, max_len - 1)
    return hist.gather(1, didx)


def verify_penalties(lgf: torch.Tensor, counts: torch.Tensor,
                     drafts: torch.Tensor, reps: torch.Tensor,
                     press: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Penalised verify-block logits [S, T, V] (``lgf`` float32): position
    j is conditioned on the fed tokens cur, d_1..d_j, so a draft token's
    count there is its base count plus its occurrences among d_1..d_j.
    Everything is penalised against the base counts, then the <= G draft
    columns are re-penalised with their block counts and written back.
    Draft ids at or past V (prompt tokens outside the sampled vocabulary)
    can never be sampled, and their corrections are dropped."""
    s, t, v = lgf.shape
    g = drafts.shape[1]
    r3, p3, f3 = reps[:, None, None], press[:, None, None], freqs[:, None, None]
    lg = penalize_values(lgf, counts[:, None, :].to(torch.float32), r3, p3, f3)
    eq = (drafts[:, :, None] == drafts[:, None, :]).to(torch.float32)
    extra = torch.cat([torch.zeros((s, g, 1), device=lgf.device),
                       torch.cumsum(eq, dim=2)], dim=2)          # [S, G, T]
    dcl = drafts.clamp(max=v - 1)
    dcol = dcl[:, None, :].expand(s, t, g)
    raw = lgf.gather(2, dcol)                                    # [S, T, G]
    base = counts.gather(1, dcl).to(torch.float32)               # [S, G]
    corr = penalize_values(raw, base[:, None, :] + extra.transpose(1, 2),
                           r3, p3, f3)
    # Equal drafts get equal corrected values, so duplicate indices write
    # one value; out-of-vocabulary drafts write the dropped extra column.
    scat = torch.where(drafts < v, dcl, torch.full_like(dcl, v))
    padded = torch.cat([lg, torch.zeros((s, t, 1), device=lg.device)], dim=2)
    padded.scatter_(2, scat[:, None, :].expand(s, t, g), corr)
    return padded[..., :v]


def spec_steps(params: dict, cfg: ModelConfig, cache: KVCache,
               st: DecodeState, steps: int, kv_len: int, draft: int, *,
               sample_vocab: int, method: str,
               table: torch.Tensor | None = None,
               block_size: int = 0) -> torch.Tensor:
    """``steps`` speculative steps; returns [K, S, T + 1]: per step and
    slot the T sampled tokens and, last, ``n_out`` (the host consumes the
    first ``n_out`` tokens). Needs ``st.history``."""
    hist = st.history
    s = st.cur.shape[0]
    t = draft + 1
    sink = hist.shape[1] - 1
    dev = st.cur.device
    ar_t = torch.arange(t, device=dev)
    out = torch.empty((steps, s, t + 1), dtype=torch.int64, device=dev)
    cur, pos = st.cur, st.pos
    for k in range(steps):
        act = st.active & (pos + t <= kv_len)
        hist[st.rows, torch.where(act, pos, sink)] = cur
        st.counts.scatter_add_(1, cur[:, None], act.to(torch.int32)[:, None])
        drafts = draft_tokens(hist, cur, pos, draft)
        logits, _ = forward_decode_multi(
            params, cfg, torch.cat([cur[:, None], drafts], dim=1), pos,
            cache, act, attn_len=kv_len, block_table=table,
            block_size=block_size)
        lg = verify_penalties(logits[..., :sample_vocab].to(torch.float32),
                              st.counts, drafts, st.reps, st.press, st.freqs)
        samp = sample_tokens(
            lg.reshape(s * t, sample_vocab), st.gen,
            *(x[:, None].expand(s, t).reshape(s * t)
              for x in (st.temps, st.topks, st.topps)),
            method=method).view(s, t)
        match = (samp[:, :-1] == drafts).to(torch.int64)
        accepted = torch.cumprod(match, dim=1).sum(dim=1)        # 0..G
        n_out = torch.where(act, accepted + 1, torch.zeros_like(accepted))
        cur = torch.where(act, samp.gather(1, accepted[:, None])[:, 0], cur)
        # The emitted tokens join the history; the rest go to the sink.
        keep = ar_t[None] < n_out[:, None]
        hist[st.rows[:, None],
             torch.where(keep, (pos[:, None] + 1 + ar_t[None]).clamp(
                 max=sink), torch.full_like(samp, sink))] = samp
        # Accepted drafts were fed and emitted: they count now. The last
        # emitted token (the new cur) counts when it is fed.
        st.counts.scatter_add_(
            1, samp, (ar_t[None] < (n_out - 1)[:, None]).to(torch.int32))
        pos = pos + n_out
        out[k, :, :t] = samp
        out[k, :, t] = n_out
    st.cur, st.pos = cur, pos
    return out
