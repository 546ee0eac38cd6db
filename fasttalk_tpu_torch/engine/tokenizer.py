"""Tokenization: HF fast tokenizer when checkpoint files exist, byte-level
fallback otherwise, plus the Llama-3 chat template and incremental
detokenization for streaming.

The reference never tokenized — its external engines did, and its "token"
counts were actually stream-chunk counts (SURVEY.md §5 metrics gap). Here
the framework owns the tokenizer, so streamed deltas and counters are real
tokens.
"""

from __future__ import annotations

import os
from typing import Protocol, Sequence

Message = dict[str, str]  # {"role": ..., "content": ...}


class Tokenizer(Protocol):
    vocab_size: int
    eos_ids: frozenset[int]
    pad_id: int

    def encode(self, text: str) -> list[int]: ...

    def encode_prompt(self, text: str) -> list[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def apply_chat_template(self, messages: Sequence[Message],
                            add_generation_prompt: bool = True) -> list[int]: ...


class ByteTokenizer:
    """Self-contained byte-level tokenizer (no files, no network).

    ids 0..255 = raw bytes; specials above. Role headers are single
    tokens so the chat template stays cheap and unambiguous. Used for
    tests and for weight-free benchmarking; real checkpoints bring their
    own tokenizer.json.
    """

    BOS = 256
    EOS = 257
    ROLE_SYSTEM = 258
    ROLE_USER = 259
    ROLE_ASSISTANT = 260
    ROLE_TOOL = 261
    pad_id = 262
    vocab_size = 263

    def __init__(self) -> None:
        self.eos_ids = frozenset({self.EOS})
        self._role_tokens = {
            "system": self.ROLE_SYSTEM,
            "user": self.ROLE_USER,
            "assistant": self.ROLE_ASSISTANT,
            "tool": self.ROLE_TOOL,
        }

    def encode(self, text: str) -> list[int]:
        return list(text.encode("utf-8"))

    def encode_prompt(self, text: str) -> list[int]:
        """Raw completion prompt: BOS + verbatim tokens (no template)."""
        return [self.BOS] + self.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        """Bytes decode to text; specials decode to nothing; ids beyond
        this tokenizer's vocab (possible when the model's vocab is larger,
        e.g. weight-free benchmarking of a 128k-vocab model over the byte
        fallback) decode to a private-use-area glyph instead of vanishing,
        so streaming still carries one visible delta per token."""
        out: list[str] = []
        byte_run: list[int] = []
        for i in ids:
            if i < 256:
                byte_run.append(i)
                continue
            if byte_run:
                out.append(bytes(byte_run).decode("utf-8", errors="replace"))
                byte_run = []
            if i >= self.vocab_size:
                out.append(chr(0xE000 + i % 6400))
        if byte_run:
            out.append(bytes(byte_run).decode("utf-8", errors="replace"))
        return "".join(out)

    def apply_chat_template(self, messages: Sequence[Message],
                            add_generation_prompt: bool = True) -> list[int]:
        out = [self.BOS]
        for m in messages:
            out.append(self._role_tokens.get(m.get("role", "user"), self.ROLE_USER))
            out.extend(self.encode(m.get("content", "")))
            out.append(self.EOS)
        if add_generation_prompt:
            out.append(self.ROLE_ASSISTANT)
        return out


def render_llama3(messages: Sequence[Message],
                  add_generation_prompt: bool = True) -> str:
    """Llama-3 instruct template (checkpoint-defined, stable across 3.x)."""
    def header(role: str) -> str:
        return f"<|start_header_id|>{role}<|end_header_id|>\n\n"

    text = "<|begin_of_text|>"
    for m in messages:
        text += header(m.get("role", "user"))
        text += m.get("content", "") + "<|eot_id|>"
    if add_generation_prompt:
        text += header("assistant")
    return text


def render_chatml(messages: Sequence[Message],
                  add_generation_prompt: bool = True) -> str:
    """ChatML template (Qwen 2.x instruct)."""
    text = ""
    for m in messages:
        role = m.get("role", "user")
        text += f"<|im_start|>{role}\n{m.get('content', '')}<|im_end|>\n"
    if add_generation_prompt:
        text += "<|im_start|>assistant\n"
    return text


def render_mistral(messages: Sequence[Message],
                   add_generation_prompt: bool = True) -> str:
    """Mistral instruct template: [INST] turns; the format has no system
    role, so a system message is prepended to the LAST user turn —
    matching mistral-common / the HF chat template for Instruct-v0.3
    (folding into the first turn deviates from the checkpoint's trained
    format on multi-turn prompts)."""
    sys_parts: list[str] = []
    last_user = -1
    for i, m in enumerate(messages):
        if m.get("role", "user") == "system":
            sys_parts.append(m.get("content", ""))
        elif m.get("role", "user") == "user":
            last_user = i
    system = "\n\n".join(p for p in sys_parts if p)
    text = "<s>"
    for i, m in enumerate(messages):
        role, content = m.get("role", "user"), m.get("content", "")
        if role == "system":
            continue
        if role == "user":
            if system and i == last_user:
                content = f"{system}\n\n{content}"
            text += f"[INST] {content} [/INST]"
        else:  # assistant / tool result turns close with </s>
            text += f" {content}</s>"
    if system and last_user < 0:
        # System message with no user turn (e.g. lone system prompt):
        # still surface it rather than dropping it silently.
        text += f"[INST] {system} [/INST]"
    return text


_TEMPLATES = {"llama3": render_llama3, "chatml": render_chatml,
              "mistral": render_mistral}
# BOS text per template family, for raw (untemplated) completion
# prompts — vLLM's /v1/completions prepends BOS by default, so parity
# requires it here (ChatML models have no BOS).
_BOS_TEXT = {"llama3": "<|begin_of_text|>", "chatml": "",
             "mistral": "<s>"}


class HFTokenizer:
    """Wraps a HuggingFace fast tokenizer (tokenizer.json).

    Chat rendering prefers the CHECKPOINT'S OWN template
    (tokenizer_config.json ``chat_template`` / chat_template.jinja,
    rendered by engine/chat_template.py exactly as HF/vLLM render it) —
    so a new instruct checkpoint serves its trained format with zero
    code edits, matching what the reference got from its engines
    (docker-compose.vllm.yml:38-53). Checkpoints that ship no template
    fall back to the in-tree family renderer named by
    models/configs.py."""

    def __init__(self, tokenizer_file: str, template: str = "llama3",
                 ckpt_template: Any = None):
        from tokenizers import Tokenizer as RustTokenizer

        self._tok = RustTokenizer.from_file(tokenizer_file)
        self._ckpt_template = ckpt_template
        self._render = _TEMPLATES.get(template, render_llama3)
        # Fallback mirrors the template fallback: an unknown template
        # name renders llama3, so its raw prompts must get llama3's BOS.
        self._bos_text = _BOS_TEXT.get(template, _BOS_TEXT["llama3"])
        if ckpt_template is not None and \
                ckpt_template.special_tokens.get("bos_token"):
            self._bos_text = ckpt_template.special_tokens["bos_token"]
        self.vocab_size = self._tok.get_vocab_size()
        eos = set()
        eos_names = ["<|eot_id|>", "<|end_of_text|>", "</s>", "<|eom_id|>",
                     "<|im_end|>", "<|endoftext|>"]
        if ckpt_template is not None and \
                ckpt_template.special_tokens.get("eos_token"):
            # The checkpoint's declared EOS, whatever it is named.
            eos_names.append(ckpt_template.special_tokens["eos_token"])
        for name in eos_names:
            tid = self._tok.token_to_id(name)
            if tid is not None:
                eos.add(tid)
        self.eos_ids = frozenset(eos) or frozenset({self.vocab_size - 1})
        pad = self._tok.token_to_id("<|finetune_right_pad_id|>")
        self.pad_id = pad if pad is not None else 0

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def encode_prompt(self, text: str) -> list[int]:
        """Raw completion prompt: template-family BOS + verbatim tokens
        (the same textual-special-token path the chat templates use)."""
        return self.encode(self._bos_text + text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: Sequence[Message],
                            add_generation_prompt: bool = True) -> list[int]:
        if self._ckpt_template is not None:
            try:
                text = self._ckpt_template.render(
                    messages, add_generation_prompt=add_generation_prompt)
            except Exception:
                # Render-time failure (e.g. a strict-alternation template
                # hitting the agent's role-"tool" turns, where stock
                # templates call raise_exception): fall back to the
                # family renderer — one failed render must not error
                # every request and trip the breaker.
                import logging

                logging.getLogger("fasttalk.engine.tokenizer").warning(
                    "checkpoint chat template failed to render; using "
                    "the %s family fallback", self._render.__name__,
                    exc_info=True)
                text = self._render(messages, add_generation_prompt)
        else:
            text = self._render(messages, add_generation_prompt)
        return self._tok.encode(text, add_special_tokens=False).ids


class StreamDetokenizer:
    """Incremental detokenization for one stream.

    Emits only complete, stable UTF-8 text, holding back while the
    decoded tail ends in a replacement char (split multi-byte/multi-token
    glyph). Decodes only the ids since the last stable emit — per-token
    cost is O(window), not O(tokens generated so far); the naive
    decode-everything-each-push is quadratic per request and becomes a
    real host-side cost at >1k streamed tok/s.
    """

    # A legal UTF-8 glyph spans at most 4 bytes / a few tokens; past that,
    # a trailing replacement char is genuinely invalid output and must be
    # emitted rather than held back forever.
    MAX_HOLDBACK_TOKENS = 4
    # Stable ids kept as decode context so tokenizers whose decoders are
    # position-sensitive (e.g. Metaspace stripping the leading space at
    # sequence start) join window text exactly as a full decode would.
    PREFIX_CONTEXT = 4

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._prefix: list[int] = []   # stable context ids
        self._window: list[int] = []   # ids not yet emitted as stable text
        self._emitted_text: list[str] = []
        self._count = 0

    def _pending(self) -> tuple[str, str]:
        """(decoded context, decoded context+window)."""
        prev = self._tok.decode(self._prefix) if self._prefix else ""
        full = self._tok.decode(self._prefix + self._window)
        return prev, full

    def push(self, token_id: int) -> str:
        self._window.append(token_id)
        self._count += 1
        prev, full = self._pending()
        if full.endswith("�") and \
                len(self._window) <= self.MAX_HOLDBACK_TOKENS:
            return ""
        delta = full[len(prev):] if len(full) > len(prev) else ""
        self._prefix = (self._prefix + self._window)[-self.PREFIX_CONTEXT:]
        self._window.clear()
        if delta:
            self._emitted_text.append(delta)
        return delta

    def flush(self) -> str:
        prev, full = self._pending()
        delta = full[len(prev):] if len(full) > len(prev) else ""
        self._prefix = (self._prefix + self._window)[-self.PREFIX_CONTEXT:]
        self._window.clear()
        if delta:
            self._emitted_text.append(delta)
        return delta

    @property
    def text(self) -> str:
        prev, full = self._pending()
        pending = full[len(prev):] if len(full) > len(prev) else ""
        return "".join(self._emitted_text) + pending

    @property
    def token_count(self) -> int:
        return self._count


def find_tokenizer_file(model_path: str, model_name: str) -> str | None:
    from fasttalk_tpu_torch.models.loader import find_checkpoint_dir

    candidates = []
    ckpt = find_checkpoint_dir(model_path, model_name) if model_path else None
    if ckpt:
        candidates.append(os.path.join(ckpt, "tokenizer.json"))
    if model_path:
        candidates.append(os.path.join(model_path, "tokenizer.json"))
    for c in candidates:
        if os.path.isfile(c):
            return c
    return None


def load_tokenizer(model_path: str, model_name: str,
                   tokenizer_path: str = "",
                   template: str = "llama3") -> Tokenizer:
    """HF tokenizer if files are present, else the byte fallback.

    When the checkpoint directory ships its own chat template
    (tokenizer_config.json / chat_template.jinja), that template wins
    over the ``template`` family name (engine/chat_template.py)."""
    tf = tokenizer_path if tokenizer_path and os.path.isfile(tokenizer_path) \
        else find_tokenizer_file(model_path, model_name)
    if tf:
        from fasttalk_tpu_torch.engine.chat_template import load_chat_template

        return HFTokenizer(tf, template=template,
                           ckpt_template=load_chat_template(
                               os.path.dirname(os.path.abspath(tf))))
    return ByteTokenizer()
