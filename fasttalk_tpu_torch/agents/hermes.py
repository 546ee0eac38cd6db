"""Streaming parser for hermes-style tool-call markup.

The reference outsourced tool-call parsing to vLLM's server flag
(--tool-call-parser hermes, docker-compose.vllm.yml:50-51) and let
PydanticAI drive the loop (SURVEY.md §3.4). This framework owns the
decode stream, so it parses the markup itself:

    <tool_call>{"name": "get_weather", "arguments": {"city": "Oslo"}}</tool_call>

The parser is incremental: feed it text deltas as they stream; it
returns the user-visible text (with tool-call markup suppressed) and any
completed tool calls. A partial opening tag at the end of a delta is
held back until it can be disambiguated.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

OPEN_TAG = "<tool_call>"
CLOSE_TAG = "</tool_call>"


@dataclass
class ToolCall:
    name: str
    arguments: dict
    raw: str


class HermesStreamParser:
    def __init__(self) -> None:
        self._buf = ""
        self._in_call = False

    def feed(self, delta: str) -> tuple[str, list[ToolCall]]:
        """Consume a text delta; return (emittable_text, completed_calls)."""
        pre, calls, post = self.feed_split(delta)
        return pre + post, calls

    def feed_split(self, delta: str,
                   ) -> tuple[str, list[ToolCall], str]:
        """Consume a text delta; return ``(pre, completed_calls, post)``
        where ``pre`` is the text that streamed BEFORE the first call
        completed in this feed and ``post`` the text after it. When no
        call completes, everything is ``pre``. Callers that suppress
        text once a call exists (the agent loop) need the split —
        chunk boundaries are arbitrary, so prose preceding a call can
        arrive in the very chunk that completes it (ADVICE r4)."""
        self._buf += delta
        pre: list[str] = []
        post: list[str] = []
        calls: list[ToolCall] = []
        while True:
            out = post if calls else pre
            if self._in_call:
                end = self._buf.find(CLOSE_TAG)
                if end < 0:
                    return "".join(pre), calls, "".join(post)
                raw = self._buf[:end]
                self._buf = self._buf[end + len(CLOSE_TAG):]
                self._in_call = False
                calls.append(self._parse(raw))
            else:
                start = self._buf.find(OPEN_TAG)
                if start >= 0:
                    out.append(self._buf[:start])
                    self._buf = self._buf[start + len(OPEN_TAG):]
                    self._in_call = True
                    continue
                # Hold back any suffix that is a prefix of the open tag.
                hold = 0
                for k in range(min(len(OPEN_TAG) - 1, len(self._buf)), 0, -1):
                    if self._buf.endswith(OPEN_TAG[:k]):
                        hold = k
                        break
                cut = len(self._buf) - hold
                out.append(self._buf[:cut])
                self._buf = self._buf[cut:]
                return "".join(pre), calls, "".join(post)

    def flush(self) -> str:
        """End of stream: release held-back text. An unterminated tool
        call body is dropped (it never completed) — and so is a held
        partial OPENING tag of two or more characters ("<tool_cal" at
        a max_tokens cutoff): the in-stream path holds such a suffix
        back waiting for the rest of the tag, and releasing it here
        leaked raw markup into user-visible text whenever the stream
        ended mid-tag. A lone trailing "<" is still released —
        legitimate prose ends with it far more often than a tag
        starts one character before the end of a stream."""
        if self._in_call:
            text = ""
        else:
            text = self._buf
            for k in range(min(len(OPEN_TAG) - 1, len(text)), 1, -1):
                if text.endswith(OPEN_TAG[:k]):
                    text = text[:-k]
                    break
        self._buf = ""
        self._in_call = False
        return text

    @staticmethod
    def _parse(raw: str) -> ToolCall:
        try:
            obj = json.loads(raw.strip())
            name = obj.get("name", "")
            args = obj.get("arguments", {})
            if isinstance(args, str):  # some models emit stringified args
                args = json.loads(args) if args else {}
            if not isinstance(args, dict):
                args = {"value": args}
            return ToolCall(name=name, arguments=args, raw=raw)
        except (json.JSONDecodeError, AttributeError):
            return ToolCall(name="", arguments={}, raw=raw)


def format_tool_result(name: str, result: str) -> str:
    """Result message body in hermes convention."""
    return f"<tool_response>\n{json.dumps({'name': name, 'content': result})}\n</tool_response>"


def inject_tools_section(messages: list[dict], section: str) -> list[dict]:
    """Merge a tools section into the conversation's system prompt
    (append to an existing leading system message, else insert one).
    Shared by the agent loop and the OpenAI route so the placement rule
    can't drift between them."""
    msgs = [dict(m) for m in messages]
    if msgs and msgs[0].get("role") == "system":
        msgs[0]["content"] = msgs[0]["content"] + "\n\n" + section
    else:
        msgs.insert(0, {"role": "system", "content": section})
    return msgs


def tools_system_prompt(tool_specs: list[dict]) -> str:
    """System-prompt section teaching the model the hermes call format."""
    lines = [
        "You have access to the following tools. To call a tool, emit "
        "exactly:",
        '<tool_call>{"name": "<tool_name>", "arguments": {...}}</tool_call>',
        "Tool results arrive in <tool_response> messages. "
        "Use tools only when needed, then answer the user.",
        "Available tools:",
    ]
    for spec in tool_specs:
        lines.append(json.dumps(spec))
    return "\n".join(lines)
