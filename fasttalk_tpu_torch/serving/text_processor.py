"""Sentence-boundary text chunking for TTS pipelines.

The port's own copy of ``fasttalk_tpu/serving/text_processor.py`` (the
port imports nothing of the JAX package): find the shortest sentence-like
prefix of a streaming buffer that is safe to hand to a TTS engine. The
WebSocket server uses it behind the session config flag ``tts_chunking``
so voice clients can opt in.
"""

from __future__ import annotations

SPLIT_CHARS = ".!?,;:\n-。、"


def extract_speakable_chunk(buffer: str, min_chars: int = 12,
                            min_alnum: int = 4) -> tuple[str, str]:
    """Split ``buffer`` into (speakable_prefix, remainder).

    The prefix ends at the earliest split character such that the prefix
    is at least ``min_chars`` long and contains at least ``min_alnum``
    alphanumeric characters; ("", buffer) if no such point exists yet.
    """
    alnum = 0
    for i, ch in enumerate(buffer):
        if ch.isalnum():
            alnum += 1
        if ch in SPLIT_CHARS and i + 1 >= min_chars and alnum >= min_alnum:
            return buffer[:i + 1], buffer[i + 1:]
    return "", buffer

