"""Prompt construction and ASR-output post-processing.

The port's own copy of the parts of qwen3_asr_tpu/text/prompt.py that it
calls: the ASR chat template, the audio offset, and the transcript's
'language Xxx' prefix handling (whole and streamed).
"""

from __future__ import annotations

from qwen3_asr_tpu_torch.config import DecoderConfig


def build_asr_prompt(
    n_audio_frames: int,
    cfg: DecoderConfig,
    system_prompt_tokens: list[int] | None = None,
) -> list[int]:
    """<|im_start|>system\\n{sys}<|im_end|>\\n<|im_start|>user\\n
    <|audio_start|><|audio_pad|>*N<|audio_end|><|im_end|>\\n
    <|im_start|>assistant\\n"""
    toks = [cfg.im_start_token_id, cfg.system_token_id, cfg.newline_token_id]
    if system_prompt_tokens:
        toks.extend(system_prompt_tokens)
    toks += [cfg.im_end_token_id, cfg.newline_token_id,
             cfg.im_start_token_id, cfg.user_token_id, cfg.newline_token_id]
    toks.append(cfg.audio_start_token_id)
    toks.extend([cfg.audio_pad_token_id] * n_audio_frames)
    toks.append(cfg.audio_end_token_id)
    toks += [cfg.im_end_token_id, cfg.newline_token_id,
             cfg.im_start_token_id, cfg.assistant_token_id,
             cfg.newline_token_id]
    return toks


def audio_start_pos(tokens: list[int], cfg: DecoderConfig) -> int:
    """Position of the first audio_pad token (-1 if there is none)."""
    for i, t in enumerate(tokens):
        if t == cfg.audio_pad_token_id:
            return i
    return -1


def detect_language(asr_text: str) -> str:
    """Parse a leading 'language Xxx' prefix."""
    prefix = "language "
    if not asr_text.startswith(prefix) or len(asr_text) <= len(prefix):
        return ""
    pos = len(prefix)
    first = asr_text[pos]
    if not ("A" <= first <= "Z"):
        return ""
    pos += 1
    while pos < len(asr_text) and "a" <= asr_text[pos] <= "z":
        pos += 1
    return asr_text[len(prefix) : pos].lower()


def extract_transcript(asr_text: str) -> str:
    """Strip the 'language Xxx' prefix plus following ASCII whitespace."""
    prefix = "language "
    if not asr_text.startswith(prefix):
        return asr_text
    pos = len(prefix)
    if pos >= len(asr_text):
        return ""
    if not ("A" <= asr_text[pos] <= "Z"):
        return asr_text
    pos += 1
    while pos < len(asr_text) and "a" <= asr_text[pos] <= "z":
        pos += 1
    while pos < len(asr_text):
        c = asr_text[pos]
        if ord(c) >= 0x80 or not c.isspace():
            break
        pos += 1
    return asr_text[pos:]


def _prefix_split(s: str, final: bool) -> tuple[bool, int]:
    """Incremental form of `extract_transcript`'s prefix scan: given the
    text streamed so far, return (resolved, strip_len). resolved=False
    means more input could still extend the 'language Xxx' prefix, so the
    caller must keep buffering; `final=True` forces resolution at stream
    end (the whole buffer may BE the prefix)."""
    prefix = "language "
    if not s.startswith(prefix[: len(s)]):
        return True, 0  # diverged: nothing to strip
    if len(s) <= len(prefix):
        if final:
            # exactly 'language ' strips to empty (extract_transcript's
            # pos>=len case); any shorter partial is returned unchanged
            return True, len(s) if s == prefix else 0
        return False, 0  # could still grow into the prefix
    pos = len(prefix)
    if not ("A" <= s[pos] <= "Z"):
        return True, 0
    pos += 1
    while pos < len(s) and "a" <= s[pos] <= "z":
        pos += 1
    if pos == len(s):
        return final, pos if final else 0
    while pos < len(s):
        c = s[pos]
        if ord(c) >= 0x80 or not c.isspace():
            return True, pos  # first real transcript char seen
        pos += 1
    return final, pos if final else 0  # trailing whitespace may continue


class StreamingTranscriptCleaner:
    """Strip the leading 'language Xxx' prefix from incrementally streamed
    ASR text (SSE serving): feed() returns the cleaned text ready to emit
    (empty while the prefix is still ambiguous), flush() settles the
    buffer at stream end. The concatenation of all returns equals
    `extract_transcript` of the concatenated input, for every chunking."""

    def __init__(self):
        self._buf = ""
        self._resolved = False

    def feed(self, piece: str) -> str:
        if self._resolved:
            return piece
        self._buf += piece
        resolved, strip = _prefix_split(self._buf, final=False)
        if resolved:
            self._resolved = True
            return self._buf[strip:]
        return ""

    def flush(self) -> str:
        if self._resolved:
            return ""
        resolved, strip = _prefix_split(self._buf, final=True)
        self._resolved = True
        return self._buf[strip:]
