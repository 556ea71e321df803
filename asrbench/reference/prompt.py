"""Prompts and shapes of the two models, worked out from the configuration
file: the encoder's output rows for a mel frame count, the ASR chat prompt,
the aligner's prompt of byte-vocabulary words, each followed by two
timestamp slots."""

from __future__ import annotations

CHUNK = 100   # mel frames per conv chunk (n_window * 2)


def conv_rows(frames: int) -> int:
    """Rows the three stride-2 convs leave of `frames` frames."""
    for _ in range(3):
        frames = (frames - 1) // 2 + 1
    return frames


def audio_rows(n_frames: int) -> int:
    """Encoder output rows of an utterance of n_frames mel frames: each
    100-frame chunk gives conv_rows(100) = 13, the tail chunk its own."""
    n_chunks = -(-n_frames // CHUNK)
    return conv_rows(CHUNK) * (n_chunks - 1) + conv_rows(n_frames - (n_chunks - 1) * CHUNK)


def asr_prompt(cfg: dict, n_audio: int) -> tuple[list[int], int]:
    """<|im_start|>system\\n<|im_end|>\\n<|im_start|>user\\n<|audio_start|>
    <|audio_pad|> x n_audio <|audio_end|><|im_end|>\\n<|im_start|>assistant\\n
    -> (the tokens, the row of the first audio_pad)."""
    t = cfg["tokens"]
    head = [t["im_start"], t["system"], t["newline"], t["im_end"], t["newline"],
            t["im_start"], t["user"], t["newline"], t["audio_start"]]
    tail = [t["audio_end"], t["im_end"], t["newline"], t["im_start"],
            t["assistant"], t["newline"]]
    return head + [t["audio_pad"]] * n_audio + tail, len(head)


def word_tokens(word: str) -> list[int]:
    """A word's ids in the byte vocabulary: its UTF-8 bytes."""
    return list(word.encode("utf-8"))


def align_prompt(cfg: dict, n_audio: int, words: list[str]) -> tuple[list[int], int]:
    """<audio_start><audio_pad> x n_audio<audio_end>, then each word's bytes
    and two <ts> slots -> (the tokens, the row of the first audio_pad)."""
    t = cfg["tokens"]
    toks = [t["audio_start"]] + [t["audio_pad"]] * n_audio + [t["audio_end"]]
    for w in words:
        toks += word_tokens(w) + [t["timestamp"], t["timestamp"]]
    return toks, 1


def align_words(n_words: int) -> list[str]:
    """The synthetic transcript of an alignment: word000, word001, ..."""
    return [f"word{i:03d}" for i in range(n_words)]
