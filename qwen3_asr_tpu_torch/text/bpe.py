"""Byte-level BPE tokenizer (GPT-2 style), host-side string processing.

The port's own copy of qwen3_asr_tpu/text/bpe.py, pure Python (the JAX
package's optional native encoder is not used):
- encode: whitespace pre-split, space prefix on non-first words, greedy
  lowest-rank pairwise merges;
- decode: GPT-2 byte<->unicode tables, skipping `<|...|>` control tokens and
  `[PAD...]` fillers.

Vocab and merges come from GGUF metadata (`tokenizer.ggml.tokens` /
`tokenizer.ggml.merges`).
"""

from __future__ import annotations

import functools


@functools.cache
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2 bytes_to_unicode: printable bytes map to themselves, the rest
    to codepoints 256+n."""
    bs = (
        list(range(0x21, 0x7F))
        + list(range(0xA1, 0xAD))
        + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.cache
def _unicode_to_byte() -> dict[str, int]:
    return {c: b for b, c in _byte_to_unicode().items()}


def bytes_to_bpe_string(raw: bytes) -> str:
    table = _byte_to_unicode()
    return "".join(table[b] for b in raw)


def bpe_string_to_bytes(s: str) -> bytes:
    """Inverse map; unknown codepoints pass through as UTF-8."""
    table = _unicode_to_byte()
    out = bytearray()
    for ch in s:
        b = table.get(ch)
        if b is not None:
            out.append(b)
        else:
            out.extend(ch.encode("utf-8"))
    return bytes(out)


class BPETokenizer:
    def __init__(self, vocab: list[str], merges: list[str]):
        self.vocab = vocab
        self.token_to_id = {t: i for i, t in enumerate(vocab)}
        # rank by position in the merges list
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}

    # -- encoding ----------------------------------------------------------

    def _encode_word(self, word_bpe: str) -> list[str]:
        """Greedy lowest-rank merge loop."""
        symbols = list(word_bpe)
        if len(symbols) <= 1:
            return symbols
        ranks = self.bpe_ranks
        while len(symbols) > 1:
            best_rank = None
            best_pos = -1
            for i in range(len(symbols) - 1):
                r = ranks.get(symbols[i] + " " + symbols[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_pos = i
            if best_rank is None:
                break
            symbols[best_pos : best_pos + 2] = [
                symbols[best_pos] + symbols[best_pos + 1]
            ]
        return symbols

    def encode_piece(self, text: str) -> list[int]:
        """BPE-encode one piece (no whitespace pre-splitting)."""
        bpe_str = bytes_to_bpe_string(text.encode("utf-8"))
        ids = []
        for sw in self._encode_word(bpe_str):
            tid = self.token_to_id.get(sw)
            if tid is not None:
                ids.append(tid)
        return ids

    def encode(self, text: str) -> list[int]:
        """Whitespace pre-split + space prefix on non-first words."""
        ids: list[int] = []
        first = True
        for word in text.split():
            piece = word if first else " " + word
            first = False
            ids.extend(self.encode_piece(piece))
        return ids

    # -- decoding ----------------------------------------------------------

    def decode_token(self, token_id: int) -> bytes:
        if token_id < 0 or token_id >= len(self.vocab):
            return b""
        tok = self.vocab[token_id]
        # skip special tokens <|...|> and [PAD...]
        if len(tok) >= 4 and tok.startswith("<|") and tok.endswith("|>"):
            return b""
        if tok.startswith("[PAD"):
            return b""
        return bpe_string_to_bytes(tok)

    def decode(self, token_ids: list[int]) -> str:
        raw = b"".join(self.decode_token(t) for t in token_ids)
        return raw.decode("utf-8", errors="replace")
