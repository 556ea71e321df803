"""Korean left/right word splitter (LTokenizer style) for the aligner.

The port's own copy of qwen3_asr_tpu/text/korean.py: for each whitespace
word longer than two characters, the longest left part (>= 2 characters)
found in the dictionary splits the word into (left, rest). The dictionary
is the repo's `assets/korean_words.txt` (one word per line) or a
jieba-format file (`word freq tag`).
"""

from __future__ import annotations

import os

# dictionary file names accepted, in order of preference
_DICT_NAMES = ("korean_words.txt", "korean_dict_jieba.dict")

# the repo's assets directory (.../qwen3_asr_tpu_torch/../assets)
_PKG_ASSETS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "assets",
)


def find_korean_dict(model_path: str = "") -> str:
    """The dictionary's path: next to the model (its ../assets and
    assets), then ./assets, then the repo's assets; "" if none exists."""
    dirs = []
    if model_path:
        d = os.path.dirname(model_path) or "."
        dirs += [os.path.join(d, "..", "assets"), os.path.join(d, "assets")]
    dirs += ["assets", _PKG_ASSETS]
    for directory in dirs:
        for name in _DICT_NAMES:
            cand = os.path.join(directory, name)
            if os.path.isfile(cand):
                return cand
    return ""


def load_korean_dict(path: str) -> set[str]:
    """The dictionary's words: the first space-separated column of each
    non-empty line."""
    words: set[str] = set()
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            word = line.split(" ", 1)[0]
            if word:
                words.add(word)
    return words


def tokenize_korean(text: str, ko_dict: set[str]) -> list[str]:
    """Split each whitespace word into its best left part and the rest: a
    dictionary hit scores 1, a miss 0, and among equal scores the longest
    left part wins."""
    result: list[str] = []
    for word in text.split():
        chars = list(word)
        length = len(chars)
        if length <= 2:
            result.append(word)
            continue
        best_score = -1e9
        best_left_len = 0
        best_left = ""
        best_right = ""
        for e in range(2, length + 1):
            left = "".join(chars[:e])
            right = "".join(chars[e:])
            score = 1.0 if left in ko_dict else 0.0
            if score > best_score or (score == best_score and e > best_left_len):
                best_score = score
                best_left_len = e
                best_left = left
                best_right = right
        result.append(best_left)
        if best_right:
            result.append(best_right)
    return result
