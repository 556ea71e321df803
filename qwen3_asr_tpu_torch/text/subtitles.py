"""Subtitles (SubRip / WebVTT) from word-level alignments.

The port's own copy of qwen3_asr_tpu/text/subtitles.py. Words (`.word`,
`.start`, `.end` in seconds, or dicts or 3-tuples of them) are grouped into
cues greedily: a cue closes before a word that would take its line past
`max_chars`, its span past `max_duration` seconds, or that follows a
silence longer than `max_gap`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Cue:
    start: float
    end: float
    text: str


def _as_triples(words) -> list[tuple[str, float, float]]:
    out = []
    for w in words:
        if isinstance(w, dict):
            out.append((w["word"], float(w["start"]), float(w["end"])))
        elif isinstance(w, (tuple, list)):
            out.append((str(w[0]), float(w[1]), float(w[2])))
        else:
            out.append((w.word, float(w.start), float(w.end)))
    return out


def group_words_into_cues(words, max_chars: int = 42, max_duration: float = 5.0,
                          max_gap: float = 1.0) -> list[Cue]:
    """Greedy cues; a zero-length cue gets a 10 ms floor so players show
    it."""
    cues: list[Cue] = []
    cur: list[tuple[str, float, float]] = []

    def flush():
        if not cur:
            return
        start = cur[0][1]
        end = max(cur[-1][2], start + 0.01)
        cues.append(Cue(start, end, " ".join(w for w, _, _ in cur)))
        cur.clear()

    for word, start, end in _as_triples(words):
        if cur:
            text_len = len(" ".join(w for w, _, _ in cur)) + 1 + len(word)
            gap = start - cur[-1][2]
            if (text_len > max_chars or end - cur[0][1] > max_duration
                    or gap > max_gap):
                flush()
        cur.append((word, start, end))
    flush()
    return cues


def _timecode(seconds: float, sep: str) -> str:
    if seconds < 0:
        seconds = 0.0
    ms = int(round(seconds * 1000))
    h, rem = divmod(ms, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{h:02d}:{m:02d}:{s:02d}{sep}{ms:03d}"


def words_to_srt(words, **cue_opts) -> str:
    """SubRip: 1-indexed cues, `HH:MM:SS,mmm --> HH:MM:SS,mmm`."""
    lines = []
    for i, cue in enumerate(group_words_into_cues(words, **cue_opts), 1):
        lines.append(str(i))
        lines.append(f"{_timecode(cue.start, ',')} --> {_timecode(cue.end, ',')}")
        lines.append(cue.text)
        lines.append("")
    return "\n".join(lines)


def words_to_vtt(words, **cue_opts) -> str:
    """WebVTT: a `WEBVTT` header, `HH:MM:SS.mmm --> HH:MM:SS.mmm`."""
    lines = ["WEBVTT", ""]
    for cue in group_words_into_cues(words, **cue_opts):
        lines.append(f"{_timecode(cue.start, '.')} --> {_timecode(cue.end, '.')}")
        lines.append(cue.text)
        lines.append("")
    return "\n".join(lines)
