"""Timestamp post-processing of the forced aligner (host side, tiny).

The port's own copy of qwen3_asr_tpu/text/timestamps.py:
- `get_feat_extract_output_lengths`: the audio_pad count (encoder output
  rows) for a mel frame count;
- `fix_timestamp_classes`: the longest-increasing-subsequence repair of the
  classes at the <ts> slots, with the reference's tie-breaking;
- `classes_to_timestamps` / `pair_words`: classes to seconds, and two
  timestamps per word paired into (start, end) clamped to the audio.
"""

from __future__ import annotations


def get_feat_extract_output_lengths(input_lengths: int) -> int:
    """audio_pad count (encoder output rows) for a mel frame count."""
    leave = input_lengths % 100
    feat = (leave - 1) // 2 + 1
    return ((feat - 1) // 2 + 1 - 1) // 2 + 1 + (input_lengths // 100) * 13


def fix_timestamp_classes(data: list[int]) -> list[int]:
    """The repaired classes: a list of ints as long as `data`, the
    contract of the JAX package's native `lis_repair`. The port runs the
    pure-Python repair (`fix_timestamp_classes_py`), which that C library
    is held equal to: a few hundred classes a request, O(n^2) host work."""
    return fix_timestamp_classes_py(data)


def fix_timestamp_classes_py(data: list[int]) -> list[int]:
    """Longest-increasing-subsequence repair, O(n^2) DP. Values on the LIS
    (the first maximal chain) are kept; runs of anomalies of length <= 2
    snap to the nearer valid neighbour (ties toward the left), longer runs
    are linearly interpolated (truncated toward zero), and a run with one
    anchor copies it."""
    n = len(data)
    if n == 0:
        return []

    dp = [1] * n
    parent = [-1] * n
    for i in range(1, n):
        for j in range(i):
            if data[j] <= data[i] and dp[j] + 1 > dp[i]:
                dp[i] = dp[j] + 1
                parent[i] = j

    max_idx = max(range(n), key=lambda i: dp[i])   # the FIRST maximal index

    is_normal = [False] * n
    idx = max_idx
    while idx != -1:
        is_normal[idx] = True
        idx = parent[idx]

    result = list(data)
    i = 0
    while i < n:
        if is_normal[i]:
            i += 1
            continue
        j = i
        while j < n and not is_normal[j]:
            j += 1
        count = j - i

        left_val = -1
        for k in range(i - 1, -1, -1):
            if is_normal[k]:
                left_val = result[k]
                break
        right_val = -1
        for k in range(j, n):
            if is_normal[k]:
                right_val = result[k]
                break

        if count <= 2:
            for k in range(i, j):
                if left_val < 0:
                    result[k] = right_val
                elif right_val < 0:
                    result[k] = left_val
                else:
                    # distance to the left anchor (i-1) vs the right one (j)
                    result[k] = left_val if (k - (i - 1)) <= (j - k) else right_val
        else:
            if left_val >= 0 and right_val >= 0:
                step = (right_val - left_val) / (count + 1)
                for k in range(i, j):
                    result[k] = int(left_val + step * (k - i + 1))
            elif left_val >= 0:
                for k in range(i, j):
                    result[k] = left_val
            elif right_val >= 0:
                for k in range(i, j):
                    result[k] = right_val
        i = j

    return result


def classes_to_timestamps(classes: list[int], segment_time_ms: int = 80) -> list[float]:
    seg = segment_time_ms / 1000.0
    return [c * seg for c in classes]


def pair_words(words: list[str], timestamps: list[float],
               audio_duration: float) -> list[dict]:
    """Two timestamps per word: ts[2i] = start, ts[2i+1] = end, clamped to
    the duration; a missing start is 0.0 and a missing end the duration."""
    ts = [min(t, audio_duration) for t in timestamps]
    out = []
    for i, word in enumerate(words):
        start = ts[2 * i] if 2 * i < len(ts) else 0.0
        end = ts[2 * i + 1] if 2 * i + 1 < len(ts) else audio_duration
        out.append({"word": word, "start": start, "end": end})
    return out
