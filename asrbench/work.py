"""The yardstick's arithmetic: operations and bytes of the two models'
requests and of one decode step (the `qwen3_asr` family's work count,
`asrbench/families/qwen3_asr.py`), counted from the configuration's shapes
whatever format or kernel runs them, and the H100's published peaks,
which every family's count is held against.

Operations are 2 x multiply-adds. A request of Qwen3-ASR counts the conv
stem (every 100-frame chunk, the tail one padded), the audio encoder, the
prefill over the prompt, the lm head on its last row, and max_tokens - 1
decode steps (the first token comes from the prefill), each with the lm
head. An alignment counts the conv stem, the windowed encoder, one causal
pass over its real prompt rows and the classify head on each of them.
The log-mel's few MFLOP are left out.

A decode step's bytes are its weights and their per-channel scales read
once (int8: a byte a weight, a float32 scale an output channel, the lm
head's too), and each row's live cache: the rows before its position and
the fresh row it writes, K and V in every layer.
"""

from __future__ import annotations

from asrbench.reference.mel import n_mel_frames
from asrbench.reference.prompt import CHUNK, align_prompt, align_words, asr_prompt, audio_rows, conv_rows

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W).
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
SAMPLE_RATE = 16000


def bound(nbytes: float, ops: float, peak: float) -> float:
    """The least seconds the card could take: the larger of the bytes over
    HBM_BPS and the operations over `peak`."""
    return max(nbytes / HBM_BPS, ops / peak)


def decoder_layer_weights(cfg: dict) -> int:
    """Weights of the decoder's layer matrices, all layers."""
    t = cfg["text"]
    h, qd = t["hidden_size"], t["attention_heads"] * t["head_dim"]
    kvd = t["num_key_value_heads"] * t["head_dim"]
    per = h * (qd + 2 * kvd) + qd * h + 3 * h * t["intermediate_size"]
    return t["decoder_layers"] * per


def decoder_layer_channels(cfg: dict) -> int:
    """Output channels of the decoder's layer matrices, all layers (a
    per-channel scale each)."""
    t = cfg["text"]
    h, qd = t["hidden_size"], t["attention_heads"] * t["head_dim"]
    kvd = t["num_key_value_heads"] * t["head_dim"]
    return t["decoder_layers"] * (qd + 2 * kvd + h + 2 * t["intermediate_size"] + h)


def head_weights(cfg: dict) -> int:
    return cfg["text"]["hidden_size"] * cfg["vocab_size"]


def cache_row_bytes(cfg: dict, kv: str) -> int:
    """Bytes of one position's K and V rows in every layer: bf16 values, or
    int8 codes with a float32 scale per (row, head)."""
    t = cfg["text"]
    nkv, hd, L = t["num_key_value_heads"], t["head_dim"], t["decoder_layers"]
    per = {"bf16": 2 * nkv * hd * 2, "int8": 2 * nkv * hd + 2 * nkv * 4}[kv]
    return L * per


def attention_macs(cfg: dict, keys: int) -> int:
    """Multiply-adds of one query row against `keys` cached rows, all
    layers: QK and PV."""
    t = cfg["text"]
    return t["decoder_layers"] * 2 * keys * t["attention_heads"] * t["head_dim"]


def step_work(cfg: dict, positions: list[int], kv: str) -> tuple[float, float]:
    """(bytes, operations) of one decode step of rows at `positions`, int8
    weights: the weights and scales once, each row's live cache and fresh
    row, 2 operations a weight a row, the attention over pos + 1 rows."""
    w = decoder_layer_weights(cfg) + head_weights(cfg)
    scales = 4 * (decoder_layer_channels(cfg) + cfg["vocab_size"])
    row = cache_row_bytes(cfg, kv)
    nbytes = w + scales + sum((p + 1) * row for p in positions)
    ops = 2.0 * w * len(positions) + sum(2.0 * attention_macs(cfg, p + 1) for p in positions)
    return nbytes, ops


def encoder_macs(cfg: dict, n_frames: int) -> int:
    """The conv stem over every chunk, the layers over the audio rows
    (full or windowed attention), proj1 and proj2."""
    a = cfg["audio"]
    c, d, f = a["conv_channels"], a["d_model"], a["ffn_dim"]
    n_chunks = -(-n_frames // CHUNK)
    h1, w1 = (a["num_mel_bins"] + 1) // 2, (CHUNK + 1) // 2   # 3x3, stride 2, pad 1
    h2, w2 = (h1 + 1) // 2, (w1 + 1) // 2
    h3, w3 = (h2 + 1) // 2, conv_rows(CHUNK)
    conv = 9 * c * (h1 * w1 + c * h2 * w2 + c * h3 * w3) + w3 * (c * h3) * d
    T = audio_rows(n_frames)
    window = a["attention_window_rows"]
    if window:
        full, tail = divmod(T, window)
        keys = full * window * window + tail * tail
    else:
        keys = T * T
    layer = 4 * T * d * d + 2 * T * d * f + 2 * keys * d
    post = T * d * d + T * d * a["output_dim"]
    return n_chunks * conv + a["encoder_layers"] * layer + post


def prompt_macs(cfg: dict, rows: int) -> int:
    """One causal pass over `rows` prompt rows: the layer matrices and the
    attention of row t over rows 0..t."""
    return rows * decoder_layer_weights(cfg) + attention_macs(cfg, 1) * rows * (rows + 1) // 2


def asr_request(cfg: dict, n_samples: int, max_tokens: int) -> dict:
    """Shapes of one transcription: n_frames, n_audio, n_prompt, and the
    decode steps' positions."""
    n_frames = n_mel_frames(n_samples)
    n_audio = audio_rows(n_frames)
    n_prompt = len(asr_prompt(cfg, n_audio)[0])
    return {"n_frames": n_frames, "n_audio": n_audio, "n_prompt": n_prompt,
            "positions": [n_prompt + i - 1 for i in range(1, max_tokens)]}


def asr_request_ops(cfg: dict, n_samples: int, max_tokens: int) -> float:
    s = asr_request(cfg, n_samples, max_tokens)
    macs = (encoder_macs(cfg, s["n_frames"]) + prompt_macs(cfg, s["n_prompt"])
            + head_weights(cfg))
    for p in s["positions"]:
        macs += decoder_layer_weights(cfg) + head_weights(cfg) + attention_macs(cfg, p + 1)
    return 2.0 * macs


def align_request(cfg: dict, n_samples: int, n_words: int) -> dict:
    n_frames = n_mel_frames(n_samples)
    n_audio = audio_rows(n_frames)
    return {"n_frames": n_frames, "n_audio": n_audio,
            "n_real": len(align_prompt(cfg, n_audio, align_words(n_words))[0])}


def align_request_ops(cfg: dict, n_samples: int, n_words: int) -> float:
    s = align_request(cfg, n_samples, n_words)
    macs = (encoder_macs(cfg, s["n_frames"]) + prompt_macs(cfg, s["n_real"])
            + s["n_real"] * cfg["text"]["hidden_size"] * cfg["classify_num"])
    return 2.0 * macs
