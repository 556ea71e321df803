"""The two models' forward passes in float32, TF32 off.

Weights come in the benchmark's layout (`asrbench/weights.py`): [in, out]
matrices, OIHW convolutions, per-layer matrices stacked on a leading axis.
`quantize_int4` gives the control its weights: the decoder's matrices
rounded per output channel to int4 (`int4`, a matrix at a time). The
decoder's pieces (`embed`, `attention`, `dense_ffn`, `decoder_layer`,
`output_norm`) take one layer's weights each, for a family whose
reference runs layer by layer.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from asrbench.reference.prompt import CHUNK, conv_rows

DECODER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@contextlib.contextmanager
def exact_f32():
    """float32 matrix products and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def f32(tree):
    """A copy of a weight tree in float32."""
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def int4(w: torch.Tensor) -> torch.Tensor:
    """A matrix [..., in, out] rounded to int4 per output channel
    (symmetric, codes -7..7, scale max|w| / 7): the precision below the
    int8 the deployment runs."""
    s = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 7.0
    return torch.clamp(torch.round(w / s), -7, 7) * s


def quantize_int4(dec: dict) -> dict:
    """The decoder with each layer matrix rounded by `int4`."""
    layers = dict(dec["layers"])
    for key in DECODER_MATRICES:
        layers[key] = int4(layers[key])
    return dict(dec, layers=layers)


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    half = d // 2
    div = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64)
                    / (half - 1))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * div[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float().to(device)


def encode(enc: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """log-mel [n_mels, n_frames] -> audio rows [n_audio, hidden]: the conv
    stem over zero-padded 100-frame chunks, a sinusoidal position per
    chunk row, the valid rows of each chunk, the transformer layers (full
    attention, or windows of `attention_window_rows` rows), ln_post, proj1
    with GELU and proj2."""
    a = cfg["audio"]
    n_mels, n_frames = mel.shape
    n_chunks = -(-n_frames // CHUNK)
    x = F.pad(mel, (0, n_chunks * CHUNK - n_frames))
    x = x.reshape(n_mels, n_chunks, CHUNK).permute(1, 0, 2)[:, None]
    with exact_f32():
        for i in (1, 2, 3):
            x = F.gelu(F.conv2d(x, enc[f"conv{i}_w"], enc[f"conv{i}_b"], stride=2, padding=1))
        B, C, H, W = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B, W, C * H) @ enc["conv_out_w"]
        x = x + _sinusoid(W, a["d_model"], x.device)[None]
        last = conv_rows(n_frames - (n_chunks - 1) * CHUNK)
        h = torch.cat([x[c, :(W if c < n_chunks - 1 else last)] for c in range(n_chunks)])
        T, d, nh = h.shape[0], a["d_model"], a["attention_heads"]
        hd = d // nh
        window = a["attention_window_rows"]
        mask = None
        if window:
            seg = torch.arange(T, device=h.device) // window
            mask = seg[:, None] == seg[None, :]
        eps = a["layer_norm_eps"]
        for l in range(a["encoder_layers"]):
            lw = {k: v[l] for k, v in enc["layers"].items()}
            y = _layer_norm(h, lw["attn_norm_w"], lw["attn_norm_b"], eps)
            q = (y @ lw["wq"] + lw["bq"]).reshape(T, nh, hd)
            k = (y @ lw["wk"] + lw["bk"]).reshape(T, nh, hd)
            v = (y @ lw["wv"] + lw["bv"]).reshape(T, nh, hd)
            s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
            if mask is not None:
                s = s.masked_fill(~mask[None], float("-inf"))
            o = torch.einsum("hts,shd->thd", s.softmax(-1), v).reshape(T, d)
            h = h + o @ lw["wo"] + lw["bo"]
            y = _layer_norm(h, lw["ffn_norm_w"], lw["ffn_norm_b"], eps)
            h = h + F.gelu(y @ lw["w_up"] + lw["b_up"]) @ lw["w_down"] + lw["b_down"]
        h = _layer_norm(h, enc["ln_post_w"], enc["ln_post_b"], eps)
        h = F.gelu(h @ enc["proj1_w"] + enc["proj1_b"])
        return h @ enc["proj2_w"] + enc["proj2_b"]


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on x [T, heads, D] at positions 0..T-1, pairs
    (x[i], x[i + D/2])."""
    T, _, D = x.shape
    inv = 1.0 / (theta ** (np.arange(0, D // 2, dtype=np.float64) * 2.0 / D))
    ang = torch.from_numpy(np.arange(T, dtype=np.float64)[:, None] * inv[None]).to(x.device)
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def embed(dec: dict, tokens: list[int], audio: torch.Tensor, audio_offset: int) -> torch.Tensor:
    """The token embedding rows of `tokens` with the audio rows spliced over
    rows [audio_offset, audio_offset + len(audio)) -> [T, hidden]. The
    prompt's run of audio placeholders from `audio_offset` has to be as
    long as the audio."""
    pad = tokens[audio_offset]
    run = next((i for i, t in enumerate(tokens[audio_offset:]) if t != pad),
               len(tokens) - audio_offset)
    if run != audio.shape[0]:
        raise ValueError(f"the prompt holds {run} audio rows from {audio_offset}, "
                         f"the tower gave {audio.shape[0]}")
    ids = torch.tensor(tokens, dtype=torch.long, device=audio.device)
    h = dec["token_embd"][ids].clone()
    h[audio_offset:audio_offset + audio.shape[0]] = audio
    return h


def attention(lw: dict, t: dict, h: torch.Tensor) -> torch.Tensor:
    """One layer's causal self-attention block over h [T, hidden] at
    positions 0..T-1 (RMSNorm, QK-norm, RoPE, grouped KV heads), with its
    residual; `lw` is the layer's weights."""
    T = h.shape[0]
    nh, nkv, hd, eps = t["attention_heads"], t["num_key_value_heads"], t["head_dim"], t["rms_norm_eps"]
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    y = _rms_norm(h, lw["attn_norm"], eps)
    q = _rms_norm((y @ lw["wq"]).reshape(T, nh, hd), lw["q_norm"], eps)
    k = _rms_norm((y @ lw["wk"]).reshape(T, nkv, hd), lw["k_norm"], eps)
    v = (y @ lw["wv"]).reshape(T, nkv, hd)
    q, k = _rope(q, t["rope_theta"]), _rope(k, t["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    s = s.masked_fill(~causal[None], float("-inf"))
    o = torch.einsum("hts,shd->thd", s.softmax(-1), v).reshape(T, nh * hd)
    return h + o @ lw["wo"]


def dense_ffn(lw: dict, t: dict, h: torch.Tensor) -> torch.Tensor:
    """One layer's SwiGLU feed-forward block, with its residual."""
    y = _rms_norm(h, lw["ffn_norm"], t["rms_norm_eps"])
    return h + (F.silu(y @ lw["w_gate"]) * (y @ lw["w_up"])) @ lw["w_down"]


def decoder_layer(lw: dict, t: dict, h: torch.Tensor) -> torch.Tensor:
    """One dense decoder layer (`t`: the configuration's "text")."""
    with exact_f32():
        return dense_ffn(lw, t, attention(lw, t, h))


def output_norm(dec: dict, t: dict, h: torch.Tensor) -> torch.Tensor:
    return _rms_norm(h, dec["output_norm"], t["rms_norm_eps"])


def decode(dec: dict, cfg: dict, tokens: list[int], audio: torch.Tensor,
           audio_offset: int) -> torch.Tensor:
    """One causal pass over `tokens` with the audio rows spliced over rows
    [audio_offset, audio_offset + len(audio)) -> the final hidden states
    [T, hidden] after the output norm."""
    t = cfg["text"]
    h = embed(dec, tokens, audio, audio_offset)
    for l in range(t["decoder_layers"]):
        h = decoder_layer({k: v[l] for k, v in dec["layers"].items()}, t, h)
    return output_norm(dec, t, h)


def lm_logits(dec: dict, h: torch.Tensor) -> torch.Tensor:
    """The tied head: h [T, hidden] -> logits [T, vocab]."""
    with exact_f32():
        return h @ dec["token_embd"].T


def classify_logits(dec: dict, h: torch.Tensor) -> torch.Tensor:
    """The aligner's head: h [T, hidden] -> logits [T, classes]."""
    with exact_f32():
        return h @ dec["classify_w"] + dec["classify_b"]
