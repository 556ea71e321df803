"""Whisper-style audio encoder: the ASR tower (full bidirectional
attention) and the aligner's tower (block-diagonal windows).

Port of qwen3_asr_tpu/models/encoder.py:41-411: three 3x3 stride-2 convs
with exact GELU on zero-padded 100-frame chunks, conv_out, the sinusoidal
positional embedding per chunk, the validity gather of each chunk's output
rows, LayerNorm/GELU transformer blocks, ln_post and proj1/proj2. Weights
keep the JAX package's layouts ([in, out] linears, OIHW convs, stacked
layers). Attention in the exact-shape `encode` is the plain `mha_attention`
(the JAX package switches to its flash kernel only at T >= FLASH_MIN_T);
the bucketed, batched encoder (`encode_audio_padded_batch`, the serving
path; port of `_encode_padded_core_batch`) runs the flash kernel K2
bidirectionally with per-item valid lengths, as `_encoder_block_batch`
does. A config with `n_window_infer` (the aligner) attends within windows
of 13 * n_window_infer / 100 rows (104) in every entry point, through the
plain `block_diagonal_attention`, as the JAX package runs it in XLA: the
bucketed entries mask each item's keys past its n_audio, as the JAX
package's vmapped `_encode_padded_core` does per item, and launch no K2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from qwen3_asr_tpu_torch.config import AudioEncoderConfig
from qwen3_asr_tpu_torch.ops.attention import (
    block_diagonal_attention_batch,
    mha_attention,
)
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention_batch
from qwen3_asr_tpu_torch.ops.support import full_f32


def chunk_output_len(chunk_frames: int) -> int:
    """(len-1)//2+1 applied three times."""
    n = chunk_frames
    for _ in range(3):
        n = (n - 1) // 2 + 1
    return n


def sinusoidal_pe(n_ctx: int, d_model: int) -> np.ndarray:
    """Half-split sin/cos positional embedding, float64 [n_ctx, d_model]."""
    half = d_model // 2
    i = np.arange(half, dtype=np.float64)
    div = np.exp(-np.log(10000.0) * i / (half - 1))
    pos = np.arange(n_ctx, dtype=np.float64)[:, None]
    ang = pos * div[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1)


@functools.cache
def _pe_device(n_ctx: int, d_model: int, device, dtype) -> torch.Tensor:
    """sinusoidal_pe on `device`, uploaded once per shape."""
    return torch.from_numpy(sinusoidal_pe(n_ctx, d_model)).to(device, dtype)


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)
    if w is not None:
        y = y * w
    if b is not None:
        y = y + b
    return y


def _conv_frontend(params: dict, mel_chunks: torch.Tensor) -> torch.Tensor:
    """mel_chunks [B, 1, n_mel, chunk] -> [B, T_out, C*H] features. Inputs
    and kernels are rounded to the weights' dtype, products accumulate in
    f32 (TF32 off), bias and GELU run in f32."""
    dtype = params["conv_out_w"].dtype
    x = mel_chunks.to(dtype)
    with full_f32():
        for i in (1, 2, 3):
            w = params[f"conv{i}_w"].to(dtype).float()
            b = params[f"conv{i}_b"].float()
            x = F.conv2d(x.float(), w, stride=2, padding=1)
            x = F.gelu(x + b[None, :, None, None]).to(dtype)
    # [B, C, H, W] -> [B, W, C, H] -> [B, W, C*H] (feature = c*H + h)
    B, C, H, W = x.shape
    return x.permute(0, 3, 1, 2).reshape(B, W, C * H)


def attention_window(cfg: AudioEncoderConfig) -> int | None:
    """Rows per attention window of a windowed (aligner) encoder: the
    conv's 13 output rows per chunk times the chunks per n_window_infer
    frames (104 for 800); None for full attention."""
    if cfg.n_window_infer is None:
        return None
    return chunk_output_len(cfg.chunk_size) * (cfg.n_window_infer // cfg.chunk_size)


def _encoder_block(cfg: AudioEncoderConfig, h, layer):
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    T = h.shape[0]
    x = _layer_norm(h, layer["attn_norm_w"], layer["attn_norm_b"], cfg.layer_norm_eps)
    q = (x @ layer["wq"] + layer["bq"]).reshape(T, cfg.n_heads, cfg.head_dim)
    k = (x @ layer["wk"] + layer["bk"]).reshape(T, cfg.n_heads, cfg.head_dim)
    v = (x @ layer["wv"] + layer["bv"]).reshape(T, cfg.n_heads, cfg.head_dim)
    window = attention_window(cfg)
    if window is None:
        attn = mha_attention(q, k, v, None, scale)
    else:
        attn = block_diagonal_attention_batch(q[None], k[None], v[None], window,
                                              scale)[0]
    h = h + (attn.reshape(T, cfg.d_model) @ layer["wo"] + layer["bo"])
    x = _layer_norm(h, layer["ffn_norm_w"], layer["ffn_norm_b"], cfg.layer_norm_eps)
    x = F.gelu(x @ layer["w_up"] + layer["b_up"])
    return h + (x @ layer["w_down"] + layer["b_down"])


def encode(params: dict, cfg: AudioEncoderConfig, mel: torch.Tensor,
           n_frames: int) -> torch.Tensor:
    """mel [n_mel, n_frames] -> features [n_ctx, output_dim], n_ctx = 13 per
    full 100-frame chunk plus the tail chunk's rows."""
    n_mel, chunk = cfg.n_mel_bins, cfg.chunk_size
    n_chunks = -(-n_frames // chunk)
    max_out = chunk_output_len(chunk)
    pad = n_chunks * chunk - n_frames
    mel_p = F.pad(mel.float(), (0, pad))
    chunks = mel_p.reshape(n_mel, n_chunks, chunk).permute(1, 0, 2)[:, None]

    feats = _conv_frontend(params, chunks)
    dtype = params["conv_out_w"].dtype
    x = feats.to(dtype) @ params["conv_out_w"]
    x = x + _pe_device(max_out, cfg.d_model, x.device, dtype)[None]

    # every chunk yields max_out rows but the tail one: the valid rows are
    # a prefix of the flattened chunk outputs
    last_out = chunk_output_len(n_frames - (n_chunks - 1) * chunk)
    h = x.reshape(n_chunks * max_out, cfg.d_model)[
        :(n_chunks - 1) * max_out + last_out]

    layers = params["layers"]
    for l in range(cfg.n_layers):
        h = _encoder_block(cfg, h, {k: v[l] for k, v in layers.items()})

    return _post(params, cfg, h)


def _post(params: dict, cfg: AudioEncoderConfig, h: torch.Tensor) -> torch.Tensor:
    h = _layer_norm(h, params["ln_post_w"], params["ln_post_b"], cfg.layer_norm_eps)
    if params.get("proj1_w") is not None:
        h = F.gelu(h @ params["proj1_w"] + params["proj1_b"])
    if params.get("proj2_w") is not None:
        h = h @ params["proj2_w"] + params["proj2_b"]
    return h


def _encoder_block_batch(cfg: AudioEncoderConfig, h, layer, n_valid):
    """One block on h [B, T, d]; keys at index >= n_valid[b] masked.
    Attention is the flash kernel (K2), bidirectional, or for a windowed
    encoder the plain block-diagonal attention."""
    scale = 1.0 / float(np.sqrt(cfg.head_dim))
    B, T, _ = h.shape
    shape = (B, T, cfg.n_heads, cfg.head_dim)
    x = _layer_norm(h, layer["attn_norm_w"], layer["attn_norm_b"], cfg.layer_norm_eps)
    q = (x @ layer["wq"] + layer["bq"]).reshape(shape)
    k = (x @ layer["wk"] + layer["bk"]).reshape(shape)
    v = (x @ layer["wv"] + layer["bv"]).reshape(shape)
    window = attention_window(cfg)
    if window is None:
        attn = flash_attention_batch(q, k, v, n_valid, causal=False, scale=scale)
    else:
        attn = block_diagonal_attention_batch(q, k, v, window, scale, n_valid)
    h = h + (attn.reshape(B, T, cfg.d_model) @ layer["wo"] + layer["bo"])
    x = _layer_norm(h, layer["ffn_norm_w"], layer["ffn_norm_b"], cfg.layer_norm_eps)
    x = F.gelu(x @ layer["w_up"] + layer["b_up"])
    return h + (x @ layer["w_down"] + layer["b_down"])


def max_encoder_ctx(cfg: AudioEncoderConfig, n_frames_bucket: int) -> int:
    """Transformer sequence length for a bucket of n_frames mel frames."""
    return (n_frames_bucket // cfg.chunk_size) * chunk_output_len(cfg.chunk_size)


def _gap_params(cfg: AudioEncoderConfig, n_frames_true: int):
    """(gap_pos, gap_size, n_audio): the tail chunk emits fewer rows than a
    full one; deleting gap_size rows at gap_pos makes the true rows a
    contiguous prefix of n_audio rows."""
    chunk = cfg.chunk_size
    max_out = chunk_output_len(chunk)
    k_full, tail = divmod(n_frames_true, chunk)
    if tail:
        t_out = chunk_output_len(tail)
        return k_full * max_out + t_out, max_out - t_out, k_full * max_out + t_out
    return k_full * max_out, 0, k_full * max_out


def encode_audio_padded_batch(params: dict, cfg: AudioEncoderConfig,
                              mel_b: torch.Tensor, n_frames_list
                              ) -> tuple[torch.Tensor, list[int]]:
    """Bucketed, batched encoder: mel_b [B, n_mel, F_b] (F_b a multiple of
    the chunk, frames past each item's true count zeroed) -> (feats [B,
    13 * F_b / chunk, output_dim], n_audio per item). Every chunk runs the
    conv; a close-the-gap gather removes the tail chunk's missing rows, and
    attention is masked to the first n_audio rows. Rows past n_audio are
    padding the caller never reads."""
    B, n_mel, F_b = mel_b.shape
    chunk = cfg.chunk_size
    if F_b % chunk:
        raise ValueError(f"mel bucket {F_b} is not a multiple of {chunk}")
    n_chunks = F_b // chunk
    max_out = chunk_output_len(chunk)
    dev = mel_b.device
    gaps = np.asarray([_gap_params(cfg, n) for n in n_frames_list], np.int64)

    chunks = (mel_b.float().reshape(B, n_mel, n_chunks, chunk)
              .permute(0, 2, 1, 3).reshape(B * n_chunks, 1, n_mel, chunk))
    feats = _conv_frontend(params, chunks)
    dtype = params["conv_out_w"].dtype
    x = feats.to(dtype) @ params["conv_out_w"]
    x = x + _pe_device(max_out, cfg.d_model, x.device, dtype)[None]
    N = max_encoder_ctx(cfg, F_b)
    x = x.reshape(B, N, cfg.d_model)
    pos = np.arange(N)[None, :]
    idx = np.minimum(pos + np.where(pos >= gaps[:, :1], gaps[:, 1:2], 0), N - 1)
    h = torch.take_along_dim(x, torch.from_numpy(idx).to(dev)[:, :, None], dim=1)

    n_valid = torch.from_numpy(gaps[:, 2].astype(np.int32)).to(dev)
    layers = params["layers"]
    for l in range(cfg.n_layers):
        h = _encoder_block_batch(cfg, h, {k: v[l] for k, v in layers.items()},
                                 n_valid)
    return _post(params, cfg, h), [int(g) for g in gaps[:, 2]]


def encode_audio(params: dict, cfg: AudioEncoderConfig, mel) -> torch.Tensor:
    """mel [n_mel, n_frames] (a tensor on the params' device, or host data
    moved there) -> encoder features [n_ctx, output_dim], 13 rows per full
    second of audio."""
    dev = params["conv_out_w"].device
    mel = torch.as_tensor(mel, device=dev)
    return encode(params, cfg, mel, int(mel.shape[1]))


def encode_audio_padded(params: dict, cfg: AudioEncoderConfig,
                        mel_p: torch.Tensor, n_frames_true: int
                        ) -> tuple[torch.Tensor, int]:
    """Bucketed encoder of one utterance: mel_p [n_mel, F_b] -> (feats
    [13 * F_b / chunk, output_dim], true n_audio)."""
    feats, n_audio = encode_audio_padded_batch(params, cfg, mel_p[None],
                                               [n_frames_true])
    return feats[0], n_audio[0]
