"""Qwen3-ASR and Qwen3-ForcedAligner: the Whisper-style audio tower and
the dense Qwen3 decoder, the family of a configuration that names none.

It binds the benchmark's first implementation of these models: the
weights of `asrbench/weights.py` (each group of the whole tree in one
draw), the reference of `asrbench/reference/` (the whole tree in float32,
one request after another) and the counts of `asrbench/work.py`.
"""

from __future__ import annotations

import copy

from asrbench import weights, work
from asrbench.doors import byte_vocab
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel
from asrbench.reference import prompt as rprompt


def port_config(cfg: dict):
    """The program's ASRModelConfig, or AlignerModelConfig for a
    configuration with a classify head, with EOS switched off."""
    from qwen3_asr_tpu_torch.config import (
        AlignerModelConfig,
        ASRModelConfig,
        AudioEncoderConfig,
        DecoderConfig,
    )

    a, t, tok = cfg["audio"], cfg["text"], cfg["tokens"]
    window = a["attention_window_rows"]
    enc = AudioEncoderConfig(
        n_layers=a["encoder_layers"], d_model=a["d_model"], n_heads=a["attention_heads"],
        ffn_dim=a["ffn_dim"], conv_channels=a["conv_channels"], n_mel_bins=a["num_mel_bins"],
        output_dim=a["output_dim"], layer_norm_eps=a["layer_norm_eps"], n_window=a["n_window"],
        n_window_infer=a["n_window_infer"] if window else None)
    dec = DecoderConfig(
        vocab_size=cfg["vocab_size"], hidden_size=t["hidden_size"], n_layers=t["decoder_layers"],
        n_heads=t["attention_heads"], n_kv_heads=t["num_key_value_heads"],
        head_dim=t["head_dim"], intermediate_size=t["intermediate_size"],
        rms_norm_eps=t["rms_norm_eps"], rope_theta=t["rope_theta"],
        pad_token_id=tok["pad"], eos_token_id=-1, audio_start_token_id=tok["audio_start"],
        audio_end_token_id=tok["audio_end"], audio_pad_token_id=tok["audio_pad"],
        im_start_token_id=tok["im_start"], im_end_token_id=tok["im_end"],
        system_token_id=tok["system"], user_token_id=tok["user"],
        assistant_token_id=tok["assistant"], newline_token_id=tok["newline"],
        classify_num=cfg.get("classify_num"))
    if cfg.get("classify_num"):
        return AlignerModelConfig(encoder=enc, decoder=dec,
                                  timestamp_token_id=tok["timestamp"],
                                  timestamp_segment_time_ms=cfg["timestamp_segment_time_ms"])
    return ASRModelConfig(encoder=enc, decoder=dec)


def load(program, cfg: dict, seed: int, device) -> None:
    """The whole tree made at once, handed to the program's loader, which
    quantizes and packs it."""
    program._finish_load(port_config(cfg), weights.make(cfg, seed, device),
                         byte_vocab(cfg["vocab_size"]), [])


def prompt(cfg: dict, kind: str, req) -> tuple[list[int], int]:
    n_audio = rprompt.audio_rows(rmel.n_mel_frames(req.n_samples))
    if kind == "asr":
        return rprompt.asr_prompt(cfg, n_audio)
    return rprompt.align_prompt(cfg, n_audio, rprompt.align_words(req.n_words))


def reference(cfg: dict, seed: int, device, jobs: list, control: bool = False) -> list:
    """[(logits, control's logits or None)] a job: the whole tree in
    float32, the control's decoder at int4 (`rmodel.quantize_int4`)."""
    tree = rmodel.f32(weights.make(cfg, seed, device))
    enc, dec = tree["encoder"], tree["decoder"]
    low = rmodel.quantize_int4(dec) if control else None
    head = rmodel.classify_logits if cfg.get("classify_num") else rmodel.lm_logits
    out = []
    for job in jobs:
        audio = rmodel.encode(enc, cfg, rmel.log_mel(job.pcm, device))
        logits = head(dec, rmodel.decode(dec, cfg, job.tokens, audio, job.audio_offset)[job.rows])
        lo = None
        if low is not None:
            lo = head(low, rmodel.decode(low, cfg, job.tokens, audio, job.audio_offset)[job.rows])
        out.append((logits, lo))
    return out


def request_ops(cfg: dict, kind: str, req) -> float:
    if kind == "asr":
        return work.asr_request_ops(cfg, req.n_samples, req.max_tokens)
    return work.align_request_ops(cfg, req.n_samples, req.n_words)


def decode_positions(cfg: dict, req) -> list[int]:
    return work.asr_request(cfg, req.n_samples, req.max_tokens)["positions"]


step_work = work.step_work


def tiny(cfg: dict) -> dict:
    """The configuration at test widths: 2 + 2 layers, hidden 64, a 512-entry
    vocabulary (the special ids at its top). The weights are N(0, 0.3^2):
    at 0.02 or 0.08 a model this small says one token whatever it hears,
    and no check of its outputs could see a step or a row go missing."""
    c = copy.deepcopy(cfg)
    c["audio"].update(encoder_layers=2, d_model=32, attention_heads=4, ffn_dim=64,
                      conv_channels=8, output_dim=64)
    c["text"].update(decoder_layers=2, hidden_size=64, attention_heads=4,
                     num_key_value_heads=2, head_dim=16, intermediate_size=96)
    V = 512
    c["vocab_size"] = V
    c["tokens"] = {k: V - 1 - i for i, k in enumerate(sorted(c["tokens"]))}
    c["tokens"]["im_end"] = c["tokens"]["eos"]
    if c.get("classify_num"):
        c["classify_num"] = 50
    c["init"] = {"std": 0.3, "conv1_std": 0.1}
    return c
