"""The program's front doors, one module each, found by the mix's `door`.

A door builds the program from a configuration file and the benchmark's
own weights, warms it up, and serves requests: `call(req, pcm)` for a
closed loop (-> the output), or `submit(req, pcm)` -> a Future and
`result(req, value)` -> the output for an open loop. `counters()` reads
the program's counters, `close()` frees the program. Its `kind` ("asr" or
"align") says how the reference judges the outputs: an ASR output is the
list of served token ids, an alignment's the classes the aligner produced
at every real prompt row.

This module also turns a configuration file into the program's config
objects (EOS switched off) and makes the byte vocabulary.
"""

from __future__ import annotations

import importlib
import re

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load(name: str):
    """The door module asrbench/doors/<name>.py."""
    if not _NAME.match(name) or "." in name:
        raise ValueError(f"bad door name {name!r}")
    return importlib.import_module(f"asrbench.doors.{name}")


def byte_vocab(size: int) -> list[str]:
    """A vocabulary of `size` entries: the 256 bytes in GPT-2's printable
    byte alphabet (entry b is byte b), then fillers "[PADi]"."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
            + list(range(ord("®"), ord("ÿ") + 1)))
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return [table[b] for b in range(256)] + [f"[PAD{i}]" for i in range(256, size)]


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
