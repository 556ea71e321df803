"""High-level ASR pipeline: audio -> transcript, on one device.

Port of qwen3_asr_tpu/pipeline/asr.py:83-298 and :509-638 for the weight
and cache modes the port carries:
- quantize="int4": int4 decode weights (int8pc prefill) with the int8 KV
  cache, on the fused single-utterance path
  (`models/e2e.py::transcribe_fused`) and the batched path
  (`transcribe_batch`: the bucketed batched frontend, then the batched
  prefill and the lockstep batched decode step, in chunks of at most 16
  sequences as the `mesh=None` branch of
  qwen3_asr_tpu/parallel/mesh.py::batched_transcribe_step runs them);
- quantize="q8_0" (also True): GGUF Q8_0 weights, and quantize=False:
  dense bf16 weights, each with a bf16 (kv_cache None or "bf16") or int8
  KV cache, on the fused path through the per-layer decode step.
Other modes raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import SAMPLE_RATE, ASRModelConfig
from qwen3_asr_tpu_torch.text.bpe import BPETokenizer
from qwen3_asr_tpu_torch.text.prompt import audio_start_pos, build_asr_prompt
from qwen3_asr_tpu_torch.audio.mel import filters_t, generate_mel_filters
from qwen3_asr_tpu_torch.audio.wav import load_wav
from qwen3_asr_tpu_torch.ops.megakernel import pack_megakernel_params
from qwen3_asr_tpu_torch.ops.support import resolve_device
from qwen3_asr_tpu_torch.runtime.params import (
    assert_on_device,
    dequantize_decoder_params,
    fuse_decoder_params,
    init_asr_params,
    load_asr_model,
    quantize_decoder_params,
)


@dataclasses.dataclass
class TranscribeParams:
    max_tokens: int = 1024
    system_prompt: str = ""
    # prompt-length bucket of the batched paths (tokens)
    prompt_bucket: int = 128
    # mel frame-count bucket of the batched paths (a multiple of the
    # 100-frame chunk; 0 = exact shapes, one frontend pass per file)
    mel_bucket: int = 0


@dataclasses.dataclass
class TranscribeResult:
    success: bool = False
    text: str = ""
    tokens: list = dataclasses.field(default_factory=list)
    error_msg: str = ""
    t_total_ms: float = 0.0


class Qwen3ASR:
    """End-to-end speech-to-text (model: Qwen3-ASR-0.6B)."""

    def __init__(self, quantize="int4", kv_cache: str | None = "int8",
                 device="cuda", dtype=torch.bfloat16):
        """quantize: "int4" (int4 decode weights, int8pc prefill), "q8_0" or
        True (GGUF Q8_0 weights), False / None / "" (dense weights);
        kv_cache: "int8", or "bf16" / None (a bf16 cache)."""
        quantize = "q8_0" if quantize is True else (quantize or "")
        kv_cache = kv_cache or "bf16"
        if kv_cache not in ("bf16", "int8", "int4"):
            raise ValueError(f"kv_cache must be bf16/int8/int4, got {kv_cache!r}")
        if quantize in ("int8pc", "auto") or kv_cache == "int4":
            raise NotImplementedError(
                f"quantize={quantize!r}, kv_cache={kv_cache!r}: the int8-weight "
                "modes and the int4 KV cache are not ported (ROADMAP, next PRs, "
                "item 3)")
        if quantize not in ("int4", "q8_0", ""):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if quantize == "int4" and kv_cache != "int8":
            raise NotImplementedError(
                f"quantize='int4' with kv_cache={kv_cache!r}: the int4 decode "
                "step takes the int8 KV cache only (its bf16-KV mode: ROADMAP, "
                "next PRs, item 3)")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.quantize, self.kv_cache = quantize, kv_cache
        self.cfg: ASRModelConfig | None = None
        self.params: dict | None = None
        self.tokenizer: BPETokenizer | None = None
        self.filters_t: torch.Tensor | None = None
        self.error_msg = ""

    # -- loading -----------------------------------------------------------

    def _finish_load(self, cfg, params, vocab, merges) -> None:
        dec = params["decoder"]
        if self.quantize == "int4":
            # the int4 pack is built from int8pc leaves, so Q8_0 blocks of a
            # GGUF are decoded first
            dec = quantize_decoder_params(
                dequantize_decoder_params(dec, self.dtype), "int8pc")
        elif self.quantize == "q8_0":
            dec = quantize_decoder_params(dec, "q8_0")
        dec = fuse_decoder_params(dec)
        if self.quantize == "int4":
            dec["mega"] = pack_megakernel_params(dec, cfg.decoder)
        params["decoder"] = dec
        assert_on_device(params, self.device)
        self.cfg, self.params = cfg, params
        self.tokenizer = BPETokenizer(vocab, merges)
        self.filters_t = filters_t(generate_mel_filters(), self.device)

    def load_random(self, cfg: ASRModelConfig, seed: int = 0,
                    vocab: list[str] | None = None,
                    merges: list[str] | None = None) -> None:
        """Synthetic weights at the config's size, made on the device from
        a seeded torch.Generator."""
        params = init_asr_params(cfg, seed, self.device, self.dtype)
        self._finish_load(cfg, params, vocab or [], merges or [])

    def load_model(self, model_path: str) -> bool:
        """Load a GGUF model; False (with error_msg) on failure, like the
        JAX pipeline."""
        try:
            t0 = time.perf_counter()
            cfg, params, vocab, merges = load_asr_model(
                model_path, self.device, self.dtype)
            self._finish_load(cfg, params, vocab, merges)
            print(f"Model loaded in {int((time.perf_counter() - t0) * 1000)} ms",
                  file=sys.stderr, flush=True)
            return True
        except (OSError, ValueError, KeyError) as e:
            self.error_msg = f"Failed to load model: {e}"
            return False

    # -- transcription -------------------------------------------------------

    def transcribe(self, audio, params: TranscribeParams | None = None
                   ) -> TranscribeResult:
        """`audio`: path to a 16 kHz mono WAV, or a sample array (int16 PCM
        is scaled on the device)."""
        from qwen3_asr_tpu_torch.models.e2e import transcribe_fused

        params = params or TranscribeParams()
        result = TranscribeResult()
        if self.params is None:
            result.error_msg = "Model not loaded"
            return result
        samples = self._load_samples(audio, result)
        if samples is None:
            return result
        t0 = time.perf_counter()
        sys_tokens = (self.tokenizer.encode(params.system_prompt)
                      if params.system_prompt else None)
        out, n_kept = transcribe_fused(self.params, self.cfg, samples,
                                       self.filters_t, params.max_tokens,
                                       system_prompt_tokens=sys_tokens,
                                       cache_dtype=self.cache_dtype)
        result.tokens = [int(t) for t in out[:n_kept]]
        result.text = self.tokenizer.decode(result.tokens)
        result.success = True
        result.t_total_ms = (time.perf_counter() - t0) * 1000
        return result

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch.int8 if self.kv_cache == "int8" else torch.bfloat16

    def _load_samples(self, audio, result: TranscribeResult):
        """A path or a sample array -> samples (int16 kept as is), or None
        with result.error_msg set."""
        if not isinstance(audio, str):
            samples = np.asarray(audio)
            return samples if samples.dtype == np.int16 else samples.astype(np.float32)
        try:
            samples, sr = load_wav(audio, raw_int16=True)
        except (OSError, ValueError) as e:
            result.error_msg = f"Failed to load audio file: {e}"
            return None
        if sr != SAMPLE_RATE:
            result.error_msg = f"Audio must be 16kHz, got {sr} Hz"
            return None
        return samples

    def transcribe_batch(self, audios: list,
                         params: TranscribeParams | None = None
                         ) -> list[TranscribeResult]:
        """Transcribe several utterances in one batched decode: all prompts
        pad to a common bucket, the frontend runs per mel bucket, and the
        batched prefill and decode run in chunks of at most 16 sequences
        (MAX_BATCH), each chunk one lockstep loop of the batched step."""
        from qwen3_asr_tpu_torch.models.generate import generate_greedy_batch_mega
        from qwen3_asr_tpu_torch.ops.megakernel_batch import MAX_BATCH

        params = params or TranscribeParams()
        results = [TranscribeResult() for _ in audios]
        if self.params is None:
            for r in results:
                r.error_msg = "Model not loaded"
            return results
        if "mega" not in self.params["decoder"]:
            raise NotImplementedError(
                f"transcribe_batch runs the batched int4 decode step; "
                f"quantize={self.quantize or False!r} has no int4 pack (the "
                "batched Q8_0 / dense path is not ported)")
        t0 = time.perf_counter()
        samples_list = [self._load_samples(a, r) for a, r in zip(audios, results)]
        feats_list = frontend_feats_batch(self, samples_list, params.mel_bucket)
        valid = [i for i, f in enumerate(feats_list) if f is not None]
        if not valid:
            return results
        toks, n_prompt, n_audio, audio, offset = batch_prompts(
            self, [feats_list[i] for i in valid], params.prompt_bucket)
        B = len(valid)
        outs, kept = [], []
        for c in range(0, B, MAX_BATCH):
            e = min(B, c + MAX_BATCH)
            o, k = generate_greedy_batch_mega(
                self.params["decoder"], self.cfg.decoder, toks[c:e], n_prompt[c:e],
                audio[c:e], n_audio[c:e], offset, params.max_tokens)
            outs.append(o)
            kept.append(k)
        out, n_kept = np.concatenate(outs), np.concatenate(kept)
        t_ms = (time.perf_counter() - t0) * 1000
        for b, i in enumerate(valid):
            r = results[i]
            r.tokens = [int(t) for t in out[b, :int(n_kept[b])]]
            r.text = self.tokenizer.decode(r.tokens)
            r.success = True
            r.t_total_ms = t_ms
        return results


def batch_prompts(asr: Qwen3ASR, feats: list, bucket: int):
    """The prompts of (feats, n_audio) pairs as one batch: tokens int32 [B,
    P] on the device (prompts left-aligned, padded to the longest rounded up
    to `bucket`), n_prompt and n_audio (host int64 [B]), the audio rows [B,
    max n_audio, hidden] the prompts splice in, and the audio offset."""
    dcfg = asr.cfg.decoder
    prompts = [build_asr_prompt(n, dcfg) for _, n in feats]
    P = -(-max(len(p) for p in prompts) // bucket) * bucket
    toks = np.full((len(prompts), P), dcfg.pad_token_id, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    n_audio = np.array([n for _, n in feats], np.int64)
    audio = torch.zeros(len(feats), int(n_audio.max()), dcfg.hidden_size,
                        dtype=asr.dtype, device=asr.device)
    for b, (f, n) in enumerate(feats):
        audio[b, :n] = f[:n].to(asr.dtype)
    return (torch.from_numpy(toks).to(asr.device),
            np.array([len(p) for p in prompts], np.int64), n_audio, audio,
            audio_start_pos(prompts[0], dcfg))


def frontend_feats_batch(asr: Qwen3ASR, samples_list: list,
                         mel_bucket: int) -> list:
    """Batched mel + encoder: files grouped by mel bucket run the batched
    bucketed frontend once per group. -> a list aligned with samples_list
    of (feats [N, d] on the device, n_audio), None where the input was
    None. mel_bucket <= 0 keeps exact shapes (one pass per file)."""
    from qwen3_asr_tpu_torch.audio.mel import (
        log_mel_spectrogram_padded_batch,
        mel_device,
        num_mel_frames,
    )
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
    from qwen3_asr_tpu_torch.models.encoder import encode, encode_audio_padded_batch

    enc, ecfg = asr.params["encoder"], asr.cfg.encoder
    feats_list: list = [None] * len(samples_list)
    if mel_bucket > 0:
        bf = -(-mel_bucket // ecfg.chunk_size) * ecfg.chunk_size
        groups: dict[int, list[int]] = {}
        for i, s in enumerate(samples_list):
            if s is not None:
                F_b = -(-num_mel_frames(len(s)) // bf) * bf
                groups.setdefault(F_b, []).append(i)
        for idxs in groups.values():
            mel_b, n_true = log_mel_spectrogram_padded_batch(
                [samples_list[i] for i in idxs], asr.filters_t, bf)
            feats_b, n_audio = encode_audio_padded_batch(enc, ecfg, mel_b, n_true)
            for j, i in enumerate(idxs):
                feats_list[i] = (feats_b[j], n_audio[j])
        return feats_list
    for i, samples in enumerate(samples_list):
        if samples is None:
            continue
        buf, n_frames = _pad_pcm(samples)
        mel = mel_device(torch.from_numpy(buf).to(asr.device), asr.filters_t,
                         n_frames).T
        f = encode(enc, ecfg, mel, n_frames)
        feats_list[i] = (f, int(f.shape[0]))
    return feats_list
