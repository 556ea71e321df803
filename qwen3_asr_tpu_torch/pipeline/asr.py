"""High-level ASR pipeline: audio -> transcript, on one device.

Port of qwen3_asr_tpu/pipeline/asr.py:35-505 and :509-638, with its
defaults: `Qwen3ASR()` keeps dense weights and a bf16 KV cache. Weight
modes (`quantize`): "auto" (int8pc for dense weights, none when the GGUF
ships Q8_0 blocks, which then run as loaded), "int8pc" (per-channel int8
weights) and "int4" (int4 decode weights, int8pc prefill), both with the
decode pack (`ops/megakernel.py`), whose step the K1 kernels run; "q8_0"
(also True) and False (dense), both through the per-layer decode step
(K4-K7). Each takes a bf16 or int8 cache (`kv_cache`, or `kv_int8`); the
int4 cache (`kv_cache="int4"`) is the decode pack's nibble-packed stream
and runs as int8 without a pack and in batches.

`transcribe` runs one utterance either fused (`models/e2e.py::
transcribe_fused`: one upload, one fetch) or staged (mel, the encoder, the
decode, each timed; the bucketed frontend at `mel_bucket > 0`), as the
reference picks them; a progress or token callback (`set_progress_callback`,
`set_token_callback`) or `print_progress` takes the staged path with the
streaming decode (`generate_greedy_streaming`: callbacks per token, one host
read per 8 tokens). Sampled decoding (`temperature` > 0, with `top_k`,
`top_p` and `seed`: `generate_sample`) and greedy self-speculation (`spec_k`
> 0: `generate_greedy_spec`, which needs a decode pack and runs over an int8
cache) take the staged path too, as in the reference; spec_k is ignored
under sampling, and a sampled request reports no per-token progress. Unlike
the reference, spec runs wherever the pack does (the twins on the CPU) and
at any audio length. `transcribe_batch` (the bucketed batched frontend, the
batched prefill and the lockstep batched decode,
`parallel/mesh.py::batched_transcribe_step`) runs in every weight and cache
mode: the decode pack's batched step (K3) over an int8 or a bf16 cache in
chunks of at most 16 sequences, or without a pack the per-layer step at B
rows; the int4 cache runs as int8 in a batch.

An MoE model (Qwen3-Omni-30B-A3B's thinker: `config.MoeDecoderConfig`)
loads under "int8pc" or "auto" (its experts as `ops/moe.py`'s int8 leaves,
the MoE step's pack under "moe") and runs `transcribe`'s greedy path, fused
or staged; the other paths and weight modes raise, naming themselves.
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
from qwen3_asr_tpu_torch.models.generate import INT4_KV
from qwen3_asr_tpu_torch.ops.megakernel import pack_megakernel_params
from qwen3_asr_tpu_torch.ops.moe import pack_moe_params
from qwen3_asr_tpu_torch.ops.support import resolve_device
from qwen3_asr_tpu_torch.runtime.params import (
    assert_on_device,
    dequantize_decoder_params,
    fuse_decoder_params,
    init_asr_params,
    load_asr_model,
    quantize_decoder_params,
    resolve_quantize,
)
from qwen3_asr_tpu_torch.runtime.profiler import span

SPEC_NEEDS_PACK = ("spec_k needs a quantized model with the decode megakernel "
                   "(quantize='int8pc'/'auto'/'int4')")


@dataclasses.dataclass
class TranscribeParams:
    max_tokens: int = 1024
    language: str = ""            # accepted for CLI parity; unused by the model
    system_prompt: str = ""
    print_progress: bool = False  # "Generated N tokens..." on stderr (streaming path)
    print_timing: bool = True     # the timing block on stderr
    # prompt-length bucket of the staged and batched paths (tokens)
    prompt_bucket: int = 128
    # mel frame-count bucket (a multiple of the 100-frame chunk; 0 = exact
    # shapes, one frontend pass per file)
    mel_bucket: int = 0
    # fused=True (and mel_bucket 0): models/e2e.py::transcribe_fused;
    # otherwise the staged path with per-stage timings
    fused: bool = False
    # greedy self-speculation: draft spec_k tokens a round through the decode
    # pack, verify them in one int8pc pass (0 = off; ignored under sampling)
    spec_k: int = 0
    # sampled decoding: temperature > 0 draws from the softmax after top-k
    # (0 = off) and top-p (1.0 = off); seed seeds the request's generator
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0


@dataclasses.dataclass
class TranscribeResult:
    success: bool = False
    text: str = ""
    tokens: list = dataclasses.field(default_factory=list)
    error_msg: str = ""
    t_mel_ms: float = 0.0
    t_encode_ms: float = 0.0
    t_decode_ms: float = 0.0
    t_total_ms: float = 0.0


class Qwen3ASR:
    """End-to-end speech-to-text (model: Qwen3-ASR-0.6B)."""

    def __init__(self, quantize=False, kv_int8: bool = False,
                 kv_cache: str | None = None, device="cuda",
                 dtype=torch.bfloat16):
        """quantize: False / None / "" (dense), True or "q8_0" (GGUF Q8_0
        weights), "int8pc", "int4" or "auto" (int8pc for dense weights, none
        for a Q8_0 GGUF). kv_int8: an int8 KV cache instead of bf16;
        kv_cache ("bf16" / "int8" / "int4") overrides it. int4 is the
        decode pack's nibble-packed cache (a quarter of bf16's cache bytes,
        ~4x int8's quantization error); without a pack, and in batches, it
        runs as int8. The defaults are the JAX package's: dense weights, a
        bf16 cache."""
        quantize = "q8_0" if quantize is True else (quantize or "")
        if quantize not in ("", "q8_0", "int8pc", "int4", "auto"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        if kv_cache not in (None, "bf16", "int8", "int4"):
            raise ValueError(f"kv_cache must be bf16/int8/int4, got {kv_cache!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.quantize = quantize
        self.kv_cache = kv_cache or ("int8" if kv_int8 else "bf16")
        self.cfg: ASRModelConfig | None = None
        self.params: dict | None = None
        self.tokenizer: BPETokenizer | None = None
        self.filters_t: torch.Tensor | None = None
        self._progress_cb = None   # (i, max_tokens) per token
        self._token_cb = None      # (token id) per token
        self.error_msg = ""

    # -- loading -----------------------------------------------------------

    def _resolve_quantize(self, dec: dict) -> str:
        """'auto' -> int8pc for dense weights, "" when the GGUF already
        shipped int8 blocks (runtime/params.py::resolve_quantize)."""
        return resolve_quantize(self.quantize, dec)

    def _finish_load(self, cfg, params, vocab, merges) -> None:
        dec = params["decoder"]
        if cfg.decoder.moe:
            dec = self._moe_decoder(cfg, dec)
        else:
            dec = self._dense_decoder(cfg, dec)
        params["decoder"] = dec
        assert_on_device(params, self.device)
        self.cfg, self.params = cfg, params
        self.tokenizer = BPETokenizer(vocab, merges)
        self.filters_t = filters_t(generate_mel_filters(), self.device)

    def _moe_decoder(self, cfg, dec: dict) -> dict:
        """An MoE decoder (Qwen3-Omni's thinker) on int8pc weights: its
        attention and lm head as int8pc leaves, its experts as `ops/moe.py`'s
        int8 leaves (dense matrices are rounded here; leaves already int8,
        as a loader a layer at a time hands them, stay), and the MoE decode
        step's pack under "moe". "auto" is int8pc; the int4 pack, Q8_0 and
        dense weights are not ported for it."""
        if self.quantize not in ("int8pc", "auto"):
            cfg.decoder.require_dense(f"quantize={self.quantize or False!r}")
        dec = fuse_decoder_params(quantize_decoder_params(dec, "int8pc"))
        dec["moe"] = pack_moe_params(dec, cfg.decoder)
        return dec

    def _dense_decoder(self, cfg, dec: dict) -> dict:
        quantize = self._resolve_quantize(dec)
        if quantize in ("int8pc", "int4"):
            # the decode pack is built from int8pc leaves, so Q8_0 blocks of
            # a GGUF are decoded first
            dec = quantize_decoder_params(
                dequantize_decoder_params(dec, self.dtype), "int8pc")
        elif quantize == "q8_0":
            dec = quantize_decoder_params(dec, "q8_0")
        dec = fuse_decoder_params(dec)
        if quantize in ("int8pc", "int4"):
            dec["mega"] = pack_megakernel_params(dec, cfg.decoder,
                                                 int4=quantize == "int4")
        return dec

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
        except Exception as e:  # noqa: BLE001 - the JAX pipeline's bool + error surface
            self.error_msg = f"Failed to load model: {e}"
            return False

    @property
    def cache_dtype(self) -> torch.dtype:
        """torch.bfloat16, torch.int8 or INT4_KV (the int4 cache)."""
        return {"bf16": torch.bfloat16, "int8": torch.int8,
                "int4": INT4_KV}[self.kv_cache]

    def set_progress_callback(self, cb) -> None:
        """cb(i, max_tokens) after each decoded token; setting it routes
        transcribe() through the streaming path. None clears it."""
        self._progress_cb = cb

    def set_token_callback(self, cb) -> None:
        """cb(token_id) for each decoded token (the server's SSE text
        deltas ride it); setting it routes transcribe() through the
        streaming path. None clears it. Device work is single-threaded, so
        setting it around a call is race-free."""
        self._token_cb = cb

    def _streaming(self, params: TranscribeParams) -> bool:
        return bool(self._progress_cb or self._token_cb or params.print_progress)

    # -- transcription -------------------------------------------------------

    def transcribe(self, audio, params: TranscribeParams | None = None
                   ) -> TranscribeResult:
        """`audio`: path to a 16 kHz mono WAV, a sample array (int16 PCM is
        scaled on the device), or a PreparedPCM (the padded PCM already on
        the device; only the fused path reads that copy)."""
        with span("qwen3.request"):
            return self._transcribe(audio, params or TranscribeParams())

    def _transcribe(self, audio, params: TranscribeParams) -> TranscribeResult:
        from qwen3_asr_tpu_torch.models.e2e import PreparedPCM

        result = TranscribeResult()
        if self.params is None:
            result.error_msg = "Model not loaded"
            return result
        if (params.fused and params.mel_bucket == 0 and not self._streaming(params)
                and params.spec_k == 0 and params.temperature <= 0):
            samples = audio if isinstance(audio, PreparedPCM) else \
                self._load_samples(audio, result)
            if samples is None:
                return result
            return self._transcribe_fused(samples, params, result)
        if isinstance(audio, PreparedPCM):
            audio = audio.samples
        samples = self._load_samples(audio, result)
        if samples is None:
            return result
        return self._transcribe_staged(samples, params, result)

    def _sys_tokens(self, params: TranscribeParams):
        return (self.tokenizer.encode(params.system_prompt)
                if params.system_prompt else None)

    def _finish(self, result: TranscribeResult, out, n_kept: int,
                t_total: float) -> TranscribeResult:
        result.tokens = [int(t) for t in out[:n_kept]]
        with span("qwen3.detokenize"):
            result.text = self.tokenizer.decode(result.tokens)
        result.success = True
        result.t_total_ms = (time.perf_counter() - t_total) * 1000
        return result

    def _transcribe_fused(self, samples, params, result) -> TranscribeResult:
        from qwen3_asr_tpu_torch.models.e2e import transcribe_fused

        t0 = time.perf_counter()
        out, n_kept = transcribe_fused(self.params, self.cfg, samples,
                                       self.filters_t, params.max_tokens,
                                       system_prompt_tokens=self._sys_tokens(params),
                                       cache_dtype=self.cache_dtype)
        self._finish(result, out, n_kept, t0)
        if params.print_timing:
            print(f"\nTiming (fused single-dispatch):\n"
                  f"  Total: {result.t_total_ms:.0f} ms", file=sys.stderr, flush=True)
        return result

    def _transcribe_staged(self, samples, params, result) -> TranscribeResult:
        """Mel, the encoder (bucketed at mel_bucket > 0), then the prompt
        padded to its bucket and the decode: generate_greedy_spec (spec_k >
        0, greedy), generate_sample (temperature > 0), generate_greedy_streaming
        (callbacks or print_progress) or generate_greedy. Each stage ends in
        a synchronize, so the stage times are the device's: t_mel_ms and
        t_encode_ms from their spans, t_decode_ms the prefill and the
        decode together."""
        from qwen3_asr_tpu_torch.models.e2e import _pad_pcm
        from qwen3_asr_tpu_torch.models.encoder import encode, encode_audio_padded
        from qwen3_asr_tpu_torch.models.generate import (
            generate_greedy,
            generate_greedy_spec,
            generate_greedy_streaming,
            generate_sample,
        )
        from qwen3_asr_tpu_torch.audio.mel import log_mel_spectrogram_padded, mel_device

        dcfg, dev = self.cfg.decoder, self.device
        t_total = time.perf_counter()
        bucket_frames = params.mel_bucket
        if bucket_frames > 0:
            chunk = self.cfg.encoder.chunk_size
            bucket_frames = -(-bucket_frames // chunk) * chunk

        with span("qwen3.mel", timed=True) as sp:
            if bucket_frames:
                mel, n_frames = log_mel_spectrogram_padded(samples, self.filters_t,
                                                           bucket_frames)
            else:
                with span("qwen3.upload"):
                    buf, n_frames = _pad_pcm(samples)
                    pcm = torch.from_numpy(buf).to(dev)
                mel = mel_device(pcm, self.filters_t, n_frames).T
            _sync(dev)
        result.t_mel_ms = sp.ms

        with span("qwen3.encode", timed=True) as sp:
            if bucket_frames:
                feats, n_audio = encode_audio_padded(self.params["encoder"],
                                                     self.cfg.encoder, mel, n_frames)
            else:
                feats = encode(self.params["encoder"], self.cfg.encoder, mel, n_frames)
                n_audio = int(feats.shape[0])
            _sync(dev)
        result.t_encode_ms = sp.ms

        prompt = build_asr_prompt(n_audio, dcfg, self._sys_tokens(params))
        n_prompt = len(prompt)
        P = -(-n_prompt // params.prompt_bucket) * params.prompt_bucket
        toks = np.full(P, dcfg.pad_token_id, np.int32)
        toks[:n_prompt] = prompt
        args = (self.params["decoder"], dcfg, torch.from_numpy(toks).to(dev), n_prompt,
                feats, n_audio, audio_start_pos(prompt, dcfg), params.max_tokens)
        sampled = params.temperature > 0
        use_spec = params.spec_k > 0 and not sampled
        if sampled and params.spec_k > 0:
            print("Note: temperature>0 — spec_k (greedy-exact speculation) does "
                  "not apply to sampled decoding; using the sampled path.",
                  file=sys.stderr, flush=True)
        if use_spec:
            dcfg.require_dense("speculative decoding (spec_k)")
        if use_spec and "mega" not in self.params["decoder"]:
            result.error_msg = SPEC_NEEDS_PACK
            return result
        t0 = time.perf_counter()   # the prefill and the decode: their own spans
        if use_spec:
            if self.cache_dtype != torch.int8:
                print("Note: spec_k uses an int8 KV cache; the configured "
                      "kv_cache setting is ignored.", file=sys.stderr, flush=True)
            out, n_kept, stats = generate_greedy_spec(*args, k=params.spec_k)
            if params.print_timing:
                drafted = max(stats["drafted"], 1)
                print(f"spec: rounds={stats['rounds']} "
                      f"accepted={stats['accepted']}/{drafted} "
                      f"({stats['accepted'] / drafted:.0%})",
                      file=sys.stderr, flush=True)
        elif sampled:
            if self._streaming(params):
                print("Note: temperature>0 decodes without per-token "
                      "callbacks; per-token progress is not reported.",
                      file=sys.stderr, flush=True)
            out, n_kept = generate_sample(
                *args, seed=params.seed, temperature=float(params.temperature),
                top_k=int(params.top_k), top_p=float(params.top_p),
                cache_dtype=self.cache_dtype)
        elif self._streaming(params):
            def on_token(i, total):
                if self._progress_cb:
                    self._progress_cb(i, total)
                if params.print_progress and i % 10 == 0:
                    print(f"Generated {i} tokens...", file=sys.stderr, flush=True)

            out = generate_greedy_streaming(
                *args, on_token=on_token, cache_dtype=self.cache_dtype,
                on_token_id=self._token_cb)
            n_kept = len(out)
        else:
            out, n_kept = generate_greedy(*args, self.cache_dtype)
        result.t_decode_ms = (time.perf_counter() - t0) * 1000
        self._finish(result, out, n_kept, t_total)
        if params.print_timing:
            print("\nTiming:\n"
                  f"  Mel spectrogram: {result.t_mel_ms:.0f} ms\n"
                  f"  Audio encoding:  {result.t_encode_ms:.0f} ms\n"
                  f"  Text decoding:   {result.t_decode_ms:.0f} ms\n"
                  f"  Total:           {result.t_total_ms:.0f} ms\n"
                  f"  Tokens generated: {len(result.tokens)}",
                  file=sys.stderr, flush=True)
        return result

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
        batched prefill and decode run as batched_transcribe_step routes
        them (the decode pack in chunks of at most 16 sequences, each chunk
        one lockstep loop of the batched step; without a pack the per-layer
        step at B rows)."""
        with span("qwen3.request"):
            return self._transcribe_batch(audios, params or TranscribeParams())

    def _transcribe_batch(self, audios: list, params: TranscribeParams
                          ) -> list[TranscribeResult]:
        from qwen3_asr_tpu_torch.parallel.mesh import batched_transcribe_step

        results = [TranscribeResult() for _ in audios]
        if self.params is None:
            for r in results:
                r.error_msg = "Model not loaded"
            return results
        self.cfg.decoder.require_dense("transcribe_batch (and the server's closed batches)")
        t0 = time.perf_counter()
        samples_list = [self._load_samples(a, r) for a, r in zip(audios, results)]
        feats_list = frontend_feats_batch(self, samples_list, params.mel_bucket)
        valid = [i for i, f in enumerate(feats_list) if f is not None]
        if not valid:
            return results
        toks, n_prompt, n_audio, audio, offset = batch_prompts(
            self, [feats_list[i] for i in valid], params.prompt_bucket)
        out, n_kept = batched_transcribe_step(
            self.params["decoder"], self.cfg.decoder, toks, n_prompt, audio, n_audio,
            offset, params.max_tokens, cache_dtype=self.cache_dtype)
        t_ms = (time.perf_counter() - t0) * 1000
        with span("qwen3.detokenize"):
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
            with span("qwen3.mel"):
                mel_b, n_true = log_mel_spectrogram_padded_batch(
                    [samples_list[i] for i in idxs], asr.filters_t, bf)
            with span("qwen3.encode"):
                feats_b, n_audio = encode_audio_padded_batch(enc, ecfg, mel_b, n_true)
            for j, i in enumerate(idxs):
                feats_list[i] = (feats_b[j], n_audio[j])
        return feats_list
    for i, samples in enumerate(samples_list):
        if samples is None:
            continue
        with span("qwen3.upload"):
            buf, n_frames = _pad_pcm(samples)
            pcm = torch.from_numpy(buf).to(asr.device)
        with span("qwen3.mel"):
            mel = mel_device(pcm, asr.filters_t, n_frames).T
        with span("qwen3.encode"):
            f = encode(enc, ecfg, mel, n_frames)
        feats_list[i] = (f, int(f.shape[0]))
    return feats_list


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
