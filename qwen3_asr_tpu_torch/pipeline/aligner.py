"""Forced alignment: audio + transcript -> word timestamps, on one device.

Port of qwen3_asr_tpu/pipeline/aligner.py (model: Qwen3-ForcedAligner-0.6B).
The prompt is <audio_start>, one audio_pad row per encoder row, <audio_end>,
then each word's BPE tokens followed by two <ts> slots. One causal pass of
the decoder over the prompt (the prefill's layer stack: K2 causal, keys past
the real prompt length masked) and the classify head's argmax give a class
per row; the classes at the <ts> slots, repaired by the longest increasing
subsequence, times 80 ms are each word's start and end. Mel, the windowed
encoder, the pass and the argmax run on the device; the host reads back one
int32 class a row and does the O(words) post-processing.

`align` runs staged (mel, encoder, classify, each timed; the bucketed front
end at `mel_bucket > 0`) or fused (`models/e2e.py::align_fused`: one upload,
one fetch). `align_batch` runs the bucketed front end once per mel bucket
and one batched pass (K2 batched) for the whole batch. Weight modes
(`quantize`): False (dense), "int8pc" (also True and "int4": the aligner
has no decode loop for an int4 pack to serve), "q8_0", and "auto" (int8pc
unless the GGUF ships Q8_0 blocks, which then run as loaded). No mode
quantizes the 152k-row lm head, which the aligner never reads, and none
builds a decode pack.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from qwen3_asr_tpu_torch.audio.mel import _as_pcm, filters_t, generate_mel_filters
from qwen3_asr_tpu_torch.audio.wav import load_wav
from qwen3_asr_tpu_torch.config import SAMPLE_RATE, AlignerModelConfig
from qwen3_asr_tpu_torch.ops.support import resolve_device
from qwen3_asr_tpu_torch.runtime.params import (
    assert_on_device,
    fuse_decoder_params,
    init_aligner_params,
    load_aligner_model,
    quantize_decoder_params,
    resolve_quantize,
)
from qwen3_asr_tpu_torch.runtime.profiler import timer
from qwen3_asr_tpu_torch.text import (
    BPETokenizer,
    build_aligner_prompt,
    classes_to_timestamps,
    fix_timestamp_classes,
    get_feat_extract_output_lengths,
    load_korean_dict,
    pair_words,
    tokenize_korean,
)

AUDIO_OFFSET = 1      # the first audio row sits right after <audio_start>
PROMPT_BUCKET = 128   # prompt rows are padded to a multiple of this


@dataclasses.dataclass
class AlignedWord:
    word: str
    start: float
    end: float


@dataclasses.dataclass
class AlignmentResult:
    success: bool = False
    words: list = dataclasses.field(default_factory=list)
    error_msg: str = ""
    t_mel_ms: float = 0.0
    t_encode_ms: float = 0.0
    t_decode_ms: float = 0.0
    t_total_ms: float = 0.0
    # align_batch: the stage times are the whole batch's (shared work)
    batch_size: int = 1
    batch_index: int = 0


class ForcedAligner:
    """Word-level timestamp alignment (model: Qwen3-ForcedAligner-0.6B)."""

    def __init__(self, quantize=False, device="cuda", dtype=torch.bfloat16):
        """quantize: False / None / "" (dense), "int8pc" (also True and
        "int4"), "q8_0" or "auto". device: "cuda" (the kernels; raises
        without a card) or "cpu" (their plain versions)."""
        if quantize is True or quantize == "int4":
            quantize = "int8pc"
        if quantize not in (False, "", None, "auto", "int8pc", "q8_0"):
            raise ValueError(f"quantize must be int8pc/q8_0/auto, got {quantize!r}")
        self.quantize = quantize or ""
        self.device = resolve_device(device)
        self.dtype = dtype
        self.cfg: AlignerModelConfig | None = None
        self.params: dict | None = None
        self.tokenizer: BPETokenizer | None = None
        self.filters_t: torch.Tensor | None = None
        self.ko_dict: set[str] = set()
        self.error_msg = ""

    # -- loading -----------------------------------------------------------

    def _finish_load(self, cfg, params, vocab, merges) -> None:
        """Quantize ("auto": int8pc unless the GGUF shipped Q8_0 blocks) and
        fuse the decoder, with no int8 lm head."""
        dec = params["decoder"]
        quantize = resolve_quantize(self.quantize, dec)
        if quantize:
            dec = quantize_decoder_params(dec, quantize, lm_head=False)
        params["decoder"] = fuse_decoder_params(dec)
        assert_on_device(params, self.device)
        self.cfg, self.params = cfg, params
        self.tokenizer = BPETokenizer(vocab, merges)
        self.filters_t = filters_t(generate_mel_filters(), self.device)

    def load_model(self, model_path: str) -> bool:
        """Load an aligner GGUF; False (with error_msg) on failure."""
        try:
            self._finish_load(*load_aligner_model(model_path, self.device, self.dtype))
            return True
        except Exception as e:  # noqa: BLE001 - the JAX pipeline's bool + error surface
            self.error_msg = f"Failed to load model: {e}"
            return False

    def load_random(self, cfg: AlignerModelConfig, seed: int = 0,
                    vocab: list[str] | None = None,
                    merges: list[str] | None = None) -> None:
        """Synthetic weights at the config's size, made on the device."""
        params = init_aligner_params(cfg, seed, self.device, self.dtype)
        self._finish_load(cfg, params, vocab or [], merges or [])

    def load_korean_dict(self, dict_path: str) -> bool:
        try:
            self.ko_dict = load_korean_dict(dict_path)
        except OSError:
            return False
        print(f"Korean dictionary loaded: {len(self.ko_dict)} words",
              file=sys.stderr, flush=True)
        return True

    # -- the stages --------------------------------------------------------

    def tokenize_with_timestamps(self, text: str, language: str
                                 ) -> tuple[list[int], list[str]]:
        """Each word's BPE tokens followed by two <ts> slots; Korean words
        split by the dictionary when one is loaded."""
        if language == "korean" and self.ko_dict:
            words = tokenize_korean(text, self.ko_dict)
        else:
            words = text.split()
        ts_id = self.cfg.timestamp_token_id
        tokens: list[int] = []
        for w in words:
            tokens.extend(self.tokenizer.encode_piece(w))
            tokens += [ts_id, ts_id]
        return tokens, words

    def prompt(self, text: str, language: str, n_frames: int
               ) -> tuple[list[int], list[str]]:
        """(the whole prompt, the words) for audio of n_frames mel frames:
        one audio_pad row per encoder row, by the feature-length formula."""
        text_tokens, words = self.tokenize_with_timestamps(text, language)
        n_pads = get_feat_extract_output_lengths(n_frames)
        return build_aligner_prompt(text_tokens, n_pads, self.cfg.decoder), words

    def frontend(self, samples, bucket: int = 0):
        """Mel on the device -> (mel [n_mels, F], the true n_frames); with
        bucket > 0 (a multiple of the 100-frame chunk) F is n_frames
        rounded up to it and the frames past n_frames are 0."""
        from qwen3_asr_tpu_torch.audio.mel import log_mel_spectrogram_padded, mel_device
        from qwen3_asr_tpu_torch.models.e2e import _pad_pcm

        if bucket:
            return log_mel_spectrogram_padded(samples, self.filters_t, bucket)
        buf, n_frames = _pad_pcm(samples)
        mel = mel_device(torch.from_numpy(buf).to(self.device), self.filters_t,
                         n_frames).T
        return mel, n_frames

    def encode(self, mel: torch.Tensor, n_frames: int, bucket: int = 0):
        """-> (feats [N, hidden] on the device, n_audio); rows past n_audio
        of a bucketed mel are padding."""
        from qwen3_asr_tpu_torch.models.encoder import encode, encode_audio_padded

        if bucket:
            return encode_audio_padded(self.params["encoder"], self.cfg.encoder, mel,
                                       n_frames)
        feats = encode(self.params["encoder"], self.cfg.encoder, mel, n_frames)
        return feats, int(feats.shape[0])

    def prompt_tokens(self, prompts: list[list[int]]) -> np.ndarray:
        """A batch of prompts left-aligned in int32 [B, P], P the longest
        rounded up to PROMPT_BUCKET (models/e2e.py::pad_prompts)."""
        from qwen3_asr_tpu_torch.models.e2e import pad_prompts

        return pad_prompts(prompts, self.cfg.decoder, PROMPT_BUCKET)

    def nar_pass(self, prompts: list[list[int]], feats: torch.Tensor,
                 n_audio) -> torch.Tensor:
        """The causal pass over a batch of prompts (prompt_tokens) with
        feats [B, N, hidden] spliced in at AUDIO_OFFSET -> hidden states
        [B, P, hidden]; rows past each prompt are padding."""
        from qwen3_asr_tpu_torch.models.generate import nar_forward_batch

        toks = torch.from_numpy(self.prompt_tokens(prompts)).to(self.device)
        return nar_forward_batch(self.params["decoder"], self.cfg.decoder, toks, feats,
                                 n_audio, AUDIO_OFFSET, [len(p) for p in prompts])

    def classify(self, prompts: list[list[int]], feats: torch.Tensor,
                 n_audio) -> list[np.ndarray]:
        """nar_pass and the classify head's argmax on every real row ->
        int32 classes per prompt, in one fetch."""
        from qwen3_asr_tpu_torch.models.decoder import classify_logits

        h = self.nar_pass(prompts, feats, n_audio)
        n_valid = [len(p) for p in prompts]
        pred = torch.cat([torch.argmax(classify_logits(self.params["decoder"],
                                                       self.cfg.decoder, h[b, :n]), dim=-1)
                          for b, n in enumerate(n_valid)]).to(torch.int32).cpu().numpy()
        return np.split(pred, np.cumsum(n_valid)[:-1])

    def words(self, prompt: list[int], classes, words: list[str],
              duration: float) -> list[AlignedWord]:
        """Host post-processing: the classes at the <ts> slots, repaired,
        in seconds, paired per word and clamped to the audio."""
        ts_id = self.cfg.timestamp_token_id
        ts = [int(classes[i]) for i, t in enumerate(prompt) if t == ts_id]
        seconds = classes_to_timestamps(fix_timestamp_classes(ts),
                                        self.cfg.timestamp_segment_time_ms)
        return [AlignedWord(**w) for w in pair_words(words, seconds, duration)]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- alignment ---------------------------------------------------------

    def align(self, audio, text: str, language: str = "", mel_bucket: int = 0,
              fused: bool = False) -> AlignmentResult:
        """`audio`: a 16 kHz WAV path, samples (int16 PCM is scaled on the
        device) or a PreparedPCM. mel_bucket > 0 (frames, rounded up to the
        100-frame chunk) pads mel and encoder to a bucket; fused=True (and
        mel_bucket 0) runs models/e2e.py::align_fused."""
        from qwen3_asr_tpu_torch.models.e2e import PreparedPCM

        result = AlignmentResult()
        if self.params is None:
            result.error_msg = "Model not loaded"
            return result
        if isinstance(audio, str):
            try:
                samples, sr = load_wav(audio, raw_int16=True)
            except (OSError, ValueError) as e:
                result.error_msg = f"Failed to load audio file: {e}"
                return result
            if sr != SAMPLE_RATE:
                result.error_msg = f"Audio must be 16kHz, got {sr} Hz"
                return result
        elif isinstance(audio, PreparedPCM):
            # the staged upload serves only the fused, exact-shape leg
            samples = audio if (fused and not mel_bucket) else audio.samples
        else:
            samples = _as_pcm(audio)

        t_total = time.perf_counter()
        duration = len(samples) / SAMPLE_RATE
        if fused and not mel_bucket:
            from qwen3_asr_tpu_torch.audio.mel import num_mel_frames
            from qwen3_asr_tpu_torch.models.e2e import align_fused

            prompt, words = self.prompt(text, language, num_mel_frames(len(samples)))
            with timer("fa.fused"):
                pred = align_fused(self.params, self.cfg, samples, self.filters_t,
                                   prompt, AUDIO_OFFSET)
            result.words = self.words(prompt, pred, words, duration)
            result.success = True
            result.t_total_ms = result.t_decode_ms = (time.perf_counter() - t_total) * 1000
            return result

        bucket = mel_bucket
        if bucket > 0:
            chunk = self.cfg.encoder.chunk_size
            bucket = -(-bucket // chunk) * chunk
        t0 = time.perf_counter()
        with timer("fa.mel"):
            mel, n_frames = self.frontend(samples, bucket)
            self._sync()
        result.t_mel_ms = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        with timer("fa.encode"):
            feats, n_audio = self.encode(mel, n_frames, bucket)
            self._sync()
        result.t_encode_ms = (time.perf_counter() - t0) * 1000
        prompt, words = self.prompt(text, language, n_frames)
        t0 = time.perf_counter()
        with timer("fa.decode"):
            pred = self.classify([prompt], feats[None], [n_audio])[0]
        result.t_decode_ms = (time.perf_counter() - t0) * 1000
        result.words = self.words(prompt, pred, words, duration)
        result.success = True
        result.t_total_ms = (time.perf_counter() - t_total) * 1000
        return result

    def align_batch(self, audios: list, texts: list, language: str = "",
                    mel_bucket: int = 500) -> list[AlignmentResult]:
        """Align several (audio, text) pairs: the bucketed mel and encoder
        once per mel bucket (`mel_bucket` frames, rounded up to the chunk),
        then one batched causal pass and classify for the whole batch."""
        from qwen3_asr_tpu_torch.audio.mel import (
            log_mel_spectrogram_padded_batch,
            num_mel_frames,
        )
        from qwen3_asr_tpu_torch.models.encoder import encode_audio_padded_batch

        if len(audios) != len(texts):
            raise ValueError(f"{len(audios)} audios for {len(texts)} texts")
        results = [AlignmentResult() for _ in audios]
        if self.params is None:
            for r in results:
                r.error_msg = "Model not loaded"
            return results
        t_total = time.perf_counter()
        samples_list = []
        for audio in audios:
            if isinstance(audio, str):
                samples, sr = load_wav(audio, raw_int16=True)
                if sr != SAMPLE_RATE:
                    raise ValueError(f"Audio must be 16kHz, got {sr} Hz")
                audio = samples
            samples_list.append(_as_pcm(audio))

        chunk = self.cfg.encoder.chunk_size
        bf = max(chunk, -(-mel_bucket // chunk) * chunk)
        true_frames = [num_mel_frames(len(s)) for s in samples_list]
        groups: dict[int, list[int]] = {}
        for i, nf in enumerate(true_frames):
            groups.setdefault(-(-nf // bf) * bf, []).append(i)
        feats_map = {}
        t_mel_ms = t_encode_ms = 0.0
        for idxs in groups.values():
            t0 = time.perf_counter()
            mel_b, n_true = log_mel_spectrogram_padded_batch(
                [samples_list[i] for i in idxs], self.filters_t, bf)
            self._sync()
            t_mel_ms += (time.perf_counter() - t0) * 1000
            t0 = time.perf_counter()
            feats_b, n_audio = encode_audio_padded_batch(
                self.params["encoder"], self.cfg.encoder, mel_b, n_true)
            self._sync()
            t_encode_ms += (time.perf_counter() - t0) * 1000
            for j, i in enumerate(idxs):
                feats_map[i] = (feats_b[j], n_audio[j])

        prompts, word_lists = zip(*(self.prompt(t, language, nf)
                                    for t, nf in zip(texts, true_frames)))
        B = len(audios)
        cap = max(int(f.shape[0]) for f, _ in feats_map.values())
        feats = torch.zeros(B, cap, self.cfg.decoder.hidden_size, dtype=self.dtype,
                            device=self.device)
        for i, (f, _) in feats_map.items():
            feats[i, :f.shape[0]] = f.to(self.dtype)
        t0 = time.perf_counter()
        preds = self.classify(list(prompts), feats, [feats_map[i][1] for i in range(B)])
        t_decode_ms = (time.perf_counter() - t0) * 1000
        for i, r in enumerate(results):
            r.words = self.words(prompts[i], preds[i], word_lists[i],
                                 len(samples_list[i]) / SAMPLE_RATE)
            r.success = True
            r.t_mel_ms, r.t_encode_ms, r.t_decode_ms = t_mel_ms, t_encode_ms, t_decode_ms
            r.batch_size, r.batch_index = B, i
            r.t_total_ms = (time.perf_counter() - t_total) * 1000
        return results
