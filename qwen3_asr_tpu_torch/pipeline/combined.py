"""Combined transcribe + align: the ASR's transcript, then its words'
timestamps from the forced aligner.

Port of qwen3_asr_tpu/pipeline/combined.py: ASR, the language from the
transcript's 'language Xxx' prefix (or the caller's override), the
transcript without it, then `ForcedAligner.align` in that language. On the
fused path the padded PCM is uploaded once and both legs read it. A Korean
alignment loads the repo's Korean dictionary into the aligner first when it
has none.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from qwen3_asr_tpu_torch.audio.wav import load_wav
from qwen3_asr_tpu_torch.config import SAMPLE_RATE
from qwen3_asr_tpu_torch.pipeline.aligner import AlignmentResult, ForcedAligner
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams, TranscribeResult
from qwen3_asr_tpu_torch.text import detect_language, extract_transcript
from qwen3_asr_tpu_torch.text.korean import find_korean_dict


@dataclasses.dataclass
class TranscribeAlignResult:
    success: bool = False
    error_msg: str = ""
    transcript: str = ""
    detected_language: str = ""
    asr: TranscribeResult | None = None
    alignment: AlignmentResult | None = None


def _fail_asr(out: TranscribeAlignResult, msg: str) -> TranscribeAlignResult:
    out.asr = TranscribeResult(error_msg=msg)
    out.error_msg = f"ASR failed: {msg}"
    return out


def transcribe_and_align(asr: Qwen3ASR, aligner: ForcedAligner, audio,
                         params: TranscribeParams | None = None,
                         language_override: str = "") -> TranscribeAlignResult:
    """ASR -> language detection -> transcript -> forced alignment with the
    detected (or overriding) language."""
    from qwen3_asr_tpu_torch.models.e2e import PreparedPCM, prepare_pcm

    out = TranscribeAlignResult()
    if params is not None and params.fused and params.mel_bucket == 0:
        # one upload of the padded PCM for both fused legs, with the ASR
        # leg's load checks and messages
        if isinstance(audio, str):
            try:
                samples, sr = load_wav(audio, raw_int16=True)
            except (OSError, ValueError) as e:
                return _fail_asr(out, f"Failed to load audio file: {e}")
            if sr != SAMPLE_RATE:
                return _fail_asr(out, f"Audio must be 16kHz, got {sr} Hz")
            audio = prepare_pcm(samples, asr.device)
        elif not isinstance(audio, PreparedPCM):
            audio = prepare_pcm(audio, asr.device)

    asr_result = asr.transcribe(audio, params)
    out.asr = asr_result
    if not asr_result.success:
        out.error_msg = f"ASR failed: {asr_result.error_msg}"
        return out

    detected = detect_language(asr_result.text)
    align_lang = language_override or detected
    out.detected_language = detected
    out.transcript = extract_transcript(asr_result.text)

    if align_lang == "korean" and not aligner.ko_dict:
        dict_path = find_korean_dict()
        if not dict_path:
            print("Warning: Korean dictionary not found. "
                  "Falling back to whitespace splitting.", file=sys.stderr, flush=True)
        elif not aligner.load_korean_dict(dict_path):
            print(f"Warning: Failed to load Korean dictionary from {dict_path}",
                  file=sys.stderr, flush=True)

    mel_bucket = params.mel_bucket if params else 0
    out.alignment = aligner.align(audio, out.transcript, align_lang,
                                  mel_bucket=mel_bucket,
                                  fused=(params.fused if params else False)
                                  and mel_bucket == 0)
    if not out.alignment.success:
        out.error_msg = f"Alignment failed: {out.alignment.error_msg}"
        return out
    out.success = True
    return out


def alignment_to_json(result: AlignmentResult) -> str:
    """The words as the reference CLI prints them: one word a line,
    start / end with three decimals."""

    def esc(s: str) -> str:
        return json.dumps(s, ensure_ascii=False)[1:-1]

    rows = [f'    {{"word": "{esc(w.word)}", "start": {w.start:.3f}, '
            f'"end": {w.end:.3f}}}' for w in result.words]
    return "\n".join(['{\n  "words": [', ",\n".join(rows), "  ]\n}"])
