from qwen3_asr_tpu_torch.text.bpe import BPETokenizer
from qwen3_asr_tpu_torch.text.prompt import (
    StreamingTranscriptCleaner,
    audio_start_pos,
    build_asr_prompt,
    detect_language,
    extract_transcript,
)
from qwen3_asr_tpu_torch.text.timestamps import get_feat_extract_output_lengths

__all__ = [
    "BPETokenizer",
    "StreamingTranscriptCleaner",
    "audio_start_pos",
    "build_asr_prompt",
    "detect_language",
    "extract_transcript",
    "get_feat_extract_output_lengths",
]
