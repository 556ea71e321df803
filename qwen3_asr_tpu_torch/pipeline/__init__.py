from qwen3_asr_tpu_torch.pipeline.aligner import (
    AlignedWord,
    AlignmentResult,
    ForcedAligner,
)
from qwen3_asr_tpu_torch.pipeline.asr import (
    Qwen3ASR,
    TranscribeParams,
    TranscribeResult,
)
from qwen3_asr_tpu_torch.pipeline.combined import (
    TranscribeAlignResult,
    alignment_to_json,
    transcribe_and_align,
)

__all__ = ["AlignedWord", "AlignmentResult", "ForcedAligner", "Qwen3ASR",
           "TranscribeAlignResult", "TranscribeParams", "TranscribeResult",
           "alignment_to_json", "transcribe_and_align"]
