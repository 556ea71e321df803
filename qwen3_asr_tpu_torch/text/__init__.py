from qwen3_asr_tpu_torch.text.bpe import BPETokenizer
from qwen3_asr_tpu_torch.text.korean import (
    find_korean_dict,
    load_korean_dict,
    tokenize_korean,
)
from qwen3_asr_tpu_torch.text.prompt import (
    StreamingTranscriptCleaner,
    audio_start_pos,
    build_aligner_prompt,
    build_asr_prompt,
    detect_language,
    extract_transcript,
)
from qwen3_asr_tpu_torch.text.subtitles import (
    group_words_into_cues,
    words_to_srt,
    words_to_vtt,
)
from qwen3_asr_tpu_torch.text.timestamps import (
    classes_to_timestamps,
    fix_timestamp_classes,
    get_feat_extract_output_lengths,
    pair_words,
)

__all__ = [
    "BPETokenizer",
    "StreamingTranscriptCleaner",
    "audio_start_pos",
    "build_aligner_prompt",
    "build_asr_prompt",
    "classes_to_timestamps",
    "detect_language",
    "extract_transcript",
    "find_korean_dict",
    "fix_timestamp_classes",
    "get_feat_extract_output_lengths",
    "group_words_into_cues",
    "load_korean_dict",
    "pair_words",
    "tokenize_korean",
    "words_to_srt",
    "words_to_vtt",
]
