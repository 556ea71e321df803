"""Hyperparameter dataclasses of the ASR model.

The port's own copy of qwen3_asr_tpu/config.py (the audio frontend
constants, `AudioEncoderConfig`, `DecoderConfig`, `ASRModelConfig`,
`AlignerModelConfig` and the tiny test configs), with the same fields and
defaults,
so that a config converts between the packages field by field. Defaults
mirror the reference's compiled-in defaults, so a GGUF file with missing
keys loads the same in both packages.
"""

from __future__ import annotations

import dataclasses

# Audio frontend constants
SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 128

# What an MoE decoder (MoeDecoderConfig) runs; every other path
# raises naming itself (DecoderConfig.require_dense)
MOE_PATHS = ("Qwen3ASR.transcribe's greedy path, fused or staged, on int8pc weights "
             "(quantize 'int8pc' or 'auto')")

# Chat-template token ids
IM_START = 151644
IM_END = 151645
SYSTEM_TOKEN = 8948
USER_TOKEN = 872
ASSISTANT_TOKEN = 77091
NEWLINE_TOKEN = 198


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Whisper-style audio tower of the ASR model."""

    n_layers: int = 18
    d_model: int = 896
    n_heads: int = 14
    ffn_dim: int = 3584
    conv_channels: int = 480
    n_mel_bins: int = 128
    output_dim: int = 1024          # text decoder hidden size (proj2 out)
    layer_norm_eps: float = 1e-5
    # chunking: 100 mel frames (1 s) per conv chunk; downsample 8x -> 13
    n_window: int = 50
    # attention windowing: None = full bidirectional (ASR); an int =
    # block-diagonal windows of `n_window_infer` mel frames (the aligner)
    n_window_infer: int | None = None

    @property
    def chunk_size(self) -> int:
        return self.n_window * 2  # 100 mel frames

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def conv_out_in_dim(self) -> int:
        # 3 conv layers halve the 128 mel bins to 16; features = C*16
        return self.conv_channels * (self.n_mel_bins // 8)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Qwen3 text decoder."""

    vocab_size: int = 151936
    hidden_size: int = 1024
    n_layers: int = 28
    n_heads: int = 16
    n_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 3072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6

    pad_token_id: int = 151643
    eos_token_id: int = 151645
    audio_start_token_id: int = 151669
    audio_end_token_id: int = 151670
    audio_pad_token_id: int = 151676

    # chat-template token ids (parameterized so tiny test configs stay
    # within their vocab)
    im_start_token_id: int = IM_START
    im_end_token_id: int = IM_END
    system_token_id: int = SYSTEM_TOKEN
    user_token_id: int = USER_TOKEN
    assistant_token_id: int = ASSISTANT_TOKEN
    newline_token_id: int = NEWLINE_TOKEN

    # the JAX package's layer-scan unroll factor; the port runs its layers
    # in a Python loop and ignores it
    scan_unroll: int = 1

    # single-token decode steps use the decode-attention kernel
    # (ops/decode_attention.py); False is not ported
    use_decode_attn_kernel: bool = True

    # forced-aligner classification head: its class count (timestamp
    # classes of timestamp_segment_time_ms each); None for the ASR model
    classify_num: int | None = None

    @property
    def moe(self) -> bool:
        """True for an MoE decoder (MoeDecoderConfig)."""
        return False

    def require_dense(self, mode: str) -> None:
        """Raise for an MoE decoder in `mode`, a path that has only the dense
        MLP: no path runs a dense feed-forward in the experts' place."""
        if self.moe:
            raise NotImplementedError(f"{mode} is not ported for an MoE decoder "
                                      f"({self.n_experts} experts): it runs {MOE_PATHS}")


@dataclasses.dataclass(frozen=True)
class MoeDecoderConfig(DecoderConfig):
    """Qwen3-MoE text decoder (Qwen3-Omni's thinker): every layer's MLP is
    n_experts SwiGLU experts of moe_intermediate_size, each row taking the
    top n_experts_per_tok of the router's softmax, their weights
    renormalised over them (norm_topk_prob); no shared expert.
    intermediate_size is unused. A class of its own, so DecoderConfig keeps
    the JAX package's fields."""

    n_experts: int = 128
    n_experts_per_tok: int = 8
    moe_intermediate_size: int = 768

    @property
    def moe(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class ASRModelConfig:
    encoder: AudioEncoderConfig = dataclasses.field(default_factory=AudioEncoderConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)


@dataclasses.dataclass(frozen=True)
class AlignerModelConfig:
    """Forced aligner (Qwen3-ForcedAligner-0.6B): a wider, windowed encoder,
    the same decoder backbone at vocab 152,064, and a classification head
    of 5,000 timestamp classes in place of the lm head."""

    encoder: AudioEncoderConfig = dataclasses.field(
        default_factory=lambda: AudioEncoderConfig(
            n_layers=24, d_model=1024, n_heads=16, ffn_dim=4096, n_window_infer=800
        )
    )
    decoder: DecoderConfig = dataclasses.field(
        default_factory=lambda: DecoderConfig(vocab_size=152064, classify_num=5000)
    )
    timestamp_token_id: int = 151705
    timestamp_segment_time_ms: int = 80


def tiny_asr_config(vocab_size: int = 512) -> ASRModelConfig:
    """Small config for tests: same structure, tiny dims."""
    return ASRModelConfig(
        encoder=AudioEncoderConfig(
            n_layers=2,
            d_model=32,
            n_heads=4,
            ffn_dim=64,
            conv_channels=8,
            output_dim=64,
        ),
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            intermediate_size=96,
            pad_token_id=0,
            eos_token_id=vocab_size - 1,
            audio_start_token_id=vocab_size - 4,
            audio_end_token_id=vocab_size - 3,
            audio_pad_token_id=vocab_size - 2,
            im_start_token_id=vocab_size - 6,
            im_end_token_id=vocab_size - 1,   # = eos, like the reference
            system_token_id=vocab_size - 7,
            user_token_id=vocab_size - 8,
            assistant_token_id=vocab_size - 9,
            newline_token_id=vocab_size - 10,
        ),
    )


def tiny_aligner_config(vocab_size: int = 512) -> AlignerModelConfig:
    """Small aligner config for tests: the windowed encoder and the
    classify head at tiny dims."""
    return AlignerModelConfig(
        encoder=AudioEncoderConfig(
            n_layers=2,
            d_model=32,
            n_heads=4,
            ffn_dim=64,
            conv_channels=8,
            output_dim=64,
            n_window_infer=800,
        ),
        decoder=DecoderConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            head_dim=16,
            intermediate_size=96,
            classify_num=50,
            pad_token_id=0,
            eos_token_id=vocab_size - 1,
            audio_start_token_id=vocab_size - 4,
            audio_end_token_id=vocab_size - 3,
            audio_pad_token_id=vocab_size - 2,
        ),
        timestamp_token_id=vocab_size - 5,
    )


def default_aligner_config() -> AlignerModelConfig:
    """Qwen3-ForcedAligner-0.6B: the 24-layer windowed encoder, the decoder
    backbone with the 5,000-class head (AlignerModelConfig's defaults)."""
    return AlignerModelConfig()
