"""The CLI's transcription: `Qwen3ASR(quantize=..., kv_cache=...)` and
`transcribe(pcm, TranscribeParams(max_tokens, fused=True, print_timing=False))`
for one file after another (`qwen3-asr-cuda-cli`'s default path)."""

from __future__ import annotations

import torch


kind = "asr"


class Door:
    def __init__(self, family, cfg: dict, mix: dict, seed: int, device,
                 quantize: str | None = None):
        from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

        args = mix["door_args"]
        self.asr = Qwen3ASR(quantize=quantize or args["quantize"], kv_cache=args["kv_cache"],
                            device=device)
        family.load(self.asr, cfg, seed, device)
        self._params = TranscribeParams

    def call(self, req, pcm) -> list[int]:
        r = self.asr.transcribe(pcm, self._params(max_tokens=req.max_tokens, fused=True,
                                                  print_timing=False))
        if not r.success:
            raise RuntimeError(r.error_msg)
        return r.tokens

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.asr = None
