"""The CLI's `--align`: `ForcedAligner(quantize=...)` and `align(pcm, text,
fused=True)` for one file after another. The door keeps the classes the
aligner computed at every real prompt row, as its `words` step receives
them, for the reference to judge. It records through the aligner's
`words`, which it overrides: the door refuses to build where the aligner
has no such method, and a call raises where `words` did not run."""

from __future__ import annotations

from asrbench.reference.prompt import align_words

kind = "align"


class Door:
    def __init__(self, family, cfg: dict, mix: dict, seed: int, device,
                 quantize: str | None = None):
        from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner

        if not callable(getattr(ForcedAligner, "words", None)):
            raise RuntimeError("ForcedAligner has no words step for the door to record")

        class Recording(ForcedAligner):
            """The aligner, keeping the classes its `words` step gets."""

            def words(self, prompt, classes, words, duration):
                self.classes = classes
                return super().words(prompt, classes, words, duration)

        args = mix["door_args"]
        self.fa = Recording(quantize=quantize or args["quantize"], device=device)
        family.load(self.fa, cfg, seed, device)

    def call(self, req, pcm):
        self.fa.classes = None
        r = self.fa.align(pcm, " ".join(align_words(req.n_words)), fused=True)
        if not r.success:
            raise RuntimeError(r.error_msg)
        if self.fa.classes is None:
            raise RuntimeError("the aligner's words step did not run: no classes recorded")
        if len(r.words) != req.n_words:
            raise RuntimeError(f"{len(r.words)} words aligned of {req.n_words}")
        return [int(c) for c in self.fa.classes]

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self.fa = None
