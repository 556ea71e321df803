"""The CLI's transcription of an MoE model (Qwen3-Omni's thinker): the
`cli_transcribe` door, whose every output also carries the program's MoE
counters of its request (`Tokens.moe`), and whose `counters()` reads them
(`models/decoder.py::_moe`): the routed (row, expert) pairs, the experts
with a pair summed over layers, the most pairs one expert took (a running
maximum since the program loaded, not a sum) and the decode steps. The
program fetches its device counts with each request's tokens, so reading
them adds no wait."""

from __future__ import annotations

from asrbench.doors import cli_transcribe

kind = "asr"
COUNTERS = ("pairs", "experts_touched", "rows_max", "decode_steps")


class Tokens(list):
    """A request's served tokens, with `moe`: {counter: its request's
    increase} (rows_max: the running maximum after it)."""

    moe: dict


def _read() -> dict:
    from qwen3_asr_tpu_torch.models.decoder import _moe

    return {k: int(getattr(_moe, k)) for k in COUNTERS}


class Door(cli_transcribe.Door):
    def call(self, req, pcm) -> Tokens:
        before = _read()
        out = Tokens(super().call(req, pcm))
        after = _read()
        out.moe = {k: after[k] if k == "rows_max" else after[k] - before[k] for k in COUNTERS}
        return out

    def counters(self) -> dict:
        return {f"moe.{k}": v for k, v in _read().items()}
