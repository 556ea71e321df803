"""The comparison that decides `correct`.

Once the window has closed and the program is freed, a sample of the
window's finished requests, drawn from the seed and always holding the
longest, is judged by the plain reference of the configuration's family
(`family.reference`, `asrbench/families/`), which makes the weights again
from the seed and works out the log-mel, the encoder rows and the logits
itself, over the prompt the family gives (`family.prompt`):

- a transcription: the prompt and the served tokens in one causal pass;
  each served token's gap is the reference's best logit at its position
  less the reference's logit of the served token;
- an alignment: the aligner's prompt in one causal pass; the gap of each
  <ts> row is the reference's best class logit less its logit of the
  class the aligner produced there.

The numbers compared, each against its limit:
- `failed`: requests of the window with no result (limit 0);
- `malformed`: judged requests whose output has the wrong length (limit 0);
- `max_gap`: the widest gap over the sample (the cell's `check.max_gap`);
- `mean_gap`: the mean gap over every judged position (`check.mean_gap`),
  which moves with the share of decisions a precision loss flips and is
  steadier from seed to seed than the widest.

The control (`control` in the mix): "program" runs the program's own
lower-precision path and is judged as above; "reference" puts the
family's reference in the program's place at its control precision
(int4 decoder matrices): each judged position's output is then that
reference's argmax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from asrbench.traffic import Plan, Request

SAMPLE_STREAM = 7


def sample(requests: list[Request], seed: int, n: int) -> list[Request]:
    """n finished requests drawn from the seed, the longest first."""
    done = [r for r in requests if r.ok]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n_samples, -r.seq))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng([seed % 2 ** 63, SAMPLE_STREAM])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[int(i)] for i in sorted(pick)]


def _gaps(logits: torch.Tensor, chosen: torch.Tensor) -> torch.Tensor:
    return logits.max(dim=-1).values - logits.gather(1, chosen[:, None])[:, 0]


@dataclasses.dataclass
class Job:
    """One judged request as the reference runs it: its PCM, the tokens of
    one causal pass with the audio rows spliced in from `audio_offset`, and
    the rows whose logits judge the program's output."""

    pcm: np.ndarray
    tokens: list[int]
    audio_offset: int
    rows: slice | list[int]


def judge(family, cfg: dict, kind: str, plan: Plan, judged: list[Request], seed: int,
          device, reference_control: bool = False) -> dict:
    """-> {"max_gap": the widest gap, "mean_gap": the mean gap over every
    judged position, "malformed": count, "positions": positions judged}
    over `judged`."""
    jobs, picked, malformed = [], [], 0
    for req in judged:
        toks, off = family.prompt(cfg, kind, req)
        out = list(req.output)
        if kind == "asr":
            if len(out) != req.max_tokens:
                malformed += 1
                continue
            seq = toks + out[:-1]
            jobs.append(Job(plan.pcm(req), seq, off, slice(len(toks) - 1, len(seq))))
            picked.append(out)
        else:
            if len(out) != len(toks):
                malformed += 1
                continue
            ts = [i for i, t in enumerate(toks) if t == cfg["tokens"]["timestamp"]]
            jobs.append(Job(plan.pcm(req), toks, off, ts))
            picked.append([out[i] for i in ts])
    worst, total, positions = 0.0, 0.0, 0
    refs = family.reference(cfg, seed, device, jobs, control=reference_control)
    for ids, (logits, low) in zip(picked, refs):
        if low is not None:
            chosen = low.argmax(dim=-1)
        else:
            chosen = torch.tensor(ids, dtype=torch.long, device=device)
        if int(chosen.min()) < 0 or int(chosen.max()) >= logits.shape[1]:
            malformed += 1
            continue
        gaps = _gaps(logits, chosen)
        worst = max(worst, float(gaps.max()))
        total += float(gaps.sum())
        positions += int(chosen.numel())
    return {"max_gap": worst, "mean_gap": total / max(positions, 1), "malformed": malformed,
            "positions": positions}


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, {name: {"value", "limit"}}): each number must be at
    most its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(v["value"] <= v["limit"] for v in out.values()), out
