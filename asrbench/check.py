"""The comparison that decides `correct`.

Once the window has closed and the program is freed, a sample of the
window's finished requests, drawn from the seed and always holding the
longest, is judged by the plain reference (`asrbench/reference/`), which
makes the weights again from the seed and works out the log-mel, the
encoder rows, the prompt and the logits itself:

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
reference in the program's place, its decoder at int4: each judged
position's output is then the int4 reference's argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from asrbench import weights
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel
from asrbench.reference import prompt as rprompt
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


def judge(cfg: dict, kind: str, plan: Plan, judged: list[Request], seed: int, device,
          reference_control: bool = False) -> dict:
    """-> {"max_gap": the widest gap, "mean_gap": the mean gap over every
    judged position, "malformed": count, "positions": positions judged}
    over `judged`."""
    tree = rmodel.f32(weights.make(cfg, seed, device))
    enc, dec = tree["encoder"], tree["decoder"]
    low = rmodel.quantize_int4(dec) if reference_control else None
    worst, total, malformed, positions = 0.0, 0.0, 0, 0
    for req in judged:
        mel = rmel.log_mel(plan.pcm(req), device)
        audio = rmodel.encode(enc, cfg, mel)
        out = list(req.output)
        if kind == "asr":
            toks, off = rprompt.asr_prompt(cfg, audio.shape[0])
            if len(out) != req.max_tokens:
                malformed += 1
                continue
            seq = toks + out[:-1]
            rows = slice(len(toks) - 1, len(seq))
            logits = rmodel.lm_logits(dec, rmodel.decode(dec, cfg, seq, audio, off)[rows])
            if low is not None:
                lo = rmodel.lm_logits(low, rmodel.decode(low, cfg, seq, audio, off)[rows])
                chosen = lo.argmax(dim=-1)
            else:
                chosen = torch.tensor(out, dtype=torch.long, device=device)
        else:
            words = rprompt.align_words(req.n_words)
            toks, off = rprompt.align_prompt(cfg, audio.shape[0], words)
            if len(out) != len(toks):
                malformed += 1
                continue
            ts = [i for i, t in enumerate(toks) if t == cfg["tokens"]["timestamp"]]
            logits = rmodel.classify_logits(dec, rmodel.decode(dec, cfg, toks, audio, off)[ts])
            if low is not None:
                lo = rmodel.classify_logits(low, rmodel.decode(low, cfg, toks, audio, off)[ts])
                chosen = lo.argmax(dim=-1)
            else:
                chosen = torch.tensor([out[i] for i in ts], dtype=torch.long, device=device)
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
