"""A family for the tests: Qwen3-ASR's dense shapes, with weights made a
part or a decoder layer at a time, each a pure function of (configuration,
seed, part, layer). `load` hands the program its decoder one layer at a
time, each rounded to the program's int8 leaves before the next is made;
`reference` runs every judged request through one decoder layer at a
time. `LIVE` counts the decoder layers the maker has handed out that are
still alive, and the most at once.

The rest (the program's config, the prompt, the work count, the tiny
widths) is `qwen3_asr`'s.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from asrbench import weights
from asrbench.doors import byte_vocab
from asrbench.families import qwen3_asr as base
from asrbench.reference import mel as rmel
from asrbench.reference import model as rmodel

port_config = base.port_config
prompt = base.prompt
request_ops = base.request_ops
decode_positions = base.decode_positions
step_work = base.step_work
tiny = base.tiny

PARTS = ("encoder", "top", "layer")        # the tower; embedding and heads; a decoder layer
NORMAL = {"encoder": torch.bfloat16, "decoder": torch.bfloat16, "embed": torch.bfloat16,
          "conv": torch.float32}
FILL = {"ones": (torch.ones, torch.bfloat16), "zeros": (torch.zeros, torch.bfloat16),
        "conv_bias": (torch.zeros, torch.float32)}
MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Layer(dict):
    """One decoder layer's weights, counted by LIVE while alive."""


class Live:
    def __init__(self):
        self.now = self.most = 0

    def add(self, layer: Layer) -> Layer:
        self.now += 1
        self.most = max(self.most, self.now)
        weakref.finalize(layer, self._drop)
        return layer

    def _drop(self) -> None:
        self.now -= 1


LIVE = Live()


def _leaves(cfg: dict, part: str) -> list:
    """[(path within the part, shape, group)] of `weights.leaves`; a decoder
    layer's shapes without the layer axis."""
    out = []
    for group, items in weights.leaves(cfg).items():
        for path, shape in items:
            if path[:2] == ("decoder", "layers"):
                if part == "layer":
                    out.append((path[2:], shape[1:], group))
            elif part == {"encoder": "encoder", "decoder": "top"}[path[0]]:
                out.append((path[1:], shape, group))
    return out


def make(cfg: dict, seed: int, part: str, device, layer: int = 0, dtype=None) -> dict:
    """The weights of `part` (and `layer`), from a generator seeded by
    (seed, part, layer) alone, each normal group in one draw; in `dtype`
    (float32 for the reference) or as served."""
    state = np.random.SeedSequence([seed % 2 ** 63, PARTS.index(part), layer])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state.generate_state(1, np.uint64)[0]) % 2 ** 63)
    items = _leaves(cfg, part)
    tree: dict = {}

    def put(path, value):
        t = tree
        for k in path[:-1]:
            t = t.setdefault(k, {})
        t[path[-1]] = value if dtype is None else value.to(dtype)

    for group, kind in NORMAL.items():
        mine = [(p, s) for p, s, g in items if g == group]
        sizes = [int(np.prod(s)) for _, s in mine]
        buf = torch.randn(sum(sizes), generator=gen, dtype=kind, device=device)
        off = 0
        for (path, shape), n in zip(mine, sizes):
            std = cfg["init"]["conv1_std"] if path[-1] == "conv1_w" else cfg["init"]["std"]
            put(path, buf[off:off + n].view(shape).mul_(std))
            off += n
    for path, shape, group in items:
        if group in FILL:
            fn, kind = FILL[group]
            put(path, fn(shape, dtype=kind, device=device))
    return LIVE.add(Layer(tree)) if part == "layer" else tree


def load(program, cfg: dict, seed: int, device) -> None:
    """The tower and the top whole; the decoder a layer at a time, each
    matrix rounded to the program's int8 leaf (`quantize_pc_weights`, what
    its loader does to the stacked matrices) before the next layer is
    made. The program must run int8pc (the mix's door argument `quantize`),
    which keeps leaves already rounded and builds its decode pack from them:
    under "auto" the port takes leaves already int8 for a GGUF's and builds
    no pack."""
    if program.quantize != "int8pc":
        raise ValueError(f"{__name__} hands int8pc leaves, the program runs {program.quantize!r}")
    L = cfg["text"]["decoder_layers"]
    layers: dict = {}
    for l in range(L):
        _stack(layers, make(cfg, seed, "layer", device, l), l, L)
    tree = {"encoder": make(cfg, seed, "encoder", device),
            "decoder": dict(make(cfg, seed, "top", device), layers=layers)}
    program._finish_load(port_config(cfg), tree, byte_vocab(cfg["vocab_size"]), [])


def _stack(layers: dict, lw: Layer, l: int, L: int) -> None:
    """Layer l's weights into the stacked leaves [L, ...], its matrices as
    int8pc leaves {"i8pc:q", "i8pc:s"}."""
    from qwen3_asr_tpu_torch.ops.q8_matmul import quantize_pc_weights

    def into(slot: dict, key: str, v: torch.Tensor) -> None:
        if key not in slot:
            slot[key] = torch.empty((L,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        slot[key][l] = v

    for k, w in lw.items():
        if k in MATRICES:
            q, s = quantize_pc_weights(w)
            leaf = layers.setdefault(k, {})
            into(leaf, "i8pc:q", q)
            into(leaf, "i8pc:s", s)
        else:
            into(layers, k, w)


def reference(cfg: dict, seed: int, device, jobs: list, control: bool = False) -> list:
    """[(logits, control's logits or None)] a job: the tower a job at a
    time, then every job's rows through one float32 decoder layer at a time.
    The control's rows go through the same layer once its matrices are
    rounded to int4 in place, a matrix at a time, so one layer's float32
    weights are alive at once with the control too."""
    t = cfg["text"]
    enc = rmodel.f32(make(cfg, seed, "encoder", device))
    audio = [rmodel.encode(enc, cfg, rmel.log_mel(j.pcm, device)) for j in jobs]
    del enc
    top = rmodel.f32(make(cfg, seed, "top", device))
    hs = [rmodel.embed(top, j.tokens, a, j.audio_offset) for j, a in zip(jobs, audio)]
    lows = list(hs) if control else None
    for l in range(t["decoder_layers"]):
        lw = make(cfg, seed, "layer", device, l, torch.float32)
        hs = [rmodel.decoder_layer(lw, t, h) for h in hs]
        if control:
            for k in MATRICES:
                lw[k] = rmodel.int4(lw[k])
            lows = [rmodel.decoder_layer(lw, t, h) for h in lows]
        del lw
    head = rmodel.classify_logits if cfg.get("classify_num") else rmodel.lm_logits

    def logits(h, job):
        return head(top, rmodel.output_norm(top, t, h)[job.rows])

    return [(logits(h, j), logits(lows[i], j) if control else None)
            for i, (h, j) in enumerate(zip(hs, jobs))]
