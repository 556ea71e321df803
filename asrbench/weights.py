"""Seeded random weights at a configuration's shapes, made on the device.

Each group of same-scale matrices comes from one `torch.randn` call on a
`torch.Generator` of the device, in bfloat16 (the type they are served
in; the conv stem is float32, as the published checkpoints keep it):
the encoder's matrices, the decoder's layer matrices, the token embedding
with the aligner's classify head, and the three convolutions. Every
matrix is N(0, init_std^2) (conv1: N(0, conv1_std^2)); norms are ones,
biases zeros. The same seed gives the same weights on the same device.

The layout is the one both the measured program and the reference take:
[in, out] matrices, OIHW convolutions, per-layer leaves stacked on a
leading layer axis.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 2 ** 63


def leaves(cfg: dict) -> dict:
    """{group: [(path, shape), ...]} of the normal leaves, and the ones and
    zeros under the groups "ones" / "zeros" (path: a tuple of keys)."""
    a, t = cfg["audio"], cfg["text"]
    L, d, f, c = a["encoder_layers"], a["d_model"], a["ffn_dim"], a["conv_channels"]
    E = ("encoder",)
    EL = ("encoder", "layers")
    h, Ld, inter = t["hidden_size"], t["decoder_layers"], t["intermediate_size"]
    qd = t["attention_heads"] * t["head_dim"]
    kvd = t["num_key_value_heads"] * t["head_dim"]
    DL = ("decoder", "layers")
    conv_in = c * (a["num_mel_bins"] // 8)
    out = {
        "encoder": [(EL + (k,), (L,) + s) for k, s in (
            ("wq", (d, d)), ("wk", (d, d)), ("wv", (d, d)), ("wo", (d, d)),
            ("w_up", (d, f)), ("w_down", (f, d)))]
        + [(E + ("conv_out_w",), (conv_in, d)), (E + ("proj1_w",), (d, d)),
           (E + ("proj2_w",), (d, a["output_dim"]))],
        "decoder": [(DL + (k,), (Ld,) + s) for k, s in (
            ("wq", (h, qd)), ("wk", (h, kvd)), ("wv", (h, kvd)), ("wo", (qd, h)),
            ("w_gate", (h, inter)), ("w_up", (h, inter)), ("w_down", (inter, h)))],
        "embed": [(("decoder", "token_embd"), (cfg["vocab_size"], h))],
        "conv": [(E + ("conv1_w",), (c, 1, 3, 3)), (E + ("conv2_w",), (c, c, 3, 3)),
                 (E + ("conv3_w",), (c, c, 3, 3))],
        "ones": [(EL + ("attn_norm_w",), (L, d)), (EL + ("ffn_norm_w",), (L, d)),
                 (E + ("ln_post_w",), (d,)), (DL + ("attn_norm",), (Ld, h)),
                 (DL + ("q_norm",), (Ld, t["head_dim"])), (DL + ("k_norm",), (Ld, t["head_dim"])),
                 (DL + ("ffn_norm",), (Ld, h)), (("decoder", "output_norm"), (h,))],
        "zeros": [(EL + (k,), (L, n)) for k, n in (
            ("attn_norm_b", d), ("bq", d), ("bk", d), ("bv", d), ("bo", d),
            ("ffn_norm_b", d), ("b_up", f), ("b_down", d))]
        + [(E + ("ln_post_b",), (d,)), (E + ("proj1_b",), (d,)),
           (E + ("proj2_b",), (a["output_dim"],))],
        "conv_bias": [(E + (f"conv{i}_b",), (c,)) for i in (1, 2, 3)],
    }
    if cfg.get("classify_num"):
        out["embed"].append((("decoder", "classify_w"), (h, cfg["classify_num"])))
        out["zeros"].append((("decoder", "classify_b"), (cfg["classify_num"],)))
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def make(cfg: dict, seed: int, device) -> dict:
    """{"encoder": {...}, "decoder": {...}} of seeded random weights on
    `device`: bf16 matrices, norms and biases; float32 convolutions."""
    init = cfg["init"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % SEED_MOD)
    tree: dict = {}
    groups = leaves(cfg)
    for group, dtype in (("encoder", torch.bfloat16), ("decoder", torch.bfloat16),
                         ("embed", torch.bfloat16), ("conv", torch.float32)):
        items = groups[group]
        sizes = [math.prod(s) for _, s in items]
        buf = torch.randn(sum(sizes), generator=gen, dtype=dtype, device=device)
        off = 0
        for (path, shape), n in zip(items, sizes):
            scale = init["conv1_std"] if path[-1] == "conv1_w" else init["std"]
            _put(tree, path, buf[off:off + n].view(shape).mul_(scale))
            off += n
    for path, shape in groups["ones"]:
        _put(tree, path, torch.ones(shape, dtype=torch.bfloat16, device=device))
    for path, shape in groups["zeros"]:
        _put(tree, path, torch.zeros(shape, dtype=torch.bfloat16, device=device))
    for path, shape in groups["conv_bias"]:
        _put(tree, path, torch.zeros(shape, dtype=torch.float32, device=device))
    return tree

