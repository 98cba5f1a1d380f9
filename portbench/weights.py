"""Seeded weights, drawn on the device in the layout the program serves.

One ``torch.Generator`` on the device, seeded from the run's seed, draws
every leaf in one call (the layers of a leaf stacked), at the usual
initialisation scales: normals of 0.02 for the embeddings, 1/√fan-in for
the projections, 0.5 for the VQ codebooks. Norm scales are 1 and biases 0
plus normals of 0.02, so that a path that drops a bias or a scale shows in
the comparison with the reference. The tree is the benchmark's: the
program is handed it, and the reference reads it.
"""
from __future__ import annotations

import torch


def draw(cfg: dict, seed: int, device) -> dict:
    """The parameter tree of ``cfg`` (a configuration file's dict) from
    ``seed``, float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    L, d, H, Hkv = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    dh = cfg.get("head_dim") or d // H
    dff, V = cfg["d_ff"], cfg["vocab"]

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(scale)

    def norm_p(lead):
        p = {"scale": normal(lead + (d,), 0.02).add_(1.0)}
        if cfg["norm"] == "layernorm":
            p["bias"] = normal(lead + (d,), 0.02)
        return p

    embed = {"tok": normal((V, d), 0.02)}
    if cfg["pos"] == "sampled":
        embed["pos"] = normal((cfg["pos_pool"], d), 0.02)
    elif cfg["pos"] == "learned":
        embed["pos"] = normal((cfg["max_seq"], d), 0.02)
    r = (L,)
    mixer = {"wq": normal(r + (d, H * dh), d ** -0.5),
             "wk": normal(r + (d, Hkv * dh), d ** -0.5),
             "wv": normal(r + (d, Hkv * dh), d ** -0.5),
             "wo": normal(r + (H * dh, d), (H * dh) ** -0.5)}
    if cfg["attn_bias"]:
        mixer.update(bq=normal(r + (H * dh,), 0.02), bk=normal(r + (Hkv * dh,), 0.02),
                     bv=normal(r + (Hkv * dh,), 0.02), bo=normal(r + (d,), 0.02))
    vq = cfg["vqt"]
    mixer["vq"] = {"codebook": normal(r + (vq["n_heads"], vq["codebook_size"],
                                           H * dh // vq["n_heads"]), 0.5)}
    if cfg["ffn"] == "swiglu":
        ffn = {"w_gate": normal(r + (d, dff), d ** -0.5), "w_up": normal(r + (d, dff), d ** -0.5),
               "w_down": normal(r + (dff, d), dff ** -0.5)}
    elif cfg["ffn"] == "gelu":
        ffn = {"w_up": normal(r + (d, dff), d ** -0.5), "b_up": normal(r + (dff,), 0.02),
               "w_down": normal(r + (dff, d), dff ** -0.5), "b_down": normal(r + (d,), 0.02)}
    else:
        raise ValueError(cfg["ffn"])
    tree = {"embed": embed,
            "stages": [({"norm1": norm_p(r), "norm2": norm_p(r), "mixer": mixer,
                         "ffn": ffn},)],
            "final_norm": norm_p(())}
    if not cfg["tie_embeddings"]:
        tree["lm_head"] = normal((d, V), d ** -0.5)
    return tree


def to_host(tree):
    """A copy of the tree on the host."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree.cpu()
