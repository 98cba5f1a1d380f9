"""The plain float32 VQ-Transformer that every cell's output is judged by.

Written from the papers' descriptions and the configuration files under
``portbench/configs/`` alone: it imports no module of the program under
test, and takes from the benchmark only what the benchmark made itself
(weights drawn from the seed, tokens, positions, the edit stream).

The model (paper arXiv:2307.14988 §3-§4 on a pre-norm decoder):

* token embeddings plus learned / sampled absolute position embeddings,
  or rotary embeddings (rotate-half form, the whole head) on q and k;
* LayerNorm (population variance, eps 1e-5) or RMSNorm (eps from the
  configuration);
* σ attention (eq. 1): ``w_ij = gelu_tanh(q_i·k_j / √dh)`` for ``j <= i``,
  each row divided by the number of positions it attends (GQA: query head
  ``h`` reads key head ``h // (H / Hkv)``);
* multi-head VQ of the concatenated head outputs before the output
  projection: ``hq`` contiguous slices, each replaced by its nearest of
  ``Q`` codes (argmax of ``o·c − ‖c‖²/2``);
* a GELU (tanh) MLP with biases, or SwiGLU without;
* tied (``embed.tok``ᵀ) or separate (``lm_head``) output projection.

Parameters are read from a tree in the layout the benchmark draws
(``portbench/weights.py``): one uniform stage whose leaves are stacked over
the layers.

``forward`` given ``codes`` runs teacher-forced: with the VQ codes that
the program chose (its output under judgement) in place of the
reference's own, recording at each layer by how much the program's code
scores below the reference's best (0 where they agree) and continuing with
the program's code, so one near tie between two float orders does not move
every later activation. ``train_loss`` is the training objective, differentiable by
autograd: the Gumbel straight-through VQ with given noise, its commitment
and codebook terms, and next-token cross-entropy.

``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32`` are set
False while these functions run (``float32``), so a float32 product is
computed in float32 on the card; ``precision("tf32")`` turns them on, the
control that computes the same in the next precision down.
"""
from __future__ import annotations

import contextlib
import math
import torch
import torch.nn.functional as F

# query rows a block of σ attention takes: its [H, block, keys] scores stay
# a few hundred MB at 8,192 keys
ATTN_BLOCK = 512


@contextlib.contextmanager
def precision(kind: str = "float32"):
    """Products in float32 (TF32 off) or, for the control, TF32."""
    tf32 = kind == "tf32"
    if kind not in ("float32", "tf32"):
        raise ValueError(kind)
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def layer(W: dict, l: int) -> dict:
    """Layer ``l``'s parameters out of the one stacked stage."""
    if len(W["stages"]) != 1 or len(W["stages"][0]) != 1:
        raise ValueError("the reference reads one uniform stage")

    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[l]
    return pick(W["stages"][0][0])


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def norm(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + cfg.get("layer_norm_eps", 1e-5)) * p["scale"] + p["bias"]
    if cfg["norm"] == "rmsnorm":
        ms = (x * x).mean(-1, keepdim=True)
        return x / torch.sqrt(ms + cfg["rms_norm_eps"]) * p["scale"]
    raise ValueError(cfg["norm"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def embed(W: dict, cfg: dict, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """tokens, positions: [..., n] ints. Returns [..., n, d]."""
    x = W["embed"]["tok"][tokens.long()]
    if cfg["pos"] in ("learned", "sampled"):
        x = x + W["embed"]["pos"][positions.long()]
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., n, heads, dh] rotated by positions [..., n] (halves form)."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh))
    ang = positions.to(torch.float32)[..., None] * inv  # [..., n, dh/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    a, b = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def qkv(cfg: dict, lp: dict, h: torch.Tensor, positions: torch.Tensor):
    """h [..., n, d] -> q [..., n, H, dh], k and v [..., n, Hkv, dh]."""
    H, Hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    m = lp["mixer"]
    q, k, v = h @ m["wq"], h @ m["wk"], h @ m["wv"]
    if "bq" in m:
        q, k, v = q + m["bq"], k + m["bk"], v + m["bv"]
    lead = h.shape[:-1]
    q, k, v = q.reshape(*lead, H, dh), k.reshape(*lead, Hkv, dh), v.reshape(*lead, Hkv, dh)
    if cfg["pos"] == "rope":
        q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"])
    return q, k, v


def sigma_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_start: int = 0) -> torch.Tensor:
    """Causal σ attention of one sequence. q [m, H, dh] holds the queries
    at sequence rows ``q_start .. q_start + m - 1``; k, v [n, Hkv, dh] the
    keys of rows 0 .. n - 1. Returns [m, H·dh]."""
    m, H, dh = q.shape
    rep = H // k.shape[1]
    out = torch.empty((m, H, dh), dtype=torch.float32, device=q.device)
    for i0 in range(0, m, ATTN_BLOCK):
        i1 = min(i0 + ATTN_BLOCK, m)
        last = q_start + i1  # keys this block can see
        kk = k[:last].repeat_interleave(rep, dim=1)  # [last, H, dh]
        vv = v[:last].repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q[i0:i1], kk) * dh ** -0.5
        rows = torch.arange(q_start + i0, q_start + i1, device=q.device)
        live = torch.arange(last, device=q.device)[None, :] <= rows[:, None]  # [b, last]
        w = gelu(s) * live[None].to(torch.float32)
        w = w / (rows + 1).to(torch.float32)[None, :, None]
        out[i0:i1] = torch.einsum("hqk,khd->qhd", w, vv)
    return out.reshape(m, H * dh)


def vq_scores(cb: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """cb [hq, Q, dv]; o [..., hq·dv]. Returns [..., hq, Q]: o·c − ‖c‖²/2."""
    hq, _, dv = cb.shape
    oh = o.reshape(*o.shape[:-1], hq, dv)
    return torch.einsum("...hd,hqd->...hq", oh, cb) - 0.5 * (cb * cb).sum(-1)


def lookup(cb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes [..., hq] -> [..., hq·dv]."""
    heads = torch.arange(cb.shape[0], device=cb.device)
    return cb[heads, codes.long()].reshape(*codes.shape[:-1], -1)


def mix_out(lp: dict, o: torch.Tensor) -> torch.Tensor:
    y = o @ lp["mixer"]["wo"]
    return y + lp["mixer"]["bo"] if "bo" in lp["mixer"] else y


def ffn(cfg: dict, lp: dict, h: torch.Tensor) -> torch.Tensor:
    f = lp["ffn"]
    if cfg["ffn"] == "swiglu":
        return (F.silu(h @ f["w_gate"]) * (h @ f["w_up"])) @ f["w_down"]
    if cfg["ffn"] == "gelu":
        return gelu(h @ f["w_up"] + f["b_up"]) @ f["w_down"] + f["b_down"]
    raise ValueError(cfg["ffn"])


def logits(W: dict, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    h = norm(cfg, W["final_norm"], x)
    return h @ (W["embed"]["tok"].T if cfg["tie_embeddings"] else W["lm_head"])


def code_gap(scores: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """How far below the best score each given code scores: [..., hq] >= 0."""
    chosen = torch.gather(scores, -1, codes.long()[..., None])[..., 0]
    return scores.max(-1).values - chosen


class Record:
    """What a forward keeps: the residual stream entering each layer and
    leaving the last (``xs``, L + 1 of [n, d]), the keys and values each
    layer writes (``ks``, ``vs``: [n, Hkv, dh]), the codes it uses
    (``codes``: [n, hq]), and, teacher-forced, the largest code gap and
    the count of codes that differ from the reference's own choice; own
    codes, asked for, each choice whose lead over the runner-up is within
    ``near`` (``ties``: (lead, layer, row, head, runner-up code)), a near
    tie another float order may take the other way."""

    def __init__(self):
        self.gap = 0.0
        self.flips = 0
        self.xs: list = []
        self.ks: list = []
        self.vs: list = []
        self.codes: list = []
        self.ties: list = []


def forward(W: dict, cfg: dict, tokens: torch.Tensor, positions: torch.Tensor,
            codes=None, *, keep_x: bool = False, keep_kv: bool = False,
            near: float = 0.0) -> Record:
    """One sequence (tokens, positions [n]) through every layer. With
    ``codes(l) -> [n, hq]`` (the program's codes at layer ``l``) the forward
    is teacher-forced: it records each code's gap below the reference's
    best and continues with the program's code; without, or where
    ``codes(l)`` is None, it takes its own codes and, with ``near`` > 0,
    records those whose lead is within ``near``. ``keep_x`` / ``keep_kv``
    keep the residual stream / the keys and values (the last residual
    stream is always kept)."""
    rec = Record()
    x = embed(W, cfg, tokens, positions)
    for l in range(cfg["n_layers"]):
        lp = layer(W, l)
        if keep_x:
            rec.xs.append(x)
        q, k, v = qkv(cfg, lp, norm(cfg, lp["norm1"], x), positions)
        if keep_kv:
            rec.ks.append(k)
            rec.vs.append(v)
        cb = lp["mixer"]["vq"]["codebook"]
        s = vq_scores(cb, sigma_attention(q, k, v))
        c = None if codes is None else codes(l)
        if c is None:
            if near:
                top = s.topk(2, dim=-1)
                lead = top.values[..., 0] - top.values[..., 1]
                for r, h in (lead <= near).nonzero().tolist():
                    rec.ties.append((float(lead[r, h]), l, r, h, int(top.indices[r, h, 1])))
            c = s.argmax(-1)
        else:
            c = c.to(s.device)
            rec.gap = max(rec.gap, float(code_gap(s, c).max()))
            rec.flips += int((s.argmax(-1) != c.long()).sum())
        rec.codes.append(c)
        del s, q
        x = x + mix_out(lp, lookup(cb, c))
        x = x + ffn(cfg, lp, norm(cfg, lp["norm2"], x))
    rec.xs.append(x)
    return rec


# ---------------------------------------------------------------- training


def _vq_train(cb: torch.Tensor, o: torch.Tensor, noise: torch.Tensor, beta: float,
              temperature: float):
    """Gumbel-softmax straight-through VQ (paper §4): the forward value is
    the hard code of ``argmax(scores + noise)``; the gradient reaches ``o``
    unchanged; the codebook learns through ``‖x_q − sg(o)‖²`` with x_q the
    straight-through mixture of the hard one-hot and the soft weights; the
    commitment term ``β‖o − sg(c)‖²`` pulls o toward its code."""
    s = vq_scores(cb, o)
    z = (s + noise) / temperature
    soft = torch.softmax(z, dim=-1)
    idx = z.argmax(-1)
    hard = F.one_hot(idx, s.shape[-1]).to(soft.dtype)
    w = hard + soft - soft.detach()
    xq = torch.einsum("...hq,hqd->...hd", w, cb).reshape(o.shape)
    commit = ((o - lookup(cb, idx).detach()) ** 2).mean()
    cb_loss = ((xq - o.detach()) ** 2).mean()
    return o + (xq - o).detach(), beta * commit + cb_loss


def _train_layer(cfg: dict, lp: dict, x: torch.Tensor, positions: torch.Tensor,
                 noise: torch.Tensor):
    h = norm(cfg, lp["norm1"], x)
    q, k, v = qkv(cfg, lp, h, positions)
    o = torch.stack([sigma_attention(q[b], k[b], v[b]) for b in range(x.shape[0])])
    vq = cfg["vqt"]
    o, aux = _vq_train(lp["mixer"]["vq"]["codebook"], o, noise, vq["commitment_beta"],
                       vq["temperature"])
    x = x + mix_out(lp, o)
    return x + ffn(cfg, lp, norm(cfg, lp["norm2"], x)), aux


def gumbel_ties(W: dict, cfg: dict, tokens: torch.Tensor, positions: torch.Tensor,
                noise: list, tie: float) -> tuple[int, float]:
    """For a step's batch: the count of (row, layer, VQ head) whose Gumbel
    straight-through choice leads its runner-up by less than ``tie``, and
    the narrowest lead (a choice another float order may flip)."""
    count, narrowest = 0, float("inf")
    with torch.no_grad():
        for b in range(tokens.shape[0]):
            x = embed(W, cfg, tokens[b], positions[b])
            for l in range(cfg["n_layers"]):
                lp = layer(W, l)
                q, k, v = qkv(cfg, lp, norm(cfg, lp["norm1"], x), positions[b])
                cb = lp["mixer"]["vq"]["codebook"]
                z = vq_scores(cb, sigma_attention(q, k, v)) + noise[l][b]
                top = z.topk(2, dim=-1).values
                lead = top[..., 0] - top[..., 1]
                count += int((lead < tie).sum())
                narrowest = min(narrowest, float(lead.min()))
                x = x + mix_out(lp, lookup(cb, z.argmax(-1)))
                x = x + ffn(cfg, lp, norm(cfg, lp["norm2"], x))
    return count, narrowest


def train_loss(W: dict, cfg: dict, tokens: torch.Tensor, positions: torch.Tensor,
               noise: list) -> torch.Tensor:
    """The step's objective on [b, n] tokens at positions [b, n], with the
    Gumbel noise ``noise[l]`` [b, n, hq, Q] of each layer: mean next-token
    cross-entropy plus the VQ terms of every layer. Each layer is
    recomputed in the backward (``torch.utils.checkpoint``) so the autograd
    graph holds one layer's activations at a time."""
    from torch.utils.checkpoint import checkpoint

    x = embed(W, cfg, tokens, positions)
    aux = torch.zeros((), device=x.device)
    for l in range(cfg["n_layers"]):
        x, a = checkpoint(_train_layer, cfg, layer(W, l), x, positions, noise[l],
                          use_reentrant=False)
        aux = aux + a
    lg = logits(W, cfg, x)[:, :-1]
    nll = F.cross_entropy(lg.reshape(-1, lg.shape[-1]), tokens[:, 1:].reshape(-1).long())
    return nll + aux


def adamw(params: list, grads: list, mu: list, nu: list, step: int, lr: float,
          opt: dict) -> tuple[list, list, list, float]:
    """AdamW with global-norm clipping as the configuration states it:
    ``g ← g · min(1, clip / (‖g‖ + 1e-9))``, ``m ← b1 m + (1 − b1) g``,
    ``v ← b2 v + (1 − b2) g²``, ``p ← p − lr (m̂ / (√v̂ + eps) + wd · p)``
    with bias-corrected m̂, v̂ and weight decay on every leaf. Returns
    (params, mu, nu, the gradient's norm before clipping)."""
    gnorm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    scale = min(1.0, opt["grad_clip"] / (gnorm + 1e-9))
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
    out_p, out_m, out_v = [], [], []
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        upd = (m / c1) / (torch.sqrt(v / c2) + opt["eps"]) + opt["weight_decay"] * p
        out_p.append(p - lr * upd)
        out_m.append(m)
        out_v.append(v)
    return out_p, out_m, out_v, gnorm


def leaves(tree) -> list:
    """The tree's tensors in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def with_leaves(tree, flat: list):
    """``tree`` with its tensors replaced, in ``leaves`` order."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(go(x) for x in t)
        return next(it)
    return go(tree)


def leaf_names(tree, prefix: str = "") -> list:
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree) for n in leaf_names(x, f"{prefix}/{i}")]
    return [prefix]


def train_steps(W: dict, cfg: dict, batches: list, opt: dict, lr: float,
                steps: int) -> dict:
    """``steps`` AdamW steps from ``W`` on ``batches[i]`` = (tokens,
    positions, noise). Returns each step's loss, the first step's gradient
    norms by leaf, the parameters' change by leaf after the last step, and
    the leaves' names."""
    names = leaf_names(W)
    params = [t.detach().clone() for t in leaves(W)]
    start = [t.clone() for t in params]
    mu = [torch.zeros_like(t) for t in params]
    nu = [torch.zeros_like(t) for t in params]
    losses, grad0 = [], None
    for i in range(steps):
        live = [t.requires_grad_() for t in params]
        tokens, positions, noise = batches[i]
        loss = train_loss(with_leaves(W, live), cfg, tokens, positions, noise)
        grads = torch.autograd.grad(loss, live)
        losses.append(float(loss.detach()))
        if grad0 is None:
            grad0 = [float(g.double().norm()) for g in grads]
        params, mu, nu, _ = adamw([t.detach() for t in live], grads, mu, nu, i + 1, lr, opt)
        del grads, live
    change = [float((p - s).double().norm()) for p, s in zip(params, start)]
    return dict(losses=losses, grad_norms=grad0, change_norms=change, names=names)
