"""The decode step run by the caches' plan across a grid
(``models.sharded_decode``, ``launch.sharding.place_caches``) on grids of
"cpu" entries, against the 1x1 grid's plain step and against the
reference's jitted serve step under its shardings.

- One family a cache kind: phi4-mini (GQA), deepseek-v2 (MLA latents,
  its MoE at a capacity where nothing drops), hymba (attention ring + SSM
  and conv states; 6 heads, a second layer windowed to a ring of 8 slots)
  and rwkv6 (WKV state, token-shift carries), each with VQT and without.
- Batch 1 on (2, 1), (1, 2), (2, 2) and (4, 1) grids: the sequence split
  over the data rows (partial attention combined at the first row), and
  a batch of 4 on (2, 2): the batch split. Each step's greedy token
  equals the 1x1 step's and its logits lie within 1e-5 of their max |.|;
  the caches likewise after the steps, and every replica of a cache leaf
  is bitwise equal.
- A ring write lands in every sequence row once the ring wraps.
- Each cache's bytes a device equal the reference's ``cache_shardings``
  shard shapes in f32 / int32, and a (2, 2) grid's greedy decode equals
  the reference's jitted ``make_serve_step`` on an Auto (2, 2) mesh of
  forced host devices (tokens equal, logits within the 2e-3 decode gate;
  deepseek-v2 as its dense MLA layer twice there: the reference's
  expert-parallel ``shard_map`` refuses a batch of one token on a mesh).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.common.pytree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.context import (  # noqa: E402
    GRID_STATS, Blocks, grid_index_rows, reset_grid_stats, use_mesh,
)
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.launch.sharding import place_caches, unplace  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.decode import greedy_decode  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"gqa": "phi4-mini-3.8b", "mla": "deepseek-v2-236b", "hymba": "hymba-1.5b",
            "rwkv6": "rwkv6-7b"}
SEQ_GRIDS = [(2, 1), (1, 2), (2, 2), (4, 1)]
S, STEPS, RING = 32, 20, 8
TOL = 1e-5  # relative to the step's max |logit|
DECODE_GATE = 2e-3  # the port's decode gate against the reference


def _cfg(family: str, vqt: bool):
    cfg = get_config(FAMILIES[family], smoke=True, vqt=vqt)
    if cfg.moe:  # nothing drops
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    if family == "hymba":
        local = dataclasses.replace(cfg.stages[1][0][0], window=RING)
        cfg = dataclasses.replace(cfg, n_heads=6, stages=(cfg.stages[0], ((local,), 1))).validate()
    return cfg


def _grid(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _decode(params, cfg, toks, grid, b):
    """Teacher-forced decode of ``toks`` [b, steps] from empty caches of S
    slots under ``grid`` (placed with one copy an entry, as on distinct
    cards): ([logits a step], the final caches)."""
    caches = T.init_caches(cfg, b, S, device="cpu")
    if grid.devices.size > 1:
        caches = place_caches(caches, grid, batch=b, share=False)
    logits = []
    with torch.no_grad(), use_mesh(grid):
        for i in range(toks.shape[1]):
            out, caches = T.decode_step(params, cfg, toks[:, i:i + 1], caches,
                                        torch.full((b, 1), i, dtype=torch.int32))
            logits.append(out)
    return logits, caches


def _tokens(cfg, b, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, cfg.vocab, (b, STEPS)),
                           dtype=torch.int32)


@pytest.fixture(scope="module")
def plain():
    """{(family, vqt, b): (cfg, params, tokens, the 1x1 logits a step, the
    1x1 caches)}."""
    out = {}
    for family in FAMILIES:
        for vqt in (False, True):
            cfg = _cfg(family, vqt)
            params = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
            for b in (1, 4):
                toks = _tokens(cfg, b)
                out[(family, vqt, b)] = (cfg, params, toks,
                                         *_decode(params, cfg, toks, make_host_mesh("cpu"), b))
    return out


def _check(plain_run, grid, b):
    cfg, params, toks, want, want_caches = plain_run
    reset_grid_stats()
    got, caches = _decode(params, cfg, toks, grid, b)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g.argmax(-1), w.argmax(-1)), f"step {i}: greedy tokens differ"
        err = float((g - w).abs().max())
        assert err <= TOL * max(1.0, float(w.abs().max())), f"step {i}: logits differ by {err}"
    for g, w in zip(tree_leaves(unplace(caches)), tree_leaves(want_caches)):
        assert g.dtype == w.dtype
        assert float((g - w).abs().max()) <= TOL * max(1.0, float(w.abs().max()))
    replicas = 0
    for leaf in tree_leaves(caches):
        assert isinstance(leaf, Blocks)
        for held in leaf.replicas():
            replicas += len(held) - 1
            assert all(torch.equal(held[0][1], t) for _, t in held[1:])
    return replicas


@pytest.mark.parametrize("shape", SEQ_GRIDS, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("vqt", [False, True], ids=["plain", "vqt"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_1_decode_matches_the_1x1_grid(plain, family, vqt, shape):
    grid = _grid(shape)
    replicas = _check(plain[(family, vqt, 1)], grid, 1)
    moved = GRID_STATS["bytes"]
    if shape[0] > 1:
        assert replicas > 0  # the states and lengths, held by every row
        if family != "rwkv6":  # attention over the sequence rows
            assert moved["seq_bcast"] > 0 and moved["seq_combine"] > 0
    if shape[1] > 1:
        assert moved["model_sum"] > 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_batch_split_decode_matches_the_1x1_grid(plain, family):
    """A batch of 4 on (2, 2): each data row decodes its 2 rows, nothing
    crosses the rows but the logits."""
    _check(plain[(family, True, 4)], _grid((2, 2)), 4)
    assert "seq_bcast" not in GRID_STATS["bytes"]
    assert GRID_STATS["bytes"]["data_gather"] > 0


def test_a_ring_write_lands_in_every_sequence_row(plain):
    """hymba's windowed layer: a ring of 8 slots cut over 4 rows, 20 steps:
    the token's k / v go to each row in turn (``cache_copy`` received by
    every row's entry), and the decode still equals the 1x1 grid's."""
    cfg, params, toks, *_ = plain[("hymba", False, 1)]
    grid = _grid((4, 1))
    caches = T.init_caches(cfg, 1, S, device="cpu")
    ring = caches[1][0]["mix"]["attn"]["k"]
    assert ring.shape[2] == RING < STEPS
    reset_grid_stats()
    _check(plain[("hymba", False, 1)], grid, 1)
    got = {idx for (idx, kind) in GRID_STATS["received"] if kind == "cache_copy"}
    assert got >= {row[0] for row in grid_index_rows(grid)[1:]}


def test_greedy_decode_accepts_a_placed_state(plain):
    """``greedy_decode`` under a (2, 2) grid (the caches placed by their
    plan, the prompt token by token) equals it under 1x1."""
    cfg, params, toks, *_ = plain[("gqa", True, 1)]
    with use_mesh(make_host_mesh("cpu")):
        want, _ = greedy_decode(params, cfg, toks[:, :6], 6, cache_len=S)
    with use_mesh(_grid((2, 2))):
        got, caches = greedy_decode(params, cfg, toks[:, :6], 6, cache_len=S)
    assert torch.equal(got, want)
    assert all(isinstance(leaf, Blocks) for leaf in tree_leaves(caches))


REF = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    jax.devices()
    sys.path.insert(0, sys.argv[3])
    from _torch_parity import params_to_numpy
    from repro.configs import get_config
    from repro.distributed.context import use_mesh
    from repro.launch.sharding import batch_shardings, cache_shardings, param_shardings
    from repro.models import transformer as T
    from repro.serving.decode import make_serve_step

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k in sorted(tree) for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
        if isinstance(tree, (list, tuple)):
            return {k2: v2 for i, x in enumerate(tree) for k2, v2 in flat(x, f"{prefix}{i}/").items()}
        return {prefix[:-1]: np.asarray(tree)}

    spec = json.loads(sys.argv[1])
    out = {}
    # each cache's bytes a device under the plan, as f32 / int32 (4 B an element)
    for fam, arch in spec["families"].items():
        cfg = get_config(arch, smoke=True)
        for axes, shape in [(("data", "model"), (2, 4)), (("pod", "data", "model"), (2, 2, 2))]:
            mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
            for b in (1, 8):
                caches = jax.eval_shape(lambda: T.init_caches(cfg, b, 64, dtype=jnp.float32))
                per = {}
                for leaf, sh in zip(jax.tree.leaves(caches),
                                    jax.tree.leaves(cache_shardings(caches, mesh, batch=b))):
                    for dev, idx in sh.devices_indices_map(leaf.shape).items():
                        n = 1
                        for sl, dim in zip(idx, leaf.shape):
                            n *= len(range(*sl.indices(dim)))
                        per[dev.id] = per.get(dev.id, 0) + 4 * n
                out[f"bytes/{fam}/{'x'.join(map(str, shape))}/{b}"] = sorted(per.values())
    # the sharded serve step: greedy from each step's logits, teacher-forced tokens
    mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    toks = np.load(sys.argv[2])
    arrays = {}
    for fam, arch in spec["families"].items():
        cfg = get_config(arch, smoke=True, vqt=True)
        if cfg.moe:  # its dense MLA layer twice: the EP shard_map takes no 1-token batch
            cfg = dataclasses.replace(cfg, stages=((cfg.stages[0][0], 2),))
        params = T.init_params(jax.random.PRNGKey(1), cfg)
        caches = T.init_caches(cfg, 1, spec["S"], dtype=jnp.float32)
        tk = jnp.asarray(toks[fam])
        with use_mesh(mesh):
            tok0 = {"tokens": tk[:, :1], "positions": jnp.zeros((1, 1), jnp.int32)}
            c_sh = cache_shardings(caches, mesh, batch=1)
            step = jax.jit(make_serve_step(cfg), in_shardings=(
                param_shardings(params, mesh), c_sh,
                batch_shardings(tok0, mesh)["tokens"], batch_shardings(tok0, mesh)["positions"]),
                out_shardings=(None, c_sh))
            logits = []
            for i in range(tk.shape[1]):
                lg, caches = step(params, caches, tk[:, i:i + 1],
                                  jnp.full((1, 1), i, jnp.int32))
                logits.append(np.asarray(lg))
        arrays[f"{fam}/logits"] = np.concatenate(logits, axis=1)
        for k, v in flat(params_to_numpy(jax.device_get(params))).items():
            arrays[f"{fam}/param/{k}"] = v
    np.savez(sys.argv[4], **arrays)
    print(json.dumps(out))
""")
REF_STEPS = 12


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's cache plans' bytes a device (8 forced host devices)
    and its jitted serve step on an Auto (2, 2) mesh: logits a step of
    each family's smoke config with VQT, its weights (one subprocess)."""
    d = tmp_path_factory.mktemp("ref_decode")
    toks = {f: _tokens(get_config(a, smoke=True), 1, seed=3)[:, :REF_STEPS].numpy()
            for f, a in FAMILIES.items()}
    np.savez(d / "toks.npz", **toks)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", REF, json.dumps({"families": FAMILIES, "S": S}),
                           str(d / "toks.npz"), str(ROOT / "tests"), str(d / "out.npz")],
                          capture_output=True, text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), dict(np.load(d / "out.npz")), toks


@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_bytes_a_device_equal_the_references_plan(reference, family):
    plans, _, _ = reference
    cfg = get_config(FAMILIES[family], smoke=True)
    for shape, axes in (((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))):
        grid = make_mesh(shape, axes, ["cpu"] * 8)
        for b in (1, 8):
            placed = place_caches(T.init_caches(cfg, b, 64, device="cpu"), grid, batch=b,
                                  share=False)
            per = {}
            for leaf in tree_leaves(placed):
                assert leaf.tensors[next(iter(leaf.tensors))].element_size() == 4
                for idx, t in leaf.tensors.items():
                    per[idx] = per.get(idx, 0) + t.numel() * 4
            assert sorted(per.values()) == plans[f"bytes/{family}/{'x'.join(map(str, shape))}/{b}"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_2x2_decode_matches_the_references_sharded_serve_step(reference, family):
    """The reference's weights into the port, the same tokens, batch 1 on
    (2, 2) (the sequence over the data rows): each step's greedy token
    equal, its logits within the decode gate."""
    _, arrays, toks = reference
    cfg = get_config(FAMILIES[family], smoke=True, vqt=True)
    if cfg.moe:  # as the reference's run: its dense MLA layer twice
        cfg = dataclasses.replace(cfg, stages=((cfg.stages[0][0], 2),))
    like = T.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    from test_torch_sharded_train import _flat

    params = T.params_from_numpy(tree_unflatten(
        like, [arrays[f"{family}/param/{k}"] for k in _flat(like)]), device="cpu")
    tk = torch.as_tensor(toks[family])
    got, _ = _decode(params, cfg, tk, _grid((2, 2)), 1)
    got = torch.cat(got, dim=1)
    want = torch.as_tensor(arrays[f"{family}/logits"])
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    assert float((got - want).abs().max()) <= DECODE_GATE
