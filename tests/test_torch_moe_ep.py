"""``repro_torch.models.moe.moe_apply_ep`` (the expert-parallel MoE over a
grid's model axis) against the JAX package's ``moe_apply_ep`` and against
the dense MoE, on deepseek-v2's smoke config (4 experts, top-2).

- On the host grid (1x1) in-process: the same output, aux and dropped
  assignments as the reference, with repeated token rows that force drops
  at the default capacity; the same gradients as ``jax.grad``.
- At capacity 8 nothing drops, and EP equals the dense MoE on every grid.
- Across slices the reference needs several devices, so a subprocess with
  4 forced host devices computes it once: without shared experts the
  port's outputs, aux and gradients equal it at (1, 2), (2, 2) and (1, 4).
  With a shared expert the reference adds only each model slice's share of
  it (its weights are model-sharded inside ``shard_map`` and nothing sums
  the slices), so it is off the dense function at M > 1 and the port,
  which runs the shared experts in full, is not.
- ``launch.train --mesh host`` trains deepseek-v2 through
  ``moe_apply_ep``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import params_to_numpy  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed.context import use_mesh as ref_use_mesh  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.context import use_mesh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.transformer import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRIDS = [(1, 2), (2, 2), (1, 4)]
ROUTE_TIE = 1e-5


def _cfgs(capacity_factor=1.25, n_shared=1):
    out = []
    for get in (get_config, ref_get_config):
        c = get("deepseek-v2-236b", smoke=True)
        out.append(dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor, n_shared=n_shared)))
    return out


def _params(cfg_j, seed=0):
    pj = ref_moe.moe_init(jax.random.PRNGKey(seed), cfg_j)
    return pj, params_from_numpy(params_to_numpy(pj), device="cpu")


def _x(d: int) -> np.ndarray:
    """[2, 64, d] normal tokens whose rows 10.. repeat row 0 of their
    document: 54 identical tokens a document route to the same experts,
    so at the default capacity some of their assignments must drop."""
    x = np.random.default_rng(5).standard_normal((2, 64, d)).astype(np.float32)
    x[:, 10:] = x[:, :1]
    return x


def _grid(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * int(np.prod(shape)))


def _ref_kept(pj, cfg_j, x: np.ndarray, shape) -> dict:
    """The reference's slotting (``moe.py:146-153``) replayed with its own
    router: {(row, slice): [T2·k] kept}."""
    e, (D, M) = cfg_j.moe, shape
    b, n, d = x.shape
    T_loc = b // D * n
    T2 = -(-T_loc // M)
    cap = ref_moe._ep_capacity(T2, e, e.n_experts)
    out = {}
    for r in range(D):
        xt = x[r * (b // D):(r + 1) * (b // D)].reshape(T_loc, d)
        xt = np.concatenate([xt, np.zeros((T2 * M - T_loc, d), np.float32)])
        for m in range(M):
            _, eidx, _ = ref_moe._router(pj, e, jnp.asarray(xt[m * T2:(m + 1) * T2]))
            onehot = np.eye(e.n_experts, dtype=np.int64)[np.asarray(eidx).reshape(-1)]
            pos = ((np.cumsum(onehot, 0) - onehot) * onehot).sum(1)
            out[(r, m)] = pos < cap
    return out


def _no_near_ties(pt, cfg, x: np.ndarray) -> None:
    logits = x.reshape(-1, x.shape[-1]) @ pt["router"].numpy()
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = -np.sort(-(p / p.sum(-1, keepdims=True)), -1)
    k = cfg.moe.top_k
    assert ((p[:, k - 1] - p[:, k]) > ROUTE_TIE).all(), "the fixture holds a routing near tie"


def _loss_weights(x: np.ndarray) -> np.ndarray:
    return np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)


@pytest.mark.parametrize("n_shared", [0, 1])
def test_ep_matches_the_reference_on_the_host_grid(n_shared):
    """1x1 grid, default capacity: the same output, aux and dropped
    assignments as the reference's ``moe_apply_ep`` under its host mesh."""
    cfg, cfg_j = _cfgs(n_shared=n_shared)
    pj, pt = _params(cfg_j)
    x = _x(cfg.d_model)
    _no_near_ties(pt, cfg, x)
    with ref_use_mesh(ref_host_mesh()):
        y_j, aux_j = jax.jit(lambda p, x: ref_moe.moe_apply_ep(p, cfg_j, x))(pj, jnp.asarray(x))
    moe.reset_ep_stats()
    with use_mesh(make_host_mesh("cpu")):
        y_t, aux_t = moe.moe_apply(pt, cfg, torch.tensor(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    want = _ref_kept(pj, cfg_j, x, (1, 1))
    got = {k: v.numpy() for k, v in moe.EP_STATS["kept"].items()}
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    assert (~want[(0, 0)]).sum() > 0, "the fixture must force drops"
    assert moe.EP_STATS["calls"] == 1 and moe.EP_STATS["exchange_bytes"] == 0
    # the drops make it another function than the dense one
    y_d, _ = moe.moe_apply_dense(pt, cfg, torch.tensor(x))
    assert float((y_d - y_t).abs().max()) > 1e-2


@pytest.mark.parametrize("shape", [(1, 1)] + GRIDS)
def test_ep_equals_dense_at_capacity_8(shape):
    """Capacity 8: no assignment drops, so EP is the dense function on
    every grid (the reference's ``tests/test_models.py:176``, and more
    slices)."""
    cfg, cfg_j = _cfgs(capacity_factor=8.0)
    _, pt = _params(cfg_j, seed=1)
    x = torch.tensor(_x(cfg.d_model))
    y_d, aux_d = moe.moe_apply_dense(pt, cfg, x)
    moe.reset_ep_stats()
    with use_mesh(_grid(shape)):
        y_e, aux_e = moe.moe_apply(pt, cfg, x)
    assert all(bool(k.all()) for k in moe.EP_STATS["kept"].values())
    assert len(moe.EP_STATS["kept"]) == shape[0] * shape[1]
    np.testing.assert_allclose(y_e.numpy(), y_d.numpy(), atol=2e-5, rtol=2e-5)
    if shape == (1, 1):
        np.testing.assert_allclose(float(aux_e), float(aux_d), rtol=1e-5)


REF_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.distributed.context import use_mesh
    from repro.models import moe

    data = dict(np.load(sys.argv[1]))
    x, w = jnp.asarray(data["x"]), jnp.asarray(data["w"])
    out = {}
    for ns in (0, 1):
        p = {k.split("/", 1)[1]: jnp.asarray(v) for k, v in data.items()
             if k.startswith(f"p{ns}/") and "/shared/" not in k}
        if ns:
            p["shared"] = {k.rsplit("/", 1)[1]: jnp.asarray(v) for k, v in data.items()
                           if k.startswith(f"p{ns}/shared/")}
        for cf in (1.25, 8.0):
            c = get_config("deepseek-v2-236b", smoke=True)
            cfg = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=cf, n_shared=ns))
            y_d, _ = moe.moe_apply_dense(p, cfg, x)
            for shape in ((1, 2), (2, 2), (1, 4)):
                devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
                tag = f"{ns}/{cf}/{shape[0]}x{shape[1]}"
                with use_mesh(Mesh(devs, ("data", "model"))):
                    f = jax.jit(lambda p, x: moe.moe_apply_ep(p, cfg, x))
                    y, aux = f(p, x)
                    out[f"y/{tag}"], out[f"aux/{tag}"] = np.asarray(y), np.asarray(aux)
                    out[f"dense_err/{tag}"] = np.abs(np.asarray(y) - np.asarray(y_d)).max()
                    if ns == 0 and cf == 1.25 and shape == (1, 2):
                        def loss(p, x):
                            y, aux = moe.moe_apply_ep(p, cfg, x)
                            return jnp.sum(y * w) + aux
                        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                        for k, v in gp.items():
                            out[f"grad/{k}"] = np.asarray(v)
                        out["grad/x"] = np.asarray(gx)
    np.savez(sys.argv[2], **out)
""")


@pytest.fixture(scope="module")
def reference_ep(tmp_path_factory):
    """The reference's EP on 4 forced host devices (one subprocess, ~10 s):
    outputs, aux and (at 1x2) gradients; the same weights and tokens as the
    port's side."""
    d = tmp_path_factory.mktemp("ref_ep")
    feed = {}
    params = {}
    for ns in (0, 1):
        cfg, cfg_j = _cfgs(n_shared=ns)
        pj, pt = _params(cfg_j, seed=2)
        params[ns] = pt
        for k, v in params_to_numpy(pj).items():
            if isinstance(v, dict):
                feed.update({f"p{ns}/shared/{kk}": vv for kk, vv in v.items()})
            else:
                feed[f"p{ns}/{k}"] = v
    x = _x(cfg.d_model)
    feed.update(x=x, w=_loss_weights(x))
    np.savez(d / "in.npz", **feed)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", REF_EP, str(d / "in.npz"), str(d / "out.npz")],
                         capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(d / "out.npz")), params, x


def _port_ep(pt, cfg, x, shape):
    with use_mesh(_grid(shape)):
        return moe.moe_apply(pt, cfg, torch.tensor(x))


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("shape", GRIDS)
def test_ep_matches_the_reference_across_slices(reference_ep, shape, cf):
    """No shared experts: outputs and aux equal the reference's EP on a
    grid of 2 or 4 slices, with drops at 1.25 and none at 8."""
    ref, params, x = reference_ep
    cfg, _ = _cfgs(capacity_factor=cf, n_shared=0)
    _no_near_ties(params[0], cfg, x)
    y, aux = _port_ep(params[0], cfg, x, shape)
    tag = f"0/{cf}/{shape[0]}x{shape[1]}"
    np.testing.assert_allclose(y.numpy(), ref[f"y/{tag}"], atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(aux), float(ref[f"aux/{tag}"]), rtol=1e-5)
    dropped = sum(int((~k).sum()) for k in moe.EP_STATS["kept"].values())
    assert (dropped > 0) == (cf == 1.25)


@pytest.mark.parametrize("shape", GRIDS)
def test_reference_drops_the_shared_experts_share_and_the_port_does_not(reference_ep, shape):
    """Capacity 8 with a shared expert: the reference's EP is off its own
    dense MoE at M > 1 (it sums only each slice's share of the shared
    SwiGLU); the port's EP is the dense function."""
    ref, params, x = reference_ep
    cfg, _ = _cfgs(capacity_factor=8.0, n_shared=1)
    tag = f"1/8.0/{shape[0]}x{shape[1]}"
    assert float(ref[f"dense_err/{tag}"]) > 0.1
    assert float(ref["dense_err/0/8.0/" + f"{shape[0]}x{shape[1]}"]) < 2e-5
    y, _ = _port_ep(params[1], cfg, x, shape)
    y_d, _ = moe.moe_apply_dense(params[1], cfg, torch.tensor(x))
    np.testing.assert_allclose(y.numpy(), y_d.numpy(), atol=2e-5, rtol=2e-5)


def _port_grads(pt, cfg, x, w, shape):
    p = {k: (v.clone().requires_grad_() if torch.is_tensor(v) else
             {kk: vv.clone().requires_grad_() for kk, vv in v.items()})
         for k, v in pt.items()}
    xt = torch.tensor(x, requires_grad=True)
    with use_mesh(_grid(shape)):
        y, aux = moe.moe_apply(p, cfg, xt)
    (torch.sum(y * torch.tensor(w)) + aux).backward()
    grads = {k: v.grad.numpy() for k, v in p.items() if torch.is_tensor(v)}
    grads["x"] = xt.grad.numpy()
    return grads


def _assert_grads_close(got: dict, want: dict, rel=1e-5) -> None:
    """Each leaf within ``rel`` of its max |.|, as the port's other
    gradient tests (``tests/test_torch_training.py``)."""
    assert set(got) == set(want)
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-12)
        err = float(np.abs(got[k] - w).max())
        assert err <= rel * scale, f"{k}: {err} of max {scale}"


def test_ep_gradients_match_jax_grad_on_the_host_grid():
    """1x1 grid with drops and a shared expert: the gradient of
    sum(y · w) + aux in every expert leaf, the router and x."""
    cfg, cfg_j = _cfgs(n_shared=1)
    pj, pt = _params(cfg_j, seed=3)
    x = _x(cfg.d_model)
    w = _loss_weights(x)

    def loss(p, x):
        y, aux = ref_moe.moe_apply_ep(p, cfg_j, x)
        return jnp.sum(y * jnp.asarray(w)) + aux

    with ref_use_mesh(ref_host_mesh()):
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(pj, jnp.asarray(x))
    want = {k: np.asarray(v) for k, v in gp.items() if k != "shared"}
    want["x"] = np.asarray(gx)
    _assert_grads_close(_port_grads(pt, cfg, x, w, (1, 1)), want)


def test_ep_gradients_match_jax_grad_across_two_slices(reference_ep):
    ref, params, x = reference_ep
    cfg, _ = _cfgs(n_shared=0)
    want = {k.split("/", 1)[1]: v for k, v in ref.items() if k.startswith("grad/")}
    assert sorted(want) == ["router", "w_down", "w_gate", "w_up", "x"]
    _assert_grads_close(_port_grads(params[0], cfg, x, _loss_weights(x), (1, 2)), want)


def test_placed_experts_run_where_they_sit():
    """``place_experts`` on a 2x2 grid: each model index's slices, no whole
    expert leaf; EP over the placement is bitwise EP over the whole
    leaves; the exchanges' byte count is the reference's two all_to_alls."""
    cfg, cfg_j = _cfgs()
    _, pt = _params(cfg_j, seed=4)
    grid = _grid((2, 2))
    placed = moe.place_experts(pt, grid)
    assert not {"w_gate", "w_up", "w_down"} & set(placed)
    slices = placed["placed"].experts
    assert sorted(m for m, _ in slices) == [0, 1]
    for (m, _), w in slices.items():
        assert torch.equal(w["w_up"], pt["w_up"][2 * m:2 * m + 2])
        assert w["w_up"].data_ptr() != pt["w_up"].data_ptr()
    x = torch.tensor(_x(cfg.d_model))
    moe.reset_ep_stats()
    with use_mesh(grid):
        y_p, aux_p = moe.moe_apply(placed, cfg, x)
        y_w, aux_w = moe.moe_apply(pt, cfg, x)
    assert torch.equal(y_p, y_w) and torch.equal(aux_p, aux_w)
    T2 = 64 // 2
    cap = moe._ep_capacity(T2, cfg.moe, 4)
    block = 2 * cap * cfg.d_model * 4
    # 2 calls x 2 data rows x (M·(M−1) blocks out + as many back), M = 2
    assert moe.EP_STATS["exchange_bytes"] == 2 * 2 * (2 * 2 * 1) * block
    assert moe.EP_STATS["device_copy_bytes"] == 0  # every entry is the one CPU
    with use_mesh(_grid((1, 4))), pytest.raises(ValueError, match="placed on"):
        moe.moe_apply(placed, cfg, x)


def test_ep_raises_as_the_reference():
    cfg, cfg_j = _cfgs()
    _, pt = _params(cfg_j)
    x = torch.tensor(_x(cfg.d_model))
    with use_mesh(make_mesh((1, 3), ("data", "model"), ["cpu"] * 3)), \
            pytest.raises(ValueError, match="experts 4 must divide model axis 3"):
        moe.moe_apply(pt, cfg, x)
    with use_mesh(make_mesh((4, 1), ("data", "model"), ["cpu"] * 4)), \
            pytest.raises(ValueError, match="batch 2 does not split over the 4 data rows"):
        moe.moe_apply(pt, cfg, x)
    assert moe.moe_apply(pt, cfg, x)[0].shape == x.shape  # no grid: the dense path


def test_launch_train_host_mesh_runs_the_moe_through_ep(capsys):
    """``launch.train --arch deepseek-v2-236b --smoke --mesh host``: each
    step's MoE layer goes through ``moe_apply_ep`` on the 1x1 grid of the
    device (forward and its remat recompute)."""
    from repro_torch.distributed.context import get_ctx
    from repro_torch.launch import train

    grids = []
    ep = moe.moe_apply_ep

    def counted(params, cfg, x):
        grids.append(get_ctx().mesh.shape)
        return ep(params, cfg, x)

    moe.moe_apply_ep = counted
    try:
        train.main(["--arch", "deepseek-v2-236b", "--smoke", "--device", "cpu", "--steps", "2",
                    "--batch", "2", "--seq", "16", "--log-every", "1"])
    finally:
        moe.moe_apply_ep = ep
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("step ") for line in lines) == 2
    n_moe = sum(layer.ffn == "moe" for layer in get_config(
        "deepseek-v2-236b", smoke=True).layer_list())
    assert n_moe >= 1 and len(grids) >= 2 * n_moe
    assert all(g == {"data": 1, "model": 1} for g in grids)


def test_remat_recompute_sees_the_forward_grid():
    """A train forward under a grid whose backward runs outside it (as on
    the card, where autograd recomputes checkpointed layers in its device
    thread, which has no context): each layer body is recomputed under the
    grid of its forward, so the MoE recomputes through EP with the same
    saved tensors, and the gradients equal a backward inside the grid."""
    import threading

    from repro_torch.distributed.context import get_ctx, with_ctx
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.training.losses import next_token_loss

    cfg = get_config("deepseek-v2-236b", smoke=True)
    grid = _grid((1, 2))
    seen = []
    with use_mesh(grid) as ctx:
        t = threading.Thread(target=with_ctx(ctx, lambda: seen.append(get_ctx())))
        t.start(), t.join()
    assert seen == [ctx] and get_ctx() is None

    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
    grads = []
    for inside in (True, False):
        params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        leaf = params["stages"][1][0]["ffn"]["w_up"].requires_grad_()
        with use_mesh(grid):
            logits, aux = forward(params, cfg, tokens, train=True, remat=True)
            loss = next_token_loss(logits[:, :-1], tokens[:, 1:]) + aux["aux_loss"]
            if inside:
                loss.backward()
        if not inside:
            loss.backward()
        grads.append(leaf.grad.clone())
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0
