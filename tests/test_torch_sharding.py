"""``repro_torch.launch.{mesh,sharding}`` and ``repro_torch.distributed.context``
against the JAX package's: the specs of ``param_shardings``,
``batch_shardings`` and ``cache_shardings`` leaf by leaf on every arch's
smoke trees, on the host grid in-process and on the production grids
(16x16 and 2x16x16) against a reference subprocess with 512 forced host
devices; ``NamedSharding.blocks`` against jax's ``devices_indices_map``;
``ShardingCtx.spec`` over a table of logical axes; ``constrain``;
``make_production_mesh``'s device count."""
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.common.pytree import path_names as ref_path_names  # noqa: E402
from repro.configs import all_arch_names  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import context as ref_context  # noqa: E402
from repro.launch import sharding as ref_sharding  # noqa: E402
from repro.launch.mesh import make_host_mesh as ref_host_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.training import train_state_init as ref_state_init  # noqa: E402
from repro_torch.common.pytree import path_names, tree_flatten_with_path  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import context  # noqa: E402
from repro_torch.distributed.context import NamedSharding, PartitionSpec as P  # noqa: E402
from repro_torch.launch import mesh, sharding  # noqa: E402
from repro_torch.models import transformer as PT  # noqa: E402
from repro_torch.training import train_state_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GRIDS = {"16x16": dict(multi_pod=False), "2x16x16": dict(multi_pod=True)}
BATCHES = ((32, 64), (1, 64))  # (batch, seq): batch over data, and batch-1 seq-sharded


def _spec(s) -> tuple:
    """A spec (the port's, jax's, or its JSON form) as a plain tuple."""
    return tuple(tuple(e) if isinstance(e, list) else e for e in tuple(s))


def _specs(tree) -> list:
    """[(path, spec)] of a port NamedSharding tree."""
    out = []
    for path, leaf in tree_flatten_with_path(tree):
        assert isinstance(leaf, NamedSharding)
        out.append(("/".join(path_names(path)), _spec(leaf.spec)))
    return out


def _ref_specs(tree) -> list:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
    return [("/".join(ref_path_names(p)), _spec(s.spec)) for p, s in flat]


def _port_trees(arch: str, batch: int, seq: int):
    cfg = get_config(arch, smoke=True)
    state = train_state_init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    caches = PT.init_caches(cfg, batch, seq, device="cpu")
    return state, {"tokens": torch.zeros((batch, seq), dtype=torch.int32)}, caches


def _ref_trees(arch: str, batch: int, seq: int):
    cfg = ref_get_config(arch, smoke=True)
    state = jax.eval_shape(lambda: ref_state_init(jax.random.PRNGKey(0), cfg))
    caches = jax.eval_shape(lambda: RT.init_caches(cfg, batch, seq))
    return state, {"tokens": jax.ShapeDtypeStruct((batch, seq), np.int32)}, caches


@pytest.mark.parametrize("arch", all_arch_names())
def test_host_grid_specs_equal_the_reference(arch):
    grid, ref_mesh = mesh.make_host_mesh("cpu"), ref_host_mesh()
    state, batch, caches = _port_trees(arch, 2, 32)
    r_state, r_batch, r_caches = _ref_trees(arch, 2, 32)
    assert _specs(sharding.param_shardings(state, grid)) == _ref_specs(
        ref_sharding.param_shardings(r_state, ref_mesh))
    assert _specs(sharding.batch_shardings(batch, grid)) == _ref_specs(
        ref_sharding.batch_shardings(r_batch, ref_mesh))
    assert _specs(sharding.cache_shardings(caches, grid, batch=2)) == _ref_specs(
        ref_sharding.cache_shardings(r_caches, ref_mesh, batch=2))


REF_SPECS = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.common.pytree import path_names
    from repro.configs import all_arch_names, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.sharding import (batch_shardings, cache_shardings, param_shardings,
                                       serving_batch_sharding)
    from repro.models import transformer as T
    from repro.training import train_state_init

    def specs(tree):
        flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: hasattr(x, "spec"))[0]
        return [["/".join(path_names(p)), list(s.spec)] for p, s in flat]

    BLOCKS = json.loads(sys.argv[1])
    out = {}
    for name, multi in (("16x16", False), ("2x16x16", True)):
        mesh = make_production_mesh(multi_pod=multi)
        pos = {d: idx for idx, d in np.ndenumerate(mesh.devices)}
        res = {"archs": {}, "blocks": [], "serving": list(serving_batch_sharding(mesh).spec)}
        for arch in all_arch_names():
            cfg = get_config(arch, smoke=True)
            st = jax.eval_shape(lambda: train_state_init(jax.random.PRNGKey(0), cfg))
            a = {"params": specs(param_shardings(st, mesh))}
            for b, n in BLOCKS["batches"]:
                caches = jax.eval_shape(lambda: T.init_caches(cfg, b, n))
                tok = {"tokens": jax.ShapeDtypeStruct((b, n), np.int32)}
                a[f"batch{b}"] = specs(batch_shardings(tok, mesh))
                a[f"batch{b}_seq"] = specs(batch_shardings(tok, mesh, seq_sharded=True))
                a[f"cache{b}"] = specs(cache_shardings(caches, mesh, batch=b))
            res["archs"][arch] = a
        for spec, shape in BLOCKS["blocks"]:
            spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            axes = {a for e in spec if e for a in (e if isinstance(e, tuple) else (e,))}
            if not axes <= set(mesh.axis_names):
                res["blocks"].append(None)
                continue
            m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
            res["blocks"].append(sorted(
                [list(map(int, pos[d])), [[s.start or 0, shape[i] if s.stop is None else s.stop]
                                          for i, s in enumerate(sl)]]
                for d, sl in m.items()))
        out[name] = res
    print(json.dumps(out))
""")

BLOCK_CASES = [
    [["model", None, None], [160, 8, 4]],
    [[["pod", "data"], None], [64, 8]],
    [["data", None], [32, 4]],
    [[None, "model"], [6, 32]],
]


@pytest.fixture(scope="module")
def reference_grid_specs():
    """The reference's specs on both production meshes, from one
    subprocess with 512 forced host devices (~5 s)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    arg = json.dumps({"batches": BATCHES, "blocks": BLOCK_CASES})
    out = subprocess.run([sys.executable, "-c", REF_SPECS, arg], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _json_specs(pairs) -> list:
    return [(p, _spec(s)) for p, s in pairs]


@pytest.mark.parametrize("grid_name", list(GRIDS))
@pytest.mark.parametrize("arch", all_arch_names())
def test_production_grid_specs_equal_the_reference(reference_grid_specs, grid_name, arch):
    grid = mesh.make_production_mesh(**GRIDS[grid_name], devices=["cpu"] * 512)
    want = reference_grid_specs[grid_name]["archs"][arch]
    state, _, _ = _port_trees(arch, 1, 64)
    assert _specs(sharding.param_shardings(state, grid)) == _json_specs(want["params"])
    for b, n in BATCHES:
        _, batch, caches = _port_trees(arch, b, n)
        assert _specs(sharding.batch_shardings(batch, grid)) == _json_specs(want[f"batch{b}"])
        assert _specs(sharding.batch_shardings(batch, grid, seq_sharded=True)) == _json_specs(
            want[f"batch{b}_seq"])
        assert _specs(sharding.cache_shardings(caches, grid, batch=b)) == _json_specs(
            want[f"cache{b}"])


@pytest.mark.parametrize("grid_name", list(GRIDS))
def test_blocks_equal_jax_devices_indices_map(reference_grid_specs, grid_name):
    """The plan's blocks: grid entry -> slices, as jax places them."""
    grid = mesh.make_production_mesh(**GRIDS[grid_name], devices=["cpu"] * 512)
    ref = reference_grid_specs[grid_name]
    assert _spec(sharding.serving_batch_sharding(grid).spec) == _spec(ref["serving"])
    assert sum(w is not None for w in ref["blocks"]) == (3 if grid_name == "16x16" else 4)
    for (spec, shape), want in zip(BLOCK_CASES, ref["blocks"]):
        if want is None:  # names the pod axis, which the 16x16 grid lacks
            continue
        got = NamedSharding(grid, P(*_spec(spec))).blocks(shape)
        got = sorted([list(idx), [[s.start, s.stop] for s in sl]] for idx, sl in got.items())
        assert got == want, spec


LOGICAL = [
    (("batch", None, "model"), (32, 8, 64)),
    (("batch", "seq", None), (1, 4096, 64)),
    (("batch", "seq", None), (32, 4096, 64)),
    (("seq_model", None), (48, 7)),
    (("model", "model"), (32, 32)),
    (("batch", "model"), (3, 25)),
    ((None, "seq", "model"), (2, 64, 16)),
]


@pytest.mark.parametrize("shape", [(1, 1), (16, 16), (2, 16, 16), (4, 2)])
@pytest.mark.parametrize("axes,dims", LOGICAL)
def test_ctx_spec_equals_the_reference(shape, axes, dims):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    fake = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    grid = mesh.make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))
    for d in (dims, None):
        want = ref_context.ShardingCtx(fake).spec(*axes, dims=d)
        got = context.ShardingCtx(grid).spec(*axes, dims=d)
        assert got == tuple(want) and isinstance(got, P)


def test_constrain_is_an_identity_that_checks_rank():
    x = torch.arange(6.0).reshape(2, 3)
    assert context.constrain(x, "batch") is x  # no context: no check, as the reference
    with context.use_mesh(mesh.make_host_mesh("cpu")) as ctx:
        assert context.get_ctx() is ctx
        assert context.constrain(x, "batch", "model") is x
        with pytest.raises(ValueError, match="rank-2"):
            context.constrain(x, "batch")
    assert context.get_ctx() is None


@pytest.mark.parametrize("multi_pod,need", [(False, 256), (True, 512)])
def test_production_mesh_raises_with_fewer_devices(multi_pod, need):
    with pytest.raises(ValueError, match=f"needs {need} devices, but only 10"):
        mesh.make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * 10)
    grid = mesh.make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * need)
    assert grid.devices.size == need and list(grid.shape.values())[-2:] == [16, 16]
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="but only 0 are visible"):
            mesh.make_production_mesh(multi_pod=multi_pod)
