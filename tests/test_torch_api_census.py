"""The port's public surface against the reference's, read from the sources
with ``ast``: neither package is imported, so this runs in a second.

- Every module of ``src/repro/`` has a port file at the same relative path
  under ``src/repro_torch/``, but for the four Pallas sources, whose
  kernels are CUDA in ``src/repro_torch/csrc/`` behind an ``ops`` entry.
- Every ``pl.pallas_call`` site of the reference is one of the eight
  entries of ``PALLAS``, so a new Pallas entry fails here.
- Every public top-level function and class, and every public method of a
  public class, has a same-named counterpart in the port's module (for a
  method, a method or a class-level field), and the counterpart accepts
  every keyword-only parameter of the reference's (a class's: those of its
  ``__init__``).
- What does not hold by design sits in ``EXEMPT``, one reason a line; an
  exemption that the sources no longer need fails too.
"""
from __future__ import annotations

import ast
import functools
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"
CSRC = PORT / "csrc"

# (Pallas source, function that calls pl.pallas_call) -> (CUDA source in
# csrc/, the port's ops module, its entry that launches the kernel)
PALLAS = {
    ("kernels/fused_step/fused_step.py", "fused_step_kernel"):
        ("fused_step.cu", "kernels/fused_step/ops.py", "fused_patch_assign"),
    ("kernels/fused_step/fused_step.py", "fused_step_kernel_batched"):
        ("fused_step.cu", "kernels/fused_step/ops.py", "fused_patch_assign_batched"),
    ("kernels/fused_step/fused_step.py", "delta_gate_kernel"):
        ("fused_step.cu", "kernels/fused_step/ops.py", "delta_gate"),
    ("kernels/vq_assign/vq_assign.py", "vq_assign_kernel"):
        ("vq_assign.cu", "kernels/vq_assign/ops.py", "vq_assign"),
    ("kernels/vq_assign/vq_assign.py", "vq_assign_kernel_batched"):
        ("vq_assign.cu", "kernels/vq_assign/ops.py", "vq_assign_batched"),
    ("kernels/gated_attention/gated_attention.py", "gated_attention_kernel"):
        ("gated_attention.cu", "kernels/gated_attention/ops.py", "gated_attention"),
    ("kernels/incr_patch/incr_patch.py", "incr_patch_kernel"):
        ("incr_patch.cu", "kernels/incr_patch/ops.py", "incr_patch"),
    ("kernels/incr_patch/incr_patch.py", "incr_patch_kernel_batched"):
        ("incr_patch.cu", "kernels/incr_patch/ops.py", "incr_patch_batched"),
}

_TILE = "a Pallas tile size; the CUDA kernel picks its own launch shape"
_NOISE = "torch's RNG cannot give jax.random's bits: the port takes the noise itself"

# "module:Name" or "module:Class.method" for a name the port lacks;
# "module:function(param)" for a keyword-only parameter it does not take,
# "module:function(param->replacement)" where it takes ``replacement``.
EXEMPT = {
    "common/pytree.py:static_field": "JAX pytree machinery; the port's trees are dicts",
    "common/pytree.py:pytree_dataclass": "JAX pytree machinery; the port's trees are dicts",
    "distributed/context.py:shard_map_compat": "JAX shard_map shim; the grid runs models/sharded.py",
    "launch/dryrun.py:lower_full": "XLA lowering; the port's dry run executes on meta tensors",
    "launch/dryrun.py:lower_roofline": "XLA lowering; the port's dry run executes on meta tensors",
    "models/attention.py:constrain_qkv": "a JAX sharding constraint; the grid lays out heads itself",
    "core/vq.py:VQParams": "params are dicts: VQParams is {'codebook': ...}",
    "core/incremental.py:LayerWeights": "params are dicts: the engine reads the layer's dict",
    "serving/batch_server.py:BatchStats.kernel_launches_per_edit":
        "the kernel wrappers' LAUNCHES counters replace it",
    "kernels/fused_step/ops.py:fused_patch_assign(block_r)": _TILE,
    "kernels/fused_step/ops.py:fused_patch_assign_batched(block_r)": _TILE,
    "kernels/fused_step/ops.py:delta_gate(block_r)": _TILE,
    "kernels/gated_attention/ops.py:gated_attention(block_q)": _TILE,
    "kernels/gated_attention/ops.py:gated_attention(block_k)": _TILE,
    "kernels/incr_patch/ops.py:incr_patch(block_r)": _TILE,
    "kernels/incr_patch/ops.py:incr_patch_batched(block_r)": _TILE,
    "kernels/vq_assign/ops.py:vq_assign(block_n)": _TILE,
    "kernels/vq_assign/ops.py:vq_assign_batched(block_n)": _TILE,
    "models/attention.py:attn_apply(vq_rng->vq_noise)": _NOISE,
    "models/hymba.py:hymba_apply(vq_rng->vq_noise)": _NOISE,
    "models/mla.py:mla_apply(vq_rng->vq_noise)": _NOISE,
    "models/flash.py:streaming_attention(remat)": "jax.checkpoint of the scan body; torch streams without it",
    "training/step.py:make_train_step(donate)": "XLA buffer donation; torch updates in place",
    "launch/mesh.py:make_serving_mesh(axis)": "a named JAX mesh axis; the serving mesh is a device list",
    "serving/batch_engine.py:BatchedJitEngine(batch_axis)": "a named JAX mesh axis; the mesh is a device list",
    "serving/batch_server.py:BatchServer(batch_axis)": "a named JAX mesh axis; the mesh is a device list",
}

_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _surface(path: Path) -> dict:
    """{"f": FunctionDef, "C": ClassDef, "C.m": FunctionDef, "C.__init__":
    ...}: the module's public names, its public classes' public methods and
    their constructors."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, _FUNCS + (ast.ClassDef,)) and _public(node.name):
            out[node.name] = node
        if isinstance(node, ast.ClassDef) and _public(node.name):
            for sub in node.body:
                if isinstance(sub, _FUNCS) and (_public(sub.name) or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _bound(path: Path) -> set:
    """Names a port module binds: its defs and classes, top-level
    assignments and imports, and each class's methods and fields as
    "C.name"."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, _FUNCS + (ast.ClassDef,)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, _FUNCS):
                    out.add(f"{node.name}.{sub.name}")
                elif isinstance(sub, ast.AnnAssign) and isinstance(sub.target, ast.Name):
                    out.add(f"{node.name}.{sub.target.id}")
                elif isinstance(sub, ast.Assign):
                    out.update(f"{node.name}.{t.id}" for t in sub.targets
                               if isinstance(t, ast.Name))
    return out


def _params(fn) -> tuple[set, bool]:
    """(names a function takes by keyword, whether it takes **kwargs)."""
    a = fn.args
    return {x.arg for x in a.args + a.kwonlyargs}, a.kwarg is not None


def _pallas_sources() -> set:
    return {src for src, _ in PALLAS}


def _missing_names() -> set:
    """"module:name" of every public reference name the port lacks."""
    out = set()
    for rel in _modules(REF):
        if rel in _pallas_sources() or not (PORT / rel).exists():
            continue
        bound = _bound(PORT / rel)
        out.update(f"{rel}:{name}" for name in _surface(REF / rel)
                   if not name.endswith(".__init__") and name not in bound)
    return out


def _missing_keywords() -> dict:
    """"module:function(param)" of every keyword-only parameter a reference
    function takes and its port counterpart does not -> the counterpart's
    keyword names."""
    out = {}
    for rel in _modules(REF):
        if rel in _pallas_sources() or not (PORT / rel).exists():
            continue
        port = _surface(PORT / rel)
        for name, node in _surface(REF / rel).items():
            if not isinstance(node, _FUNCS) or name not in port:
                continue
            takes, any_kw = _params(port[name])
            fn = name.removesuffix(".__init__")
            out.update({f"{rel}:{fn}({p.arg})": takes for p in node.args.kwonlyargs
                        if p.arg not in takes and not any_kw})
    return out


def _name_exemptions() -> set:
    return {k for k in EXEMPT if "(" not in k}


def _keyword_exemptions() -> dict:
    """"module:function(param)" -> its replacement's name, or None."""
    out = {}
    for key in EXEMPT:
        if "(" in key:
            head, inner = key[:-1].split("(")
            param, _, repl = inner.partition("->")
            out[f"{head}({param})"] = repl or None
    return out


def test_every_reference_module_has_a_port_file():
    missing = [rel for rel in _modules(REF)
               if rel not in _pallas_sources() and not (PORT / rel).exists()]
    assert not missing, f"reference modules with no port file: {missing}"
    assert all(not (PORT / rel).exists() for rel in _pallas_sources())


def test_pallas_sources_map_to_a_cuda_kernel_and_an_ops_entry():
    for (src, fn), (cu, ops, entry) in PALLAS.items():
        assert (REF / src).exists(), src
        assert fn in _surface(REF / src), f"{src} has no {fn}"
        assert (CSRC / cu).exists(), f"{fn}: no csrc/{cu}"
        assert entry in _surface(PORT / ops), f"{fn}: {ops} has no {entry}"
        # the ops module binds the kernel from the CUDA source's library
        binds = {node.args[0].value for node in ast.walk(_tree(PORT / ops))
                 if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "bind"
                 and node.args and isinstance(node.args[0], ast.Constant)}
        assert Path(cu).stem in binds, f"{ops} binds no kernel of csrc/{cu}"


def test_every_pallas_call_site_is_a_listed_entry():
    sites = []
    for rel in _modules(REF):
        for top in _tree(REF / rel).body:
            for node in ast.walk(top):
                if isinstance(node, ast.Call) and (
                        getattr(node.func, "attr", None) == "pallas_call"
                        or getattr(node.func, "id", None) == "pallas_call"):
                    sites.append((rel, getattr(top, "name", f"<line {node.lineno}>")))
    assert sorted(sites) == sorted(PALLAS), (
        f"pl.pallas_call sites {sorted(set(sites) ^ set(PALLAS))} differ from PALLAS; "
        f"{len(sites)} sites for {len(PALLAS)} entries")


def test_every_public_reference_name_has_a_counterpart():
    missing = _missing_names() - _name_exemptions()
    assert not missing, f"reference names with no port counterpart: {sorted(missing)}"


def test_every_keyword_parameter_is_accepted():
    missing = set(_missing_keywords()) - set(_keyword_exemptions())
    assert not missing, f"keyword parameters the port does not take: {sorted(missing)}"


def test_exemptions_are_needed():
    """An exemption names a gap the sources still have: the reference's
    name or keyword exists and the port lacks it; a renamed keyword's
    replacement is taken instead."""
    stale = sorted(_name_exemptions() - _missing_names())
    gaps = _missing_keywords()
    for key, repl in _keyword_exemptions().items():
        if key not in gaps or (repl is not None and repl not in gaps[key]):
            stale.append(key)
    assert not stale, f"exemptions no gap needs: {stale}"
    assert all(reason.strip() for reason in EXEMPT.values())


def test_the_census_imports_neither_package():
    names = set()
    for node in ast.walk(_tree(Path(__file__))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"repro", "repro_torch", "jax", "torch"}, names
