"""The port stands alone: no module of ``src/repro_torch/``, nor
``chip_smoke.py`` or the kernel timing tool, imports jax, jaxlib or the JAX
package ``repro``, and the port's entry points default to the GPU without
falling back to the CPU."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tools" / "time_bwd_variants.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_nothing_of_jax(path):
    bad = FORBIDDEN & set(_imported_roots(ast.parse(path.read_text())))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_server_without_device_does_not_run_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_server import BatchServer

    cfg = smoke_config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        BatchServer(params, cfg)


@pytest.mark.parametrize("entry", ["IncrementalServer", "IncrementalEngine"])
def test_op_counting_engine_without_device_does_not_run_on_cpu(entry):
    """The op-counting server and its engine default to the card too."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.core.incremental import IncrementalEngine
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import IncrementalServer

    cfg = smoke_config()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    cls = {"IncrementalServer": IncrementalServer,
           "IncrementalEngine": IncrementalEngine}[entry]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        cls(params, cfg)
