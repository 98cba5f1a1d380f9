"""``repro_torch.common.compile_cache``: the port's kernel build cache
switch, the four tests of the reference's ``tests/test_compile_cache.py``
on the port — off by default, the environment variable and an explicit
directory turn it on (pointing ``kernels._build.BUILD_ROOT`` there),
idempotent, and the ``BatchServer`` flag."""
import os
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.common import compile_cache  # noqa: E402
from repro_torch.common.compile_cache import (  # noqa: E402
    ENV_VAR, enable_persistent_compilation_cache,
)
from repro_torch.kernels import _build  # noqa: E402


@pytest.fixture(autouse=True)
def _isolate(monkeypatch):
    """A clean module state, no ambient variable, and the build root put
    back afterwards."""
    monkeypatch.delenv(ENV_VAR, raising=False)
    monkeypatch.setattr(compile_cache, "_enabled_dir", None)
    monkeypatch.setattr(_build, "BUILD_ROOT", _build.BUILD_ROOT)
    yield


def test_off_without_dir_or_env():
    before = _build.BUILD_ROOT
    assert enable_persistent_compilation_cache() is None
    assert _build.BUILD_ROOT == before
    assert before.parts[-2:] == ("build", "repro_torch_kernels")


def test_env_var_activates(tmp_path, monkeypatch):
    target = tmp_path / "kcc-env"
    monkeypatch.setenv(ENV_VAR, str(target))
    got = enable_persistent_compilation_cache()
    assert got == str(target)
    assert os.path.isdir(got)
    assert _build.BUILD_ROOT == Path(got)
    assert _build.build_dir().parent == Path(got)


def test_explicit_dir_wins_and_is_idempotent(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "ignored"))
    target = tmp_path / "kcc-explicit"
    got = enable_persistent_compilation_cache(str(target))
    assert got == str(target)
    assert enable_persistent_compilation_cache(str(target)) == got
    assert not (tmp_path / "ignored").exists()
    assert _build.BUILD_ROOT == Path(got)


def test_batch_server_flag(tmp_path):
    """The BatchServer keyword threads through without the variable."""
    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.batch_server import BatchServer

    cfg = smoke_config(vqt=True)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    target = tmp_path / "kcc-srv"
    srv = BatchServer(params, cfg, edit_capacity=4, row_capacity=16, max_batch=2,
                      min_doc_capacity=16, compilation_cache_dir=str(target), device="cpu")
    assert srv.compilation_cache_dir == str(target)
    assert os.path.isdir(target)
    srv2 = BatchServer(params, cfg, edit_capacity=4, row_capacity=16, max_batch=2,
                       min_doc_capacity=16, device="cpu")
    assert srv2.compilation_cache_dir is None
