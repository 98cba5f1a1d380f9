"""The port's example modules (``repro_torch.examples``) run end to end on
the CPU with ``--device cpu`` and pass their own checks: token parity with
the edit-replayed references and a suggestion for every subscription
(``incremental_serving``), the op counts and the edited tokens
(``quickstart``), each family's decode against its forward
(``multiarch_decode``, deepseek-v2's MLA and MoE among them)."""
import importlib

import pytest

torch = pytest.importorskip("torch")


@pytest.mark.parametrize("name,expect", [
    ("quickstart", "cumulative speedup so far"),
    ("incremental_serving", "token buffers match the edit-replayed references"),
])
def test_example_runs_on_the_cpu(capsys, name, expect):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert expect in out
    assert "X cheaper than re-running" in out or "X less than recompute" in out


@pytest.mark.parametrize("vqt", [False, True])
def test_multiarch_decode_runs_on_the_cpu(capsys, vqt):
    from repro_torch.examples import multiarch_decode

    multiarch_decode.main(["--device", "cpu"] + (["--vqt"] if vqt else []))
    out = capsys.readouterr().out
    for arch in ("stablelm-1.6b", "gemma3-12b", "deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b",
                 "musicgen-large"):
        assert f"{arch}" in out and out.count("decode matches the forward") == 6
    assert "not ported" not in out and "skipped" not in out
