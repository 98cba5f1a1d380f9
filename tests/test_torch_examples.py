"""The port's example modules (``repro_torch.examples``) run end to end on
the CPU with ``--device cpu`` and pass their own checks: token parity with
the edit-replayed references and a suggestion for every subscription
(``incremental_serving``), the op counts and the edited tokens
(``quickstart``)."""
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
