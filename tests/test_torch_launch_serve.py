"""``python -m repro_torch.launch.serve`` on the CPU: the tiered, async and
fleet demos run end to end with ``--smoke --device cpu``, and the modes
that are not ported yet raise with the ROADMAP item that owns them."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402


def _run(capsys, *argv):
    serve.main(["--smoke", "--device", "cpu", *argv])
    return capsys.readouterr().out


def test_tiered_demo_evicts_and_rehydrates(capsys):
    out = _run(capsys, "--tiered", "--docs", "4", "--budget-docs", "2",
               "--doc-len", "24", "--edits", "8")
    totals = next(line for line in out.splitlines() if line.startswith("totals:"))
    fields = dict(kv.split("=") for kv in totals.split()[1:])
    assert int(fields["edits"]) == 8
    assert int(fields["evictions"]) > 0 and int(fields["rehydrations"]) > 0
    assert "bytes hot/warm/cold/suggest = 0/0/0/0" in out


def test_async_fleet_demo_serves_every_client(capsys):
    out = _run(capsys, "--async-fleet", "--docs", "3", "--doc-len", "24",
               "--edits", "6", "--delay-ms", "4")
    assert out.count("suggestion [") == 3 * 2  # every client's every burst
    assert "failed=0" in out
    edit = next(line for line in out.splitlines() if line.startswith("edit "))
    assert "n=18" in edit


def test_fleet_demo_migrates(capsys):
    out = _run(capsys, "--fleet", "2", "--docs", "3", "--doc-len", "24",
               "--edits", "6", "--delay-ms", "3")
    assert "migrated" in out
    table = dict(re.split(r"\s{2,}", line.strip(), maxsplit=1)
                 for line in out.splitlines() if line.startswith("  "))
    assert table["migrations"] == "1" and table["replicas alive"] == "2"
    assert table["edits applied"] == "6" and table["documents open"] == "3"


@pytest.mark.parametrize("argv,item", [([], "item 7"),
                                       (["--tiered", "--ckpt", "x.npz"], "item 10")])
def test_modes_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        serve.main(["--smoke", "--device", "cpu", *argv])
