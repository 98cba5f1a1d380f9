"""``python -m repro_torch.launch.serve`` on the CPU: the default
single-document op-count mode prints the reference's lines, the tiered,
async and fleet demos run end to end with ``--smoke --device cpu``, and
``launch.train``'s production grids raise naming the devices they need. ``--ckpt`` is held in
``tests/test_torch_pytree_checkpoint.py``."""
import argparse
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


def test_single_document_mode_prints_the_references_lines(capsys):
    """``run_single`` of both packages on the same smoke weights (the
    reference's at PRNGKey(1), the port's their numpy copy), ``--doc-len 32
    --edits 5``: every printed line is equal — the document, the edits,
    their op counts, the dense costs, the ratios and the totals."""
    from _torch_parity import smoke_params
    from repro.launch import serve as ref_serve

    from repro_torch.configs.vq_opt_125m import smoke_config

    cfg_ref, params, np_params = smoke_params()
    args = argparse.Namespace(doc_len=32, edits=5, device="cpu")
    ref_serve.run_single(args, cfg_ref, params)
    ref_out = capsys.readouterr().out
    serve.run_single(args, smoke_config(), np_params)
    out = capsys.readouterr().out
    assert out.splitlines() == ref_out.splitlines()
    assert out.count("ops=") == 5 and "totals: edits=5" in out


def test_single_document_mode_is_the_default(capsys):
    out = _run(capsys, "--doc-len", "24", "--edits", "3")
    assert out.startswith("opened 24-token document; streaming 3 atomic edits")
    assert "totals: edits=3 defrags=0" in out


@pytest.mark.parametrize("argv,item", [(["--mesh", "single"], "16x16 grid needs 256 devices"),
                                       (["--mesh", "pod"], "2x16x16 grid needs 512 devices")])
def test_modes_not_ported_raise(argv, item):
    """The production grids need their cards: with fewer visible, the
    launcher raises ``make_mesh``'s error naming the count."""
    from repro_torch.launch import train

    with pytest.raises(ValueError, match=item):
        train.main(["--arch", "vq-opt-125m", "--smoke", "--device", "cpu", *argv])
