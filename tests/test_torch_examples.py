"""The port's example modules (``repro_torch.examples``) run end to end on
the CPU with ``--device cpu`` and pass their own checks: token parity with
the edit-replayed references and a suggestion for every subscription
(``incremental_serving``), the op counts and the edited tokens
(``quickstart``), each family's decode against its forward
(``multiarch_decode``, deepseek-v2's MLA and MoE among them), and the
distillation pipeline at a few steps (``distill_vqt``: finite losses, a
parameter file that restores, accuracies and an op speedup)."""
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


def test_distill_vqt_runs_on_the_cpu(capsys, tmp_path):
    import re

    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs.vq_opt_125m import smoke_config
    from repro_torch.examples import distill_vqt
    from repro_torch.models.transformer import init_params

    ckpt = str(tmp_path / "student.npz")
    distill_vqt.main(["--device", "cpu", "--steps", "4", "--ckpt", ckpt])
    out = capsys.readouterr().out
    for i in range(1, 5):
        assert f"[{i}/4]" in out
    kl, lm = (float(x) for x in re.search(r"kl=([\d.]+) lm=([\d.]+)", out).groups())
    assert kl >= 0 and lm > 0
    acc = [float(x) for x in re.findall(r"acc=([\d.]+)", out)]
    assert len(acc) == 2 and all(0 <= a <= 1 for a in acc)
    speedup = float(re.search(r"cumulative ([\d.]+)X", out).group(1))
    assert speedup > 1
    like = init_params(smoke_config(), generator=torch.Generator().manual_seed(9), device="cpu")
    params = restore_pytree(ckpt, like)
    assert not torch.equal(params["embed"]["tok"], like["embed"]["tok"])
