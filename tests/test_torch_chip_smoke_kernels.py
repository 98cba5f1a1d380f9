"""``chip_smoke.check_fused_step_single`` rehearsed on the CPU: with the
wrappers' CPU calls counted as launches, the single-document
``fused_patch_assign`` is bitwise the B = 1 batched call, two launches;
a wrapper that is not the B = 1 view fails the check."""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

from repro_torch.kernels.fused_step import ops  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def _counted(fn):
    def wrapper(*a, **kw):
        ops.LAUNCHES["fused_step"] += 1
        return fn(*a, **kw)
    return wrapper


def _counted_ops():
    return mock.patch.multiple(
        ops, fused_patch_assign_batched=_counted(ops.fused_patch_assign_batched),
        fused_patch_assign=_counted(ops.fused_patch_assign))


def test_single_document_check_passes_on_the_cpu():
    with _counted_ops():
        row = cs.check_fused_step_single(ops, torch.Generator().manual_seed(0), C=24, n=64)
    assert row == dict(n=64, C=24, bitwise=True, launches=2)


def test_single_document_check_catches_a_wrong_view():
    def shifted(*a, **kw):
        T, codes = ops.fused_patch_assign_ref(*a)
        return T + 1e-7, codes
    with _counted_ops(), mock.patch.object(ops, "fused_patch_assign", _counted(shifted)):
        with pytest.raises(AssertionError, match="bitwise"):
            cs.check_fused_step_single(ops, torch.Generator().manual_seed(0), C=24, n=64)
