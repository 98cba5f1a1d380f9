"""The port's copies of the framework-free host code equal the reference's:
capacity bucketing, edit scripts and the gapped position allocator."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.common import bucketing as ref_bucketing  # noqa: E402
from repro.core import edits as ref_edits  # noqa: E402
from repro.core import positional as ref_positional  # noqa: E402
from repro_torch.common import bucketing  # noqa: E402
from repro_torch.core import edits, positional  # noqa: E402


def test_next_pow2_and_capacity_class_equal_reference():
    for n in range(0, 300):
        for minimum in (1, 4, 16):
            assert bucketing.next_pow2(n, minimum) == ref_bucketing.next_pow2(n, minimum)
            for step in (2, 4, 8):
                assert (bucketing.capacity_class(n, minimum, step)
                        == ref_bucketing.capacity_class(n, minimum, step))
    with pytest.raises(ValueError):
        bucketing.capacity_class(10, 4, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_edit_script_and_apply_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        old = list(rng.integers(0, 30, int(rng.integers(1, 40))))
        new = edits.random_revision(np.random.default_rng(int(rng.integers(1 << 30))),
                                    old, 30, 0.3)
        script = edits.edit_script(old, new)
        ref_script = ref_edits.edit_script(old, new)
        assert [(e.op, e.pos, e.token) for e in script] == \
            [(e.op, e.pos, e.token) for e in ref_script]
        assert edits.apply_edits(old, script) == list(new)
        ref_replay = ref_edits.apply_edits(
            old, [ref_edits.Edit(e.op, e.pos, e.token) for e in script])
        assert edits.apply_edits(old, script) == ref_replay


def test_random_revision_streams_equal_reference():
    toks = list(range(50))
    a = edits.random_revision(np.random.default_rng(7), toks, 100, 0.2)
    b = ref_edits.random_revision(np.random.default_rng(7), toks, 100, 0.2)
    assert a == b


@pytest.mark.parametrize("seed,n,pool", [(0, 10, 256), (1, 40, 2048), (2, 3, 16)])
def test_position_allocator_snapshots_equal_reference(seed, n, pool):
    rng = np.random.default_rng(seed)
    a = positional.PositionAllocator(n, pool)
    b = ref_positional.PositionAllocator(n, pool)
    np.testing.assert_array_equal(a.snapshot(), b.snapshot())
    for _ in range(200):
        r = rng.random()
        if r < 0.55:
            i = int(rng.integers(min(len(a), 3) + 1))  # front-heavy: gaps exhaust
            if not a.can_insert_at(i):
                assert not b.can_insert_at(i)
                assert a.defragment() == b.defragment()
            assert a.insert_at(i) == b.insert_at(i)
        elif r < 0.85 and len(a) > 1:
            i = int(rng.integers(len(a)))
            assert a.delete_at(i) == b.delete_at(i)
        else:
            assert a.defragment() == b.defragment()
        np.testing.assert_array_equal(a.snapshot(), b.snapshot())
        assert a.min_gap() == b.min_gap()
    assert a.defrag_count == b.defrag_count > 0
    snap = a.snapshot()
    a.restore(snap)
    np.testing.assert_array_equal(a.snapshot(), snap)
    np.testing.assert_array_equal(positional.spread_positions(n, pool),
                                  ref_positional.spread_positions(n, pool))
