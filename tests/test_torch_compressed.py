"""``repro_torch.core.compressed`` against ``repro.core.compressed`` on the
same numpy inputs: every case of ``tests/test_compressed.py`` (per-location
ops, binary ops on unique index pairs, recompression, the base + deltas
batch map, token embeddings, row dedup), at seeded sizes in place of the
reference's property draws. Codebooks within 1e-6 (they hold the same
rows), index maps and code counts exactly equal; and the fixed-capacity
paths padded with -1 as ``jnp.unique(size=)`` pads them."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import compressed as RC  # noqa: E402
from repro_torch.core import compressed as PC  # noqa: E402

SEEDS = range(6)


def _sizes(seed, **hi):
    rng = np.random.default_rng(1000 + seed)
    return rng, {k: int(rng.integers(1, v + 1)) for k, v in hi.items()}


def _pair(rng, b, n, q, d):
    """The same random compressed tensor in both packages."""
    rows = rng.standard_normal((q, d)).astype(np.float32)
    idx = rng.integers(0, q, (b, n)).astype(np.int32)
    return (RC.from_dense_rows(jnp.asarray(rows), jnp.asarray(idx)),
            PC.from_dense_rows(torch.tensor(rows), torch.tensor(idx)))


def _same(port, ref, rtol=1e-6, atol=0.0):
    """Equal index maps and code counts; codebooks within rtol (and atol)."""
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    assert port.idx.dtype == torch.int32
    assert int(port.n_codes) == int(ref.n_codes)
    np.testing.assert_allclose(port.codebook.numpy(), np.asarray(ref.codebook), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("seed", SEEDS)
def test_per_location_equals_reference(seed):
    rng, s = _sizes(seed, b=5, n=16, q=8, d=9)
    cj, ct = _pair(rng, s["b"], s["n"], s["q"], s["d"])
    out_j = RC.per_location(lambda x: jnp.tanh(x) * 2.0 + 1.0, cj)
    out_t = PC.per_location(lambda x: torch.tanh(x) * 2.0 + 1.0, ct)
    _same(out_t, out_j, atol=1e-6)  # two libraries' tanh may differ in the last bit
    np.testing.assert_allclose(out_t.to_dense().numpy(),
                               torch.tanh(ct.to_dense()).numpy() * 2.0 + 1.0, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_binary_equals_reference(seed):
    """Unique pairs in the reference's sorted order; growth bounded by the
    pairs and by b·n."""
    rng, s = _sizes(seed, b=4, n=12, qa=6, qb=6, d=8)
    aj, at = _pair(rng, s["b"], s["n"], s["qa"], s["d"])
    bj, bt = _pair(rng, s["b"], s["n"], s["qb"], s["d"])
    out_j, out_t = RC.add(aj, bj), PC.add(at, bt)
    _same(out_t, out_j)
    np.testing.assert_allclose(out_t.to_dense().numpy(),
                               (at.to_dense() + bt.to_dense()).numpy(), rtol=1e-6)
    assert int(out_t.n_codes) <= min(s["qa"] * s["qb"], s["b"] * s["n"])


@pytest.mark.parametrize("seed", SEEDS)
def test_recompress_equals_reference(seed):
    rng, s = _sizes(seed, b=4, n=12, q=12)
    cj, ct = _pair(rng, s["b"], s["n"], s["q"], 4)
    out_j, out_t = RC.recompress(cj), PC.recompress(ct)
    _same(out_t, out_j)
    assert int(out_t.n_codes) == len(np.unique(ct.idx.numpy()))
    assert int(ct.occupancy()) == int(cj.occupancy())


@pytest.mark.parametrize("seed", SEEDS)
def test_fixed_capacity_paths_pad_as_the_reference(seed):
    """``binary`` and ``recompress`` with a capacity above the unique count:
    the same padded rows (from index 0) and code counts."""
    rng, s = _sizes(seed, b=3, n=8, qa=4, qb=4, d=5)
    aj, at = _pair(rng, s["b"], s["n"], s["qa"], s["d"])
    bj, bt = _pair(rng, s["b"], s["n"], s["qb"], s["d"])
    cap = s["b"] * s["n"] + 3
    out_j, out_t = RC.add(aj, bj, capacity=cap), PC.add(at, bt, capacity=cap)
    assert out_t.capacity == cap
    _same(out_t, out_j)
    rec_j, rec_t = RC.recompress(aj, capacity=cap), PC.recompress(at, capacity=cap)
    _same(rec_t, rec_j)


@pytest.mark.parametrize("seed", SEEDS)
def test_base_and_deltas_equals_reference(seed):
    """The mode per location (lowest index among tied modes) and the delta
    mask; reconstruction exact and near-sparse."""
    rng, s = _sizes(seed, n=16, b=6, n_edit=9)
    n, b, n_edit = s["n"], s["b"], s["n_edit"] - 1
    idx = np.tile(rng.integers(0, n + 1, n), (b, 1))
    for _ in range(n_edit):
        idx[rng.integers(b), rng.integers(n)] = rng.integers(0, n + 1)
    rows = rng.standard_normal((n + 1, 4)).astype(np.float32)
    cj = RC.from_dense_rows(jnp.asarray(rows), jnp.asarray(idx, jnp.int32))
    ct = PC.from_dense_rows(torch.tensor(rows), torch.tensor(idx, dtype=torch.int32))
    base_j, delta_j = RC.base_and_deltas(cj)
    base_t, delta_t = PC.base_and_deltas(ct)
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(delta_t.numpy(), np.asarray(delta_j))
    rec = np.where(delta_t.numpy(), idx, base_t.numpy()[None, :])
    np.testing.assert_array_equal(rec, idx)
    assert int(delta_t.sum()) <= n_edit * 2 + b


def test_base_and_deltas_takes_the_lowest_tied_mode():
    idx = np.array([[3, 1], [2, 1], [3, 0], [2, 0]], np.int32)
    rows = np.zeros((4, 2), np.float32)
    base_t, _ = PC.base_and_deltas(PC.from_dense_rows(torch.tensor(rows), torch.tensor(idx)))
    base_j, _ = RC.base_and_deltas(RC.from_dense_rows(jnp.asarray(rows), jnp.asarray(idx)))
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    assert base_t.tolist() == [2, 0]


def test_from_tokens_equals_reference():
    emb = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    toks = np.array([[1, 2, 3], [1, 2, 9]], np.int32)
    cj, ct = RC.from_tokens(jnp.asarray(emb), jnp.asarray(toks)), PC.from_tokens(
        torch.tensor(emb), torch.tensor(toks))
    _same(ct, cj)
    np.testing.assert_array_equal(ct.to_dense().numpy(), emb[toks])


def test_compress_equals_reference():
    """Row dedup in ``np.unique``'s order: 3 codes for 6 rows."""
    rows = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    x = rows[[0, 1, 0, 2, 2, 1]].reshape(2, 3, 3)
    cj, ct = RC.compress(jnp.asarray(x)), PC.compress(torch.tensor(x))
    assert int(ct.n_codes) == 3
    _same(ct, cj, rtol=0)
    np.testing.assert_array_equal(ct.to_dense().numpy(), x)
    with pytest.raises(NotImplementedError):
        PC.compress(torch.tensor(x), capacity=8)
