"""The port's sampled positions (``repro_torch.core.positional``) against
the reference's: given the reference's own Gumbel noise the ids are equal;
drawn from a ``torch.Generator`` they are a sorted, unique, in-range int32
subset of the pool."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import positional as ref  # noqa: E402
from repro_torch.core import positional as port  # noqa: E402


@pytest.mark.parametrize("n,pool", [(1, 1), (5, 5), (16, 100), (50, 1000), (128, 6400)])
def test_sample_positions_equal_the_reference_given_its_noise(n, pool):
    key = jax.random.PRNGKey(n + pool)
    noise = np.array(jax.random.gumbel(key, (pool,)))
    got = port.sample_positions(None, n, pool, gumbel=torch.from_numpy(noise))
    want = np.asarray(ref.sample_positions(key, n, pool))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("batch,n,pool", [(1, 8, 64), (4, 16, 100), (3, 32, 32)])
def test_sample_positions_batch_equal_the_reference_given_its_noise(batch, n, pool):
    key = jax.random.PRNGKey(7 * batch + n)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (pool,)))
                      for k in jax.random.split(key, batch)])
    got = port.sample_positions_batch(None, batch, n, pool, gumbel=torch.from_numpy(noise))
    want = np.asarray(ref.sample_positions_batch(key, batch, n, pool))
    assert got.dtype == torch.int32 and got.shape == (batch, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_drawn_positions_are_a_sorted_subset_of_the_pool():
    gen = torch.Generator().manual_seed(0)
    for n, pool in ((50, 1000), (64, 64), (1, 3)):
        pos = port.sample_positions(gen, n, pool)
        assert pos.dtype == torch.int32 and pos.shape == (n,)
        assert bool((pos[1:] > pos[:-1]).all()) and 0 <= int(pos.min()) <= int(pos.max()) < pool
    batch = port.sample_positions_batch(gen, 4, 32, 500)
    assert batch.dtype == torch.int32 and batch.shape == (4, 32)
    assert bool((batch[:, 1:] > batch[:, :-1]).all())
    assert 0 <= int(batch.min()) and int(batch.max()) < 500
    assert len({tuple(r.tolist()) for r in batch}) > 1  # each document its own draw
    again = port.sample_positions(torch.Generator().manual_seed(0), 50, 1000)
    assert torch.equal(again, port.sample_positions(torch.Generator().manual_seed(0), 50, 1000))


def test_more_positions_than_the_pool_raise_as_the_reference():
    with pytest.raises(ValueError):
        ref.sample_positions(jax.random.PRNGKey(0), 9, 8)
    with pytest.raises(ValueError):
        port.sample_positions(torch.Generator().manual_seed(0), 9, 8)
    with pytest.raises(ValueError):
        port.sample_positions_batch(torch.Generator().manual_seed(0), 2, 9, 8)
    with pytest.raises(ValueError):  # noise of the wrong shape
        port.sample_positions(None, 4, 8, gumbel=torch.zeros(9))
