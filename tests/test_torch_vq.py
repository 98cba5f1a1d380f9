"""The port's joint VQ code (``combined_code`` / ``split_code`` of
``repro_torch.core.vq``, paper §4) against the reference's: bitwise equal
int32 codes and per-head indices, and the round trip, at h in {1, 2, 4}
heads of q = 64 entries."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import vq as ref  # noqa: E402
from repro_torch.core import vq as port  # noqa: E402

Q = 64


@pytest.mark.parametrize("h", [1, 2, 4])
def test_combined_and_split_code_equal_the_reference(h):
    rng = np.random.default_rng(h)
    idx = rng.integers(0, Q, (3, 17, h)).astype(np.int32)
    idx[0, 0] = Q - 1  # the largest code, q**h - 1
    idx[0, 1] = 0
    code = port.combined_code(torch.from_numpy(idx), Q)
    want = np.asarray(ref.combined_code(jnp.asarray(idx), Q))
    assert code.dtype == torch.int32 and code.shape == (3, 17)
    np.testing.assert_array_equal(code.numpy(), want)
    assert int(code[0, 0]) == Q ** h - 1 and int(code[0, 1]) == 0
    back = port.split_code(code, Q, h)
    assert back.dtype == torch.int32 and back.shape == idx.shape
    np.testing.assert_array_equal(back.numpy(), np.asarray(ref.split_code(jnp.asarray(want), Q, h)))
    np.testing.assert_array_equal(back.numpy(), idx)


@pytest.mark.parametrize("h", [1, 2, 4])
def test_every_code_splits_as_the_reference(h):
    codes = np.unique(np.concatenate([
        np.arange(min(Q ** h, 4096)),
        np.random.default_rng(0).integers(0, Q ** h, 4096)])).astype(np.int32)
    got = port.split_code(torch.from_numpy(codes), Q, h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.split_code(jnp.asarray(codes), Q, h)))
    np.testing.assert_array_equal(port.combined_code(got, Q).numpy(), codes)
