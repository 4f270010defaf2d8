"""grlir_torch.ops.layout vs grlir.ops.layout on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grlir.ops import layout as jl
from grlir_torch.ops import layout as tl


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("window", [(8, 8), (4, 16), (16, 4)])
def test_window_partition_and_reverse(window):
    x = _x((2, 16, 32, 5))
    want = np.asarray(jl.window_partition(jnp.asarray(x), window))
    got = tl.window_partition(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tl.window_reverse(got, window, (16, 32))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jl.window_reverse(jnp.asarray(want), window,
                                                   (16, 32))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("window", [(8, 8), (4, 16), (16, 4)])
def test_window_partition_and_reverse_cm(window):
    """The channel-major pair the fused attention engines read and write."""
    x = _x((2, 16, 32, 5), seed=1)
    want = np.asarray(jl.window_partition_cm(jnp.asarray(x), window))
    got = tl.window_partition_cm(torch.from_numpy(x), window)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tl.window_reverse_cm(got, window, (16, 32))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jl.window_reverse_cm(jnp.asarray(want), window,
                                                      (16, 32))))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("scale", [2, 3])
def test_nearest_upsample(scale):
    x = _x((1, 5, 7, 3))
    want = np.asarray(jl.nearest_upsample(jnp.asarray(x), scale))
    np.testing.assert_array_equal(
        tl.nearest_upsample(torch.from_numpy(x), scale).numpy(), want)


# (20, 36) reflects; (4, 7) is smaller than its pad and takes zeros; (32, 48)
# needs no pad
@pytest.mark.parametrize("hw", [(20, 36), (4, 7), (32, 48)])
def test_pad_to_multiple(hw):
    x = _x((2, *hw, 3))
    want = np.asarray(jl.pad_to_multiple(jnp.asarray(x), 16))
    got = tl.pad_to_multiple(torch.from_numpy(x), 16).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
