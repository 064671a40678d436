"""Port ops vs the JAX package's ops on the same random inputs.

Tolerances: float32 ops atol 1e-5 (summation order differs between XLA and
ATen); connected components, nearest resizes and bit packing are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu import ops as jops
from vfloodnet_tpu.pipelines import video_seg as jvs
from vfloodnet_tpu_torch import ops
from vfloodnet_tpu_torch.pipelines import video_seg as tvs

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.mark.parametrize("in_hw,out_hw", [((45, 80), (27, 48)),
                                          ((30, 53), (1080 // 8, 1920 // 8)),
                                          ((64, 96), (64, 50))])
def test_bicubic_matches_jax(in_hw, out_hw):
    rng = np.random.RandomState(0)
    frame = rng.rand(*in_hw, 3).astype(np.float32)          # NHWC frame
    want = jops.resize(jnp.asarray(frame), out_hw, "bicubic",
                       spatial_axes=(0, 1))
    got = ops.resize(torch.tensor(frame), out_hw, "bicubic",
                     spatial_axes=(0, 1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # [H, W] map in [-1, 1], the range of the engine's fg - bg difference
    plane = (2 * rng.rand(*in_hw) - 1).astype(np.float32)
    want = jops.resize(jnp.asarray(plane), out_hw, "bicubic",
                       spatial_axes=(-2, -1))
    got = ops.resize(torch.tensor(plane), out_hw, "bicubic",
                     spatial_axes=(-2, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("method", ["nearest", "nearest_torch"])
def test_nearest_resizes_match_jax_exactly(method):
    rng = np.random.RandomState(1)
    for (h, w), out in [((480, 853), (30, 53)), ((30, 53), (1080, 1920)),
                        ((1080, 1920), (480, 853)), ((37, 91), (23, 140)),
                        ((240, 427), (15, 26))]:
        x = rng.randint(0, 5, size=(2, h, w)).astype(np.uint8)
        want = jops.resize(jnp.asarray(x), out, method, spatial_axes=(-2, -1))
        got = ops.resize(torch.tensor(x), out, method, spatial_axes=(-2, -1))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_short_side_size_matches_jax():
    for h, w in [(1080, 1920), (1920, 1080), (480, 853), (100, 100),
                 (333, 777)]:
        for t in (48, 240, 480):
            assert ops.short_side_size(h, w, t) == \
                jops.short_side_size(h, w, t)


@pytest.mark.parametrize("shape,axes", [((1, 45, 83, 3), (-3, -2)),
                                        ((2, 37, 64), (-2, -1)),
                                        ((3, 48, 64, 1), (-3, -2))])
def test_pad_and_unpad_match_jax(shape, axes):
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want, want_pad = jops.pad_divide_by(jnp.asarray(x), 16, spatial_axes=axes)
    got, got_pad = ops.pad_divide_by(torch.tensor(x), 16, spatial_axes=axes)
    assert tuple(got_pad) == tuple(want_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = ops.unpad(got, got_pad, spatial_axes=axes)
    np.testing.assert_array_equal(back.numpy(), x)


def test_local_pools_match_jax():
    x = np.random.RandomState(3).rand(2, 20, 31, 5).astype(np.float32)
    xt = torch.tensor(x).permute(0, 3, 1, 2)                # NHWC -> NCHW
    for jf, tf in ((jops.local_avg_pool, ops.local_avg_pool),
                   (jops.local_max_pool, ops.local_max_pool)):
        want = np.asarray(jf(jnp.asarray(x), 7))
        got = tf(xt, 7).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_uncertainty_matches_jax():
    x = np.random.RandomState(4).rand(2, 3, 9, 11).astype(np.float32)
    want = jops.calc_uncertainty(jnp.asarray(x), obj_axis=1)
    got = ops.calc_uncertainty(torch.tensor(x), obj_axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _blobs(rng, h, w, density):
    """Random masks with blob structure: thresholded smoothed noise."""
    from scipy import ndimage
    noise = ndimage.uniform_filter(rng.rand(h, w), size=3)
    return (noise > np.quantile(noise, 1 - density)).astype(np.uint8)


@pytest.mark.parametrize("density,seed", [(0.3, 0), (0.5, 1), (0.6, 2),
                                          (0.05, 3)])
def test_connected_components_match_jax_exactly(density, seed):
    mask = _blobs(np.random.RandomState(seed), 30, 53, density)
    want = np.asarray(jops.connected_components(jnp.asarray(mask)))
    got = ops.connected_components(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jops.largest_connected_component(jnp.asarray(mask)))
    got = ops.largest_connected_component(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(got, want)


def test_largest_cc_snake_and_empty():
    snake = np.zeros((21, 21), np.uint8)
    for r in range(0, 21, 4):
        snake[r, :] = 1
        snake[r + 1:r + 3, 20 if (r // 4) % 2 == 0 else 0] = 1
    snake[19:, :] = 0
    snake[0, 0] = 0
    snake[10, 10] = 0
    want = np.asarray(jops.largest_connected_component(jnp.asarray(snake)))
    got = ops.largest_connected_component(torch.tensor(snake)).numpy()
    np.testing.assert_array_equal(got, want)
    empty = np.zeros((8, 9), np.uint8)
    assert ops.largest_connected_component(torch.tensor(empty)).sum() == 0


def test_pack_bits_matches_jax_and_round_trips():
    label = np.random.RandomState(5).randint(0, 2, (37, 91)).astype(np.uint8)
    want = np.asarray(jvs.pack_bits(jnp.asarray(label)))
    got = tvs.pack_bits(torch.tensor(label)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvs.unpack_bits(got, 91), label)


@pytest.mark.parametrize("scale", [16, 4])
def test_device_largest_cc_matches_jax_exactly(scale):
    rng = np.random.RandomState(6)
    small = _blobs(rng, 240, 427, 0.4)
    full = jops.resize(jnp.asarray(small), (540, 960), "nearest",
                       spatial_axes=(-2, -1))
    want = jvs.device_largest_cc(full, jnp.asarray(small), scale=scale)
    got = tvs.device_largest_cc(torch.tensor(np.asarray(full)),
                                torch.tensor(small), scale=scale)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_largest_cc_and_onehot_match_jax():
    rng = np.random.RandomState(7)
    for density in (0.2, 0.5):
        label = _blobs(rng, 64, 96, density)
        np.testing.assert_array_equal(tvs.host_largest_cc(label),
                                      jvs.host_largest_cc(label))
    mask = rng.randint(0, 3, (10, 12)).astype(np.uint8)
    np.testing.assert_array_equal(tvs.to_onehot(mask, 3),
                                  jvs.to_onehot(mask, 3))
