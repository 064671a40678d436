"""Default arguments that the port shares with the JAX package: the sharded
engine's post-processing, and ``ops.resize``'s method, with
``resize_short_side``. A default-built object of each package is held to
the other's. Resizes: float32, within 1e-5 (XLA and the port's dense
products add in other orders); nearest is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu import ops as jops
from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.parallel import make_mesh as jmake_mesh
from vfloodnet_tpu.pipelines.video_seg_sharded import \
    ShardedVideoSegEngine as JShardedEngine
from vfloodnet_tpu_torch import ops
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.parallel import (close_world, init_local_world,
                                          make_mesh)
from vfloodnet_tpu_torch.pipelines.video_seg_sharded import \
    ShardedVideoSegEngine

torch.set_num_threads(2)
ATOL = 1e-5
# (input [H, W], output) pairs: one down, one up
SHAPES = [((45, 80), (27, 48)), ((30, 53), (61, 97))]


def test_sharded_engine_default_postprocess_is_jax():
    """Built with defaults, both engines resolve the same post-processing
    ('none'): the port's default was 'auto', which picks the host or the
    CC kernel."""
    want = JShardedEngine(JAFBURR(), {}, JFeatureBank(2),
                          jmake_mesh()).postprocess
    init_local_world("cpu")
    try:
        engine = ShardedVideoSegEngine(AFBURR(), FeatureBank(2, device="cpu"),
                                       make_mesh())
    finally:
        close_world()
    assert want == "none"
    assert engine.postprocess == want


def _frame(in_hw, seed=0):
    return np.random.RandomState(seed).rand(*in_hw, 3).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", SHAPES)
def test_resize_default_method_is_bilinear(in_hw, out_hw):
    """``resize(x, hw)`` with no method is JAX's, the bilinear."""
    x = _frame(in_hw)
    want = np.asarray(jops.resize(jnp.asarray(x), out_hw))
    got = ops.resize(torch.from_numpy(x), out_hw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    bilinear = ops.resize(torch.from_numpy(x), out_hw, "bilinear").numpy()
    np.testing.assert_array_equal(got, bilinear)


@pytest.mark.parametrize("method,antialias", [
    ("bilinear", False), ("bilinear", True), ("bicubic", False),
    ("nearest", False)])
def test_resize_methods_match_jax(method, antialias):
    for in_hw, out_hw in SHAPES:
        x = _frame(in_hw, 1)
        if method == "nearest":
            x = np.floor(x * 5).astype(np.uint8)
        want = np.asarray(jops.resize(jnp.asarray(x), out_hw, method,
                                      spatial_axes=(0, 1),
                                      antialias=antialias))
        got = ops.resize(torch.from_numpy(x), out_hw, method,
                         spatial_axes=(0, 1), antialias=antialias).numpy()
        if method == "nearest":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("target", [20, 64])
def test_resize_short_side_matches_jax(target):
    """Same signature and defaults as JAX's; a landscape and a portrait
    frame, NHWC and [C, H, W]."""
    for in_hw in ((45, 80), (80, 45)):
        x = _frame(in_hw, 2)
        want = np.asarray(jops.resize_short_side(jnp.asarray(x), target,
                                                 spatial_axes=(0, 1)))
        got = ops.resize_short_side(torch.from_numpy(x), target,
                                    spatial_axes=(0, 1)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
        chw = np.ascontiguousarray(x.transpose(2, 0, 1))
        want = np.asarray(jops.resize_short_side(
            jnp.asarray(chw), target, "bilinear", spatial_axes=(-2, -1),
            antialias=True))
        got = ops.resize_short_side(torch.from_numpy(chw), target,
                                    "bilinear", spatial_axes=(-2, -1),
                                    antialias=True).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL)
