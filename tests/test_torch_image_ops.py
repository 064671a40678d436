"""The image path's ops against the JAX package's, on the CPU:

- bilinear resize, with and without antialias, against
  ``jax.image.resize`` (as the JAX package calls it) at size pairs of the
  image path (down to 416, back up to a frame) and odd ones, atol 1e-5;
- the largest component of a batch of maps (the plain version the CUDA
  kernel is held to), exactly against the JAX op map by map;
- the kernel's wrapper refuses a CPU tensor, and the dispatcher takes the
  plain version for one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.ops import cc as jcc
from vfloodnet_tpu_torch.ops import cc, cc_cuda, resize

PAIRS = [((37, 53), (416, 416)), ((480, 853), (416, 416)),
         ((416, 416), (1080, 1920)), ((101, 77), (13, 9)),
         ((20, 30), (20, 61))]


@pytest.mark.parametrize("antialias", [False, True])
def test_bilinear_matches_jax(antialias):
    rng = np.random.RandomState(int(antialias))
    for in_hw, out_hw in PAIRS:
        x = rng.rand(2, *in_hw, 3).astype(np.float32)
        want = jax.jit(lambda a, o=out_hw: jax.image.resize(
            a, (2, *o, 3), "linear", antialias=antialias))(jnp.asarray(x))
        got = resize(torch.from_numpy(x), out_hw, "bilinear",
                     antialias=antialias)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   err_msg=f"{in_hw} -> {out_hw}")


def test_bilinear_on_chw_axes_and_bicubic_refuses_antialias():
    x = np.random.RandomState(2).rand(3, 40, 50).astype(np.float32)
    want = jax.jit(lambda a: jax.image.resize(
        a, (3, 16, 20), "linear", antialias=False))(jnp.asarray(x))
    got = resize(torch.from_numpy(x), (16, 20), "bilinear",
                 spatial_axes=(-2, -1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="antialias"):
        resize(torch.from_numpy(x), (16, 20), "bicubic",
               spatial_axes=(-2, -1), antialias=True)


def test_batched_largest_cc_matches_jax_map_by_map():
    rng = np.random.RandomState(4)
    maps = (rng.rand(4, 41, 57) < 0.45).astype(np.uint8)
    maps[2] = 0                                   # empty
    maps[3] = 0
    maps[3, 5:9, 5:9] = 1                         # two equal squares: the
    maps[3, 20:24, 30:34] = 1                     # smaller label is kept
    got = cc.largest_connected_component(torch.from_numpy(maps)).numpy()
    for i in range(4):
        want = np.asarray(jcc.largest_connected_component(
            jnp.asarray(maps[i])))
        np.testing.assert_array_equal(got[i], want, err_msg=f"map {i}")
    assert got[3, 6, 6] == 1 and got[3, 21, 31] == 0


def test_cc_kernel_wrapper_needs_a_cuda_tensor():
    with pytest.raises(ValueError, match="uint8 CUDA tensor"):
        cc_cuda.largest_cc(torch.zeros(4, 4, dtype=torch.uint8))
    assert cc_cuda.launches["largest_cc"] == 0
