"""The port's PSPNet (``models/pspnet.py``) and its weight bridge against
the JAX package's ``PSPNet`` on the CPU.

The Flax variables are made from their shapes (``jax.eval_shape``, no
JAX init) with seeded numpy values, BatchNorm statistics included, so
that the fold is exercised. Bars: float32 logits and aux logits within
rtol 1e-4 and 1e-4 of their scale (the largest magnitude); bf16 labels
(the harness's: logits upsampled to the input, argmax) agree with JAX's
bf16 labels at least as well as JAX's bf16 labels agree with its float32
ones, less 0.01; the PPM's resizes within 1e-6 of the scale of
``jax.image.resize``; the converter's round trip exact."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.pspnet import PSPNet as JPSPNet
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import (convert_pspnet_variables,
                                              export_pspnet_variables)
from vfloodnet_tpu_torch.models import TrainBN
from vfloodnet_tpu_torch.models.pspnet import PSPNet
from vfloodnet_tpu_torch.ops import resize

torch.set_num_threads(4)


@functools.lru_cache(maxsize=None)
def jax_variables(num_classes, seed=0):
    """Seeded Flax variables of ``PSPNet(num_classes)``: kernels LeCun
    normal, biases, BN scale and bias N(0, 0.1) about Flax's init, BN
    means N(0, 0.1) and variances in [0.5, 1.5]. Made once a module
    (the tests only read them)."""
    shapes = jax.eval_shape(JPSPNet(num_classes=num_classes).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        leaf = path[-1].key
        shape = s.shape
        if leaf == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        base = 1.0 if leaf == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@functools.lru_cache(maxsize=None)
def jax_apply(num_classes, dtype=jnp.float32):
    """JAX's ``PSPNet(num_classes, dtype).apply``, jitted once a module."""
    return jax.jit(JPSPNet(num_classes=num_classes, dtype=dtype).apply)


def port_model(variables, num_classes, dtype=torch.float32):
    model = PSPNet(num_classes, dtype=dtype)
    model.load_state_dict(convert_pspnet_variables(variables))
    return model.eval()


def _image(hw, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (1,) + hw + (3,)).astype(np.float32)


def _port(model, x):
    with torch.no_grad():
        aux, logits = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (aux.float().permute(0, 2, 3, 1).numpy(),
            logits.float().permute(0, 2, 3, 1).numpy())


@pytest.mark.parametrize("num_classes,hw", [(7, (64, 64)), (56, (64, 64)),
                                            (7, (57, 70))])
def test_pspnet_matches_jax(num_classes, hw):
    v = jax_variables(num_classes)
    x = _image(hw)
    want = jax_apply(num_classes)(v, jnp.asarray(x))
    got = _port(port_model(v, num_classes), x)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (1, -(-hw[0] // 8), -(-hw[1] // 8),
                                      num_classes)
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * scale)


def _labels(logits, hw):
    """The harness's labels: logits upsampled to ``hw``, argmax."""
    up = jax.image.resize(jnp.asarray(logits, jnp.float32),
                          (1,) + hw + (logits.shape[-1],), "linear")
    return np.asarray(jnp.argmax(up[0], axis=-1))


def test_pspnet_bf16_labels_within_jax_own_gap():
    hw = (64, 64)
    v = jax_variables(56)
    x = _image(hw, seed=3)
    j32 = jax_apply(56)(v, jnp.asarray(x))[1]
    j16 = jax_apply(56, jnp.bfloat16)(v, jnp.asarray(x))[1]
    p16 = _port(port_model(v, 56, torch.bfloat16), x)[1]
    want32, want16 = _labels(j32, hw), _labels(j16, hw)
    got16 = _labels(p16, hw)
    jax_gap = (want16 == want32).mean()
    agree = (got16 == want16).mean()
    assert jax_gap < 1.0     # bf16 moves some labels at all
    assert agree >= jax_gap - 0.01, (agree, jax_gap)


def test_ppm_resizes_match_jax():
    """The PPM's pooling (96 -> 1, 2, 3, 6, ``linear`` with JAX's default
    antialias) and its upsamples back to 96, at the full-width trunk's
    1/8 grid of a 768-px input."""
    x = np.random.default_rng(4).standard_normal((1, 96, 96, 16)).astype(
        np.float32)
    for b in (1, 2, 3, 6):
        want = jax.jit(lambda a, b=b: jax.image.resize(
            a, (1, b, b, 16), "linear"))(jnp.asarray(x))
        got = resize(torch.from_numpy(x), (b, b), "bilinear",
                     antialias=True).numpy()
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-6 * scale)
        small = np.array(want)
        want_up = jax.jit(lambda a: jax.image.resize(
            a, (1, 96, 96, 16), "linear"))(jnp.asarray(small))
        got_up = resize(torch.from_numpy(small), (96, 96), "bilinear",
                        antialias=True).numpy()
        np.testing.assert_allclose(got_up, np.asarray(want_up), rtol=0,
                                   atol=1e-6 * scale)


def test_converter_round_trip():
    """JAX variables -> the unfolded form -> back, exactly; the unfolded
    form's eval output equal to the folded one's; a stray array raises."""
    v = jax_variables(7)
    flat = flatten(jax.tree.map(np.asarray, v))
    state = convert_pspnet_variables(v, trainable_bn=True)
    model = PSPNet(7, norm=TrainBN).eval()
    model.load_state_dict(state)
    back = export_pspnet_variables(model.state_dict())
    assert sorted(back) == sorted(flat)
    for k, arr in flat.items():
        np.testing.assert_array_equal(back[k], arr, err_msg=k)
    x = _image((40, 48), seed=6)
    for g, w in zip(_port(model, x), _port(port_model(v, 7), x)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        convert_pspnet_variables(dict(flat, **{"batch_stats/extra/mean":
                                               np.zeros(4, np.float32)}))
