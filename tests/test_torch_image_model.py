"""The image model: the port's trained EfficientNet-B4 features and
LinkNet against the JAX package's, from the bundled checkpoint
(``records/checkpoints/image/best.npz``) carried across by the weight
bridge, on the same seeded 96 x 128 images on the CPU: the features
within rtol/atol 1e-4 and the probabilities within atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.models.efficientnet import EfficientNetFeatures as JEff
from vfloodnet_tpu.models.linknet import load_linknet as j_load_linknet
from vfloodnet_tpu_torch.core import (convert_linknet_variables,
                                      load_flat_npz)
from vfloodnet_tpu_torch.pipelines import load_linknet
from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint

torch.set_num_threads(4)
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


@pytest.fixture(scope="module")
def models():
    jm, variables = j_load_linknet(None)
    return jm, variables, load_linknet(device="cpu")


def _images():
    return np.random.RandomState(0).rand(2, 96, 128, 3).astype(np.float32)


def test_efficientnet_features_match_jax(models):
    _, variables, port = models
    x = (_images() - MEAN) / STD
    enc = {"params": variables["params"]["encoder"],
           "batch_stats": variables["batch_stats"]["encoder"]}
    want = jax.jit(JEff().apply)(enc, jnp.asarray(x))
    with torch.no_grad():
        got = port.encoder(torch.from_numpy(x))
    assert [f.shape[-1] for f in got] == [24, 32, 56, 160, 448]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_linknet_matches_jax(models):
    jm, variables, port = models
    x = _images()
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 96, 128, 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_linknet_bridge_uses_every_array_once():
    flat = load_flat_npz(default_checkpoint("image"))
    assert len(convert_linknet_variables(flat)) == 572
    flat["batch_stats"]["extra"] = {"mean": np.zeros(3, np.float32)}
    with pytest.raises(KeyError):
        convert_linknet_variables(flat)


def test_load_linknet_refuses_missing_and_pth(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_linknet(str(tmp_path / "none.npz"), device="cpu")
    # a .pth is the reference's smp LinkNet now
    # (tests/test_torch_weight_routes.py); a missing one raises, and so
    # does a file of a suffix the loader does not know
    with pytest.raises(FileNotFoundError):
        load_linknet(str(tmp_path / "model.pth"), device="cpu")
    other = tmp_path / "model.ckpt"
    other.write_bytes(b"")
    with pytest.raises(ValueError, match="npz"):
        load_linknet(str(other), device="cpu")
