"""The bundled body-mesh regressor in the port against the JAX package on the
CPU:

- the trained ``records/checkpoints/bodymesh/best.npz`` (the full-width
  ``BodyMeshRegressor``: ResNet-50 to layer 3, encoder stages at
  1024/256/128) through both packages' ``load_default_mesh_regressor`` on
  3 crops (two person crops of the staged scenes and a random one), one at
  a time and as one batch: projected vertices within 1e-4 in [-1, 1]
  units; with torch's default, exact GELU in place of Flax's tanh form
  they are off by more than 1e-3;
- ``TransformerBlock`` against Flax's on inputs of small variance, where
  the LayerNorm epsilon shows: within 1e-5 of scale with Flax's 1e-6,
  off by more than 1e-3 with torch's 1e-5;
- the loader refuses an orbax directory and falls back to seeded weights
  with a warning; a METRO ``.bin`` whose trunk it does not know loads the
  rest into ``METRONetwork`` (HRNet-W64 seeded, with a warning).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vfloodnet_tpu.models.metro import TransformerBlock as JBlock
from vfloodnet_tpu.models.metro import \
    load_default_mesh_regressor as jload
from vfloodnet_tpu_torch.core.convert import convert_metro_variables
from vfloodnet_tpu_torch.models.metro import (BodyMeshRegressor,
                                              METRONetwork, TransformerBlock,
                                              load_default_mesh_regressor)
from vfloodnet_tpu_torch.pipelines.object_detection import crop_person
from vfloodnet_tpu_torch.utils import load_image, load_mask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "records", "demo_eval", "people")
BOXES = ((62.7, 100.4, 152.3, 277.3), (98.6, 104.3, 187.6, 287.0))


def _crops():
    crops = []
    for i, box in enumerate(BOXES):
        img = np.ascontiguousarray(load_image(os.path.join(
            SCENES, "frames", f"scene{i}.png"))[..., ::-1])
        mask = load_mask(os.path.join(SCENES, "masks", f"scene{i}.png"))
        crops.append(crop_person(img, mask, box)[0])
    crops.append((np.random.RandomState(0).rand(224, 224, 3) * 255).astype(
        np.uint8))
    return np.stack(crops)


def test_trained_regressor_matches_jax(monkeypatch):
    crops = _crops()
    jreg = jload()
    want = np.stack([np.asarray(jreg(c)) for c in crops])
    reg = load_default_mesh_regressor(device="cpu")
    assert isinstance(reg.model, BodyMeshRegressor)
    one = np.stack([reg(c) for c in crops])
    batch = reg(crops)
    assert want.shape == one.shape == batch.shape == (3, 431, 2)
    assert np.abs(want).max() > 0.3          # a spread-out body, not zeros
    np.testing.assert_allclose(one, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(batch, want, atol=1e-4, rtol=0)
    gelu = F.gelu
    monkeypatch.setattr(F, "gelu", lambda x, approximate="none": gelu(x))
    assert np.abs(reg(crops) - want).max() > 1e-3


def test_transformer_block_keeps_flax_defaults():
    dim = 64
    x = (np.random.RandomState(1).randn(2, 30, dim) * 2e-3).astype(
        np.float32)
    jm = JBlock(dim)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = TransformerBlock(dim).eval()
    tm.load_state_dict(convert_metro_variables({"params": v["params"]}))
    xt = torch.from_numpy(x)
    scale = np.abs(want).max()

    def err(block):
        with torch.no_grad():
            return np.abs(block(xt).numpy() - want).max() / scale

    assert err(tm) < 1e-5
    torch_eps = TransformerBlock(dim).eval()
    torch_eps.load_state_dict(tm.state_dict())
    torch_eps.LayerNorm_0.eps = torch_eps.LayerNorm_1.eps = 1e-5
    assert err(torch_eps) > 1e-3


def test_loader_refuses_orbax_and_seeds(tmp_path):
    with pytest.raises(ValueError, match="orbax"):
        load_default_mesh_regressor(str(tmp_path), device="cpu")
    with pytest.warns(UserWarning, match="seeded"):
        reg = load_default_mesh_regressor(str(tmp_path / "absent.npz"),
                                          device="cpu")
    pts = reg(_crops()[2])
    assert pts.shape == (431, 2) and np.isfinite(pts).all()
    from tests.torch_metro import METRONetworkTorch
    sd = METRONetworkTorch(torch.nn.Identity(), stage_hidden=(32, 16, 8),
                           stage_out=(16, 8, 3), intermediate=48,
                           layers=1).state_dict()
    sd["backbone.stem.mystery.weight"] = torch.zeros(2, 2)
    torch.save(sd, str(tmp_path / "metro.bin"))
    with pytest.warns(UserWarning, match="unrecognised"):
        reg = load_default_mesh_regressor(str(tmp_path / "metro.bin"),
                                          device="cpu")
    assert isinstance(reg.model, METRONetwork)
    assert torch.equal(reg.model.stage2.cls_head.weight,
                       sd["trans_encoder.2.cls_head.weight"])
    pts = reg(_crops()[2])
    assert pts.shape == (431, 2) and np.isfinite(pts).all()
