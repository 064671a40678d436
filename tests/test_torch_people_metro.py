"""METRO's pieces in the port against the JAX package on the CPU:

- ``HRNet`` at width 18 on a 72-px input (the /16 branch is 5 px, so the
  fuse layers' nearest upsamples run at ratios 3.6 and 1.8), from the
  official-layout torch HRNet of ``tests/torch_hrnet.py`` with random
  weights and BatchNorm statistics through both packages'
  ``convert_hrnet_state_dict``: the grid feature and the /4 branch within
  1e-4 of their scale; ``F.interpolate``'s floor nearest in the fuse
  layers is off by more than 1e-2.
- ``METRONetwork`` at small stage widths (64/32/16, 2 layers, 4 heads, an
  MLP of 96) with the ResNet-50 trunk (layer 4 included) and random SMPL
  buffers, Flax's initialisation carried across by
  ``convert_metro_variables``: camera, joints and the three meshes within
  1e-4 of their scale; the projection is METRO's s * (xy + t) exactly.
- The ``.bin`` route: a METRO-layout state dict of ``tests/torch_metro.py``
  (as ``tests/test_metro_parity.py`` builds it) saved with ``torch.save``,
  through both packages' ``load_default_mesh_regressor``: the same
  ``_infer_metro_config`` and projected vertices within 1e-4; the
  converters' Flax trees equal, for this layout, the HRNet layout and
  ``skip_backbone``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from tests.torch_hrnet import TorchHRNetFeatmaps, randomize_
from tests.torch_metro import METRONetworkTorch
from tests.torch_oracle import _ResNet50
from vfloodnet_tpu.core import convert_metro as jcm
from vfloodnet_tpu.models.hrnet import HRNet as JHRNet
from vfloodnet_tpu.models.metro import METRONetwork as JMETRO
from vfloodnet_tpu.models.metro import _infer_metro_config as jinfer
from vfloodnet_tpu.models.metro import \
    load_default_mesh_regressor as jload
from vfloodnet_tpu_torch.core import convert_metro as tcm
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import convert_metro_variables
from vfloodnet_tpu_torch.models import hrnet as thrnet
from vfloodnet_tpu_torch.models.metro import (METRONetwork,
                                              _infer_metro_config,
                                              load_default_mesh_regressor,
                                              metro_orthographic_projection)

HIDDEN, OUT, LAYERS, HEADS, INTER = (64, 32, 16), (32, 16, 3), 2, 4, 96


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _smpl(seed=0):
    rng = np.random.RandomState(seed)
    return {"template_joints": rng.randn(14, 3).astype(np.float32) * 0.3,
            "template_vertices_sub2":
                rng.randn(431, 3).astype(np.float32) * 0.3,
            "j_regressor_h36m":
                rng.rand(17, 6890).astype(np.float32) / 6890.0}


def test_hrnet_width18_matches_jax(monkeypatch):
    oracle = TorchHRNetFeatmaps(width=18)
    randomize_(oracle, seed=5)
    sd = {k: v.detach().numpy() for k, v in oracle.state_dict().items()}
    x = np.random.RandomState(0).rand(1, 72, 72, 3).astype(np.float32)
    feat_j, high_j = jax.jit(JHRNet(width=18).apply)(
        jcm.convert_hrnet_state_dict(sd), jnp.asarray(x))
    model = thrnet.HRNet(width=18).eval()
    model.load_state_dict(tcm.convert_hrnet_state_dict(sd))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)

    def run():
        with torch.no_grad():
            feat, high = model(xt)
        return feat.permute(0, 2, 3, 1).numpy(), high.permute(
            0, 2, 3, 1).numpy()

    feat, high = run()
    assert feat.shape == (1, 3, 3, 2048) and high.shape == (1, 18, 18, 18)
    assert _rel(feat, feat_j) < 1e-4 and _rel(high, high_j) < 1e-4
    monkeypatch.setattr(thrnet, "resize", lambda y, hw, **_: F.interpolate(
        y, size=hw, mode="nearest"))
    assert _rel(run()[1], high_j) > 1e-2


def test_metro_network_matches_jax():
    jm = JMETRO(backbone="resnet50", stage_hidden=HIDDEN, stage_out=OUT,
                stage_layers=LAYERS, stage_heads=HEADS, intermediate=INTER)
    crops = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(crops))
    v = {"params": v["params"], "batch_stats": v["batch_stats"],
         "smpl": _smpl()}
    want = jax.jit(jm.apply)(v, jnp.asarray(crops))
    tm = METRONetwork(backbone="resnet50", stage_hidden=HIDDEN,
                      stage_out=OUT, stage_layers=LAYERS,
                      stage_heads=HEADS, intermediate=INTER).eval()
    tm.load_state_dict(convert_metro_variables(v))
    with torch.no_grad():
        got = tm(torch.from_numpy(crops))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g.numpy(), w) < 1e-4
    cam, verts = np.array(want[0]), np.array(want[2])
    proj = metro_orthographic_projection(torch.from_numpy(verts),
                                         torch.from_numpy(cam)).numpy()
    expect = cam[:, None, 0:1] * (verts[..., :2] + cam[:, None, 1:3])
    np.testing.assert_array_equal(proj, expect)


def _metro_state_dict(seed):
    torch.manual_seed(seed)
    backbone = torch.nn.Sequential(*list(_ResNet50().children())[:-2])
    oracle = METRONetworkTorch(backbone, stage_hidden=HIDDEN, stage_out=OUT,
                               heads=HEADS, intermediate=INTER, layers=LAYERS)
    return oracle.state_dict()


def test_metro_bin_route_matches_jax(tmp_path):
    sd = _metro_state_dict(1)
    path = tmp_path / "metro_state_dict.bin"
    torch.save(sd, str(path))
    np_sd = {k: v.numpy() for k, v in sd.items()}
    assert _infer_metro_config(np_sd) == jinfer(np_sd) == dict(
        stage_hidden=HIDDEN, stage_out=OUT, stage_layers=LAYERS,
        intermediate=INTER)
    crops = (np.random.RandomState(0).rand(2, 64, 64, 3) * 255).astype(
        np.uint8)
    jreg = jload(str(path))
    want = np.stack([np.asarray(jreg(c)) for c in crops])
    reg = load_default_mesh_regressor(str(path), device="cpu")
    assert isinstance(reg.model, METRONetwork)
    got = reg(crops)
    assert got.shape == (2, 431, 2)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(reg(crops[0]), want[0], atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["resnet", "hrnet", "skip_backbone"])
def test_metro_converters_match_jax(layout):
    """metro_to_flax equals the JAX package's convert_metro_state_dict,
    array for array, and the port's state dict fills METRONetwork's."""
    sd = {k: v.numpy() for k, v in _metro_state_dict(2).items()}
    if layout != "resnet":
        trunk = TorchHRNetFeatmaps(width=18)
        sd = {k: v for k, v in sd.items() if not k.startswith("backbone.")}
        sd.update({f"backbone.{k}": v.numpy()
                   for k, v in trunk.state_dict().items()})
    kw = {"skip_backbone": layout == "skip_backbone", "smpl_buffers": _smpl()}
    want = flatten(jcm.convert_metro_state_dict(sd, **kw))
    got = flatten(tcm.metro_to_flax(sd, **kw))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    state = tcm.convert_metro_state_dict(sd, **kw)
    np.testing.assert_array_equal(state["j_regressor_h36m"].numpy(),
                                  kw["smpl_buffers"]["j_regressor_h36m"])
    if layout == "resnet":
        model = METRONetwork(backbone="resnet50", stage_hidden=HIDDEN,
                             stage_out=OUT, stage_layers=LAYERS,
                             intermediate=INTER)
        model.load_state_dict(state)      # strict: every tensor filled
    else:
        assert any(k.startswith("backbone.stage4_2.") for k in state) == \
            (layout == "hrnet")
    with pytest.raises(ValueError, match="unmapped"):
        tcm.metro_to_flax({"mystery.weight": np.zeros((2, 2))})
