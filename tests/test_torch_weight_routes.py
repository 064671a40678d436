"""The reference's PyTorch weight files through the port's loaders,
against the JAX package's converters (CPU):

- a reference-style AFB-URR ``state_dict`` (the reference's key names and
  torch layouts, made from the Flax tree as ``tests/test_convert.py``
  does, with the normalisation buffers and ``num_batches_tracked`` the
  converter must skip), saved as the trainer's ``{"model": ...}`` ``.pth``
  and as a bare ``.bin``: the port's ``load_afb_urr`` equals, tensor for
  tensor, the port loaded through the JAX ``convert_afb_urr_state_dict``
  and ``convert_afb_urr_variables``, and the JAX loader's variables;
- smp's ``Linknet(efficientnet-b4)`` rebuilt with smp's key names
  (``tests/torch_smp.py``, random weights and BN statistics): the port's
  transposed convolution against ``nn.ConvTranspose2d`` and the JAX one;
  the port's ``LinkNetSMP`` against the JAX ``LinkNetSMP`` and the oracle;
  ``load_linknet`` of a whole-model pickle and of a ``state_dict``, both
  written by ``torch.save`` under ``tmp_path``.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.core.convert import (convert_afb_urr_state_dict,
                                        convert_smp_linknet_state_dict,
                                        torch_conv_to_flax)
from vfloodnet_tpu.models.linknet_smp import LinkNetSMP as JLinkNetSMP
from vfloodnet_tpu.models.linknet_smp import TorchConvTranspose2d
from vfloodnet_tpu.pipelines.loaders import load_afb_urr as j_load_afb_urr
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.core.checkpoint import flatten, load_flat_npz
from vfloodnet_tpu_torch.core.convert import convert_linknet_variables
from vfloodnet_tpu_torch.core.convert_ref import (
    afb_urr_state_dict_to_variables, smp_linknet_state_dict_to_variables)
from vfloodnet_tpu_torch.models import LinkNetSMP
from vfloodnet_tpu_torch.models.linknet_smp import ConvTranspose2d
from vfloodnet_tpu_torch.pipelines import load_afb_urr, load_linknet

from torch_smp import TorchLinknetSMP, randomize_

torch.set_num_threads(4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEO_NPZ = os.path.join(REPO, "records", "checkpoints", "video",
                         "best.npz")
_INV_LAYER = {"layer1": "res2", "layer2": "res3", "layer3": "res4"}


def _torch_key(path):
    """A Flax path of the JAX AFBURR -> the reference's state_dict key
    (its module attribute names)."""
    *body, leaf = path.split("/")
    if body[0] in ("encoder_m", "encoder_q") and body[1] == "backbone":
        rest = body[2:]
        if rest[0] in ("conv1", "bn1"):
            body = [body[0], rest[0]]
        else:
            layer, block, mod = rest
            idx = block[len("block"):]
            tail = {"downsample_conv": ["downsample", "0"],
                    "downsample_bn": ["downsample", "1"]}.get(mod, [mod])
            body = [body[0], _INV_LAYER[layer], idx] + tail
    elif body[0] == "keyval_r4":
        body = ["keyval_r4", body[1].capitalize()]
    leaf = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(leaf, leaf)
    return ".".join(body + [leaf])


@pytest.fixture(scope="module")
def reference_sd():
    """A reference-style AFB-URR state_dict with seeded values, shaped
    after the trained checkpoint's Flax tree."""
    flat = flatten(load_flat_npz(VIDEO_NPZ))
    rng = np.random.default_rng(0)
    sd = {}
    for key in sorted(flat):
        coll, path = key.split("/", 1)
        shape = flat[key].shape
        if path.endswith("/kernel"):
            shape = (shape[3], shape[2], shape[0], shape[1])
        w = rng.standard_normal(shape, dtype=np.float32)
        if path.endswith("/var"):
            w = np.abs(w) + 0.5
        sd[_torch_key(path)] = torch.from_numpy(w)
    sd["encoder_m.mean"] = torch.zeros(1, 3, 1, 1)
    sd["encoder_q.std"] = torch.ones(1, 3, 1, 1)
    sd["encoder_m.bn1.num_batches_tracked"] = torch.tensor(7)
    return sd


def _numpy_sd(sd):
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same_tree(got, want):
    got, want = flatten(got), flatten(want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_afb_urr_pth_and_bin_load_as_the_jax_route(reference_sd, tmp_path):
    want_vars = convert_afb_urr_state_dict(_numpy_sd(reference_sd))
    _assert_same_tree(afb_urr_state_dict_to_variables(
        _numpy_sd(reference_sd)), want_vars)
    want = convert_afb_urr_variables(want_vars)
    pth = str(tmp_path / "afb_urr.pth")
    torch.save({"epoch": 3, "model": reference_sd}, pth)
    binf = str(tmp_path / "afb_urr.bin")
    torch.save(reference_sd, binf)
    for path in (pth, binf):
        got = load_afb_urr(path, device="cpu").state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (path, k)
        _, jvars = j_load_afb_urr(path)
        _assert_same_tree(afb_urr_state_dict_to_variables(
            _numpy_sd(reference_sd)), jvars)
    other = tmp_path / "afb_urr.ckpt"
    other.write_bytes(b"")
    with pytest.raises(ValueError):
        load_afb_urr(str(other), device="cpu")
    with pytest.raises(FileNotFoundError):
        load_afb_urr(str(tmp_path / "missing.pth"), device="cpu")


def test_transposed_conv_matches_torch_and_jax():
    """``tests/test_convert_smp.py``'s case: k 4, s 2, p 1."""
    g = torch.Generator().manual_seed(3)
    tc = torch.nn.ConvTranspose2d(8, 12, 4, stride=2, padding=1, bias=False)
    with torch.no_grad():
        tc.weight.normal_(0, 0.1, generator=g)
    x = torch.randn(1, 8, 6, 7, generator=g)
    ref = tc(x).detach()
    kern = torch_conv_to_flax(tc.weight.detach().numpy())   # [4, 4, 12, 8]
    port = ConvTranspose2d(8, 12, 4, stride=2, padding=1, bias=False)
    port.load_state_dict({"weight": convert_linknet_variables(
        {"params": {"tconv": {"kernel": kern}}})["tconv.weight"]})
    with torch.no_grad():
        got = port(x)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    jout = TorchConvTranspose2d(12).apply(
        {"params": {"kernel": jnp.asarray(kern)}},
        jnp.asarray(x.numpy().transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jout).transpose(
        0, 3, 1, 2), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def smp_oracle():
    oracle = TorchLinknetSMP().eval()
    randomize_(oracle, seed=7)
    return oracle


def test_linknet_smp_matches_jax_and_the_oracle(smp_oracle):
    sd = _numpy_sd(smp_oracle.state_dict())
    jvars = convert_smp_linknet_state_dict(sd)
    _assert_same_tree(smp_linknet_state_dict_to_variables(sd), jvars)
    port = LinkNetSMP().eval()
    port.load_state_dict(convert_linknet_variables(jvars, bn_eps=1e-3))
    img01 = np.random.default_rng(5).random((2, 64, 96, 3),
                                            dtype=np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(img01)).numpy()
    want = np.asarray(JLinkNetSMP().apply(jvars, jnp.asarray(img01)))
    assert got.shape == want.shape == (2, 64, 96, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    with torch.no_grad():
        ref = smp_oracle(torch.from_numpy(
            ((img01 - mean) / std).transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got, ref.transpose(0, 2, 3, 1), atol=5e-4)
    with pytest.raises(ValueError):
        port(torch.zeros(1, 48, 64, 3))


def test_load_linknet_reads_smp_pth(smp_oracle, tmp_path):
    want = LinkNetSMP().eval()
    want.load_state_dict(convert_linknet_variables(
        convert_smp_linknet_state_dict(_numpy_sd(smp_oracle.state_dict())),
        bn_eps=1e-3))
    whole = str(tmp_path / "link_efficientb4_model.pth")
    torch.save(smp_oracle, whole)
    sd_path = str(tmp_path / "linknet_sd.pth")
    torch.save(smp_oracle.state_dict(), sd_path)
    for path in (whole, sd_path):
        got = load_linknet(path, device="cpu")
        assert isinstance(got, LinkNetSMP) and not got.training
        sd = got.state_dict()
        for k, v in want.state_dict().items():
            assert torch.equal(sd[k], v), (path, k)
    with pytest.raises(FileNotFoundError):
        load_linknet(str(tmp_path / "absent.pth"), device="cpu")
