"""Weight bridge and AFB-URR modules: the port vs the JAX package with the
bundled trained video weights (records/checkpoints/video/best.npz) at a
64x96 frame. Tolerance: rtol 1e-4, atol 1e-4 (float32 convolutions summed
in another order by XLA and by ATen)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu.core.checkpoint import load_flat_npz as j_load_flat_npz
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu_torch.core import convert_afb_urr_variables, load_flat_npz
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import cast_floating_params, load_afb_urr

torch.set_num_threads(4)
CKPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "records", "checkpoints", "video", "best.npz")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    variables = j_load_flat_npz(CKPT)
    port = load_afb_urr(CKPT, device="cpu")
    return JAFBURR(), variables, port


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(0)
    frame = rng.rand(64, 96, 3).astype(np.float32)
    mask = np.zeros((2, 64, 96), np.float32)
    mask[1, 30:, :] = 1.0
    mask[0] = 1.0 - mask[1]
    return frame, mask


def _nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def test_bridge_uses_every_array_once():
    variables = load_flat_npz(CKPT)
    flat = flatten(variables)
    assert len(flat) == 472
    sd = convert_afb_urr_variables(variables)
    model = AFBURR()
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    port_elems = sum(v.numel() for v in sd.values())
    # the port folds each FrozenBN's (scale, var) pair into one weight
    bn_vars = sum(a.size for k, a in flat.items() if k.endswith("/var"))
    assert port_elems == sum(a.size for a in flat.values()) - bn_vars
    bad = dict(variables, extra={"w": np.zeros(1, np.float32)})
    with pytest.raises(KeyError):
        convert_afb_urr_variables(bad)


def test_frozen_bn_fold():
    variables = load_flat_npz(CKPT)
    sd = convert_afb_urr_variables(variables)
    p = variables["params"]["encoder_q"]["backbone"]["bn1"]
    s = variables["batch_stats"]["encoder_q"]["backbone"]["bn1"]
    np.testing.assert_allclose(sd["encoder_q.backbone.bn1.weight"].numpy(),
                               p["scale"] / np.sqrt(s["var"] + 1e-5),
                               rtol=1e-6)


def test_encoders_and_keyvalue_match_jax(models, inputs):
    jm, variables, port = models
    frame, mask = inputs
    f = frame[None]
    want = jm.apply(variables, jnp.asarray(f),
                    method=lambda m, x: m.encoder_q(x))
    with torch.no_grad():
        got = port.encoder_q(torch.tensor(f).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _nchw(w), **TOL)
    m = mask[1][None, ..., None]
    want_m = jm.apply(variables, jnp.asarray(f), jnp.asarray(m),
                      jnp.asarray(1.0 - m),
                      method=lambda mod, a, b, c: mod.encoder_m(a, b, c))
    tm = torch.tensor(m).permute(0, 3, 1, 2)
    with torch.no_grad():
        got_m = port.encoder_m(torch.tensor(f).permute(0, 3, 1, 2), tm,
                               1.0 - tm)
    for g, w in zip(got_m, want_m):
        np.testing.assert_allclose(g.numpy(), _nchw(w), **TOL)
    want_kv = jm.apply(variables, want[0],
                       method=lambda mod, x: mod.keyval_r4(x))
    with torch.no_grad():
        got_kv = port.keyval_r4(got[0])
    for g, w in zip(got_kv, want_kv):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_memorize_matches_jax(models, inputs):
    jm, variables, port = models
    frame, mask = inputs
    want = jm.apply(variables, jnp.asarray(frame), jnp.asarray(mask),
                    method=jm.memorize)
    with torch.no_grad():
        got = port.memorize(torch.tensor(frame), torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_segment_and_decoder_match_jax(models, inputs):
    """segment = encode_query + bank read + decode_with_memory (Decoder).
    The bank holds what the engine would hold: the memorized features of
    two frames (48 valid slots of 256, random values in the invalid rest).
    Frames of 60x90 exercise the pad / unpad round trip."""
    jm, variables, port = models
    frame, mask = inputs
    rng = np.random.RandomState(1)
    frames = rng.rand(1, 60, 90, 3).astype(np.float32)
    keys = rng.randn(2, 256, 128).astype(np.float32)
    values = rng.randn(2, 256, 512).astype(np.float32)
    for i, f in enumerate((frame, frame[::-1].copy())):
        k4, v4 = jm.apply(variables, jnp.asarray(f), jnp.asarray(mask),
                          method=jm.memorize)
        keys[:, 24 * i:24 * (i + 1)] = np.asarray(k4)
        values[:, 24 * i:24 * (i + 1)] = np.asarray(v4)
    valid = np.zeros((2, 256), bool)
    valid[:, :48] = True
    occ = np.array([48, 48], np.int32)
    score, _, cnt = jm.apply(variables, *map(jnp.asarray,
                                             (frames, keys, values, valid)),
                             False, bank_occ=jnp.asarray(occ),
                             method=jm.segment)
    with torch.no_grad():
        got_score, got_cnt = port.segment(
            *map(torch.tensor, (frames, keys, values, valid)),
            bank_occ=torch.tensor(occ))
    assert got_score.shape == (1, 2, 60, 90)
    # The trained decoder's log-odds reach |score| ~ 400, where float32
    # resolution is 3e-5 and the final logit1 - logit0 cancels: the score is
    # held at 1e-4 of its own scale.
    want = np.asarray(score)
    np.testing.assert_allclose(got_score.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(got_cnt.numpy(), np.asarray(cnt), atol=1.0)
    assert np.asarray(cnt).sum() > 0


def test_cast_floating_params_keeps_biases_and_bn():
    model = cast_floating_params(AFBURR(), torch.bfloat16)
    assert model.keyval_r4.conv.weight.dtype == torch.bfloat16
    assert model.keyval_r4.conv.bias.dtype == torch.float32
    assert model.encoder_q.backbone.bn1.weight.dtype == torch.float32
