"""The bf16 configuration with trained weights, and the weight cast, on
the CPU.

- ``cast_floating_params`` returns a copy with bf16 conv kernels and
  float32 biases, and leaves the caller's float32 model as it was.
- The trained bf16 engine on the lake clip at 240 px against the JAX bf16
  engine on the same clip: the port's lowest and mean per-frame IoU
  against the ground truth each no more than 0.01 below the JAX bf16
  engine's. IoU >= 0.75 on every frame, the float32 bar of
  tests/test_demo_e2e.py, holds for neither engine in bf16 (the JAX bf16
  engine's lowest frame is 0.736): bf16 labels move with the summation
  order of the convolutions, so the port is held to the reference
  configuration.
"""

import os
from glob import glob

import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.pipelines.loaders import load_afb_urr as j_load_afb_urr
from vfloodnet_tpu.pipelines.video_seg import VideoSegEngine as JEngine
from vfloodnet_tpu.pipelines.video_seg import \
    host_largest_cc as j_host_largest_cc
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import cast_floating_params, load_afb_urr
from vfloodnet_tpu_torch.pipelines.video_seg import (VideoSegEngine,
                                                     host_largest_cc)

torch.set_num_threads(4)
BF = torch.bfloat16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = os.path.join(REPO, "records", "demo_eval", "lake")


def test_cast_floating_params_leaves_the_callers_model():
    model = AFBURR()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    cast = cast_floating_params(model, BF)
    assert cast is not model
    for name, param in model.named_parameters():
        assert param.dtype == torch.float32, name
        assert torch.equal(param, before[name]), name
    assert cast.keyval_r4.conv.weight.dtype == BF
    assert cast.encoder_m.backbone.conv1.weight.dtype == BF
    assert cast.keyval_r4.conv.bias.dtype == torch.float32
    assert cast.decoder.RF2.convFS.bias.dtype == torch.float32
    torch.testing.assert_close(cast.keyval_r4.conv.weight,
                               model.keyval_r4.conv.weight.to(BF),
                               rtol=0, atol=0)


def _iou(a, b):
    a, b = a > 0, b > 0
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


def test_trained_bf16_engine_on_lake_clip_matches_jax_bf16():
    from PIL import Image

    from vfloodnet_tpu_torch.utils import load_mask

    paths = sorted(glob(os.path.join(EVAL, "frames", "*.jpg")),
                   key=lambda p: int(os.path.splitext(
                       os.path.basename(p))[0]))
    masks = [load_mask(os.path.join(EVAL, "masks", os.path.splitext(
        os.path.basename(p))[0] + ".png")) for p in paths]
    imgs = [np.asarray(Image.open(p).convert("RGB"), np.uint8)
            for p in paths]

    jm, jvars = j_load_afb_urr(None, dtype=jnp.bfloat16)
    jeng = JEngine(jm, jvars, JFeatureBank(obj_n=2, memory_budget=65_536,
                                           dtype=jnp.bfloat16),
                   downsample=240, postprocess="host")
    teng = VideoSegEngine(load_afb_urr(device="cpu", dtype=BF),
                          FeatureBank(obj_n=2, memory_budget=65_536,
                                      dtype=BF, device="cpu"),
                          downsample=240, postprocess="host")
    js = jeng.bootstrap(imgs[0], masks[0])
    ts = teng.bootstrap(imgs[0], masks[0])
    j_ious, t_ious = [], []
    for i, img in enumerate(imgs[1:]):
        js, jl = jeng.step(js, img, i + 1)
        ts, tl = teng.step(ts, img, i + 1)
        j_ious.append(_iou(j_host_largest_cc(jeng.fetch_label(jl)),
                           masks[i + 1]))
        t_ious.append(_iou(host_largest_cc(teng.fetch_label(tl)),
                           masks[i + 1]))
    assert min(t_ious) >= min(j_ious) - 0.01, (t_ious, j_ious)
    assert np.mean(t_ious) >= np.mean(j_ious) - 0.01, (t_ious, j_ious)
