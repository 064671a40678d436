"""Detectron2 checkpoint -> the port's detector (counterpart of
``vfloodnet_tpu.core.convert_d2``).

A Detectron2 ``model`` dict (``backbone.bottom_up.res{2..5}.*``,
``backbone.fpn_*``, ``proposal_generator.rpn_head.*``, ``roi_heads.*``) is
mapped onto the JAX package's Generalized R-CNN parameter paths, key for
key as its converter maps them, and then through
:func:`.convert.convert_rcnn_variables`, so a Detectron2 file gives the
port exactly the weights the JAX package would run. That includes the JAX
converter's mask deconvolution: Detectron2's [in, out, kh, kw] weight
becomes the Flax kernel [kh, kw, in, out] unflipped, which the Flax layer
applies flipped relative to Detectron2's ``ConvTranspose2d``, and the
same for the keypoint head's ``score_lowres``. Unknown heads are skipped
with a report.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping

import numpy as np
import torch

from .convert import convert_rcnn_variables

_BLOCK_MODS = {"conv1": ("conv1", "bn1"), "conv2": ("conv2", "bn2"),
               "conv3": ("conv3", "bn3"), "shortcut": ("shortcut",
                                                       "shortcut_bn")}
_RPN_MODS = {"conv": "conv", "objectness_logits": "objectness",
             "anchor_deltas": "deltas"}
_NORM = {"norm.weight": "params/{}/scale", "norm.bias": "params/{}/bias",
         "norm.running_mean": "batch_stats/{}/mean",
         "norm.running_var": "batch_stats/{}/var"}


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


def _dense(w: np.ndarray) -> np.ndarray:
    """Linear [out, in] (or a point head's Conv1d [out, in, 1]) -> [in,
    out]."""
    return (w if w.ndim == 2 else np.squeeze(w, -1)).T


def d2_to_flax(sd: Mapping[str, np.ndarray], with_masks: bool = False,
               with_pointrend: bool = False, with_keypoints: bool = False
               ) -> Dict[str, np.ndarray]:
    """A Detectron2 ``model`` dict -> the JAX package's flat variables
    ('/'-joined ``params/...`` and ``batch_stats/...`` paths)."""
    out: Dict[str, np.ndarray] = {}
    skipped = []

    def layer(fpath, leaf, val, kernel=_hwio):
        if leaf == "weight":
            out[f"params/{fpath}/kernel"] = kernel(val)
        else:
            out[f"params/{fpath}/bias"] = val

    for key, val in sd.items():
        val = np.asarray(val)
        if key.startswith("backbone.bottom_up.stem.conv1."):
            leaf = key.split("stem.conv1.")[1]
            if leaf == "weight":
                layer("backbone/stem_conv", leaf, val)
            elif leaf in _NORM:
                out[_NORM[leaf].format("backbone/stem_bn")] = val
            continue
        m = re.match(r"backbone\.bottom_up\.res(\d)\.(\d+)\.(conv\d|shortcut)"
                     r"\.(.+)", key)
        if m:
            stage, block, mod, leaf = m.groups()
            base = f"backbone/res{stage}_block{block}"
            conv, bn = _BLOCK_MODS[mod]
            if leaf == "weight":
                layer(f"{base}/{conv}", leaf, val)
            elif leaf in _NORM:
                out[_NORM[leaf].format(f"{base}/{bn}")] = val
            continue
        m = re.match(r"backbone\.fpn_(lateral|output)(\d)\.(weight|bias)", key)
        if m:
            kind, lvl, leaf = m.groups()
            layer(f"fpn/{kind}{lvl}", leaf, val)
            continue
        m = re.match(r"proposal_generator\.rpn_head\.(conv|objectness_logits"
                     r"|anchor_deltas)\.(weight|bias)", key)
        if m:
            mod, leaf = m.groups()
            layer(f"rpn/head/{_RPN_MODS[mod]}", leaf, val)
            continue
        m = re.match(r"roi_heads\.box_head\.fc(\d)\.(weight|bias)", key)
        if m:
            idx, leaf = m.groups()
            layer(f"box_head/fc{idx}", leaf, val, _dense)
            continue
        m = re.match(r"roi_heads\.box_predictor\.(cls_score|bbox_pred)"
                     r"\.(weight|bias)", key)
        if m:
            mod, leaf = m.groups()
            layer("box_head/" + ("cls" if mod == "cls_score" else "bbox"),
                  leaf, val, _dense)
            continue
        if with_masks:
            m = re.match(r"roi_heads\.mask_head\.mask_fcn(\d)\.(weight|bias)",
                         key)
            if m:
                idx, leaf = m.groups()
                layer(f"mask_head/conv{int(idx) - 1}", leaf, val)
                continue
            if key.startswith("roi_heads.mask_head.deconv."):
                layer("mask_head/deconv", key.rsplit(".", 1)[1], val,
                      lambda w: np.transpose(w, (2, 3, 0, 1)))
                continue
            if key.startswith("roi_heads.mask_head.predictor."):
                layer("mask_head/predictor", key.rsplit(".", 1)[1], val)
                continue
        if with_pointrend:
            m = re.match(r"roi_heads\.mask_head\.point_head\.fc(\d)"
                         r"\.(weight|bias)", key)
            if m:
                idx, leaf = m.groups()
                layer(f"point_head/fc{int(idx) - 1}", leaf, val, _dense)
                continue
            if key.startswith("roi_heads.mask_head.point_head.predictor."):
                layer("point_head/predictor", key.rsplit(".", 1)[1], val,
                      _dense)
                continue
        if with_keypoints:
            m = re.match(r"roi_heads\.keypoint_head\.conv_fcn(\d)"
                         r"\.(weight|bias)", key)
            if m:
                idx, leaf = m.groups()
                layer(f"keypoint_head/conv{int(idx) - 1}", leaf, val)
                continue
            if key.startswith("roi_heads.keypoint_head.score_lowres."):
                layer("keypoint_head/deconv", key.rsplit(".", 1)[1], val,
                      lambda w: np.transpose(w, (2, 3, 0, 1)))
                continue
        skipped.append(key)
    if skipped:
        print(f"convert_d2: skipped {len(skipped)} keys "
              f"(e.g. {skipped[:4]})")
    return out


def convert_d2_state_dict(sd: Mapping[str, np.ndarray],
                          with_masks: bool = False,
                          with_pointrend: bool = False,
                          with_keypoints: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """A Detectron2 ``model`` dict -> a ``state_dict`` for the port's
    :class:`~vfloodnet_tpu_torch.models.detection.GeneralizedRCNN`."""
    return convert_rcnn_variables(d2_to_flax(sd, with_masks, with_pointrend,
                                             with_keypoints))


def convert_d2_checkpoint(path: str, **kwargs) -> Dict[str, torch.Tensor]:
    """:func:`convert_d2_state_dict` of a Detectron2 ``.pkl`` (a file this
    program's user supplies; unpickling runs its code)."""
    with open(path, "rb") as f:
        blob = pickle.load(f, encoding="latin1")
    return convert_d2_state_dict(blob.get("model", blob), **kwargs)
