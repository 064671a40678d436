"""METRO (MeshTransformer) checkpoints -> the port's body-mesh models
(counterpart of ``vfloodnet_tpu.core.convert_metro``).

A METRO ``state_dict`` (``.bin``/``.pth``) is mapped onto the JAX
package's ``METRONetwork`` variables key for key as its converter maps
them (:func:`metro_to_flax`, :func:`hrnet_to_flax`: numpy copies of
``convert_metro_state_dict`` and ``convert_hrnet_state_dict``), then
through :func:`.convert.convert_metro_variables`, so a METRO file gives the
port exactly the weights the JAX package would run.

torch key layout (METRO_Network, MeshTransformer):
  trans_encoder.{s}.bert.img_embedding.{weight,bias}
  trans_encoder.{s}.bert.position_embeddings.weight
  trans_encoder.{s}.bert.encoder.layer.{l}.attention.self.{query,key,value}.*
  trans_encoder.{s}.bert.encoder.layer.{l}.attention.output.dense.*
  trans_encoder.{s}.bert.encoder.layer.{l}.attention.output.LayerNorm.*
  trans_encoder.{s}.bert.encoder.layer.{l}.intermediate.dense.*
  trans_encoder.{s}.bert.encoder.layer.{l}.output.dense.*
  trans_encoder.{s}.bert.encoder.layer.{l}.output.LayerNorm.*
  trans_encoder.{s}.cls_head.* / trans_encoder.{s}.residual.*
  upsampling.* / upsampling2.*
  cam_param_fc.* / cam_param_fc2.* / cam_param_fc3.*
  backbone.{0,1,4,5,6,7}.*        (torchvision arch: Sequential(children[:-2]))
  backbone.{conv1,stage2,...}.*   (cls_hrnet HRNet-W64)

SMPL's buffers (template joints and vertices, the H36M joint regressor) are
not in the state dict (SMPL's files are licensed data): ``smpl_buffers``
fills them, zeros otherwise.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .convert import convert_metro_variables


def torch_conv_to_flax(w: np.ndarray) -> np.ndarray:
    """torch conv weight [O, I, kh, kw] -> flax [kh, kw, I, O]."""
    return np.transpose(w, (2, 3, 1, 0))


def _set(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


_SEQ_TO_RESNET = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                  "6": "layer3", "7": "layer4"}

_BERT_SUB = {
    "attention.self.query": "attention/query",
    "attention.self.key": "attention/key",
    "attention.self.value": "attention/value",
    "attention.output.dense": "attention/out_dense",
    "attention.output.LayerNorm": "attention/out_ln",
    "intermediate.dense": "intermediate_dense",
    "output.dense": "output_dense",
    "output.LayerNorm": "output_ln",
}


def _dense(params, path, leaf, w):
    if leaf == "weight":
        _set(params, f"{path}/kernel", np.transpose(w))   # [out,in]->[in,out]
    else:
        _set(params, f"{path}/bias", w)


def _layernorm(params, path, leaf, w):
    _set(params, f"{path}/{'scale' if leaf == 'weight' else 'bias'}", w)


def _resnet_leaf(params, stats, flax_path, leaf, w):
    if leaf == "weight":
        if w.ndim == 4:
            _set(params, f"{flax_path}/kernel", torch_conv_to_flax(w))
        else:
            _set(params, f"{flax_path}/scale", w)
    elif leaf == "bias":
        _set(params, f"{flax_path}/bias", w)
    elif leaf == "running_mean":
        _set(stats, f"{flax_path}/mean", w)
    elif leaf == "running_var":
        _set(stats, f"{flax_path}/var", w)


def _map_hrnet_key(rest: str) -> Optional[str]:
    """Map a cls_hrnet(-featmaps) module path (leaf stripped) onto the Flax
    :class:`vfloodnet_tpu.models.hrnet.HRNet` path. Layout: the public
    HRNet-Image-Classification ``cls_hrnet.py``, which MeshTransformer
    vendors for METRO's HRNet-w64 backbone
    (reference scripts/inference_bodymesh.py:228-293)."""
    parts = rest.split(".")

    def cb(idx: str) -> str:
        return "conv" if idx == "0" else "bn"

    if parts[0] in ("conv1", "bn1", "conv2", "bn2"):
        return parts[0]
    if parts[0] == "layer1" and len(parts) >= 3:
        if parts[2] == "downsample":
            return f"layer1_{parts[1]}/downsample_{cb(parts[3])}"
        return f"layer1_{parts[1]}/{parts[2]}"
    m = re.match(r"transition(\d)$", parts[0])
    if m and len(parts) >= 3:
        # existing branch: transitionX.{b}.{0|1}; new branch (one extra
        # Sequential level): transitionX.{b}.0.{0|1}
        idx = parts[2] if len(parts) == 3 else parts[3]
        return f"transition{m.group(1)}_{parts[1]}_{cb(idx)}"
    m = re.match(r"stage(\d)$", parts[0])
    if m and len(parts) >= 3:
        s, mod = m.group(1), parts[1]
        if parts[2] == "branches" and len(parts) >= 6:
            return f"stage{s}_{mod}/branch{parts[3]}_block{parts[4]}" \
                   f"/{parts[5]}"
        if parts[2] == "fuse_layers" and len(parts) >= 6:
            i, j = parts[3], parts[4]
            if int(j) > int(i):                    # 1x1 up path
                return f"stage{s}_{mod}/fuse{i}_{j}_{cb(parts[5])}"
            if len(parts) >= 7:                    # strided down chain
                return (f"stage{s}_{mod}/fuse{i}_{j}_"
                        f"{cb(parts[6])}{parts[5]}")
    if parts[0] == "incre_modules" and len(parts) >= 4:
        if parts[3] == "downsample":
            return f"incre{parts[1]}/downsample_{cb(parts[4])}"
        return f"incre{parts[1]}/{parts[3]}"
    if parts[0] == "downsamp_modules" and len(parts) >= 3:
        return f"downsamp{parts[1]}_{cb(parts[2])}"
    if parts[0] == "final_layer" and len(parts) >= 2:
        return f"final_{cb(parts[1])}"
    return None


def hrnet_to_flax(sd: Mapping[str, np.ndarray], prefix: str = ""
                  ) -> Dict[str, Any]:
    """A cls_hrnet(-featmaps) state dict (optionally ``prefix``-ed, e.g.
    ``backbone.``) -> the JAX package's HRNet variables {'params',
    'batch_stats'}."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    unmapped = []
    for key, value in sd.items():
        if prefix and not key.startswith(prefix):
            continue
        rest = key[len(prefix):]
        leaf = rest.split(".")[-1]
        if leaf == "num_batches_tracked":
            continue
        path = _map_hrnet_key(rest.rsplit(".", 1)[0])
        if path is None:
            unmapped.append(key)
            continue
        _resnet_leaf(params, stats, path, leaf, np.asarray(value))
    if unmapped:
        raise ValueError(f"unmapped HRNet keys ({len(unmapped)}): "
                         f"{unmapped[:8]}...")
    return {"params": params, "batch_stats": stats}


def _is_hrnet_layout(sd: Mapping[str, np.ndarray]) -> bool:
    return any(k.startswith("backbone.stage2.") for k in sd) and \
        any(k.startswith("backbone.conv1.") for k in sd)


def metro_to_flax(sd: Mapping[str, np.ndarray],
                  smpl_buffers: Optional[Dict[str, np.ndarray]] = None,
                  skip_backbone: bool = False) -> Dict[str, Any]:
    """A METRO_Network state dict -> the JAX package's METRONetwork
    variables {'params', 'batch_stats', 'smpl'}.

    ``skip_backbone``: drop backbone.* keys (unknown trunk layouts; the
    transformer stages, upsampling and camera heads still convert). Both
    the torchvision-Sequential ResNet layout and the cls_hrnet HRNet-w64
    layout (detected automatically) convert fully.
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    unmapped = []
    hrnet = _is_hrnet_layout(sd)

    for key, value in sd.items():
        w = np.asarray(value)
        leaf = key.split(".")[-1]
        if leaf == "num_batches_tracked":
            continue

        m = re.match(r"trans_encoder\.(\d+)\.(.+)\.(weight|bias)$", key)
        if m:
            stage, rest, leaf = m.groups()
            base = f"stage{stage}"
            if rest == "bert.img_embedding":
                _dense(params, f"{base}/img_embedding", leaf, w)
            elif rest == "bert.position_embeddings":
                _set(params, f"{base}/position_embeddings", w)
            elif rest in ("cls_head", "residual"):
                _dense(params, f"{base}/{rest}", leaf, w)
            else:
                lm = re.match(r"bert\.encoder\.layer\.(\d+)\.(.+)$", rest)
                if lm and lm.group(2) in _BERT_SUB:
                    li, sub = lm.groups()
                    flax_sub = _BERT_SUB[sub]
                    path = f"{base}/layer{li}/{flax_sub}"
                    if flax_sub.endswith("_ln"):
                        _layernorm(params, path, leaf, w)
                    else:
                        _dense(params, path, leaf, w)
                else:
                    unmapped.append(key)
            continue

        m = re.match(r"(upsampling2?|cam_param_fc[23]?)\.(weight|bias)$", key)
        if m:
            _dense(params, m.group(1), m.group(2), w)
            continue

        if key.startswith("backbone."):
            if skip_backbone:
                continue
            if hrnet:
                rest = key[len("backbone."):]
                path = _map_hrnet_key(rest.rsplit(".", 1)[0])
                if path is None:
                    unmapped.append(key)
                else:
                    _resnet_leaf(params, stats, f"backbone/{path}", leaf, w)
                continue
            m = re.match(r"backbone\.(\d+)\.(.*)$", key)
            if m and m.group(1) in _SEQ_TO_RESNET:
                mod = _SEQ_TO_RESNET[m.group(1)]
                rest = m.group(2)
                if not rest:
                    unmapped.append(key)
                    continue
                if mod in ("conv1", "bn1"):
                    flax_path = f"backbone/{mod}"
                    _resnet_leaf(params, stats, flax_path, leaf, w)
                    continue
                bm = re.match(r"(\d+)\.(.+)\.([^.]+)$", rest)
                if bm:
                    block, tail, leaf2 = bm.groups()
                    dm = re.match(r"downsample\.(\d)$", tail)
                    if dm:
                        sub = ("downsample_conv" if dm.group(1) == "0"
                               else "downsample_bn")
                    else:
                        sub = tail
                    _resnet_leaf(params, stats,
                                 f"backbone/{mod}/block{block}/{sub}",
                                 leaf2, w)
                    continue
            unmapped.append(key)
            continue

        unmapped.append(key)

    if unmapped:
        raise ValueError(f"unmapped METRO keys ({len(unmapped)}): "
                         f"{unmapped[:8]}...")

    smpl = {
        "template_joints": np.zeros((14, 3), np.float32),
        "template_vertices_sub2": np.zeros((431, 3), np.float32),
        "j_regressor_h36m": np.zeros((17, 6890), np.float32),
    }
    if smpl_buffers:
        smpl.update({k: np.asarray(v, np.float32)
                     for k, v in smpl_buffers.items()})
    return {"params": params, "batch_stats": stats, "smpl": smpl}



def convert_hrnet_state_dict(sd: Mapping[str, np.ndarray], prefix: str = ""
                             ) -> Dict[str, torch.Tensor]:
    """A cls_hrnet(-featmaps) state dict -> a ``state_dict`` for
    :class:`vfloodnet_tpu_torch.models.hrnet.HRNet`."""
    return convert_metro_variables(hrnet_to_flax(sd, prefix))


def convert_metro_state_dict(sd: Mapping[str, np.ndarray],
                             smpl_buffers: Optional[Dict[str, np.ndarray]]
                             = None, skip_backbone: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """A METRO_Network state dict -> a ``state_dict`` for
    :class:`vfloodnet_tpu_torch.models.metro.METRONetwork` (without the
    backbone's keys when ``skip_backbone``)."""
    return convert_metro_variables(metro_to_flax(sd, smpl_buffers,
                                                 skip_backbone))
