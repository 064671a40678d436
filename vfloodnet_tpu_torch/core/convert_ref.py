"""The reference's PyTorch weight files -> the JAX package's Flax layout
(numpy copies of ``convert_afb_urr_state_dict`` and
``convert_smp_linknet_state_dict`` of ``vfloodnet_tpu.core.convert``,
which the port may not import). The weight bridge (:mod:`.convert`) then
carries the Flax layout into the port's modules, so a reference file and
the JAX package's own checkpoints take one road.

- AFB-URR: the reference trainer's ``.pth`` (a dict holding ``model``, a
  ``state_dict``; or a bare ``state_dict``, as ``.pth`` or ``.bin``);
- LinkNet: segmentation_models_pytorch's ``Linknet(efficientnet-b4)``,
  pickled whole (the reference's image model) or as a ``state_dict``.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Mapping

import numpy as np

_LAYER_MAP = {"res2": "layer1", "res3": "layer2", "res4": "layer3"}


def _set(tree: Dict[str, Any], path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def _map_resnet_key(rest: str) -> str:
    """A torchvision ResNet sub-key inside an encoder (``conv1.weight``,
    ``res3.2.bn1.bias``, ``res2.0.downsample.0.weight``) -> its Flax path
    under ``backbone``, or '' if it is not one."""
    m = re.match(r"(conv1|bn1)\.(.+)", rest)
    if m:
        return f"{m.group(1)}/{m.group(2)}"
    m = re.match(r"(res2|res3|res4)\.(\d+)\.(.+)", rest)
    if not m:
        return ""
    layer, block, tail = m.groups()
    prefix = f"{_LAYER_MAP[layer]}/block{block}"
    tm = re.match(r"(conv\d|bn\d)\.(.+)", tail)
    if tm:
        return f"{prefix}/{tm.group(1)}/{tm.group(2)}"
    dm = re.match(r"downsample\.(\d)\.(.+)", tail)
    if dm:
        mod = "downsample_conv" if dm.group(1) == "0" else "downsample_bn"
        return f"{prefix}/{mod}/{dm.group(2)}"
    return ""


def _leaf(path: str, leaf: str, w: np.ndarray):
    """(collection, Flax path, array) of one torch leaf, or (None, ...)
    for ``num_batches_tracked``. Conv weights [O, I, kh, kw] (and the
    transposed conv's [in, out, kh, kw]) go to [kh, kw, I, O] by the same
    permutation; a BN weight is its ``scale``."""
    if leaf == "weight":
        if w.ndim == 4:
            return ("params", path[:-len("weight")] + "kernel",
                    np.transpose(w, (2, 3, 1, 0)))
        return "params", path[:-len("weight")] + "scale", w
    if leaf == "bias":
        return "params", path, w
    if leaf == "running_mean":
        return "batch_stats", path[:-len("running_mean")] + "mean", w
    if leaf == "running_var":
        return "batch_stats", path[:-len("running_var")] + "var", w
    if leaf == "num_batches_tracked":
        return None, None, None
    raise ValueError(f"unhandled leaf {leaf} at {path}")


def _to_variables(items) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for path, w in items:
        coll, final, arr = _leaf(path, path.rsplit("/", 1)[-1], w)
        if coll is not None:
            _set(tree[coll], final, np.asarray(arr, np.float32))
    return tree


def afb_urr_state_dict_to_variables(sd: Mapping[str, Any]
                                    ) -> Dict[str, Any]:
    """A reference AFB-URR ``state_dict`` -> the JAX package's
    ``{'params', 'batch_stats'}`` for its ``AFBURR``. The encoders'
    normalisation buffers (``mean``, ``std``) are skipped; an unknown key
    raises."""
    items = []
    for key, value in sd.items():
        value = np.asarray(value)
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith(("encoder_m.", "encoder_q.")):
            enc, rest = key.split(".", 1)
            if rest in ("mean", "std"):
                continue
            if rest.startswith(("conv1_m.", "conv1_o.")):
                path = f"{enc}/" + rest.replace(".", "/")
            else:
                mapped = _map_resnet_key(rest)
                if not mapped:
                    raise ValueError(f"unmapped encoder key: {key}")
                path = f"{enc}/backbone/{mapped}"
        elif key.startswith("keyval_r4."):
            _, head, sub = key.split(".")
            path = f"keyval_r4/{head.lower()}/{sub}"
        elif key.startswith("decoder."):
            path = "decoder/" + key[len("decoder."):].replace(".", "/")
        else:
            raise ValueError(f"unmapped key: {key}")
        items.append((path, value))
    return _to_variables(items)


# efficientnet-pytorch B4 block repeats (depth 1.8 over B0's [1, 2, 2, 3,
# 3, 4, 1]): the encoder's flat ``_blocks`` list -> stage{s}_block{b}
_B4_REPS = [2, 4, 4, 6, 6, 8, 2]
_ENC_SKIP = ("_conv_head.", "_bn1.", "_fc.")   # not in smp's pyramid
_BLOCK_MODS = {"_expand_conv": "expand_conv", "_bn0": "expand_bn",
               "_depthwise_conv": "dw_conv", "_bn1": "dw_bn",
               "_se_reduce": "se/reduce", "_se_expand": "se/expand",
               "_project_conv": "project_conv", "_bn2": "project_bn"}
_DEC_MODS = {"0": ("conv1", "bn1"), "1": ("tconv", "bn2"),
             "2": ("conv3", "bn3")}


def _map_smp_encoder_key(rest: str) -> str:
    """An efficientnet-pytorch sub-key (after ``encoder.``) -> its Flax
    path, or '' for the head's keys, which smp's pyramid does not use."""
    if rest.startswith("_conv_stem."):
        return "encoder/stem_conv/" + rest.split(".", 1)[1]
    if rest.startswith("_bn0."):
        return "encoder/stem_bn/" + rest.split(".", 1)[1]
    if rest.startswith(_ENC_SKIP):
        return ""
    m = re.match(r"_blocks\.(\d+)\.(.+)", rest)
    if not m:
        raise ValueError(f"unmapped smp encoder key: {rest}")
    flat, tail = int(m.group(1)), m.group(2)
    acc = 0
    for si, reps in enumerate(_B4_REPS):
        if flat < acc + reps:
            break
        acc += reps
    else:
        raise ValueError(f"block index {flat} beyond B4's "
                         f"{sum(_B4_REPS)} blocks")
    mod, leaf = tail.split(".", 1)
    if mod not in _BLOCK_MODS:
        raise ValueError(f"unmapped smp block module: {tail}")
    return f"encoder/stage{si}_block{flat - acc}/{_BLOCK_MODS[mod]}/{leaf}"


def smp_linknet_state_dict_to_variables(sd: Mapping[str, Any]
                                        ) -> Dict[str, Any]:
    """An smp ``Linknet(efficientnet-b4)`` ``state_dict`` -> the JAX
    package's variables for its ``LinkNetSMP``. Decoder block ``j``'s
    ``block.{0,1,2}`` are (Conv2dReLU, TransposeX2, Conv2dReLU), each a
    (conv, bn, relu) Sequential; ``segmentation_head.0`` is the head."""
    items = []
    for key, value in sd.items():
        value = np.asarray(value)
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("encoder."):
            path = _map_smp_encoder_key(key[len("encoder."):])
            if not path:
                continue
        elif key.startswith("decoder.blocks."):
            m = re.match(r"decoder\.blocks\.(\d)\.block\.([012])\.([01])\."
                         r"(.+)", key)
            if not m:
                raise ValueError(f"unmapped smp decoder key: {key}")
            j, seq, idx, sub = m.groups()
            path = f"decoder/block{j}/{_DEC_MODS[seq][int(idx)]}/{sub}"
        elif key.startswith("segmentation_head.0."):
            path = "decoder/head/" + key[len("segmentation_head.0."):]
        else:
            raise ValueError(f"unmapped smp key: {key}")
        items.append((path, value))
    return _to_variables(items)


def _numpy_state_dict(blob) -> Dict[str, np.ndarray]:
    sd = blob.state_dict() if hasattr(blob, "state_dict") else blob
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in sd.items()}


def read_afb_urr_pth(path: str) -> Dict[str, Any]:
    """A reference AFB-URR ``.pth`` / ``.bin`` -> the JAX package's
    variables. The file holds tensors and numbers only, so it is read
    with ``weights_only=True``."""
    import torch
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob:
        blob = blob["model"]
    return afb_urr_state_dict_to_variables(_numpy_state_dict(blob))


def read_smp_linknet_pth(path: str) -> Dict[str, Any]:
    """The reference's smp LinkNet ``.pth`` -> the JAX package's
    ``LinkNetSMP`` variables. A ``state_dict`` is read with
    ``weights_only=True``; the reference's whole-model pickle cannot be
    (it holds smp's classes, which must then be importable), so that file
    is unpickled in full: open only such a file from a source you
    trust."""
    import torch
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        blob = torch.load(path, map_location="cpu", weights_only=False)
    return smp_linknet_state_dict_to_variables(_numpy_state_dict(blob))
