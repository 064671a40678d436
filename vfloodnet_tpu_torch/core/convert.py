"""Weight bridge: the JAX package's AFB-URR, LinkNet, Generalized R-CNN and
body-mesh (``BodyMeshRegressor``, ``METRONetwork``) variables -> the
port's ``state_dict``.

Input: the nested dict that :func:`.checkpoint.load_flat_npz` returns (or
the Flax variables themselves, as numpy), ``params/...`` and
``batch_stats/...`` with '/'-joined Flax module paths. Output: a
``state_dict`` for :class:`vfloodnet_tpu_torch.models.AFBURR`.

- Conv kernels go from HWIO to OIHW.
- FrozenBN: ``weight = scale / sqrt(var + 1e-5)``; ``bias`` and ``mean`` are
  kept as they are.
- The memory encoder's stem kernels for the frame, the mask and the inverse
  mask (``conv1``, ``conv1_m``, ``conv1_o``) are concatenated along the
  input channels into one 5-plane stem.
- The key and value heads are concatenated along the output channels into
  one 1024 -> 640 conv.
- ``layerK/blockB`` becomes ``layerK.B``.

Every Flax array is used exactly once; a key left over raises.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

from .checkpoint import flatten

BN_EPS = 1e-5


def _oihw(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def _port_path(path: str) -> str:
    return re.sub(r"/block(\d+)", r".\1", path).replace("/", ".")


def convert_afb_urr_variables(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    flat = flatten(variables)
    used = set()

    def take(key: str) -> np.ndarray:
        if key in used:
            raise KeyError(f"{key} used twice")
        used.add(key)
        return np.asarray(flat[key], np.float32)

    out: Dict[str, np.ndarray] = {}
    stem_m = "params/encoder_m/backbone/conv1/kernel"
    out["encoder_m.backbone.conv1.weight"] = _oihw(np.concatenate(
        [take(stem_m), take("params/encoder_m/conv1_m/kernel"),
         take("params/encoder_m/conv1_o/kernel")], axis=2))
    kv = "params/keyval_r4/"
    out["keyval_r4.conv.weight"] = _oihw(np.concatenate(
        [take(kv + "key/kernel"), take(kv + "value/kernel")], axis=3))
    out["keyval_r4.conv.bias"] = np.concatenate(
        [take(kv + "key/bias"), take(kv + "value/bias")])

    for key in sorted(flat):
        if key in used or not key.startswith("params/"):
            continue
        path, leaf = key[len("params/"):].rsplit("/", 1)
        port = _port_path(path)
        if leaf == "kernel":
            out[port + ".weight"] = _oihw(take(key))
        elif leaf == "bias":
            out[port + ".bias"] = take(key)
        elif leaf == "scale":          # FrozenBN
            var = take(f"batch_stats/{path}/var")
            scale = take(key)
            out[port + ".weight"] = scale * np.reciprocal(
                np.sqrt(var + np.float32(BN_EPS)))
            out[port + ".mean"] = take(f"batch_stats/{path}/mean")
        else:
            raise KeyError(f"unexpected Flax array {key}")

    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def convert_linknet_variables(variables: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's TPU-first ``LinkNet`` variables (EfficientNet-B4
    encoder, flat npz of the bundled image checkpoint) -> a ``state_dict``
    for :class:`vfloodnet_tpu_torch.models.linknet.LinkNet`.

    Paths map one to one (``/`` -> ``.``; the encoder's blocks live under
    ``encoder.blocks``); conv kernels go from HWIO to OIHW (a depthwise
    kernel [k, k, 1, C] becomes [C, 1, k, k]); FrozenBN folds ``scale`` and
    the running ``var`` into ``weight = scale / sqrt(var + 1e-5)``. Every
    Flax array is used exactly once; a key left over raises."""
    flat = flatten(variables)
    out: Dict[str, np.ndarray] = {}
    used = set()
    for key in sorted(flat):
        if not key.startswith("params/"):
            continue
        path, leaf = key[len("params/"):].rsplit("/", 1)
        port = path.replace("/", ".")
        if port.startswith("encoder.stage"):
            port = "encoder.blocks." + port[len("encoder."):]
        arr = np.asarray(flat[key], np.float32)
        used.add(key)
        if leaf == "kernel":
            out[port + ".weight"] = _oihw(arr)
        elif leaf == "bias":
            out[port + ".bias"] = arr
        elif leaf == "scale":          # FrozenBN
            var = np.asarray(flat[f"batch_stats/{path}/var"], np.float32)
            out[port + ".weight"] = arr * np.reciprocal(
                np.sqrt(var + np.float32(BN_EPS)))
            out[port + ".mean"] = np.asarray(
                flat[f"batch_stats/{path}/mean"], np.float32)
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def convert_rcnn_variables(variables: Dict[str, Any]
                           ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``GeneralizedRCNN`` variables (a flat npz, or the
    Flax tree as numpy) -> a ``state_dict`` for
    :class:`vfloodnet_tpu_torch.models.detection.GeneralizedRCNN`.

    Paths map one to one (``/`` -> ``.``). Conv kernels go from HWIO to
    OIHW, dense kernels [in, out] to [out, in] (the heads flatten ROI
    features in the JAX package's (y, x, channel) order, so no weight is
    permuted). A transposed convolution's kernel [kh, kw, in, out] becomes
    ``ConvTranspose2d``'s [in, out, kh, kw], flipped spatially: the Flax
    layer (kernel not transposed) writes input (i, j) times tap
    (1 - a, 1 - b) to output (2i + a, 2j + b). FrozenBN folds ``scale`` and
    the running ``var`` into ``weight = scale / sqrt(var + 1e-5)``. Every
    Flax array is used exactly once; a key left over raises."""
    flat = flatten(variables)
    out: Dict[str, np.ndarray] = {}
    used = set()
    for key in sorted(flat):
        if not key.startswith("params/"):
            continue
        path, leaf = key[len("params/"):].rsplit("/", 1)
        port = path.replace("/", ".")
        arr = np.asarray(flat[key], np.float32)
        used.add(key)
        if leaf == "kernel" and arr.ndim == 4 and path.endswith("deconv"):
            out[port + ".weight"] = np.ascontiguousarray(
                np.transpose(arr, (2, 3, 0, 1))[:, :, ::-1, ::-1])
        elif leaf == "kernel" and arr.ndim == 4:
            out[port + ".weight"] = _oihw(arr)
        elif leaf == "kernel" and arr.ndim == 2:
            out[port + ".weight"] = np.ascontiguousarray(arr.T)
        elif leaf == "bias":
            out[port + ".bias"] = arr
        elif leaf == "scale":          # FrozenBN
            var = np.asarray(flat[f"batch_stats/{path}/var"], np.float32)
            out[port + ".weight"] = arr * np.reciprocal(
                np.sqrt(var + np.float32(BN_EPS)))
            out[port + ".mean"] = np.asarray(
                flat[f"batch_stats/{path}/mean"], np.float32)
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def _mesh_port_path(path: str) -> str:
    """A Flax path of the body-mesh models -> the port's module path: a
    ResNet layer's ``blockN`` is its Sequential's ``N``; the encoder
    stages' ``blockN`` keep their names."""
    return re.sub(r"(layer\d)/block(\d+)", r"\1.\2", path).replace("/", ".")


def convert_metro_variables(variables: Dict[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``METRONetwork``, ``HRNet`` or ``BodyMeshRegressor``
    variables
    (a flat npz, or the Flax tree as numpy; ``params``, ``batch_stats`` and
    METRO's ``smpl`` buffers) -> a ``state_dict`` for
    :class:`vfloodnet_tpu_torch.models.metro.METRONetwork` or
    ``BodyMeshRegressor``.

    Conv kernels go from HWIO to OIHW, dense kernels [in, out] to [out,
    in]. Flax attention's query, key and value kernels [in, heads,
    head_dim] become [heads x head_dim, in] and their biases [heads,
    head_dim] flat; its output kernel [heads, head_dim, out] becomes [out,
    heads x head_dim]. A ``scale`` with running statistics is a FrozenBN
    (``weight = scale / sqrt(var + 1e-5)``), one without a LayerNorm's
    weight. Embeddings and ``smpl`` buffers are kept as they are. Every
    Flax array is used exactly once; a key left over raises."""
    flat = flatten(variables)
    out: Dict[str, np.ndarray] = {}
    used = set()
    for key in sorted(flat):
        kind, _, rest = key.partition("/")
        if kind == "smpl":
            out[rest] = np.asarray(flat[key], np.float32)
            used.add(key)
            continue
        if kind != "params":
            continue
        path, _, leaf = rest.rpartition("/")
        port = _mesh_port_path(path) + "." if path else ""
        arr = np.asarray(flat[key], np.float32)
        used.add(key)
        if leaf == "kernel" and arr.ndim == 4:
            out[port + "weight"] = _oihw(arr)
        elif leaf == "kernel" and arr.ndim == 3 and path.endswith("/out"):
            out[port + "weight"] = np.ascontiguousarray(
                arr.reshape(-1, arr.shape[-1]).T)
        elif leaf == "kernel" and arr.ndim == 3:
            out[port + "weight"] = np.ascontiguousarray(
                arr.reshape(arr.shape[0], -1).T)
        elif leaf == "kernel":
            out[port + "weight"] = np.ascontiguousarray(arr.T)
        elif leaf == "bias":
            out[port + "bias"] = arr.reshape(-1)
        elif leaf == "scale" and f"batch_stats/{path}/var" in flat:
            var = np.asarray(flat[f"batch_stats/{path}/var"], np.float32)
            out[port + "weight"] = arr * np.reciprocal(
                np.sqrt(var + np.float32(BN_EPS)))
            out[port + "mean"] = np.asarray(
                flat[f"batch_stats/{path}/mean"], np.float32)
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        elif leaf == "scale":          # LayerNorm
            out[port + "weight"] = arr
        else:                          # token and position embeddings
            out[port + leaf] = arr
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}

