"""Weight bridge: the JAX package's AFB-URR, LinkNet (both layouts),
Generalized R-CNN, body-mesh (``BodyMeshRegressor``, ``METRONetwork``)
and PSPNet variables -> the port's ``state_dict``, and the training forms'
``state_dict`` back to the JAX flat layout (``export_*_variables``).

With ``trainable_bn`` a converter fills a training form instead, whose
BatchNorms (``models/resnet.py::TrainBN``) keep ``scale``, ``bias``,
``mean`` and ``var`` as they are; its ``export_*`` is the exact inverse.

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
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .checkpoint import flatten

BN_EPS = 1e-5
KEYDIM = 128     # AFB-URR's key width: the fused key-value conv splits here


def _oihw(kernel: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def _port_path(path: str) -> str:
    return re.sub(r"/block(\d+)", r".\1", path).replace("/", ".")


def _bn(flat: Dict[str, Any], path: str, port: str, scale: np.ndarray,
        trainable_bn: bool, eps: float = BN_EPS) -> Dict[str, np.ndarray]:
    """A FrozenBN's leaves under the port prefix ``port`` (ending in
    '.', or empty): folded, ``weight = scale / sqrt(var + eps)`` and
    ``mean``, or with ``trainable_bn`` ``scale``, ``mean`` and ``var``."""
    mean = np.asarray(flat[f"batch_stats/{path}/mean"], np.float32)
    var = np.asarray(flat[f"batch_stats/{path}/var"], np.float32)
    if trainable_bn:
        return {port + "scale": scale, port + "mean": mean,
                port + "var": var}
    return {port + "weight": scale * np.reciprocal(
        np.sqrt(var + np.float32(eps))), port + "mean": mean}


def _hwio(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _flax_path(path: str) -> str:
    """A port module path -> its Flax path: a Sequential's ``N`` is the
    Flax ``blockN``."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"/block\1", path).replace(".", "/")


def _export(state_dict: Dict[str, torch.Tensor],
            flax_path: Callable[[str], str] = _flax_path,
            kernel: Optional[Callable[[str, np.ndarray], np.ndarray]] = None,
            bias: Optional[Callable[[str, np.ndarray], np.ndarray]] = None
            ) -> Dict[str, np.ndarray]:
    """A training form's ``state_dict`` (or its gradients, under the same
    names) -> the JAX flat layout, float32 numpy: a ``weight`` of two or
    more axes is a kernel (4-d HWIO, 2-d transposed, or ``kernel(path,
    w)``), one of one axis a LayerNorm's ``scale``; ``mean`` and ``var``
    go to ``batch_stats``; ``bias`` (or ``bias(path, b)``), ``scale`` and
    other leaves to ``params`` as they are."""
    out: Dict[str, np.ndarray] = {}
    for name, t in state_dict.items():
        arr = t.detach().cpu().numpy().astype(np.float32)
        path, _, leaf = name.rpartition(".")
        pre = flax_path(path) + "/" if path else ""
        if leaf == "weight" and arr.ndim >= 2:
            w = kernel(path, arr) if kernel else None
            if w is None:
                w = _hwio(arr) if arr.ndim == 4 else arr.T
            out[f"params/{pre}kernel"] = w
        elif leaf == "weight":
            out[f"params/{pre}scale"] = arr
        elif leaf in ("mean", "var"):
            out[f"batch_stats/{pre}{leaf}"] = arr
        elif leaf == "bias" and bias is not None:
            out[f"params/{pre}bias"] = bias(path, arr)
        else:
            out[f"params/{pre}{leaf}"] = arr
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def convert_afb_urr_variables(variables: Dict[str, Any],
                              trainable_bn: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's AFB-URR variables -> a ``state_dict`` for
    ``AFBURR()``, or with ``trainable_bn`` for the training form
    ``AFBURR(trainable_bn=True)``, whose BatchNorms keep ``scale``,
    ``bias``, ``mean`` and ``var`` as they are (nothing is folded; the
    inverse is :func:`export_afb_urr_variables`)."""
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
            out.update(_bn(flat, path, port + ".", take(key), trainable_bn))
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")

    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def export_afb_urr_variables(state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_afb_urr_variables(..., trainable_bn=True)``:
    the training form's ``state_dict`` (or its parameters' gradients,
    under the same names) -> the JAX package's flat layout,
    ``{"params/...": array, "batch_stats/...": array}`` with '/'-joined
    Flax paths, float32 numpy. The 5-plane stem splits back into
    ``conv1``, ``conv1_m`` and ``conv1_o``, the fused key-value conv into
    ``key`` and ``value``; kernels go back to HWIO. Every entry is used
    exactly once."""
    state = dict(state_dict)
    out: Dict[str, np.ndarray] = {}
    stem = state.pop("encoder_m.backbone.conv1.weight", None)
    if stem is not None:
        w = _hwio(stem.detach().cpu().numpy().astype(np.float32))
        out["params/encoder_m/backbone/conv1/kernel"] = w[:, :, :3]
        out["params/encoder_m/conv1_m/kernel"] = w[:, :, 3:4]
        out["params/encoder_m/conv1_o/kernel"] = w[:, :, 4:5]
    for leaf, kind in (("weight", "kernel"), ("bias", "bias")):
        t = state.pop(f"keyval_r4.conv.{leaf}", None)
        if t is None:
            continue
        t = t.detach().cpu().numpy()
        t = _hwio(t) if leaf == "weight" else t
        out[f"params/keyval_r4/key/{kind}"] = t[..., :KEYDIM]
        out[f"params/keyval_r4/value/{kind}"] = t[..., KEYDIM:]
    out.update(_export(state))
    return {k: np.ascontiguousarray(v, np.float32) for k, v in out.items()}


def convert_linknet_variables(variables: Dict[str, Any],
                              bn_eps: float = BN_EPS,
                              trainable_bn: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """The JAX package's TPU-first ``LinkNet`` variables (EfficientNet-B4
    encoder, flat npz of the bundled image checkpoint) -> a ``state_dict``
    for :class:`vfloodnet_tpu_torch.models.linknet.LinkNet`, and likewise
    the ``LinkNetSMP`` variables (``bn_eps`` 1e-3, efficientnet-pytorch's)
    for :class:`vfloodnet_tpu_torch.models.linknet_smp.LinkNetSMP`.

    Paths map one to one (``/`` -> ``.``; the encoder's blocks live under
    ``encoder.blocks``); conv kernels go from HWIO to OIHW (a depthwise
    kernel [k, k, 1, C] becomes [C, 1, k, k]); the smp decoder's
    ``tconv`` kernel, stored [kh, kw, out, in] for a torch-exact
    transposed convolution, goes back to ``ConvTranspose2d``'s [in, out,
    kh, kw]; FrozenBN folds ``scale`` and the running ``var`` into
    ``weight = scale / sqrt(var + bn_eps)`` (kept unfolded for the
    training form with ``trainable_bn``; the inverse is
    :func:`export_linknet_variables`). Every Flax array is used exactly
    once; a key left over raises."""
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
        if leaf == "kernel" and path.endswith("tconv"):
            out[port + ".weight"] = np.ascontiguousarray(
                np.transpose(arr, (3, 2, 0, 1)))
        elif leaf == "kernel":
            out[port + ".weight"] = _oihw(arr)
        elif leaf == "bias":
            out[port + ".bias"] = arr
        elif leaf == "scale":          # FrozenBN
            out.update(_bn(flat, path, port + ".", arr, trainable_bn,
                           bn_eps))
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def export_linknet_variables(state_dict: Dict[str, torch.Tensor]
                             ) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_linknet_variables(..., trainable_bn=True)``
    for the TPU-first ``LinkNet``: the training form's ``state_dict`` (or
    its gradients) -> the JAX flat layout (the encoder's
    ``encoder.blocks.stageS_blockB`` is the Flax ``encoder/stageS_blockB``;
    a depthwise kernel [C, 1, k, k] goes back to [k, k, 1, C])."""
    return _export(state_dict, lambda p: p.replace(
        "encoder.blocks.", "encoder.").replace(".", "/"))


def convert_rcnn_variables(variables: Dict[str, Any],
                           trainable_bn: bool = False
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
    the running ``var`` into ``weight = scale / sqrt(var + 1e-5)`` (kept
    unfolded for the training form with ``trainable_bn``; the inverse is
    :func:`export_rcnn_variables`). Every Flax array is used exactly once;
    a key left over raises."""
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
            out.update(_bn(flat, path, port + ".", arr, trainable_bn))
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def export_rcnn_variables(state_dict: Dict[str, torch.Tensor]
                          ) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_rcnn_variables(..., trainable_bn=True)``:
    the training form's ``state_dict`` (or its gradients) -> the JAX flat
    layout; a transposed convolution's kernel is flipped back and
    returned to [kh, kw, in, out]."""
    def kernel(path, w):
        if path.endswith("deconv"):
            return np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1))
        return None
    return _export(state_dict, lambda p: p.replace(".", "/"), kernel)


def convert_pspnet_variables(variables: Dict[str, Any],
                             trainable_bn: bool = False
                             ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``PSPNet`` variables (a flat npz, or the Flax tree
    as numpy) -> a ``state_dict`` for
    :class:`vfloodnet_tpu_torch.models.pspnet.PSPNet`, whose module names
    are the Flax ones (``/`` -> ``.``). Conv kernels go from HWIO to OIHW;
    FrozenBN folds ``scale`` and the running ``var`` into ``weight = scale
    / sqrt(var + 1e-5)`` (kept unfolded with ``trainable_bn``, for
    ``PSPNet(norm=TrainBN)``; the inverse is
    :func:`export_pspnet_variables`). Every Flax array is used exactly
    once; a key left over raises."""
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
        if leaf == "kernel" and arr.ndim == 4:
            out[port + ".weight"] = _oihw(arr)
        elif leaf == "bias":
            out[port + ".bias"] = arr
        elif leaf == "scale":          # FrozenBN
            out.update(_bn(flat, path, port + ".", arr, trainable_bn))
            used.update((f"batch_stats/{path}/var",
                         f"batch_stats/{path}/mean"))
        else:
            raise KeyError(f"unexpected Flax array {key}")
    left = sorted(set(flat) - used)
    if left:
        raise KeyError(f"{len(left)} Flax arrays not converted: {left[:5]}")
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def export_pspnet_variables(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_pspnet_variables(..., trainable_bn=True)``:
    a ``PSPNet(norm=TrainBN)`` ``state_dict`` -> the JAX flat layout."""
    return _export(state_dict, lambda p: p.replace(".", "/"))


def _mesh_port_path(path: str) -> str:
    """A Flax path of the body-mesh models -> the port's module path: a
    ResNet layer's ``blockN`` is its Sequential's ``N``; the encoder
    stages' ``blockN`` keep their names."""
    return re.sub(r"(layer\d)/block(\d+)", r"\1.\2", path).replace("/", ".")


def convert_metro_variables(variables: Dict[str, Any],
                            trainable_bn: bool = False
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
    weight. Embeddings and ``smpl`` buffers are kept as they are. With
    ``trainable_bn`` the FrozenBNs stay unfolded, for the training form
    (the inverse is :func:`export_metro_variables`). Every Flax array is
    used exactly once; a key left over raises."""
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
            out.update(_bn(flat, path, port, arr, trainable_bn))
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



def export_metro_variables(state_dict: Dict[str, torch.Tensor],
                           heads: int = 4) -> Dict[str, np.ndarray]:
    """The inverse of ``convert_metro_variables(..., trainable_bn=True)``
    for the training form of ``BodyMeshRegressor``: its ``state_dict`` (or
    its gradients) -> the JAX flat layout. The attention's query, key and
    value kernels [heads x head_dim, in] go back to [in, heads, head_dim],
    their biases to [heads, head_dim], the output kernel to [heads,
    head_dim, out] (``heads`` 4, the regressor's)."""
    qkv = ("attn.query", "attn.key", "attn.value")

    def kernel(path, w):
        if path.endswith(qkv):
            return w.T.reshape(w.shape[1], heads, -1)
        if path.endswith("attn.out"):
            return w.T.reshape(heads, -1, w.shape[0])
        return None

    def bias(path, b):
        return b.reshape(heads, -1) if path.endswith(qkv) else b
    return _export(state_dict, kernel=kernel, bias=bias)
