"""Model construction and weight loading (counterpart of
``vfloodnet_tpu.pipelines.loaders``)."""

from __future__ import annotations

import copy
import os
import warnings
from typing import Optional

import torch

from ..core import (convert_afb_urr_variables, convert_linknet_variables,
                    convert_pspnet_variables, load_flat_npz, resolve_device)
from ..core.convert_ref import read_afb_urr_pth, read_smp_linknet_pth
from ..models import AFBURR, LinkNet
from ..models.linknet_smp import LinkNetSMP
from ..models.pspnet import PSPNet, seeded_init

_RECORDS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "records", "checkpoints")


def default_checkpoint(kind: str = "video") -> str:
    """Path of the bundled trained flat-npz checkpoint of ``kind``."""
    return os.path.join(_RECORDS, kind, "best.npz")


def load_afb_urr(model_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32) -> AFBURR:
    """AFB-URR computing in ``dtype`` with weights from a flat ``.npz``
    checkpoint of the JAX package (default: the bundled trained one) or the
    reference's PyTorch ``.pth`` / ``.bin`` (through its key map,
    :mod:`..core.convert_ref`), converted by the weight bridge and moved to
    ``device``, in eval mode. A missing file or another suffix raises. The
    weights stay float32 masters; the engine casts them once
    (:func:`cast_floating_params`)."""
    model_path = model_path or default_checkpoint("video")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"no video checkpoint at {model_path}")
    if model_path.endswith(".npz"):
        variables = load_flat_npz(model_path)
    elif model_path.endswith((".pth", ".bin")):
        variables = read_afb_urr_pth(model_path)
    else:
        raise ValueError(f"expected a flat .npz or a reference .pth/.bin "
                         f"checkpoint, got {model_path}")
    device = resolve_device(device)
    model = AFBURR(dtype=dtype)
    model.load_state_dict(convert_afb_urr_variables(variables))
    return model.to(device).eval()


def load_linknet(model_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
    """The image model computing in ``dtype`` on ``device``, in eval mode:
    the JAX package's TPU-first ``LinkNet`` (EfficientNet-B4) from a flat
    ``.npz`` checkpoint (default: the bundled trained one), or, from a
    ``.pth``, the reference's smp ``Linknet(efficientnet-b4)`` (a
    whole-model pickle or a ``state_dict``) as :class:`LinkNetSMP`, as the
    JAX loader returns. The weights stay float32 masters
    (:func:`cast_floating_params` casts a copy). A missing file raises."""
    model_path = model_path or default_checkpoint("image")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"no image checkpoint at {model_path}")
    device = resolve_device(device)
    if model_path.endswith(".pth"):
        model = LinkNetSMP(dtype=dtype)
        model.load_state_dict(convert_linknet_variables(
            read_smp_linknet_pth(model_path), bn_eps=LinkNetSMP.BN_EPS))
    elif model_path.endswith(".npz"):
        model = LinkNet(dtype=dtype)
        model.load_state_dict(convert_linknet_variables(load_flat_npz(
            model_path)))
    else:
        raise ValueError(f"expected a flat .npz or an smp .pth "
                         f"checkpoint, got {model_path}")
    return model.to(device).eval()


def load_pspnet(model_path: str, num_classes: int = 56, device="cuda",
                dtype: torch.dtype = torch.float32) -> PSPNet:
    """The Atlantis PSPNet computing in ``dtype`` on ``device``, in eval
    mode, with weights from a flat ``.npz`` of the JAX package's
    variables (the layout of ``records/checkpoints/*/best.npz``). Where
    ``model_path`` does not exist, a warning and the seeded weights of
    :func:`..models.pspnet.seeded_init` from seed 0 (the JAX harness
    warns and initialises from ``PRNGKey(0)``). A directory (an orbax
    checkpoint) or another suffix raises."""
    device = resolve_device(device)
    model = PSPNet(num_classes=num_classes, dtype=dtype)
    if not os.path.exists(model_path):
        warnings.warn(f"No checkpoint at {model_path}; seeded init "
                      "(seed 0).")
        seeded_init(model, 0)
    elif model_path.endswith(".npz") and os.path.isfile(model_path):
        model.load_state_dict(convert_pspnet_variables(
            load_flat_npz(model_path)))
    else:
        raise ValueError(f"expected a flat .npz checkpoint, got "
                         f"{model_path} (orbax folders are not read)")
    return model.to(device).eval()


def cast_floating_params(model: torch.nn.Module,
                         dtype: torch.dtype) -> torch.nn.Module:
    """A copy of ``model`` with its conv kernels (floating parameters with
    ndim >= 2) cast to ``dtype`` and its biases and frozen-BN buffers kept
    float32, as the JAX package's helper returns a cast copy of the
    variables for a reduced-precision engine; ``model`` is left as it
    was."""
    model = copy.deepcopy(model)
    for param in model.parameters():
        if param.ndim >= 2 and param.is_floating_point():
            param.data = param.data.to(dtype)
    return model
