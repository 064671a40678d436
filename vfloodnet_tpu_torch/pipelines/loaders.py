"""Model construction and weight loading (counterpart of
``vfloodnet_tpu.pipelines.loaders``)."""

from __future__ import annotations

import copy
import os
from typing import Optional

import torch

from ..core import (convert_afb_urr_variables, convert_linknet_variables,
                    load_flat_npz, resolve_device)
from ..models import AFBURR, LinkNet

_RECORDS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "records", "checkpoints")


def default_checkpoint(kind: str = "video") -> str:
    """Path of the bundled trained flat-npz checkpoint of ``kind``."""
    return os.path.join(_RECORDS, kind, "best.npz")


def load_afb_urr(model_path: Optional[str] = None, device="cuda",
                 dtype: torch.dtype = torch.float32) -> AFBURR:
    """AFB-URR computing in ``dtype`` with weights from a flat ``.npz``
    checkpoint of the JAX package (default: the bundled trained one),
    converted by the weight bridge and moved to ``device``, in eval mode.
    The weights stay float32 masters; the engine casts them once
    (:func:`cast_floating_params`)."""
    model_path = model_path or default_checkpoint("video")
    if not model_path.endswith(".npz"):
        raise ValueError(f"expected a flat .npz checkpoint, got {model_path}")
    device = resolve_device(device)
    model = AFBURR(dtype=dtype)
    model.load_state_dict(convert_afb_urr_variables(load_flat_npz(model_path)))
    return model.to(device).eval()


def load_linknet(model_path: Optional[str] = None,
                 device="cuda") -> LinkNet:
    """The image model, the JAX package's TPU-first ``LinkNet``
    (EfficientNet-B4), with weights from a flat ``.npz`` checkpoint
    (default: the bundled trained one), on ``device``, in eval mode. A
    missing file raises. The reference's pickled smp ``.pth`` (the JAX
    package's ``LinkNetSMP`` route) is not ported."""
    model_path = model_path or default_checkpoint("image")
    if not model_path.endswith(".npz"):
        raise ValueError(f"expected a flat .npz checkpoint, got "
                         f"{model_path} (the smp .pth route is not ported)")
    if not os.path.exists(model_path):
        raise FileNotFoundError(f"no image checkpoint at {model_path}")
    device = resolve_device(device)
    model = LinkNet()
    model.load_state_dict(convert_linknet_variables(load_flat_npz(
        model_path)))
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
