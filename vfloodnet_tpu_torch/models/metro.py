"""Body-mesh regression (counterpart of ``vfloodnet_tpu.models.metro``): a
224 x 224 person crop -> 431 projected mesh vertices in [-1, 1] crop
coordinates, the input of the people depth geometry.

- :class:`METRONetwork`: the faithful METRO graph (HRNet-W64 or a ResNet-50
  trunk, 3 BERT stages over 14 joint and 431 vertex tokens, the camera FC
  chain, the learned mesh upsampling 431 -> 1723 -> 6890, pelvis centring
  through the H36M joint regressor). The SMPL constants (template joints
  and vertices, the regressor) are buffers.
- :class:`BodyMeshRegressor`: the JAX package's lighter regressor with the
  same output (ResNet-50 to layer 3, three encoder stages of 4 pre-norm
  blocks at 1024/256/128), which the bundled checkpoint holds.

Module names are the JAX package's Flax paths with ``.`` for ``/``
(``core/convert.py::convert_metro_variables``). Flax's defaults are kept
where they differ from PyTorch's: the encoder blocks' ``nn.LayerNorm()``
has epsilon 1e-6 and their ``nn.gelu`` is the tanh approximation, while
the BERT layers use epsilon 1e-12 and the exact GELU; Flax's attention
scales the query by 1/sqrt(head_dim) before the product, BERT's the
scores after it. Both models take a batch of crops along a leading axis
(the JAX modules take one crop or a batch as written).

``BodyMeshRegressor(trainable_bn=True)`` is the training form
(``train/train_bodymesh.py``): its ResNet's BNs are
:class:`.resnet.TrainBN`, live in training as the JAX trainer's are, so it
trains on one crop at a time (a batch would pool their statistics).
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.device import resolve_device
from .resnet import FrozenBN, ResNet50Backbone, TrainBN

NUM_JOINTS = 14
NUM_VERTICES = 431    # METRO's coarse SMPL mesh (sub2 downsample)
NUM_VERTICES_SUB = 1723
NUM_VERTICES_FULL = 6890
NUM_H36M_JOINTS = 17
H36M_J17_TO_J14 = (0, 1, 2, 3, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14)
H36M_PELVIS = 0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class _ImageNorm(nn.Module):
    """[N, H, W, 3] RGB in [0, 1] -> ImageNet-normalised NCHW."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, crops01: torch.Tensor) -> torch.Tensor:
        return ((crops01 - self.mean) / self.std).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# The faithful METRO graph
# ---------------------------------------------------------------------------

class BertSelfAttention(nn.Module):
    """HuggingFace BERT's attention block: query/key/value, the output
    dense layer and its LayerNorm (epsilon 1e-12) around the residual."""

    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out_dense = nn.Linear(hidden, hidden)
        self.out_ln = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, hidden = x.shape
        hd = hidden // self.heads

        def split(v):
            return v.reshape(n, t, self.heads, hd).transpose(1, 2)

        q, k = split(self.query(x)), split(self.key(x))
        p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
        v = split(self.value(x))
        ctx = (p @ v).transpose(1, 2).reshape(n, t, hidden)
        return self.out_ln(self.out_dense(ctx) + x)


class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int):
        super().__init__()
        self.attention = BertSelfAttention(hidden, heads)
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)
        self.output_ln = nn.LayerNorm(hidden, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attention(x)
        h = F.gelu(self.intermediate_dense(x))
        return self.output_ln(self.output_dense(h) + x)


class METROStage(nn.Module):
    """One METRO encoder stage: the linear image embedding plus learned
    position embeddings, BERT layers, ``cls_head`` plus a linear residual
    from the stage's input."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int,
                 layers: int = 4, heads: int = 4, intermediate: int = 3072,
                 max_positions: int = 512):
        super().__init__()
        self.layers = layers
        self.position_embeddings = nn.Parameter(torch.zeros(max_positions,
                                                            hidden))
        self.img_embedding = nn.Linear(in_dim, hidden)
        for i in range(layers):
            self.add_module(f"layer{i}", BertLayer(hidden, heads,
                                                   intermediate))
        self.cls_head = nn.Linear(hidden, out_dim)
        self.residual = nn.Linear(in_dim, out_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        t = feats.shape[1]
        h = self.img_embedding(feats) + self.position_embeddings[None, :t]
        for i in range(self.layers):
            h = getattr(self, f"layer{i}")(h)
        return self.cls_head(h) + self.residual(feats)


class METRONetwork(nn.Module):
    """METRO's body-mesh network. ``forward`` takes crops [N, 224, 224, 3]
    RGB in [0, 1] and returns (cam [N, 3], joints [N, 14, 3] from the mesh,
    verts_sub2 [N, 431, 3], verts_sub [N, 1723, 3], verts_full [N, 6890,
    3]), the full mesh and joints centred on the pelvis."""

    def __init__(self, backbone: str = "hrnet64",
                 stage_hidden: Sequence[int] = (1024, 256, 128),
                 stage_out: Sequence[int] = (512, 128, 3),
                 stage_layers: int = 4, stage_heads: int = 4,
                 intermediate: int = 3072, feat_dim: int = 2048):
        super().__init__()
        self.norm = _ImageNorm()
        if backbone == "hrnet64":
            from .hrnet import HRNet
            self.backbone = HRNet(width=64)
        elif backbone == "resnet50":
            self.backbone = ResNet50Backbone(with_layer4=True)
        else:
            raise ValueError(backbone)
        self.n_stages = len(stage_hidden)
        in_dim = 3 + feat_dim
        for si, (hid, od) in enumerate(zip(stage_hidden, stage_out)):
            self.add_module(f"stage{si}", METROStage(
                in_dim, hid, od, layers=stage_layers, heads=stage_heads,
                intermediate=intermediate))
            in_dim = od
        self.cam_param_fc = nn.Linear(3, 1)
        self.cam_param_fc2 = nn.Linear(NUM_VERTICES, 250)
        self.cam_param_fc3 = nn.Linear(250, 3)
        self.upsampling = nn.Linear(NUM_VERTICES, NUM_VERTICES_SUB)
        self.upsampling2 = nn.Linear(NUM_VERTICES_SUB, NUM_VERTICES_FULL)
        self.register_buffer("template_joints", torch.zeros(NUM_JOINTS, 3))
        self.register_buffer("template_vertices_sub2",
                             torch.zeros(NUM_VERTICES, 3))
        self.register_buffer("j_regressor_h36m",
                             torch.zeros(NUM_H36M_JOINTS, NUM_VERTICES_FULL))
        self.register_buffer("j17_to_j14", torch.tensor(H36M_J17_TO_J14),
                             persistent=False)

    def forward(self, crops01: torch.Tensor):
        n = crops01.shape[0]
        feat = self.backbone(self.norm(crops01))[0]
        img_feat = feat.mean(dim=(2, 3))                       # [N, 2048]
        ref = torch.cat([self.template_joints, self.template_vertices_sub2])
        h = torch.cat([ref[None].expand(n, -1, -1),
                       img_feat[:, None].expand(-1, ref.shape[0], -1)], -1)
        for si in range(self.n_stages):
            h = getattr(self, f"stage{si}")(h)
        verts_sub2 = h[:, NUM_JOINTS:]
        c = self.cam_param_fc(verts_sub2).transpose(1, 2)     # [N, 1, 431]
        cam = self.cam_param_fc3(self.cam_param_fc2(c))[:, 0]
        vs = self.upsampling(verts_sub2.transpose(1, 2))
        vf = self.upsampling2(vs)
        verts_sub = vs.transpose(1, 2)
        verts_full = vf.transpose(1, 2)
        j17 = torch.einsum("jv,nvc->njc", self.j_regressor_h36m, verts_full)
        pelvis = j17[:, H36M_PELVIS:H36M_PELVIS + 1]
        joints = j17.index_select(1, self.j17_to_j14) - pelvis
        return cam, joints, verts_sub2, verts_sub, verts_full - pelvis


def metro_orthographic_projection(x3d: torch.Tensor, cam: torch.Tensor
                                  ) -> torch.Tensor:
    """METRO's weak-perspective projection: 2d = s * (xy + t)."""
    return cam[..., 0:1, None] * (x3d[..., :2] + cam[..., None, 1:3])


# ---------------------------------------------------------------------------
# The bundled regressor
# ---------------------------------------------------------------------------

class MultiHeadAttention(nn.Module):
    """Flax's ``MultiHeadDotProductAttention`` as self-attention: the query
    scaled by 1/sqrt(head_dim) before the product (the weight bridge
    reshapes its [in, heads, head_dim] kernels into ``nn.Linear``'s)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, dim = x.shape
        hd = dim // self.heads

        def split(v):
            return v.reshape(n, t, self.heads, hd).transpose(1, 2)

        q = split(self.query(x)) / math.sqrt(hd)
        k, v = split(self.key(x)), split(self.value(x))
        p = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out((p @ v).transpose(1, 2).reshape(n, t, dim))


class TransformerBlock(nn.Module):
    """Pre-norm block with Flax's defaults: LayerNorm epsilon 1e-6, the
    tanh GELU, an MLP of ``mlp_ratio`` x the width."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: float = 2.0):
        super().__init__()
        self.LayerNorm_0 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiHeadAttention(dim, heads)
        self.LayerNorm_1 = nn.LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, int(dim * mlp_ratio))
        self.Dense_1 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.LayerNorm_0(x))
        h = F.gelu(self.Dense_0(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_1(h)


class EncoderStage(nn.Module):
    def __init__(self, in_dim: int, dim: int, layers: int = 4):
        super().__init__()
        self.layers = layers
        self.proj = nn.Linear(in_dim, dim)
        for i in range(layers):
            self.add_module(f"block{i}", TransformerBlock(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        return x


class BodyMeshRegressor(nn.Module):
    """Crops [N, 224, 224, 3] RGB in [0, 1] -> (verts [N, 431, 3], joints
    [N, 14, 3], cam [N, 3]), the camera's scale about 1. ``backbone``:
    "resnet50" (layer 3's 1024-channel grid) or "hrnet64"; a ResNet takes
    ``trainable_bn`` (the training form) and the convolutions' ``dtype``
    (float64 for checks)."""

    def __init__(self, stage_dims: Sequence[int] = (1024, 256, 128),
                 backbone: str = "resnet50", trainable_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = _ImageNorm()
        if backbone == "hrnet64":
            from .hrnet import HRNet
            self.backbone, feat_dim = HRNet(width=64), 2048
        else:
            self.backbone, feat_dim = ResNet50Backbone(
                dtype=dtype, norm=TrainBN if trainable_bn else FrozenBN), 1024
        n_tok = NUM_JOINTS + NUM_VERTICES
        self.token_embed = nn.Parameter(torch.zeros(n_tok, 512))
        self.n_stages = len(stage_dims)
        in_dim = 512 + feat_dim
        for si, dim in enumerate(stage_dims):
            self.add_module(f"stage{si}", EncoderStage(in_dim, dim))
            in_dim = dim
        self.coord_head = nn.Linear(in_dim, 3)
        self.cam_head = nn.Linear(in_dim, 3)

    def forward(self, crops01: torch.Tensor):
        n = crops01.shape[0]
        grid = self.backbone(self.norm(crops01))[0].mean(dim=(2, 3))
        q = self.token_embed
        h = torch.cat([q[None].expand(n, -1, -1),
                       grid[:, None].expand(-1, q.shape[0], -1)], -1)
        for si in range(self.n_stages):
            h = getattr(self, f"stage{si}")(h)
        coords = self.coord_head(h)
        cam = self.cam_head(h.mean(dim=1))
        cam = torch.cat([1.0 + cam[:, :1], cam[:, 1:]], -1)
        return coords[:, NUM_JOINTS:], coords[:, :NUM_JOINTS], cam


def project_orthographic(verts_3d: torch.Tensor, cam: torch.Tensor
                         ) -> torch.Tensor:
    """The bundled regressor's projection: 2d = s * xy + t (one crop's
    [V, 3] and [3], or a batch's [N, V, 3] and [N, 3])."""
    return cam[..., None, 0:1] * verts_3d[..., :2] + cam[..., None, 1:3]


def _infer_metro_config(sd) -> dict:
    """Stage widths, depth and MLP width from a METRO state dict's shapes
    (the heads stay at METRO's 4: shapes do not show them)."""
    hidden, out = [], []
    s = 0
    while f"trans_encoder.{s}.bert.img_embedding.weight" in sd:
        hidden.append(sd[f"trans_encoder.{s}.bert.img_embedding.weight"]
                      .shape[0])
        out.append(sd[f"trans_encoder.{s}.cls_head.weight"].shape[0])
        s += 1
    layers = 1 + max(int(k.split(".")[5]) for k in sd
                     if ".bert.encoder.layer." in k)
    inter = sd["trans_encoder.0.bert.encoder.layer.0.intermediate."
               "dense.weight"].shape[0]
    return dict(stage_hidden=tuple(hidden), stage_out=tuple(out),
                stage_layers=layers, intermediate=inter)


def _unit_rms_batchnorms(backbone: nn.Module, gen: torch.Generator) -> None:
    """Scale every FrozenBN of ``backbone`` so that its output has unit RMS
    on one seeded normal 224 x 224 input, in forward order (LSUV): with
    identity statistics a random ResNet's or HRNet's activations grow by
    orders of magnitude through its residual and fuse sums."""
    from .resnet import FrozenBN

    def rescale(mod, _inp, out):
        rms = out.float().pow(2).mean().sqrt().clamp(min=1e-6)
        mod.weight.div_(rms)
        mod.bias.div_(rms)
        return out / rms

    hooks = [m.register_forward_hook(rescale) for m in backbone.modules()
             if isinstance(m, FrozenBN)]
    try:
        device = next(backbone.parameters()).device
        backbone(torch.randn((1, 3, 224, 224), generator=gen).to(device))
    finally:
        for h in hooks:
            h.remove()


def _capture(module: nn.Module, run) -> torch.Tensor:
    """The output of ``module`` while ``run()`` runs."""
    got = []
    hook = module.register_forward_hook(lambda m, i, o: got.append(o))
    try:
        run()
    finally:
        hook.remove()
    return got[0]


def _centre_outputs(model: nn.Module, gen: torch.Generator) -> None:
    """Make a seeded regressor's vertices spread about the crop's centre:
    on a seeded batch of crops, scale and shift the vertex layers so the
    3-D coordinates have mean 0 and standard deviation 0.4 over vertices
    and crops, then shift the camera layer so the camera is (1, 0, 0)
    on average. A random model otherwise puts every vertex near one point:
    the image feature common to all tokens outweighs their embeddings."""
    crops = torch.rand((2, 224, 224, 3), generator=gen).to(
        next(model.parameters()).device)
    if isinstance(model, METRONetwork):
        coords = getattr(model, f"stage{model.n_stages - 1}")
        layers, cam = (coords.cls_head, coords.residual), model.cam_param_fc3
    else:
        coords = model.coord_head
        layers, cam = (coords,), model.cam_head
    y = _capture(coords, lambda: model(crops)).reshape(-1, 3)
    f = 0.4 / y.std(0)
    for lin in layers:
        lin.weight.mul_(f[:, None])
        lin.bias.mul_(f)
    layers[0].bias.sub_(f * y.mean(0))
    c = _capture(cam, lambda: model(crops)).reshape(-1, 3)
    cam.bias.sub_(c.mean(0))
    if isinstance(model, METRONetwork):
        cam.bias.add_(torch.tensor([1.0, 0.0, 0.0], device=c.device))


def seeded_init(model: nn.Module, seed: int = 0) -> nn.Module:
    """Deterministic weights for a :class:`METRONetwork` or
    :class:`BodyMeshRegressor` from ``seed`` that keep its
    projected vertices spread over the crop (smoke mode; make them on the
    CPU so that a card copy agrees): convolution and linear weights normal
    with variance 1 / fan-in, biases zero; token and position embeddings
    normal(0.5); the backbone's FrozenBNs scaled to unit output RMS and
    the output layers to centred, spread-out vertices and a unit camera
    (:func:`_centre_outputs`) on seeded inputs; METRO's SMPL buffers:
    templates normal(0.3), the joint regressor uniform over [0, 2 / 6890)
    (rows summing to about one)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        * w[0].numel() ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
        for name, p in model.named_parameters():
            if name.endswith(("token_embed", "position_embeddings")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
        if isinstance(model, METRONetwork):
            for buf in (model.template_joints, model.template_vertices_sub2):
                buf.copy_(torch.randn(buf.shape, generator=gen) * 0.3)
            jreg = model.j_regressor_h36m
            jreg.copy_(torch.rand(jreg.shape, generator=gen)
                       * (2.0 / NUM_VERTICES_FULL))
        _unit_rms_batchnorms(model.backbone, gen)
        _centre_outputs(model, gen)
    return model


class MeshRegressor:
    """BGR uint8 crops -> projected vertices in [-1, 1]: one crop [224,
    224, 3] -> [431, 2], or a batch [N, 224, 224, 3] -> [N, 431, 2] in one
    forward on the model's device."""

    def __init__(self, model: nn.Module):
        self.model = model.eval()
        self.device = model.norm.mean.device
        self.metro = isinstance(model, METRONetwork)

    def forward(self, crops01: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            out = self.model(crops01)
        if self.metro:
            cam, _, verts_sub2, _, _ = out
            return metro_orthographic_projection(verts_sub2, cam)
        verts, _, cam = out
        return project_orthographic(verts, cam)

    def __call__(self, crops_bgr: np.ndarray) -> np.ndarray:
        single = crops_bgr.ndim == 3
        x = torch.from_numpy(np.ascontiguousarray(
            crops_bgr[None] if single else crops_bgr)).to(self.device)
        # a tensor divisor: true division on the card too (a CPU scalar
        # becomes a reciprocal product there)
        crops01 = x.flip(-1).float() / torch.full((), 255.0,
                                                  device=self.device)
        pts = self.forward(crops01).cpu().numpy()
        return pts[0] if single else pts


def _repo() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _load_metro_bin(path: str) -> nn.Module:
    from ..core.convert import convert_metro_variables
    from ..core.convert_metro import _is_hrnet_layout, metro_to_flax
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    hrnet = _is_hrnet_layout(sd)
    digit = any(k.startswith("backbone.") and k.split(".")[1].isdigit()
                for k in sd)
    skip = (not hrnet and not digit
            and any(k.startswith("backbone.") for k in sd))
    model = METRONetwork(backbone="hrnet64" if hrnet or skip
                         else "resnet50", **_infer_metro_config(sd))
    state = convert_metro_variables(metro_to_flax(sd, skip_backbone=skip))
    if skip:
        warnings.warn("METRO backbone layout unrecognised; backbone runs "
                      "with seeded weights (transformer and heads loaded).")
        seeded_init(model, 0)
        state.update({k: v for k, v in model.state_dict().items()
                      if k.startswith("backbone.")})
    model.load_state_dict(state)
    return model


def load_default_mesh_regressor(model_path: Optional[str] = None,
                                device="cuda") -> MeshRegressor:
    """The people path's regressor. Weights: a METRO ``.bin``/``.pth``
    state dict (converted into :class:`METRONetwork`: an HRNet-W64 or a
    torchvision-Sequential ResNet-50 trunk; an unknown trunk keeps seeded
    weights with a warning), else ``records/bodymesh_tpu``, else the
    bundled ``records/checkpoints/bodymesh/best.npz`` (a flat ``.npz`` of
    the JAX package's :class:`BodyMeshRegressor`); an orbax directory
    raises. Without any checkpoint, seeded weights with a warning (smoke
    mode)."""
    from ..core.checkpoint import load_flat_npz
    from ..core.convert import convert_metro_variables

    device = resolve_device(device)
    path = model_path or os.path.join(_repo(), "records", "bodymesh_tpu")
    if not model_path and not os.path.exists(path):
        demo = os.path.join(_repo(), "records", "checkpoints", "bodymesh",
                            "best.npz")
        if os.path.exists(demo):
            path = demo
    if os.path.isfile(path) and path.endswith((".bin", ".pth")):
        return MeshRegressor(_load_metro_bin(path).to(device))
    model = BodyMeshRegressor()
    if path.endswith(".npz") and os.path.isfile(path):
        model.load_state_dict(convert_metro_variables(load_flat_npz(path)))
    elif os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory; the port "
                         "reads flat .npz files only")
    else:
        warnings.warn(f"No body-mesh checkpoint at {path!r}; seeded weights "
                      "(smoke mode).")
        seeded_init(model, 0)
    return MeshRegressor(model.to(device))
