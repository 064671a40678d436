"""Body-mesh regressor trainer (counterpart of
``vfloodnet_tpu.train.train_bodymesh``), and the loop of the JAX
package's ``scripts/train_people_chain.py`` regressor stage.

The people chain's ``BodyMeshRegressor`` trains on synthetic standing
figures (``data/detection_dataset.py::render_person_scene``): the crop is
cut as the inference path cuts it, around a jittered detector box, and
the target is the canonical standing template scaled to the figure's true
extent in the crop, the part under water included. The loss is the mean
square of the orthographic projection's error; the optimiser
``optax.chain(clip_by_global_norm(1), adamw(cosine_decay_schedule(lr,
total_steps, 0.02)))`` (:class:`.train_video.AdamWClip`); the backbone's
BatchNorm is live, one crop a step, with the running statistics set to
``0.9 * stat + 0.1 * batch``.

Run ``python -m vfloodnet_tpu_torch.train.train_bodymesh --steps N --out
DIR [--device cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import time
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core import resolve_device
from ..models.metro import BodyMeshRegressor, project_orthographic
from .train_video import (AdamWClip, _pass_stats, _variance_scaling_,
                          batch_norms)


@dataclasses.dataclass
class BodyMeshTrainConfig:
    lr: float = 3e-4
    weight_decay: float = 1e-4
    crop_size: int = 224
    seed: int = 0
    # cosine decay horizon; 0 = a constant rate (with live BN a flat 3e-4
    # thrashes late in training)
    total_steps: int = 0


def make_bodymesh_lr_schedule(cfg: BodyMeshTrainConfig
                              ) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule(lr, total_steps, alpha=0.02)`` of
    the optimiser's step count, or ``lr`` without ``total_steps``."""
    if not cfg.total_steps:
        return lambda count: cfg.lr

    def schedule(count: int) -> float:
        c = min(count, cfg.total_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cfg.total_steps))
        return cfg.lr * ((1 - 0.02) * cosine + 0.02)
    return schedule


def init_bodymesh_train_state(model: BodyMeshRegressor,
                              cfg: BodyMeshTrainConfig) -> AdamWClip:
    """The JAX ``init_bodymesh_train_state``'s optimiser over ``model``'s
    parameters."""
    return AdamWClip(dict(model.named_parameters()),
                     make_bodymesh_lr_schedule(cfg), cfg.weight_decay,
                     grad_clip=1.0)


def make_bodymesh_train_step(model: BodyMeshRegressor, opt: AdamWClip
                             ) -> Callable:
    """``step(crop01 [224, 224, 3], target_2d [V, 2]) -> loss`` (a
    detached 0-d tensor): one crop through the regressor with its BNs
    normalising with that crop's statistics, the MSE of the projected
    vertices, one optimiser update and the running statistics' update.
    The BNs are left frozen afterwards."""
    bns = batch_norms(model)

    def step(crop01: torch.Tensor, target_2d: torch.Tensor) -> torch.Tensor:
        for p in opt.params.values():
            p.grad = None
        for bn in bns:
            bn.live = True
            bn.batch_mean = bn.batch_var = None
        verts, _, cam = model(crop01[None])
        loss = ((project_orthographic(verts[0], cam[0]) - target_2d) ** 2
                ).mean()
        stats = _pass_stats(bns)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for bn, (mean, var) in zip(bns, stats):
                bn.live = False
                bn.mean.copy_(mean)
                bn.var.copy_(var)
        return loss.detach()
    return step


def make_training_sample(rng: np.random.Generator, template_2d: np.ndarray,
                         size: int = 320, crop_size: int = 224
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(crop01 [224, 224, 3] RGB in [0, 1], target_2d [V, 2] in [-1, 1]
    crop coordinates): a person scene (a water band over the legs half the
    time), cropped as the inference path crops (``crop_person``) around
    the GT box, cut at the waterline 70 % of the time when submerged, plus
    N(0, 2) jitter; the template mapped to the true head..feet extent."""
    from ..data.detection_dataset import render_person_scene
    from ..pipelines.object_detection import crop_person

    water = float(rng.uniform(0.1, 0.5)) if rng.random() < 0.5 else None
    sc = render_person_scene(rng, size, water_level=water)
    box = sc["boxes"][0].copy()
    if water is not None and rng.random() < 0.7:
        box[3] = min(box[3], size * (1.0 - water))
    box += rng.normal(0.0, 2.0, 4).astype(np.float32)
    crop, _ = crop_person(sc["image"], sc["water_mask"], box)

    # the crop window (crop_person's arithmetic)
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    radius = min(size, 1.5 * max(x2 - x1, y2 - y1)) / 2
    left, top = cx - radius, cy - radius
    if left < 0:
        left = 0
    if left + 2 * radius > size:
        left = size - 2 * radius
    if top < 0:
        top = 0
    if top + 2 * radius > size:
        top = size - 2 * radius
    span = 2 * radius

    def to_crop(y):
        return float(np.clip(2.0 * (y - top) / span - 1.0, -1.5, 1.5))

    head_c, feet_c = to_crop(sc["head_y"]), to_crop(sc["feet_y"])
    gt_cx = (sc["boxes"][0, 0] + sc["boxes"][0, 2]) / 2
    gt_w = sc["boxes"][0, 2] - sc["boxes"][0, 0]
    cx_c = float(2.0 * (gt_cx - left) / span - 1.0)
    w_c = float(gt_w / span)
    # template y spans [-0.95, 0.95] -> [head_c, feet_c]; x scaled to the
    # person's half-width and centred on the body
    t = template_2d
    ty = (t[:, 1] + 0.95) / 1.9 * (feet_c - head_c) + head_c
    tx = t[:, 0] / np.abs(t[:, 0]).max() * (w_c / 2.0) + cx_c
    target = np.stack([tx, ty], axis=1).astype(np.float32)
    crop01 = crop[..., ::-1].astype(np.float32) / 255.0   # BGR -> RGB
    return np.ascontiguousarray(crop01), target


@torch.no_grad()
def init_body_mesh(seed: int = 0, device="cuda") -> BodyMeshRegressor:
    """A training-form ``BodyMeshRegressor`` with the JAX model's
    initialisers, drawn from ``seed`` (torch's generator, not JAX's keys):
    convolution and dense kernels LeCun normal, biases zero, the token
    embedding normal with deviation 0.02, LayerNorm and BatchNorm the
    identity."""
    device = resolve_device(device)
    model = BodyMeshRegressor(trainable_bn=True)
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            _variance_scaling_(mod.weight, 1.0, "fan_in", gen)
            if mod.bias is not None:
                mod.bias.zero_()
    model.token_embed.copy_(torch.randn(model.token_embed.shape,
                                        generator=gen) * 0.02)
    return model.to(device)


def train_bodymesh(steps: int, out_dir: str, device="cuda",
                   log_every: int = 50) -> str:
    """The JAX script's regressor stage: ``steps`` steps of one sample
    each (sample ``i`` from the seed ``(seed + 13, i)``), the cosine rate
    over ``steps``, and ``best`` the weights at the lowest 25-step running
    mean of the loss, read every 25 steps from step 100 (the last weights
    if the run is shorter). Writes ``out_dir/best.npz`` in the JAX flat
    layout; returns its path."""
    from ..core.checkpoint import save_flat_npz
    from ..core.convert import export_metro_variables
    from ..pipelines.object_detection import load_template_3d

    device = resolve_device(device)
    cfg = BodyMeshTrainConfig(total_steps=steps)
    model = init_body_mesh(cfg.seed + 1, device)
    opt = init_bodymesh_train_state(model, cfg)
    step_fn = make_bodymesh_train_step(model, opt)
    template_2d = load_template_3d(None)
    t0 = time.time()
    losses = []
    best = (float("inf"), None)
    for i in range(steps):
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed + 13,
                                                            i]))
        crop01, target = make_training_sample(rng, template_2d,
                                              crop_size=cfg.crop_size)
        loss = step_fn(torch.from_numpy(crop01).to(device),
                       torch.from_numpy(target).to(device))
        losses.append(float(loss))
        if i >= 100 and i % 25 == 0:
            mean = float(np.mean(losses[-25:]))
            if mean < best[0]:
                best = (mean, export_metro_variables(model.state_dict()))
        if i % log_every == 0 or i == steps - 1:
            print(f"mesh step {i}/{steps} loss {losses[-1]:.5f} (best-mean "
                  f"{best[0]:.5f}, {time.time() - t0:.0f}s)", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "best.npz")
    save_flat_npz(path, best[1] or export_metro_variables(
        model.state_dict()))
    print(f"body-mesh regressor saved: {path} (best running-mean loss "
          f"{best[0]:.5f})", flush=True)
    return path


def main() -> None:
    p = argparse.ArgumentParser(
        description="flowtide (PyTorch/CUDA): body-mesh regressor trainer")
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--out", type=str, required=True,
                   help="Directory for best.npz")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' or 'cpu'.")
    args = p.parse_args()
    if torch.device(args.device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    train_bodymesh(args.steps, args.out, args.device)


if __name__ == "__main__":
    main()
