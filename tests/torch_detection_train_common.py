"""Shared pieces of the detection-trainer tests: the bundled trained tiny
people detector (masks and keypoints) at 64 px, a scene, JAX's random
proposals, and one loss-and-gradient evaluation in each package."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.data.detection_dataset import (render_person_scene,
                                                  render_stopsign_scene)
from vfloodnet_tpu.models.detection.meta import GeneralizedRCNN as JRCNN
from vfloodnet_tpu.train import train_detection as jtd
from vfloodnet_tpu_torch.core.checkpoint import flatten, load_flat_npz
from vfloodnet_tpu_torch.core.convert import (convert_rcnn_variables,
                                              export_rcnn_variables)
from vfloodnet_tpu_torch.models.detection.meta import (GeneralizedRCNN,
                                                       RCNNConfig)
from vfloodnet_tpu_torch.train import train_detection as td

S = 64
# 2 keypoint ROIs, not 16: XLA's float64 convolutions on the CPU are slow,
# and the keypoint head's eight 512-wide ones dominate a step
TC = dict(image_size=S, roi_n=16, roi_topk=6, keypoint_rois=2)


def jax_config(people: bool):
    return (jtd.tiny_people_config if people else jtd.tiny_stopsign_config)(S)


def port_config(people: bool) -> RCNNConfig:
    return (td.tiny_people_config if people else td.tiny_stopsign_config)(S)


def trained_people():
    """The trained tiny people detector (the JAX package's file): a JAX
    random init takes longer than the test."""
    return load_flat_npz(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "records", "checkpoints", "people_tiny", "best.npz"))


def for_config(variables, people: bool):
    """The variables of the stop-sign config: no keypoint head."""
    if people:
        return variables
    return {c: {k: v for k, v in t.items() if k != "keypoint_head"}
            for c, t in variables.items()}


def scene(people: bool, seed: int = 3):
    """(image, boxes, classes, masks, valid[, keypoints]) of a scene."""
    rng = np.random.default_rng(seed)
    if people:
        sc = render_person_scene(rng, S)
        return (sc["image"], sc["boxes"], sc["classes"], sc["masks"],
                sc["valid"].astype(np.float32), sc["keypoints"])
    sc = render_stopsign_scene(rng, S)
    return (sc["image"], sc["boxes"], sc["classes"], sc["masks"],
            sc["valid"].astype(np.float32))


def jax_random_boxes(key, tc):
    """The random proposals that the JAX ``_training_proposals`` draws
    from ``key``."""
    n = tc.roi_n - tc.roi_topk - 8
    k1, k2 = jax.random.split(key)
    s = tc.image_size
    xy = jax.random.uniform(k1, (n, 2), minval=0.0, maxval=s * 0.8)
    wh = jax.random.uniform(k2, (n, 2), minval=s * 0.05, maxval=s * 0.5)
    return np.asarray(jnp.concatenate([xy, jnp.minimum(xy + wh, s)], axis=1))


def jax_loss_and_grads(variables, people, sample, dtype=jnp.float32,
                       grads=True):
    tc = jtd.DetectionTrainConfig(**TC)
    jm = JRCNN(jax_config(people), dtype=dtype)
    anchors = jtd.level_anchors(S)
    key = jax.random.PRNGKey(5)
    args = [jnp.asarray(a) for a in sample]

    def loss_fn(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        return jtd.detection_loss(jm, v, tc, anchors, key, *args)
    if grads:
        (loss, aux), g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        g = flatten({"params": jax.tree.map(np.asarray, g)})
    else:
        loss, aux = jax.jit(loss_fn)(variables["params"])
        g = None
    return (float(loss), {k: float(v) for k, v in aux.items()}, g,
            jax_random_boxes(key, tc))


def port_model(variables, people, dtype=torch.float32):
    model = GeneralizedRCNN(port_config(people), trainable_bn=True)
    model.load_state_dict(convert_rcnn_variables(variables,
                                                 trainable_bn=True))
    return model.to(dtype)


def port_loss_and_grads(model, sample, rand_boxes, device="cpu"):
    """(loss, terms, flat Flax-layout gradients) of ``model``."""
    dt = next(model.parameters()).dtype
    tc = td.DetectionTrainConfig(**TC)
    for p in model.parameters():
        p.grad = None
    t = [torch.from_numpy(np.asarray(a)).to(device) for a in sample]
    t = [a.to(dt) if a.is_floating_point() else a for a in t]
    anchors = td.level_anchors(S, device, dt)
    loss, aux = td.detection_loss(
        model, tc, anchors, *t[:5], t[5] if len(t) > 5 else None,
        rand_boxes=torch.tensor(rand_boxes, device=device, dtype=dt))
    loss.backward()
    g = export_rcnn_variables({n: p.grad for n, p in
                               model.named_parameters()})
    return loss.item(), {k: v.item() for k, v in aux.items()}, g
