"""One image-trainer step of the port against the JAX package's in
float64, shared by ``tests/test_torch_image_train.py`` (frozen BN) and
``tests/test_torch_image_train_bn.py`` (``update_bn``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.models import LinkNet as JLinkNet
from vfloodnet_tpu.train import train_image as jti
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import (convert_linknet_variables,
                                              export_linknet_variables)
from vfloodnet_tpu_torch.models import LinkNet, TrainBN
from vfloodnet_tpu_torch.train import train_image as ti

from torch_train_common import jax_float64

HW = 64
# A gradient leaf that vanishes (a bias feeding a live BatchNorm: the
# batch mean removes it) is rounding noise near 1e-17 in both trainers,
# so its scale is floored at this share of the largest leaf.
NOISE_FLOOR = 1e-9


def image_batch(seed=0, b=2, hw=HW):
    """Seeded images [b, hw, hw, 3] in [0, 1]: a sky and a sea colour
    split by a wavy waterline, with noise; the masks [b, hw, hw] are the
    water."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw] / hw
    images = np.zeros((b, hw, hw, 3))
    masks = np.zeros((b, hw, hw))
    for i in range(b):
        a = rng.uniform(-1, 1)
        water = (yy + 0.3 * np.sin(6 * xx + a)) > 0.55
        masks[i] = water
        images[i] = np.where(water[..., None], rng.uniform(0.1, 0.4, 3),
                             rng.uniform(0.5, 0.9, 3))
    images = np.clip(images + 0.05 * rng.standard_normal(images.shape), 0, 1)
    return images, masks


def _jax_step(variables, images, masks, update_bn):
    jm = JLinkNet(dtype=jnp.float64)

    def loss_fn(params, stats):
        v = {"params": params, "batch_stats": stats}
        if update_bn:
            prob, upd = jm.apply(v, images, mutable=["batch_stats"])
            stats = upd["batch_stats"]
        else:
            prob = jm.apply(v, images)
        return jti.dice_loss(prob[..., 0], masks), stats
    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"])
    return float(loss), flatten({"params": jax.tree.map(np.asarray, grads),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             stats)})


def step_in_float64(variables, update_bn):
    """``make_image_train_step`` from ``variables`` and JAX's
    ``value_and_grad`` of the same loss, both in float64: a dict of the
    two losses (``got_loss``, ``want_loss``), the port's IoU, their flat
    Flax-layout gradients and running statistics (``got``, ``want``), and
    the variables before the step (``before``)."""
    images, masks = image_batch()
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    with jax_float64():
        want_loss, want = _jax_step(v64, images, masks, update_bn)
    model = LinkNet(dtype=torch.float64, norm=TrainBN)
    model.load_state_dict(convert_linknet_variables(v64, trainable_bn=True))
    model = model.to(torch.float64)
    cfg = ti.ImageTrainConfig(update_bn=update_bn)
    step = ti.make_image_train_step(
        model, ti.init_image_train_state(model, cfg), update_bn)
    loss, iou = step(torch.from_numpy(images), torch.from_numpy(masks))
    got = export_linknet_variables({n: p.grad for n, p in
                                    model.named_parameters()})
    got.update(export_linknet_variables(
        {n: b for n, b in model.state_dict().items()
         if n.endswith((".mean", ".var"))}))
    return {"got_loss": loss.item(), "want_loss": want_loss,
            "iou": iou.item(), "got": got, "want": want,
            "before": flatten(variables)}


def check_loss(res):
    """The losses within 1e-9 relative, the IoU in [0, 1]."""
    assert np.isfinite(res["want_loss"])
    assert abs(res["got_loss"] - res["want_loss"]) <= 1e-9 * abs(
        res["want_loss"])
    assert 0.0 <= res["iou"] <= 1.0


def check_leaves(res):
    """Every gradient leaf within 1e-6 of its scale."""
    got, want = res["got"], res["want"]
    assert set(got) == set(want)
    top = max(np.abs(w).max() for k, w in want.items()
              if k.startswith("params/"))
    for k, w in want.items():
        if k.startswith("params/"):
            scale = max(np.abs(w).max(), NOISE_FLOOR * top)
            assert np.abs(got[k] - w).max() <= 1e-6 * scale, k


def check_stats(res, update_bn):
    """The running statistics within 1e-6 relative of JAX's new ones
    (``update_bn``), or as they were."""
    for k, w in res["want"].items():
        if not k.startswith("batch_stats/"):
            continue
        if update_bn:
            np.testing.assert_allclose(res["got"][k], w, rtol=1e-6, atol=0,
                                       err_msg=k)
            assert not np.array_equal(w, res["before"][k]), k
        else:
            np.testing.assert_array_equal(res["got"][k], res["before"][k],
                                          err_msg=k)
