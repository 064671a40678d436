"""Shared pieces of the port's trainer tests: seeded clips, the training
form from Flax variables, and one loss-and-gradient evaluation in each
package, both returned in the JAX package's flat layout."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.train import train_video as jtv
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.core.checkpoint import flatten
from vfloodnet_tpu_torch.core.convert import export_afb_urr_variables
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.train import train_video as tv

HW, CLIP_N, OBJ_N, B = 32, 3, 2, 2


@contextlib.contextmanager
def jax_float64():
    """x64 on, and ``jnp.float32`` naming float64, inside the block: the
    JAX modules cast to ``jnp.float32`` by name, so their float64 run
    stays float64."""
    saved = jnp.float32
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = saved
        jax.config.update("jax_enable_x64", False)


def make_clips(hw=HW, seed=0, b=B, clip_n=CLIP_N, obj_n=OBJ_N):
    """Seeded clips: a sky and a sea colour split by a wavy waterline that
    moves from frame to frame, a ripple and a little noise; the masks are
    one-hot (background, water)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw] / hw
    frames = np.zeros((b, clip_n, hw, hw, 3), np.float32)
    masks = np.zeros((b, clip_n, obj_n, hw, hw), np.float32)
    for i in range(b):
        for t in range(clip_n):
            a, c = rng.uniform(-1, 1, 2)
            water = (yy + 0.3 * np.sin(6 * xx + a) + 0.1 * c) > 0.55
            masks[i, t, 1] = water
            masks[i, t, 0] = 1 - water
            sky, sea = rng.uniform(0.5, 0.9, 3), rng.uniform(0.1, 0.4, 3)
            img = np.where(water[..., None], sea, sky) \
                + 0.1 * np.sin(8 * xx + 5 * yy + a)[..., None]
            frames[i, t] = np.clip(
                img + 0.02 * rng.standard_normal(img.shape), 0, 1)
    return frames, masks


def port_model(variables, dtype=torch.float32):
    model = AFBURR(trainable_bn=True, dtype=dtype)
    model.load_state_dict(convert_afb_urr_variables(variables,
                                                    trainable_bn=True))
    return model.to(dtype)


def port_loss_and_grads(model, frames, masks, update_bn, remat=False):
    """(loss, flat Flax-layout gradients and new running statistics)."""
    for p in model.parameters():
        p.grad = None
    dt = next(model.parameters()).dtype
    loss, stats = tv.video_clip_loss(
        model, torch.from_numpy(frames).to(dt), torch.from_numpy(masks).to(dt),
        0.5, remat=remat, update_bn=update_bn)
    loss.backward()
    out = export_afb_urr_variables({n: p.grad.double() for n, p in
                                    model.named_parameters()})
    if stats is not None:
        names = {m: n for n, m in model.named_modules()}
        named = {}
        for i, bn in enumerate(tv.batch_norms(model)):
            named[names[bn] + ".mean"] = stats[2 * i]
            named[names[bn] + ".var"] = stats[2 * i + 1]
        out.update(export_afb_urr_variables(named))
    return loss.item(), out


def jax_loss_and_grads(variables, frames, masks, update_bn,
                       dtype=jnp.float32):
    jm = JAFBURR(dtype=dtype)

    def loss_fn(params):
        return jtv.video_clip_loss(jm, params, variables["batch_stats"],
                                   frames, masks, 0.5, update_bn=update_bn)
    (loss, stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return float(loss), flatten({"params": jax.tree.map(np.asarray, grads),
                                 "batch_stats": jax.tree.map(np.asarray,
                                                             stats)})
