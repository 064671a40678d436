"""The port's body-mesh trainer against the JAX package's, on the CPU:

- ``make_training_sample`` (a cv2-free person scene, the crop's float
  ``INTER_LINEAR`` of ``ops/resize.py::cv2_linear_float``, the target)
  gives the JAX package's crop and target bit for bit for several seeds;
- one step of ``make_bodymesh_train_step`` from the JAX package's random
  init (one module fixture) carried into the training form, both trainers
  in float64 (``jnp.float32`` pointed at float64 for JAX's call), on one
  64 x 64 crop (the regressor pools its grid: any size runs, and XLA's
  float64 convolutions on the CPU are slow at 224): the loss within 1e-9
  relative, every gradient leaf within 1e-6 of its largest magnitude (a
  leaf that vanishes up to rounding, a bias feeding a live BN, within
  1e-6 of 1e-9 of the largest leaf) and the new running statistics within
  1e-6 relative;
- the optimiser against ``optax.chain(clip_by_global_norm(1),
  adamw(cosine_decay_schedule(lr, 6, 0.02)))`` over 6 steps, some clipped:
  parameters within 1e-6 relative;
- ``convert_metro_variables(..., trainable_bn=True)`` and
  ``export_metro_variables`` round-trip every leaf exactly, and the
  exported ``best.npz`` gives the same vertices through both packages'
  ``load_default_mesh_regressor``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vfloodnet_tpu.models.metro import BodyMeshRegressor as JRegressor
from vfloodnet_tpu.models.metro import \
    load_default_mesh_regressor as j_load_regressor
from vfloodnet_tpu.models.metro import project_orthographic as j_project
from vfloodnet_tpu.pipelines.object_detection import _load_template_3d
from vfloodnet_tpu.train import train_bodymesh as jtb
from vfloodnet_tpu_torch.core.checkpoint import flatten, save_flat_npz
from vfloodnet_tpu_torch.core.convert import (convert_metro_variables,
                                              export_metro_variables)
from vfloodnet_tpu_torch.models.metro import (BodyMeshRegressor,
                                              load_default_mesh_regressor)
from vfloodnet_tpu_torch.pipelines.object_detection import load_template_3d
from vfloodnet_tpu_torch.train import train_bodymesh as tb

from torch_image_train_common import NOISE_FLOOR
from torch_train_common import jax_float64

torch.set_num_threads(4)
HW = 64


@pytest.fixture(scope="module")
def init():
    v = jax.jit(JRegressor().init)(jax.random.PRNGKey(1),
                                   jnp.zeros((HW, HW, 3)))
    return jax.tree.map(np.asarray, v)


def _port(variables, dtype=torch.float32):
    model = BodyMeshRegressor(trainable_bn=True, dtype=dtype)
    model.load_state_dict(convert_metro_variables(variables,
                                                  trainable_bn=True))
    return model.to(dtype)


def test_training_sample_matches_jax():
    template = load_template_3d(None)
    np.testing.assert_array_equal(template, _load_template_3d(None))
    for seed in range(6):
        got = tb.make_training_sample(
            np.random.default_rng(np.random.SeedSequence([13, seed])),
            template)
        want = jtb.make_training_sample(
            np.random.default_rng(np.random.SeedSequence([13, seed])),
            template)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def step(init):
    """Both trainers' loss, gradients and new statistics in float64 from
    JAX's init, and the statistics before the step."""
    rng = np.random.default_rng(0)
    crop = rng.random((HW, HW, 3))
    target = rng.uniform(-1, 1, (431, 2))
    v64 = jax.tree.map(lambda a: np.asarray(a, np.float64), init)
    with jax_float64():
        jm = JRegressor(dtype=jnp.float64)

        def loss_fn(params):
            (verts, _, cam), upd = jm.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                crop, mutable=["batch_stats"])
            return jnp.mean((j_project(verts, cam) - target) ** 2), \
                upd["batch_stats"]
        (want_loss, stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(v64["params"])
        want = flatten({"params": jax.tree.map(np.asarray, grads),
                        "batch_stats": jax.tree.map(np.asarray, stats)})
    model = _port(v64, torch.float64)
    cfg = tb.BodyMeshTrainConfig()
    loss = tb.make_bodymesh_train_step(
        model, tb.init_bodymesh_train_state(model, cfg))(
        torch.from_numpy(crop), torch.from_numpy(target))
    got = export_metro_variables({n: p.grad for n, p in
                                  model.named_parameters()})
    got.update(export_metro_variables(
        {n: b for n, b in model.state_dict().items()
         if n.endswith((".mean", ".var"))}))
    return loss.item(), float(want_loss), got, want


def test_step_loss_matches_jax_in_float64(step):
    got_loss, want_loss, _, _ = step
    assert np.isfinite(want_loss)
    assert abs(got_loss - want_loss) <= 1e-9 * abs(want_loss)


def test_step_gradients_match_jax_in_float64(step):
    _, _, got, want = step
    assert set(got) == set(want)
    top = max(np.abs(w).max() for k, w in want.items()
              if k.startswith("params/"))
    for k, w in want.items():
        if k.startswith("params/"):
            scale = max(np.abs(w).max(), NOISE_FLOOR * top)
            assert np.abs(got[k] - w).max() <= 1e-6 * scale, k


def test_step_statistics_match_jax_in_float64(step, init):
    _, _, got, want = step
    before = flatten(init)
    for k, w in want.items():
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], w, rtol=1e-6, atol=0,
                                       err_msg=k)
            assert not np.array_equal(w, before[k]), k


def test_optimiser_matches_optax():
    rng = np.random.default_rng(2)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = tb.BodyMeshTrainConfig(total_steps=6)
    state, tx = jtb.init_bodymesh_train_state(
        None, {"params": params, "batch_stats": {}}, cfg)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tb.AdamWClip(tp, tb.make_bodymesh_lr_schedule(cfg),
                       cfg.weight_decay, grad_clip=1.0)
    jp, jo = state.params, state.opt_state
    for i in range(6):
        g = {k: (rng.standard_normal(s) * 10 ** (i % 3 - 1)).astype(
            np.float32) for k, s in shapes.items()}
        upd, jo = tx.update(g, jo, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step({k: torch.from_numpy(v) for k, v in g.items()})
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{k} step {i}")


def test_weights_round_trip_and_load_in_both_packages(init, tmp_path):
    back = export_metro_variables(_port(init).state_dict())
    want = flatten(init)
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    path = str(tmp_path / "best.npz")
    save_flat_npz(path, back)
    crop = (np.random.default_rng(3).random((224, 224, 3)) * 255).astype(
        np.uint8)
    got = load_default_mesh_regressor(path, device="cpu")(crop)
    ref = j_load_regressor(path)(crop)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
