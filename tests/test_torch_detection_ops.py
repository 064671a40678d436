"""The detection ops of the port against the JAX package on the CPU, on the
same numpy-seeded inputs: greedy NMS (the kernel's plain version), the
class-aware NMS, ``jax.lax.top_k``'s order, and ROIAlign.

Tolerances: NMS keep indices, scores and validity equal (the same float32
operations in the same order, ties to the lower index); top-k indices
equal; ROIAlign atol 1e-5 (gathers and float32 bilinear weights in the
JAX package's order; the bin means sum in another order).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfloodnet_tpu_torch.ops import nms as tnms
from vfloodnet_tpu_torch.ops import roi_align as troi

jnms = importlib.import_module("vfloodnet_tpu.ops.nms")
jroi = importlib.import_module("vfloodnet_tpu.ops.roi_align")


def _boxes(rng, n, extent=100.0, size=40.0):
    xy = rng.uniform(0, extent, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0, size, (n, 2))],
                          1).astype(np.float32)


NMS_CASES = {
    # (n, max_out, iou, score threshold, rounded ties, duplicates, -inf)
    "ties_duplicates": [(300, 60, 0.5, 0.0, True, True, 0.1),
                        (37, 80, 0.3, -1.0, True, True, 0.0)],
    "dead_and_thresholds": [(200, 20, 0.7, 0.5, False, False, 0.3),
                            (120, 50, 0.5, 0.0, True, False, 1.0)],
    "rpn_like": [(1500, 300, 0.7, 0.0, True, True, 0.05)],
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_matches_jax(case):
    """Ties, duplicate boxes, -inf, all dead, thresholds of either sign,
    max_out above and below the number kept."""
    rng = np.random.RandomState(len(case))
    for n, max_out, iou, thr, ties, dups, dead in NMS_CASES[case]:
        b = _boxes(rng, n)
        s = rng.randn(n).astype(np.float32)
        if ties:
            s = np.round(s, 1).astype(np.float32)
        if dups:
            k = n // 3
            b[-k:], s[-k:] = b[:k], s[:k]
        s[rng.rand(n) < dead] = -np.inf
        want = jnms.nms(jnp.asarray(b), jnp.asarray(s), iou, max_out, thr)
        got = tnms.nms(torch.from_numpy(b), torch.from_numpy(s), iou,
                       max_out, thr)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_batched_class_nms_matches_jax():
    rng = np.random.RandomState(7)
    n = 600
    b = _boxes(rng, n, 300.0, 80.0)
    s = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)
    cls = rng.randint(0, 5, n).astype(np.int32)
    want = jnms.batched_class_nms(jnp.asarray(b), jnp.asarray(s),
                                  jnp.asarray(cls), 0.5, 50, 0.2)
    got = tnms.batched_class_nms(torch.from_numpy(b), torch.from_numpy(s),
                                 torch.from_numpy(cls.astype(np.int64)), 0.5,
                                 50, 0.2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())


def test_top_k_order_matches_jax():
    """Equal values (thousands of exact zeros, rounded ties, -0.0 beside
    +0.0, -inf, negatives as in PointRend's -|logit|) come out lower
    index first, as ``jax.lax.top_k`` gives them."""
    rng = np.random.RandomState(3)
    x = np.round(rng.randn(4, 3000), 1).astype(np.float32)
    x[0, rng.rand(3000) < 0.7] = 0.0
    x[1] = -np.abs(x[1])
    x[2, ::5] = -0.0
    x[3, rng.rand(3000) < 0.2] = -np.inf
    for k in (1, 784, 2048, 3000):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tnms.top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(np.asarray(wi), gi.numpy())
        np.testing.assert_array_equal(np.asarray(wv), gv.numpy())


def test_roi_align_matches_jax():
    """Single level: boxes partly and wholly outside the map (zero
    samples) and tiny ones. Multilevel: each box sampled at its own FPN
    level only (the port) against every level and a pick (the JAX
    package), over boxes of every level's size: the same values."""
    rng = np.random.RandomState(0)
    feat = rng.randn(24, 40, 16).astype(np.float32)
    xy = rng.uniform(-30, 170, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 90, (40, 2))],
                           1).astype(np.float32)
    boxes[:5, 2:] = boxes[:5, :2] + 0.1
    want = jroi.roi_align(jnp.asarray(feat), jnp.asarray(boxes), 7, 0.25)
    got = troi.roi_align(torch.from_numpy(feat), torch.from_numpy(boxes), 7,
                         0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    feats = [rng.randn(64 // 2 ** i, 96 // 2 ** i, 8).astype(np.float32)
             for i in range(4)]
    xy = rng.uniform(-20, 380, (60, 2))
    wh = np.exp(rng.uniform(np.log(4), np.log(700), (60, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    want = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats],
                                     jnp.asarray(boxes), (4, 8, 16, 32),
                                     pooled=14)
    got = troi.multilevel_roi_align([torch.from_numpy(f) for f in feats],
                                    torch.from_numpy(boxes), (4, 8, 16, 32),
                                    pooled=14)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
