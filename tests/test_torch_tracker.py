"""The port's MOSSE tracker (``vfloodnet_tpu_torch.ops.tracker``) against
``vfloodnet_tpu.ops.tracker`` on the CPU.

- Given the same patches, the filter terms (``_init_filter``), the
  responses (``_respond_multi``, ``_respond``) and the update
  (``_update_filter``) agree within 1e-4 of each tensor's largest
  magnitude, the displacements are equal and the best-PSR candidate is
  the same; the filters that ``init`` learns from one frame (window crop,
  augmentations, filter) agree within 1e-4 too.
- On the five scenarios of ``tests/test_tracker.py`` (translation, loss of
  the object, the image border, growth, a static object), the boxes are
  within 1 px on every frame and the ``ok`` flags are equal.
"""

import numpy as np
import pytest
import torch

from test_tracker import _scene, _scene_scaled
from vfloodnet_tpu.ops import tracker as jt
from vfloodnet_tpu_torch.ops import tracker as tt


def _close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_filter_terms_and_responses_match_jax():
    rng = np.random.default_rng(0)
    patches = rng.uniform(0, 255, (8, tt.SIZE, tt.SIZE)).astype(np.float32)
    # candidates: a shifted copy of the first patch, a noisier one, noise
    noisy = np.clip(patches[0] + rng.normal(0, 30, patches[0].shape), 0, 255)
    cands = np.stack([np.roll(patches[0], (3, -2), (0, 1)), noisy,
                      rng.uniform(0, 255, patches[0].shape)]
                     ).astype(np.float32)
    jnum, jden = jt._init_filter(patches)
    num, den = tt._init_filter(torch.from_numpy(patches))
    _close(num, jnum)
    _close(den, jden)
    jdy, jdx, jpsr = (np.asarray(v) for v in jt._respond_multi(jnum, jden,
                                                               cands))
    dy, dx, psr = (v.numpy() for v in tt._respond_multi(
        num, den, torch.from_numpy(cands)))
    np.testing.assert_array_equal(dy, jdy)
    np.testing.assert_array_equal(dx, jdx)
    _close(psr, jpsr)
    assert int(np.argmax(psr)) == int(np.argmax(jpsr)) == 0
    assert (dy[0], dx[0]) == (3.0, -2.0)
    jout = jt._respond(jnum, jden, cands[1])
    out = tt._respond(num, den, torch.from_numpy(cands[1]))
    for got, want in zip(out, jout):
        _close(got.numpy(), want)
    jn2, jd2 = jt._update_filter(jnum, jden, jout[3], np.float32(0.125))
    n2, d2 = tt._update_filter(num, den, out[3], 0.125)
    _close(n2, jn2)
    _close(d2, jd2)
    # what init learns from a frame: crop, augmentations and filter
    frame = _scene(np.random.default_rng(1), 80, 90)
    jtr, ttr = jt.MosseTracker(), tt.MosseTracker(device="cpu")
    jtr.init(frame, (65, 75, 30, 30))
    ttr.init(frame, (65, 75, 30, 30))
    _close(ttr._num, jtr._num)
    _close(ttr._den, jtr._den)


def _translating(rng):
    cx, cy = 80.0, 90.0
    frames = [_scene(rng, cx, cy)]
    for _ in range(15):
        cx, cy = cx + 3.0, cy + 2.0
        frames.append(_scene(rng, cx, cy))
    return frames, (65, 75, 30, 30)


def _lost(rng):
    frames = [_scene(rng, 120, 120), _scene(rng, 120, 120)]
    frames += [rng.uniform(0, 60, (240, 240)).astype(np.float32)
               for _ in range(5)]
    return frames, (105, 105, 30, 30)


def _border(rng):
    frames = [_scene(rng, 30, 30, size=200)]
    frames += [_scene(rng, 25 - t, 25 - t, size=200) for t in range(10)]
    return frames, (15, 15, 30, 30)


def _growing(rng):
    side = 30.0
    frames = [_scene_scaled(rng, 120, 120, side)]
    for _ in range(24):
        side *= 1.023
        frames.append(_scene_scaled(rng, 120, 120, side))
    return frames, (105, 105, 30, 30)


def _static(rng):
    return ([_scene_scaled(rng, 120, 120, 30) for _ in range(21)],
            (105, 105, 30, 30))


@pytest.mark.parametrize("scenario,seed", [
    (_translating, 0), (_lost, 1), (_border, 2), (_growing, 3),
    (_static, 4)], ids=["translating", "lost", "border", "growing",
                        "static"])
def test_tracker_follows_jax_on_the_tracker_scenarios(scenario, seed):
    frames, box = scenario(np.random.default_rng(seed))
    jtr, ttr = jt.MosseTracker(), tt.MosseTracker(device="cpu")
    jtr.init(frames[0], box)
    ttr.init(frames[0], box)
    for i, frame in enumerate(frames[1:]):
        jok, jbox = jtr.update(frame)
        ok, got = ttr.update(frame)
        assert ok == jok, i
        assert max(abs(a - b) for a, b in zip(got, jbox)) <= 1, (i, got,
                                                                 jbox)
