"""The port's streaming water level against
``vfloodnet_tpu.pipelines.streaming_waterlevel`` on the CPU, on seeded
48 x 64 frames of a sky over a rippling lower half (the frames of
``chip_smoke.py``), with the JAX package's trained AFB-URR
(``records/checkpoints/video/best.npz``) carried across by the weight
bridge: its flat file loads in a second or two, where a JAX random init
of the model takes about 30 s on the CPU, and it finds water there.

- ``StreamingWaterLevel.step`` on four frames with eight boxes: on every
  frame where the two engines' operating-size labels agree in the column
  under every box, the levels are equal, NaN in the same places; those
  columns agree on at least 3 of the 4 frames. The port's levels also
  equal a host scan of its own fetched label on every frame.
- ``BoundedResolver``: the same levels as the JAX resolver, never more
  than ``lag`` pending.
- ``run_streaming_waterlevel`` on a frame directory (two reference boxes):
  the CSV parses to the same index and columns as the JAX runner's. Its
  values equal JAX's to 1e-9 when every frame's columns agree; otherwise
  the smoothing spreads one frame's difference to its neighbours, so the
  unsmoothed resolver levels are compared frame by frame, on the frames
  whose columns agree.
- The CLI runs ``--opt people`` (no masks: no rows) and ``--opt ref
  --streaming`` on the CPU.
"""

import os
import sys
from datetime import datetime, timedelta

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from vfloodnet_tpu.core.checkpoint import load_flat_npz
from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines import streaming_waterlevel as jsw
from vfloodnet_tpu.pipelines.video_seg import VideoSegEngine as JEngine
from vfloodnet_tpu.utils import save_seg_mask as jsave_seg_mask
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import streaming_waterlevel as tsw
from vfloodnet_tpu_torch.pipelines import waterlevel
from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint
from vfloodnet_tpu_torch.pipelines.video_seg import VideoSegEngine

torch.set_num_threads(4)
HW = (48, 64)
BOXES = [(x, y, 8, 6) for x in (0, 16, 32, 48) for y in (0, 10)]


@pytest.fixture(scope="module")
def models():
    variables = load_flat_npz(default_checkpoint("video"))
    port = AFBURR()
    port.load_state_dict(convert_afb_urr_variables(variables))
    return JAFBURR(read_chunk=128), variables, port.eval()


def _clip(n, seed):
    """Seeded frames [48, 64, 3] uint8 of a sky over a rippling lower half,
    and a first mask of that half as water."""
    h, w = HW
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([90 + 60 * yy / h, 120 + 40 * xx / w,
                     200 - 80 * yy / h], axis=-1)
    water = yy > h * 0.55
    frames = []
    for t in range(n):
        ripple = 25 * np.sin(xx / 37.0 + t * 0.7) * np.cos(yy / 23.0)
        img = base + np.where(water, ripple, 0)[..., None]
        img[water] *= np.array([0.4, 0.6, 1.0], np.float32)
        img = img + rng.randn(h, w, 1) * 6
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames, water.astype(np.uint8)


def _key_cols(boxes, scale):
    return [int((x + w / 2) * scale) for x, y, w, h in boxes]


def _host_levels(label, boxes, scale):
    """The JAX package's level arithmetic on a host scan of ``label``."""
    out = []
    for (x, y, w, h), col in zip(boxes, _key_cols(boxes, scale)):
        row = int((y + h) * scale)
        below = np.nonzero(label[row + 1:, col] == 1)[0]
        if below.size == 0:
            out.append(np.nan)
            continue
        lv = (row + 1 + below[0] - row) / scale
        out.append(np.nan if lv <= 1.0 / scale else float(lv))
    return out


def test_streaming_step_matches_jax(models):
    jm, variables, port = models
    frames, mask0 = _clip(5, 0)
    jeng = JEngine(jm, variables, JFeatureBank(obj_n=2, memory_budget=1024),
                   downsample=48, postprocess="none")
    teng = VideoSegEngine(port, FeatureBank(obj_n=2, memory_budget=1024,
                                            device="cpu"),
                          downsample=48, postprocess="none")
    js, ts = jeng.bootstrap(frames[0], mask0), teng.bootstrap(frames[0],
                                                             mask0)
    jstream = jsw.StreamingWaterLevel(jeng, BOXES)
    tstream = tsw.StreamingWaterLevel(teng, BOXES)
    cols = _key_cols(BOXES, 1.0)
    agreeing, compared = 0, 0
    for i, f in enumerate(frames[1:]):
        js, jlv, jsmall = jstream.step(js, f, i + 1)
        ts, tlv, tsmall = tstream.step(ts, f, i + 1)
        jsmall, tsmall = np.asarray(jsmall), tsmall.numpy()
        assert tsmall.shape == jsmall.shape == HW
        assert len(tlv) == len(BOXES)
        np.testing.assert_array_equal(tlv, _host_levels(tsmall, BOXES, 1.0))
        if np.array_equal(jsmall[:, cols], tsmall[:, cols]):
            agreeing += 1
            np.testing.assert_array_equal(tlv, jlv)
            compared += int(np.isfinite(jlv).sum())
    assert agreeing >= 3, agreeing
    assert compared > 0                  # some levels are not NaN


def test_bounded_resolver_matches_jax():
    values = {i: [float(i)] if i % 3 else [float("nan")] for i in range(200)}

    class FakeStream:
        @staticmethod
        def resolve(pending):
            return values[pending]

    want = jsw.BoundedResolver(FakeStream(), tracker_num=1, lag=4)
    got = tsw.BoundedResolver(FakeStream(), tracker_num=1, lag=4)
    for i in range(200):
        want.push(i)
        got.push(i)
        assert len(got.pending) <= 4
    assert got.finish() == want.finish()
    assert got.max_live == 4
    assert tsw.RESOLVE_LAG == jsw.RESOLVE_LAG


def _frame_dir(tmp_path, n=5):
    """Frames named by their time, a stored box file, and the first
    frame's mask, which the runners read from their output trees."""
    frames, mask0 = _clip(n, 0)
    frame_dir = tmp_path / "frames"
    frame_dir.mkdir()
    t0 = datetime(2021, 5, 1, 12, 0, 0)
    for i, img in enumerate(frames):
        name = (t0 + timedelta(minutes=3 * i)).strftime("%Y-%m-%d-%H-%M-%S")
        Image.fromarray(img).save(frame_dir / f"{name}.png")
    # houston: two reference boxes, no tracker, no homography
    record = tmp_path / "records" / "houston_s"
    record.mkdir(parents=True)
    np.savetxt(record / "ref_bbox.txt",
               np.array([[0.0, 0.0, 8.0, 6.0], [32.0, 0.0, 8.0, 6.0]]))
    return frame_dir, mask0


def _capture(monkeypatch, module, seen):
    """Record each step's operating-size label and boxes, and the
    resolver's unsmoothed levels, of ``module``'s runner."""
    step_async = module.StreamingWaterLevel.step_async
    finish = module.BoundedResolver.finish

    def recording_step(self, state, frame, idx):
        state, pending, small = step_async(self, state, frame, idx)
        seen["small"].append(np.asarray(small.numpy() if torch.is_tensor(
            small) else small))
        seen["boxes"].append(list(self.ref_bboxes))
        return state, pending, small

    def recording_finish(self):
        seen["levels"] = finish(self)
        return seen["levels"]

    monkeypatch.setattr(module.StreamingWaterLevel, "step_async",
                        recording_step)
    monkeypatch.setattr(module.BoundedResolver, "finish", recording_finish)


def test_run_streaming_waterlevel_matches_jax(models, tmp_path,
                                              monkeypatch):
    jm, variables, port = models
    frame_dir, m = _frame_dir(tmp_path)
    first = sorted(os.listdir(frame_dir))[0][:-4]
    runs = {}
    for name, module in (("jax", jsw), ("port", tsw)):
        out_dir = tmp_path / name
        seg_dir = out_dir / "segs" / "houston_s" / "mask"
        seg_dir.mkdir(parents=True)
        jsave_seg_mask(m, str(seg_dir / f"{first}.png"))
        seen = {"small": [], "boxes": []}
        _capture(monkeypatch, module, seen)
        if name == "jax":
            csv = jsw.run_streaming_waterlevel(
                str(frame_dir), "houston_s", str(out_dir),
                str(tmp_path / "records"), jm, variables, budget=1024,
                downsample=48)
        else:
            csv = tsw.run_streaming_waterlevel(
                str(frame_dir), "houston_s", str(out_dir),
                str(tmp_path / "records"), port, budget=1024,
                downsample=48, device="cpu")
        runs[name] = (pd.read_csv(csv, index_col=0, parse_dates=True), seen)
    (want, jseen), (got, tseen) = runs["jax"], runs["port"]
    assert list(got.columns) == list(want.columns) == [
        "est_ref0_px", "est_ref1_px", "est_avg_px"]
    assert got.index.equals(want.index) and len(got) == 4
    cols = _key_cols(jseen["boxes"][0], 1.0)
    agree = [np.array_equal(a[:, cols], b[:, cols])
             for a, b in zip(jseen["small"], tseen["small"])]
    assert sum(agree) >= 3, agree
    if all(agree):
        np.testing.assert_allclose(got.to_numpy(), want.to_numpy(),
                                   rtol=1e-9, atol=1e-9, equal_nan=True)
    for ok, a, b in zip(agree, jseen["levels"], tseen["levels"]):
        if ok:
            np.testing.assert_array_equal(b, a)
    assert np.nanmax(np.abs(want.to_numpy())) > 0   # water was found


def test_cli_refuses_detection_and_runs_streaming(tmp_path, monkeypatch):
    frame_dir, m = _frame_dir(tmp_path, n=3)
    out = tmp_path / "out"
    first = sorted(os.listdir(frame_dir))[0][:-4]
    seg_dir = out / "houston_s_ref" / "segs" / "houston_s" / "mask"
    seg_dir.mkdir(parents=True)
    jsave_seg_mask(m, str(seg_dir / f"{first}.png"))
    base = ["waterlevel", "--test-path", str(frame_dir), "--test-name",
            "houston_s", "--out-dir", str(out), "--record-dir",
            str(tmp_path / "records"), "--device", "cpu"]
    # --opt people runs (no masks under the default --seg-dir: no rows)
    monkeypatch.setattr(sys, "argv", base + ["--opt", "people"])
    waterlevel.main()
    assert (out / "houston_s_people" / "waterdepth.txt").read_text() == ""
    monkeypatch.setattr(sys, "argv", base + ["--opt", "ref", "--streaming"])
    waterlevel.main()
    df = pd.read_csv(out / "houston_s_ref" / "waterlevel.csv", index_col=0,
                     parse_dates=True)
    assert len(df) == 2 and list(df.columns)[-1] == "est_avg_px"
