"""The port's file-based water level and hydrograph comparison against
``vfloodnet_tpu.pipelines.reference_tracking`` and ``.hydrograph`` on the
CPU, on the synthetic video of ``tests/test_tracking_hydrograph.py`` (120 x
160 frames, water rising 3 px a frame) and the gauge fixtures of
``tests/fixtures/gauge/``.

- ``est_by_reference`` on the same mask files: the CSV parses to the same
  index and columns, values equal to 1e-9; the overlays with the boxes and
  waterline marks equal the JAX package's PNGs pixel for pixel. With a
  site that tracks (MOSSE) and rectifies (a stored homography), the CSV
  still equals JAX's to 1e-9.
- ``compare_hydrographs``: equal ``n`` and errors to 1e-9 on that video's
  levels and on the three gauge formats.
"""

import os
from datetime import timedelta

import cv2
import numpy as np
import pandas as pd
import pytest

from test_tracking_hydrograph import FIXTURES, _est_csv, _make_video, _px2m
from vfloodnet_tpu.pipelines import hydrograph as jhydro
from vfloodnet_tpu.pipelines import reference_tracking as jref
from vfloodnet_tpu_torch.pipelines import hydrograph as thydro
from vfloodnet_tpu_torch.pipelines import reference_tracking as tref


def _csvs_equal(got, want):
    a = pd.read_csv(got, index_col=0, parse_dates=True)
    b = pd.read_csv(want, index_col=0, parse_dates=True)
    assert list(a.columns) == list(b.columns)
    assert a.index.equals(b.index)
    np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), rtol=1e-9,
                               atol=1e-9, equal_nan=True)
    return a


def _records(tmp_path, site, homography=None):
    record_dir = tmp_path / "records"
    (record_dir / site).mkdir(parents=True)
    np.savetxt(record_dir / site / "ref_bbox.txt",
               np.array([[74.0, 18.0, 12.0, 24.0]]))
    if homography is not None:
        np.savetxt(record_dir / site / "homo_mat.txt", homography)
    return record_dir


def test_est_by_reference_matches_jax(tmp_path):
    img_list, mask_list, levels, _ = _make_video(tmp_path)
    record_dir = _records(tmp_path, "LSU_test")
    out = {}
    for name, mod in (("jax", jref), ("port", tref)):
        kw = {} if name == "jax" else {"device": "cpu"}
        out[name] = mod.est_by_reference(img_list, mask_list,
                                         str(tmp_path / name),
                                         str(record_dir), "LSU_test", **kw)
    df = _csvs_equal(out["port"], out["jax"])
    assert abs(df["est_avg_px"].to_numpy()[0] - 48) < 4
    assert os.path.exists(tmp_path / "port" / "waterlevel_px.png")
    for path in img_list:
        name = os.path.basename(path)
        want = cv2.imread(str(tmp_path / "jax" / "viz" / name))
        got = cv2.imread(str(tmp_path / "port" / "viz" / name))
        np.testing.assert_array_equal(got, want)


def test_est_by_reference_tracks_and_rectifies_as_jax(tmp_path):
    img_list, mask_list, _, _ = _make_video(tmp_path)
    # a mild perspective: the frame's corners move by up to 3 px
    src = np.array([[0, 0], [159, 0], [0, 119], [159, 119]], np.float64)
    dst = src + np.array([[2, 1], [-3, 2], [1, -2], [-2, -3]])
    homography = cv2.getPerspectiveTransform(src.astype(np.float32),
                                             dst.astype(np.float32))
    record_dir = _records(tmp_path, "boston_test", homography)
    out = {}
    for name, mod in (("jax", jref), ("port", tref)):
        kw = {} if name == "jax" else {"device": "cpu"}
        with pytest.warns(UserWarning, match="MOSSE"):
            out[name] = mod.est_by_reference(
                img_list, mask_list, str(tmp_path / name), str(record_dir),
                "boston_test", viz=False, **kw)
    df = _csvs_equal(out["port"], out["jax"])
    assert np.isfinite(df["est_avg_px"].to_numpy()).all()


def test_compare_hydrographs_on_the_video_matches_jax(tmp_path):
    img_list, mask_list, levels, t0 = _make_video(tmp_path)
    record_dir = _records(tmp_path, "LSU_test")
    csv = jref.est_by_reference(img_list, mask_list, str(tmp_path / "out"),
                                str(record_dir), "LSU_test", viz=False)
    times = [t0 + timedelta(minutes=3 * i) for i in range(len(levels))]
    gt = tmp_path / "gt.csv"
    pd.DataFrame({"time": times, "level_m": [(120 - wr) * 0.01
                                             for wr in levels]}).to_csv(
        gt, index=False)
    px2m = tmp_path / "px_to_meter.txt"
    np.savetxt(px2m, np.array([-0.01, 0.78]))
    want = jhydro.compare_hydrographs(str(csv), str(gt), str(px2m))
    got = thydro.compare_hydrographs(str(csv), str(gt), str(px2m),
                                     str(tmp_path / "cmp"))
    assert got["n"] == want["n"] == len(levels)
    assert got["site_profile"] == want["site_profile"]
    for key in ("mean_abs_err_cm", "std_abs_err_cm", "mean_err_rate"):
        assert abs(got[key] - want[key]) <= 1e-9 * max(1.0, abs(want[key]))
    assert os.path.exists(tmp_path / "cmp" / "hydrograph_cmp.png")
    assert os.path.exists(tmp_path / "cmp" / "cmp_report.txt")


@pytest.mark.parametrize("site,times,cols,rows,test_name", [
    ("boston_harbor", ["2019-01-19 11:00", "2019-01-19 12:00"],
     {"est_ref0_px": [1.8, 1.6]}, [[1.0, 0.0]],
     "boston_harbor_20190119_20190123"),
    ("houston", ["2019-01-19 10:30", "2019-01-19 12:00"],
     {"est_ref0_px": [19.6, 21.2], "est_ref1_px": [19.6, 21.2],
      "est_avg_px": [19.6, 21.2]}, [[0.5, 0.0], [0.5, 0.0]],
     "houston_buffalo"),
    ("LSU", ["2021-03-05 10:00:30", "2021-03-05 10:02:30"],
     {"est_ref0_px": [0.225, 0.29]}, [[1.0, 0.0]], "LSU_demo"),
], ids=["boston_harbor", "houston", "LSU"])
def test_gauge_formats_match_jax(tmp_path, site, times, cols, rows,
                                 test_name):
    est = _est_csv(tmp_path, times, cols)
    px2m = _px2m(tmp_path, rows)
    gt = os.path.join(FIXTURES, f"{site}_gt.csv")
    for name in (test_name, f"{site}_other"):
        want = jhydro.compare_hydrographs(est, gt, px2m, test_name=name)
        got = thydro.compare_hydrographs(est, gt, px2m, test_name=name)
        assert got["site_profile"] == want["site_profile"]
        assert got["n"] == want["n"]
        for key in ("mean_abs_err_cm", "std_abs_err_cm", "mean_err_rate"):
            assert abs(got[key] - want[key]) <= 1e-9
    assert thydro.gauge_profile_for(test_name).name == site
