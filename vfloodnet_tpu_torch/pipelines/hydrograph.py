"""Hydrograph comparison against gauge records (counterpart of
``vfloodnet_tpu.pipelines.hydrograph``): pixel water levels to meters by a
per-site affine ``px_to_meter.txt`` (one row per tracker), the site's
gauge ``gt.csv`` parsed by a :class:`SiteGaugeProfile` matched on the test
name, the gauge series linearly resampled to the estimate's timestamps,
and the mean and spread of the absolute error in cm and as a share of the
gauge peak, with an optional plot. A host-side analysis tool: pandas and
matplotlib are imported inside its functions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SiteGaugeProfile:
    """How to parse one site's gauge gt.csv (reference
    cmp_hydrograph.py:65-86)."""
    name: str
    match: str                       # test-name substring that selects this
    time_cols: Tuple[int, ...]       # columns joined with ' ' -> datetime
    value_col: int
    time_format: Optional[str] = None
    coerce: bool = False             # invalid datetimes -> NaT (LSU)
    # gauge-clock correction: shift gt times by this many minutes when the
    # test name also contains ``shift_when`` (boston 20190119_20190123)
    time_shift_min: float = 0.0
    shift_when: Optional[str] = None
    label: str = "Water Level"


SITE_PROFILES: Sequence[SiteGaugeProfile] = (
    SiteGaugeProfile("boston_harbor", match="boston_harbor",
                     time_cols=(0, 1), value_col=4,
                     time_shift_min=-60.0, shift_when="20190119_20190123"),
    SiteGaugeProfile("houston", match="houston", time_cols=(0,),
                     value_col=2, time_format="%m/%d/%Y %H:%M"),
    SiteGaugeProfile("LSU", match="LSU", time_cols=(0,), value_col=1,
                     time_format="%Y-%m-%d-%H-%M-%S", coerce=True,
                     label="Water Depth"),
)

GENERIC_PROFILE = SiteGaugeProfile("generic", match="", time_cols=(0,),
                                   value_col=1)


def gauge_profile_for(test_name: str) -> SiteGaugeProfile:
    for profile in SITE_PROFILES:
        if profile.match and profile.match in test_name:
            return profile
    return GENERIC_PROFILE


def load_gauge_csv(gt_csv: str, profile: SiteGaugeProfile,
                   test_name: str = "") -> Tuple[np.ndarray, np.ndarray]:
    """Parse a site gt.csv -> (times [datetime64], values [float])."""
    import pandas as pd
    gt = pd.read_csv(gt_csv)
    joined = gt.iloc[:, profile.time_cols[0]].astype(str)
    for col in profile.time_cols[1:]:
        joined = joined + " " + gt.iloc[:, col].astype(str)
    times = pd.to_datetime(joined, format=profile.time_format,
                           errors="coerce" if profile.coerce else "raise")
    if profile.time_shift_min and (profile.shift_when is None
                                   or profile.shift_when in test_name):
        times = times + pd.Timedelta(minutes=profile.time_shift_min)
    values = pd.to_numeric(gt.iloc[:, profile.value_col], errors="coerce")
    ok = times.notna() & values.notna()
    return (times[ok].to_numpy(), values[ok].to_numpy(np.float64))


def load_px_to_meter(path: str) -> np.ndarray:
    """Affine px->meter calibration, one (scale, offset) row per tracker:
    meters = scale * px + offset (reference cmp_hydrograph.py:55-95)."""
    vals = np.loadtxt(path)
    if vals.ndim == 0:
        vals = np.array([[float(vals), 0.0]])
    elif vals.ndim == 1:
        vals = vals[None, :] if vals.size > 1 else np.array([[vals[0], 0.0]])
    return vals


def resample_gt(gt_times: np.ndarray, gt_values: np.ndarray,
                est_times: np.ndarray) -> np.ndarray:
    """Linear interpolation of the gauge series onto estimate timestamps
    (reference get_gt_sample, cmp_hydrograph.py:27-38)."""
    import pandas as pd
    gt_s = pd.to_datetime(pd.Series(list(gt_times))).astype(np.int64) / 1e9
    est_s = pd.to_datetime(pd.Series(list(est_times))).astype(np.int64) / 1e9
    return np.interp(est_s.to_numpy(), gt_s.to_numpy(), gt_values)


def estimate_meters(est, px_to_meter: np.ndarray) -> np.ndarray:
    """Per-tracker affine conversion of the estimate's DataFrame, averaged
    over trackers (reference cmp_hydrograph.py:92-97). Falls back to
    est_avg_px for single-tracker CSVs without est_ref columns."""
    tracker_cols = [c for c in est.columns if c.startswith("est_ref")
                    and c.endswith("_px")]
    if tracker_cols:
        meters = np.stack([
            px_to_meter[min(i, len(px_to_meter) - 1), 0]
            * est[f"est_ref{i}_px"].to_numpy(np.float64)
            + px_to_meter[min(i, len(px_to_meter) - 1), 1]
            for i in range(len(tracker_cols))])
        return np.nanmean(meters, axis=0)
    return (est["est_avg_px"].to_numpy(np.float64) * px_to_meter[0, 0]
            + px_to_meter[0, 1])


def compare_hydrographs(est_csv: str, gt_csv: str, px_to_meter_path: str,
                        out_dir: Optional[str] = None,
                        test_name: str = "") -> dict:
    """Returns {'mean_abs_err_cm', 'std_abs_err_cm', 'mean_err_rate'} and
    writes a comparison plot when out_dir is given. ``test_name`` selects
    the site gauge format (see :data:`SITE_PROFILES`)."""
    import pandas as pd
    est = pd.read_csv(est_csv, index_col=0, parse_dates=True)
    est_m = estimate_meters(est, load_px_to_meter(px_to_meter_path))

    profile = gauge_profile_for(test_name)
    gt_times, gt_vals = load_gauge_csv(gt_csv, profile, test_name)
    est_times = [t.to_pydatetime() if hasattr(t, "to_pydatetime") else t
                 for t in est.index]
    gt_resampled = resample_gt(gt_times, gt_vals, np.array(est_times))

    ok = np.isfinite(est_m)
    abs_err_cm = np.abs(est_m[ok] - gt_resampled[ok]) * 100.0
    # error rate normalised by the gauge peak (reference
    # cmp_hydrograph.py:103: abs_err / nanmax(gt_val_sample))
    peak = max(abs(float(np.nanmax(gt_resampled))), 1e-9) * 100.0
    result = {
        "site_profile": profile.name,
        "mean_abs_err_cm": float(abs_err_cm.mean()),
        "std_abs_err_cm": float(abs_err_cm.std()),
        "mean_err_rate": float((abs_err_cm / peak).mean()),
        "n": int(ok.sum()),
    }

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(16, 8))
        ax.plot(est_times, est_m, "o", label=f"estimated {profile.label} (m)")
        ax.plot(est_times, gt_resampled, "-", label="gauge (m)")
        ax.set_ylabel(f"{profile.label} (m)")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "hydrograph_cmp.png"), dpi=200)
        plt.close(fig)
        with open(os.path.join(out_dir, "cmp_report.txt"), "w") as f:
            f.write(f"site profile: {profile.name}\n"
                    f"mean abs err: {result['mean_abs_err_cm']:.2f} cm\n"
                    f"std abs err:  {result['std_abs_err_cm']:.2f} cm\n"
                    f"err rate:     {result['mean_err_rate'] * 100:.2f} %\n"
                    f"samples:      {result['n']}\n")
    return result
