"""``resolve_postprocess`` of the port against the JAX package's, for
CPU and CUDA devices and 2 or 8 CPUs (the JAX platform query and
``os.cpu_count`` are replaced for the test)."""

import os
import types

import pytest

import vfloodnet_tpu.pipelines.video_seg as jvs
from vfloodnet_tpu_torch.pipelines.video_seg import resolve_postprocess


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
@pytest.mark.parametrize("cpus", [2, 8])
def test_resolve_postprocess_matches_jax(monkeypatch, platform, cpus):
    monkeypatch.setattr(os, "cpu_count", lambda: cpus)
    monkeypatch.setattr(jvs.jax, "devices",
                        lambda: [types.SimpleNamespace(platform=platform)])
    device = "cpu" if platform == "cpu" else "cuda"
    for mode in ("auto", True, False, "host", "device", "none"):
        assert resolve_postprocess(mode, device) == \
            jvs.resolve_postprocess(mode), (mode, platform, cpus)
    assert resolve_postprocess("auto", device) == (
        "device" if platform == "gpu" and cpus < 4 else "host")
