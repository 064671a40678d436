"""The video trainer's data path against the JAX package's, on the CPU,
on the bundled demo set ``records/demo_train``:

- ``WaterVideoTrainDataset`` gives frames, one-hot masks and object counts
  bit-equal to the JAX dataset's for several (seed, epoch, index), at two
  output sizes and object counts;
- ``BatchLoader`` gives the JAX loader's batches, in its order, with no
  worker (the default, which starts no thread) and with 2 worker threads;
- ``AvgMeter``, ``MetricWriter`` and ``save_scripts`` as the JAX
  package's.
"""

import json
import os
import threading

import numpy as np
import pytest

from vfloodnet_tpu.data import BatchLoader as JBatchLoader
from vfloodnet_tpu.data import WaterVideoTrainDataset as JDataset
from vfloodnet_tpu.utils import AvgMeter as JAvgMeter
from vfloodnet_tpu.utils.logging import MetricWriter as JMetricWriter
from vfloodnet_tpu_torch.data import BatchLoader, WaterVideoTrainDataset
from vfloodnet_tpu_torch.utils import AvgMeter, MetricWriter, save_scripts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "records", "demo_train")


@pytest.mark.parametrize("size,clip_n,obj_n,seed", [(96, 4, 3, 0),
                                                    (64, 3, 2, 5)])
def test_dataset_is_bit_equal_to_jax(size, clip_n, obj_n, seed):
    kw = dict(output_size=size, clip_n=clip_n, max_obj_n=obj_n, seed=seed)
    port, jax_ds = WaterVideoTrainDataset(ROOT, **kw), JDataset(ROOT, **kw)
    assert len(port) == len(jax_ds) == 3
    assert port.img_list == jax_ds.img_list
    for epoch, idx in ((0, 0), (0, 2), (3, 1)):
        got, want = port.get(idx, epoch), jax_ds.get(idx, epoch)
        assert got[0].dtype == want[0].dtype == np.float32
        assert got[0].shape == (clip_n, size, size, 3)
        assert got[1].shape == (clip_n, obj_n, size, size)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


class _Counting:
    """A dataset of small seeded arrays whose sample is a pure function of
    (epoch, idx)."""

    def __len__(self):
        return 7

    def get(self, idx, epoch=0):
        rng = np.random.default_rng([epoch, idx])
        return (rng.random((2, 3), dtype=np.float32),
                np.full((4,), idx, np.int64), f"{epoch}/{idx}")


def test_loader_batches_match_jax_with_and_without_workers(monkeypatch):
    ds = _Counting()
    started = []
    real_start = threading.Thread.start
    monkeypatch.setattr(threading.Thread, "start",
                        lambda self: started.append(1) or real_start(self))
    for drop_last in (True, False):
        want = [list(JBatchLoader(ds, 3, seed=4, drop_last=drop_last)
                     .epoch(e)) for e in (0, 1)]
        started.clear()
        inline = BatchLoader(ds, 3, seed=4, drop_last=drop_last)
        got0 = [list(inline.epoch(e)) for e in (0, 1)]
        assert not started
        got2 = [list(BatchLoader(ds, 3, seed=4, drop_last=drop_last,
                                 workers=2).epoch(e)) for e in (0, 1)]
        assert started
        assert len(inline) == len(want[0])
        for got in (got0, got2):
            assert len(got[0]) == len(want[0])
            for gb, wb in zip(sum(got, []), sum(want, [])):
                np.testing.assert_array_equal(gb[0], wb[0])
                np.testing.assert_array_equal(gb[1], wb[1])
                assert gb[2] == wb[2]


def test_meters_logging_and_scripts_as_jax(tmp_path):
    a, b = AvgMeter(), JAvgMeter()
    for v, n in ((1.0, 1), (4.0, 2), (0.5, 1), (2.0, 3)):
        a.update(v, n)
        b.update(v, n)
        assert a.avg == b.avg and a.cnt == b.cnt
    with MetricWriter(str(tmp_path / "p")) as w:
        w.write("epoch", step=3, loss=np.float32(0.25), epoch=1, tag="x")
    jw = JMetricWriter(str(tmp_path / "j"))
    jw.write("epoch", step=3, loss=np.float32(0.25), epoch=1, tag="x")
    jw.close()
    recs = [json.loads(open(tmp_path / d / "metrics.jsonl").read())
            for d in ("p", "j")]
    for r in recs:
        r.pop("t")
    assert recs[0] == recs[1] == {"event": "epoch", "step": 3,
                                  "loss": 0.25, "epoch": 1.0, "tag": "x"}
    save_scripts(str(tmp_path / "log"), os.path.join(REPO,
                                                     "vfloodnet_tpu_torch"))
    assert os.path.exists(tmp_path / "log" / "scripts" / "train" /
                          "train_video.py")
    assert not any(f.endswith((".cu", ".pyc")) for _, _, fs in os.walk(
        tmp_path / "log") for f in fs)
