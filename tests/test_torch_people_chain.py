"""The people depth chain through the port against the JAX package on the
CPU:

- ``crop_person``: the crop and its mask crop byte-equal to the JAX
  package's (``cv2.resize``) on 300 boxes over a 500 x 600 frame: boxes
  clamped at every border, crops up- and downscaled to 224, 1:1 and an
  exact 2x (448 -> 224).
- OpenCV's ``INTER_NEAREST`` (``ops/resize.py::cv2_nearest``) on 300 size
  pairs, up and down, and the zero-radius ``cv2.circle`` of thickness 2-5
  (``utils/draw.py::dot``) against cv2, exactly; the synthetic standing
  template equal to the JAX package's, bit for bit.
- The injected chain of ``tests/test_people_path.py`` (a fixed detection,
  a fixed vertex set): the port's rows and canvases equal JAX's; so do
  ``waterdepth_by_people``'s ratio and canvases on random vertices.
- The trained tiny pair (``records/checkpoints/people_tiny`` and
  ``records/checkpoints/bodymesh``) on the staged scenes
  (``records/demo_eval/people``): the JAX package's rows as written
  (scene0 0.2019 / 35.4094, scene1 0.4789 / 83.9944) from both packages,
  canvases >= 0.99 of pixels equal; ``--opt people`` through the port's CLI
  on the CPU writes them too.
- The card's fixtures (``records/port_fixtures/people_scene{0,1}_*.npy``:
  the decoded frame and mask, and the trained tiny detector's boxes and
  scores as the JAX package finds them) equal what they were made from.
  ``python -m tests.test_torch_people_chain`` writes them.
"""

import os
import shutil
import sys
from glob import glob

import numpy as np
import pytest

from vfloodnet_tpu.pipelines import object_detection as jod
from vfloodnet_tpu.pipelines.object_detection import Instances as JInst
from vfloodnet_tpu.utils import save_seg_mask
from vfloodnet_tpu_torch.ops.resize import cv2_nearest
from vfloodnet_tpu_torch.pipelines import object_detection as tod
from vfloodnet_tpu_torch.pipelines import waterlevel
from vfloodnet_tpu_torch.utils import load_image, load_mask
from vfloodnet_tpu_torch.utils.draw import dot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(REPO, "records", "demo_eval", "people")
FIXTURE = os.path.join(REPO, "records", "port_fixtures",
                       "people_scene{}_{}.npy")
ROWS = ["scene0\t0.2019\t35.4094", "scene1\t0.4789\t83.9944"]


def _lists():
    imgs = sorted(glob(os.path.join(SCENES, "frames", "*.png")))
    return imgs, [os.path.join(SCENES, "masks", os.path.basename(p))
                  for p in imgs]


def test_crop_person_matches_jax():
    rng = np.random.RandomState(0)
    h, w = 500, 600
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    mask = rng.randint(0, 3, (h, w), np.uint8)
    boxes = []
    for _ in range(300):
        cx, cy = rng.uniform(-20, w + 20), rng.uniform(-20, h + 20)
        bw, bh = rng.uniform(3, 450, 2)
        boxes.append((cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2))
    side = 448 / 1.5 - 1e-5                        # a 448 crop: exact 2x
    boxes += [(100.0, 50.0, 249.0, 199.0),         # a 224 crop: no resize
              (300.5 - side / 2, 250.0, 300.5 + side / 2, 260.0)]
    sizes = set()
    for box in boxes:
        want = jod.crop_person(img, mask, box)
        got = tod.crop_person(img, mask, box)
        for g, wv in zip(got, want):
            assert g.dtype == wv.dtype and g.shape == wv.shape
            np.testing.assert_array_equal(g, wv)
        x1, y1, x2, y2 = box
        r = min(min(h, w), 1.5 * max(x2 - x1, y2 - y1)) / 2
        sizes.add(int((x1 + x2) / 2 + r) - int((x1 + x2) / 2 - r))
    assert min(sizes) < 224 < max(sizes) and 448 in sizes


def test_nearest_dot_and_template_match_opencv(tmp_path):
    import cv2
    from vfloodnet_tpu.pipelines.object_detection import _load_template_3d
    rng = np.random.RandomState(1)
    for i in range(300):
        h, w = rng.randint(1, 500, 2)
        oh, ow = (224, 224) if i % 3 == 0 else rng.randint(1, 500, 2)
        img = rng.randint(0, 256, (h, w), np.uint8)
        np.testing.assert_array_equal(
            cv2_nearest(img, (oh, ow)),
            cv2.resize(img, (int(ow), int(oh)),
                       interpolation=cv2.INTER_NEAREST))
    a = np.full((60, 50, 3), 255, np.uint8)
    b = a.copy()
    for th in (2, 3, 4, 5):
        for x, y in rng.randint(-3, 63, (40, 2)):
            color = [int(c) for c in rng.randint(0, 256, 3)]
            cv2.circle(a, (int(x), int(y)), 0, color, th)
            dot(b, (x, y), color, th)
    np.testing.assert_array_equal(b, a)
    want = _load_template_3d(None)
    np.testing.assert_array_equal(tod.load_template_3d(None), want)
    path = tmp_path / "template.json"
    path.write_text("[[0.5, -0.25, 1.0], [0.125, 0.75, 2.0]]")
    np.testing.assert_array_equal(tod.load_template_3d(str(path)),
                                  _load_template_3d(str(path)))


def test_injected_chain_matches_jax(tmp_path):
    """``tests/test_people_path.py``'s chain: water over the bottom 40 %, a
    standing person box, a straight vertical vertex set."""
    import cv2
    h, w = 240, 320
    img_path = str(tmp_path / "frame.png")
    cv2.imwrite(img_path, np.full((h, w, 3), 128, np.uint8))
    water = np.zeros((h, w), np.uint8)
    water[int(h * 0.6):, :] = 1
    mask_path = str(tmp_path / "mask.png")
    save_seg_mask(water, mask_path)
    box = np.array([[140.0, 48.0, 180.0, 216.0]])
    template = np.stack([np.zeros(431), np.linspace(-0.9, 0.9, 431)], 1)
    rows = {}
    for name, mod, inst in (
            ("jax", jod, JInst), ("port", tod, tod.Instances)):
        out = tmp_path / name
        path = mod.est_by_obj_detection(
            [img_path], [mask_path], str(out), "people",
            detector=lambda _img, inst=inst: inst(
                boxes=box, scores=np.array([0.95]), classes=np.array([0])),
            mesh_regressor=lambda crop: template, template_3d_path=None)
        with open(path) as f:
            rows[name] = f.read().splitlines()
    assert rows["port"] == rows["jax"] and len(rows["jax"]) == 1
    ratio = float(rows["port"][0].split("\t")[1])
    assert 0.05 <= ratio <= 0.8
    rng = np.random.RandomState(3)
    crop_mask = np.zeros((224, 224), np.uint8)
    crop_mask[130:] = 1
    pred = rng.uniform(-1.1, 1.1, (431, 2))
    ratios = [mod.waterdepth_by_people(
        crop_mask, pred, jod._load_template_3d(None),
        result_dir=str(tmp_path / name / "result"), img_name="random")
        for name, mod in (("port", tod), ("jax", jod))]
    assert ratios[0] == ratios[1] is not None
    for kind in ("est", "template"):
        for img_name in ("frame", "random"):
            got, want = (cv2.imread(str(tmp_path / n / "result" /
                                        f"{img_name}_{kind}.png"))
                         for n in ("port", "jax"))
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def trained_runs(tmp_path_factory):
    imgs, masks = _lists()
    out = {}
    for name, fn in (("jax", jod.est_by_obj_detection),
                     ("port", tod.est_by_obj_detection)):
        d = str(tmp_path_factory.mktemp(name))
        kw = {"device": "cpu"} if name == "port" else {}
        with open(fn(imgs, masks, d, "people", **kw)) as f:
            out[name] = (d, f.read().splitlines())
    return out


def test_trained_pair_matches_jax(trained_runs):
    import cv2
    assert trained_runs["jax"][1] == ROWS
    assert trained_runs["port"][1] == ROWS
    for scene in ("scene0", "scene1"):
        for kind in ("est", "template"):
            want, got = (cv2.imread(os.path.join(trained_runs[k][0], "result",
                                                 f"{scene}_{kind}.png"))
                         for k in ("jax", "port"))
            assert got is not None and got.shape == want.shape
            assert (got == want).all(axis=-1).mean() >= 0.99


def test_cli_people(tmp_path, monkeypatch):
    frames = tmp_path / "frames"
    seg = tmp_path / "segs" / "demo" / "mask"
    frames.mkdir()
    seg.mkdir(parents=True)
    for img, mask in zip(*_lists()):
        shutil.copy(img, frames)
        shutil.copy(mask, seg)
    monkeypatch.setattr(sys, "argv", [
        "waterlevel", "--test-path", str(frames), "--test-name", "demo",
        "--opt", "people", "--seg-dir", str(tmp_path / "segs"), "--out-dir",
        str(tmp_path / "out"), "--device", "cpu"])
    waterlevel.main()
    with open(tmp_path / "out" / "demo_people" / "waterdepth.txt") as f:
        assert f.read().splitlines() == ROWS


def _jax_detections():
    """The trained tiny detector's [N, 5] (box, score) rows of each staged
    scene, as the JAX package finds them on the frame cv2 decodes."""
    import cv2
    from vfloodnet_tpu.models.detection import load_default_detector
    det = load_default_detector("people")
    out = []
    for path in _lists()[0]:
        inst = det(cv2.imread(path))
        out.append(np.concatenate([inst.boxes, inst.scores[:, None]],
                                  1).astype(np.float32))
    return out


def test_card_fixtures_match_sources():
    dets = _jax_detections()
    for i, (img, mask) in enumerate(zip(*_lists())):
        frame = np.load(FIXTURE.format(i, "frame"))
        np.testing.assert_array_equal(
            frame, np.ascontiguousarray(load_image(img)[..., ::-1]))
        np.testing.assert_array_equal(np.load(FIXTURE.format(i, "mask")),
                                      load_mask(mask))
        np.testing.assert_array_equal(np.load(FIXTURE.format(i, "det")),
                                      dets[i])
        assert dets[i].shape == (1, 5) and dets[i][0, 4] >= 0.9


if __name__ == "__main__":
    for i, ((img, mask), det) in enumerate(zip(zip(*_lists()),
                                               _jax_detections())):
        np.save(FIXTURE.format(i, "frame"),
                np.ascontiguousarray(load_image(img)[..., ::-1]))
        np.save(FIXTURE.format(i, "mask"), load_mask(mask))
        np.save(FIXTURE.format(i, "det"), det)
