"""The image, detection and body-mesh trainers on the card. Marked
``cuda``; each test skips where there is no GPU. Run on a GPU machine with
``python -m pytest --noconftest -m cuda tests/test_torch_trainers_cuda.py``.

``chip_smoke.py`` phase 16's card-against-CPU steps in float64 (TF32 off,
cuDNN deterministic), one case a trainer: the image trainer from the
bundled trained LinkNet on two 128-px stills, the tiny people detector
(masks and keypoints) from seeded weights on a 96-px scene, and the
seeded body-mesh regressor (live BN) on one 224-px training sample. The
losses within 1e-9 relative and every gradient leaf within 1e-6 of its
scale (a leaf whose gradient vanishes, within 1e-6 of 1e-9 of the
largest leaf); no step launches any of the port's CUDA kernels.
"""

import pytest
import torch

import chip_smoke
from vfloodnet_tpu_torch.core import load_flat_npz
from vfloodnet_tpu_torch.ops import bank_read_cuda, cc_cuda, nms_cuda
from vfloodnet_tpu_torch.pipelines.loaders import default_checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _grads_fn(name):
    if name == "image":
        variables = load_flat_npz(default_checkpoint("image"))
        images, masks = chip_smoke.image_batch(2, 128, chip_smoke.SEED + 22)
        return lambda dev, dt: chip_smoke.image_grads(variables, dev, dt,
                                                      images, masks)
    if name == "detection":
        return lambda dev, dt: chip_smoke.detection_grads(dev, dt, 0)
    return lambda dev, dt: chip_smoke.bodymesh_grads(dev, dt, 0)


@pytest.mark.parametrize("name", ["image", "detection", "bodymesh"])
def test_card_step_matches_cpu_in_float64(dev, name):
    fn = _grads_fn(name)
    for counter in (bank_read_cuda, cc_cuda, nms_cuda):
        counter.reset_launches()
    card = fn(dev, torch.float64)
    cpu = fn(torch.device("cpu"), torch.float64)
    res = chip_smoke.compare_steps(card, cpu, chip_smoke.NOISE_FLOOR)
    assert res["loss_rel"] <= 1e-9, res
    assert res["leaf_rel"] <= 1e-6, res
    launched = {**bank_read_cuda.launches, **cc_cuda.launches,
                **nms_cuda.launches}
    assert not any(launched.values()), launched
