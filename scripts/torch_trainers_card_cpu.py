#!/usr/bin/env python3
"""How far one step of the image, detection and body-mesh trainers on the
card is from the same step on the CPU, and from the float64 step, over
seeded inputs.

Each trainer takes one step as ``chip_smoke.py`` phase 16 takes it (TF32
off, cuDNN deterministic): the image trainer from the bundled trained
LinkNet on a batch of 2 seeded 128-px stills (``chip_smoke.image_batch``
from ``chip_smoke.SEED + 22 + i``), the tiny people detector from its
seeded weights on people scene ``i`` at 96 px
(``chip_smoke.detection_grads``), and the seeded body-mesh regressor on
training sample ``(13, i)`` (``chip_smoke.bodymesh_grads``), for ``i`` in
0 .. ``--seeds`` - 1 (0 is phase 16's input). The step runs on the CPU
in float32 and in float64, and on the card in float32 and float64.

For each trainer and seed it writes one JSON line (to stdout and to
``--out``) with, for each pair, the loss and the gradients' global norm
relative, and the largest gap of a gradient leaf over its scale
(``chip_smoke.compare_steps``). Phase 16's float32 bounds
(``chip_smoke.TRAINER_F32_BOUNDS``) are twice the largest card-against-CPU
gaps read here.

Run from the repository root on a GPU machine:

    python3 scripts/torch_trainers_card_cpu.py [--seeds 8] [--out PATH]
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from vfloodnet_tpu_torch.core import load_flat_npz  # noqa: E402
from vfloodnet_tpu_torch.pipelines.loaders import (  # noqa: E402
    default_checkpoint)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--out", default=None,
                        help="also append the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_trainers_card_cpu: CUDA is not available",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    variables = load_flat_npz(default_checkpoint("image"))

    def image(i):
        images, masks = cs.image_batch(2, 128, cs.SEED + 22 + i)
        return lambda dev, dt: cs.image_grads(variables, dev, dt, images,
                                              masks)

    trainers = {
        "image": image,
        "detection": lambda i: lambda dev, dt: cs.detection_grads(dev, dt,
                                                                  i),
        "bodymesh": lambda i: lambda dev, dt: cs.bodymesh_grads(dev, dt, i),
    }
    cpu = torch.device("cpu")
    for name, make in trainers.items():
        for i in range(args.seeds):
            fn = make(i)
            steps = {"cpu32": fn(cpu, torch.float32),
                     "cpu64": fn(cpu, torch.float64),
                     "card32": fn(cs.DEV, torch.float32),
                     "card64": fn(cs.DEV, torch.float64)}
            row = {"trainer": name, "seed": i, "card": smi,
                   **{f"{a}_vs_{b}": cs.compare_steps(steps[a], steps[b],
                                                      cs.NOISE_FLOOR)
                      for a, b in (("card32", "cpu32"), ("cpu32", "cpu64"),
                                   ("card32", "cpu64"),
                                   ("card64", "cpu64"))}}
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")


if __name__ == "__main__":
    main()
