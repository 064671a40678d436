#!/usr/bin/env python3
"""How far one AFB-URR training step on the card is from the same step on
the CPU, and from the float64 step, over seeded clips.

Takes one step (trained weights, the training form, frozen BN, lr 1e-5,
TF32 off) on each clip: the wavy clips of ``chip_smoke.wavy_clip`` and the
scene clips of ``chip_smoke.training_clips``, 240 px, 3 frames, 2
objects; ``--clips`` of each, seeded 0, 1, ... (the scene clips from
``chip_smoke.SEED + 16``, the first being phase 15(b)'s). The step runs

- on the CPU in float32 and in float64 (the reference);
- on the card in float32 with cuDNN deterministic (as the trainer CLI
  runs it), without it, and with cuDNN off (PyTorch's own convolutions),
  and in float64.

For each clip it writes one JSON line (to stdout and to ``--out``) with,
for each pair, the loss and the gradients' global norm relative, and the
largest gap of a gradient leaf over that leaf's largest magnitude
(``chip_smoke.compare_steps``).

Run from the repository root on a GPU machine:

    python3 scripts/torch_train_card_cpu.py [--clips 4] [--out PATH]
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


def card_step(variables, frames, masks, dtype, deterministic=True,
              cudnn=True):
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.enabled = cudnn
    try:
        return cs.train_grads(variables, cs.DEV, frames, masks, dtype)
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.enabled = True


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--clips", type=int, default=4,
                        help="clips of each kind")
    parser.add_argument("--out", default=None,
                        help="also append the JSON lines to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_card_cpu: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    variables = load_flat_npz(default_checkpoint("video"))
    cpu = torch.device("cpu")
    clips = [(f"wavy{i}", lambda i=i: cs.wavy_clip(240, seed=i))
             for i in range(args.clips)]
    clips += [(f"scene{i}", lambda i=i: cs.training_clips(
        1, 3, 2, 240, cs.SEED + 16 + i)) for i in range(args.clips)]
    for name, make in clips:
        frames, masks = make()
        steps = {
            "cpu32": cs.train_grads(variables, cpu, frames, masks,
                                    torch.float32),
            "cpu64": cs.train_grads(variables, cpu, frames, masks,
                                    torch.float64),
            "card32": card_step(variables, frames, masks, torch.float32),
            "card32_nondet": card_step(variables, frames, masks,
                                       torch.float32, deterministic=False),
            "card32_nocudnn": card_step(variables, frames, masks,
                                        torch.float32, cudnn=False),
            "card64": card_step(variables, frames, masks, torch.float64),
        }
        pairs = [("card32", "cpu32"), ("card32_nondet", "cpu32"),
                 ("card32_nocudnn", "cpu32"), ("cpu32", "cpu64"),
                 ("card32", "cpu64"), ("card32_nondet", "cpu64"),
                 ("card32_nocudnn", "cpu64"), ("card64", "cpu64")]
        row = {"clip": name, "card": smi,
               **{f"{a}_vs_{b}": cs.compare_steps(steps[a], steps[b])
                  for a, b in pairs}}
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
