#!/usr/bin/env python3
"""Peak TF32 tensor-core rates of mma.sync and wgmma on the card.

Builds ``scripts/tf32_mma_rates.cu`` with ``nvcc`` (sm_90a) into
``vfloodnet_tpu_torch/_build/`` and runs it. The bank read and count
kernels (``vfloodnet_tpu_torch/csrc/bank_read.cu``) use mma.sync; the gap
between the two rates is what a move to wgmma could win. Run from the
repository root on a GPU machine:

    python3 scripts/probe_tf32_rates.py

Prints one JSON line with the card's name and power limit.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vfloodnet_tpu_torch.ops import bank_read_cuda  # noqa: E402


def main():
    src = os.path.join(ROOT, "scripts", "tf32_mma_rates.cu")
    os.makedirs(bank_read_cuda.BUILD_DIR, exist_ok=True)
    exe = os.path.join(bank_read_cuda.BUILD_DIR, "tf32_mma_rates")
    subprocess.run([bank_read_cuda._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src],
                   check=True, timeout=600)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rates = json.loads(subprocess.run([exe], capture_output=True, text=True,
                                      timeout=600, check=True).stdout)
    print(json.dumps({"card": card, **rates}), flush=True)


if __name__ == "__main__":
    main()
