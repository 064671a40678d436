"""The port's multi-stream engine in the bf16 configuration on the CPU,
against the JAX package's bf16 ``BatchVideoSegEngine`` with the same
PRNGKey(0) weights (float32 masters, cast by each engine).

bf16 labels move with the order in which the two frameworks round (see
tests/test_torch_bf16_engine.py), so the port's bf16 labels are held to
the JAX bf16 engine's at least as closely as the JAX bf16 engine keeps to
its own float32 engine on the same streams, less 0.01: the JAX bf16 gap.
The bank stays bf16 (keys and values) with float32 bookkeeping.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vfloodnet_tpu.memory import FeatureBank as JFeatureBank
from vfloodnet_tpu.models import AFBURR as JAFBURR
from vfloodnet_tpu.pipelines.video_seg_batch import \
    BatchVideoSegEngine as JBatchEngine
from vfloodnet_tpu_torch.core import convert_afb_urr_variables
from vfloodnet_tpu_torch.memory import FeatureBank
from vfloodnet_tpu_torch.models import AFBURR
from vfloodnet_tpu_torch.pipelines import BatchVideoSegEngine

torch.set_num_threads(4)
HW, B, STEPS, BUDGET = (48, 64), 2, 3, 1024
BF = torch.bfloat16


def _run(engine, vids, masks):
    state = engine.bootstrap([v[0] for v in vids], masks)
    labels = []
    for i in range(STEPS):
        state, lab = engine.step(state, np.stack([v[i + 1] for v in vids]),
                                 i + 1)
        labels.append(engine.fetch_labels(lab))
    return state, np.stack(labels)


def test_bf16_batch_engine_within_the_jax_bf16_gap():
    j32 = JAFBURR(read_chunk=128)
    variables = jax.jit(lambda key: j32.init(
        key, jnp.zeros(HW + (3,)), jnp.zeros((2,) + HW),
        method=j32.init_all))(jax.random.PRNGKey(0))
    j16 = JAFBURR(read_chunk=128, dtype=jnp.bfloat16)
    port = AFBURR(dtype=BF).eval()
    port.load_state_dict(convert_afb_urr_variables(variables))

    rng = np.random.RandomState(3)
    vids = [[rng.rand(*HW, 3).astype(np.float32) for _ in range(STEPS + 1)]
            for _ in range(B)]
    masks = []
    for v in range(B):
        m = np.zeros(HW, np.uint8)
        m[20 + 4 * v:, :] = 1
        masks.append(m)

    _, want32 = _run(JBatchEngine(j32, variables, JFeatureBank(
        obj_n=2, memory_budget=BUDGET), batch=B, downsample=48,
        postprocess="none"), vids, masks)
    _, want16 = _run(JBatchEngine(j16, variables, JFeatureBank(
        obj_n=2, memory_budget=BUDGET, dtype=jnp.bfloat16), batch=B,
        downsample=48, postprocess="none"), vids, masks)
    state, got = _run(BatchVideoSegEngine(
        port, FeatureBank(obj_n=2, memory_budget=BUDGET, dtype=BF,
                          device="cpu"),
        batch=B, downsample=48, postprocess="none"), vids, masks)

    assert state.keys.dtype == BF and state.values.dtype == BF
    assert state.usage.dtype == torch.float32
    assert state.keys.shape[0] == B * 2
    gap = (want16 == want32).mean()
    agreement = (got == want16).mean()
    assert agreement >= gap - 0.01, (agreement, gap)
