"""The port stands alone: ``vfloodnet_tpu_torch`` and ``chip_smoke.py``
import nothing of JAX or of the JAX package, import PIL, cv2, pandas and
matplotlib only inside functions, and the package imports where there is
no CUDA and no nvcc."""

import ast
import os
import subprocess
import sys
from glob import glob

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob(os.path.join(REPO, "vfloodnet_tpu_torch", "**", "*.py"),
                    recursive=True)) + [os.path.join(REPO, "chip_smoke.py")]
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "vfloodnet_tpu")
LAZY = ("PIL", "cv2", "pandas", "matplotlib")


def _imports(tree):
    """(top-level module name, node, inside a function) for every import;
    relative imports stay inside the package."""
    out = []

    def visit(node, in_func):
        for child in ast.iter_child_nodes(node):
            f = in_func or isinstance(child, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name.split(".")[0], child, f)
                           for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module.split(".")[0], child, f))
            visit(child, f)

    visit(tree, False)
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_and_lazy_image_libraries(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for name, node, in_func in _imports(tree):
        assert name not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"
        if name in LAZY:
            assert in_func, f"{path}:{node.lineno} imports {name} at top level"


def test_package_imports_without_cuda_or_nvcc():
    code = ("import sys, torch\n"
            "assert not torch.cuda.is_available()\n"
            "import vfloodnet_tpu_torch.pipelines, vfloodnet_tpu_torch.ops\n"
            "import vfloodnet_tpu_torch.pipelines.atlantis\n"
            "import vfloodnet_tpu_torch.utils.visualize\n"
            "import vfloodnet_tpu_torch.train.model_parallel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + LAZY!r}]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PATH="/usr/bin:/bin")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
