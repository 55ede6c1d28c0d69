"""The port stands alone: ``dynamo_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor any module of the ``dynamo_tpu`` package, and the
kernel modules import on a machine without nvcc or a GPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "dynamo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or name == "dynamo_tpu" or name.startswith("dynamo_tpu.")


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_rule_tells_the_packages_apart():
    assert _forbidden("dynamo_tpu") and _forbidden("dynamo_tpu.models.llama")
    assert _forbidden("jax.numpy")
    assert not _forbidden("dynamo_tpu_torch") and not _forbidden("dynamo_tpu_torch.ops")


def test_import_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import dynamo_tpu_torch, dynamo_tpu_torch.engine.engine, "
        "dynamo_tpu_torch.ops.qmatmul, dynamo_tpu_torch.ops.paged_attention, "
        "dynamo_tpu_torch.models.convert\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib') or m == 'dynamo_tpu' "
        "or m.startswith('dynamo_tpu.')]\n"
        "print(bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_kernel_modules_import_without_nvcc():
    """Nothing is built or loaded at import: with no nvcc on PATH the
    kernel modules import, and only building a kernel fails, loudly."""
    code = (
        "import dynamo_tpu_torch.ops.qmatmul, dynamo_tpu_torch.ops.paged_attention\n"
        "from dynamo_tpu_torch.ops import _build\n"
        "assert not _build._libs\n"
        "import shutil, os\n"
        "if shutil.which('nvcc') is None and not os.path.exists('/usr/local/cuda/bin/nvcc'):\n"
        "    try:\n"
        "        _build.library('qmm')\n"
        "    except RuntimeError as e:\n"
        "        assert 'nvcc not found' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('built without nvcc')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT), PATH="/usr/bin:/bin")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_wrappers_take_plain_path_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and launches nothing."""
    import torch

    from dynamo_tpu_torch.ops import paged_attention as pa
    from dynamo_tpu_torch.ops import qmatmul as qm

    before = (qm.qmm.launches, pa.paged_attention_decode_stacked.launches)
    x = torch.randn(3, 16, dtype=torch.bfloat16)
    w = torch.randint(-127, 128, (16, 32), dtype=torch.int8)
    s = torch.rand(32)
    assert qm.qmm(x, w, s).shape == (3, 32)
    q = torch.randn(2, 4, 16, dtype=torch.bfloat16)
    kc = torch.randn(1, 32, 2, 16).to(torch.bfloat16)
    out = pa.paged_attention_decode_stacked(
        q, kc, kc, 0, torch.tensor([[1, 2], [3, 0]], dtype=torch.int32),
        torch.tensor([10, 3], dtype=torch.int32), 8)
    assert out.shape == (2, 4, 16)
    assert (qm.qmm.launches, pa.paged_attention_decode_stacked.launches) == before
