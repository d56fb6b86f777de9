"""The port imports without JAX, and its kernel module without a GPU."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def _python(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env={**os.environ, **env},
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_import_leaves_jax_out():
    res = _python(
        "import sys, jaxsim_tpu_torch, jaxsim_tpu_torch.bridge\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxsim_tpu.')))\n"
        "assert 'jaxsim_tpu' not in sys.modules and not bad, bad\n"
    )
    assert res.returncode == 0, res.stderr


def test_kernel_module_imports_without_nvcc_or_cuda():
    """Importing builds nothing: nvcc runs only inside a launch on a CUDA state."""
    res = _python(
        "import torch\n"
        "from jaxsim_tpu_torch.ops import cuda_rollout\n"
        "assert not torch.cuda.is_available()\n"
        "assert cuda_rollout.ROLLOUT_KERNEL_LAUNCHES == 0 and not cuda_rollout._BUILDS\n",
        PATH=os.path.dirname(sys.executable),
        CUDA_VISIBLE_DEVICES="",
    )
    assert res.returncode == 0, res.stderr


def test_kernel_builds_from_the_checkout():
    """The wrapper finds the CUDA source in the package and builds into the
    checkout's ``build/`` directory, which ``.gitignore`` lists."""
    from jaxsim_tpu_torch.ops import cuda_rollout

    assert cuda_rollout.SOURCE == REPO / "jaxsim_tpu_torch" / "csrc" / "rollout.cu"
    assert cuda_rollout.SOURCE.is_file()
    assert cuda_rollout.BUILD_DIR == REPO / "build" / "jaxsim_tpu_torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in (REPO / "jaxsim_tpu_torch").rglob("*.py"))
)
def test_no_module_of_the_port_imports_jax(path):
    for line in (REPO / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in ("jax", "jaxsim_tpu"), line
