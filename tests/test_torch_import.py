"""The port imports without JAX, and its kernel modules without a GPU; its
entry points default to the CUDA card; its kernel libraries are rebuilt when
any file they include changes."""

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
        "from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step\n"
        "assert not torch.cuda.is_available()\n"
        "assert cuda_rollout.ROLLOUT_KERNEL_LAUNCHES == 0 and not cuda_build._BUILDS\n"
        "assert cuda_step.STEP_PD_KERNEL_LAUNCHES == cuda_step.STEP_TAU_KERNEL_LAUNCHES == 0\n"
        "assert cuda_env_rollout.ENV_ROLLOUT_KERNEL_LAUNCHES == 0\n",
        PATH=os.path.dirname(sys.executable),
        CUDA_VISIBLE_DEVICES="",
    )
    assert res.returncode == 0, res.stderr


def test_kernel_builds_from_the_checkout():
    """The wrappers find the CUDA sources in the package and build into the
    checkout's ``build/`` directory, which ``.gitignore`` lists."""
    from jaxsim_tpu_torch.ops import cuda_build, cuda_env_rollout, cuda_rollout, cuda_step

    assert cuda_rollout.SOURCE == REPO / "jaxsim_tpu_torch" / "csrc" / "rollout.cu"
    for module in (cuda_rollout, cuda_step, cuda_env_rollout):
        assert module.SOURCE.is_file()
        assert cuda_build.CSRC / "step_env.cuh" in cuda_build.included_files(module.SOURCE)
    assert cuda_build.BUILD_DIR == REPO / "build" / "jaxsim_tpu_torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in (REPO / "jaxsim_tpu_torch").rglob("*.py"))
)
def test_no_module_of_the_port_imports_jax(path):
    for line in (REPO / path).read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            assert words[1].split(".")[0] not in ("jax", "jaxsim_tpu"), line


def _pendulum_model():
    from jaxsim_tpu_torch import JaxSimModel, models

    return JaxSimModel.build_from_model_description(models.build_pendulum_urdf(1))


def test_engine_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no device named and no CUDA device, building raises and names the
    way to the CPU; naming the CPU builds there."""
    import numpy as np
    import torch

    from jaxsim_tpu_torch import BatchedEngine, bridge

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        BatchedEngine.build(_pendulum_model())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bridge.state_from_numpy({k: np.zeros((1, 2), np.float32) for k in bridge.STATE_FIELDS})
    eng = BatchedEngine.build(_pendulum_model(), device="cpu")
    assert eng.S.device.type == "cpu" and eng.init_state(2).p.device.type == "cpu"


def test_build_key_follows_every_included_file(tmp_path):
    """A library's cache key hashes the files its source includes: a changed
    step_env.cuh gives every kernel a new key, a file no kernel includes none."""
    import shutil

    from jaxsim_tpu_torch import BatchedEngine
    from jaxsim_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    header = cuda_build.topology_header(BatchedEngine.build(_pendulum_model(), device="cpu"))
    sources = ("rollout.cu", "step.cu", "env_rollout.cu")
    keys = [cuda_build.build_key(csrc / name, header) for name in sources]
    (csrc / "notes.txt").write_text("not included")
    assert [cuda_build.build_key(csrc / name, header) for name in sources] == keys
    with open(csrc / "step_env.cuh", "a") as f:
        f.write("// changed\n")
    new = [cuda_build.build_key(csrc / name, header) for name in sources]
    assert all(a != b for a, b in zip(keys, new))
    assert cuda_build.build_key(csrc / "step.cu", header + "#define X 1\n") != new[1]
