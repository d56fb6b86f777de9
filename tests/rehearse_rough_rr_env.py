"""One env of the rough relaxed-rigid rows case through K1-rr's body built
with ``float`` as ``double`` (g++, the harness of ``test_torch_rr_step.py``),
step by step against the float64 twin.

``chip_probe.py rough_rr_parting`` saves, for the env where K1-rr parts
furthest from the float64 twin, its start state, its multipliers and terrain
offset, and the card's float64 twin's and K1-rr's states after each step, to
``build/rough_rr_parting.npz``. This script, on the CPU, runs the
double body from that start for 1, 2, ... ``steps`` steps (each a launch from
the start) and prints, per step and field, the largest |Δ| against this
machine's float64 twin of: the double body, the card's float64 twin, and the
card's K1-rr (m over max(1, max |m|) of the env's float64 state):

    JAX_PLATFORMS=cpu python -m tests.rehearse_rough_rr_env build/rough_rr_parting.npz 10
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

import numpy as np
import torch

import chip_smoke
from jaxsim_tpu_torch import BatchedState, bridge
from jaxsim_tpu_torch.ops import cuda_build, cuda_rollout
from tests.test_torch_rr_step import ENVS, GAINS, _build, _fields, _run, _with_envs

DOMAIN_NAMES = ("Kmul", "Dmul", "mumul", "gmul", "Mmul")  # the rows' order in the kernel's DomainRows


def main(path: str, steps: int) -> None:
    saved = np.load(path)
    eng = chip_smoke.rr_humanoid_engine("cpu", terrain=chip_smoke.rough_terrain()).double()
    start = BatchedState(*(torch.from_numpy(np.asarray(saved[f"start_{k}"], np.float64)[..., None].copy())
                           for k in bridge.STATE_FIELDS))  # fmt: skip
    dom = {k: torch.tensor([float(saved[f"dom_{k}"])], dtype=torch.float64) for k in DOMAIN_NAMES}
    off = torch.from_numpy(np.asarray(saved["terr_off"], np.float64)[:, None].copy())
    print(f"env {int(saved['env'])}: rows {rows_text(dom)}, terrOff {off.ravel().tolist()}", flush=True)
    kp, kd = GAINS["humanoid23"]
    rows = (torch.stack([dom[k] for k in DOMAIN_NAMES]), off)
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = pathlib.Path(tmp)
        job = _with_envs(cuda_rollout.job(eng, domain=True, terr_off=True), ENVS)
        binary = _build(tmp_path, eng, job, 1, double=True)
        twin = start
        for n in range(1, steps + 1):
            flat = _run(tmp_path, binary, eng, start, n, cuda_build.packed_params(eng), (kp, kd), double=True, rows=rows)
            got, _ = _fields(flat, start)
            twin = cuda_rollout.rollout_reference(eng, twin, 1, kp, kd, domain=dom, terr_off=off)
            scale = max(1.0, float(np.abs(saved[f"f64_{n}_m"]).max()))
            row = {}
            for k, want in zip(bridge.STATE_FIELDS, twin.fields()):
                want = want.numpy()
                s = scale if k == "m" else 1.0
                row[k] = [float(np.abs(x - want).max()) / s for x in (got[k], saved[f"f64_{n}_{k}"][..., None],
                                                                     saved[f"kernel_{n}_{k}"][..., None])]  # fmt: skip
            print(f"step {n}: |Δ| against this machine's float64 twin of the double body, the card's float64 twin,"
                  f" the card's K1-rr: " + ", ".join(f"{k} {a:.3g} {b:.3g} {c:.3g}" for k, (a, b, c) in row.items()),
                  flush=True)  # fmt: skip


def rows_text(dom: dict) -> str:
    return ", ".join(f"{k} {float(v):.6g}" for k, v in dom.items())


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
