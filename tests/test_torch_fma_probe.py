"""The FMA-rate probes (K6, K7), ``jaxsim_tpu_torch.ops.fma_probe``.

On the CPU the plain version is held against the JAX package's probe kernel
(``scripts/bf16_probe.py``'s ``build``, whose float32 chain is also
``bench.py``'s ``fma_kernel``) run by the Pallas interpreter at T = 64, in
units in the last place, at the probe's own ``k`` and ``e`` and at the
gate's (``fma_probe.GATE_K``, ``GATE_E``), the only ones at which a bf16
chain moves; and the SASS reader that checks the kernels' timed loops is
held on a written excerpt. Tests marked ``gpu`` compare the CUDA kernels
with the plain version on the card at the gate's ``k`` and ``e`` and check
their SASS; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_fma_probe.py
"""

from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from jaxsim_tpu_torch.ops import fma_probe

REPO = pathlib.Path(__file__).resolve().parents[1]
T = 64
# The plain version rounds each fused step in float64 first, the kernels
# (and XLA's fused multiply-add) once: the two can differ only where the
# float64 result lies on a rounding tie of the chain's type, by one unit in
# the last place.
ULPS = 1


def _bf16_probe_script(constants: str):
    """``scripts/bf16_probe.py`` as a module, with the JAX options it sets
    on import put back. For ``constants == "gate"`` its ``build`` is
    recompiled from its own source with the chains' ``k`` and ``e`` written
    as the gate's."""
    import inspect

    import jax

    saved = {k: getattr(jax.config, k) for k in ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location("bf16_probe", REPO / "scripts" / "bf16_probe.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    if constants == "gate":
        src = inspect.getsource(module.build)
        for literal, value in (("0.9999991", fma_probe.K), ("1.1e-7", fma_probe.E)):
            assert src.count(literal) == 2 and float(literal) == value
        src = src.replace("0.9999991", repr(fma_probe.GATE_K)).replace("1.1e-7", repr(fma_probe.GATE_E))
        exec(compile(src, module.__file__, "exec"), module.__dict__)
    return module


class _Unsummed:
    """``jax.numpy`` with ``sum`` the identity, so that the probe script's
    ``build`` returns its kernel's output instead of the output's sum."""

    def __getattr__(self, name):
        import jax.numpy as jnp

        return getattr(jnp, name)

    @staticmethod
    def sum(a):
        return a


@pytest.mark.parametrize("constants", ["probe", "gate"])
@pytest.mark.parametrize("variant", fma_probe.VARIANTS)
def test_plain_probe_matches_pallas_probe_in_interpret_mode(variant, constants, monkeypatch):
    """The JAX probe's (32, 128) tile of start values in [0.25, 0.75), its
    six chains, T = 64: every one of its 128 grid programs' outputs against
    the plain version, each thread's chains a tile element's. XLA runs with
    its optimizations here, so that ``a·k + e`` is one fused multiply-add as
    on the chips (the test suite's default turns most of them off, and then
    each step rounds twice); a bf16 product XLA rounds to bf16 all the same
    before it adds ``e`` (``fused=False``), where the CUDA kernel's HFMA2
    rounds once. At the probe's own constants a bf16 chain does not move;
    at the gate's every output moves with each trip of 16 iterations, so
    there the comparison holds the trip count too."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    k, e = (fma_probe.K, fma_probe.E) if constants == "probe" else (fma_probe.GATE_K, fma_probe.GATE_E)
    script = _bf16_probe_script(constants)
    monkeypatch.setattr(script, "jnp", _Unsummed())
    dtype, cast = {"f32": (jnp.float32, False), "bf16": (jnp.bfloat16, False), "bf16_store": (jnp.bfloat16, True)}[variant]
    x = (0.25 + 0.5 * np.random.default_rng(0).random((script.R, 128))).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    saved = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(script.build(dtype, cast, T_=T)(xj))  # (G, R, 128) float32
    finally:
        jax.config.update("jax_disable_most_optimizations", saved)
    assert ref.shape == (script.G, script.R, 128)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(fma_probe.dtype(variant)).reshape(-1)
    got = fma_probe.probe_reference(variant, xt, T, script.CH, k, e, fused=False)
    if constants == "gate":
        assert fma_probe.moves_every_trip(variant, xt, T, script.CH)
    elif variant != "f32":
        assert torch.equal(got, fma_probe.probe_reference(variant, xt, 0, script.CH, k, e))
    for program in ref:
        want = torch.tensor(program.reshape(-1)).to(fma_probe.dtype(variant))
        assert int(fma_probe.ulp_distance(got, want).max()) <= ULPS


def test_plain_probe_on_the_cpu_counts_no_launch():
    """The wrappers run the plain version for a CPU tensor; a bf16 pair's
    lanes are independent chains."""
    before = (fma_probe.FMA_PROBE_LAUNCHES, dict(fma_probe.BF16_PROBE_LAUNCHES))
    x = fma_probe.make_input("bf16", 256, "cpu")
    got = fma_probe.bf16_probe("bf16", x, 32, 2)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    assert torch.equal(got[:, 1], fma_probe.probe_reference("bf16", x[:, 1].contiguous(), 32, 2))
    assert torch.equal(fma_probe.fma_probe(x.float()[:, 0].contiguous(), 32, 2),
                       fma_probe.probe_reference("f32", x.float()[:, 0].contiguous(), 32, 2))  # fmt: skip
    assert (fma_probe.FMA_PROBE_LAUNCHES, fma_probe.BF16_PROBE_LAUNCHES) == before


def test_ulp_distance():
    a = torch.tensor([1.0, 0.5, 0.25])
    b = torch.nextafter(a, torch.tensor(2.0))
    assert fma_probe.ulp_distance(a, b).tolist() == [1, 1, 1]
    h = torch.tensor([1.0, 0.5], dtype=torch.bfloat16)
    assert fma_probe.ulp_distance(h, h + torch.tensor([2**-7, 2**-8], dtype=torch.bfloat16)).tolist() == [1, 1]


# A cuobjdump -sass excerpt in the layout it prints for sm_90a: one f32
# kernel with two chains whose timed loop (0x0100-0x0140) holds four FFMA,
# and one FFMA outside it.
SASS = """
\t\tFunction : _ZN45_GLOBAL__N__3a765677_12_fma_probe_cu_7718145214fma_f32_kernelILi2EEEvPKfPfiff
\t.headerflags\t@"EF_CUDA_SM90"
        /*00c0*/              @!P0 BRA 0x150 ;                    /* 0x0000000000988947 */
        /*0100*/                   FFMA R2, R2, c[0x0][0x224], R3 ;  /* 0x0000890002027623 */
        /*0110*/                   FFMA R4, R4, c[0x0][0x224], R3 ;  /* 0x0000890004047623 */
        /*0120*/                   FFMA R2, R2, c[0x0][0x224], R3 ;  /* 0x0000890002027623 */
        /*0130*/                   FFMA R4, R4, c[0x0][0x224], R3 ;  /* 0x0000890004047623 */
        /*0140*/              @!P0 BRA 0x100 ;                    /* 0xfffffffc00748947 */
        /*0150*/                   FFMA R5, R2, 1, R4 ;             /* 0x0000000002057423 */
        /*0160*/                   BRA 0x160;                       /* 0xfffffffc00fc7947 */
"""


def test_sass_reader_counts_the_timed_loop():
    assert fma_probe.parse_sass(SASS) == {("f32", 2): dict(op="FFMA", total=5, in_loop=4)}


def test_operations_and_launch_sweep():
    assert fma_probe.operations("bf16", 128, 4, 16) == 2 * 128 * 2 * 4 * 16
    assert fma_probe.operations("f32", 128, 4, 16) == 2 * 128 * 4 * 16
    assert fma_probe.sweep_launches() == len(fma_probe.CHAINS) * len(fma_probe.BLOCKS_PER_SM) * 2 * (1 + fma_probe.REPEATS)


# ----- on the card -----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", fma_probe.VARIANTS)
def test_kernel_matches_plain(variant, cuda):
    """Every compiled chain count at 8 blocks an SM, T = 64, at the gate's
    k and e (where every output moves with each trip), within ULPS; K6 is
    the float32 kernel, counted as K6's and as K7's."""
    n = torch.cuda.get_device_properties(cuda).multi_processor_count * 8 * fma_probe.THREADS
    k, e = fma_probe.GATE_K, fma_probe.GATE_E
    for chains in fma_probe.CHAINS:
        x = fma_probe.make_input(variant, n, cuda, seed=chains)
        assert fma_probe.moves_every_trip(variant, x, T, chains)
        before = fma_probe.BF16_PROBE_LAUNCHES[variant]
        kern = fma_probe.bf16_probe(variant, x, T, chains, k, e)
        torch.cuda.synchronize()
        assert fma_probe.BF16_PROBE_LAUNCHES[variant] == before + 1
        assert int(fma_probe.ulp_distance(kern, fma_probe.probe_reference(variant, x, T, chains, k, e)).max()) <= ULPS
        if variant == "f32":
            before = (fma_probe.FMA_PROBE_LAUNCHES, fma_probe.BF16_PROBE_LAUNCHES["f32"])
            assert torch.equal(fma_probe.fma_probe(x, T, chains, k, e), kern)
            assert (fma_probe.FMA_PROBE_LAUNCHES, fma_probe.BF16_PROBE_LAUNCHES["f32"]) == (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_kernel_sass_holds_every_fma(cuda):
    found = fma_probe.check_sass(fma_probe.build())
    assert set(found) == {(v, ch) for v in fma_probe.VARIANTS for ch in fma_probe.CHAINS}


@pytest.mark.gpu
def test_kernel_refuses_bad_arguments(cuda):
    x = fma_probe.make_input("f32", fma_probe.THREADS, cuda)
    for T_, chains in ((T + 1, 1), (T, 3)):
        with pytest.raises(ValueError):
            fma_probe.fma_probe(x, T_, chains)
    with pytest.raises(ValueError, match="float32"):
        fma_probe.bf16_probe("f32", x.to(torch.bfloat16), T, 1)
