"""FMA-rate probes on the card's CUDA cores (K6, K7).

Counterparts of two TPU kernels that compute the same chains on the vector
unit: ``bench.py``'s ``fma_kernel`` (K6, the measured float32 FMA peak that
divides its utilisation readout) and ``scripts/bf16_probe.py``'s ``kern``
(K7, the float32, bf16, and bf16-storage/float32-math rates). The kernels are
``jaxsim_tpu_torch/csrc/fma_probe.cu``; see the note at its top.

Each thread runs ``chains`` independent chains ``a ← a·k + e`` from
``a = x·0.5^i`` for ``T`` iterations (``T`` a multiple of :data:`UNROLL`) and
writes their sum. A rate is ``2·elements·chains·(T_LONG − T_SHORT)`` over the
difference of the two launches' device times, as ``bench.py`` takes it, at the
best of a sweep over chains per thread and blocks per SM.

:func:`bf16_probe` (K7, one of :data:`VARIANTS`) launches the kernel for a
CUDA tensor and runs the plain version, :func:`probe_reference`, for a CPU
tensor. K6's chain is K7's float32 chain, so :func:`fma_probe` (K6) is
``bf16_probe("f32", ...)`` and counts each launch as K6's too: one sweep
measures both. Run on a machine with a card, ``python -m
jaxsim_tpu_torch.ops.fma_probe`` prints K6's peak (K7's float32 rate) and
K7's bf16 rates, each with its share of the data-sheet peak.

The rates are taken at the TPU probes' ``k`` and ``e``, at which a bf16
chain is a fixed point (``k`` rounds to 1 and ``e`` lies below half an ulp
of every chain value), so an output there holds nothing of the trip count.
A kernel is held against its plain version at :data:`GATE_K` and
:data:`GATE_E` instead, where every chain moves at every iteration
(:func:`moves_every_trip`).
"""

from __future__ import annotations

import re
import statistics
import subprocess

import torch

from . import cuda_build
from .cuda_build import CSRC, F32, I32, PTR, BuildJob, KernelBuild

SOURCE = CSRC / "fma_probe.cu"
SIGNATURES = {"jx_fma_probe": [I32, I32, PTR, PTR, I32, I32, F32, F32, PTR]}
VARIANTS = ("f32", "bf16", "bf16_store")
# The chains' multiplier and increment, as the TPU probes have them: the
# timed sweep's.
K, E = 0.9999991, 1.1e-7
# Those of a kernel-vs-plain comparison: k = 1 + 2^-7 moves a bf16 value by
# one or two ulp at every iteration, and both are exact in bf16.
GATE_K, GATE_E = 1.0 + 2.0**-7, 2.0**-9
UNROLL = 16  # iterations a trip of the kernel's timed loop
THREADS = 128  # a block
CHAINS = (1, 2, 4, 8)  # compiled instantiations
BLOCKS_PER_SM = (1, 2, 4, 8, 16)
# The long launch takes 2-5 ms at the best float32 configuration on an
# H100, so that the event timer's jitter stays a fraction of a percent (at
# the TPU probe's 65536 the same launch took 0.6 ms, and repeated sweeps
# read up to 101 % of the data sheet).
T_LONG, T_SHORT = 262144, 16
REPEATS = 3  # timed launches per T and configuration, after one warm-up
# Data-sheet peaks of the CUDA cores, NVIDIA H100 SXM at 700 W: float32 67
# TFLOP/s (NVIDIA H100 data sheet); bf16 outside the tensor cores 133.8
# TFLOP/s (NVIDIA H100 Tensor Core GPU Architecture whitepaper, H100 SXM5).
# bf16_store does its arithmetic in float32.
PEAK_FLOPS = dict(f32=67e12, bf16=133.8e12, bf16_store=67e12)

# Launches of the kernel by fma_probe() (K6) and by bf16_probe() (K7, per
# variant; fma_probe's launches are K7 float32 launches too), in this
# process.
FMA_PROBE_LAUNCHES = 0
BF16_PROBE_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def job() -> BuildJob:
    return BuildJob(None, SOURCE, SIGNATURES)


def build() -> KernelBuild:
    """Compile (or load from ``BUILD_DIR``) the probes' library."""
    return cuda_build.build(job())


def lanes(variant: str) -> int:
    """Elements a chain holds: a bf16 pair for ``bf16``, else one."""
    return 2 if variant == "bf16" else 1


def dtype(variant: str) -> torch.dtype:
    return torch.float32 if variant == "f32" else torch.bfloat16


def make_input(variant: str, n_threads: int, device, seed: int = 0) -> torch.Tensor:
    """Seeded start values in [0.25, 0.75), one per thread (a pair for bf16)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (n_threads, 2) if lanes(variant) == 2 else (n_threads,)
    x = 0.25 + 0.5 * torch.rand(shape, generator=gen)
    return x.to(dtype(variant)).to(device)


def operations(variant: str, n_threads: int, chains: int, T: int) -> float:
    """Floating-point operations of a launch: an FMA is two."""
    return 2.0 * n_threads * lanes(variant) * chains * T


def probe_reference(
    variant: str, x: torch.Tensor, T: int, chains: int, k: float = K, e: float = E, fused: bool = True
) -> torch.Tensor:
    """The plain version. An FMA rounds once; here each step is computed in
    float64, where the product of two float32 or bf16 values is exact, and
    rounded to the chain's type (for ``bf16_store`` through float32, as the
    kernel rounds). It can differ from the kernel's single rounding only at a
    tie after the float64 rounding, by one unit in the last place.
    ``fused=False`` rounds a ``bf16`` product to bf16 before ``e`` is added,
    as XLA on the CPU evaluates a bf16 ``a*k + e``."""
    # k and e as the kernel takes them: float32, and for bf16 rounded again.
    k, e = (torch.tensor(v, dtype=torch.float32) for v in (k, e))
    if variant == "bf16":
        k, e = k.to(torch.bfloat16), e.to(torch.bfloat16)
    k, e = float(k), float(e)
    a = torch.stack([x * 0.5**i for i in range(chains)])
    for _ in range(T):
        product = a.double() * k if fused or variant != "bf16" else (a.double() * k).to(x.dtype).double()
        y = product + e
        a = (y if variant == "bf16" else y.float()).to(x.dtype)
    out = a[0]
    for i in range(1, chains):
        out = (out.float() + a[i].float()).to(x.dtype)
    return out


def _launch(variant: str, x: torch.Tensor, T: int, chains: int, k: float, e: float) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains}")
    if T <= 0 or T % UNROLL:
        raise ValueError(f"T must be a positive multiple of {UNROLL}, got {T}")
    n = x.shape[0]
    if n % THREADS:
        raise ValueError(f"the threads (x.shape[0] = {n}) must fill blocks of {THREADS}")
    shape = (n, 2) if lanes(variant) == 2 else (n,)
    cuda_build.check_tensor("x", x, shape, x.device, dtype(variant))
    out = torch.empty_like(x)
    cuda_build.launch(
        build(), "jx_fma_probe", None, x.device,
        VARIANTS.index(variant), chains, x.data_ptr(), out.data_ptr(), n // THREADS, T // UNROLL, k, e,
    )  # fmt: skip
    return out


def bf16_probe(variant: str, x: torch.Tensor, T: int, chains: int, k: float = K, e: float = E) -> torch.Tensor:
    """K7: the chains of ``variant``, one launch for a CUDA ``x``, the plain
    version for a CPU ``x``."""
    if x.device.type == "cpu":
        return probe_reference(variant, x, T, chains, k, e)
    out = _launch(variant, x, T, chains, k, e)
    BF16_PROBE_LAUNCHES[variant] += 1
    return out


def fma_probe(x: torch.Tensor, T: int, chains: int, k: float = K, e: float = E) -> torch.Tensor:
    """K6: the float32 chains (one thread an element), which are K7's:
    ``bf16_probe("f32", ...)``, its launch counted as K6's as well."""
    global FMA_PROBE_LAUNCHES
    out = bf16_probe("f32", x, T, chains, k, e)
    if x.device.type != "cpu":
        FMA_PROBE_LAUNCHES += 1
    return out


def moves_every_trip(variant: str, x: torch.Tensor, T: int, chains: int, k: float = GATE_K, e: float = GATE_E) -> bool:
    """Whether the plain output at ``T`` differs from the one at
    ``T - UNROLL`` in every element, so that a comparison at these inputs
    refuses a kernel that runs one trip of its loop fewer."""
    return bool((probe_reference(variant, x, T, chains, k, e) != probe_reference(variant, x, T - UNROLL, chains, k, e)).all())


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Units in the last place between same-typed float32 or bf16 tensors of
    positive values (the chains' outputs): the distance of their bit
    patterns read as integers."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return (a.view(view).to(torch.int64) - b.view(view).to(torch.int64)).abs()


def _device_ms(fn, repeats: int) -> float:
    """Median CUDA-event milliseconds of ``repeats`` calls, after a warm-up."""
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def measure(variant: str, device) -> dict:
    """The rate of ``variant`` at each configuration of the sweep (chains per
    thread × blocks per SM), from the launches at ``T_LONG`` and ``T_SHORT``;
    returns the best with the sweep. The float32 chains launch through
    :func:`fma_probe`, so that they count as K6's and K7's."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    run = fma_probe if variant == "f32" else (lambda x, T, ch: bf16_probe(variant, x, T, ch))
    sweep = []
    for chains in CHAINS:
        for bps in BLOCKS_PER_SM:
            n = sms * bps * THREADS
            x = make_input(variant, n, device)
            t_long = _device_ms(lambda: run(x, T_LONG, chains), REPEATS)
            t_short = _device_ms(lambda: run(x, T_SHORT, chains), REPEATS)
            rate = operations(variant, n, chains, T_LONG - T_SHORT) / ((t_long - t_short) * 1e-3)
            sweep.append(dict(chains=chains, blocks_per_sm=bps, n_threads=n, ms=t_long, ms_short=t_short, rate=rate))
    best = max(sweep, key=lambda r: r["rate"])
    return dict(best, variant=variant, sweep=sweep)


def sweep_launches() -> int:
    """Kernel launches of one :func:`measure`."""
    return len(CHAINS) * len(BLOCKS_PER_SM) * 2 * (1 + REPEATS)


def sass_loop_fmas(kernel: KernelBuild) -> dict[tuple[str, int], dict]:
    """For each (variant, chains) kernel of the library, the FFMA (HFMA2 for
    bf16) instructions in its SASS (``cuobjdump -sass``): in all, and in the
    timed loop, the instructions from the target of the last backward
    branch to that branch."""
    cmd = [cuda_build.cuda_tool("cuobjdump"), "-sass", str(kernel.path)]
    return parse_sass(subprocess.run(cmd, capture_output=True, text=True, check=True).stdout)


def parse_sass(sass: str) -> dict[tuple[str, int], dict]:
    """:func:`sass_loop_fmas` on the text of ``cuobjdump -sass``."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"fma_(f32|bf16|bf16_store)_kernelILi(\d+)E", block.splitlines()[0])
        if not m:
            continue
        code = [(int(a, 16), ins) for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        loop = []
        for addr, ins in code:
            b = re.search(r"\bBRA\s+0x([0-9a-f]+)", ins)
            if b and int(b.group(1), 16) < addr:
                loop = [i for a, i in code if int(b.group(1), 16) <= a <= addr]
        op = "HFMA2" if m.group(1) == "bf16" else "FFMA"
        count = lambda instructions: sum(1 for i in instructions if re.search(rf"\b{op}\b", i))  # noqa: E731
        out[(m.group(1), int(m.group(2)))] = dict(op=op, total=count(i for _, i in code), in_loop=count(loop))
    return out


def check_sass(kernel: KernelBuild) -> dict[tuple[str, int], dict]:
    """Raises unless every probe kernel's timed loop holds UNROLL·chains FMA
    instructions of its type: none folded away, none duplicated."""
    found = sass_loop_fmas(kernel)
    bad = {
        key: got for key, got in found.items() if got["in_loop"] != UNROLL * key[1]
    }
    missing = {(v, ch) for v in VARIANTS for ch in CHAINS} - set(found)
    if bad or missing:
        raise RuntimeError(f"probe SASS off: expected {UNROLL}·chains FMAs in each timed loop; got {bad}, missing {missing}")
    return found


def main() -> int:
    """Print K6's float32 peak (K7's float32 rate) and K7's bf16 rates on the
    current card."""
    if not torch.cuda.is_available():
        print("fma_probe: no CUDA device is visible")
        return 1
    device = torch.device("cuda")
    rows = [(f"K7 bf16_probe {v}" if v != "f32" else "K6 fma_probe = K7 f32", measure(v, device)) for v in VARIANTS]
    for name, r in rows:
        print(
            f"{name:>26}: {r['rate'] / 1e12:8.3f} TFLOP/s, {100 * r['rate'] / PEAK_FLOPS[r['variant']]:6.2f} % of "
            f"{PEAK_FLOPS[r['variant']] / 1e12:g} (chains {r['chains']}, blocks/SM {r['blocks_per_sm']}, "
            f"T={T_LONG} {r['ms']:.4f} ms)"
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
