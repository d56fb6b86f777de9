"""The generated layout of K4, the fused step VJP (``csrc/step_vjp.cu`` on
``csrc/soft_step_lanes.cuh``), on the CPU.

K4 puts each env on a group of lanes of a warp, with its tape in a slot of
shared memory laid out by ``soft_step_lanes.cuh`` and scheduled by the
generated header (``cuda_build.lane_tables``). For the pendulum, garpez and
the humanoid at each count of lanes: the slot's rows do not overlap and fill
the size the header declares; a block's shared memory fits in an H100's
227 KB; every link is scheduled once, after its parent, and pulls its
children in descending order; every contact point has exactly one lane slot,
a group of slots one parent. No card, no compiler: these read the sources
and the generated header.
"""

from __future__ import annotations

import functools
import re

import pytest

from jaxsim_tpu_torch import BatchedEngine, JaxSimModel, models
from jaxsim_tpu_torch.ops import cuda_build, cuda_step_vjp

URDFS = dict(
    pendulum1=lambda: models.build_pendulum_urdf(1),
    garpez=models.build_garpez_urdf,
    humanoid23=models.build_humanoid_urdf,
)
LANES = (1, 2, 4, 8, 16, 32)
# The slot's rows in soft_step_lanes.cuh, (name, floats) in order: a link's,
# a contact parent's, the base's.
LINK_ROWS = (("WR", 9), ("WP", 3), ("IR", 9), ("IP", 3), ("V", 6), ("MA", 36), ("PA", 6), ("A", 6), ("T", 28))
PAR_ROWS = (("F", 6), ("WV", 6), ("GWR", 9), ("GWP", 3), ("GWV", 6))
BASE_ROWS = (("GA0", 6), ("BR0I", 9), ("BP0I", 3), ("GWR0", 9), ("GWP0", 3), ("BV", 6), ("BP", 3), ("BQ", 4))


@functools.lru_cache(maxsize=None)
def _engine(name: str) -> BatchedEngine:
    return BatchedEngine.build(JaxSimModel.build_from_model_description(URDFS[name]()), device="cpu")


@functools.lru_cache(maxsize=None)
def _constants() -> dict[str, int]:
    """The integer constants of soft_step_lanes.cuh's layout."""
    text = (cuda_build.CSRC / "soft_step_lanes.cuh").read_text()
    return {k: int(v) for k, v in re.findall(r"\b((?:LK|PR|BS|T)_\w+|LK|PR|BS) = (\d+)\b", text)}


def _header(name: str, lanes: int, params_grad: bool) -> tuple[dict[str, int], dict[str, list[int]]]:
    job = cuda_step_vjp.job(_engine(name), params_grad, lanes)
    header = cuda_build.topology_header(_engine(name), job.defines)
    defines = {k: int(v) for k, v in re.findall(r"^#define (\w+) (-?\d+)$", header, re.M)}
    arrays = {k: [int(x) for x in v.split(", ")] for k, v in re.findall(r"__constant__ int (\w+)\[\d+\] = \{([^}]*)\};", header)}
    return defines, arrays


@pytest.mark.parametrize("prefix, rows, size", [("LK", LINK_ROWS, "LK"), ("PR", PAR_ROWS, "PR"), ("BS", BASE_ROWS, "BS")])
def test_slot_rows_do_not_overlap(prefix, rows, size):
    """Each row group's rows start where the one before ends and fill the
    group's size, which cuda_build's slot size counts."""
    consts = _constants()
    offset = 0
    for name, width in rows:
        assert consts[f"{prefix}_{name}"] == offset, name
        offset += width
    assert consts[size] == offset
    assert offset == dict(LK=cuda_build.LN_LINK_FLOATS, PR=cuda_build.LN_PAR_FLOATS, BS=cuda_build.LN_BASE_FLOATS)[size]
    # T's pass-2 contribution: a symmetric 6x6's lower triangle, then 6.
    assert consts["T_PA"] == 21 and 21 + 6 <= dict(LINK_ROWS)["T"]


@pytest.mark.parametrize("params_grad", [False, True])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(URDFS))
def test_header_slot_fits_a_block(name, lanes, params_grad):
    """The header's slot is the layout's size for the model, and a block's
    slots (at the odd stride) and, with params_grad, its row of model-array
    cotangents fit in 227 KB; a block is at most one warp of whole envs."""
    eng = _engine(name)
    defines, arrays = _header(name, lanes, params_grad)
    n_par = len(set(eng.contact_parent))
    assert defines["JX_LN_LANES"] == lanes and defines["JX_PARAMS_GRAD"] == int(params_grad)
    assert defines["JX_LN_NPAR"] == n_par
    assert defines["JX_LN_SLOT"] == (
        cuda_build.LN_LINK_FLOATS * eng.n_links + cuda_build.LN_PAR_FLOATS * n_par + cuda_build.LN_BASE_FLOATS
    )
    tables = cuda_build.lane_tables(eng, lanes, params_grad)
    envs, stride = tables["envs"], tables["stride"]
    assert envs == defines["JX_LN_ENVS"] and envs * lanes <= 32 and envs & (envs - 1) == 0
    assert stride % 2 == 1 and stride in (envs, envs + 1)
    n_params = cuda_build.packed_params(eng).numel() if params_grad else 0
    assert tables["smem_bytes"] == 4 * (defines["JX_LN_SLOT"] * stride + n_params) <= cuda_build.MAX_SMEM_BYTES
    assert cuda_step_vjp.envs_per_block(eng, params_grad, lanes) == envs
    if name == "humanoid23" and lanes == cuda_step_vjp.LANES:
        assert envs == 8 and defines["JX_LN_NLEV"] == 7


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(URDFS))
def test_schedule_takes_each_link_once_after_its_parent(name, lanes):
    """Links 1..nL-1 each appear once in the level schedule, each on a
    later level than its parent (the root before all), and each link's
    children are listed in descending order; the parent rows map the
    contact parents."""
    eng = _engine(name)
    defines, arrays = _header(name, lanes, False)
    lev_off, lev_link = arrays["JX_LN_LEV_OFF"], arrays["JX_LN_LEV_LINK"]
    assert len(lev_off) == defines["JX_LN_NLEV"] + 1 and lev_off[0] == 0 and lev_off[-1] == eng.n_links - 1
    level = {i: lev for lev in range(defines["JX_LN_NLEV"]) for i in lev_link[lev_off[lev] : lev_off[lev + 1]]}
    assert sorted(lev_link[: lev_off[-1]]) == sorted(level) == list(range(1, eng.n_links))
    assert all(eng.lam[i] == 0 or level[eng.lam[i]] < level[i] for i in level)
    ch_off, ch = arrays["JX_LN_CH_OFF"], arrays["JX_LN_CH"]
    for i in range(eng.n_links):
        kids = ch[ch_off[i] : ch_off[i + 1]]
        assert kids == sorted((c for c in range(1, eng.n_links) if eng.lam[c] == i), reverse=True)
    rows = arrays["JX_LN_PAR_ROW"]
    parents = arrays["JX_LN_PAR_LINK"][: defines["JX_LN_NPAR"]]
    assert [rows[i] for i in parents] == list(range(len(parents)))
    assert all(rows[i] == -1 for i in range(eng.n_links) if i not in parents)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(URDFS))
def test_every_point_has_one_lane_slot(name, lanes):
    """The point slots hold each contact point once and padding (-1)
    otherwise; a group of ``lanes`` slots (one a lane) shares one parent,
    and a parent's groups are neighbours."""
    eng = _engine(name)
    defines, arrays = _header(name, lanes, False)
    own = defines["JX_LN_OWN"]
    slots = arrays["JX_LN_SLOT_POINT"][: lanes * own]
    assert sorted(c for c in slots if c >= 0) == list(range(eng.n_points))
    assert all(c == -1 for c in slots if c < 0)
    groups = arrays["JX_LN_GROUP_LINK"][:own]
    for k in range(own):
        points = [slots[g + lanes * k] for g in range(lanes)]
        assert {eng.contact_parent[c] for c in points if c >= 0} == {groups[k]}
        assert arrays["JX_LN_PAR_LINK"][arrays["JX_LN_GROUP_PAR"][k]] == groups[k]
    assert [p for n, p in enumerate(groups) if n == 0 or groups[n - 1] != p] == list(dict.fromkeys(groups))
