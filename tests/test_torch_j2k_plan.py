"""D1's and M1's launch plans (``ops/j2k.idwt_plan``, ``colour_launch``)
run on the CPU.

D1's kernel cannot run here, so this file runs its scheme: each of the
plan's launches lifts, for every tile of a level, the window of the tile
and the plan's halo, gathered from the four bands (the LL band from the
buffer the last level wrote, the rest from the host stage's planes), with
the twin's own ``_lift53`` / ``_lift97``, and keeps the tile; a plane
with no levels is copied a tile at a time. The result must be
``idwt_reference``'s planes bit for bit: on every small fixture (at the
default tiles and at small ones, so that cut edges, odd origins and lines
of one and two samples meet the halo) and on the two 768 x 1024 clip
frames' tile-components with coefficients from a numpy seed. Every output sample of every level
is written by exactly one tile, and the launch count is the one
``idwt_plan``'s docstring gives.
"""

import json
import os

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.io import j2k as K
from superviseddescent_tpu_torch.io import jp2 as J
from superviseddescent_tpu_torch.ops import j2k as O
from torch_apps_helpers import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "torch_j2k")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SMALL = sorted(n for n, e in MANIFEST["files"].items()
               if "pil_error" not in e and e["small"])
CLIP_97, CLIP_53 = "f01_clip_97_rpcl.jp2", "f02_clip_53_tiles.jp2"
SEED = 25
# the plan's tiles: the default, tiles of 8 x 4 and 16 x 8 (each of a small
# fixture's levels cut many times) and the largest
PLANS = {"default": O.IDWT_TILE, "tiled_8x4": (8, 4), "tiled_16x8": (16, 8),
         "tiled_64x64": O.IDWT_MAX_TILE}
_FRAMES = {}


def codestream(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return J.read_file(f.read()).codestream


def frame_of(name):
    """The Python host stage's frame of a fixture (once a process)."""
    if name not in _FRAMES:
        _FRAMES[name] = O.decode_python(codestream(name))
    return _FRAMES[name]


def tcs_of(data: bytes) -> np.ndarray:
    """The host stage's tile-component table from the markers alone (no
    tier-1): its rows as ``decode_python`` writes them."""
    cs = K.parse(data)
    rows, offset = [], 0
    for index in range(cs.tiles_across * cs.tiles_down):
        tile = cs.tiles[index]
        for c, tc in enumerate(K.tile_geometry(cs, tile)):
            row = [0] * O.TC_COLS
            row[:O.TC_RES] = [offset, tc.x1 - tc.x0, tc.y1 - tc.y0, tc.x0,
                              tc.y0, tile.comps[c].levels,
                              int(tile.comps[c].reversible), c]
            for r, res in enumerate(tc.resolutions):
                row[O.TC_RES + 4 * r:O.TC_RES + 4 * r + 4] = [
                    res.x0, res.y0, res.x1, res.y1]
            rows.append(row)
            offset += (tc.x1 - tc.x0) * (tc.y1 - tc.y0)
    return np.array(rows, np.int32)


def _lift(x: torch.Tensor, sn: int, cas: int, rev: int) -> torch.Tensor:
    """The twin's lifting of lines x (band layout, sn low samples first)."""
    if rev:
        return O._lift53(x, sn, cas)
    return O._lift97(x.view(torch.float32), sn, cas).view(torch.int32)


def _plane(buf: torch.Tensor, lv, rows: int) -> torch.Tensor:
    off, W = int(lv[O.LV_OFF]), int(lv[O.LV_STRIDE])
    return buf[off:off + W * rows].view(rows, W)


def _runs(lo: int, hi: int, cas: int, sn: int):
    """The band indices of interleaved positions [lo, hi): the low ones
    (a run of the low band), then the high ones (a run after sn)."""
    low = [(p - cas) // 2 for p in range(lo, hi) if (p - cas) % 2 == 0]
    high = [sn + (p - 1 + cas) // 2 for p in range(lo, hi)
            if (p - cas) % 2 != 0]
    return low, high


def _tile(bufs, lv, tile: int, written: np.ndarray):
    """One CTA of a launch: the tile's window from the four bands, lifted
    with the twin's functions, the tile kept; or, for a plane with no
    levels, the tile copied."""
    rw, rh = int(lv[O.LV_RW]), int(lv[O.LV_RH])
    snh, snv = int(lv[O.LV_SNH]), int(lv[O.LV_SNV])
    cash, casv = int(lv[O.LV_CASH]), int(lv[O.LV_CASV])
    tw, th, h = int(lv[O.LV_TW]), int(lv[O.LV_TH]), int(lv[O.LV_HALO])
    ty, tx = divmod(tile, int(lv[O.LV_TILES_X]))
    X0, Y0 = tx * tw, ty * th
    X1, Y1 = min(X0 + tw, rw), min(Y0 + th, rh)
    written[Y0:Y1, X0:X1] += 1
    if lv[O.LV_COPY]:
        _plane(bufs[int(lv[O.LV_DST])], lv, rh)[Y0:Y1, X0:X1] = \
            _plane(bufs[O.HOST], lv, rh)[Y0:Y1, X0:X1]
        return
    ca, cb = max(X0 - h, 0), min(X1 + h, rw)
    ra, rb = max(Y0 - h, 0), min(Y1 + h, rh)
    low_r, high_r = _runs(ra, rb, casv, snv)
    low_c, high_c = _runs(ca, cb, cash, snh)
    host = _plane(bufs[O.HOST], lv, rh)
    ll = _plane(bufs[int(lv[O.LV_SRC])], lv, max(snv, 1))
    window = torch.cat([
        torch.cat([ll[low_r][:, low_c], host[low_r][:, high_c]], 1),
        host[high_r][:, low_c + high_c]], 0)
    rev = int(lv[O.LV_REV])
    rows = _lift(window.contiguous(), len(low_c), (ca + cash) & 1, rev)
    done = _lift(rows.t().contiguous(), len(low_r), (ra + casv) & 1, rev).t()
    _plane(bufs[int(lv[O.LV_DST])], lv, rh)[Y0:Y1, X0:X1] = \
        done[Y0 - ra:Y1 - ra, X0 - ca:X1 - ca]


def emulate(coeffs: torch.Tensor, plan: O.IdwtPlan) -> torch.Tensor:
    """D1's launches of ``plan`` on the CPU: the output buffer. Asserts
    that each level's output samples (each plane's with no levels) are
    written once each."""
    bufs = {O.HOST: coeffs.clone(), O.OUT: torch.zeros_like(coeffs),
            O.SCRATCH: torch.zeros_like(coeffs)}
    levels = plan.levels
    written = {}
    for launch in plan.launches:
        cols = O.TILE_CTA_COLS
        rows = plan.table[launch.start:launch.start + launch.ctas * cols]
        for row in rows.reshape(-1, cols).tolist():
            lv = levels[row[0]]
            assert row[2:] == lv.tolist()
            counts = written.setdefault(row[0], np.zeros(
                (lv[O.LV_RH], lv[O.LV_RW]), np.int64))
            _tile(bufs, lv, row[1], counts)
    assert sorted(written) == [i for i, lv in enumerate(levels)
                               if lv[O.LV_RW] and lv[O.LV_RH]]
    for key, counts in written.items():
        assert (counts == 1).all(), f"level row {key}: {counts}"
    assert torch.equal(bufs[O.HOST], coeffs), "the host planes changed"
    return bufs[O.OUT]


def expected_launches(tcs: np.ndarray) -> int:
    """The docstring's count: one for each j where some tile-component's
    j-th level (or plane with no levels, j = 0) has samples."""
    used = set()
    for row in tcs:
        if row[O.TC_W] == 0 or row[O.TC_H] == 0:
            continue
        sizes = [rw * rh for rw, rh, *_ in O._levels_of(row)] or [1]
        used |= {j for j, size in enumerate(sizes) if size}
    return len(used)


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("name", SMALL)
def test_plan_finds_the_twins_planes_on_every_small_fixture(name, plan):
    frame = frame_of(name)
    p = O.idwt_plan(frame.tcs, PLANS[plan])
    assert len(p.launches) == expected_launches(frame.tcs)
    got = emulate(frame.coeffs, p)
    assert torch.equal(got, O.idwt_reference(frame.coeffs, frame.tcs))


def seeded(tcs: np.ndarray, seed: int) -> torch.Tensor:
    """Coefficients for ``tcs`` from a numpy seed: 5/3 planes integers of
    +-2^11, 9/7 planes float32 of scale 100 (their bits as int32)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int((tcs[:, O.TC_W].astype(np.int64)
                        * tcs[:, O.TC_H]).sum()), np.int32)
    for row in tcs:
        off, size = int(row[O.TC_OFFSET]), int(row[O.TC_W] * row[O.TC_H])
        if row[O.TC_REV]:
            out[off:off + size] = rng.integers(-2048, 2048, size)
        else:
            out[off:off + size] = (rng.standard_normal(size) * 100).astype(
                np.float32).view(np.int32)
    return torch.from_numpy(out)


@pytest.mark.parametrize("name, launches", [(CLIP_97, 5), (CLIP_53, 5)])
def test_plan_finds_the_twins_planes_on_the_clip_frames(name, launches):
    tcs = tcs_of(codestream(name))
    p = O.idwt_plan(tcs)
    assert len(p.launches) == expected_launches(tcs) == launches
    coeffs = seeded(tcs, SEED)
    assert torch.equal(emulate(coeffs, p), O.idwt_reference(coeffs, tcs))


def test_the_markers_alone_give_the_host_stages_tables():
    """``frame_of_markers`` (no tier-1) has the host stage's tables."""
    for name in ("k39_odd_tiles_97.j2k", "o24_subsampled_offset.j2k",
                 "k16_tiles_offset_97.jp2"):
        got, want = frame_of_markers(codestream(name)), frame_of(name)
        np.testing.assert_array_equal(got.tcs, want.tcs)
        np.testing.assert_array_equal(got.tiles, want.tiles)
        np.testing.assert_array_equal(got.comps, want.comps)
        assert got[:8] == want[:8]


def test_the_wide_fixture_needs_no_line_limit():
    """A level 16,400 samples wide takes tiles like any other."""
    name = next(n for n, e in MANIFEST["files"].items()
                if "pil_error" not in e and e["shape"][1] > 16384)
    tcs = tcs_of(codestream(name))
    p = O.idwt_plan(tcs)
    assert int(p.levels[:, O.LV_RW].max()) > 16384
    assert len(p.launches) == expected_launches(tcs)
    coeffs = seeded(tcs, SEED + 1)
    assert torch.equal(emulate(coeffs, p), O.idwt_reference(coeffs, tcs))


def frame_of_markers(data: bytes) -> O.J2kFrame:
    """The host stage's frame from the markers alone: its tables, no
    coefficients."""
    cs = K.parse(data)
    n = len(cs.comps)
    tiles = [[*K.tile_rect(cs, i), cs.tiles[i].mct, n * i]
             for i in range(cs.tiles_across * cs.tiles_down)]
    comps = [[c.prec, int(c.signed), c.dx, c.dy] for c in cs.comps]
    return O.J2kFrame(cs.x1 - cs.x0, cs.y1 - cs.y0, cs.x0, cs.y0, cs.tx0,
                      cs.ty0, cs.tdx, cs.tdy, np.array(comps, np.int32),
                      torch.zeros(0, dtype=torch.int32), tcs_of(data),
                      np.array(tiles, np.int32))


@pytest.mark.parametrize("name", SMALL + [CLIP_97, CLIP_53])
def test_colour_grid_covers_every_pixel_once(name):
    """M1's grid: every output pixel in exactly one CTA's band, inside the
    CTA's tile; the path is common exactly where every component a
    channel (or the component transform) reads is unsubsampled."""
    with open(os.path.join(FIXTURES, name), "rb") as fh:
        f = J.read_file(fh.read())
    frame = frame_of_markers(f.codestream)
    plan = O.colour_plan(f, frame)
    reads = max(O.WANTED[plan.kind], 3 if len(plan.comps) >= 3
                and frame.tiles[:, 4].any() else 0)
    assert plan.common == bool((plan.comps[:reads, 2:] == 1).all())
    for channels in (3, 1):
        table, ctas, shared = O.colour_launch(frame, plan, channels)
        rows = table[O.COLOUR_CTAS_AT:].reshape(-1, O.COLOUR_CTA_COLS)
        assert len(rows) == ctas and shared <= 48 * 1024
        cover = np.zeros((frame.height, frame.width), np.int64)
        for t, y, n, xs, xe, *tile in rows.tolist():
            tx0, ty0, tx1, ty1 = frame.tiles[t, :4]
            assert tile[:5] == [tx0, ty0, tx1 - tx0, ty1 - ty0,
                                frame.tiles[t, 4]]
            assert tx0 <= xs + frame.x0 and xe + frame.x0 <= tx1
            assert ty0 <= y + frame.y0 and y + n + frame.y0 <= ty1
            cover[y:y + n, xs:xe] += 1
        assert (cover == 1).all()


def test_the_paths_of_m1_are_both_taken():
    """The small fixtures reach both of M1's paths: subsampled chroma
    (o19-o24, e06) the general one, the rest the common one."""
    common = {n: O.colour_plan(J.read_file(open(os.path.join(
        FIXTURES, n), "rb").read()), frame_of_markers(codestream(n))).common
        for n in SMALL}
    assert not common["o19_ycc420.j2k"] and not common["e06_sycc.jp2"]
    assert common["k04_rgb_97_mct.jp2"] and common["k09_cmyk.jp2"]


def test_the_kernels_read_the_tables_the_plans_write():
    """csrc/j2k_pixels.cu's table layouts and limits are ops/j2k.py's."""
    import re
    from superviseddescent_tpu_torch.ops._build import CSRC
    src = (CSRC / "j2k_pixels.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert const("kLevelCols") == O.LEVEL_COLS
    assert re.search(r"kTileCtaCols = 2 \+ kLevelCols", src)
    assert O.TILE_CTA_COLS == 2 + O.LEVEL_COLS
    assert (const("kMaxTileW"), const("kMaxTileH")) == O.IDWT_MAX_TILE
    assert const("kMaxHalo") == O.IDWT_MAX_HALO >= max(O.IDWT_HALO.values())
    assert (const("kHost"), const("kOut"), const("kScratch")) == (
        O.HOST, O.OUT, O.SCRATCH)
    assert const("kTileRow") == O.COLOUR_TILE_COLS
    assert re.search(r"kColourCtaCols = 5 \+ kTileRow", src)
    assert O.COLOUR_CTA_COLS == 5 + O.COLOUR_TILE_COLS
    assert re.search(r"kColourCtasAt = 32 \+ 768 \+ 1024", src)
    assert O.COLOUR_CTAS_AT == 32 + 768 + 1024
