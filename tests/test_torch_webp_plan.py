"""W1 and W2's launch plan (``ops/webp.vp8_launch_plan``) and the order of
their work, on the CPU.

The kernels (``csrc/vp8_pixels.cu``) put a macroblock row on a warp (W1:
on a pair of warps): row r on CTA (r / rows) % ctas as its row r % rows,
which takes its rows in order, each macroblock (r, c) waiting until row
r - 1 has done c + 2 macroblocks (W1: c + 1, and c + 2 for a B_PRED
macroblock's top-right). Here the plan is held to sm_90's limits of
threads and CTAs (shared memory is the launcher's to fit: a plan whose
CTAs do not fit fails its launch), every row is assigned once, and an event simulation of that schedule (one step a
macroblock) ends without a deadlock in ``wavefront_steps`` steps: mb_w +
2 (mb_h - 1) whenever the plan keeps mb_w / 2 rows in flight (mb_h in a
frame one macroblock wide). It runs at every lossy fixture's size, at 1 x
1 macroblock and at rows in flight forced to 1, 2 and 5 (W1's waits with
each fixture's own modes); at 16383 x 16383 pixels only the plan's limits
and the closed form. Last, W1 runs a B_PRED macroblock's sixteen 4x4
blocks in their own wavefront (block (i, j) at step j + 2 i): the twin in
that order gives the planes of the twin in raster order on every fixture.

    python -m pytest tests/test_torch_webp_plan.py -q
"""

import json
import os

import pytest
import torch

from superviseddescent_tpu_torch.io.vp8 import decode_vp8, frame_size
from superviseddescent_tpu_torch.io.webp import _chunks
from superviseddescent_tpu_torch.ops import webp as W
from torch_apps_helpers import one_torch_thread  # noqa: F401 (fixture)
from torch_imageio_fixtures import OUT as FIXTURES

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    NAMES = json.load(_f)["groups"]["webp_lossy"]
FORCED_ROWS = (1, 2, 5)
# W1's 4x4 blocks, block (i, j) at step j + 2 i
WAVEFRONT_ORDER = tuple(sorted(range(16), key=lambda n: n % 4 + 2 * (n // 4)))
MAX_THREADS = 1024              # sm_90: a CTA's threads
SM90_SMS = 132


def vp8_payload(name: str) -> bytes:
    """A fixture's (first) ``VP8 `` chunk, alone, after VP8X or in an
    animation's first frame."""
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()

    def find(buf, lo, hi):
        for chunk, body, _ in _chunks(buf, lo, hi):
            if chunk == b"VP8 ":
                return body
            if chunk == b"ANMF":
                return find(body, 16, len(body))
        return None
    return find(data, 12, len(data))


def macroblocks(name: str):
    width, height, _ = frame_size(vp8_payload(name))
    return (width + 15) // 16, (height + 15) // 16


SIZES = sorted({macroblocks(n) for n in NAMES} | {(1, 1)})


def wavefront_steps(mb_w: int, mb_h: int, rows_in_flight: int) -> int:
    """The closed form of ``simulate``'s steps: row r starts at 2 r (r in a
    frame one macroblock wide) plus, each time its warp takes over a row,
    what a row longer than twice the rows in flight adds."""
    lead = min(2, mb_w)
    lag = max(0, mb_w - lead * rows_in_flight)
    return mb_w + lead * (mb_h - 1) + (mb_h - 1) // rows_in_flight * lag


def simulate(mb_w: int, mb_h: int, plan: W.Vp8Plan, lead=None):
    """Steps of the kernels' schedule under ``plan``, a macroblock a step:
    each of a CTA's rows takes its macroblock rows in order (the kernels'
    loop, r = cta rows + row, then + rows ctas), a row's macroblocks in
    order, macroblock (r, c) once row r - 1 has done min(c + lead(r, c),
    mb_w) (lead 2: W2, and W1 at its longest). None on a deadlock."""
    K, G = plan.rows, plan.ctas
    queues = [list(range(b * K + w, mb_h, K * G))
              for b in range(G) for w in range(K)]
    done, at = [0] * mb_h, [0] * len(queues)
    steps, left = 0, mb_w * mb_h
    while left:
        ready = []
        for q, rows in enumerate(queues):
            if at[q] < len(rows):
                r = rows[at[q]]
                c = done[r]
                ahead = 2 if lead is None else lead(r, c)
                if r == 0 or done[r - 1] >= min(c + ahead, mb_w):
                    ready.append(q)
        if not ready:
            return None
        for q in ready:
            r = queues[q][at[q]]
            done[r] += 1
            left -= 1
            at[q] += done[r] == mb_w
        steps += 1
    return steps


def check_limits(plan: W.Vp8Plan, rows: int):
    assert 1 <= plan.rows <= W.MAX_ROWS and 64 * plan.rows <= MAX_THREADS
    assert 1 <= plan.ctas <= SM90_SMS
    if rows:
        assert plan.rows_in_flight <= rows


@pytest.mark.parametrize("per_cta", sorted({1, 16, W.ROWS_PER_CTA}))
@pytest.mark.parametrize("rows", (0,) + FORCED_ROWS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plan_assigns_every_row_once_and_never_deadlocks(size, rows, per_cta,
                                                          monkeypatch):
    mb_w, mb_h = size
    monkeypatch.setattr(W, "ROWS_PER_CTA", per_cta)
    plan = W.vp8_launch_plan(mb_w, mb_h, rows, SM90_SMS)
    check_limits(plan, rows)
    K, G = plan.rows, plan.ctas
    owners = {}
    for b in range(G):
        for w in range(K):
            for r in range(b * K + w, mb_h, K * G):   # the kernels' loop
                assert r not in owners
                owners[r] = (b, w)
    assert sorted(owners) == list(range(mb_h))
    steps = simulate(mb_w, mb_h, plan)
    assert steps == wavefront_steps(mb_w, mb_h, plan.rows_in_flight)
    if 2 * plan.rows_in_flight >= mb_w:
        assert steps == mb_w + min(2, mb_w) * (mb_h - 1)
    if not rows:
        assert 2 * plan.rows_in_flight >= min(mb_w, 2 * mb_h)


def test_plan_of_the_clip_frame(monkeypatch):
    """768 x 1024: every row in flight on CTAs of ROWS_PER_CTA rows; 174
    steps; 24 rows in flight at 16 rows a CTA on two CTAs."""
    per_cta = W.ROWS_PER_CTA
    plan = W.vp8_launch_plan(48, 64)
    assert plan == (per_cta, 64 // per_cta)
    assert simulate(48, 64, plan) == 174 == wavefront_steps(48, 64, 64)
    monkeypatch.setattr(W, "ROWS_PER_CTA", 16)
    assert W.vp8_launch_plan(48, 64, 24) == (12, 2)


def test_plan_at_the_largest_frame(monkeypatch):
    """16383 x 16383 pixels (1024 x 1024 macroblocks): within sm_90's
    limits, mb_w / 2 rows in flight, the closed-form path."""
    for per_cta in (1, 8, W.ROWS_PER_CTA):
        monkeypatch.setattr(W, "ROWS_PER_CTA", per_cta)
        plan = W.vp8_launch_plan(1024, 1024, 0, SM90_SMS)
        check_limits(plan, 0)
        assert plan.rows_in_flight >= 512
        assert wavefront_steps(1024, 1024,
                                 plan.rows_in_flight) == 1024 + 2046
    for rows in FORCED_ROWS:
        plan = W.vp8_launch_plan(1024, 1024, rows, sms=SM90_SMS)
        check_limits(plan, rows)
        assert wavefront_steps(1024, 1024, rows) > 1024 + 2046


@pytest.mark.parametrize("size", [(7, 3), (9, 5), (12, 4)])
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_closed_form_when_rows_in_flight_fall_short(size, rows):
    """Fewer rows in flight than mb_w / 2: each row a warp takes over
    waits for the row it follows, the closed form still exact."""
    mb_w, mb_h = size
    plan = W.Vp8Plan(rows, 1)
    assert simulate(mb_w, mb_h, plan) == wavefront_steps(mb_w, mb_h, rows)


def test_plans_across_ctas_match_one_cta():
    """The same rows in flight on one CTA or several: the same steps."""
    for mb_w, mb_h in SIZES:
        one = W.Vp8Plan(4, 1)
        four = W.Vp8Plan(1, 4)
        assert simulate(mb_w, mb_h, one) == simulate(mb_w, mb_h, four)


@pytest.mark.parametrize("name", NAMES)
def test_w1_waits_by_mode_never_deadlock(name):
    """W1 waits for the macroblock above (c + 1) and, a B_PRED macroblock,
    for the one after it (c + 2, its top-right): with each fixture's own
    modes, at the plan's rows in flight and at the forced ones, no deadlock
    and no more steps than the c + 2 wavefront."""
    f = decode_vp8(vp8_payload(name))
    is4 = f.modes[:, 0].reshape(f.mb_h, f.mb_w) != 0
    for rows in (0,) + FORCED_ROWS:
        plan = W.vp8_launch_plan(f.mb_w, f.mb_h, rows, SM90_SMS)
        steps = simulate(f.mb_w, f.mb_h, plan,
                         lambda r, c: 2 if is4[r, c] else 1)
        assert steps is not None
        assert steps <= simulate(f.mb_w, f.mb_h, plan)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", NAMES)
def test_subblocks_in_wavefront_order_give_the_raster_planes(name,
                                                             monkeypatch):
    """The twin's B_PRED blocks at step j + 2 i (W1's order) give the
    planes of raster order (libwebp's)."""
    f = decode_vp8(vp8_payload(name))
    coeffs, modes = torch.from_numpy(f.coeffs), torch.from_numpy(f.modes)
    raster = W.reconstruct_reference(coeffs, modes, f.mb_w, f.mb_h)
    assert sorted(WAVEFRONT_ORDER) == list(range(16))
    assert WAVEFRONT_ORDER != W.SUBBLOCK_ORDER
    monkeypatch.setattr(W, "SUBBLOCK_ORDER", WAVEFRONT_ORDER)
    wavefront = W.reconstruct_reference(coeffs, modes, f.mb_w, f.mb_h)
    assert all(torch.equal(a, b) for a, b in zip(raster, wavefront))
