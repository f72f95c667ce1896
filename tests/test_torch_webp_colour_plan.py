"""W3's launch plan (``ops/webp.vp8_colour_plan``) and its bands, on the
CPU.

The kernel (``csrc/vp8_pixels.cu``'s ``vp8_colour``) puts a band of an
even number of full-width output rows on a CTA: it stages the band's Y
rows and the chroma rows they read (``chroma_rows`` here) in shared
memory (``colour_smem``), computes each sample from those rows alone,
U and V packed in the halves of a word, and writes the band's bytes as a
ragged head, 16-byte words and a ragged tail (``spans`` here). Here the
plan is held to sm_90's shared memory up to VP8's widest frame, and a
numpy model of that decomposition, reading nothing but what a band
stages, gives ``colour_reference``'s bytes on every lossy fixture and on
seeded planes at every width 1-40 and height 1-20, at 2, 4, 8 and 16 rows
a band, RGB and grey.

    python -m pytest tests/test_torch_webp_colour_plan.py -q
"""

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.io.vp8 import decode_vp8
from superviseddescent_tpu_torch.ops import webp as W
from test_torch_webp_plan import NAMES, SM90_SMS, vp8_payload
from torch_apps_helpers import one_torch_thread  # noqa: F401 (fixture)

SM90_SMEM = 232448              # sm_90: the shared memory a CTA may take
VP8_MAX = 16383                 # VP8's widest and highest frame
BAND_ROWS = (2, 4, 8, 16)


def round16(n: int) -> int:
    return (n + 15) // 16 * 16


def chroma_rows(y0: int, rows: int, height: int) -> tuple:
    """The chroma rows (first, last) that output rows ``y0`` (even) to
    ``y0 + rows - 1`` read, as the kernel stages them: each output row y
    its nearest y // 2 and the next one away, clamped to the frame."""
    uh = (height + 1) // 2
    return max(y0 // 2 - 1, 0), min((y0 + rows - 1) // 2 + 1, uh - 1)


def spans(address: int, nbytes: int) -> tuple:
    """How the kernel writes a band's ``nbytes`` output bytes starting at
    device ``address``: (head, words), ``head`` bytes one by one up to the
    first 16-byte-aligned address, ``words`` 16-byte stores, then the rest
    (under 16 bytes) one by one."""
    head = min(-address % 16, nbytes)
    return head, (nbytes - head) // 16


def fancy(nn, nf, fn, ff):
    """The kernel's packed upsampling: U in the low half, V in the high."""
    t = ((nn + 3 * nf + 3 * fn + ff + 0x00080008) >> 3) & 0x01FF01FF
    return (t + nn) >> 1


def edge(nn, fn):
    return (3 * nn + fn + 0x00020002) >> 2


def clip8(v):
    return np.minimum(np.maximum(v, 0), 16383) >> 6


def band_model(y, u, v, width, height, channels, rows, address=0):
    """The kernel's bands in numpy: each band stages its Y rows and the
    chroma rows ``chroma_rows`` names into arrays of the kernel's
    pitches, computes its samples from those arrays only (every row index
    checked to fall inside them) and writes its bytes into the frame's
    output by ``spans`` at device ``address``. Returns the
    output, (H, W, 3) or (H, W) uint8."""
    Y, U, V = (np.asarray(p, dtype=np.int64) for p in (y, u, v))
    uw = (width + 1) // 2
    out = np.full(height * width * channels, -1, np.int64)
    xs = np.arange(width)
    nc = xs >> 1
    # the kernel's columns: nearest j, the other j +- 1, clamped to the row
    # (only where the edge rule takes over, so the clamp never picks)
    fc = np.clip(np.where(xs & 1, nc + 1, nc - 1), 0, uw - 1)
    last = width - 1 if width % 2 == 0 else -1
    is_edge = (xs == 0) | (xs == last)
    for y0 in range(0, height, rows):
        n = min(rows, height - y0)
        c0, c1 = chroma_rows(y0, n, height)
        assert c1 - c0 + 1 <= rows // 2 + 2
        sy = np.zeros((rows, round16(width)), np.int64)
        suv = np.zeros((rows // 2 + 2, round16(uw)), np.int64)
        sy[:n, :width] = Y[y0:y0 + n, :width]
        suv[:c1 - c0 + 1, :uw] = U[c0:c1 + 1, :uw] | V[c0:c1 + 1, :uw] << 16
        ys = y0 + np.arange(n)
        nr = ys >> 1
        fr = np.clip(np.where(ys & 1, nr + 1, nr - 1), 0,
                     (height + 1) // 2 - 1)
        assert (c0 <= nr).all() and (nr <= c1).all()
        assert (c0 <= fr).all() and (fr <= c1).all()
        near, far = suv[nr - c0], suv[fr - c0]          # (n, pitch)
        uv = np.where(is_edge, edge(near[:, nc], far[:, nc]),
                      fancy(near[:, nc], near[:, fc], far[:, nc],
                            far[:, fc]))
        cu, cv = uv & 0xFF, uv >> 16
        yv = (sy[:n, :width] * 19077) >> 8
        R = clip8(yv + ((cv * 26149) >> 8) - 14234)
        G = clip8(yv - ((cu * 6419) >> 8) - ((cv * 13320) >> 8) + 8708)
        B = clip8(yv + ((cu * 33050) >> 8) - 17685)
        if channels == 1:
            band = ((R * 4899 + G * 9617 + B * 1868 + 8192) >> 14).reshape(-1)
        else:
            band = np.stack([R, G, B], -1).reshape(-1)
        start = y0 * width * channels
        head, words = spans(address + start, band.size)
        tail = head + 16 * words
        out[start:start + head] = band[:head]
        out[start + head:start + tail] = band[head:tail]
        out[start + tail:start + band.size] = band[tail:]
    assert (out >= 0).all() and (out <= 255).all()
    shape = (height, width) + ((3,) if channels == 3 else ())
    return out.astype(np.uint8).reshape(shape)


def seeded_planes(width, height, seed):
    rng = np.random.default_rng(seed)
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    return (rng.integers(0, 256, (16 * mb_h, 16 * mb_w), dtype=np.uint8),
            rng.integers(0, 256, (8 * mb_h, 8 * mb_w), dtype=np.uint8),
            rng.integers(0, 256, (8 * mb_h, 8 * mb_w), dtype=np.uint8))


def check_plan(plan, width, height, channels):
    assert plan.rows >= 2 and plan.rows % 2 == 0
    assert plan.ctas >= 1
    # every output row in exactly one band
    owners = [b for b in range(plan.ctas)
              for _ in range(min(plan.rows, height - b * plan.rows))]
    assert len(owners) == height and (plan.ctas - 1) * plan.rows < height
    assert W.colour_smem(plan.rows, width, channels) <= SM90_SMEM


@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("width,height", [
    (1, 1), (1, 2), (2, 1), (3, 3), (40, 20), (768, 1024), (1024, 768),
    (7680, 1024), (VP8_MAX, 1), (VP8_MAX, 5), (VP8_MAX, VP8_MAX),
    (1, VP8_MAX), (4095, 4097)])
def test_plan_limits(width, height, channels):
    """Even rows a band, every row in one band, at least one CTA, the
    band's shared memory within sm_90's 227 KB, and no more bands than
    COLOUR_BANDS_PER_SM an SM unless a band of their rows would not fit."""
    plan = W.vp8_colour_plan(width, height, SM90_SMS, channels=channels)
    check_plan(plan, width, height, channels)
    if plan.ctas > W.COLOUR_BANDS_PER_SM * SM90_SMS:
        assert W.colour_smem(plan.rows + 2, width, channels) > SM90_SMEM
    if plan.rows > 2:  # the fewest rows that keep to the bands aimed at
        assert -(-height // (plan.rows - 2)) > \
            W.COLOUR_BANDS_PER_SM * SM90_SMS


def test_plan_of_the_clip_frame():
    """768 x 1024 on 132 SMs: the fewest even rows a band that keep to
    COLOUR_BANDS_PER_SM bands an SM; at 8 rows a band 128 CTAs of ~30 KB."""
    rows = 2 * -(-1024 // (2 * W.COLOUR_BANDS_PER_SM * SM90_SMS))
    assert W.vp8_colour_plan(768, 1024, SM90_SMS) == (rows, 1024 // rows)
    assert W.vp8_colour_plan(768, 1024, SM90_SMS, rows=8) == (8, 128)
    assert W.colour_smem(8, 768, 3) == (8 * 768 + 2 * 6 * 384
                                        + 8 * 768 * 3 + 16)


def test_widest_frame_fits_two_rows_only():
    """At 16,383 px two RGB rows and their Y and chroma take ~176 KB: two
    rows a band fit, four do not (the launcher refuses such a forced
    plan)."""
    assert W.colour_smem(2, VP8_MAX, 3) <= SM90_SMEM
    assert W.colour_smem(4, VP8_MAX, 3) > SM90_SMEM
    assert W.vp8_colour_plan(VP8_MAX, VP8_MAX, SM90_SMS).rows == 2
    assert W.vp8_colour_plan(VP8_MAX, 8, SM90_SMS, rows=4) == (4, 2)


@pytest.mark.parametrize("rows", (-2, 1, 3, 7))
def test_forced_rows_must_be_even(rows):
    with pytest.raises(ValueError, match="even"):
        W.vp8_colour_plan(64, 64, SM90_SMS, rows=rows)


@pytest.mark.parametrize("rows", BAND_ROWS + (32,))
def test_forced_plans(rows):
    for width, height in ((1, 1), (33, 17), (768, 1024)):
        plan = W.vp8_colour_plan(width, height, SM90_SMS, rows=rows)
        assert plan.rows == rows
        check_plan(plan, width, height, 3)


@pytest.mark.parametrize("rows", BAND_ROWS)
def test_band_spans_cover_each_byte_once(rows):
    """Each band's bytes at every 16-byte residue of the output's address:
    a head of under 16 bytes ending on a 16-byte address, whole aligned
    words, a tail of under 16 bytes, together every byte exactly once."""
    for width, height, channels in ((1, 1, 1), (5, 3, 3), (13, 20, 1),
                                    (40, 20, 3), (768, 64, 3)):
        for base in range(16):
            seen = np.zeros(width * height * channels, np.int64)
            for y0 in range(0, height, rows):
                n = min(rows, height - y0)
                start, size = y0 * width * channels, n * width * channels
                head, words = spans(base + start, size)
                tail = size - head - 16 * words
                assert 0 <= head < 16 and 0 <= tail < 16
                if words:
                    assert (base + start + head) % 16 == 0
                seen[start:start + size] += 1
            assert (seen == 1).all()


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("height", range(1, 21))
def test_bands_equal_the_twin_on_seeded_planes(height):
    """Every width 1-40 at this height, 2, 4, 8 and 16 rows a band, RGB
    and grey, the output at an address of each 16-byte residue in turn."""
    for width in range(1, 41):
        y, u, v = seeded_planes(width, height, 1000 * height + width)
        ty, tu, tv = (torch.from_numpy(p) for p in (y, u, v))
        for channels in (1, 3):
            want = W.colour_reference(ty, tu, tv, width, height,
                                      channels).numpy()
            for k, rows in enumerate(BAND_ROWS):
                got = band_model(y, u, v, width, height, channels, rows,
                                 address=(width + k) % 16)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{width} x {height}, {rows} rows")


@pytest.fixture(scope="module")
def fixture_planes():
    """Each lossy fixture's planes after W2, by the twins."""
    torch.set_num_threads(1)
    planes = {}
    for name in NAMES:
        f = decode_vp8(vp8_payload(name))
        p = W.reconstruct_reference(torch.as_tensor(f.coeffs),
                                    torch.as_tensor(f.modes), f.mb_w, f.mb_h)
        p = W.filter_reference(*p, torch.as_tensor(f.filters),
                               f.filter_type, f.mb_w, f.mb_h)
        planes[name] = (f.width, f.height, p)
    return planes


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("name", NAMES)
def test_bands_equal_the_twin_on_every_fixture(name, fixture_planes):
    """Every lossy fixture (the 768 x 1024 clip frame among them) at the
    plan's rows a band and at 2, 4, 8 and 16, RGB and grey."""
    width, height, planes = fixture_planes[name]
    arrays = [p.numpy() for p in planes]
    plan = W.vp8_colour_plan(width, height, SM90_SMS)
    for channels in (1, 3):
        want = W.colour_reference(*planes, width, height, channels).numpy()
        for rows in sorted({plan.rows, *BAND_ROWS}):
            got = band_model(*arrays, width, height, channels, rows,
                             address=rows % 16)
            np.testing.assert_array_equal(got, want, err_msg=f"{rows} rows")
