"""The Haar cascade face detector of the port against the JAX package.

Both run on the CPU with the stock OpenCV cascades (the parser on every
stock frontal-face file, the detector with ``haarcascade_frontalface_alt2``
and the apps' parameters: scale 1.2, 2 neighbours, 50 x 50 px at least) on
``.synth120`` images, one of each of its five size classes, scaled down in
the test by a whole stride to a long side of about 300 px.

What must be equal, and the one rule for what may differ:
  * the parsed cascades, bit for bit;
  * the bank products and the norm factor are exact integers in both
    packages, and the port's float64 stage sums are exact (checked below),
    so a window's decision can differ from JAX's only where JAX's float32
    stage sum ties its threshold: such a window is accepted only within
    1e-6 relative of that stage's threshold, and each is reported. The
    expected count is zero;
  * the integer pyramid: JAX's CPU resize is a dense float32 product whose
    summation order follows its backend's blocking, so an output whose
    exact value lies within float32 noise of a .5 tie may round either
    way. Such a pixel is accepted only within 1e-3 of the tie, and each is
    reported;
  * raw boxes (``min_neighbors=0``) and grouped boxes, equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.io.haar import (
    parse_opencv_cascade as jax_parse)
from superviseddescent_tpu.models import facedetect as jfd
from superviseddescent_tpu.utils.landmarks import check_face as jax_check
from superviseddescent_tpu_torch.io.haar import (
    STOCK_FRONTAL_ALT2, parse_opencv_cascade)
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models import facedetect as tfd
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from superviseddescent_tpu_torch.utils.landmarks import check_face

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STOCK = "/usr/share/opencv4/haarcascades"
FRONTAL = ("haarcascade_frontalcatface.xml",
           "haarcascade_frontalcatface_extended.xml",
           "haarcascade_frontalface_alt.xml",
           "haarcascade_frontalface_alt2.xml",
           "haarcascade_frontalface_alt_tree.xml",
           "haarcascade_frontalface_default.xml")
# the first image of each .synth120 size class (w x h: 412 x 600, 300 x 450,
# 337 x 500, 728 x 1023, 686 x 1024)
IMAGES = ("synth_0000", "synth_0001", "synth_0002", "synth_0003",
          "synth_0004")
PARAMS = dict(scale_factor=1.2, min_size=(50, 50))
STAGE_TIE_RTOL = 1e-6
PIXEL_TIE = 1e-3


def scaled_image(name):
    """The image at a whole stride, long side about 300 px."""
    img = load_gray_image(os.path.join(REPO, ".synth120", name + ".png"))
    k = max(1, round(max(img.shape) / 300))
    return np.ascontiguousarray(img[::k, ::k])


@pytest.fixture(scope="module")
def cascade():
    return parse_opencv_cascade(STOCK_FRONTAL_ALT2)


@pytest.fixture(scope="module")
def detectors(cascade):
    """(JAX raw, JAX grouped, port raw, port grouped) detectors."""
    jc = jax_parse(STOCK_FRONTAL_ALT2)
    return (jfd.HaarCascadeDetector(jc, min_neighbors=0, **PARAMS),
            jfd.HaarCascadeDetector(jc, min_neighbors=2, **PARAMS),
            tfd.HaarCascadeDetector(cascade, min_neighbors=0, device="cpu",
                                    **PARAMS),
            tfd.HaarCascadeDetector(cascade, min_neighbors=2, device="cpu",
                                    **PARAMS))


@pytest.fixture(scope="module")
def jax_boxes(detectors):
    """JAX's raw and grouped boxes per test image (one compiled program
    per image shape serves both)."""
    jraw, jgrp = detectors[:2]
    out = {}
    for name in IMAGES:
        img = scaled_image(name)
        out[name] = (jraw.detect(img), jgrp.detect(img))
    return out


# ------------------------------------------------------------ the parser
@pytest.mark.parametrize("name", FRONTAL)
def test_parser_bit_equal_on_stock_frontal_cascades(name):
    """Every field of HaarCascadeData, bit for bit, and the same refusal
    (tilted features) where JAX refuses; the bf16 exactness check agrees."""
    path = os.path.join(STOCK, name)
    try:
        want = jax_parse(path)
    except ValueError as e:
        with pytest.raises(ValueError, match="tilted"):
            parse_opencv_cascade(path)
        assert "tilted" in str(e)
        return
    got = parse_opencv_cascade(path)
    assert (got.window_width, got.window_height) == (want.window_width,
                                                     want.window_height)
    for field in ("bank0", "bank1", "thresh0", "thresh1", "flip0", "leaves",
                  "stage_bounds", "stage_thresholds"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert tfd.banks_exact_in_bf16(got) == jfd._banks_exact_in_bf16(want)
    # the port's float64 stage sums are exact in any order: every leaf a
    # multiple of 2^-40 and every stage's sum of magnitudes below 2^13
    leaves = got.leaves.astype(np.float64)
    assert np.all(np.ldexp(leaves, 40) == np.round(np.ldexp(leaves, 40)))
    for lo, hi in zip(got.stage_bounds[:-1], got.stage_bounds[1:]):
        assert np.abs(leaves[lo:hi]).max(axis=1).sum() < 2.0 ** 13


def test_carried_cascade_is_the_stock_file():
    with open(STOCK_FRONTAL_ALT2, "rb") as f:
        carried = f.read()
    with open(os.path.join(STOCK, "haarcascade_frontalface_alt2.xml"),
              "rb") as f:
        assert carried == f.read()
    assert b"Intel License Agreement" in carried[:2000]


# ------------------------------------------------------------ the pyramid
def stage_sums(d, image, x, y):
    """float64 stage sums of the window at (x, y) of an integer pyramid
    level, in numpy from the parsed cascade (an evaluation of its own; the
    norm factor in float32 as both packages compute it)."""
    win = image[y:y + d.window_height, x:x + d.window_width].reshape(-1)
    inner = np.zeros((d.window_height, d.window_width), np.float32)
    inner[1:-1, 1:-1] = 1.0
    inner = inner.reshape(-1)
    pc = win.astype(np.float32) - np.float32(128.0)
    s, sq = np.float32(pc @ inner), np.float32((pc * pc) @ inner)
    var = np.float32(inner.sum()) * sq - s * s
    nf = np.sqrt(var) if var > 0 else np.float32(1.0)
    raw0, raw1 = win.astype(np.float32) @ d.bank0, win.astype(
        np.float32) @ d.bank1
    c0 = (raw0 < d.thresh0 * nf) ^ d.flip0
    leaf = np.where(c0, d.leaves[:, 0], np.where(
        raw1 < d.thresh1 * nf, d.leaves[:, 1], d.leaves[:, 2]))
    return np.array([leaf[a:b].astype(np.float64).sum() for a, b in
                     zip(d.stage_bounds[:-1], d.stage_bounds[1:])])


@pytest.mark.parametrize("name", IMAGES)
def test_integer_pyramid_equals_jax(detectors, name):
    """Every level of the detector's plan, pixel by pixel, against JAX's
    ``jax.image.resize`` + round + clip at the same shape; a pixel that
    differs must lie at a .5 tie of the exact (float64) resize."""
    det = detectors[2]
    img = scaled_image(name)
    h, w = img.shape
    resize = jax.jit(lambda x, sh, sw: jnp.clip(jnp.round(jax.image.resize(
        x, (1, sh, sw), method="linear", antialias=False)), 0.0, 255.0),
        static_argnums=(1, 2))
    plan = det.pyramid_plan(h, w)
    assert len(plan) >= 4
    ties = []
    for s in plan:
        want = np.asarray(resize(jnp.asarray(img[None]), s.sh, s.sw))[0]
        got = tfd.resize_round(torch.from_numpy(img)[None], s.sh,
                               s.sw)[0].numpy()
        for yy, xx in zip(*np.nonzero(got != want)):
            i0, i1, w0, w1 = tfd.resize_taps(w, s.sw)
            j0, j1, v0, v1 = tfd.resize_taps(h, s.sh)
            img64 = img.astype(np.float64)
            rows = [img64[r, i0[xx]] * w0[xx] + img64[r, i1[xx]] * w1[xx]
                    for r in (j0[yy], j1[yy])]
            exact = rows[0] * v0[yy] + rows[1] * v1[yy]
            ties.append((s.factor, yy, xx, exact))
            assert abs(got[yy, xx] - want[yy, xx]) == 1.0
            assert abs(exact - np.floor(exact) - 0.5) < PIXEL_TIE, ties[-1]
    if ties:
        print(f"{name}: {len(ties)} pixels at .5 ties differ from JAX: "
              f"{ties}")


# ------------------------------------------------------ masks and boxes
@pytest.mark.parametrize("name", IMAGES)
def test_window_masks_equal_jax(detectors, cascade, name):
    """The dense pass mask of every window of every level, and the
    prefiltered one, against JAX's dense mask; a window that differs must
    have a stage sum within 1e-6 relative of that stage's threshold."""
    jdet, _, det, _ = detectors
    img = scaled_image(name)
    h, w = img.shape
    pend = jdet._dispatch_stack(jnp.asarray(img[None]), h, w)
    want = np.asarray(jfd._run_pyramid_masks(pend.imgs_dev, *pend.args,
                                             *pend.statics))[0]
    plan = det.pyramid_plan(h, w)
    images = torch.from_numpy(img)[None]
    dense, ovf = det._pyramid(images, plan, 0)
    assert not bool(ovf.any())
    dense = dense[0].numpy()
    assert want.shape == dense.shape and want.sum() > 0
    # survivors in N // 2 slots (the default's N // 4 overflows on some
    # of these frames, whose small levels pass the first stages often)
    pre, ovf_pre = det._pyramid(images, plan, 2)
    assert not bool(ovf_pre.any())
    np.testing.assert_array_equal(pre[0].numpy(), dense)
    offsets = np.cumsum([0] + [s.oh * s.ow for s in plan])
    differ = np.nonzero(dense != want)[0]
    for i in differ:
        li = np.searchsorted(offsets, i, side="right") - 1
        s = plan[li]
        y, x = divmod(i - offsets[li], s.ow)
        scaled = tfd.resize_round(images, s.sh, s.sw)[0].numpy()
        sums = stage_sums(cascade, scaled, x * s.stride, y * s.stride)
        rel = np.abs(sums - cascade.stage_thresholds) / np.abs(
            cascade.stage_thresholds)
        print(f"{name}: window {i} (level {li}, x {x}, y {y}) differs "
              f"from JAX; nearest stage threshold {rel.min():.2e} relative")
        assert rel.min() <= STAGE_TIE_RTOL


@pytest.mark.parametrize("name", IMAGES)
def test_raw_and_grouped_boxes_equal_jax(detectors, jax_boxes, name):
    _, _, raw, grouped = detectors
    img = scaled_image(name)
    want_raw, want_grouped = jax_boxes[name]
    np.testing.assert_array_equal(raw.detect(img), want_raw)
    np.testing.assert_array_equal(grouped.detect(img), want_grouped)
    if name != "synth_0004":        # the face found in the first four
        assert len(want_grouped) == 1


def test_group_rectangles_equals_jax():
    boxes = np.float32([[10, 10, 50, 50], [12, 11, 50, 50],
                        [11, 12, 49, 51], [200, 200, 40, 40]])
    out = tfd.group_rectangles(boxes, min_neighbors=2)
    assert out.shape == (1, 4)
    np.testing.assert_allclose(out[0], boxes[:3].mean(axis=0))
    np.testing.assert_array_equal(out, jfd.group_rectangles(boxes, 2))
    out0 = tfd.group_rectangles(boxes, min_neighbors=0)
    assert out0.shape[0] == 2
    np.testing.assert_array_equal(out0, jfd.group_rectangles(boxes, 0))
    rng = np.random.default_rng(0)
    many = np.concatenate([rng.normal(100, 3, (40, 4)),
                           rng.normal(300, 40, (40, 4))]).astype(np.float32)
    many[:, 2:] = np.abs(many[:, 2:]) + 20
    for mn in (0, 1, 2, 3):
        np.testing.assert_array_equal(tfd.group_rectangles(many, mn),
                                      jfd.group_rectangles(many, mn))


TOY = """<?xml version="1.0"?>
<opencv_storage>
<cascade type_id="opencv-cascade-classifier"><stageType>BOOST</stageType>
  <featureType>HAAR</featureType>
  <height>8</height><width>8</width>
  <stageParams><maxWeakCount>1</maxWeakCount></stageParams>
  <featureParams><maxCatCount>0</maxCatCount></featureParams>
  <stageNum>1</stageNum>
  <stages>
    <_>
      <maxWeakCount>1</maxWeakCount>
      <stageThreshold>0.5</stageThreshold>
      <weakClassifiers>
        <_>
          <internalNodes>0 -1 0 2.0</internalNodes>
          <leafValues>0. 1.</leafValues></_></weakClassifiers></_>
  </stages>
  <features>
    <_>
      <rects>
        <_>0 0 8 8 -1.</_>
        <_>2 2 4 4 4.</_></rects></_>
  </features>
</cascade>
</opencv_storage>
"""


def test_synthetic_stump_cascade(tmp_path):
    """A hand-built single-stump cascade passes exactly where the window's
    centre rect is brighter than its surround; the same boxes as JAX."""
    xml = tmp_path / "toy.xml"
    xml.write_text(TOY)
    det = tfd.HaarCascadeDetector(str(xml), min_neighbors=0, min_size=(8, 8),
                                  device="cpu")
    img = np.zeros((32, 32), np.float32)
    img[12:16, 12:16] = 255.0
    boxes = det.detect(img)
    assert len(boxes) >= 1
    assert any(b[0] == 10 and b[1] == 10 for b in boxes), boxes
    want = jfd.HaarCascadeDetector(str(xml), min_neighbors=0,
                                   min_size=(8, 8)).detect(img)
    np.testing.assert_array_equal(boxes, want)


def test_prefilter_dense_and_both_fallbacks_equal_jax(cascade, detectors,
                                                      jax_boxes):
    """No prefilter, a 128-slot survivor buffer that must overflow (the
    flag read back), and a 4-slot candidate buffer that must overflow, each
    give JAX's raw and grouped boxes."""
    name = "synth_0003"
    img = scaled_image(name)
    want_raw, want_grouped = jax_boxes[name]
    for mn, want in ((0, want_raw), (2, want_grouped)):
        dense = tfd.HaarCascadeDetector(cascade, min_neighbors=mn,
                                        device="cpu", **PARAMS)
        dense.SURVIVOR_DIV = 0
        np.testing.assert_array_equal(dense.detect(img), want)
        tiny = tfd.HaarCascadeDetector(cascade, min_neighbors=mn,
                                       device="cpu", **PARAMS)
        tiny.SURVIVOR_DIV = 1 << 20
        pend = tiny.detect_begin(img)
        assert int(pend.packed[0, -1]) == 1       # the survivor flag
        np.testing.assert_array_equal(tiny.detect_end(pend), want)
        few = tfd.HaarCascadeDetector(cascade, min_neighbors=mn,
                                      device="cpu", **PARAMS)
        few.MAX_CANDIDATES = 4
        pend = few.detect_begin(img)
        assert int(pend.packed[0, -2]) == len(want_raw) > 4
        assert int(pend.packed[0, -1]) == 0
        np.testing.assert_array_equal(few.detect_end(pend), want)


def test_window_budget_bands_equal_whole(cascade, detectors):
    """Evaluations cut into bands of a frame's rows (a budget below one
    frame's windows) give the same boxes as whole levels."""
    img = scaled_image("synth_0000")
    banded = tfd.HaarCascadeDetector(cascade, min_neighbors=0, device="cpu",
                                     **PARAMS)
    banded.WINDOW_BUDGET = 500
    np.testing.assert_array_equal(banded.detect(img),
                                  detectors[2].detect(img))


def test_detect_batch_and_stream_equal_detect(detectors):
    """detect_batch (one read-back for the stack) and detect_stream /
    detect_begin / detect_end return what detect returns, including a
    blank frame, a shifted one and frames of another shape, at any depth
    and fenced out of issue order."""
    det = detectors[3]
    img = scaled_image("synth_0001")
    h, w = img.shape
    shifted = np.zeros_like(img)
    shifted[:h - 20, :w - 15] = img[20:, 15:]
    frames = np.stack([img, shifted, np.zeros_like(img)])
    batched = det.detect_batch(frames)
    assert len(batched) == 3
    singles = [det.detect(f) for f in frames]
    for got, want in zip(batched, singles):
        np.testing.assert_array_equal(got, want)
    assert len(batched[0]) == 1 and len(batched[2]) == 0
    mixed = [img, shifted, np.zeros_like(img), img[:h - 32, :w - 16]]
    want = [det.detect(f) for f in mixed]
    for depth in (1, 2, 4, 7):
        got = list(det.detect_stream(mixed, depth=depth))
        assert len(got) == len(mixed)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="depth"):
        list(det.detect_stream(mixed, depth=0))
    p0 = det.detect_begin(img)
    p1 = det.detect_begin(shifted)
    np.testing.assert_array_equal(det.detect_end(p1), singles[1])
    np.testing.assert_array_equal(det.detect_end(p0), singles[0])


def test_tensor_and_numpy_inputs_agree(detectors):
    det = detectors[3]
    img = scaled_image("synth_0002")
    want = det.detect(img)
    assert len(want) == 1
    for x in (torch.from_numpy(img), torch.from_numpy(img.astype(np.uint8)),
              img.astype(np.uint8)):
        np.testing.assert_array_equal(det.detect(x), want)
    batch = det.detect_batch(torch.from_numpy(np.stack([img, img])))
    for got in batch:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="grayscale image"):
        det.detect(np.stack([img, img]))
    with pytest.raises(ValueError, match="grayscale stack"):
        det.detect_batch(img)


def test_small_frame_has_no_level(detectors):
    det = detectors[3]
    assert det.pyramid_plan(40, 40) == ()
    assert det.detect(np.zeros((40, 40), np.float32)).shape == (0, 4)
    assert [b.shape for b in det.detect_batch(
        np.zeros((2, 40, 40), np.float32))] == [(0, 4), (0, 4)]


def test_no_cuda_and_no_device_raises(cascade, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfd.HaarCascadeDetector(cascade)


# --------------------------------------------------------- check_face
def test_check_face_equals_jax():
    """Hits and misses on the .pts ground truth of the test images,
    including boxes whose right or bottom edge falls exactly on a landmark
    (half-open: outside) or one pixel past it (inside)."""
    from superviseddescent_tpu.io import read_pts_landmarks as jax_pts
    for name in IMAGES:
        pts_path = os.path.join(REPO, ".synth120", name + ".pts")
        gt, jgt = read_pts_landmarks(pts_path), jax_pts(pts_path)
        xs = [int(gt[n][0]) for n in ("37", "46", "58")]
        ys = [int(gt[n][1]) for n in ("37", "46", "58")]
        x0, y0 = min(xs), min(ys)
        tight = (x0, y0, max(xs) - x0 + 1, max(ys) - y0 + 1)
        cases = {
            "tight": (tight, True),
            "right edge on the landmark": (
                (x0, y0, max(xs) - x0, max(ys) - y0 + 1), False),
            "bottom edge on the landmark": (
                (x0, y0, max(xs) - x0 + 1, max(ys) - y0), False),
            "left of it": ((x0 + 1, y0, 500, 500), False),
            "big": ((0, 0, 2000, 2000), True),
        }
        for label, (box, want) in cases.items():
            for boxes in ([box], [box, (0, 0, 1, 1)]):
                assert check_face(boxes, gt) == want, (name, label)
                assert jax_check(boxes, jgt) == want, (name, label)
        assert not check_face([], gt) and not jax_check([], jgt)
        assert not check_face([(0, 0, 1, 1), tight], gt)
