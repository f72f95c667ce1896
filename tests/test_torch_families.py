"""COFW-29 and ibug-68 through the port, and the remaining detector entry
points (``make_batched_detector``, ``make_scan_detector``), port vs JAX.

The pretrained family models (``pretrained/rcr29_lfpw5.bin``,
``rcr68_lfpw5.bin``: 4 levels, 5 cells, 4 bins, 11,601 and 27,201 features)
are loaded by the JAX package and handed to the port through
``convert.from_jax_params``; faces are ``.synth120`` images, their ground
truth filtered from the 68-point ``.pts``. The port runs on ``device="cpu"``
(the plain twins); JAX kernels run in Pallas interpret mode.

Tolerances, in pixels: 1e-3 for the exact ``detect_batch`` rows (the same
float32 operations, other summation orders); 0.02 for a whole fused cascade
against the JAX fused kernel (the fast-class limit of
``tests/test_torch_fused_small.py``); 0.75 for the fused and the fast
stepped rows against the exact stepped rows (the JAX package's
fused-vs-exact bound, ``tests/test_detectors.py``).
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_small import frames_and_boxes, tiny_pair
from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu.models.rcr_training import (
    normalised_landmark_errors as jax_errors)
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import (
    RCR22_HOG_PARAMS, DetectionModel, align_mean, gt_facebox)
from superviseddescent_tpu_torch.models.rcr_training import (
    normalised_landmark_errors)
from superviseddescent_tpu_torch.ops.cascade_fused import (
    _MAX_SHARED, launch_plan)
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from superviseddescent_tpu_torch.utils.landmarks import (
    ied_from_rows, resolve_eye_indices, to_row)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_PX = 1e-3
WHOLE_PX = 0.02
FUSED_VS_EXACT_PX = 0.75
# landmark ids of the families (scripts/bench_fused_families.py)
IDS29 = [str(i) for i in
         (3, 9, 15, 18, 20, 22, 23, 25, 27, 28, 31, 32, 34, 36,
          37, 38, 40, 41, 43, 44, 46, 47, 49, 51, 52, 53, 55, 58, 63)]
FAMILY_IDS = {29: IDS29, 68: [str(i) for i in range(1, 69)]}
_CASES = {}


def family(n_lm):
    """(JAX model, port model, images, boxes, gt rows) of a family on the
    first two .synth120 faces; built once per process."""
    if n_lm not in _CASES:
        jm = JaxModel.load(os.path.join(REPO, "pretrained",
                                        f"rcr{n_lm}_lfpw5.bin"))
        pm = from_jax_params(
            [np.asarray(r.weights) for r in jm.sdo.regressors], jm.mean,
            jm.landmark_ids, jm.hog_params, jm.right_eye_ids,
            jm.left_eye_ids, device="cpu")
        files = sorted(glob.glob(os.path.join(REPO, ".synth120",
                                              "*.png")))[:2]
        images = [load_gray_image(f) for f in files]
        gts = [read_pts_landmarks(f[:-4] + ".pts").filter(pm.landmark_ids)
               for f in files]
        boxes = np.array([gt_facebox(g) for g in gts], np.float32)
        gt_rows = np.stack([to_row(g) for g in gts])
        _CASES[n_lm] = (jm, pm, images, boxes, gt_rows)
    return _CASES[n_lm]


@pytest.mark.parametrize("n_lm", [29, 68])
def test_family_model_shape(n_lm):
    _, pm, _, _, gt_rows = family(n_lm)
    assert pm.landmark_ids == FAMILY_IDS[n_lm]
    assert gt_rows.shape == (2, 2 * n_lm)
    for p, q in zip(pm.hog_params, RCR22_HOG_PARAMS, strict=True):
        assert (p.variant, p.num_cells, p.cell_size, p.num_bins) == (
            q.variant, q.num_cells, q.cell_size, q.num_bins)
        assert abs(p.relative_patch_size - q.relative_patch_size) < 1e-6
    f = n_lm * 16 * 25 + 1
    assert f == {29: 11601, 68: 27201}[n_lm]
    assert all(r.weights.shape == (f, 2 * n_lm) for r in pm.sdo.regressors)
    det = pm.make_fused_detector(roi=512)
    # rows padded to a multiple of 8, the padding zero
    fp = det.weights.tensor.shape[2]
    assert fp == -(-f // 8) * 8 and det.weights.num_features == f
    assert not bool(det.weights.tensor[:, :, f:].any())
    # a block of several faces fits, at any batch (H100: 132 SMs)
    for n in (1, 4096):
        assert launch_plan(n, n_lm, 5, 55, True,
                           132).shared_bytes <= _MAX_SHARED
    r_idx, l_idx = resolve_eye_indices(pm.landmark_ids, pm.right_eye_ids,
                                       pm.left_eye_ids)
    assert (det.r_idx, det.l_idx) == (r_idx, l_idx)
    assert [pm.landmark_ids[i] for i in r_idx] == pm.right_eye_ids


@pytest.mark.parametrize("n_lm", [29, 68])
def test_family_detect_batch_matches_jax(n_lm):
    jm, pm, images, boxes, gt_rows = family(n_lm)
    stack, _ = stack_images(images)
    ref = np.asarray(jm.detect_batch(jnp.asarray(stack), boxes))
    got = pm.detect_batch(torch.from_numpy(stack), boxes).numpy()
    np.testing.assert_allclose(got, ref, atol=EXACT_PX, rtol=0)
    r_idx, l_idx = resolve_eye_indices(pm.landmark_ids, pm.right_eye_ids,
                                       pm.left_eye_ids)
    err = normalised_landmark_errors(torch.from_numpy(got),
                                     torch.from_numpy(gt_rows), r_idx, l_idx)
    ref_err = np.asarray(jax_errors(ref, gt_rows, r_idx, l_idx))
    assert abs(float(err.mean()) - float(ref_err.mean())) < 1e-4
    assert float(err.mean()) < 0.1


@pytest.mark.parametrize("n_lm", [29, 68])
def test_family_fused_tracker_and_stepped_on_the_cpu(n_lm):
    # full width through the fused detector (K3's twin), the tracker and the
    # stepped window detector (K2 + K1's twins), as chip_smoke.py drives them
    _, pm, images, boxes, gt_rows = family(n_lm)
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    frames = torch.from_numpy(stack)
    r_idx, l_idx = resolve_eye_indices(pm.landmark_ids, pm.right_eye_ids,
                                       pm.left_eye_ids)
    inits = align_mean(pm.mean[None], torch.from_numpy(boxes))
    max_ied = 1.15 * max(
        float(ied_from_rows(inits, r_idx, l_idx).max()),
        float(ied_from_rows(torch.from_numpy(gt_rows), r_idx, l_idx).max()))
    fused_det = pm.make_fused_detector(roi=512, max_ied=max_ied)
    assert fused_det.frames_path_ok(frames)
    fused = fused_det(frames, boxes)
    exact = pm.make_stepped_detector(2, roi=512, window_sampler=True,
                                     max_ied=max_ied)(frames, boxes)
    fast = pm.make_stepped_detector(2, roi=512, window_sampler=True,
                                    sampling="fast",
                                    max_ied=max_ied)(frames, boxes)
    assert fused.shape == exact.shape == (2, 2 * n_lm)
    assert float((fused - exact).abs().max()) <= FUSED_VS_EXACT_PX
    assert float((fast - exact).abs().max()) <= FUSED_VS_EXACT_PX
    tracked = pm.make_fused_tracker(roi=512, max_ied=max_ied)(frames, exact)
    assert tracked.shape == exact.shape
    assert bool(torch.isfinite(tracked).all())
    # the tracker against the exact single-face path from the same prior
    # row (the pretrained regressors move a row that lies on the face, in
    # both paths alike)
    mono = to_row(pm.detect_from_landmarks(images[0], exact[0]))
    assert float(np.abs(tracked[0].numpy() - mono).max()) <= FUSED_VS_EXACT_PX


@pytest.mark.parametrize("init", ["facebox", "landmarks"])
def test_many_landmark_fused_matches_jax_kernel(init):
    # 68 landmarks x 3 cells, 2 levels: two lane segments in the JAX
    # kernel's layout, a 6,529-value feature row in the port's
    jm, pm = tiny_pair(68, 2, hog_cells=3)
    frames, boxes = frames_and_boxes(seed=4, n=2)
    given = boxes
    if init == "landmarks":
        rng = np.random.default_rng(6)
        given = (align_mean(pm.mean[None], torch.from_numpy(boxes)).numpy()
                 + rng.uniform(-3, 3, (2, 136)).astype(np.float32))
    ref = np.asarray(jm.make_fused_detector(roi=128, init=init)(
        jnp.asarray(frames), jnp.asarray(given)))
    got = pm.make_fused_detector(roi=128, init=init)(
        torch.from_numpy(frames), given).numpy()
    np.testing.assert_allclose(got, ref, atol=WHOLE_PX, rtol=0)
    start = given if init == "landmarks" else align_mean(
        pm.mean[None], torch.from_numpy(boxes)).numpy()
    assert np.abs(got - start).max() > 1.0


# ------------------------------------------------------------------ #
# make_batched_detector, make_scan_detector
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def uniform():
    jm, pm = tiny_pair(6, 3, hog_cells=3)
    frames, boxes = frames_and_boxes(seed=7, n=3)
    return jm, pm, frames.astype(np.float32), boxes


@pytest.mark.parametrize("quantize", [True, False])
def test_batched_detector_matches_detect_batch_and_jax(uniform, quantize):
    jm, pm, frames, boxes = uniform
    det = pm.make_batched_detector(frames.shape[1:], 3, quantize=quantize)
    got = det(torch.from_numpy(frames), boxes)
    want = pm.detect_batch(torch.from_numpy(frames), boxes,
                           quantize=quantize)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = np.asarray(jm.make_batched_detector(frames.shape[1:], 3,
                                              quantize=quantize)(
        jnp.asarray(frames), jnp.asarray(boxes)))
    np.testing.assert_allclose(got.numpy(), ref, atol=EXACT_PX, rtol=0)


def test_batched_detector_checks_its_shapes(uniform):
    _, pm, frames, boxes = uniform
    det = pm.make_batched_detector(frames.shape[1:], 3)
    with pytest.raises(ValueError, match="built for 3 images"):
        det(torch.from_numpy(frames[:2]), boxes[:2])
    with pytest.raises(ValueError, match="built for 3 images"):
        det(torch.from_numpy(frames[:, :100]), boxes)
    with pytest.raises(ValueError, match="image_shape"):
        pm.make_batched_detector((3, 192, 128), 3)


@pytest.mark.parametrize("quantize", [True, False])
def test_scan_detector_matches_detect_batch_and_jax(uniform, quantize):
    jm, pm, frames, boxes = uniform
    got = pm.make_scan_detector(3, quantize=quantize)(
        torch.from_numpy(frames), boxes)
    want = pm.detect_batch(torch.from_numpy(frames), boxes,
                           quantize=quantize)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = np.asarray(jm.make_scan_detector(3, quantize=quantize)(
        jnp.asarray(frames), jnp.asarray(boxes)))
    np.testing.assert_allclose(got.numpy(), ref, atol=EXACT_PX, rtol=0)
    with pytest.raises(ValueError, match="built for batch 3"):
        pm.make_scan_detector(3)(torch.from_numpy(frames[:2]), boxes[:2])


def test_scan_detector_guard_matches_jax(uniform):
    jm22 = JaxModel.load(os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"))
    pm22 = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"), device="cpu")
    with pytest.raises(ValueError, match="uniform per-level HOG") as port_err:
        pm22.make_scan_detector(4)
    with pytest.raises(ValueError, match="uniform per-level HOG") as jax_err:
        jm22.make_scan_detector(4)
    assert str(port_err.value) == str(jax_err.value)
    _, pm, _, _ = uniform
    stack = pm.sdo.weight_stack
    assert stack.shape == (3,) + tuple(pm.sdo.regressors[0].weights.shape)
    assert pm22.sdo.weight_stack.shape[0] == 4
    first = pm.sdo.regressors[0]
    whole = first.weights
    first.weights = whole[:-1]
    try:
        with pytest.raises(ValueError, match="differing weight shapes"):
            pm.sdo.weight_stack
    finally:
        first.weights = whole
