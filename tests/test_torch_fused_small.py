"""The fused whole-cascade detector on small random models, port vs JAX.

The JAX side runs ``make_fused_detector`` and the fused ops as its own CPU
tests do, with the Pallas kernels in interpret mode; the port runs the
plain twin (its CPU path). Models come from ``__graft_entry__._tiny_model``
(random regressors, scaled up so that each level moves the landmarks by
pixels), frames and boxes from numpy with a seed; the port gets the same
parameters through ``convert.from_jax_params``. JAX outputs are cached per
module.

Tolerances, in pixels: 0.02 for a whole cascade, the fast class of the
stepped detector's parity test (a centre that rounds the other way at a .5
boundary after a float-noise difference moves a patch by a pixel);
1e-3 for one level from the same input rows, where the centres are equal
and only summation orders differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from superviseddescent_tpu.core.cascade import (
    SupervisedDescentOptimiser as JaxSdo)
from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu.ops.cascade_pallas import (
    detect_cascade_fused_frames as jax_frames_op, permute_weights)
from superviseddescent_tpu.ops.patches_pallas import (
    sample_patches_window as jax_sample)
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.core.cascade import (
    SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.models.rcr import (
    DetectionModel, align_mean, rows_shift)
from superviseddescent_tpu_torch.ops.cascade_fused import (
    detect_cascade_fused_frames, level_patch_half, level_patches,
    prepare_weights)
from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.ops.patches_window import (
    sample_patches_window)

ROI = 128
WHOLE_PX = 0.02
LEVEL_PX = 1e-3


def tiny_pair(num_landmarks, levels, hog_cells=3, scale=20.0):
    """(JAX model, port model) with the same scaled random regressors."""
    jm = __graft_entry__._tiny_model(num_landmarks=num_landmarks,
                                     levels=levels, hog_cells=hog_cells)
    regs = [dataclasses.replace(r, weights=r.weights * scale)
            for r in jm.sdo.regressors]
    jm = JaxModel(JaxSdo(regs, jm.sdo.normalisation), jm.mean,
                  jm.landmark_ids, jm.hog_params, jm.right_eye_ids,
                  jm.left_eye_ids)
    pm = from_jax_params([np.asarray(r.weights) for r in regs], jm.mean,
                         jm.landmark_ids, jm.hog_params, jm.right_eye_ids,
                         jm.left_eye_ids, device="cpu")
    return jm, pm


def frames_and_boxes(seed=0, n=4, h=192, w=128):
    """Smoothed noise frames (uint8, 32/128-aligned) and boxes inside
    them, near the borders. 128 columns: the frames path's window is then
    the full width. (From 256 columns on, the window at roi 128 is 256
    wide while the column sub-window stays 128, which caps the patch half
    at max_patch_half_x(128) = -1 in both packages.)"""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, size=(n, h + 4, w + 4)).astype(np.float32)
    smooth = sum(raw[:, dy:dy + h, dx:dx + w]
                 for dy in range(5) for dx in range(5)) / 25.0
    frames = np.clip((smooth - 127.5) * 3 + 127.5, 0, 255).astype(np.uint8)
    boxes = np.float32([[20, 40, 80, 80], [2, 100, 84, 84],
                        [50, 4, 76, 76], [40, 90, 70, 70]])[:n]
    return frames, boxes


@pytest.fixture(scope="module")
def tiny():
    jm, pm = tiny_pair(6, 2)
    frames, boxes = frames_and_boxes()
    return dict(jm=jm, pm=pm, frames=frames, boxes=boxes, cache={})


def jax_detect(case, key, images, rows, **kw):
    cache = case["cache"]
    if key not in cache:
        cache[key] = np.asarray(case["jm"].make_fused_detector(
            roi=ROI, **kw)(jnp.asarray(images), jnp.asarray(rows)))
    return cache[key]


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_tiny_frames_and_crop_paths_match_jax(tiny, dtype):
    # uint8 frames: K3's frames path; float32: the crop path to K4
    frames = tiny["frames"].astype(dtype)
    ref = jax_detect(tiny, dtype, frames, tiny["boxes"])
    det = tiny["pm"].make_fused_detector(roi=ROI)
    assert det.frames_path_ok(torch.from_numpy(frames)) == (dtype == "uint8")
    got = det(torch.from_numpy(frames), tiny["boxes"]).numpy()
    np.testing.assert_allclose(got, ref, atol=WHOLE_PX, rtol=0)
    start = align_mean(tiny["pm"].mean[None], torch.from_numpy(tiny["boxes"]))
    assert float((torch.from_numpy(got) - start).abs().max()) > 1.0


def test_tiny_per_level_from_jax_rows(tiny):
    # one-level op calls, each level from the JAX op's own input rows
    jm, pm = tiny["jm"], tiny["pm"]
    frames = tiny["frames"]
    det = pm.make_fused_detector(roi=ROI)
    t_frames = torch.from_numpy(frames)
    boxes = torch.from_numpy(tiny["boxes"])
    oy, ox, window = det.aligned_origins(t_frames, boxes)
    idx = torch.arange(len(frames), dtype=torch.int32)
    x = (align_mean(pm.mean[None], boxes)
         - rows_shift(ox.float(), oy.float(), len(pm.landmark_ids))).numpy()
    n_lm, c = len(pm.landmark_ids), pm.hog_params[0].num_cells
    for li, level in enumerate(det.levels):
        wperm = permute_weights(np.asarray(jm.sdo.regressors[li].weights),
                                n_lm, c, det.dims)
        ref = np.asarray(jax_frames_op(
            jnp.asarray(frames), jnp.asarray(idx.numpy()),
            jnp.asarray(oy.numpy()), jnp.asarray(ox.numpy()),
            jnp.asarray(x), (wperm,), window, (level,),
            (det.cell_sizes[li],), 4, det.dims, det.r_idx, det.l_idx))
        got = detect_cascade_fused_frames(
            t_frames, idx, oy, ox, torch.from_numpy(x),
            [pm.sdo.regressors[li].weights], window, (level,),
            (det.cell_sizes[li],), 4, det.dims, det.r_idx,
            det.l_idx).numpy()
        np.testing.assert_allclose(got, ref, atol=LEVEL_PX, rtol=0)
        x = np.array(ref)


def test_tiny_unquantized_matches_jax(tiny):
    ref = jax_detect(tiny, "noq", tiny["frames"], tiny["boxes"],
                     quantize=False)
    got = tiny["pm"].make_fused_detector(roi=ROI, quantize=False)(
        torch.from_numpy(tiny["frames"]), tiny["boxes"]).numpy()
    np.testing.assert_allclose(got, ref, atol=WHOLE_PX, rtol=0)
    quantized = jax_detect(tiny, "uint8", tiny["frames"], tiny["boxes"])
    assert np.abs(ref - quantized).max() > 0


def test_tiny_landmarks_init_matches_jax(tiny):
    pm = tiny["pm"]
    rng = np.random.default_rng(3)
    rows = (align_mean(pm.mean[None], torch.from_numpy(tiny["boxes"]))
            .numpy() + rng.uniform(-3, 3, (4, 12)).astype(np.float32))
    ref = jax_detect(tiny, "landmarks", tiny["frames"], rows,
                     init="landmarks")
    got = pm.make_fused_tracker(roi=ROI)(torch.from_numpy(tiny["frames"]),
                                         rows).numpy()
    np.testing.assert_allclose(got, ref, atol=WHOLE_PX, rtol=0)


def test_multi_segment_29_landmarks_matches_jax():
    # 29 landmarks x 5 cells: two lane segments in the JAX kernel's layout
    jm, pm = tiny_pair(29, 2, hog_cells=5)
    frames, boxes = frames_and_boxes(seed=1, n=2)
    ref = np.asarray(jm.make_fused_detector(roi=ROI)(
        jnp.asarray(frames), jnp.asarray(boxes)))
    got = pm.make_fused_detector(roi=ROI)(torch.from_numpy(frames),
                                          boxes).numpy()
    np.testing.assert_allclose(got, ref, atol=WHOLE_PX, rtol=0)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_image_indices_equal_expanded_stack(tiny, dtype):
    frames = tiny["frames"].astype(dtype)
    idx = np.array([0, 2, 2, 3, 1, 0], np.int32)
    boxes = tiny["boxes"][idx % 4]
    det = tiny["pm"].make_fused_detector(roi=ROI)
    expanded = det(torch.from_numpy(frames[idx]), boxes)
    indexed = det(torch.from_numpy(frames), boxes, image_indices=idx)
    torch.testing.assert_close(indexed, expanded, rtol=0, atol=0)
    also = det(torch.from_numpy(frames), boxes,
               image_indices=torch.from_numpy(idx))
    torch.testing.assert_close(also, expanded, rtol=0, atol=0)


def test_fused_sampling_equals_k2_twin_and_jax(tiny):
    # the fused twin's sampling step is K2's fast, transposed sampling
    pm = tiny["pm"]
    det = pm.make_fused_detector(roi=ROI)
    frames = torch.from_numpy(tiny["frames"])
    boxes = torch.from_numpy(tiny["boxes"])
    oy, ox, (ry, rx) = det.aligned_origins(frames, boxes)
    windows = torch.stack([frames[i, y:y + ry, x:x + rx]
                           for i, (y, x) in enumerate(zip(oy.tolist(),
                                                          ox.tolist()))])
    x = align_mean(pm.mean[None], boxes) - rows_shift(
        ox.float(), oy.float(), len(pm.landmark_ids))
    l = x.shape[1] // 2
    for level in det.levels:
        s, w, wx, _ = level
        _, phw = level_patch_half(x, level, ry, rx, det.r_idx, det.l_idx)
        got = level_patches(windows, x, level, phw, True)
        k2 = sample_patches_window(
            windows, x[:, :l], x[:, l:], phw, s, sub_window=w,
            sub_window_x=wx, sampling="fast", transposed=True)
        torch.testing.assert_close(got, k2, rtol=0, atol=0)
        ref = np.asarray(jax_sample(
            jnp.asarray(windows.numpy().astype(np.float32), jnp.bfloat16),
            jnp.asarray(x[:, :l].numpy()), jnp.asarray(x[:, l:].numpy()),
            jnp.asarray(phw.numpy()), s, sub_window=w, sub_window_x=wx,
            sampling="fast", transposed=True, interpret=True), np.float32)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_five_levels_with_zero_fifth_equal_four():
    # the port takes any number of levels (the JAX ops stop at 4)
    _, pm = tiny_pair(6, 4)
    regs = [LinearRegressor(r.weights.clone()) for r in pm.sdo.regressors]
    five = DetectionModel(
        SupervisedDescentOptimiser(
            regs + [LinearRegressor(torch.zeros_like(regs[-1].weights))],
            pm.sdo.normalisation),
        pm.mean.numpy(), pm.landmark_ids,
        pm.hog_params + pm.hog_params[-1:], pm.right_eye_ids,
        pm.left_eye_ids, device="cpu")
    frames, boxes = frames_and_boxes(seed=2)
    four_rows = pm.make_fused_detector(roi=ROI)(torch.from_numpy(frames),
                                                boxes)
    five_rows = five.make_fused_detector(roi=ROI)(torch.from_numpy(frames),
                                                  boxes)
    torch.testing.assert_close(five_rows, four_rows, rtol=0, atol=0)


def test_named_errors(tiny):
    pm = tiny["pm"]
    with pytest.raises(ValueError, match="128-aligned roi"):
        pm.make_fused_detector(roi=200)
    with pytest.raises(ValueError, match="init mode"):
        pm.make_fused_detector(roi=ROI, init="boxes")

    def variant(**kw):
        params = tuple(dataclasses.replace(p, **kw) if i == 1 else p
                       for i, p in enumerate(pm.hog_params))
        return DetectionModel(pm.sdo, pm.mean.numpy(), pm.landmark_ids,
                              params, pm.right_eye_ids, pm.left_eye_ids,
                              device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        variant(num_cells=4).make_fused_detector(roi=ROI)

    def all_levels(**kw):
        params = tuple(dataclasses.replace(p, **kw) for p in pm.hog_params)
        return DetectionModel(pm.sdo, pm.mean.numpy(), pm.landmark_ids,
                              params, pm.right_eye_ids, pm.left_eye_ids,
                              device="cpu")
    with pytest.raises(ValueError, match="Uoctti"):
        all_levels(variant=HogVariant.DalalTriggs).make_fused_detector(
            roi=ROI)
    with pytest.raises(ValueError, match="num_bins=4"):
        all_levels(num_bins=6).make_fused_detector(roi=ROI)
    det = pm.make_fused_detector(roi=ROI)
    frames = torch.from_numpy(tiny["frames"])
    for idx in ([0, 1, 4, 2], np.array([0, -1, 1, 2])):
        with pytest.raises(ValueError, match="outside"):
            det(frames, tiny["boxes"], image_indices=idx)



def test_prepared_weights_keep_reference_order(tiny):
    pm = tiny["pm"]
    ws = [r.weights for r in pm.sdo.regressors]
    prepared = prepare_weights(ws)
    f, p = ws[0].shape
    assert prepared.tensor.shape == (2, p, -(-f // 8) * 8)
    assert prepared.tensor.dtype == torch.bfloat16
    assert not bool(prepared.tensor[:, :, f:].any())
    for li, w in enumerate(ws):
        torch.testing.assert_close(prepared.reference(li),
                                   w.bfloat16().float(), rtol=0, atol=0)
    assert prepare_weights(prepared) is prepared


def test_fused_op_named_errors(tiny):
    pm = tiny["pm"]
    det = pm.make_fused_detector(roi=ROI)
    frames = torch.from_numpy(tiny["frames"])
    idx = torch.arange(4, dtype=torch.int32)
    zeros = torch.zeros(4, dtype=torch.int32)
    x0 = torch.zeros((4, 12))
    args = (det.levels, det.cell_sizes, 4, 16, det.r_idx, det.l_idx)
    with pytest.raises(ValueError, match="uint8"):
        detect_cascade_fused_frames(frames.float(), idx, zeros, zeros, x0,
                                    det.weights, (160, 128), *args)
    with pytest.raises(ValueError, match="weight levels"):
        detect_cascade_fused_frames(frames, idx, zeros, zeros, x0,
                                    [pm.sdo.regressors[0].weights],
                                    (160, 128), *args)
    with pytest.raises(ValueError, match="num_orientations=4"):
        detect_cascade_fused_frames(frames, idx, zeros, zeros, x0,
                                    det.weights, (160, 128), *args[:2], 9,
                                    36, *args[4:])
    with pytest.raises(ValueError, match="exceeds"):
        detect_cascade_fused_frames(frames, idx, zeros, zeros, x0,
                                    det.weights, (224, 128), *args)
