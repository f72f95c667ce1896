"""K5 / K6 (one level's fused training features), port vs JAX.

The JAX side runs ``extract_features_fused_frames`` / ``extract_features_
fused`` as Pallas kernels in interpret mode, compacts the padded kernel
rows (``compact_feature_columns``) and maps the kernel's column order to the
reference's Matlab order (``std[:, compact_to_standard_rows] = compact``).
The port runs the kernels' plain twins (its CPU path), which write the
reference's order directly.

Tolerances: 1e-6 absolute on channel values of order 0.1-0.4 (measured:
6e-8, a last bit). Both sides do the same float32 operations on the same
bf16-rounded partials, up to ``rsqrt`` against ``1/sqrt`` in the block
factors; the share of exactly equal entries is printed. K5's rows against
the port's ``window`` backend in the fast class (K2's twin then K1's twin,
which splats in one (S*S, C*C) product without the bf16-rounded x
partials): 5e-3 absolute (measured: 1.7e-3).
"""

import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.ops.cascade_pallas import (
    compact_feature_columns, compact_to_standard_rows,
    extract_features_fused as jax_k6,
    extract_features_fused_frames as jax_k5)
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import (
    DetectionModel, HogTransform, align_mean, gt_facebox, rows_shift)
from superviseddescent_tpu_torch.ops.cascade_fused import (
    extract_features_fused, extract_features_fused_frames,
    extract_features_fused_frames_reference, extract_features_fused_reference)
from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from test_torch_fused_small import frames_and_boxes, tiny_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 0, 1e-6
WINDOW_ATOL = 5e-3


def to_reference_order(feats_k, n_lm, cells, dims=16):
    compact = np.asarray(compact_feature_columns(feats_k, n_lm, cells, dims))
    std = np.empty_like(compact)
    std[:, compact_to_standard_rows(n_lm, cells, dims)] = compact
    return std


def level_inputs(det, frames, boxes, seed):
    """Window origins and, per level, rows in window coordinates: the
    aligned mean moved by up to 2 px, another draw at each level."""
    model = det.model
    n_lm = len(model.landmark_ids)
    oy, ox, window = det.aligned_origins(frames, boxes)
    rng = np.random.default_rng(seed)
    base = align_mean(model.mean[None], boxes) - rows_shift(
        ox.float(), oy.float(), n_lm)
    rows = [base + torch.from_numpy(
        rng.uniform(-2, 2, tuple(base.shape)).astype(np.float32))
        for _ in det.levels]
    return oy, ox, window, rows


def frame_windows(frames, oy, ox, window):
    ry, rx = window
    return torch.stack([frames[i, y:y + ry, x:x + rx] for i, (y, x) in
                        enumerate(zip(oy.tolist(), ox.tolist()))])


def compare(got, ref, label):
    diff = np.abs(got - ref)
    print(f"{label}: max abs {diff.max():.3e}, exactly equal "
          f"{100 * (diff == 0).mean():.2f}% of {diff.size} entries")
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n_lm,cells", [(6, 3), (29, 5)])
def test_tiny_twins_match_jax_at_every_level(n_lm, cells):
    _, pm = tiny_pair(n_lm, 2, hog_cells=cells)
    frames_np, boxes_np = frames_and_boxes(seed=n_lm, n=3)
    frames, boxes = torch.from_numpy(frames_np), torch.from_numpy(boxes_np)
    det = pm.make_fused_detector(roi=128)
    oy, ox, window, rows = level_inputs(det, frames, boxes, seed=n_lm)
    idx = torch.arange(len(frames_np), dtype=torch.int32)
    windows = frame_windows(frames, oy, ox, window)
    eyes = (det.r_idx, det.l_idx)
    f = n_lm * 16 * cells * cells + 1
    for li, (level, x) in enumerate(zip(det.levels, rows)):
        cs = det.cell_sizes[li]
        ref5 = to_reference_order(jax_k5(
            jnp.asarray(frames_np), jnp.asarray(idx.numpy()),
            jnp.asarray(oy.numpy()), jnp.asarray(ox.numpy()),
            jnp.asarray(x.numpy()), window, level, cs, 4, 16, *eyes),
            n_lm, cells)
        got5 = extract_features_fused_frames(
            frames, idx, oy, ox, x, window, level, cs, 4, 16, *eyes).numpy()
        assert got5.shape == ref5.shape == (3, f)
        assert (got5[:, -1] == 1).all() and got5.dtype == np.float32
        compare(got5, ref5, f"K5 {n_lm} landmarks level {li}")
        ref6 = to_reference_order(jax_k6(
            jnp.asarray(windows.numpy()), jnp.asarray(x.numpy()), level, cs,
            4, 16, *eyes), n_lm, cells)
        got6 = extract_features_fused(windows, x, level, cs, 4, 16,
                                      *eyes).numpy()
        compare(got6, ref6, f"K6 {n_lm} landmarks level {li}")
        # the two sources hold the same pixels: the same rows
        np.testing.assert_array_equal(got5, got6)
    assert float(np.abs(got5[:, :-1]).max()) > 0.1


@pytest.fixture(scope="module")
def rcr22():
    model = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"), device="cpu")
    files = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))[:2]
    images = [load_gray_image(f) for f in files]
    boxes = np.array([gt_facebox(read_pts_landmarks(f[:-4] + ".pts")
                                 .filter(model.landmark_ids))
                      for f in files], np.float32)
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    det = model.make_fused_detector(roi=512)
    frames, tb = torch.from_numpy(stack), torch.from_numpy(boxes)
    oy, ox, window, rows = level_inputs(det, frames, tb, seed=22)
    return dict(model=model, det=det, frames=frames, stack=stack, oy=oy,
                ox=ox, window=window, rows=rows,
                idx=torch.arange(2, dtype=torch.int32))


def test_rcr22_width_frames_twin_matches_jax(rcr22):
    # the full 8,801-wide row, one level (interpret mode is slow)
    c = rcr22
    det, li = c["det"], 1
    level, cs, x = det.levels[li], det.cell_sizes[li], c["rows"][li]
    ref = to_reference_order(jax_k5(
        jnp.asarray(c["stack"]), jnp.asarray(c["idx"].numpy()),
        jnp.asarray(c["oy"].numpy()), jnp.asarray(c["ox"].numpy()),
        jnp.asarray(x.numpy()), c["window"], level, cs, 4, 16, det.r_idx,
        det.l_idx), 22, 5)
    got = extract_features_fused_frames(
        c["frames"], c["idx"], c["oy"], c["ox"], x, c["window"], level, cs,
        4, 16, det.r_idx, det.l_idx).numpy()
    assert got.shape == ref.shape == (2, 8801)
    compare(got, ref, "K5 RCR-22 level 1")
    assert 0.05 < float(got[:, :-1].mean()) < 0.4


@pytest.mark.parametrize("li", [0, 3])
def test_rows_close_to_the_window_backend_fast_class(rcr22, li):
    c = rcr22
    det, model = c["det"], c["model"]
    level, cs, x = det.levels[li], det.cell_sizes[li], c["rows"][li]
    fused = extract_features_fused_frames(
        c["frames"], c["idx"], c["oy"], c["ox"], x, c["window"], level, cs,
        4, 16, det.r_idx, det.l_idx)
    windows = frame_windows(c["frames"], c["oy"], c["ox"], c["window"])
    sub = [0] * len(det.levels)
    sub_x = list(sub)
    sub[li], sub_x[li] = level[1], level[2]
    window_rows = HogTransform(
        windows, model.hog_params, model.landmark_ids, model.right_eye_ids,
        model.left_eye_ids, backend="window", sampling="fast",
        sub_windows=sub, sub_windows_x=sub_x)(x, li)
    diff = (fused - window_rows).abs()
    print(f"fused vs window backend, level {li}: max {float(diff.max()):.3e}"
          f" (tolerance {WINDOW_ATOL})")
    assert float(diff.max()) <= WINDOW_ATOL


def test_out_of_range_samples_get_nan_rows(rcr22):
    c = rcr22
    det = c["det"]
    args = (c["window"], det.levels[3], det.cell_sizes[3], 4, 16, det.r_idx,
            det.l_idx)
    x = c["rows"][3]
    good = extract_features_fused_frames(c["frames"], c["idx"], c["oy"],
                                         c["ox"], x, *args)
    assert bool(torch.isfinite(good).all())
    for bad in (dict(idx=torch.tensor([0, 2], dtype=torch.int32)),
                dict(idx=torch.tensor([0, -1], dtype=torch.int32)),
                dict(oy=torch.tensor([int(c["oy"][0]), 1024],
                                     dtype=torch.int32)),
                dict(ox=torch.tensor([int(c["ox"][0]), -128],
                                     dtype=torch.int32))):
        given = dict(idx=c["idx"], oy=c["oy"], ox=c["ox"])
        given.update(bad)
        rows = extract_features_fused_frames(
            c["frames"], given["idx"], given["oy"], given["ox"], x, *args)
        assert bool(torch.isnan(rows[1]).all())
        torch.testing.assert_close(rows[0], good[0], rtol=0, atol=0)


def test_empty_batch_gives_empty_rows(rcr22):
    c = rcr22
    det = c["det"]
    tail = (det.levels[0], det.cell_sizes[0], 4, 16, det.r_idx, det.l_idx)
    empty = torch.zeros((0,), dtype=torch.int32)
    x = torch.zeros((0, 44))
    rows = extract_features_fused_frames(c["frames"], empty, empty, empty, x,
                                         c["window"], *tail)
    assert rows.shape == (0, 8801) and rows.dtype == torch.float32
    rows = extract_features_fused(
        torch.zeros((0, 544, 640), dtype=torch.bfloat16), x, *tail)
    assert rows.shape == (0, 8801)
    for twin_rows in (
            extract_features_fused_reference(
                torch.zeros((0, 544, 640)), x, det.levels[0],
                det.cell_sizes[0], det.r_idx, det.l_idx),
            extract_features_fused_frames_reference(
                c["frames"], empty, empty, empty, x, c["window"],
                det.levels[0], det.cell_sizes[0], det.r_idx, det.l_idx)):
        assert twin_rows.shape == (0, 8801)


def test_op_named_errors(rcr22):
    c = rcr22
    det = c["det"]
    x = c["rows"][0]
    base = (c["idx"], c["oy"], c["ox"], x, c["window"], det.levels[0],
            det.cell_sizes[0])
    eyes = (det.r_idx, det.l_idx)
    with pytest.raises(ValueError, match="uint8"):
        extract_features_fused_frames(c["frames"].float(), *base, 4, 16,
                                      *eyes)
    with pytest.raises(ValueError, match="num_orientations=4"):
        extract_features_fused_frames(c["frames"], *base, 9, 36, *eyes)
    with pytest.raises(ValueError, match="exceeds"):
        extract_features_fused_frames(c["frames"], *base[:4], (2048, 640),
                                      *base[5:], 4, 16, *eyes)
    with pytest.raises(ValueError, match="row sub-window"):
        extract_features_fused_frames(
            c["frames"], *base[:5], (55, 100, 640, 1.0), 11, 4, 16, *eyes)
    with pytest.raises(ValueError, match="eye indices"):
        extract_features_fused_frames(c["frames"], *base, 4, 16, (), (1,))
    with pytest.raises(ValueError, match=r"\(N, RY, RX\)"):
        extract_features_fused(torch.zeros((3, 544, 640)), x, det.levels[0],
                               det.cell_sizes[0], 4, 16, *eyes)


def test_hog_transform_fused_named_errors(rcr22):
    c = rcr22
    m = c["model"]
    ids = (m.landmark_ids, m.right_eye_ids, m.left_eye_ids)

    def make(params=m.hog_params, images=c["frames"], **kw):
        return HogTransform(images, params, *ids, backend="fused", **kw)

    with pytest.raises(ValueError, match="always quantizes"):
        make(quantize=False)
    mixed = tuple(dataclasses.replace(p, num_cells=4) if i == 1 else p
                  for i, p in enumerate(m.hog_params))
    with pytest.raises(ValueError, match="uniform"):
        make(params=mixed)
    with pytest.raises(ValueError, match="Uoctti"):
        make(params=tuple(dataclasses.replace(
            p, variant=HogVariant.DalalTriggs) for p in m.hog_params))
    table = (c["idx"], c["oy"], c["ox"])
    with pytest.raises(ValueError, match="requires frame_window"):
        make(frame_table=table)
    with pytest.raises(ValueError, match="uint8 frame stack"):
        make(images=c["frames"].float(), frame_table=table,
             frame_window=c["window"])
    with pytest.raises(ValueError, match="requires the fused backend"):
        HogTransform(c["frames"], m.hog_params, *ids, backend="window",
                     frame_table=table, frame_window=c["window"])
    with pytest.raises(ValueError, match="unknown feature backend"):
        HogTransform(c["frames"], m.hog_params, *ids, backend="sparse")
    hog = make(frame_table=table, frame_window=c["window"])
    assert hog.feature_dim() == hog.feature_dim(3) == 8801


def test_hog_transform_frames_table_and_chunks(rcr22):
    # samples map to faces through image_indices; chunking changes nothing
    c = rcr22
    m, det = c["model"], c["det"]
    ids = (m.landmark_ids, m.right_eye_ids, m.left_eye_ids)
    sample_to_face = torch.tensor([1, 0, 1])
    x = c["rows"][3][sample_to_face]
    sub = tuple(lv[1] for lv in det.levels)
    sub_x = tuple(lv[2] for lv in det.levels)
    kw = dict(backend="fused", sub_windows=sub, sub_windows_x=sub_x,
              image_indices=sample_to_face)
    frames_rows = HogTransform(
        c["frames"], m.hog_params, *ids, frame_table=(c["idx"], c["oy"],
                                                      c["ox"]),
        frame_window=c["window"], **kw)(x, 3)
    direct = extract_features_fused_frames(
        c["frames"], c["idx"][sample_to_face], c["oy"][sample_to_face],
        c["ox"][sample_to_face], x, c["window"], det.levels[3],
        det.cell_sizes[3], 4, 16, det.r_idx, det.l_idx)
    torch.testing.assert_close(frames_rows, direct, rtol=0, atol=0)
    windows = frame_windows(c["frames"], c["oy"], c["ox"], c["window"])
    whole = HogTransform(windows, m.hog_params, *ids, **kw)(x, 3)
    chunked = HogTransform(windows, m.hog_params, *ids, chunk_size=2,
                           **kw)(x, 3)
    torch.testing.assert_close(whole, frames_rows, rtol=0, atol=0)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    for backend in ("window", "gather"):
        kw_b = dict(kw, backend=backend)
        if backend == "gather":
            kw_b.pop("sub_windows"), kw_b.pop("sub_windows_x")
        a = HogTransform(windows, m.hog_params, *ids, **kw_b)(x, 3)
        b = HogTransform(windows, m.hog_params, *ids, chunk_size=2,
                         **kw_b)(x, 3)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert a.shape == (3, 8801)
