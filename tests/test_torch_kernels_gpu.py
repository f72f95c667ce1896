"""K1-K6 and the probe kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips unless a CUDA device is present (decided
inside the fixture, never at import). On the card:
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu``
(the repository's conftest imports JAX, which the card's machine lacks).
"""

import os
import re

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.ops.hog_flat import (
    hog_descriptor_flat, hog_descriptor_flat_reference)
from superviseddescent_tpu_torch.ops.patches_window import (
    _prepare, sample_patches_window, sample_patches_window_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("fast,transposed", [(False, False), (True, False),
                                             (True, True)])
@pytest.mark.parametrize("s,cs", [(55, 11), (50, 10), (40, 8), (30, 6)])
def test_hog_kernel_matches_twin(cuda, s, cs, fast, transposed):
    rng = np.random.default_rng(s)
    patches = torch.from_numpy(rng.integers(0, 256, size=(300, s * s))
                               .astype(np.float32)).to(cuda)
    if fast and transposed:
        patches = patches.bfloat16()
    before = hog_descriptor_flat.launches
    got = hog_descriptor_flat(patches, s, cs, 4, HogVariant.Uoctti,
                              fast=fast, transposed=transposed)
    torch.cuda.synchronize()
    assert hog_descriptor_flat.launches == before + 1
    ref = hog_descriptor_flat_reference(patches, s, cs, 4, HogVariant.Uoctti,
                                        fast=fast, transposed=transposed)
    # same float32 operations, splat sums in another order
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_hog_kernel_dalaltriggs(cuda):
    rng = np.random.default_rng(1)
    patches = torch.from_numpy(rng.integers(0, 256, size=(40, 64 * 64))
                               .astype(np.float32)).to(cuda)
    got = hog_descriptor_flat(patches, 64, 8, 9, HogVariant.DalalTriggs)
    ref = hog_descriptor_flat_reference(patches, 64, 8, 9,
                                        HogVariant.DalalTriggs)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("sampling", ["exact", "fast"])
@pytest.mark.parametrize("window_dtype", [torch.uint8, torch.float32])
def test_window_kernel_equals_twin(cuda, window_dtype, sampling, transposed):
    rng = np.random.default_rng(0)
    n, ry, rx, l, s = 6, 64, 384, 7, 40
    wins = torch.from_numpy(rng.integers(0, 256, size=(n, ry, rx))
                            .astype(np.uint8)).to(cuda).to(window_dtype)
    cx = torch.from_numpy(rng.uniform(-4, rx + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    cy = torch.from_numpy(rng.uniform(-4, ry + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    phw = torch.from_numpy(rng.uniform(5, 30, (n,)).round()
                           .astype(np.float32)).to(cuda)
    for quantize in (False, True):
        kw = dict(sub_window=40, sub_window_x=256, quantize=quantize,
                  sampling=sampling, transposed=transposed)
        got = sample_patches_window(wins, cx, cy, phw, s, **kw)
        oxy, sp = _prepare(cx, cy, phw, s)
        ref = sample_patches_window_reference(
            wins, oxy, sp, s, 40, 256, quantize, sampling, transposed,
            torch.float32)
        # every float operation rounds as the twin's does: bit-equal
        torch.testing.assert_close(got, ref, rtol=0, atol=0)


# ------------------------------------------------------------------ #
# K1 and K2 at the stepped detector's level shapes (RCR-22, COFW-29 and
# ibug-68 share them), their edges, and their launch plans
# ------------------------------------------------------------------ #
LEVEL_SHAPES = [(55, 11), (50, 10), (40, 8), (30, 6)]
K1_RTOL, K1_ATOL = 1e-4, 1e-5   # chip_smoke.py's: splat sums in another order


def random_patches(cuda, b, s, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, size=(b, s * s))
                         .astype(np.float32)).to(cuda)
    return x.to(dtype)


def check_hog(patches, s, cs, o=4, variant=HogVariant.Uoctti, **kw):
    before = hog_descriptor_flat.launches
    got = hog_descriptor_flat(patches, s, cs, o, variant, **kw)
    torch.cuda.synchronize()
    assert hog_descriptor_flat.launches == before + (patches.shape[0] > 0)
    ref = hog_descriptor_flat_reference(patches, s, cs, o, variant, **kw)
    torch.testing.assert_close(got, ref, rtol=K1_RTOL, atol=K1_ATOL)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast,transposed", [(False, False), (False, True),
                                             (True, False), (True, True)])
@pytest.mark.parametrize("s,cs", LEVEL_SHAPES)
def test_hog_kernel_at_level_shapes(cuda, s, cs, fast, transposed, dtype):
    from superviseddescent_tpu_torch.ops.hog_flat import launch_plan
    # a batch that is not a multiple of the patches per block
    per_block = launch_plan(s, cs, 4, fast)
    b = 7 * per_block + 1 if per_block > 1 else 301
    check_hog(random_patches(cuda, b, s, dtype, seed=s), s, cs, fast=fast,
              transposed=transposed)


@pytest.mark.parametrize("s,cs,o,variant,b", [
    (3, 1, 4, HogVariant.Uoctti, 5), (3, 3, 4, HogVariant.Uoctti, 9),
    (96, 8, 4, HogVariant.Uoctti, 3), (96, 12, 16, HogVariant.Uoctti, 2),
    (16, 1, 4, HogVariant.Uoctti, 4), (24, 1, 9, HogVariant.DalalTriggs, 3),
    (64, 8, 9, HogVariant.DalalTriggs, 11), (55, 11, 4, HogVariant.Uoctti, 1),
    (30, 6, 4, HogVariant.Uoctti, 1)])
@pytest.mark.parametrize("transposed", [False, True])
def test_hog_kernel_edges(cuda, s, cs, o, variant, b, transposed):
    check_hog(random_patches(cuda, b, s, torch.float32, seed=b), s, cs, o,
              variant, transposed=transposed)


def test_hog_kernel_empty_batch(cuda):
    out = check_hog(random_patches(cuda, 0, 55, torch.float32), 55, 11)
    assert out.shape == (0, 16 * 25)


@pytest.mark.parametrize("fast,transposed", [(False, False), (True, True)])
@pytest.mark.parametrize("s,cs", LEVEL_SHAPES)
def test_hog_kernel_plans_agree(cuda, s, cs, fast, transposed):
    from superviseddescent_tpu_torch.ops import hog_flat
    from superviseddescent_tpu_torch.ops._build import load_library
    x = random_patches(cuda, 37, s,
                       torch.bfloat16 if transposed else torch.float32)
    outs = []
    for per_block in (1, 2, 3):
        out = torch.empty((37, 16 * hog_flat.hog_num_cells(s, cs) ** 2),
                          device=cuda)
        hog_flat._launch(load_library("hog_flat"), x, out, s, cs, 4,
                         HogVariant.Uoctti, fast, transposed, per_block)
        outs.append(out)
    torch.cuda.synchronize()
    for out in outs[1:]:
        # the splat sums run in one order for every plan
        assert torch.equal(out, outs[0])


def window_case(cuda, window_dtype, n=7, l=5, ry=64, rx=384, seed=0):
    rng = np.random.default_rng(seed)
    wins = torch.from_numpy(rng.integers(0, 256, size=(n, ry, rx))
                            .astype(np.uint8)).to(cuda).to(window_dtype)
    cx = torch.from_numpy(rng.uniform(-4, rx + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    cy = torch.from_numpy(rng.uniform(-4, ry + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    phw = torch.from_numpy(rng.uniform(5, 30, (n,)).round()
                           .astype(np.float32)).to(cuda)
    return wins, cx, cy, phw


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("sampling", ["exact", "fast"])
@pytest.mark.parametrize("window_dtype",
                         [torch.uint8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [55, 50, 40, 30])
def test_window_kernel_at_level_shapes(cuda, s, window_dtype, sampling,
                                       transposed, out_dtype):
    # 7 faces x 5 landmarks: the last block of every plan is ragged
    wins, cx, cy, phw = window_case(cuda, window_dtype, seed=s)
    for quantize in (False, True):
        kw = dict(sub_window=40, sub_window_x=256, quantize=quantize,
                  sampling=sampling, transposed=transposed,
                  out_dtype=out_dtype)
        before = sample_patches_window.launches
        got = sample_patches_window(wins, cx, cy, phw, s, **kw)
        torch.cuda.synchronize()
        assert sample_patches_window.launches == before + 1
        oxy, sp = _prepare(cx, cy, phw, s)
        ref = sample_patches_window_reference(
            wins, oxy, sp, s, 40, 256, quantize, sampling, transposed,
            out_dtype)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [55, 30, 96, 1])
def test_window_kernel_plans_agree(cuda, s, out_dtype, transposed):
    from superviseddescent_tpu_torch.ops import patches_window
    from superviseddescent_tpu_torch.ops._build import load_library
    wins, cx, cy, phw = window_case(cuda, torch.uint8, n=9, l=7, ry=160,
                                    rx=384, seed=s)
    oxy, sp = _prepare(cx, cy, phw, s)
    outs = []
    for per_block in (1, 2, 3, 5, 8, 16):
        if patches_window._shared_bytes(s, per_block, transposed,
                                        out_dtype.itemsize) > 200 * 1024:
            continue
        out = torch.empty((9, 7, s, s), dtype=out_dtype, device=cuda)
        patches_window._launch(load_library("patches_window"), wins, oxy, sp,
                               out, 160, 384, True, False, transposed,
                               per_block)
        outs.append(out)
    # through the entry point, whose plan is min(8, N*L): plans 1-8
    for k in range(1, 9):
        outs.append(sample_patches_window(
            wins[:k], cx[:k, :1], cy[:k, :1], phw[:k], s, 160, 384,
            quantize=True, sampling="exact", transposed=transposed,
            out_dtype=out_dtype))
    torch.cuda.synchronize()
    ref = sample_patches_window_reference(wins, oxy, sp, s, 160, 384, True,
                                          "exact", transposed, out_dtype)
    for out in outs:
        assert torch.equal(out, ref[:out.shape[0], :out.shape[1]])


# ------------------------------------------------------------------ #
# K3 / K4: the fused cascade against its plain twin
# ------------------------------------------------------------------ #
LEVEL_PX = 1e-3     # one level from equal rows: only the GEMV sums differ
WHOLE_PX = 0.02     # whole cascade: a centre may round the other way
WHOLE_MAX_PX = 0.75


def random_model(cuda, num_landmarks, levels, cells, seed=0, scale=0.02):
    """An RCR model with random regressors (numpy, seeded) on the card."""
    from superviseddescent_tpu_torch.core.cascade import (
        SupervisedDescentOptimiser)
    from superviseddescent_tpu_torch.core.regressor import LinearRegressor
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, HogParams, InterEyeDistanceNormalisation)
    rng = np.random.default_rng(seed)
    names = [str(i + 1) for i in range(num_landmarks)]
    params = tuple(HogParams(HogVariant.Uoctti, cells, 4, 4, 0.8)
                   for _ in range(levels))
    f = num_landmarks * cells * cells * 16 + 1
    regs = [LinearRegressor(torch.from_numpy(
        (rng.normal(size=(f, 2 * num_landmarks)) * scale).astype(np.float32)))
        for _ in range(levels)]
    mean = rng.uniform(-0.35, 0.35, 2 * num_landmarks).astype(np.float32)
    mean[0], mean[1] = -0.15, 0.15
    norm = InterEyeDistanceNormalisation(names, ["1"], ["2"])
    return DetectionModel(SupervisedDescentOptimiser(regs, norm), mean, names,
                          params, ["1"], ["2"], device=cuda)


def check_fused_against_twin(det, frames, boxes, idx=None):
    """K3 (uint8 frames) and K4 (float32 frames) against their twins: per
    level from the twin's own rows, then the whole cascade."""
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames,
        detect_cascade_fused_frames_reference, detect_cascade_fused_reference,
        prepare_weights)
    m = det.model
    n_lm = len(m.landmark_ids)
    n = boxes.shape[0]
    idx = torch.arange(n, device=frames.device, dtype=torch.int32) \
        if idx is None else idx
    eyes = (det.r_idx, det.l_idx)
    q = dict(quantize=det.quantize)
    x_img = align_mean(m.mean[None], boxes)
    oy, ox, window = det.aligned_origins(frames, boxes)
    x_k3 = x_img - rows_shift(ox.float(), oy.float(), n_lm)
    windows, wox, woy = det.crop(frames.float(), boxes, idx)
    x_k4 = x_img - rows_shift(wox, woy, n_lm)
    for li, level in enumerate(det.levels):
        w1 = prepare_weights([m.sdo.regressors[li].weights])
        one = ((level,), (det.cell_sizes[li],))
        before = detect_cascade_fused_frames.launches
        got = detect_cascade_fused_frames(frames, idx, oy, ox, x_k3, w1,
                                          window, *one, 4, 16, *eyes, **q)
        assert detect_cascade_fused_frames.launches == before + 1
        ref = detect_cascade_fused_frames_reference(frames, idx, oy, ox,
                                                    x_k3, w1, window, *one,
                                                    *eyes, **q)
        assert float((got - ref).abs().max()) <= LEVEL_PX
        got4 = detect_cascade_fused(windows, x_k4, w1, *one, 4, 16, *eyes,
                                    **q)
        ref4 = detect_cascade_fused_reference(windows, x_k4, w1, *one, *eyes,
                                              **q)
        assert float((got4 - ref4).abs().max()) <= LEVEL_PX
        x_k3, x_k4 = ref, ref4
    weights = det.weights
    for got, ref in (
            (detect_cascade_fused_frames(
                frames, idx, oy, ox, x_img - rows_shift(
                    ox.float(), oy.float(), n_lm), weights, window,
                det.levels, det.cell_sizes, 4, 16, *eyes, **q),
             detect_cascade_fused_frames_reference(
                 frames, idx, oy, ox, x_img - rows_shift(
                     ox.float(), oy.float(), n_lm), weights, window,
                 det.levels, det.cell_sizes, *eyes, **q)),
            (detect_cascade_fused(windows, x_img - rows_shift(wox, woy, n_lm),
                                  weights, det.levels, det.cell_sizes, 4, 16,
                                  *eyes, **q),
             detect_cascade_fused_reference(
                 windows, x_img - rows_shift(wox, woy, n_lm), weights,
                 det.levels, det.cell_sizes, *eyes, **q))):
        per_face = (got - ref).abs().amax(dim=1)
        assert bool(torch.isfinite(got).all())
        assert float(per_face.max()) <= WHOLE_MAX_PX
        # at most 0.1% of the faces (rounded up) beyond the fast-class bound
        assert int((per_face > WHOLE_PX).sum()) <= -(-n // 1000)


@pytest.mark.parametrize("num_landmarks,cells,levels,quantize",
                         [(6, 3, 2, True), (29, 5, 2, True), (6, 3, 5, True),
                          (6, 3, 2, False)])
def test_fused_kernels_match_twin_tiny(cuda, num_landmarks, cells, levels,
                                       quantize):
    rng = np.random.default_rng(num_landmarks)
    model = random_model(cuda, num_landmarks, levels, cells)
    # 128 columns: the frames path's window is the full width (see
    # tests/test_torch_fused_small.py::frames_and_boxes)
    frames = torch.from_numpy(rng.integers(0, 256, size=(6, 192, 128))
                              .astype(np.uint8)).to(cuda)
    boxes = torch.from_numpy(np.column_stack([
        rng.uniform(0, 48, 6), rng.uniform(0, 110, 6),
        np.full(6, 80.0), np.full(6, 80.0)]).astype(np.float32)).to(cuda)
    check_fused_against_twin(
        model.make_fused_detector(roi=128, quantize=quantize), frames, boxes)


# K3 / K4's launch plans (launch_plan) on a card of `sms` SMs: a batch of
# each, and the (faces per block, landmarks per group, threads) it takes
def plan_batches(sms):
    return {"one face, 1,024 threads": (1, (1, None, 1024)),
            "one face, four landmarks": (sms + 5, (1, 4, 256)),
            "one face, two landmarks": (3 * sms + 5, (1, 2, 256)),
            "two faces, two landmarks": (4 * sms + 1, (2, 2, 256)),
            "two faces, odd batch": (6 * sms + 1, (2, 1, 256))}


def batch_for(cuda, label):
    """The batch of plan_batches' ``label`` on this card, after checking
    that launch_plan gives it that plan."""
    from superviseddescent_tpu_torch.ops.cascade_fused import launch_plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n, (faces, group, threads) = plan_batches(sms)[label]
    plan = launch_plan(n, 22, 5, 55, True, sms)
    assert (plan.faces, plan.threads) == (faces, threads)
    assert group is None or plan.group == group
    return n


@pytest.fixture(scope="module")
def rcr22_faces():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import glob
    import os
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, gt_facebox)
    from superviseddescent_tpu_torch.ops.patches import (
        load_gray_image, stack_images)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = DetectionModel.load(
        os.path.join(repo, "pretrained", "rcr22_lfpw5.bin"), device="cuda")
    files = sorted(glob.glob(os.path.join(repo, ".synth120", "*.png")))[:16]
    images = [load_gray_image(f) for f in files]
    boxes = np.array([gt_facebox(read_pts_landmarks(f[:-4] + ".pts")
                                 .filter(model.landmark_ids))
                      for f in files], np.float32)
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    # enough faces for every launch plan: the largest batch of
    # plan_batches takes two faces per block and is odd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sel = np.arange(max(n for n, _ in plan_batches(sms).values())) \
        % len(files)
    return (model, torch.from_numpy(stack).cuda(),
            torch.from_numpy(boxes[sel]).cuda(),
            torch.from_numpy(sel.astype(np.int32)).cuda())


@pytest.mark.parametrize("label", list(plan_batches(132)))
def test_fused_kernels_match_twin_rcr22(cuda, rcr22_faces, label):
    model, stack, boxes, idx = rcr22_faces
    n = batch_for(cuda, label)
    det = model.make_fused_detector(roi=512)
    check_fused_against_twin(det, stack, boxes[:n], idx[:n])


@pytest.mark.parametrize("crop", [False, True])
def test_fused_launch_plans_agree(cuda, rcr22_faces, crop):
    """A face's rows are the same bits whatever batch it comes in, and so
    whatever launch plan runs it: the entry point's rows of the first n
    faces at each batch of plan_batches equal those of the whole batch
    (K3 on the uint8 stack; with crop, K4 on a float32 stack)."""
    model, stack, boxes, idx = rcr22_faces
    det = model.make_fused_detector(roi=512)
    images = stack.float() if crop else stack
    whole = det(images, boxes, image_indices=idx)
    for label in plan_batches(132):
        n = batch_for(cuda, label)
        rows = det(images, boxes[:n], image_indices=idx[:n])
        assert torch.equal(rows, whole[:n]), label


@pytest.mark.parametrize("label", ["one face, 1,024 threads",
                                   "two faces, odd batch"])
def test_fused_out_of_range_cuda_index_gives_nan_row(cuda, rcr22_faces,
                                                     label):
    # with two faces per block, faces 3 and 7 share theirs with good faces
    model, stack, boxes, idx = rcr22_faces
    n = max(64, batch_for(cuda, label))
    boxes, idx = boxes[:n], idx[:n]
    det = model.make_fused_detector(roi=512)
    good = det(stack, boxes, image_indices=idx)
    bad_idx = idx.clone()
    bad_idx[3] = stack.shape[0]
    bad_idx[7] = -1
    for images in (stack, stack.float()):  # K3, then the crop path to K4
        rows = det(images, boxes, image_indices=bad_idx)
        assert bool(torch.isnan(rows[[3, 7]]).all())
        keep = torch.ones(len(idx), dtype=torch.bool, device=cuda)
        keep[[3, 7]] = False
        assert bool(torch.isfinite(rows[keep]).all())
        if images.dtype == torch.uint8:
            torch.testing.assert_close(rows[keep], good[keep], rtol=0,
                                       atol=0)


def test_fused_empty_batch_launches_nothing(cuda, rcr22_faces):
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused_frames)
    model, stack, boxes, idx = rcr22_faces
    det = model.make_fused_detector(roi=512)
    before = detect_cascade_fused_frames.launches
    rows = det(stack, boxes[:0], image_indices=idx[:0])
    assert rows.shape == (0, 44)
    assert detect_cascade_fused_frames.launches == before


# ------------------------------------------------------------------ #
# K5 / K6: the fused feature extractors against their plain twins
# ------------------------------------------------------------------ #
# the same float32 operations in the same order as the twin: equal, up to
# a last-bit difference in a block factor (1e-6 on values below 0.5)
FEATURES_ATOL = 1e-6


def check_features_against_twin(det, frames, boxes, idx=None):
    """K5 (uint8 frames) and K6 (bf16 windows) against their twins at every
    level, from the aligned mean and from rows moved by a few pixels."""
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused, extract_features_fused_frames,
        extract_features_fused_frames_reference,
        extract_features_fused_reference)
    m = det.model
    n_lm = len(m.landmark_ids)
    n = boxes.shape[0]
    idx = torch.arange(n, device=frames.device, dtype=torch.int32) \
        if idx is None else idx
    eyes = (det.r_idx, det.l_idx)
    gen = torch.Generator().manual_seed(0)
    jitter = (torch.rand((n, 2 * n_lm), generator=gen) * 6 - 3).to(
        frames.device)
    x_img = align_mean(m.mean[None], boxes) + jitter
    oy, ox, window = det.aligned_origins(frames, boxes)
    x_k5 = x_img - rows_shift(ox.float(), oy.float(), n_lm)
    windows, wox, woy = det.crop(frames.float(), boxes, idx)
    x_k6 = x_img - rows_shift(wox, woy, n_lm)
    for li, level in enumerate(det.levels):
        cs = det.cell_sizes[li]
        before = extract_features_fused_frames.launches
        got = extract_features_fused_frames(frames, idx, oy, ox, x_k5, window,
                                            level, cs, 4, 16, *eyes)
        assert extract_features_fused_frames.launches == before + 1
        ref = extract_features_fused_frames_reference(
            frames, idx, oy, ox, x_k5, window, level, cs, *eyes)
        assert got.shape == ref.shape == (n, det.weights.num_features)
        assert bool((got[:, -1] == 1).all())
        assert float((got - ref).abs().max()) <= FEATURES_ATOL
        before = extract_features_fused.launches
        got6 = extract_features_fused(windows, x_k6, level, cs, 4, 16, *eyes)
        assert extract_features_fused.launches == before + 1
        ref6 = extract_features_fused_reference(windows, x_k6, level, cs,
                                                *eyes)
        assert float((got6 - ref6).abs().max()) <= FEATURES_ATOL
        assert float(got.abs().max()) > 0.05


@pytest.mark.parametrize("num_landmarks,cells", [(6, 3), (29, 5)])
def test_features_kernels_match_twin_tiny(cuda, num_landmarks, cells):
    rng = np.random.default_rng(num_landmarks)
    model = random_model(cuda, num_landmarks, 2, cells)
    frames = torch.from_numpy(rng.integers(0, 256, size=(6, 192, 128))
                              .astype(np.uint8)).to(cuda)
    boxes = torch.from_numpy(np.column_stack([
        rng.uniform(0, 48, 6), rng.uniform(0, 110, 6),
        np.full(6, 80.0), np.full(6, 80.0)]).astype(np.float32)).to(cuda)
    check_features_against_twin(model.make_fused_detector(roi=128), frames,
                                boxes)


def test_features_kernels_match_twin_rcr22(cuda, rcr22_faces):
    model, stack, boxes, idx = rcr22_faces
    check_features_against_twin(model.make_fused_detector(roi=512), stack,
                                boxes, idx)


def test_features_out_of_range_index_gives_nan_row_and_empty(cuda,
                                                             rcr22_faces):
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused_frames)
    model, stack, boxes, idx = rcr22_faces
    det = model.make_fused_detector(roi=512)
    oy, ox, window = det.aligned_origins(stack, boxes)
    x = align_mean(model.mean[None], boxes) - rows_shift(
        ox.float(), oy.float(), 22)
    args = (window, det.levels[0], det.cell_sizes[0], 4, 16, det.r_idx,
            det.l_idx)
    good = extract_features_fused_frames(stack, idx, oy, ox, x, *args)
    bad_idx = idx.clone()
    bad_idx[3] = stack.shape[0]
    bad_oy = oy.clone()
    bad_oy[7] = stack.shape[1]
    rows = extract_features_fused_frames(stack, bad_idx, bad_oy, ox, x, *args)
    assert bool(torch.isnan(rows[[3, 7]]).all())
    keep = torch.ones(len(idx), dtype=torch.bool, device=cuda)
    keep[[3, 7]] = False
    torch.testing.assert_close(rows[keep], good[keep], rtol=0, atol=0)
    before = extract_features_fused_frames.launches
    empty = extract_features_fused_frames(stack, idx[:0], oy[:0], ox[:0],
                                          x[:0], *args)
    assert empty.shape == (0, 8801)
    assert extract_features_fused_frames.launches == before


# K5 / K6 launch plans (samples per block, landmarks per group, threads):
# every block size, one and several samples per block, groups that leave
# RCR-22's last group ragged, and features_launch_plan's
FEATURE_PLANS = (None, (1, 1, 128), (1, 4, 128), (1, 5, 256), (1, 7, 256),
                 (2, 3, 256), (3, 2, 128), (1, 22, 256))


def features_plan_case(cuda, model, stack, boxes, idx, n, spread=1.0,
                       jitter_px=3.0):
    """n samples (the faces repeated) of a family at every level: the K5
    arguments (frames, indices, origins, rows, window) and K6's (bf16
    windows, rows), per level. The rows are the aligned mean, spread about
    each face's centre by ``spread`` and moved by up to ``jitter_px``."""
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    sel = torch.arange(n, device=cuda) % boxes.shape[0]
    boxes, idx = boxes[sel], idx[sel]
    det = model.make_fused_detector(roi=512)
    n_lm = len(model.landmark_ids)
    rng = np.random.default_rng(n)
    jitter = torch.from_numpy(rng.uniform(-jitter_px, jitter_px,
                                          (n, 2 * n_lm)).astype(
        np.float32)).to(cuda)
    mean = align_mean(model.mean[None], boxes)
    centre = torch.cat([mean[:, :n_lm].mean(1, keepdim=True).expand(-1, n_lm),
                        mean[:, n_lm:].mean(1, keepdim=True).expand(-1, n_lm)],
                       dim=1)
    x_img = centre + spread * (mean - centre) + jitter
    oy, ox, window = det.aligned_origins(stack, boxes)
    windows, wox, woy = det.crop(stack.float(), boxes, idx)
    return (det, (stack, idx, oy, ox,
                  x_img - rows_shift(ox.float(), oy.float(), n_lm), window),
            (windows, x_img - rows_shift(wox, woy, n_lm)))


def features_at_plan(frames_args, windows_args, level, cs, eyes, plan):
    """K5 and K6 at ``plan`` through the entry point's library (these
    launches do not count)."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _check_level, _features_launch_args, _launch_features,
        _launch_features_frames)
    lib = load_library("features_fused")
    frames, idx, oy, ox, x, window = frames_args
    lv, c, f = _check_level(x.shape[1] // 2, *window, level, cs, 4, 16,
                            *eyes)
    out5, args = _features_launch_args(x, lv, cs, *eyes, *window, c, f,
                                       plan)
    _launch_features_frames(lib, frames, idx, oy, ox, args)
    windows, x6 = windows_args
    lv6, _, _ = _check_level(x.shape[1] // 2, *windows.shape[1:], level, cs,
                             4, 16, *eyes)
    out6, args = _features_launch_args(x6, lv6, cs, *eyes,
                                       *windows.shape[1:], c, f, plan)
    _launch_features(lib, windows, args)
    return out5, out6


@pytest.mark.parametrize("n", [1, 3, 5, 4099])
def test_features_kernels_every_plan(cuda, rcr22_faces, n):
    """K5 and K6 against their twins at every launch plan and level, at
    batches whose rows start off 16-byte boundaries (the row width 8,801 is
    odd) and that leave the last block of a many-sample plan part empty:
    the same bits for every plan."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused_frames_reference,
        extract_features_fused_reference)
    model, stack, boxes, idx = rcr22_faces
    det, frames_args, windows_args = features_plan_case(
        cuda, model, stack, boxes, idx, n)
    eyes = (det.r_idx, det.l_idx)
    for li, level in enumerate(det.levels):
        cs = det.cell_sizes[li]
        ref5 = extract_features_fused_frames_reference(
            *frames_args, level, cs, *eyes)
        ref6 = extract_features_fused_reference(*windows_args, level, cs,
                                                *eyes)
        first = None
        for plan in FEATURE_PLANS:
            got5, got6 = features_at_plan(frames_args, windows_args, level,
                                          cs, eyes, plan)
            assert float((got5 - ref5).abs().max()) <= FEATURES_ATOL, plan
            assert float((got6 - ref6).abs().max()) <= FEATURES_ATOL, plan
            assert bool((got5[:, -1] == 1).all())
            if first is None:
                first = got5
            assert torch.equal(got5, first), plan


@pytest.mark.parametrize("spread,jitter_px", [(0.4, 3.0), (1.8, 40.0)])
def test_features_kernels_where_taps_leave_the_sub_window(
        cuda, rcr22_faces, spread, jitter_px):
    """Landmarks drawn together (patches narrower than their side, output
    rows sharing source rows) or spread out and moved by up to 40 px
    (patches that reach past their sub-windows, whose outer taps have
    weight 0 and are moved inside with their weights): K5 and K6 equal
    their twins at every level and plan."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused_frames_reference,
        extract_features_fused_reference)
    model, stack, boxes, idx = rcr22_faces
    det, frames_args, windows_args = features_plan_case(
        cuda, model, stack, boxes, idx, 64, spread, jitter_px)
    eyes = (det.r_idx, det.l_idx)
    for li, level in enumerate(det.levels):
        cs = det.cell_sizes[li]
        ref5 = extract_features_fused_frames_reference(
            *frames_args, level, cs, *eyes)
        ref6 = extract_features_fused_reference(*windows_args, level, cs,
                                                *eyes)
        for plan in (None, (1, 4, 128), (2, 3, 256)):
            got5, got6 = features_at_plan(frames_args, windows_args, level,
                                          cs, eyes, plan)
            assert float((got5 - ref5).abs().max()) <= FEATURES_ATOL, \
                (li, plan)
            assert float((got6 - ref6).abs().max()) <= FEATURES_ATOL, \
                (li, plan)


def test_features_kernels_68_landmarks_ragged_group(cuda, rcr22_faces):
    """ibug-68 (27,201 features) at the entry point's plan and at two whose
    last landmark group is ragged (68 = 13 x 5 + 3 = 22 x 3 + 2)."""
    import os
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused_frames_reference,
        extract_features_fused_reference)
    _, stack, boxes, idx = rcr22_faces
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = DetectionModel.load(
        os.path.join(repo, "pretrained", "rcr68_lfpw5.bin"), device="cuda")
    n = 37
    det, frames_args, windows_args = features_plan_case(
        cuda, model, stack, boxes, idx, n)
    eyes = (det.r_idx, det.l_idx)
    for li, level in enumerate(det.levels):
        cs = det.cell_sizes[li]
        ref5 = extract_features_fused_frames_reference(
            *frames_args, level, cs, *eyes)
        ref6 = extract_features_fused_reference(*windows_args, level, cs,
                                                *eyes)
        assert ref5.shape == (n, 27201)
        for plan in (None, (1, 5, 256), (2, 3, 256)):
            got5, got6 = features_at_plan(frames_args, windows_args, level,
                                          cs, eyes, plan)
            assert float((got5 - ref5).abs().max()) <= FEATURES_ATOL, plan
            assert float((got6 - ref6).abs().max()) <= FEATURES_ATOL, plan


@pytest.mark.parametrize("plan", [None, (2, 3, 256), (3, 2, 128)])
def test_features_nan_rows_share_blocks_with_good_ones(cuda, rcr22_faces,
                                                       plan):
    """Samples whose frame index or origin lies outside the stack get rows
    of NaN, bias included, beside good samples of the same block; N = 0
    launches nothing."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused_frames)
    model, stack, boxes, idx = rcr22_faces
    det, frames_args, windows_args = features_plan_case(
        cuda, model, stack, boxes, idx, 12)
    frames, idx, oy, ox, x, window = frames_args
    eyes = (det.r_idx, det.l_idx)
    level, cs = det.levels[0], det.cell_sizes[0]
    good, _ = features_at_plan(frames_args, windows_args, level, cs, eyes,
                               plan)
    bad_idx, bad_ox = idx.clone(), ox.clone()
    bad_idx[4] = stack.shape[0]
    bad_ox[7] = -128
    rows, _ = features_at_plan((frames, bad_idx, oy, bad_ox, x, window),
                               windows_args, level, cs, eyes, plan)
    assert bool(torch.isnan(rows[[4, 7]]).all())
    keep = torch.ones(12, dtype=torch.bool, device=cuda)
    keep[[4, 7]] = False
    assert torch.equal(rows[keep], good[keep])
    before = extract_features_fused_frames.launches
    empty = extract_features_fused_frames(frames, idx[:0], oy[:0], ox[:0],
                                          x[:0], window, level, cs, 4, 16,
                                          *eyes)
    assert empty.shape == (0, 8801)
    assert extract_features_fused_frames.launches == before


def test_features_whole_number_square_root_is_sqrtf(cuda):
    """K5 / K6's gradient magnitude takes sqrtf's fast path without its
    range check: the same bits as sqrtf for every squared gradient length
    a uint8 patch gives (whole numbers from 1 to 2 * 255^2)."""
    import ctypes
    from superviseddescent_tpu_torch.ops._build import load_library
    fn = load_library("features_fused",
                      ("FEATURES_SQRT_TABLE",)).features_sqrt_table
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    n = 2 * 255 ** 2 + 1
    whole = torch.empty(n, device=cuda)
    ref = torch.empty_like(whole)
    assert fn(whole.data_ptr(), ref.data_ptr(), n) == 0
    torch.cuda.synchronize()
    assert torch.equal(whole[1:], ref[1:])


# ------------------------------------------------------------------ #
# the ridge solver on the card: true float32 whatever the TF32 flag says
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("method", ["lu", "cholesky", "qr"])
def test_solver_ignores_tf32_flag_on_the_card(cuda, method):
    """With ``allow_tf32`` on, the products and the factorisation's solves
    still run in float32: the weights are the bits of a run with the flag
    off, and the flag is restored."""
    from superviseddescent_tpu_torch.core.regulariser import (
        RegularisationType, Regulariser)
    from superviseddescent_tpu_torch.ops.solver import (
        solve_ridge_normal_equations)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((2048, 700), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((2048, 44), dtype=np.float32))
    a, b = a.to(cuda), b.to(cuda)
    reg = Regulariser(RegularisationType.MatrixNorm, 1.5,
                      regularise_last_row=False)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        off = solve_ridge_normal_equations(a, b, reg, method)
        torch.backends.cuda.matmul.allow_tf32 = True
        on = solve_ridge_normal_equations(a, b, reg, method)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    assert bool(torch.equal(on, off))


# ------------------------------------------------------------------ #
# a 68-landmark K3 launch: 27,208-value weight rows, 136 outputs
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("n", [32, 137, 529])
def test_fused_kernel_68_landmarks_matches_twin(cuda, n):
    import glob
    import os
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, gt_facebox)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _MAX_SHARED, launch_plan)
    from superviseddescent_tpu_torch.ops.patches import (
        load_gray_image, stack_images)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = DetectionModel.load(
        os.path.join(repo, "pretrained", "rcr68_lfpw5.bin"), device="cuda")
    files = sorted(glob.glob(os.path.join(repo, ".synth120", "*.png")))[:8]
    boxes = np.array([gt_facebox(read_pts_landmarks(f[:-4] + ".pts")
                                 .filter(model.landmark_ids))
                      for f in files], np.float32)
    stack, _ = stack_images([load_gray_image(f) for f in files],
                            dtype=np.uint8, pad_width_to=128)
    sel = np.arange(n) % len(files)
    det = model.make_fused_detector(roi=512)
    fp = det.weights.tensor.shape[2]
    assert (det.weights.num_features, fp) == (27201, 27208)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = launch_plan(n, 68, 5, 55, True, sms)
    # 1,024 threads alone on an SM, one face of four landmarks in flight,
    # two faces per block (529 on 132 SMs)
    assert plan.shared_bytes <= _MAX_SHARED
    assert (plan.threads == 1024) == (n <= sms)
    assert (plan.faces > 1) == (n > 4 * sms)
    check_fused_against_twin(
        det, torch.from_numpy(stack).cuda(),
        torch.from_numpy(boxes[sel]).cuda(),
        torch.from_numpy(sel.astype(np.int32)).cuda())


# ------------------------------------------------------------------ #
# the probes P1-P5 against their plain twins
# ------------------------------------------------------------------ #
def sampler_probe_case(cuda, s, ph, centres):
    from superviseddescent_tpu_torch import probes
    from superviseddescent_tpu_torch.probes.sampler import sub_window_origins
    n, roi, l = 8, 512, 5
    windows = probes.sampler_windows(1, n, roi, cuda)
    if centres == "middle":
        cx, cy = probes.sampler_centres(1, n, l, roi)
    else:       # up to 4 px outside: origins clamp, taps are truncated
        rng = np.random.default_rng(2)
        cx = rng.uniform(-4, roi + 4, (n, l)).astype(np.float32)
        cy = rng.uniform(-4, roi + 4, (n, l)).astype(np.float32)
    oxy, sp = probes.sampler_inputs(cx, cy, s, ph, cuda)
    return windows, oxy, sp, sub_window_origins


@pytest.mark.parametrize("centres", ["middle", "border"])
@pytest.mark.parametrize("s,w,wx,ph", [(55, 160, 384, 72.0),
                                       (40, 72, 256, 29.0)])
def test_sampler_probes_equal_twin_and_each_other(cuda, s, w, wx, ph,
                                                  centres):
    from superviseddescent_tpu_torch.probes.sampler import (
        VARIANTS, probe_sampler, probe_sampler_g, probe_sampler_pre,
        probe_sampler_reference)
    windows, oxy, sp, origins = sampler_probe_case(cuda, s, ph, centres)
    oo = origins(oxy, sp, 512, 512, s, w, wx)
    outs = {}
    for variant in VARIANTS:
        before = probe_sampler.launches
        outs[variant] = probe_sampler(windows, oxy, sp, variant, s, w, wx)
        assert probe_sampler.launches == before + 1
        ref = probe_sampler_reference(windows, oxy, sp, s, w, wx, variant)
        # at most two non-zero terms per float32 sum: bit-equal
        assert torch.equal(outs[variant].view(torch.int16),
                           ref.view(torch.int16)), variant
    assert float(outs["full"].float().max()) > 0
    for g in (1, 2, 4):
        before = probe_sampler_g.launches
        got = probe_sampler_g(windows, oxy, sp, g, s, w, wx)
        assert probe_sampler_g.launches == before + 1
        assert torch.equal(got.view(torch.int16),
                           outs["full"].view(torch.int16)), g
    for pre in (False, True):
        before = probe_sampler_pre.launches
        got = probe_sampler_pre(windows, oxy, sp, oo, pre, s, w, wx)
        assert probe_sampler_pre.launches == before + 1
        assert torch.equal(got.view(torch.int16),
                           outs["full"].view(torch.int16)), pre


def test_sampler_probe_is_k2_fast_transposed(cuda):
    windows, oxy, sp, _ = sampler_probe_case(cuda, 40, 29.0, "border")
    from superviseddescent_tpu_torch.probes.sampler import probe_sampler
    from superviseddescent_tpu_torch.ops._build import load_library
    import ctypes
    n, l = oxy.shape[0], oxy.shape[2] // 2
    k2 = torch.empty((n, l, 40, 40), dtype=torch.bfloat16, device=cuda)
    oxy2, sp2 = oxy.reshape(n, -1).contiguous(), sp.reshape(n, 2).contiguous()
    err = load_library("patches_window").patches_window_launch(
        ctypes.c_void_p(windows.data_ptr()), 1,
        ctypes.c_void_p(oxy2.data_ptr()), ctypes.c_void_p(sp2.data_ptr()),
        ctypes.c_void_p(k2.data_ptr()), 1, n, l, 512, 512, 40, 72, 256, 1, 1,
        1, 8, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    got = probe_sampler(windows, oxy, sp, "full", 40, 72, 256)
    assert torch.equal(got.view(torch.int16), k2.view(torch.int16))


@pytest.mark.parametrize("centres", ["middle", "border"])
@pytest.mark.parametrize("s,w,wx,ph", [(1, 8, 128, 2.5), (17, 24, 128, 7.0),
                                       (96, 96, 128, 40.0),
                                       (55, 160, 384, 72.0)])
def test_sampler_probes_at_odd_sizes_and_plans(cuda, s, w, wx, ph, centres):
    """S = 1, 17, 96 with W = S or the next multiple of 8 and WX = 128, at
    middle and border centres: every variant, G and pre equal their twin,
    and so do plans of other sizes, blocks of at most 768 threads (40
    registers a thread) and larger (the launches of ``_launch`` do not
    count)."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.probes import sampler
    windows, oxy, sp, origins = sampler_probe_case(cuda, s, ph, centres)
    n, ry, rx = windows.shape
    l = oxy.shape[2] // 2
    oo = origins(oxy, sp, ry, rx, s, w, wx)
    full = sampler.probe_sampler_reference(windows, oxy, sp, s, w, wx)
    for variant in sampler.VARIANTS:
        got = sampler.probe_sampler(windows, oxy, sp, variant, s, w, wx)
        ref = sampler.probe_sampler_reference(windows, oxy, sp, s, w, wx,
                                              variant)
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    for g in (1, 2, 4):
        got = sampler.probe_sampler_g(windows, oxy, sp, g, s, w, wx)
        assert torch.equal(got.view(torch.int16), full.view(torch.int16))
    for pre in (False, True):
        got = sampler.probe_sampler_pre(windows, oxy, sp, oo, pre, s, w, wx)
        assert torch.equal(got.view(torch.int16), full.view(torch.int16))
    lib = load_library("probe_sampler")
    for g in (1, 2, 4):
        for target in (32, 192, 768, 1024):
            plan = sampler.launch_plan(l, s, target)
            got = torch.full_like(full, float("nan"))
            sampler._launch(lib, windows, oxy, sp, oo, got, "full", g, True,
                            s, w, wx, plan)
            assert torch.equal(got.view(torch.int16),
                               full.view(torch.int16)), (g, plan)


@pytest.mark.parametrize("s,l,w,wx,seg,ry,rx,shift", [
    (8, 1, 32, 128, 128, 64, 256, 0), (8, 8, 32, 128, 20, 64, 256, 0),
    (128, 1, 32, 128, 128, 64, 256, 0), (128, 8, 32, 128, 136, 64, 256, 0),
    (16, 3, 128, 256, 40, 128, 384, 0), (16, 16, 40, 128, 128, 64, 264, 0),
    # L past the 16 warps of a block: warps take several landmarks
    (16, 22, 32, 128, 16, 64, 256, 0), (16, 40, 32, 128, 128, 64, 256, 0),
    # 40 output columns of landmark 0: two passes of the second product
    (40, 40, 32, 128, 40, 64, 256, 0),
    # W past 128 rows, or WX too wide for 128 staged rows: the sub-window
    # in slices
    (8, 2, 160, 128, 8, 192, 256, 0), (16, 2, 256, 384, 16, 256, 384, 0),
    (16, 2, 128, 1024, 16, 128, 1024, 0),
    # rows off 16-byte boundaries: staged value by value
    (16, 6, 32, 128, 128, 64, 250, 0), (16, 6, 32, 128, 128, 64, 256, 3),
    # an empty sub-window: every sum is 0
    (16, 6, 0, 0, 16, 64, 256, 0)])
def test_abde_probe_at_other_shapes(cuda, s, l, w, wx, seg, ry, rx, shift):
    """ABDE at L = 1 to 40, S = 8 to 128, W up to 256, a W that is no
    multiple of 16, SEG that is no multiple of 16, sub-windows staged in
    slices, windows whose rows are off 16-byte boundaries (RX no multiple
    of 8, or the window ``shift`` values past one), against its twin and
    the numpy emulation."""
    from superviseddescent_tpu_torch.probes.dyn import (
        ABDE_RTOL, abde_emulation, probe_abde, probe_abde_reference)
    rng = np.random.default_rng(s + l + w)
    g = 3
    x = torch.from_numpy(rng.uniform(-20, rx + 20, (g, 1, 2 * l))
                         .astype(np.float32)).to(cuda)
    flat = torch.from_numpy(rng.uniform(0, 255, g * ry * rx + shift)
                            .astype(np.float32)).to(cuda).bfloat16()
    win = flat[shift:].view(g, ry, rx)
    got = probe_abde(x, win, s, w, wx, seg)
    ref = probe_abde_reference(x, win, s, w, wx, seg)
    torch.testing.assert_close(got, ref, rtol=ABDE_RTOL, atol=0)
    emu = abde_emulation(x.cpu().numpy(), win.float().cpu().numpy(), s, w,
                         wx, seg)
    np.testing.assert_allclose(got.cpu().numpy(), emu, rtol=ABDE_RTOL, atol=0)


@pytest.mark.parametrize("offset", [0, 1, 3, 4])
def test_flatout_probe_equals_two_x(cuda, offset):
    # 37 tiles of 7 x 7 leave a tail of 1 float after the 16-byte words; an
    # offset of 1 or 3 floats gives an input base off the 16-byte grid
    from superviseddescent_tpu_torch.probes.flatout import probe_flatout
    rng = np.random.default_rng(0)
    for n, s in ((37, 55), (37, 7), (37, 96), (1, 1), (0, 5)):
        buf = torch.from_numpy(rng.normal(size=offset + n * s * s)
                               .astype(np.float32)).to(cuda)
        x = buf[offset:].view(n, s, s)
        before = probe_flatout.launches
        got = probe_flatout(x)
        assert probe_flatout.launches == before + (n > 0)
        assert torch.equal(got, (x * 2.0).reshape(n, s * s))


def test_dyn_probes_match_twin_and_emulation(cuda):
    from superviseddescent_tpu_torch import probes
    from superviseddescent_tpu_torch.probes.dyn import (
        ABDE_RTOL, abde_emulation, c_emulation, probe_abde,
        probe_abde_reference, probe_c, probe_c4, probe_c_reference)
    d = probes.DYN
    x, win, v = probes.dyn_inputs(3, cuda, **d)
    shape = (d["s"], d["w"], d["wx"], d["seg"])
    before = probe_abde.launches
    got = probe_abde(x, win, *shape)
    assert probe_abde.launches == before + 1
    ref = probe_abde_reference(x, win, *shape)
    # float32 sums over 128 and 32 terms in another order: one bf16
    # rounding of the patch
    torch.testing.assert_close(got, ref, rtol=ABDE_RTOL, atol=0)
    emu = abde_emulation(x.cpu().numpy(), win.float().cpu().numpy(), *shape)
    np.testing.assert_allclose(got.cpu().numpy(), emu, rtol=ABDE_RTOL, atol=0)
    assert float(got.min()) > 100
    ref_c = probe_c_reference(v, d["g"], d["br"])
    for fn in (probe_c, probe_c4):
        before = fn.launches
        out = fn(v, d["g"], d["br"])
        assert fn.launches == before + 1
        assert torch.equal(out, ref_c)
        np.testing.assert_array_equal(
            out.cpu().numpy(), c_emulation(v.cpu().numpy(), d["g"], d["br"]))


@pytest.mark.parametrize("g", [1, 4, 37])
@pytest.mark.parametrize("br", [4, 8, 13])
def test_c_probes_equal_twin_at_every_shape(cuda, g, br):
    """C and C4 (one kernel, no scratch, 16-byte words with a scalar head
    and tail) bit-equal to the twin at every SEG, into a new output and
    into one a float (4 bytes) off the 16-byte grid; each launch counted on
    its own wrapper."""
    from superviseddescent_tpu_torch.probes.dyn import (
        probe_c, probe_c4, probe_c_reference)
    rng = np.random.default_rng(g * 100 + br)
    for seg in (1, 3, 128, 129, 1000):
        v = torch.from_numpy(rng.normal(size=(5, seg)).astype(np.float32)
                             ).to(cuda)
        ref = probe_c_reference(v, g, br)
        for fn in (probe_c, probe_c4):
            before = (probe_c.launches, probe_c4.launches)
            got = fn(v, g, br)
            buf = torch.full((ref.numel() + 1,), float("nan"), device=cuda)
            out = buf[1:].view(ref.shape)
            assert out.data_ptr() % 16 == 4
            assert fn(v, g, br, out=out) is out
            torch.cuda.synchronize()
            counts = (probe_c.launches, probe_c4.launches)
            assert counts == ((before[0] + 2, before[1]) if fn is probe_c
                              else (before[0], before[1] + 2))
            assert torch.equal(got, ref), (fn.__name__, seg)
            assert torch.equal(out, ref), (fn.__name__, seg)
            assert bool(torch.isnan(buf[0]))


# ------------------------------------------------------------------ #
# tracking on the card: stream and scan give the chain
# ------------------------------------------------------------------ #
def test_tracking_stream_and_scan_equal_the_chain(cuda):
    rng = np.random.default_rng(5)
    model = random_model(cuda, 6, 2, 3)
    clip = torch.from_numpy(rng.integers(0, 256, size=(9, 192, 128))
                            .astype(np.uint8)).to(cuda)
    box = torch.tensor([24.0, 60.0, 76.0, 76.0], device=cuda)
    detector = model.make_fused_detector(roi=128)
    tracker = model.make_fused_tracker(roi=128)
    rows = [detector(clip[:1], box[None])]
    for k in range(1, 9):
        rows.append(tracker(clip[k:k + 1], rows[-1]))
    chain = torch.cat(rows)
    assert bool(torch.isfinite(chain).all())
    scan = model.make_fused_track_scan(roi=128)
    scan(clip[:2], box)                      # first call uploads the tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scanned = scan(clip, box)            # nothing in it may synchronise
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(scanned, chain)
    for chunk, depth in ((1, None), (4, None), (1, 3)):
        stream = model.make_fused_track_stream(roi=128, chunk=chunk,
                                               depth=depth)
        got = np.stack(list(stream(iter(clip), box)))
        np.testing.assert_array_equal(got, chain.cpu().numpy())


# ------------------------------------------------------------------ #
# face detection on the card: the CPU path's boxes
# ------------------------------------------------------------------ #
SYNTH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".synth120")


def synth_gray(name):
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    return load_gray_image(os.path.join(SYNTH, name + ".png"))


@pytest.mark.parametrize("name", ["synth_0000", "synth_0001", "synth_0002",
                                  "synth_0003", "synth_0004"])
def test_face_detector_on_the_card_equals_cpu(cuda, name):
    """One image of each .synth120 size class at its own size: raw and
    grouped boxes of detect, and of detect_batch on the image beside its
    mirror, equal on the card and on the CPU."""
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    img = synth_gray(name)
    stack = np.stack([img, img[:, ::-1]])
    for mn in (0, 2):
        on_card = HaarCascadeDetector(STOCK_FRONTAL_ALT2, min_neighbors=mn,
                                      device=cuda)
        on_cpu = HaarCascadeDetector(STOCK_FRONTAL_ALT2, min_neighbors=mn,
                                     device="cpu")
        assert on_card.exact
        want = on_cpu.detect(img)
        np.testing.assert_array_equal(on_card.detect(img), want)
        np.testing.assert_array_equal(
            on_card.detect(torch.from_numpy(img).to(cuda)), want)
        for got, ref in zip(on_card.detect_batch(stack),
                            on_cpu.detect_batch(stack)):
            np.testing.assert_array_equal(got, ref)
        if mn and name != "synth_0004":
            assert len(want) == 1


def test_face_detector_overflow_on_the_card(cuda):
    """A 128-slot survivor buffer and a 4-slot candidate buffer each
    overflow (the flags read back) and fall back to the dense evaluation,
    with the default's boxes; detect_stream gives detect's."""
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    img = synth_gray("synth_0003")
    ref = HaarCascadeDetector(STOCK_FRONTAL_ALT2, min_neighbors=0,
                              device=cuda)
    want = ref.detect(img)
    assert len(want) > 4
    tiny = HaarCascadeDetector(STOCK_FRONTAL_ALT2, min_neighbors=0,
                               device=cuda)
    tiny.SURVIVOR_DIV = 1 << 20
    pend = tiny.detect_begin(img)
    got = tiny.detect_end(pend)
    assert int(pend.packed[0, -1]) == 1
    np.testing.assert_array_equal(got, want)
    few = HaarCascadeDetector(STOCK_FRONTAL_ALT2, min_neighbors=0,
                              device=cuda)
    few.MAX_CANDIDATES = 4
    pend = few.detect_begin(img)
    got = few.detect_end(pend)
    assert int(pend.packed[0, -2]) == len(want)
    np.testing.assert_array_equal(got, want)
    frames = [img, img[:, ::-1], np.zeros_like(img), img[:600, :500]]
    singles = [ref.detect(f) for f in frames]
    for depth in (1, 3):
        for got, want_f in zip(ref.detect_stream(frames, depth=depth),
                               singles):
            np.testing.assert_array_equal(got, want_f)


# ------------------------------------------------------------------ J1
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_jpeg")


def jpeg_manifest():
    import json
    with open(os.path.join(JPEG_FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [
    "s00_grey_q75.jpg", "s01_444_q95.jpg", "s02_422_q50.jpg",
    "s04_420_q95_restart.jpg", "s06_422_q75_odd.jpg", "clip/f000.jpg",
    "p00_grey_q75_prog.jpg", "p03_420_q75_prog.jpg",
    "p04_420_q95_restart_prog.jpg", "c00_cmyk_q75.jpg", "c01_ycck_q75.jpg",
    "r00_411_q75.jpg", "r01_440_q75.jpg", "m01_422_2scans_restart.jpg",
    "x00_mixed_2x2_1x2_2x1.jpg", "x01_3x2_box.jpg",
    "clip_progressive/f000.jpg"])
def test_jpeg_kernel_equals_twin_and_pil(cuda, name):
    """J1 on the host decoder's coefficients: bit-equal to its twin on the
    same tensors and to PIL's digests; the host decoder equal to the
    Python one (every scan of a progressive or multi-scan stream in one
    call)."""
    import hashlib
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels, read_jpeg)
    m = jpeg_manifest()
    frames = m["clip"]["frames"] + m["clip_progressive"]["frames"]
    want = (m["stills"][name] if name in m["stills"] else
            [f for f in frames if f["name"] == name][0])
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    host = entropy_decode_native(f)
    assert host.is_pinned()
    np.testing.assert_array_equal(host.numpy(), jpeg.entropy_decode(f))
    coef = host.to(cuda)
    for channels, key in ((1, "grey_sha256"), (3, "rgb_sha256")):
        before = jpeg_pixels.launches
        got = jpeg_pixels(coef, f, channels)
        assert jpeg_pixels.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, jpeg.pixels_reference(coef, f, channels))
        assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == \
            want[key]
        assert torch.equal(read_jpeg(data, channels), got)


@pytest.mark.parametrize("name", [
    "a00_grey_q50.jpg", "a07_420_q75.jpg", "a12_420_q75_restart.jpg",
    "a13_444_q75_dac.jpg", "a15_420_q75_prog.jpg",
    "b00_420_q75_arith_never.jpg", "b03_444_q75_huffman_unrefined.jpg",
    "l00_grey_p1.jpg", "l08_rgb_ids123_p6.jpg", "l11_420_p7.jpg",
    "l12_420_3scans_restart_p4.jpg", "l13_cmyk_p1.jpg",
    "timing/t02_clip_f000_sof3_grey.jpg"])
def test_jpeg_coded_kinds_equal_twin_and_pil(cuda, name):
    """Arithmetic-coded, block-smoothed and lossless stills: the host
    decoder equal to the Python twins, J1 (the samples source for a
    lossless frame, with its own launch count) bit-equal to its twin on
    the same tensors and to PIL's digests."""
    import hashlib
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels, jpeg_samples, read_jpeg)
    m = jpeg_manifest()
    want = m["stills"].get(name) or m["timing"][name]
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    host = entropy_decode_native(f)
    assert host.is_pinned()
    assert host.dtype == (torch.uint8 if f.lossless else torch.int16)
    np.testing.assert_array_equal(host.numpy(), jpeg.entropy_decode(f))
    values = host.to(cuda)
    counter = jpeg_samples if f.lossless else jpeg_pixels
    for channels, key in ((1, "grey_sha256"), (3, "rgb_sha256")):
        before = counter.launches
        got = jpeg_pixels(values, f, channels)
        assert counter.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, jpeg.pixels_reference(values, f, channels))
        assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == \
            want[key]
        assert torch.equal(read_jpeg(data, channels), got)


@pytest.mark.parametrize("name", [
    "s00_grey_q75.jpg", "s01_444_q95.jpg", "s02_422_q50.jpg",
    "s03_420_q75.jpg", "c00_cmyk_q75.jpg", "c01_ycck_q75.jpg",
    "r00_411_q75.jpg", "r01_440_q75.jpg", "x00_mixed_2x2_1x2_2x1.jpg",
    "x01_3x2_box.jpg"])
def test_jpeg_kernel_at_odd_and_tiny_sizes(cuda, name):
    """J1's edges in every upsampling filter and colour space (box
    upsampling below three samples, replicated edge samples, odd extents,
    replication by 3 and 4): the fixtures' coefficients with the frame cut
    to small sizes, against the twin on the same cut (the card's machine
    has no PIL to write small streams)."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import jpeg_pixels
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    coef = torch.from_numpy(jpeg.entropy_decode(f)).to(cuda)
    full_w, full_h = f.width, f.height
    for w, h in ((1, 1), (3, 2), (4, 5), (5, 9), (17, 33), (23, 7)):
        f.width, f.height = min(w, full_w), min(h, full_h)
        jpeg.sample_extents(f)
        for channels in (1, 3):
            assert torch.equal(jpeg_pixels(coef, f, channels),
                               jpeg.pixels_reference(coef, f, channels))


JPEG_KINDS = ["s00_grey_q75.jpg", "s01_444_q95.jpg", "s02_422_q50.jpg",
              "s03_420_q75.jpg", "c00_cmyk_q75.jpg", "c01_ycck_q75.jpg",
              "r00_411_q75.jpg", "r01_440_q75.jpg",
              "x00_mixed_2x2_1x2_2x1.jpg", "x01_3x2_box.jpg"]


def around(n):
    return (n - 1, n, n + 1)


@pytest.mark.parametrize("name", JPEG_KINDS)
def test_jpeg_kernel_at_tile_boundaries(cuda, name):
    """J1 at widths and heights one under, at and one over one and two of
    its tiles (ops/jpeg.J1_TILE, in pixels of the frame's MCUs) and at a
    single MCU row, under the default plan and two others, against the
    twin on the same cut frame."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import J1_TILE, jpeg_pixels
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    coef = torch.from_numpy(jpeg.entropy_decode(f)).to(cuda)
    full_w, full_h = f.width, f.height
    mcu_w = 8 * max(c.h for c in f.components)
    mcu_h = 8 * max(c.v for c in f.components)
    tw, th = J1_TILE[1] * mcu_w, J1_TILE[0] * mcu_h
    widths = [*around(tw), *around(2 * tw), full_w]
    heights = [mcu_h, *around(th), *around(2 * th), full_h]
    for k, (w, h) in enumerate((w, h) for w in widths for h in heights):
        f.width, f.height = min(w, full_w), min(h, full_h)
        jpeg.sample_extents(f)
        plan = (None, (2, 3, 64), (1, 16, 512))[k % 3]
        for channels in (1, 3):
            assert torch.equal(jpeg_pixels(coef, f, channels, plan),
                               jpeg.pixels_reference(coef, f, channels)), (
                f.width, f.height, channels, plan)


@pytest.mark.parametrize("name", ["s03_420_q75.jpg", "c01_ycck_q75.jpg"])
def test_jpeg_kernel_extreme_blocks_equal_the_twin(cuda, name):
    """J1 gives the twin's bits on blocks with only a DC and on blocks
    with large AC values, at values far outside what an 8-bit encoder
    writes, where the int32 products wrap."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import jpeg_pixels
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    coef = jpeg.entropy_decode(f).copy()
    rng = np.random.default_rng(5)
    idx = rng.choice(len(coef), min(400, len(coef)), replace=False)
    coef[idx, 0] = rng.choice([32767, -32768, 20000, -20000, 4000], len(idx))
    coef[idx[:len(idx) // 2], 1:] = 0
    coef[idx[len(idx) // 2:], 5] = 32767
    t = torch.from_numpy(coef).to(cuda)
    for channels in (1, 3):
        assert torch.equal(jpeg_pixels(t, f, channels),
                           jpeg.pixels_reference(t, f, channels)), channels


@pytest.mark.parametrize("name", JPEG_KINDS + ["clip/f000.jpg"])
def test_jpeg_kernel_writes_every_pixel(cuda, name):
    """J1 launched into outputs filled with two different sentinels gives
    the twin's pixels both times: no pixel is left unwritten."""
    import ctypes
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.jpeg import (
        pixel_params, quant_on_card)
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    coef = torch.from_numpy(jpeg.entropy_decode(f)).to(cuda)
    for channels in (1, 3):
        want = jpeg.pixels_reference(coef, f, channels)
        geom, quant = pixel_params(f, channels)
        tables = quant_on_card(quant, cuda)
        for sentinel in (0x5A, 0xA5):
            out = torch.full(tuple(want.shape), sentinel, dtype=torch.uint8,
                             device=cuda)
            err = load_library("jpeg_decode").jpeg_pixels_launch(
                ctypes.c_void_p(coef.data_ptr()),
                ctypes.c_void_p(out.data_ptr()),
                ctypes.c_void_p(geom.ctypes.data),
                ctypes.c_void_p(tables.data_ptr()),
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            assert err == 0
            torch.cuda.synchronize()
            assert torch.equal(out, want), (channels, sentinel)


@pytest.mark.parametrize("name", ["s04_420_q95_restart.jpg",
                                  "p04_420_q95_restart_prog.jpg",
                                  "m01_422_2scans_restart.jpg"])
def test_jpeg_host_decoder_reports_truncation(cuda, name):
    """A cut or corrupted scan raises in the host decoder with the Python
    twin's error."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import entropy_decode_native
    data = open(os.path.join(JPEG_FIXTURES, name), "rb").read()
    f = jpeg.parse_jpeg(data)
    scan = f.scans[-1]
    whole = scan.data
    scan.data = whole[:len(whole) // 2]
    with pytest.raises(ValueError, match="JPEG: "):
        entropy_decode_native(f)
    scan.data = whole
    rng = np.random.default_rng(0)
    for s in f.scans:
        keep = s.data
        for _ in range(8):
            b = bytearray(keep)
            b[rng.integers(0, len(b))] = rng.integers(0, 256)
            s.data = bytes(b)
            try:
                want = jpeg.entropy_decode(f)
            except ValueError as e:
                with pytest.raises(ValueError, match=re.escape(str(e))):
                    entropy_decode_native(f)
            else:
                np.testing.assert_array_equal(
                    entropy_decode_native(f).numpy(), want)
        s.data = keep


# ------------------------------------------------------------------ J2
IMAGEIO_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "torch_imageio")
J2_KINDS = ((3, "4:4:4"), (3, "4:2:2"), (3, "4:2:0"), (1, None))


@pytest.mark.parametrize("channels,sub", J2_KINDS)
def test_jpeg_encode_kernel_equals_twin(cuda, channels, sub):
    """J2 bit-equal to its twin at every size from 1 x 1 to 33 x 33 (each
    edge and dummy-block rule) and at 301 x 451 and 768 x 1024, qualities
    1 to 100; the card's whole file equal to the CPU twins'."""
    from superviseddescent_tpu_torch.io.jpeg_write import (
        coefficients_reference, encode_jpeg, layout)
    from superviseddescent_tpu_torch.ops.jpeg import (
        encode_jpeg_device, jpeg_coefficients)
    rng = np.random.default_rng(channels * 10 + len(sub or ""))
    shapes = [(h, w) for h in range(1, 34, 4) for w in range(1, 34)]
    shapes += [(301, 451), (451, 301), (768, 1024)]
    for k, (h, w) in enumerate(shapes):
        px = rng.integers(0, 256, (h, w, 3)[:2 + (channels == 3)], np.uint8)
        quality = (1, 10, 25, 50, 75, 90, 95, 100)[k % 8]
        lay = layout(h, w, channels, quality, sub)
        t = torch.from_numpy(px)
        before = jpeg_coefficients.launches
        got = jpeg_coefficients(t.to(cuda), lay)
        assert jpeg_coefficients.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), coefficients_reference(t, lay)), (
            h, w, quality)
        if h * w < 5000 or h == 768:
            assert encode_jpeg_device(t.to(cuda), quality, sub) == \
                encode_jpeg(t, quality, sub, device="cpu")


@pytest.mark.parametrize("channels,sub", J2_KINDS)
def test_jpeg_encode_kernel_at_strip_boundaries(cuda, channels, sub):
    """J2 at widths one under, at and one over one and two of its strips
    (ops/jpeg.J2_STRIP MCUs, in pixels) and at heights one under, at and
    one over one and two MCU rows, under the default plan and two others,
    bit-equal to its twin."""
    from superviseddescent_tpu_torch.io.jpeg_write import (
        coefficients_reference, layout)
    from superviseddescent_tpu_torch.ops.jpeg import (
        J2_STRIP, jpeg_coefficients)
    rng = np.random.default_rng(channels * 7 + len(sub or ""))
    lay = layout(16, 16, channels, 75, sub)
    mcu_w = 8 * max(c.h for c in lay.components)
    mcu_h = 8 * max(c.v for c in lay.components)
    sw = J2_STRIP[lay.blocks_per_mcu] * mcu_w
    widths = [*around(sw), *around(2 * sw)]
    heights = [*around(mcu_h), *around(2 * mcu_h)]
    for k, (w, h) in enumerate((w, h) for w in widths for h in heights):
        px = rng.integers(0, 256, (h, w, 3)[:2 + (channels == 3)], np.uint8)
        lay = layout(h, w, channels, (50, 75, 95)[k % 3], sub)
        t = torch.from_numpy(px)
        for strip in (None, 1, 3):
            got = jpeg_coefficients(t.to(cuda), lay, strip)
            assert torch.equal(got.cpu(), coefficients_reference(t, lay)), (
                h, w, strip)


def test_jpeg_encode_kernel_writes_pils_digests(cuda):
    """J2 and the host coder on the decoded pixels of the committed stills
    and clip frames: every file's sha256 is PIL's, from the manifest."""
    import hashlib
    import json
    from superviseddescent_tpu_torch.ops.jpeg import (
        encode_jpeg_device, read_jpeg)
    with open(os.path.join(IMAGEIO_FIXTURES, "manifest.json")) as f:
        writes = json.load(f)["jpeg_writes"]
    for e in writes:
        px = read_jpeg(os.path.join(JPEG_FIXTURES, e["source"]),
                       e["channels"], cuda)
        data = encode_jpeg_device(px, e["quality"], e["subsampling"])
        assert hashlib.sha256(data).hexdigest() == e["sha256"], e


TIFF_JPEG_FILES = ["f05_clip_ycbcr420.tif", "f06_clip_rgb_pil.tif",
                   "f07_clip_ycbcr420_libtiff.tif", "j00_rgb_strips_pil.tif",
                   "j01_grey_strips_pil.tif", "j02_ycbcr444_pil.tif",
                   "j03_ycbcr420_strips.tif", "j04_ycbcr420_tiles.tif",
                   "j05_ycbcr422_strips_be.tif", "j06_grey_tiles.tif"]


@pytest.mark.parametrize("name", TIFF_JPEG_FILES)
def test_jpeg_kernel_tiff_batches(cuda, name):
    """A JPEG-compressed TIFF on the card: at most two J1 launches (the
    full-size strips or tiles as one batch, the short last strip), the
    batch bit-equal to its twin on the same coefficients, the page equal
    to PIL's digests in grey and RGB."""
    import hashlib
    import json
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.tiff import jpeg_chunks
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels, read_tiff_jpeg)
    with open(os.path.join(IMAGEIO_FIXTURES, "manifest.json")) as f:
        want = json.load(f)["files"][name]
    data = open(os.path.join(IMAGEIO_FIXTURES, name), "rb").read()
    for channels, key in ((1, "grey_sha256"), (3, "rgb_sha256")):
        before = jpeg_pixels.launches
        got = read_tiff_jpeg(data, channels, cuda)
        assert jpeg_pixels.launches - before <= 2
        assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == \
            want[key]
    page = jpeg_chunks(data)
    frames = [jpeg.parse_jpeg(s) for s in page.streams]
    f = frames[0]
    same = [g for g in frames if (g.width, g.height) == (f.width, f.height)]
    coef = torch.stack([entropy_decode_native(g) for g in same]).to(cuda)
    for channels in (1, 3):
        got = jpeg_pixels(coef, f, channels)
        assert torch.equal(got.cpu(), jpeg.pixels_reference(coef.cpu(), f,
                                                            channels))


def test_webp_native_decoder_on_the_card_path(cuda):
    """The nvcc-built host decoder behind read_rgb(device=card): every
    WebP fixture equal to PIL's digests."""
    import hashlib
    import json
    from superviseddescent_tpu_torch.io.image import read_gray, read_rgb
    with open(os.path.join(IMAGEIO_FIXTURES, "manifest.json")) as f:
        m = json.load(f)
    for name in m["groups"]["webp"] + ["f04_clip.webp"]:
        path = os.path.join(IMAGEIO_FIXTURES, name)
        for read, key in ((read_gray, "grey_sha256"), (read_rgb,
                                                       "rgb_sha256")):
            got = read(path, device=cuda)
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                m["files"][name][key], name


@pytest.mark.parametrize("rows", [0, 1, 2, 5])
def test_webp_lossy_kernels_match_twins(cuda, rows):
    """W1, W2 and W3 (ops/webp.py) each equal to its twin on the same
    inputs for every lossy WebP fixture, W1 and W2 at the launch plan's
    rows in flight (0) and at 1, 2 and 5 (a warp taking several rows), and
    read_gray / read_rgb on the card equal to PIL's digests."""
    import hashlib
    import json
    from superviseddescent_tpu_torch.io.image import read_gray, read_rgb
    from superviseddescent_tpu_torch.io.webp import compose, decode_vp8l_native
    from superviseddescent_tpu_torch.ops import webp as W
    with open(os.path.join(IMAGEIO_FIXTURES, "manifest.json")) as f:
        m = json.load(f)

    def stages(payload):
        f, coeffs, modes, filters = W.vp8_frame(payload, cuda)
        planes = W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h, grid=rows)
        want = W.reconstruct_reference(coeffs, modes, f.mb_w, f.mb_h)
        assert all(torch.equal(a, b) for a, b in zip(planes, want))
        want = W.filter_reference(*planes, filters, f.filter_type, f.mb_w,
                                  f.mb_h)
        planes = W.vp8_filter(*(p.clone() for p in planes), filters,
                              f.filter_type, f.mb_w, f.mb_h, grid=rows)
        assert all(torch.equal(a, b) for a, b in zip(planes, want))
        for channels in (1, 3):
            got = W.vp8_colour(*planes, f.width, f.height, channels)
            assert torch.equal(got, W.colour_reference(
                *planes, f.width, f.height, channels))
        return got
    for name in m["groups"]["webp_lossy"]:
        path = os.path.join(IMAGEIO_FIXTURES, name)
        with open(path, "rb") as f:
            compose(f.read(), decode_vp8l_native, stages)
        for read, key in ((read_gray, "grey_sha256"), (read_rgb,
                                                       "rgb_sha256")):
            got = read(path, device=cuda)
            assert hashlib.sha256(got.tobytes()).hexdigest() == \
                m["files"][name][key], name


@pytest.mark.parametrize("per_cta, rows", [(None, 0), (None, 1), (None, 2),
                                           (None, 5), (16, 0)])
def test_webp_lossy_kernels_on_a_wide_frame(cuda, per_cta, rows,
                                            monkeypatch):
    """W1 and W2 equal to their twins on the lossy clip frame's
    coefficients, modes and filter bytes repeated ten times side by side
    (7,680 pixels, ten times the widest fixture), at the plan's rows in
    flight (0) and at 1, 2 and 5, and at 16 rows a CTA."""
    from superviseddescent_tpu_torch.io.webp import _chunks
    from superviseddescent_tpu_torch.ops import webp as W
    if per_cta:
        monkeypatch.setattr(W, "ROWS_PER_CTA", per_cta)
    with open(os.path.join(IMAGEIO_FIXTURES, "f08_clip_lossy.webp"),
              "rb") as f:
        data = f.read()
    payload = {c: b for c, b, _ in _chunks(data, 12, len(data))}[b"VP8 "]
    f, coeffs, modes, filters = W.vp8_frame(payload, cuda)
    mb_w, mb_h = 10 * f.mb_w, f.mb_h

    def wide(t):
        rows_of = t.reshape(mb_h, f.mb_w, -1).repeat(1, 10, 1)
        return rows_of.reshape(mb_w * mb_h, *t.shape[1:]).contiguous()
    coeffs, modes, filters = wide(coeffs), wide(modes), wide(filters)
    planes = W.vp8_reconstruct(coeffs, modes, mb_w, mb_h, grid=rows)
    want = W.reconstruct_reference(coeffs, modes, mb_w, mb_h)
    assert all(torch.equal(a, b) for a, b in zip(planes, want))
    want = W.filter_reference(*planes, filters, f.filter_type, mb_w, mb_h)
    planes = W.vp8_filter(*(p.clone() for p in planes), filters,
                          f.filter_type, mb_w, mb_h, grid=rows)
    assert all(torch.equal(a, b) for a, b in zip(planes, want))


def colour_planes(cuda, width, height, seed, offset=0):
    """Seeded W2-shaped planes for a ``width`` x ``height`` frame on the
    card, each starting ``offset`` bytes into its allocation (a contiguous
    view: 1 and 4 take W3's plain and 4-byte copies)."""
    rng = np.random.default_rng(seed)
    mb_w, mb_h = -(-width // 16), -(-height // 16)
    out = []
    for s in (16, 8, 8):
        shape = (s * mb_h, s * mb_w)
        buf = torch.empty(shape[0] * shape[1] + offset, dtype=torch.uint8,
                          device=cuda)
        p = buf[offset:].view(shape)
        p.copy_(torch.from_numpy(rng.integers(0, 256, shape,
                                              dtype=np.uint8)))
        out.append(p)
    return tuple(out)


def check_colour(planes, width, height, rows=0):
    from superviseddescent_tpu_torch.ops import webp as W
    for channels in (1, 3):
        got = W.vp8_colour(*planes, width, height, channels, rows=rows)
        want = W.colour_reference(*planes, width, height, channels)
        assert torch.equal(got, want), (width, height, channels, rows)


@pytest.mark.parametrize("height", (1, 2, 3, 17, 1024))
def test_webp_colour_equals_twin_at_every_width(cuda, height):
    """W3 (ops/webp.vp8_colour) on seeded planes at every width 1-48,
    every residue of a row's bytes mod 16, RGB and grey, at the plan's
    bands: equal to colour_reference."""
    for width in range(1, 49):
        check_colour(colour_planes(cuda, width, height, 100 * height + width),
                     width, height)


@pytest.mark.parametrize("rows", (0, 2, 4, 8, 16, 32))
def test_webp_colour_at_every_plan_of_the_sweep(cuda, rows):
    """W3 at the plan's rows a band (0) and at chip_smoke.py's COLOUR_SWEEP
    on a 768 x 1024 frame, on one whose odd mb_w puts the chroma rows off
    16 bytes (8-byte copies), and on planes 1, 4 and 8 bytes into their
    allocations."""
    check_colour(colour_planes(cuda, 768, 1024, rows), 768, 1024, rows)
    check_colour(colour_planes(cuda, 741, 999, rows + 1), 741, 999, rows)
    for offset in (1, 4, 8):
        check_colour(colour_planes(cuda, 75, 37, offset, offset), 75, 37,
                     rows)


def test_webp_colour_on_the_widest_frame(cuda):
    """W3 on a frame 16,383 px wide (VP8's widest) and a few rows high, at
    the plan's two rows a band; four rows a band do not fit the shared
    memory and the launcher refuses them."""
    from superviseddescent_tpu_torch.ops import webp as W
    planes = colour_planes(cuda, 16383, 5, 7)
    assert W.vp8_colour_plan(16383, 5, W._sm_count(cuda)).rows == 2
    check_colour(planes, 16383, 5)
    with pytest.raises(RuntimeError, match="W3"):
        W.vp8_colour(*planes, 16383, 5, 3, rows=4)


J2K_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_j2k")


def _j2k_readable():
    import json
    with open(os.path.join(J2K_DIR, "manifest.json")) as fh:
        files = json.load(fh)["files"]
    return sorted(n for n, e in files.items() if "pil_error" not in e)


@pytest.mark.parametrize("name", _j2k_readable())
def test_j2k_d1_and_m1_match_their_twins(cuda, name):
    """D1 and M1 on the host C++ stage's planes of every readable JPEG
    2000 fixture, equal to their twins (plain PyTorch on the CPU); D1 in
    exactly its plan's launches."""
    from superviseddescent_tpu_torch.io import jp2 as J
    from superviseddescent_tpu_torch.ops import j2k as O
    with open(os.path.join(J2K_DIR, name), "rb") as fh:
        got = J.read_file(fh.read())
    frame = O.decode_native(got.codestream)
    plan = O.colour_plan(got, frame)
    want = O.idwt_reference(frame.coeffs, frame.tcs)
    before = O.j2k_idwt.launches
    card = O.j2k_idwt(frame.coeffs.to(cuda), frame.tcs)
    torch.cuda.synchronize()
    assert O.j2k_idwt.launches - before == len(
        O.idwt_plan(frame.tcs).launches)
    assert torch.equal(card.cpu(), want)
    for channels in (3, 1):
        px = O.j2k_colour(card, frame, plan, channels)
        assert torch.equal(px.cpu(), O.colour_reference(want, frame, plan,
                                                        channels))


def test_j2k_idwt_leaves_the_host_planes_unchanged(cuda):
    """D1 writes a new tensor; the host stage's planes it reads stay as
    they were (its tiled levels read their detail bands from them)."""
    from superviseddescent_tpu_torch.io import jp2 as J
    from superviseddescent_tpu_torch.ops import j2k as O
    with open(os.path.join(J2K_DIR, "f01_clip_97_rpcl.jp2"), "rb") as fh:
        frame = O.decode_native(J.read_file(fh.read()).codestream)
    coeffs = frame.coeffs.to(cuda)
    before = coeffs.clone()
    out = O.j2k_idwt(coeffs, frame.tcs)
    torch.cuda.synchronize()
    assert out.data_ptr() != coeffs.data_ptr()
    assert torch.equal(coeffs, before)
    assert torch.equal(out.cpu(), O.idwt_reference(frame.coeffs, frame.tcs))


@pytest.mark.parametrize("tile", [(8, 4), (64, 32), (64, 64), (7, 3),
                                  (16, 8), (1, 1), (32, 16)])
@pytest.mark.parametrize("name", ["k39_odd_tiles_97.j2k",
                                  "k16_tiles_offset_97.jp2",
                                  "o24_subsampled_offset.j2k",
                                  "k15_tiles_offset.jp2", "k36_1x17.jp2",
                                  "k37_23x1.jp2", "k35_1x1.jp2",
                                  "k17_res1.j2k"])
def test_j2k_d1_at_other_plans(cuda, name, tile):
    """D1 in other tiles (small ones: cut edges, odd origins, lines of one
    and two samples under the halo): equal to its twin."""
    from superviseddescent_tpu_torch.io import jp2 as J
    from superviseddescent_tpu_torch.ops import j2k as O
    with open(os.path.join(J2K_DIR, name), "rb") as fh:
        frame = O.decode_native(J.read_file(fh.read()).codestream)
    plan = O.idwt_plan(frame.tcs, tile)
    card = O.j2k_idwt(frame.coeffs.to(cuda), frame.tcs, plan)
    assert torch.equal(card.cpu(), O.idwt_reference(frame.coeffs,
                                                    frame.tcs))

