"""RCR training, port vs JAX, on a tiny configuration.

6 landmarks (a mirror-closed ibug subset), 2 levels of 3 x 3 cells, 8
smoothed-noise frames of 192 x 128 (128 columns: the frames path's window
is then the full width), 2 perturbations, roi 128. The random streams of the
two packages cannot be matched, so ``augment_initialisations`` is replaced
in BOTH packages by one numpy function of the boxes it is given (nothing in
the JAX package changes for that). The JAX side runs its Pallas kernels in
interpret mode; the port runs the kernels' plain twins (``device="cpu"``).

Tolerances: per-level training rows (``on_epoch``, image coordinates) within
0.02 px, the fast-class bound of the detectors' parity tests (measured:
2e-5); regressor weights by their mean absolute difference, under 1e-3 as
tests/test_detectors.py holds two training backends, and under 1e-3 of
their mean magnitude (measured: 1e-6 relative); rows detected by the
port-trained model carried across with ``to_jax_params`` against the
JAX-trained model, both through the JAX ``detect_batch``: 0.02 px.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.core.cascade import (
    SupervisedDescentOptimiser as JaxSdo)
from superviseddescent_tpu.core.regressor import (
    LinearRegressor as JaxRegressor)
from superviseddescent_tpu.models import rcr_training as jax_training
from superviseddescent_tpu.models.rcr import (
    DetectionModel as JaxModel, HogParams as JaxHogParams,
    InterEyeDistanceNormalisation as JaxNorm)
from superviseddescent_tpu.ops.hog import HogVariant as JaxVariant
from superviseddescent_tpu.utils.landmarks import (
    mirror_permutation as jax_mirror_permutation)
from superviseddescent_tpu_torch.convert import to_jax_params
from superviseddescent_tpu_torch.io.cereal import load_detection_model
from superviseddescent_tpu_torch.models import rcr_training as training
from superviseddescent_tpu_torch.models.rcr import (
    HogParams, aligned_window_origins)
from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.utils.landmarks import mirror_permutation
from test_torch_fused_small import frames_and_boxes

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["37", "40", "43", "46", "31", "58"]
RIGHT, LEFT = ["37", "40"], ["43", "46"]
MEAN = np.float32([-0.22, -0.08, 0.08, 0.22, 0.0, 0.0,
                   -0.15, -0.15, -0.15, -0.15, 0.05, 0.25])
ROI = 128
ROWS_PX = 0.02
DETECT_PX = 0.02
WEIGHTS_ABS = 1e-3
WEIGHTS_REL = 1e-3


def tiny_data(dtype=np.uint8):
    f1, b1 = frames_and_boxes(seed=0)
    f2, b2 = frames_and_boxes(seed=1)
    frames = np.concatenate([f1, f2]).astype(dtype)
    boxes = np.concatenate([b1, b2])
    l = len(NAMES)
    gt = np.concatenate(
        [(MEAN[:l] + 0.5) * boxes[:, 2:3] + boxes[:, 0:1],
         (MEAN[l:] + 0.5) * boxes[:, 3:4] + boxes[:, 1:2]], axis=1)
    gt = gt + np.random.default_rng(7).normal(size=gt.shape) * 2.0
    return frames, boxes, gt.astype(np.float32)


def numpy_initialisations(mean, boxes, p):
    """The reference's perturbation scheme in numpy float32, from a fixed
    seed: a function of the boxes alone, the same for both packages."""
    rng = np.random.default_rng(5)
    mean = np.asarray(mean, np.float32)
    boxes = np.asarray(boxes, np.float32)
    b, l = len(boxes), mean.shape[0] // 2
    t = (rng.normal(size=(b, p, 2)) * 0.04).astype(np.float32)
    s = (1 + rng.normal(size=(b, p)) * 0.04).astype(np.float32)
    x, y, w, h = (boxes[:, None, i] for i in range(4))
    pw, ph = w * s, h * s
    moved = np.stack([x + (w - pw) / 2 + t[..., 0] * w,
                      y + (h - ph) / 2 + t[..., 1] * h, pw, ph], axis=-1)
    every = np.concatenate([boxes[:, None, :], moved], axis=1)
    half = np.float32(0.5)
    x0 = np.concatenate(
        [(mean[:l] + half) * every[..., 2:3] + every[..., 0:1],
         (mean[l:] + half) * every[..., 3:4] + every[..., 1:2]], axis=-1)
    return (x0.astype(np.float32).reshape(b * (p + 1), -1),
            np.repeat(np.arange(b), p + 1))


@pytest.fixture
def same_initialisations(monkeypatch):
    def for_jax(mean, faceboxes, key, num_perturbations=10, **kw):
        x0, s2b = numpy_initialisations(mean, faceboxes, num_perturbations)
        return jnp.asarray(x0), jnp.asarray(s2b, jnp.int32)

    def for_port(mean, faceboxes, generator, num_perturbations=10, **kw):
        x0, s2b = numpy_initialisations(mean.numpy(), faceboxes.numpy(),
                                        num_perturbations)
        return torch.from_numpy(x0), torch.from_numpy(s2b)

    monkeypatch.setattr(jax_training, "augment_initialisations", for_jax)
    monkeypatch.setattr(training, "augment_initialisations", for_port)


def train_both(backend, dtype, mirror=False, chunk=None):
    frames, boxes, gt = tiny_data(dtype)
    common = dict(num_perturbations=2, roi=ROI, patch_backend=backend,
                  mirror_augmentation=mirror, feature_chunk_size=chunk)
    jax_rows, port_rows = [], []
    jax_model = jax_training.train_rcr(
        frames, gt, boxes, NAMES, RIGHT, LEFT, MEAN,
        jax_training.RcrTrainConfig(
            hog_params=tuple(JaxHogParams(JaxVariant.Uoctti, 3, 4, 4, 0.8)
                             for _ in range(2)), **common),
        on_epoch=lambda x: jax_rows.append(np.asarray(x)))
    model = training.train_rcr(
        frames, gt, boxes, NAMES, RIGHT, LEFT, MEAN,
        training.RcrTrainConfig(
            hog_params=tuple(HogParams(HogVariant.Uoctti, 3, 4, 4, 0.8)
                             for _ in range(2)), **common),
        on_epoch=lambda x: port_rows.append(x.numpy()), device="cpu")
    return dict(jax_model=jax_model, model=model, jax_rows=jax_rows,
                port_rows=port_rows, frames=frames, boxes=boxes, gt=gt)


def carried_to_jax(model):
    """The JAX DetectionModel built from the port model's parameters."""
    params = to_jax_params(model)
    regs = [JaxRegressor(weights=jnp.asarray(w)) for w in params["weights"]]
    ids = (params["landmark_ids"], params["right_eye_ids"],
           params["left_eye_ids"])
    hog = tuple(JaxHogParams(JaxVariant(p["variant"]), p["num_cells"],
                             p["cell_size"], p["num_bins"],
                             p["relative_patch_size"])
                for p in params["hog_params"])
    return JaxModel(JaxSdo(regs, JaxNorm(*ids)), params["mean"], ids[0], hog,
                    ids[1], ids[2])


CASES = {
    "gather": ("gather", np.uint8, False, None),
    "window": ("window", np.uint8, False, None),
    "window_chunked": ("window", np.uint8, False, 5),
    "fused_frames": ("fused", np.uint8, False, None),
    "fused_windows_mirror": ("fused", np.float32, True, 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_rcr_matches_jax(same_initialisations, case):
    backend, dtype, mirror, chunk = CASES[case]
    r = train_both(backend, dtype, mirror, chunk)
    n = 8 * (2 if mirror else 1) * 3
    assert len(r["port_rows"]) == len(r["jax_rows"]) == 2
    moved = 0.0
    for port, ref in zip(r["port_rows"], r["jax_rows"]):
        assert port.shape == ref.shape == (n, 12)
        np.testing.assert_allclose(port, ref, rtol=0, atol=ROWS_PX)
        moved = max(moved, float(np.abs(port - r["port_rows"][0]).max()))
    # rows come back in image coordinates: the last level lands near the
    # ground truth of each sample's face
    gt = r["gt"]
    if mirror:
        assert r["port_rows"][-1].shape[0] == 2 * 3 * len(gt)
    else:
        err = np.abs(r["port_rows"][-1] - np.repeat(gt, 3, axis=0))
        assert float(err.mean()) < 3.0
    for port, ref in zip(r["model"].sdo.regressors,
                         r["jax_model"].sdo.regressors):
        w, w_ref = port.weights.numpy(), np.asarray(ref.weights)
        assert w.shape == w_ref.shape == (6 * 16 * 9 + 1, 12)
        dw = float(np.abs(w - w_ref).mean())
        assert dw < WEIGHTS_ABS
        assert dw < WEIGHTS_REL * float(np.abs(w_ref).mean())
        assert port.method == "lu"
    # the port-trained model, carried across, detects what the JAX-trained
    # model detects
    frames = r["frames"].astype(np.float32)
    args = (jnp.asarray(frames), jnp.asarray(r["boxes"]))
    ref = np.asarray(r["jax_model"].detect_batch(
        *args, image_indices=jnp.arange(len(frames))))
    got = np.asarray(carried_to_jax(r["model"]).detect_batch(
        *args, image_indices=jnp.arange(len(frames))))
    np.testing.assert_allclose(got, ref, rtol=0, atol=DETECT_PX)
    own = r["model"].detect_batch(torch.from_numpy(frames),
                                  r["boxes"]).numpy()
    np.testing.assert_allclose(own, ref, rtol=0, atol=DETECT_PX)


def test_window_and_fused_require_roi():
    frames, boxes, gt = tiny_data()
    for backend in ("window", "fused"):
        with pytest.raises(ValueError, match="requires config.roi"):
            training.train_rcr(
                frames, gt, boxes, NAMES, RIGHT, LEFT, MEAN,
                training.RcrTrainConfig(patch_backend=backend),
                device="cpu")
    with pytest.raises(ValueError, match="outside"):
        training.train_rcr(
            frames, gt, boxes, NAMES, RIGHT, LEFT, MEAN,
            training.RcrTrainConfig(roi=ROI), image_indices=np.arange(8) + 1,
            device="cpu")


def test_train_rcr_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    frames, boxes, gt = tiny_data()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.train_rcr(frames, gt, boxes, NAMES, RIGHT, LEFT, MEAN)


def test_fused_routes_frames_mode_only_for_aligned_uint8(monkeypatch):
    # which of K5 / K6 a stack reaches: the frames-mode eligibility rule
    seen = []
    real = training.HogTransform

    def spy(images, *a, **kw):
        seen.append((kw["frame_table"] is not None, images.dtype,
                     tuple(images.shape)))
        return real(images, *a, **kw)

    monkeypatch.setattr(training, "HogTransform", spy)
    frames, boxes, gt = tiny_data()
    cfg = training.RcrTrainConfig(
        hog_params=(HogParams(HogVariant.Uoctti, 3, 4, 4, 0.8),),
        num_perturbations=1, roi=ROI, patch_backend="fused")

    def route(stack, config=cfg):
        training.train_rcr(stack, gt, boxes, NAMES, RIGHT, LEFT, MEAN,
                           config, device="cpu")
        return seen.pop()

    assert route(frames) == (True, torch.uint8, (8, 192, 128))
    # float32 pixels, a height off the 32-row grain, a width off the
    # 128-column grain: per-face bf16 windows for K6
    assert route(frames.astype(np.float32)) == (
        False, torch.bfloat16, (8, ROI, ROI))
    assert route(np.pad(frames, ((0, 0), (0, 8), (0, 0)))) == (
        False, torch.bfloat16, (8, ROI, ROI))
    assert route(np.pad(frames, ((0, 0), (0, 0), (0, 8)))) == (
        False, torch.bfloat16, (8, ROI, ROI))
    gather = training.RcrTrainConfig(
        hog_params=cfg.hog_params, num_perturbations=1, roi=ROI)
    assert route(frames, gather) == (False, torch.uint8, (8, ROI, ROI))


# ------------------------------------------------------------------ #
# Augmentation
# ------------------------------------------------------------------ #
def test_perturb_facebox_matches_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(10, 200, (5, 4)).astype(np.float32)
    tx, ty = rng.normal(size=(2, 5)).astype(np.float32) * 0.1
    s = (1 + rng.normal(size=5) * 0.1).astype(np.float32)
    got = training.perturb_facebox(torch.from_numpy(boxes),
                                   torch.from_numpy(tx),
                                   torch.from_numpy(ty),
                                   torch.from_numpy(s)).numpy()
    ref = np.asarray(jax_training.perturb_facebox(boxes, tx, ty, s))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    # scaling keeps the centre; translation is a fraction of the side
    plain = training.perturb_facebox(torch.tensor([10.0, 20, 100, 50]),
                                     0.1, -0.2, 0.5)
    torch.testing.assert_close(plain, torch.tensor([45.0, 22.5, 50, 25]))
    same = training.perturb_facebox(torch.from_numpy(boxes), 0.0, 0.0)
    torch.testing.assert_close(same, torch.from_numpy(boxes))


def test_augment_initialisations_structure_and_seeds():
    boxes = torch.tensor([[10.0, 20, 100, 100], [50, 60, 80, 90],
                          [5, 5, 40, 60]])
    mean = torch.from_numpy(MEAN)

    def draw(seed, **kw):
        return training.augment_initialisations(
            mean, boxes, torch.Generator().manual_seed(seed),
            num_perturbations=4, **kw)

    x0, s2b = draw(3)
    assert x0.shape == (15, 12) and x0.dtype == torch.float32
    assert s2b.tolist() == [0] * 5 + [1] * 5 + [2] * 5
    # the unperturbed box comes first in each group
    from superviseddescent_tpu_torch.models.rcr import align_mean
    torch.testing.assert_close(x0[::5], align_mean(mean[None], boxes),
                               rtol=0, atol=0)
    assert float((x0[1] - x0[0]).abs().max()) > 0.1
    # perturbations of the scale the sigmas give (4% of a 100 px box)
    assert float((x0[1:5] - x0[0]).abs().max()) < 30
    again, _ = draw(3)
    other, _ = draw(4)
    torch.testing.assert_close(again, x0, rtol=0, atol=0)
    assert float((other - x0).abs().max()) > 0.1
    none, s2b0 = training.augment_initialisations(
        mean, boxes, torch.Generator().manual_seed(0), num_perturbations=0)
    torch.testing.assert_close(none, align_mean(mean[None], boxes))
    assert s2b0.tolist() == [0, 1, 2]


def test_rotation_jitter_turns_about_the_centroid():
    boxes = torch.tensor([[10.0, 20, 100, 100], [50, 60, 80, 90]])
    mean = torch.from_numpy(MEAN)
    plain, _ = training.augment_initialisations(
        mean, boxes, torch.Generator().manual_seed(1), num_perturbations=3)
    turned, _ = training.augment_initialisations(
        mean, boxes, torch.Generator().manual_seed(1), num_perturbations=3,
        sigma_rotation=0.2)
    l = 6
    # the same translation / scale draws, then a rotation: centroids and
    # the distances to them are kept, the unperturbed copies are untouched
    for rows in (plain, turned):
        assert rows.shape == (8, 12)
    torch.testing.assert_close(turned[::4], plain[::4], rtol=0, atol=0)
    cp = torch.stack([plain[:, :l].mean(1), plain[:, l:].mean(1)], 1)
    ct = torch.stack([turned[:, :l].mean(1), turned[:, l:].mean(1)], 1)
    torch.testing.assert_close(ct, cp, rtol=0, atol=1e-3)
    rp = torch.hypot(plain[:, :l] - cp[:, :1], plain[:, l:] - cp[:, 1:])
    rt = torch.hypot(turned[:, :l] - ct[:, :1], turned[:, l:] - ct[:, 1:])
    torch.testing.assert_close(rt, rp, rtol=0, atol=1e-3)
    assert float((turned[1] - plain[1]).abs().max()) > 0.5


@pytest.mark.parametrize("model_file", ["rcr22_lfpw5.bin", "rcr29_lfpw5.bin",
                                        "rcr68_lfpw5.bin"])
def test_mirror_permutation_matches_jax(model_file):
    names = load_detection_model(
        os.path.join(REPO, "pretrained", model_file)).landmark_ids
    try:
        ref = jax_mirror_permutation(names)
    except ValueError as e:
        # the shipped 29-point ibug subset is one-sided: both refuse it,
        # naming the same landmark
        with pytest.raises(ValueError) as raised:
            mirror_permutation(names)
        assert str(raised.value) == str(e)
        assert model_file == "rcr29_lfpw5.bin"
        return
    perm = mirror_permutation(names)
    np.testing.assert_array_equal(perm, ref)
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm[perm], np.arange(len(names)))


def test_mirror_permutation_rejects_a_one_sided_set():
    with pytest.raises(ValueError, match="not mirror-closed"):
        mirror_permutation(["37", "40", "31"])
    np.testing.assert_array_equal(mirror_permutation(NAMES),
                                  [3, 2, 1, 0, 4, 5])


# ------------------------------------------------------------------ #
# Window origins
# ------------------------------------------------------------------ #
BORDER_BOXES = np.float32([
    [-40, -30, 90, 90],      # off the top-left corner: negative origins
    [60, 140, 80, 80],       # bottom-right: clamped
    [0.5, 47.5, 127, 97],    # centres at .5: round half to even
    [1.5, 48.5, 127, 97],
    [20, 40, 80, 80],
    [-200, 500, 30, 30],     # far outside
])


def test_crop_face_windows_match_jax_on_border_boxes():
    frames, _, _ = tiny_data()
    idx = np.array([0, 1, 2, 3, 7, 5], np.int32)
    for roi in (96, 128):
        ref_w, ref_o = jax_training._crop_face_windows(
            frames, idx, BORDER_BOXES, roi)
        got_w, got_o = training._crop_face_windows(
            torch.from_numpy(frames), torch.from_numpy(idx),
            torch.from_numpy(BORDER_BOXES), roi)
        assert got_w.dtype == torch.uint8 and got_o.dtype == torch.float32
        np.testing.assert_array_equal(got_o.numpy(), ref_o)
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(ref_w))
    with pytest.raises(ValueError, match="exceeds"):
        training._crop_face_windows(
            torch.from_numpy(frames), torch.from_numpy(idx),
            torch.from_numpy(BORDER_BOXES), 256)


@pytest.mark.parametrize("h,w,roi", [(192, 128, 128), (1024, 768, 512),
                                     (544, 640, 512), (512, 512, 512),
                                     (160, 384, 128)])
def test_frames_mode_origins_match_the_jax_arithmetic(h, w, roi):
    # the JAX train_rcr computes these inline (numpy, host side): round
    # half to even, floor to the (32, 128) grain, then clamp
    scale = np.float32([w / 128, h / 192, 1, 1])
    boxes = BORDER_BOXES * scale
    ry = roi + (32 if h >= roi + 32 else 0)
    rx = roi + (128 if w >= roi + 128 else 0)
    cx = boxes[:, 0] + boxes[:, 2] / 2.0
    cy = boxes[:, 1] + boxes[:, 3] / 2.0
    ref_oy = np.clip(np.round(cy - roi / 2.0).astype(np.int32) // 32 * 32,
                     0, h - ry)
    ref_ox = np.clip(np.round(cx - roi / 2.0).astype(np.int32) // 128 * 128,
                     0, w - rx)
    oy, ox, window = aligned_window_origins(h, w, torch.from_numpy(boxes),
                                            roi)
    assert window == (ry, rx)
    np.testing.assert_array_equal(oy.numpy(), ref_oy)
    np.testing.assert_array_equal(ox.numpy(), ref_ox)
    assert oy.dtype == ox.dtype == torch.int32
    assert (oy.numpy() % 32 == 0).all() and (ox.numpy() % 128 == 0).all()
    assert (oy.numpy() + ry <= h).all() and (ox.numpy() + rx <= w).all()
