"""Tracking: the stream and the scan against the sequential chain and JAX.

A tiny random model (``test_torch_fused_small.tiny_pair``: 6 landmarks, 2
levels, regressors scaled up so that each level moves the landmarks by
pixels) tracks
a clip made from one smoothed-noise image that drifts a few pixels per frame
(numpy, seeded; 128-column uint8 frames, the fused frames path). The port
runs on ``device="cpu"`` (the plain twins); the JAX side runs its Pallas
kernel in interpret mode.

Tolerances: stream (every ``chunk`` / ``depth``), scan and the sequential
detector / tracker chain give the same rows exactly (they run the same
calls); against the JAX package 0.02 px, the fast-class limit of
``tests/test_torch_fused_small.py``, over the whole chain.

The last tests chain the pretrained RCR-22 model over a short drifting clip of
a ``.synth120`` face in both packages: used as a tracker it leaves the face
within a few frames, through the exact path and the fused kernel of the JAX
package exactly as through the port (its regressors were trained from the
mean shape aligned into a box, not from rows on the face). That is why
``chip_smoke.py`` tracks its clip with a model trained near the face.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fused_small import tiny_pair
from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import DetectionModel, gt_facebox
from superviseddescent_tpu_torch.models.rcr_training import (
    normalised_landmark_errors)
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from superviseddescent_tpu_torch.utils.landmarks import (
    resolve_eye_indices, to_row)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROI = 128
WHOLE_PX = 0.02
N_FRAMES = 7
SETTINGS = [(1, None), (2, None), (3, None), (8, None), (1, 1), (1, 2),
            (1, 4), (1, 16)]


def drifting_clip(seed=0, n=N_FRAMES, h=192, w=128):
    """(n, h, w) uint8 frames cut from one larger smoothed-noise image at
    origins that drift by up to 2 px per frame, and the first facebox."""
    rng = np.random.default_rng(seed)
    big_h, big_w = h + 4 * n, w + 4 * n
    raw = rng.integers(0, 256, size=(big_h + 4, big_w + 4)).astype(np.float32)
    smooth = sum(raw[dy:dy + big_h, dx:dx + big_w]
                 for dy in range(5) for dx in range(5)) / 25.0
    image = np.clip((smooth - 127.5) * 3 + 127.5, 0, 255).astype(np.uint8)
    steps = rng.integers(0, 3, size=(n, 2))
    steps[0] = 0
    offs = np.cumsum(steps, axis=0)
    frames = np.stack([image[oy:oy + h, ox:ox + w] for oy, ox in offs])
    return frames, np.float32([24, 60, 76, 76])


@pytest.fixture(scope="module")
def case():
    jm, pm = tiny_pair(6, 2)
    frames, box = drifting_clip()
    detector = pm.make_fused_detector(roi=ROI)
    tracker = pm.make_fused_tracker(roi=ROI)
    t_frames = torch.from_numpy(frames)
    rows = [detector(t_frames[:1], box[None])]
    for i in range(1, len(frames)):
        rows.append(tracker(t_frames[i:i + 1], rows[-1]))
    chain = torch.cat(rows).numpy()
    assert np.abs(chain[1:] - chain[:-1]).max() > 0.5   # the rows do move
    return dict(jm=jm, pm=pm, frames=frames, box=box, chain=chain)


class Counting:
    """A frame iterable that counts the frames handed out so far."""

    def __init__(self, frames):
        self.frames = frames
        self.taken = 0

    def __iter__(self):
        for frame in self.frames:
            self.taken += 1
            yield frame


def delivery(stream, frames, box):
    """(rows, frames taken when each row arrived)."""
    source = Counting(frames)
    rows, lags = [], []
    for row in stream(source, box):
        rows.append(np.asarray(row))
        lags.append(source.taken)
    return rows, lags


@pytest.mark.parametrize("chunk,depth", SETTINGS)
def test_stream_rows_equal_the_sequential_chain(case, chunk, depth):
    stream = case["pm"].make_fused_track_stream(ROI, chunk=chunk, depth=depth)
    rows, lags = delivery(stream, list(case["frames"]), case["box"])
    assert len(rows) == N_FRAMES
    assert all(r.shape == (12,) and r.dtype == np.float32 for r in rows)
    np.testing.assert_array_equal(np.stack(rows), case["chain"])
    n = N_FRAMES
    if depth is not None:
        # row i arrives once frame i + depth has been dispatched
        assert lags == [min(i + depth + 1, n) for i in range(n)]
    else:
        # bursts of chunk, one flush behind the dispatch front; the tail
        # after the last frame
        full = n // chunk
        want = [min((i // chunk + 2) * chunk, n) if i // chunk < full - 1
                else n for i in range(n)]
        assert lags == want


def test_stream_accepts_tensors_and_2d_or_3d_frames(case):
    stream = case["pm"].make_fused_track_stream(ROI, chunk=2)
    frames = [torch.from_numpy(f) if i % 2 else f[None]
              for i, f in enumerate(case["frames"])]
    rows = np.stack(list(stream(iter(frames), torch.from_numpy(case["box"]))))
    np.testing.assert_array_equal(rows, case["chain"])
    assert list(stream([], case["box"])) == []


def test_scan_rows_equal_the_sequential_chain(case):
    scan = case["pm"].make_fused_track_scan(ROI)
    rows = scan(torch.from_numpy(case["frames"]), case["box"])
    assert isinstance(rows, torch.Tensor) and rows.shape == (N_FRAMES, 12)
    np.testing.assert_array_equal(rows.numpy(), case["chain"])
    one = scan(case["frames"][:1], case["box"])
    np.testing.assert_array_equal(one.numpy(), case["chain"][:1])
    assert scan(case["frames"][:0], case["box"]).shape == (0, 12)
    with pytest.raises(ValueError, match="stack"):
        scan(case["frames"][0], case["box"])


@pytest.mark.parametrize("kwargs,match", [
    (dict(chunk=0), "chunk must be >= 1"),
    (dict(depth=0), "depth requires chunk=1 and depth >= 1"),
    (dict(chunk=2, depth=2), "depth requires chunk=1 and depth >= 1"),
])
def test_stream_named_errors_match_jax(case, kwargs, match):
    with pytest.raises(ValueError, match=match) as port_err:
        case["pm"].make_fused_track_stream(ROI, **kwargs)
    with pytest.raises(ValueError, match=match) as jax_err:
        case["jm"].make_fused_track_stream(ROI, **kwargs)
    assert str(port_err.value) == str(jax_err.value)


def test_scan_rows_match_jax(case):
    ref = np.asarray(case["jm"].make_fused_track_scan(ROI)(
        jnp.asarray(case["frames"]), jnp.asarray(case["box"])))
    assert ref.shape == case["chain"].shape
    np.testing.assert_allclose(case["chain"], ref, atol=WHOLE_PX, rtol=0)


@pytest.mark.parametrize("chunk,depth", [(3, None), (1, 2)])
def test_stream_rows_and_delivery_match_jax(case, chunk, depth):
    frames = list(case["frames"])
    ref_rows, ref_lags = delivery(
        case["jm"].make_fused_track_stream(ROI, chunk=chunk, depth=depth),
        frames, case["box"])
    rows, lags = delivery(
        case["pm"].make_fused_track_stream(ROI, chunk=chunk, depth=depth),
        frames, case["box"])
    assert lags == ref_lags
    np.testing.assert_allclose(np.stack(rows), np.stack(ref_rows),
                               atol=WHOLE_PX, rtol=0)


def test_single_face_entry_points_follow_detect_batch(case):
    pm = case["pm"]
    image, box = case["frames"][0], case["box"]
    batch_row = pm.detect_batch(torch.from_numpy(image[None]).float(),
                                box[None])[0].numpy()
    lms = pm.detect(image, box)
    assert lms.names == pm.landmark_ids
    np.testing.assert_array_equal(
        np.concatenate([lms.coordinates[:, 0], lms.coordinates[:, 1]]),
        batch_row)
    again = pm.detect_from_landmarks(image, batch_row)
    ref = case["jm"].detect_from_landmarks(image, batch_row)
    # float32 noise over two levels of the plain path
    np.testing.assert_allclose(again.coordinates, ref.coordinates,
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(lms.coordinates,
                               case["jm"].detect(image, box).coordinates,
                               atol=1e-3, rtol=0)


# ------------------------------------------------------------------ #
# the pretrained RCR-22 model as a tracker: it drifts in both packages
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def pretrained():
    """Both packages' pretrained RCR-22, and a 4-frame clip: the first
    .synth120 image on a black (32- and 128-aligned) canvas at integer
    offsets that drift by up to 3 px per frame, with each frame's truth."""
    path = os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin")
    jm, pm = JaxModel.load(path), DetectionModel.load(path, device="cpu")
    file = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))[0]
    image = load_gray_image(file).astype(np.uint8)
    truth = read_pts_landmarks(file[:-4] + ".pts").filter(pm.landmark_ids)
    h, w = image.shape
    rng = np.random.default_rng(0)
    steps = rng.integers(-3, 4, size=(4, 2))
    steps[0] = 0
    offs = 32 + np.cumsum(steps, axis=0)
    frames = np.zeros((4, -(-(h + 64) // 32) * 32, -(-(w + 64) // 128) * 128),
                      np.uint8)
    for k, (oy, ox) in enumerate(offs):
        frames[k, oy:oy + h, ox:ox + w] = image
    n_lm = len(pm.landmark_ids)
    shift = np.concatenate([np.repeat(offs[:, 1:2], n_lm, 1),
                            np.repeat(offs[:, 0:1], n_lm, 1)], axis=1)
    gt = to_row(truth)[None] + shift.astype(np.float32)
    box = np.float32(gt_facebox(truth)) + np.float32(
        [offs[0, 1], offs[0, 0], 0, 0])
    eyes = resolve_eye_indices(pm.landmark_ids, pm.right_eye_ids,
                               pm.left_eye_ids)

    def iod(rows):
        return normalised_landmark_errors(
            torch.from_numpy(np.stack(rows)), torch.from_numpy(gt),
            *eyes).mean(dim=1).numpy()
    return dict(jm=jm, pm=pm, frames=frames, box=box, iod=iod)


def chained(first, later, frames):
    rows = [first(frames[0])]
    for frame in frames[1:]:
        rows.append(later(frame, rows[-1]))
    return rows


def assert_drifts(errs):
    # on the face from the facebox, off it from its own rows
    assert errs[0] < 0.1
    assert all(b > a for a, b in zip(errs, errs[1:]))
    assert errs[1] > 2 * errs[0] and errs[3] > 1.0


def test_pretrained_tracker_drifts_alike_through_the_exact_paths(pretrained):
    jm, pm, box = pretrained["jm"], pretrained["pm"], pretrained["box"]
    ref = chained(lambda f: to_row(jm.detect(f, box)),
                  lambda f, x: to_row(jm.detect_from_landmarks(f, x)),
                  pretrained["frames"])
    got = chained(lambda f: to_row(pm.detect(f, box)),
                  lambda f, x: to_row(pm.detect_from_landmarks(f, x)),
                  pretrained["frames"])
    np.testing.assert_allclose(np.stack(got), np.stack(ref), atol=1e-3,
                               rtol=0)
    assert_drifts(pretrained["iod"](ref))
    assert_drifts(pretrained["iod"](got))


def test_pretrained_tracker_drifts_alike_through_the_fused_paths(pretrained):
    jm, pm, box = pretrained["jm"], pretrained["pm"], pretrained["box"]
    j_det, j_trk = (jm.make_fused_detector(roi=512),
                    jm.make_fused_tracker(roi=512))
    ref = chained(
        lambda f: np.asarray(j_det(jnp.asarray(f[None]),
                                   jnp.asarray(box[None])))[0],
        lambda f, x: np.asarray(j_trk(jnp.asarray(f[None]),
                                      jnp.asarray(x[None])))[0],
        pretrained["frames"])
    detector = pm.make_fused_detector(roi=512)
    tracker = pm.make_fused_tracker(roi=512)
    got = chained(
        lambda f: detector(torch.from_numpy(f[None]), box[None])[0].numpy(),
        lambda f, x: tracker(torch.from_numpy(f[None]),
                             torch.from_numpy(x[None]))[0].numpy(),
        pretrained["frames"])
    np.testing.assert_allclose(np.stack(got), np.stack(ref), atol=WHOLE_PX,
                               rtol=0)
    assert_drifts(pretrained["iod"](ref))
    assert_drifts(pretrained["iod"](got))
