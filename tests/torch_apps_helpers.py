"""Inputs and runners shared by the app tests (``tests/test_torch_apps_*``).

The apps' input files are written under the test's temporary directory
from files in the repository: the 68-point mean CSV from
``pretrained/rcr68_lfpw5.bin``'s mean, the INFO training config with
``rcr22_lfpw5.bin``'s 22 landmark ids and the inter-eye-distance config with
its eye ids; images are ``.synth120`` pairs, or frames the tests write.

Both packages' apps run in-process through ``main(argv)`` on the CPU: the JAX
package with its Pallas kernels in interpret mode, the port with
``--device cpu``. Their printed boxes and landmark coordinates are rounded;
``run_app`` shadows ``round`` in the app's module so that the bboxes print
at full precision, then parses them.
"""

import contextlib
import glob
import io
import os
import re
import shutil

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.io.cereal import load_detection_model
from superviseddescent_tpu_torch.io.png import write_png
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from superviseddescent_tpu_torch.utils.landmarks import to_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, ".synth120")
PRETRAINED = os.path.join(REPO, "pretrained")
FLOAT = r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?|nan|-?inf"


def write_config_files(directory):
    """(mean CSV, training config, eval config) paths under ``directory``."""
    m68 = load_detection_model(os.path.join(PRETRAINED, "rcr68_lfpw5.bin"))
    m22 = load_detection_model(os.path.join(PRETRAINED, "rcr22_lfpw5.bin"))
    assert m68.landmark_ids == [str(i) for i in range(1, 69)]
    mean = os.path.join(directory, "mean_68.txt")
    with open(mean, "w") as f:
        f.write(",".join(repr(float(v))
                         for v in np.asarray(m68.mean).ravel()) + "\n")
    config = os.path.join(directory, "rcr_training_22.cfg")
    with open(config, "w") as f:
        f.write("modelLandmarks\n{\n    landmarks\n    {\n"
                + "".join(f"        {i}\n" for i in m22.landmark_ids)
                + "    }\n}\n")
    evaluation = os.path.join(directory, "rcr_eval.cfg")
    with open(evaluation, "w") as f:
        f.write("interEyeDistance\n{\n"
                f'    rightEye "{" ".join(m22.right_eye_ids)}"\n'
                f'    leftEye "{" ".join(m22.left_eye_ids)}"\n}}\n')
    return mean, config, evaluation


def synth_of_shape(shape, count):
    """The first ``count`` .synth120 images of one (h, w) size class."""
    out = []
    for png in sorted(glob.glob(os.path.join(SYNTH, "*.png"))):
        if load_gray_image(png).shape == shape:
            out.append(png)
            if len(out) == count:
                return out
    raise AssertionError(f"fewer than {count} images of shape {shape}")


def copy_pairs(pngs, directory):
    os.makedirs(directory, exist_ok=True)
    for png in pngs:
        shutil.copy(png, directory)
        shutil.copy(png[:-4] + ".pts", directory)
    return directory


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, restored afterwards.
    The apps' CPU paths are many small operations, as fast on one thread as
    on eight (measured: 0.84-1.04 s a 6-frame run either way); with several
    test workers on the machine, every worker's pool of eight spinning
    threads made them 50x slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def run_app(monkeypatch, module, argv):
    """(return code, stdout) of ``module.main(argv)``, with ``round``
    shadowed in the module so that its bboxes print unrounded."""
    monkeypatch.setattr(module, "round", lambda v, ndigits=None: v,
                        raising=False)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue()


def track_events(out):
    """The tracking apps' per-frame lines: [("row", i, bbox (4,)),
    ("lost", i), ...] in the order printed."""
    events = []
    for line in out.splitlines():
        m = re.match(r"frame (\d+) \(.*\): .*bbox \((.*)\)$", line)
        if m:
            events.append(("row", int(m.group(1)), np.float64(
                re.findall(FLOAT, m.group(2)))))
        elif re.match(r"frame \d+: tracking lost", line):
            events.append(("lost", int(line.split()[1].rstrip(":"))))
    return events


def assert_same_events(got, want, atol):
    """The same frames and losses in the same order, bboxes within atol."""
    assert [e[:2] for e in got] == [e[:2] for e in want], (got, want)
    for g, w in zip(got, want):
        if g[0] == "row":
            np.testing.assert_allclose(g[2], w[2], atol=atol, rtol=0)


def record_detect(monkeypatch, cls, store):
    """Record (facebox, unrounded coordinates) of every ``cls.detect``."""
    fit = cls.detect

    def recording(self, image, facebox):
        lms = fit(self, image, facebox)
        store.append((tuple(float(v) for v in facebox),
                      np.asarray(lms.coordinates, np.float64)))
        return lms
    monkeypatch.setattr(cls, "detect", recording)


def detect_lines(out):
    """rcr_detect's landmark lines: {name: (x, y)}."""
    rows = {}
    for line in out.splitlines():
        m = re.match(rf"(\w+): ({FLOAT}) ({FLOAT})$", line)
        if m:
            rows[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return rows


# ------------------------------------------------------------- tracking
TRACK_IMAGE = "synth_0003"          # the 728 x 1023 class
# Frames that are not 32- and 128-aligned: both apps pad them to
# 1024 x 768 (544 x 640) and hand them to the fused kernel as uint8 (K3).
# An aligned frame the JAX app hands over as float32 (the crop kernel K4),
# the port as uint8 (K3); the two kernels' rows differ by up to 0.06 px
# over this clip, in both packages alike.
FRAME_SHAPE = (1000, 700)
TRACK_ORIGIN = (260, 20)            # image row / column offset of frame 0
LOSS_FRAME = 3
LOSS_SHAPE = (520, 520)
# the per-frame events of a 6-frame clip through that loss
LOSS_EVENTS = ([("row", i) for i in range(LOSS_FRAME + 1)]
               + [("lost", LOSS_FRAME)]
               + [("row", i) for i in range(LOSS_FRAME + 1, 6)])


def frame_offsets(n, seed=0):
    """(n, 2) integer offsets drifting by up to 3 px per frame and axis."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(-3, 4, size=(n, 2))
    steps[0] = 0
    return np.asarray(TRACK_ORIGIN) + np.cumsum(steps, axis=0)


def write_clip(directory, n=6, loss=False, shape=FRAME_SHAPE, jpeg=False,
               progressive=False):
    """n PNG frames of ``shape`` showing one .synth120 face at drifting
    offsets; with ``loss``, frame LOSS_FRAME is cut to its top-left
    LOSS_SHAPE corner, which leaves the face (below row 540) out of it.
    With ``jpeg``, each frame is a 4:2:0 JPEG (quality 90, PIL) of a seeded
    tint of it (``torch_jpeg_fixtures.tint``) instead; with
    ``progressive`` too, a progressive one of the same pixels.
    Returns the (n, 2) [row, column] offsets of the image."""
    os.makedirs(directory, exist_ok=True)
    image = load_gray_image(
        os.path.join(SYNTH, TRACK_IMAGE + ".png")).astype(np.uint8)
    h, w = shape
    offs = frame_offsets(n)
    for k, (oy, ox) in enumerate(offs):
        frame = np.zeros(shape, np.uint8)
        src = image[:h - oy, :w - ox]
        frame[oy:oy + src.shape[0], ox:ox + src.shape[1]] = src
        if loss and k == LOSS_FRAME:
            frame = frame[:LOSS_SHAPE[0], :LOSS_SHAPE[1]]
        if jpeg:
            from torch_jpeg_fixtures import encode, tint
            with open(os.path.join(directory, f"f{k:02d}.jpg"), "wb") as f:
                f.write(encode(tint(frame, 0), "4:2:0", 90,
                               progressive=progressive))
        else:
            write_png(os.path.join(directory, f"f{k:02d}.png"), frame)
    return offs


def tracking_model(path, frame0, box):
    """Train an RCR-22 tracking model with the port on the CPU and save it:
    the clip's face in frame 0, its own shape in ``box`` as the mean, so
    that the perturbed initialisations are the face displaced by a few
    pixels, which is what a previous frame's row is (the pretrained models
    drift as trackers; tests/test_torch_tracking.py)."""
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    m22 = load_detection_model(os.path.join(PRETRAINED, "rcr22_lfpw5.bin"))
    truth = read_pts_landmarks(os.path.join(SYNTH, TRACK_IMAGE + ".pts"))
    row = to_row(truth.filter(m22.landmark_ids))
    l = row.shape[0] // 2
    oy, ox = TRACK_ORIGIN
    row = row + np.float32([ox] * l + [oy] * l)
    box = np.float32(box)
    mean = np.concatenate([(row[:l] - box[0]) / box[2] - 0.5,
                           (row[l:] - box[1]) / box[3] - 0.5]).astype(
                               np.float32)
    copies = 8
    model = train_rcr(
        frame0[None].astype(np.uint8), np.repeat(row[None], copies, 0),
        np.repeat(box[None], copies, 0), m22.landmark_ids,
        m22.right_eye_ids, m22.left_eye_ids, mean,
        RcrTrainConfig(seed=0), image_indices=np.zeros(copies, np.int64),
        device="cpu")
    model.save(path)
    return path


def track_case(root, loss=False, n=6):
    """A clip under ``root`` (``write_clip``), the face detector's box on
    its frame 0 and a tracking model trained there: dict(frames, model,
    box)."""
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    frames = os.path.join(root, "frames")
    write_clip(frames, n, loss=loss)
    frame0 = load_gray_image(os.path.join(frames, "f00.png"))
    det = HaarCascadeDetector(STOCK_FRONTAL_ALT2, scale_factor=1.2,
                              min_neighbors=2, min_size=(50, 50),
                              device="cpu")
    box = det.detect(frame0)[0]
    model = tracking_model(os.path.join(root, "track.bin"), frame0, box)
    return dict(frames=frames, model=model,
                box=",".join(repr(float(v)) for v in box))


# ------------------------------------------------------------- training
WEIGHTS_ABS = 1e-3      # tests/test_torch_training.py
WEIGHTS_REL = 1e-3
PRINTED_TOL = 1e-4


def train_case(root, count=8, shape=(450, 300)):
    """The training inputs under ``root``: the config files and ``count``
    .synth120 pairs of one size class (default the 300 x 450 class)."""
    mean, config, evaluation = write_config_files(root)
    data = copy_pairs(synth_of_shape(shape, count),
                      os.path.join(root, "data"))
    return dict(root=root, data=data, mean=mean, config=config,
                evaluation=evaluation)


def train_argv(case, output, *extra):
    return ["-d", case["data"], "-m", case["mean"], "-c", case["config"],
            "-e", case["evaluation"], "-o", output, "--levels", "2",
            "--num-perturbations", "0", *extra]


def printed_numbers(out):
    """Every 'label: number' line of a training run, in order."""
    return [(m.group(1), float(m.group(2))) for m in (
        re.match(rf"(NLSR .*|Normalised LM-error .*): ({FLOAT})$", line)
        for line in out.splitlines()) if m]


def assert_same_training(got_out, want_out, got_model, want_model,
                         error_files=None):
    """Printed residuals and errors within 1e-4, per-level weights within
    the training tolerances, and the same .error.txt columns."""
    got, want = printed_numbers(got_out), printed_numbers(want_out)
    assert [g[0] for g in got] == [w[0] for w in want] and got
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               atol=PRINTED_TOL, rtol=0)
    skipped = [l for l in got_out.splitlines() if "skipped" in l
               or l.startswith("Kept")]
    assert skipped == [l for l in want_out.splitlines() if "skipped" in l
                       or l.startswith("Kept")]
    a, b = load_detection_model(got_model), load_detection_model(want_model)
    assert len(a.regressors) == len(b.regressors) == 2
    for ra, rb in zip(a.regressors, b.regressors):
        w, w_ref = np.asarray(ra.weights), np.asarray(rb.weights)
        assert w.shape == w_ref.shape
        dw = float(np.abs(w - w_ref).mean())
        assert dw < WEIGHTS_ABS
        assert dw < WEIGHTS_REL * float(np.abs(w_ref).mean())
    np.testing.assert_array_equal(a.mean, b.mean)
    assert a.landmark_ids == b.landmark_ids
    if error_files:
        cols = [np.float64(open(f).read().split(",")) for f in error_files]
        assert cols[0].shape == cols[1].shape == (len(a.landmark_ids),)
        np.testing.assert_allclose(cols[0], cols[1], atol=PRINTED_TOL,
                                   rtol=0)
