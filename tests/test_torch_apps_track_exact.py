"""``rcr_track --no-fused`` through a tracking loss, the port's app against
the JAX package's, on the CPU: the clip of ``test_torch_apps_track.py``
(frame 3 cut so that the face is out of it), the exact fit from the face
detector's box (``--face-detector``, the stock cascade carried in the
port; on the lost frame it finds no face, so the box stays), the same loss
and re-initialisation events, every bbox within 1e-3 px
(``tests/test_torch_rcr.py``'s exact tolerance).
"""

import numpy as np
import pytest

from superviseddescent_tpu.apps import rcr_track as jax_track
from superviseddescent_tpu_torch.apps import rcr_track
from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    FRAME_SHAPE, LOSS_EVENTS, LOSS_SHAPE, assert_same_events,
    one_torch_thread, run_app, track_case, track_events)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
EXACT_PX = 1e-3


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    return track_case(str(tmp_path_factory.mktemp("track_exact")),
                      loss=True)


def argv(clip, *extra):
    return ["-m", clip["model"], "-f", clip["frames"],
            "--face-detector", STOCK_FRONTAL_ALT2, "--no-fused", *extra]


def test_exact_loss_matches_jax(monkeypatch, clip):
    rc, text = run_app(monkeypatch, jax_track, argv(clip))
    assert rc == 0
    want = track_events(text)
    assert [e[:2] for e in want] == LOSS_EVENTS, text
    rc, text = run_app(monkeypatch, rcr_track, argv(clip, "--device", "cpu"))
    assert rc == 0
    got = track_events(text)
    assert [e[:2] for e in got] == LOSS_EVENTS, text
    assert_same_events(got, want, EXACT_PX)
    assert "0 fused fits (0 refits), 6 exact fits" in text


def test_exact_loss_reinitialises_from_a_redetected_box(monkeypatch, clip):
    """A face found on the lost frame is the box the next frame starts
    from (here a box the test puts there)."""
    from superviseddescent_tpu_torch.models import facedetect, rcr
    new_box = np.float32([[200.0, 520.0, 300.0, 300.0]])
    detect = facedetect.HaarCascadeDetector.detect
    fit = rcr.DetectionModel.detect
    shapes, boxes = [], []

    def redetect(self, image):
        shapes.append(image.shape)
        return new_box if image.shape == LOSS_SHAPE else detect(self, image)

    def recording_fit(self, image, facebox):
        boxes.append(tuple(float(v) for v in facebox))
        return fit(self, image, facebox)
    monkeypatch.setattr(facedetect.HaarCascadeDetector, "detect", redetect)
    monkeypatch.setattr(rcr.DetectionModel, "detect", recording_fit)
    rc, text = run_app(monkeypatch, rcr_track, argv(clip, "--device", "cpu"))
    assert rc == 0
    assert [e[:2] for e in track_events(text)] == LOSS_EVENTS
    assert shapes == [FRAME_SHAPE, LOSS_SHAPE]
    first = tuple(float(v) for v in clip["box"].split(","))
    assert boxes == [first, tuple(float(v) for v in new_box[0])]
