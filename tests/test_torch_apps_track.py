"""``rcr_track``, the port's app against the JAX package's, on the CPU.

A 6-frame clip of 1000 x 700 PNG frames (both apps pad them to 1024 x 768
for the fused kernel) shows one ``.synth120`` face (the 728 x 1023 class)
at offsets that drift by up to 3 px per frame; frame 3 is cut to its
top-left 520 x 520 corner, which the face lies below, so the row tracked
from frame 2 is out of that frame and the loss test trips
(``torch_apps_helpers.write_clip``). The model is an RCR-22 tracking model
that the port trains on the clip's face (the pretrained models drift as
trackers), the first box the face detector's on frame 0.

The JAX app runs once, fused at depth 3 (its rows do not depend on the
depth): the loss is read while frames 4 and 5 are in flight, and it fits
them again from the box. The port runs fused at depth 1 and 3: the same
rows within 0.02 px (the fast class of ``tests/test_torch_fused_small.py``;
both apps hand the padded frames to the frames kernel K3 as uint8), the
same loss, and every frame reported exactly once, the frames in flight
fitted again through a new stream (the JAX app's fall-back path drops
in-flight frames; the port has none). The exact fit through the same clip:
``test_torch_apps_track_exact.py``.

The port alone, on the clip without its short frame: ``--scan`` gives the
stream's rows bit for bit; the loss test gets each frame's own shape in
every mode (the fix of the JAX app's padded-shape check); a fused failure
raises instead of falling back; a ``*.jpg`` frame that does not decode is
refused by name (JPEG clips: ``tests/test_torch_apps_jpeg.py``); ``-o``
writes the annotated frames.
"""

import os

import numpy as np
import pytest

from superviseddescent_tpu.apps import rcr_track as jax_track
from superviseddescent_tpu_torch.apps import rcr_track
from superviseddescent_tpu_torch.io.png import read_png
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    FRAME_SHAPE, LOSS_EVENTS, LOSS_FRAME, assert_same_events,
    one_torch_thread, run_app, track_case, track_events, write_clip)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FUSED_PX = 0.02
N_FRAMES = 6


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("track")
    case = track_case(str(root), loss=True, n=N_FRAMES)
    case["whole"] = str(root / "whole")
    write_clip(case["whole"], N_FRAMES)
    return case


def argv(clip, *extra, frames=None):
    return ["-m", clip["model"], "-f", frames or clip["frames"],
            "--facebox", clip["box"], *extra]


def port_run(monkeypatch, clip, *extra, frames=None):
    rc, text = run_app(monkeypatch, rcr_track,
                       argv(clip, *extra, "--device", "cpu", frames=frames))
    assert rc == 0
    return text


@pytest.fixture(scope="module")
def jax_events(clip):
    mp = pytest.MonkeyPatch()
    try:
        rc, text = run_app(mp, jax_track, argv(clip, "--depth", "3"))
    finally:
        mp.undo()
    assert rc == 0
    events = track_events(text)
    assert [e[:2] for e in events] == LOSS_EVENTS, text
    return events


@pytest.mark.parametrize("depth", [1, 3])
def test_fused_rows_and_loss_match_jax(monkeypatch, clip, jax_events,
                                       depth):
    text = port_run(monkeypatch, clip, "--depth", str(depth))
    events = track_events(text)
    assert [e[:2] for e in events] == LOSS_EVENTS, text
    assert_same_events(events, jax_events, FUSED_PX)
    assert "using the fused whole-cascade kernel" in text
    # the frames dispatched after the lost one rode the lost chain: fitted
    # again from the box, each reported once
    in_flight = list(range(LOSS_FRAME + 1, min(LOSS_FRAME + 1 + depth,
                                               N_FRAMES)))
    refits = [int(line.split()[1]) for line in text.splitlines()
              if "(refit)" in line]
    assert refits == in_flight
    assert (f"tracked {N_FRAMES} frames: {N_FRAMES + len(in_flight)} fused "
            f"fits ({len(in_flight)} refits), 0 exact fits") in text
    tag = f"(lag {depth})" if depth > 1 else "(pipelined)"
    assert sum(tag in line for line in text.splitlines()) == (
        N_FRAMES - len(in_flight))


def test_scan_gives_the_stream_rows(monkeypatch, clip, tmp_path):
    out_dir = tmp_path / "annotated"
    stream = track_events(port_run(monkeypatch, clip, "--depth", "2",
                                   frames=clip["whole"]))
    assert [e[:2] for e in stream] == [("row", i) for i in range(N_FRAMES)]
    text = port_run(monkeypatch, clip, "--scan", "-o", str(out_dir),
                    frames=clip["whole"])
    assert f"scan: {N_FRAMES} frames in" in text
    assert_same_events(track_events(text), stream, 0.0)
    written = sorted(os.listdir(out_dir))
    assert written == [f"f{k:02d}.png" for k in range(N_FRAMES)]
    for name in written:
        rgb = read_png(out_dir / name)
        assert rgb.shape == FRAME_SHAPE + (3,)
        assert (rgb == (0, 255, 0)).all(axis=2).sum() > 0


def test_scan_refuses_frames_of_other_shapes(monkeypatch, clip):
    with pytest.raises(SystemExit, match="same-shape"):
        port_run(monkeypatch, clip, "--scan")


def test_loss_check_uses_the_unpadded_shape():
    """A row inside the pad margin of a 1000 x 700 frame (padded to
    1024 x 768): lost against the frame's own shape, which the port's app
    passes; in frame against the padded shape, which the JAX app passes
    for fused and scanned rows (its rcr_track.py:185, and :223 through the
    padded frame it keeps in flight, :303)."""
    l = 22
    row = np.float32([710.0 + k for k in range(l)]
                     + [300.0 + 2 * k for k in range(l)])
    assert not rcr_track.estimate_ok(row, (1000, 700))
    assert rcr_track.estimate_ok(row, rcr_track.pad_align(
        np.zeros((1000, 700), np.uint8)).shape)
    assert rcr_track.estimate_ok(row - 20.0, (1000, 700))


@pytest.mark.parametrize("mode", [["--depth", "2"], ["--no-fused"],
                                  ["--scan"]])
def test_app_checks_loss_against_each_frame_shape(monkeypatch, clip, mode):
    shapes = []
    check = rcr_track.estimate_ok

    def recording(row, shape):
        shapes.append(tuple(shape))
        return check(row, shape)
    monkeypatch.setattr(rcr_track, "estimate_ok", recording)
    port_run(monkeypatch, clip, *mode, frames=clip["whole"])
    assert shapes == [FRAME_SHAPE] * N_FRAMES


def test_fused_failure_raises(monkeypatch, clip):
    """No fall-back to the exact fit: a failing fused fit stops the app."""
    from superviseddescent_tpu_torch.models import rcr

    def fail(self, *args, **kwargs):
        raise RuntimeError("injected fused failure")
    monkeypatch.setattr(rcr.FusedDetector, "__call__", fail)
    with pytest.raises(RuntimeError, match="injected fused failure"):
        port_run(monkeypatch, clip, "--depth", "2", frames=clip["whole"])


def test_jpg_frames_are_refused_by_name(clip, tmp_path):
    """``*.jpg`` frames are read (the port decodes JPEG); a truncated one
    stops the app with an error that names it."""
    frames = tmp_path / "frames"
    write_clip(str(frames), 2)
    (frames / "f01b.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="f01b.jpg: JPEG stream ends"):
        rcr_track.main(argv(clip, "--device", "cpu", frames=str(frames)))
