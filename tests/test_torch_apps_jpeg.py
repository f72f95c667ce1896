"""The apps on JPEG inputs, the port against the JAX package, on the CPU.

``rcr_track`` over a 4-frame clip of 1000 x 700 4:2:0 JPEG frames
(``torch_apps_helpers.write_clip(jpeg=True)``: the drifting ``.synth120``
face of ``tests/test_torch_apps_track.py``, tinted), tracked by pretrained
RCR-22 from the face detector's box on frame 0: the port's rows within
0.02 px of the JAX app's (that file's tolerance for the fused kernel, K3
in both apps), at depth 2 and by ``--scan``. The pretrained model drifts
as a tracker in both packages alike (``tests/test_torch_tracking.py``
chains it over 4 frames); training a tracking model on the CPU would take
half a minute. The JAX app reads the frames with PIL, the
port with its own decoder (``--device cpu``: the Python entropy decoder
and J1's plain twin), and the two decoders give the same pixels
(``tests/test_torch_jpeg.py``).

The same clip written as progressive JPEG (PIL decodes it to the same
pixels, so the JAX app's rows are the baseline clip's): the port's rows
bit-equal to its rows on the baseline clip, and so within 0.02 px of the
JAX app's.

``-o`` in both apps: each annotated frame is written under its own name
(``fNN.jpg``) and the JAX app's file (PIL's drawing and JPEG writer) is
held byte for byte against the port's (PIL's drawing rules in
``apps/_draw``, its encoder's twins in ``io/jpeg_write``), once both
apps' landmarks are shown to map to the same drawn pixels (the
truncated corners of every ring).

``rcr_detect -i face.jpg -f -o out.jpg`` with pretrained RCR-22 on a
baseline 4:2:0, a progressive and an Adobe CMYK still of one face, and
``-i face.pgm``: the landmarks within 1e-3 px of JAX's
(``tests/test_torch_apps_io.py``) and, where they draw the same pixels,
``out.jpg`` byte-equal to the JAX app's.
"""

import os

import numpy as np
import pytest

from superviseddescent_tpu.apps import rcr_detect as jax_detect
from superviseddescent_tpu.apps import rcr_track as jax_track
from superviseddescent_tpu.models import rcr as jax_rcr
from superviseddescent_tpu_torch.apps import rcr_detect, rcr_track
from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
from superviseddescent_tpu_torch.models import rcr as port_rcr
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    PRETRAINED, SYNTH, assert_same_events, one_torch_thread,
    record_detect, run_app, track_events, write_clip)
from torch_jpeg_fixtures import encode, tint

pytestmark = pytest.mark.usefixtures("one_torch_thread")
FUSED_PX = 0.02
EXACT_PX = 1e-3
N_FRAMES = 4


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    root = tmp_path_factory.mktemp("track_jpeg")
    frames = str(root / "frames")
    write_clip(frames, N_FRAMES, jpeg=True)
    frame0 = load_gray_image(os.path.join(frames, "f00.jpg"), device="cpu")
    box = HaarCascadeDetector(STOCK_FRONTAL_ALT2, scale_factor=1.2,
                              min_neighbors=2, min_size=(50, 50),
                              device="cpu").detect(frame0)[0]
    return dict(frames=frames,
                model=os.path.join(PRETRAINED, "rcr22_lfpw5.bin"),
                box=",".join(repr(float(v)) for v in box))


@pytest.fixture(scope="module")
def progressive_frames(clip):
    """The clip's frames as progressive JPEG: PIL reads the same pixels."""
    from PIL import Image
    frames = os.path.join(os.path.dirname(clip["frames"]), "progressive")
    write_clip(frames, N_FRAMES, jpeg=True, progressive=True)
    for name in sorted(os.listdir(frames)):
        assert np.array_equal(
            np.asarray(Image.open(os.path.join(frames, name))),
            np.asarray(Image.open(os.path.join(clip["frames"], name))))
    return frames


def argv(clip, *extra):
    return ["-m", clip["model"], "-f", clip["frames"], "--facebox",
            clip["box"], *extra]


def pil_corners(monkeypatch, store):
    """Record the integer corners PIL draws of every ellipse and
    rectangle (C's truncation of the float corners the JAX apps pass)."""
    from PIL import ImageDraw
    for name in ("ellipse", "rectangle"):
        original = getattr(ImageDraw.ImageDraw, name)

        def recording(self, xy, *a, _original=original, _name=name, **kw):
            store.append((_name, tuple(int(float(v)) for v in xy)))
            return _original(self, xy, *a, **kw)
        monkeypatch.setattr(ImageDraw.ImageDraw, name, recording)


def port_corners(coordinates, box=None):
    """The same corners from the port's drawing rules."""
    c = np.asarray(coordinates, np.float32).reshape(-1, 2)
    two = np.float32(2)
    out = [("ellipse", tuple(int(float(v)) for v in (*(p - two), *(p + two))))
           for p in c]
    if box is not None:
        x, y, w, h = box
        out.append(("rectangle", tuple(int(float(v))
                                       for v in (x, y, x + w, y + h))))
    return out


@pytest.fixture(scope="module")
def jax_events(clip, tmp_path_factory):
    """The JAX app's rows at depth 2, its annotated frames and the corners
    it drew, frame by frame."""
    out_dir = tmp_path_factory.mktemp("jax_annotated")
    mp = pytest.MonkeyPatch()
    corners = []
    try:
        pil_corners(mp, corners)
        rc, text = run_app(mp, jax_track, argv(clip, "--depth", "2", "-o",
                                               str(out_dir)))
    finally:
        mp.undo()
    assert rc == 0
    events = track_events(text)
    assert [e[:2] for e in events] == [("row", i) for i in range(N_FRAMES)]
    per_frame = len(corners) // N_FRAMES
    return dict(events=events, out_dir=out_dir, corners=[
        corners[k * per_frame:(k + 1) * per_frame] for k in range(N_FRAMES)])


@pytest.mark.parametrize("mode", [["--depth", "2"], ["--scan"]])
def test_track_jpeg_frames_match_jax(monkeypatch, clip, jax_events, mode,
                                     tmp_path):
    out_dir = tmp_path / "annotated"
    drawn = []
    annotate = rcr_track.annotate

    def recording(path, out, coordinates, box=None, device=None):
        drawn.append(port_corners(coordinates))
        return annotate(path, out, coordinates, box, device)
    monkeypatch.setattr(rcr_track, "annotate", recording)
    rc, text = run_app(monkeypatch, rcr_track, argv(
        clip, *mode, "--device", "cpu", "-o", str(out_dir)))
    assert rc == 0
    assert_same_events(track_events(text), jax_events["events"], FUSED_PX)
    assert (f"tracked {N_FRAMES} frames: {N_FRAMES} fused fits (0 refits), "
            "0 exact fits") in text
    names = [f"f{k:02d}.jpg" for k in range(N_FRAMES)]
    assert sorted(os.listdir(out_dir)) == names
    # the rows agree within FUSED_PX; they draw the same pixels ...
    assert drawn == jax_events["corners"]
    # ... and so the port writes the JAX app's (PIL's) bytes
    for name in names:
        assert (out_dir / name).read_bytes() == (
            jax_events["out_dir"] / name).read_bytes(), name


def test_track_progressive_frames_match_jax(monkeypatch, clip,
                                           progressive_frames, jax_events):
    runs = []
    for frames in (clip["frames"], progressive_frames):
        rc, text = run_app(monkeypatch, rcr_track, argv(
            dict(clip, frames=frames), "--depth", "2", "--device", "cpu"))
        assert rc == 0
        runs.append(track_events(text))
    assert_same_events(runs[1], runs[0], 0)
    assert_same_events(runs[1], jax_events["events"], FUSED_PX)


def still(kind, path):
    """The face of synth_0001, tinted, as a 4:2:0 still: baseline,
    progressive, or (``cmyk``) PIL's Adobe CMYK of it."""
    from PIL import Image
    grey = load_gray_image(os.path.join(SYNTH, "synth_0001.png"))
    rgb = tint(grey.astype(np.uint8), 1)
    if kind == "cmyk":
        Image.fromarray(rgb).convert("CMYK").save(path, "JPEG", quality=90)
    else:
        path.write_bytes(encode(rgb, "4:2:0", 90,
                                progressive=kind == "progressive"))


@pytest.mark.parametrize("kind", ["baseline", "progressive", "cmyk", "pgm"])
def test_rcr_detect_on_a_jpeg_matches_jax(monkeypatch, tmp_path, kind):
    image = tmp_path / ("face.pgm" if kind == "pgm" else "face.jpg")
    if kind == "pgm":
        from PIL import Image
        Image.fromarray(load_gray_image(os.path.join(
            SYNTH, "synth_0001.png")).astype(np.uint8)).save(image)
    else:
        still(kind, image)
    common = ["-m", os.path.join(PRETRAINED, "rcr22_lfpw5.bin"), "-i",
              str(image)]
    want, got, jax_drawn = [], [], []
    record_detect(monkeypatch, jax_rcr.DetectionModel, want)
    record_detect(monkeypatch, port_rcr.DetectionModel, got)
    jax_out = tmp_path / "jax.jpg"
    with monkeypatch.context() as mp:
        pil_corners(mp, jax_drawn)
        rc, _ = run_app(monkeypatch, jax_detect, common + [
            "-f", STOCK_FRONTAL_ALT2, "-o", str(jax_out)])
    assert rc == 0
    out = tmp_path / "out.jpg"
    rc, text = run_app(monkeypatch, rcr_detect, common + [
        "-f", "-o", str(out), "--device", "cpu"])
    assert rc == 0
    (box, coords), (jax_box, jax_coords) = got[0], want[0]
    assert len(got) == len(want) == 1 and coords.shape == (22, 2)
    np.testing.assert_allclose(box, jax_box, rtol=1e-6, atol=0)
    np.testing.assert_allclose(coords, jax_coords, atol=EXACT_PX, rtol=0)
    assert f"Wrote {out}" in text
    # the same drawn pixels, so the JAX app's (PIL's) bytes
    assert port_corners(coords, box) == jax_drawn
    assert out.read_bytes() == jax_out.read_bytes()
