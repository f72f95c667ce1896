"""rcr-track: track landmarks over a frame sequence.

The port of ``superviseddescent_tpu/apps/rcr_track.py`` (reference:
rcr-track.cpp). Reads a directory of PNG and JPEG frames
(``*.png``, ``*.jpg``, sorted; a JPEG's pixel stage runs on the device,
kernel J1), fits the first
from a facebox (``--facebox`` or the port's face detector,
``--face-detector``) and every later frame from its predecessor's
landmarks, and re-initialises from a facebox when an estimate is lost
(``estimate_ok``): non-finite, collapsed, or outside the frame. Runs on the
card unless ``--device cpu`` is given.

Fused tracking (the default) runs the whole cascade per frame in one launch
of the hand-written K3 kernel (``csrc/cascade_fused.cu``) through
``DetectionModel.make_fused_track_stream``: each fit is enqueued from the
previous row on the device, and each row comes back through a ring of
pinned buffers with one event per copy, ``--depth`` frames after its
dispatch. Frames go to the kernel as uint8, zero-padded right and bottom to
its (32, 128) alignment (``pad_align``). A frame smaller than the 512-px
ROI, or a face larger than 0.6 of it, takes the exact fit
(``DetectionModel.detect`` / ``detect_from_landmarks``) instead, as does
every frame with ``--no-fused``. ``--scan`` tracks the whole clip with
``make_fused_track_scan`` and checks losses afterwards.

Differences from the JAX app, by intent:
  * the loss test uses each frame's own (h, w), never the padded shape, in
    every mode (the JAX app checks fused rows against the padded shape and
    misses drift into the pad margin);
  * a fused fit that fails raises; there is no silent fall-back to the exact
    fit, and no in-flight frame is dropped. A model that the fused kernel
    does not accept (``ValueError`` when the stream is built) is reported
    and tracked with the exact fit;
  * on a loss, the frames in flight are fitted again by a new stream that
    starts from the (re-detected) facebox, and are reported with the tag
    ``(refit)``: the same rows as the JAX app's synchronous re-fit. Until
    the new chain's first row is read, the face-size rule uses the facebox;
  * the JAX app hands aligned float32 frames to its fused detector; the
    port always hands uint8 frames, so fused tracking runs on K3.

``-o`` writes every frame under its own basename in the format its
extension names, drawn as PIL draws (``apps/_draw``), as the JAX app does;
a JPEG frame is decoded (J1), drawn and encoded (J2) on the device.

    python -m superviseddescent_tpu_torch.apps.rcr_track -m model.bin \\
        -f frames/ --face-detector
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import time
from typing import NamedTuple

import numpy as np

from superviseddescent_tpu_torch.apps._draw import annotate
from superviseddescent_tpu_torch.ops.patches import load_gray_image
from superviseddescent_tpu_torch.utils.landmarks import to_row

ROI = 512
# a face larger than this share of the ROI window is tracked with the
# exact fit: the fused fit would crop or IED-clamp it
FUSED_FACE_SHARE = 0.6


def enclosing_bbox(row):
    """Bounding box of a landmark row (reference: rcr-track.cpp:47-55)."""
    l = row.shape[0] // 2
    x0, y0 = row[:l].min(), row[l:].min()
    x1, y1 = row[:l].max(), row[l:].max()
    return float(x0), float(y0), float(x1 - x0), float(y1 - y0)


def estimate_ok(row, shape):
    """Sanity of a tracked estimate: finite, not collapsed, and not drifted
    out of the frame, whose own (h, w) is ``shape`` (never the padded
    shape). On failure the app re-initialises from a facebox (the
    reference's re-detect-on-loss intent, rcr-track.cpp:168-177)."""
    if not np.isfinite(row).all():
        return False
    x, y, w, h = enclosing_bbox(row)
    hh, ww = shape
    return (w > 5 and h > 5 and x + w > 0 and y + h > 0
            and x < ww and y < hh)


def pad_align(img_u8):
    """Zero-pad a uint8 frame right and bottom to the fused kernel's
    (32, 128) alignment (coordinates are unchanged)."""
    h, w = img_u8.shape
    ph, pw = -(-h // 32) * 32, -(-w // 128) * 128
    if (ph, pw) == (h, w):
        return img_u8
    out = np.zeros((ph, pw), np.uint8)
    out[:h, :w] = img_u8
    return out


class Frame(NamedTuple):
    index: int
    path: str
    image: np.ndarray      # (h, w) float32 gray, as decoded

    @property
    def shape(self):
        return self.image.shape

    def kernel_frame(self):
        """The uint8 frame, padded to the kernel's alignment."""
        return pad_align(self.image.astype(np.uint8))


def bbox_text(row):
    return str(tuple(round(v, 1) for v in enclosing_bbox(row)))


def annotate_row(output_dir, path, row, device=None):
    """With an output directory, write the frame with the row drawn under
    its own basename, in its own format."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        l = row.shape[0] // 2
        annotate(path, os.path.join(output_dir, os.path.basename(path)),
                 np.stack([row[:l], row[l:]], axis=1), device=device)


class Tracker:
    """The per-frame loop of the app: its state is the facebox, the last
    good row and the fit counts."""

    def __init__(self, model, frames, box, face_det, depth, output_dir,
                 fused, device=None):
        self.model = model
        self.device = device
        self.paths = frames
        self.box = box
        self.face_det = face_det
        self.depth = depth
        self.output_dir = output_dir
        self.fused_usable = fused
        self.stream = None
        self.prev_row = None     # the last good row read back
        self.next = 0            # the next frame never fitted
        self._peek = None        # (index, Frame) decoded, not yet fitted
        self.fused_fits = self.exact_fits = self.refits = 0
        self.t_iter = time.time()
        self.lag_tag = (f" (lag {depth})" if depth > 1 else " (pipelined)")

    def frame(self, i) -> Frame:
        if self._peek is None or self._peek[0] != i:
            self._peek = (i, Frame(i, self.paths[i], load_gray_image(
                self.paths[i], device=self.device)))
        return self._peek[1]

    def face_size(self):
        """The size proxy of the face: the last good row's extent, or the
        facebox while the chain starts from it."""
        if self.prev_row is None:
            return max(self.box[2], self.box[3])
        _, _, bw, bh = enclosing_bbox(self.prev_row)
        return max(bw, bh)

    def fused_ok(self, frame: Frame) -> bool:
        """Does this frame go to the fused kernel? Builds the stream on
        first use; a model the kernel does not accept is reported once and
        tracked exactly from then on."""
        h, w = frame.shape
        if (not self.fused_usable or h < ROI or w < ROI
                or self.face_size() > FUSED_FACE_SHARE * ROI):
            return False
        if self.stream is None:
            try:
                self.stream = self.model.make_fused_track_stream(
                    ROI, depth=self.depth)
            except ValueError as e:
                self.fused_usable = False
                print(f"fused kernel unavailable ({e}); using the exact fit")
                return False
            print("using the fused whole-cascade kernel "
                  "(--no-fused for the exact fit)")
        return True

    def lost(self, frame: Frame):
        """A loss: re-detect the facebox on the frame (if a detector is
        given) and restart the chain from it."""
        print(f"frame {frame.index}: tracking lost, re-initialising")
        if self.face_det is not None:
            redetected = self.face_det.detect(frame.image)
            if len(redetected):
                self.box = tuple(float(v) for v in redetected[0])
        self.prev_row = None

    def report(self, frame: Frame, row, tag) -> bool:
        """Print, annotate and loss-check one row; False on a loss."""
        wall_ms = (time.time() - self.t_iter) * 1000.0
        self.t_iter = time.time()
        print(f"frame {frame.index} ({os.path.basename(frame.path)}): fit "
              f"{wall_ms:.1f} ms{tag}, bbox {bbox_text(row)}")
        annotate_row(self.output_dir, frame.path, row, self.device)
        if not estimate_ok(row, frame.shape):
            self.lost(frame)
            return False
        self.prev_row = row
        return True

    def run_stream(self, refit):
        """One fused stream from the facebox: first the frames in ``refit``
        (in flight when the chain was lost), then new frames while they
        qualify. Returns the frames in flight when a loss cut the stream
        short (to be fitted again), else []."""
        in_flight = collections.deque()

        def feed():
            for frame in refit:
                in_flight.append((frame, " (refit)"))
                self.refits += 1
                self.fused_fits += 1
                yield frame.kernel_frame()
            while self.next < len(self.paths):
                frame = self.frame(self.next)
                if not self.fused_ok(frame):
                    return
                self.next += 1
                in_flight.append((frame, self.lag_tag))
                self.fused_fits += 1
                yield frame.kernel_frame()

        for row in self.stream(feed(), np.float32(self.box)):
            frame, tag = in_flight.popleft()
            if not self.report(frame, row, tag):
                return [f for f, _ in in_flight]
        return []

    def exact(self, frame: Frame):
        """The exact fit of one frame, from the last good row or the box."""
        t0 = time.time()
        if self.prev_row is None:
            lms = self.model.detect(frame.image, self.box)
        else:
            lms = self.model.detect_from_landmarks(frame.image,
                                                   self.prev_row)
        row = to_row(lms)
        self.exact_fits += 1
        fit_ms = (time.time() - t0) * 1000.0
        self.t_iter = time.time()
        print(f"frame {frame.index} ({os.path.basename(frame.path)}): fit "
              f"{fit_ms:.1f} ms, bbox {bbox_text(row)}")
        if estimate_ok(row, frame.shape):
            self.prev_row = row
        else:
            self.lost(frame)
        annotate_row(self.output_dir, frame.path, row, self.device)

    def run(self):
        refit = []
        while refit or self.next < len(self.paths):
            if refit or self.fused_ok(self.frame(self.next)):
                refit = self.run_stream(refit)
            else:
                frame = self.frame(self.next)
                self.next += 1
                self.exact(frame)
        print(f"tracked {len(self.paths)} frames: {self.fused_fits} fused "
              f"fits ({self.refits} refits), {self.exact_fits} exact fits")


def track_scan(model, frames, box, output_dir, device=None):
    """--scan: the whole clip through ``make_fused_track_scan``, the loss
    checks afterwards (no mid-clip re-initialisation)."""
    images = [load_gray_image(p, device=device) for p in frames]
    padded = [pad_align(im.astype(np.uint8)) for im in images]
    if len({im.shape for im in padded}) != 1:
        raise SystemExit("--scan requires same-shape frames")
    if padded[0].shape[0] < ROI or padded[0].shape[1] < ROI:
        raise SystemExit(f"--scan requires frames >= {ROI}x{ROI}")
    scan = model.make_fused_track_scan(roi=ROI)
    t0 = time.time()
    rows = scan(np.stack(padded), np.float32(box)).cpu().numpy()
    wall = time.time() - t0
    print(f"scan: {len(frames)} frames in {wall * 1e3:.1f} ms "
          f"({wall / len(frames) * 1e3:.3f} ms/frame incl. upload)")
    for i, (path, row) in enumerate(zip(frames, rows)):
        print(f"frame {i} ({os.path.basename(path)}): bbox {bbox_text(row)}")
        if not estimate_ok(row, images[i].shape):
            print(f"frame {i}: tracking lost (no mid-clip re-init "
                  "in --scan mode)")
        annotate_row(output_dir, path, row, device)
    print(f"tracked {len(frames)} frames: {len(frames)} fused fits "
          "(0 refits), 0 exact fits")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Track facial landmarks over an image sequence "
                    "(PyTorch port)")
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-f", "--frames", required=True,
                   help="directory of *.png and *.jpg frames (sorted)")
    p.add_argument("--facebox", default=None,
                   help="initial facebox x,y,w,h for the first frame")
    p.add_argument("--face-detector", nargs="?", default=None, const="",
                   metavar="XML",
                   help="OpenCV Haar cascade XML (with no file: the carried "
                        "haarcascade_frontalface_alt2.xml): detect the "
                        "initial facebox, and re-detect on tracking loss, "
                        "like the reference app (rcr-track.cpp:141)")
    p.add_argument("-o", "--output-dir", default=None,
                   help="write annotated frames here, each under its own "
                        "name and in its own format")
    p.add_argument("--no-fused", action="store_true",
                   help="track with the exact fit instead of the fused "
                        "whole-cascade kernel")
    p.add_argument("--depth", type=int, default=8,
                   help="read each fused row back D frames after its "
                        "dispatch (the rows are the same for every D; "
                        "output and loss detection lag by D frames). Use "
                        "--depth 1 for per-frame interactive output")
    p.add_argument("--scan", action="store_true",
                   help="offline whole-clip mode: every fit enqueued with "
                        "no host synchronisation between frames and one "
                        "read-back; requires same-shape frames; loss checks "
                        "run afterwards (no mid-clip facebox re-init)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)
    if args.depth < 1:
        raise SystemExit("--depth must be >= 1")

    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    model = DetectionModel.load(args.model, device=device)
    frames = sorted(glob.glob(os.path.join(args.frames, "*.png"))
                    + glob.glob(os.path.join(args.frames, "*.jpg")))
    if not frames:
        raise SystemExit(f"no frames in {args.frames}")

    face_det = None
    if args.face_detector is not None:
        from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
        from superviseddescent_tpu_torch.models.facedetect import (
            HaarCascadeDetector)
        face_det = HaarCascadeDetector(
            args.face_detector or STOCK_FRONTAL_ALT2, scale_factor=1.2,
            min_neighbors=2, min_size=(50, 50), device=device)
    if args.facebox:
        box = tuple(float(v) for v in args.facebox.split(","))
    elif face_det is not None:
        boxes = face_det.detect(load_gray_image(frames[0], device=device))
        if len(boxes) == 0:
            raise SystemExit("no face detected in the first frame")
        box = tuple(float(v) for v in boxes[0])
    else:
        raise SystemExit("provide --facebox or --face-detector")

    if args.scan:
        if args.no_fused:
            raise SystemExit("--scan requires the fused kernel")
        track_scan(model, frames, box, args.output_dir, device)
        return 0
    Tracker(model, frames, box, face_det, args.depth, args.output_dir,
            fused=not args.no_fused, device=device).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
