"""Hello-world HOG landmark detection: 5 of the 68 ibug landmarks.

The port of ``examples/landmark_detection.py`` (reference:
examples/landmark_detection.cpp): non-adaptive HOG (3 cells of 12 px, a
relative patch size that keeps the adaptive size near the HOG input), 3
regressors, MatrixNorm 0.1, trained and scored on its own images. The
images are the first five of the 300 x 450 class of the repository's
``.synth120`` set. Like the reference (landmark_detection.cpp:420-427) the
faceboxes come from Haar cascade face detection, here the port's detector
with the carried stock ``haarcascade_frontalface_alt2.xml``; an image with
no detection takes a box derived from its ground truth, as the JAX example
does. Runs on the card unless ``--device cpu`` is given.

    python -m superviseddescent_tpu_torch.examples.landmark_detection
"""

import argparse
import glob
import os
import tempfile

import numpy as np

from superviseddescent_tpu_torch import Regulariser, RegularisationType
from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.facedetect import HaarCascadeDetector
from superviseddescent_tpu_torch.models.rcr import (
    HogParams, gt_facebox)
from superviseddescent_tpu_torch.models.rcr_training import (
    RcrTrainConfig, normalised_landmark_errors, train_rcr)
from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from superviseddescent_tpu_torch.utils.device import resolve_device
from superviseddescent_tpu_torch.utils.landmarks import (
    resolve_eye_indices, to_landmark_collection, to_row)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".synth120")
IMAGE_SHAPE = (450, 300)
NUM_IMAGES = 5

# 5 landmarks: nose tip, right eye outer, left eye outer, mouth corners
# (landmark_detection.cpp:129-143 uses ibug ids 31, 37, 46, 49, 55)
LANDMARKS = ["31", "37", "46", "49", "55"]
RIGHT_EYE, LEFT_EYE = ["37"], ["46"]


def training_images():
    """(images, ground-truth rows) of the first NUM_IMAGES pairs of the
    IMAGE_SHAPE class."""
    images, rows = [], []
    for png in sorted(glob.glob(os.path.join(DATA, "*.png"))):
        img = load_gray_image(png)
        if img.shape != IMAGE_SHAPE:
            continue
        images.append(img)
        rows.append(to_row(read_pts_landmarks(png[:-4] + ".pts")
                           .filter(LANDMARKS)))
        if len(images) == NUM_IMAGES:
            return images, np.stack(rows)
    raise SystemExit(f"fewer than {NUM_IMAGES} {IMAGE_SHAPE[1]} x "
                     f"{IMAGE_SHAPE[0]} .png/.pts pairs in {DATA}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    device = resolve_device(p.parse_args(argv).device)

    images, gt_rows = training_images()
    # the reference's pipeline: detectMultiScale(1.2, 2, 50x50)
    # (landmark_detection.cpp:420-427), one read-back for the class
    det = HaarCascadeDetector(STOCK_FRONTAL_ALT2, scale_factor=1.2,
                              min_neighbors=2, min_size=(50, 50),
                              device=device)
    boxes = []
    for found, r in zip(det.detect_batch(np.stack(images)), gt_rows):
        boxes.append(found[0] if len(found) else
                     gt_facebox(to_landmark_collection(r, LANDMARKS)))
    boxes = np.stack(boxes).astype(np.float32)
    stack, _ = stack_images(images)

    # mean from the training shapes mapped into facebox space
    def to_box_space(row, box):
        l = len(LANDMARKS)
        x, y, w, h = box
        return np.concatenate([(row[:l] - x) / w - 0.5,
                               (row[l:] - y) / h - 0.5])
    mean = np.mean([to_box_space(r, b) for r, b in zip(gt_rows, boxes)],
                   axis=0).astype(np.float32)

    # non-adaptive: 3 cells x 12 px, 4 bins (landmark_detection.cpp:440);
    # a large relative patch keeps the IED-adaptive size near the HOG input
    hog = tuple(HogParams(HogVariant.Uoctti, 3, 12, 4, 1.0)
                for _ in range(3))
    cfg = RcrTrainConfig(
        hog_params=hog,
        regularisation=Regulariser(RegularisationType.MatrixNorm, 0.1, True),
        num_perturbations=5, seed=0)

    right_idx, left_idx = resolve_eye_indices(LANDMARKS, RIGHT_EYE, LEFT_EYE)
    model = train_rcr(stack, gt_rows, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE,
                      mean, cfg, device=device)

    pred = model.detect_batch(stack, boxes)
    err = normalised_landmark_errors(
        pred, pred.new_tensor(gt_rows), right_idx, left_idx)
    print(f"IOD-normalised detect error over {len(images)} images: "
          f"{float(err.mean()):.4f}")
    out = os.path.join(tempfile.gettempdir(), "landmark_detection_model.bin")
    model.save(out)
    print(f"Saved {out}")

    lc = to_landmark_collection(pred[0].cpu().numpy(), LANDMARKS)
    for name, (x, y) in zip(lc.names, lc.coordinates):
        print(f"  {name}: ({x:.1f}, {y:.1f})")
    return 0


if __name__ == "__main__":
    main()
