"""rcr-detect: detect landmarks in one image with a trained RCR model.

The port of ``superviseddescent_tpu/apps/rcr_detect.py`` (reference:
rcr-detect.cpp). The facebox comes from ``--facebox x,y,w,h``, from
ground-truth landmarks (``--pts``), or from the port's Haar cascade face
detector (``-f``; with no file named, the stock
``haarcascade_frontalface_alt2.xml`` carried in
``superviseddescent_tpu_torch/data/``). ``-o`` writes the image with the
landmarks and the box drawn as PIL draws them (``apps/_draw.py``), in the
format its extension names, as PIL's ``save`` chooses it: PNG, JPEG
(through kernel J2 on the device), BMP / DIB, PNM, TIFF, GIF (PIL's
median-cut palette) or WebP (libwebp's lossy encoder at PIL's defaults);
a format the port does not write is refused by name, an unknown or
missing extension raises. The image
is a PNG, a JPEG (every kind PIL reads but arithmetic coding, 12-bit and
lossless; its pixel stage runs on the device, kernel J1), a BMP, a PNM
(grey PFM too), a TIFF (every kind PIL reads; a JPEG-compressed one
through J1), a GIF, a WebP (a lossy one through W1-W3) or a JPEG 2000
file (JP2 or a raw codestream, through D1 and M1) (``io/image.py``). Runs on the card unless ``--device cpu`` is given;
the landmark fit (``DetectionModel.detect``) and the face
detector are plain PyTorch operations on that device.

    python -m superviseddescent_tpu_torch.apps.rcr_detect -m model.bin \\
        -i face.jpg -f -o out.jpg
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Detect facial landmarks with a trained RCR model "
                    "(PyTorch port)")
    p.add_argument("-m", "--model", required=True, help="trained model file")
    p.add_argument("-i", "--image", required=True,
                   help="image to detect in (PNG, JPEG, BMP, PNM, TIFF, GIF, "
                        "WebP or JPEG 2000)")
    p.add_argument("--facebox", default=None, help="x,y,w,h")
    p.add_argument("--pts", default=None,
                   help="derive the facebox from this ground-truth .pts file")
    p.add_argument("-f", "--face-detector", nargs="?", default=None,
                   const="", metavar="XML",
                   help="OpenCV Haar cascade XML for built-in face detection"
                        " (with no file: the carried "
                        "haarcascade_frontalface_alt2.xml)")
    p.add_argument("-o", "--output", default=None,
                   help="write the image with the landmarks and the box "
                        "drawn, in the format of the name's extension (.png,"
                        " .jpg, .bmp, .ppm, .tif, .gif, .webp, ...)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)

    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, gt_facebox)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    from superviseddescent_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    try:
        model = DetectionModel.load(args.model, device=device)
    except (OSError, ValueError) as e:
        print(f"Error loading the model: {e}")
        return 1

    image = load_gray_image(args.image, device=device)

    if args.facebox:
        box = tuple(float(v) for v in args.facebox.split(","))
    elif args.pts:
        from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
        lms = read_pts_landmarks(args.pts).filter(model.landmark_ids)
        box = gt_facebox(lms)
    elif args.face_detector is not None:
        from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
        from superviseddescent_tpu_torch.models.facedetect import (
            HaarCascadeDetector)
        det = HaarCascadeDetector(args.face_detector or STOCK_FRONTAL_ALT2,
                                  scale_factor=1.2, min_neighbors=2,
                                  min_size=(50, 50), device=device)
        boxes = det.detect(image)
        if len(boxes) == 0:
            print("No face detected.")
            return 1
        box = tuple(float(v) for v in boxes[0])
    else:
        print("Provide --facebox, --pts, or --face-detector [cascade.xml].")
        return 1

    landmarks = model.detect(image, box)
    for name, (x, y) in zip(landmarks.names, landmarks.coordinates):
        print(f"{name}: {x:.2f} {y:.2f}")

    if args.output:
        from superviseddescent_tpu_torch.apps._draw import annotate
        written = annotate(args.image, args.output, landmarks.coordinates,
                           box, device=device)
        print(f"Wrote {written}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
