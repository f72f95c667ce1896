"""Face boxes at full size, the port's detector against the JAX package's.

``tests/test_torch_facedetect.py`` holds the pyramid, the window masks and
the boxes on images scaled to about 300 px; this file holds raw
(``min_neighbors=0``) and grouped boxes on the first image of each
``.synth120`` size class at its full size (412 x 600 to 728 x 1023), with
the stock cascade carried in the port and the apps' parameters, both on the
CPU. The tie rules are that file's: the boxes must be equal, and a window
can differ only at a stage threshold tie or a .5 pyramid tie, none of
which occurs here.
"""

import os

import numpy as np
import pytest

from superviseddescent_tpu.io.haar import parse_opencv_cascade as jax_parse
from superviseddescent_tpu.models import facedetect as jfd
from superviseddescent_tpu_torch.io.haar import (
    STOCK_FRONTAL_ALT2, parse_opencv_cascade)
from superviseddescent_tpu_torch.models import facedetect as tfd
from superviseddescent_tpu_torch.ops.patches import load_gray_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the first image of each size class (w x h: 412 x 600, 300 x 450,
# 337 x 500, 728 x 1023, 686 x 1024)
IMAGES = ("synth_0000", "synth_0001", "synth_0002", "synth_0003",
          "synth_0004")
PARAMS = dict(scale_factor=1.2, min_size=(50, 50))


@pytest.fixture(scope="module")
def detectors():
    jc = jax_parse(STOCK_FRONTAL_ALT2)
    c = parse_opencv_cascade(STOCK_FRONTAL_ALT2)
    return (jfd.HaarCascadeDetector(jc, min_neighbors=0, **PARAMS),
            tfd.HaarCascadeDetector(c, min_neighbors=0, device="cpu",
                                    **PARAMS))


@pytest.mark.parametrize("name", IMAGES)
def test_full_size_boxes_equal_jax(detectors, name):
    jraw, raw = detectors
    img = load_gray_image(os.path.join(REPO, ".synth120", name + ".png"))
    assert min(img.shape) >= 300
    want, got = jraw.detect(img), raw.detect(img)
    assert want.shape[0] > 0
    np.testing.assert_array_equal(got, want)
    grouped = tfd.group_rectangles(got, 2)
    np.testing.assert_array_equal(grouped, jfd.group_rectangles(want, 2))
    # the grouped boxes as the detectors group them themselves
    np.testing.assert_array_equal(
        grouped, tfd.HaarCascadeDetector(raw.data, min_neighbors=2,
                                         device="cpu", **PARAMS).detect(img))
    if name != "synth_0004":        # grouped, the face is found in four
        assert len(grouped) == 1
