"""Port io layer vs the JAX package: cereal models, PNG decoding, .pts."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from superviseddescent_tpu.io.cereal import (
    load_detection_model as jax_load_cereal)
from superviseddescent_tpu.io.pts import read_pts_landmarks as jax_read_pts
from superviseddescent_tpu.ops.patches import (
    load_gray_image as jax_load_gray)
from superviseddescent_tpu_torch.io.cereal import (
    load_detection_model, save_detection_model)
from superviseddescent_tpu_torch.io.png import decode_png, read_png
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import DetectionModel
from superviseddescent_tpu_torch.ops.patches import load_gray_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ["rcr22_lfpw5.bin", "rcr29_lfpw5.bin", "rcr68_lfpw5.bin"]
# one .synth120 image of each of the five sizes
IMAGES = ["synth_0000", "synth_0001", "synth_0002", "synth_0003",
          "synth_0004"]


def model_path(name):
    return os.path.join(REPO, "pretrained", name)


def image_path(stem, ext=".png"):
    return os.path.join(REPO, ".synth120", stem + ext)


@pytest.mark.parametrize("name", MODELS)
def test_cereal_load_matches_jax(name):
    ours = load_detection_model(model_path(name))
    ref = jax_load_cereal(model_path(name))
    assert len(ours.regressors) == len(ref.regressors)
    for a, b in zip(ours.regressors, ref.regressors):
        np.testing.assert_array_equal(a.weights, b.weights)
        assert (a.regularisation_type, a.lambda_, a.regularise_last_row) == (
            b.regularisation_type, b.lambda_, b.regularise_last_row)
    np.testing.assert_array_equal(ours.mean, ref.mean)
    for field in ("norm_model_landmarks", "norm_right_eye_ids",
                  "norm_left_eye_ids", "landmark_ids", "right_eye_ids",
                  "left_eye_ids"):
        assert getattr(ours, field) == getattr(ref, field)
    assert [vars(p) for p in ours.hog_params] == [
        vars(p) for p in ref.hog_params]


@pytest.mark.parametrize("name", MODELS)
def test_cereal_save_is_byte_identical(name, tmp_path):
    out = tmp_path / name
    save_detection_model(load_detection_model(model_path(name)), out)
    with open(model_path(name), "rb") as f:
        assert out.read_bytes() == f.read()


def test_detection_model_save_is_byte_identical(tmp_path):
    model = DetectionModel.load(model_path(MODELS[0]), device="cpu")
    model.save(tmp_path / "m.bin")
    with open(model_path(MODELS[0]), "rb") as f:
        assert (tmp_path / "m.bin").read_bytes() == f.read()


@pytest.mark.parametrize("stem", IMAGES)
def test_png_decoder_matches_pil(stem):
    ours = read_png(image_path(stem))
    ref = np.asarray(Image.open(image_path(stem)))
    assert ours.shape == ref.shape + (1,)
    np.testing.assert_array_equal(ours[..., 0], ref)
    np.testing.assert_array_equal(load_gray_image(image_path(stem)),
                                  jax_load_gray(image_path(stem)))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "LA"])
def test_png_colour_types_match_pil(mode, tmp_path):
    rng = np.random.default_rng(0)
    channels = len(mode)
    # smooth rows so the encoder picks a mix of filters
    pixels = np.cumsum(rng.integers(0, 8, (37, 53, channels)), axis=1
                       ).astype(np.uint8)
    path = tmp_path / "img.png"
    Image.fromarray(pixels, mode).save(path)
    np.testing.assert_array_equal(read_png(path), pixels)
    np.testing.assert_array_equal(load_gray_image(path), jax_load_gray(path))


def test_png_rejects_unsupported():
    """Every valid PNG decodes (16-bit as PIL reads it:
    tests/test_torch_jpeg.py); what is left to refuse is invalid: here RGB
    at 4 bits, a depth the standard does not allow for colour type 2."""
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "PNG")
    data = bytearray(buf.getvalue())
    assert data[24:26] == b"\x08\x02"            # IHDR bit depth, colour
    data[24] = 4
    with pytest.raises(ValueError, match="invalid PNG: bit depth 4, "
                       "colour type 2"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


@pytest.mark.parametrize("stem", IMAGES[:2])
def test_pts_matches_jax(stem):
    ours = read_pts_landmarks(image_path(stem, ".pts"))
    ref = jax_read_pts(image_path(stem, ".pts"))
    assert ours.names == ref.names
    np.testing.assert_array_equal(ours.coordinates, ref.coordinates)
