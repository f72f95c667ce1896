"""The port's HOG beyond single-channel patches, and its HOG rendering.

Multi-channel, bilinear-orientation, transposed and polar-field HOG against
the reference C goldens (the tolerances of tests/test_hog_golden.py and
tests/test_hog_polar_viz.py) and against the JAX package's ``hog_cells`` /
``hog_extract`` / ``hog_cells_from_polar`` on the same seeded inputs;
``hog_viz`` against the JAX package's arrays.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.ops import hog as jhog
from superviseddescent_tpu.ops import hog_viz as jviz
from superviseddescent_tpu_torch.ops import hog_viz
from superviseddescent_tpu_torch.ops.hog import (
    HogVariant, hog_cells, hog_cells_from_polar, hog_descriptor, hog_extract)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _golden(name):
    return np.load(os.path.join(GOLDENS, name))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _cases(name):
    data = _golden(name)
    return [(name, i) for i in range(int(data["num_cases"]))]


@pytest.mark.parametrize("name,i", _cases("hog_bilinear_goldens.npz")
                         + _cases("hog_multichannel_goldens.npz")
                         + _cases("hog_transposed_goldens.npz"))
def test_image_goldens(name, i):
    data = _golden(name)
    meta = [int(v) for v in data[f"meta_{i}"]]
    variant, o, _, cs = meta[:4]
    bilinear = name.startswith("hog_bilinear")
    transposed = name.startswith("hog_transposed")
    cells = hog_cells(_t(data[f"input_{i}"][None]), cs, o,
                      bilinear_orientation=bilinear, transposed=transposed)
    out = hog_extract(cells, HogVariant(variant),
                      transposed=transposed)[0].numpy()
    tol = 3e-4 if bilinear else 2e-4
    np.testing.assert_allclose(np.transpose(out, (2, 0, 1)),
                               data[f"output_{i}"], rtol=tol, atol=tol / 10)


@pytest.mark.parametrize("i", range(int(_golden(
    "hog_polar_goldens.npz")["num_cases"])))
def test_polar_goldens(i):
    data = _golden("hog_polar_goldens.npz")
    variant, o, _, cs, directed, bilinear = (int(v) for v in
                                             data[f"meta_{i}"][:6])
    cells = hog_cells_from_polar(
        _t(data[f"mod_{i}"][None]), _t(data[f"ang_{i}"][None]),
        bool(directed), cs, o, bilinear_orientation=bool(bilinear))
    np.testing.assert_allclose(cells[0].permute(2, 0, 1).numpy(),
                               data[f"cells_{i}"], rtol=2e-4, atol=2e-4)
    feats = hog_extract(cells, HogVariant(variant))[0].numpy()
    np.testing.assert_allclose(np.transpose(feats, (2, 0, 1)),
                               data[f"feats_{i}"], rtol=2e-4, atol=2e-5)


def _close(got, ref):
    # the same float32 formulas; the products sum in another order
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(
        1.0, float(np.abs(ref).max())))


@pytest.mark.parametrize("channels,bilinear,transposed,variant", [
    (1, True, False, HogVariant.Uoctti),
    (3, False, False, HogVariant.Uoctti),
    (3, True, True, HogVariant.DalalTriggs),
    (2, False, True, HogVariant.Uoctti),
])
def test_cells_and_extract_match_jax(channels, bilinear, transposed,
                                     variant):
    rng = np.random.default_rng(channels * 10 + bilinear + 2 * transposed)
    imgs = rng.integers(0, 256, size=(4, channels, 30, 30)).astype(np.float32)
    imgs[0, -1] = imgs[0, 0]             # a tie: the first channel wins
    o = 9 if variant == HogVariant.DalalTriggs else 4
    ref_cells = jhog.hog_cells(jnp.asarray(imgs), 6, o,
                               bilinear_orientation=bilinear,
                               transposed=transposed)
    cells = hog_cells(_t(imgs), 6, o, bilinear_orientation=bilinear,
                      transposed=transposed)
    _close(cells.numpy(), np.asarray(ref_cells))
    ref = np.asarray(jhog.hog_extract(ref_cells, variant,
                                      transposed=transposed))
    _close(hog_extract(cells, variant, transposed=transposed).numpy(), ref)


@pytest.mark.parametrize("transposed", [False, True])
def test_descriptor_matches_jax(transposed):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 256, size=(3, 3, 40, 40)).astype(np.float32)
    ref = np.asarray(jhog.hog_descriptor(jnp.asarray(imgs), 8, 4,
                                         transposed=transposed))
    _close(hog_descriptor(_t(imgs), 8, 4, transposed=transposed).numpy(),
           ref)


def test_planar_single_channel_equals_plain():
    rng = np.random.default_rng(7)
    imgs = _t(rng.integers(0, 256, size=(3, 30, 30)))
    assert torch.equal(hog_descriptor(imgs, 6, 4),
                       hog_descriptor(imgs[:, None], 6, 4))


@pytest.mark.parametrize("directed,bilinear", [
    (True, False), (False, False), (True, True), (False, True)])
def test_polar_matches_jax(directed, bilinear):
    rng = np.random.default_rng(11 + 2 * directed + bilinear)
    mod = rng.uniform(-2, 50, size=(3, 24, 24)).astype(np.float32)
    ang = rng.uniform(-7, 13, size=(3, 24, 24)).astype(np.float32)
    ref = np.asarray(jhog.hog_cells_from_polar(
        jnp.asarray(mod), jnp.asarray(ang), directed, 6, 5,
        bilinear_orientation=bilinear))
    got = hog_cells_from_polar(_t(mod), _t(ang), directed, 6, 5,
                               bilinear_orientation=bilinear).numpy()
    _close(got, ref)


@pytest.mark.parametrize("variant,o", [(HogVariant.Uoctti, 4),
                                       (HogVariant.Uoctti, 9),
                                       (HogVariant.DalalTriggs, 9)])
def test_viz_equals_jax(variant, o):
    np.testing.assert_array_equal(hog_viz.hog_flip_permutation(variant, o),
                                  jviz.hog_flip_permutation(variant, o))
    for transposed in (False, True):
        np.testing.assert_array_equal(hog_viz.hog_glyphs(o, transposed),
                                      jviz.hog_glyphs(o, transposed))
    rng = np.random.default_rng(o)
    desc = rng.uniform(-0.1, 0.4, size=(3, 2, jhog.hog_dimension(
        variant, o))).astype(np.float32)
    for transposed in (False, True):
        np.testing.assert_array_equal(
            hog_viz.hog_render(desc, variant, o, transposed),
            jviz.hog_render(desc, variant, o, transposed))


def test_viz_goldens():
    data = _golden("hog_polar_goldens.npz")
    for i in range(int(data["num_cases"])):
        variant, o = (int(v) for v in data[f"meta_{i}"][:2])
        np.testing.assert_array_equal(
            hog_viz.hog_flip_permutation(HogVariant(variant), o),
            data[f"perm_{i}"])
        if f"glyphs_{i}" in data:
            np.testing.assert_array_equal(hog_viz.hog_glyphs(o),
                                          data[f"glyphs_{i}"])
