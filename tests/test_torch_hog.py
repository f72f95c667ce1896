"""Port HOG vs the reference C goldens and the JAX package.

K1's plain twin (the CPU side of ``ops/hog_flat.hog_descriptor_flat``) is
held against the JAX Pallas kernel run in interpret mode, at the four
RCR-22 level shapes, in exact, fast and fast+transposed mode.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.ops.hog import hog_descriptor as jax_hog
from superviseddescent_tpu.ops.hog_pallas_flat import (
    hog_descriptor_pallas_flat)
from superviseddescent_tpu_torch.ops.hog import (
    HogVariant, hog_descriptor, hog_dimension, hog_num_cells)
from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens",
                       "hog_goldens.npz")
LEVELS = [(55, 11), (50, 10), (40, 8), (30, 6)]   # RCR22_HOG_PARAMS
MODES = [(False, False), (True, False), (True, True)]  # (fast, transposed)


@pytest.mark.parametrize("case", range(12))
def test_hog_matches_reference_goldens(case):
    data = np.load(GOLDENS)
    variant, o, size, cs, ww, hh, dd = (int(v) for v in data[f"meta_{case}"])
    assert hog_num_cells(size, cs) == ww and hog_dimension(
        HogVariant(variant), o) == dd
    img = torch.from_numpy(data[f"input_{case}"][None].astype(np.float32))
    expected = np.transpose(data[f"output_{case}"], (0, 2, 1)).reshape(-1)
    # the README's parity bound against the reference C code
    got = hog_descriptor(img, cs, o, HogVariant(variant))[0].numpy()
    np.testing.assert_allclose(got, expected, rtol=2e-4, atol=2e-5)
    flat = hog_descriptor_flat(img.reshape(1, -1), size, cs, o,
                               HogVariant(variant))[0].numpy()
    np.testing.assert_allclose(flat, expected, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant,o,s,cs", [
    (HogVariant.Uoctti, 4, 55, 11), (HogVariant.Uoctti, 4, 30, 6),
    (HogVariant.DalalTriggs, 9, 64, 8)])
def test_hog_matches_jax(variant, o, s, cs):
    rng = np.random.default_rng(0)
    patches = rng.integers(0, 256, size=(5, s, s)).astype(np.float32)
    ref = np.asarray(jax_hog(jnp.asarray(patches), cs, o, variant))
    got = hog_descriptor(torch.from_numpy(patches), cs, o, variant).numpy()
    # same float32 formulas; only matmul summation order differs
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fast,transposed", MODES)
@pytest.mark.parametrize("s,cs", LEVELS)
def test_flat_twin_matches_pallas_kernel(s, cs, fast, transposed):
    rng = np.random.default_rng(s)
    patches = rng.integers(0, 256, size=(6, s, s)).astype(np.float32)
    if transposed:
        patches = np.ascontiguousarray(patches.transpose(0, 2, 1))
    flat = patches.reshape(6, s * s)
    ref = np.asarray(hog_descriptor_pallas_flat(
        jnp.asarray(flat), s, cs, 4, HogVariant.Uoctti, fast=fast,
        transposed=transposed, interpret=True))
    got = hog_descriptor_flat(torch.from_numpy(flat), s, cs, 4,
                              HogVariant.Uoctti, fast=fast,
                              transposed=transposed).numpy()
    # Exact: the README's 2e-4 relative parity class (measured 4e-7).
    # Fast: both sides round the gradient planes and tent weights to bf16
    # with the same float32 operations and classify sectors with the same
    # float32 compares, so no pixel bins differently; what is left is the
    # float32 summation order of the bf16 splat products, bounded like the
    # exact mode (measured 3e-7 relative).
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_flat_twin_dalaltriggs_and_bf16_input():
    rng = np.random.default_rng(1)
    patches = rng.integers(0, 256, size=(3, 64 * 64)).astype(np.float32)
    ref = np.asarray(hog_descriptor_pallas_flat(
        jnp.asarray(patches), 64, 8, 9, HogVariant.DalalTriggs, block=2,
        interpret=True))
    got = hog_descriptor_flat(torch.from_numpy(patches), 64, 8, 9,
                              HogVariant.DalalTriggs).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
    # integer pixels are exact in bf16
    bf16 = hog_descriptor_flat(torch.from_numpy(patches).bfloat16(), 64, 8, 9,
                               HogVariant.DalalTriggs).numpy()
    np.testing.assert_array_equal(bf16, got)


def test_flat_wrapper_validates_input():
    with pytest.raises(ValueError, match="patches"):
        hog_descriptor_flat(torch.zeros(2, 50), 55, 11, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        hog_descriptor_flat(torch.zeros(2, 900, dtype=torch.uint8), 30, 6, 4)
