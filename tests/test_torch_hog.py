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


# the patch sides and cell sizes the models use, and the contract's edges
WEIGHT_SHAPES = LEVELS + [(3, 1), (3, 3), (96, 8), (96, 12)]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("s,cs", WEIGHT_SHAPES)
def test_kernel_weight_formula_is_the_twins_table(s, cs, transposed):
    from superviseddescent_tpu.ops.hog_pallas_flat import _flat_consts
    from superviseddescent_tpu_torch.ops.hog_flat import (
        _flat_weights, kernel_weights)
    # K1 forms float32(W[a, ca] * W[b, cb]) from the float64 tents in
    # storage coordinates; the bits must be the twin's table, and the JAX
    # kernel's, in either layout
    got = kernel_weights(s, cs, transposed)
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _flat_weights(s, cs).view(np.uint32))
    c = hog_num_cells(s, cs)
    storage = got.reshape(s, s, c * c)
    if transposed:
        storage = storage.transpose(1, 0, 2)
    jax_table = _flat_consts(s, cs, transposed)[0]
    np.testing.assert_array_equal(
        np.ascontiguousarray(storage).reshape(s * s, c * c).view(np.uint32),
        jax_table.view(np.uint32))


def test_hog_launch_plan_and_shared_layout():
    from superviseddescent_tpu_torch.ops import hog_flat
    # the kernel's Layout at S = 55, C = 5, O = 4, one patch, by hand:
    # tents, orientations, patch, magnitudes, lane slots, parts, cells,
    # energies, factors, bins, each rounded up to 16 bytes (the 2-D splat),
    # and for the separable splat float32 tents, per-thread bin slots and
    # the first pass's (bin, ca, b) sums in place of lane slots and parts
    assert hog_flat._shared_bytes(55, 11, 4, 1, False) == (
        2208 + 32 + 12112 + 12112 + 8192 + 1024 + 800 + 112 + 400 + 3040)
    assert hog_flat._shared_bytes(55, 11, 4, 1, True) == (
        2208 + 1104 + 32 + 12112 + 12112 + 8192 + 8800 + 800 + 112 + 400
        + 3040)
    assert [hog_flat.launch_plan(s, cs, 4, False)
            for s, cs in LEVELS] == [1, 1, 2, 3]
    assert [hog_flat.launch_plan(s, cs, 4, True)
            for s, cs in LEVELS] == [1, 2, 3, 3]
    # the separable splat wherever its buffers fit; not for 16
    # orientations at S = 96, cs = 12
    assert hog_flat.separable(55, 11, 4, 1, False)
    assert not hog_flat.separable(55, 11, 4, 1, True)
    assert not hog_flat.separable(96, 12, 16, 1, False)
    for s in range(3, 97):
        for cs in sorted({1, max(1, s // 8), max(1, s // 5), s}):
            for o in (4, 9, 16):
                for fast in (False, True):
                    p = hog_flat.launch_plan(s, cs, o, fast)
                    # the kernel is built for 1 to 3 patches per block
                    assert 1 <= p <= 3
                    sep = hog_flat.separable(s, cs, o, p, fast)
                    assert p == 1 or hog_flat._shared_bytes(
                        s, cs, o, p, sep) <= hog_flat._PLAN_SHARED


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("s,cs", LEVELS + [(64, 8), (16, 1), (3, 1)])
def test_separable_splat_within_k1_tolerance(s, cs, transposed):
    from superviseddescent_tpu_torch.ops.hog_flat import (
        _flat_weights, separable_cells)
    # the exact-mode kernel's two float32 passes against the twin's 2-D
    # weights (float32(Wy * Wx) from float64), on one-bin magnitude planes
    rng = np.random.default_rng(s)
    c = hog_num_cells(s, cs)
    mags = rng.uniform(0, 360, size=(4, 8, s, s)).astype(np.float32)
    mags[..., 0, :] = mags[..., -1, :] = 0
    mags[..., :, 0] = mags[..., :, -1] = 0
    mags *= rng.integers(0, 2, size=mags.shape)        # sparse bins
    ref = mags.reshape(4, 8, s * s) @ _flat_weights(s, cs)   # [cx, cy]
    planes = mags.transpose(0, 1, 3, 2) if transposed else mags
    got = separable_cells(torch.from_numpy(
        np.ascontiguousarray(planes).reshape(4, 8, s * s)), s, cs,
        transposed).numpy()
    assert got.shape == (4, 8, c * c)
    # float32 rounding of two passes against one: a few ulps of each cell,
    # far inside K1's rtol 1e-4 + atol 1e-5 on the descriptors
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
