"""Port patch sampling vs the JAX package.

``extract_patches`` must be bit-equal. K2's plain twin (the CPU side of
``ops/patches_window.sample_patches_window``) is held against the JAX Pallas
sampler in interpret mode, in the cases of tests/test_patches_window.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.ops.patches import (
    extract_patches as jax_extract, rgb_to_gray_u8 as jax_gray,
    stack_images as jax_stack)
from superviseddescent_tpu.ops.patches_pallas import (
    sample_patches_window as jax_sample)
from superviseddescent_tpu_torch.ops.patches import (
    extract_patches, rgb_to_gray_u8, stack_images)
from superviseddescent_tpu_torch.ops.patches_window import (
    sample_patches_window)


def make_case(seed=0, n=3, r=128, l=4):
    rng = np.random.default_rng(seed)
    wins = rng.integers(0, 256, size=(n, r, r)).astype(np.float32)
    cx = rng.uniform(10, r - 10, (n, l)).astype(np.float32)
    cy = rng.uniform(10, r - 10, (n, l)).astype(np.float32)
    phw = rng.uniform(5, 14, (n,)).astype(np.float32).round()
    return wins, cx, cy, phw


def both(wins, cx, cy, phw, s, **kw):
    ref = np.asarray(jax_sample(
        jnp.asarray(wins), jnp.asarray(cx), jnp.asarray(cy),
        jnp.asarray(phw), s, interpret=True,
        **{k: (jnp.bfloat16 if v is torch.bfloat16 else v)
           for k, v in kw.items()}), np.float32)
    got = sample_patches_window(
        torch.from_numpy(wins), torch.from_numpy(cx), torch.from_numpy(cy),
        torch.from_numpy(phw), s, **kw).float().numpy()
    return got, ref


def case_sub_windows():
    return make_case(), dict(sub_window=48)


def case_lane_sub_window():
    wins, cx, cy, phw = make_case(seed=2, n=3, r=384, l=5)
    return ((wins, cx * (374.0 / 118.0), cy * (374.0 / 118.0), phw),
            dict(sub_window=48, sub_window_x=256))


def case_lane_border():
    wins = make_case(seed=4, n=2, r=384)[0]
    cx = np.tile(np.float32([3.0, 381.0, 130.0]), (2, 1))
    cy = np.tile(np.float32([378.0, 2.0, 128.0]), (2, 1))
    return ((wins, cx, cy, np.full((2,), 8.0, np.float32)),
            dict(sub_window=48, sub_window_x=256))


def case_border():
    wins = make_case()[0]
    cx = np.tile(np.float32([2.0, 126.0]), (3, 1))
    cy = np.tile(np.float32([125.0, 1.0]), (3, 1))
    return ((wins, cx, cy, np.full((3,), 8.0, np.float32)),
            dict(sub_window=48))


def case_rows_only():
    rng = np.random.default_rng(7)
    n, ry, rx, l = 3, 64, 384, 4
    wins = rng.integers(0, 256, size=(n, ry, rx)).astype(np.float32)
    cx = rng.uniform(12, rx - 12, (n, l)).astype(np.float32)
    cy = rng.uniform(12, ry - 12, (n, l)).astype(np.float32)
    phw = rng.uniform(5, 11, (n,)).astype(np.float32).round()
    return (wins, cx, cy, phw), dict(sub_window=40, sub_window_x=256)


def case_truncated():
    # patches larger than the sub-window: taps outside it contribute 0
    wins, cx, cy, _ = make_case(seed=5)
    return ((wins, cx, cy, np.full((3,), 30.0, np.float32)),
            dict(sub_window=32))


CASES = {"sub_windows": case_sub_windows, "lane": case_lane_sub_window,
         "lane_border": case_lane_border, "border": case_border,
         "rows_only": case_rows_only, "truncated": case_truncated}


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_twin_unquantized_exact(name, transposed):
    args, kw = CASES[name]()
    got, ref = both(*args, 24, quantize=False, sampling="exact",
                    transposed=transposed, **kw)
    # the Pallas kernel's float32 tent dots contract in another order (and
    # may fuse multiply-adds); 5e-3 grey levels is the bound
    # tests/test_patches_window.py uses for the same kernel
    np.testing.assert_allclose(got, ref, atol=5e-3)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_twin_quantized_exact(name, transposed):
    args, kw = CASES[name]()
    got, ref = both(*args, 24, quantize=True, sampling="exact",
                    transposed=transposed, **kw)
    # only pixels on a .5 rounding boundary may flip (measured: none)
    d = np.abs(got - ref)
    assert d.max() <= 1.0 and (d > 0).mean() < 0.02


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_window_twin_fast_is_equal(name, transposed):
    args, kw = CASES[name]()
    got, ref = both(*args, 24, quantize=True, sampling="fast",
                    transposed=transposed, **kw)
    # bf16 x small-integer products are exact in float32 and each pass
    # rounds once to bf16, so the order of the two-tap sums cannot matter
    np.testing.assert_array_equal(got, ref)


def test_window_twin_bf16_output_and_uint8_windows():
    (wins, cx, cy, phw), kw = case_sub_windows()
    got, ref = both(wins, cx, cy, phw, 16, quantize=True,
                    out_dtype=torch.bfloat16, **kw)
    np.testing.assert_array_equal(got, ref)
    direct = sample_patches_window(
        torch.from_numpy(wins.astype(np.uint8)), torch.from_numpy(cx),
        torch.from_numpy(cy), torch.from_numpy(phw), 16, **kw)
    np.testing.assert_array_equal(direct.numpy(), ref)


def test_window_wrapper_validates_sub_windows():
    wins, cx, cy, phw = (torch.from_numpy(a) for a in make_case())
    with pytest.raises(ValueError, match="multiples of 8"):
        sample_patches_window(wins, cx, cy, phw, 24, sub_window=44)
    with pytest.raises(ValueError, match="128"):
        sample_patches_window(wins[:, :, :120].contiguous(), cx, cy, phw, 24,
                              sub_window_x=64)


@pytest.mark.parametrize("quantize", [False, True])
def test_extract_patches_bit_equal(quantize):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(2, 90, 120)).astype(np.float32)
    idx = np.array([0, 1, 1], np.int32)
    # centres near and past the borders exercise the zero padding
    cx = rng.uniform(-5, 125, (3, 6)).astype(np.float32)
    cy = rng.uniform(-5, 95, (3, 6)).astype(np.float32)
    phw = np.float32([6, 17, 30])          # up- and down-scaling
    ref = np.asarray(jax_extract(jnp.asarray(images), jnp.asarray(idx),
                                 jnp.asarray(cx), jnp.asarray(cy),
                                 jnp.asarray(phw), 30, quantize=quantize))
    got = extract_patches(torch.from_numpy(images), torch.from_numpy(idx),
                          torch.from_numpy(cx), torch.from_numpy(cy),
                          torch.from_numpy(phw), 30, quantize=quantize)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_stack_images_and_gray_match_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, size=s).astype(np.uint8)
            for s in ((30, 200), (47, 129))]
    for kw in (dict(dtype=np.uint8, pad_width_to=128), dict()):
        ours, sizes = stack_images(imgs, **kw)
        ref, ref_sizes = jax_stack(imgs, **kw)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(sizes, ref_sizes)
    rgb = rng.integers(0, 256, size=(7, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(rgb_to_gray_u8(rgb), jax_gray(rgb))


@pytest.mark.parametrize("transposed,itemsize", [(False, 4), (False, 2),
                                                 (True, 4), (True, 2)])
def test_window_launch_plan_is_valid(transposed, itemsize):
    from superviseddescent_tpu_torch.ops import patches_window as k2
    for s in range(1, k2._MAX_SIZE + 1):
        pitch = k2._tile_pitch(s, 16 // itemsize)
        # whole 16-byte words, an odd number of them, covering a column
        assert pitch >= s and pitch * itemsize % 32 == 16
        for nl in (1, 2, 7, 8, 9, 4096 * 22 + 3, 4096 * 68):
            g = k2.launch_plan(nl, s, transposed, itemsize)
            assert 1 <= g <= min(k2._PER_BLOCK, nl)
            if transposed:
                assert g == 1 or k2._shared_bytes(
                    s, g, transposed, itemsize) <= k2._PLAN_SHARED
            else:
                assert g == min(k2._PER_BLOCK, nl)
