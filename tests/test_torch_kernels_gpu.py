"""K1 and K2 CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: each test skips unless a CUDA device is present (decided
inside the fixture, never at import). On the card:
``python -m pytest tests/test_torch_kernels_gpu.py -m gpu``.
"""

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.ops.hog import HogVariant
from superviseddescent_tpu_torch.ops.hog_flat import (
    hog_descriptor_flat, hog_descriptor_flat_reference)
from superviseddescent_tpu_torch.ops.patches_window import (
    _prepare, sample_patches_window, sample_patches_window_reference)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("fast,transposed", [(False, False), (True, False),
                                             (True, True)])
@pytest.mark.parametrize("s,cs", [(55, 11), (50, 10), (40, 8), (30, 6)])
def test_hog_kernel_matches_twin(cuda, s, cs, fast, transposed):
    rng = np.random.default_rng(s)
    patches = torch.from_numpy(rng.integers(0, 256, size=(300, s * s))
                               .astype(np.float32)).to(cuda)
    if fast and transposed:
        patches = patches.bfloat16()
    before = hog_descriptor_flat.launches
    got = hog_descriptor_flat(patches, s, cs, 4, HogVariant.Uoctti,
                              fast=fast, transposed=transposed)
    torch.cuda.synchronize()
    assert hog_descriptor_flat.launches == before + 1
    ref = hog_descriptor_flat_reference(patches, s, cs, 4, HogVariant.Uoctti,
                                        fast=fast, transposed=transposed)
    # same float32 operations, splat sums in another order
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


def test_hog_kernel_dalaltriggs(cuda):
    rng = np.random.default_rng(1)
    patches = torch.from_numpy(rng.integers(0, 256, size=(40, 64 * 64))
                               .astype(np.float32)).to(cuda)
    got = hog_descriptor_flat(patches, 64, 8, 9, HogVariant.DalalTriggs)
    ref = hog_descriptor_flat_reference(patches, 64, 8, 9,
                                        HogVariant.DalalTriggs)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("sampling", ["exact", "fast"])
@pytest.mark.parametrize("window_dtype", [torch.uint8, torch.float32])
def test_window_kernel_equals_twin(cuda, window_dtype, sampling, transposed):
    rng = np.random.default_rng(0)
    n, ry, rx, l, s = 6, 64, 384, 7, 40
    wins = torch.from_numpy(rng.integers(0, 256, size=(n, ry, rx))
                            .astype(np.uint8)).to(cuda).to(window_dtype)
    cx = torch.from_numpy(rng.uniform(-4, rx + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    cy = torch.from_numpy(rng.uniform(-4, ry + 4, (n, l))
                          .astype(np.float32)).to(cuda)
    phw = torch.from_numpy(rng.uniform(5, 30, (n,)).round()
                           .astype(np.float32)).to(cuda)
    for quantize in (False, True):
        kw = dict(sub_window=40, sub_window_x=256, quantize=quantize,
                  sampling=sampling, transposed=transposed)
        got = sample_patches_window(wins, cx, cy, phw, s, **kw)
        oxy, sp = _prepare(cx, cy, phw, s)
        ref = sample_patches_window_reference(
            wins, oxy, sp, s, 40, 256, quantize, sampling, transposed,
            torch.float32)
        # every float operation rounds as the twin's does: bit-equal
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
