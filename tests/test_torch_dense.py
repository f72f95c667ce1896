"""The dense patch sampler and the dense training backend, port vs JAX.

``extract_patches_dense`` against the JAX package's on the same seeded
images and centres: ``exact`` equal when quantised and within 1e-4 grey
levels when not; ``high`` within 0.006 grey levels of exact before
quantisation and ``fast`` within one grey level (the bounds the JAX package
states for its precisions, ``models/rcr.py``'s ``sampling``). The JAX
package runs both on the CPU in float32, where its ``high`` is exact, so
the port's bfloat16 modes are held to those bounds, not to JAX's bits.
Then ``train_rcr(patch_backend="dense")`` against the JAX package's, and
the ``rcr_train`` app with ``--patch-backend dense`` against the JAX app.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.apps import rcr_train as jax_app
from superviseddescent_tpu.core.regulariser import (
    RegularisationType as JaxRegType, Regulariser as JaxReg)
from superviseddescent_tpu.models import rcr_training as jax_training
from superviseddescent_tpu.models.rcr import HogParams as JaxHogParams
from superviseddescent_tpu.ops import patches as jax_patches
from superviseddescent_tpu.ops.hog import HogVariant as JaxVariant
from superviseddescent_tpu_torch.apps import rcr_train as port_app
from superviseddescent_tpu_torch.models.rcr import HogTransform
from superviseddescent_tpu_torch.models.rcr_training import train_rcr
from superviseddescent_tpu_torch.ops.patches import (
    extract_patches, extract_patches_dense)
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    assert_same_training, one_torch_thread, printed_numbers, run_app,
    train_argv, train_case)
from torch_remainder_helpers import (
    LANDMARKS, LEFT_EYE, REG_PARAM, RIGHT_EYE, SMALL_HOG, port_config,
    synth_set)

HIGH_GREY = 0.006
FAST_GREY = 1.0
# tests/test_parallel.py's tolerance for weights that differ in the order
# of float32 sums only
WEIGHTS_RTOL, WEIGHTS_ATOL = 2e-4, 1e-6

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def sample_case(seed, dtype):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, size=(3, 90, 110)).astype(dtype)
    n, l = 6, 5
    return dict(
        images=imgs, image_indices=np.int32([0, 1, 2, 2, 1, 0]),
        centers_x=rng.uniform(-5, 115, (n, l)).astype(np.float32),
        centers_y=rng.uniform(-5, 95, (n, l)).astype(np.float32),
        patch_half=rng.integers(3, 30, n).astype(np.float32))


def port_dense(case, size, **kw):
    args = [torch.from_numpy(np.asarray(case[k])) for k in (
        "images", "image_indices", "centers_x", "centers_y", "patch_half")]
    return extract_patches_dense(*args, size, **kw).numpy()


def jax_dense(case, size, **kw):
    args = [jnp.asarray(case[k]) for k in (
        "images", "image_indices", "centers_x", "centers_y", "patch_half")]
    return np.asarray(jax_patches.extract_patches_dense(*args, size, **kw))


@pytest.mark.parametrize("seed,dtype,size", [
    (0, np.uint8, 30), (1, np.float32, 30), (2, np.uint8, 11),
    (3, np.float32, 55)])
def test_exact_matches_jax(seed, dtype, size):
    case = sample_case(seed, dtype)
    np.testing.assert_array_equal(port_dense(case, size),
                                  jax_dense(case, size))
    np.testing.assert_allclose(port_dense(case, size, quantize=False),
                               jax_dense(case, size, quantize=False),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_high_and_fast_within_their_bounds(seed):
    case = sample_case(seed, np.uint8)
    exact = port_dense(case, 30, quantize=False)
    high = port_dense(case, 30, quantize=False, sampling="high")
    fast = port_dense(case, 30, quantize=False, sampling="fast")
    assert np.abs(high - exact).max() <= HIGH_GREY
    assert np.abs(fast - exact).max() <= FAST_GREY
    # quantised, each stays within a grey level of the exact sampler
    q = port_dense(case, 30)
    for mode in ("high", "fast"):
        assert np.abs(port_dense(case, 30, sampling=mode) - q).max() <= 1.0
    # JAX on the CPU multiplies its bfloat16 operands in float32, as the
    # port's fast mode does
    np.testing.assert_allclose(
        fast, jax_dense(case, 30, quantize=False,
                        precision=jax.lax.Precision.DEFAULT),
        rtol=0, atol=2e-3)


@pytest.mark.parametrize("seed", [4, 5])
def test_dense_against_the_gather_sampler(seed):
    """Unquantised, the two samplers agree within float32 rounding of the
    coordinates (measured 1.1e-3 grey levels); quantised, the dense
    sampler rounds the float result where the gather sampler reproduces
    cv::resize's truncating fixed-point shifts, so some pixels differ by
    one grey level (measured 7.5%)."""
    case = sample_case(seed, np.uint8)
    args = [torch.from_numpy(np.asarray(case[k])) for k in (
        "images", "image_indices", "centers_x", "centers_y", "patch_half")]
    for quantize, tol in ((False, 2e-3), (True, 1.0)):
        gathered = extract_patches(*args, 30, quantize=quantize).numpy()
        assert np.abs(port_dense(case, 30, quantize=quantize)
                      - gathered).max() <= tol


def test_transform_refuses_what_it_cannot_run():
    images = torch.zeros((1, 64, 64))
    ids = (LANDMARKS, RIGHT_EYE, LEFT_EYE)
    with pytest.raises(ValueError, match="dense-sampler"):
        HogTransform(images, (), *ids, backend="window", sampling="high")
    with pytest.raises(ValueError, match="own HOG kernel"):
        HogTransform(images, (), *ids, backend="window", hog_backend="plain")
    with pytest.raises(ValueError, match="sampling"):
        HogTransform(images, (), *ids, backend="dense", sampling="bf16")
    assert HogTransform(images, (), *ids).hog_backend == "plain"
    assert HogTransform(images, (), *ids,
                        backend="dense").hog_backend == "kernel"


@pytest.fixture(scope="module")
def synth():
    return synth_set(12)


def jax_dense_model(synth, roi):
    stack, gt, boxes, mean = synth
    cfg = jax_training.RcrTrainConfig(
        hog_params=tuple(JaxHogParams(JaxVariant.Uoctti, *p)
                         for p in SMALL_HOG),
        regularisation=JaxReg(JaxRegType.MatrixNorm, REG_PARAM, False),
        num_perturbations=0, patch_backend="dense", roi=roi)
    return jax_training.train_rcr(stack, gt, boxes, LANDMARKS, RIGHT_EYE,
                                  LEFT_EYE, mean, cfg)


@pytest.mark.parametrize("roi", [256, None])
def test_dense_training_matches_jax(synth, roi):
    stack, gt, boxes, mean = synth
    ref = jax_dense_model(synth, roi)
    model = train_rcr(stack, gt, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE,
                      mean, port_config(patch_backend="dense", roi=roi),
                      device="cpu")
    for r, rj in zip(model.sdo.regressors, ref.sdo.regressors):
        np.testing.assert_allclose(r.weights.numpy(), np.asarray(rj.weights),
                                   rtol=WEIGHTS_RTOL, atol=WEIGHTS_ATOL)


def test_dense_training_in_chunks_and_precisions(synth):
    """Chunks change no bit. Models trained with high and fast sampling
    detect within 0.05 / 0.25 px of the exact-trained model on their
    training faces (measured 0.029 / 0.147 px). Their weights are no
    measure at this size: 12 samples for 145 features leave the solve to
    the regulariser, and the gather-trained model's weights lie 4-12%
    (mean) from the dense exact model's, its rows 0.068 px."""
    stack, gt, boxes, mean = synth
    args = (stack, gt, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE, mean)

    def model(**kw):
        return train_rcr(*args, port_config(patch_backend="dense", roi=256,
                                            **kw), device="cpu")

    exact = model()
    chunked = model(feature_chunk_size=5)
    for r, r0 in zip(chunked.sdo.regressors, exact.sdo.regressors):
        assert torch.equal(r.weights, r0.weights)
    rows = exact.detect_batch(stack, boxes)
    for sampling, px in (("high", 0.05), ("fast", 0.25)):
        got = model(sampling=sampling).detect_batch(stack, boxes)
        assert float((got - rows).abs().max()) <= px


def test_app_dense_matches_jax_app(tmp_path, monkeypatch):
    """``rcr_train --patch-backend dense`` in both packages, held to the app
    tests' training tolerances; then the port's app with ``--sampling
    high``, whose printed errors stay near the exact run's (fast is held
    by the training test above)."""
    case = train_case(str(tmp_path))
    extra = ["--roi", "256", "--patch-backend", "dense"]
    want_model = os.path.join(str(tmp_path), "jax.bin")
    rc, want = run_app(monkeypatch, jax_app,
                       train_argv(case, want_model, *extra))
    assert rc in (0, None)
    got_model = os.path.join(str(tmp_path), "port.bin")
    rc, got = run_app(monkeypatch, port_app,
                      train_argv(case, got_model, *extra, "--device", "cpu"))
    assert rc == 0
    assert_same_training(got, want, got_model, want_model)
    exact = printed_numbers(got)
    rc, out = run_app(monkeypatch, port_app, train_argv(
        case, os.path.join(str(tmp_path), "high.bin"), *extra,
        "--sampling", "high", "--device", "cpu"))
    assert rc == 0
    numbers = printed_numbers(out)
    assert [n[0] for n in numbers] == [n[0] for n in exact]
    # measured: within 3e-6
    np.testing.assert_allclose([n[1] for n in numbers],
                               [n[1] for n in exact], rtol=0, atol=1e-4)
