"""COFW-29 and ibug-68: ``detect_batch`` against the exact stepped rows, the
port's reading beside JAX's own.

``detect_batch`` samples each patch from the whole image (zero outside it);
the stepped window detector samples from a roi x roi window cut around the
face box and clamped inside the image, through 8-row / 128-column aligned
sub-windows that may truncate a patch. The two exact paths therefore differ
where a patch reaches past what its window holds. On ``.synth120`` face 4
(the widest gap of the first 32 faces through the port's CPU path) the
port's two paths lie 0.35 px (29 landmarks) and 1.08 px (68) apart in the
120-image stack. This test shows that the gap is the reference's: the JAX
package's own ``detect_batch`` lies as far from its own exact stepped
detector on the same face.

Tolerances, in pixels: 1e-3 between the two packages' rows of each path
(the same float32 operations, other summation orders), and 0.02 between the
two packages' gaps.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import gt_facebox
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACE = 4
# the sub-window bound chip_smoke.py derives for each family over all 120
# faces (family_data)
MAX_IED = {29: 155.83, 68: 159.53}
EXACT_PX = 1e-3
GAP_PX = 0.02


@pytest.mark.parametrize("n_lm", [29, 68])
def test_detect_batch_gap_reads_the_same_in_jax(n_lm):
    jm = JaxModel.load(os.path.join(REPO, "pretrained",
                                    f"rcr{n_lm}_lfpw5.bin"))
    pm = from_jax_params(
        [np.asarray(r.weights) for r in jm.sdo.regressors], jm.mean,
        jm.landmark_ids, jm.hog_params, jm.right_eye_ids, jm.left_eye_ids,
        device="cpu")
    path = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))[FACE]
    truth = read_pts_landmarks(path[:-4] + ".pts").filter(pm.landmark_ids)
    box = np.float32([gt_facebox(truth)])
    stack, _ = stack_images([load_gray_image(path)], dtype=np.uint8,
                            pad_width_to=128)
    kw = dict(roi=512, max_ied=MAX_IED[n_lm])

    frames = torch.from_numpy(stack)
    batch = pm.detect_batch(frames, box).numpy()
    exact = pm.make_stepped_detector(1, window_sampler=True, **kw)(
        frames, box).numpy()
    jax_batch = np.asarray(jm.detect_batch(jnp.asarray(stack), box))
    jax_exact = np.asarray(jm.make_stepped_detector(
        1, window_sampler=True, **kw)(jnp.asarray(stack), jnp.asarray(box)))

    np.testing.assert_allclose(batch, jax_batch, atol=EXACT_PX, rtol=0)
    np.testing.assert_allclose(exact, jax_exact, atol=EXACT_PX, rtol=0)
    port_gap = float(np.abs(batch - exact).max())
    jax_gap = float(np.abs(jax_batch - jax_exact).max())
    assert port_gap > 0.1   # the face shows the gap
    assert abs(port_gap - jax_gap) <= GAP_PX
