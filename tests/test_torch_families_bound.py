"""ibug-68, fused against exact stepped: the port's reading beside JAX's own.

The JAX package bounds its fused detector to 0.75 px of its exact path on
RCR-22 (``tests/test_detectors.py``). At 68 landmarks the maximum runs over
three times the coordinates, and on ``.synth120`` face 74 (the worst of the
120 through the port's plain twins) the port's fused rows lie 0.90 px from its
exact stepped rows. This test shows that the distance is the algorithm's and
not the port's: the JAX package's own fused kernel (Pallas interpret mode)
lies as far from its own exact stepped detector on the same face.

Tolerances, in pixels: 0.02 between the two packages' fused rows and between
the two fused-vs-exact readings (the fast-class limit of
``tests/test_torch_fused_small.py``); 1e-3 between their exact stepped rows;
1.0 for fused against exact, the limit ``chip_smoke.py`` holds ibug-68 to.
"""

import glob
import os

import jax.numpy as jnp
import numpy as np
import torch

from superviseddescent_tpu.models.rcr import DetectionModel as JaxModel
from superviseddescent_tpu_torch.convert import from_jax_params
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import gt_facebox
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FACE = 74
# the sub-window bound chip_smoke.py derives for ibug-68 over all 120 faces
MAX_IED = 159.53
WHOLE_PX = 0.02
EXACT_PX = 1e-3
RCR22_BOUND_PX = 0.75
IBUG68_BOUND_PX = 1.0


def test_ibug68_fused_vs_exact_reads_the_same_in_jax():
    jm = JaxModel.load(os.path.join(REPO, "pretrained", "rcr68_lfpw5.bin"))
    pm = from_jax_params(
        [np.asarray(r.weights) for r in jm.sdo.regressors], jm.mean,
        jm.landmark_ids, jm.hog_params, jm.right_eye_ids, jm.left_eye_ids,
        device="cpu")
    path = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))[FACE]
    truth = read_pts_landmarks(path[:-4] + ".pts").filter(pm.landmark_ids)
    box = np.float32([gt_facebox(truth)])
    stack, _ = stack_images([load_gray_image(path)], dtype=np.uint8,
                            pad_width_to=128)
    kw = dict(roi=512, max_ied=MAX_IED)

    frames = torch.from_numpy(stack)
    fused = pm.make_fused_detector(**kw)(frames, box).numpy()
    exact = pm.make_stepped_detector(1, window_sampler=True, **kw)(
        frames, box).numpy()
    jax_fused = np.asarray(jm.make_fused_detector(**kw)(
        jnp.asarray(stack), jnp.asarray(box)))
    jax_exact = np.asarray(jm.make_stepped_detector(
        1, window_sampler=True, **kw)(jnp.asarray(stack), jnp.asarray(box)))

    np.testing.assert_allclose(fused, jax_fused, atol=WHOLE_PX, rtol=0)
    np.testing.assert_allclose(exact, jax_exact, atol=EXACT_PX, rtol=0)
    port_reading = float(np.abs(fused - exact).max())
    jax_reading = float(np.abs(jax_fused - jax_exact).max())
    # beyond RCR-22's bound in both packages alike, inside ibug-68's
    assert RCR22_BOUND_PX < port_reading <= IBUG68_BOUND_PX
    assert RCR22_BOUND_PX < jax_reading <= IBUG68_BOUND_PX
    assert abs(port_reading - jax_reading) <= WHOLE_PX
