"""Data parallelism over torch.distributed, port vs JAX.

Two ranks, spawned once for the module and joined in a gloo group through
a FileStore under the test's temporary directory, run
``torch_remainder_helpers.parallel_suite`` on the CPU: the mesh guards,
``distributed_train_level``, a cascade trained with ``sharded_learn``,
``train_rcr(mesh=)`` (5 samples padded to 6) and its checkpointed resume,
``sharded_detect`` and ``sharded_detect_fused``, and ``rcr_train --mesh
2``. Each is held against the JAX package's ``mesh=make_mesh(2)`` run (2
of tests/conftest.py's 8 virtual CPU devices) with tests/test_parallel.py's
tolerances (the app against the port's single-process app), against the
port's single-process result, and the two ranks against each other
(equal).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superviseddescent_tpu import LinearRegressor as JaxRegressor
from superviseddescent_tpu import SupervisedDescentOptimiser as JaxSdo
from superviseddescent_tpu.core.regulariser import (
    RegularisationType as JaxRegType, Regulariser as JaxReg)
from superviseddescent_tpu.models import rcr_training as jax_training
from superviseddescent_tpu.models.rcr import HogParams as JaxHogParams
from superviseddescent_tpu.ops.hog import HogVariant as JaxVariant
from superviseddescent_tpu.parallel import (
    distributed_train_level as jax_level, make_mesh as jax_mesh,
    shard_batch as jax_shard)
from superviseddescent_tpu.parallel.dist import (
    sharded_detect as jax_sharded_detect,
    sharded_detect_fused as jax_sharded_fused)
from superviseddescent_tpu_torch.apps import rcr_train as port_app
from superviseddescent_tpu_torch.io.cereal import load_detection_model
from superviseddescent_tpu_torch.models.rcr_training import train_rcr
from superviseddescent_tpu_torch.ops.solver import (
    solve_ridge_normal_equations)
from test_torch_fused_small import frames_and_boxes, tiny_pair
from torch_apps_helpers import (  # noqa: F401 (one_torch_thread)
    WEIGHTS_ABS, WEIGHTS_REL, one_torch_thread, run_app, train_argv,
    train_case)
from torch_remainder_helpers import (
    LANDMARKS, LEFT_EYE, REG_PARAM, RIGHT_EYE, SMALL_HOG, mesh_train_set,
    parallel_suite, port_config, regularisers, run_ranks, sin_case,
    solver_case)

FUSED_ROI = 128
FUSED_PX = 0.02          # port vs JAX fused rows (tests/test_torch_fused_small)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    jm, pm = tiny_pair(6, 2)
    # 8 faces: the four boxes of the helper, each over two frames
    frames, boxes = frames_and_boxes(seed=0, n=8)
    boxes = np.concatenate([boxes, boxes])
    pm.save(str(root / "fused.bin"))
    np.savez(root / "fused_case.npz", frames=frames, boxes=boxes,
             roi=FUSED_ROI)
    os.makedirs(root / "app")
    case = train_case(str(root / "app"))
    with open(root / "app_argv.json", "w") as f:
        json.dump(train_argv(case, str(root / "app" / "mesh.bin")), f)
    run_ranks(parallel_suite, 2, str(root / "store"), str(root))
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(2)]
    return dict(root=root, ranks=ranks, jm=jm, pm=pm, frames=frames,
                boxes=boxes, case=case)


def test_ranks_agree_and_the_mesh_is_guarded(suite):
    a, b = suite["ranks"]
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["refused_3"] and a["app_refused_3"] and int(a["app_rc"]) == 0
    np.testing.assert_array_equal(a["replicated"], [1.0])
    np.testing.assert_array_equal(a["gathered"][:, 0], np.arange(8))


@pytest.mark.parametrize("i", range(3))
def test_distributed_level_matches_jax(suite, i):
    feats, b = solver_case()
    reg = regularisers()[i]
    mesh = jax_mesh(2)
    ref = np.asarray(jax_level(
        jax_shard(jnp.asarray(feats), mesh), jax_shard(jnp.asarray(b), mesh),
        JaxReg(JaxRegType(int(reg.regularisation_type)), reg.param,
               reg.regularise_last_row), mesh))
    got = suite["ranks"][0][f"level_{i}"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    single = solve_ridge_normal_equations(
        torch.from_numpy(feats), torch.from_numpy(b), reg).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5)


def test_sharded_cascade_matches_jax(suite):
    x_gt, x0, y = sin_case()
    mesh = jax_mesh(2)
    sdo = JaxSdo([JaxRegressor() for _ in range(3)])
    sdo.train(*(jax_shard(jnp.asarray(v), mesh) for v in (x_gt, x0, y)),
              lambda x, level: jnp.sin(x))
    for i, r in enumerate(sdo.regressors):
        np.testing.assert_allclose(suite["ranks"][0][f"sin_{i}"],
                                   np.asarray(r.weights), rtol=2e-4,
                                   atol=1e-6)


def jax_config():
    return jax_training.RcrTrainConfig(
        hog_params=tuple(JaxHogParams(JaxVariant.Uoctti, *p)
                         for p in SMALL_HOG),
        regularisation=JaxReg(JaxRegType.MatrixNorm, REG_PARAM, False),
        num_perturbations=0)


def test_train_rcr_mesh_matches_jax_and_single(suite):
    stack, gt, boxes, mean = mesh_train_set()
    ids = (LANDMARKS, RIGHT_EYE, LEFT_EYE)
    mesh = jax_mesh(2)
    ref = jax_training.train_rcr(stack, gt, boxes, *ids, mean, jax_config(),
                                 mesh=mesh)
    single = train_rcr(stack, gt, boxes, *ids, mean, port_config(),
                       device="cpu")
    got = suite["ranks"][0]
    for i, (rj, rs) in enumerate(zip(ref.sdo.regressors,
                                     single.sdo.regressors)):
        for want in (np.asarray(rj.weights), rs.weights.numpy()):
            np.testing.assert_allclose(got[f"mesh_w{i}"], want, rtol=2e-2,
                                       atol=2e-4)
        # the resumed run starts from level 0's checkpoint
        np.testing.assert_allclose(got[f"resumed_w{i}"], got[f"mesh_w{i}"],
                                   rtol=0, atol=1e-6)
    faces = np.arange(6) % stack.shape[0]
    rows = np.asarray(jax_sharded_detect(ref, stack[faces], boxes[faces],
                                         mesh))
    np.testing.assert_allclose(got["mesh_rows"], rows, atol=0.05)


def test_sharded_fused_matches_jax(suite):
    got = suite["ranks"][0]["fused_rows"]
    ref = np.asarray(jax_sharded_fused(suite["jm"], suite["frames"],
                                       suite["boxes"], jax_mesh(2),
                                       roi=FUSED_ROI))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FUSED_PX)
    single = suite["pm"].make_fused_detector(roi=FUSED_ROI)(
        torch.from_numpy(suite["frames"]), suite["boxes"]).numpy()
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-4)


def test_app_mesh_matches_the_single_process_app(suite, tmp_path,
                                                monkeypatch):
    """``rcr_train --mesh 2``: rank 0 alone writes the model, and its
    weights match a single-process run of the same arguments within the
    app tests' training tolerances (the single-process app is held to the
    JAX app in tests/test_torch_apps_train.py)."""
    out = str(suite["root"] / "app" / "mesh.bin")
    assert os.path.exists(out + ".rank0")
    assert not os.path.exists(out + ".rank1")
    single = str(tmp_path / "single.bin")
    rc, _ = run_app(monkeypatch, port_app,
                    train_argv(suite["case"], single, "--device", "cpu"))
    assert rc == 0
    a, b = load_detection_model(out + ".rank0"), load_detection_model(single)
    assert len(a.regressors) == len(b.regressors) == 2
    for ra, rb in zip(a.regressors, b.regressors):
        w, w_ref = np.asarray(ra.weights), np.asarray(rb.weights)
        dw = float(np.abs(w - w_ref).mean())
        assert dw < WEIGHTS_ABS and dw < WEIGHTS_REL * float(
            np.abs(w_ref).mean())
