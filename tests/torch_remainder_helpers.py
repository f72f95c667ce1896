"""Inputs and process launching shared by the tests of the port's last
slice (``tests/test_torch_dense.py``, ``test_torch_parallel.py``,
``test_torch_checkpoint.py``).

This module imports only the port, so that the ranks the parallel tests
spawn (fresh interpreters) never import JAX. The training set: the first
``.synth120`` images of the 300 x 450 class, an 8-landmark ibug subset,
ground-truth face boxes and the mean shape of those boxes; no
perturbations, since the two packages' random streams cannot agree.
"""

import glob
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import gt_facebox
from superviseddescent_tpu_torch.ops.patches import (
    load_gray_image, stack_images)
from superviseddescent_tpu_torch.utils.landmarks import (
    to_landmark_collection, to_row)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTH = os.path.join(REPO, ".synth120")
LANDMARKS = ["31", "37", "40", "43", "46", "49", "55", "58"]
RIGHT_EYE, LEFT_EYE = ["37", "40"], ["43", "46"]
# (num_cells, cell_size, num_bins, relative_patch_size) per level
SMALL_HOG = ((3, 6, 4, 0.7), (3, 4, 4, 0.4))
REG_PARAM = 0.1


def synth_set(count, shape=(450, 300)):
    """(float32 stack, (B, 16) ground truth, (B, 4) boxes, (16,) mean) of
    the first ``count`` .synth120 images of one (h, w) size class."""
    images, rows = [], []
    for png in sorted(glob.glob(os.path.join(SYNTH, "*.png"))):
        img = load_gray_image(png)
        if img.shape != shape:
            continue
        images.append(img)
        lms = read_pts_landmarks(png[:-4] + ".pts")
        rows.append(to_row(lms.filter(LANDMARKS)))
        if len(images) == count:
            break
    stack, _ = stack_images(images)
    gt = np.stack(rows).astype(np.float32)
    boxes = np.stack([gt_facebox(to_landmark_collection(r, LANDMARKS))
                      for r in gt]).astype(np.float32)
    l = len(LANDMARKS)
    mean = np.mean([np.concatenate([(r[:l] - b[0]) / b[2] - 0.5,
                                    (r[l:] - b[1]) / b[3] - 0.5])
                    for r, b in zip(gt, boxes)], axis=0).astype(np.float32)
    return stack, gt, boxes, mean


def port_config(**kwargs):
    from superviseddescent_tpu_torch.core.regulariser import (
        RegularisationType, Regulariser)
    from superviseddescent_tpu_torch.models.rcr import HogParams
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig)
    from superviseddescent_tpu_torch.ops.hog import HogVariant
    kwargs.setdefault("num_perturbations", 0)
    return RcrTrainConfig(
        hog_params=tuple(HogParams(HogVariant.Uoctti, *p)
                         for p in SMALL_HOG),
        regularisation=Regulariser(RegularisationType.MatrixNorm, REG_PARAM,
                                   regularise_last_row=False), **kwargs)


def _rank_main(rank, size, store_path, fn, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, size),
                            rank=rank, world_size=size)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, size, store_path, *args, timeout=240):
    """Run ``fn(rank, *args)`` in ``size`` spawned processes joined in a
    gloo group through a FileStore at ``store_path``; ``fn`` must be a
    module-level function of a module that imports no JAX. Raises if a
    rank fails."""
    ctx = mp.start_processes(_rank_main, args=(size, store_path, fn, args),
                             nprocs=size, join=False, start_method="spawn")
    for _ in range(timeout):
        if ctx.join(timeout=1):
            return
    for p in ctx.processes:
        p.kill()
    raise TimeoutError(f"ranks still running after {timeout} s")


# ---------------------------------------------------------------- #
# The two-rank suite of tests/test_torch_parallel.py, run in each rank
# ---------------------------------------------------------------- #
def solver_case():
    """Seeded (64, 24) features (bias last) and (64, 6) targets, as
    tests/test_parallel.py draws them."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(64, 24)).astype(np.float32)
    feats[:, -1] = 1.0
    b = rng.normal(size=(64, 6)).astype(np.float32)
    return feats, b


def regularisers():
    from superviseddescent_tpu_torch.core.regulariser import (
        RegularisationType, Regulariser)
    return (Regulariser(),
            Regulariser(RegularisationType.Manual, 5.0, True),
            Regulariser(RegularisationType.MatrixNorm, 1.5, False))


def sin_case():
    rng = np.random.default_rng(1)
    y = rng.uniform(-1, 1, size=(64, 1)).astype(np.float32)
    x_gt = np.arcsin(y)
    return x_gt, np.full_like(x_gt, 0.5), y


def mesh_train_set():
    """5 faces, so that train_rcr pads its 5 samples to 6 over 2 ranks."""
    return synth_set(5)


def parallel_suite(rank, root):
    """Everything the 2-rank test checks, in one spawn: each rank writes
    its results to ``root/rank{rank}.npz``."""
    import json

    from superviseddescent_tpu_torch.apps import rcr_train
    from superviseddescent_tpu_torch.core.cascade import (
        SupervisedDescentOptimiser)
    from superviseddescent_tpu_torch.core.regressor import LinearRegressor
    from superviseddescent_tpu_torch.io.checkpoint import TrainCheckpointer
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.models.rcr_training import train_rcr
    from superviseddescent_tpu_torch.parallel import (
        distributed_train_level, gather_rows, make_mesh, replicate,
        shard_batch, sharded_detect, sharded_detect_fused, sharded_learn)

    out = {}
    mesh = make_mesh(2, device="cpu")
    try:
        make_mesh(3, device="cpu")
        out["refused_3"] = False
    except ValueError:
        out["refused_3"] = True
    out["replicated"] = replicate(np.float32([rank + 1.0]), mesh).numpy()
    out["gathered"] = gather_rows(
        shard_batch(np.arange(8, dtype=np.float32)[:, None], mesh),
        mesh).numpy()

    feats, b = solver_case()
    for i, reg in enumerate(regularisers()):
        out[f"level_{i}"] = distributed_train_level(
            shard_batch(feats, mesh), shard_batch(b, mesh), reg,
            mesh).numpy()

    x_gt, x0, y = sin_case()
    sdo = SupervisedDescentOptimiser([LinearRegressor() for _ in range(3)])
    sdo.train(shard_batch(x_gt, mesh), shard_batch(x0, mesh),
              shard_batch(y, mesh), lambda x, level: torch.sin(x),
              learn_fn=sharded_learn(mesh))
    for i, r in enumerate(sdo.regressors):
        out[f"sin_{i}"] = r.weights.numpy()

    stack, gt, boxes, mean = mesh_train_set()
    args = (stack, gt, boxes, LANDMARKS, RIGHT_EYE, LEFT_EYE, mean,
            port_config())
    model = train_rcr(*args, mesh=mesh)
    for i, r in enumerate(model.sdo.regressors):
        out[f"mesh_w{i}"] = r.weights.numpy()
    faces = np.arange(6) % stack.shape[0]
    out["mesh_rows"] = sharded_detect(model, stack, boxes[faces], mesh,
                                      image_indices=faces).numpy()

    # resume: a full checkpointed run, level 1 removed, then resumed
    ck = os.path.join(root, "ck")
    train_rcr(*args, checkpointer=TrainCheckpointer(ck), mesh=mesh)
    if rank == 0:
        os.remove(os.path.join(ck, "level_01.npz"))
    dist.barrier()
    resumed = train_rcr(*args, checkpointer=TrainCheckpointer(ck),
                        mesh=mesh)
    for i, r in enumerate(resumed.sdo.regressors):
        out[f"resumed_w{i}"] = r.weights.numpy()

    with np.load(os.path.join(root, "fused_case.npz")) as case:
        fused = DetectionModel.load(os.path.join(root, "fused.bin"),
                                    device="cpu")
        out["fused_rows"] = sharded_detect_fused(
            fused, case["frames"], case["boxes"], mesh,
            roi=int(case["roi"])).numpy()

    with open(os.path.join(root, "app_argv.json")) as f:
        argv = json.load(f)
    argv[argv.index("-o") + 1] += f".rank{rank}"
    rc = rcr_train.main(argv + ["--mesh", "2", "--device", "cpu"])
    out["app_rc"] = rc
    try:
        rcr_train.main(argv + ["--mesh", "3", "--device", "cpu"])
        out["app_refused_3"] = False
    except ValueError:
        out["app_refused_3"] = True
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
