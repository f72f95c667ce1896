"""rcr-train: train an RCR landmark detection model.

The port of ``superviseddescent_tpu/apps/rcr_train.py`` (reference:
rcr-train.cpp). Faceboxes come from the ground-truth landmarks
(``--facebox-source gt``), from a JSON file of boxes (``file:<path>``) or
from the port's Haar cascade face detector with the reference's
``check_face`` filter on the first box (``cascade:<xml>``); ``--seed``
seeds the perturbations. Runs on the card unless ``--device cpu`` is given.

With ``--roi R --patch-backend window`` each level's features come from the
hand-written window sampler (K2, ``csrc/patches_window.cu``) and HOG kernel
(K1, ``csrc/hog_flat.cu``); with ``--patch-backend dense`` from the dense
sampler (two tent products, ``--sampling exact | high | fast``) and K1; the
default ``gather`` backend is plain PyTorch.

``--mesh N`` trains data-parallel over a ``torch.distributed`` group of N
ranks (``parallel/``), one process per rank, each given the same
arguments; a group of any other size is refused. The group is the one
already initialised in the process, else one that the app starts from the
environment that ``torchrun`` sets, with ``--dist-backend`` (nccl, or gloo
for ``--device cpu``); rank r trains on cuda:r. Rank 0 writes the model
and the error file.

    python -m superviseddescent_tpu_torch.apps.rcr_train -d train/ \\
        -m mean_68.txt -c rcr_training_22.cfg -e rcr_eval.cfg -o model.bin
    torchrun --nproc-per-node 4 -m superviseddescent_tpu_torch.apps.rcr_train \\
        --mesh 4 -d train/ -m mean_68.txt -c rcr_training_22.cfg \\
        -e rcr_eval.cfg --roi 512 --patch-backend dense --sampling high \\
        --feature-chunk-size 512
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def load_dataset(directory, model_landmarks):
    """Load .png images + .pts landmarks, filtered to the model landmarks
    (reference: rcr-train.cpp:65-89, 361)."""
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    from superviseddescent_tpu_torch.utils.landmarks import to_row

    images, rows, full_landmarks = [], [], []
    for png in sorted(glob.glob(os.path.join(directory, "*.png"))):
        pts = png[:-len(".png")] + ".pts"
        if not os.path.exists(pts):
            continue
        lms = read_pts_landmarks(pts)
        images.append(load_gray_image(png))
        full_landmarks.append(lms)
        rows.append(to_row(lms.filter(model_landmarks)))
    if not images:
        raise SystemExit(f"no .png/.pts pairs found in {directory}")
    return images, np.stack(rows), full_landmarks


def resolve_faceboxes(source, full_landmarks, rows, model_landmarks,
                      images=None, device=None):
    """(boxes (K, 4) float32, kept image indices) for a --facebox-source."""
    from superviseddescent_tpu_torch.models.rcr import gt_facebox
    from superviseddescent_tpu_torch.utils.landmarks import (
        to_landmark_collection)
    if source.startswith("cascade:"):
        # the reference pipeline: Haar face detection + check_face
        # true-positive filter, discarding images whose face is not found
        # (rcr-train.cpp:383-436)
        from superviseddescent_tpu_torch.models.facedetect import (
            HaarCascadeDetector)
        from superviseddescent_tpu_torch.utils.landmarks import check_face
        det = HaarCascadeDetector(source[len("cascade:"):], scale_factor=1.2,
                                  min_neighbors=2, min_size=(50, 50),
                                  device=device)
        # one detect_batch (one read-back) per image-size class
        by_shape = {}
        for i, img in enumerate(images):
            by_shape.setdefault(img.shape, []).append(i)
        all_boxes = [None] * len(images)
        for idxs in by_shape.values():
            stack = np.stack([np.asarray(images[i], np.float32)
                              for i in idxs])
            for i, bx in zip(idxs, det.detect_batch(stack)):
                all_boxes[i] = bx
        kept, out = [], []
        for i, full in enumerate(full_landmarks):
            boxes = all_boxes[i]
            # the reference checks only the FIRST detection and discards
            # the image if it fails (rcr-train.cpp:410-417, helpers.hpp)
            if check_face(boxes, full):
                kept.append(i)
                out.append(boxes[0])
            else:
                print(f"image {i}: skipped (no verified face detection)")
        if not out:
            raise SystemExit("face detection found no usable training faces")
        return np.asarray(out, np.float32), kept
    if source == "gt":
        return np.stack([
            gt_facebox(to_landmark_collection(r, model_landmarks))
            for r in rows]).astype(np.float32), list(range(len(rows)))
    if source.startswith("file:"):
        with open(source[5:]) as f:
            boxes = json.load(f)   # list of [x, y, w, h] or null per image
        kept, out = [], []
        for i, b in enumerate(boxes):
            if b is not None:
                kept.append(i)
                out.append(b)
        return np.asarray(out, np.float32), kept
    raise SystemExit(f"unknown --facebox-source: {source}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Train an RCR facial landmark detection model "
                    "(PyTorch port)")
    p.add_argument("-d", "--data", required=True,
                   help="path to ibug images (.png) + .pts landmarks")
    p.add_argument("-m", "--mean", required=True,
                   help="pre-calculated 68-point mean shape CSV")
    p.add_argument("-c", "--config", required=True,
                   help="model config (landmark list, INFO format)")
    p.add_argument("-e", "--evaluation", required=True,
                   help="evaluation config (IED definition, INFO format)")
    p.add_argument("-o", "--output", default="model.bin",
                   help="model output file (cereal-compatible binary)")
    p.add_argument("-t", "--test-data", default=None,
                   help="optional test-set directory for evaluation")
    p.add_argument("--facebox-source", default="gt",
                   help="'gt' (from landmarks), 'file:<boxes.json>', or "
                        "'cascade:<haar.xml>' (the port's face detector "
                        "+ check_face filter, like the reference app)")
    p.add_argument("--num-perturbations", type=int, default=10)
    p.add_argument("--lambda-factor", type=float, default=1.5,
                   help="MatrixNorm regularisation factor (reference: 1.5)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel training over a torch.distributed "
                        "group of this many ranks (one process per rank)")
    p.add_argument("--dist-backend", default="nccl",
                   choices=["nccl", "gloo"],
                   help="with --mesh, the backend of the group the app "
                        "starts from torchrun's environment (gloo for "
                        "--device cpu)")
    p.add_argument("--feature-chunk-size", type=int, default=None,
                   help="bound per-level feature-extraction memory by"
                        " processing the sample axis in chunks")
    p.add_argument("--roi", type=int, default=None,
                   help="crop a fixed ROI window per face before training")
    p.add_argument("--patch-backend", default=None,
                   choices=["dense", "gather", "window"],
                   help="patch sampler ('window' = the K2 + K1 kernels, "
                        "requires --roi; 'dense' = two tent products + K1)")
    p.add_argument("--sampling", default="exact",
                   choices=["exact", "high", "fast"],
                   help="patch sampling precision of the dense backend "
                        "(exact, high, fast) and the window backend "
                        "(exact, fast)")
    p.add_argument("--sigma-rotation", type=float, default=0.0,
                   help="in-plane rotation jitter (radians) on the"
                        " perturbed initialisations (0 = reference"
                        " behaviour)")
    p.add_argument("--mirror", action="store_true",
                   help="horizontal-flip augmentation: double the training"
                        " set with mirrored images + mirror-permuted"
                        " ground truth (ibug-68 correspondence)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)

    from superviseddescent_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    if args.sampling == "high" and args.patch_backend == "window":
        raise SystemExit("--sampling high is a mode of the dense sampler: "
                         "use --patch-backend dense, or exact or fast")
    if not args.mesh:
        return _train(args, device, None)
    import torch.distributed as dist
    from superviseddescent_tpu_torch.parallel import make_mesh
    started = not dist.is_initialized()
    if started and device.type == "cpu" and args.dist_backend == "nccl":
        raise SystemExit("--mesh on the CPU: NCCL needs CUDA devices, pass "
                         "--dist-backend gloo")
    if started and "RANK" not in os.environ:
        raise SystemExit("--mesh: no process group is initialised and the "
                         "environment names none; start the app with "
                         "torchrun --nproc-per-node N")
    if started:
        dist.init_process_group(backend=args.dist_backend,
                                init_method="env://")
    try:
        mesh = make_mesh(args.mesh, device=device)
        return _train(args, mesh.device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args, device, mesh):
    import torch

    from superviseddescent_tpu_torch.core.regulariser import (
        RegularisationType, Regulariser)
    from superviseddescent_tpu_torch.io import (
        load_mean, read_ied_definition, read_landmarks_list_to_train)
    from superviseddescent_tpu_torch.models.rcr import (
        RCR22_HOG_PARAMS, align_mean)
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, normalised_landmark_errors, train_rcr)
    from superviseddescent_tpu_torch.ops.patches import stack_images
    from superviseddescent_tpu_torch.utils.landmarks import (
        mirror_permutation, resolve_eye_indices, to_landmark_collection,
        to_row)

    # rank 0 alone writes files; every rank prints its own progress
    writes = mesh is None or mesh.rank == 0
    model_landmarks = read_landmarks_list_to_train(args.config)
    print(f"Loaded a list of {len(model_landmarks)} landmarks to train "
          "the model.")
    right_ids, left_ids = read_ied_definition(args.evaluation)

    mean68 = load_mean(args.mean)
    ibug_ids = [str(i) for i in range(1, 69)]
    mean = to_row(to_landmark_collection(mean68, ibug_ids)
                  .filter(model_landmarks))

    images, gt_rows, full_lms = load_dataset(args.data, model_landmarks)
    boxes, kept = resolve_faceboxes(args.facebox_source, full_lms, gt_rows,
                                    model_landmarks, images=images,
                                    device=device)
    images = [images[i] for i in kept]
    gt_rows = gt_rows[kept]
    print(f"Kept {len(images)} images.")
    # uint8 is lossless for decoded grays; the 128-multiple width (and
    # 32-multiple height) is the frames layout of the window and fused
    # backends, and the --mirror ground truth below is reflected about it
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)

    cfg = RcrTrainConfig(
        hog_params=RCR22_HOG_PARAMS[:args.levels],
        regularisation=Regulariser(RegularisationType.MatrixNorm,
                                   args.lambda_factor,
                                   regularise_last_row=False),
        num_perturbations=args.num_perturbations,
        sigma_rotation=args.sigma_rotation,
        seed=args.seed,
        feature_chunk_size=args.feature_chunk_size,
        roi=args.roi,
        patch_backend=args.patch_backend,
        sampling=args.sampling,
        mirror_augmentation=args.mirror)
    right_idx, left_idx = resolve_eye_indices(model_landmarks, right_ids,
                                              left_ids)
    gt_rows_cb = gt_rows
    if args.mirror:
        # train_rcr appends the flipped faces after the originals, their
        # ground truth reflected about the padded stack width
        perm = mirror_permutation(model_landmarks)
        wpx = stack.shape[2]
        l = len(model_landmarks)
        gt_flip = np.concatenate(
            [(wpx - 1.0) - gt_rows[:, :l][:, perm],
             gt_rows[:, l:][:, perm]], axis=1)
        gt_rows_cb = np.concatenate([gt_rows, gt_flip])
    gt_aug = np.repeat(gt_rows_cb, args.num_perturbations + 1, axis=0)
    gt_aug_dev = torch.from_numpy(gt_aug).to(device)

    def on_epoch(x):
        x_np = x.cpu().numpy()
        nlsr = np.linalg.norm(x_np - gt_aug) / np.linalg.norm(gt_aug)
        err = float(normalised_landmark_errors(
            x, gt_aug_dev, right_idx, left_idx).mean())
        print(f"NLSR train: {nlsr:.6f}")
        print(f"Normalised LM-error train: {err:.6f}")

    print("Training the model, printing the residual after each learned "
          "regressor:")
    t0 = time.time()
    model = train_rcr(stack, gt_rows, boxes, model_landmarks,
                      right_ids, left_ids, mean, cfg, on_epoch=on_epoch,
                      mesh=mesh, device=device)
    print(f"Training took {time.time() - t0:.1f}s")
    if writes:
        model.save(args.output)
        print(f"Saved model to {args.output}")

    if args.test_data:
        t_images, t_rows, t_full = load_dataset(args.test_data,
                                                model_landmarks)
        t_boxes, t_kept = resolve_faceboxes(args.facebox_source, t_full,
                                            t_rows, model_landmarks,
                                            images=t_images, device=device)
        t_images = [t_images[i] for i in t_kept]
        t_rows = t_rows[t_kept]
        print(f"Kept {len(t_images)} test images.")
        t_stack, _ = stack_images(t_images, dtype=np.uint8,
                                  pad_width_to=128)
        t_rows_dev = torch.from_numpy(t_rows).to(device)

        init = align_mean(model.mean[None, :],
                          torch.from_numpy(t_boxes).to(device))
        err0 = float(normalised_landmark_errors(
            init, t_rows_dev, right_idx, left_idx).mean())
        print(f"Normalised LM-error test from mean init: {err0:.6f}")

        pred = model.detect_batch(t_stack, t_boxes)
        pred_np = pred.cpu().numpy()
        nlsr = np.linalg.norm(pred_np - t_rows) / np.linalg.norm(t_rows)
        per_lm = normalised_landmark_errors(
            pred, t_rows_dev, right_idx, left_idx).cpu().numpy()
        print(f"NLSR test: {nlsr:.6f}")
        print(f"Normalised LM-error test: {float(per_lm.mean()):.6f}")

        # per-landmark error file for plotting (rcr-train.cpp:526-538)
        if writes:
            error_file = os.path.splitext(args.output)[0] + ".error.txt"
            with open(error_file, "w") as f:
                f.write(", ".join(f"{v:g}" for v in per_lm.mean(axis=0))
                        + "\n")
            print(f"Wrote per-landmark errors to {error_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
