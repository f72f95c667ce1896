"""6-DoF pose estimation from 2D landmarks (known-template SDM).

The port of ``examples/pose_estimation.py`` (reference:
examples/pose_estimation.cpp): learn descent directions for
[pitch, yaw, roll, tx, ty, tz] from 500 random poses of a 10-point 3D face
model, then recover the pose of a hardcoded landmark set. The poses come
from a seeded ``torch.Generator`` (the reference seeds from
std::random_device). Runs on the card unless ``--device cpu`` is given.

    python -m superviseddescent_tpu_torch.examples.pose_estimation
"""

import argparse

import numpy as np
import torch

from superviseddescent_tpu_torch import (
    LinearRegressor, RegularisationType, Regulariser,
    SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.models.pose import (
    IBUG_10PT_FACE_MODEL, PoseProjection)
from superviseddescent_tpu_torch.utils.device import resolve_device

SEED = 0


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    device = resolve_device(p.parse_args(argv).device)
    generator = torch.Generator().manual_seed(SEED)      # on the CPU
    proj = PoseProjection(IBUG_10PT_FACE_MODEL, device=device)

    num_samples = 500
    angles = torch.rand((num_samples, 3), generator=generator) * 60.0 - 30.0
    x_tr = torch.cat([angles, torch.tensor([0.0, 0.0, -2000.0]).expand(
        num_samples, 3)], dim=1).to(device)
    y_tr = proj(x_tr)
    x0 = torch.zeros_like(x_tr)
    x0[:, 5] = -2000.0

    reg = Regulariser(RegularisationType.MatrixNorm, 2.0, True)
    sdo = SupervisedDescentOptimiser(
        [LinearRegressor(regulariser=reg) for _ in range(3)])

    def print_residual(x):
        r = torch.linalg.norm(x - x_tr) / torch.linalg.norm(x_tr)
        print(f"train residual: {float(r):.6f}")

    print("Training, residual after each regressor:")
    sdo.train(x_tr, x0, y_tr, proj, on_training_epoch_callback=print_residual)

    landmarks = np.float32([498, 504, 479, 498, 529, 553, 489, 503, 527, 503,
                            502, 513, 457, 465, 471, 471, 522, 522, 530, 536])
    landmarks = torch.from_numpy((landmarks - 500.0) / 1800.0).to(device)
    init = torch.zeros(6, device=device)
    init[5] = -2000.0
    pred = sdo.predict(init, landmarks[None, :], proj).cpu().numpy()
    print("Groundtruth pose: pitch = 11.0, yaw = -25.0, roll = -10.0")
    print(f"Predicted pose:   pitch = {pred[0]:.1f}, yaw = {pred[1]:.1f}, "
          f"roll = {pred[2]:.1f}")
    return 0


if __name__ == "__main__":
    main()
