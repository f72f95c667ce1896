"""Hello-world: invert sin(x) with a cascade of linear regressors.

The port of ``examples/simple_function.py`` (reference:
examples/simple_function.cpp): train 10 unregularised regressors to step
from x0 = 0.5 toward asin(y), then test on a finer grid. Runs on the card
unless ``--device cpu`` is given.

    python -m superviseddescent_tpu_torch.examples.simple_function
"""

import argparse

import numpy as np
import torch

from superviseddescent_tpu_torch import (
    LinearRegressor, SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.utils.device import resolve_device


def grid(start, step, n):
    out = np.empty(n, np.float32)
    v = np.float32(start)
    for i in range(n):
        out[i] = v
        v = np.float32(v + np.float32(step))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    device = resolve_device(p.parse_args(argv).device)

    def h(x, level):
        return torch.sin(x)

    def dev(a):
        return torch.from_numpy(a).to(device)

    y_tr = grid(-1.0, 0.2, 11).reshape(-1, 1)
    x_tr = np.arcsin(np.minimum(y_tr, np.float32(1.0)))
    x0 = np.full_like(x_tr, 0.5)

    sdo = SupervisedDescentOptimiser([LinearRegressor() for _ in range(10)])

    def print_residual(current_x):
        r = (np.linalg.norm(current_x.cpu().numpy() - x_tr)
             / np.linalg.norm(x_tr))
        print(f"train residual: {r:.6f}")

    print("Training, residual after each regressor:")
    sdo.train(dev(x_tr), dev(x0), dev(y_tr), h,
              on_training_epoch_callback=print_residual)

    y_ts = grid(-1.0, 0.05, 41).reshape(-1, 1)
    x_ts_gt = np.arcsin(np.minimum(y_ts, np.float32(1.0)))
    pred = sdo.test(dev(np.full_like(x_ts_gt, 0.5)), dev(y_ts), h)
    r = np.linalg.norm(pred.cpu().numpy() - x_ts_gt) / np.linalg.norm(x_ts_gt)
    print(f"test residual: {r:.6f}  (reference pins 0.026157)")
    return 0


if __name__ == "__main__":
    main()
