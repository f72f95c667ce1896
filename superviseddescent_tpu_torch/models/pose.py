"""6-DoF pose estimation from 2D landmarks: the known-template use case.

Counterpart of ``superviseddescent_tpu/models/pose.py`` (reference:
examples/pose_estimation.cpp:58-240): OpenGL-convention rotation,
translation and perspective matrices, the viewport transform, and the
normalised 2D projection used as the SDM projection function h. The whole
(B, 6) parameter batch is projected with one batched matrix chain, true
float32 on the card too (``ops.solver.float32_matmul``). ``PoseProjection``
is a plain callable ``h(x, level)``, the projection that
``SupervisedDescentOptimiser.train`` / ``test`` / ``predict`` take.
"""

from __future__ import annotations

import numpy as np
import torch

from superviseddescent_tpu_torch.ops.solver import float32_matmul
from superviseddescent_tpu_torch.utils.device import resolve_device


def _rotation(c, s, rows):
    """(..., 4, 4) from cos / sin tensors and a 4 x 4 layout whose entries
    name 'c', 's', '-s', 0 or 1."""
    z, o = torch.zeros_like(c), torch.ones_like(c)
    pick = {"c": c, "s": s, "-s": -s, 0: z, 1: o}
    return torch.stack([torch.stack([pick[v] for v in row], -1)
                        for row in rows], -2)


def _rot_x(angle):
    return _rotation(torch.cos(angle), torch.sin(angle),
                     [[1, 0, 0, 0], [0, "c", "-s", 0], [0, "s", "c", 0],
                      [0, 0, 0, 1]])


def _rot_y(angle):
    return _rotation(torch.cos(angle), torch.sin(angle),
                     [["c", 0, "s", 0], [0, 1, 0, 0], ["-s", 0, "c", 0],
                      [0, 0, 0, 1]])


def _rot_z(angle):
    return _rotation(torch.cos(angle), torch.sin(angle),
                     [["c", "-s", 0, 0], ["s", "c", 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]])


def _translation(t):
    """t: (..., 3) -> (..., 4, 4) translation matrices."""
    out = torch.eye(4, dtype=t.dtype, device=t.device).expand(
        t.shape[:-1] + (4, 4)).clone()
    out[..., :3, 3] = t
    return out


def perspective_projection_matrix(vertical_angle_deg, aspect, near, far,
                                  device=None) -> torch.Tensor:
    """OpenGL/Qt-convention perspective matrix (reference:
    pose_estimation.cpp:142-154), float32 on ``device`` (the card unless
    the caller names one)."""
    radians = (vertical_angle_deg / 2.0) * np.pi / 180.0
    sine = np.sin(radians)
    cotan = np.cos(radians) / sine
    return torch.tensor([
        [cotan / aspect, 0.0, 0.0, 0.0],
        [0.0, cotan, 0.0, 0.0],
        [0.0, 0.0, -(near + far) / (far - near),
         (-2.0 * near * far) / (far - near)],
        [0.0, 0.0, -1.0, 0.0]], dtype=torch.float32,
        device=resolve_device(device))


class PoseProjection:
    """Batched SDM projection function for 6-DoF pose.

    Parameters are rows ``[r_x, r_y, r_z, t_x, t_y, t_z]`` (angles in
    degrees). Output rows are normalised 2D projections
    ``[x_0..x_{n-1}, y_0..y_{n-1}]``: screen coordinates with the image
    centre subtracted and divided by the focal length (reference:
    pose_estimation.cpp:212-237). The model points live on ``device`` (the
    card unless the caller names one); parameters are moved there.
    """

    def __init__(self, model_points, focal_length=1800.0,
                 screen=(1000, 1000), near=1.0, far=5000.0, device=None):
        self.device = resolve_device(device)
        pts = np.asarray(model_points, np.float32)
        if pts.shape[0] == 3:
            pts = np.concatenate([pts, np.ones((1, pts.shape[1]),
                                               np.float32)])
        if pts.shape[0] != 4:
            raise ValueError("model_points must be (3, N) or (4, N), got "
                             f"{pts.shape}")
        self.model = torch.from_numpy(pts).to(self.device)  # (4, N)
        self.focal_length = float(focal_length)
        self.screen_w, self.screen_h = screen
        fovy = np.degrees(2.0 * np.arctan2(self.screen_h,
                                           2.0 * self.focal_length))
        aspect = self.screen_w / self.screen_h
        self.projection = perspective_projection_matrix(
            fovy, aspect, near, far, device=self.device)

    @property
    def num_landmarks(self):
        return self.model.shape[1]

    def __call__(self, parameters, level: int = 0) -> torch.Tensor:
        """parameters: (B, 6) or (6,) -> (B, 2N) or (2N,) projections."""
        p = torch.as_tensor(parameters, dtype=torch.float32,
                            device=self.device)
        squeeze = p.ndim == 1
        if squeeze:
            p = p[None, :]
        rad = p[:, :3] * (np.pi / 180.0)
        with float32_matmul():
            model_matrix = (_translation(p[:, 3:6])
                            @ _rot_y(rad[:, 1]) @ _rot_x(rad[:, 0])
                            @ _rot_z(rad[:, 2]))
            mvp = self.projection[None] @ model_matrix          # (B, 4, 4)
            clip = mvp @ self.model[None]                       # (B, 4, N)
        clip = clip / clip[:, 3:4, :]                           # divide by w
        x_ss = (clip[:, 0, :] + 1.0) * (self.screen_w / 2.0)
        y_ss = self.screen_h - (clip[:, 1, :] + 1.0) * (self.screen_h / 2.0)
        cx, cy = self.screen_w / 2.0, self.screen_h / 2.0
        x_n = (x_ss - cx) / self.focal_length
        y_n = (y_ss - cy) / self.focal_length
        out = torch.cat([x_n, y_n], dim=1)
        return out[0] if squeeze else out


# The 10-point 3D face model of the reference example
# (pose_estimation.cpp:257-266), iBug landmark ids 31,34,37,40,43,46,49,52,55,58.
IBUG_10PT_FACE_MODEL = np.asarray([
    [-0.287526, -2.0203, 3.33725],      # nose tip, 31
    [-0.11479, -17.2056, -13.5569],     # nose-lip junction, 34
    [-46.1668, 34.7219, -35.938],       # right eye outer corner, 37
    [-18.926, 31.5432, -29.9641],       # right eye inner corner, 40
    [19.2574, 31.5767, -30.229],        # left eye inner corner, 43
    [46.1914, 34.452, -36.1317],        # left eye outer corner, 46
    [-23.7552, -35.7461, -28.2573],     # mouth right corner, 49
    [-0.0753515, -28.3064, -12.8984],   # upper lip center top, 52
    [23.7138, -35.7886, -28.5949],      # mouth left corner, 55
    [0.125511, -44.7427, -17.1411],     # lower lip center bottom, 58
], np.float32).T                        # (3, 10)
