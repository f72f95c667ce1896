"""Data-parallel training and detection over a ``parallel.mesh.Mesh``.

Counterpart of ``superviseddescent_tpu/parallel/dist.py``. The one
collective that training needs is the sum of the normal equations over
the sample shards,

    AtA = sum_r A_r^T A_r      Atb = sum_r A_r^T b_r,

one ``all_reduce`` per level, after which every rank solves the same
F x F system; the weights are then broadcast from rank 0, so that every
rank holds the same bits. Detection is data-parallel over faces with no
communication until the rows are gathered (``mesh.gather_rows``).

Every rank calls these functions with the same full inputs and computes
on its own shard.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from superviseddescent_tpu_torch.core.regressor import LinearRegressor
from superviseddescent_tpu_torch.core.regulariser import Regulariser
from superviseddescent_tpu_torch.ops.solver import (
    _solve_from_normal, normal_equations)
from superviseddescent_tpu_torch.parallel.mesh import (
    Mesh, _as_tensor, gather_rows, shard_bounds)


def distributed_train_level(features: torch.Tensor, b: torch.Tensor,
                            regulariser: Regulariser, mesh: Mesh,
                            method: str = "lu",
                            num_samples: Optional[int] = None
                            ) -> torch.Tensor:
    """One cascade level's learn from this rank's (n, F) feature rows and
    (n, P) targets: the rank's AtA and Atb in true float32, one sum over
    the group, the replicated solve. num_samples: the sample count of the
    MatrixNorm lambda (default: the rows of every rank; pass the count
    without the zero rows that padded the batch). Returns the (F, P)
    weights, the same on every rank."""
    ata, atb = normal_equations(features, b)
    dist.all_reduce(ata, group=mesh.group)
    dist.all_reduce(atb, group=mesh.group)
    if num_samples is None:
        count = torch.tensor([features.shape[0]], device=features.device)
        dist.all_reduce(count, group=mesh.group)
        num_samples = int(count)
    weights = _solve_from_normal(ata, atb, num_samples, regulariser,
                                 method).contiguous()
    dist.broadcast(weights, src=0, group=mesh.group)
    return weights


def sharded_learn(mesh: Mesh, num_samples: Optional[int] = None,
                  valid: Optional[torch.Tensor] = None):
    """A ``learn_fn`` for ``SupervisedDescentOptimiser.train`` that learns
    each level through ``distributed_train_level``: every rank trains the
    cascade on its shard of the samples. valid: (n,) 1 for this rank's
    real rows, 0 for rows that only pad the batch (they then add nothing
    to AtA and Atb)."""
    def learn(regressor, observed, b, level):
        if valid is not None:
            observed = observed * valid[:, None]
            b = b * valid[:, None]
        w = distributed_train_level(observed, b, regressor.regulariser,
                                    mesh, method=regressor.method,
                                    num_samples=num_samples)
        return LinearRegressor(weights=w, regulariser=regressor.regulariser,
                               method=regressor.method)
    return learn


def _shard_faces(images, faceboxes, image_indices, mesh: Mesh):
    """This rank's faces: its boxes, and its per-face images or (with
    image_indices) the whole frame stack and its indices."""
    a, b = shard_bounds(faceboxes.shape[0], mesh)
    boxes = _as_tensor(faceboxes, mesh.device).float()[a:b]
    if image_indices is None:
        return _as_tensor(images[a:b], mesh.device), boxes, None
    return (_as_tensor(images, mesh.device), boxes,
            _as_tensor(image_indices, mesh.device)[a:b])


def sharded_detect(model, images, faceboxes, mesh: Mesh,
                   quantize: bool = True, image_indices=None
                   ) -> torch.Tensor:
    """``model.detect_batch`` (the exact plain path) over faces split
    across the mesh. images: (B, H, W) one image per face, or a frame stack
    with (B,) image_indices; faceboxes: (B, 4); B must divide over the
    mesh. Returns the (B, 2L) rows on every rank."""
    imgs, boxes, idx = _shard_faces(images, faceboxes, image_indices, mesh)
    rows = model.detect_batch(imgs, boxes, image_indices=idx,
                              quantize=quantize)
    return gather_rows(rows, mesh)


def make_sharded_fused_detector(model, mesh: Mesh, roi: int, max_ied=None):
    """``f(images, faceboxes, image_indices=None) -> (B, 2L)`` on every
    rank: each rank runs the fused cascade kernel (K3 on a uint8 stack of
    32-aligned height and 128-aligned width, else K4) on its shard of the
    faces, with no communication until the rows are gathered. Arguments
    as for ``sharded_detect``."""
    detect = model.make_fused_detector(roi=roi, max_ied=max_ied)

    def run(images, faceboxes, image_indices=None):
        imgs, boxes, idx = _shard_faces(images, faceboxes, image_indices,
                                        mesh)
        return gather_rows(detect(imgs, boxes, image_indices=idx), mesh)
    return run


def sharded_detect_fused(model, images, faceboxes, mesh: Mesh, roi: int,
                         max_ied=None, image_indices=None) -> torch.Tensor:
    """One call of ``make_sharded_fused_detector``."""
    return make_sharded_fused_detector(model, mesh, roi, max_ied)(
        images, faceboxes, image_indices=image_indices)


class ShardedHogTransform:
    """A ``HogTransform`` run on this rank's shard of the samples.

    ``h(x (n, 2L), level) -> (n, F)``: x is this rank's shard of a batch
    of n * mesh.size samples (``train_rcr`` pads the batch to a multiple of
    the mesh), and the transform's sample -> image map is cut to the same
    shard, while the image stack (or frame table) stays whole on every
    rank."""

    def __init__(self, hog, mesh: Mesh):
        self.hog = hog
        self.mesh = mesh

    def feature_dim(self, level: int = 0) -> int:
        return self.hog.feature_dim(level)

    def __call__(self, x: torch.Tensor, level: int) -> torch.Tensor:
        n = x.shape[0]
        indices = self.hog._indices_for(n * self.mesh.size)
        a, b = shard_bounds(indices.shape[0], self.mesh)
        return self.hog.call_with_indices(x, level, indices[a:b])
