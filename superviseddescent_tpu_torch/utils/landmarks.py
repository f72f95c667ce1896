"""Landmark containers and helpers.

Counterpart of ``superviseddescent_tpu/utils/landmarks.py`` (reference:
rcr/landmark.hpp, rcr/helpers.hpp). One row per shape everywhere:
``[x_0 .. x_{n-1}, y_0 .. y_{n-1}]``. Names exist only at the host boundary;
eye identifiers resolve once to index tuples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclass
class LandmarkCollection:
    """Named 2D landmarks. ``coordinates`` is (N, 2) float32 [x, y]."""

    names: list
    coordinates: np.ndarray

    def __post_init__(self):
        self.coordinates = np.asarray(self.coordinates, np.float32)
        if self.coordinates.shape != (len(self.names), 2):
            raise ValueError(
                f"coordinates {self.coordinates.shape} do not match "
                f"{len(self.names)} names")

    def __len__(self):
        return len(self.names)

    def filter(self, keep_names: Sequence[str]) -> "LandmarkCollection":
        """Subset by name, in the order of ``keep_names``."""
        index = {n: i for i, n in enumerate(self.names)}
        kept = [n for n in keep_names if n in index]
        return LandmarkCollection(kept,
                                  self.coordinates[[index[n] for n in kept]])

    def __getitem__(self, name: str) -> np.ndarray:
        return self.coordinates[self.names.index(name)]


def to_row(landmarks: LandmarkCollection) -> np.ndarray:
    """(N, 2) named landmarks -> (2N,) row [x..., y...]."""
    c = landmarks.coordinates
    return np.concatenate([c[:, 0], c[:, 1]]).astype(np.float32)


def to_landmark_collection(row, names: Sequence[str]) -> LandmarkCollection:
    """Row [x..., y...] -> named landmarks."""
    if isinstance(row, torch.Tensor):
        row = row.detach().cpu().numpy()
    row = np.asarray(row).reshape(-1)
    n = row.shape[0] // 2
    if n != len(names):
        raise ValueError(f"row holds {n} landmarks, {len(names)} names given")
    return LandmarkCollection(list(names), np.stack([row[:n], row[n:]], 1))


def resolve_eye_indices(model_landmarks: Sequence[str],
                        right_eye_ids: Sequence[str],
                        left_eye_ids: Sequence[str]
                        ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Eye identifier names -> index tuples into the model landmark list.
    Raises ValueError if an identifier is missing."""
    index = {n: i for i, n in enumerate(model_landmarks)}
    try:
        right = tuple(index[n] for n in right_eye_ids)
        left = tuple(index[n] for n in left_eye_ids)
    except KeyError as e:
        raise ValueError(
            f"eye identifier {e} not present in model landmarks") from e
    return right, left


def ied_from_rows(rows: torch.Tensor, right_idx: Tuple[int, ...],
                  left_idx: Tuple[int, ...]) -> torch.Tensor:
    """Inter-eye distance per row: the L2 distance of the two eye centres,
    each the mean of its landmarks. rows: (..., 2N) -> (...,)."""
    n = rows.shape[-1] // 2
    xs, ys = rows[..., :n], rows[..., n:]
    ri, li = list(right_idx), list(left_idx)
    rx = xs[..., ri].mean(-1)
    ry = ys[..., ri].mean(-1)
    lx = xs[..., li].mean(-1)
    ly = ys[..., li].mean(-1)
    return torch.sqrt((rx - lx) ** 2 + (ry - ly) ** 2)


# left/right landmark correspondence of the ibug-68 scheme under a
# horizontal flip (1-based ibug ids; ids not listed map to themselves)
_IBUG68_MIRROR_PAIRS = (
    (1, 17), (2, 16), (3, 15), (4, 14), (5, 13), (6, 12), (7, 11), (8, 10),
    (18, 27), (19, 26), (20, 25), (21, 24), (22, 23),        # brows
    (32, 36), (33, 35),                                      # nose base
    (37, 46), (38, 45), (39, 44), (40, 43), (41, 48), (42, 47),  # eyes
    (49, 55), (50, 54), (51, 53),                            # outer mouth
    (61, 65), (62, 64), (60, 56), (59, 57), (68, 66),        # inner mouth
)


def mirror_permutation(model_landmarks: Sequence[str]) -> np.ndarray:
    """(L,) index map for horizontally flipped faces (ibug naming).

    In a flipped image, the landmark named ``model_landmarks[i]`` sits at
    the mirrored position of the original image's landmark
    ``model_landmarks[perm[i]]``, so a flipped ground-truth row is
    ``x' = (W-1) - x[perm]``, ``y' = y[perm]``. Raises if the landmark set
    is not closed under the ibug-68 mirror map (a one-sided subset cannot
    be flip-augmented).
    """
    mirror = {}
    for a, b in _IBUG68_MIRROR_PAIRS:
        mirror[str(a)] = str(b)
        mirror[str(b)] = str(a)
    index = {n: i for i, n in enumerate(model_landmarks)}
    perm = []
    for n in model_landmarks:
        partner = mirror.get(n, n)
        if partner not in index:
            raise ValueError(
                f"landmark set is not mirror-closed: {n!r} needs its "
                f"flip partner {partner!r} (ibug-68 correspondence)")
        perm.append(index[partner])
    return np.asarray(perm, np.int64)


def get_ied(landmarks: LandmarkCollection, right_eye_ids: Sequence[str],
            left_eye_ids: Sequence[str]) -> float:
    """Host-side IED from named landmarks."""
    right = np.mean([landmarks[n] for n in right_eye_ids], axis=0)
    left = np.mean([landmarks[n] for n in left_eye_ids], axis=0)
    return float(np.linalg.norm(right - left))


def check_face(detected_faces, groundtruth: LandmarkCollection) -> bool:
    """True-positive filter: ground-truth landmarks "37", "46", "58" must be
    inside the first detected facebox (reference: helpers.hpp:106-131).

    detected_faces: sequence of (x, y, w, h) boxes.
    """
    if len(detected_faces) == 0:
        return False
    x, y, w, h = detected_faces[0]
    for name in ("37", "46", "58"):
        if name in groundtruth.names:
            px, py = groundtruth[name]
            # cv::Rect::contains uses half-open [x, x+w) x [y, y+h);
            # the reference converts to integer cv::Point first.
            ipx, ipy = int(px), int(py)
            if not (x <= ipx < x + w and y <= ipy < y + h):
                return False
    return True
