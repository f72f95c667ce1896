"""ibug .pts landmark files. The reader skips 3 header lines, names the
points "1".."N" in file order and subtracts 1 from both coordinates
(1-based to 0-based), as the reference reader does
(rcr/landmarks_io.hpp); the writer is its inverse."""

from __future__ import annotations

import numpy as np

from superviseddescent_tpu_torch.utils.landmarks import LandmarkCollection


def write_pts_landmarks(filename, landmarks: LandmarkCollection) -> None:
    """Write an ibug .pts file, coordinates 1-based. The format carries no
    names (the reader names the points "1".."N"), so a collection named
    otherwise, e.g. a 22-landmark subset, is refused rather than renamed on
    the way back."""
    expect = [str(i + 1) for i in range(len(landmarks))]
    if list(landmarks.names) != expect:
        raise ValueError(
            ".pts carries no landmark names (read_pts_landmarks renames "
            "points '1'..'N' in file order): refusing to write a "
            f"collection named {list(landmarks.names)[:4]}...; filter or "
            "reorder to sequential ibug ids first")
    c = np.asarray(landmarks.coordinates, np.float32)
    with open(filename, "w") as f:
        f.write("version: 1\n")
        f.write(f"n_points:  {len(landmarks)}\n")
        f.write("{\n")
        for x, y in c:
            f.write(f"{x + 1.0:.6f} {y + 1.0:.6f}\n")
        f.write("}\n")


def read_pts_landmarks(filename) -> LandmarkCollection:
    with open(filename, "r") as f:
        lines = f.readlines()
    if len(lines) < 4:
        raise ValueError(f"not a .pts file (too short): {filename}")
    names, coords = [], []
    for line in lines[3:]:
        line = line.strip()
        if line == "}" or not line:
            break
        parts = line.split()
        try:
            x, y = float(parts[0]), float(parts[1])
        except (IndexError, ValueError) as e:
            raise ValueError(
                f"Landmark format error while parsing the line: {line}") from e
        names.append(str(len(names) + 1))
        coords.append((np.float32(x) - 1.0, np.float32(y) - 1.0))
    return LandmarkCollection(names, np.asarray(coords, np.float32))
