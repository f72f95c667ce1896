"""ibug .pts landmark reader: skip 3 header lines, name the points
"1".."N" in file order, and subtract 1 from both coordinates (1-based to
0-based), as the reference reader does (rcr/landmarks_io.hpp)."""

from __future__ import annotations

import numpy as np

from superviseddescent_tpu_torch.utils.landmarks import LandmarkCollection


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
