from superviseddescent_tpu_torch.io.pts import (
    read_pts_landmarks,
    write_pts_landmarks,
)
from superviseddescent_tpu_torch.io.meanshape import load_mean
from superviseddescent_tpu_torch.io.infocfg import (
    parse_info,
    read_landmarks_list_to_train,
    read_ied_definition,
)
from superviseddescent_tpu_torch.io.cereal import (
    load_detection_model,
    save_detection_model,
)

__all__ = [
    "read_pts_landmarks",
    "write_pts_landmarks",
    "load_mean",
    "parse_info",
    "read_landmarks_list_to_train",
    "read_ied_definition",
    "load_detection_model",
    "save_detection_model",
]
