"""Byte-exact reader/writer for the reference's cereal binary model format.

The reference saves RCR models with cereal::BinaryOutputArchive: a raw
little-endian concatenation with no field tags.

detection_model (rcr/model.hpp):
    SupervisedDescentOptimiser, mean: Mat, landmark_ids: vec<str>,
    hog_params: vec<HoGParam>, right_eye_ids: vec<str>, left_eye_ids: vec<str>
SupervisedDescentOptimiser: regressors: vec<LinearRegressor>,
    normalisation: InterEyeDistanceNormalisation (3 x vec<str>)
LinearRegressor: x: Mat, Regulariser (int32 type, float32 lambda, bool)
HoGParam: int32 vlhog_variant, int32 num_cells, int32 cell_size,
    int32 num_bins, float32 relative_patch_size
cv::Mat: int32 rows, int32 cols, int32 type, bool continuous, raw bytes
vector: uint64 count, then elements; string: uint64 size, then bytes

This is the port's own copy of the numpy codec; it uses no torch.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np

# cv depth codes -> numpy dtypes (type = depth + (channels-1)*8)
_CV_DEPTH_TO_DTYPE = {
    0: np.uint8, 1: np.int8, 2: np.uint16, 3: np.int16,
    4: np.int32, 5: np.float32, 6: np.float64,
}
CV_32F = 5


@dataclass
class CerealHoGParam:
    vlhog_variant: int  # 0=DalalTriggs, 1=Uoctti
    num_cells: int
    cell_size: int
    num_bins: int
    relative_patch_size: float


@dataclass
class CerealRegressor:
    weights: np.ndarray           # (F, 2L) float32, the reference's `x`
    regularisation_type: int = 0  # 0=Manual, 1=MatrixNorm
    lambda_: float = 0.0
    regularise_last_row: bool = True


@dataclass
class CerealDetectionModel:
    """The serialized state of rcr::detection_model."""
    regressors: List[CerealRegressor]
    norm_model_landmarks: List[str]
    norm_right_eye_ids: List[str]
    norm_left_eye_ids: List[str]
    mean: np.ndarray              # (2L,) float32 row
    landmark_ids: List[str]
    hog_params: List[CerealHoGParam]
    right_eye_ids: List[str]
    left_eye_ids: List[str] = field(default_factory=list)


class _Writer:
    def __init__(self):
        self.parts = []

    def pack(self, fmt, v):
        self.parts.append(struct.pack(fmt, v))

    def string(self, s: str):
        b = s.encode("utf-8")
        self.pack("<Q", len(b))
        self.parts.append(b)

    def string_vec(self, v):
        self.pack("<Q", len(v))
        for s in v:
            self.string(s)

    def mat(self, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.dtype != np.float32:
            raise ValueError("only CV_32FC1 matrices are written")
        self.pack("<i", arr.shape[0])
        self.pack("<i", arr.shape[1])
        self.pack("<i", CV_32F)
        self.pack("<?", True)  # continuous
        self.parts.append(arr.tobytes())


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("cereal archive truncated")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self):
        return self.take(self.unpack("<Q")).decode("utf-8")

    def string_vec(self):
        return [self.string() for _ in range(self.unpack("<Q"))]

    def mat(self) -> np.ndarray:
        rows, cols, cvtype = (self.unpack("<i") for _ in range(3))
        self.unpack("<?")  # continuous or not, rows*cols elements follow
        if (cvtype >> 3) != 0:
            raise ValueError(f"multi-channel Mat not supported: type {cvtype}")
        dtype = np.dtype(_CV_DEPTH_TO_DTYPE[cvtype & 7])
        buf = self.take(rows * cols * dtype.itemsize)
        return np.frombuffer(buf, dtype=dtype).reshape(rows, cols).copy()


def save_detection_model(model: CerealDetectionModel, filename):
    """Write a reference-compatible model.bin."""
    w = _Writer()
    w.pack("<Q", len(model.regressors))
    for reg in model.regressors:
        w.mat(np.asarray(reg.weights, np.float32))
        w.pack("<i", int(reg.regularisation_type))
        w.pack("<f", float(reg.lambda_))
        w.pack("<?", bool(reg.regularise_last_row))
    w.string_vec(model.norm_model_landmarks)
    w.string_vec(model.norm_right_eye_ids)
    w.string_vec(model.norm_left_eye_ids)
    w.mat(np.asarray(model.mean, np.float32))
    w.string_vec(model.landmark_ids)
    w.pack("<Q", len(model.hog_params))
    for hp in model.hog_params:
        for v in (hp.vlhog_variant, hp.num_cells, hp.cell_size, hp.num_bins):
            w.pack("<i", int(v))
        w.pack("<f", float(hp.relative_patch_size))
    w.string_vec(model.right_eye_ids)
    w.string_vec(model.left_eye_ids)
    with open(filename, "wb") as f:
        f.write(b"".join(w.parts))


def load_detection_model(filename) -> CerealDetectionModel:
    """Read a reference model.bin."""
    with open(filename, "rb") as f:
        data = f.read()
    r = _Reader(data)
    regressors = []
    for _ in range(r.unpack("<Q")):
        weights = r.mat().astype(np.float32)
        regressors.append(CerealRegressor(
            weights=weights, regularisation_type=r.unpack("<i"),
            lambda_=r.unpack("<f"), regularise_last_row=r.unpack("<?")))
    norm_model_landmarks = r.string_vec()
    norm_right = r.string_vec()
    norm_left = r.string_vec()
    mean = r.mat().reshape(-1).astype(np.float32)
    landmark_ids = r.string_vec()
    hog_params = [
        CerealHoGParam(vlhog_variant=r.unpack("<i"), num_cells=r.unpack("<i"),
                       cell_size=r.unpack("<i"), num_bins=r.unpack("<i"),
                       relative_patch_size=r.unpack("<f"))
        for _ in range(r.unpack("<Q"))]
    right_eye_ids = r.string_vec()
    left_eye_ids = r.string_vec()
    if r.pos != len(data):
        raise ValueError(
            f"trailing bytes in model file: read {r.pos} of {len(data)}")
    return CerealDetectionModel(
        regressors=regressors, norm_model_landmarks=norm_model_landmarks,
        norm_right_eye_ids=norm_right, norm_left_eye_ids=norm_left,
        mean=mean, landmark_ids=landmark_ids, hog_params=hog_params,
        right_eye_ids=right_eye_ids, left_eye_ids=left_eye_ids)
