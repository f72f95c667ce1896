"""boost::serialization binary-archive codec for 2-D matrices.

The port's own copy of ``superviseddescent_tpu/io/boost_mat.py`` (pure
numpy; it writes the same bytes). The reference's legacy matrix adapter
(utils/mat_serialization.hpp) writes a cv::Mat through a boost archive as
``rows:int, cols:int, type:int, continuous:bool, raw data bytes``. The
stream, for boost ``binary_oarchive`` with default flags on 64-bit
little-endian:

  ========================  =======================================
  bytes                     meaning
  ========================  =======================================
  u64 = 22                  length of the signature string
  "serialization::archive"  archive signature
  u16                       archive library version
  -- first object of each class only --
  bool (1 byte)             class tracking flag (false: not tracked)
  u8                        class version (0 for cv::Mat)
  -- per object --
  i32, i32, i32             rows, cols, cv type code
  bool (1 byte)             continuous (always true when written here)
  rows*cols*itemsize bytes  raw matrix data
  ========================  =======================================

The format has never met a stream written by boost itself (boost is not
at hand); the library version (17 by default, boost 1.68+) can be pinned
with ``library_version=``, and reads accept any version and 1- or 4-byte
class versions. Held by round trips and by byte equality with the JAX
package's writer.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from superviseddescent_tpu_torch.io.cereal import _CV_DEPTH_TO_DTYPE

_SIGNATURE = b"serialization::archive"
DEFAULT_LIBRARY_VERSION = 17

_DTYPE_TO_CV_DEPTH = {np.dtype(v): k for k, v in _CV_DEPTH_TO_DTYPE.items()}


def _cv_type_for(arr: np.ndarray) -> int:
    depth = _DTYPE_TO_CV_DEPTH.get(arr.dtype)
    if depth is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    return depth  # single-channel: type == depth


def dumps_mats(mats: List[np.ndarray],
               library_version: int = DEFAULT_LIBRARY_VERSION) -> bytes:
    """Serialize 2-D arrays as one boost binary archive (header + objects).

    The class preamble (tracking flag + class version) is emitted before
    the first matrix only, as boost does per class per archive.
    """
    out = [struct.pack("<Q", len(_SIGNATURE)), _SIGNATURE,
           struct.pack("<H", library_version)]
    for i, arr in enumerate(mats):
        a = np.ascontiguousarray(arr)
        if a.ndim != 2:
            raise ValueError("only 2-D matrices are supported")
        if i == 0:
            out.append(struct.pack("<?B", False, 0))  # tracking, class ver
        out.append(struct.pack("<iii?", a.shape[0], a.shape[1],
                               _cv_type_for(a), True))
        out.append(a.tobytes())
    return b"".join(out)


class _BoostReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated boost archive")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def peek_mat_header(self) -> bool:
        """True if the next 13 bytes parse as a plausible mat header
        (empty matrices — zero rows or cols — are legal)."""
        if self.pos + 13 > len(self.data):
            return False
        rows, cols, typ = struct.unpack_from("<iii", self.data, self.pos)
        cont = self.data[self.pos + 12]
        return (rows >= 0 and cols >= 0 and typ in _CV_DEPTH_TO_DTYPE
                and cont in (0, 1))


def loads_mats(data: bytes) -> List[np.ndarray]:
    """Parse every matrix in a boost binary archive written by
    ``dumps_mats`` or by the reference's mat_serialization.hpp through a
    little-endian binary_oarchive."""
    r = _BoostReader(data)
    n = struct.unpack("<Q", r.take(8))[0]
    if n != len(_SIGNATURE) or r.take(len(_SIGNATURE)) != _SIGNATURE:
        raise ValueError("not a boost binary archive (bad signature)")
    r.take(2)  # library version — accepted, not interpreted

    mats: List[np.ndarray] = []
    first = True
    while r.pos < len(r.data):
        if first:
            # class preamble: tracking bool + class version (u8 in modern
            # boost binary archives, u32 in very old ones) — disambiguate
            # by checking which skip leaves a plausible mat header
            for skip in (2, 5, 0):
                save = r.pos
                if r.pos + skip <= len(r.data):
                    r.take(skip)
                    if r.peek_mat_header():
                        break
                r.pos = save
            else:
                raise ValueError("unrecognised class preamble")
            first = False
        rows, cols, typ, cont = struct.unpack("<iii?", r.take(13))
        depth = typ & 7
        if (typ >> 3) not in (0,):
            raise ValueError("only single-channel matrices are supported")
        dtype = np.dtype(_CV_DEPTH_TO_DTYPE[depth])
        raw = r.take(rows * cols * dtype.itemsize)
        # non-continuous mats are written row-wise with identical bytes
        # (mat_serialization.hpp:75-81), so one read covers both branches
        mats.append(np.frombuffer(raw, dtype=dtype)
                    .reshape(rows, cols).copy())
    return mats


def save_mats(path, mats: List[np.ndarray],
              library_version: int = DEFAULT_LIBRARY_VERSION) -> None:
    with open(path, "wb") as f:
        f.write(dumps_mats(mats, library_version))


def load_mats(path) -> List[np.ndarray]:
    with open(path, "rb") as f:
        return loads_mats(f.read())
