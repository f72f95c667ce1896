"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles on its own with nvcc into a shared library with a
plain C interface, loaded with ctypes: pointers and the stream pass as
``c_void_p``, and every C entry point returns ``cudaGetLastError()``.
Libraries go to ``build/torch_kernels/`` beside the package (git-ignored),
named by a hash of the source, the headers (``csrc/*.cuh``, ``*.h``) and
the flags,
so an edited source rebuilds and an unchanged one is reused.

``-fmad=false`` keeps every float multiply and add rounding on its own, as
PyTorch's separate elementwise operations do: the kernels then agree with
their plain twins operation for operation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

# C entry points: source name -> {symbol: argument types}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# the cascade kernels' common tail: x0, out, weights, level tables, tents,
# eyes; n, levels, L, C, RY, RX, Fp, quantize, S_max, faces per block,
# landmarks per group, threads per block; stream
_CASCADE = [_P] * 7 + [_I] * 12 + [_P]
# the feature extractors' common tail: x, out, level tables, tents, eyes;
# n, L, C, RY, RX, S, samples per block, landmarks per group, threads per
# block; stream
_FEATURES = [_P] * 6 + [_I] * 9 + [_P]
KERNELS = {
    "hog_flat": {"hog_flat_launch":
                 [_P, _I, _P, _P, _P] + [_I] * 9 + [_P]},
    "patches_window": {"patches_window_launch":
                       [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P]},
    "cascade_fused": {"cascade_fused_frames_launch":
                      [_P] * 4 + [_I] * 3 + _CASCADE,
                      "cascade_fused_launch": [_P] + _CASCADE},
    "features_fused": {"features_fused_frames_launch":
                       [_P] * 4 + [_I] * 3 + _FEATURES,
                       "features_fused_launch": [_P] + _FEATURES},
    # the probes (probes/sampler.py, flatout.py, dyn.py)
    "probe_sampler": {"probe_sampler_launch": [_P] * 5 + [_I] * 12 + [_P]},
    "probe_flatout": {"probe_flatout_launch": [_P, _P, _I, _I, _P]},
    "probe_dyn": {"probe_abde_launch": [_P] * 3 + [_I] * 10 + [_P],
                  "probe_c_launch": [_P, _P] + [_I] * 3 + [_P],
                  "probe_empty_launch": [_P]},
    # JPEG (ops/jpeg.py): the host entropy decoder and J1
    "jpeg_decode": {"jpeg_entropy_decode": [_P, _I, _P, _P, _P],
                    "jpeg_pixels_launch": [_P] * 5,
                    "jpeg_samples_launch": [_P] * 5},
    # JPEG writing (ops/jpeg.py): J2 and the host Huffman coder
    "jpeg_encode": {"jpeg_coefficients_launch": [_P] * 5,
                    "jpeg_huffman_encode": [_P, _I, _P, _P, _P, _I]},
    # WebP (io/webp.py, io/vp8.py): the host VP8L decoder and the host
    # entropy stage of lossy WebP, no kernel
    "webp_decode": {"webp_decode_vp8l": [_P, _I, _I, _I, _P],
                    "webp_decode_vp8": [_P, _I, _I, _I] + [_P] * 4},
    # TIFF (io/tiff.py, io/ccitt.py, io/zstd.py): the host CCITT and
    # Zstandard decoders, no kernel
    "tiff_decode": {"tiff_ccitt_decode": [_P, _L] + [_I] * 4 + [_P],
                    "tiff_zstd_decode": [_P, _L, _P, _L, _P]},
    # GIF writing (io/gif_write.py): the host median-cut quantiser and LZW
    # coder, no kernel
    "gif_encode": {"gif_quantize": [_P, _L, _P, _P],
                   "gif_lzw_encode": [_P, _I, _I, _I, _P, _L]},
    # WebP writing (io/vp8_write.py): the host VP8 encoder, no kernel
    "webp_encode": {"webp_encode_vp8": [_P, _I, _I, _P, _L]},
    # JPEG 2000 (ops/j2k.py): the host markers, tier-2 and tier-1, no
    # kernel; and its pixel stage, D1 and M1
    "j2k_decode": {"j2k_decode": [_P, _L, _P, _L, _P, _I, _P, _I, _P],
                   "j2k_components": [_P, _L, _P, _I]},
    "j2k_pixels": {"j2k_idwt_launch": [_P] * 4 + [_I] * 2 + [_P],
                   "j2k_colour_launch": [_P, _P] + [_I] * 4 + [_P, _P]},
    # lossy WebP's pixel stage (ops/webp.py): W1, W2 and W3
    "vp8_pixels": {"vp8_reconstruct_launch": [_P] * 6 + [_I] * 4 + [_P],
                   "vp8_filter_launch": [_P] * 5 + [_I] * 5 + [_P],
                   "vp8_colour_launch": [_P] * 4 + [_I] * 5 + [_P]},
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _flags(defines: tuple) -> list:
    return [*NVCC_FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: tuple = ()) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(
        [*CSRC.glob("*.cuh"), *CSRC.glob("*.h")]))
    key = hashlib.sha256(source + headers
                         + " ".join(_flags(defines)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def _start(name: str, defines: tuple = ()):
    """Start nvcc for one source unless its library exists; returns the
    process (or None) and the temporary output path."""
    path = library_path(name, defines)
    if path.exists():
        return None, path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(defines), "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, proc, tmp: Path, defines: tuple = ()) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, library_path(name, defines))
    return log


def build_all(extra=()) -> dict:
    """Compile every kernel, one nvcc per source, all started together,
    and the measurement builds ``extra`` ((name, defines) pairs) beside
    them. Returns {name: compiler log} (ptxas register and shared-memory
    usage; empty for a library that was already built; a measurement
    build's key is its name and defines joined by "+") and the seconds
    taken under the key "seconds"."""
    t0 = time.perf_counter()
    builds = [(name, ()) for name in KERNELS] + [
        (name, tuple(defines)) for name, defines in extra]
    started = [(name, defines, *_start(name, defines))
               for name, defines in builds]
    logs = {"+".join((name, *defines)): _finish(name, proc, tmp, defines)
            for name, defines, proc, tmp in started}
    logs["seconds"] = time.perf_counter() - t0
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: tuple = ()):
    """The loaded library of kernel ``name``, built at first use.
    ``defines`` (macro names) select a measurement build of the source;
    the entry points load the plain build only."""
    _finish(name, *_start(name, defines), defines)
    lib = ctypes.CDLL(str(library_path(name, defines)))
    for symbol, argtypes in KERNELS[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
