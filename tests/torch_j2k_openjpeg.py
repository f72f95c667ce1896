"""OpenJPEG 2.5's encoder through ctypes, for the JPEG 2000 fixtures.

PIL's ``save(..., "JPEG2000")`` reaches only part of OpenJPEG's options.
``encode`` calls the same ``libopenjp2`` that PIL bundles with the
parameter struct laid out as OpenJPEG 2.5's public ``openjpeg.h`` lays out
``opj_cparameters_t`` (the byte offsets below), so that the fixtures can
use code-block styles, SOP / EPH markers, progression order changes,
tile-parts, a region of interest, other precisions and subsampled
components. ``tests/torch_j2k_fixtures.py`` checks the layout first: a
write at PIL's default settings must equal PIL's own file byte for byte.
Test code only: the port never loads ``libopenjp2``.
"""

from __future__ import annotations

import ctypes
import glob
import os

import numpy as np

import PIL

# opj_cparameters_t (openjpeg.h, OpenJPEG 2.5, x86-64): byte offsets
TILE_SIZE_ON, CP_TX0, CP_TY0, CP_TDX, CP_TDY = 0, 4, 8, 12, 16
CP_DISTO_ALLOC, CP_FIXED_QUALITY = 20, 28
CP_COMMENT, CSTY, PROG_ORDER, POC = 40, 48, 52, 56
POC_SIZE = 148          # opj_poc_t
NUMPOCS, TCP_NUMLAYERS, TCP_RATES, TCP_DISTORATIO = 4792, 4796, 4800, 5200
NUMRESOLUTION, CBLOCKW, CBLOCKH, MODE, IRREVERSIBLE = (
    5600, 5604, 5608, 5612, 5616)
ROI_COMPNO, ROI_SHIFT, RES_SPEC, PRCW_INIT, PRCH_INIT = (
    5620, 5624, 5628, 5632, 5764)
IMAGE_OFFSET_X0, IMAGE_OFFSET_Y0 = 18188, 18192
TP_ON, TP_FLAG, TCP_MCT = 18696, 18697, 18698
PARAMS_SIZE = 18720
# opj_poc_t fields used by the encoder
POC_RESNO0, POC_COMPNO0, POC_LAYNO1, POC_RESNO1, POC_COMPNO1 = 0, 4, 8, 12, 16
POC_PRG1, POC_TILE = 32, 48
# opj_image_t / opj_image_comp_t
IMAGE_COMPS, COMP_SIZE, COMP_DATA = 24, 64, 48
PROGRESSIONS = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}
# code-block styles (COD's SPcod)
BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM = 1, 2, 4, 8, 16, 32
CODEC_J2K, CODEC_JP2 = 0, 2
CLRSPC_SRGB, CLRSPC_GRAY = 1, 2


def library():
    """PIL's bundled libopenjp2."""
    root = os.path.dirname(os.path.dirname(PIL.__file__))
    found = sorted(glob.glob(os.path.join(root, "pillow.libs",
                                          "libopenjp2*.so*")))
    if not found:
        raise RuntimeError("PIL's bundled libopenjp2 was not found")
    lib = ctypes.CDLL(found[0])
    P, U, I = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int
    for name, restype, argtypes in (
            ("opj_image_create", P, [U, P, I]),
            ("opj_create_compress", P, [I]),
            ("opj_setup_encoder", I, [P, P, P]),
            ("opj_stream_create_default_file_stream", P,
             [ctypes.c_char_p, I]),
            ("opj_start_compress", I, [P, P, P]),
            ("opj_encode", I, [P, P]),
            ("opj_end_compress", I, [P, P]),
            ("opj_stream_destroy", None, [P]),
            ("opj_destroy_codec", None, [P]),
            ("opj_image_destroy", None, [P]),
            ("opj_set_default_encoder_parameters", None, [P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _put(buf, offset, value, dtype=np.int32):
    np.frombuffer(buf, np.uint8)[offset:offset + np.dtype(dtype).itemsize] \
        = np.frombuffer(np.array(value, dtype).tobytes(), np.uint8)


def encode(planes, path, *, jp2=False, color=CLRSPC_SRGB, prec=8,
           signed=False, subsampling=None, offset=(0, 0), size=None,
           tiles=None, resolutions=None, codeblock=(64, 64), mode=0,
           irreversible=False, mct=False, progression="LRCP",
           rates=(0.0,), distortion=None, precincts=None, sop=False,
           eph=False, pocs=(), tile_parts=None, roi=None,
           comment=None) -> bytes:
    """Encode int planes (one a component, each at its subsampled size)
    into ``path`` and return the file's bytes. ``subsampling``: (dx, dy)
    a component; ``offset``: the image origin on the reference grid;
    ``size``: (width, height) on the grid (default: the first plane's
    size times its subsampling); ``tiles``: (x0, y0, w, h); ``rates`` or
    ``distortion``: one value a layer (OpenJPEG's ``-r`` / ``-q``);
    ``precincts``: (w, h) a resolution from the highest; ``pocs``:
    (resno0, compno0, layno1, resno1, compno1, progression) a change;
    ``tile_parts``: 'R', 'L' or 'C'; ``roi``: (component, shift)."""
    lib = library()
    buf = (ctypes.c_char * PARAMS_SIZE)()
    lib.opj_set_default_encoder_parameters(buf)
    n = len(planes)
    sub = list(subsampling or [(1, 1)] * n)
    precs = [prec] * n if np.isscalar(prec) else list(prec)
    if size is None:
        size = (planes[0].shape[1] * sub[0][0], planes[0].shape[0]
                * sub[0][1])
    x0, y0 = offset
    x1, y1 = x0 + size[0], y0 + size[1]
    layers = list(distortion if distortion is not None else rates)
    _put(buf, TCP_NUMLAYERS, len(layers))
    key = TCP_DISTORATIO if distortion is not None else TCP_RATES
    for i, v in enumerate(layers):
        _put(buf, key + 4 * i, v, np.float32)
    _put(buf, CP_FIXED_QUALITY if distortion is not None
         else CP_DISTO_ALLOC, 1)
    tw, th = (tiles[2], tiles[3]) if tiles else size
    if resolutions is None:        # as PIL chooses it
        resolutions = 6
        while min(tw, th) < (1 << (resolutions - 1)) and resolutions > 1:
            resolutions -= 1
    _put(buf, NUMRESOLUTION, resolutions)
    _put(buf, CBLOCKW, codeblock[0])
    _put(buf, CBLOCKH, codeblock[1])
    _put(buf, MODE, mode)
    _put(buf, IRREVERSIBLE, int(irreversible))
    _put(buf, PROG_ORDER, PROGRESSIONS[progression])
    _put(buf, IMAGE_OFFSET_X0, x0)
    _put(buf, IMAGE_OFFSET_Y0, y0)
    csty = (2 if sop else 0) | (4 if eph else 0)
    if precincts:
        csty |= 1
        _put(buf, RES_SPEC, len(precincts))
        for i, (pw, ph) in enumerate(precincts):
            _put(buf, PRCW_INIT + 4 * i, pw)
            _put(buf, PRCH_INIT + 4 * i, ph)
    _put(buf, CSTY, csty)
    if tiles:
        _put(buf, TILE_SIZE_ON, 1)
        for off, v in zip((CP_TX0, CP_TY0, CP_TDX, CP_TDY), tiles):
            _put(buf, off, v)
    if n == 3:
        _put(buf, TCP_MCT, int(mct), np.uint8)
    for i, (r0, c0, l1, r1, c1, prog) in enumerate(pocs):
        base = POC + POC_SIZE * i
        for off, v in ((POC_RESNO0, r0), (POC_COMPNO0, c0), (POC_LAYNO1, l1),
                       (POC_RESNO1, r1), (POC_COMPNO1, c1),
                       (POC_PRG1, PROGRESSIONS[prog]), (POC_TILE, 1)):
            _put(buf, base + off, v)
    _put(buf, NUMPOCS, len(pocs))
    if tile_parts:
        _put(buf, TP_ON, 1, np.uint8)
        _put(buf, TP_FLAG, ord(tile_parts), np.uint8)
    if roi:
        _put(buf, ROI_COMPNO, roi[0])
        _put(buf, ROI_SHIFT, roi[1])
    keep = []
    if comment is not None:
        text = ctypes.create_string_buffer(comment)
        keep.append(text)
        _put(buf, CP_COMMENT, ctypes.addressof(text), np.uint64)
    params = np.zeros((n, 9), np.uint32)
    for i, ((dx, dy), p) in enumerate(zip(sub, precs)):
        cx0, cy0 = -(-x0 // dx), -(-y0 // dy)
        params[i] = [dx, dy, -(-x1 // dx) - cx0, -(-y1 // dy) - cy0, cx0, cy0,
                     p, p, int(signed)]
        assert planes[i].shape == (params[i][3], params[i][2]), (
            i, planes[i].shape, params[i])
    image = lib.opj_image_create(n, params.ctypes.data, color)
    if not image:
        raise RuntimeError("opj_image_create failed")
    try:
        header = np.frombuffer((ctypes.c_char * 16).from_address(image),
                               np.uint32)
        header[:] = [x0, y0, x1, y1]
        comps = ctypes.c_void_p.from_address(image + IMAGE_COMPS).value
        for i, plane in enumerate(planes):
            data = ctypes.c_void_p.from_address(
                comps + COMP_SIZE * i + COMP_DATA).value
            q = np.ascontiguousarray(plane, np.int32)
            ctypes.memmove(data, q.ctypes.data, q.nbytes)
        codec = lib.opj_create_compress(CODEC_JP2 if jp2 else CODEC_J2K)
        try:
            if not lib.opj_setup_encoder(codec, buf, image):
                raise RuntimeError("opj_setup_encoder failed")
            stream = lib.opj_stream_create_default_file_stream(
                os.fsencode(path), 0)
            try:
                if not (lib.opj_start_compress(codec, image, stream)
                        and lib.opj_encode(codec, stream)
                        and lib.opj_end_compress(codec, stream)):
                    raise RuntimeError(f"OpenJPEG could not encode {path}")
            finally:
                lib.opj_stream_destroy(stream)
        finally:
            lib.opj_destroy_codec(codec)
    finally:
        lib.opj_image_destroy(image)
    with open(path, "rb") as f:
        return f.read()
