"""Kernels D1 and M1: the pixel stage of JPEG 2000 on the card.

``read_j2k`` reads a JPEG 2000 file (a JP2 file or a raw codestream) as
PIL 12.1 reads it. The file layer and PIL's mode are ``io/jp2.py``'s. The
codestream's markers, tier-2 and tier-1 run on the host, and the pixel
stage runs where the caller asks:

* on the card, the host C++ decoder of ``csrc/j2k_decode.cu``
  (``j2k_decode``) writes every tile-component's plane of coefficients
  (int32 for the 5/3 transform, float32 for 9/7, in OpenJPEG's band
  layout) and their tables into pinned memory, they go to the card, and
  two kernels of ``csrc/j2k_pixels.cu`` run there: D1 (``j2k_idwt``: the
  inverse wavelet transform of every tile and component at once, in
  ``idwt_plan``'s launches: one a level, in tiles) and M1
  (``j2k_colour``: the inverse RCT or ICT, the DC level shift and clamp,
  Pillow's unpacking of each tile into the frame, and the colour or grey
  PIL's ``convert("RGB")`` and the JAX package's ``load_gray_image`` give,
  a CTA a band of a tile's rows);
* on the CPU, the Python twins of the host stage (``io/j2k.py``,
  ``io/j2k_t2.py``, ``io/j2k_t1.py``) and the plain PyTorch twins of the
  two kernels here (``idwt_reference``, ``colour_reference``).

A kernel's wrapper takes its twin only where its input lies on the CPU; on
the card a failed build or launch raises, and nothing falls back.

The host stage's output (``J2kFrame``): ``coeffs``, every plane flat,
tile by tile and component by component (a 9/7 plane's float32 bits in
the int32 words); ``tcs``, a row a tile-component (``TC_*`` columns: the
plane's offset, width and height, its origin, its levels, 5/3 or 9/7, its
component, then each resolution's rectangle from the coarsest); ``tiles``,
a row a tile (its rectangle on the reference grid, the component
transform, its first tile-component's row).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from superviseddescent_tpu_torch.io import jp2 as J
from superviseddescent_tpu_torch.utils.device import resolve_device

MAX_RES = 33
TC_OFFSET, TC_W, TC_H, TC_X0, TC_Y0, TC_LEVELS, TC_REV, TC_COMP = range(8)
TC_RES = 8
TC_COLS = TC_RES + 4 * MAX_RES
TILE_COLS = 6
# the kinds of Pillow's unpacking (io/jp2.unpacker), as M1 takes them, and
# the channels each unpacks
KINDS = {"grey": 0, "grey16": 1, "rgb": 2, "sycc": 3, "cmyk": 4}
WANTED = {0: 1, 1: 1, 2: 3, 3: 3, 4: 4}
# OpenJPEG's 9/7 lifting (dwt.c): steps, K and the "two_invK" it scales
# the high band by
ALPHA, BETA, GAMMA, DELTA = -1.586134342, -0.052980118, 0.882911075, \
    0.443506852
K97, TWO_INV_K = 1.230174105, 1.625732422
# OpenJPEG's inverse ICT (mct.c)
ICT = (1.402, 0.34413, 0.71414, 1.772)
_INT32_MAX = 2 ** 31 - 1


class J2kFrame(NamedTuple):
    width: int              # the image on the reference grid
    height: int
    x0: int
    y0: int
    tx0: int                # the tile grid
    ty0: int
    tdx: int
    tdy: int
    comps: np.ndarray       # (components, 4): precision, signed, dx, dy
    coeffs: torch.Tensor    # int32 (n,)
    tcs: np.ndarray         # int32 (tile-components, TC_COLS)
    tiles: np.ndarray       # int32 (tiles, TILE_COLS)


def _ycc_tables() -> np.ndarray:
    """PIL's YCbCr -> RGB tables (``ConvertYCbCr.c``): (int)(k * (i - 128)
    * 64 + 0.5) for R_Cr, G_Cb, G_Cr, B_Cb, each summed and shifted
    right by 6."""
    c = np.arange(256, dtype=np.float64) - 128
    out = [np.trunc(k * c * 64 + 0.5) for k in (1.402, -0.34414, -0.71414,
                                                 1.772)]
    return np.stack(out).astype(np.int32)


YCC = _ycc_tables()


# ---------------------------------------------------------------- #
# the host stage
# ---------------------------------------------------------------- #
def decode_python(codestream: bytes) -> J2kFrame:
    """The Python twin of the host stage: markers, tier-2 and tier-1."""
    from superviseddescent_tpu_torch.io import j2k as K
    from superviseddescent_tpu_torch.io.j2k_t1 import tile_planes
    from superviseddescent_tpu_torch.io.j2k_t2 import (
        HeaderSource, read_packets)
    cs = K.parse(codestream)
    ppm = None
    if cs.ppm is not None:
        ppm = HeaderSource(b"".join(cs.ppm))
    planes, tcs, tiles = [], [], []
    offset = 0
    for index in range(cs.tiles_across * cs.tiles_down):
        tile = cs.tiles[index]
        geometry = K.tile_geometry(cs, tile)
        precincts = read_packets(cs, tile, geometry, ppm)
        tx0, ty0, tx1, ty1 = K.tile_rect(cs, index)
        tiles.append([tx0, ty0, tx1, ty1, tile.mct, len(tcs)])
        for c, plane in enumerate(tile_planes(cs, tile, geometry,
                                              precincts)):
            tc = geometry[c]
            row = [0] * TC_COLS
            row[:TC_RES] = [offset, tc.x1 - tc.x0, tc.y1 - tc.y0, tc.x0,
                            tc.y0, tile.comps[c].levels,
                            int(tile.comps[c].reversible), c]
            for r, res in enumerate(tc.resolutions):
                row[TC_RES + 4 * r:TC_RES + 4 * r + 4] = [
                    res.x0, res.y0, res.x1, res.y1]
            tcs.append(row)
            planes.append(plane.reshape(-1).view(np.int32))
            offset += plane.size
    comps = np.array([[c.prec, int(c.signed), c.dx, c.dy]
                      for c in cs.comps], np.int32)
    coeffs = torch.from_numpy(np.concatenate(planes) if planes else
                              np.zeros(0, np.int32))
    return J2kFrame(cs.x1 - cs.x0, cs.y1 - cs.y0, cs.x0, cs.y0, cs.tx0,
                    cs.ty0, cs.tdx, cs.tdy, comps, coeffs,
                    np.array(tcs, np.int32).reshape(-1, TC_COLS),
                    np.array(tiles, np.int32).reshape(-1, TILE_COLS))


ERRORS = {2: "not a JPEG 2000 codestream", 3: "HTJ2K (Part 15) is not "
          "ported", 4: "a damaged codestream", 5: "a marker or a parameter "
          "the port does not read", 6: "the codestream does not end with "
          "EOC", 7: "a damaged codestream: a SOP or EPH marker is missing "
          "(OpenJPEG warns and reads on)"}


def decode_native(codestream: bytes, library=None,
                  pinned: bool = False) -> J2kFrame:
    """The host C++ stage (``csrc/j2k_decode.cu``, ``j2k_decode``): the
    same frame as ``decode_python``, its coefficients in pinned memory
    where ``pinned``. ``library``: a loaded build (the tests build it with
    g++)."""
    if library is None:
        from superviseddescent_tpu_torch.ops._build import load_library
        library = load_library("j2k_decode")
    buf = np.frombuffer(codestream, np.uint8)
    info = np.zeros(16, np.int64)
    P = ctypes.c_void_p
    err = library.j2k_decode(P(buf.ctypes.data), len(buf), None, 0, None,
                             0, None, 0, P(info.ctypes.data))
    if err != 1:
        raise ValueError(_message(err, info))
    ncoef, ntc, ntile, ncomp = (int(v) for v in info[:4])
    coeffs = torch.empty(max(ncoef, 1), dtype=torch.int32,
                         pin_memory=pinned)
    tcs = np.zeros((ntc, TC_COLS), np.int32)
    tiles = np.zeros((ntile, TILE_COLS), np.int32)
    err = library.j2k_decode(P(buf.ctypes.data), len(buf),
                             P(coeffs.data_ptr()), ncoef,
                             P(tcs.ctypes.data), ntc, P(tiles.ctypes.data),
                             ntile, P(info.ctypes.data))
    if err:
        raise ValueError(_message(err, info))
    x1, y1, x0, y0, tx0, ty0, tdx, tdy = (int(v) for v in info[4:12])
    comps = np.zeros((ncomp, 4), np.int32)
    err = library.j2k_components(P(buf.ctypes.data), len(buf),
                                 P(comps.ctypes.data), ncomp)
    if err:
        raise ValueError(_message(err, info))
    return J2kFrame(x1 - x0, y1 - y0, x0, y0, tx0, ty0, tdx, tdy, comps,
                    coeffs[:ncoef], tcs, tiles)


def _message(err: int, info) -> str:
    return f"JPEG 2000: {ERRORS.get(err, f'error {err}')} (at {info[12]})"


def host_stage(codestream: bytes, device) -> J2kFrame:
    """The host stage for ``device``: the Python twin on the CPU; the C++
    decoder into pinned memory, then the coefficients to the card."""
    if device.type == "cpu":
        return decode_python(codestream)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    f = decode_native(codestream, pinned=True)
    return f._replace(coeffs=f.coeffs.to(device, non_blocking=True))


# ---------------------------------------------------------------- #
# D1: the inverse wavelet transform
# ---------------------------------------------------------------- #
def idwt_jobs(tcs: np.ndarray, level: int) -> np.ndarray:
    """The tile-components that have a level ``level`` (0 the coarsest)
    and its lines: int32 (jobs, 10) of plane offset, stride, the level's
    width and height, the low band's width and height, the parities of
    the level's origin (OpenJPEG's ``cas``), 5/3 or 9/7, then unused."""
    rows = tcs[tcs[:, TC_LEVELS] > level]
    lo = rows[:, TC_RES + 4 * level:TC_RES + 4 * level + 4]
    hi = rows[:, TC_RES + 4 * (level + 1):TC_RES + 4 * (level + 1) + 4]
    out = np.zeros((len(rows), 10), np.int32)
    out[:, 0] = rows[:, TC_OFFSET]
    out[:, 1] = rows[:, TC_W]
    out[:, 2] = hi[:, 2] - hi[:, 0]
    out[:, 3] = hi[:, 3] - hi[:, 1]
    out[:, 4] = lo[:, 2] - lo[:, 0]
    out[:, 5] = lo[:, 3] - lo[:, 1]
    out[:, 6] = hi[:, 0] & 1
    out[:, 7] = hi[:, 1] & 1
    out[:, 8] = rows[:, TC_REV]
    return out


def _lift53(x: torch.Tensor, sn: int, cas: int) -> torch.Tensor:
    """OpenJPEG's 5/3 synthesis of lines x (B, n): sn low samples first,
    the line's first sample odd where ``cas``."""
    n = x.shape[1]
    if n == 1:
        return torch.div(x, 2, rounding_mode="trunc") if cas else x
    y = torch.empty_like(x)
    y[:, cas::2] = x[:, :sn]
    y[:, 1 - cas::2] = x[:, sn:]
    idx = torch.arange(n, device=x.device)
    left = torch.where(idx > 0, idx - 1, idx + 1)
    right = torch.where(idx < n - 1, idx + 1, idx - 1)
    even = idx[cas::2]                            # the low samples
    y[:, even] = y[:, even] - torch.div(
        y[:, left[even]] + y[:, right[even]] + 2, 4, rounding_mode="floor")
    odd = idx[1 - cas::2]
    y[:, odd] = y[:, odd] + torch.div(
        y[:, left[odd]] + y[:, right[odd]], 2, rounding_mode="floor")
    return y


def _lift97(x: torch.Tensor, sn: int, cas: int) -> torch.Tensor:
    """OpenJPEG 2.5.4's 9/7 synthesis (``opj_v8dwt_decode``) of float32
    lines: low samples times K, high ones times two_invK, then the four
    lifting steps, each (left + right) * c added, float32 throughout."""
    n = x.shape[1]
    if n == 1:
        return x
    f32 = torch.float32
    y = torch.empty_like(x)
    y[:, cas::2] = x[:, :sn] * torch.tensor(K97, dtype=f32)
    y[:, 1 - cas::2] = x[:, sn:] * torch.tensor(TWO_INV_K, dtype=f32)
    idx = torch.arange(n, device=x.device)
    left = torch.where(idx > 0, idx - 1, idx + 1)
    right = torch.where(idx < n - 1, idx + 1, idx - 1)
    low, high = idx[cas::2], idx[1 - cas::2]
    for which, c in ((low, -DELTA), (high, -GAMMA), (low, -BETA),
                     (high, -ALPHA)):
        t = (y[:, left[which]] + y[:, right[which]]) * torch.tensor(
            c, dtype=f32)
        y[:, which] = y[:, which] + t
    return y


def _idwt_twin_pass(coeffs: torch.Tensor, jobs: np.ndarray,
                    vertical: bool) -> torch.Tensor:
    out = coeffs.clone()
    for off, stride, rw, rh, snh, snv, cash, casv, rev, _ in jobs.tolist():
        if rw == 0 or rh == 0:
            continue
        plane = out[off:off + stride * rh].view(rh, stride)[:, :rw]
        if not rev:
            plane = plane.view(torch.float32)
        lines = plane.t() if vertical else plane
        sn, cas = (snv, casv) if vertical else (snh, cash)
        lift = _lift53 if rev else _lift97
        done = lift(lines.contiguous(), sn, cas)
        plane.copy_(done.t() if vertical else done)
    return out


def idwt_reference(coeffs: torch.Tensor, tcs: np.ndarray) -> torch.Tensor:
    """The plain twin of D1: every tile-component's planes synthesised,
    level by level from the coarsest, rows then columns as OpenJPEG's
    ``opj_dwt_decode_tile`` / ``opj_dwt_decode_real`` run them."""
    out = coeffs
    for level in range(int(tcs[:, TC_LEVELS].max(initial=0))):
        jobs = idwt_jobs(tcs, level)
        out = _idwt_twin_pass(out, jobs, False)
        out = _idwt_twin_pass(out, jobs, True)
    return out


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _upload(table: np.ndarray, device) -> torch.Tensor:
    """``table`` (int32) to ``device`` in one copy from pinned memory."""
    pinned = torch.empty(max(len(table), 1), dtype=torch.int32,
                         pin_memory=True)
    pinned[:len(table)] = torch.from_numpy(table)
    return pinned.to(device, non_blocking=True)


# D1's launch plan (``idwt_plan``): a launch a level, a CTA an output tile
# of IDWT_TILE (columns, rows) staged with IDWT_HALO samples each side
# (5/3: its two lifting steps, 9/7: its four; a sample of a step reads its
# neighbours, so the k-th step spoils k samples in from a window's cut
# edge). On an H100 this took 0.0203-0.0333 ms on 1 to 12 of the 5/3 clip
# frame's 256 x 256 RGB tiles and 0.0276 / 0.0415 ms on the 9/7 frame's
# grey / RGB, where a CTA a tile-component taking its levels of up to
# 1,024, 4,096 or 16,384 samples in shared memory, in one launch, took
# longer at every count but the 12 tiles (1% less at 16,384)
IDWT_TILE = (64, 32)
IDWT_HALO = {1: 2, 0: 4}
IDWT_MAX_TILE, IDWT_MAX_HALO = (64, 64), 4   # the kernel's shared memory
# a level's row of the plan's table: the plane's offset and stride, the
# level's width and height, the low bands' width and height, the parities
# of its origin (OpenJPEG's cas), 5/3 (1) or 9/7 (0), the buffers it reads
# its LL band from and writes to, its tiles across, the tile's columns and
# rows, the halo, and 1 where the row copies a plane with no levels
(LV_OFF, LV_STRIDE, LV_RW, LV_RH, LV_SNH, LV_SNV, LV_CASH, LV_CASV, LV_REV,
 LV_SRC, LV_DST, LV_TILES_X, LV_TW, LV_TH, LV_HALO, LV_COPY) = range(16)
LEVEL_COLS = 16
# the buffers: the host stage's planes (read only), the output, a scratch
# plane; a tile-component's levels alternate between the last two so that
# its last level writes the output
HOST, OUT, SCRATCH = 0, 1, 2
# a CTA's row of a launch: its level's row, its tile, then that level's
# row itself (the kernel reads both in one round trip)
TILE_CTA_COLS = 2 + LEVEL_COLS


class IdwtLaunch(NamedTuple):
    start: int      # the launch's first CTA row, in ints of the table
    ctas: int


class IdwtPlan(NamedTuple):
    """D1's launches for one read: ``table`` (int32, uploaded once) holds
    the level rows (``levels``, LEVEL_COLS each), then each launch's CTA
    rows."""
    table: np.ndarray
    levels: np.ndarray      # (level rows, LEVEL_COLS)
    launches: tuple         # IdwtLaunch


def _levels_of(row: np.ndarray):
    """(width, height, low width, low height, cash, casv) of each level of
    a tile-component's row of ``tcs``, the coarsest first."""
    out = []
    for level in range(int(row[TC_LEVELS])):
        lo = row[TC_RES + 4 * level:TC_RES + 4 * level + 4]
        hi = row[TC_RES + 4 * (level + 1):TC_RES + 4 * (level + 1) + 4]
        out.append((int(hi[2] - hi[0]), int(hi[3] - hi[1]),
                    int(lo[2] - lo[0]), int(lo[3] - lo[1]), int(hi[0] & 1),
                    int(hi[1] & 1)))
    return out


def idwt_plan(tcs: np.ndarray, tile: tuple = IDWT_TILE) -> IdwtPlan:
    """D1's plan: the j-th level (the coarsest first) of every
    tile-component runs in the j-th launch, a CTA a ``tile`` of (columns,
    rows) of the level's output; a plane with no levels is copied, a CTA a
    tile, in the first. So a read takes a launch for each j where some
    tile-component's j-th level (or plane with no levels, j = 0) has
    samples: 5 for either 768 x 1024 clip frame (5 levels)."""
    tw, th = tile
    if not (1 <= tw <= IDWT_MAX_TILE[0] and 1 <= th <= IDWT_MAX_TILE[1]):
        raise ValueError(f"D1's tiles are at most {IDWT_MAX_TILE}")
    levels, launches_rows = [], []
    for row in tcs:
        off, W, H = int(row[TC_OFFSET]), int(row[TC_W]), int(row[TC_H])
        if W == 0 or H == 0:
            continue
        geometry = _levels_of(row)
        n = len(geometry)
        rev = int(row[TC_REV])

        def dst(level):
            return OUT if (n - 1 - level) % 2 == 0 else SCRATCH
        if n == 0:
            geometry, copy = [(W, H, W, H, 0, 0)], 1
        else:
            copy = 0
        for level, (rw, rh, snh, snv, cash, casv) in enumerate(geometry):
            if level == len(launches_rows):
                launches_rows.append([])
            tiles = -(-rw // tw) * -(-rh // th)
            launches_rows[level].append(np.stack([
                np.full(tiles, len(levels)), np.arange(tiles)], axis=1))
            levels.append([off, W, rw, rh, snh, snv, cash, casv, rev,
                           HOST if level == 0 else dst(level - 1),
                           OUT if copy else dst(level), -(-rw // tw), tw, th,
                           IDWT_HALO[rev], copy])
    parts = [np.array(levels, np.int32).reshape(-1, LEVEL_COLS)]
    launches = []
    at = parts[0].size
    for rows in launches_rows:
        rows = np.concatenate(rows)
        if not len(rows):   # levels of no samples
            continue
        rows = np.concatenate([rows, parts[0][rows[:, 0]]], axis=1).astype(
            np.int32)
        parts.append(rows)
        launches.append(IdwtLaunch(at, len(rows)))
        at += rows.size
    table = np.concatenate([p.reshape(-1) for p in parts]).astype(np.int32)
    return IdwtPlan(table, parts[0], tuple(launches))


def j2k_idwt(coeffs: torch.Tensor, tcs: np.ndarray,
             plan: IdwtPlan | None = None) -> torch.Tensor:
    """D1: the inverse DWT of every tile-component's plane on the card,
    into a new tensor in the same layout (the host stage's planes stay as
    they are), in ``idwt_plan``'s launches (``plan``: another plan of the
    same ``tcs``); on the CPU the twin's copy."""
    if coeffs.device.type == "cpu":
        return idwt_reference(coeffs, tcs)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    if coeffs.dtype != torch.int32 or not coeffs.is_contiguous():
        raise ValueError("D1 takes the host stage's contiguous int32 planes")
    if coeffs.numel() > _INT32_MAX:
        raise ValueError("too many coefficients for D1")
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("j2k_pixels")
    plan = idwt_plan(tcs) if plan is None else plan
    table = _upload(plan.table, coeffs.device)
    out = torch.empty_like(coeffs)
    scratch = torch.empty_like(coeffs) if any(
        plan.levels[:, LV_DST] == SCRATCH) else out
    for launch in plan.launches:
        err = lib.j2k_idwt_launch(
            _ptr(coeffs), _ptr(out), _ptr(scratch), _ptr(table),
            launch.start, launch.ctas, _stream(coeffs))
        if err != 0:
            raise RuntimeError(f"j2k_pixels (D1) launch failed: CUDA error "
                               f"{err}")
        j2k_idwt.launches += 1
    return out


j2k_idwt.launches = 0


# ---------------------------------------------------------------- #
# M1: from planes to PIL's pixels
# ---------------------------------------------------------------- #
class ColourPlan(NamedTuple):
    """M1's parameters: the kind of Pillow's unpacking, PIL's mode, its
    palette (P / PA), per component precision, signedness and
    subsampling, and M1's path: ``common`` where every channel Pillow
    unpacks reads an unsubsampled component (channel c component c at the
    pixel's own place), else the general path of Pillow's unpacking."""
    kind: int
    mode_l: bool
    palette: np.ndarray     # (256, 3) uint8 (zeros where not P / PA)
    paletted: bool
    comps: np.ndarray       # (components, 4)
    common: bool


def colour_plan(f: J.J2kFile, frame: J2kFrame) -> ColourPlan:
    """Pillow's unpacking of the frame (``io/jp2.unpacker``), with the
    checks PIL's decoder makes of the image against its mode."""
    comps = frame.comps
    n = len(comps)
    subsampled = [i for i, (_, _, dx, dy) in enumerate(comps.tolist())
                  if dx != 1 or dy != 1]
    kind = J.unpacker(f, n, subsampled[0] if subsampled else -1)
    if (frame.width, frame.height) != tuple(f.size):
        raise ValueError(f"the JP2 header's size {f.size} differs from the "
                         f"codestream's ({frame.width}, {frame.height})")
    sizes = {(int(p) + 7) >> 3 for p in comps[:, 0]}
    if len(sizes) > 1:
        raise ValueError("components of different sample sizes are not "
                         "ported")
    palette = np.zeros((256, 3), np.uint8)
    paletted = f.mode in ("P", "PA")
    if paletted:
        rows = np.array(f.palette, np.uint8).reshape(-1, 3)[:256]
        # PIL's palette entries past those the file gives are black
        palette[:len(rows)] = rows
    for tx0, ty0, tx1, ty1, mct, first in frame.tiles.tolist():
        rows = frame.tcs[first:first + 3]
        if mct and (len(set(map(tuple, rows[:, [TC_W, TC_H, TC_REV]]
                                .tolist()))) != 1):
            raise ValueError("a component transform over components of "
                             "different sizes or transforms (OpenJPEG "
                             "fails)")
    if max(frame.x0 + frame.width, frame.y0 + frame.height) > _INT32_MAX:
        raise ValueError("an image grid past 2^31")
    # channel c reads component c at the pixel's place where the components
    # it and the component transform read are unsubsampled (their planes
    # then have the tile's size)
    reads = max(WANTED[KINDS[kind]], 3 if n >= 3 and frame.tiles[:, 4].any()
                else 0)
    sizes = np.stack([frame.tiles[:, 2] - frame.tiles[:, 0],
                      frame.tiles[:, 3] - frame.tiles[:, 1]], axis=1)
    common = bool((comps[:reads, 2:] == 1).all()) and all(
        (frame.tcs[frame.tiles[:, 5] + m][:, [TC_W, TC_H]] == sizes).all()
        for m in range(reads))
    return ColourPlan(KINDS[kind], f.mode == "L", palette, paletted, comps,
                      common)


def _tile_of(frame: J2kFrame, gx: torch.Tensor, gy: torch.Tensor):
    across = -(-(frame.x0 + frame.width - frame.tx0) // frame.tdx)
    return ((gy - frame.ty0) // frame.tdy) * across + (
        gx - frame.tx0) // frame.tdx


def words_reference(coeffs: torch.Tensor, frame: J2kFrame,
                    comps: np.ndarray) -> torch.Tensor:
    """Every sample of every tile-component after the inverse RCT or ICT
    (where its tile has one; OpenJPEG's ``opj_mct_decode`` and
    ``opj_mct_decode_real``), the DC level shift and the clamp to its
    precision (a 9/7 sample rounded half to even, as ``lrintf``), as the
    bytes OpenJPEG's tile data holds it: int64 (n,), by flat position."""
    dev = coeffs.device
    tcs = torch.from_numpy(frame.tcs).to(dev).long()
    tiles = torch.from_numpy(frame.tiles).to(dev).long()
    n = len(comps)
    sizes = tcs[:, TC_W] * tcs[:, TC_H]
    tc = torch.repeat_interleave(torch.arange(len(tcs), device=dev), sizes)
    local = torch.arange(len(tc), device=dev) - tcs[tc, TC_OFFSET]
    tile = tc // n
    m = tcs[tc, TC_COMP]
    rev = tcs[tc, TC_REV] == 1
    ints = coeffs.view(torch.int32)[:len(tc)].long()
    floats = coeffs.view(torch.float32)[:len(tc)]
    if n >= 3:
        first = tiles[tile, 5]
        at = [(tcs[first + k, TC_OFFSET] + local).clamp(max=len(tc) - 1)
              for k in range(3)]
        y, u, v = (ints[i] for i in at)
        g = y - ((u + v) >> 2)
        rct = torch.where(m == 0, v + g, torch.where(m == 1, g, u + g))
        f32 = torch.float32
        c = [torch.tensor(k, dtype=f32) for k in ICT]
        yf, uf, vf = (floats[i] for i in at)
        ict = torch.where(m == 0, yf + vf * c[0], torch.where(
            m == 1, (yf - uf * c[1]) - vf * c[2], yf + uf * c[3]))
        on = (tiles[tile, 4] == 1) & (m < 3)
        ints = torch.where(on, rct, ints)
        floats = torch.where(on, ict, floats)
    cm = torch.from_numpy(comps).to(dev).long()
    prec, sgnd = cm[m, 0], cm[m, 1]
    lo = torch.where(sgnd == 1, -(1 << (prec - 1)), torch.zeros_like(prec))
    hi = torch.where(sgnd == 1, (1 << (prec - 1)) - 1, (1 << prec) - 1)
    shift = torch.where(sgnd == 1, torch.zeros_like(prec), 1 << (prec - 1))
    rounded = torch.round(floats.double()).clamp(-2 ** 40, 2 ** 40).long()
    value = torch.where(rev, ints, rounded) + shift
    value = torch.minimum(torch.maximum(value, lo), hi)
    return value & ((1 << (8 * ((prec + 7) >> 3))) - 1)


def colour_reference(coeffs: torch.Tensor, frame: J2kFrame,
                     plan: ColourPlan, channels: int = 3) -> torch.Tensor:
    """The plain twin of M1: the synthesised planes -> uint8 (H, W, 3)
    RGB or (H, W) grey, as PIL's ``convert("RGB")`` and the JAX package's
    ``load_gray_image`` read the file."""
    dev = coeffs.device
    H, W = frame.height, frame.width
    words = words_reference(coeffs, frame, plan.comps)
    gy, gx = torch.meshgrid(torch.arange(H, device=dev) + frame.y0,
                            torch.arange(W, device=dev) + frame.x0,
                            indexing="ij")
    tiles = torch.from_numpy(frame.tiles).to(dev).long()
    tcs = torch.from_numpy(frame.tcs).to(dev).long()
    comps = torch.from_numpy(plan.comps).to(dev).long()
    t = _tile_of(frame, gx, gy)
    tx0, ty0, tx1, ty1, first = (tiles[t, i] for i in (0, 1, 2, 3, 5))
    x, y = gx - tx0, gy - ty0
    w, h = tx1 - tx0, ty1 - ty0
    n = len(plan.comps)
    # the tile's data: each tile-component's samples after the last's
    cum = [torch.zeros_like(t)]
    for m in range(n):
        cum.append(cum[-1] + tcs[first + m, TC_W] * tcs[first + m, TC_H])
    wanted = WANTED[plan.kind]
    bits = 16 if plan.kind == 1 else 8
    outs = []
    start = torch.zeros_like(t)
    for c in range(wanted):
        dx, dy = comps[c, 2], comps[c, 3]
        # Pillow's unpackers index the tile's data by rows of w // dx
        k = start + (y // dy) * (w // dx) + x // dx
        m = torch.zeros_like(k)
        for j in range(1, n):
            m = m + (k >= cum[j]).long()
        base = torch.stack(cum[:n])
        pos = torch.gather(tcs[:, TC_OFFSET][first[None] + torch.arange(
            n, device=dev)[:, None, None]], 0, m[None])[0]
        pos = pos + k - torch.gather(base, 0, m[None])[0]
        v = torch.where(k < cum[n], words[pos.clamp(0, len(words) - 1)],
                        torch.zeros_like(k))      # PIL's zeroed buffer
        prec, sgnd = comps[c, 0], comps[c, 1]
        sh = int(bits - prec)
        off = (1 << int(prec - 1)) if int(sgnd) else 0
        if sh < 0:
            off += 1 << (-sh - 1)
            word = (off + v) >> (-sh)
        else:
            word = (off + v) << sh
        outs.append(word & ((1 << bits) - 1))
        start = start + (h // dy) * (w // dx)
    if plan.kind == 0:
        g = outs[0]
        if plan.paletted:
            rgb = torch.from_numpy(plan.palette).to(dev).long()[g]
        else:
            rgb = torch.stack([g, g, g], dim=-1)
    elif plan.kind == 1:
        g = outs[0].clamp(max=255)
        rgb = torch.stack([g, g, g], dim=-1)
    elif plan.kind == 2:
        rgb = torch.stack(outs[:3], dim=-1)
    elif plan.kind == 3:
        yy, cb, cr = outs[:3]
        tab = torch.from_numpy(YCC).to(dev).long()
        rgb = torch.stack([yy + (tab[0, cr] >> 6),
                           yy + ((tab[1, cb] + tab[2, cr]) >> 6),
                           yy + (tab[3, cb] >> 6)], dim=-1).clamp(0, 255)
    else:
        nk = 255 - outs[3]
        tt = torch.stack(outs[:3], dim=-1) * nk[..., None] + 128
        rgb = nk[..., None] - (((tt >> 8) + tt) >> 8)
    if channels == 3:
        return rgb.to(torch.uint8)
    if plan.mode_l:
        return outs[0].to(torch.uint8)
    return ((rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868
             + 8192) >> 14).to(torch.uint8)


# M1's grid (``colour_launch``): a CTA a band of output rows of one tile,
# at most COLOUR_SPAN columns wide and about COLOUR_PIXELS pixels, at most
# COLOUR_MAX_ROWS rows (on an H100 the 768 x 1024 clip frames took 0.0106 /
# 0.0096 ms in RGB at 1,024 pixels a CTA, 0.0105 / 0.0116 at 512, 0.0102 /
# 0.0100 at 2,048, 0.0104 / 0.0107 at 3,072: 9/7 / 5/3)
COLOUR_PIXELS = 1024
COLOUR_SPAN = 4096
COLOUR_MAX_ROWS = 64
# M1's table: a header of 16 ints, the components (4 x 4), the palette,
# PIL's YCbCr tables, then the CTAs (COLOUR_CTA_COLS each: the tile, the
# first row, rows, first and end column, then the tile's row of
# COLOUR_TILE_COLS: origin, size, component transform, per component its
# plane's offset, samples and transform)
COLOUR_CTAS_AT = 16 + 16 + 3 * 256 + 4 * 256
COLOUR_TILE_COLS = 20
COLOUR_CTA_COLS = 5 + COLOUR_TILE_COLS


def colour_launch(frame: J2kFrame, plan: ColourPlan, channels: int):
    """M1's table and grid for one read: (table int32, CTAs, shared
    bytes)."""
    W, H = frame.width, frame.height
    n = len(plan.comps)
    if n > 4:
        raise ValueError("M1 takes at most four components")
    tiles = frame.tiles.astype(np.int64)
    if len(tiles) and 4 * int(((tiles[:, 2] - tiles[:, 0]) * (
            tiles[:, 3] - tiles[:, 1])).max()) > _INT32_MAX:
        raise ValueError("a tile too large for M1")
    rows = np.zeros((len(tiles), COLOUR_TILE_COLS), np.int64)
    rows[:, :2] = tiles[:, :2]
    rows[:, 2] = tiles[:, 2] - tiles[:, 0]
    rows[:, 3] = tiles[:, 3] - tiles[:, 1]
    rows[:, 4] = tiles[:, 4]
    for m in range(n):
        tc = frame.tcs[tiles[:, 5] + m]
        rows[:, 5 + m] = tc[:, TC_OFFSET]
        rows[:, 9 + m] = tc[:, TC_W].astype(np.int64) * tc[:, TC_H]
        rows[:, 13 + m] = tc[:, TC_REV]
    ctas, shared = [], 0
    for t, (tx0, ty0, tx1, ty1) in enumerate(tiles[:, :4].tolist()):
        xs, xe = max(tx0, frame.x0) - frame.x0, min(tx1, frame.x0 + W) - \
            frame.x0
        ys, ye = max(ty0, frame.y0) - frame.y0, min(ty1, frame.y0 + H) - \
            frame.y0
        for a in range(xs, xe, COLOUR_SPAN):
            b = min(a + COLOUR_SPAN, xe)
            band = max(1, min(COLOUR_MAX_ROWS, COLOUR_PIXELS // (b - a)))
            for y in range(ys, ye, band):
                ctas.append([t, y, min(band, ye - y), a, b])
            pitch = ((b - a) * channels + 30) & ~15
            shared = max(shared, min(band, ye - ys) * pitch)
    comps = np.zeros((4, 4), np.int32)
    comps[:n] = plan.comps
    cta_rows = np.array(ctas, np.int64).reshape(-1, 5)
    cta_rows = np.concatenate([cta_rows, rows[cta_rows[:, 0]]], axis=1)
    header = np.array([W, H, frame.x0, frame.y0, n, plan.kind,
                       int(plan.mode_l), int(plan.paletted),
                       WANTED[plan.kind], 16 if plan.kind == 1 else 8, 0, 0,
                       0, 0, 0, 0])
    table = np.concatenate([header, comps.reshape(-1),
                            plan.palette.astype(np.int64).reshape(-1),
                            YCC.reshape(-1), cta_rows.reshape(-1)])
    if len(table) > _INT32_MAX or np.abs(table).max() > _INT32_MAX:
        raise ValueError("a frame too large for M1")
    return table.astype(np.int32), len(ctas), shared


def j2k_colour(coeffs: torch.Tensor, frame: J2kFrame, plan: ColourPlan,
               channels: int = 3) -> torch.Tensor:
    """M1: D1's planes -> uint8 (H, W, 3) RGB or (H, W) grey on their
    device, in one launch of ``colour_launch``'s grid, by the plan's path;
    on the CPU the twin."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    if coeffs.device.type == "cpu":
        return colour_reference(coeffs, frame, plan, channels)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    H, W = frame.height, frame.width
    if H * W * channels > _INT32_MAX:
        raise ValueError(f"a {W} x {H} frame is too large")
    from superviseddescent_tpu_torch.ops._build import load_library
    dev = coeffs.device
    table, ctas, shared = colour_launch(frame, plan, channels)
    table = _upload(table, dev)
    out = torch.empty((H, W) + ((3,) if channels == 3 else ()),
                      dtype=torch.uint8, device=dev)
    err = load_library("j2k_pixels").j2k_colour_launch(
        _ptr(coeffs), _ptr(table), ctas, int(plan.common), channels, shared,
        _ptr(out), _stream(coeffs))
    if err != 0:
        raise RuntimeError(f"j2k_pixels (M1) launch failed: CUDA error "
                           f"{err}")
    j2k_colour.launches += 1
    j2k_colour.paths["common" if plan.common else "general"] += 1
    return out


j2k_colour.launches = 0
# launches by path (ColourPlan.common)
j2k_colour.paths = {"common": 0, "general": 0}


# ---------------------------------------------------------------- #
# reading
# ---------------------------------------------------------------- #
def read_j2k(data: bytes, channels: int = 3, device=None) -> torch.Tensor:
    """JPEG 2000 bytes (JP2 or a raw codestream) -> uint8 (H, W, 3) RGB or
    (H, W) grey as a tensor on ``device`` (the card unless the caller
    names one), as PIL reads the file: the host stage, then D1 and M1
    (their twins on the CPU)."""
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    f = J.read_file(data)
    frame = host_stage(f.codestream, dev)
    plan = colour_plan(f, frame)
    coeffs = j2k_idwt(frame.coeffs, frame.tcs)
    return j2k_colour(coeffs, frame, plan, channels)
