"""Kernels W1, W2 and W3: the pixel stage of lossy WebP (VP8) on the card.

``read_webp`` reads a WebP as PIL reads it. A lossless one decodes on the
host (``io/webp.py``). A lossy one (a ``VP8 `` bitstream, with or without
its ``ALPH`` chunk) has its entropy-coded data decoded on the host, and
its pixel stage runs where the caller asks:

* on the card, the host C++ decoder of ``csrc/webp_decode.cu``
  (``webp_decode_vp8``) writes the coefficients, modes and filter
  parameters into pinned memory, they go to the card, and three kernels of
  ``csrc/vp8_pixels.cu`` run there: W1 (``vp8_reconstruct``: prediction,
  the inverse WHT and DCT, into the unfiltered Y / U / V planes), W2
  (``vp8_filter``: the loop filter in place) and W3 (``vp8_colour``:
  libwebp's fancy upsampling and fixed-point RGB, or PIL's grey of it);
* on the CPU, the Python twin of the entropy stage (``io/vp8.py``) and the
  plain PyTorch twins of the three kernels here
  (``reconstruct_reference``, ``filter_reference``, ``colour_reference``).

A kernel's wrapper takes its twin only where its input lies on the CPU; on
the card a failed build or launch raises, and nothing falls back.

W1 and W2 run the macroblocks as libwebp does, in raster order, in a
wavefront: macroblock (r, c) after (r, c - 1) and (r - 1, c + 1), so the
twins take a diagonal ``c + 2 r`` at a time and the kernels a warp per
macroblock row, waiting on the row above (``csrc/vp8_pixels.cu``), on the
rows a CTA and CTAs ``vp8_launch_plan`` chooses. W3 has no chain: a CTA
takes a band of full-width output rows staged in shared memory, on the
bands ``vp8_colour_plan`` chooses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from superviseddescent_tpu_torch.io import vp8_tables as T
from superviseddescent_tpu_torch.utils.device import resolve_device

_INT32_MAX = 2 ** 31 - 1


# ---------------------------------------------------------------- #
# the plain twins
# ---------------------------------------------------------------- #
def _mode_weights() -> np.ndarray:
    """The 4x4 sub-block predictions other than TM as weights in eighths:
    pixel = (W[mode, pixel] . context + 4) >> 3 over the 13 context
    samples I, J, K, L (left, top down), X (top-left), A..H (top and
    top-right), as libwebp's ``DC4`` .. ``HU4`` (``src/dsp/dec.c``) form
    them from AVG3 (a + 2b + c + 2) >> 2, AVG2 (a + b + 1) >> 1 and
    copies, each exact in eighths."""
    I, J, K, L, X, A, B, C, D, E, F, G, H = range(13)
    w = np.zeros((10, 16, 13), np.int32)

    def put(mode, xy, *taps):
        for x, y in xy:
            v = w[mode, 4 * y + x]
            if len(taps) == 3:
                v[taps[0]] += 2
                v[taps[1]] += 4
                v[taps[2]] += 2
            elif len(taps) == 2:
                v[taps[0]] += 4
                v[taps[1]] += 4
            else:
                v[taps[0]] += 8

    for p in range(16):                                # DC4
        w[T.B_DC_PRED, p, [I, J, K, L, A, B, C, D]] = 1
    for x, taps in enumerate(((X, A, B), (A, B, C), (B, C, D), (C, D, E))):
        put(T.B_VE_PRED, [(x, y) for y in range(4)], *taps)
    for y, taps in enumerate(((X, I, J), (I, J, K), (J, K, L), (K, L, L))):
        put(T.B_HE_PRED, [(x, y) for x in range(4)], *taps)
    put(T.B_RD_PRED, [(0, 3)], J, K, L)
    put(T.B_RD_PRED, [(1, 3), (0, 2)], I, J, K)
    put(T.B_RD_PRED, [(2, 3), (1, 2), (0, 1)], X, I, J)
    put(T.B_RD_PRED, [(3, 3), (2, 2), (1, 1), (0, 0)], A, X, I)
    put(T.B_RD_PRED, [(3, 2), (2, 1), (1, 0)], B, A, X)
    put(T.B_RD_PRED, [(3, 1), (2, 0)], C, B, A)
    put(T.B_RD_PRED, [(3, 0)], D, C, B)
    put(T.B_LD_PRED, [(0, 0)], A, B, C)
    put(T.B_LD_PRED, [(1, 0), (0, 1)], B, C, D)
    put(T.B_LD_PRED, [(2, 0), (1, 1), (0, 2)], C, D, E)
    put(T.B_LD_PRED, [(3, 0), (2, 1), (1, 2), (0, 3)], D, E, F)
    put(T.B_LD_PRED, [(3, 1), (2, 2), (1, 3)], E, F, G)
    put(T.B_LD_PRED, [(3, 2), (2, 3)], F, G, H)
    put(T.B_LD_PRED, [(3, 3)], G, H, H)
    put(T.B_VR_PRED, [(0, 0), (1, 2)], X, A)
    put(T.B_VR_PRED, [(1, 0), (2, 2)], A, B)
    put(T.B_VR_PRED, [(2, 0), (3, 2)], B, C)
    put(T.B_VR_PRED, [(3, 0)], C, D)
    put(T.B_VR_PRED, [(0, 3)], K, J, I)
    put(T.B_VR_PRED, [(0, 2)], J, I, X)
    put(T.B_VR_PRED, [(0, 1), (1, 3)], I, X, A)
    put(T.B_VR_PRED, [(1, 1), (2, 3)], X, A, B)
    put(T.B_VR_PRED, [(2, 1), (3, 3)], A, B, C)
    put(T.B_VR_PRED, [(3, 1)], B, C, D)
    put(T.B_VL_PRED, [(0, 0)], A, B)
    put(T.B_VL_PRED, [(1, 0), (0, 2)], B, C)
    put(T.B_VL_PRED, [(2, 0), (1, 2)], C, D)
    put(T.B_VL_PRED, [(3, 0), (2, 2)], D, E)
    put(T.B_VL_PRED, [(0, 1)], A, B, C)
    put(T.B_VL_PRED, [(1, 1), (0, 3)], B, C, D)
    put(T.B_VL_PRED, [(2, 1), (1, 3)], C, D, E)
    put(T.B_VL_PRED, [(3, 1), (2, 3)], D, E, F)
    put(T.B_VL_PRED, [(3, 2)], E, F, G)
    put(T.B_VL_PRED, [(3, 3)], F, G, H)
    put(T.B_HD_PRED, [(0, 0), (2, 1)], I, X)
    put(T.B_HD_PRED, [(0, 1), (2, 2)], J, I)
    put(T.B_HD_PRED, [(0, 2), (2, 3)], K, J)
    put(T.B_HD_PRED, [(0, 3)], L, K)
    put(T.B_HD_PRED, [(3, 0)], A, B, C)
    put(T.B_HD_PRED, [(2, 0)], X, A, B)
    put(T.B_HD_PRED, [(1, 0), (3, 1)], I, X, A)
    put(T.B_HD_PRED, [(1, 1), (3, 2)], J, I, X)
    put(T.B_HD_PRED, [(1, 2), (3, 3)], K, J, I)
    put(T.B_HD_PRED, [(1, 3)], L, K, J)
    put(T.B_HU_PRED, [(0, 0)], I, J)
    put(T.B_HU_PRED, [(2, 0), (0, 1)], J, K)
    put(T.B_HU_PRED, [(2, 1), (0, 2)], K, L)
    put(T.B_HU_PRED, [(1, 0)], I, J, K)
    put(T.B_HU_PRED, [(3, 0), (1, 1)], J, K, L)
    put(T.B_HU_PRED, [(3, 1), (1, 2)], K, L, L)
    put(T.B_HU_PRED, [(3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)], L)
    return w


MODE_WEIGHTS = _mode_weights()
# the order reconstruct_reference predicts a B_PRED macroblock's 4x4 blocks
# in: raster, as libwebp. W1 runs them in their own wavefront, block (i, j)
# at step j + 2 i: each reads only blocks done before it (left, top,
# top-left, top-right), so the planes are the same
# (tests/test_torch_webp_plan.py runs the twin in that order too).
SUBBLOCK_ORDER = tuple(range(16))


def _int16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int16).to(torch.int32)


def inverse_wht(y2: torch.Tensor) -> torch.Tensor:
    """libwebp's ``TransformWHT``: (..., 16) Y2 -> (..., 16) DCs of the Y
    blocks (raster order), int32 holding int16 values."""
    x = y2.to(torch.int32).reshape(*y2.shape[:-1], 4, 4)
    a0, a1 = x[..., 0, :] + x[..., 3, :], x[..., 1, :] + x[..., 2, :]
    a2, a3 = x[..., 1, :] - x[..., 2, :], x[..., 0, :] - x[..., 3, :]
    t = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-2)
    dc = t[..., 0] + 3
    b0, b1 = dc + t[..., 3], t[..., 1] + t[..., 2]
    b2, b3 = t[..., 1] - t[..., 2], dc - t[..., 3]
    out = torch.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], dim=-1) >> 3
    return _int16(out.reshape(*y2.shape[:-1], 16))


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def inverse_dct(coeffs: torch.Tensor) -> torch.Tensor:
    """libwebp's ``TransformOne`` without the add: (..., 16) coefficients
    (raster) -> (..., 4, 4) residuals ``v >> 3``, int32."""
    x = coeffs.to(torch.int32).reshape(*coeffs.shape[:-1], 4, 4)
    # vertical pass: each column i of the input -> tmp row i
    a, b = x[..., 0, :] + x[..., 2, :], x[..., 0, :] - x[..., 2, :]
    c = _mul2(x[..., 1, :]) - _mul1(x[..., 3, :])
    d = _mul1(x[..., 1, :]) + _mul2(x[..., 3, :])
    t = torch.stack([a + d, b + c, b - c, a - d], dim=-1)   # [..., i, k]
    # horizontal pass: output row k from t[..., :, k]
    dc = t[..., 0, :] + 4
    a, b = dc + t[..., 2, :], dc - t[..., 2, :]
    c = _mul2(t[..., 1, :]) - _mul1(t[..., 3, :])
    d = _mul1(t[..., 1, :]) + _mul2(t[..., 3, :])
    out = torch.stack([a + d, b + c, b - c, a - d], dim=-1)  # [..., k, x]
    return out >> 3


def _wavefront(mb_w: int, mb_h: int):
    """The diagonals c + 2 r in order: (rows, cols) index tensors."""
    r = torch.arange(mb_h).repeat_interleave(mb_w)
    c = torch.arange(mb_w).repeat(mb_h)
    t = c + 2 * r
    order = torch.argsort(t * (mb_w * mb_h) + r * mb_w + c)
    t, r, c = t[order], r[order], c[order]
    counts = torch.bincount(t).tolist()
    return list(zip(torch.split(r, counts), torch.split(c, counts)))


def _pred_large(size, mode, top, left, corner, r, c):
    """A 16x16 luma or 8x8 chroma prediction (libwebp's ``DC16`` ..
    ``TM16`` and their chroma twins) for a batch: top (B, size), left (B,
    size), corner (B,), modes (B,), the macroblocks' rows and columns for
    DC's edge variants."""
    shift = 5 if size == 16 else 4
    dc_full = (top.sum(1) + left.sum(1) + size) >> shift
    dc_top = (top.sum(1) + size // 2) >> (shift - 1)
    dc_left = (left.sum(1) + size // 2) >> (shift - 1)
    dc = torch.where(r == 0, torch.where(c == 0, torch.full_like(dc_full,
                                                                 128),
                                         dc_left),
                     torch.where(c == 0, dc_top, dc_full)).to(torch.int32)
    B = top.shape[0]
    out = dc[:, None, None].expand(B, size, size)
    tm = (top[:, None, :] + left[:, :, None] - corner[:, None, None]).clamp(
        0, 255)
    out = torch.where((mode == T.TM_PRED)[:, None, None], tm, out)
    out = torch.where((mode == T.V_PRED)[:, None, None],
                      top[:, None, :].expand(B, size, size), out)
    out = torch.where((mode == T.H_PRED)[:, None, None],
                      left[:, :, None].expand(B, size, size), out)
    return out


def _blocks_to_plane(res: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n * n, 4, 4) residual blocks in raster order -> (B, 4n, 4n)."""
    B = res.shape[0]
    return res.reshape(B, n, n, 4, 4).permute(0, 1, 3, 2, 4).reshape(
        B, 4 * n, 4 * n)


def reconstruct_reference(coeffs: torch.Tensor, modes: torch.Tensor,
                          mb_w: int, mb_h: int):
    """W1's plain twin: (MBs, 25, 16) int16 coefficients and (MBs, 20)
    uint8 modes (``io/vp8.py``) -> the unfiltered uint8 planes Y (16
    mb_h, 16 mb_w), U and V (8 mb_h, 8 mb_w), predicted as libwebp
    predicts: from unfiltered samples, 127 above the frame, 129 left of
    it, a 4x4 block's top-right beyond the last column the sample above
    the macroblock's last column, and below the top row the macroblock's
    own top-right."""
    dev = coeffs.device
    co = coeffs.to(torch.int32).reshape(mb_h * mb_w, 25, 16)
    md = modes.to(torch.int64).reshape(mb_h * mb_w, 20)
    is4 = md[:, 0].bool()
    ycoef = co[:, 1:17].clone()
    ycoef[:, :, 0] = torch.where(is4[:, None], ycoef[:, :, 0],
                                 inverse_wht(co[:, 0]))
    yres = inverse_dct(ycoef)                       # (MBs, 16, 4, 4)
    uvres = inverse_dct(co[:, 17:25])               # (MBs, 8, 4, 4)
    W, H = 16 * mb_w, 16 * mb_h
    # the planes with their borders: row 0 above the frame (127, its
    # corner too), column 0 left of it (129); Y has 4 columns past the
    # right edge for the top-right samples
    Y = torch.full((H + 1, W + 5), 129, dtype=torch.int32, device=dev)
    Y[0] = 127
    UV = torch.full((2, H // 2 + 1, W // 2 + 1), 129, dtype=torch.int32,
                    device=dev)
    UV[:, 0] = 127
    weights = torch.from_numpy(MODE_WEIGHTS).to(dev)
    ar16 = torch.arange(16, device=dev)
    ar8 = torch.arange(8, device=dev)
    for rs, cs in _wavefront(mb_w, mb_h):
        rs, cs = rs.to(dev), cs.to(dev)
        i = rs * mb_w + cs
        B = len(i)
        y0, x0 = 16 * rs, 16 * cs               # the border's coordinates
        top = Y[y0[:, None], x0[:, None] + 1 + torch.arange(20, device=dev)]
        last = (cs == mb_w - 1) & (rs > 0)
        top[:, 16:] = torch.where(last[:, None], top[:, 15:16], top[:, 16:])
        left = Y[y0[:, None] + 1 + ar16, x0[:, None]]
        corner = Y[y0, x0]
        out = torch.empty((B, 16, 16), dtype=torch.int32, device=dev)
        big = ~is4[i]
        if bool(big.any()):
            k = big.nonzero()[:, 0]
            pred = _pred_large(16, md[i[k], 1], top[k, :16], left[k],
                               corner[k], rs[k], cs[k])
            res = _blocks_to_plane(yres[i[k]], 4)
            out[k] = (pred + res).clamp(0, 255)
        if bool(is4[i].any()):
            k = is4[i].nonzero()[:, 0]
            n4 = len(k)
            # the macroblock's work area: row 0 the samples above (and the
            # top-right), column 0 the left ones; the top-right repeated
            # on rows 4, 8 and 12 for the right column's blocks
            wb = torch.zeros((n4, 17, 21), dtype=torch.int32, device=dev)
            wb[:, 0, 0] = corner[k]
            wb[:, 0, 1:] = top[k]
            wb[:, 1:, 0] = left[k]
            wb[:, 4:13:4, 17:] = top[k, None, 16:]
            sub = md[i[k], 2:18]
            res = yres[i[k]]
            for n in SUBBLOCK_ORDER:
                by, bx = 4 * (n // 4), 4 * (n % 4)
                ctx = torch.cat([wb[:, by + 1:by + 5, bx],
                                 wb[:, by, bx:bx + 9]], dim=1)   # (n4, 13)
                m = sub[:, n]
                pred = ((weights[m] * ctx[:, None, :]).sum(-1).to(
                    torch.int32) + 4) >> 3
                tm = (ctx[:, None, 5:9] + ctx[:, 0:4, None]
                      - ctx[:, 4, None, None]).clamp(0, 255).reshape(n4, 16)
                pred = torch.where((m == T.B_TM_PRED)[:, None], tm, pred)
                wb[:, by + 1:by + 5, bx + 1:bx + 5] = (
                    pred.reshape(n4, 4, 4) + res[:, n]).clamp(0, 255)
            out[k] = wb[:, 1:, 1:17]
        Y[(y0[:, None, None] + 1 + ar16[:, None]),
          (x0[:, None, None] + 1 + ar16)] = out
        for p in range(2):
            P = UV[p]
            u0, v0 = 8 * rs, 8 * cs
            ctop = P[u0[:, None], v0[:, None] + 1 + ar8]
            cleft = P[u0[:, None] + 1 + ar8, v0[:, None]]
            pred = _pred_large(8, md[i, 18], ctop, cleft, P[u0, v0], rs, cs)
            res = _blocks_to_plane(uvres[i, 4 * p:4 * p + 4], 2)
            P[(u0[:, None, None] + 1 + ar8[:, None]),
              (v0[:, None, None] + 1 + ar8)] = (pred + res).clamp(0, 255)
    return (Y[1:, 1:W + 1].to(torch.uint8).contiguous(),
            UV[0, 1:, 1:].to(torch.uint8).contiguous(),
            UV[1, 1:, 1:].to(torch.uint8).contiguous())


def _filter_lines(buf, idx, thresh, ilevel, hev_t, kind):
    """Filter lines across an edge in ``buf`` (flat int32), in place:
    ``idx`` (N, 8) the flat indices of p3 p2 p1 p0 q0 q1 q2 q3, the
    per-line edge limit, interior limit and hev threshold. ``kind``: 6 (a
    macroblock edge, libwebp's ``FilterLoop26``), 4 (an inner edge,
    ``FilterLoop24``) or 2 (the simple filter)."""
    v = buf[idx]
    p3, p2, p1, p0, q0, q1, q2, q3 = v.unbind(1)
    thresh2 = 2 * thresh + 1
    needs = (4 * (p0 - q0).abs() + (p1 - q1).abs()) <= thresh2
    if kind != 2:
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1),
                     (q1, q0)):
            needs &= (a - b).abs() <= ilevel
        hev = ((p1 - p0).abs() > hev_t) | ((q1 - q0).abs() > hev_t)
    else:
        hev = torch.ones_like(needs)

    def sclip1(x):
        return x.clamp(-128, 127)

    def sclip2(x):
        return x.clamp(-16, 15)

    def clip1(x):
        return x.clamp(0, 255)
    # DoFilter2
    a = 3 * (q0 - p0) + sclip1(p1 - q1)
    f1, f2 = sclip2((a + 4) >> 3), sclip2((a + 3) >> 3)
    new = [p3, p2, p1, clip1(p0 + f2), clip1(q0 - f1), q1, q2, q3]
    if kind == 4:                                     # DoFilter4
        a = 3 * (q0 - p0)
        a1, a2 = sclip2((a + 4) >> 3), sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        other = [p3, p2, clip1(p1 + a3), clip1(p0 + a2), clip1(q0 - a1),
                 clip1(q1 - a3), q2, q3]
    elif kind == 6:                                   # DoFilter6
        a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1))
        a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
        other = [p3, clip1(p2 + a3), clip1(p1 + a2), clip1(p0 + a1),
                 clip1(q0 - a1), clip1(q1 - a2), clip1(q2 - a3), q3]
    else:
        other = new
    out = torch.where(hev[:, None], torch.stack(new, 1),
                      torch.stack(other, 1))
    buf[idx] = torch.where(needs[:, None], out, v)


def filter_reference(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     filters: torch.Tensor, filter_type: int, mb_w: int,
                     mb_h: int):
    """W2's plain twin: the loop filter of libwebp's ``DoFilter`` on
    copies of W1's planes, macroblock by macroblock in raster order (a
    diagonal of the wavefront at a time): the left macroblock edge, the
    inner vertical edges, the top macroblock edge, the inner horizontal
    edges; ``filter_type`` 1 the simple filter (luma only), 2 the normal
    one. ``filters``: (MBs, 4) uint8 limit, interior limit, hev threshold,
    inner. Returns the filtered (Y, U, V)."""
    if filter_type == 0:
        return y.clone(), u.clone(), v.clone()
    dev = y.device
    W, Wc = 16 * mb_w, 8 * mb_w
    ny, nc = y.numel(), u.numel()
    buf = torch.cat([y.reshape(-1), u.reshape(-1), v.reshape(-1)]).to(
        torch.int32)
    fl = filters.to(torch.int32).reshape(mb_h * mb_w, 4)
    taps = torch.arange(-4, 4, device=dev)
    ar16, ar8 = torch.arange(16, device=dev), torch.arange(8, device=dev)
    for rs, cs in _wavefront(mb_w, mb_h):
        rs, cs = rs.to(dev), cs.to(dev)
        f = fl[rs * mb_w + cs]
        on = f[:, 0] > 0
        rs, cs, f = rs[on], cs[on], f[on]
        if len(rs) == 0:
            continue
        inner = f[:, 3] > 0

        def lines(sel, off, vertical_edge, edge):
            """(lines, 8) indices across an edge at ``edge`` samples into
            the macroblocks ``sel`` (luma: off None; chroma: U or V)."""
            r, c = rs[sel], cs[sel]
            size = 16 if off is None else 8
            stride = W if off is None else Wc
            base = 0 if off is None else off
            ar = ar16 if size == 16 else ar8
            if vertical_edge:            # across columns: a line a row
                rows = size * r[:, None] + ar
                cols = size * c[:, None] + edge
                start = base + rows * stride + cols
                idx = start[..., None] + taps
            else:                        # across rows: a line a column
                rows = size * r[:, None] + edge
                cols = size * c[:, None] + ar
                start = base + rows * stride + cols
                idx = start[..., None] + taps * stride
            n = idx.shape[1]
            return (idx.reshape(-1, 8), f[sel, 0].repeat_interleave(n),
                    f[sel, 1].repeat_interleave(n),
                    f[sel, 2].repeat_interleave(n))

        def run(parts, kind, extra):
            parts = [p for p in parts if p[0].numel()]
            if not parts:
                return
            idx, lim, il, hv = (torch.cat(x) for x in zip(*parts))
            _filter_lines(buf, idx, lim + extra, il, hv, kind)

        planes = (None,) if filter_type == 1 else (None, ny, ny + nc)
        mb_kind, in_kind = (2, 2) if filter_type == 1 else (6, 4)
        for vertical in (True, False):
            edge_sel = (cs > 0) if vertical else (rs > 0)
            run([lines(edge_sel, p, vertical, 0) for p in planes], mb_kind,
                T.MB_EDGE_EXTRA)
            for k, e in enumerate((4, 8, 12)):
                run([lines(inner, p, vertical, e) for p in planes
                     if p is None or k == 0], in_kind, 0)
    return (buf[:ny].reshape(y.shape).to(torch.uint8),
            buf[ny:ny + nc].reshape(u.shape).to(torch.uint8),
            buf[ny + nc:].reshape(v.shape).to(torch.uint8))


def _clip8(v):
    """libwebp's ``VP8Clip8`` of a 6-bit fixed-point value."""
    return torch.where((v & ~16383) == 0, v >> 6,
                       torch.where(v < 0, 0, 255))


def yuv_to_rgb(y, u, v) -> torch.Tensor:
    """libwebp's ``VP8YUVToR/G/B`` (``src/dsp/yuv.h``): int32 tensors ->
    (..., 3) int32."""
    yy = (y * 19077) >> 8
    r = _clip8(yy + ((v * 26149) >> 8) - 14234)
    g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
    b = _clip8(yy + ((u * 33050) >> 8) - 17685)
    return torch.stack([r, g, b], dim=-1)


def colour_reference(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                     width: int, height: int, channels: int = 3):
    """W3's plain twin: the filtered planes -> uint8 (H, W, 3) RGB or (H,
    W) grey (OpenCV's formula on that RGB, as the JAX package's
    ``load_gray_image``), through libwebp's fancy upsampler
    (``UpsampleRgbLinePair``): each output sample's chroma from its nearest
    chroma sample and the next one away in each direction, as ((nn + 3 nf
    + 3 fn + ff + 8) >> 3 + nn) >> 1; the first column, and the last of an
    even width, from the two rows only, (3 nn + fn + 2) >> 2; rows and
    columns past the edge repeat the last."""
    dev = y.device
    uw, uh = (width + 1) // 2, (height + 1) // 2
    Y = y[:height, :width].to(torch.int32)
    ys, xs = torch.arange(height, device=dev), torch.arange(width, device=dev)
    nr, nc = ys >> 1, xs >> 1
    fr = torch.where(ys % 2 == 1, nr + 1, nr - 1).clamp(0, uh - 1)
    fc = torch.where(xs % 2 == 1, nc + 1, nc - 1).clamp(0, uw - 1)
    edge = (xs == 0) | ((xs == width - 1) & (width % 2 == 0))

    def up(C):
        C = C[:uh, :uw].to(torch.int32)
        nn, nf = C[nr][:, nc], C[nr][:, fc]
        fn, ff = C[fr][:, nc], C[fr][:, fc]
        inner = (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1
        return torch.where(edge[None, :], (3 * nn + fn + 2) >> 2, inner)
    rgb = yuv_to_rgb(Y, up(u), up(v))
    if channels == 1:
        return ((rgb[..., 0] * 4899 + rgb[..., 1] * 9617 + rgb[..., 2] * 1868
                 + 8192) >> 14).to(torch.uint8)
    return rgb.to(torch.uint8)


# ---------------------------------------------------------------- #
# the kernels' launch plan
# ---------------------------------------------------------------- #
# W1 and W2 put a macroblock row on a warp (W1: on a pair of warps, one
# making the residuals, one predicting). Row r runs on CTA (r / rows) %
# ctas as its row r % rows, which takes rows r, r + rows ctas, ...; so
# ``rows * ctas`` rows are in flight. Rows of one CTA hand off inside the
# SM, rows of two CTAs through global memory (one row in ``rows``).
MAX_ROWS = 16             # csrc/vp8_pixels.cu's kMaxRows: W1's 1,024 threads
# rows a CTA, W1's and W2's (chip_smoke.py --webp --sweep): a step is one
# warp's chain of dependent instructions, so few warps to an SM keep it
# short; rows on other CTAs hand off through L2 instead
ROWS_PER_CTA = 4
SMS = 132                 # an H100 SXM's SMs: the plan's default cap


class Vp8Plan(NamedTuple):
    """W1's and W2's launch: ``rows`` macroblock rows a CTA, ``ctas``
    CTAs."""
    rows: int
    ctas: int

    @property
    def rows_in_flight(self) -> int:
        return self.rows * self.ctas


def vp8_launch_plan(mb_w: int, mb_h: int, rows: int = 0,
                    sms: int = SMS) -> Vp8Plan:
    """W1's and W2's plan for a frame of ``mb_w`` x ``mb_h`` macroblocks:
    every row in flight, on CTAs of ROWS_PER_CTA rows, more where the
    card's ``sms`` run out. ``mb_w / 2`` rows in flight already keep the
    wavefront's critical path at ``mb_w + 2 (mb_h - 1)`` steps, but a warp
    then takes several rows one after another, and on the card a step of
    the path takes about as long as a macroblock of a row, so more rows cut
    the time (chip_smoke.py --webp --sweep). ``rows`` > 0: at most that
    many rows in flight, so that a warp takes several rows (a longer path,
    the same planes)."""
    cap = min(MAX_ROWS, ROWS_PER_CTA)
    want = mb_h
    if rows > 0:
        want = min(want, rows)
    ctas = min(-(-want // cap), max(1, sms))
    per_cta = min(MAX_ROWS, -(-want // ctas))
    if rows > 0 and per_cta * ctas > rows:
        per_cta = max(1, rows // ctas)
    return Vp8Plan(per_cta, ctas)


# W3 puts a band of ``rows`` full-width output rows (even: output rows 2k
# - 1 and 2k read the same two chroma rows) on a CTA, its Y rows, the
# chroma rows they read and its output bytes in shared memory
# (csrc/vp8_pixels.cu's ColourLayout)
SMEM_OPTIN = 232448       # sm_90: the shared memory a CTA may opt in to
# bands for each SM the plan aims at (chip_smoke.py --webp --sweep: on the
# 768 x 1024 frame 4 rows a band, two CTAs an SM, beat 8 and 2 by ~5-10%)
COLOUR_BANDS_PER_SM = 2


class ColourPlan(NamedTuple):
    """W3's launch: a CTA a band of ``rows`` output rows, ``ctas``
    CTAs."""
    rows: int
    ctas: int


def _round16(n: int) -> int:
    return (n + 15) & ~15


def colour_smem(rows: int, width: int, channels: int = 3) -> int:
    """W3's shared memory for a band of ``rows`` rows of a frame
    ``width`` wide: the Y rows, the rows / 2 + 2 rows of U and of V they
    read, and the band's output bytes after up to 15 bytes that align them
    as their device address is aligned, each part in rows of 16-byte
    multiples."""
    return (rows * _round16(width)
            + 2 * (rows // 2 + 2) * _round16((width + 1) // 2)
            + _round16(rows * width * channels + 15))


def vp8_colour_plan(width: int, height: int, sms: int = SMS, rows: int = 0,
                    channels: int = 3) -> ColourPlan:
    """W3's bands for a ``width`` x ``height`` frame: the fewest even rows
    a band that make at most COLOUR_BANDS_PER_SM bands an SM of ``sms``
    (768 x 1024 on 132 SMs: 4 rows, 256 CTAs), fewer where a band would
    not fit SMEM_OPTIN (2 rows at 16,383 px wide), never under 2. ``rows``
    > 0 forces that many rows a band (even; the launcher refuses a band
    that does not fit)."""
    if rows:
        if rows < 2 or rows % 2:
            raise ValueError(f"W3's bands take an even number of rows, "
                             f"got {rows}")
    else:
        bands = max(1, COLOUR_BANDS_PER_SM * sms)
        rows = 2 * -(-height // (2 * bands))
        while rows > 2 and colour_smem(rows, width, channels) > SMEM_OPTIN:
            rows -= 2
    return ColourPlan(rows, -(-height // rows))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------- #
def _stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _check_frame(mb_w: int, mb_h: int):
    if not (0 < mb_w and 0 < mb_h and mb_w * mb_h * 400 <= _INT32_MAX):
        raise ValueError(f"a VP8 frame of {mb_w} x {mb_h} macroblocks is "
                         "out of the kernels' range")


def _planes(mb_w, mb_h, device):
    return (torch.empty((16 * mb_h, 16 * mb_w), dtype=torch.uint8,
                        device=device),
            torch.empty((8 * mb_h, 8 * mb_w), dtype=torch.uint8,
                        device=device),
            torch.empty((8 * mb_h, 8 * mb_w), dtype=torch.uint8,
                        device=device))


def vp8_reconstruct(coeffs: torch.Tensor, modes: torch.Tensor, mb_w: int,
                    mb_h: int, grid: int = 0):
    """W1: (MBs, 25, 16) int16 coefficients and (MBs, 20) uint8 modes ->
    the unfiltered (Y, U, V) planes on their device. A CUDA tensor
    launches the kernel; a CPU tensor takes the plain twin. ``grid``: at
    most that many macroblock rows in flight (0: ``vp8_launch_plan``'s),
    so that a warp takes several rows."""
    _check_frame(mb_w, mb_h)
    if coeffs.device.type == "cpu":
        return reconstruct_reference(coeffs, modes, mb_w, mb_h)
    if coeffs.device.type != "cuda":
        raise ValueError(f"unsupported device {coeffs.device}")
    n = mb_w * mb_h
    if (coeffs.dtype != torch.int16 or tuple(coeffs.shape) != (n, 25, 16)
            or modes.dtype != torch.uint8 or tuple(modes.shape) != (n, 20)
            or not coeffs.is_contiguous() or not modes.is_contiguous()
            or modes.device != coeffs.device):
        raise ValueError(f"W1 takes contiguous int16 ({n}, 25, 16) and "
                         f"uint8 ({n}, 20) on one device")
    from superviseddescent_tpu_torch.ops._build import load_library
    plan = vp8_launch_plan(mb_w, mb_h, grid, _sm_count(coeffs.device))
    y, u, v = _planes(mb_w, mb_h, coeffs.device)
    progress = torch.zeros(mb_h, dtype=torch.int32, device=coeffs.device)
    err = load_library("vp8_pixels").vp8_reconstruct_launch(
        _ptr(coeffs), _ptr(modes), _ptr(y), _ptr(u), _ptr(v), _ptr(progress),
        mb_w, mb_h, plan.rows, plan.ctas, _stream(coeffs))
    if err != 0:
        raise RuntimeError(f"vp8_pixels (W1) launch failed: CUDA error {err}")
    vp8_reconstruct.launches += 1
    return y, u, v


vp8_reconstruct.launches = 0


def vp8_filter(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               filters: torch.Tensor, filter_type: int, mb_w: int, mb_h: int,
               grid: int = 0):
    """W2: the loop filter of W1's planes, (MBs, 4) uint8 filter bytes;
    ``filter_type`` 0 (none: no launch), 1 (simple) or 2 (normal). On the
    card in place (returns the same planes); on the CPU the twin's
    filtered copies. ``grid`` as W1's."""
    _check_frame(mb_w, mb_h)
    if y.device.type == "cpu":
        return filter_reference(y, u, v, filters, filter_type, mb_w, mb_h)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    if filter_type not in (0, 1, 2):
        raise ValueError(f"filter type {filter_type}")
    n = mb_w * mb_h
    for p, s in ((y, 16), (u, 8), (v, 8)):
        if (p.dtype != torch.uint8 or tuple(p.shape) != (s * mb_h, s * mb_w)
                or not p.is_contiguous() or p.device != y.device):
            raise ValueError("W2 takes W1's contiguous uint8 planes")
    if (filters.dtype != torch.uint8 or tuple(filters.shape) != (n, 4)
            or not filters.is_contiguous() or filters.device != y.device):
        raise ValueError(f"W2 takes contiguous uint8 ({n}, 4) filter bytes")
    if filter_type == 0:
        return y, u, v
    from superviseddescent_tpu_torch.ops._build import load_library
    plan = vp8_launch_plan(mb_w, mb_h, grid, _sm_count(y.device))
    progress = torch.zeros(mb_h, dtype=torch.int32, device=y.device)
    err = load_library("vp8_pixels").vp8_filter_launch(
        _ptr(y), _ptr(u), _ptr(v), _ptr(filters), _ptr(progress), mb_w, mb_h,
        filter_type, plan.rows, plan.ctas, _stream(y))
    if err != 0:
        raise RuntimeError(f"vp8_pixels (W2) launch failed: CUDA error {err}")
    vp8_filter.launches += 1
    return y, u, v


vp8_filter.launches = 0


def vp8_colour(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               width: int, height: int, channels: int = 3,
               rows: int = 0) -> torch.Tensor:
    """W3: the filtered planes -> uint8 (H, W, 3) RGB or (H, W) grey on
    their device, as PIL's ``convert("RGB")`` and the JAX package's
    ``load_gray_image`` read the frame. ``rows``: that many output rows a
    CTA (even; 0: ``vp8_colour_plan``'s)."""
    if channels not in (1, 3):
        raise ValueError(f"channels must be 1 or 3, got {channels}")
    mb_w, mb_h = y.shape[1] // 16, y.shape[0] // 16
    if not (0 < width <= 16 * mb_w and 0 < height <= 16 * mb_h):
        raise ValueError(f"a {width} x {height} frame in planes of "
                         f"{tuple(y.shape)}")
    if y.device.type == "cpu":
        return colour_reference(y, u, v, width, height, channels)
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    for p, s in ((y, 16), (u, 8), (v, 8)):
        if (p.dtype != torch.uint8 or tuple(p.shape) != (s * mb_h, s * mb_w)
                or not p.is_contiguous() or p.device != y.device):
            raise ValueError("W3 takes W2's contiguous uint8 planes")
    if width * height * channels > _INT32_MAX:
        raise ValueError(f"a {width} x {height} frame is too large")
    from superviseddescent_tpu_torch.ops._build import load_library
    plan = vp8_colour_plan(width, height, _sm_count(y.device), rows,
                           channels)
    out = torch.empty((height, width) + ((3,) if channels == 3 else ()),
                      dtype=torch.uint8, device=y.device)
    err = load_library("vp8_pixels").vp8_colour_launch(
        _ptr(y), _ptr(u), _ptr(v), _ptr(out), width, height, mb_w, channels,
        plan.rows, _stream(y))
    if err != 0:
        raise RuntimeError(f"vp8_pixels (W3) launch failed: CUDA error {err}")
    vp8_colour.launches += 1
    return out


vp8_colour.launches = 0


# ---------------------------------------------------------------- #
# reading
# ---------------------------------------------------------------- #
def vp8_frame(payload: bytes, device):
    """A ``VP8 `` payload's entropy stage for ``device``: the Python twin
    on the CPU, the host C++ decoder (into pinned memory, then to the card)
    on the card. Returns (Vp8Frame, coeffs, modes, filters) with the
    tensors on ``device``."""
    from superviseddescent_tpu_torch.io.vp8 import (
        decode_vp8, decode_vp8_native)
    if device.type == "cpu":
        f = decode_vp8(payload)
        return (f, torch.from_numpy(f.coeffs), torch.from_numpy(f.modes),
                torch.from_numpy(f.filters))
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    f = decode_vp8_native(payload, pinned=True)
    return (f, f.coeffs.to(device, non_blocking=True),
            f.modes.to(device, non_blocking=True),
            f.filters.to(device, non_blocking=True))


def decode_vp8_pixels(payload: bytes, channels: int = 3,
                      device=None) -> torch.Tensor:
    """A ``VP8 `` payload -> uint8 (H, W, 3) RGB or (H, W) grey on
    ``device`` (the card unless the caller names one): the entropy stage
    on the host, then W1, W2 and W3 (the twins on the CPU)."""
    dev = resolve_device(device)
    f, coeffs, modes, filters = vp8_frame(payload, dev)
    y, u, v = vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h)
    y, u, v = vp8_filter(y, u, v, filters, f.filter_type, f.mb_w, f.mb_h)
    return vp8_colour(y, u, v, f.width, f.height, channels)


def read_webp(data: bytes, channels: int = 3, device=None):
    """WebP bytes -> uint8 (H, W, 3) RGB or (H, W) grey, as PIL reads the
    file (``io/webp.compose``): a lossy frame as a tensor on ``device``
    (its pixel stage W1-W3 there), a lossless one as a host array (the
    C++ decoder where ``device`` is the card, the twin on the CPU); an
    animation's first frame on its canvas as a host array."""
    from superviseddescent_tpu_torch.io import webp
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    lossless = (webp.decode_vp8l if dev.type == "cpu"
                else webp.decode_vp8l_native)

    def lossy(payload):
        return decode_vp8_pixels(payload, channels, dev)
    px = webp.compose(data, lossless, lossy)
    if isinstance(px, torch.Tensor):
        return px
    if channels == 1:
        from superviseddescent_tpu_torch.ops.patches import rgb_to_gray_u8
        return rgb_to_gray_u8(px)
    return px
