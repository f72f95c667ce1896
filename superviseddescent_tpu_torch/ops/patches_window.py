"""K2: window patch sampler, a hand-written CUDA kernel.

Replaces the TPU kernel ``superviseddescent_tpu/ops/patches_pallas.py::
sample_patches_window`` (``_sampler_kernel``), with its contract: for every
face n and landmark l, the IED-adaptive square crop around the rounded
centre, zero-padded and resized to S x S, sampled from an aligned
sub-window of the face's ROI window (W rows at an 8-aligned origin, WX
columns at a 128-aligned origin) on the cv::resize source grid clamped to
the crop. A bilinear tap whose row or column lies outside the sub-window
contributes 0, exactly as the TPU kernel's tent products over the
sub-window do. Options: 11-bit tent quantisation and uint8 rounding
(``quantize``; the 11-bit grid only in exact mode), bfloat16 arithmetic
(``sampling="fast"``: bf16 tents, and the partial product rounded to bf16
between the two passes), and transposed output (patch[x, y], the x pass
first).

The sub-window alignment (8 rows, 128 columns) is part of the contract:
it decides which taps are truncated when a patch outgrows its sub-window,
so the port keeps it even though the H100 needs no such alignment.

The kernel (``csrc/patches_window.cu``) runs G (face, landmark) patches
per block (``launch_plan``). Only two taps per axis are non-zero, so it
evaluates the bilinear sum over those taps directly instead of the TPU's
dense tent products; it reads uint8, bfloat16 or float32 windows as they are
(no float copy of the window stack). What bounds it on the H100: memory. At
the RCR-22 level-0 shape it writes 90,112 x 55 x 55 float32 pixels (1.09 GB,
~0.33 ms at 3.35 TB/s) and reads only the few KB of window under each
patch. An earlier design (one block per patch) took ~3.5x that: a measurement
build that stores nothing ran as long as the kernel, so the time went to the
per-patch tap prologue and to window reads one output at a time. So the
block computes the taps of G patches at once, each thread computes one
16-byte word of output (4 float32 or 8 bfloat16 values, their 4 x 4 or 4 x 8
window reads in flight together), neighbouring threads take neighbouring
columns (coalesced window reads), and the words go out as 16-byte stores on
16-byte boundaries of the whole output. A transposed patch is computed in
strips of 4 or 8 rows of one column, each a 16-byte word of a
shared-memory tile in (x, y) order, which then goes out the same way.

Compiled with -fmad=false so every float operation rounds as PyTorch's
separate elementwise operations do: the kernel equals its plain twin
``sample_patches_window_reference`` bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

SUBLANE_ALIGN = 8
LANE_ALIGN = 128
_FIT_MARGIN = 2  # bilinear tent support around the outermost sample

_MAX_SIZE = 96  # the kernel's largest output side
_DTYPE_CODES = {torch.uint8: 0, torch.bfloat16: 1, torch.float32: 2}
# patches per block: the launch plan's choice, and the shared memory a
# block of transposed output may take (its tile dominates); chosen by a
# sweep on the H100 over 1-16 patches at the four level shapes (PERF.md
# section 6)
_PER_BLOCK = 8
_PLAN_SHARED = 36 * 1024


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _tile_pitch(size: int, values_per_word: int) -> int:
    """Values per column of the transposed tile (csrc/patches_window.cu's
    tile_pitch): an odd number of 16-byte words."""
    words = -(-size // values_per_word)
    return (words + 1 - words % 2) * values_per_word


def _shared_bytes(size: int, per_block: int, transposed: bool,
                  out_itemsize: int) -> int:
    """Dynamic shared memory of one K2 block: csrc/patches_window.cu's
    Layout (six tap tables, the sub-window offsets, the transposed tile)."""
    tables = 6 * _align16(per_block * size * 4) + _align16(per_block * 8)
    tile = (per_block * size * _tile_pitch(size, 16 // out_itemsize)
            * out_itemsize if transposed else 0)
    return tables + _align16(tile)


@functools.lru_cache(maxsize=None)
def launch_plan(n_patches: int, size: int, transposed: bool,
                out_itemsize: int) -> int:
    """Patches per K2 block for N*L patches of side S: _PER_BLOCK, fewer
    when a block of transposed output would take more than _PLAN_SHARED
    bytes of shared memory, never more than the patches there are, at
    least 1."""
    g = max(1, min(_PER_BLOCK, n_patches))
    while transposed and g > 1 and _shared_bytes(
            size, g, transposed, out_itemsize) > _PLAN_SHARED:
        g -= 1
    return g


def max_patch_half(sub_window: int, align: int = SUBLANE_ALIGN) -> float:
    """Largest patch_half whose patch a W-row (or, with align=LANE_ALIGN,
    W-column) sub-window covers after its origin floors to ``align``."""
    return (sub_window - align - _FIT_MARGIN) / 2.0


def min_sub_window(max_extent: float, align: int = SUBLANE_ALIGN) -> int:
    """Smallest sub-window side (a multiple of ``align``) that covers a
    patch extent of ``max_extent`` pixels (extent = 2*patch_half)."""
    need = int(-(-max_extent // 1)) + align + _FIT_MARGIN
    return -(-need // align) * align


def max_patch_half_x(sub_window_x: int) -> float:
    """Column counterpart of max_patch_half (128-aligned origins)."""
    return max_patch_half(sub_window_x, LANE_ALIGN)


def min_sub_window_x(max_extent: float) -> int:
    """Column counterpart of min_sub_window (a multiple of 128)."""
    return min_sub_window(max_extent, LANE_ALIGN)


def _taps(start, src, origin, span, quantize, fast):
    """Bilinear taps along one axis.

    start: (N, L) crop origin in window space; src: (N, S) crop-space
    source grid; origin: (N, L) sub-window origin. Returns (i0, t0, t1):
    (N, L, S) first tap index within the sub-window and the two tap
    weights, zeroed where the tap lies outside [0, span).
    """
    coord = (start[:, :, None] + src[:, None, :]) - origin[:, :, None]
    u0 = torch.floor(coord)
    t0 = torch.clamp(1.0 - torch.abs(coord - u0), min=0.0)
    t1 = torch.clamp(1.0 - torch.abs(coord - (u0 + 1.0)), min=0.0)
    if quantize and not fast:
        t0 = torch.round(t0 * 2048.0) * (1.0 / 2048.0)
        t1 = torch.round(t1 * 2048.0) * (1.0 / 2048.0)
    if fast:
        t0 = t0.bfloat16().float()
        t1 = t1.bfloat16().float()
    zero = torch.zeros((), device=coord.device)
    t0 = torch.where((u0 >= 0) & (u0 < span), t0, zero)
    t1 = torch.where((u0 + 1 >= 0) & (u0 + 1 < span), t1, zero)
    return u0.long(), t0, t1


def _prepare(centers_x, centers_y, patch_half, out_size):
    """Crop origins and resize steps shared by the kernel and its twin."""
    cx = torch.round(centers_x)
    cy = torch.round(centers_y)
    oxy = torch.cat([cy - patch_half[:, None], cx - patch_half[:, None]],
                    dim=1).float().contiguous()                # (N, 2L)
    # a tensor divisor: on CUDA, PyTorch multiplies by the reciprocal of a
    # Python-scalar divisor, which differs from the true quotient (the CPU's,
    # JAX's and the fused kernel's) in the last bit
    step = 2.0 * patch_half / torch.full_like(patch_half, float(out_size))
    sp = torch.stack([step, patch_half], dim=1).float().contiguous()  # (N, 2)
    return oxy, sp


def _tap_plan(ry, rx, oxy, sp, s, w, wx, quantize, fast):
    """Sub-window origins and bilinear taps of every (face, landmark).

    Returns (oy, ox, (v0, ty0, ty1), (u0, tx0, tx1)): (N, L) sub-window
    origins in window space, then the row and column taps of ``_taps``.
    """
    l = oxy.shape[1] // 2
    dev = oxy.device
    by, bx = oxy[:, :l], oxy[:, l:]                            # (N, L)
    st, ph = sp[:, 0:1], sp[:, 1:2]                            # (N, 1)
    j = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    src = torch.minimum(torch.clamp((j + 0.5) * st - 0.5, min=0.0),
                        2.0 * ph - 1.0)                        # (N, S)
    src0 = src[:, 0:1]
    oy = torch.clamp(torch.floor(by + src0), 0.0, float(ry - w))
    oy = torch.div(oy.long(), SUBLANE_ALIGN,
                   rounding_mode="floor") * SUBLANE_ALIGN      # (N, L)
    if wx == rx:
        ox = torch.zeros_like(oy)
    else:
        ox = torch.clamp(torch.floor(bx + src0), 0.0, float(rx - wx))
        ox = torch.div(ox.long(), LANE_ALIGN,
                       rounding_mode="floor") * LANE_ALIGN
    ytaps = _taps(by, src, oy.float(), w, quantize, fast)
    xtaps = _taps(bx, src, ox.float(), wx, quantize, fast)
    return oy, ox, ytaps, xtaps


def sample_patches_window_reference(windows, oxy, sp, out_size, w, wx,
                                    quantize, sampling, transposed,
                                    out_dtype):
    """Plain PyTorch twin of the K2 kernel on any device, from the crop
    origins ``oxy`` and steps ``sp`` that the wrapper prepares."""
    n, ry, rx = windows.shape
    fast = sampling == "fast"
    dev = windows.device
    oy, ox, (v0, ty0, ty1), (u0, tx0, tx1) = _tap_plan(
        ry, rx, oxy, sp, out_size, w, wx, quantize, fast)

    face = torch.arange(n, device=dev)[:, None, None, None]

    def pix(vy, ux):
        """(N, L, S, S) window pixels at sub-window rows vy[..., j] and
        columns ux[..., i]. A tap outside the sub-window has weight 0, so
        its clamped read never counts."""
        yy = (oy[:, :, None] + vy)[:, :, :, None].clamp(0, ry - 1)
        xx = (ox[:, :, None] + ux)[:, :, None, :].clamp(0, rx - 1)
        return windows[face, yy, xx].float()

    p00, p01 = pix(v0, u0), pix(v0, u0 + 1)
    p10, p11 = pix(v0 + 1, u0), pix(v0 + 1, u0 + 1)
    ty0, ty1 = ty0[..., :, None], ty1[..., :, None]            # over j
    tx0, tx1 = tx0[..., None, :], tx1[..., None, :]            # over i

    def mid(v):
        return v.bfloat16().float() if fast else v

    if transposed:
        q0 = mid(tx0 * p00 + tx1 * p01)          # row v0, x pass first
        q1 = mid(tx0 * p10 + tx1 * p11)
        patch = (q0 * ty0 + q1 * ty1).transpose(2, 3)         # [x, y]
    else:
        r0 = mid(ty0 * p00 + ty1 * p10)          # column u0, y pass first
        r1 = mid(ty0 * p01 + ty1 * p11)
        patch = r0 * tx0 + r1 * tx1                            # [y, x]
    if quantize:
        patch = torch.clamp(torch.floor(patch + 0.5), 0.0, 255.0)
    return patch.to(out_dtype).contiguous()


def _launch(lib, windows, oxy, sp, out, w, wx, quantize, fast, transposed,
            per_block=None):
    """Launch K2 from ``lib`` (the entry point's library, or a measurement
    build of the same source) into ``out`` (N, L, S, S), with
    ``launch_plan``'s patches per block. ``per_block`` overrides the plan,
    for ``chip_smoke.py``'s sweep (which reaches past the plan's 8) and the
    plans-agree test only."""
    n, ry, rx = windows.shape
    l, s = out.shape[1], out.shape[2]
    if out.data_ptr() % 16:
        raise ValueError("the output must start on a 16-byte boundary")
    if per_block is None:
        per_block = launch_plan(n * l, s, transposed, out.element_size())
    err = lib.patches_window_launch(
        ctypes.c_void_p(windows.data_ptr()), _DTYPE_CODES[windows.dtype],
        ctypes.c_void_p(oxy.data_ptr()), ctypes.c_void_p(sp.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), int(out.dtype == torch.bfloat16),
        n, l, ry, rx, s, w, wx, int(quantize), int(fast), int(transposed),
        per_block, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"patches_window kernel launch failed: CUDA error {err}")


def sample_patches_window(windows: torch.Tensor, centers_x: torch.Tensor,
                          centers_y: torch.Tensor, patch_half: torch.Tensor,
                          out_size: int, sub_window: int = 0,
                          sub_window_x: int = 0, quantize: bool = True,
                          sampling: str = None, transposed: bool = False,
                          out_dtype=torch.float32) -> torch.Tensor:
    """Sample (N, L, S, S) patches from per-face ROI windows.

    windows: (N, RY, RX) uint8, bfloat16 or float32; centres (N, L) in
    window coordinates; patch_half: (N,). sub_window: rows W, a multiple
    of 8 (0 -> RY); sub_window_x: columns WX, a multiple of 128 with RX a
    multiple of 128 too (0 -> RX). sampling: 'exact' or 'fast' (default
    'fast' for bfloat16 windows, else 'exact'). transposed: emit
    out[n, l, x, y]. out_dtype: float32 or bfloat16.

    A CUDA tensor launches the K2 kernel; a CPU tensor takes the plain twin.
    """
    if windows.ndim != 3 or centers_x.ndim != 2:
        raise ValueError("expected (N, RY, RX) windows and (N, L) centres")
    n, ry, rx = windows.shape
    l = centers_x.shape[1]
    if (centers_x.shape != (n, l) or centers_y.shape != (n, l)
            or patch_half.shape != (n,)):
        raise ValueError("centres must be (N, L) and patch_half (N,)")
    if windows.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported window dtype {windows.dtype}")
    if not 1 <= out_size <= _MAX_SIZE:
        raise ValueError(f"out_size must be 1..{_MAX_SIZE}, got {out_size}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    w = sub_window or ry
    wx = sub_window_x or rx
    if not (w <= ry and w % SUBLANE_ALIGN == 0 and ry % SUBLANE_ALIGN == 0):
        raise ValueError(
            f"sample_patches_window: row sub-window W={w} and window height "
            f"RY={ry} must both be multiples of {SUBLANE_ALIGN} with W <= RY")
    if not (wx <= rx and (wx == rx or (wx % LANE_ALIGN == 0
                                       and rx % LANE_ALIGN == 0))):
        raise ValueError(
            f"sample_patches_window: column sub-window WX={wx} requires both "
            f"WX and the window width RX={rx} to be multiples of "
            f"{LANE_ALIGN} (or WX == RX)")
    if sampling is None:
        sampling = "fast" if windows.dtype == torch.bfloat16 else "exact"
    if sampling not in ("exact", "fast"):
        raise ValueError(f"unknown sampling mode {sampling!r}")
    oxy, sp = _prepare(centers_x.float(), centers_y.float(),
                       patch_half.float(), out_size)

    if windows.device.type == "cpu":
        return sample_patches_window_reference(
            windows, oxy, sp, out_size, w, wx, quantize, sampling,
            transposed, out_dtype)
    if windows.device.type != "cuda":
        raise ValueError(f"unsupported device {windows.device}")
    if not windows.is_contiguous():
        raise ValueError("windows must be contiguous")
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("patches_window")
    out = torch.empty((n, l, out_size, out_size), dtype=out_dtype,
                      device=windows.device)
    if n * l == 0:
        return out
    _launch(lib, windows, oxy, sp, out, w, wx, quantize, sampling == "fast",
            transposed)
    sample_patches_window.launches += 1
    return out


sample_patches_window.launches = 0
