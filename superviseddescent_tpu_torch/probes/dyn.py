"""P5: the dynamic-indexing probes, two small CUDA kernels (C and C4 share one).

Replace ``scripts/probe_dyn.py::probe_abde`` (``kernel_abde``), ``probe_c``
(``kernel_c``) and ``probe_c4`` (``kernel_c4``). The TPU probes asked whether
dynamic first-axis loads, dynamic aligned sub-slices, dynamic stores and a
slice offset derived from a loaded value compile; in CUDA each is an indexed
access, and the probes' worth is that the port computes the same numbers.

``probe_abde(x, win, s, w, wx, seg)``: x (G, 1, 2L) float32, win
(G, RY, RX) bfloat16 -> (G, 1, 2L) float32. Per face g and landmark lm: the
scalars ``x[g, 0, lm]`` (column) and ``x[g, 0, lm + L]`` (row) truncated to
int, clamped into the window and floored to 128 columns / 8 rows; the
(W, WX) sub-window at that origin; ``q = tx . subT`` and
``patch = bf16(q) . tyT`` with constant bf16 tents of 0.01 ((S, WX) and
(SEG, W)) and float32 sums; the (S, SEG) patch rounded to bf16 and stored
under its landmark index; the first S columns of every landmark's patch
laid side by side as (S, L*S); the column sums of that, of which the first
2L leave.

``probe_c(v, g, br)`` / ``probe_c4(v, g, br)``: v (R >= 4, SEG) float32 ->
(2*G*BR, SEG) float32 whose rows ``k*G*BR + f*BR + [0, 4)`` hold
``(v[0:4] + f) + 10 k`` for face f < G and k in {0, 1}; every other row is
zero. The TPU kernels stored the rows at a computed row offset of a 2-D
scratch (C) or at ``[k, f]`` of a 4-D one (C4); the function is the same, so
both launch one kernel, which stages nothing: each thread writes one 16-byte
word of the output, worked out from its position (``c_check``: G >= 1,
BR >= 4, SEG >= 1, at most ``C_MAX_ELEMENTS`` values).

Kernels in ``csrc/probe_dyn.cu``; nothing of the card bounds them (a few
hundred KB and MFLOP): their time is the launch and, for ABDE, a chain of
dependent products. The ABDE kernel runs a face per block and its
landmarks side by side, one warp each (``abde_plan``: up to 16 in flight,
a warp taking several where L is larger): the sub-window staged in shared
memory by 16-byte copies (in slices of rows where it is too tall), both
products on the tensor cores (bf16 in, float32 sums), each warp summing
its own output columns. Its float32 sums
run over 128 and 32 terms, so kernel, twin and the numpy emulation sum in
different orders and agree to a rounding of the bf16 intermediates (see
``ABDE_RTOL``); C and C4 are exact.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from superviseddescent_tpu_torch.ops.cascade_fused import _MAX_SHARED
from superviseddescent_tpu_torch.ops.solver import float32_matmul

#: kernel, twin and emulation of ABDE differ by at most one bf16 rounding of
#: the patch (2**-8 relative), summed over S rows of equal sign
ABDE_RTOL = 2.0 ** -7
#: the ABDE kernel's largest block (landmarks in flight, one warp each) and
#: the most sub-window rows a warp holds (q's fragments); csrc/probe_dyn.cu
ABDE_MAX_WARPS = 16
ABDE_MAX_ROWS = 128
#: the most elements a C / C4 output may hold (int32 offsets in the kernel)
C_MAX_ELEMENTS = 2 ** 31 - 1


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)
                            ).bfloat16().float().numpy()


def _origins(row_x, row_y, ry, rx, w, wx):
    oy = min(max(int(row_y), 0), ry - w) // 8 * 8
    ox = min(max(int(row_x), 0), rx - wx) // 128 * 128
    return oy, ox


def abde_emulation(x: np.ndarray, win: np.ndarray, s: int, w: int, wx: int,
                   seg: int) -> np.ndarray:
    """ABDE in numpy, loop by loop (x float32, win float32 holding bf16
    values): the emulation that ``scripts/probe_dyn.py`` checks its kernel
    against."""
    g_n, _, l2 = x.shape
    l = l2 // 2
    _, ry, rx = win.shape
    tent = _bf16(np.float32([0.01]))[0]
    exp = np.zeros((g_n, 1, l2), np.float32)
    for g in range(g_n):
        pscr = np.zeros((s, l * s), np.float32)
        for lm in range(l):
            oy, ox = _origins(x[g, 0, lm], x[g, 0, lm + l], ry, rx, w, wx)
            sub = win[g, oy:oy + w, ox:ox + wx].astype(np.float32)
            tx = np.full((s, wx), tent, np.float32)
            ty = np.full((seg, w), tent, np.float32)
            qb = _bf16(tx @ sub.T)
            pb = _bf16(qb @ ty.T)
            pscr[:, lm * s:(lm + 1) * s] = pb[:, 0:s]
        exp[g, 0, :] = pscr.sum(axis=0)[0:l2]
    return exp


def c_emulation(v: np.ndarray, g_n: int, br: int) -> np.ndarray:
    """C / C4 in numpy: zeros but for the stored rows."""
    gb = g_n * br
    exp = np.zeros((2 * gb, v.shape[1]), np.float32)
    for g in range(g_n):
        for k in range(2):
            off = k * gb + g * br
            exp[off:off + 4] = v[0:4] + np.float32(g) + np.float32(10 * k)
    return exp


def probe_abde_reference(x, win, s, w, wx, seg):
    """Plain PyTorch twin of the ABDE kernel on any device."""
    g_n, _, l2 = x.shape
    l = l2 // 2
    _, ry, rx = win.shape
    dev = x.device
    row = x.reshape(g_n, l2)
    ox = row[:, :l].int().clamp(0, rx - wx)
    oy = row[:, l:].int().clamp(0, ry - w)
    ox = (torch.div(ox, 128, rounding_mode="floor") * 128).long()
    oy = (torch.div(oy, 8, rounding_mode="floor") * 8).long()
    face = torch.arange(g_n, device=dev)[:, None, None, None]
    rows = (oy[:, :, None] + torch.arange(w, device=dev))[..., :, None]
    cols = (ox[:, :, None] + torch.arange(wx, device=dev))[..., None, :]
    sub = win[face, rows, cols].float()                        # (G, L, W, WX)
    tx = torch.full((s, wx), 0.01, device=dev).bfloat16().float()
    ty = torch.full((seg, w), 0.01, device=dev).bfloat16().float()
    with float32_matmul():
        q = torch.matmul(tx, sub.transpose(-1, -2)).bfloat16().float()
        patch = torch.matmul(q, ty.t()).bfloat16().float()    # (G, L, S, SEG)
    pscr = patch[..., :s].permute(0, 2, 1, 3).reshape(g_n, s, l * s)
    return pscr.sum(dim=1)[:, None, :l2].contiguous()


def probe_c_reference(v, g_n, br):
    """Plain PyTorch twin of the C and C4 kernels on any device."""
    seg = v.shape[1]
    f = torch.arange(g_n, dtype=torch.float32, device=v.device)
    k = torch.arange(2, dtype=torch.float32, device=v.device)
    rows = (v[None, None, 0:4, :] + f[None, :, None, None]) + (
        10.0 * k[:, None, None, None])                         # (2, G, 4, SEG)
    out = torch.zeros((2, g_n, br, seg), device=v.device)
    out[:, :, 0:4] = rows
    return out.reshape(2 * g_n * br, seg)


class AbdePlan(NamedTuple):
    """A launch of the ABDE kernel: warps (landmarks in flight) per block,
    sub-window rows a warp stages at a time, the block's shared memory."""
    warps: int
    rows: int
    shared_bytes: int


def abde_shared_bytes(s: int, wx: int, warps: int, rows: int) -> int:
    """Dynamic shared memory of an ABDE block: each warp's ``rows`` staged
    sub-window rows in bf16, padded by 8 values, and its S column sums."""
    return warps * (rows * (wx + 8) * 2 + s * 4)


def abde_check(s: int, w: int, wx: int, l: int, seg: int, ry: int,
               rx: int) -> None:
    """Raise ValueError, naming the limit, where ABDE's contract does not
    take the shapes (the kernel's launch checks the same)."""
    if not (s <= seg and 2 * l <= l * s):
        raise ValueError(f"need S <= SEG and 2L <= L*S, got S={s}, SEG={seg}, "
                         f"L={l}")
    if not (0 <= w <= ry and w % 8 == 0):
        raise ValueError(f"W must be a multiple of 8 up to RY, got W={w}, "
                         f"RY={ry}")
    if not (0 <= wx <= rx and wx % 128 == 0):
        raise ValueError(f"WX must be a multiple of 128 up to RX, got "
                         f"WX={wx}, RX={rx}")


def abde_plan(s: int, w: int, wx: int, l: int) -> AbdePlan:
    """The ABDE kernel's plan for L >= 1 landmarks within the shared memory
    of a block: the whole sub-window a warp where it fits (at most
    ABDE_MAX_ROWS rows), else the most rows, a multiple of 8, that one warp
    can stage; then as many landmarks in flight as fit (at most
    ABDE_MAX_WARPS), spread evenly over the warps. Raises ValueError where
    not even 8 rows of one landmark fit."""
    rows = min(max(w, 8), ABDE_MAX_ROWS)
    while rows > 8 and abde_shared_bytes(s, wx, 1, rows) > _MAX_SHARED:
        rows -= 8
    per_warp = abde_shared_bytes(s, wx, 1, rows)
    if per_warp > _MAX_SHARED:
        raise ValueError(f"one landmark's 8 staged rows and S sums need "
                         f"{per_warp} bytes of shared memory; one block has "
                         f"{_MAX_SHARED}")
    warps = min(l, ABDE_MAX_WARPS, _MAX_SHARED // per_warp)
    warps = -(-l // -(-l // warps))  # the same rounds, landmarks spread evenly
    return AbdePlan(warps, rows, abde_shared_bytes(s, wx, warps, rows))


def probe_abde(x: torch.Tensor, win: torch.Tensor, s: int, w: int, wx: int,
               seg: int) -> torch.Tensor:
    """ABDE (see the module docstring). A CPU tensor takes the plain twin; a
    CUDA tensor launches the kernel."""
    if x.ndim != 3 or x.shape[1] != 1 or x.shape[2] % 2 or \
            x.dtype != torch.float32:
        raise ValueError("x must be (G, 1, 2L) float32")
    g_n, _, l2 = x.shape
    l = l2 // 2
    if win.ndim != 3 or win.shape[0] != g_n or win.dtype != torch.bfloat16:
        raise ValueError("win must be (G, RY, RX) bfloat16")
    _, ry, rx = win.shape
    abde_check(s, w, wx, l, seg, ry, rx)
    plan = abde_plan(s, w, wx, l) if l else None
    if x.device.type == "cpu":
        return probe_abde_reference(x, win, s, w, wx, seg)
    if x.device.type != "cuda" or win.device != x.device:
        raise ValueError(f"unsupported devices {x.device}, {win.device}")
    if not (x.is_contiguous() and win.is_contiguous()):
        raise ValueError("x and win must be contiguous")
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("probe_dyn")
    out = torch.empty_like(x)
    if g_n * l == 0:
        return out
    err = lib.probe_abde_launch(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(win.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), g_n, ry, rx, s, w, wx, l, seg,
        plan.warps, plan.rows,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe_abde kernel launch failed: CUDA error {err}")
    probe_abde.launches += 1
    return out


probe_abde.launches = 0


def c_check(g_n: int, br: int, seg: int, rows: int) -> None:
    """Raise ValueError, naming the limit, where C's contract does not take
    the shapes (the kernel's launch checks the same; ``rows``: v's rows)."""
    if rows < 4:
        raise ValueError(f"v needs at least 4 rows, got {rows}")
    if g_n < 1:
        raise ValueError(f"need G >= 1, got G={g_n}")
    if br < 4:
        raise ValueError(f"need BR >= 4, got BR={br}")
    if seg < 1:
        raise ValueError(f"need SEG >= 1, got SEG={seg}")
    if 2 * g_n * br * seg > C_MAX_ELEMENTS:
        raise ValueError(f"the output's 2*G*BR*SEG = {2 * g_n * br * seg} "
                         f"elements exceed int32")


def _run_c(counted, v, g_n, br, out):
    if v.ndim != 2 or v.dtype != torch.float32:
        raise ValueError("v must be (R >= 4, SEG) float32")
    seg = v.shape[1]
    c_check(g_n, br, seg, v.shape[0])
    shape = (2 * g_n * br, seg)
    if out is not None and (out.shape != shape or out.dtype != torch.float32
                            or out.device != v.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {shape} float32 tensor "
                         f"on {v.device}")
    if v.device.type == "cpu":
        ref = probe_c_reference(v, g_n, br)
        return ref if out is None else out.copy_(ref)
    if v.device.type != "cuda":
        raise ValueError(f"unsupported device {v.device}")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("probe_dyn")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=v.device)
    err = lib.probe_c_launch(
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        g_n, br, seg, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe_c kernel launch failed: CUDA error {err}")
    counted.launches += 1
    return out


def probe_c(v: torch.Tensor, g_n: int, br: int,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C: the rows that the TPU kernel stored at a computed offset of a 2-D
    scratch. ``out``: the (2*G*BR, SEG) float32 tensor to write (any
    float32 alignment), else a new one."""
    return _run_c(probe_c, v, g_n, br, out)


probe_c.launches = 0


def probe_c4(v: torch.Tensor, g_n: int, br: int,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """C4: the same rows, which the TPU kernel stored at [k, face] of a 4-D
    scratch; the same kernel as C, counted apart."""
    return _run_c(probe_c4, v, g_n, br, out)


probe_c4.launches = 0
