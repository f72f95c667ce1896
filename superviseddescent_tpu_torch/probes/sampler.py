"""P1-P3: the window-sampler probes, hand-written in CUDA.

Replace the probe kernels of ``scripts/probe_sampler.py`` (P1),
``scripts/probe_sampler_g.py`` (P2) and ``scripts/probe_sampler_pre.py``
(P3). All three compute K2's fast, transposed, quantised sampling
(``ops/patches_window.py``) from ready-made crop origins and steps: for face
n and landmark lm, the (W, WX) sub-window of the face's bfloat16 window at an
origin floored to 8 rows and 128 columns, two bf16 tent products
``q = tx . subT`` and ``patch = bf16(q) . tyT`` with float32 sums,
``clip(floor(patch + 0.5), 0, 255)``, bfloat16 output, transposed
(``patch[x, y]``).

  * P1 ``probe_sampler(..., variant)``: ``full`` (per-landmark tents),
    ``shared`` (one base tent, the crop-space grid itself, for every
    landmark) and ``nodot`` (the tents are built, the products are replaced
    by ``ty[:, :S] + tx[:, :S]``, a bf16 sum): separates tent construction
    from the contraction.
  * P2 ``probe_sampler_g(..., g)``: ``full`` with g = 1, 2 or 4 faces per
    thread block: fewer, longer blocks against more blocks across the SMs.
  * P3 ``probe_sampler_pre(..., oo, pre)``: ``full`` with the sub-window
    origins read from the int32 input ``oo`` (``pre``) or formed in the
    kernel by one thread's float-to-int chain and a block barrier.

Every g and both ``pre`` settings give the bits of ``full``. The (8, 128)
flooring of the origin is part of the function: it decides which taps fall
outside ``[0, W) x [0, WX)`` and count as zero.

The kernel (``csrc/probe_sampler.cu``, one template for the three) is bound
by memory, the bf16 output stream, and held back by its window gathers. A
block takes the G * L patches of its G faces, face by face, in groups of
a face's patches in flight (``launch_plan``: up to 1,024 threads, two
blocks an SM, so that few faces are in flight and their windows stay in
L2), phase by phase: tap tables,
samples into a bf16 tile that holds the group's outputs as they lie in the
output, 16-byte stores. A tent row has at most two non-zero taps, so every
float32 sum has at most two non-zero terms and no summation order changes
it: kernel and twin agree bit for bit, for every plan. The plain twin
``probe_sampler_reference`` forms the dense tents and both products as
matrix products, as the scripts do; nothing on the card calls it but the
checks.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from superviseddescent_tpu_torch.ops.cascade_fused import (
    _BLOCK_RESERVED, _SM_SHARED)
from superviseddescent_tpu_torch.ops.patches_window import (
    LANE_ALIGN, SUBLANE_ALIGN)
from superviseddescent_tpu_torch.ops.solver import float32_matmul

VARIANTS = ("full", "shared", "nodot")
_MAX_SIZE = 96     # the kernel's largest output side S
_MAX_THREADS = 1024  # the kernel's largest block
#: the most threads a plan's block takes: two blocks an SM
PLAN_THREADS = 1024
#: the shared memory a plan's block may take: half of an SM's, less what
#: the card reserves per block
PLAN_SHARED = (_SM_SHARED - 2 * _BLOCK_RESERVED) // 2
_CHUNK = 16        # faces per step of the plain twin


class SamplerPlan(NamedTuple):
    """A launch of the P1-P3 kernel: patches of a face in flight per block
    (a group), threads per block (one per output column of the group) and
    the block's dynamic shared memory."""
    group: int
    threads: int
    shared_bytes: int


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def shared_bytes(s: int, group: int) -> int:
    """Dynamic shared memory of one block (csrc/probe_sampler.cu's
    Layout): the row and column tap tables (16 bytes an entry), the
    sub-window offsets, the bf16 tile of the group's outputs from the
    16-byte boundary before the first."""
    return (2 * _align16(group * s * 16) + _align16(group * 8)
            + _align16((group * s * s + 16) * 2))


@functools.lru_cache(maxsize=None)
def launch_plan(l: int, s: int, target: int = PLAN_THREADS) -> SamplerPlan:
    """The P1-P3 kernel's plan for faces of L landmarks at side S, whatever
    the faces per block (a block works its faces one after another): each
    face's patches in the fewest rounds (groups as even as they allow) whose
    group has at most ``target`` output columns, a thread each, and fits in
    PLAN_SHARED bytes, so that two blocks share an SM and the few faces in
    flight keep their windows in L2 (at least one patch a group); threads:
    the group's columns in whole warps. The choices were measured fastest by
    ``chip_smoke.py --probes --sweep``."""
    if not 1 <= s <= _MAX_SIZE:
        raise ValueError(f"S must be 1..{_MAX_SIZE}, got {s}")
    if l < 1:
        raise ValueError(f"need L >= 1, got L={l}")
    if not 32 <= target <= _MAX_THREADS:
        raise ValueError(f"target threads must be 32..{_MAX_THREADS}, got "
                         f"{target}")
    for rounds in range(1, l + 1):
        group = -(-l // rounds)
        if group * s <= target and shared_bytes(s, group) <= PLAN_SHARED \
                or group == 1:
            break
    return SamplerPlan(group, max(32, -(-group * s // 32) * 32),
                       shared_bytes(s, group))


def sub_window_origins(oxy: torch.Tensor, sp: torch.Tensor, ry: int, rx: int,
                       s: int, w: int, wx: int) -> torch.Tensor:
    """(N, 1, 2L) int32 sub-window origins [oy..., ox...] as the kernel forms
    them: ``floor(b + src0)`` clamped into the window, floored to 8 rows and
    128 columns."""
    n = oxy.shape[0]
    l = oxy.shape[-1] // 2
    o2 = oxy.reshape(n, 2 * l).float()
    st, ph = sp.reshape(n, 2).float().unbind(1)
    src0 = torch.minimum(torch.clamp((0.0 + 0.5) * st - 0.5, min=0.0),
                         2.0 * ph - 1.0)[:, None]
    oy = torch.clamp(torch.floor(o2[:, :l] + src0), 0.0, float(ry - w))
    ox = torch.clamp(torch.floor(o2[:, l:] + src0), 0.0, float(rx - wx))
    oy = torch.div(oy.int(), SUBLANE_ALIGN,
                   rounding_mode="floor") * SUBLANE_ALIGN
    ox = torch.div(ox.int(), LANE_ALIGN, rounding_mode="floor") * LANE_ALIGN
    return torch.cat([oy, ox], dim=1).int()[:, None, :].contiguous()


def _reference_chunk(windows, oxy, sp, oo, variant, s, w, wx):
    n, ry, rx = windows.shape
    l = oxy.shape[1] // 2
    dev = windows.device
    by, bx = oxy[:, :l], oxy[:, l:]
    st, ph = sp[:, 0:1], sp[:, 1:2]
    j = torch.arange(s, dtype=torch.float32, device=dev)[None, :]
    src = torch.minimum(torch.clamp((j + 0.5) * st - 0.5, min=0.0),
                        2.0 * ph - 1.0)                        # (N, S)
    oy = oo[:, :l].long().clamp(0, ry - w)
    ox = oo[:, l:].long().clamp(0, rx - wx)
    if variant == "shared":
        cy = cx = src[:, None, :].expand(n, l, s)
    else:
        cy = (by[:, :, None] + src[:, None, :]) - oy.float()[:, :, None]
        cx = (bx[:, :, None] + src[:, None, :]) - ox.float()[:, :, None]
    uy = torch.arange(w, dtype=torch.float32, device=dev)
    ux = torch.arange(wx, dtype=torch.float32, device=dev)
    ty = torch.clamp(1.0 - torch.abs(cy[..., None] - uy), min=0.0).bfloat16()
    tx = torch.clamp(1.0 - torch.abs(cx[..., None] - ux), min=0.0).bfloat16()
    if variant == "nodot":
        patch = (ty[..., :s] + tx[..., :s]).float()
    else:
        face = torch.arange(n, device=dev)[:, None, None, None]
        rows = (oy[:, :, None] + torch.arange(w, device=dev))[..., :, None]
        cols = (ox[:, :, None] + torch.arange(wx, device=dev))[..., None, :]
        sub = windows[face, rows, cols].float()                # (N, L, W, WX)
        q = torch.matmul(tx.float(), sub.transpose(-1, -2))    # (N, L, S, W)
        patch = torch.matmul(q.bfloat16().float(),
                             ty.float().transpose(-1, -2))     # [x, y]
    patch = torch.clamp(torch.floor(patch + 0.5), 0.0, 255.0)
    return patch.bfloat16()


def probe_sampler_reference(windows, oxy, sp, s, w, wx, variant="full",
                            oo=None):
    """Plain PyTorch twin of the P1-P3 kernel on any device: dense bf16
    tents and both products as float32 matrix products of bf16 values.
    ``oo``: the origins to use (P3 ``pre``); default: formed from ``oxy``
    and ``sp``. The faces per block of P2 do not enter the function."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    n, ry, rx = windows.shape
    if oo is None:
        oo = sub_window_origins(oxy, sp, ry, rx, s, w, wx)
    oxy2 = oxy.reshape(n, -1).float()
    sp2 = sp.reshape(n, 2).float()
    oo2 = oo.reshape(n, -1)
    with float32_matmul():
        out = [_reference_chunk(windows[a:a + _CHUNK], oxy2[a:a + _CHUNK],
                                sp2[a:a + _CHUNK], oo2[a:a + _CHUNK], variant,
                                s, w, wx)
               for a in range(0, n, _CHUNK)]
    return torch.cat(out).contiguous()


def _check(windows, oxy, sp, s, w, wx):
    if windows.ndim != 3 or windows.dtype != torch.bfloat16:
        raise ValueError("windows must be (N, RY, RX) bfloat16")
    n, ry, rx = windows.shape
    if oxy.ndim != 3 or oxy.shape[:2] != (n, 1) or oxy.shape[2] % 2:
        raise ValueError("oxy must be (N, 1, 2L)")
    if sp.shape != (n, 1, 2):
        raise ValueError("sp must be (N, 1, 2)")
    if oxy.dtype != torch.float32 or sp.dtype != torch.float32:
        raise ValueError("oxy and sp must be float32")
    if not 1 <= s <= _MAX_SIZE:
        raise ValueError(f"S must be 1..{_MAX_SIZE}, got {s}")
    if not (s <= w <= ry and w % SUBLANE_ALIGN == 0
            and ry % SUBLANE_ALIGN == 0):
        raise ValueError(f"row sub-window W={w}: a multiple of "
                         f"{SUBLANE_ALIGN} with S <= W <= RY={ry}")
    if not (s <= wx <= rx and wx % LANE_ALIGN == 0 and rx % LANE_ALIGN == 0):
        raise ValueError(f"column sub-window WX={wx}: a multiple of "
                         f"{LANE_ALIGN} with S <= WX <= RX={rx}")


def _run(counted, windows, oxy, sp, oo, variant, g, pre, s, w, wx):
    """Shared body of the three wrappers: a CPU tensor takes the plain twin,
    a CUDA tensor launches the kernel (and adds one to ``counted``'s
    launches)."""
    _check(windows, oxy, sp, s, w, wx)
    n, ry, rx = windows.shape
    l = oxy.shape[2] // 2
    if g not in (1, 2, 4) or n % g:
        raise ValueError(f"faces per block g={g}: 1, 2 or 4, dividing N={n}")
    if pre:
        if oo is None or oo.shape != oxy.shape or oo.dtype != torch.int32:
            raise ValueError("pre needs oo, (N, 1, 2L) int32")
    dev = windows.device
    if dev.type == "cpu":
        return probe_sampler_reference(windows, oxy, sp, s, w, wx, variant,
                                       oo if pre else None)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    tensors = [windows, oxy, sp] + ([oo] if pre else [])
    if any(t.device != dev or not t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous and on one device")
    from superviseddescent_tpu_torch.ops._build import load_library
    out = torch.empty((n, l, s, s), dtype=torch.bfloat16, device=dev)
    if n * l == 0:
        return out
    _launch(load_library("probe_sampler"), windows, oxy, sp, oo, out,
            variant, g, pre, s, w, wx)
    counted.launches += 1
    return out


def _launch(lib, windows, oxy, sp, oo, out, variant, g, pre, s, w, wx,
            plan=None):
    """One launch of ``lib``'s kernel (the entry points' build or a
    measurement build) into ``out``, with ``launch_plan``'s plan unless
    ``plan`` is given; raises if it is refused."""
    n, ry, rx = windows.shape
    l = oxy.shape[2] // 2
    plan = plan or launch_plan(l, s)
    err = lib.probe_sampler_launch(
        ctypes.c_void_p(windows.data_ptr()), ctypes.c_void_p(oxy.data_ptr()),
        ctypes.c_void_p(sp.data_ptr()),
        ctypes.c_void_p(oo.data_ptr() if pre else 0),
        ctypes.c_void_p(out.data_ptr()), n, l, ry, rx, s, w, wx,
        VARIANTS.index(variant), g, int(pre), plan.group, plan.threads,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(
            f"probe_sampler kernel launch failed: CUDA error {err}")


def probe_sampler(windows: torch.Tensor, oxy: torch.Tensor, sp: torch.Tensor,
                  variant: str, s: int, w: int, wx: int) -> torch.Tensor:
    """P1. windows: (N, RY, RX) bfloat16; oxy: (N, 1, 2L) float32 crop
    origins [by..., bx...] in window coordinates; sp: (N, 1, 2) float32
    (resize step, patch half). variant: 'full', 'shared' or 'nodot'.
    Returns (N, L, S, S) bfloat16 patches [x, y]."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    return _run(probe_sampler, windows, oxy, sp, None, variant, 1, False, s,
                w, wx)


probe_sampler.launches = 0


def probe_sampler_g(windows: torch.Tensor, oxy: torch.Tensor,
                    sp: torch.Tensor, g: int, s: int, w: int,
                    wx: int) -> torch.Tensor:
    """P2: P1 'full' with g = 1, 2 or 4 faces per thread block (N a
    multiple of g). The rows are those of g = 1."""
    return _run(probe_sampler_g, windows, oxy, sp, None, "full", g, False, s,
                w, wx)


probe_sampler_g.launches = 0


def probe_sampler_pre(windows: torch.Tensor, oxy: torch.Tensor,
                      sp: torch.Tensor, oo: torch.Tensor, pre: bool, s: int,
                      w: int, wx: int) -> torch.Tensor:
    """P3: P1 'full' with the sub-window origins read from ``oo``
    ((N, 1, 2L) int32 [oy..., ox...], clamped into the window) when ``pre``,
    else formed in the kernel. With ``sub_window_origins``' values both give
    the same rows."""
    return _run(probe_sampler_pre, windows, oxy, sp, oo, "full", 1,
                bool(pre), s, w, wx)


probe_sampler_pre.launches = 0
