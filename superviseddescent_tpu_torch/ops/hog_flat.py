"""K1: HOG of flattened S x S patches, a hand-written CUDA kernel.

Replaces the TPU kernel ``superviseddescent_tpu/ops/hog_pallas_flat.py::
hog_descriptor_pallas_flat`` (``_flat_kernel``), with the same contract:
(B, S*S) row-major flattened patches (or (x, y)-major with
``transposed``), float32 or bfloat16 -> (B, D*C*C) float32 descriptors in
Matlab order d*C*C + cx*C + cy. Exact mode matches ``ops/hog.py``; fast
mode (O=4 only for the sector compare) classifies orientations by two slope
compares and rounds the gradient planes and tent weights to bfloat16 with
float32 accumulation.

The kernel (``csrc/hog_flat.cu``) runs P patches per block (``launch_plan``):
  1. the patches are staged in shared memory as float32 with 16-byte loads,
     in their own layout (a transposed patch stays transposed: the kernel
     works in storage coordinates), beside the (S, C) float64 tents;
  2. one thread per pixel computes the central-difference gradient, its
     magnitude and its bin, stepping the pixel's coordinates without a
     division;
  3. the splat. Exact mode: two separable float32 passes over the tents
     rounded to float32 (``separable_cells`` is the same arithmetic in
     plain PyTorch; it stays within K1's tolerance of the twin's 2-D
     weights and takes half the (pixel, cell) pairs), one thread per
     (patch, cell row, column) into its own bin slots, then one per
     (patch, bin, cell). Fast mode, whose contract rounds each 2-D weight
     to bf16 (and exact mode where the separable buffers exceed a block,
     ``separable``): one warp per cell, for all P patches at once, the
     lanes forming each weight in registers as float32(Wa * Wb) from the
     float64 tents (``kernel_weights`` is the same formula in numpy: the
     bits of ``_flat_weights``) and adding into their own (patch, bin,
     lane) slots in shared memory, summed in a fixed order. No atomics,
     so runs repeat bit for bit, for every P;
  4. one thread per cell forms the energy and the four block factors;
  5. one thread per output value writes the Uoctti / DalalTriggs
     channels, the block's P descriptors as one contiguous run.
What bounds it on the H100: memory. At the RCR-22 level-0 shape
(90,112 patches of 55 x 55 float32) it must read 1.09 GB and write
0.14 GB, ~0.37 ms at 3.35 TB/s, against ~11 GFLOP of float32 arithmetic
(~0.16 ms at 67 TFLOP/s). The design reads each input pixel once, keeps
every intermediate (gradients, bins, cell histograms) in shared memory,
and reads no weight table (an earlier design read a (C*C, S*S) float32
table, 302 KB at S = 55, per (pixel, cell) pair, from L2).

The kernel is compiled with -fmad=false so that every float operation
rounds as PyTorch's separate elementwise operations do; the plain twin
``hog_descriptor_flat_reference`` then differs from it only in the order
of the splat sums.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from superviseddescent_tpu_torch.ops.hog import (
    HogVariant, _orientation_vectors, _tent_1d, hog_dimension, hog_num_cells)

# (dx, dy) neighbours of the four 2x2 blocks around a cell, factor order
# 1..4 of vl_hog_extract (UL, UR, LL, LR)
_BLOCKS = (((-1, -1), (0, -1), (-1, 0), (0, 0)),
           ((0, -1), (1, -1), (0, 0), (1, 0)),
           ((-1, 0), (0, 0), (-1, 1), (0, 1)),
           ((0, 0), (1, 0), (0, 1), (1, 1)))
_TAN_PI_8 = 0.41421356237
_TAN_3PI_8 = 2.41421356237
# the kernel stages one patch and its gradient planes in shared memory
_MAX_SIZE = 96
_MAX_ORIENTATIONS = 16


@functools.lru_cache(maxsize=None)
def _flat_weights(size: int, cell_size: int) -> np.ndarray:
    """(S*S, C*C) float32 tent weights w2[y*S + x, cx*C + cy] =
    Wy[y, cy] * Wx[x, cx], formed in float64 and rounded once, with border
    pixels zero (the same table as the TPU kernel's)."""
    w = _tent_1d(size, cell_size)
    c = w.shape[1]
    return np.einsum("yc,xd->yxdc", w, w).reshape(
        size * size, c * c).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flat_weights_on(size: int, cell_size: int,
                     device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_flat_weights(size, cell_size)).to(device)


def kernel_weights(size: int, cell_size: int,
                   transposed: bool = False) -> np.ndarray:
    """The kernel's tent weights, formed as it forms them, in the layout
    of ``_flat_weights``: storage pixel (a, b) (row a of stride S, column
    b) weighs on the cell (ca, cb) along those axes by
    float32(W[a, ca] * W[b, cb]), from the float64 tents W; storage is
    (y, x), or (x, y) when ``transposed``."""
    w = _tent_1d(size, cell_size)
    c = w.shape[1]
    # [a, ca, b, cb]: each float64 product rounded once to float32
    prod = (w[:, :, None, None] * w[None, None, :, :]).astype(np.float32)
    # to [y, x, cx, cy]
    table = prod.transpose((2, 0, 1, 3) if transposed else (0, 2, 3, 1))
    return np.ascontiguousarray(table).reshape(size * size, c * c)


def separable_cells(planes: torch.Tensor, size: int, cell_size: int,
                    transposed: bool = False) -> torch.Tensor:
    """The exact-mode kernel's splat in plain PyTorch: (B, 2O, S*S)
    magnitude planes in storage order (one bin each) -> (B, 2O, C*C) cell
    histograms in Matlab cell order, in the kernel's float32 arithmetic:
    the tents rounded to float32, first along storage rows a (summed in
    increasing a), then along columns b (in increasing b)."""
    s = size
    w = torch.from_numpy(_tent_1d(s, cell_size).astype(np.float32)).to(
        planes.device)                                          # (S, C)
    c = w.shape[1]
    img = planes.reshape(*planes.shape[:2], s, s)               # [.., a, b]
    part = torch.zeros(*planes.shape[:2], c, s, device=planes.device)
    for a in range(s):                                          # [.., ca, b]
        part = part + img[:, :, None, a, :] * w[a][None, None, :, None]
    cells = torch.zeros(*planes.shape[:2], c, c, device=planes.device)
    for b in range(s):                                          # [.., ca, cb]
        cells = cells + part[:, :, :, b, None] * w[b][None, None, None, :]
    if not transposed:
        cells = cells.transpose(2, 3)     # storage (y, x): ca = cy, cb = cx
    return cells.reshape(*planes.shape[:2], c * c)


@functools.lru_cache(maxsize=None)
def _tents_on(size: int, cell_size: int, device: torch.device) -> torch.Tensor:
    """(S, C) float64 tents on ``device``, from which the kernel forms its
    weights."""
    return torch.from_numpy(_tent_1d(size, cell_size)).to(device)


@functools.lru_cache(maxsize=None)
def _orientations_on(num_orientations: int,
                     device: torch.device) -> torch.Tensor:
    """(2, O) float32 (cos, sin)(k*pi/O) on ``device``."""
    return torch.from_numpy(_orientation_vectors(num_orientations)).to(device)


def _check(patches_flat, size, cell_size, num_orientations, variant):
    if patches_flat.ndim != 2 or patches_flat.shape[1] != size * size:
        raise ValueError(f"expected (B, {size * size}) patches, got "
                         f"{tuple(patches_flat.shape)}")
    if patches_flat.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"patches must be float32 or bfloat16, got "
                         f"{patches_flat.dtype}")
    if not (3 <= size <= _MAX_SIZE and 1 <= cell_size <= size
            and 1 <= num_orientations <= _MAX_ORIENTATIONS):
        raise ValueError(
            f"unsupported HOG shape: size {size} (3..{_MAX_SIZE}), cell "
            f"size {cell_size}, {num_orientations} orientations "
            f"(1..{_MAX_ORIENTATIONS})")
    HogVariant(variant)


def sector_bins(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Directed bin 0..7 of each gradient for O=4: the nearest multiple of
    pi/4, picked by two slope compares (the fast mode's binning)."""
    dev = gx.device
    ax, ay = gx.abs(), gy.abs()
    px, py = gx >= 0, gy >= 0
    one = torch.ones((), dtype=torch.long, device=dev)
    bin_h = torch.where(px, 0 * one, 4 * one)
    bin_v = torch.where(py, 2 * one, 6 * one)
    bin_d = torch.where(px == py, torch.where(px, one, 5 * one),
                        torch.where(py, 3 * one, 7 * one))
    t_lo = torch.tensor(_TAN_PI_8, dtype=torch.float32, device=dev)
    t_hi = torch.tensor(_TAN_3PI_8, dtype=torch.float32, device=dev)
    return torch.where(ay < ax * t_lo, bin_h,
                       torch.where(ay > ax * t_hi, bin_v, bin_d))


def uoctti_channels(factors, ha, hb):
    """The 3O + 4 Uoctti channels from the four block factors and the
    per-orientation directed (ha) and opposite (hb) histograms, all
    tensors of one shape: 0.5 x the sums of the four normalised copies,
    clamped at 0.2, then the texture channels t_i / sqrt(18)."""
    t_acc = [0.0] * 4
    chan_a, chan_b, chan_c = [], [], []
    for ha_k, hb_k in zip(ha, hb):
        ha_s = hb_s = hc_s = 0.0
        for i in range(4):
            hai = factors[i] * ha_k
            hbi = factors[i] * hb_k
            hci = torch.clamp(hai + hbi, max=0.2)
            ha_s = ha_s + torch.clamp(hai, max=0.2)
            hb_s = hb_s + torch.clamp(hbi, max=0.2)
            hc_s = hc_s + hci
            t_acc[i] = t_acc[i] + hci
        chan_a.append(0.5 * ha_s)
        chan_b.append(0.5 * hb_s)
        chan_c.append(0.5 * hc_s)
    scale_t = float(np.float32(1.0) / np.sqrt(np.float32(18.0)))
    return chan_a + chan_b + chan_c + [t * scale_t for t in t_acc]


def hog_descriptor_flat_reference(patches_flat: torch.Tensor, size: int,
                                  cell_size: int, num_orientations: int,
                                  variant: HogVariant = HogVariant.Uoctti,
                                  fast: bool = False,
                                  transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch twin of the K1 kernel, on any device."""
    _check(patches_flat, size, cell_size, num_orientations, variant)
    s, o = size, num_orientations
    b = patches_flat.shape[0]
    dev = patches_flat.device
    img = patches_flat.float().reshape(b, s, s)
    if transposed:
        img = img.transpose(1, 2)
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1, 1:-1] = img[:, 1:-1, 2:] - img[:, 1:-1, :-2]
    gy[:, 1:-1, 1:-1] = img[:, 2:, 1:-1] - img[:, :-2, 1:-1]
    gx = gx.reshape(b, s * s)
    gy = gy.reshape(b, s * s)
    grad = torch.sqrt(gx * gx + gy * gy)

    if fast and o == 4:
        best_bin = sector_bins(gx, gy)
    else:
        # argmax of |score| on unnormalised gradients, first maximum wins,
        # k + O for a negative score
        ov = _orientations_on(o, dev)
        best = torch.zeros_like(grad)
        best_bin = torch.full(grad.shape, -1, dtype=torch.long, device=dev)
        for k in range(o):
            sc = gx * ov[0, k] + gy * ov[1, k]
            a = sc.abs()
            upd = a > best
            best = torch.where(upd, a, best)
            best_bin = torch.where(
                upd, torch.where(sc < 0, k + o, k), best_bin)

    bins = torch.arange(2 * o, device=dev)[None, :, None]
    planes = torch.where(best_bin[:, None, :] == bins, grad[:, None, :],
                         torch.zeros((), device=dev))           # (B, 2O, P)
    w2 = _flat_weights_on(s, cell_size, dev)
    if fast:
        planes = planes.bfloat16().float()
        w2 = w2.bfloat16().float()
    cells = torch.matmul(planes, w2)                            # (B, 2O, CC)
    ha, hb = cells[:, :o], cells[:, o:]

    c = hog_num_cells(s, cell_size)
    energy = torch.zeros((b, c * c), device=dev)
    for k in range(o):
        f = ha[:, k] + hb[:, k]
        energy = energy + f * f
    e = torch.nn.functional.pad(energy.reshape(b, 1, c, c), (1, 1, 1, 1),
                                mode="replicate")[:, 0]        # [cx, cy]
    factors = []
    for block in _BLOCKS:
        total = None
        for dx, dy in block:
            n = e[:, 1 + dx:1 + dx + c, 1 + dy:1 + dy + c].reshape(b, c * c)
            total = n if total is None else total + n
        factors.append(torch.rsqrt(total + 1e-4))

    if variant == HogVariant.Uoctti:
        channels = uoctti_channels(factors, [ha[:, k] for k in range(o)],
                                   [hb[:, k] for k in range(o)])
    else:
        channels = [torch.clamp(factors[i] * (ha[:, k] + hb[:, k]), max=0.2)
                    for i in range(4) for k in range(o)]
    return torch.cat(channels, dim=1)


# patches per block, by patch side, as a sweep on the H100 over 1-3 patches
# at the four level shapes chose them (PERF.md section 6); more patches
# share each splat weight between them, fewer leave more blocks on an SM.
# Exact mode: 1 at S = 55 and 50, 2 at 40, 3 at 30; fast mode: 1 at 55, 2
# at 50, 3 at 40 and 30. Fewer where a block would take more than
# _PLAN_SHARED bytes of shared memory.
_PER_BLOCK_BY_SIZE = {False: ((44, 1), (35, 2), (0, 3)),
                      True: ((52, 1), (44, 2), (0, 3))}
_PLAN_SHARED = 100 * 1024
_MAX_SHARED = 232448  # shared memory one block may take on the H100
_THREADS = 256  # of a K1 block
_WARPS = _THREADS // 32


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _shared_bytes(size: int, cell_size: int, num_orientations: int,
                  per_block: int, separable: bool) -> int:
    """Dynamic shared memory of one K1 block: csrc/hog_flat.cu's Layout,
    for the separable splat (exact mode) or the 2-D one."""
    s, p, two_o = size, per_block, 2 * num_orientations
    c = hog_num_cells(s, cell_size)
    if separable:
        splat = (s * c * 4, _THREADS * two_o * 4, p * two_o * c * s * 4)
    else:
        splat = (0, _WARPS * p * two_o * 32 * 4, _WARPS * p * two_o * 4 * 4)
    return sum(_align16(n) for n in (
        s * c * 8, splat[0], two_o * 4, p * s * s * 4, p * s * s * 4,
        *splat[1:], p * two_o * c * c * 4, p * c * c * 4, p * 4 * c * c * 4,
        p * s * s))


def separable(size: int, cell_size: int, num_orientations: int,
              per_block: int, fast: bool) -> bool:
    """Whether the kernel splats in two separable passes: in exact mode,
    where their buffers fit in a block. The launch passes this answer to
    the kernel, which takes the form it is given."""
    return not fast and _shared_bytes(size, cell_size, num_orientations,
                                      per_block, True) <= _MAX_SHARED


@functools.lru_cache(maxsize=None)
def launch_plan(size: int, cell_size: int, num_orientations: int,
                fast: bool = False) -> int:
    """Patches per K1 block for patches of side S (at least 1; a shape
    whose one-patch block exceeds the card's shared memory is refused by
    the launch)."""
    per_block = next(p for least, p in _PER_BLOCK_BY_SIZE[fast]
                     if size >= least)
    while per_block > 1 and _shared_bytes(
            size, cell_size, num_orientations, per_block,
            separable(size, cell_size, num_orientations, per_block,
                      fast)) > _PLAN_SHARED:
        per_block -= 1
    return per_block


def _launch(lib, patches_flat, out, size, cell_size, num_orientations,
            variant, fast, transposed, per_block=None):
    """Launch K1 from ``lib`` (the entry point's library, or a measurement
    build of the same source) on checked, contiguous CUDA patches, with
    ``launch_plan``'s patches per block. ``per_block`` overrides the plan,
    for ``chip_smoke.py``'s sweep and the plans-agree test only."""
    tents = _tents_on(size, cell_size, patches_flat.device)
    ov = _orientations_on(num_orientations, patches_flat.device)
    if per_block is None:
        per_block = launch_plan(size, cell_size, num_orientations, fast)
    sep = separable(size, cell_size, num_orientations, per_block, fast)
    err = lib.hog_flat_launch(
        ctypes.c_void_p(patches_flat.data_ptr()),
        int(patches_flat.dtype == torch.bfloat16),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(tents.data_ptr()),
        ctypes.c_void_p(ov.data_ptr()),
        patches_flat.shape[0], size, cell_size, num_orientations,
        int(variant), int(fast), int(transposed), per_block, int(sep),
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"hog_flat kernel launch failed: CUDA error {err}")


def hog_descriptor_flat(patches_flat: torch.Tensor, size: int,
                        cell_size: int, num_orientations: int,
                        variant: HogVariant = HogVariant.Uoctti,
                        fast: bool = False,
                        transposed: bool = False) -> torch.Tensor:
    """(B, S*S) flattened patches -> (B, C*C*D) float32 descriptors.

    A CUDA tensor launches the K1 kernel; a CPU tensor takes the plain
    twin. fast=True: sector binning (O=4) and bfloat16 gradient planes and
    tent weights with float32 sums. transposed: patches are flattened
    (x, y)-major, the window sampler's transposed output.
    """
    _check(patches_flat, size, cell_size, num_orientations, variant)
    if patches_flat.device.type == "cpu":
        return hog_descriptor_flat_reference(
            patches_flat, size, cell_size, num_orientations, variant,
            fast=fast, transposed=transposed)
    if patches_flat.device.type != "cuda":
        raise ValueError(f"unsupported device {patches_flat.device}")
    if not patches_flat.is_contiguous():
        raise ValueError("patches must be contiguous")
    from superviseddescent_tpu_torch.ops._build import load_library
    b = patches_flat.shape[0]
    c = hog_num_cells(size, cell_size)
    dims = hog_dimension(variant, num_orientations)
    out = torch.empty((b, dims * c * c), dtype=torch.float32,
                      device=patches_flat.device)
    if b == 0:
        return out
    _launch(load_library("hog_flat"), patches_flat, out, size, cell_size,
            num_orientations, variant, fast, transposed)
    hog_descriptor_flat.launches += 1
    return out


hog_descriptor_flat.launches = 0
