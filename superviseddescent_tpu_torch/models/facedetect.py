"""Viola-Jones face detection (Haar cascade evaluator) in PyTorch.

Counterpart of ``superviseddescent_tpu/models/facedetect.py``. The reference
library leaves face detection to OpenCV's
``CascadeClassifier::detectMultiScale`` (rcr-detect.cpp:110,
rcr-train.cpp:410, rcr-track.cpp:141; default model
``haarcascade_frontalface_alt2.xml``, carried with this package as
``io.haar.STOCK_FRONTAL_ALT2``). The JAX package evaluates the stock cascade
files as plain XLA, with no Pallas kernel; this module does the same with
PyTorch operations, on the card unless the caller names the CPU:

  * Every Haar feature is linear in the window's pixels, so every tree of
    every window evaluates as two matrix products: window rows
    ``(N, wh*ww)`` (one strided copy) against the node-0 / node-1
    pixel-weight banks ``(wh*ww, T)`` built by ``io/haar.py``
    (``torch.matmul``).
  * Variance normalisation folds into the node comparison:
    ``raw/nf < t  <=>  raw < t*nf`` (nf > 0), so no divisions.
  * The windows of whole frames, every level of each, are evaluated
    together, up to ``WINDOW_BUDGET`` windows at a time (the memory bound on
    the (N, T) intermediates). The first ``N_PRE_STAGES`` stages run on
    every window; the windows that pass them are compacted on the device
    into a fixed ``N // SURVIVOR_DIV`` slots (no host synchronisation), and
    only they meet the remaining stages. A buffer too small for its
    survivors raises a flag, on the device, for the frames it holds.
  * A detect call reads back one ``(B, MAX_CANDIDATES + 2)`` int32 array of
    candidate indices, counts and flags; a frame with more candidates than
    slots, or with its flag raised, is evaluated again densely and its
    whole mask read back (correctness over speed).

Numerics, exact where JAX's is. The pyramid is the JAX package's: a
bilinear resize without antialias (``jax.image.resize(..., "linear",
antialias=False)``: two taps per output from the same float32 weights,
half-pixel centres, edge weights renormalised; here the width pass, then
the height pass, each tap's product rounded and then summed), rounded half
to even and clipped to [0, 255]. With integer pixels and the stock
cascades' small integer rect weights (checked by ``banks_exact_in_bf16``)
every bank product and every partial sum is an integer below 2^24, so the
float32 products (TF32 off) are exact in any order, on the CPU and on the
card. The norm factor's sums come from float64 integral images of each
level, exact integers as JAX's sums over the window rows are. Stage sums
add float32 leaf values in float64, where the stock cascades' sums are
exact in any order (so the CPU and the card agree bit for bit); JAX adds
them in float32, so a window whose stage sum ties its threshold to within
float32 rounding may decide the other way there.
"""

from __future__ import annotations

import collections
import functools
from typing import Iterable, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from superviseddescent_tpu_torch.io.haar import (
    HaarCascadeData, parse_opencv_cascade)
from superviseddescent_tpu_torch.ops.solver import float32_matmul
from superviseddescent_tpu_torch.utils.device import resolve_device

# stages evaluated on EVERY window before survivor compaction; the remaining
# stages run only on windows that pass these (OpenCV's early-out as a static
# two-phase split)
N_PRE_STAGES = 3


def banks_exact_in_bf16(d: HaarCascadeData) -> bool:
    """True when the bank products are exact for integer pixels in [0, 255]
    in float32 in any order, and also as bf16 products with float32 sums:
    integer weights, bf16-representable, and a worst-case absolute column
    sum x 255 below 2^24 (so every partial sum is an integer float32 holds
    exactly). All stock OpenCV frontal-face cascades pass."""
    for b in (d.bank0, d.bank1):
        if not np.all(b == np.round(b)):
            return False
        t = torch.from_numpy(np.ascontiguousarray(b, np.float32))
        if not torch.equal(t.bfloat16().float(), t):
            return False
        if np.abs(b).sum(axis=0).max() * 255.0 >= 2.0 ** 24:
            return False
    return True


@functools.lru_cache(maxsize=1024)
def resize_taps(n_in: int, n_out: int):
    """The two taps of each output of a linear resize from ``n_in`` to
    ``n_out`` samples, as ``jax.image.resize(..., "linear",
    antialias=False)`` weighs them (``compute_weight_mat``, in float32):
    sample centre ``(j + 0.5) / scale - 0.5``, triangle weights of the
    in-range inputs, normalised by their sum, zero where the centre lies
    outside the input. Returns numpy (i0, i1, w0, w1); a tap outside the
    input has weight 0 and an index clipped into it."""
    inv = np.float32(1.0 / (n_out / n_in))
    sf = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    i0 = np.floor(sf).astype(np.int64)
    taps = []
    for i in (i0, i0 + 1):
        inside = (i >= 0) & (i < n_in)
        w = np.maximum(np.float32(0.0),
                       np.float32(1.0) - np.abs(sf - i.astype(np.float32)))
        taps.append((np.clip(i, 0, n_in - 1),
                     np.where(inside, w, np.float32(0.0))))
    (j0, w0), (j1, w1) = taps
    total = w0 + w1
    keep = ((np.abs(total) > 1000.0 * np.finfo(np.float32).eps)
            & (sf >= -0.5) & (sf <= n_in - 0.5))
    safe = np.where(total != 0, total, np.float32(1.0))
    w0 = np.where(keep, w0 / safe, np.float32(0.0)).astype(np.float32)
    w1 = np.where(keep, w1 / safe, np.float32(0.0)).astype(np.float32)
    return j0, j1, w0, w1


@functools.lru_cache(maxsize=1024)
def _device_taps(n_in: int, n_out: int, dim: int, device: torch.device):
    """``resize_taps`` on ``device`` for axis ``dim`` of a (B, H, W) stack,
    the weights shaped to broadcast along it; uploaded once: an upload from
    pageable memory would wait for the work already queued on the card."""
    shape = [1, 1, 1]
    shape[dim] = n_out
    i0, i1, w0, w1 = (torch.from_numpy(a).to(device)
                      for a in resize_taps(n_in, n_out))
    return i0, i1, w0.view(shape), w1.view(shape)


def _resize_axis(images: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    i0, i1, w0, w1 = _device_taps(images.shape[dim], n_out, dim,
                                  images.device)
    return (torch.index_select(images, dim, i0) * w0
            + torch.index_select(images, dim, i1) * w1)


def resize_round(images: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    """(B, H, W) float32 -> (B, sh, sw) integer-valued float32: the JAX
    package's pyramid level (``facedetect.py:312-314``), the width pass
    first, then the height pass, rounded half to even, clipped to
    [0, 255]."""
    scaled = _resize_axis(_resize_axis(images, sw, 2), sh, 1)
    return torch.clamp(torch.round(scaled), 0.0, 255.0)


def windows(images: torch.Tensor, wh: int, ww: int,
            stride: int) -> torch.Tensor:
    """Every stride-aligned (wh, ww) window of a contiguous (B, H, W) stack
    as a (B, oh, ow, wh, ww) view (no copy); copied into window rows it is
    the JAX package's ``conv_general_dilated_patches`` (``_patch_rows``)."""
    b, h, w = images.shape
    sb, sy, sx = images.stride()
    return images.as_strided(
        (b, (h - wh) // stride + 1, (w - ww) // stride + 1, wh, ww),
        (sb, stride * sy, stride * sx, sy, sx), images.storage_offset())


def inner_sums(images: torch.Tensor, wh: int, ww: int,
               stride: int) -> torch.Tensor:
    """The sum and the sum of squares of the centred pixels ``x - 128``
    over each window's inner rect (OpenCV's normrect (1, 1, ww-2, wh-2)),
    from float64 integral images of a (B, H, W) integer-valued stack:
    (2, B, oh, ow) float32. Every value is an integer (|sum| <= 128 * area,
    sum of squares <= 16384 * area, both below 2^24 for a 20 x 20 window),
    so these are the exact sums that the JAX package takes over each
    window's row."""
    _, h, w = images.shape
    pc = images.double() - 128.0
    ii = F.pad(torch.stack((pc, pc * pc)).cumsum(2).cumsum(3),
               (1, 0, 1, 0))                        # (2, B, H + 1, W + 1)
    rows = ii[:, :, wh - 1:h] - ii[:, :, 1:h - wh + 2]
    boxes = rows[..., ww - 1:w] - rows[..., 1:w - ww + 2]
    return boxes[:, :, ::stride, ::stride].float()


class ScalePlan(NamedTuple):
    """One pyramid level: scaled size, window stride, windows per frame
    (oh x ow) and the scale factor."""
    sh: int
    sw: int
    stride: int
    oh: int
    ow: int
    factor: float


class PendingDetect(NamedTuple):
    """In-flight detect: the candidate array (pinned host memory on the
    card, its copy behind ``event``), the frames kept for the dense
    fallback, the plan, and the frame count. Returned by ``detect_begin``."""
    packed: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event]
    images: Optional[torch.Tensor]
    plan: Tuple[ScalePlan, ...]
    n_frames: int


def group_rectangles(boxes: np.ndarray, min_neighbors: int,
                     eps: float = 0.2) -> np.ndarray:
    """OpenCV-style groupRectangles: cluster similar boxes, average each
    cluster, drop clusters with <= min_neighbors members, prune averaged
    boxes contained in bigger ones (cascadedetect.cpp groupRectangles)."""
    n = len(boxes)
    if n == 0:
        return np.zeros((0, 4), np.float32)
    parent = np.arange(n)

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    # pairwise similarity vectorised; same predicate, same union order
    # (upper triangle, row-major) as a pairwise loop
    b = np.asarray(boxes, np.float32)
    delta = eps * 0.5 * (np.minimum(b[:, 2:3], b[None, :, 2])
                         + np.minimum(b[:, 3:4], b[None, :, 3]))
    x2 = b[:, 0] + b[:, 2]
    y2 = b[:, 1] + b[:, 3]
    sim = ((np.abs(b[:, 0:1] - b[None, :, 0]) <= delta)
           & (np.abs(b[:, 1:2] - b[None, :, 1]) <= delta)
           & (np.abs(x2[:, None] - x2[None, :]) <= delta)
           & (np.abs(y2[:, None] - y2[None, :]) <= delta))
    for i, j in np.argwhere(np.triu(sim, 1)):
        pi, pj = find(i), find(j)
        if pi != pj:
            parent[pj] = pi
    roots = np.array([find(i) for i in range(n)])
    out, counts = [], []
    for r in np.unique(roots):
        members = b[roots == r]
        if len(members) <= min_neighbors:
            continue
        out.append(members.mean(axis=0))
        counts.append(len(members))
    if not out:
        return np.zeros((0, 4), np.float32)
    out = np.stack(out)
    # prune a grouped box contained inside a bigger one when the big
    # cluster clearly dominates OR the small one is weak (< 3 members):
    # OpenCV's `n2 > max(3, n1) || n1 < 3` clause, tested against every
    # other cluster regardless of its own fate
    keep = np.ones(len(out), bool)
    for i in range(len(out)):
        for j in range(len(out)):
            if i == j:
                continue
            dx, dy = out[j, 2] * 0.2, out[j, 3] * 0.2
            if (out[i, 0] >= out[j, 0] - dx
                    and out[i, 1] >= out[j, 1] - dy
                    and out[i, 0] + out[i, 2] <= out[j, 0] + out[j, 2] + dx
                    and out[i, 1] + out[i, 3] <= out[j, 1] + out[j, 3] + dy
                    and (counts[j] > max(3, counts[i]) or counts[i] < 3)):
                keep[i] = False
                break
    return out[keep]


class _Bank(NamedTuple):
    """Trees [lo, hi) and stages [s_lo, s_hi) of a cascade on the device:
    banks (D, T), thresholds, flip, leaves (T, 3), and each stage's member
    trees (T, S) and threshold (S,) in float64."""
    bank0: torch.Tensor
    bank1: torch.Tensor
    thresh0: torch.Tensor
    thresh1: torch.Tensor
    flip0: torch.Tensor
    leaves: torch.Tensor
    members: torch.Tensor
    stage_thresholds: torch.Tensor


def _bank(d: HaarCascadeData, s_lo: int, s_hi: int, device) -> _Bank:
    lo, hi = int(d.stage_bounds[s_lo]), int(d.stage_bounds[s_hi])
    members = np.zeros((hi - lo, s_hi - s_lo), np.float64)
    for si in range(s_lo, s_hi):
        members[d.stage_bounds[si] - lo:d.stage_bounds[si + 1] - lo,
                si - s_lo] = 1.0

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return _Bank(dev(d.bank0[:, lo:hi]), dev(d.bank1[:, lo:hi]),
                 dev(d.thresh0[lo:hi]), dev(d.thresh1[lo:hi]),
                 dev(d.flip0[lo:hi]), dev(d.leaves[lo:hi]), dev(members),
                 dev(d.stage_thresholds[s_lo:s_hi].astype(np.float64)))


def _stage_pass(p: torch.Tensor, nf: torch.Tensor, bank: _Bank
                ) -> torch.Tensor:
    """AND of the bank's stage decisions for window rows ``p``: the leaf
    value of every tree (the two bank products, ``raw < thresh * nf``, the
    ``flip0`` XOR), each stage's leaf sum in float64 against its
    threshold."""
    with record_function("facedetect.products"), float32_matmul():
        raw0 = torch.matmul(p, bank.bank0)                 # (N, T)
        raw1 = torch.matmul(p, bank.bank1)
    with record_function("facedetect.stages"):
        nfc = nf[:, None]
        # flip0: trees whose TRUE branch descends to node 1 (swapped
        # children in the XML): XOR the node-0 comparison so that True
        # always means leaf 0
        cond0 = torch.logical_xor(raw0 < bank.thresh0 * nfc, bank.flip0)
        leaf = torch.where(cond0, bank.leaves[:, 0],
                           torch.where(raw1 < bank.thresh1 * nfc,
                                       bank.leaves[:, 1], bank.leaves[:, 2]))
        sums = torch.matmul(leaf.double(), bank.members)   # (N, S)
        return (sums >= bank.stage_thresholds).all(dim=1)


class HaarCascadeDetector:
    """detectMultiScale-equivalent on PyTorch, on ``device`` (CUDA unless
    the caller names one; ``utils.device.resolve_device``).

    Drop-in for the reference apps' OpenCV face detection step: loads the
    same XML cascade files (``io.haar.STOCK_FRONTAL_ALT2``, or e.g.
    /usr/share/opencv4/haarcascades/haarcascade_frontalface_alt2.xml).
    """

    # windows of one evaluation (``_evaluations``): bounds the (N, T)
    # intermediates whatever the frame size or batch. At 2^18 windows the
    # rows take 420 MB and the survivors' products and leaves a few GB (a
    # call of 24 frames of 728 x 1023 peaks at 4.8 GiB on an H100)
    WINDOW_BUDGET = 1 << 18

    # candidate slots per frame in the device-side compaction buffer (4 KB
    # read back); a frame with more raw hits falls back to the dense mask
    MAX_CANDIDATES = 1 << 10

    # survivor buffer divisor of the two-phase prefilter: windows passing
    # the first N_PRE_STAGES stages are compacted into N // SURVIVOR_DIV
    # slots (at least 128) before the remaining stages run; overflow falls
    # back to the dense program (0 disables the prefilter)
    SURVIVOR_DIV = 4

    def __init__(self, cascade, scale_factor: float = 1.2,
                 min_neighbors: int = 2,
                 min_size: Tuple[int, int] = (50, 50),
                 max_size: Optional[Tuple[int, int]] = None, device=None):
        if isinstance(cascade, str):
            cascade = parse_opencv_cascade(cascade)
        self.data: HaarCascadeData = cascade
        self.scale_factor = float(scale_factor)
        self.min_neighbors = int(min_neighbors)
        self.min_size = tuple(min_size)
        self.max_size = tuple(max_size) if max_size else None
        self.device = resolve_device(device)
        # the products are exact in any order, so the CPU and the card give
        # the same boxes
        self.exact = banks_exact_in_bf16(cascade)
        d = cascade
        self._area = torch.tensor(
            float((d.window_height - 2) * (d.window_width - 2)),
            device=self.device)
        n_stages = d.num_stages
        self._n_pre = min(N_PRE_STAGES, n_stages)
        self._pre = _bank(d, 0, self._n_pre, self.device)
        self._rest = (_bank(d, self._n_pre, n_stages, self.device)
                      if self._n_pre < n_stages else None)

    # -------------------------------------------------------------- plan
    def pyramid_plan(self, h: int, w: int) -> Tuple[ScalePlan, ...]:
        """The pyramid levels of an (h, w) frame: every scale
        ``scale_factor**k`` whose window fits the frame and lies within
        ``min_size`` / ``max_size``; stride 1 above a factor of 2, else 2
        (JAX ``facedetect.py:513-554``, without its compile buckets)."""
        d = self.data
        wh, ww = d.window_height, d.window_width
        plan = []
        factor = 1.0
        while True:
            win_w = ww * factor
            win_h = wh * factor
            if win_w > w or win_h > h:
                break
            if self.max_size and (win_w > self.max_size[0]
                                  or win_h > self.max_size[1]):
                break
            sw = int(round(w / factor))
            sh = int(round(h / factor))
            if (win_w >= self.min_size[0] and win_h >= self.min_size[1]
                    and sw >= ww and sh >= wh):
                stride = 1 if factor > 2.0 else 2
                plan.append(ScalePlan(sh, sw, stride, (sh - wh) // stride + 1,
                                      (sw - ww) // stride + 1, factor))
            factor *= self.scale_factor
        return tuple(plan)

    # -------------------------------------------------------- evaluation
    def _eval_rows(self, p: torch.Tensor, s: torch.Tensor, sq: torch.Tensor,
                   survivor_div: int):
        """Cascade decision of window rows ``p`` (N, wh*ww), integer-valued
        float32, with their inner sums ``s`` and ``sq`` (``inner_sums``):
        the first stages on every row, the rest on the survivors compacted
        into max(128, N // survivor_div) slots (0: on every row). Returns
        ((N,) bool pass mask, 0-d bool tensor: the survivor buffer
        overflowed, and the mask is then only right where the first stages
        failed)."""
        n = p.shape[0]
        dev = p.device
        with record_function("facedetect.norm"):
            # variance norm factor nf = sqrt(area*sumsq - sum^2), or 1 if
            # non-positive, in float32 as JAX computes it
            var = self._area * sq - s * s
            nf = torch.where(var > 0.0, torch.sqrt(torch.clamp(var, min=0.0)),
                             torch.ones_like(var))
        passed = _stage_pass(p, nf, self._pre)
        no_overflow = torch.zeros((), dtype=torch.bool, device=dev)
        if self._rest is None:
            return passed, no_overflow
        k = max(128, n // survivor_div) if survivor_div > 0 else n
        if k >= n:
            return passed & _stage_pass(p, nf, self._rest), no_overflow
        with record_function("facedetect.compaction"):
            # the survivors' indices in order, in k slots, on the device;
            # unused slots point at row 0 and are masked below
            rank = torch.cumsum(passed, 0) - 1
            n_surv = rank[-1] + 1
            slot = torch.where(passed & (rank < k), rank,
                               torch.full_like(rank, k))
            idx = torch.zeros(k + 1, dtype=torch.int64, device=dev).scatter_(
                0, slot, torch.arange(n, device=dev))[:k]
            p_sel = torch.index_select(p, 0, idx)
            nf_sel = torch.index_select(nf, 0, idx)
        passed_sel = _stage_pass(p_sel, nf_sel, self._rest)
        with record_function("facedetect.compaction"):
            valid = torch.arange(k, device=dev) < n_surv
            rest = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce_(
                0, idx, (passed_sel & valid).int(), reduce="amax")
            return passed & rest.bool(), n_surv > k

    def _evaluations(self, n_frames: int, plan: Tuple[ScalePlan, ...]):
        """The pieces (f0, f1, level, r0, r1) of each evaluation: frames
        f0..f1-1, output rows r0..r1-1 of a level. An evaluation holds
        whole frames, every level of each, as many as WINDOW_BUDGET takes,
        so that its survivors average over the pyramid (the small levels
        pass the first stages more often than the large ones); a frame
        whose pyramid exceeds the budget is cut into bands of a level's
        rows, packed in order up to the budget."""
        per_frame = sum(s.oh * s.ow for s in plan)
        if per_frame <= self.WINDOW_BUDGET:
            step = min(n_frames, self.WINDOW_BUDGET // per_frame)
            for f0 in range(0, n_frames, step):
                f1 = min(n_frames, f0 + step)
                yield [(f0, f1, li, 0, s.oh) for li, s in enumerate(plan)]
            return
        for f in range(n_frames):
            pieces, size = [], 0
            for li, s in enumerate(plan):
                rows = max(1, self.WINDOW_BUDGET // s.ow)
                for r0 in range(0, s.oh, rows):
                    r1 = min(s.oh, r0 + rows)
                    if pieces and size + (r1 - r0) * s.ow > self.WINDOW_BUDGET:
                        yield pieces
                        pieces, size = [], 0
                    pieces.append((f, f + 1, li, r0, r1))
                    size += (r1 - r0) * s.ow
            yield pieces

    def _pyramid(self, images: torch.Tensor, plan: Tuple[ScalePlan, ...],
                 survivor_div: int):
        """Every level of a (B, H, W) float32 stack: resize, window rows in
        evaluations of at most WINDOW_BUDGET windows (``_evaluations``), the
        cascade. Returns ((B, total) bool mask, levels in plan order, each
        row-major; (B,) bool: an evaluation holding the frame overflowed its
        survivor buffer)."""
        d = self.data
        wh, ww = d.window_height, d.window_width
        b = images.shape[0]
        offsets = np.cumsum([0] + [s.oh * s.ow for s in plan])
        flat = torch.empty((b, int(offsets[-1])), dtype=torch.bool,
                           device=images.device)
        overflow = torch.zeros(b, dtype=torch.bool, device=images.device)
        with record_function("facedetect.resize"):
            levels = [resize_round(images, s.sh, s.sw) for s in plan]
        with record_function("facedetect.norm"):
            sums = [inner_sums(lv, wh, ww, s.stride)
                    for lv, s in zip(levels, plan)]
        for pieces in self._evaluations(b, plan):
            with record_function("facedetect.unfold"):
                views = [windows(levels[li], wh, ww, plan[li].stride)[
                    f0:f1, r0:r1] for f0, f1, li, r0, r1 in pieces]
                sizes = [v.shape[0] * v.shape[1] * v.shape[2] for v in views]
                p = torch.empty((sum(sizes), wh * ww), device=images.device)
                at = 0
                for v, n in zip(views, sizes):
                    p[at:at + n].view(v.shape).copy_(v)
                    at += n
                del views
                s, sq = torch.cat([sums[li][:, f0:f1, r0:r1].reshape(2, -1)
                                   for f0, f1, li, r0, r1 in pieces], dim=1)
            passed, ovf = self._eval_rows(p, s, sq, survivor_div)
            del p
            overflow[pieces[0][0]:pieces[-1][1]] |= ovf
            at = 0
            for (f0, f1, li, r0, r1), n in zip(pieces, sizes):
                lo = int(offsets[li]) + r0 * plan[li].ow
                flat[f0:f1, lo:lo + n // (f1 - f0)] = \
                    passed[at:at + n].view(f1 - f0, -1)
                at += n
        return flat, overflow

    def _pack(self, flat: torch.Tensor, overflow: torch.Tensor
              ) -> torch.Tensor:
        """(B, K + 2) int32 on the device: each frame's first K candidate
        indices (-1 past its count), its count, and its overflow flag."""
        k = self.MAX_CANDIDATES
        b, total = flat.shape
        with record_function("facedetect.compaction"):
            rank = torch.cumsum(flat, 1) - 1
            count = rank[:, -1] + 1
            slot = torch.where(flat & (rank < k), rank,
                               torch.full_like(rank, k))
            idx = torch.arange(total, dtype=torch.int32,
                               device=flat.device).expand(b, total)
            packed = torch.full((b, k + 1), -1, dtype=torch.int32,
                                device=flat.device).scatter_(1, slot, idx)
            return torch.cat([packed[:, :k], count[:, None].int(),
                              overflow[:, None].int()], dim=1)

    # ----------------------------------------------------------- decode
    def _boxes(self, plan: Tuple[ScalePlan, ...], sel: np.ndarray
               ) -> np.ndarray:
        """Flat window indices of one frame -> (K, 4) float32 [x, y, w, h]
        raw boxes (JAX ``facedetect.py:633-642``)."""
        d = self.data
        offsets = np.cumsum([0] + [s.oh * s.ow for s in plan])
        pw = np.asarray([s.ow for s in plan], np.int64)
        stride = np.asarray([s.stride for s in plan], np.int64)
        factor = np.asarray([s.factor for s in plan], np.float64)
        pid = np.searchsorted(offsets, sel, side="right") - 1
        local = sel - offsets[pid]
        ys = local // pw[pid]
        xs = local % pw[pid]
        sf = stride[pid] * factor[pid]
        return np.stack([
            np.round(xs * sf), np.round(ys * sf),
            np.round(d.window_width * factor[pid]),
            np.round(d.window_height * factor[pid])],
            axis=1).astype(np.float32)

    def _decode(self, pend: PendingDetect) -> List[np.ndarray]:
        """Wait for one candidate read-back and decode boxes (with the dense
        fallback and grouping)."""
        if pend.packed is None:
            return [np.zeros((0, 4), np.float32)] * pend.n_frames
        if pend.event is not None:
            pend.event.synchronize()
        with record_function("facedetect.decode"):
            packed = pend.packed.numpy()
            counts = packed[:, -2].astype(np.int64)
            # overflow (candidate buffer or survivor prefilter): those
            # frames' dense masks, evaluated again and read back whole
            redo = np.nonzero((counts > self.MAX_CANDIDATES)
                              | (packed[:, -1] != 0))[0]
            dense = {}
            if len(redo):
                masks = self._pyramid(
                    pend.images[torch.from_numpy(redo).to(pend.images.device)],
                    pend.plan, 0)[0].cpu().numpy()
                dense = dict(zip(redo.tolist(), masks))
            raws = []
            for fi in range(pend.n_frames):
                sel = (np.nonzero(dense[fi])[0] if fi in dense
                       else packed[fi, :counts[fi]].astype(np.int64))
                raws.append(self._boxes(pend.plan, sel) if len(sel)
                            else np.zeros((0, 4), np.float32))
            if self.min_neighbors > 0:
                return [group_rectangles(r, self.min_neighbors)
                        for r in raws]
            return raws

    # ------------------------------------------------------ entry points
    def _frames(self, images, ndim: int) -> torch.Tensor:
        """A (H, W) frame or (B, H, W) stack (numpy or a tensor on any
        device, any integer-valued dtype) as a (B, H, W) float32 tensor on
        the detector's device."""
        if isinstance(images, np.ndarray):
            images = np.ascontiguousarray(images)
        x = torch.as_tensor(images)
        if x.ndim != ndim:
            raise ValueError("expected a (H, W) grayscale image" if ndim == 2
                             else "expected a (B, H, W) grayscale stack")
        if self.device.type == "cuda" and x.device.type == "cpu":
            # through pinned memory, so that the upload does not wait for
            # the work already queued on the card (detect_stream)
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = x.to(self.device).float()
        return x[None] if ndim == 2 else x

    def _dispatch(self, images: torch.Tensor) -> PendingDetect:
        """Enqueue the whole pyramid for a (B, H, W) stack and start the
        candidate read-back; returns without waiting for the device."""
        b, h, w = images.shape
        plan = self.pyramid_plan(h, w)
        if not plan:
            return PendingDetect(None, None, None, (), b)
        flat, overflow = self._pyramid(images, plan, self.SURVIVOR_DIV)
        packed = self._pack(flat, overflow)
        if packed.device.type != "cuda":
            return PendingDetect(packed, None, images, plan, b)
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return PendingDetect(host, event, images, plan, b)

    def detect(self, image) -> np.ndarray:
        """Detect objects in a (H, W) grayscale image (numpy or tensor).

        Returns (K, 4) float32 [x, y, w, h] boxes in image coordinates
        (grouped, like OpenCV's detectMultiScale; raw boxes with
        ``min_neighbors=0``).
        """
        return self._decode(self._dispatch(self._frames(image, 2)))[0]

    def detect_batch(self, images) -> List[np.ndarray]:
        """Detect objects in a (B, H, W) stack of same-shape grayscale
        frames: one pass over the pyramid for the whole stack and ONE
        device-to-host candidate read-back (reference: rcr-train.cpp:410
        re-detects every training image through cv::detectMultiScale).

        Returns a list of B (K_i, 4) float32 [x, y, w, h] boxes.
        """
        return self._decode(self._dispatch(self._frames(images, 3)))

    def detect_begin(self, image) -> PendingDetect:
        """Asynchronous half of :meth:`detect`: enqueue the pyramid of one
        (H, W) frame and the non-blocking copy of its candidates into
        pinned host memory, and return at once. Fetch the boxes with
        :meth:`detect_end`."""
        return self._dispatch(self._frames(image, 2))

    def detect_end(self, pending: PendingDetect) -> np.ndarray:
        """Wait for a :meth:`detect_begin` handle's copy and decode it: the
        boxes ``detect`` would have returned."""
        return self._decode(pending)[0]

    def detect_stream(self, frames: Iterable,
                      depth: int = 4) -> Iterator[np.ndarray]:
        """Pipelined single-frame detection over a frame iterable (a video
        sweep): yields each frame's boxes in order, keeping ``depth``
        detects in flight. Each frame's candidates are copied into pinned
        host memory behind an event of their own at dispatch, and decoded
        ``depth`` frames later, so the host enqueues the next frames while
        the card works. The boxes are the same for every depth; frames may
        differ in shape."""
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        window = collections.deque()
        for frame in frames:
            window.append(self.detect_begin(frame))
            if len(window) > depth:
                yield self.detect_end(window.popleft())
        while window:
            yield self.detect_end(window.popleft())
