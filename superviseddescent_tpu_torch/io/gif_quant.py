"""PIL's median-cut quantiser (the Python twin): ``convert("P",
palette=Image.Palette.ADAPTIVE)`` of an RGB image.

That call is libImaging's ``quantize`` (``Quant.c``) with method 0 (median
cut), 256 colours and no k-means. In its order:

1. The distinct colours are counted in a hash that holds at most 65,536
   of them: while there are more, each channel drops one more low bit
   (``scale``), and the colours that then agree are counted as one. The
   hash compares colours by ``PIXEL_HASH``, which is one-to-one on 8-bit
   triples, so a dict keyed by the scaled colour is the same table.
2. Median cut on the scaled colours. The boxes live in a binary max-heap
   ordered by their pixel count (``box_heap_cmp``; ties left where the
   heap's sift leaves them); 255 times the top box is taken (one of volume
   1, a single colour, is dropped from the heap and stays a leaf) and split
   along the axis whose range weighted 77 / 150 / 29 is largest (the
   first such). The colours sorted by that channel, largest
   first, go left until more than half the box's pixels are there, with
   every colour that ties the last one taken; if none are left over, the
   colours of the smallest value go right instead.
3. The leaves, left to right, are the palette's entries; each entry is the
   mean of the original pixels of its leaf, rounded half up.
4. Each pixel's index is the entry nearest to it (squared distance),
   its own leaf's entry kept on a tie; among other entries at the same
   distance the one nearest its leaf's entry, then the lowest index (the
   stable sort of ``build_distance_tables``).

``csrc/gif_encode.cu`` holds the same steps in C++ for the card's path.
"""

from __future__ import annotations

import numpy as np

MAX_HASH_ENTRIES = 65536
COLOURS = 256
# the weights of the axis choice (libImaging's ``split``)
AXIS_WEIGHTS = (77, 150, 29)


def _pack(rgb: np.ndarray) -> np.ndarray:
    return ((rgb[:, 0].astype(np.uint32) << 16)
            | (rgb[:, 1].astype(np.uint32) << 8) | rgb[:, 2])


def _unpack(v: np.ndarray) -> np.ndarray:
    return np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255],
                    axis=1).astype(np.int64)


def _scale(colours: np.ndarray) -> int:
    """The bits each channel drops so that at most 65,536 colours stay."""
    s = 0
    while len(np.unique(_pack(colours >> s))) > MAX_HASH_ENTRIES:
        s += 1
    return s


class _Box:
    __slots__ = ("members", "count", "volume", "left", "right")

    def __init__(self, members: np.ndarray, count: int, scaled: np.ndarray):
        self.members, self.count = members, count
        self.left = self.right = None
        c = scaled[members]
        self.volume = int(np.prod(c.max(0) - c.min(0) + 1))


def _heap_add(heap: list, box: _Box):
    """libImaging's ``ImagingQuantHeapAdd`` (1-based, max by pixel
    count)."""
    heap.append(None)
    k = len(heap) - 1
    while k != 1:
        if box.count - heap[k // 2].count <= 0:
            break
        heap[k] = heap[k // 2]
        k >>= 1
    heap[k] = box


def _heap_remove(heap: list) -> _Box | None:
    """libImaging's ``ImagingQuantHeapRemove``."""
    if len(heap) == 1:
        return None
    top = heap[1]
    v = heap.pop()
    n = len(heap) - 1
    if n == 0:
        return top
    k = 1
    while k * 2 <= n:
        child = k * 2
        if child < n and heap[child].count - heap[child + 1].count < 0:
            child += 1
        if v.count - heap[child].count > 0:
            break
        heap[k] = heap[child]
        k = child
    heap[k] = v
    return top


def _split(box: _Box, scaled: np.ndarray, counts: np.ndarray):
    """libImaging's ``split`` and ``splitlists``: the left (larger values)
    and right members of ``box``."""
    c = scaled[box.members]
    ranges = (c.max(0) - c.min(0)) * np.array(AXIS_WEIGHTS)
    axis = int(np.argmax(ranges))
    values = c[:, axis]
    order = np.argsort(-values, kind="stable")
    v = values[order]
    cum = np.cumsum(counts[box.members][order])
    k = int(np.argmax(cum * 2 > box.count)) if cum[-1] * 2 > box.count \
        else len(v) - 1
    n_left = int(np.searchsorted(-v, -v[k], side="right"))
    if n_left == len(v):
        n_left = int(np.searchsorted(-v, -v[-1], side="left"))
    return box.members[order[:n_left]], box.members[order[n_left:]]


def _median_cut(scaled: np.ndarray, counts: np.ndarray, total: int) -> list:
    """The leaves of the median-cut tree, left to right: arrays of indices
    into ``scaled``."""
    root = _Box(np.arange(len(scaled)), total, scaled)
    heap = [None]
    _heap_add(heap, root)
    for _ in range(COLOURS - 1):
        while True:
            box = _heap_remove(heap)
            if box is None or box.volume != 1:
                break
        if box is None:
            break
        lm, rm = _split(box, scaled, counts)
        box.left = _Box(lm, int(counts[lm].sum()), scaled)
        box.right = _Box(rm, int(counts[rm].sum()), scaled)
        _heap_add(heap, box.left)
        _heap_add(heap, box.right)
    leaves, stack = [], [root]
    while stack:
        b = stack.pop()
        if b.left is None:
            leaves.append(b.members)
        else:
            stack += [b.right, b.left]
    return leaves


def nearest(colours: np.ndarray, palette: np.ndarray, own: np.ndarray,
            chunk: int = 4096) -> np.ndarray:
    """Each colour's index as ``map_image_pixels_from_median_box`` picks
    it: the nearest palette entry, ``own`` (its leaf's entry) on a tie,
    else the tied entry nearest ``own``'s entry, then the lowest index."""
    pal = palette.astype(np.int64)
    n = len(pal)
    between = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    out = np.empty(len(colours), np.int64)
    idx = np.arange(n)
    for s in range(0, len(colours), chunk):
        c = colours[s:s + chunk].astype(np.int64)
        o = own[s:s + chunk]
        d = ((c[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
        rank = between[o] + 1
        rank[np.arange(len(o)), o] = 0
        key = (d << 26) | (rank << 8) | idx[None, :]
        out[s:s + chunk] = key.argmin(1)
    return out


def quantize(rgb: np.ndarray):
    """uint8 (H, W, 3) -> (palette uint8 (n, 3), indices uint8 (H, W)):
    PIL's ``convert("P", palette=ADAPTIVE)``, its palette as
    ``getpalette()`` gives it (n entries, n <= 256)."""
    h, w = rgb.shape[:2]
    flat = _pack(rgb.reshape(-1, 3))
    distinct, inverse = np.unique(flat, return_inverse=True)
    colours = _unpack(distinct)
    s = _scale(colours)
    skeys, sinv = np.unique(_pack(colours >> s), return_inverse=True)
    scaled = _unpack(skeys)
    pix_count = np.bincount(inverse, minlength=len(distinct))
    counts = np.bincount(sinv, weights=pix_count,
                         minlength=len(skeys)).astype(np.int64)
    leaves = _median_cut(scaled, counts, h * w)
    leaf_of = np.empty(len(skeys), np.int64)
    for i, members in enumerate(leaves):
        leaf_of[members] = i
    own = leaf_of[sinv]                       # per distinct colour
    n = len(leaves)
    total = np.stack([np.bincount(own, weights=pix_count * colours[:, k],
                                  minlength=n) for k in range(3)], 1)
    num = np.bincount(own, weights=pix_count, minlength=n)
    palette = np.floor(0.5 + total / num[:, None]).astype(np.uint8)
    index = nearest(colours, palette, own)
    return palette, index[inverse].astype(np.uint8).reshape(h, w)
