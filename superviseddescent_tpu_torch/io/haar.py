"""OpenCV Haar cascade XML parser (stdlib xml.etree and numpy only).

Counterpart of ``superviseddescent_tpu/io/haar.py``, copied so that the port
imports nothing of the JAX package; it gives the same ``HaarCascadeData``,
bit for bit (``tests/test_torch_facedetect.py``). The reference's apps
delegate face detection to OpenCV's ``CascadeClassifier::detectMultiScale``
with the stock ``haarcascade_frontalface_alt2.xml`` (rcr-detect.cpp:110,
rcr-train.cpp:410, rcr-track.cpp); a copy of that file ships with this
package (``STOCK_FRONTAL_ALT2``). This module reads such a "new format"
cascade file (``<cascade type_id="opencv-cascade-classifier">``, BOOST
stages, HAAR features, depth-1/2 trees, no tilted features) into dense numpy
arrays for the evaluator in ``models/facedetect.py``:

  * every Haar feature is **linear in the window pixels**, so each tree
    node's feature becomes one column of a pixel-domain weight bank
    ``(h*w, T)``, rect weights splatted over their pixel areas; the whole
    weak-classifier bank then evaluates as one matrix product of window
    rows against the bank (see facedetect.py);
  * trees are normalised to depth-2 form (node0; optional node1 on the
    right branch): single-node stumps get ``t1 = +inf`` so the vectorised
    ``where(f0 < t0, L0, where(f1 < t1, L1, L2))`` picks the right leaf.

OpenCV semantics being reproduced (modules/objdetect/src/cascadedetect.cpp):
feature value = (sum_i w_i * rectsum_i) * (1/nf) with nf the pixel-std
norm factor over the inner (1,1,w-2,h-2) rect; node comparison
``val < threshold``; stage passes when the leaf sum exceeds the stage
threshold.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from xml.etree import ElementTree

import numpy as np

#: the stock OpenCV frontal-face cascade that the reference's apps load,
#: carried with this package (licence header intact)
STOCK_FRONTAL_ALT2 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "haarcascade_frontalface_alt2.xml")


@dataclass
class HaarCascadeData:
    """Parsed cascade, ready for the batched evaluator."""
    window_width: int
    window_height: int
    # pixel-domain weight banks, (window_h * window_w, T) f32: column t is
    # tree t's node-0 (bank0) / node-1 (bank1) feature as per-pixel weights
    bank0: np.ndarray
    bank1: np.ndarray
    thresh0: np.ndarray          # (T,) node-0 thresholds
    thresh1: np.ndarray          # (T,) node-1 thresholds (+inf for stumps)
    flip0: np.ndarray            # (T,) bool: node-0's TRUE branch goes to
    #                              node 1 (children swapped) — the
    #                              evaluator XORs the comparison
    leaves: np.ndarray           # (T, 3) leaf values [L0, L1, L2] ordered
    #                              for where(c0, L0, where(c1, L1, L2))
    stage_bounds: np.ndarray     # (S+1,) tree-index boundaries per stage
    stage_thresholds: np.ndarray  # (S,)

    @property
    def num_trees(self) -> int:
        return self.bank0.shape[1]

    @property
    def num_stages(self) -> int:
        return self.stage_thresholds.shape[0]


def _feature_to_column(rects, w: int, h: int) -> np.ndarray:
    """Splat a Haar feature's weighted rects into a (h*w,) pixel vector."""
    col = np.zeros((h, w), np.float32)
    for (x, y, rw, rh, weight) in rects:
        col[y:y + rh, x:x + rw] += weight
    return col.reshape(-1)


def parse_opencv_cascade(path: str) -> HaarCascadeData:
    """Parse an OpenCV new-format Haar cascade XML file."""
    root = ElementTree.parse(path).getroot()
    casc = root.find("cascade")
    if casc is None:
        raise ValueError(
            f"{path}: not a new-format OpenCV cascade "
            "(<cascade type_id='opencv-cascade-classifier'> not found)")
    feature_type = casc.findtext("featureType", "").strip()
    if feature_type != "HAAR":
        raise ValueError(f"{path}: featureType {feature_type!r} "
                         "unsupported (only HAAR)")
    w = int(casc.findtext("width"))
    h = int(casc.findtext("height"))

    # features: list of weighted rects
    features = []
    for feat in casc.find("features"):
        rects = []
        tilted = feat.findtext("tilted")
        if tilted is not None and int(tilted):
            raise ValueError(f"{path}: tilted features unsupported")
        for r in feat.find("rects"):
            vals = r.text.split()
            x, y, rw, rh = (int(v) for v in vals[:4])
            rects.append((x, y, rw, rh, float(vals[4])))
        features.append(rects)
    feat_cols = {}

    def column(idx: int) -> np.ndarray:
        if idx not in feat_cols:
            feat_cols[idx] = _feature_to_column(features[idx], w, h)
        return feat_cols[idx]

    bank0, bank1 = [], []
    thresh0, thresh1, flip0, leaves = [], [], [], []
    stage_bounds = [0]
    stage_thresholds = []
    zero_col = np.zeros(w * h, np.float32)

    def leaf(lv, idx):
        """leafValues[-idx] for a child index idx <= 0
        (cascadedetect.cpp predictOrdered: idx = val < t ? left : right
        while idx > 0; leaf = leaves[-idx])."""
        return lv[-int(idx)]

    for stage in casc.find("stages"):
        stage_thresholds.append(float(stage.findtext("stageThreshold")))
        for weak in stage.find("weakClassifiers"):
            nodes = [float(v) for v in weak.findtext("internalNodes").split()]
            lv = [float(v) for v in weak.findtext("leafValues").split()]
            if len(nodes) == 4:
                # stump: both children are leaves
                l0, r0, fidx, t = nodes
                if l0 > 0 or r0 > 0:
                    raise ValueError(f"{path}: unexpected stump topology "
                                     f"{nodes}")
                bank0.append(column(int(fidx)))
                bank1.append(zero_col)
                thresh0.append(t)
                thresh1.append(np.inf)          # always take the L1 branch
                flip0.append(False)
                leaves.append((leaf(lv, l0), leaf(lv, r0), leaf(lv, r0)))
            elif len(nodes) == 8:
                # depth-2 tree: one child of node 0 is node 1, the other a
                # leaf (either order occurs in the stock files); node 1's
                # children are both leaves
                l0, r0, f0, t0, l1, r1, f1, t1 = nodes
                flip = (l0 == 1)                # TRUE branch -> node 1
                other = r0 if flip else l0
                if 1.0 not in (l0, r0) or other > 0 or l1 > 0 or r1 > 0:
                    raise ValueError(f"{path}: unexpected tree topology "
                                     f"{nodes}")
                leaf0 = leaf(lv, other)
                bank0.append(column(int(f0)))
                bank1.append(column(int(f1)))
                thresh0.append(t0)
                thresh1.append(t1)
                flip0.append(flip)
                leaves.append((leaf0, leaf(lv, l1), leaf(lv, r1)))
            else:
                raise ValueError(f"{path}: trees deeper than 2 unsupported "
                                 f"({len(nodes) // 4} nodes)")
        stage_bounds.append(len(thresh0))

    return HaarCascadeData(
        window_width=w,
        window_height=h,
        bank0=np.stack(bank0, axis=1).astype(np.float32),
        bank1=np.stack(bank1, axis=1).astype(np.float32),
        thresh0=np.asarray(thresh0, np.float32),
        thresh1=np.asarray(thresh1, np.float32),
        flip0=np.asarray(flip0, bool),
        leaves=np.asarray(leaves, np.float32),
        stage_bounds=np.asarray(stage_bounds, np.int32),
        stage_thresholds=np.asarray(stage_thresholds, np.float32),
    )
