"""The host side of K5 / K6's design (``ops/cascade_fused.py``).

``_features_shared_bytes`` mirrors the shared-memory layout of
``csrc/features_fused.cu`` (its ``Layout``); ``features_launch_plan`` picks
the samples per block, the landmarks per group and the threads per block
(the choices measured fastest on the H100, ``chip_smoke.py --k5 --sweep``);
the cell table the kernel builds for the gradients' x contraction holds at
most two cells per pixel column. The kernel itself runs on the card only
(``tests/test_torch_kernels_gpu.py``).
"""

import pytest

from superviseddescent_tpu_torch.ops.cascade_fused import (
    _MAX_SHARED, LaunchPlan, _features_shared_bytes, features_blocks_per_sm,
    features_launch_plan)
from superviseddescent_tpu_torch.ops.hog import hog_num_cells

SMS = 132  # an H100 SXM
SM_SHARED = 233472  # 228 KB of shared memory an SM, 1 KB of it per block
# (L, S, cell size) of the families' levels and of the largest patch side
SHAPES = {"rcr22": (22, ((55, 11), (50, 10), (40, 8), (30, 6))),
          "cofw29": (29, ((55, 11), (50, 10), (40, 8), (30, 6))),
          "ibug68": (68, ((55, 11), (50, 10), (40, 8), (30, 6))),
          "s96": (22, ((96, 4), (96, 16)))}


def a16(nbytes):
    return -(-nbytes // 16) * 16


def layout_by_hand(c, s, faces, group, threads):
    """The kernel's Layout written out buffer by buffer."""
    bodies, cc = faces * group, c * c
    block = (a16(s * c * 4)            # tent
             + s * 16 + a16(s * 8)      # cell table: offsets, weights
             + 16                       # flag: a cell without pixels
             + a16(faces * 4)           # patch halves
             + a16(faces * 8) * 2       # windows, strides
             + a16(bodies * 8)          # sub-window origins
             + 16 * 4 * threads)        # x contraction accumulators
    taps = 2 * a16(16 * s)  # per row and column: offset, two weights
    part = 8 * c * s * 2
    later = a16(8 * cc * 4) + a16(4 * cc * 4) + a16(16 * cc * 4)
    body = a16(max(taps, part)) + a16(max(s * s, later))
    return block + bodies * body


@pytest.mark.parametrize("family", list(SHAPES))
def test_shared_bytes_is_the_kernel_layout(family):
    _, levels = SHAPES[family]
    for s, cs in levels:
        c = hog_num_cells(s, cs)
        for faces, group, threads in ((1, 1, 128), (1, 5, 256), (2, 3, 256),
                                      (1, 11, 256), (3, 7, 256)):
            assert _features_shared_bytes(c, s, faces, group, threads) == \
                layout_by_hand(c, s, faces, group, threads)


@pytest.mark.parametrize("family", ["rcr22", "cofw29", "ibug68"])
@pytest.mark.parametrize("n", [1, 384, 512, 4096, 11264])
def test_plan_per_family(family, n):
    """At every training level: one sample a block; groups of one round
    (a group's patch rows fit in the block's threads) as even as their
    count allows; the batch in one wave when it fits in one at all."""
    l, levels = SHAPES[family]
    for s, cs in levels:
        c = hog_num_cells(s, cs)
        plan = features_launch_plan(n, l, c, s, SMS)
        assert isinstance(plan, LaunchPlan)
        assert plan.faces == 1 and plan.threads in (128, 256)
        assert 1 <= plan.group <= l and plan.group * s <= plan.threads
        rounds = -(-l // plan.group)
        assert -(-l // rounds) == plan.group      # even groups
        assert plan.shared_bytes == _features_shared_bytes(
            c, s, 1, plan.group, plan.threads) <= _MAX_SHARED
        slots = features_blocks_per_sm(plan) * SMS
        assert slots >= n or features_blocks_per_sm(plan) >= 4
        # 128-thread blocks only where three patch rows fit and the batch
        # fills the card with them
        assert (plan.threads == 128) == (s <= 42 and n > 8 * SMS)


def test_plan_at_the_training_levels():
    """RCR-22 at 11,264 samples (one launch a level of train_rcr), at 512
    (the windows path's chunks) and at 384 (its last chunk): (threads,
    group) per level, S = 55, 50, 40, 30."""
    def plans(n):
        return [tuple(features_launch_plan(n, 22, 5, s, SMS)[1:3])
                for s in (55, 50, 40, 30)]
    assert plans(11264) == [(4, 256), (5, 256), (3, 128), (4, 128)]
    # S = 30: eight landmarks a group would leave three blocks an SM, 396
    # slots for 512 samples (two waves); six leave four (one wave)
    assert plans(512) == [(4, 256), (5, 256), (6, 256), (6, 256)]
    assert plans(384) == [(4, 256), (5, 256), (6, 256), (8, 256)]
    # ibug-68 at 4,096 faces: 68 = 17 x 4, 14 x 5 - 2, 23 x 3 - 1
    assert [features_launch_plan(4096, 68, 5, s, SMS).group
            for s in (55, 50, 40, 30)] == [4, 5, 3, 4]


def test_plan_at_the_largest_patch_and_what_does_not_fit():
    # S = 96 with 4-pixel cells: 24 x 24 cells, 47 KB of channels a body
    plan = features_launch_plan(4096, 22, 24, 96, SMS)
    assert plan.shared_bytes <= _MAX_SHARED and plan.group == 2
    assert features_blocks_per_sm(plan) == 1
    assert features_launch_plan(4096, 22, 6, 96, SMS)[1:3] == (2, 256)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        features_launch_plan(1, 22, 80, 96, SMS)


def support(k, cs, s):
    """csrc/cascade_body.cuh's tent support of cell k: [lo, hi]."""
    a, b = (2 * k - 1) * cs - 1, (2 * k + 3) * cs - 1
    lo = a // 2 + 1 if a >= 0 else 0
    return max(lo, 1), min((b - 1) // 2, s - 2)


@pytest.mark.parametrize("s,cs", [(55, 11), (50, 10), (40, 8), (30, 6),
                                  (24, 8), (96, 4), (96, 16), (17, 3)])
def test_cell_table_has_at_most_two_cells_a_column(s, cs):
    """The kernel's per-column cell table: every interior pixel column lies
    in the tent support of one or two cells, two neighbours, and each cell
    with pixels ends at exactly one column (where its sums are rounded)."""
    c = hog_num_cells(s, cs)
    sup = [support(k, cs, s) for k in range(c)]
    for px in range(s):
        cells = [k for k, (lo, hi) in enumerate(sup) if lo <= px <= hi]
        assert len(cells) <= 2
        assert len(cells) < 2 or cells[1] == cells[0] + 1
        if 1 <= px <= s - 2:
            assert cells
    for lo, hi in sup:
        assert lo <= hi
