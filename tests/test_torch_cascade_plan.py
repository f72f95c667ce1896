"""The host side of K3 / K4's launch plan (``ops/cascade_fused.py``).

``_shared_bytes`` mirrors the shared-memory layout of
``csrc/cascade_fused.cu`` (its ``Layout``); ``launch_plan`` picks the faces
per block, the landmarks per group and the threads per block from the
batch, the family, the 232,448 bytes a block may use and the blocks an SM
holds. The kernel itself runs on the card only
(``tests/test_torch_kernels_gpu.py``).
"""

import pytest

from superviseddescent_tpu_torch.ops.cascade_fused import (
    _MAX_FACES, _MAX_SHARED, _PLANS, LaunchPlan, _shared_bytes,
    blocks_per_sm, launch_plan)

SMS = 132  # an H100 SXM
SM_SHARED = 233472  # 228 KB of shared memory an SM, 1 KB of it per block


def a16(nbytes):
    return -(-nbytes // 16) * 16


def layout_by_hand(l, c, s, quantize, faces, group, threads):
    """The kernel's Layout written out buffer by buffer."""
    bodies = faces * group
    slices = 5  # GEMV slices of a row, every family and plan
    block = (a16(s * c * 4)                       # tent
             + a16(faces * 2 * l * 4)             # landmark rows
             + a16(slices * faces * 2 * l * 4)    # GEMV partial sums
             + a16(faces * 8) * 3                 # ied/phw, window, stride
             + a16(bodies * 8))                   # sub-window origins
    taps = bodies * 6 * a16(s * 4)
    block += max(taps, 8 * threads * 4)           # or the x accumulators
    patch = s * s * (1 if quantize else 4)
    cells = a16(8 * c * c * 4) + a16(4 * c * c * 4)
    body = (a16(max(patch, 8 * c * s * 2)) + a16(max(s * s * 2, cells))
            + a16(s * s) + a16(16 * c * c * 2))
    return block + bodies * body


@pytest.mark.parametrize("l", [6, 22, 29, 68])
@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("faces,group,threads", [
    (1, 1, 256), (2, 1, 256), (1, 4, 256), (2, 2, 256), (1, 8, 1024),
    (2, 5, 256)])
def test_shared_bytes_is_the_kernel_layout(l, quantize, faces, group,
                                           threads):
    for c, s in ((5, 55), (3, 24), (8, 96)):
        assert _shared_bytes(l, c, s, quantize, faces, group, threads) == \
            layout_by_hand(l, c, s, quantize, faces, group, threads)


@pytest.mark.parametrize("l", [22, 29, 68])
@pytest.mark.parametrize("quantize", [True, False])
def test_plan_per_family(l, quantize):
    plan = launch_plan(4096, l, 5, 55, quantize, SMS)
    assert isinstance(plan, LaunchPlan)
    assert (plan.faces, plan.group, plan.threads) == (_MAX_FACES, 1, 256)
    assert plan.shared_bytes == _shared_bytes(l, 5, 55, quantize,
                                              plan.faces, plan.group, 256)
    # quantised, four blocks share an SM: 32 warps
    if quantize:
        assert 4 * (plan.shared_bytes + 1024) <= SM_SHARED
        assert blocks_per_sm(plan) == 4
    for n in (1, SMS):   # SMs left idle: one face, 1,024 threads
        plan = launch_plan(n, l, 5, 55, quantize, SMS)
        assert (plan.faces, plan.threads) == (1, 1024)
        assert plan.shared_bytes <= _MAX_SHARED
        check_fewest_even_groups(plan, l, 5, 55, quantize)
    if quantize:  # RCR-22 in two groups of 11, COFW-29 in three
        assert launch_plan(1, l, 5, 55, True, SMS).group == {
            22: 11, 29: 10, 68: 12}[l]


def check_fewest_even_groups(plan, l, c, s, quantize):
    """The latency plan's groups: as few as fit, as even as they can be."""
    groups = -(-l // plan.group)
    assert -(-l // groups) == plan.group
    if groups > 1:
        wider = -(-l // (groups - 1))
        assert _shared_bytes(l, c, s, quantize, 1, wider,
                             1024) > _MAX_SHARED


@pytest.mark.parametrize("l", [22, 29, 68])
def test_plan_runs_the_batch_in_one_wave(l):
    """Past the SM count the batch takes the plan with the fewest faces
    per block, then the most landmarks in flight per face, whose blocks
    are all resident at once: one face with four landmarks up to three
    blocks an SM, with two up to four, then two faces a block with two
    landmarks (three blocks an SM) and with one (the crossovers measured
    on the H100)."""
    expected = {SMS + 1: (1, 4), 3 * SMS: (1, 4), 3 * SMS + 1: (1, 2),
                4 * SMS: (1, 2), 4 * SMS + 1: (2, 2), 6 * SMS: (2, 2),
                6 * SMS + 1: (2, 1), 8 * SMS: (2, 1), 8 * SMS + 1: (2, 1),
                4096: (2, 1)}
    for n, (faces, group) in expected.items():
        plan = launch_plan(n, l, 5, 55, True, SMS)
        assert (plan.faces, plan.group, plan.threads) == (faces, group, 256)
        if n <= 8 * SMS:
            assert -(-n // faces) <= blocks_per_sm(plan) * SMS


def test_plan_group_never_exceeds_the_landmarks():
    assert launch_plan(1, 6, 3, 24, True, SMS)[:3] == (1, 6, 1024)
    assert launch_plan(SMS + 1, 6, 3, 24, True, SMS)[:3] == (1, 4, 256)
    assert launch_plan(SMS + 1, 3, 3, 24, True, SMS)[:3] == (1, 3, 256)
    assert launch_plan(4096, 6, 3, 24, True, SMS)[:3] == (2, 1, 256)
    assert max(faces for faces, _, _ in _PLANS) == _MAX_FACES


def test_plan_shrinks_to_what_fits():
    # S = 96, C = 24, float32 patches: 92,160 bytes a body
    l, c, s = 22, 24, 96
    assert _shared_bytes(l, c, s, False, 1, 4) > _MAX_SHARED
    for n in (1, SMS, SMS + 1, 4096):
        plan = launch_plan(n, l, c, s, False, SMS)
        assert plan.shared_bytes <= _MAX_SHARED
        assert plan.faces * plan.group <= 2
    # one block an SM: 133 faces of one per block would need a second
    # wave, so two faces share a block
    assert launch_plan(SMS + 1, l, c, s, False, SMS)[:3] == (2, 1, 256)
    plan = launch_plan(1, l, c, s, False, SMS)
    assert plan.threads == 1024 and plan.shared_bytes <= _MAX_SHARED
    check_fewest_even_groups(plan, l, c, s, False)


def test_plan_names_a_shape_that_does_not_fit():
    # the landmark rows alone exceed a block: 20,000 landmarks
    with pytest.raises(ValueError, match="232448"):
        launch_plan(1, 20000, 5, 55, True, SMS)
    with pytest.raises(ValueError, match="need .* bytes of shared memory"):
        launch_plan(4096, 20000, 5, 55, True, SMS)
