"""The host side of the sampler probes' and ABDE's designs.

``probes/sampler.py``: ``shared_bytes`` mirrors the shared-memory layout of
``csrc/probe_sampler.cu`` (its ``Layout``); ``launch_plan`` picks the
patches in flight per block and the threads. ``probes/dyn.py``:
``abde_shared_bytes`` mirrors the ABDE kernel's staged sub-windows,
``abde_plan`` picks the landmarks in flight and the rows a warp stages, and
``abde_check`` raises, by name, every limit of the contract that the
kernel's launch checks; ``c_check`` does the same for C and C4, whose
contract has no scratch to bound it.
The kernels themselves run on the card only
(``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

from superviseddescent_tpu_torch.ops.cascade_fused import _MAX_SHARED
from superviseddescent_tpu_torch.probes import DYN, dyn_inputs, sampler
from superviseddescent_tpu_torch.probes.dyn import (
    ABDE_MAX_ROWS, ABDE_MAX_WARPS, C_MAX_ELEMENTS, abde_check, abde_plan,
    abde_shared_bytes, c_check, c_emulation, probe_abde, probe_c, probe_c4)

TARGETS = (32, 64, 128, 256, 512, 768, 1024)


def a16(nbytes):
    return -(-nbytes // 16) * 16


def layout_by_hand(s, group):
    """The kernel's Layout written out buffer by buffer."""
    return (a16(group * s * 16)        # row taps: offset, weights, index
            + a16(group * s * 16)      # column taps
            + a16(group * 8)           # sub-window offsets
            + a16((group * s * s + 16) * 2))  # bf16 tile from a 16-B edge


@pytest.mark.parametrize("s", range(1, 97))
def test_plan_at_every_size(s):
    """At L = 1, 22 or 68 landmarks: a face in the fewest rounds of groups
    as even as they allow, each group's columns (one thread each) within
    1,024 threads and the layout within half an SM's shared memory (two
    blocks an SM), whole warps."""
    for l in (1, 22, 68):
        plan = sampler.launch_plan(l, s)
        assert isinstance(plan, sampler.SamplerPlan)
        assert 1 <= plan.group <= l
        rounds = -(-l // plan.group)
        assert -(-l // rounds) == plan.group     # even groups
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        assert plan.group * s <= plan.threads < plan.group * s + 32
        assert plan.shared_bytes == sampler.shared_bytes(s, plan.group) \
            == layout_by_hand(s, plan.group) <= sampler.PLAN_SHARED
        # one round fewer would not fit
        if rounds > 1:
            wider = -(-l // (rounds - 1))
            assert wider * s > 1024 or \
                sampler.shared_bytes(s, wider) > sampler.PLAN_SHARED


@pytest.mark.parametrize("target", TARGETS)
def test_no_plan_exceeds_a_block(target):
    """Every plan the sweep may ask for, at every S and L = 1, 22, 68, fits
    in 1,024 threads and a block's shared memory, and aims at ``target``
    threads where one patch fits in them."""
    for s in range(1, 97):
        for l in (1, 22, 68):
            plan = sampler.launch_plan(l, s, target)
            assert plan.threads <= 1024
            assert plan.shared_bytes <= _MAX_SHARED
            assert plan.group * s * s < 1 << 22
            assert plan.group == 1 or plan.group * s <= target


def test_plan_at_the_probe_shapes():
    """RCR-22's probe shapes: at S = 55 half a face in flight (11 patches,
    608 threads: the build with 40 registers a thread), at S = 40 a whole
    face (22 patches, 896 threads)."""
    assert sampler.launch_plan(22, 55)[:2] == (11, 608)
    assert sampler.launch_plan(22, 40)[:2] == (22, 896)


@pytest.mark.parametrize("args,match", [
    ((22, 0), "S must be 1..96"),
    ((22, 97), "S must be 1..96"),
    ((0, 55), "L >= 1"),
    ((22, 55, 16), "target threads must be 32..1024"),
    ((22, 55, 2048), "target threads must be 32..1024"),
])
def test_plan_errors(args, match):
    with pytest.raises(ValueError, match=match):
        sampler.launch_plan(*args)


@pytest.mark.parametrize("n,g", [(8, 0), (8, 3), (6, 4)])
def test_faces_per_block_errors(n, g):
    """P2's faces per block: 1, 2 or 4, dividing N; checked on every
    device."""
    windows = torch.zeros((n, 64, 128), dtype=torch.bfloat16)
    oxy = torch.zeros((n, 1, 4))
    sp = torch.ones((n, 1, 2))
    with pytest.raises(ValueError, match=f"faces per block g={g}"):
        sampler.probe_sampler_g(windows, oxy, sp, g, 8, 8, 128)


def test_abde_bytes_by_hand():
    # the script's shape: six warps, each a 32 x (128 + 8) bf16 sub-window
    # and 16 column sums
    assert abde_shared_bytes(16, 128, 6, 32) == 6 * (32 * 136 * 2 + 16 * 4)
    for s, wx, warps, rows in ((8, 128, 1, 8), (128, 256, 3, 128),
                               (40, 384, 5, 40), (16, 0, 2, 8)):
        assert abde_shared_bytes(s, wx, warps, rows) == \
            warps * (rows * (wx + 8) * 2 + s * 4)


@pytest.mark.parametrize("s,w,wx,l,seg,ry,rx", [
    (16, 32, 128, 6, 128, 64, 256),      # the script's shape
    (8, 32, 128, 1, 128, 64, 256), (8, 32, 128, 8, 20, 64, 256),
    (128, 32, 128, 1, 128, 64, 256), (128, 8, 128, 8, 136, 64, 256),
    (16, 32, 128, 22, 16, 64, 256),      # RCR-22, SEG = S
    (8, 1024, 128, 1, 8, 1024, 130),     # W past 128 rows, RX odd
    (2, 8, 12160, 0, 2, 8, 12160)])      # no landmark
def test_abde_limits_accept(s, w, wx, l, seg, ry, rx):
    """Shapes the contract takes, also past 16 landmarks and 128 rows, with
    rows off 16-byte boundaries and with no landmark; where L >= 1 the
    plan fits in a block."""
    abde_check(s, w, wx, l, seg, ry, rx)
    if l:
        plan = abde_plan(s, w, wx, l)
        assert plan.shared_bytes <= _MAX_SHARED


@pytest.mark.parametrize("s,w,wx,l", [
    (16, 32, 128, 6), (16, 32, 128, 16), (16, 32, 128, 17), (16, 32, 128, 22),
    (16, 32, 128, 68), (16, 128, 256, 3), (16, 128, 256, 40),
    (16, 160, 128, 6), (2, 1024, 128, 1), (16, 128, 896, 1),
    (16, 128, 1024, 2), (2, 8, 12160, 1), (16, 0, 0, 3)])
def test_abde_plan(s, w, wx, l):
    """The whole sub-window a warp where it fits (at most 128 rows), else
    the most rows that fit; landmarks in the fewest rounds of at most 16
    warps that fit in a block, spread as evenly as they allow."""
    plan = abde_plan(s, w, wx, l)
    assert plan.shared_bytes == abde_shared_bytes(s, wx, plan.warps,
                                                  plan.rows) <= _MAX_SHARED
    assert plan.rows % 8 == 0 and 8 <= plan.rows <= ABDE_MAX_ROWS
    if abde_shared_bytes(s, wx, 1, min(max(w, 8), ABDE_MAX_ROWS)) \
            <= _MAX_SHARED:
        assert plan.rows == min(max(w, 8), ABDE_MAX_ROWS)
    else:
        assert abde_shared_bytes(s, wx, 1, plan.rows + 8) > _MAX_SHARED
    assert 1 <= plan.warps <= min(l, ABDE_MAX_WARPS)
    most = min(l, ABDE_MAX_WARPS,
               _MAX_SHARED // abde_shared_bytes(s, wx, 1, plan.rows))
    rounds = -(-l // plan.warps)
    assert rounds == -(-l // most)             # the fewest rounds
    assert -(-l // rounds) == plan.warps       # as even as they allow


def test_abde_most_landmarks():
    """At the script's sub-window, L = 16 takes 16 warps, L = 17 two
    rounds of 9 and 8 landmarks; at W = 128 and WX = 256 the shared memory
    holds 3 warps, so L = 40 runs in 14 rounds of 3."""
    assert abde_plan(16, 32, 128, 16).warps == 16
    assert abde_plan(16, 32, 128, 17).warps == 9
    assert abde_plan(16, 128, 256, 3).warps == 3
    assert abde_plan(16, 128, 256, 40).warps == 3


@pytest.mark.parametrize("args,match", [
    ((1, 32, 128, 6, 128, 64, 256), "2L <= L\\*S"),
    ((32, 32, 128, 6, 16, 64, 256), "S <= SEG"),
    ((16, 4, 128, 6, 128, 64, 256), "W must be a multiple of 8"),
    ((16, 36, 128, 6, 128, 64, 256), "W must be a multiple of 8"),
    ((16, -8, 128, 6, 128, 64, 256), "W must be a multiple of 8"),
    ((16, 72, 128, 6, 128, 64, 256), "W must be a multiple of 8"),
    ((16, 32, 64, 6, 128, 64, 256), "WX must be a multiple of 128"),
    ((16, 32, 192, 6, 128, 64, 256), "WX must be a multiple of 128"),
    ((16, 32, -128, 6, 128, 64, 256), "WX must be a multiple of 128"),
    ((16, 32, 384, 6, 128, 64, 256), "WX must be a multiple of 128"),
    ((16, 32, 128, 6, 128, 64, 100), "WX must be a multiple of 128"),
])
def test_abde_errors(args, match):
    with pytest.raises(ValueError, match=match):
        abde_check(*args)


@pytest.mark.parametrize("s,w,wx", [(16, 8, 16384), (60000, 8, 128)])
def test_abde_plan_errors(s, w, wx):
    """Where not even 8 rows of one landmark and its S sums fit."""
    with pytest.raises(ValueError, match="shared memory"):
        abde_plan(s, w, wx, 1)


def test_abde_wrapper_raises_the_same():
    """The wrapper checks the contract and the plan on every device, so the
    CPU twin refuses what the kernel would."""
    x, win, _ = dyn_inputs(0, "cpu", **DYN)
    with pytest.raises(ValueError, match="2L <= L"):
        probe_abde(x, win, 1, DYN["w"], DYN["wx"], DYN["seg"])
    with pytest.raises(ValueError, match="W must be a multiple of 8"):
        probe_abde(x, win, DYN["s"], 36, DYN["wx"], DYN["seg"])
    wide = torch.zeros((DYN["g"], 8, 16384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        probe_abde(x, wide, DYN["s"], 8, 16384, DYN["seg"])


@pytest.mark.parametrize("l,w", [(0, 32), (22, 32), (6, 160)])
def test_abde_wrapper_takes_the_wider_contract(l, w):
    """No landmark, more landmarks than a block has warps, and a sub-window
    taller than a warp's 128 rows go through the wrapper (here its twin) and
    agree with the numpy emulation."""
    from superviseddescent_tpu_torch.probes.dyn import (
        ABDE_RTOL, abde_emulation)
    rng = np.random.default_rng(l + w)
    x = rng.uniform(-20, 280, (2, 1, 2 * l)).astype(np.float32)
    win = torch.from_numpy(rng.uniform(0, 255, (2, 192, 256)).astype(
        np.float32)).bfloat16()
    got = probe_abde(torch.from_numpy(x), win, 16, w, 128, 16).numpy()
    assert got.shape == (2, 1, 2 * l)
    np.testing.assert_allclose(got, abde_emulation(x, win.float().numpy(), 16,
                                                   w, 128, 16),
                               rtol=ABDE_RTOL, atol=0)


@pytest.mark.parametrize("args,match", [
    ((4, 8, 128, 3), "at least 4 rows"),
    ((0, 8, 128, 8), "G >= 1"),
    ((-1, 8, 128, 8), "G >= 1"),
    ((4, 3, 128, 8), "BR >= 4"),
    ((4, 8, 0, 8), "SEG >= 1"),
    ((1 << 14, 1 << 10, 1 << 6, 8), "exceed int32"),
    ((1, 4, (C_MAX_ELEMENTS + 1) // 8 + 1, 4), "exceed int32"),
])
def test_c_errors(args, match):
    """Every limit of C's contract, by name, as the kernel's launch checks
    them (the 48 KB scratch limit went with the scratch)."""
    with pytest.raises(ValueError, match=match):
        c_check(*args)


@pytest.mark.parametrize("fn", [probe_c, probe_c4])
def test_c_wrapper_raises_the_same(fn):
    """Both wrappers check the contract on every device, so the CPU twin
    refuses what the kernel would."""
    with pytest.raises(ValueError, match="at least 4 rows"):
        fn(torch.zeros((3, 128)), 4, 8)
    with pytest.raises(ValueError, match="BR >= 4"):
        fn(torch.zeros((8, 128)), 4, 2)
    with pytest.raises(ValueError, match="G >= 1"):
        fn(torch.zeros((8, 128)), 0, 8)
    with pytest.raises(ValueError, match="out must be"):
        fn(torch.zeros((8, 128)), 4, 8, out=torch.zeros((64, 127)))


@pytest.mark.parametrize("g,br,seg,rows", [
    (4, 8, 128, 8),       # the script's shape
    (1, 4, 1, 4), (37, 13, 3, 4), (4, 8, 129, 9), (2, 4, 1000, 5),
    (96, 8, 128, 8),      # past the old 48 KB scratch: 768 KB
    (4, 64, 1024, 8)])    # 2 MB
def test_c_wrapper_takes_the_wider_contract(g, br, seg, rows):
    """Shapes that the scratch kept out (past 48 KB), odd SEG and BR, and v
    with more than 4 rows go through both wrappers (here their twin), into
    a new tensor or a given one off the 16-byte grid, and agree with the
    numpy emulation bit for bit."""
    rng = np.random.default_rng(g * br + seg)
    v = torch.from_numpy(rng.normal(size=(rows, seg)).astype(np.float32))
    want = c_emulation(v.numpy(), g, br)
    assert want.shape == (2 * g * br, seg)
    for fn in (probe_c, probe_c4):
        np.testing.assert_array_equal(fn(v, g, br).numpy(), want)
        buf = torch.full((want.size + 1,), np.nan)
        out = buf[1:].view(2 * g * br, seg)
        assert fn(v, g, br, out=out) is out
        np.testing.assert_array_equal(out.numpy(), want)
        assert np.isnan(float(buf[0]))
