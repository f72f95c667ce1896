"""The probes' plain twins against the probe scripts' own kernel bodies.

The scripts' ``run`` wrappers compile for the TPU; here each script is
imported as a module and its kernel body is wrapped in a
``pl.pallas_call(..., interpret=True)`` of the script's own block layout, so
the body runs on the CPU. The port runs its plain twin (the wrappers' CPU
path). Inputs are numpy arrays from a seed, rounded to bf16 once and handed
to both sides.

Tolerances: P1-P3 equal bit for bit (a tent row has at most two non-zero
taps, so no float32 sum depends on its order); P4 equal; P5 C / C4 equal on
the rows the kernels store (the script's scratch is uninitialised elsewhere,
the port's is zero); P5 ABDE within ``ABDE_RTOL`` = 2**-7 relative (float32
sums over 128 and 32 terms in different orders may round a bf16 intermediate
the other way).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from superviseddescent_tpu_torch.probes import (
    DYN, dyn_inputs, run_all, sampler_centres, sampler_inputs,
    sampler_windows)
from superviseddescent_tpu_torch.probes.dyn import (
    ABDE_RTOL, abde_emulation, c_emulation, probe_abde, probe_c, probe_c4)
from superviseddescent_tpu_torch.probes.flatout import (
    probe_flatout, probe_flatout_reference)
from superviseddescent_tpu_torch.probes.sampler import (
    VARIANTS, probe_sampler, probe_sampler_g, probe_sampler_pre,
    probe_sampler_reference, sub_window_origins)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, ROI, L = 4, 256, 3
# (S, W, WX, patch half): the patch extent 2 * ph fits W - 8 - 2
SHAPES = {"s16": (16, 32, 128, 10.0), "s12": (12, 24, 128, 5.0)}


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return {name: script(name) for name in (
        "probe_sampler", "probe_sampler_g", "probe_sampler_pre", "probe_dyn")}


def sampler_case(shape, centres):
    """windows, oxy, sp, oo as torch tensors on the CPU. centres 'middle':
    the scripts' (the middle of the window); 'border': anywhere up to 4 px
    outside it, so that origins clamp and taps are truncated."""
    s, w, wx, ph = SHAPES[shape]
    windows = sampler_windows(3, N, ROI, "cpu")
    if centres == "middle":
        cx, cy = sampler_centres(3, N, L, ROI)
    else:
        rng = np.random.default_rng(5)
        cx = rng.uniform(-4, ROI + 4, (N, L)).astype(np.float32)
        cy = rng.uniform(-4, ROI + 4, (N, L)).astype(np.float32)
    oxy, sp = sampler_inputs(cx, cy, s, ph, "cpu")
    oo = sub_window_origins(oxy, sp, ROI, ROI, s, w, wx)
    return windows, oxy, sp, oo, (s, w, wx)


def pallas_sampler(kernel, g, windows, oxy, sp, s, oo=None):
    """The scripts' pallas_call (their block layout), in interpret mode."""
    n, ry, rx = windows.shape
    l = oxy.shape[-1] // 2
    row = lambda width: pl.BlockSpec((g, 1, width), lambda i: (i, 0, 0))
    in_specs = [row(2 * l), row(2)] + ([row(2 * l)] if oo is not None else [])
    in_specs.append(pl.BlockSpec((g, ry, rx), lambda i: (i, 0, 0)))
    args = [jnp.asarray(oxy.numpy()), jnp.asarray(sp.numpy())]
    if oo is not None:
        args.append(jnp.asarray(oo.numpy()))
    args.append(jnp.asarray(windows.float().numpy(), jnp.bfloat16))
    out = pl.pallas_call(
        kernel, grid=(n // g,), in_specs=in_specs,
        out_specs=pl.BlockSpec((g, l, s, s), lambda i: (i, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, l, s, s), jnp.bfloat16),
        interpret=True)(*args)
    return np.asarray(out, np.float32)


def as_f32(t):
    assert t.dtype == torch.bfloat16
    return t.float().numpy()


@pytest.mark.parametrize("centres", ["middle", "border"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_p1_variant_equals_script_kernel(scripts, variant, shape, centres):
    windows, oxy, sp, _, (s, w, wx) = sampler_case(shape, centres)
    kernel = scripts["probe_sampler"].make_kernel(variant, L, s, w, wx, ROI,
                                                  ROI)
    ref = pallas_sampler(kernel, 1, windows, oxy, sp, s)
    got = probe_sampler(windows, oxy, sp, variant, s, w, wx)
    assert got.shape == (N, L, s, s)
    np.testing.assert_array_equal(as_f32(got), ref)
    assert ref.max() > 0


@pytest.mark.parametrize("centres", ["middle", "border"])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_p2_faces_per_block_equal_script_kernel_and_full(scripts, g, centres):
    windows, oxy, sp, _, (s, w, wx) = sampler_case("s16", centres)
    kernel = scripts["probe_sampler_g"].make_kernel(g, L, s, w, wx, ROI, ROI)
    ref = pallas_sampler(kernel, g, windows, oxy, sp, s)
    got = probe_sampler_g(windows, oxy, sp, g, s, w, wx)
    np.testing.assert_array_equal(as_f32(got), ref)
    full = probe_sampler(windows, oxy, sp, "full", s, w, wx)
    assert torch.equal(got, full)


@pytest.mark.parametrize("centres", ["middle", "border"])
@pytest.mark.parametrize("pre", [False, True])
def test_p3_origins_equal_script_kernel_and_full(scripts, pre, centres):
    windows, oxy, sp, oo, (s, w, wx) = sampler_case("s16", centres)
    kernel = scripts["probe_sampler_pre"].make_kernel(pre, L, s, w, wx, ROI,
                                                      ROI)
    ref = pallas_sampler(kernel, 1, windows, oxy, sp, s, oo=oo)
    got = probe_sampler_pre(windows, oxy, sp, oo, pre, s, w, wx)
    np.testing.assert_array_equal(as_f32(got), ref)
    full = probe_sampler(windows, oxy, sp, "full", s, w, wx)
    assert torch.equal(got, full)


def test_p1_full_is_k2_fast_transposed_sampling():
    # the probes compute K2's fast, transposed, quantised sampling
    from superviseddescent_tpu_torch.ops.patches_window import (
        sample_patches_window_reference)
    windows, oxy, sp, _, (s, w, wx) = sampler_case("s16", "border")
    got = probe_sampler_reference(windows, oxy, sp, s, w, wx)
    k2 = sample_patches_window_reference(
        windows, oxy.reshape(N, -1), sp.reshape(N, 2), s, w, wx, True, "fast",
        True, torch.bfloat16)
    assert torch.equal(got, k2)


def test_sampler_named_errors():
    windows, oxy, sp, oo, (s, w, wx) = sampler_case("s16", "middle")
    with pytest.raises(ValueError, match="variant"):
        probe_sampler(windows, oxy, sp, "dense", s, w, wx)
    with pytest.raises(ValueError, match="bfloat16"):
        probe_sampler(windows.float(), oxy, sp, "full", s, w, wx)
    with pytest.raises(ValueError, match="faces per block"):
        probe_sampler_g(windows, oxy, sp, 3, s, w, wx)
    with pytest.raises(ValueError, match="int32"):
        probe_sampler_pre(windows, oxy, sp, oo.long(), True, s, w, wx)
    with pytest.raises(ValueError, match="column sub-window"):
        probe_sampler(windows, oxy, sp, "full", s, w, 100)


def test_p4_twin_is_two_x_reshaped():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 55, 55)).astype(np.float32)
    ref = (x * 2.0).reshape(6, 55 * 55)      # scripts/probe_flatout.py:46
    got = probe_flatout(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        probe_flatout_reference(torch.from_numpy(x)).numpy(), ref)
    with pytest.raises(ValueError, match="float32"):
        probe_flatout(torch.from_numpy(x).double())


@pytest.fixture(scope="module")
def dyn_case(scripts):
    m = scripts["probe_dyn"]
    shapes = dict(g=m.G, ry=m.RY, rx=m.RX, s=m.S, w=m.W, wx=m.WX, l=m.L,
                  seg=m.SEG, br=m.BR)
    assert shapes == DYN
    x, win, v = dyn_inputs(0, "cpu", **shapes)
    return m, x, win, v


def test_p5_abde_equals_script_kernel_and_emulation(dyn_case):
    m, x, win, _ = dyn_case
    ref = np.asarray(pl.pallas_call(
        m.kernel_abde, grid=(1,),
        in_specs=[pl.BlockSpec((m.G, 1, 2 * m.L), lambda i: (0, 0, 0)),
                  pl.BlockSpec((m.G, m.RY, m.RX), lambda i: (0, 0, 0))],
        out_specs=pl.BlockSpec((m.G, 1, 2 * m.L), lambda i: (0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((m.G, 1, 2 * m.L), jnp.float32),
        scratch_shapes=[pltpu.VMEM((m.L, m.S, m.SEG), jnp.bfloat16),
                        pltpu.VMEM((m.S, m.L * m.S), jnp.bfloat16)],
        interpret=True)(jnp.asarray(x.numpy()),
                        jnp.asarray(win.float().numpy(), jnp.bfloat16)))
    got = probe_abde(x, win, m.S, m.W, m.WX, m.SEG).numpy()
    assert got.shape == (m.G, 1, 2 * m.L) and got.min() > 100
    np.testing.assert_allclose(got, ref, rtol=ABDE_RTOL, atol=0)
    emu = abde_emulation(x.numpy(), win.float().numpy(), m.S, m.W, m.WX,
                         m.SEG)
    np.testing.assert_allclose(got, emu, rtol=ABDE_RTOL, atol=0)
    np.testing.assert_allclose(ref, emu, rtol=ABDE_RTOL, atol=0)


@pytest.mark.parametrize("which", ["c", "c4"])
def test_p5_stores_equal_script_kernel_and_emulation(dyn_case, which):
    m, _, _, v = dyn_case
    rows = 2 * m.GB
    kernel, scratch = {
        "c": (m.kernel_c, pltpu.VMEM((rows, m.SEG), jnp.float32)),
        "c4": (m.kernel_c4, pltpu.VMEM((2, m.G, m.BR, m.SEG), jnp.float32)),
    }[which]
    ref = np.asarray(pl.pallas_call(
        kernel, grid=(1,),
        in_specs=[pl.BlockSpec((8, m.SEG), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((rows, m.SEG), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, m.SEG), jnp.float32),
        scratch_shapes=[scratch], interpret=True)(jnp.asarray(v.numpy())))
    got = (probe_c if which == "c" else probe_c4)(v, m.G, m.BR).numpy()
    stored = (np.arange(rows) % m.BR) < 4
    np.testing.assert_array_equal(got[stored], ref[stored])
    np.testing.assert_array_equal(got, c_emulation(v.numpy(), m.G, m.BR))
    assert torch.equal(probe_c(v, m.G, m.BR), probe_c4(v, m.G, m.BR))


def test_run_all_on_the_cpu_runs_every_probe_untimed():
    lines = []
    records = run_all(device="cpu", batch=4, roi=256, landmarks=3,
                      shapes=tuple(SHAPES.values()), tiles=3, tile_size=7,
                      log=lines.append)
    assert [r["probe"] for r in records].count("P1") == 6
    assert {r["probe"] for r in records} == {"P1", "P2", "P3", "P4", "P5"}
    assert all(r["ms"] is None for r in records)
    assert lines[0] == "S=16 W=32 WX=128 full   : not measured"
    assert records[-4]["ok"] and records[-3]["delta"] <= \
        ABDE_RTOL * records[-3]["scale"]
    assert records[-1]["delta"] == 0 and records[-2]["delta"] == 0
