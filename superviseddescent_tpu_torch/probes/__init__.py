"""The probes: small kernels that each ask one question of the hardware.

Counterparts of ``scripts/probe_sampler.py`` (P1), ``probe_sampler_g.py``
(P2), ``probe_sampler_pre.py`` (P3), ``probe_flatout.py`` (P4) and
``probe_dyn.py`` (P5), as hand-written CUDA kernels (``sampler.py``,
``flatout.py``, ``dyn.py``).

    python -m superviseddescent_tpu_torch.probes

runs every probe on the card at the scripts' shapes and prints one line per
variant, as the scripts do: the time is the median of 20 CUDA-event timed
launches after 3 warm-ups.
"""

from __future__ import annotations

import numpy as np
import torch

from superviseddescent_tpu_torch.probes.dyn import (
    abde_emulation, c_emulation, probe_abde, probe_c, probe_c4)
from superviseddescent_tpu_torch.probes.flatout import probe_flatout
from superviseddescent_tpu_torch.probes.sampler import (
    VARIANTS, probe_sampler, probe_sampler_g, probe_sampler_pre,
    sub_window_origins)
from superviseddescent_tpu_torch.utils.device import resolve_device

#: (S, W, WX, patch half) of the sampler probes: RCR-22's first and third level
SAMPLER_SHAPES = ((55, 160, 384, 72.0), (40, 72, 256, 29.0))
#: the shapes of the dynamic-indexing probes
DYN = dict(g=4, ry=64, rx=256, s=16, w=32, wx=128, l=6, seg=128, br=8)


def sampler_windows(seed: int, batch: int, roi: int, device) -> torch.Tensor:
    """(batch, roi, roi) bfloat16 windows of grey levels 0..255 rounded to
    bf16 once (bf16 holds 8 bits, so levels above 128 round to even)."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(0, 256, (batch, roi, roi), dtype=np.uint8)
    return torch.from_numpy(levels).to(device).bfloat16()


def sampler_centres(seed: int, batch: int, landmarks: int, roi: int):
    """(cx, cy), each (batch, landmarks) float32, in the middle of the
    window (200..312 of 512)."""
    rng = np.random.default_rng(seed + 1)
    lo, hi = roi * 200.0 / 512.0, roi * 312.0 / 512.0
    cx = rng.uniform(lo, hi, (batch, landmarks)).astype(np.float32)
    cy = rng.uniform(lo, hi, (batch, landmarks)).astype(np.float32)
    return cx, cy


def sampler_inputs(cx: np.ndarray, cy: np.ndarray, s: int, ph: float,
                   device):
    """oxy (N, 1, 2L) and sp (N, 1, 2) float32 of one (S, patch half): crop
    origins around the rounded centres and the resize step 2 ph / S."""
    batch = cx.shape[0]
    oxy = np.concatenate([np.round(cy) - ph, np.round(cx) - ph],
                         axis=1).astype(np.float32)[:, None, :]
    sp = np.tile(np.float32([2.0 * ph / s, ph]), (batch, 1))[:, None, :]
    return (torch.from_numpy(oxy).to(device),
            torch.from_numpy(sp.astype(np.float32)).to(device))


def dyn_inputs(seed: int, device, g, ry, rx, l, seg, **_):
    """x (G, 1, 2L) float32 in [0, 200), win (G, RY, RX) bfloat16 in
    [0, 255), v (8, SEG) float32 in [0, 1)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 200, (g, 1, 2 * l)).astype(np.float32)
    win = rng.uniform(0, 255, (g, ry, rx)).astype(np.float32)
    v = rng.uniform(0, 1, (8, seg)).astype(np.float32)
    return (torch.from_numpy(x).to(device),
            torch.from_numpy(win).to(device).bfloat16(),
            torch.from_numpy(v).to(device))


def _time(fn, *args, reps, warmup):
    """(median ms or None on the CPU, result)."""
    out = fn(*args)
    if out.device.type != "cuda":
        return None, out
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    ms, _ = cuda_time_ms(fn, *args, reps=reps, warmup=warmup)
    return ms, out


def _fmt(ms):
    return "not measured" if ms is None else f"{ms:7.3f} ms"


def run_all(device=None, seed: int = 0, batch: int = 1024, roi: int = 512,
            landmarks: int = 22, shapes=SAMPLER_SHAPES, tiles: int = 512,
            tile_size: int = 55, reps: int = 20, warmup: int = 3,
            log=print) -> list:
    """Run every probe once at the given shapes (default: the scripts'),
    print one line per variant and return the records
    ``dict(probe, label, ms, ...)``. Runs on the card unless ``device`` says
    otherwise; on the CPU the plain twins run and no time is taken."""
    dev = resolve_device(device)
    records = []

    def note(probe, label, ms, line, **extra):
        records.append(dict(probe=probe, label=label, ms=ms, **extra))
        log(line)

    windows = sampler_windows(seed, batch, roi, dev)
    cx, cy = sampler_centres(seed, batch, landmarks, roi)
    for s, w, wx, ph in shapes:
        oxy, sp = sampler_inputs(cx, cy, s, ph, dev)
        oo = sub_window_origins(oxy, sp, roi, roi, s, w, wx)
        head = f"S={s} W={w} WX={wx}"
        for variant in VARIANTS:
            ms, _ = _time(probe_sampler, windows, oxy, sp, variant, s, w, wx,
                          reps=reps, warmup=warmup)
            note("P1", f"{head} {variant}", ms,
                 f"{head} {variant:7s}: {_fmt(ms)}")
        for g in (1, 2, 4):
            ms, _ = _time(probe_sampler_g, windows, oxy, sp, g, s, w, wx,
                          reps=reps, warmup=warmup)
            note("P2", f"{head} G={g}", ms, f"{head} G={g}: {_fmt(ms)}")
        for pre in (False, True):
            ms, _ = _time(probe_sampler_pre, windows, oxy, sp, oo, pre, s, w,
                          wx, reps=reps, warmup=warmup)
            note("P3", f"{head} pre={int(pre)}", ms,
                 f"{head} pre={int(pre)}: {_fmt(ms)}")
    del windows

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(tiles, tile_size, tile_size))
                         .astype(np.float32)).to(dev)
    ms, out = _time(probe_flatout, x, reps=reps, warmup=warmup)
    ok = bool(torch.equal(out, (x * 2.0).reshape(tiles, -1)))
    note("P4", "flat rows", ms,
         f"in-kernel reshape: {'OK' if ok else 'WRONG'}\n"
         f"reshape kernel: {_fmt(ms)} for {tiles} tiles", ok=ok)

    d = DYN
    xd, win, v = dyn_inputs(seed, dev, **d)
    ms, out = _time(probe_abde, xd, win, d["s"], d["w"], d["wx"], d["seg"],
                    reps=reps, warmup=warmup)
    exp = abde_emulation(xd.cpu().numpy(), win.float().cpu().numpy(), d["s"],
                         d["w"], d["wx"], d["seg"])
    delta = float(np.abs(out.cpu().numpy() - exp).max())
    note("P5", "ABDE", ms,
         f"ABDE sampler-loop: OK  {_fmt(ms)} sum={float(out.sum()):.3f}\n"
         f"  ABDE numeric delta vs numpy: {delta:.5f}", delta=delta,
         scale=float(np.abs(exp).max()))
    exp_c = c_emulation(v.cpu().numpy(), d["g"], d["br"])
    for tag, fn in (("C dyn-sublane-store", probe_c),
                    ("C4 4D-store+reshape", probe_c4)):
        ms, out = _time(fn, v, d["g"], d["br"], reps=reps, warmup=warmup)
        delta = float(np.abs(out.cpu().numpy() - exp_c).max())
        note("P5", tag.split()[0], ms,
             f"{tag}: OK  {_fmt(ms)} sum={float(out.sum()):.3f}\n"
             f"  {tag.split()[0]} delta: {delta:.5f}", delta=delta)
    return records
