#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``superviseddescent_tpu_torch/csrc``,
holds each against its plain PyTorch twin on the card, then drives the main
path: pretrained RCR-22 (``pretrained/rcr22_lfpw5.bin``) over 4,096 faces
of the 120 ``.synth120`` images through
``DetectionModel.make_stepped_detector(window_sampler=True, roi=512)``, in
exact and fast sampling. It checks the launch counts of both kernels, the
rows against the port's CPU path, and the train-set IOD error, and times
the detector and each kernel with CUDA events.

Any failed check exits non-zero. The last line of standard output is the
JSON result; the line before it lists every kernel with its times and
bounds. Full results also go to ``build/chip_smoke.json``.
"""

import glob
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 4096
ROI = 512
MEM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32, CUDA cores
# rows of the card's kernels against the port's CPU path (first 32 faces);
# the tolerances of tests/test_torch_rcr.py
TOL_PX = {"exact": 1e-3, "fast": 0.02}
K1_RTOL, K1_ATOL = 1e-4, 1e-5
SOURCES = {
    "hog_flat": ("superviseddescent_tpu_torch/csrc/hog_flat.cu",
                 "superviseddescent_tpu/ops/hog_pallas_flat.py:271"),
    "patches_window": ("superviseddescent_tpu_torch/csrc/patches_window.cu",
                       "superviseddescent_tpu/ops/patches_pallas.py:247"),
}


class SmokeFailure(RuntimeError):
    pass


def check(ok, message):
    if not ok:
        raise SmokeFailure(message)


def log(message):
    print(message, flush=True)


def phase_device(torch):
    check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), using {name}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] float32 matmul and cuDNN: TF32 off")
    return name, smi


def phase_build():
    from superviseddescent_tpu_torch.ops._build import build_all
    logs = build_all()
    log(f"[build] K1 + K2 built in {logs.pop('seconds'):.2f} s "
        f"(nvcc, sm_90a, one process per source)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def phase_hog(torch):
    """K1 against its plain twin at each RCR-22 level's shape."""
    from superviseddescent_tpu_torch.models.rcr import RCR22_HOG_PARAMS
    from superviseddescent_tpu_torch.ops.hog_flat import (
        hog_descriptor_flat, hog_descriptor_flat_reference)
    errs = {"exact": 0.0, "fast": 0.0}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in RCR22_HOG_PARAMS:
        s = p.patch_size
        patches = torch.randint(0, 256, (22 * 256, s * s), generator=gen,
                                device="cuda").float()
        for fast, transposed in ((False, False), (True, False), (True, True)):
            x = patches.bfloat16() if transposed else patches
            kw = dict(size=s, cell_size=p.cell_size,
                      num_orientations=p.num_bins, variant=p.variant,
                      fast=fast, transposed=transposed)
            got = hog_descriptor_flat(x, **kw)
            ref = hog_descriptor_flat_reference(x, **kw)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            abs_err = float(diff.max())
            rel_err = float((diff / (ref.abs() + K1_ATOL)).max())
            bad = int((diff > K1_ATOL + K1_RTOL * ref.abs()).sum())
            mode = "fast" if fast else "exact"
            log(f"[K1] S={s} cs={p.cell_size} {mode:5s} "
                f"transposed={transposed!s:5s}: max abs {abs_err:.3e}, "
                f"max rel {rel_err:.3e} (tolerance rtol {K1_RTOL} + atol "
                f"{K1_ATOL}; {bad} outside)")
            check(bad == 0, f"K1 disagrees with its twin at S={s} {mode}")
            errs[mode] = max(errs[mode], abs_err)
    return errs


def load_data(torch):
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, align_mean, gt_facebox)
    from superviseddescent_tpu_torch.ops.patches import (
        load_gray_image, stack_images)
    from superviseddescent_tpu_torch.utils.landmarks import (
        ied_from_rows, resolve_eye_indices, to_row)
    import numpy as np
    t0 = time.perf_counter()
    model = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"))
    files = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))
    check(len(files) == 120, f"expected 120 .synth120 images, {len(files)}")
    images = [load_gray_image(f) for f in files]
    gts = [read_pts_landmarks(f[:-4] + ".pts").filter(model.landmark_ids)
           for f in files]
    boxes = np.array([gt_facebox(g) for g in gts], np.float32)
    gt_rows = np.stack([to_row(g) for g in gts])
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    sel = np.arange(BATCH) % len(files)
    r_idx, l_idx = resolve_eye_indices(model.landmark_ids,
                                       model.right_eye_ids,
                                       model.left_eye_ids)
    # sub-window bound as bench.py sizes it: the larger IED of the aligned
    # mean and the ground truth, with a 1.15 drift margin
    inits = align_mean(model.mean.cpu()[None],
                       torch.from_numpy(boxes))
    max_ied = 1.15 * max(
        float(ied_from_rows(inits, r_idx, l_idx).max()),
        float(ied_from_rows(torch.from_numpy(gt_rows), r_idx, l_idx).max()))
    stack_dev = torch.from_numpy(stack).cuda()
    sel_dev = torch.from_numpy(sel).cuda()
    data = dict(
        model=model, stack=stack, sel=sel, boxes_np=boxes[sel],
        images=stack_dev[sel_dev], boxes=torch.from_numpy(boxes[sel]).cuda(),
        gt=torch.from_numpy(gt_rows[sel]).cuda(), r_idx=r_idx, l_idx=l_idx,
        max_ied=max_ied)
    torch.cuda.synchronize()
    log(f"[data] model + {len(files)} images decoded in "
        f"{time.perf_counter() - t0:.1f} s; stack {tuple(stack.shape)} uint8;"
        f" {BATCH} faces; max_ied {max_ied:.2f} px")
    return data


def phase_sampler(torch, data):
    """K2 against its plain twin on .synth120 windows at roi 512."""
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, sample_patches_window, sample_patches_window_reference)
    model = data["model"]
    errs = {"exact": 0.0, "fast": 0.0}
    n = 256
    for sampling in ("exact", "fast"):
        det = model.make_stepped_detector(
            n, roi=ROI, sampling=sampling, window_sampler=True,
            max_ied=data["max_ied"])
        boxes = data["boxes"][:n]
        windows, ox, oy = det.crop(data["images"][:n], boxes)
        x = align_mean(model.mean[None], boxes) - rows_shift(
            ox, oy, len(model.landmark_ids))
        hog = det.transform(windows)
        for li in range(len(model.hog_params)):
            args, kw, _ = hog.window_args(x, li)
            w = kw["sub_window"] or windows.shape[1]
            wx = kw["sub_window_x"] or windows.shape[2]
            for transposed in (False, True):
                kw = dict(kw, transposed=transposed)
                got = sample_patches_window(*args, **kw).float()
                oxy, sp = _prepare(args[1], args[2], args[3], args[4])
                ref = sample_patches_window_reference(
                    windows, oxy, sp, args[4], w, wx, kw["quantize"],
                    sampling, transposed, kw["out_dtype"]).float()
                torch.cuda.synchronize()
                diff = (got - ref).abs()
                share = float((diff > 0).float().mean())
                log(f"[K2] level {li} S={args[4]} W={w} WX={wx} {sampling:5s}"
                    f" transposed={transposed!s:5s}: max abs "
                    f"{float(diff.max()):.1f} grey levels on "
                    f"{100 * share:.4f}% of pixels (tolerance: equal)")
                check(float(diff.max()) == 0.0,
                      f"K2 {sampling} differs from its twin at level {li}")
                errs[sampling] = max(errs[sampling], float(diff.max()))
    return errs


def k1_bound(n_rows, p, in_bytes):
    """Least time for K1: each patch read once, each descriptor written
    once, against the float32 operations the HOG needs."""
    from superviseddescent_tpu_torch.ops.hog import (
        hog_dimension, hog_num_cells)
    s, o = p.patch_size, p.num_bins
    cc = hog_num_cells(s, p.cell_size) ** 2
    dims = hog_dimension(p.variant, o)
    bytes_moved = n_rows * (s * s * in_bytes + dims * cc * 4)
    # per pixel: 2 differences, magnitude (3 + sqrt), 4 ops per bin score,
    # 2 per splat into each of 4 cells; per cell: energy (3 per bin),
    # 4 block factors (5 each) and 7 per channel and factor
    ops = n_rows * (s * s * (6 + 4 * o + 8) + cc * (3 * o + 20 + 28 * o))
    return bytes_moved / MEM_BYTES_PER_S, ops / F32_OPS_PER_S


def k2_read_pixels(torch, windows, oxy, sp, s, w, wx, quantize, fast):
    """Window pixels K2 must read: for each face, the union over its
    landmarks of the rows x columns that carry a non-zero tap. Pixels
    shared by overlapping patches of one face count once."""
    from superviseddescent_tpu_torch.ops.patches_window import _tap_plan
    n, ry, rx = windows.shape
    oy, ox, (v0, ty0, ty1), (u0, tx0, tx1) = _tap_plan(
        ry, rx, oxy, sp, s, w, wx, quantize, fast)

    def cover(origin, i0, t0, t1, size):
        # (N, L, size) 1.0 where a row (column) carries a tap; slot `size`
        # takes the zero-weight taps and is dropped
        c = torch.zeros(i0.shape[:2] + (size + 1,), device=i0.device)
        first = origin[:, :, None] + i0
        c.scatter_(2, torch.where(t0 != 0, first, size), 1.0)
        c.scatter_(2, torch.where(t1 != 0, first + 1, size), 1.0)
        return c[:, :, :size]

    rows = cover(oy, v0, ty0, ty1, ry)
    cols = cover(ox, u0, tx0, tx1, rx)
    total = 0
    for a in range(0, n, 256):
        hits = torch.bmm(rows[a:a + 256].transpose(1, 2), cols[a:a + 256])
        total += int((hits > 0).sum())
    return total


def k2_bound(torch, windows, oxy, sp, s, w, wx, kw):
    """Least time for K2: each output pixel written once, each window pixel
    of ``k2_read_pixels`` read once, the crop origins and steps read once."""
    n, l = oxy.shape[0], oxy.shape[1] // 2
    read = k2_read_pixels(torch, windows, oxy, sp, s, w, wx, kw["quantize"],
                          kw["sampling"] == "fast")
    out_bytes = 2 if kw["out_dtype"] == torch.bfloat16 else 4
    bytes_moved = (n * l * s * s * out_bytes + read * windows.element_size()
                   + (oxy.numel() + sp.numel()) * 4)
    ops = n * l * s * s * 15   # two-tap passes, rounding and clamping
    return bytes_moved / MEM_BYTES_PER_S, ops / F32_OPS_PER_S


def phase_main(torch, data):
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, align_mean, rows_shift)
    from superviseddescent_tpu_torch.models.rcr_training import (
        normalised_landmark_errors)
    from superviseddescent_tpu_torch.ops.hog_flat import (
        hog_descriptor_flat, hog_descriptor_flat_reference)
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, sample_patches_window, sample_patches_window_reference)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    model, images, boxes = data["model"], data["images"], data["boxes"]
    cpu_model = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"), device="cpu")
    outputs, results = {}, {}
    for sampling in ("exact", "fast"):
        det = model.make_stepped_detector(
            BATCH, roi=ROI, sampling=sampling, window_sampler=True,
            max_ied=data["max_ied"])
        # the main path's run: counts from 0, read right after
        hog_descriptor_flat.launches = 0
        sample_patches_window.launches = 0
        out = det(images, boxes)
        torch.cuda.synchronize()
        launches = {"hog_flat": hog_descriptor_flat.launches,
                    "patches_window": sample_patches_window.launches}
        log(f"[main] {sampling}: launches {launches} in one detect call "
            f"of {BATCH} faces (sub-windows W {det.sub_windows}, WX "
            f"{det.sub_windows_x})")
        check(launches == {"hog_flat": 4, "patches_window": 4},
              f"expected 4 launches of each kernel, got {launches}")
        check(out.shape == (BATCH, 2 * len(model.landmark_ids))
              and bool(torch.isfinite(out).all()),
              "non-finite or misshapen landmark rows")
        outputs[sampling] = out

        cpu_det = cpu_model.make_stepped_detector(
            32, roi=ROI, sampling=sampling, window_sampler=True,
            max_ied=data["max_ied"])
        cpu_out = cpu_det(torch.from_numpy(data["stack"][data["sel"][:32]]),
                          data["boxes_np"][:32])
        delta = float((out[:32].cpu() - cpu_out).abs().max())
        log(f"[main] {sampling}: max px delta vs the CPU plain path on the "
            f"first 32 faces {delta:.3e} (tolerance {TOL_PX[sampling]})")
        check(delta <= TOL_PX[sampling],
              f"{sampling} rows differ from the CPU path by {delta} px")

        err = float(normalised_landmark_errors(
            out, data["gt"], data["r_idx"], data["l_idx"]).mean())
        ms, runs = cuda_time_ms(det, images, boxes, reps=20, warmup=3)
        log(f"[main] {sampling}: train-set IOD error {err:.6f}; detect "
            f"{ms:.3f} ms median of {len(runs)} (min {min(runs):.3f}, max "
            f"{max(runs):.3f}) -> {BATCH / ms * 1e3:.0f} faces/s")
        results[sampling] = dict(iod_err=err, detect_ms=ms,
                                 faces_per_s=BATCH / ms * 1e3,
                                 launches=launches, cpu_delta_px=delta,
                                 k1_err=0.0, k2_err=0.0, levels=[])

        # each kernel against its twin, and timed, at the main path's inputs
        windows, ox, oy = det.crop(images, boxes)
        x = align_mean(model.mean[None], boxes) - rows_shift(
            ox, oy, len(model.landmark_ids))
        hog = det.transform(windows)
        for li, p in enumerate(model.hog_params):
            args, skw, hkw = hog.window_args(x, li)
            n, l, s = BATCH, len(model.landmark_ids), p.patch_size
            oxy, sp = _prepare(args[1], args[2], args[3], s)
            w = skw["sub_window"] or windows.shape[1]
            wx = skw["sub_window_x"] or windows.shape[2]
            ref_args = (windows, oxy, sp, s, w, wx, skw["quantize"], sampling,
                        skw["transposed"], skw["out_dtype"])

            got = sample_patches_window(*args, **skw)
            ref = sample_patches_window_reference(*ref_args)
            k2_err = float((got.float() - ref.float()).abs().max())
            del ref
            log(f"[check] {sampling} level {li}: K2 vs twin on {n * l} "
                f"patches max abs {k2_err:.1f} (tolerance: equal)")
            check(k2_err == 0.0, f"K2 {sampling} differs from its twin on "
                  f"the main path at level {li}")
            patches = got.reshape(n * l, s * s)
            got = hog_descriptor_flat(patches, **hkw)
            ref = hog_descriptor_flat_reference(patches, **hkw)
            diff = (got - ref).abs()
            k1_err = float(diff.max())
            bad = int((diff > K1_ATOL + K1_RTOL * ref.abs()).sum())
            del got, ref, diff
            log(f"[check] {sampling} level {li}: K1 vs twin on {n * l} rows "
                f"max abs {k1_err:.3e} (tolerance rtol {K1_RTOL} + atol "
                f"{K1_ATOL}; {bad} outside)")
            check(bad == 0, f"K1 {sampling} disagrees with its twin on the "
                  f"main path at level {li}")
            results[sampling]["k1_err"] = max(results[sampling]["k1_err"],
                                              k1_err)
            results[sampling]["k2_err"] = max(results[sampling]["k2_err"],
                                              k2_err)

            k2_ms, _ = cuda_time_ms(sample_patches_window, *args, **skw)
            k1_ms, _ = cuda_time_ms(hog_descriptor_flat, patches, **hkw)
            k2_plain, _ = cuda_time_ms(sample_patches_window_reference,
                                       *ref_args, reps=3, warmup=1)
            torch.cuda.empty_cache()
            k1_plain, _ = cuda_time_ms(hog_descriptor_flat_reference,
                                       patches, reps=3, warmup=1, **hkw)
            torch.cuda.empty_cache()
            k1_b = k1_bound(n * l, p, patches.element_size())
            k2_b = k2_bound(torch, windows, oxy, sp, s, w, wx, skw)
            torch.cuda.empty_cache()
            level = dict(level=li, S=s, W=w, WX=wx,
                         k2_ms=k2_ms, k2_plain_ms=k2_plain,
                         k2_bound_bytes_ms=k2_b[0] * 1e3,
                         k2_bound_ops_ms=k2_b[1] * 1e3,
                         k1_ms=k1_ms, k1_plain_ms=k1_plain,
                         k1_bound_bytes_ms=k1_b[0] * 1e3,
                         k1_bound_ops_ms=k1_b[1] * 1e3)
            results[sampling]["levels"].append(level)
            log(f"[level] {sampling} {li} S={s}: K2 {k2_ms:.4f} ms (plain "
                f"{k2_plain:.3f}, bound {max(k2_b) * 1e3:.4f}) | K1 "
                f"{k1_ms:.4f} ms (plain {k1_plain:.3f}, bound "
                f"{max(k1_b) * 1e3:.4f})")
            x = det.level(li, windows, x)
            del patches
        del windows
        torch.cuda.empty_cache()

    fast_vs_exact = float((outputs["fast"] - outputs["exact"]).abs().max())
    log(f"[main] fast vs exact: max px delta {fast_vs_exact:.4f}")
    return results, fast_vs_exact


def phase_profile(torch, data):
    """Where one exact detect call spends device time: torch.profiler
    kernel sums by name, and the device busy share of the call's wall."""
    from torch.profiler import ProfilerActivity, profile
    det = data["model"].make_stepped_detector(
        BATCH, roi=ROI, sampling="exact", window_sampler=True,
        max_ied=data["max_ied"])
    det(data["images"], data["boxes"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        det(data["images"], data["boxes"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernels only: an operator's own entry repeats its kernels' time
        if "CUDA" not in str(ev.device_type):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        log("[profile] the profiler recorded no device time: not measured")
        return None
    log(f"[profile] exact detect of {BATCH} faces: wall {wall_ms:.3f} ms "
        f"(profiled), kernels busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for ms, count, key in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[dict(ms=ms, count=count, name=key[:120])
                     for ms, count, key in rows[:20]])


def kernel_entries(results, k1_errs, k2_errs):
    """One entry per kernel and mode. max_abs_err is the larger of the
    twin checks at the main path's inputs and those of phases 3-4;
    library_ms is null: no single PyTorch call computes HOG or the
    truncated, quantised window sampling."""
    entries = []
    for name, key, errs in (("hog_flat", "k1", k1_errs),
                            ("patches_window", "k2", k2_errs)):
        source, replaces = SOURCES[name]
        for sampling in ("exact", "fast"):
            levels = results[sampling]["levels"]
            total = lambda field: sum(lv[field] for lv in levels)  # noqa
            b_bytes = total(f"{key}_bound_bytes_ms")
            b_ops = total(f"{key}_bound_ops_ms")
            entries.append(dict(
                name=f"{name}/{sampling}", route="cuda", source=source,
                replaces=replaces,
                launches=results[sampling]["launches"][name],
                max_abs_err=max(errs[sampling],
                                results[sampling][f"{key}_err"]),
                ms=total(f"{key}_ms"),
                plain_ms=total(f"{key}_plain_ms"),
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=None))
    return entries


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "superviseddescent_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t0 = time.perf_counter()
    name, smi = phase_device(torch)
    phase_build()
    k1_errs = phase_hog(torch)
    data = load_data(torch)
    k2_errs = phase_sampler(torch, data)
    results, fast_vs_exact = phase_main(torch, data)
    profile = phase_profile(torch, data)
    entries = kernel_entries(results, k1_errs, k2_errs)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=name, nvidia_smi=smi, results=results,
                       fast_vs_exact_px=fast_vs_exact, profile=profile,
                       kernels=entries,
                       seconds=time.perf_counter() - t0), f, indent=1)
    check(all(math.isfinite(e["ms"]) for e in entries), "bad kernel times")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
