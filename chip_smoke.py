#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``superviseddescent_tpu_torch/csrc``,
holds each against its plain PyTorch twin on the card, then drives the two
serving paths with pretrained RCR-22 (``pretrained/rcr22_lfpw5.bin``) over
4,096 faces of the 120 ``.synth120`` images:

* the stepped detector,
  ``DetectionModel.make_stepped_detector(window_sampler=True, roi=512)``,
  in exact and fast sampling (K2 then K1 per level);
* the fused detector, ``DetectionModel.make_fused_detector(roi=512)``, on
  the unique 120-frame uint8 stack with ``image_indices`` (K3, one launch
  per call) and on the float32 stack (the crop path to K4).

It checks each path's launch counts, each kernel against its twin at the
path's own inputs, the rows against the port's CPU path, the train-set IOD
error and the fused rows against the exact stepped rows, and times the
detectors and each kernel with CUDA events.

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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16, dense tensor cores
# fused kernels against their twins: one level from equal rows (only the
# regressor sums differ); the whole cascade per face, where a centre may
# round the other way at a .5 boundary and move a patch by a pixel, so a
# share of the faces is held to the fast-class bound and every face to the
# JAX package's fused-vs-exact bound (tests/test_detectors.py)
FUSED_LEVEL_PX = 1e-3
FUSED_WHOLE_PX = 0.02
FUSED_SHARE = 0.999
FUSED_WHOLE_MAX_PX = 0.75
SOURCES = {
    "hog_flat": ("superviseddescent_tpu_torch/csrc/hog_flat.cu",
                 "superviseddescent_tpu/ops/hog_pallas_flat.py:271"),
    "patches_window": ("superviseddescent_tpu_torch/csrc/patches_window.cu",
                       "superviseddescent_tpu/ops/patches_pallas.py:247"),
    "cascade_fused_frames": (
        "superviseddescent_tpu_torch/csrc/cascade_fused.cu",
        "superviseddescent_tpu/ops/cascade_pallas.py:1054"),
    "cascade_fused": ("superviseddescent_tpu_torch/csrc/cascade_fused.cu",
                      "superviseddescent_tpu/ops/cascade_pallas.py:1207"),
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
    log(f"[build] K1-K4 built in {logs.pop('seconds'):.2f} s "
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
        frames=stack_dev, sel_dev=sel_dev.int(), images=stack_dev[sel_dev],
        boxes=torch.from_numpy(boxes[sel]).cuda(),
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


def k2_bound(torch, windows, oxy, sp, s, w, wx, kw):
    """Least time for K2: each output pixel written once, each window pixel
    that carries a tap (``read_pixels``) read once, the crop origins and
    steps read once."""
    from superviseddescent_tpu_torch.ops.patches_window import _tap_plan
    n, l = oxy.shape[0], oxy.shape[1] // 2
    ry, rx = windows.shape[1:]
    read = read_pixels(torch, (ry, rx), [_tap_plan(
        ry, rx, oxy, sp, s, w, wx, kw["quantize"], kw["sampling"] == "fast")])
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
        zero_counts()
        out = det(images, boxes)
        torch.cuda.synchronize()
        launches = read_counts()
        log(f"[main] {sampling}: launches {launches} in one detect call "
            f"of {BATCH} faces (sub-windows W {det.sub_windows}, WX "
            f"{det.sub_windows_x})")
        check(launches == {"hog_flat": 4, "patches_window": 4,
                           "cascade_fused_frames": 0, "cascade_fused": 0},
              f"expected 4 launches of K1 and K2, got {launches}")
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
    return results, fast_vs_exact, outputs["exact"]


def read_pixels(torch, n_rows_cols, plans):
    """Window pixels a kernel must read: for each face, the union over its
    landmarks and over the levels of ``plans`` of the rows x columns that
    carry a non-zero tap; pixels shared by overlapping patches count once.
    plans: per level the (oy, ox, ytaps, xtaps) of _tap_plan."""
    ry, rx = n_rows_cols
    n = plans[0][0].shape[0]

    def cover(origin, i0, t0, t1, size, a, b):
        c = torch.zeros((b - a,) + i0.shape[1:2] + (size + 1,),
                        device=i0.device)
        first = origin[a:b, :, None] + i0[a:b]
        c.scatter_(2, torch.where(t0[a:b] != 0, first, size), 1.0)
        c.scatter_(2, torch.where(t1[a:b] != 0, first + 1, size), 1.0)
        return c[:, :, :size]

    total = 0
    for a in range(0, n, 128):
        b = min(n, a + 128)
        hit = torch.zeros((b - a, ry, rx), dtype=torch.bool,
                          device=plans[0][0].device)
        for oy, ox, (v0, ty0, ty1), (u0, tx0, tx1) in plans:
            rows = cover(oy, v0, ty0, ty1, ry, a, b)
            cols = cover(ox, u0, tx0, tx1, rx, a, b)
            hit |= torch.bmm(rows.transpose(1, 2), cols) > 0
        total += int(hit.sum())
    return total


def cascade_bound(torch, model, det, levels_x, window_shape, pixel_bytes,
                  weights_bytes):
    """Least time for a fused cascade call: the bytes of each face's window
    pixels (the union of its taps over all levels, read once), the weights
    and the rows, against K2's and K1's float32 operations at 67 TFLOP/s
    plus the regressor GEMV (2 * 2L * F per face and level) at the bf16
    dense tensor-core rate."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        level_patch_half)
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, _tap_plan)
    ry, rx = window_shape
    n, l2 = levels_x[0].shape
    l = l2 // 2
    plans, ops_f32, gemv = [], 0, 0
    for li, (level, x) in enumerate(zip(det.levels, levels_x)):
        s, w, wx, _ = level
        _, phw = level_patch_half(x, level, ry, rx, det.r_idx, det.l_idx)
        oxy, sp = _prepare(x[:, :l], x[:, l:], phw, s)
        plans.append(_tap_plan(ry, rx, oxy, sp, s, w, wx, det.quantize,
                               True))
        p = model.hog_params[li]
        k1_ops = k1_bound(n * l, p, 2)[1] * F32_OPS_PER_S
        ops_f32 += k1_ops + n * l * s * s * 15
        gemv += 2 * l2 * det.weights.num_features * n
    read = read_pixels(torch, (ry, rx), plans)
    bytes_moved = (read * pixel_bytes + weights_bytes + 2 * n * l2 * 4
                   + 3 * n * 4)
    b_bytes = bytes_moved / MEM_BYTES_PER_S
    b_ops = ops_f32 / F32_OPS_PER_S + gemv / BF16_OPS_PER_S
    return b_bytes, b_ops, read


def zero_counts():
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames)
    from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat
    from superviseddescent_tpu_torch.ops.patches_window import (
        sample_patches_window)
    hog_descriptor_flat.launches = 0
    sample_patches_window.launches = 0
    detect_cascade_fused_frames.launches = 0
    detect_cascade_fused.launches = 0


def read_counts():
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames)
    from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat
    from superviseddescent_tpu_torch.ops.patches_window import (
        sample_patches_window)
    return {"hog_flat": hog_descriptor_flat.launches,
            "patches_window": sample_patches_window.launches,
            "cascade_fused_frames": detect_cascade_fused_frames.launches,
            "cascade_fused": detect_cascade_fused.launches}


def cascade_compare(torch, name, per_face):
    """Whole-cascade kernel-vs-twin check on per-face max deltas (px)."""
    n = per_face.numel()
    within = float((per_face <= FUSED_WHOLE_PX).float().mean())
    beyond_1e3 = float((per_face > FUSED_LEVEL_PX).float().mean())
    worst = float(per_face.max())
    log(f"[fused] {name} whole cascade vs twin on {n} faces: max "
        f"{worst:.3e} px; {100 * within:.3f}% of faces <= {FUSED_WHOLE_PX} "
        f"px (need >= {100 * FUSED_SHARE}%), {100 * beyond_1e3:.3f}% beyond "
        f"{FUSED_LEVEL_PX} px (bound: every face <= {FUSED_WHOLE_MAX_PX})")
    check(within >= FUSED_SHARE and worst <= FUSED_WHOLE_MAX_PX,
          f"{name} disagrees with its twin over the whole cascade")
    return dict(max_px=worst, share_within=within, share_beyond_1e3=beyond_1e3)


def phase_fused(torch, data, exact_rows):
    """The fused detector (K3 on the unique uint8 frame stack with
    image_indices, K4 on the float32 stack): launch counts, each kernel
    against its twin per level and over the whole cascade at the main
    path's inputs, image_indices vs the expanded stack, the card vs the
    CPU path, accuracy, and times."""
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, align_mean, rows_shift)
    from superviseddescent_tpu_torch.models.rcr_training import (
        normalised_landmark_errors)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames,
        detect_cascade_fused_frames_reference, detect_cascade_fused_reference,
        prepare_weights)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    model, frames, boxes = data["model"], data["frames"], data["boxes"]
    idx = data["sel_dev"]
    det = model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    n_lm = len(model.landmark_ids)
    eyes = (det.r_idx, det.l_idx)
    results = {}

    # the main path's run: K3, counts from 0, read right after
    zero_counts()
    out = det(frames, boxes, image_indices=idx)
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"[fused] frames path (uint8 {tuple(frames.shape)} unique stack, "
        f"image_indices): launches {launches} in one detect call of {BATCH} "
        f"faces; levels (S, W, WX, rel) {det.levels}")
    check(launches == {"hog_flat": 0, "patches_window": 0,
                       "cascade_fused_frames": 1, "cascade_fused": 0},
          f"expected exactly 1 K3 launch, got {launches}")
    check(out.shape == (BATCH, 2 * n_lm) and bool(torch.isfinite(out).all()),
          "non-finite or misshapen fused rows")
    frames_f32 = frames.float()
    zero_counts()
    out4 = det(frames_f32, boxes, image_indices=idx)
    torch.cuda.synchronize()
    launches4 = read_counts()
    log(f"[fused] crop path (float32 stack): launches {launches4}")
    check(launches4 == {"hog_flat": 0, "patches_window": 0,
                        "cascade_fused_frames": 0, "cascade_fused": 1},
          f"expected exactly 1 K4 launch, got {launches4}")
    check(bool(torch.isfinite(out4).all()), "non-finite K4 rows")
    k3_vs_k4 = float((out - out4).abs().max())
    log(f"[fused] K3 vs K4 rows: max {k3_vs_k4:.4f} px")

    # each kernel against its twin, per level (one-level op calls from the
    # twin's rows) and over the whole cascade, at the main path's inputs
    x_img = align_mean(model.mean[None], boxes)
    oy, ox, window = det.aligned_origins(frames, boxes)
    windows, wox, woy = det.crop(frames_f32, boxes, idx)
    del frames_f32
    paths = {
        "cascade_fused_frames": dict(
            x0=x_img - rows_shift(ox.float(), oy.float(), n_lm),
            window=window, pixel_bytes=1,
            op=lambda x, w, lv, cs: detect_cascade_fused_frames(
                frames, idx, oy, ox, x, w, window, lv, cs, 4, 16, *eyes,
                quantize=det.quantize),
            twin=lambda x, w, lv, cs: detect_cascade_fused_frames_reference(
                frames, idx, oy, ox, x, w, window, lv, cs, *eyes,
                quantize=det.quantize)),
        "cascade_fused": dict(
            x0=x_img - rows_shift(wox, woy, n_lm),
            window=tuple(windows.shape[1:]), pixel_bytes=2,
            op=lambda x, w, lv, cs: detect_cascade_fused(
                windows, x, w, lv, cs, 4, 16, *eyes, quantize=det.quantize),
            twin=lambda x, w, lv, cs: detect_cascade_fused_reference(
                windows, x, w, lv, cs, *eyes, quantize=det.quantize)),
    }
    weights_bytes = det.weights.tensor.numel() * 2
    for name, path in paths.items():
        x = path["x0"]
        level_x, level_err = [], 0.0
        for li, level in enumerate(det.levels):
            w1 = prepare_weights([model.sdo.regressors[li].weights])
            one = ((level,), (det.cell_sizes[li],))
            got = path["op"](x, w1, *one)
            ref = path["twin"](x, w1, *one)
            err = float((got - ref).abs().max())
            log(f"[fused] {name} level {li} vs twin from equal rows: max "
                f"{err:.3e} px (tolerance {FUSED_LEVEL_PX})")
            check(err <= FUSED_LEVEL_PX,
                  f"{name} disagrees with its twin at level {li}")
            level_x.append(x)
            level_err = max(level_err, err)
            x = ref
        args = (path["x0"], det.weights, det.levels, det.cell_sizes)
        got = path["op"](*args)
        ref = path["twin"](*args)
        whole = cascade_compare(torch, name, (got - ref).abs().amax(dim=1))
        ms, runs = cuda_time_ms(path["op"], *args)
        plain_ms, _ = cuda_time_ms(path["twin"], *args, reps=3, warmup=1)
        torch.cuda.empty_cache()
        b_bytes, b_ops, read = cascade_bound(
            torch, model, det, level_x, path["window"], path["pixel_bytes"],
            weights_bytes)
        torch.cuda.empty_cache()
        bound = max(b_bytes, b_ops)
        log(f"[fused] {name}: kernel {ms:.4f} ms median of {len(runs)} (min "
            f"{min(runs):.4f}) | plain twin {plain_ms:.2f} ms | bound "
            f"{bound * 1e3:.4f} ms (bytes {b_bytes * 1e3:.4f} ms with "
            f"{read} window pixels; operations {b_ops * 1e3:.4f} ms) -> "
            f"{ms / (bound * 1e3):.1f}x the bound")
        results[name] = dict(level_err_px=level_err, whole=whole, ms=ms,
                             plain_ms=plain_ms, bound_bytes_ms=b_bytes * 1e3,
                             bound_ops_ms=b_ops * 1e3, read_pixels=read)
    del windows
    torch.cuda.empty_cache()
    results["cascade_fused_frames"]["launches"] = launches[
        "cascade_fused_frames"]
    results["cascade_fused"]["launches"] = launches4["cascade_fused"]

    # image_indices against the expanded per-face stack
    n_exp = 256
    expanded = det(frames[idx[:n_exp].long()], boxes[:n_exp])
    same = bool(torch.equal(expanded, out[:n_exp]))
    log(f"[fused] image_indices vs the expanded stack, first {n_exp} faces: "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    check(same, "image_indices rows differ from the expanded stack's")

    # the card against the port's CPU path
    cpu_model = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"), device="cpu")
    cpu_det = cpu_model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    cpu_out = cpu_det(torch.from_numpy(data["stack"]), data["boxes_np"][:32],
                      image_indices=data["sel"][:32])
    cpu_delta = float((out[:32].cpu() - cpu_out).abs().max())
    log(f"[fused] card vs the CPU plain path, first 32 faces: max "
        f"{cpu_delta:.3e} px (tolerance {FUSED_WHOLE_PX})")
    check(cpu_delta <= FUSED_WHOLE_PX, "fused card rows differ from the CPU")

    # accuracy against ground truth and the exact stepped path
    err = float(normalised_landmark_errors(
        out, data["gt"], data["r_idx"], data["l_idx"]).mean())
    per_face = (out - exact_rows).abs().amax(dim=1)
    vs_exact = float(per_face.max())
    above = float((per_face > 0.26).float().mean())
    log(f"[fused] train-set IOD error {err:.6f}; vs the exact stepped path "
        f"max {vs_exact:.4f} px (bound {FUSED_WHOLE_MAX_PX}), "
        f"{100 * above:.2f}% of faces above 0.26 px")
    check(vs_exact <= FUSED_WHOLE_MAX_PX,
          f"fused rows {vs_exact} px from the exact path")

    # end-to-end detect times, both paths
    timing = {}
    for name, images in (("frames (K3)", frames), ("crop (K4)",
                                                  frames.float())):
        ms, runs = cuda_time_ms(det, images, boxes, image_indices=idx,
                                reps=20, warmup=3)
        timing[name] = dict(detect_ms=ms, faces_per_s=BATCH / ms * 1e3,
                            min_ms=min(runs), max_ms=max(runs))
        log(f"[fused] detect {name}: {ms:.3f} ms median of {len(runs)} (min "
            f"{min(runs):.3f}, max {max(runs):.3f}) -> "
            f"{BATCH / ms * 1e3:.0f} faces/s")
    torch.cuda.empty_cache()
    profile = phase_profile(
        torch, "fused detect (K3)",
        lambda: det(frames, boxes, image_indices=idx))
    return dict(kernels=results, timing=timing, iod_err=err,
                vs_exact_px=vs_exact, share_above_026=above,
                cpu_delta_px=cpu_delta, k3_vs_k4_px=k3_vs_k4,
                profile=profile)


def phase_profile(torch, label, call):
    """Where one detect call spends device time: torch.profiler kernel
    sums by name, and the device busy share of the call's wall."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
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
    log(f"[profile] {label} of {BATCH} faces: wall {wall_ms:.3f} ms "
        f"(profiled), kernels busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for ms, count, key in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[dict(ms=ms, count=count, name=key[:120])
                     for ms, count, key in rows[:20]])


def kernel_entries(results, k1_errs, k2_errs, fused):
    """One entry per kernel (K1 and K2 per sampling mode). max_abs_err is,
    for K1 and K2, the larger of the twin checks at the main path's inputs
    and those of the kernel phases; for K3 and K4 the largest per-level
    delta in px from equal rows. library_ms is null: no single PyTorch call
    computes HOG, the truncated, quantised window sampling or the
    cascade."""
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
    for name, r in fused["kernels"].items():
        source, replaces = SOURCES[name]
        b_bytes, b_ops = r["bound_bytes_ms"], r["bound_ops_ms"]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["level_err_px"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(b_bytes, b_ops),
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
    results, fast_vs_exact, exact_rows = phase_main(torch, data)
    stepped = data["model"].make_stepped_detector(
        BATCH, roi=ROI, sampling="exact", window_sampler=True,
        max_ied=data["max_ied"])
    profile = phase_profile(
        torch, "exact stepped detect",
        lambda: stepped(data["images"], data["boxes"]))
    del stepped
    fused = phase_fused(torch, data, exact_rows)
    entries = kernel_entries(results, k1_errs, k2_errs, fused)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=name, nvidia_smi=smi, results=results,
                       fast_vs_exact_px=fast_vs_exact, profile=profile,
                       fused=fused, kernels=entries,
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
