#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``superviseddescent_tpu_torch/csrc``,
holds each against its plain PyTorch twin on the card, then drives the two
serving paths with pretrained RCR-22 (``pretrained/rcr22_lfpw5.bin``) over
4,096 faces of the 120 ``.synth120`` images, and trains RCR-22 on them:

* the stepped detector,
  ``DetectionModel.make_stepped_detector(window_sampler=True, roi=512)``,
  in exact and fast sampling (K2 then K1 per level);
* the fused detector, ``DetectionModel.make_fused_detector(roi=512)``, on
  the unique 120-frame uint8 stack with ``image_indices`` (K3, one launch
  per call) and on the float32 stack (the crop path to K4);
* training, ``train_rcr(..., RcrTrainConfig(roi=512,
  patch_backend="fused"))``, on 1,024 faces x 11 initialisations = 11,264
  samples of the uint8 stack (K5, one launch per level, then the normal
  equations and the LU solve); a smaller run on the float32 stack in
  chunks of 512 samples (K6) and one with ``patch_backend="window"``
  (K2 + K1 under training).

Then the later phases:

* the probes P1-P5 (``python -m superviseddescent_tpu_torch.probes``'s
  ``run_all``) at the probe scripts' shapes, every variant against its plain
  twin, the G and pre variants against ``full``, P5 against its numpy
  emulation;
* COFW-29 and ibug-68 (``pretrained/rcr29_lfpw5.bin``, ``rcr68_lfpw5.bin``)
  over the same 4,096 faces through the fused detector (K3, and K4 on a
  float32 stack), the fused tracker and the stepped detector (K2 + K1,
  exact and fast);
* tracking: RCR-22 over a 256-frame clip in which one ``.synth120`` face
  drifts a few pixels per frame, through ``make_fused_track_scan``,
  ``make_fused_track_stream`` (chunk 1 and 8, depth 4) and the sequential
  detector / tracker chain with a read-back per frame;
* face detection (``models/facedetect.HaarCascadeDetector`` with the
  carried stock ``haarcascade_frontalface_alt2.xml`` and the apps'
  parameters) over all 120 images, ``detect_batch`` per size class: the
  card's raw and grouped boxes against the port's CPU path on one image per
  class, the overflow fallbacks forced once, ``check_face`` against the
  ``.pts`` files, ms per call and frames/s per class, ``detect`` at batch 1
  and ``detect_stream`` on the largest class, its profiled split
  (``record_function`` ranges) and peak memory. It runs no hand-written
  kernel: its products are ``torch.matmul``;
* the apps and examples (``phase_apps``), each through its ``main(argv)``
  on the card with inputs written to a temporary directory: ``rcr_train``
  on the 96 .synth120 pairs of identities 0-3 with ``--roi 512
  --patch-backend window --facebox-source cascade:<carried xml>`` and the
  24 of identity 4 as ``-t`` (K2 and K1 once per level; the held-out error
  below the mean initialisation's), ``rcr_detect -f -o`` on one image of
  each size class (landmarks against the CPU run), ``rcr_track
  --face-detector`` over a 64-frame clip with one frame that loses the face,
  at depth 1 and 4 and with ``--scan`` (K3 launches = the fused fits the app
  reports; rows equal ``make_fused_track_stream``'s), and the three
  examples with their tests' checks.

    python3 chip_smoke.py --apps

runs only that phase after the builds. Then the JPEG phase
(``phase_jpeg``): the committed fixtures of ``tests/torch_jpeg`` (the card
has no PIL; PIL's sha256 digests in their manifest) through the host C++
entropy decoder and J1 (``csrc/jpeg_decode.cu``): every still (baseline,
progressive, multi-scan, CMYK / YCCK, 4:1:1 / 4:4:0, other sampling
factors) as grey and RGB against PIL's digests and bit for bit against
J1's twin, the host coefficients against the Python twin's and a
progressive still's against the baseline still's of the same pixels; per
768 x 1024 frame of the 16-frame baseline and progressive clips (the same
pixels; each progressive frame's host coefficients equal the baseline
frame's) the host entropy ms, J1's device ms (torch.profiler) beside its
bound and its twin's, ``load_gray_image`` of each clip against the PNG
of the same pixels, all in turns; ``rcr_track`` on the progressive clip,
the baseline clip and those PNG frames at depth 1 and 4 and ``--scan``
(rows equal; K3 launches = fused fits, J1 launches = JPEG frames), and
``rcr_detect -i still.jpg -f -o out.jpg`` on a baseline, a progressive
and a CMYK still (J1 twice and J2 once each, the file the CPU twins'
bytes).

    python3 chip_smoke.py --jpeg

runs only that phase after the builds. Then the image-io phase
(``phase_imageio``): kernel J2 (``csrc/jpeg_encode.cu``, the JPEG
writer's forward pixel stage) against its twin bit for bit, on random
pixels of every size to 33 x 33 and on the committed stills' and clip
frames' decoded pixels (grey, 4:4:4, 4:2:2, 4:2:0 at qualities 50, 75,
95; ``tests/torch_imageio/manifest.json``), every file J2 and the host
coder write equal to PIL's digest; the PNG and TIFF files of the same
decoded pixels and of two drawn stills against PIL's digests (each PNG's
filtered rows always; the whole file, which PIL's zlib wrote, with the
card's zlib named); every committed BMP / PNM / TIFF / GIF fixture read
to PIL's digests; ``rcr_track -o`` over the 16-frame
JPEG clip (``f000.jpg`` ... written, each the CPU twins' encoding of the
frame drawn with the rows the run reported; J1 twice, J2 once a frame);
``rcr_detect -o`` to ``.jpg``, ``.png``, ``.bmp``, ``.ppm`` and ``.tif``
from a BMP, a PGM and a TIFF still, each file the writers' bytes; J2's device ms beside its bound, the host
coder's ms, ``write_jpeg`` against ``write_png``, ``rcr_track -o`` ms a
frame and each reader's ms on a full-size still.

    python3 chip_smoke.py --imageio

runs only that phase after the builds. Then GIF and WebP writing
(``phase_imagewrite``): every fixture of the manifest's ``gif_writes`` and
``webp_writes`` (pixels from ``tests/torch_write_inputs.py``'s recipes,
read on the card where a recipe reads a file) written by ``write_image``
from a card tensor through the host C++ coders of ``csrc/gif_encode.cu``
(PIL's median-cut quantiser and LZW) and ``csrc/webp_encode.cu``
(libwebp's lossy encoder at PIL's defaults), each file equal to PIL's
digest, no kernel launched; ``rcr_detect -o .gif`` and ``-o .webp`` on a
``.synth120`` still equal to the JAX app's files (digests from a CPU
run); the host ms per 768 x 1024 frame of both coders and their Python
twins beside ``encode_png`` and ``encode_jpeg`` (J2 and its host coder).

    python3 chip_smoke.py --imagewrite

runs only that phase after the builds. Then the TIFF / PFM / WebP phase
(``phase_tiffwebp``): every fixture of the TIFF kinds (one per key of
PIL's ``OPEN_INFO``), the compressed kinds, JPEG-in-TIFF, PFM and lossless
WebP in ``tests/torch_imageio`` read on the card to PIL's digests (a
JPEG-compressed TIFF through J1, its batch of strips or tiles against
J1's twin; WebP through the host C++ decoder, against the Python twin on
the small files; a kind PIL cannot read refused by name);
the rest of the TIFF files PIL reads (BigTIFF, CCITT RLE / Group 3 /
Group 4 and Zstandard through the host C++ decoders of
``csrc/tiff_decode.cu``, each against its Python twin, and YCbCr under
the lossless compressions; a JPEG-compressed BigTIFF through J1);
the clip frame's pixels as a lossless WebP, a JPEG-in-TIFF as PIL's
writer and as libtiff's lay it out, a JPEG-compressed BigTIFF, a
Zstandard TIFF, a YCbCr 2x2 LZW TIFF, a CCITT RLE TIFF (coded here from
the frame's grey), an I;16 and an F TIFF and a PFM
through ``load_gray_image`` (each frame equal to the pixels the kind
holds) and K3 on the 4,096 faces' boxes (rows equal to those of the same
pixels as PNG; J1 once a JPEG-in-TIFF, K3 once a kind); each reader's ms
on that 768 x 1024 frame, the CCITT and Zstandard host decoders' ms
(C++ and twin) and J1's device ms on each JPEG-in-TIFF layout
(and on strips of 80 rows, the worst case of two launches) beside its
twin and its bound.

    python3 chip_smoke.py --tiffwebp

runs only that phase after the builds. Then the lossy WebP phase
(``phase_webp_lossy``): every lossy fixture of ``tests/torch_imageio``
(group ``webp_lossy``) through the host C++ entropy stage (against the
Python twin) and kernels W1, W2 and W3 of ``csrc/vp8_pixels.cu``, each
against its twin on the same inputs, the planes after W2 against
libwebp's ``WebPDecodeYUV`` digests, RGB and grey against PIL's and an
ALPH chunk's alpha against PIL's, W1 and W2 also at 1, 2 and 5 rows in
flight against the plan's, W3 also at COLOUR_SWEEP rows a band; the lossy
clip frame through
``load_gray_image`` (W1-W3 once each) and K3 on the 4,096 faces' boxes,
rows equal to those from the PNG of its pixels; ``rcr_detect -i`` on
that frame, landmarks and drawing equal to those from the PNG; the host
entropy ms, W1-W3's device ms beside their twins', their byte bounds and
the wavefront's critical path, ``load_gray_image`` ms against the PNG and
the JPEG of the same frame, W1 and W2 on a frame ten times as wide
(``webp_wide_frame``), W1's and W2's split (``webp_times``:
measurement builds with the hand-off alone and the work alone) and W3's
(``colour_times``: RGB and grey, warm and with the L2 flushed, whole,
without its stores, without its loads, and an empty kernel on its grid).

    python3 chip_smoke.py --webp [--sweep] [--package-root DIR]

runs only that phase after the builds; with ``--package-root`` also W1-W3
of another checkout (e.g. the package of commit eeb94ea, W3 a thread an
output sample, or ceed2b4, a CTA a macroblock row, unpacked into a
git-ignored directory under ``build/``; its split where its source has the
measurement builds, or is one of those commits', then through a copy with
SPLIT_PATCHES' lines in), in a child process, in the order other, this,
this, other; with ``--sweep`` also W1 and W2 at WEBP_SWEEP rows a CTA and
WEBP_IN_FLIGHT rows in flight, and W3 at COLOUR_SWEEP rows a band;

    python3 chip_smoke.py --j1 [--j2] [--sweep] [--package-root DIR]

times only J1 on the baseline clip's first frame, grey and RGB (``--j2``:
J2 on its RGB at 4:2:0 q75; both flags: both), each kernel by name, with
``--package-root`` another checkout's kernels beside them (e.g. the
parent's, unpacked into ``build/parent/``: its two J1 launches by name),
in the order other, this, this, other; then this tree's split of each
kernel (staging, transform, stores) from its measurement builds and,
with ``--sweep``, each kernel at the other launch plans ``J1_SWEEP`` /
``J2_SWEEP``, each output held against its twin. Then JPEG 2000
(``phase_j2k``): every committed fixture of ``tests/torch_j2k/`` (a
16,400 px wide one among them) through the host C++ stage, D1 and M1 to
PIL's RGB and grey digests (D1 exactly its plan's launches and M1 once a
read, no other kernel; both of M1's paths taken), every file PIL
cannot read refused; D1 and M1 against their twins on both 768 x 1024
clip frames (9/7 RPCL, 5/3 in 256 x 256 tiles) and on small tiled,
offset and subsampled files, the host stage against its Python twin on
both frames; the 9/7 frame through ``load_gray_image`` and K3 (rows equal
to its PNG's; the main path's counts); ``rcr_detect -i`` on it with the
manifest's face box, the landmarks within J2K_DETECT_PX of the JAX app's
and equal to those from its PNG; the host stage's ms beside its twin's,
D1 and M1 warm and L2-flushed beside their twins' and bounds, and
``load_gray_image`` against PNG and JPEG.

    python3 chip_smoke.py --j2k [--package-root DIR]

runs only that phase after the builds, then D1 and M1 on both clip
frames, warm and L2-flushed, whole and in their measurement builds
(``J2K_BUILDS``; D1's launches by kernel, and for a D1 of a line a CTA
its row and column passes apart), with ``--package-root`` another
checkout's beside them (e.g. the parent's, unpacked into
``build/parent/``, with ``SPLIT_PATCHES``' lines in), in the order
other, this, this, other. Last, the phase of the
port's last
slice (``phase_remainder``): ``train_rcr`` with the dense sampler and K1
on the 1,408 samples of the window run in exact, high and fast sampling
(chunks sized by memory, the peak printed, K1 4 launches a call and each
level's K1 against its twin on the run's own patches, the sampler's
precision contracts at each level's rows, every model against the
gather-trained model and the pretrained one); ``rcr_train
--patch-backend dense --sampling high`` on the apps' inputs; data parallel
on the one card: a 1-rank NCCL group through ``train_rcr(mesh=)`` (the
single-process weights), then two gloo ranks sharing cuda:0, spawned after
the builds, for ``train_rcr(mesh=)`` on the fused backend (K5 per rank)
and the window backend (K2 + K1 per rank), an all-reduce of the 8,801^2
AtA and ``sharded_detect_fused`` over the 4,096 faces (K3 per rank); and a
checkpointed fused run resumed after its second level.

    python3 chip_smoke.py --remainder

runs only that phase after the builds.

Where K3 spends its time is read at 4,096 faces of each family and at
batch 1 (``k3_split``): the kernel beside measurement builds of its source
that skip the GEMV or the landmark bodies or clock each phase, K5 over the
same faces. K3 at batch 1 and P4 are also timed with the L2 flushed
before each launch, and K3 through its entry point at the batch sizes
``K3_BATCHES`` (``k3_batches``), beside the kernel before its redesign.

    python3 chip_smoke.py --k3-batches [--plans] [--package-root DIR]

times only that, for RCR-22 and ibug-68: with ``--plans`` beside other
launch plans, with ``--package-root`` the package of another checkout.

Where K1 and K2 spend their time is read at each level of the RCR-22
stepped detector, exact and fast (``k12_split``): each kernel beside a
measurement build of its source (K1 without its splat, K2 without its
stores) and thread 0's cycles per phase. The stepped phases print each
level's K2 and K1 device time (torch.profiler) beside its bound and the
recorded time of the kernels before their redesign (``K12_BEFORE_MS``,
in the log only).

    python3 chip_smoke.py --k12 [--sweep] [--package-root DIR]

times only K2 and K1 per level of the stepped detector for RCR-22, COFW-29
and ibug-68, exact and fast, through their entry points (and, for this
checkout's package, ``k12_split``; with ``--sweep`` also at other numbers
of patches per block); with ``--package-root`` the package of another
checkout.

Where K5 spends its time is read at each level of the training replay
(``k5_split``): the kernel beside a measurement build of its source that
stores no row, and thread 0's cycles per phase. The training phase also
times the Cholesky solve of each level's normal equations beside the LU
that training keeps, with the same float64 backward-error check.

    python3 chip_smoke.py --k5 [--sweep] [--package-root DIR]

times only K5 and K6: K5 at each level of the RCR-22 training replay
(11,264 samples) and over the 4,096 faces of RCR-22, COFW-29 and ibug-68,
K6 at each level of the 1,408-sample windows run, each held against its
twin with the count of unequal entries, beside the warm ``train_rcr`` and
its trained model's error (and, for this checkout's package, ``k5_split``;
with ``--sweep`` also at the launch plans ``K5_SWEEP``); with
``--package-root`` the package of another checkout.

The probes' phase prints each P1-P3 variant's and ABDE's device time
(torch.profiler) beside its bound, its twin's time and the recorded time
of the kernel before its redesign (``PROBE_BEFORE_MS``, in the log only),
and the device time of an empty kernel, the launch floor under C and C4
(one kernel for both since their redesign: no scratch, one 16-byte word a
thread).

    python3 chip_smoke.py --probes [--sweep] [--package-root DIR]

times only the probes: every P1-P3 variant, G and pre at the probe
scripts' shapes and the three P5 kernels, through their entry points,
each held against its twin, with P1 ``full``'s split (``probe_split``:
measurement builds without stores and without window reads, thread 0's
cycles per phase) and the launch floor; with ``--package-root`` also
another checkout's package, in a child process, in the order other, this,
this, other, side by side; with ``--sweep`` also P1 ``full`` at other
launch plans (``PROBE_SWEEP``).

It checks each path's launch counts, each kernel against its twin at the
path's own inputs, the rows against the port's CPU path, the train-set IOD
error and the fused rows against the exact stepped rows, the trained
regressors against their normal equations in float64 and the trained
model's error against the pretrained model's, and times the detectors,
the training and each kernel with CUDA events.

Any failed check exits non-zero. The last line of standard output is the
JSON result; the line before it lists every kernel with its times and
bounds. Full results also go to ``build/chip_smoke.json``.
"""

import ctypes
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
# training: 1,024 faces x (1 + 10 perturbations), the shape of the JAX
# package's 300-W-scale training benchmark; the smaller runs use 128 faces
TRAIN_FACES = 1024
TRAIN_FACES_SMALL = 128
TRAIN_CHUNK = 512
# K5 / K6 against their twins: the same float32 operations in the same
# order, so equal up to a last bit of a block factor
FEATURES_ATOL = 1e-6
# a level's float32 LU solution W against its regularised normal equations,
# the matrices recomputed in float64 from the level's rows: the residual
# r = (AtA + diag) W - Atb as the normwise backward error
# ||r|| / (||AtA + diag|| ||W|| + ||Atb||), which a float32 solve keeps at a
# few eps (eps = 1.19e-7; TF32 products would leave about 1e-4). The same
# check reads as a limit on the relative residual ||r|| / ||Atb|| that is
# computed in the run for each level: the float32 rounding of AtA leaves a
# residual of the size eps * ||AtA|| * ||W||, a larger share of ||Atb|| at
# the later levels, where the right-hand side (the remaining landmark error)
# is small, so no one fixed number is tight at every level.
BACKWARD_ERROR_LIMIT = 1e-6
# tracking: frames of the clip, and how far the face moves per frame
CLIP_FRAMES = 256
CLIP_STEP_PX = 3
# the tracker stays on the face: every frame's IOD error below the bound the
# JAX package's family benchmark holds a served model to
TRACK_IOD_LIMIT = 0.1
# copies of the clip's face (each with 1 + 10 perturbed initialisations) that
# the tracking model is trained on
TRACK_TRAIN_COPIES = 48
FAMILIES = (29, 68)
# fused rows against the exact stepped rows, max px over all faces and
# coordinates: the JAX package's 0.75 px bound (RCR-22, tests/test_detectors.py)
# holds for COFW-29; ibug-68 takes the max over three times the coordinates
# and reaches 0.90 px (.synth120 face 74), where the JAX package's own fused
# kernel lies 0.91 px from its own exact stepped detector
# (tests/test_torch_families_bound.py), so its limit is 1 px
FAMILY_VS_EXACT_PX = {29: FUSED_WHOLE_MAX_PX, 68: 1.0}
# faces of the per-level twin checks of a family (the whole cascade is held
# against its twin on all of BATCH)
FAMILY_LEVEL_FACES = 1024
_CSRC = "superviseddescent_tpu_torch/csrc/"
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
    "features_fused_frames": (
        "superviseddescent_tpu_torch/csrc/features_fused.cu",
        "superviseddescent_tpu/ops/cascade_pallas.py:926"),
    "features_fused": ("superviseddescent_tpu_torch/csrc/features_fused.cu",
                       "superviseddescent_tpu/ops/cascade_pallas.py:773"),
    "probe_sampler": (_CSRC + "probe_sampler.cu",
                      "scripts/probe_sampler.py:58"),
    "probe_sampler_g": (_CSRC + "probe_sampler.cu",
                        "scripts/probe_sampler_g.py:47"),
    "probe_sampler_pre": (_CSRC + "probe_sampler.cu",
                          "scripts/probe_sampler_pre.py:50"),
    "probe_flatout": (_CSRC + "probe_flatout.cu",
                      "scripts/probe_flatout.py:32"),
    "probe_abde": (_CSRC + "probe_dyn.cu", "scripts/probe_dyn.py:94"),
    "probe_c": (_CSRC + "probe_dyn.cu", "scripts/probe_dyn.py:126"),
    "probe_c4": (_CSRC + "probe_dyn.cu", "scripts/probe_dyn.py:153"),
    # J1 replaces no pallas_call: the JAX package's image reader; its
    # samples source (a lossless JPEG's samples) neither
    "jpeg_decode": (_CSRC + "jpeg_decode.cu",
                    "superviseddescent_tpu/ops/patches.py:279"),
    "jpeg_samples": (_CSRC + "jpeg_decode.cu",
                     "superviseddescent_tpu/ops/patches.py:279"),
    # J2 replaces no pallas_call: the JAX apps' PIL writer (img.save)
    "jpeg_encode": (_CSRC + "jpeg_encode.cu",
                    "superviseddescent_tpu/apps/rcr_detect.py:76"),
    # W1-W3 replace no pallas_call: the JAX package's image reader
    "vp8_reconstruct": (_CSRC + "vp8_pixels.cu",
                        "superviseddescent_tpu/ops/patches.py:279"),
    "vp8_filter": (_CSRC + "vp8_pixels.cu",
                   "superviseddescent_tpu/ops/patches.py:279"),
    "vp8_colour": (_CSRC + "vp8_pixels.cu",
                   "superviseddescent_tpu/ops/patches.py:279"),
    # D1 and M1 replace no pallas_call: the JAX package's image reader
    "j2k_idwt": (_CSRC + "j2k_pixels.cu",
                 "superviseddescent_tpu/ops/patches.py:279"),
    "j2k_colour": (_CSRC + "j2k_pixels.cu",
                   "superviseddescent_tpu/ops/patches.py:279"),
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


# measurement builds of K3 / K4's source for k3_split, never entry points
SPLIT_BUILDS = (("CASCADE_SKIP_GEMV",), ("CASCADE_SKIP_BODY",),
                ("CASCADE_PHASE_CLOCKS",))


# measurement builds of K1's and K2's sources for k12_split, never entry
# points: K1 without its splat, K2 without its stores, and each with thread
# 0's cycles per phase
K12_BUILDS = (("hog_flat", ("HOG_SKIP_SPLAT",)),
              ("hog_flat", ("HOG_PHASE_CLOCKS",)),
              ("patches_window", ("PATCHES_SKIP_STORE",)),
              ("patches_window", ("PATCHES_PHASE_CLOCKS",)))
K1_PHASES = ("staging", "gradients and bins", "splat", "energy", "channels")
K2_PHASES = ("taps", "sampling", "write-out")
# measurement builds of K5 / K6's source for k5_split, never entry points:
# every channel computed and no row stored, and thread 0's cycles per phase
K5_BUILDS = (("features_fused", ("FEATURES_SKIP_STORE",)),
             ("features_fused", ("FEATURES_PHASE_CLOCKS",)))
K5_PHASES = ("IED, tent and cell table", "taps", "sampling",
             "gradients and x contraction", "y contraction and energy",
             "channels", "row stores")
# K5 launch plans (samples per block, landmarks per group, threads) that
# ``--k5 --sweep`` times beside features_launch_plan's at each training level
K5_SWEEP = ((1, 4, 256), (2, 2, 256), (1, 5, 256), (1, 6, 256), (1, 8, 256),
            (1, 2, 128), (1, 3, 128), (1, 4, 128), (2, 2, 128))


def phase_build(j2k=False):
    """Every kernel and the measurement builds, in parallel; D1's and M1's
    (``J2K_BUILDS``) only with ``j2k`` (``--j2k``, which alone runs
    them)."""
    from superviseddescent_tpu_torch.ops._build import build_all
    logs = build_all(extra=[("cascade_fused", d) for d in SPLIT_BUILDS]
                     + list(K12_BUILDS) + list(K5_BUILDS)
                     + list(JPEG_BUILDS)
                     + [("vp8_pixels", (d,)) for _, d in WEBP_BUILDS]
                     + [("vp8_pixels", (d,)) for _, d in COLOUR_BUILDS]
                     + [("j2k_pixels", (d,)) for _, d, _ in J2K_BUILDS
                        if j2k])
    log(f"[build] K1-K6, J1, J2, W1-W3, D1, M1, the host decoders and "
        f"coders, the probes and K1's, K2's, K3's, "
        f"K5's, J1's, J2's, W1's, W2's, W3's"
        + (", D1's and M1's" if j2k else "") + " measurement builds in "
        f"{logs.pop('seconds'):.2f} s (nvcc, sm_90a, one process per build)")
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
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.ops.patches import (
        load_gray_image, stack_images)
    import numpy as np
    t0 = time.perf_counter()
    model = DetectionModel.load(
        os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"))
    files = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))
    check(len(files) == 120, f"expected 120 .synth120 images, {len(files)}")
    images = [load_gray_image(f) for f in files]
    pts = [read_pts_landmarks(f[:-4] + ".pts") for f in files]
    stack, _ = stack_images(images, dtype=np.uint8, pad_width_to=128)
    sel = np.arange(BATCH) % len(files)
    faces = family_data(torch, dict(pts=pts, sel=sel), model)
    stack_dev = torch.from_numpy(stack).cuda()
    sel_dev = torch.from_numpy(sel).cuda()
    data = dict(
        model=model, stack=stack, sel=sel, boxes_np=faces["boxes_np"],
        frames=stack_dev, sel_dev=sel_dev.int(), images=stack_dev[sel_dev],
        boxes=faces["boxes"], gt=faces["gt"], r_idx=faces["eyes"][0],
        l_idx=faces["eyes"][1], max_ied=faces["max_ied"],
        image_boxes=faces["image_boxes"], image_gt=faces["image_gt"],
        pts=pts, image_shapes=[im.shape for im in images])
    torch.cuda.synchronize()
    log(f"[data] model + {len(files)} images decoded in "
        f"{time.perf_counter() - t0:.1f} s; stack {tuple(stack.shape)} uint8;"
        f" {BATCH} faces; max_ied {data['max_ied']:.2f} px")
    return data


def phase_sampler(torch, data):
    """K2 against its plain twin on .synth120 windows at roi 512, at each
    level of the stepped detector on 256 faces, in both layouts."""
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, sample_patches_window, sample_patches_window_reference)
    model = data["model"]
    errs = {"exact": 0.0, "fast": 0.0}
    n = 256
    for sampling in ("exact", "fast"):
        det = model.make_stepped_detector(
            n, roi=ROI, sampling=sampling, window_sampler=True,
            max_ied=data["max_ied"])
        for li, windows, args, kw, _ in stepped_levels(
                model, det, data["images"][:n], data["boxes"][:n]):
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


def window_level_vs_twins(torch, label, li, windows, args, skw, hkw,
                          twin_faces=None):
    """K2 then K1 against their plain twins on one level's own arguments
    (``HogTransform.window_args``): K2 must equal its twin, K1 stay within
    K1_RTOL / K1_ATOL. Each kernel is launched once on all N faces; the
    twins, which treat every face alone, run on ``twin_faces`` faces at a
    time (default: all at once) and every face is compared. Returns (K2
    error, K1 error, the (N*L, S*S) patches, K1's descriptors)."""
    from superviseddescent_tpu_torch.ops.hog_flat import (
        hog_descriptor_flat, hog_descriptor_flat_reference)
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, sample_patches_window, sample_patches_window_reference)
    s = args[4]
    n, l = args[1].shape
    step = twin_faces or n
    oxy, sp = _prepare(args[1], args[2], args[3], s)
    w = skw["sub_window"] or windows.shape[1]
    wx = skw["sub_window_x"] or windows.shape[2]
    got = sample_patches_window(*args, **skw)
    k2_err = 0.0
    for a in range(0, n, step):
        ref = sample_patches_window_reference(
            windows[a:a + step], oxy[a:a + step], sp[a:a + step], s, w, wx,
            skw["quantize"], skw["sampling"], skw["transposed"],
            skw["out_dtype"])
        k2_err = max(k2_err, float(
            (got[a:a + step].float() - ref.float()).abs().max()))
        del ref
    log(f"[check] {label} level {li} (S={s} W={w} WX={wx}): K2 vs twin on "
        f"{n * l} patches max abs {k2_err:.1f} (tolerance: equal)")
    check(k2_err == 0.0, f"K2 differs from its twin on the path of {label} "
          f"at level {li}")
    patches = got.reshape(n * l, s * s)
    desc = hog_descriptor_flat(patches, **hkw)
    k1_err, bad = 0.0, 0
    for a in range(0, n * l, step * l):
        ref = hog_descriptor_flat_reference(patches[a:a + step * l], **hkw)
        diff = (desc[a:a + step * l] - ref).abs()
        k1_err = max(k1_err, float(diff.max()))
        bad += int((diff > K1_ATOL + K1_RTOL * ref.abs()).sum())
        del ref, diff
    log(f"[check] {label} level {li}: K1 vs twin on {n * l} rows max abs "
        f"{k1_err:.3e} (tolerance rtol {K1_RTOL} + atol {K1_ATOL}; {bad} "
        f"outside)")
    check(bad == 0, f"K1 disagrees with its twin on the path of {label} at "
          f"level {li}")
    return k2_err, k1_err, patches, desc


def phase_main(torch, data):
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
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
        expect_counts(launches, f"stepped {sampling} detect", hog_flat=4,
                      patches_window=4)
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
        for li, windows, args, skw, hkw in stepped_levels(model, det, images,
                                                          boxes):
            p = model.hog_params[li]
            n, l, s = BATCH, len(model.landmark_ids), p.patch_size
            oxy, sp = _prepare(args[1], args[2], args[3], s)
            w = skw["sub_window"] or windows.shape[1]
            wx = skw["sub_window_x"] or windows.shape[2]
            ref_args = (windows, oxy, sp, s, w, wx, skw["quantize"], sampling,
                        skw["transposed"], skw["out_dtype"])

            k2_err, k1_err, patches, _ = window_level_vs_twins(
                torch, f"stepped {sampling}", li, windows, args, skw, hkw)
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
            k2_dev, k1_dev = k12_device_ms(torch, args, skw, hkw)
            before = k12_before("rcr22", sampling, li)
            level = dict(level=li, S=s, W=w, WX=wx,
                         k2_ms=k2_ms, k2_plain_ms=k2_plain,
                         k2_device_ms=k2_dev, k2_before_ms=before[0],
                         k2_bound_bytes_ms=k2_b[0] * 1e3,
                         k2_bound_ops_ms=k2_b[1] * 1e3,
                         k1_ms=k1_ms, k1_plain_ms=k1_plain,
                         k1_device_ms=k1_dev, k1_before_ms=before[1],
                         k1_bound_bytes_ms=k1_b[0] * 1e3,
                         k1_bound_ops_ms=k1_b[1] * 1e3,
                         split=k12_split(torch, windows, args, skw, hkw))
            results[sampling]["levels"].append(level)
            log(f"[level] {sampling} {li} S={s}: K2 {k2_ms:.4f} ms, device "
                f"{k2_dev:.4f} (recorded before the redesign {before[0]}; "
                f"plain {k2_plain:.3f}, bound {max(k2_b) * 1e3:.4f}) | K1 "
                f"{k1_ms:.4f} ms, device {k1_dev:.4f} (recorded before the "
                f"redesign {before[1]}; plain {k1_plain:.3f}, bound "
                f"{max(k1_b) * 1e3:.4f})")
            del patches
        del windows
        torch.cuda.empty_cache()
        levels = results[sampling]["levels"]
        log(f"[main] {sampling}: per detect call K2 device "
            f"{sum(lv['k2_device_ms'] for lv in levels):.4f} ms (recorded "
            f"before the redesign "
            f"{sum(lv['k2_before_ms'] for lv in levels):.4f}), K1 "
            f"{sum(lv['k1_device_ms'] for lv in levels):.4f} ms (recorded "
            f"before {sum(lv['k1_before_ms'] for lv in levels):.4f})")

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


def counted_ops():
    """Every kernel wrapper with a launch count, by kernel name."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames,
        extract_features_fused, extract_features_fused_frames)
    from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat
    from superviseddescent_tpu_torch.ops.j2k import j2k_colour, j2k_idwt
    from superviseddescent_tpu_torch.ops.jpeg import (
        jpeg_coefficients, jpeg_pixels, jpeg_samples)
    from superviseddescent_tpu_torch.ops.patches_window import (
        sample_patches_window)
    from superviseddescent_tpu_torch.ops.webp import (
        vp8_colour, vp8_filter, vp8_reconstruct)
    from superviseddescent_tpu_torch.probes.dyn import (
        probe_abde, probe_c, probe_c4)
    from superviseddescent_tpu_torch.probes.flatout import probe_flatout
    from superviseddescent_tpu_torch.probes.sampler import (
        probe_sampler, probe_sampler_g, probe_sampler_pre)
    return {"hog_flat": hog_descriptor_flat,
            "patches_window": sample_patches_window,
            "cascade_fused_frames": detect_cascade_fused_frames,
            "cascade_fused": detect_cascade_fused,
            "features_fused_frames": extract_features_fused_frames,
            "features_fused": extract_features_fused,
            "probe_sampler": probe_sampler,
            "probe_sampler_g": probe_sampler_g,
            "probe_sampler_pre": probe_sampler_pre,
            "probe_flatout": probe_flatout, "probe_abde": probe_abde,
            "probe_c": probe_c, "probe_c4": probe_c4,
            "jpeg_decode": jpeg_pixels, "jpeg_samples": jpeg_samples,
            "jpeg_encode": jpeg_coefficients,
            "vp8_reconstruct": vp8_reconstruct, "vp8_filter": vp8_filter,
            "vp8_colour": vp8_colour, "j2k_idwt": j2k_idwt,
            "j2k_colour": j2k_colour}


def zero_counts():
    for op in counted_ops().values():
        op.launches = 0


def read_counts():
    return {name: op.launches for name, op in counted_ops().items()}


def expect_counts(launches, what, **expected):
    """Fail unless the counts are exactly ``expected`` (0 where not named)."""
    want = {name: expected.get(name, 0) for name in launches}
    check(launches == want, f"{what}: expected launches {want}, got "
          f"{launches}")


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


# K3's times before its redesign, as PERF.md records them (NVIDIA H100 80GB
# HBM3, 700 W): 4,096 faces, and one face (profiler)
K3_BEFORE_MS = {"rcr22_4096": 10.49, "rcr22_batch1": 0.667,
                "rcr29_4096": 14.25, "rcr68_4096": 48.79}
PHASE_NAMES = ("IED and bias", "taps", "sampling", "gradients",
               "x contraction", "y contraction", "channels", "GEMV",
               "row update")


def k3_split(torch, det, frames, idx, oy, ox, window, x0, level_x):
    """Where K3's time goes, at one path's inputs: the kernel beside two
    measurement builds of its source (``-DCASCADE_SKIP_GEMV``: every
    landmark body runs and the update is zero, so each level repeats the
    rows it started from; ``-DCASCADE_SKIP_BODY``: no landmark body runs
    and the GEMV reads whatever the feature buffers hold), and K5 over the
    same faces from the same per-level rows ``level_x`` (the landmark
    bodies without a GEMV), each level held against its twin. The rest is
    the whole less the two parts. Measurement builds are launched here
    only; their launches do not count."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _check_config, _launch_args, _launch_frames,
        extract_features_fused_frames,
        extract_features_fused_frames_reference)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    l = x0.shape[1] // 2
    c = _check_config(l, det.weights, *window, det.levels, det.cell_sizes,
                      det.num_bins, det.dims, det.r_idx, det.l_idx)

    def launch(defines):
        lib = load_library("cascade_fused", defines)

        def call():
            out, args = _launch_args(x0, det.weights, det.levels,
                                     det.cell_sizes, det.r_idx, det.l_idx,
                                     *window, c, det.quantize, x0.device)
            _launch_frames(lib, frames, idx, oy, ox, args)
            return out
        return call
    whole = cuda_time_ms(launch(()))[0]
    body = cuda_time_ms(launch(SPLIT_BUILDS[0]))[0]
    gemv = cuda_time_ms(launch(SPLIT_BUILDS[1]))[0]
    # -DCASCADE_PHASE_CLOCKS: thread 0's cycles per phase, summed over the
    # blocks of one launch, as shares of the launch
    shares = phase_cycles(torch, "cascade_fused", "cascade_phase_cycles",
                          SPLIT_BUILDS[2], launch(SPLIT_BUILDS[2]),
                          PHASE_NAMES)
    k5, k5_err, k5_unequal = 0.0, 0.0, 0
    for li, (level, x) in enumerate(zip(det.levels, level_x)):
        k5args = (frames, idx, oy, ox, x, window, level, det.cell_sizes[li])
        k5 += cuda_time_ms(extract_features_fused_frames, *k5args,
                           det.num_bins, det.dims, det.r_idx, det.l_idx)[0]
        err, unequal = features_vs_twin(
            torch, f"K5 at K3's rows, {l} landmarks, level {li}",
            extract_features_fused_frames(*k5args, det.num_bins, det.dims,
                                          det.r_idx, det.l_idx),
            extract_features_fused_frames_reference(*k5args, det.r_idx,
                                                    det.l_idx))
        k5_err, k5_unequal = max(k5_err, err), k5_unequal + unequal
    split = dict(whole_ms=whole, body_ms=body, gemv_ms=gemv,
                 rest_ms=whole - body - gemv, k5_levels_ms=k5,
                 k5_max_abs_err=k5_err, k5_unequal=k5_unequal,
                 faces=x0.shape[0], phase_shares=shares)
    log(f"[split] K3 on {x0.shape[0]} faces: whole {whole:.4f} ms; landmark "
        f"bodies alone (GEMV skipped) {body:.4f} ms; GEMV alone (bodies "
        f"skipped) {gemv:.4f} ms; rest {whole - body - gemv:.4f} ms; K5 over "
        f"the same faces and levels {k5:.4f} ms")
    log("[split] phase shares (thread 0's cycles between barriers, a build "
        "with a barrier after the GEMV): " + ", ".join(
            f"{name} {100 * v:.1f}%" for name, v in shares.items()))
    return split


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
        detect_cascade_fused_frames_reference, detect_cascade_fused_reference)
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
    expect_counts(launches, "fused detect, frames path",
                  cascade_fused_frames=1)
    check(out.shape == (BATCH, 2 * n_lm) and bool(torch.isfinite(out).all()),
          "non-finite or misshapen fused rows")
    frames_f32 = frames.float()
    zero_counts()
    out4 = det(frames_f32, boxes, image_indices=idx)
    torch.cuda.synchronize()
    launches4 = read_counts()
    log(f"[fused] crop path (float32 stack): launches {launches4}")
    expect_counts(launches4, "fused detect, crop path", cascade_fused=1)
    check(bool(torch.isfinite(out4).all()), "non-finite K4 rows")
    k3_vs_k4 = float((out - out4).abs().max())
    log(f"[fused] K3 vs K4 rows: max {k3_vs_k4:.4f} px")

    # each kernel against its twin, per level (one-level op calls from
    # equal rows) and over the whole cascade, at the main path's inputs
    x_img = align_mean(model.mean[None], boxes)
    oy, ox, window = det.aligned_origins(frames, boxes)
    windows, wox, woy = det.crop(frames_f32, boxes, idx)
    del frames_f32
    paths = {
        "cascade_fused_frames": dict(
            x0=x_img - rows_shift(ox.float(), oy.float(), n_lm),
            window=window, pixel_bytes=1, rows=out,
            op=lambda x, w, lv, cs: detect_cascade_fused_frames(
                frames, idx, oy, ox, x, w, window, lv, cs, 4, 16, *eyes,
                quantize=det.quantize),
            twin=lambda x, w, lv, cs: detect_cascade_fused_frames_reference(
                frames, idx, oy, ox, x, w, window, lv, cs, *eyes,
                quantize=det.quantize)),
        "cascade_fused": dict(
            x0=x_img - rows_shift(wox, woy, n_lm),
            window=tuple(windows.shape[1:]), pixel_bytes=2, rows=out4,
            op=lambda x, w, lv, cs: detect_cascade_fused(
                windows, x, w, lv, cs, 4, 16, *eyes, quantize=det.quantize),
            twin=lambda x, w, lv, cs: detect_cascade_fused_reference(
                windows, x, w, lv, cs, *eyes, quantize=det.quantize)),
    }
    weights_bytes = det.weights.tensor.numel() * 2
    for name, path in paths.items():
        r = fused_vs_twin(torch, name, model, det, path["op"], path["twin"],
                          path["x0"], x_img - path["x0"], path["rows"], BATCH)
        args, plain_ms = r.pop("args"), r["plain_ms"]
        ms, runs = cuda_time_ms(path["op"], *args)
        if name == "cascade_fused_frames":
            r["split"] = k3_split(torch, det, frames, idx, oy, ox, window,
                                  path["x0"], r["level_x"])
        torch.cuda.empty_cache()
        b_bytes, b_ops, read = cascade_bound(
            torch, model, det, r.pop("level_x"), path["window"],
            path["pixel_bytes"], weights_bytes)
        torch.cuda.empty_cache()
        bound = max(b_bytes, b_ops)
        log(f"[fused] {name}: kernel {ms:.4f} ms median of {len(runs)} (min "
            f"{min(runs):.4f}) | plain twin {plain_ms:.2f} ms | bound "
            f"{bound * 1e3:.4f} ms (bytes {b_bytes * 1e3:.4f} ms with "
            f"{read} window pixels; operations {b_ops * 1e3:.4f} ms) -> "
            f"{ms / (bound * 1e3):.1f}x the bound")
        results[name] = dict(r, ms=ms, bound_bytes_ms=b_bytes * 1e3,
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
        torch, "fused detect (K3)", f"{BATCH} faces",
        lambda: det(frames, boxes, image_indices=idx))
    return dict(kernels=results, timing=timing, iod_err=err,
                vs_exact_px=vs_exact, share_above_026=above,
                cpu_delta_px=cpu_delta, k3_vs_k4_px=k3_vs_k4,
                profile=profile)


def features_bound(torch, p, level, x, window_shape, pixel_bytes, eyes,
                   num_features):
    """Least time for one level's feature extraction (K5 / K6): the bytes
    of each sample's tapped window pixels (the union over its landmarks,
    read once), the landmark rows and origins, and the N x F float32 rows
    written once, against K2's and K1's float32 operations at 67 TFLOP/s
    (``cascade_bound``'s count for one level, less the GEMV)."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        level_patch_half)
    from superviseddescent_tpu_torch.ops.patches_window import (
        _prepare, _tap_plan)
    ry, rx = window_shape
    n, l2 = x.shape
    l = l2 // 2
    s, w, wx, _ = level
    _, phw = level_patch_half(x, level, ry, rx, *eyes)
    oxy, sp = _prepare(x[:, :l], x[:, l:], phw, s)
    read = read_pixels(torch, (ry, rx),
                       [_tap_plan(ry, rx, oxy, sp, s, w, wx, True, True)])
    bytes_moved = (read * pixel_bytes + n * num_features * 4 + n * l2 * 4
                   + 3 * n * 4)
    ops = k1_bound(n * l, p, 2)[1] * F32_OPS_PER_S + n * l * s * s * 15
    return bytes_moved / MEM_BYTES_PER_S, ops / F32_OPS_PER_S, read


def phase_train(torch, data, pretrained_iod):
    """Training at full RCR-22 width. The main run: ``train_rcr`` with the
    fused backend on the uint8 frame stack (frames mode, K5), 11,264
    samples; then each level replayed from ``training_problem`` (the
    set-up ``train_rcr`` itself runs) to hold K5 against its twin at the
    path's own inputs, to time the level's stages and to check the solve.
    Then the windows path on the float32 stack (K6, chunked) and the
    window backend (K2 + K1), 1,408 samples each."""
    import numpy as np
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, normalised_landmark_errors, train_rcr,
        training_problem)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        extract_features_fused, extract_features_fused_frames_reference,
        extract_features_fused_reference)
    from superviseddescent_tpu_torch.ops.solver import (
        _solve_from_normal, normal_equations)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    model, frames = data["model"], data["frames"]
    ids = (model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
    eyes = (data["r_idx"], data["l_idx"])
    mean = model.mean.cpu().numpy()
    n_lm = len(model.landmark_ids)
    n_img = frames.shape[0]

    def train_set(n_faces):
        sel = np.arange(n_faces) % n_img
        return data["image_gt"][sel], data["image_boxes"][sel], sel

    def iod(rows, gt):
        return float(normalised_landmark_errors(rows, gt, *eyes).mean())

    def compare_rows(name, li, got, ref):
        check(bool(torch.isfinite(got).all()), f"{name}: NaN in the rows")
        diff = (got - ref).abs()
        err, unequal = float(diff.max()), int((got != ref).sum())
        log(f"[train] {name} level {li} vs twin on {got.shape[0]} samples x "
            f"{got.shape[1]} features: max abs {err:.3e}, {unequal} unequal "
            f"entries of {got.numel()} (tolerance {FEATURES_ATOL})")
        check(err <= FEATURES_ATOL, f"{name} disagrees with its twin at "
              f"level {li}")
        return err

    # ---- the main run: 11,264 samples through K5 ----
    cfg = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                         solver_method="lu")
    gt, bx, sel = train_set(TRAIN_FACES)
    args = (frames, gt, bx, *ids, mean, cfg)
    epoch_rows = []
    zero_counts()
    t0 = time.perf_counter()
    trained = train_rcr(*args, image_indices=sel, on_epoch=epoch_rows.append)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = read_counts()
    levels = len(cfg.hog_params)
    n = TRAIN_FACES * (cfg.num_perturbations + 1)
    log(f"[train] train_rcr(fused, roi {ROI}) on the uint8 stack, "
        f"{TRAIN_FACES} faces x {cfg.num_perturbations + 1} = {n} samples: "
        f"launches {launches}; {cold_s:.3f} s (first call)")
    expect_counts(launches, "train_rcr, fused frames mode",
                  features_fused_frames=levels)
    t0 = time.perf_counter()
    train_rcr(*args, image_indices=sel)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"[train] warm train_rcr (second call): {warm_s:.3f} s")
    profile = phase_profile(torch, "train_rcr (fused, K5)", f"{n} samples",
                            lambda: train_rcr(*args, image_indices=sel))
    check(len(epoch_rows) == levels and all(
        r.shape == (n, 2 * n_lm) and bool(torch.isfinite(r).all())
        for r in epoch_rows), "non-finite or misshapen training rows")
    for r in trained.sdo.regressors:
        check(r.weights.shape == (8801, 2 * n_lm)
              and bool(torch.isfinite(r.weights).all()),
              "non-finite or misshapen trained weights")

    # ---- each level replayed at the main path's own inputs ----
    prob = training_problem(*args, image_indices=sel)
    hog, x = prob.hog, prob.x0
    window = hog.frame_window
    fi, foy, fox = (t[hog.image_indices.long()] for t in hog.frame_table)
    stages, k5 = [], dict(err=0.0, ms=0.0, plain_ms=0.0, bytes_ms=0.0,
                          ops_ms=0.0)
    for li, p in enumerate(cfg.hog_params):
        level = train_level(hog, li, window)
        feats = hog(x, li)
        twin_args = (frames, fi, foy, fox, x, window, level, p.cell_size,
                     *eyes)
        ref = extract_features_fused_frames_reference(*twin_args)
        k5["err"] = max(k5["err"], compare_rows("K5", li, feats, ref))
        del ref
        k5_ms, _ = cuda_time_ms(hog, x, li, reps=10, warmup=2)
        plain_ms, _ = cuda_time_ms(extract_features_fused_frames_reference,
                                   *twin_args, reps=2, warmup=1)
        b_bytes, b_ops, read = features_bound(torch, p, level, x, window, 1,
                                              eyes, feats.shape[1])
        split = k5_split(torch, frames, fi, foy, fox, x, window, level,
                         p.cell_size, eyes)
        torch.cuda.empty_cache()
        reg = trained.sdo.regressors[li]
        norm = prob.sdo.normalisation(x)
        b = (x - prob.x_gt) * norm
        ne_ms, _ = cuda_time_ms(normal_equations, feats, b, reps=5, warmup=1)
        ata, atb = normal_equations(feats, b)
        solve_ms, _ = cuda_time_ms(_solve_from_normal, ata, atb, n,
                                   reg.regulariser, reg.method, reps=3,
                                   warmup=1)
        again = _solve_from_normal(ata, atb, n, reg.regulariser, reg.method)
        resolve_delta = float((again - reg.weights).abs().max())
        # Cholesky of the same regularised normal equations, timed beside
        # the LU that training keeps (solver_method "lu")
        chol_ms, _ = cuda_time_ms(_solve_from_normal, ata, atb, n,
                                  reg.regulariser, "cholesky", reps=3,
                                  warmup=1)
        w_chol = _solve_from_normal(ata, atb, n, reg.regulariser,
                                    "cholesky")
        del ata, atb, again
        upd_ms, _ = cuda_time_ms(lambda: x - reg.predict(feats) / norm,
                                 reps=10, warmup=2)
        # the level's solution against its normal equations in float64
        f64 = feats.double()
        lhs = f64.t() @ f64
        rhs = f64.t() @ b.double()
        del f64
        lhs.diagonal().add_(reg.regulariser.diagonal(lhs, n))
        w64 = reg.weights.double()
        r_norm = float(torch.linalg.norm(lhs @ w64 - rhs))
        rhs_norm = float(torch.linalg.norm(rhs))
        scale = (float(torch.linalg.norm(lhs))
                 * float(torch.linalg.norm(w64)) + rhs_norm)
        residual, backward = r_norm / rhs_norm, r_norm / scale
        residual_limit = BACKWARD_ERROR_LIMIT * scale / rhs_norm
        c64 = w_chol.double()
        chol_backward = float(torch.linalg.norm(lhs @ c64 - rhs)) / (
            float(torch.linalg.norm(lhs)) * float(torch.linalg.norm(c64))
            + rhs_norm)
        del lhs, rhs, w64, c64, w_chol
        x_next = x - reg.predict(feats) / norm
        replay_delta = float((x_next + prob.sample_shift
                              - epoch_rows[li]).abs().max())
        moved = float((x_next - x).abs().max())
        log(f"[train] level {li} S={p.patch_size}: K5 {k5_ms:.4f} ms (plain "
            f"twin {plain_ms:.1f}, bound {max(b_bytes, b_ops) * 1e3:.4f}: "
            f"bytes {b_bytes * 1e3:.4f} with {read} window pixels, "
            f"operations {b_ops * 1e3:.4f}) | AtA + Atb {ne_ms:.3f} ms | "
            f"{reg.method} solve {solve_ms:.3f} ms (cholesky {chol_ms:.3f}) | "
            f"update {upd_ms:.4f} ms")
        log(f"[train] level {li}: relative residual of the regularised "
            f"normal equations in float64 {residual:.3e} (this level's "
            f"limit {residual_limit:.3e}), which is the normwise backward "
            f"error {backward:.3e} (limit {BACKWARD_ERROR_LIMIT}); a second "
            f"solve differs from the trained weights by "
            f"{resolve_delta:.3e}; replayed rows vs the main "
            f"run's on_epoch rows {replay_delta:.3e} px; rows moved "
            f"{moved:.2f} px")
        log(f"[train] level {li}: cholesky's normwise backward error "
            f"{chol_backward:.3e} (limit {BACKWARD_ERROR_LIMIT})")
        check(residual <= residual_limit,
              f"level {li}: normal-equation residual {residual} over "
              f"{residual_limit} (backward error {backward})")
        check(chol_backward <= BACKWARD_ERROR_LIMIT,
              f"level {li}: cholesky's backward error {chol_backward}")
        check(replay_delta <= 1e-3, f"level {li}: the replay left the main "
              f"path's rows by {replay_delta} px")
        stages.append(dict(level=li, k5_ms=k5_ms, k5_plain_ms=plain_ms,
                           k5_split=split,
                           k5_bound_bytes_ms=b_bytes * 1e3,
                           k5_bound_ops_ms=b_ops * 1e3, read_pixels=read,
                           normal_equations_ms=ne_ms, solve_ms=solve_ms,
                           cholesky_ms=chol_ms,
                           cholesky_backward_error=chol_backward,
                           update_ms=upd_ms, residual=residual,
                           residual_limit=residual_limit,
                           backward_error=backward,
                           resolve_delta=resolve_delta,
                           replay_delta_px=replay_delta))
        k5["ms"] += k5_ms
        k5["plain_ms"] += plain_ms
        k5["bytes_ms"] += b_bytes * 1e3
        k5["ops_ms"] += b_ops * 1e3
        x = x_next
        del feats, b, norm
        torch.cuda.empty_cache()
    k5["launches"] = launches["features_fused_frames"]
    staged = sum(st["k5_ms"] + st["normal_equations_ms"] + st["solve_ms"]
                 + st["update_ms"] for st in stages)
    log(f"[train] stages sum to {staged:.1f} ms of the warm {warm_s * 1e3:.1f}"
        f" ms: K5 {k5['ms']:.2f}, AtA + Atb "
        f"{sum(st['normal_equations_ms'] for st in stages):.1f}, solve "
        f"{sum(st['solve_ms'] for st in stages):.1f} (cholesky "
        f"{sum(st['cholesky_ms'] for st in stages):.1f}), update "
        f"{sum(st['update_ms'] for st in stages):.2f}")
    del prob, hog, x, epoch_rows

    # ---- the trained model serves: accuracy, save and load ----
    boxes, idx = data["boxes"], data["sel_dev"]
    fused_det = trained.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    fused_rows = fused_det(frames, boxes, image_indices=idx)
    stepped = trained.make_stepped_detector(
        BATCH, roi=ROI, sampling="exact", window_sampler=True,
        max_ied=data["max_ied"])
    exact_rows = stepped(data["images"], boxes)
    err_fused, err_exact = iod(fused_rows, data["gt"]), iod(exact_rows,
                                                             data["gt"])
    log(f"[train] trained model, train-set IOD error on {BATCH} faces: "
        f"fused (K3) {err_fused:.6f} (pretrained {pretrained_iod['fused']:.6f}"
        f"), exact stepped {err_exact:.6f} (pretrained "
        f"{pretrained_iod['exact']:.6f})")
    check(err_fused < pretrained_iod["fused"]
          and err_exact < pretrained_iod["exact"],
          "the trained model is no better than the pretrained one on its "
          "own training faces")
    path = os.path.join(REPO, "build", "chip_smoke_trained.bin")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    trained.save(path)
    loaded = DetectionModel.load(path)
    same = bool(torch.equal(
        loaded.make_fused_detector(roi=ROI, max_ied=data["max_ied"])(
            frames, boxes[:256], image_indices=idx[:256]), fused_rows[:256]))
    log(f"[train] saved and loaded again: rows of 256 faces "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    check(same, "the saved and loaded model detects other rows")
    del stepped, exact_rows, loaded

    # ---- the windows path: float32 stack, K6 in chunks ----
    gt_s, bx_s, sel_s = train_set(TRAIN_FACES_SMALL)
    cfg6 = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                          solver_method="lu", feature_chunk_size=TRAIN_CHUNK)
    frames_f32 = frames.float()
    args6 = (frames_f32, gt_s, bx_s, *ids, mean, cfg6)
    n_s = TRAIN_FACES_SMALL * (cfg6.num_perturbations + 1)
    chunks = -(-n_s // TRAIN_CHUNK)
    zero_counts()
    trained6 = train_rcr(*args6, image_indices=sel_s)
    torch.cuda.synchronize()
    launches6 = read_counts()
    log(f"[train] train_rcr(fused) on the float32 stack, {n_s} samples in "
        f"chunks of {TRAIN_CHUNK}: launches {launches6}")
    expect_counts(launches6, "train_rcr, fused windows mode",
                  features_fused=levels * chunks)
    prob = training_problem(*args6, image_indices=sel_s)
    hog, x = prob.hog, prob.x0
    sample_idx = hog.image_indices.long()
    window = tuple(hog.images.shape[1:])
    spans = [slice(a, a + TRAIN_CHUNK) for a in range(0, n_s, TRAIN_CHUNK)]
    k6 = dict(err=0.0, ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
              gather_ms=0.0)
    for li, p in enumerate(cfg6.hog_params):
        level = train_level(hog, li, window)
        tail = (level, p.cell_size, p.num_bins, 16, *eyes)
        feats = hog(x, li)
        ref = extract_features_fused_reference(
            hog.images[sample_idx], x, level, p.cell_size, *eyes)
        k6["err"] = max(k6["err"], compare_rows("K6", li, feats, ref))
        del ref
        gathered = [(hog.images[sample_idx[sp]], x[sp]) for sp in spans]
        ms, _ = cuda_time_ms(
            lambda: [extract_features_fused(w, xc, *tail)
                     for w, xc in gathered], reps=10, warmup=2)
        plain_ms, _ = cuda_time_ms(
            lambda: [extract_features_fused_reference(
                w, xc, level, p.cell_size, *eyes) for w, xc in gathered],
            reps=2, warmup=1)
        del gathered
        gather_ms, _ = cuda_time_ms(
            lambda: [hog.images[sample_idx[sp]] for sp in spans], reps=10,
            warmup=2)
        b_bytes, b_ops, read = features_bound(torch, p, level, x, window, 2,
                                              eyes, feats.shape[1])
        log(f"[train] K6 level {li} S={p.patch_size}: {chunks} launches "
            f"{ms:.4f} ms ({ms / chunks:.4f} per launch; plain twin "
            f"{plain_ms:.1f}; bound {max(b_bytes, b_ops) * 1e3:.4f}: bytes "
            f"{b_bytes * 1e3:.4f}, operations {b_ops * 1e3:.4f}) | window "
            f"gather before them {gather_ms:.4f} ms")
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bytes_ms", b_bytes * 1e3), ("ops_ms", b_ops * 1e3),
                       ("gather_ms", gather_ms)):
            k6[key] += v
        x = trained6.sdo.step(li, x, feats)
        del feats
        torch.cuda.empty_cache()
    k6["launches"] = launches6["features_fused"]
    k6["launches_per_level"] = chunks
    crop_ms, _ = cuda_time_ms(
        lambda: training_problem(*args6, image_indices=sel_s), reps=3,
        warmup=1)
    log(f"[train] set-up of the windows path (crop of {TRAIN_FACES_SMALL} "
        f"faces from the float32 stack, bf16 cast, initialisations): "
        f"{crop_ms:.3f} ms")
    del prob, hog, x, frames_f32
    torch.cuda.empty_cache()
    # the same faces through K5, and what the two models detect on them
    cfg5 = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                          solver_method="lu")
    trained5 = train_rcr(frames, gt_s, bx_s, *ids, mean, cfg5,
                         image_indices=sel_s)
    boxes_s = torch.from_numpy(bx_s).cuda()
    gt_dev = torch.from_numpy(gt_s).cuda()
    rows5, rows6 = (m.make_fused_detector(roi=ROI, max_ied=data["max_ied"])(
        frames, boxes_s, image_indices=sel_s) for m in (trained5, trained6))
    k5_vs_k6 = float((rows5 - rows6).abs().max())
    log(f"[train] K5-trained vs K6-trained model on the same "
        f"{TRAIN_FACES_SMALL} faces: detections differ by max "
        f"{k5_vs_k6:.4f} px (IOD error {iod(rows5, gt_dev):.6f} vs "
        f"{iod(rows6, gt_dev):.6f})")
    check(bool(torch.isfinite(rows5).all() and torch.isfinite(rows6).all()),
          "non-finite rows from the small trained models")

    # ---- the window backend: K2 + K1 under training ----
    cfgw = RcrTrainConfig(roi=ROI, patch_backend="window", seed=0,
                          solver_method="lu")
    argsw = (frames, gt_s, bx_s, *ids, mean, cfgw)
    epoch_rows = []
    zero_counts()
    t0 = time.perf_counter()
    trained_w = train_rcr(*argsw, image_indices=sel_s,
                          on_epoch=epoch_rows.append)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    launches_w = read_counts()
    expect_counts(launches_w, "train_rcr, window backend", hog_flat=levels,
                  patches_window=levels)
    # each level replayed: K2 and K1 against their twins on this path's own
    # windows (one per sample, gathered from the per-face crops) and at its
    # own sub-windows, which follow the ground truth's IED
    prob = training_problem(*argsw, image_indices=sel_s)
    hog, x = prob.hog, prob.x0
    windows = hog.images[hog.image_indices.long()]
    kw_err = dict(k1=0.0, k2=0.0)
    for li in range(levels):
        k2_err, k1_err, _, desc = window_level_vs_twins(
            torch, "train_rcr(window)", li, windows,
            *hog.window_args(x, li, windows))
        kw_err["k1"] = max(kw_err["k1"], k1_err)
        kw_err["k2"] = max(kw_err["k2"], k2_err)
        feats = torch.cat([desc.reshape(n_s, -1),
                           torch.ones((n_s, 1), device=desc.device)], dim=1)
        del desc
        x = trained_w.sdo.step(li, x, feats)
        replay_delta = float((x + prob.sample_shift
                              - epoch_rows[li]).abs().max())
        log(f"[train] window backend level {li}: replayed rows vs the run's "
            f"on_epoch rows {replay_delta:.3e} px")
        check(replay_delta <= 1e-3, f"window backend level {li}: the replay "
              f"left the run's rows by {replay_delta} px")
        del feats
    log(f"[train] window backend sub-windows W {hog.sub_windows}, WX "
        f"{hog.sub_windows_x} on {tuple(windows.shape)} "
        f"{str(windows.dtype).split('.')[-1]} windows")
    del prob, hog, x, windows, epoch_rows
    torch.cuda.empty_cache()
    images_s = frames[torch.from_numpy(sel_s).cuda()]
    errs_w = [iod(m.make_stepped_detector(
        TRAIN_FACES_SMALL, roi=ROI, sampling="exact", window_sampler=True,
        max_ied=data["max_ied"])(images_s, boxes_s), gt_dev)
        for m in (trained_w, model)]
    log(f"[train] train_rcr(window) on {n_s} samples: launches {launches_w}, "
        f"{window_s:.3f} s; IOD error on its {TRAIN_FACES_SMALL} faces "
        f"(exact stepped) {errs_w[0]:.6f}, pretrained {errs_w[1]:.6f}")
    check(all(bool(torch.isfinite(r.weights).all())
              for r in trained_w.sdo.regressors) and errs_w[0] < errs_w[1],
          "the window-backend model is no better than the pretrained one")
    return dict(
        samples=n, cold_s=cold_s, warm_s=warm_s, profile=profile,
        stages=stages,
        kernels=dict(features_fused_frames=k5, features_fused=k6),
        iod_fused=err_fused, iod_exact=err_exact, saved_equal=same,
        windows_run=dict(samples=n_s, chunk=TRAIN_CHUNK, launches=launches6,
                         setup_ms=crop_ms, k5_vs_k6_px=k5_vs_k6),
        window_backend=dict(samples=n_s, launches=launches_w,
                            seconds=window_s, iod=errs_w[0],
                            pretrained_iod=errs_w[1], sampling=cfgw.sampling,
                            k1_err=kw_err["k1"], k2_err=kw_err["k2"]))


def phase_probes(torch, seed):
    """The probes P1-P5. The main run is ``probes.run_all`` (what
    ``python -m superviseddescent_tpu_torch.probes`` runs) at the probe
    scripts' shapes; then every variant is held against its plain twin on
    the same inputs, P2's G and P3's pre variants against P1 ``full``, P4
    against ``2 * x`` and P5 against its twins and the numpy emulation."""
    import numpy as np
    from superviseddescent_tpu_torch import probes
    from superviseddescent_tpu_torch.ops.patches_window import (
        _tap_plan, _taps)
    from superviseddescent_tpu_torch.probes.dyn import (
        ABDE_RTOL, probe_abde, probe_abde_reference, probe_c, probe_c4,
        probe_c_reference)
    from superviseddescent_tpu_torch.probes.flatout import (
        probe_flatout, probe_flatout_reference)
    from superviseddescent_tpu_torch.probes.sampler import (
        VARIANTS, probe_sampler, probe_sampler_g, probe_sampler_pre,
        probe_sampler_reference, sub_window_origins)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    batch, roi, n_lm, tiles, tile = 1024, 512, 22, 512, 55
    reps, warmup = 20, 3
    per_timing = 1 + warmup + reps

    # the main path's run: counts from 0, read right after
    zero_counts()
    records = probes.run_all(seed=seed, batch=batch, roi=roi,
                             landmarks=n_lm, tiles=tiles, tile_size=tile,
                             reps=reps, warmup=warmup,
                             log=lambda line: log("[probes] " + line.replace(
                                 "\n", "\n[probes] ")))
    torch.cuda.synchronize()
    launches = read_counts()
    shapes = probes.SAMPLER_SHAPES
    expect_counts(launches, "the probes' run",
                  probe_sampler=len(VARIANTS) * len(shapes) * per_timing,
                  probe_sampler_g=3 * len(shapes) * per_timing,
                  probe_sampler_pre=2 * len(shapes) * per_timing,
                  probe_flatout=per_timing, probe_abde=per_timing,
                  probe_c=per_timing, probe_c4=per_timing)
    by_label = {(r["probe"], r["label"]): r for r in records}

    def entry(name, ms, err, plain_ms, b_bytes, b_ops, library_ms=None,
              call=None, plain_call=None):
        """ms, plain_ms: the times between CUDA events. For the short
        kernels (``call`` and ``plain_call`` given) the host's enqueue sets
        those, so the entry's ms and plain_ms are device times from
        torch.profiler (the kernel alone; the sum of the twin's kernels) and
        the event times are kept as event_ms and plain_event_ms."""
        out = dict(name=name, launches=launches[name.split("/")[0]], ms=ms,
                   max_abs_err=err, plain_ms=plain_ms, ms_source="cuda_events",
                   bound_bytes_ms=b_bytes * 1e3, bound_ops_ms=b_ops * 1e3,
                   library_ms=library_ms)
        if call is not None:
            out.update(ms=device_ms(torch, call, match="probe_"),
                       plain_ms=device_ms(torch, plain_call,
                                          one_kernel=False),
                       ms_source="torch.profiler", event_ms=ms,
                       plain_event_ms=plain_ms)
            log(f"[probes] {name}: device time (torch.profiler) the kernel "
                f"{out['ms']:.4f} ms, the plain twin's kernels "
                f"{out['plain_ms']:.4f} ms; between CUDA events {ms:.4f} and "
                f"{plain_ms:.4f} ms (the host's enqueue); bound "
                f"{max(b_bytes, b_ops) * 1e3:.5f} ms")
        return out

    def same_bits(a, b):
        return bool(torch.equal(a.view(torch.int16), b.view(torch.int16)))

    def label_probe(tag):
        return "P2" if tag.startswith("G=") else (
            "P3" if tag.startswith("pre=") else "P1")

    kernels, device_times = [], {}
    # ---- P1-P3 against the twin and against each other ----
    windows = probes.sampler_windows(seed, batch, roi, "cuda")
    cx, cy = probes.sampler_centres(seed, batch, n_lm, roi)
    for si, (s, w, wx, ph) in enumerate(shapes):
        oxy, sp = probes.sampler_inputs(cx, cy, s, ph, "cuda")
        oo = sub_window_origins(oxy, sp, roi, roi, s, w, wx)
        head = f"S={s} W={w} WX={wx}"
        outs, err = {}, 0.0
        for variant in VARIANTS:
            got = probe_sampler(windows, oxy, sp, variant, s, w, wx)
            ref = probe_sampler_reference(windows, oxy, sp, s, w, wx, variant)
            torch.cuda.synchronize()
            diff = float((got.float() - ref.float()).abs().max())
            log(f"[probes] {head} {variant}: kernel vs twin on "
                f"{batch * n_lm} patches max abs {diff:.1f} grey levels, "
                f"{'bit-equal' if same_bits(got, ref) else 'DIFFERENT'} "
                f"(tolerance: equal); patch mean {float(got.float().mean()):.2f}")
            check(same_bits(got, ref),
                  f"P1 {variant} differs from its twin at {head}")
            err = max(err, diff)
            outs[variant] = got
            del ref
        full = outs["full"]
        for g in (1, 2, 4):
            got = probe_sampler_g(windows, oxy, sp, g, s, w, wx)
            check(same_bits(got, full), f"P2 G={g} differs from P1 full at "
                  f"{head}")
        for pre in (False, True):
            got = probe_sampler_pre(windows, oxy, sp, oo, pre, s, w, wx)
            check(same_bits(got, full), f"P3 pre={int(pre)} differs from P1 "
                  f"full at {head}")
        log(f"[probes] {head}: G = 1, 2, 4 and pre = 0, 1 give the bits of "
            f"full")
        del outs, got
        # each label's device time beside its bound, its twin's time and
        # the kernel's recorded time before its redesign (PROBE_BEFORE_MS)
        st, ph = sp.reshape(batch, 2).unbind(1)
        full_plan = _tap_plan(roi, roi, oxy.reshape(batch, -1),
                              sp.reshape(batch, 2), s, w, wx, True, True)
        j = torch.arange(s, dtype=torch.float32, device="cuda")[None, :]
        src = torch.minimum(torch.clamp((j + 0.5) * st[:, None] - 0.5,
                                        min=0.0), 2.0 * ph[:, None] - 1.0)
        zero = torch.zeros((batch, n_lm), device="cuda")
        shared_plan = full_plan[:2] + (_taps(zero, src, zero, w, True, True),
                                       _taps(zero, src, zero, wx, True, True))
        torch.cuda.empty_cache()
        out_bytes = batch * n_lm * s * s * 2 + (oxy.numel() + sp.numel()) * 4
        b_ops = batch * n_lm * s * s * 15 / F32_OPS_PER_S
        reads = {"full": read_pixels(torch, (roi, roi), [full_plan]),
                 "shared": read_pixels(torch, (roi, roi), [shared_plan]),
                 "nodot": 0}
        del full_plan, shared_plan
        torch.cuda.empty_cache()
        twin_ms = {v: cuda_time_ms(probe_sampler_reference, windows, oxy, sp,
                                   s, w, wx, v, reps=2, warmup=1)[0]
                   for v in VARIANTS}
        calls = {variant: (lambda v=variant: probe_sampler(
            windows, oxy, sp, v, s, w, wx)) for variant in VARIANTS}
        calls.update({f"G={g}": (lambda g=g: probe_sampler_g(
            windows, oxy, sp, g, s, w, wx)) for g in (1, 2, 4)})
        calls.update({f"pre={p}": (lambda p=p: probe_sampler_pre(
            windows, oxy, sp, oo, p, s, w, wx)) for p in (0, 1)})
        for tag, call in calls.items():
            label = f"{head} {tag}"
            variant = tag if tag in VARIANTS else "full"
            extra = oo.numel() * 4 if tag == "pre=1" else 0
            bytes_ms = (out_bytes + reads[variant] * 2 + extra) \
                / MEM_BYTES_PER_S * 1e3
            bound = max(bytes_ms, b_ops * 1e3 if variant != "nodot" else 0.0)
            ms = device_ms(torch, call, match="probe_")
            device_times[label] = dict(ms=ms, bound_ms=bound,
                                       bytes_ms=bytes_ms,
                                       plain_ms=twin_ms[variant])
            log(f"[probes] {label}: {ms:.4f} ms device time (run_all's CUDA "
                f"events {by_label[(label_probe(tag), label)]['ms']:.4f}); "
                f"bound {bound:.4f} ms (bytes, {reads[variant]} window "
                f"pixels); plain twin {twin_ms[variant]:.2f} ms; before the "
                f"redesign {PROBE_BEFORE_MS[label]} ms")
        if si:
            continue
        # the kernels' line: the first (the larger) shape, ms between CUDA
        # events (run_all's): the profiler sessions above have read 0.48x
        # to 2.2x the events' time in some runs (PERF.md section 7)
        for name, label in (("probe_sampler", f"{head} full"),
                            ("probe_sampler_g/G=4", f"{head} G=4"),
                            ("probe_sampler_pre/pre=1", f"{head} pre=1")):
            t = device_times[label]
            kernels.append(entry(
                name, by_label[(label_probe(label.split()[-1]), label)]["ms"],
                err, t["plain_ms"], t["bytes_ms"] / 1e3, b_ops))
    del windows, full
    torch.cuda.empty_cache()

    # ---- P4 ----
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(tiles, tile, tile))
                         .astype(np.float32)).cuda()
    got = probe_flatout(x)
    ref = probe_flatout_reference(x)
    err = float((got - ref).abs().max())
    log(f"[probes] P4 vs 2 * x reshaped on {tiles} tiles: max abs {err:.1e} "
        f"(tolerance: equal)")
    check(bool(torch.equal(got, ref)) and by_label[("P4", "flat rows")]["ok"],
          "P4 differs from 2 * x")
    plain_ms, _ = cuda_time_ms(probe_flatout_reference, x)
    # torch.mul computes P4's function: the one kernel it launches, timed
    # on the device as the probe's is
    library_ms = device_ms(torch, lambda: torch.mul(x, 2.0))
    b_bytes = 2 * x.numel() * 4 / MEM_BYTES_PER_S
    p4 = entry("probe_flatout", by_label[("P4", "flat rows")]["ms"], err,
               plain_ms, b_bytes, x.numel() / F32_OPS_PER_S, library_ms,
               call=lambda: probe_flatout(x),
               plain_call=lambda: probe_flatout_reference(x))
    # the 12.4 MB stay in the 50 MB L2 between launches, so the times
    # above are warm; the byte bound is one of device memory and holds
    # against times with the L2 flushed before each launch
    flush = l2_flusher(torch)
    p4.update(
        ms_flushed=device_ms(torch, lambda: probe_flatout(x), before=flush),
        library_ms_flushed=device_ms(torch, lambda: torch.mul(x, 2.0),
                                     before=flush))
    del flush
    log(f"[probes] P4 with the L2 flushed before each launch (device time): "
        f"the kernel {p4['ms_flushed']:.4f} ms, torch.mul "
        f"{p4['library_ms_flushed']:.4f} ms (warm: {p4['ms']:.4f} and "
        f"{library_ms:.4f} ms); byte bound {b_bytes * 1e3:.4f} ms")
    log(f"[probes] P4 against torch.mul(x, 2): warm "
        f"{p4['ms'] / library_ms:.3f}x, flushed "
        f"{p4['ms_flushed'] / p4['library_ms_flushed']:.3f}x its time")
    kernels.append(p4)

    # ---- P5 ----
    d = probes.DYN
    xd, win, v = probes.dyn_inputs(seed, "cuda", **d)
    shape = (d["s"], d["w"], d["wx"], d["seg"])
    got = probe_abde(xd, win, *shape)
    ref = probe_abde_reference(xd, win, *shape)
    rec = by_label[("P5", "ABDE")]
    rel = float(((got - ref).abs() / ref.abs()).max())
    emu_rel = rec["delta"] / rec["scale"]
    log(f"[probes] P5 ABDE vs twin: max relative {rel:.3e}; vs the numpy "
        f"emulation: max abs {rec['delta']:.5f} of {rec['scale']:.1f} "
        f"({emu_rel:.3e} relative; tolerance {ABDE_RTOL:.3e}: one bf16 "
        f"rounding of the patch)")
    check(rel <= ABDE_RTOL and emu_rel <= ABDE_RTOL,
          "P5 ABDE disagrees with its twin or the numpy emulation")
    plain_ms, _ = cuda_time_ms(probe_abde_reference, xd, win, *shape)
    g_n, l = d["g"], d["l"]
    abde_bytes = (xd.numel() * 4 * 2 + win.numel() * 2) / MEM_BYTES_PER_S
    abde_ops = g_n * l * 2 * d["s"] * d["w"] * (d["wx"] + d["seg"]) \
        / BF16_OPS_PER_S
    kernels.append(entry("probe_abde", rec["ms"],
                         float((got - ref).abs().max()), plain_ms,
                         abde_bytes, abde_ops,
                         call=lambda: probe_abde(xd, win, *shape),
                         plain_call=lambda: probe_abde_reference(
                             xd, win, *shape)))
    log(f"[probes] ABDE: {kernels[-1]['ms']:.4f} ms device time; bound "
        f"{max(abde_bytes, abde_ops) * 1e3:.5f} ms; plain twin's kernels "
        f"{kernels[-1]['plain_ms']:.4f} ms; before the redesign "
        f"{PROBE_BEFORE_MS['ABDE']} ms")
    ref_c = probe_c_reference(v, g_n, d["br"])
    got_c, got_c4 = probe_c(v, g_n, d["br"]), probe_c4(v, g_n, d["br"])
    same = bool(torch.equal(got_c, ref_c)) and bool(torch.equal(got_c4,
                                                                got_c))
    log(f"[probes] P5 C vs twin and C4 vs C: "
        f"{'bit-equal' if same else 'DIFFERENT'}; vs the numpy emulation "
        f"{by_label[('P5', 'C')]['delta']:.5f}, "
        f"{by_label[('P5', 'C4')]['delta']:.5f} (tolerance: equal)")
    check(same and by_label[("P5", "C")]["delta"] == 0.0
          and by_label[("P5", "C4")]["delta"] == 0.0,
          "P5 C / C4 differ from their twin or the numpy emulation")
    plain_ms, _ = cuda_time_ms(probe_c_reference, v, g_n, d["br"])
    c_bytes = (4 * v.shape[1] + ref_c.numel()) * 4 / MEM_BYTES_PER_S
    c_ops = 2 * 2 * g_n * 4 * v.shape[1] / F32_OPS_PER_S
    for name, fn, out in (("probe_c", probe_c, got_c),
                          ("probe_c4", probe_c4, got_c4)):
        kernels.append(entry(
            name, by_label[("P5", "C" if name == "probe_c" else "C4")]["ms"],
            float((out - ref_c).abs().max()), plain_ms, c_bytes, c_ops,
            call=lambda fn=fn: fn(v, g_n, d["br"]),
            plain_call=lambda: probe_c_reference(v, g_n, d["br"])))
    floor_ms = launch_floor_ms(torch)
    log(f"[probes] an empty kernel (one 256-thread block): {floor_ms:.4f} ms "
        f"device time, the floor under C ({kernels[-2]['ms']:.4f} ms; before "
        f"the redesign {PROBE_BEFORE_MS['C']}) and C4 "
        f"({kernels[-1]['ms']:.4f} ms; {PROBE_BEFORE_MS['C4']}); bound "
        f"{max(c_bytes, c_ops) * 1e3:.5f} ms: these sizes can reach the "
        f"floor, not the bound")
    return dict(records=records, launches=launches, kernels=kernels,
                device_times=device_times, launch_floor_ms=floor_ms)


# the kernel of l2_flusher's call, which device_ms leaves out
FLUSH_KERNEL = "FillFunctor"


def l2_flusher(torch):
    """A call that writes 256 MB, five times the H100's 50 MB L2, so that
    the next launch finds none of its inputs there (one fill kernel,
    named by FLUSH_KERNEL)."""
    buf = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


# profiler sessions device_ms takes before it times a call with CUDA
# events instead
PROFILE_TRIES = 6
# kernel launches made ahead of the timed calls in a session that must
# hold every launch of a call (``whole``): a session may lose its first
# few records (on the H100, 5-6 of D1's in every session of a --j2k run)
PROFILE_PAD_LAUNCHES = 16
# cycles of torch.cuda._sleep ahead of an events-timed batch (~10 ms at
# the H100's 1.98 GHz): the stream waits while the host queues the calls
EVENTS_SPIN_CYCLES = 20_000_000
# the calls timed with CUDA events because no profiler session held a
# record of their kernel: (match, reps), in the run's JSON
PROFILE_FALLBACKS = []


def device_ms(torch, call, reps=20, match=None, one_kernel=True,
              before=None, whole=None):
    """Device time per call of the kernels that ``call`` launches, from
    torch.profiler's kernel records over ``reps`` calls: for work so short
    that the host's enqueue, not the device, sets the time between two CUDA
    events. match: count only the kernels whose name holds it. one_kernel:
    the call must launch exactly one such kernel per call (a hand-written
    kernel, or the one kernel of a library call); otherwise the sum over all
    of them (a plain twin of several operations). Each kernel counts with
    its mean time over the launches recorded (the profiler may miss the
    first few) times its launches per call. before: ``l2_flusher``'s call,
    made ahead of each ``call``; its kernel is not counted. Late in a long
    run the profiler loses kernel records: some launches of a session, or
    every launch of every other session (on the H100, after some minutes
    of the smoke run). Such a session is profiled again, up to
    ``PROFILE_TRIES`` times in all; when none holds a record, ``call`` is
    timed with CUDA events instead (``events_us``: every kernel of the
    call, not only ``match``'s), logged and listed in
    ``PROFILE_FALLBACKS``. whole: the launches a call of ``match``'s
    kernels; only the last ``reps`` calls' records count, made after
    PROFILE_PAD_LAUNCHES launches, and a session that recorded fewer is
    taken again (launches of one name but of other lengths, as D1's
    levels, would skew the mean)."""
    found = device_kernels(torch, call, reps, match, before, whole or 1,
                           whole)
    if one_kernel:
        check(len(found) == 1 and found[0][1] == 1,
              f"expected one kernel per call, the profiler recorded "
              f"{[(key[:60], per_call) for key, per_call, _ in found]}")
    return sum(per_call * us for _, per_call, us in found) / 1e3


def events_us(torch, call, reps, before=None):
    """Device us per ``call`` between two CUDA events around ``reps``
    calls queued behind a spin kernel, so that the host's enqueue does not
    set the time; ``before``'s share, timed the same way, is taken off."""
    def batch(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(EVENTS_SPIN_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / reps
    if before is None:
        return batch(call)

    def both():
        before()
        call()
    return batch(both) - batch(before)


def device_kernels(torch, call, reps=20, match=None, before=None,
                   launches_per_call=1, whole=None):
    """``device_ms``'s profiled kernels of ``call``: (name, launches per
    call, device us per launch) of each kernel whose name holds
    ``match``. Where ``whole`` (launches a call) is given, the session
    first makes PROFILE_PAD_LAUNCHES launches' worth of calls and counts
    the last ``whole * reps`` records in the order they ran, the last
    ``reps`` calls; a session that recorded fewer is taken again. When no
    profiler session holds them, one entry timed by ``events_us``, split
    evenly over ``launches_per_call``."""
    from torch.profiler import ProfilerActivity, profile

    def device_us(ev, name):
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        counted = ("CUDA" in str(ev.device_type) and us > 0
                   and not name.startswith(("Memcpy", "Memset"))
                   and (before is None or FLUSH_KERNEL not in name)
                   and (match is None or match in name))
        return us if counted else 0.0
    call()
    torch.cuda.synchronize()
    pad = -(-PROFILE_PAD_LAUNCHES // whole) if whole else 0
    found = []
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(pad + reps):
                if before is not None:
                    before()
                call()
            torch.cuda.synchronize()
        found = []
        recorded = 0
        if whole:
            runs = sorted((ev for ev in prof.events()
                           if device_us(ev, ev.name) > 0),
                          key=lambda ev: ev.time_range.start)
            recorded = min(len(runs), whole * reps)
            per_name = {}
            for ev in runs[len(runs) - recorded:]:
                n, us = per_name.get(ev.name, (0, 0.0))
                per_name[ev.name] = (n + 1, us + device_us(ev, ev.name))
            found = [(key, max(1, round(n / reps)), us / n)
                     for key, (n, us) in per_name.items()]
        else:
            for ev in prof.key_averages():
                us = device_us(ev, ev.key)
                if us > 0 and ev.count:
                    found.append((ev.key, max(1, round(ev.count / reps)),
                                  us / ev.count))
                    recorded += ev.count
        if found and (whole is None or recorded == whole * reps):
            break
        log(f"[profile] session {attempt} of {PROFILE_TRIES} recorded "
            + (f"{recorded} of {whole * reps} launches" if found
               else "no kernel") + f" (match {match!r})")
        found = []
    if not found:
        us = events_us(torch, call, reps, before)
        check(us > 0, f"CUDA events timed {us} us (match {match!r})")
        PROFILE_FALLBACKS.append((match, reps))
        log(f"[profile] no session held a record (match {match!r}): "
            f"{us / 1e3:.5f} ms a call from CUDA events instead")
        found = [(f"CUDA events ({match})", launches_per_call,
                  us / launches_per_call)]
    return found


def family_data(torch, data, model):
    """Boxes, ground truth and the IED bound of a model's landmark set over
    the 4,096 faces (ground truth filtered from the 68-point .pts). The
    sub-window bound is sized as bench.py sizes it: the larger IED of the
    aligned mean and the ground truth, with a 1.15 drift margin."""
    import numpy as np
    from superviseddescent_tpu_torch.models.rcr import align_mean, gt_facebox
    from superviseddescent_tpu_torch.utils.landmarks import (
        ied_from_rows, resolve_eye_indices, to_row)
    gts = [p.filter(model.landmark_ids) for p in data["pts"]]
    check(all(len(g) == len(model.landmark_ids) for g in gts),
          "a .pts file lacks a landmark of the family")
    boxes = np.array([gt_facebox(g) for g in gts], np.float32)
    gt_rows = np.stack([to_row(g) for g in gts])
    eyes = resolve_eye_indices(model.landmark_ids, model.right_eye_ids,
                               model.left_eye_ids)
    inits = align_mean(model.mean.cpu()[None], torch.from_numpy(boxes))
    max_ied = 1.15 * max(
        float(ied_from_rows(inits, *eyes).max()),
        float(ied_from_rows(torch.from_numpy(gt_rows), *eyes).max()))
    sel = data["sel"]
    return dict(boxes_np=boxes[sel], boxes=torch.from_numpy(boxes[sel]).cuda(),
                gt=torch.from_numpy(gt_rows[sel]).cuda(), eyes=eyes,
                max_ied=max_ied, image_boxes=boxes, image_gt=gt_rows)


def fused_vs_twin(torch, label, model, det, op, twin, x0, shift, entry_rows,
                  twin_faces):
    """One fused kernel against its twin at the inputs of a path that was
    just driven: each level from equal rows (the kernel on all faces, the
    twin on the first ``twin_faces``), the whole cascade on all faces, and
    the rows the entry point returned against the twin's whole cascade.
    op, twin: ``(x, weights, levels, cell_sizes) -> rows`` in window space,
    on the first ``x.shape[0]`` faces; x0: the window-space start rows;
    shift: window space -> image space."""
    from superviseddescent_tpu_torch.ops.cascade_fused import prepare_weights
    x, level_x, level_err = x0, [], 0.0
    for li, level in enumerate(det.levels):
        w1 = prepare_weights([model.sdo.regressors[li].weights])
        one = ((level,), (det.cell_sizes[li],))
        got = op(x, w1, *one)
        ref = twin(x[:twin_faces], w1, *one)
        err = float((got[:twin_faces] - ref).abs().max())
        log(f"[{label}] level {li} vs twin from equal rows, {ref.shape[0]} "
            f"faces: max {err:.3e} px (tolerance {FUSED_LEVEL_PX})")
        check(err <= FUSED_LEVEL_PX,
              f"{label} disagrees with its twin at level {li}")
        level_err = max(level_err, err)
        level_x.append(x)
        x = got
        del w1, ref
    args = (x0, det.weights, det.levels, det.cell_sizes)
    got = op(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = twin(*args)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    whole = cascade_compare(torch, label, (got - ref).abs().amax(dim=1))
    entry = cascade_compare(torch, f"{label}, the entry point's rows",
                            (entry_rows - (ref + shift)).abs().amax(dim=1))
    return dict(level_err_px=level_err, whole=whole, entry=entry,
                plain_ms=plain_ms, level_x=level_x, args=args)


def phase_families(torch, data):
    """COFW-29 and ibug-68 at full width over the 4,096 faces: the fused
    detector (K3 on the uint8 stack with image_indices; K4 on a float32
    stack, 256 faces), the fused tracker (K3 from prior rows), and the
    stepped detector exact and fast (K2 + K1). Every kernel of every path
    is held against its twin at that path's inputs: K3 and K4 per level and
    over the whole cascade, K2 and K1 at each level of both stepped modes
    on all faces. Then the fused rows against the exact stepped rows, and
    the exact stepped rows against the port's CPU path."""
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, align_mean, rows_shift)
    from superviseddescent_tpu_torch.models.rcr_training import (
        normalised_landmark_errors)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused, detect_cascade_fused_frames,
        detect_cascade_fused_frames_reference, detect_cascade_fused_reference,
        launch_plan)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    frames, idx, images = data["frames"], data["sel_dev"], data["images"]
    results = {}
    m = FAMILY_LEVEL_FACES
    for n_lm in FAMILIES:
        tag = f"rcr{n_lm}"
        path = os.path.join(REPO, "pretrained", f"{tag}_lfpw5.bin")
        model = DetectionModel.load(path)
        check(len(model.landmark_ids) == n_lm, f"{tag}: landmark count")
        fam = family_data(torch, data, model)
        boxes, gt, eyes = fam["boxes"], fam["gt"], fam["eyes"]

        def iod(rows, truth=gt):
            return float(normalised_landmark_errors(rows, truth,
                                                    *eyes).mean())

        det = model.make_fused_detector(roi=ROI, max_ied=fam["max_ied"])
        f, fp = det.weights.num_features, det.weights.tensor.shape[2]
        plan = launch_plan(
            BATCH, n_lm, 5, 55, det.quantize,
            torch.cuda.get_device_properties(0).multi_processor_count)
        shared = plan.shared_bytes
        log(f"[{tag}] {n_lm} landmarks, {f} features (rows padded to {fp}), "
            f"max_ied {fam['max_ied']:.2f} px, K3 block of {plan.faces} faces "
            f"x {plan.group} landmarks per group, {plan.threads} threads, "
            f"{shared} B of shared memory; levels (S, W, WX, rel) "
            f"{det.levels}")
        fixed = dict(quantize=det.quantize)
        consts = (det.num_bins, det.dims, det.r_idx, det.l_idx)

        def frames_pair(oy, ox, window):
            """K3 and its twin on the first x.shape[0] faces."""
            def op(x, w, lv, cs):
                n = x.shape[0]
                return detect_cascade_fused_frames(
                    frames, idx[:n], oy[:n], ox[:n], x, w, window, lv, cs,
                    *consts, **fixed)

            def twin(x, w, lv, cs):
                n = x.shape[0]
                return detect_cascade_fused_frames_reference(
                    frames, idx[:n], oy[:n], ox[:n], x, w, window, lv, cs,
                    det.r_idx, det.l_idx, **fixed)
            return op, twin

        # ---- the fused detector, frames path: K3 ----
        zero_counts()
        fused = det(frames, boxes, image_indices=idx)
        torch.cuda.synchronize()
        expect_counts(read_counts(), f"{tag} fused detect",
                      cascade_fused_frames=1)
        x_img = align_mean(model.mean[None], boxes)
        oy, ox, window = det.aligned_origins(frames, boxes)
        shift = rows_shift(ox.float(), oy.float(), n_lm)
        op, twin = frames_pair(oy, ox, window)
        k3 = fused_vs_twin(torch, f"{tag} K3", model, det, op, twin,
                           x_img - shift, shift, fused, m)
        k3_ms, runs = cuda_time_ms(op, *k3["args"])
        k3["split"] = k3_split(torch, det, frames, idx, oy, ox, window,
                               x_img - shift, k3["level_x"])
        b_bytes, b_ops, read = cascade_bound(
            torch, model, det, k3.pop("level_x"), window, 1,
            det.weights.tensor.numel() * 2)
        del k3["args"]
        torch.cuda.empty_cache()
        bound = max(b_bytes, b_ops)
        log(f"[{tag}] K3: {k3_ms:.4f} ms median of {len(runs)} (min "
            f"{min(runs):.4f}) | plain twin {k3['plain_ms']:.1f} ms | bound "
            f"{bound * 1e3:.4f} ms (bytes {b_bytes * 1e3:.4f} with {read} "
            f"window pixels; operations {b_ops * 1e3:.4f}) -> "
            f"{k3_ms / (bound * 1e3):.1f}x the bound")

        # ---- the stepped detector, exact and fast: K2 + K1 ----
        rows, stepped = {}, {}
        for sampling in ("exact", "fast"):
            sdet = model.make_stepped_detector(
                BATCH, roi=ROI, sampling=sampling, window_sampler=True,
                max_ied=fam["max_ied"])
            zero_counts()
            rows[sampling] = sdet(images, boxes)
            torch.cuda.synchronize()
            expect_counts(read_counts(), f"{tag} stepped {sampling} detect",
                          hog_flat=4, patches_window=4)
            step_ms, _ = cuda_time_ms(sdet, images, boxes, reps=10, warmup=2)
            k1_err = k2_err = 0.0
            device, final = [], []
            for li, windows, args, skw, hkw in stepped_levels(
                    model, sdet, images, boxes, final):
                e2, e1, patches, _ = window_level_vs_twins(
                    torch, f"{tag} stepped {sampling}", li, windows, args,
                    skw, hkw, twin_faces=m)
                k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
                del patches
                k2_dev, k1_dev = k12_device_ms(torch, args, skw, hkw)
                before = k12_before(tag, sampling, li)
                device.append(dict(level=li, k2_device_ms=k2_dev,
                                   k1_device_ms=k1_dev,
                                   k2_before_ms=before[0],
                                   k1_before_ms=before[1]))
                log(f"[level] {tag} {sampling} {li}: K2 device {k2_dev:.4f} "
                    f"ms (recorded before the redesign {before[0]}) | K1 "
                    f"device {k1_dev:.4f} ms (recorded before {before[1]})")
            check(bool(torch.equal(final[0], rows[sampling])),
                  f"{tag} stepped {sampling}: the levels replayed against "
                  f"the twins give other rows than the detect call")
            stepped[sampling] = dict(k1_err=k1_err, k2_err=k2_err,
                                     detect_ms=step_ms,
                                     faces_per_s=BATCH / step_ms * 1e3,
                                     levels=device)
            del sdet, windows, final
            torch.cuda.empty_cache()
        exact, fast = rows["exact"], rows["fast"]

        # ---- the fused tracker from the exact rows: K3 from prior rows ----
        tracker = model.make_fused_tracker(roi=ROI, max_ied=fam["max_ied"])
        zero_counts()
        tracked = tracker(frames, exact, image_indices=idx)
        torch.cuda.synchronize()
        expect_counts(read_counts(), f"{tag} fused tracker",
                      cascade_fused_frames=1)
        t_oy, t_ox, t_window = tracker.aligned_origins(
            frames, tracker.boxes_from_rows(exact))
        t_shift = rows_shift(t_ox.float(), t_oy.float(), n_lm)
        op, twin = frames_pair(t_oy, t_ox, t_window)
        trk = fused_vs_twin(torch, f"{tag} tracker K3", model, tracker, op,
                            twin, exact - t_shift, t_shift, tracked, m)
        del trk["level_x"], trk["args"], t_shift
        torch.cuda.empty_cache()

        # ---- the fused detector, crop path: K4 ----
        n4 = 256
        frames_f32 = frames.float()
        zero_counts()
        rows4 = det(frames_f32, boxes[:n4], image_indices=idx[:n4])
        torch.cuda.synchronize()
        expect_counts(read_counts(), f"{tag} fused detect, crop path",
                      cascade_fused=1)
        windows4, wox, woy = det.crop(frames_f32, boxes[:n4], idx[:n4])
        del frames_f32
        shift4 = rows_shift(wox, woy, n_lm)
        k4 = fused_vs_twin(
            torch, f"{tag} K4", model, det,
            lambda x, w, lv, cs: detect_cascade_fused(
                windows4[:x.shape[0]], x, w, lv, cs, *consts, **fixed),
            lambda x, w, lv, cs: detect_cascade_fused_reference(
                windows4[:x.shape[0]], x, w, lv, cs, det.r_idx, det.l_idx,
                **fixed),
            x_img[:n4] - shift4, shift4, rows4, n4)
        del k4["level_x"], k4["args"], windows4
        torch.cuda.empty_cache()

        for name, out in (("fused", fused), ("exact", exact), ("fast", fast),
                          ("tracked", tracked), ("K4", rows4)):
            check(out.shape[1] == 2 * n_lm
                  and bool(torch.isfinite(out).all()),
                  f"{tag}: non-finite or misshapen {name} rows")

        # accuracy, and the paths against each other
        per_face = (fused - exact).abs().amax(dim=1)
        vs_exact = float(per_face.max())
        above = float((per_face > 0.26).float().mean())
        fast_vs_exact = float((fast - exact).abs().max())
        k3_vs_k4 = float((fused[:n4] - rows4).abs().max())
        errs = dict(fused=iod(fused), exact=iod(exact), fast=iod(fast),
                    tracked=iod(tracked), k4=iod(rows4, gt[:n4]))
        log(f"[{tag}] train-set IOD error: fused (K3) {errs['fused']:.6f}, "
            f"exact stepped {errs['exact']:.6f}, fast stepped "
            f"{errs['fast']:.6f}, K4 on {n4} faces {errs['k4']:.6f}; one "
            f"tracker fit from the exact rows {errs['tracked']:.6f}")
        limit = FAMILY_VS_EXACT_PX[n_lm]
        log(f"[{tag}] against the exact stepped rows, max px: fused (K3) "
            f"{vs_exact:.4f} ({100 * above:.2f}% of faces above 0.26), K4 "
            f"{float((rows4 - exact[:n4]).abs().max()):.4f}, fast stepped "
            f"{fast_vs_exact:.4f} (bound {limit} for each); K3 vs K4 rows "
            f"max {k3_vs_k4:.4f} px")
        check(vs_exact <= limit,
              f"{tag}: fused rows {vs_exact} px from the exact path")
        check(float((rows4 - exact[:n4]).abs().max()) <= limit,
              f"{tag}: K4 rows too far from the exact path")
        check(fast_vs_exact <= limit,
              f"{tag}: fast stepped rows {fast_vs_exact} px from the exact")
        check(max(errs["fused"], errs["exact"], errs["fast"],
                  errs["k4"]) < 0.1,
              f"{tag}: the pretrained family model misses its faces")

        # the card against the port's CPU path, first 32 faces
        cpu_model = DetectionModel.load(path, device="cpu")
        cpu_rows = cpu_model.make_stepped_detector(
            32, roi=ROI, sampling="exact", window_sampler=True,
            max_ied=fam["max_ied"])(
                torch.from_numpy(data["stack"][data["sel"][:32]]),
                fam["boxes_np"][:32])
        cpu_batch = cpu_model.detect_batch(
            torch.from_numpy(data["stack"]), fam["boxes_np"][:32],
            image_indices=data["sel"][:32])
        gt32 = gt[:32].cpu()
        delta = float((exact[:32].cpu() - cpu_rows).abs().max())
        iod_card, iod_cpu = iod(exact[:32].cpu(), gt32), iod(cpu_rows, gt32)
        iod_batch = iod(cpu_batch, gt32)
        log(f"[{tag}] exact stepped rows, card vs the CPU plain path on the "
            f"first 32 faces: max {delta:.3e} px (tolerance "
            f"{TOL_PX['exact']}); IOD error {iod_card:.7f} vs {iod_cpu:.7f} "
            f"(tolerance 1e-6); the CPU detect_batch (gather features) "
            f"{iod_batch:.7f}, rows max "
            f"{float((cpu_batch - cpu_rows).abs().max()):.3e} px from the "
            f"window path's")
        check(delta <= TOL_PX["exact"] and abs(iod_card - iod_cpu) <= 1e-6,
              f"{tag}: the card's exact stepped rows differ from the CPU's")
        del cpu_model

        fused_ms, fruns = cuda_time_ms(det, frames, boxes, image_indices=idx,
                                       reps=20, warmup=3)
        step_ms = stepped["exact"]["detect_ms"]
        log(f"[{tag}] fused detect {fused_ms:.3f} ms median of {len(fruns)} "
            f"(min {min(fruns):.3f}, max {max(fruns):.3f}) -> "
            f"{BATCH / fused_ms * 1e3:.0f} faces/s; exact stepped detect "
            f"{step_ms:.3f} ms -> {BATCH / step_ms * 1e3:.0f} faces/s; fast "
            f"stepped {stepped['fast']['detect_ms']:.3f} ms")
        results[tag] = dict(
            landmarks=n_lm, features=f, shared_bytes=shared,
            max_ied=fam["max_ied"], iod=errs, vs_exact_px=vs_exact,
            share_above_026=above, fast_vs_exact_px=fast_vs_exact,
            k3_vs_k4_px=k3_vs_k4, k3=k3, tracker=trk, k4=k4, stepped=stepped,
            k3_ms=k3_ms, k3_bound_bytes_ms=b_bytes * 1e3,
            k3_bound_ops_ms=b_ops * 1e3, read_pixels=read,
            fused_detect_ms=fused_ms, fused_faces_per_s=BATCH / fused_ms * 1e3,
            cpu_delta_px=delta, iod_card_32=iod_card, iod_cpu_32=iod_cpu,
            iod_cpu_detect_batch_32=iod_batch)
        del model, det, tracker, fused, rows, exact, fast, tracked, rows4
        torch.cuda.empty_cache()
    return results


def make_clip(torch, data, seed):
    """(CLIP_FRAMES, 1024, 768) uint8 clip on the card: one .synth120 image
    (drawn from the seed among those that leave room to move) placed at
    integer offsets that drift by up to CLIP_STEP_PX per frame and axis; the
    ground truth of a frame is the image's .pts row plus its offset."""
    import numpy as np
    h_max, w_max = data["stack"].shape[1:]
    rng = np.random.default_rng(seed)
    room = [i for i, (h, w) in enumerate(data["image_shapes"])
            if h <= h_max - 256 and w <= w_max - 256]
    i = int(rng.choice(room))
    h, w = data["image_shapes"][i]
    steps = rng.integers(-CLIP_STEP_PX, CLIP_STEP_PX + 1,
                         size=(CLIP_FRAMES, 2))
    start = np.array([(h_max - h) // 2, (w_max - w) // 2])
    steps[0] = 0
    offs = start + np.cumsum(steps, axis=0)
    offs = np.clip(offs, 0, [h_max - h, w_max - w])
    image = data["frames"][i, :h, :w]
    clip = torch.zeros((CLIP_FRAMES, h_max, w_max), dtype=torch.uint8,
                       device="cuda")
    for k, (oy, ox) in enumerate(offs):
        clip[k, oy:oy + h, ox:ox + w] = image
    n_lm = data["image_gt"].shape[1] // 2
    shift = np.concatenate([np.repeat(offs[:, 1:2], n_lm, 1),
                            np.repeat(offs[:, 0:1], n_lm, 1)], axis=1)
    gt = data["image_gt"][i][None] + shift.astype(np.float32)
    box = data["image_boxes"][i] + np.float32([offs[0, 1], offs[0, 0], 0, 0])
    return clip, torch.from_numpy(gt).cuda(), box, i, offs


# face detection: the apps' parameters (apps/rcr_detect.py:53)
FACE_PARAMS = dict(scale_factor=1.2, min_neighbors=2, min_size=(50, 50))
FACE_REPS, FACE_WARMUP = 20, 3
FACE_STREAM_DEPTH = 4
# record_function ranges of models/facedetect.py, in the order of a call
FACE_RANGES = ("facedetect.resize", "facedetect.unfold", "facedetect.norm",
               "facedetect.products", "facedetect.stages",
               "facedetect.compaction", "facedetect.decode")


def face_split(torch, call):
    """One profiled call: wall (host clock, ending in a synchronise), the
    kernels' busy time and the device's idle share, and per
    ``facedetect.*`` range the device time of the kernels it launched and
    its host time."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the ranges' own device-side annotations repeat them
    busy_ms = sum(getattr(ev, "self_device_time_total", 0.0)
                  for ev in prof.key_averages()
                  if "CUDA" in str(ev.device_type)
                  and ev.key not in FACE_RANGES) / 1e3
    split = {name: dict(device_ms=0.0, host_ms=0.0, count=0)
             for name in FACE_RANGES}
    for ev in prof.events():
        if ev.name in split and "CPU" in str(ev.device_type):
            split[ev.name]["device_ms"] += ev.device_time_total / 1e3
            split[ev.name]["host_ms"] += ev.cpu_time_total / 1e3
            split[ev.name]["count"] += 1
    check(busy_ms > 0, "the profiler recorded no kernel of the face detector")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / wall_ms, split=split)


def dense_frames(det, frames):
    """Frames of one detect_batch call that go to the dense fallback (a
    survivor buffer or the candidate buffer overflowed)."""
    pend = det._dispatch(det._frames(frames, 3))
    pend.event.synchronize()
    packed = pend.packed.numpy()
    return int(((packed[:, -2] > det.MAX_CANDIDATES)
                | (packed[:, -1] != 0)).sum())


def phase_facedetect(torch, data):
    """Face detection (``models/facedetect.HaarCascadeDetector``, the
    carried stock ``haarcascade_frontalface_alt2.xml``, the apps'
    parameters) over the 120 .synth120 images, ``detect_batch`` per size
    class: the card's raw and grouped boxes against the port's CPU path on
    the first image of each class, the overflow fallbacks once, check_face
    against the .pts ground truth, ms per call and frames/s per class, ms
    per ``detect`` at batch 1 and per frame of ``detect_stream`` on the
    largest class, the profiled split of its call and the peak memory. No
    hand-written kernel runs on this path."""
    import statistics
    import numpy as np
    from superviseddescent_tpu_torch.io.haar import (
        STOCK_FRONTAL_ALT2, parse_opencv_cascade)
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector, group_rectangles)
    from superviseddescent_tpu_torch.utils.landmarks import check_face
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    cascade = parse_opencv_cascade(STOCK_FRONTAL_ALT2)
    det = HaarCascadeDetector(cascade, device="cuda", **FACE_PARAMS)
    raw_det = HaarCascadeDetector(cascade, device="cuda", **dict(
        FACE_PARAMS, min_neighbors=0))
    cpu_raw = HaarCascadeDetector(cascade, device="cpu", **dict(
        FACE_PARAMS, min_neighbors=0))
    check(det.exact, "the cascade's bank products are not exact")
    classes = {}
    for i, (h, w) in enumerate(data["image_shapes"]):
        classes.setdefault((h, w), []).append(i)
    check(len(classes) == 5 and all(len(v) == 24 for v in classes.values()),
          f"expected five size classes of 24 images, got "
          f"{ {k: len(v) for k, v in classes.items()} }")
    out = dict(classes={})
    grouped_all, hits = {}, 0
    zero_counts()
    for (h, w), idx in sorted(classes.items(), key=lambda kv: kv[0][0] *
                              kv[0][1]):
        frames = data["frames"][torch.tensor(idx, device="cuda"), :h, :w]
        frames = frames.contiguous()
        grouped = det.detect_batch(frames)
        raw = raw_det.detect_batch(frames)
        first = data["stack"][idx[0], :h, :w]
        want_raw = cpu_raw.detect(first)
        want_grouped = group_rectangles(want_raw, FACE_PARAMS["min_neighbors"])
        same = (np.array_equal(raw[0], want_raw)
                and np.array_equal(grouped[0], want_grouped))
        log(f"[face] {w}x{h}: image {idx[0]} on the card vs the CPU path: "
            f"{len(raw[0])} raw / {len(grouped[0])} grouped boxes, "
            f"{'equal' if same else 'DIFFERENT'} (tolerance: equal)")
        check(same, f"face boxes of image {idx[0]} differ from the CPU path")
        for i, boxes in zip(idx, grouped):
            grouped_all[i] = boxes
            hits += check_face(boxes, data["pts"][i])
        ms, runs = cuda_time_ms(det.detect_batch, frames, reps=FACE_REPS,
                                warmup=FACE_WARMUP)
        dense = dense_frames(det, frames)
        out["classes"][f"{w}x{h}"] = dict(
            frames=len(idx), ms=ms, frames_per_s=len(idx) / ms * 1e3,
            runs=runs, dense_fallback_frames=dense,
            raw_boxes=sum(len(r) for r in raw),
            grouped_boxes=sum(len(g) for g in grouped))
        log(f"[face] {w}x{h}: detect_batch of {len(idx)} frames "
            f"{ms:.3f} ms median of {len(runs)} (min {min(runs):.3f}, max "
            f"{max(runs):.3f}; CUDA events around the whole call, read-back "
            f"and grouping included), {len(idx) / ms * 1e3:.1f} frames/s; "
            f"{dense} frames to the dense fallback")
    launches = read_counts()
    expect_counts(launches, "face detection")
    out["check_face_share"] = hits / len(grouped_all)
    log(f"[face] check_face (landmarks 37, 46, 58 inside the first box): "
        f"{hits} of {len(grouped_all)} images "
        f"({100 * out['check_face_share']:.1f}%)")
    # the overflow fallbacks, forced, on the smallest class
    (h, w), idx = min(classes.items(), key=lambda kv: kv[0][0] * kv[0][1])
    frames = data["frames"][torch.tensor(idx, device="cuda"), :h, :w]
    frames = frames.contiguous()
    forced = HaarCascadeDetector(cascade, device="cuda", **FACE_PARAMS)
    forced.SURVIVOR_DIV, forced.MAX_CANDIDATES = 1 << 20, 4
    n_dense = dense_frames(forced, frames)
    same = all(np.array_equal(a, grouped_all[i])
               for a, i in zip(forced.detect_batch(frames), idx))
    log(f"[face] {w}x{h} with 128 survivor slots and 4 candidate slots: "
        f"{n_dense} of {len(idx)} frames to the dense fallback, boxes "
        f"{'equal' if same else 'DIFFERENT'} to the default's")
    check(n_dense == len(idx) and same, "the forced overflow fallback")
    out["overflow"] = dict(frames=len(idx), dense_fallback_frames=n_dense)
    # the largest class: peak memory, batch 1, stream, profiled split
    (h, w), idx = max(classes.items(), key=lambda kv: kv[0][0] * kv[0][1])
    frames = data["frames"][torch.tensor(idx, device="cuda"), :h, :w]
    frames = frames.contiguous()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    det.detect_batch(frames)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    single = frames[0]
    for _ in range(FACE_WARMUP):
        det.detect(single)
    runs = []
    for _ in range(FACE_REPS):
        t0 = time.perf_counter()
        det.detect(single)
        runs.append((time.perf_counter() - t0) * 1e3)
    out["batch1_ms"] = statistics.median(runs)
    list(det.detect_stream(frames, depth=FACE_STREAM_DEPTH))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streamed = list(det.detect_stream(frames, depth=FACE_STREAM_DEPTH))
    out["stream_ms_per_frame"] = (time.perf_counter() - t0) * 1e3 / len(idx)
    check(all(np.array_equal(a, grouped_all[i])
              for a, i in zip(streamed, idx)), "detect_stream's boxes")
    log(f"[face] {w}x{h}: peak memory of detect_batch({len(idx)}) "
        f"{out['peak_bytes'] / 2 ** 30:.2f} GiB; detect at batch 1 "
        f"{out['batch1_ms']:.3f} ms median of {len(runs)} (host clock, a "
        f"frame on the card, read-back and grouping included); "
        f"detect_stream depth {FACE_STREAM_DEPTH} "
        f"{out['stream_ms_per_frame']:.3f} ms per frame")
    split = face_split(torch, lambda: det.detect_batch(frames))
    out["profile"] = split
    log(f"[face] {w}x{h} detect_batch({len(idx)}) profiled: wall "
        f"{split['wall_ms']:.3f} ms, kernels busy {split['busy_ms']:.3f} ms, "
        f"device idle {100 * split['idle_share']:.1f}%; by range (device ms "
        f"of its kernels / host ms): " + ", ".join(
            f"{k.split('.')[1]} {v['device_ms']:.3f} / {v['host_ms']:.3f}"
            for k, v in split["split"].items()))
    return out


def phase_tracking(torch, data, seed):
    """RCR-22 tracking over a drifting clip: the scan, the stream at three
    settings and the sequential chain with a read-back per frame give the
    same bits; one K3 launch per frame; no host synchronisation inside the
    scan; K3 against its twin at the chain's own inputs; ms per frame.

    The tracker starts every frame from its predecessor's row, so it needs
    regressors that were trained from initialisations near the face. The
    pretrained model's were trained from the mean shape aligned into a box;
    from a row on the face they move it off again (measured below on the
    first frames; tests/test_torch_tracking.py chains the JAX package's
    exact path and its fused kernel over such frames and reads the same
    growth of the error).
    The clip is therefore tracked with an RCR-22 model trained here, by
    ``train_rcr`` on the card, on the clip's face with that face's own shape
    as the mean: its perturbed initialisations are the face displaced by a
    few pixels, which is what a previous frame's row is."""
    import numpy as np
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, rows_shift)
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, normalised_landmark_errors, train_rcr)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused_frames, detect_cascade_fused_frames_reference,
        prepare_weights)
    pretrained = data["model"]
    n_lm = len(pretrained.landmark_ids)
    eyes = (data["r_idx"], data["l_idx"])
    clip, gt, box, image_i, offs = make_clip(torch, data, seed)
    n = clip.shape[0]
    box_dev = torch.from_numpy(box).cuda()
    torch.cuda.synchronize()
    moved = np.abs(np.diff(offs, axis=0)).max()
    log(f"[track] clip {tuple(clip.shape)} uint8 from .synth120 image "
        f"{image_i}, offsets drift up to {moved} px per frame, "
        f"{np.abs(offs - offs[0]).max()} px in all")
    kw = dict(roi=ROI, max_ied=data["max_ied"])

    def iod(rows, truth):
        return normalised_landmark_errors(rows, truth, *eyes).mean(dim=1)

    # the pretrained model as a tracker, first frames only
    detector = pretrained.make_fused_detector(**kw)
    tracker = pretrained.make_fused_tracker(**kw)
    rows, prev = [], None
    for k in range(8):
        prev = (detector(clip[:1], box_dev[None]) if prev is None
                else tracker(clip[k:k + 1], prev))
        rows.append(prev)
    drift = iod(torch.cat(rows), gt[:8]).cpu().numpy()
    log("[track] the pretrained model as a tracker, IOD error of frames "
        "0-7: " + ", ".join(f"{e:.3f}" for e in drift) + " (it leaves the "
        "face: its regressors expect mean-shape initialisations)")

    # the tracking model: RCR-22 trained on the clip's face
    row, b = data["image_gt"][image_i], data["image_boxes"][image_i]
    mean = np.concatenate([(row[:n_lm] - b[0]) / b[2] - 0.5,
                           (row[n_lm:] - b[1]) / b[3] - 0.5]).astype(
                               np.float32)
    cfg = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=seed,
                         solver_method="lu")
    copies = TRACK_TRAIN_COPIES
    zero_counts()
    t0 = time.perf_counter()
    model = train_rcr(
        data["frames"], np.repeat(row[None], copies, 0),
        np.repeat(b[None], copies, 0), pretrained.landmark_ids,
        pretrained.right_eye_ids, pretrained.left_eye_ids, mean, cfg,
        image_indices=np.full(copies, image_i))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    expect_counts(read_counts(), "train_rcr of the tracking model",
                  features_fused_frames=len(cfg.hog_params))
    log(f"[track] tracking model: train_rcr(fused) on {copies} copies of the "
        f"face x {cfg.num_perturbations + 1} initialisations = "
        f"{copies * (cfg.num_perturbations + 1)} samples in {train_s:.3f} s")
    detector = model.make_fused_detector(**kw)
    tracker = model.make_fused_tracker(**kw)

    def chain():
        """The sequential chain, each row read back before the next fit."""
        rows, prev = [], None
        for k in range(n):
            prev = (detector(clip[k:k + 1], box_dev[None]) if prev is None
                    else tracker(clip[k:k + 1], prev))
            rows.append(prev.cpu().numpy()[0])
        return np.stack(rows)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / n

    def bits(a):
        return np.ascontiguousarray(a, np.float32).view(np.int32)

    chain()                                   # warm-up
    zero_counts()
    ref, seq_ms = timed(chain)
    expect_counts(read_counts(), "the sequential chain",
                  cascade_fused_frames=n)
    check(ref.shape == (n, 2 * n_lm) and bool(np.isfinite(ref).all()),
          "non-finite or misshapen tracked rows")
    results = dict(frames=n, sequential_ms_per_frame=seq_ms, stream={})
    log(f"[track] sequential chain, a read-back per frame: {seq_ms:.4f} ms "
        f"per frame")

    # the scan: the main path's run, counts from 0, no host synchronisation
    scan = model.make_fused_track_scan(**kw)
    scan(clip[:2], box_dev)                   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        rows_dev = scan(clip, box_dev)
        enqueue_ms = (time.perf_counter() - t0) * 1e3 / n
    finally:
        torch.cuda.set_sync_debug_mode("default")
    rows = rows_dev.cpu().numpy()
    expect_counts(read_counts(), "the scan", cascade_fused_frames=n)
    check(np.array_equal(bits(rows), bits(ref)),
          "scan rows differ from the sequential chain's")
    (_, scan_ms) = timed(lambda: scan(clip, box_dev).cpu())
    results.update(scan_ms_per_frame=scan_ms,
                   scan_enqueue_ms_per_frame=enqueue_ms)
    log(f"[track] scan: {n} K3 launches, no host synchronisation inside "
        f"(sync debug mode 'error'), rows bit-equal to the chain; "
        f"{scan_ms:.4f} ms per frame with the one read-back (the host "
        f"enqueues a frame in {enqueue_ms:.4f} ms)")

    # an experiment, not an entry point of the port: the same N fits
    # recorded once as a CUDA graph and replayed, to see what the host's
    # enqueue of every small operation costs the eager scan
    static = torch.zeros_like(clip)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        scan(static[:2], box_dev)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        graph_rows = scan(static, box_dev)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0

    def replay():
        static.copy_(clip, non_blocking=True)
        graph.replay()
        return graph_rows.cpu()
    rows_g, _ = timed(replay)
    check(np.array_equal(bits(rows_g.numpy()), bits(ref)),
          "the replayed graph's rows differ from the sequential chain's")
    _, graph_ms = timed(replay)
    _, eager_ms = timed(lambda: scan(clip, box_dev).cpu())
    del graph, graph_rows, static
    # one fit alone: K3 at batch 1, a single 256-thread block
    k3_one_ms = device_ms(torch, lambda: tracker(clip[1:2], rows_dev[:1]),
                          match="cascade_kernel")
    # the same with the L2 flushed first: the weights (3.1 MB) read cold
    k3_cold_ms = device_ms(torch, lambda: tracker(clip[1:2], rows_dev[:1]),
                           match="cascade_kernel", before=l2_flusher(torch))
    log(f"[track] K3 at batch 1 with the L2 flushed before each fit "
        f"{k3_cold_ms:.4f} ms, warm {k3_one_ms:.4f} ms")
    # K3 at batch 1, split as at 4,096 faces
    prior = rows_dev[:1]
    one_oy, one_ox, one_window = tracker.aligned_origins(
        clip[1:2], tracker.boxes_from_rows(prior))
    one_idx = torch.zeros(1, dtype=torch.int32, device="cuda")
    x1 = prior - rows_shift(one_ox.float(), one_oy.float(), n_lm)
    level_x, x = [], x1
    for li, level in enumerate(tracker.levels):
        level_x.append(x)
        x = detect_cascade_fused_frames(
            clip[1:2], one_idx, one_oy, one_ox, x,
            prepare_weights([model.sdo.regressors[li].weights]), one_window,
            (level,), (tracker.cell_sizes[li],), tracker.num_bins,
            tracker.dims, tracker.r_idx, tracker.l_idx,
            quantize=tracker.quantize)
    split1 = k3_split(torch, tracker, clip[1:2], one_idx, one_oy, one_ox,
                      one_window, x1, level_x)
    # the least time of one fit: its weights, window pixels and rows at the
    # memory rate (the weights read cold), against its operations
    w_bytes = tracker.weights.tensor.numel() * 2
    b_bytes, b_ops, read1 = cascade_bound(torch, model, tracker, level_x,
                                          one_window, 1, w_bytes)
    bound1 = dict(bytes_ms=b_bytes * 1e3, ops_ms=b_ops * 1e3,
                  weight_bytes=w_bytes, window_pixels=read1)
    log(f"[track] K3 bound at batch 1: bytes {b_bytes * 1e3:.6f} ms "
        f"({w_bytes} B of bf16 weights, {read1} window pixels of 1 B and "
        f"the rows, at {MEM_BYTES_PER_S / 1e12} TB/s), operations "
        f"{b_ops * 1e3:.6f} ms; K3 {k3_one_ms:.4f} ms warm = "
        f"{k3_one_ms / (max(b_bytes, b_ops) * 1e3):.0f}x, "
        f"{k3_cold_ms:.4f} ms with the L2 flushed")
    results.update(graph_ms_per_frame=graph_ms, graph_capture_s=capture_s,
                   scan_again_ms_per_frame=eager_ms, k3_batch1_ms=k3_one_ms,
                   k3_batch1_cold_ms=k3_cold_ms, k3_batch1_split=split1,
                   k3_batch1_bound=bound1)
    log(f"[track] experiment, the scan's {n} fits as one CUDA graph "
        f"(recorded in {capture_s:.2f} s): rows bit-equal to the chain; "
        f"{graph_ms:.4f} ms per frame with the frames' copy and the one "
        f"read-back, the eager scan right after it {eager_ms:.4f} ms; K3 "
        f"alone at batch 1 {k3_one_ms:.4f} ms (torch.profiler)")

    for chunk, depth in ((1, None), (8, None), (1, 4)):
        label = f"chunk={chunk}" if depth is None else f"depth={depth}"
        stream = model.make_fused_track_stream(chunk=chunk, depth=depth, **kw)
        list(stream(iter(clip[:16]), box_dev))          # warm-up
        zero_counts()

        def run(stream=stream):
            taken, got, lags = [0], [], []

            def source():
                for k in range(n):
                    taken[0] += 1
                    yield clip[k]
            for row in stream(source(), box_dev):
                got.append(row)
                lags.append(taken[0])
            return got, lags
        (got, lags), ms = timed(run)
        expect_counts(read_counts(), f"the stream, {label}",
                      cascade_fused_frames=n)
        check(len(got) == n and all(r.shape == (2 * n_lm,) for r in got),
              f"stream {label}: wrong count or shape of rows")
        check(np.array_equal(bits(np.stack(got)), bits(ref)),
              f"stream {label}: rows differ from the sequential chain's")
        if depth is not None:
            want = [min(k + depth + 1, n) for k in range(n)]
        else:
            full = n // chunk
            want = [min((k // chunk + 2) * chunk, n)
                    if k // chunk < full - 1 else n for k in range(n)]
        check(lags == want, f"stream {label}: rows arrived out of schedule")
        results["stream"][label] = ms
        log(f"[track] stream {label}: {n} rows in order and on schedule, "
            f"bit-equal to the chain, {n} K3 launches; {ms:.4f} ms per "
            f"frame")

    # K3 against its twin at the chain's own inputs: every tracked frame
    # from its predecessor's row, as one batch
    prior = torch.from_numpy(ref[:-1]).cuda()
    batch_rows = tracker(clip[1:], prior)
    check(np.array_equal(bits(batch_rows.cpu().numpy()), bits(ref[1:])),
          "the tracker's rows depend on the batch they are fitted in")
    boxes = tracker.boxes_from_rows(prior)
    oy, ox, window = tracker.aligned_origins(clip[1:], boxes)
    shift = rows_shift(ox.float(), oy.float(), n_lm)
    twin = detect_cascade_fused_frames_reference(
        clip[1:], torch.arange(n - 1, device="cuda", dtype=torch.int32), oy,
        ox, prior - shift, tracker.weights, window, tracker.levels,
        tracker.cell_sizes, tracker.r_idx, tracker.l_idx,
        quantize=tracker.quantize) + shift
    whole = cascade_compare(torch, "tracker K3",
                            (batch_rows - twin).abs().amax(dim=1))

    # the card against the port's CPU path: the chain's first frames
    cpu_model = DetectionModel.from_cereal(model.to_cereal(), device="cpu")
    cpu_rows, prev = [], None
    for k in range(4):
        frame = clip[k:k + 1].cpu()
        prev = (cpu_model.make_fused_detector(**kw)(frame, box[None])
                if prev is None else
                cpu_model.make_fused_tracker(**kw)(frame, prev))
        cpu_rows.append(prev.numpy()[0])
    cpu_delta = np.abs(np.stack(cpu_rows) - ref[:4]).max(axis=1)
    log("[track] chain rows, card vs the CPU plain path, frames 0-3: max "
        + ", ".join(f"{v:.3e}" for v in cpu_delta)
        + f" px (tolerance {FUSED_WHOLE_PX})")
    check(float(cpu_delta.max()) <= FUSED_WHOLE_PX,
          "the card's tracked rows differ from the CPU chain's")

    # accuracy: the tracker stays on the face
    errs = iod(torch.from_numpy(ref).cuda(), gt).cpu().numpy()
    worst = int(errs.argmax())
    beyond = np.flatnonzero(errs > 2 * errs[0])
    first_beyond = int(beyond[0]) if beyond.size else None
    shown = [k for k in (1, 8, 64, n - 1) if k < n]
    log(f"[track] IOD error of frame 0 (from the facebox) {errs[0]:.5f}; "
        f"frames {shown}: " + ", ".join(f"{errs[k]:.5f}" for k in shown)
        + f"; largest {errs[worst]:.5f} at frame {worst} (limit "
        f"{TRACK_IOD_LIMIT}: the tracker stays on the face); first frame "
        f"beyond 2x frame 0's: {first_beyond}")
    check(float(errs.max()) < TRACK_IOD_LIMIT,
          f"the tracker left the face: IOD error {errs.max()} at frame "
          f"{worst}")
    results.update(twin=whole, cpu_delta_px=float(cpu_delta.max()),
                   iod_frame0=float(errs[0]), iod_max=float(errs.max()),
                   iod_last=float(errs[-1]),
                   first_frame_beyond_2x=first_beyond,
                   pretrained_iod_frames=[float(e) for e in drift],
                   train_s=train_s, launches_per_clip=n)
    return results


def phase_profile(torch, label, size, call):
    """Where one call spends device time: torch.profiler kernel sums by
    name, and the device busy share of the call's wall."""
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
    log(f"[profile] {label} of {size}: wall {wall_ms:.3f} ms "
        f"(profiled), kernels busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for ms, count, key in rows[:12]:
        log(f"[profile]   {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                top=[dict(ms=ms, count=count, name=key[:120])
                     for ms, count, key in rows[:20]])


def kernel_entries(results, k1_errs, k2_errs, fused, train, probes,
                   families, remainder):
    """One entry per kernel (K1 and K2 per sampling mode). max_abs_err is,
    for K1 and K2, the largest of the twin checks at the stepped detector's
    inputs, those of the kernel phases and, in the sampling mode it ran,
    those at the window-backend training run's inputs; for K3 and K4 the largest per-level
    delta in px from equal rows; for K5 and K6 the largest feature
    difference over all levels. Times are sums over the launches of one
    call of the path (K5: one ``train_rcr`` of 11,264 samples; K6: one of
    1,408 samples in chunks of 512). library_ms is null: no single PyTorch
    call computes HOG, the truncated, quantised window sampling, the
    cascade or its feature rows. The probes' entries: ms from the probes'
    own run (P1 ``full``, P2 G = 4 and P3 pre = 1 at S = 55), launches
    from that run; library_ms is ``torch.mul``'s time for P4, whose function
    it computes, and null for the others. ms_source says which clock gave
    an entry's ms, plain_ms and library_ms: CUDA events around the call, or,
    for the four probe kernels that run for microseconds, the kernels'
    device time from torch.profiler (all three from that one clock).
    K1's exact entry also takes the errors of the dense training runs'
    patches (K1 in exact mode in every sampling mode) and their launches
    per call, ``dense_train_launches``."""
    entries = []
    trained = train["window_backend"]
    dense = remainder["dense"]["modes"]
    dense_k1 = max(lv["k1_err"] for m in dense.values() for lv in m["levels"])
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
                device_ms=total(f"{key}_device_ms"),
                launches=results[sampling]["launches"][name],
                max_abs_err=max(
                    errs[sampling], results[sampling][f"{key}_err"],
                    trained[f"{key}_err"] if trained["sampling"] == sampling
                    else 0.0,
                    dense_k1 if (name, sampling) == ("hog_flat", "exact")
                    else 0.0,
                    *(fam["stepped"][sampling][f"{key}_err"]
                      for fam in families.values())),
                ms=total(f"{key}_ms"),
                plain_ms=total(f"{key}_plain_ms"),
                bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations",
                library_ms=None))
    for name, r in fused["kernels"].items():
        source, replaces = SOURCES[name]
        b_bytes, b_ops = r["bound_bytes_ms"], r["bound_ops_ms"]
        family_errs = [fam[key]["level_err_px"] for fam in families.values()
                       for key in (("k3", "tracker")
                                   if name == "cascade_fused_frames"
                                   else ("k4",))]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"],
            max_abs_err=max(r["level_err_px"], *family_errs),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None))
    for name, r in train["kernels"].items():
        source, replaces = SOURCES[name]
        b_bytes, b_ops = r["bytes_ms"], r["ops_ms"]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=None))
    for r in probes["kernels"]:
        source, replaces = SOURCES[r["name"].split("/")[0]]
        b_bytes, b_ops = r["bound_bytes_ms"], r["bound_ops_ms"]
        entries.append(dict(
            name=r["name"], route="cuda", source=source, replaces=replaces,
            launches=r["launches"], max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=max(b_bytes, b_ops),
            bound_by="bytes" if b_bytes >= b_ops else "operations",
            library_ms=r["library_ms"], ms_source=r["ms_source"],
            **{k: r[k] for k in ("ms_flushed", "library_ms_flushed")
               if k in r}))
    for e in entries:
        e.setdefault("ms_source", "cuda_events")
        if e["name"] == "hog_flat/exact":
            e["dense_train_launches"] = dense["exact"]["launches"]["hog_flat"]
    return entries


def k3_inputs(torch, data, n_lm):
    """K3's inputs on the fused detector's path for the 4,096 faces of a
    family: the detector, the window origins and shape, the start rows in
    window coordinates."""
    from superviseddescent_tpu_torch.models.rcr import (
        DetectionModel, align_mean, rows_shift)
    model = data["model"] if n_lm == 22 else DetectionModel.load(
        os.path.join(REPO, "pretrained", f"rcr{n_lm}_lfpw5.bin"))
    fam = family_data(torch, data, model)
    det = model.make_fused_detector(roi=ROI, max_ied=fam["max_ied"])
    oy, ox, window = det.aligned_origins(data["frames"], fam["boxes"])
    x0 = align_mean(model.mean[None], fam["boxes"]) - rows_shift(
        ox.float(), oy.float(), n_lm)
    return det, oy, ox, window, x0


def plan_call(torch, det, frames, idx, oy, ox, window, x0, plan=None,
              defines=()):
    """A K3 launch on these faces with the (faces, group, threads) launch
    plan ``plan`` in place of ``launch_plan``'s (group 0: the group of its
    one-face plan), from the entry point's library or the measurement build
    ``defines``; None when the plan does not fit in a block. A measurement
    of this script only: the launch does not count."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _MAX_FACES, _MAX_SHARED, _check_config, _launch_args, _launch_frames,
        _shared_bytes, launch_plan)
    l = x0.shape[1] // 2
    c = _check_config(l, det.weights, *window, det.levels, det.cell_sizes,
                      det.num_bins, det.dims, det.r_idx, det.l_idx)
    s = max(lv[0] for lv in det.levels)
    if plan is not None:
        faces, group, threads = plan
        if group == 0:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            group = launch_plan(1, l, c, s, det.quantize, sms).group
        if faces > _MAX_FACES or _shared_bytes(
                l, c, s, det.quantize, faces, group, threads) > _MAX_SHARED:
            return None
    lib = load_library("cascade_fused", tuple(defines))

    def call():
        out, args = _launch_args(x0, det.weights, det.levels, det.cell_sizes,
                                 det.r_idx, det.l_idx, *window, c,
                                 det.quantize, x0.device)
        if plan is not None:
            args[-4:-1] = [faces, group, threads]
        _launch_frames(lib, frames, idx, oy, ox, args)
        return out
    return call


# batch sizes at which K3 is timed through its entry point: one face, the
# H100's 132 SMs and one face more, 2 to 8 x 132 faces (the one-wave
# limits of launch_plan's plans there are 3, 4, 6 and 8 x 132), 12 and 16 x
# 132, and the serving cell's 4,096
K3_BATCHES = (1, 132, 133, 264, 396, 528, 792, 1056, 1584, 2112, 4096)
# the kernel before the redesign at those sizes: device ms (torch.profiler)
# on an NVIDIA H100 80GB HBM3 at 700.00 W, the mean of two runs of
# ``--k3-batches --package-root`` on a checkout of that kernel
K3_BEFORE_BATCH_MS = {
    "rcr22": {1: 0.6693, 132: 0.7033, 133: 0.8128, 264: 0.8488, 396: 1.0618,
              528: 1.6277, 792: 2.0848, 1056: 2.7951, 1584: 4.0120,
              2112: 5.4977, 4096: 10.4593},
    "rcr68": {1: 2.6556, 132: 2.7736, 133: 2.9998, 264: 3.1827, 396: 6.0906,
              528: 6.2881, 792: 9.4758, 1056: 12.4779, 1584: 18.6627,
              2112: 24.7366, 4096: 48.9544}}
# launch plans (faces, group, threads) that ``--k3-batches --plans`` times
# beside the entry point at each batch size
K3_PLANS = ((1, 0, 1024), (1, 4, 256), (1, 2, 256), (1, 1, 256), (2, 1, 256),
            (2, 2, 256))


def k3_batches(torch, data, families=(22,), plans=(), slices=()):
    """K3's device time (torch.profiler) through its entry point on the
    first N faces of each family, at each N of K3_BATCHES; with ``plans``,
    those launch plans beside it, with ``slices``, the measurement builds
    that cut the weight rows into that many GEMV slices, at
    ``launch_plan``'s plan (``plan_call``)."""
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused_frames)
    frames, idx = data["frames"], data["sel_dev"]
    out = {}
    for n_lm in families:
        det, oy, ox, window, x0 = k3_inputs(torch, data, n_lm)
        consts = (det.num_bins, det.dims, det.r_idx, det.l_idx)
        rows = {}
        for n in K3_BATCHES:
            faces = (frames, idx[:n], oy[:n], ox[:n])

            def entry(faces=faces, x=x0[:n]):
                return detect_cascade_fused_frames(
                    *faces, x, det.weights, window, det.levels,
                    det.cell_sizes, *consts, quantize=det.quantize)
            row = {"entry": device_ms(torch, entry, match="cascade_kernel")}
            for plan in plans:
                call = plan_call(torch, det, *faces, window, x0[:n], plan)
                if call is not None:
                    row[",".join(map(str, plan))] = device_ms(
                        torch, call, match="cascade_kernel")
            for k in slices:
                call = plan_call(torch, det, *faces, window, x0[:n],
                                 defines=(f"CASCADE_GEMV_SLICES={k}",))
                row[f"slices={k}"] = device_ms(torch, call,
                                               match="cascade_kernel")
            rows[n] = row
            before = K3_BEFORE_BATCH_MS.get(f"rcr{n_lm}", {}).get(n)
            log(f"[K3 batch] rcr{n_lm} N={n}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items())
                + ("" if before is None else f" (before the redesign "
                   f"{before})"))
        out[f"rcr{n_lm}"] = rows
    return out


# K1 and K2 on the stepped detector's path before their redesign: device ms
# per level (torch.profiler) at 4,096 faces, family -> sampling -> (K2 ms,
# K1 ms) per level, on an NVIDIA H100 80GB HBM3 at 700.00 W, the mean of two
# runs of ``--k12 --package-root`` on a checkout of those kernels
K12_BEFORE_MS = {
    "rcr22": {"exact": [(1.2139, 4.3599), (1.0542, 3.7994),
                        (0.7323, 2.7813), (0.4997, 1.9475)],
              "fast": [(1.2764, 4.0379), (1.102, 3.5649),
                       (0.7687, 2.6175), (0.5228, 1.8584)]},
    "rcr29": {"exact": [(1.5989, 5.7007), (1.3712, 5.0066),
                        (0.9656, 3.6656), (0.6597, 2.5773)],
              "fast": [(1.6743, 5.3154), (1.4411, 4.6981),
                       (1.0132, 3.4471), (0.6873, 2.4501)]},
    "rcr68": {"exact": [(3.652, 13.3467), (3.1176, 11.7194),
                        (2.1958, 8.581), (1.5079, 6.01)],
              "fast": [(3.8805, 12.449), (3.314, 10.9886),
                       (2.3255, 8.0345), (1.6062, 5.7356)]}}


def stepped_levels(model, det, images, boxes, final=None):
    """The stepped detector ``det``'s K2 and K1 arguments at each level on
    these faces: yields (level, windows, sampler args, sampler kwargs, hog
    kwargs), then advances the rows through the detector's own level. With
    ``final`` (a list), appends the rows after the last level, in image
    coordinates."""
    from superviseddescent_tpu_torch.models.rcr import align_mean, rows_shift
    n_lm = len(model.landmark_ids)
    windows, ox, oy = det.crop(images, boxes)
    x = align_mean(model.mean[None], boxes) - rows_shift(ox, oy, n_lm)
    hog = det.transform(windows)
    for li in range(len(model.hog_params)):
        args, skw, hkw = hog.window_args(x, li)
        yield li, windows, args, skw, hkw
        x = det.level(li, windows, x)
    if final is not None:
        final.append(x + rows_shift(ox, oy, n_lm))


def k12_device_ms(torch, args, skw, hkw):
    """K2's and K1's device ms (torch.profiler) through their entry points
    at one level's arguments, K1 on the patches that K2 returns."""
    from superviseddescent_tpu_torch.ops.hog_flat import hog_descriptor_flat
    from superviseddescent_tpu_torch.ops.j2k import j2k_colour, j2k_idwt
    from superviseddescent_tpu_torch.ops.jpeg import (
        jpeg_coefficients, jpeg_pixels)
    from superviseddescent_tpu_torch.ops.patches_window import (
        sample_patches_window)
    n, l = args[1].shape
    s = args[4]
    patches = sample_patches_window(*args, **skw).reshape(n * l, s * s)
    k2 = device_ms(torch, lambda: sample_patches_window(*args, **skw),
                   match="patches_window")
    k1 = device_ms(torch, lambda: hog_descriptor_flat(patches, **hkw),
                   match="hog_flat")
    return k2, k1


def k12_before(tag, sampling, li):
    """The recorded (K2, K1) device ms before the redesign, or None."""
    levels = K12_BEFORE_MS.get(tag, {}).get(sampling)
    return None if levels is None else levels[li]


def phase_cycles(torch, name, symbol, defines, call, phases):
    """Thread 0's cycles per phase of one launch of a measurement build,
    as shares of their sum."""
    from superviseddescent_tpu_torch.ops._build import load_library
    fn = getattr(load_library(name, defines), symbol)
    fn.argtypes = [ctypes.c_void_p]
    cycles = (ctypes.c_ulonglong * len(phases))()
    check(fn(ctypes.byref(cycles)) == 0, f"{symbol}")   # zero the sums
    call()
    torch.cuda.synchronize()
    check(fn(ctypes.byref(cycles)) == 0, f"{symbol}")
    total = max(1, sum(cycles))
    return {phase: cycles[k] / total for k, phase in enumerate(phases)}


def k12_split(torch, windows, args, skw, hkw):
    """Where K2's and K1's time goes at one level's arguments (device ms,
    torch.profiler): each kernel whole beside a measurement build of its
    source (K2 computing every pixel but storing none, K1 skipping its
    splat), and thread 0's cycles per phase. K1 runs on the patches K2
    wrote. Measurement builds are launched here only; their launches do
    not count."""
    from superviseddescent_tpu_torch.ops import hog_flat as k1
    from superviseddescent_tpu_torch.ops import patches_window as k2
    from superviseddescent_tpu_torch.ops._build import load_library
    n, l = args[1].shape
    s = args[4]
    oxy, sp = k2._prepare(args[1], args[2], args[3], s)
    w = skw["sub_window"] or windows.shape[1]
    wx = skw["sub_window_x"] or windows.shape[2]
    patches = torch.empty((n, l, s, s), dtype=skw["out_dtype"],
                          device=windows.device)
    flat = patches.reshape(n * l, s * s)
    c = k1.hog_num_cells(s, hkw["cell_size"])
    desc = torch.empty((n * l, k1.hog_dimension(
        hkw["variant"], hkw["num_orientations"]) * c * c),
        dtype=torch.float32, device=windows.device)

    def k2_call(defines=()):
        lib = load_library("patches_window", defines)
        return lambda: k2._launch(
            lib, windows, oxy, sp, patches, w, wx, skw["quantize"],
            skw["sampling"] == "fast", skw["transposed"])

    def k1_call(defines=()):
        lib = load_library("hog_flat", defines)
        return lambda: k1._launch(
            lib, flat, desc, hkw["size"], hkw["cell_size"],
            hkw["num_orientations"], hkw["variant"], hkw["fast"],
            hkw["transposed"])
    split = dict(k2_ms=device_ms(torch, k2_call(), match="patches_window"))
    split["k2_no_store_ms"] = device_ms(
        torch, k2_call(K12_BUILDS[2][1]), match="patches_window")
    split["k1_ms"] = device_ms(torch, k1_call(), match="hog_flat")
    split["k1_no_splat_ms"] = device_ms(
        torch, k1_call(K12_BUILDS[0][1]), match="hog_flat")
    split["k2_phases"] = phase_cycles(
        torch, "patches_window", "patches_phase_cycles", K12_BUILDS[3][1],
        k2_call(K12_BUILDS[3][1]), K2_PHASES)
    split["k1_phases"] = phase_cycles(
        torch, "hog_flat", "hog_phase_cycles", K12_BUILDS[1][1],
        k1_call(K12_BUILDS[1][1]), K1_PHASES)
    log(f"[split] S={s} {skw['sampling']}: K2 {split['k2_ms']:.4f} ms, "
        f"without its stores {split['k2_no_store_ms']:.4f} ms; K1 "
        f"{split['k1_ms']:.4f} ms, without its splat "
        f"{split['k1_no_splat_ms']:.4f} ms")
    for key in ("k2_phases", "k1_phases"):
        log(f"[split]   {key[:2].upper()} phase shares (thread 0's cycles): "
            + ", ".join(f"{k} {100 * v:.1f}%" for k, v in split[key].items()))
    return split


# patches per block that ``--k12 --sweep`` times beside the launch plans
K1_SWEEP = (1, 2, 3)
K2_SWEEP = (1, 2, 4, 6, 8, 12, 16)


def k12_sweep(torch, windows, args, skw, hkw):
    """K2's and K1's device ms at one level's arguments for each number of
    patches per block in K2_SWEEP / K1_SWEEP (through ``_launch``, whose
    launches do not count); a block that exceeds the shared memory of the
    card is left out."""
    from superviseddescent_tpu_torch.ops import hog_flat as k1
    from superviseddescent_tpu_torch.ops import patches_window as k2
    from superviseddescent_tpu_torch.ops._build import load_library
    n, l = args[1].shape
    s = args[4]
    oxy, sp = k2._prepare(args[1], args[2], args[3], s)
    w = skw["sub_window"] or windows.shape[1]
    wx = skw["sub_window_x"] or windows.shape[2]
    patches = torch.empty((n, l, s, s), dtype=skw["out_dtype"],
                          device=windows.device)
    c = k1.hog_num_cells(s, hkw["cell_size"])
    desc = torch.empty((n * l, 16 * c * c), dtype=torch.float32,
                       device=windows.device)
    lib2, lib1 = load_library("patches_window"), load_library("hog_flat")
    times = {"k2": {}, "k1": {}}
    for g in K2_SWEEP:
        if k2._shared_bytes(s, g, skw["transposed"],
                            patches.element_size()) > 200 * 1024:
            continue
        times["k2"][g] = device_ms(torch, lambda g=g: k2._launch(
            lib2, windows, oxy, sp, patches, w, wx, skw["quantize"],
            skw["sampling"] == "fast", skw["transposed"], g),
            match="patches_window")
    flat = patches.reshape(n * l, s * s)
    for p in K1_SWEEP:
        if k1._shared_bytes(s, hkw["cell_size"], hkw["num_orientations"], p,
                            k1.separable(s, hkw["cell_size"],
                                         hkw["num_orientations"], p,
                                         hkw["fast"])) > 200 * 1024:
            continue
        times["k1"][p] = device_ms(torch, lambda p=p: k1._launch(
            lib1, flat, desc, hkw["size"], hkw["cell_size"],
            hkw["num_orientations"], hkw["variant"], hkw["fast"],
            hkw["transposed"], p), match="hog_flat")
    log(f"[sweep] S={s} {skw['sampling']}: K2 by patches per block " +
        ", ".join(f"{g}: {ms:.4f}" for g, ms in times["k2"].items()) +
        " | K1 " + ", ".join(f"{p}: {ms:.4f}" for p, ms in
                             times["k1"].items()))
    return times


def k12_levels(torch, data, families=(22, 29, 68), split=False,
               sweep=False):
    """K2's and K1's device ms through their entry points at every level of
    the stepped detector, exact and fast, on the 4,096 faces of each family,
    beside their bounds and the times before the redesign; with ``split``,
    ``k12_split`` at each RCR-22 level, with ``sweep``, ``k12_sweep``."""
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.ops.patches_window import _prepare
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    out = {}
    for n_lm in families:
        tag = f"rcr{n_lm}"
        model = data["model"] if n_lm == 22 else DetectionModel.load(
            os.path.join(REPO, "pretrained", f"{tag}_lfpw5.bin"))
        fam = family_data(torch, data, model)
        for sampling in ("exact", "fast"):
            det = model.make_stepped_detector(
                BATCH, roi=ROI, sampling=sampling, window_sampler=True,
                max_ied=fam["max_ied"])
            detect_ms = cuda_time_ms(det, data["images"], fam["boxes"],
                                     reps=10, warmup=2)[0]
            log(f"[K12] {tag} {sampling}: stepped detect {detect_ms:.3f} ms "
                f"(CUDA events, median of 10) -> "
                f"{BATCH / detect_ms * 1e3:.0f} faces/s")
            profile = None
            if n_lm == 22 and sampling == "exact":
                profile = phase_profile(
                    torch, f"{tag} exact stepped detect", f"{BATCH} faces",
                    lambda: det(data["images"], fam["boxes"]))
            rows = []
            for li, windows, args, skw, hkw in stepped_levels(
                    model, det, data["images"], fam["boxes"]):
                p = model.hog_params[li]
                n, l, s = BATCH, n_lm, p.patch_size
                k2_ms, k1_ms = k12_device_ms(torch, args, skw, hkw)
                oxy, sp = _prepare(args[1], args[2], args[3], s)
                k2_b = max(k2_bound(
                    torch, windows, oxy, sp, s,
                    skw["sub_window"] or windows.shape[1],
                    skw["sub_window_x"] or windows.shape[2], skw)) * 1e3
                in_bytes = 2 if skw["out_dtype"] == torch.bfloat16 else 4
                k1_b = max(k1_bound(n * l, p, in_bytes)) * 1e3
                row = dict(level=li, S=s, k2_ms=k2_ms, k1_ms=k1_ms,
                           k2_bound_ms=k2_b, k1_bound_ms=k1_b)
                before = k12_before(tag, sampling, li)
                if split and n_lm == 22:
                    row["split"] = k12_split(torch, windows, args, skw, hkw)
                if sweep and n_lm == 22:
                    row["sweep"] = k12_sweep(torch, windows, args, skw, hkw)
                rows.append(row)
                log(f"[K12] {tag} {sampling} level {li} S={s}: K2 "
                    f"{k2_ms:.4f} ms (bound {k2_b:.4f}) | K1 {k1_ms:.4f} ms "
                    f"(bound {k1_b:.4f})" + ("" if before is None else
                                             f" | recorded before the "
                                             f"redesign K2 {before[0]}, K1 "
                                             f"{before[1]}"))
                torch.cuda.empty_cache()
            del det, windows
            out.setdefault(tag, {})[sampling] = dict(
                levels=rows, detect_ms=detect_ms, profile=profile)
            log(f"[K12] {tag} {sampling} per detect call: K2 "
                f"{sum(r['k2_ms'] for r in rows):.4f} ms, K1 "
                f"{sum(r['k1_ms'] for r in rows):.4f} ms")
    return out


def train_level(hog, li, window):
    """Level ``li`` of a training problem's feature transform as K5 / K6
    take it: (S, W, WX, relative patch size), the full window's side where
    a sub-window is not set."""
    p = hog.hog_params[li]
    return (p.patch_size, hog.sub_windows[li] or window[0],
            hog.sub_windows_x[li] or window[1], p.relative_patch_size)


def k5_call(torch, frames, idx, oy, ox, x, window, level, cell_size, eyes,
            defines=(), plan=None):
    """A K5 launch at one level's arguments from the entry point's library
    or the measurement build ``defines``, with ``features_launch_plan``'s
    plan or ``plan``. A measurement of this script only: the launch does
    not count."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _check_level, _features_launch_args, _launch_features_frames)
    lv, c, f = _check_level(x.shape[1] // 2, *window, level, cell_size, 4,
                            16, *eyes)
    lib = load_library("features_fused", tuple(defines))

    def launch():
        out, args = _features_launch_args(x, lv, cell_size, *eyes, *window,
                                          c, f, plan)
        _launch_features_frames(lib, frames, idx, oy, ox, args)
        return out
    return launch


def k5_split(torch, *args):
    """Where K5's time goes at one level's arguments (``k5_call``'s; device
    ms, torch.profiler): the kernel whole beside a measurement build of its
    source that computes every channel and stores no row, and thread 0's
    cycles per phase (``K5_PHASES``)."""
    split = dict(ms=device_ms(torch, k5_call(torch, *args),
                              match="features_kernel"))
    split["no_store_ms"] = device_ms(
        torch, k5_call(torch, *args, defines=K5_BUILDS[0][1]),
        match="features_kernel")
    split["phases"] = phase_cycles(
        torch, "features_fused", "features_phase_cycles", K5_BUILDS[1][1],
        k5_call(torch, *args, defines=K5_BUILDS[1][1]), K5_PHASES)
    log(f"[split] K5 S={args[6][0]} on {args[4].shape[0]} samples: whole "
        f"{split['ms']:.4f} ms, without its row stores "
        f"{split['no_store_ms']:.4f} ms; phase shares (thread 0's cycles): "
        + ", ".join(f"{k} {100 * v:.1f}%" for k, v in split["phases"].items()))
    return split


def k5_sweep(torch, *args, windows=None):
    """K5's device ms at one level's arguments (``k5_call``'s) for each
    launch plan of K5_SWEEP that fits in a block; with ``windows`` (a list
    of (bf16 windows, rows) chunks), K6's over the chunks instead."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        _MAX_SHARED, _check_level, _features_launch_args,
        _features_shared_bytes, _launch_features, features_launch_plan,
        hog_num_cells)
    level, cs, eyes = args[6], args[7], args[8]
    c = hog_num_cells(level[0], cs)
    l = args[4].shape[1] // 2
    n = args[4].shape[0] if windows is None else windows[0][1].shape[0]
    chosen = features_launch_plan(
        n, l, c, level[0],
        torch.cuda.get_device_properties(0).multi_processor_count)
    lib = load_library("features_fused")

    def k6(plan):
        def launch():
            for w, x in windows:
                lv, _, f = _check_level(l, *w.shape[1:], level, cs, 4, 16,
                                        *eyes)
                _out, largs = _features_launch_args(
                    x, lv, cs, *eyes, *w.shape[1:], c, f, plan)
                _launch_features(lib, w, largs)
        return launch
    times = {}
    for plan in K5_SWEEP:
        if plan[1] > l or _features_shared_bytes(
                c, level[0], *plan) > _MAX_SHARED:
            continue
        call = (k5_call(torch, *args, plan=plan) if windows is None
                else k6(plan))
        times[",".join(map(str, plan))] = device_ms(
            torch, call, match="features_kernel", one_kernel=windows is None)
    log(f"[sweep] {'K5' if windows is None else 'K6'} S={level[0]} (plan "
        f"{tuple(chosen[:3])}): " + ", ".join(
            f"{k}: {ms:.4f}" for k, ms in times.items()))
    return times


def features_vs_twin(torch, label, got, ref):
    """K5 / K6 rows against their twin's: max abs error and the count of
    unequal entries, logged; fails beyond FEATURES_ATOL."""
    check(bool(torch.isfinite(got).all()), f"{label}: NaN in the rows")
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    unequal = int((got != ref).sum())
    log(f"[K5] {label} vs twin on {got.shape[0]} samples x {got.shape[1]} "
        f"features: max abs {err:.3e}, {unequal} unequal entries of "
        f"{got.numel()} (tolerance {FEATURES_ATOL})")
    check(err <= FEATURES_ATOL, f"{label} disagrees with its twin")
    return err, unequal


def k5_levels(torch, data, split=False, sweep=False):
    """K5 and K6 through their entry points, device ms (torch.profiler):
    K5 at each level of the RCR-22 training replay (11,264 samples, the
    levels' rows advanced by the trained regressors as ``phase_train``
    does), K6 at each level of the 1,408-sample windows run (chunks of
    512), and K5 over the 4,096 faces of RCR-22, COFW-29 and ibug-68 at
    K3's per-level rows (``k3_split``'s K5); every call held against its
    twin with the count of unequal entries. Beside them the warm
    ``train_rcr`` (three calls, host clock), its profile and the trained
    model's train-set IOD error (fused detector, 4,096 faces). With
    ``split``, ``k5_split`` at each training level, with ``sweep``,
    ``k5_sweep``."""
    import numpy as np
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, normalised_landmark_errors, train_rcr,
        training_problem)
    from superviseddescent_tpu_torch.ops.cascade_fused import (
        detect_cascade_fused_frames, extract_features_fused,
        extract_features_fused_frames,
        extract_features_fused_frames_reference,
        extract_features_fused_reference, prepare_weights)
    model, frames = data["model"], data["frames"]
    ids = (model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
    eyes = (data["r_idx"], data["l_idx"])
    mean = model.mean.cpu().numpy()
    n_img = frames.shape[0]
    out = {}

    # ---- training: warm wall time, profile, the trained model's error ----
    cfg = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                         solver_method="lu")
    sel = np.arange(TRAIN_FACES) % n_img
    args = (frames, data["image_gt"][sel], data["image_boxes"][sel], *ids,
            mean, cfg)
    trained = train_rcr(*args, image_indices=sel)
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_rcr(*args, image_indices=sel)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    profile = phase_profile(torch, "train_rcr (fused, K5)",
                            f"{TRAIN_FACES * 11} samples",
                            lambda: train_rcr(*args, image_indices=sel))
    rows = trained.make_fused_detector(roi=ROI, max_ied=data["max_ied"])(
        frames, data["boxes"], image_indices=data["sel_dev"])
    iod = float(normalised_landmark_errors(rows, data["gt"], *eyes).mean())
    log(f"[K5] warm train_rcr: {', '.join(f'{t:.4f}' for t in warm)} s; "
        f"trained model's train-set IOD error (fused, {BATCH} faces) "
        f"{iod!r}")
    out["train"] = dict(warm_s=warm, iod=iod, profile=profile)

    # ---- K5 at each level of the training replay ----
    prob = training_problem(*args, image_indices=sel)
    hog, x = prob.hog, prob.x0
    window = hog.frame_window
    fi, foy, fox = (t[hog.image_indices.long()] for t in hog.frame_table)
    levels = []
    for li, p in enumerate(cfg.hog_params):
        level = train_level(hog, li, window)
        k5args = (frames, fi, foy, fox, x, window, level, p.cell_size,
                  p.num_bins, 16, *eyes)
        feats = extract_features_fused_frames(*k5args)
        ref = extract_features_fused_frames_reference(
            frames, fi, foy, fox, x, window, level, p.cell_size, *eyes)
        err, unequal = features_vs_twin(torch, f"K5 training level {li}",
                                        feats, ref)
        del ref
        ms = device_ms(torch, lambda: extract_features_fused_frames(*k5args),
                       match="features_kernel")
        b_bytes, b_ops, _ = features_bound(torch, p, level, x, window, 1,
                                           eyes, feats.shape[1])
        row = dict(level=li, S=p.patch_size, ms=ms, max_abs_err=err,
                   unequal=unequal, bound_ms=max(b_bytes, b_ops) * 1e3)
        log(f"[K5] training level {li} S={p.patch_size}: {ms:.4f} ms "
            f"(bound {row['bound_ms']:.4f})")
        call = (frames, fi, foy, fox, x, window, level, p.cell_size, eyes)
        if split:
            row["split"] = k5_split(torch, *call)
        if sweep:
            row["sweep"] = k5_sweep(torch, *call)
        levels.append(row)
        reg = trained.sdo.regressors[li]
        x = x - reg.predict(feats) / prob.sdo.normalisation(x)
        del feats
        torch.cuda.empty_cache()
    out["k5_train"] = levels
    log(f"[K5] per train_rcr: {sum(r['ms'] for r in levels):.4f} ms")
    del prob, hog, x

    # ---- K6 at each level of the windows run ----
    sel_s = np.arange(TRAIN_FACES_SMALL) % n_img
    cfg6 = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                          solver_method="lu", feature_chunk_size=TRAIN_CHUNK)
    args6 = (frames.float(), data["image_gt"][sel_s],
             data["image_boxes"][sel_s], *ids, mean, cfg6)
    trained6 = train_rcr(*args6, image_indices=sel_s)
    prob = training_problem(*args6, image_indices=sel_s)
    hog, x = prob.hog, prob.x0
    sample_idx = hog.image_indices.long()
    window = tuple(hog.images.shape[1:])
    n_s = x.shape[0]
    spans = [slice(a, a + TRAIN_CHUNK) for a in range(0, n_s, TRAIN_CHUNK)]
    levels6 = []
    for li, p in enumerate(cfg6.hog_params):
        level = train_level(hog, li, window)
        tail = (level, p.cell_size, p.num_bins, 16, *eyes)
        gathered = [(hog.images[sample_idx[sp]], x[sp]) for sp in spans]
        feats = torch.cat([extract_features_fused(w, xc, *tail)
                           for w, xc in gathered])
        ref = extract_features_fused_reference(
            hog.images[sample_idx], x, level, p.cell_size, *eyes)
        err, unequal = features_vs_twin(torch, f"K6 level {li}", feats, ref)
        del ref
        ms = device_ms(torch, lambda: [extract_features_fused(w, xc, *tail)
                                       for w, xc in gathered],
                       match="features_kernel", one_kernel=False)
        levels6.append(dict(level=li, S=p.patch_size, ms=ms,
                            launches=len(spans), max_abs_err=err,
                            unequal=unequal))
        if sweep:
            levels6[-1]["sweep"] = k5_sweep(
                torch, frames, None, None, None, x, window, level,
                p.cell_size, eyes, windows=gathered)
        log(f"[K5] K6 level {li} S={p.patch_size}: {len(spans)} launches "
            f"{ms:.4f} ms")
        x = trained6.sdo.step(li, x, feats)
        del feats, gathered
    out["k6_train"] = levels6
    log(f"[K5] K6 per train_rcr: {sum(r['ms'] for r in levels6):.4f} ms")
    del prob, hog, x, trained6
    torch.cuda.empty_cache()

    # ---- K5 over the 4,096 faces of each family at K3's per-level rows ----
    idx = data["sel_dev"]
    for n_lm in (22, 29, 68):
        det, oy, ox, window, x = k3_inputs(torch, data, n_lm)
        consts = (det.num_bins, det.dims, det.r_idx, det.l_idx)
        fam = []
        for li, level in enumerate(det.levels):
            cs = det.cell_sizes[li]
            k5args = (frames, idx, oy, ox, x, window, level, cs, *consts)
            feats = extract_features_fused_frames(*k5args)
            ref = extract_features_fused_frames_reference(
                frames, idx, oy, ox, x, window, level, cs, det.r_idx,
                det.l_idx)
            err, unequal = features_vs_twin(
                torch, f"K5 rcr{n_lm} level {li}", feats, ref)
            del feats, ref
            ms = device_ms(torch,
                           lambda: extract_features_fused_frames(*k5args),
                           match="features_kernel")
            fam.append(dict(level=li, S=level[0], ms=ms, max_abs_err=err,
                            unequal=unequal))
            w1 = prepare_weights([det.model.sdo.regressors[li].weights],
                                 frames.device)
            x = detect_cascade_fused_frames(
                frames, idx, oy, ox, x, w1, window, (level,), (cs,),
                *consts, quantize=det.quantize)
            torch.cuda.empty_cache()
        out[f"k5_rcr{n_lm}"] = fam
        log(f"[K5] rcr{n_lm} {BATCH} faces: "
            + ", ".join(f"{r['ms']:.4f}" for r in fam)
            + f" ms; sum {sum(r['ms'] for r in fam):.4f} ms")
    return out


# measurement builds of the P1-P3 source for probe_split, never entry
# points: every pixel computed and none stored; every tap taken from an
# arithmetic stand-in instead of the window (no window read); thread 0's
# cycles per phase
PROBE_BUILDS = (("probe_sampler", ("PROBE_SKIP_STORE",)),
                ("probe_sampler", ("PROBE_NO_GATHER",)),
                ("probe_sampler", ("PROBE_PHASE_CLOCKS",)))
PROBE_PHASES = ("origins and tables", "taps, products and tile", "stores")
# P1-P3 and P5 before their redesign: device ms (torch.profiler) at the
# probe scripts' shapes, on an NVIDIA H100 80GB HBM3 at 700.00 W, the mean
# of two runs of ``--probes --package-root`` on a checkout of those kernels
PROBE_BEFORE_MS = {
    "S=55 W=160 WX=384 full": 0.45527, "S=55 W=160 WX=384 shared": 0.43654,
    "S=55 W=160 WX=384 nodot": 0.19831, "S=55 W=160 WX=384 G=1": 0.4556,
    "S=55 W=160 WX=384 G=2": 0.45999, "S=55 W=160 WX=384 G=4": 0.66305,
    "S=55 W=160 WX=384 pre=0": 0.45562, "S=55 W=160 WX=384 pre=1": 0.47117,
    "S=40 W=72 WX=256 full": 0.22975, "S=40 W=72 WX=256 shared": 0.2149,
    "S=40 W=72 WX=256 nodot": 0.12519, "S=40 W=72 WX=256 G=1": 0.22823,
    "S=40 W=72 WX=256 G=2": 0.24146, "S=40 W=72 WX=256 G=4": 0.35261,
    "S=40 W=72 WX=256 pre=0": 0.22813, "S=40 W=72 WX=256 pre=1": 0.22797,
    "ABDE": 0.31954, "C": 0.00344, "C4": 0.00658}
# the threads a P1-P3 plan aims at, which ``--probes --sweep`` times beside
# launch_plan's at every G
PROBE_SWEEP = (256, 384, 512, 640, 768, 896, 1024)


def probe_cases(torch, seed, batch=1024, roi=512, n_lm=22):
    """The sampler probes' inputs at the probe scripts' shapes: yields
    (head, windows, oxy, sp, oo, s, w, wx), ``run_all``'s inputs."""
    from superviseddescent_tpu_torch import probes
    from superviseddescent_tpu_torch.probes.sampler import sub_window_origins
    windows = probes.sampler_windows(seed, batch, roi, "cuda")
    cx, cy = probes.sampler_centres(seed, batch, n_lm, roi)
    for s, w, wx, ph in probes.SAMPLER_SHAPES:
        oxy, sp = probes.sampler_inputs(cx, cy, s, ph, "cuda")
        oo = sub_window_origins(oxy, sp, roi, roi, s, w, wx)
        yield f"S={s} W={w} WX={wx}", windows, oxy, sp, oo, s, w, wx


def probe_times(torch, seed):
    """Device ms (torch.profiler, mean of 20 launches) of every P1-P3
    variant, G and pre at the probe scripts' shapes and of the three P5
    kernels, through their entry points, each output held against its twin:
    {label: dict(ms, unequal)} (P1 variants against the twin, G and pre
    against P1 full, in unequal entries; ABDE's relative error against its
    twin; C / C4 unequal entries). Times the package on ``sys.path``."""
    from superviseddescent_tpu_torch import probes
    from superviseddescent_tpu_torch.probes.dyn import (
        probe_abde, probe_abde_reference, probe_c, probe_c4,
        probe_c_reference)
    from superviseddescent_tpu_torch.probes.sampler import (
        VARIANTS, probe_sampler, probe_sampler_g, probe_sampler_pre,
        probe_sampler_reference)

    def unequal(a, b):
        return int((a.view(torch.int16) != b.view(torch.int16)).sum())

    out = {}
    for head, windows, oxy, sp, oo, s, w, wx in probe_cases(torch, seed):
        full = probe_sampler(windows, oxy, sp, "full", s, w, wx)
        for variant in VARIANTS:
            got = probe_sampler(windows, oxy, sp, variant, s, w, wx)
            ref = probe_sampler_reference(windows, oxy, sp, s, w, wx, variant)
            out[f"{head} {variant}"] = dict(ms=device_ms(
                torch, lambda v=variant: probe_sampler(windows, oxy, sp, v, s,
                                                       w, wx),
                match="probe_"), unequal=unequal(got, ref))
            del got, ref
        for g in (1, 2, 4):
            got = probe_sampler_g(windows, oxy, sp, g, s, w, wx)
            out[f"{head} G={g}"] = dict(ms=device_ms(
                torch, lambda g=g: probe_sampler_g(windows, oxy, sp, g, s, w,
                                                   wx),
                match="probe_"), unequal=unequal(got, full))
        for pre in (0, 1):
            got = probe_sampler_pre(windows, oxy, sp, oo, pre, s, w, wx)
            out[f"{head} pre={pre}"] = dict(ms=device_ms(
                torch, lambda p=pre: probe_sampler_pre(windows, oxy, sp, oo,
                                                       p, s, w, wx),
                match="probe_"), unequal=unequal(got, full))
        del full, got
    del windows
    torch.cuda.empty_cache()
    d = probes.DYN
    xd, win, v = probes.dyn_inputs(seed, "cuda", **d)
    shape = (d["s"], d["w"], d["wx"], d["seg"])
    got = probe_abde(xd, win, *shape)
    ref = probe_abde_reference(xd, win, *shape)
    out["ABDE"] = dict(ms=device_ms(torch, lambda: probe_abde(xd, win, *shape),
                                    match="probe_"),
                       rel=float(((got - ref).abs() / ref.abs()).max()))
    ref_c = probe_c_reference(v, d["g"], d["br"])
    for tag, fn in (("C", probe_c), ("C4", probe_c4)):
        out[tag] = dict(ms=device_ms(torch, lambda fn=fn: fn(v, d["g"],
                                                            d["br"]),
                                     match="probe_"),
                        unequal=int((fn(v, d["g"], d["br"]) != ref_c).sum()))
    return out


def launch_floor_ms(torch):
    """Device ms (torch.profiler) of an empty kernel of one 256-thread
    block: the floor under every launch, C's and C4's included."""
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("probe_dyn")
    return device_ms(torch, lambda: check(lib.probe_empty_launch(
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0,
        "the empty kernel's launch"), match="probe_")


def probe_split(torch, seed):
    """Where P1 ``full``'s time goes at each probe shape (device ms,
    torch.profiler): the kernel whole, without its stores and without its
    window reads (measurement builds, launched here only), and thread 0's
    cycles per phase."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.probes import sampler
    out = {}
    for head, windows, oxy, sp, oo, s, w, wx in probe_cases(torch, seed):
        n, l = oxy.shape[0], oxy.shape[2] // 2
        dst = torch.empty((n, l, s, s), dtype=torch.bfloat16, device="cuda")

        def call(defines=()):
            lib = load_library("probe_sampler", defines)
            return lambda: sampler._launch(lib, windows, oxy, sp, oo, dst,
                                           "full", 1, False, s, w, wx)
        split = dict(ms=device_ms(torch, call(), match="probe_"),
                     no_store_ms=device_ms(torch, call(PROBE_BUILDS[0][1]),
                                           match="probe_"),
                     no_gather_ms=device_ms(torch, call(PROBE_BUILDS[1][1]),
                                            match="probe_"))
        split["phases"] = phase_cycles(
            torch, "probe_sampler", "probe_phase_cycles", PROBE_BUILDS[2][1],
            call(PROBE_BUILDS[2][1]), PROBE_PHASES)
        log(f"[split] P1 {head} full: whole {split['ms']:.4f} ms, without "
            f"its stores {split['no_store_ms']:.4f} ms, without its window "
            f"reads {split['no_gather_ms']:.4f} ms; thread 0's cycles: "
            + ", ".join(f"{k} {100 * v:.1f}%"
                        for k, v in split["phases"].items()))
        out[head] = split
        del dst
    torch.cuda.empty_cache()
    return out


def probe_sweep(torch, seed):
    """P1 ``full``'s device ms at each probe shape and G = 1, 2, 4 for the
    plans that aim at each number of threads in PROBE_SWEEP (through
    ``_launch``, whose launches do not count)."""
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.probes import sampler
    lib = load_library("probe_sampler")
    out = {}
    for head, windows, oxy, sp, oo, s, w, wx in probe_cases(torch, seed):
        n, l = oxy.shape[0], oxy.shape[2] // 2
        dst = torch.empty((n, l, s, s), dtype=torch.bfloat16, device="cuda")
        for g in (1, 2, 4):
            times = {}
            for target in PROBE_SWEEP + PROBE_SWEEP[::-1]:
                plan = sampler.launch_plan(l, s, target)
                ms = device_ms(torch, lambda: sampler._launch(
                    lib, windows, oxy, sp, oo, dst, "full", g, False, s, w,
                    wx, plan), reps=60, match="probe_")
                times.setdefault(f"{plan.group}x{plan.threads}",
                                 []).append(round(ms, 4))
            out[f"{head} G={g}"] = times
            log(f"[sweep] P1 {head} full G={g}, ms by plan (patches in "
                f"flight x threads; the sweep forward, then back): "
                + ", ".join(f"{k}: {v}" for k, v in times.items()))
        del dst
    torch.cuda.empty_cache()
    return out


def other_runs(root, times, flags):
    """``times()`` of this checkout's package and, where ``root`` is
    another checkout, the same times of that checkout's package: the last
    line of a child ``chip_smoke.py *flags --package-root root``; in the
    order other, this, this, other. Returns {"this": [...], "other":
    [...]}."""
    runs = {"this": [], "other": []}
    order = ["other", "this", "this", "other"] if root != REPO else ["this"]
    for who in order:
        if who == "this":
            runs["this"].append(times())
            continue
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), *flags,
             "--package-root", root], capture_output=True, text=True)
        check(child.returncode == 0, f"the other package's {flags[-1]}: "
              + child.stdout[-2000:] + child.stderr[-2000:])
        runs["other"].append(json.loads(child.stdout.strip().splitlines()[-1]))
    return runs


def probe_levels(torch, seed, root, sweep=False):
    """``--probes``: ``probe_times`` of this checkout's package and, with
    another checkout's (``root``), of that package (``other_runs``); the
    per-variant lines side by side; ``probe_split``, the launch floor and,
    with ``sweep``, ``probe_sweep`` for this checkout's package."""
    runs = other_runs(root, lambda: probe_times(torch, seed),
                      ["--probes", "--seed", str(seed), "--probe-times"])
    for label in runs["this"][0]:
        def fmt(who):
            return " / ".join(f"{r[label]['ms']:.4f}" for r in runs[who])
        errs = " / ".join(str(r[label].get("unequal", r[label].get("rel")))
                          for r in runs["this"])
        line = f"[probes] {label}: this tree {fmt('this')} ms"
        if runs["other"]:
            ratio = (min(r[label]["ms"] for r in runs["other"])
                     / max(r[label]["ms"] for r in runs["this"]))
            line += f" | other {fmt('other')} ms (x{ratio:.2f})"
        log(line + f" | against the twin: {errs}")
    out = dict(this=runs["this"], other=runs["other"],
               split=probe_split(torch, seed),
               launch_floor_ms=launch_floor_ms(torch))
    log(f"[probes] an empty kernel (one 256-thread block): "
        f"{out['launch_floor_ms']:.4f} ms device time")
    if sweep:
        out["sweep"] = probe_sweep(torch, seed)
    return out


# ------------------------------------------------------------------ apps
# the apps and examples of the port, each through its main(argv) on the
# card (superviseddescent_tpu_torch/apps, .../examples)
APP_TRAIN_LEVELS = 4
APP_HELD_OUT_IDENTITY = 4     # .synth120 image i shows identity i % 5
APP_DETECT_PX = 1e-3          # tests/test_torch_rcr.py's exact tolerance
APP_CLIP_FRAMES = 64
APP_CLIP_IMAGE = 3            # the first image of the 728 x 1023 class
APP_CLIP_ORIGIN = (260, 40)   # its row and column offset in frame 0
APP_CLIP_SHAPE = (1024, 768)
APP_LOSS_FRAME = 20
APP_LOSS_SIDE = 520           # the lost frame is its top-left corner
APP_TRACK_DEPTHS = (1, 4)
APP_TRACK_COPIES = 8
SIMPLE_FUNCTION_PIN, SIMPLE_FUNCTION_TOL = 0.026157, 5e-6   # reference pin
POSE_TRUTH, POSE_TOL_DEG = (11.0, -25.0, -10.0), 1.0
LANDMARK_EXAMPLE_IOD = 0.05


def run_app_main(module, argv):
    """(return code, standard output, wall seconds) of an app's or an
    example's ``main(argv)``, run in this process."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


class recorded:
    """Within the block, ``owner.name`` is wrapped so that every call's
    ``pick(args, result)`` is appended to ``store``."""

    def __init__(self, owner, name, store, pick):
        self.owner, self.name, self.store, self.pick = (owner, name, store,
                                                        pick)

    def __enter__(self):
        self.original = original = getattr(self.owner, self.name)

        def wrapper(*args, **kwargs):
            out = original(*args, **kwargs)
            self.store.append(self.pick(args, out))
            return out
        setattr(self.owner, self.name, wrapper)
        return self.store

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.original)


def synchronize(torch, device):
    if device == "cuda":
        torch.cuda.synchronize()


def printed_value(text, label):
    """The number after ``label`` on its line of an app's output."""
    for line in text.splitlines():
        if line.startswith(label):
            return float(line[len(label):].split()[0].rstrip("s"))
    raise SmokeFailure(f"no '{label}' line in:\n{text}")


def app_config_files(root):
    """The training app's inputs, written from the repository's files: the
    68-point mean CSV (pretrained ibug-68's mean), the INFO training config
    with RCR-22's landmark ids and the eye config."""
    import numpy as np
    from superviseddescent_tpu_torch.io.cereal import load_detection_model
    m68 = load_detection_model(os.path.join(REPO, "pretrained",
                                            "rcr68_lfpw5.bin"))
    m22 = load_detection_model(os.path.join(REPO, "pretrained",
                                            "rcr22_lfpw5.bin"))
    mean = os.path.join(root, "mean_68.txt")
    with open(mean, "w") as f:
        f.write(",".join(repr(float(v))
                         for v in np.asarray(m68.mean).ravel()) + "\n")
    config = os.path.join(root, "rcr_training_22.cfg")
    with open(config, "w") as f:
        f.write("modelLandmarks\n{\n    landmarks\n    {\n"
                + "".join(f"        {i}\n" for i in m22.landmark_ids)
                + "    }\n}\n")
    evaluation = os.path.join(root, "rcr_eval.cfg")
    with open(evaluation, "w") as f:
        f.write("interEyeDistance\n{\n"
                f'    rightEye "{" ".join(m22.right_eye_ids)}"\n'
                f'    leftEye "{" ".join(m22.left_eye_ids)}"\n}}\n')
    return mean, config, evaluation


def apps_train(torch, root, device, backend="window", extra=()):
    """rcr_train on the card: the 96 .synth120 pairs of identities 0-3,
    every level's features through K2 + K1 (--roi 512 --patch-backend
    window) or the dense sampler and K1 (``backend="dense"``, with the
    flags ``extra``), faceboxes from the face detector with check_face,
    tested on the 24 pairs of identity 4 (-t)."""
    import shutil
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_train
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    mean, config, evaluation = app_config_files(root)
    dirs = {split: os.path.join(root, split) for split in ("train", "test")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i, png in enumerate(sorted(glob.glob(os.path.join(
            REPO, ".synth120", "*.png")))):
        d = dirs["test" if i % 5 == APP_HELD_OUT_IDENTITY else "train"]
        shutil.copy(png, d)
        shutil.copy(png[:-4] + ".pts", d)
    n_test = len(glob.glob(os.path.join(dirs["test"], "*.png")))
    n_train = len(glob.glob(os.path.join(dirs["train"], "*.png")))
    out = os.path.join(root, f"rcr22_app_{backend}.bin")
    argv = ["-d", dirs["train"], "-t", dirs["test"], "-m", mean, "-c",
            config, "-e", evaluation, "-o", out, "--levels",
            str(APP_TRAIN_LEVELS), "--roi", str(ROI), "--patch-backend",
            backend, "--facebox-source", f"cascade:{STOCK_FRONTAL_ALT2}",
            "--device", device, *extra]
    zero_counts()
    rc, text, wall = run_app_main(rcr_train, argv)
    synchronize(torch, device)
    launches = read_counts()
    check(rc == 0, f"rcr_train exited {rc}:\n{text}")
    # K2 (window) then K1 once per level over all samples; face detection
    # and the test set's detect_batch run plain torch operations
    expect_counts(launches, f"rcr_train --patch-backend {backend}",
                  hog_flat=APP_TRAIN_LEVELS,
                  patches_window=APP_TRAIN_LEVELS * (backend == "window"))
    kept = int(printed_value(text, "Kept "))
    kept_test = [l for l in text.splitlines() if l.endswith("test images.")]
    err0 = printed_value(text, "Normalised LM-error test from mean init: ")
    err = printed_value(text, "Normalised LM-error test: ")
    train_s = printed_value(text, "Training took ")
    train_errs = [float(l.split(":")[1]) for l in text.splitlines()
                  if l.startswith("Normalised LM-error train:")]
    check(len(train_errs) == APP_TRAIN_LEVELS, "rcr_train: one train error "
          f"per level expected, got {train_errs}")
    check(err < err0, f"rcr_train: test IOD error {err} not below the mean "
          f"initialisation's {err0}")
    error_file = os.path.splitext(out)[0] + ".error.txt"
    with open(error_file) as f:
        columns = [float(v) for v in f.read().split(",")]
    check(len(columns) == 22 and all(math.isfinite(v) for v in columns),
          f"rcr_train: bad .error.txt {columns}")
    log(f"[apps] rcr_train --levels {APP_TRAIN_LEVELS} --roi {ROI} "
        f"--patch-backend {' '.join((backend, *extra))} --facebox-source "
        f"cascade: {kept} of "
        f"{n_train} training images kept (check_face), "
        f"{kept_test[0].split()[1]} of {n_test} test images; launches K2 "
        f"{launches['patches_window']}, K1 {launches['hog_flat']} (one each "
        f"per level); train IOD error by level "
        + ", ".join(f"{e:.5f}" for e in train_errs)
        + f"; test (identity {APP_HELD_OUT_IDENTITY}, held out) {err:.5f} "
        f"against {err0:.5f} from the mean; train_rcr {train_s:.1f} s, the "
        f"app {wall:.2f} s wall")
    return dict(kept=kept, train_iod=train_errs, test_iod=err,
                mean_init_iod=err0, train_s=train_s, wall_s=wall,
                launches=launches, error_columns=columns), out


def apps_detect(torch, root, model_path, device):
    """rcr_detect -f -o on the card, on the first image of each size class
    in which the face detector finds a face: the landmarks against the
    port's CPU run within APP_DETECT_PX, the drawn PNG at the image's size,
    ms per call (the second of two)."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.io.png import read_png
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    files = sorted(glob.glob(os.path.join(REPO, ".synth120", "*.png")))
    out = []
    for cls in range(5):
        for png in files[cls::5]:
            argv = ["-m", model_path, "-i", png, "-f", "-o",
                    os.path.join(root, "detect.png")]
            runs = {}
            for dev in (device, device, "cpu"):
                coords = []
                zero_counts()
                with recorded(DetectionModel, "detect", coords,
                              lambda a, lms: np.asarray(lms.coordinates)):
                    rc, text, wall = run_app_main(
                        rcr_detect, argv + ["--device", dev])
                if dev == device:
                    expect_counts(read_counts(), "rcr_detect -f")
                runs[dev] = (rc, coords, wall, text)
            if runs[device][0] == 1 and "No face" in runs[device][3]:
                check(runs["cpu"][0] == 1, f"{png}: a face on the CPU only")
                continue
            (rc, coords, wall, text), cpu = runs[device], runs["cpu"]
            check(rc == 0 and cpu[0] == 0, f"rcr_detect failed:\n{text}")
            delta = float(np.abs(coords[0] - cpu[1][0]).max())
            check(delta <= APP_DETECT_PX, f"rcr_detect {png}: the card's "
                  f"landmarks {delta} px from the CPU's")
            image = read_png(os.path.join(root, "detect.png"))
            h, w = read_png(png).shape[:2]
            check(image.shape == (h, w, 3), f"rcr_detect -o: {image.shape}")
            out.append(dict(image=os.path.basename(png), shape=[h, w],
                            cpu_delta_px=delta, ms=wall * 1e3))
            log(f"[apps] rcr_detect -f -o {os.path.basename(png)} ({w} x "
                f"{h}): {wall * 1e3:.1f} ms a call (model load, PNG "
                f"decode, face detection, fit, PNG encode), landmarks "
                f"{delta:.2e} px from the CPU run")
            break
        else:
            raise SmokeFailure(f"rcr_detect -f: no face in size class {cls}")
    return out


def app_clip(torch, data, seed, root):
    """Two directories of APP_CLIP_FRAMES PNG frames of APP_CLIP_SHAPE: one
    .synth120 face at offsets drifting by up to CLIP_STEP_PX a frame; in
    ``loss/``, frame APP_LOSS_FRAME is cut to its top-left APP_LOSS_SIDE
    corner, which the face lies below. Returns (dirs, offsets, truth row of
    frame 0)."""
    import numpy as np
    from superviseddescent_tpu_torch.io.png import write_png
    i = APP_CLIP_IMAGE
    h, w = data["image_shapes"][i]
    image = data["stack"][i, :h, :w]
    rng = np.random.default_rng(seed)
    steps = rng.integers(-CLIP_STEP_PX, CLIP_STEP_PX + 1,
                         size=(APP_CLIP_FRAMES, 2))
    steps[0] = 0
    offs = np.maximum(np.asarray(APP_CLIP_ORIGIN) + np.cumsum(steps, 0), 0)
    truth = data["image_gt"][i]
    n_lm = truth.shape[0] // 2
    face_top = float(truth[n_lm:].min()) + offs[APP_LOSS_FRAME, 0]
    check(face_top > APP_LOSS_SIDE + 16, "the clip's lost frame would hold "
          "the face")
    dirs = {k: os.path.join(root, k) for k in ("loss", "same")}
    ch, cw = APP_CLIP_SHAPE
    for d in dirs.values():
        os.makedirs(d)
    for k, (oy, ox) in enumerate(offs):
        frame = np.zeros(APP_CLIP_SHAPE, np.uint8)
        src = image[:ch - oy, :cw - ox]
        frame[oy:oy + src.shape[0], ox:ox + src.shape[1]] = src
        name = f"f{k:03d}.png"
        write_png(os.path.join(dirs["same"], name), frame)
        if k == APP_LOSS_FRAME:
            frame = frame[:APP_LOSS_SIDE, :APP_LOSS_SIDE]
        write_png(os.path.join(dirs["loss"], name), frame)
    row0 = truth + np.concatenate([np.full(n_lm, offs[0, 1]),
                                   np.full(n_lm, offs[0, 0])]).astype(
                                       np.float32)
    return dirs, offs, row0


def apps_track(torch, data, seed, root, device):
    """rcr_track --face-detector on the card over a drifting clip with one
    lost frame, at depth 1 and 4 (the same rows; K3 launches = the fused
    fits the app reports, refits of the frames in flight at the loss
    included; the rows before the loss = make_fused_track_stream's), and
    --scan over the clip without the lost frame (= the stream's rows);
    ms per frame, PNG decoding included."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_track
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    dirs, offs, row0 = app_clip(torch, data, seed, root)
    n = APP_CLIP_FRAMES
    same = sorted(glob.glob(os.path.join(dirs["same"], "*.png")))
    frames = [load_gray_image(p).astype(np.uint8) for p in same]
    det = HaarCascadeDetector(STOCK_FRONTAL_ALT2, device=device,
                              **FACE_PARAMS)
    box = det.detect(frames[0])[0]
    # a tracking model: RCR-22 trained on the card on frame 0's face, its
    # own shape in the detector's box as the mean (the pretrained models
    # drift as trackers; phase_tracking)
    pretrained = data["model"]
    n_lm = row0.shape[0] // 2
    mean = np.concatenate([(row0[:n_lm] - box[0]) / box[2] - 0.5,
                           (row0[n_lm:] - box[1]) / box[3] - 0.5]).astype(
                               np.float32)
    model = train_rcr(
        torch.from_numpy(frames[0][None]).to(device),
        np.repeat(row0[None], APP_TRACK_COPIES, 0),
        np.repeat(box[None], APP_TRACK_COPIES, 0), pretrained.landmark_ids,
        pretrained.right_eye_ids, pretrained.left_eye_ids, mean,
        RcrTrainConfig(roi=ROI, patch_backend="fused", seed=seed),
        image_indices=np.zeros(APP_TRACK_COPIES, np.int64),
        device=device)
    model_path = os.path.join(root, "track.bin")
    model.save(model_path)
    ref = np.stack(list(model.make_fused_track_stream(ROI, depth=4)(
        frames, box)))

    def bits(a):
        return np.ascontiguousarray(a, np.float32).view(np.int32)

    def run(directory, *extra):
        rows = []
        zero_counts()
        with recorded(rcr_track, "estimate_ok", rows,
                      lambda a, ok: (np.array(a[0]), ok)):
            rc, text, wall = run_app_main(rcr_track, [
                "-m", model_path, "-f", directory, "--face-detector",
                "--device", device, *extra])
        synchronize(torch, device)
        launches = read_counts()
        check(rc == 0, f"rcr_track {extra} exited {rc}:\n{text}")
        summary = [l for l in text.splitlines() if l.startswith("tracked ")]
        check(len(summary) == 1, f"rcr_track {extra}: no summary:\n{text}")
        words = summary[0].replace("(", " ").split()
        fused, refits, exact = int(words[3]), int(words[6]), int(words[8])
        expect_counts(launches, f"rcr_track {' '.join(extra)}",
                      cascade_fused_frames=fused)
        reported = [int(l.split()[1]) for l in text.splitlines()
                    if l.startswith("frame ") and "bbox" in l]
        lost = [int(l.split()[1].rstrip(":")) for l in text.splitlines()
                if "tracking lost" in l]
        check(reported == list(range(n)), f"rcr_track {extra}: frames "
              f"reported {reported}")
        return dict(rows=np.stack([r for r, _ in rows]), fused=fused,
                    refits=refits, exact=exact, lost=lost,
                    ms_per_frame=wall * 1e3 / n, wall_s=wall)

    out = {}
    for depth in APP_TRACK_DEPTHS:
        r = run(dirs["loss"], "--depth", str(depth))
        in_flight = min(depth, n - 1 - APP_LOSS_FRAME)
        check(r["lost"] == [APP_LOSS_FRAME], f"rcr_track depth {depth}: "
              f"losses at {r['lost']}, expected frame {APP_LOSS_FRAME}")
        check(r["refits"] == in_flight and r["exact"] == 0
              and r["fused"] == n + in_flight, f"rcr_track depth {depth}: "
              f"{r['fused']} fused fits, {r['refits']} refits, {r['exact']} "
              "exact")
        check(np.array_equal(bits(r["rows"][:APP_LOSS_FRAME]),
                             bits(ref[:APP_LOSS_FRAME])),
              f"rcr_track depth {depth}: rows before the loss differ from "
              "make_fused_track_stream's")
        out[f"depth{depth}"] = r
    check(np.array_equal(bits(out["depth1"]["rows"]),
                         bits(out[f"depth{APP_TRACK_DEPTHS[-1]}"]["rows"])),
          "rcr_track: the rows depend on --depth")
    scan = run(dirs["same"], "--scan")
    check(scan["fused"] == n and not scan["lost"], "rcr_track --scan: "
          f"{scan['fused']} fits, losses {scan['lost']}")
    check(np.array_equal(bits(scan["rows"]), bits(ref)),
          "rcr_track --scan: rows differ from make_fused_track_stream's")
    out["scan"] = scan
    # the apps decode every frame with the port's numpy PNG decoder
    # (io/png.py): its time per frame, decoded again after the runs
    t0 = time.perf_counter()
    for p in same:
        load_gray_image(p)
    decode_ms = (time.perf_counter() - t0) * 1e3 / n
    for k, r in out.items():
        log(f"[apps] rcr_track {k} over {n} frames of {APP_CLIP_SHAPE[1]} x "
            f"{APP_CLIP_SHAPE[0]}: {r['ms_per_frame']:.2f} ms a frame "
            f"(the PNG decoder alone {decode_ms:.2f} ms a frame over the "
            f"same files, decoded again afterwards), {r['fused']} K3 "
            f"launches = fused fits ({r['refits']} refits of the frames in "
            f"flight at the loss of frame {APP_LOSS_FRAME}), rows equal "
            "make_fused_track_stream's")
        del r["rows"]
    out["decode_ms_per_frame"] = decode_ms
    return out


def apps_examples(torch, device):
    """The three examples on the card, with the checks of their CPU
    tests."""
    import re
    from superviseddescent_tpu_torch.examples import (
        landmark_detection, pose_estimation, simple_function)
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    out = {}
    zero_counts()
    rc, text, wall = run_app_main(simple_function, ["--device", device])
    residual = printed_value(text, "test residual: ")
    check(rc == 0 and abs(residual - SIMPLE_FUNCTION_PIN)
          <= SIMPLE_FUNCTION_TOL, f"simple_function: residual {residual}")
    out["simple_function"] = dict(test_residual=residual, wall_s=wall)
    rc, text, wall = run_app_main(pose_estimation, ["--device", device])
    line = [l for l in text.splitlines() if l.startswith("Predicted pose")]
    pose = [float(v) for v in re.findall(r"-?\d+\.\d+", line[0])][:3]
    check(rc == 0 and all(abs(a - b) < POSE_TOL_DEG
                          for a, b in zip(pose, POSE_TRUTH)),
          f"pose_estimation: {pose}")
    out["pose_estimation"] = dict(pose=pose, wall_s=wall)
    rc, text, wall = run_app_main(landmark_detection, ["--device", device])
    err = float([l for l in text.splitlines()
                 if "IOD-normalised" in l][0].rsplit(":", 1)[1])
    saved = [l for l in text.splitlines() if l.startswith("Saved ")][0][6:]
    model = DetectionModel.load(saved, device=device)
    os.remove(saved)
    check(rc == 0 and err < LANDMARK_EXAMPLE_IOD
          and model.landmark_ids == landmark_detection.LANDMARKS,
          f"landmark_detection: IOD error {err}")
    out["landmark_detection"] = dict(iod=err, wall_s=wall)
    expect_counts(read_counts(), "the examples")
    log(f"[apps] examples: simple_function test residual {residual:.6f} "
        f"(pin {SIMPLE_FUNCTION_PIN}), pose_estimation "
        + " / ".join(f"{v:.1f}" for v in pose)
        + f" (truth 11 / -25 / -10), landmark_detection IOD error {err:.4f};"
        " " + ", ".join(f"{k} {v['wall_s']:.2f} s" for k, v in out.items()))
    return out


def phase_apps(torch, data, seed, name, smi):
    """The port's three apps and three examples through their ``main`` on
    the card, with their inputs written to a temporary directory: rcr_train
    (K2 + K1), rcr_detect -f -o, rcr_track (K3) at two depths and --scan,
    and the examples."""
    import shutil
    import tempfile
    device = "cuda"
    root = tempfile.mkdtemp(prefix="chip_smoke_apps_")
    t0 = time.perf_counter()
    try:
        train, model_path = apps_train(torch, root, device)
        detect = apps_detect(torch, root, model_path, device)
        track = apps_track(torch, data, seed, root, device)
        examples = apps_examples(torch, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[apps] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, train=train, detect=detect,
                track=track, examples=examples, seconds=seconds)


# ---------------------------------------------------------------- #
# The io slice: baseline JPEG, the host entropy decoder and J1
# ---------------------------------------------------------------- #
JPEG_DIR = os.path.join(REPO, "tests", "torch_jpeg")
# rcr_detect -f -o on a baseline (728 x 1023), a progressive (412 x 600),
# an Adobe CMYK (300 x 450) and an arithmetic-coded progressive (SOF10,
# 412 x 600) still
JPEG_DETECT_STILLS = ("s04_420_q95_restart.jpg", "p02_422_q50_prog.jpg",
                      "c00_cmyk_q75.jpg", "a17_420_q75_prog_still.jpg")
JPEG_CLIPS = ("clip", "clip_progressive")
JPEG_TRACK_DEPTHS = (1, 4)
JPEG_TRACK_COPIES = 8
# J1's integer operations: per 8x8 block 16 one-dimensional islow
# transforms of ~44 operations, 64 dequantising products and 64 range
# limits of ~4; per output pixel ~40 (upsampling, conversion, grey)
JPEG_OPS_PER_BLOCK = 16 * 44 + 64 + 64 * 4
JPEG_OPS_PER_PIXEL = 40
OPS_PER_S = 67e12          # the card's float32 rate, the operations' yardstick


def jpeg_bound(f, channels):
    """J1's least time: the int16 coefficients read once and the output
    written once at the memory rate, or its integer operations at 67
    TOP/s, whichever is longer."""
    in_bytes = f.blocks * 64 * 2
    out_bytes = f.width * f.height * channels
    ops = (f.blocks * JPEG_OPS_PER_BLOCK
           + f.width * f.height * JPEG_OPS_PER_PIXEL)
    return dict(bytes_ms=(in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3,
                ops_ms=ops / OPS_PER_S * 1e3, in_bytes=in_bytes,
                out_bytes=out_bytes)


def sha256_of(t):
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def inside_blocks(coef, f):
    """Each component's coefficients of the blocks inside the image (the
    MCU grid's padding blocks are coded by interleaved scans only)."""
    out = []
    for c in f.components:
        grid = coef[c.offset:c.offset + c.nbx * c.nby].reshape(
            c.nby, c.nbx, 64)
        out.append(grid[:c.bh, :c.bw])
    return out


def same_inside(a, b, f):
    return all(bool((x == y).all()) for x, y in zip(inside_blocks(a, f),
                                                    inside_blocks(b, f)))


def jpeg_stills(torch, manifest):
    """Every committed still (baseline, progressive, multi-scan, CMYK /
    YCCK, 4:1:1 / 4:4:0, other sampling factors) through the host decoder
    and J1: PIL's grey and RGB digests, J1 bit-equal to its twin on the
    same coefficients, ``read_jpeg`` equal to both, the host coefficients
    equal to the Python twin's, and a progressive still's equal to those
    of the baseline still of the same pixels."""
    import numpy as np
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels, read_jpeg)
    worst, out, host_coef = 0, {}, {}
    for name, want in sorted(manifest["stills"].items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            data = fh.read()
        f = jpeg.parse_jpeg(data)
        host = entropy_decode_native(f)
        check(np.array_equal(host.numpy(), jpeg.entropy_decode(f)),
              f"{name}: the host decoder's coefficients differ from the "
              "Python twin's")
        host_coef[name] = (host.numpy(), f)
        coef = host.cuda()
        for channels, key in ((1, "grey_sha256"), (3, "rgb_sha256")):
            got = jpeg_pixels(coef, f, channels)
            twin = jpeg.pixels_reference(coef, f, channels)
            torch.cuda.synchronize()
            err = int((got.int() - twin.int()).abs().max())
            worst = max(worst, err)
            check(err == 0, f"{name}: J1 differs from its twin by {err}")
            check(sha256_of(got) == want[key], f"{name}: J1's "
                  f"{'grey' if channels == 1 else 'RGB'} digest differs "
                  "from PIL's")
            check(torch.equal(read_jpeg(data, channels), got),
                  f"{name}: read_jpeg differs from J1 on the same stream")
        out[name] = dict(kind=want["kind"], quality=want["quality"],
                         shape=want["shape"], scans=len(f.scans),
                         progressive=f.progressive)
    pairs = [(n, w["same_pixels_as"]) for n, w in manifest["stills"].items()
             if "same_pixels_as" in w]
    for prog, base in pairs:
        check(same_inside(host_coef[prog][0], host_coef[base][0],
                          host_coef[base][1]), f"{prog}: the host "
              f"coefficients differ from those of {base}, the baseline "
              "still of the same pixels")
    log(f"[jpeg] {len(out)} stills (baseline grey, 4:4:4, 4:2:2, 4:2:0 at q "
        "50 / 75 / 95, restart markers, optimised tables, 301 x 451; "
        "progressive; multi-scan sequential; Adobe CMYK and YCCK; 4:1:1, "
        "4:4:0, 2x2/1x2/2x1 and 3x2 sampling; arithmetic SOF9 / SOF10; "
        "block-smoothed SOF2 / SOF10; lossless SOF3 through J1's samples "
        "source): J1's grey and RGB equal PIL's digests and the twin bit "
        "for bit, the host coefficients (samples) the Python twin's; "
        f"{len(pairs)} progressive stills' coefficients equal their "
        "baseline stills'")
    return out, worst


def jpeg_clip_times(torch, manifest, png_dir):
    """Per 1024 x 768 frame of the baseline and the progressive clip: the
    host entropy decoder (host clock, the clips in turns), J1 and its twin
    (device time, torch.profiler, the clips in turns), J1's bound,
    ``load_gray_image`` of each clip's JPEG (the card) against the PNG of
    the same pixels (the host's numpy decoder), in turns; each frame's
    grey against PIL's digest, J1 against its twin, and each progressive
    frame's host coefficients against the baseline frame's. Writes the
    PNG frames to ``png_dir``. Returns the times and the largest J1 - twin
    difference."""
    import numpy as np
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    clips = {key: manifest[key]["frames"] for key in JPEG_CLIPS}
    n = len(clips["clip"])
    check(len(clips["clip_progressive"]) == n, "the clips' lengths differ")
    worst, parsed, entropy = 0, {}, {key: [] for key in JPEG_CLIPS}
    for key, frames in clips.items():
        parsed[key] = []
        for fr in frames:
            with open(os.path.join(JPEG_DIR, fr["name"]), "rb") as fh:
                parsed[key].append(jpeg.parse_jpeg(fh.read()))
    for key in JPEG_CLIPS + JPEG_CLIPS[::-1]:
        t0 = time.perf_counter()
        for f in parsed[key]:
            entropy_decode_native(f)
        entropy[key].append((time.perf_counter() - t0) * 1e3 / n)
    first = {}
    for k in range(n):
        base = entropy_decode_native(parsed["clip"][k])
        prog = entropy_decode_native(parsed["clip_progressive"][k])
        check(torch.equal(base, prog), f"{clips['clip_progressive'][k]['name']}"
              ": the host coefficients differ from the baseline frame's")
        for key, host in (("clip", base), ("clip_progressive", prog)):
            fr, f = clips[key][k], parsed[key][k]
            coef = host.cuda()
            grey = jpeg_pixels(coef, f, 1)
            check(sha256_of(grey) == fr["grey_sha256"],
                  f"{fr['name']}: J1's grey digest differs from PIL's")
            worst = max(worst, int((grey.int() - jpeg.pixels_reference(
                coef, f, 1).int()).abs().max()))
            if key == "clip":
                write_png(os.path.join(png_dir, os.path.basename(
                    fr["name"])[:-4] + ".png"), grey.cpu().numpy())
            first.setdefault(key, (f, coef))
    check(worst == 0, f"the clips: J1 differs from its twin by {worst}")
    j1_ms = {key: [] for key in JPEG_CLIPS}
    for key in JPEG_CLIPS + JPEG_CLIPS[::-1]:
        f, coef = first[key]
        j1_ms[key].append(device_ms(torch, lambda: jpeg_pixels(coef, f, 1),
                                    match="jpeg", one_kernel=False))
    f, coef = first["clip"]
    twin_ms = device_ms(torch, lambda: jpeg.pixels_reference(coef, f, 1),
                        one_kernel=False)
    bound = jpeg_bound(f, 1)
    paths = {key: [os.path.join(JPEG_DIR, fr["name"]) for fr in frames]
             for key, frames in clips.items()}
    paths["png"] = sorted(glob.glob(os.path.join(png_dir, "*.png")))
    loads = {}
    for label in ("clip", "clip_progressive", "png") * 2:
        t0 = time.perf_counter()
        for p in paths[label]:
            load_gray_image(p)
        loads.setdefault(label, []).append(
            (time.perf_counter() - t0) * 1e3 / len(paths[label]))
    out = dict(frames=n, entropy_ms=entropy["clip"],
               entropy_progressive_ms=entropy["clip_progressive"],
               j1_device_ms=j1_ms["clip"],
               j1_progressive_device_ms=j1_ms["clip_progressive"],
               twin_device_ms=twin_ms,
               bound_ms=max(bound["bytes_ms"], bound["ops_ms"]),
               bound_by=("bytes" if bound["bytes_ms"] >= bound["ops_ms"]
                         else "operations"), bound=bound,
               load_gray_jpeg_ms=loads["clip"],
               load_gray_progressive_ms=loads["clip_progressive"],
               load_gray_png_ms=loads["png"])

    def ms(values, digits=3):
        return " / ".join(f"{v:.{digits}f}" for v in values)
    log(f"[jpeg] per {f.width} x {f.height} 4:2:0 frame ({n} frames a "
        f"clip, the clips in turns): host entropy {ms(entropy['clip'])} ms "
        f"baseline, {ms(entropy['clip_progressive'])} ms progressive; J1 "
        f"{ms(j1_ms['clip'], 4)} ms baseline, "
        f"{ms(j1_ms['clip_progressive'], 4)} ms progressive (device, "
        f"torch.profiler, both launches), bound {out['bound_ms']:.5f} ms "
        f"({out['bound_by']}: {bound['in_bytes'] / 1e6:.2f} MB in, "
        f"{bound['out_bytes'] / 1e6:.2f} MB out; operations "
        f"{bound['ops_ms']:.5f} ms), twin {twin_ms:.4f} ms device; "
        f"load_gray_image {ms(loads['clip'], 2)} ms (baseline JPEG), "
        f"{ms(loads['clip_progressive'], 2)} ms (progressive JPEG), "
        f"{ms(loads['png'], 2)} ms (PNG of the same pixels, io/png.py); "
        "every progressive frame's host coefficients equal the baseline "
        "frame's")
    return out, worst


# the coded kinds' frames: frame 0 of the clip as arithmetic SOF9 and SOF10
# and as a grey lossless SOF3 (tests/torch_jpeg/timing), beside the
# Huffman clips' frame 0
JPEG_CODED_FRAMES = {"sof9": "timing/t00_clip_f000_sof9.jpg",
                     "sof10": "timing/t01_clip_f000_sof10.jpg",
                     "sof3": "timing/t02_clip_f000_sof3_grey.jpg",
                     "huffman": "clip/f000.jpg",
                     "huffman_progressive": "clip_progressive/f000.jpg"}
JPEG_CODED_REPS = 10
# load_gray_image calls on the SOF3 frame in the samples source's counted
# run (the entry point a user calls)
JPEG_SAMPLES_LOADS = 4


def jpeg_samples_bound(f, channels):
    """J1's samples source's least time: the uint8 samples read once and
    the output written once at the memory rate, or its ~40 integer
    operations per output pixel at 67 TOP/s, whichever is longer."""
    in_bytes = f.blocks * 64
    out_bytes = f.width * f.height * channels
    ops = f.width * f.height * JPEG_OPS_PER_PIXEL
    return dict(bytes_ms=(in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3,
                ops_ms=ops / OPS_PER_S * 1e3, in_bytes=in_bytes,
                out_bytes=out_bytes)


def jpeg_coded_kinds(torch, manifest):
    """The arithmetic and lossless kinds beyond the stills: each 768 x 1024
    frame of ``tests/torch_jpeg/timing`` through the host decoder and J1
    (both sources) against PIL's digests and the twins; the files PIL
    refuses refused by name; the host stage's ms on each frame beside the
    Huffman clips' frame 0 (the frames in turns); J1 on each (device,
    torch.profiler), the samples source beside its twin and its byte
    bound; ``load_gray_image`` of each; and the samples source's counted
    run: ``load_gray_image`` on the SOF3 frame with every count at 0 just
    before."""
    import numpy as np
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    worst, frames = 0, {}
    for key, name in JPEG_CODED_FRAMES.items():
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            data = fh.read()
        f = jpeg.parse_jpeg(data)
        host = entropy_decode_native(f)
        values = host.cuda()
        frames[key] = (f, values, os.path.join(JPEG_DIR, name))
        want = manifest["timing"].get(name)
        if want is None:
            continue
        check(np.array_equal(host.numpy(), jpeg.entropy_decode(f)),
              f"{name}: the host decoder differs from the Python twin")
        for channels, digest_key in ((1, "grey_sha256"), (3, "rgb_sha256")):
            got = jpeg_pixels(values, f, channels)
            err = int((got.int() - jpeg.pixels_reference(
                values, f, channels).int()).abs().max())
            worst = max(worst, err)
            check(err == 0, f"{name}: J1 differs from its twin by {err}")
            check(sha256_of(got) == want[digest_key], f"{name}: J1's "
                  f"{'grey' if channels == 1 else 'RGB'} digest differs "
                  "from PIL's")
    refused = {}
    for name, info in sorted(manifest["refused"].items()):
        with open(os.path.join(JPEG_DIR, name), "rb") as fh:
            data = fh.read()
        try:
            jpeg.parse_jpeg(data)
            message = None
        except ValueError as e:
            message = str(e)
        check(message is not None, f"{name}: read, though PIL refuses it "
              f"({info['libjpeg_turbo_message']})")
        refused[name] = message
    host_ms = {key: [] for key in JPEG_CODED_FRAMES}
    for key in list(JPEG_CODED_FRAMES) * 2:
        f = frames[key][0]
        t0 = time.perf_counter()
        for _ in range(JPEG_CODED_REPS):
            entropy_decode_native(f)
        host_ms[key].append((time.perf_counter() - t0) * 1e3
                            / JPEG_CODED_REPS)
    j1_ms = {}
    for key in ("sof9", "sof10", "sof3"):
        f, values, _ = frames[key]
        j1_ms[key] = device_ms(torch, lambda: jpeg_pixels(values, f, 1),
                               match="jpeg")
    f3, samples, path3 = frames["sof3"]
    twin_ms = device_ms(torch, lambda: jpeg.pixels_reference(samples, f3, 1),
                        one_kernel=False, reps=2)
    bound = jpeg_samples_bound(f3, 1)
    loads = {key: [] for key in ("sof9", "sof10", "sof3")}
    for key in list(loads) * 2:
        t0 = time.perf_counter()
        for _ in range(JPEG_CODED_REPS):
            load_gray_image(frames[key][2])
        loads[key].append((time.perf_counter() - t0) * 1e3 / JPEG_CODED_REPS)
    torch.cuda.synchronize()
    zero_counts()
    for _ in range(JPEG_SAMPLES_LOADS):
        load_gray_image(path3)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(launches, f"load_gray_image on {JPEG_CODED_FRAMES['sof3']}"
                  f" x {JPEG_SAMPLES_LOADS}", jpeg_samples=JPEG_SAMPLES_LOADS)
    out = dict(host_ms=host_ms, j1_device_ms=j1_ms,
               samples_device_ms=j1_ms["sof3"], samples_twin_device_ms=twin_ms,
               samples_bound_ms=max(bound["bytes_ms"], bound["ops_ms"]),
               samples_bound_by=("bytes" if bound["bytes_ms"] >= bound[
                   "ops_ms"] else "operations"), samples_bound=bound,
               load_gray_ms=loads, samples_launches=launches["jpeg_samples"],
               refused=refused, max_abs_err=worst)

    def ms(values, digits=3):
        return " / ".join(f"{v:.{digits}f}" for v in values)
    log("[jpeg] frame 0 of the clip (768 x 1024), host entropy stage ms "
        "(the frames in turns): " + ", ".join(
            f"{key} {ms(v)}" for key, v in host_ms.items()))
    log("[jpeg] J1 device ms (torch.profiler, grey): " + ", ".join(
        f"{key} {v:.4f}" for key, v in j1_ms.items()) + "; the samples "
        f"source on the SOF3 frame {j1_ms['sof3']:.4f} ms, bound "
        f"{out['samples_bound_ms']:.5f} ms ({out['samples_bound_by']}: "
        f"{bound['in_bytes'] / 1e6:.2f} MB in, {bound['out_bytes'] / 1e6:.2f}"
        f" MB out), twin {twin_ms:.4f} ms device; load_gray_image "
        + ", ".join(f"{key} {ms(v, 2)} ms" for key, v in loads.items())
        + f"; {len(refused)} files PIL refuses refused by name; "
        f"load_gray_image x {JPEG_SAMPLES_LOADS} on the SOF3 frame: "
        f"{launches['jpeg_samples']} launches of the samples source")
    return out


def clip_track_model(torch, manifest, root):
    """A tracking model trained on the card on frame 0 of the committed
    clip (the face at its first offset, the box from the face detector),
    saved under ``root``: (model path, the box as rcr_track's --facebox)."""
    import numpy as np
    from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    from superviseddescent_tpu_torch.models.facedetect import (
        HaarCascadeDetector)
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    from superviseddescent_tpu_torch.utils.landmarks import to_row
    clip = manifest["clip"]
    prog_dir = os.path.join(JPEG_DIR, "clip_progressive")
    frame0 = load_gray_image(os.path.join(prog_dir, "f000.jpg"))
    det = HaarCascadeDetector(STOCK_FRONTAL_ALT2, device="cuda",
                              **FACE_PARAMS)
    box = det.detect(frame0)[0]
    pretrained = DetectionModel.load(os.path.join(
        REPO, "pretrained", "rcr22_lfpw5.bin"))
    truth = to_row(read_pts_landmarks(os.path.join(
        REPO, ".synth120", clip["source"] + ".pts")).filter(
            pretrained.landmark_ids))
    n_lm = truth.shape[0] // 2
    oy, ox = clip["offsets"][0]
    row0 = (truth + np.float32([ox] * n_lm + [oy] * n_lm)).astype(
        np.float32)
    mean = np.concatenate([(row0[:n_lm] - box[0]) / box[2] - 0.5,
                           (row0[n_lm:] - box[1]) / box[3] - 0.5]).astype(
                               np.float32)
    model = train_rcr(
        torch.from_numpy(frame0.astype(np.uint8)[None]).cuda(),
        np.repeat(row0[None], JPEG_TRACK_COPIES, 0),
        np.repeat(box[None], JPEG_TRACK_COPIES, 0), pretrained.landmark_ids,
        pretrained.right_eye_ids, pretrained.left_eye_ids, mean,
        RcrTrainConfig(roi=ROI, patch_backend="fused"),
        image_indices=np.zeros(JPEG_TRACK_COPIES, np.int64), device="cuda")
    model_path = os.path.join(root, "track.bin")
    model.save(model_path)
    return model_path, ",".join(repr(float(v)) for v in box)


def jpeg_track(torch, manifest, png_dir, root):
    """rcr_track on the progressive clip, the baseline clip and PNG frames
    of the same pixels, at JPEG_TRACK_DEPTHS and --scan, with a tracking
    model trained on the card on frame 0: the rows equal in every run, K3
    launches = fused fits, J1 launches = the JPEG frames (0 on PNG)."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_track
    n = len(manifest["clip"]["frames"])
    jpg_dir = os.path.join(JPEG_DIR, "clip")
    prog_dir = os.path.join(JPEG_DIR, "clip_progressive")
    model_path, box_arg = clip_track_model(torch, manifest, root)

    def run(directory, jpeg, *extra):
        rows = []
        zero_counts()
        with recorded(rcr_track, "estimate_ok", rows,
                      lambda a, ok: np.array(a[0])):
            rc, text, wall = run_app_main(rcr_track, [
                "-m", model_path, "-f", directory, "--facebox", box_arg,
                "--device", "cuda", *extra])
        torch.cuda.synchronize()
        launches = read_counts()
        check(rc == 0, f"rcr_track {extra} exited {rc}:\n{text}")
        summary = [l for l in text.splitlines() if l.startswith("tracked ")]
        check(summary == [f"tracked {n} frames: {n} fused fits (0 refits), "
                          "0 exact fits"], f"rcr_track {extra} on "
              f"{'JPEG' if jpeg else 'PNG'}: {summary}")
        expect_counts(launches, f"rcr_track {' '.join(extra)} on "
                      f"{'JPEG' if jpeg else 'PNG'} frames",
                      cascade_fused_frames=n, jpeg_decode=n * jpeg)
        check(len(rows) == n, f"rcr_track {extra}: {len(rows)} rows")
        return np.stack(rows).astype(np.float32), wall * 1e3 / n, launches

    def bits(a):
        return a.view(np.int32)

    modes = [("--depth", str(d)) for d in JPEG_TRACK_DEPTHS] + [("--scan",)]
    out, ref = {}, None
    for mode in modes:
        key = " ".join(mode)
        grows, gms, gl = run(prog_dir, True, *mode)
        jrows, jms, jl = run(jpg_dir, True, *mode)
        prows, pms, _ = run(png_dir, False, *mode)
        ref = jrows if ref is None else ref
        check(np.array_equal(bits(grows), bits(jrows)), f"rcr_track {key}: "
              "rows on the progressive clip differ from those on the "
              "baseline clip")
        check(np.array_equal(bits(jrows), bits(prows)), f"rcr_track {key}: "
              "rows on JPEG frames differ from those on PNG frames of the "
              "same pixels")
        check(np.array_equal(bits(jrows), bits(ref)), f"rcr_track {key}: "
              "the rows depend on the mode")
        out[key] = dict(progressive_ms_per_frame=gms, jpeg_ms_per_frame=jms,
                        png_ms_per_frame=pms,
                        k3_launches=gl["cascade_fused_frames"],
                        j1_launches=gl["jpeg_decode"],
                        j1_launches_baseline=jl["jpeg_decode"])
        log(f"[jpeg] rcr_track {key} over {n} frames of 768 x 1024: "
            f"{gms:.2f} ms a frame on the progressive clip (J1 "
            f"{gl['jpeg_decode']} launches, K3 {gl['cascade_fused_frames']}"
            f" = fused fits), {jms:.2f} ms on the baseline clip, {pms:.2f} "
            "ms on PNG of the same pixels; rows equal")
    return out


def drawn(image, coords, box=None):
    """``image`` read on the CPU with ``coords`` (and ``box``) drawn."""
    from superviseddescent_tpu_torch.apps import _draw
    from superviseddescent_tpu_torch.io.image import read_rgb
    rgb = read_rgb(image, device="cpu").copy()
    _draw.draw_landmarks(rgb, coords)
    if box is not None:
        _draw.draw_box(rgb, box)
    return rgb


def drawn_jpeg(image, coords, box=None) -> bytes:
    """The JPEG file the CPU twins write of ``drawn``."""
    from superviseddescent_tpu_torch.io.jpeg_write import encode_jpeg
    return encode_jpeg(drawn(image, coords, box), device="cpu")


def jpeg_detect(torch, root):
    """rcr_detect -i <still>.jpg -f -o out.jpg on the card for each of
    JPEG_DETECT_STILLS: J1 twice (grey for the fit, RGB for the drawing)
    and J2 once, the file the CPU twins' encoding of the still drawn with
    the run's landmarks and box, the landmarks within APP_DETECT_PX of the
    CPU run's."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    out = {}
    for still in JPEG_DETECT_STILLS:
        stem = os.path.join(root, "detect_" + still[:3])
        image = os.path.join(JPEG_DIR, still)
        argv = ["-m", os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"),
                "-i", image, "-f", "-o", stem + ".jpg"]
        runs = {}
        for dev in ("cuda", "cpu"):
            fits = []
            zero_counts()
            with recorded(DetectionModel, "detect", fits,
                          lambda a, lms: (np.asarray(lms.coordinates),
                                          a[2])):
                rc, text, wall = run_app_main(rcr_detect,
                                              argv + ["--device", dev])
            if dev == "cuda":
                torch.cuda.synchronize()
                expect_counts(read_counts(), f"rcr_detect -i {still} -f -o",
                              jpeg_decode=2, jpeg_encode=1)
                with open(stem + ".jpg", "rb") as fh:
                    written = fh.read()
            check(rc == 0 and len(fits) == 1,
                  f"rcr_detect {still} {dev}:\n{text}")
            runs[dev] = (fits[0], wall, text)
        (coords, box), _, text = runs["cuda"]
        delta = float(np.abs(coords - runs["cpu"][0][0]).max())
        check(delta <= APP_DETECT_PX, f"rcr_detect on {still}: the card's "
              f"landmarks {delta} px from the CPU's")
        check(f"Wrote {stem}.jpg" in text, f"rcr_detect -o {stem}.jpg: "
              f"{text[-300:]}")
        check(written == drawn_jpeg(image, coords, box),
              f"rcr_detect -o on {still}: the card's JPEG differs from the "
              "CPU twins' encoding of the same drawing")
        log(f"[jpeg] rcr_detect -i {still} -f -o: "
            f"{runs['cuda'][1] * 1e3:.1f} ms (J1 2 launches, J2 1; the "
            f"file the twins' bytes), landmarks {delta:.2e} px from the CPU "
            "run")
        out[still] = dict(ms=runs["cuda"][1] * 1e3, cpu_delta_px=delta)
    return out


def phase_jpeg(torch, name, smi):
    """The io slices on the card: the committed JPEG fixtures
    (``tests/torch_jpeg``, PIL's digests in its manifest) through the host
    entropy decoder and J1, the arithmetic and lossless frames' times
    (``jpeg_coded_kinds``), rcr_track over the progressive and the baseline
    clip against PNG frames of the same pixels, rcr_detect on a baseline,
    a progressive, a CMYK and an arithmetic progressive still."""
    import shutil
    import tempfile
    with open(os.path.join(JPEG_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_jpeg_")
    try:
        png_dir = os.path.join(root, "png")
        os.makedirs(png_dir)
        stills, err_stills = jpeg_stills(torch, manifest)
        times, err_clip = jpeg_clip_times(torch, manifest, png_dir)
        coded = jpeg_coded_kinds(torch, manifest)
        track = jpeg_track(torch, manifest, png_dir, root)
        detect = jpeg_detect(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[jpeg] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, stills=stills, times=times,
                coded=coded, track=track, detect=detect, seconds=seconds,
                max_abs_err=max(err_stills, err_clip, coded["max_abs_err"]))


# J1's and J2's measurement builds: -DJPEG_*_LAUNCH_ONLY returns at once
# (the launch's own time), -DJPEG_*_STAGE_ONLY stops after the staging
# (J2: and the colour conversion), -DJPEG_*_SKIP_STORE leaves out the
# global stores; the last two keep the work they do. -DJPEG_*_TIMELINE
# has thread 0 of each CTA write the global timer at its start and after
# each phase (``jpeg_timeline``)
JPEG_BUILDS = tuple((name, (f"{macro}_{part}",))
                    for name, macro in (("jpeg_decode", "JPEG_DECODE"),
                                        ("jpeg_encode", "JPEG_ENCODE"))
                    for part in ("LAUNCH_ONLY", "STAGE_ONLY", "SKIP_STORE",
                                 "TIMELINE"))
# other launch plans for --sweep: J1's tile (MCU rows, MCU columns,
# threads), J2's strip (MCUs a CTA takes)
J1_SWEEP = ((1, 4, 128), (1, 8, 128), (1, 8, 256), (2, 2, 128),
            (2, 3, 192), (2, 4, 128), (2, 4, 256), (2, 4, 384),
            (2, 6, 256), (2, 8, 256), (3, 4, 256), (4, 2, 256),
            (4, 4, 256), (4, 4, 512))
J2_SWEEP = (1, 2, 3, 4, 6, 8, 12, 16)
# the frame of --j1 / --j2: the baseline clip's first 768 x 1024 4:2:0
# frame, J1 to grey and RGB, J2 of its RGB at 4:2:0 quality 75
JPEG_TIME_FRAME = "clip/f000.jpg"
JPEG_TIME_REPS = 100


def kernel_name(key):
    """A profiler record's kernel name without its namespace and
    arguments."""
    import re
    m = re.search(r"(jpeg_\w+)", key)
    return m.group(1) if m else key[:40]


def jpeg_time_inputs(torch):
    """JPEG_TIME_FRAME's parsed frame, its coefficients on the card, its
    RGB (J1) and the 4:2:0 q75 layout of that RGB."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.jpeg_write import layout
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels)
    with open(os.path.join(JPEG_DIR, JPEG_TIME_FRAME), "rb") as fh:
        f = jpeg.parse_jpeg(fh.read())
    coef = entropy_decode_native(f).cuda()
    px = jpeg_pixels(coef, f, 3)
    return f, coef, px, layout(px.shape[0], px.shape[1], 3)


def jpeg_times(torch):
    """Device ms (torch.profiler) of J1 on JPEG_TIME_FRAME to grey and to
    RGB, and of J2 on its RGB, through the package on ``sys.path``: per
    kernel name (one fused J1 kernel in this tree; the IDCT and the colour
    kernel in older ones)."""
    from superviseddescent_tpu_torch.ops.jpeg import (
        jpeg_coefficients, jpeg_pixels)
    f, coef, px, lay = jpeg_time_inputs(torch)
    calls = {"j1_grey": lambda: jpeg_pixels(coef, f, 1),
             "j1_rgb": lambda: jpeg_pixels(coef, f, 3),
             "j2": lambda: jpeg_coefficients(px, lay)}
    out = {}
    for key, call in calls.items():
        found = device_kernels(torch, call, reps=JPEG_TIME_REPS,
                               match="jpeg")
        out[key] = {kernel_name(k): n * us / 1e3 for k, n, us in found}
    return out


def jpeg_split(torch):
    """This tree's J1 (grey and RGB) and J2 beside their measurement builds
    (JPEG_BUILDS) on JPEG_TIME_FRAME: the launch alone, staging (the
    stage-only build), transform (the build without stores less staging)
    and stores (the kernel less the build without stores), device ms."""
    import ctypes
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.jpeg import (
        coefficient_params, pixel_params, quant_on_card)
    f, coef, px, lay = jpeg_time_inputs(torch)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def j1(defines, channels):
        lib = load_library("jpeg_decode", defines)
        geom, quant = pixel_params(f, channels)
        tables = quant_on_card(quant, "cuda")
        out = torch.empty((f.height, f.width, channels)[:2 + (channels > 1)],
                          dtype=torch.uint8, device="cuda")
        return lambda: lib.jpeg_pixels_launch(
            ctypes.c_void_p(coef.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(geom.ctypes.data),
            ctypes.c_void_p(tables.data_ptr()), stream)

    def j2(defines, _):
        lib = load_library("jpeg_encode", defines)
        geom, quant = coefficient_params(lay)
        tables = quant_on_card(quant, "cuda")
        out = torch.empty((lay.blocks, 64), dtype=torch.int16, device="cuda")
        return lambda: lib.jpeg_coefficients_launch(
            ctypes.c_void_p(px.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(geom.ctypes.data),
            ctypes.c_void_p(tables.data_ptr()), stream)
    out = {}
    for key, make, macro, channels in (("j1_grey", j1, "JPEG_DECODE", 1),
                                       ("j1_rgb", j1, "JPEG_DECODE", 3),
                                       ("j2", j2, "JPEG_ENCODE", 3)):
        ms = {build: device_ms(torch, make(defines, channels),
                               reps=JPEG_TIME_REPS, match="jpeg")
              for build, defines in (
                  ("whole", ()), ("launch_only", (f"{macro}_LAUNCH_ONLY",)),
                  ("stage_only", (f"{macro}_STAGE_ONLY",)),
                  ("skip_store", (f"{macro}_SKIP_STORE",)))}
        out[key] = dict(ms, staging=ms["stage_only"],
                        transform=ms["skip_store"] - ms["stage_only"],
                        stores=ms["whole"] - ms["skip_store"])
        log(f"[{key[:2]}] split of {key} on {JPEG_TIME_FRAME}: whole "
            f"{ms['whole']:.5f} ms, the launch alone "
            f"{ms['launch_only']:.5f}, staging {ms['stage_only']:.5f}, "
            f"transform {out[key]['transform']:.5f}, stores "
            f"{out[key]['stores']:.5f} (device, measurement builds)")
    return out


def jpeg_timeline(torch):
    """This tree's J1 (grey, RGB) and J2 on JPEG_TIME_FRAME through their
    -DJPEG_*_TIMELINE builds: when the CTAs start after the first one
    (spread), how long each phase takes in a CTA (mean and largest), and
    the last CTA's end; ns of the global timer, one warm launch."""
    import ctypes
    import numpy as np
    from superviseddescent_tpu_torch.ops._build import load_library
    from superviseddescent_tpu_torch.ops.jpeg import (
        coefficient_params, pixel_params, quant_on_card)
    f, coef, px, lay = jpeg_time_inputs(torch)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for key, channels in (("j1_grey", 1), ("j1_rgb", 3), ("j2", 3)):
        if key == "j2":
            lib = load_library("jpeg_encode", ("JPEG_ENCODE_TIMELINE",))
            geom, quant = coefficient_params(lay)
            dst = torch.empty((lay.blocks, 64), dtype=torch.int16,
                              device="cuda")
            args = (px, dst)
            launch = lib.jpeg_coefficients_launch
            ctas = lay.mcuy * -(-lay.mcux // int(geom[35]))
            phases = ("staging", "colour", "transform")
        else:
            lib = load_library("jpeg_decode", ("JPEG_DECODE_TIMELINE",))
            geom, quant = pixel_params(f, channels)
            dst = torch.empty((f.height, f.width, channels)[
                :2 + (channels > 1)], dtype=torch.uint8, device="cuda")
            args = (coef, dst)
            launch = lib.jpeg_pixels_launch
            ctas = -(-int(geom[7]) // int(geom[10])) * -(
                -int(geom[6]) // int(geom[11]))
            phases = ("quantisers", "transform", "colour")
        tables = quant_on_card(quant, "cuda")
        for _ in range(5):
            launch(ctypes.c_void_p(args[0].data_ptr()),
                   ctypes.c_void_p(args[1].data_ptr()),
                   ctypes.c_void_p(geom.ctypes.data),
                   ctypes.c_void_p(tables.data_ptr()), stream)
        torch.cuda.synchronize()
        t = dst.view(-1).view(torch.int64)[:4 * ctas].cpu().numpy().reshape(
            ctas, 4)
        t = t - t[:, 0].min()
        d = np.diff(t, axis=1)
        out[key] = dict(ctas=ctas, start_spread_ns=int(t[:, 0].max()),
                        end_ns=int(t[:, 3].max()),
                        **{f"{p}_mean_ns": float(d[:, k].mean())
                           for k, p in enumerate(phases)},
                        **{f"{p}_max_ns": int(d[:, k].max())
                           for k, p in enumerate(phases)})
        log(f"[{key[:2]}] timeline of {key} ({ctas} CTAs, global timer): "
            f"CTAs start within {out[key]['start_spread_ns']} ns, the last "
            f"ends at {out[key]['end_ns']} ns; per CTA " + ", ".join(
                f"{p} {out[key][p + '_mean_ns']:.0f} ns (max "
                f"{out[key][p + '_max_ns']})" for p in phases))
    return out


def jpeg_sweep(torch):
    """This tree's J1 at each tile of J1_SWEEP and J2 at each strip of
    J2_SWEEP on JPEG_TIME_FRAME: device ms, each output against its twin
    (the count of unequal entries)."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.jpeg_write import (
        coefficients_reference)
    from superviseddescent_tpu_torch.ops.jpeg import (
        jpeg_coefficients, jpeg_pixels)
    f, coef, px, lay = jpeg_time_inputs(torch)
    out = {"j1": {}, "j2": {}}
    for tile in J1_SWEEP:
        row = {}
        for channels in (1, 3):
            got = jpeg_pixels(coef, f, channels, tile)
            unequal = int((got != jpeg.pixels_reference(
                coef, f, channels)).sum())
            check(unequal == 0, f"J1 at tile {tile}: {unequal} pixels "
                  "differ from the twin")
            row[channels] = device_ms(
                torch, lambda: jpeg_pixels(coef, f, channels, tile),
                reps=JPEG_TIME_REPS, match="jpeg")
        out["j1"][str(tile)] = row
        log(f"[j1] sweep tile {tile}: grey {row[1]:.5f} ms, RGB "
            f"{row[3]:.5f} ms (device), equal to the twin")
    twin = coefficients_reference(px, lay)
    for strip in J2_SWEEP:
        got = jpeg_coefficients(px, lay, strip)
        unequal = int((got != twin).sum())
        check(unequal == 0, f"J2 at strip {strip}: {unequal} coefficients "
              "differ from the twin")
        out["j2"][strip] = device_ms(
            torch, lambda: jpeg_coefficients(px, lay, strip),
            reps=JPEG_TIME_REPS, match="jpeg")
        log(f"[j2] sweep strip {strip}: {out['j2'][strip]:.5f} ms "
            "(device), equal to the twin")
    return out


def jpeg_compare(torch, root, which):
    """``--j1`` / ``--j2``: ``jpeg_times`` of this checkout's package and,
    with another checkout's (``root``), of that package (``other_runs``);
    the lines of ``which`` ("j1", "j2" or both) printed side by side."""
    runs = other_runs(root, lambda: jpeg_times(torch), ["--jpeg-times"])

    def text(run_list, key):
        total = " / ".join(f"{sum(r[key].values()):.5f}" for r in run_list)
        parts = " + ".join(f"{name} {ms:.5f}"
                           for name, ms in run_list[0][key].items())
        return f"{total} ms ({parts})"
    keys = [k for k in ("j1_grey", "j1_rgb", "j2") if k[:2] in which]
    for key in keys:
        line = (f"[{key[:2]}] {JPEG_TIME_FRAME} {key}: this tree "
                + text(runs["this"], key))
        if runs["other"]:
            line += " | other " + text(runs["other"], key)
        log(line + " (device, torch.profiler)")
    return runs


def jpeg_entry(jpeg, tiffwebp=None):
    """The kernels line's entry of J1: device ms per 1024 x 768 4:2:0
    frame of the progressive clip (the slice's main path; the baseline
    clip's beside it, measured in turns), launches of the depth-1
    rcr_track run on the progressive clip, plus the JPEG-in-TIFF run's
    (``phase_tiffwebp``) with its ms per 768 x 1024 page beside."""
    source, replaces = SOURCES["jpeg_decode"]
    t = jpeg["times"]
    extra = {}
    if tiffwebp is not None:
        tt = tiffwebp["times"]["j1"]
        extra = dict(tiff_launches=tiffwebp["launches"]["jpeg_decode"],
                     tiff_plain_ms=tt["jpeg_tiff_pil"]["twin_device_ms"],
                     tiff_bound_ms=tt["jpeg_tiff_pil"]["bound_ms"],
                     max_abs_err_tiff=tiffwebp["max_abs_err"],
                     **tiff_page_times(tt))
    return dict(
        name="jpeg_decode", route="cuda", source=source, replaces=replaces,
        replaces_note="no pallas_call: the JAX package decodes images with "
        "PIL on the host; J1 is a hand kernel of the io slice",
        launches=jpeg["track"][f"--depth {JPEG_TRACK_DEPTHS[0]}"][
            "j1_launches"] + extra.get("tiff_launches", 0),
        max_abs_err=max(jpeg["max_abs_err"],
                        extra.get("max_abs_err_tiff", 0)),
        ms=min(t["j1_progressive_device_ms"]),
        ms_baseline_clip=min(t["j1_device_ms"]),
        plain_ms=t["twin_device_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, ms_source="torch.profiler",
        **extra)


def jpeg_samples_entry(jpeg):
    """The kernels line's entry of J1's samples source (a lossless JPEG's
    samples): device ms on the grey SOF3 frame of the clip, launches of
    the counted ``load_gray_image`` run on it."""
    source, replaces = SOURCES["jpeg_samples"]
    c = jpeg["coded"]
    return dict(
        name="jpeg_samples", route="cuda", source=source, replaces=replaces,
        replaces_note="no pallas_call: the JAX package decodes images with "
        "PIL on the host; J1's samples source is a hand kernel of the io "
        "slice",
        launches=c["samples_launches"], max_abs_err=c["max_abs_err"],
        ms=c["samples_device_ms"], plain_ms=c["samples_twin_device_ms"],
        bound_ms=c["samples_bound_ms"], bound_by=c["samples_bound_by"],
        library_ms=None, ms_source="torch.profiler")


# ---------------------------------------------------------------- #
# Image io: J2, the readers, the apps' outputs
# ---------------------------------------------------------------- #
IMAGEIO_DIR = os.path.join(REPO, "tests", "torch_imageio")
# rcr_detect -o from these stills (412 x 600, .synth120 image 2, whose
# .pts gives the box) to each of these outputs
IMAGEIO_DETECT = ("f00_grey.bmp", "f01_grey.pgm", "f02_rgb_lzw_predictor.tif")
IMAGEIO_OUTPUTS = (".jpg", ".png", ".bmp", ".ppm", ".tif")
IMAGEIO_POINTS = "synth_0002"
# J2's integer operations: per 8x8 block 16 one-dimensional islow
# transforms of ~50 operations and 64 quantisations of ~6; per sample ~4
# (sum, bias, shift, level shift) and ~10 per full-resolution pixel it
# reads (clamped indices, the colour conversion's products and sums)
J2_OPS_PER_BLOCK = 16 * 50 + 64 * 6
J2_OPS_PER_SAMPLE = 4
J2_OPS_PER_PIXEL_READ = 10
J2_SWEEP_SIZES = ((1, 1), (1, 9), (7, 1), (8, 8), (9, 17), (16, 16),
                  (17, 17), (23, 31), (33, 33), (31, 8))
# the frame of the times: the clip's first frame as RGB, 4:2:0, quality 75
J2_TIME_FRAME = "clip/f000.jpg"
READER_REPS = 3


def j2_bound(lay):
    """J2's least time: the pixels read once and the int16 coefficients
    written once at the memory rate, or its integer operations at 67
    TOP/s, whichever is longer."""
    in_bytes = lay.width * lay.height * lay.channels
    out_bytes = lay.blocks * 64 * 2
    ops = 0
    for c in lay.components:
        blocks = lay.mcux * lay.mcuy * c.h * c.v
        ops += blocks * (J2_OPS_PER_BLOCK + 64 * (
            J2_OPS_PER_SAMPLE + J2_OPS_PER_PIXEL_READ * c.hexp * c.vexp))
    return dict(bytes_ms=(in_bytes + out_bytes) / MEM_BYTES_PER_S * 1e3,
                ops_ms=ops / OPS_PER_S * 1e3, in_bytes=in_bytes,
                out_bytes=out_bytes, ops=ops)


def imageio_j2(torch, manifest):
    """J2 against its twin on random pixels of every kind at
    J2_SWEEP_SIZES and qualities 1-100, and on the decoded pixels of the
    manifest's JPEG writes; each of those files' sha256 against PIL's.
    Returns (entries checked, files checked, largest |J2 - twin|)."""
    import hashlib
    import numpy as np
    from superviseddescent_tpu_torch.io.jpeg_write import (
        coefficients_reference, layout)
    from superviseddescent_tpu_torch.ops.jpeg import (
        encode_jpeg_device, jpeg_coefficients, read_jpeg)
    rng = np.random.default_rng(0)
    worst, checked = 0, 0

    def compare(px, lay, what):
        nonlocal worst, checked
        got = jpeg_coefficients(px, lay)
        twin = coefficients_reference(px, lay)
        torch.cuda.synchronize()
        err = int((got.int() - twin.int()).abs().max())
        worst = max(worst, err)
        checked += 1
        check(err == 0, f"J2 differs from its twin by {err} on {what}")
    kinds = ((3, "4:4:4"), (3, "4:2:2"), (3, "4:2:0"), (1, None))
    for k, (h, w) in enumerate(J2_SWEEP_SIZES):
        for channels, sub in kinds:
            shape = (h, w, 3) if channels == 3 else (h, w)
            px = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
            quality = (1, 10, 25, 50, 75, 90, 95, 100)[k % 8]
            compare(px.cuda(), layout(h, w, channels, quality, sub),
                    f"{h} x {w} {sub or 'grey'} q{quality}")
    files = 0
    for e in manifest["jpeg_writes"]:
        px = read_jpeg(os.path.join(JPEG_DIR, e["source"]), e["channels"])
        lay = layout(px.shape[0], px.shape[1], e["channels"], e["quality"],
                     e["subsampling"])
        what = (f"{e['source']} {e['subsampling'] or 'grey'} "
                f"q{e['quality']}")
        compare(px, lay, what)
        data = encode_jpeg_device(px, e["quality"], e["subsampling"])
        check(hashlib.sha256(data).hexdigest() == e["sha256"],
              f"{what}: the file J2 writes differs from PIL's digest")
        files += 1
    log(f"[imageio] J2 bit-equal to its twin on {checked} inputs (every "
        "kind at 10 sizes to 33 x 33, qualities 1-100; the decoded pixels "
        f"of {len(manifest['jpeg_writes'])} writes of 3 stills and 2 clip "
        "frames, 301 x 451 to 768 x 1024); every one of the "
        f"{files} files equal to PIL's digest")
    return checked, files, worst


def drawn_points():
    """The landmarks of the manifest's drawn PNG / TIFF writes and their
    bounding box (x, y, width, height), as the fixture script draws them
    (``tests/torch_imageio_fixtures.drawn_still``)."""
    import numpy as np
    from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
    coords = np.asarray(read_pts_landmarks(os.path.join(
        REPO, ".synth120", IMAGEIO_POINTS + ".pts")).coordinates, np.float32)
    lo = coords.min(axis=0)
    return coords, (*lo, *(coords.max(axis=0) - lo))


def imageio_png_tiff(torch, manifest):
    """The manifest's PNG and TIFF writes: the decoded pixels of the stills
    and clip frames (J1, grey and RGB) and two full-size stills drawn as
    ``rcr_detect -o`` draws, written by ``encode_png`` / ``encode_tiff``.
    Each PNG's filtered rows against PIL's (``filtered_sha256``, which no
    zlib changes) and each file against PIL's digest, which PIL's zlib
    (the manifest's ``zlib``) wrote: a file that differs under another
    zlib says so by name. Returns the files checked."""
    import hashlib
    import zlib
    from superviseddescent_tpu_torch.io.png import encode_png, filter_rows
    from superviseddescent_tpu_torch.io.tiff import encode_tiff
    from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
    ours, theirs = zlib.ZLIB_RUNTIME_VERSION, manifest["zlib"]
    coords, box = drawn_points()
    checked = 0
    for e in manifest["png_tiff_writes"]:
        if e["drawn"]:
            px = drawn(os.path.join(IMAGEIO_DIR, e["source"]), coords, box)
        else:
            px = read_jpeg(os.path.join(JPEG_DIR, e["source"]),
                           e["channels"]).cpu().numpy()
        kind = "drawn" if e["drawn"] else ("grey", "RGB")[e["channels"] > 1]
        what = f"{e['format']} of {e['source']} {kind}"
        if e["format"] == "PNG":
            rows = filter_rows(px.reshape(px.shape[0], -1), e["channels"])
            check(hashlib.sha256(rows.tobytes()).hexdigest()
                  == e["filtered_sha256"], f"{what}: the filtered rows "
                  "differ from PIL's")
            data = encode_png(px)
        else:
            data = encode_tiff(px)
        check(hashlib.sha256(data).hexdigest() == e["sha256"],
              f"{what}: the file differs from PIL's digest"
              + (f" (this machine's zlib is {ours}, the digest's {theirs})"
                 if ours != theirs else f" (zlib {ours}, as the digest's)"))
        checked += 1
    log(f"[imageio] {checked} PNG / TIFF writes (grey and RGB of 3 stills "
        "and 2 clip frames, 2 drawn stills) equal to PIL's digests, each "
        f"PNG's filtered rows too; zlib {ours} here, {theirs} for the "
        "digests")
    return checked


def imageio_reader_files(manifest):
    """The fixtures of the BMP / PNM / TIFF / GIF readers (the TIFF kinds,
    PFM and WebP: ``phase_tiffwebp``)."""
    return sorted(name for group in ("bmp", "pnm", "tiff", "gif", "full")
                  for name in manifest["groups"][group])


def imageio_readers(torch, manifest):
    """Every committed BMP / PNM / TIFF / GIF fixture read to PIL's grey
    and RGB digests (the host decoders); each full-size still's
    load_gray_image ms (host clock, the best of READER_REPS)."""
    import hashlib
    from superviseddescent_tpu_torch.io.image import read_gray, read_rgb
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    times = {}
    for name in imageio_reader_files(manifest):
        want = manifest["files"][name]
        path = os.path.join(IMAGEIO_DIR, name)
        grey, rgb = read_gray(path), read_rgb(path)
        for got, key in ((grey, "grey_sha256"), (rgb, "rgb_sha256")):
            check(hashlib.sha256(got.tobytes()).hexdigest() == want[key],
                  f"{name}: the port's {key[:-7]} differs from PIL's")
        if name.startswith("f"):
            reps = []
            for _ in range(READER_REPS):
                t0 = time.perf_counter()
                load_gray_image(path)
                reps.append((time.perf_counter() - t0) * 1e3)
            times[name] = reps
    log(f"[imageio] {len(imageio_reader_files(manifest))} BMP / DIB / PNM / "
        "TIFF / GIF "
        "fixtures read to PIL's grey and RGB digests; load_gray_image of a "
        "412 x 600 still, ms (host): " + ", ".join(
            f"{n} {min(v):.2f}" for n, v in times.items()))
    return times


def imageio_times(torch):
    """J2's device ms (torch.profiler) on the clip's first frame as RGB
    4:2:0 q75 beside its twin's and its bound; the host coder's ms; a
    whole write_jpeg (J2, the copy, the coder, the file) against
    write_png (the port's zlib writer) of the same frame, in turns."""
    import tempfile
    from superviseddescent_tpu_torch.io.jpeg_write import (
        coefficients_reference, layout)
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.ops.jpeg import (
        huffman_encode_native, jpeg_coefficients, read_jpeg, write_jpeg)
    px = read_jpeg(os.path.join(JPEG_DIR, J2_TIME_FRAME), 3)
    lay = layout(px.shape[0], px.shape[1], 3)
    j2_ms = [device_ms(torch, lambda: jpeg_coefficients(px, lay),
                       reps=50, match="jpeg_coefficients") for _ in range(2)]
    twin_ms = device_ms(torch, lambda: coefficients_reference(px, lay),
                        one_kernel=False)
    host = jpeg_coefficients(px, lay).cpu().pin_memory()
    coder = []
    for _ in range(5):
        t0 = time.perf_counter()
        huffman_encode_native(host, lay)
        coder.append((time.perf_counter() - t0) * 1e3)
    writes = {"jpeg": [], "png": []}
    px_host = px.cpu().numpy()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_write_") as d:
        for kind in ("jpeg", "png") * 3:
            t0 = time.perf_counter()
            if kind == "jpeg":
                write_jpeg(os.path.join(d, "x.jpg"), px)
            else:
                write_png(os.path.join(d, "x.png"), px_host)
            writes[kind].append((time.perf_counter() - t0) * 1e3)
    bound = j2_bound(lay)
    out = dict(j2_device_ms=j2_ms, twin_device_ms=twin_ms,
               bound_ms=max(bound["bytes_ms"], bound["ops_ms"]),
               bound_by=("bytes" if bound["bytes_ms"] >= bound["ops_ms"]
                         else "operations"), bound=bound,
               host_coder_ms=coder, write_jpeg_ms=writes["jpeg"],
               write_png_ms=writes["png"])
    log(f"[imageio] J2 on a {lay.width} x {lay.height} RGB 4:2:0 q75 frame: "
        + " / ".join(f"{v:.5f}" for v in j2_ms) + " ms (device, "
        f"torch.profiler), bound {out['bound_ms']:.5f} ms ({out['bound_by']}: "
        f"{bound['in_bytes'] / 1e6:.2f} MB in, {bound['out_bytes'] / 1e6:.2f}"
        f" MB out; operations {bound['ops_ms']:.5f} ms), twin "
        f"{twin_ms:.4f} ms device; host coder {min(coder):.3f}-"
        f"{max(coder):.3f} ms; write_jpeg " + " / ".join(
            f"{v:.2f}" for v in writes["jpeg"]) + " ms against write_png "
        + " / ".join(f"{v:.2f}" for v in writes["png"]) + " ms (host clock)")
    return out


def imageio_track(torch, manifest, root):
    """rcr_track -o on the 16-frame baseline clip at depth 1: f000.jpg ...
    written, each byte-equal to the CPU twins' encoding of the frame drawn
    with the row the run reported; J1 twice and J2 once a frame, K3 once."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_track
    frames = manifest["clip"]["frames"]
    n = len(frames)
    model_path, box_arg = clip_track_model(torch, manifest, root)
    out_dir = os.path.join(root, "tracked")
    rows = []
    zero_counts()
    with recorded(rcr_track, "estimate_ok", rows,
                  lambda a, ok: np.array(a[0])):
        rc, text, wall = run_app_main(rcr_track, [
            "-m", model_path, "-f", os.path.join(JPEG_DIR, "clip"),
            "--facebox", box_arg, "--device", "cuda", "--depth", "1", "-o",
            out_dir])
    torch.cuda.synchronize()
    launches = read_counts()
    check(rc == 0 and len(rows) == n, f"rcr_track -o exited {rc}:\n{text}")
    expect_counts(launches, "rcr_track -o on the JPEG clip",
                  cascade_fused_frames=n, jpeg_decode=2 * n, jpeg_encode=n)
    names = sorted(os.listdir(out_dir))
    check(names == [os.path.basename(f["name"]) for f in frames],
          f"rcr_track -o wrote {names}")
    for fr, row in zip(frames, rows):
        l = row.shape[0] // 2
        coords = np.stack([row[:l], row[l:]], axis=1).astype(np.float32)
        want = drawn_jpeg(os.path.join(JPEG_DIR, fr["name"]), coords)
        with open(os.path.join(out_dir, os.path.basename(fr["name"])),
                  "rb") as fh:
            check(fh.read() == want, f"rcr_track -o {fr['name']}: the card's "
                  "file differs from the CPU twins' encoding of the frame "
                  "drawn with the reported row")
    ms = wall * 1e3 / n
    log(f"[imageio] rcr_track -o over {n} JPEG frames of 768 x 1024 at "
        f"depth 1: {ms:.2f} ms a frame (J1 {launches['jpeg_decode']}, J2 "
        f"{launches['jpeg_encode']}, K3 {launches['cascade_fused_frames']} "
        "launches); every f0NN.jpg the twins' bytes")
    return dict(ms_per_frame=ms, launches=launches)


def imageio_detect(torch, root):
    """rcr_detect -i <still> --pts -o out<ext> for the BMP, PGM and TIFF
    stills and each of IMAGEIO_OUTPUTS: the named file in its format, the
    JPEG the CPU twins' bytes, the others the drawn pixels; J2 once for a
    JPEG output, J1 never."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.io.image import read_rgb, sniff
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.io.bmp import encode_bmp
    from superviseddescent_tpu_torch.io.png import encode_png
    from superviseddescent_tpu_torch.io.pnm import encode_pnm
    from superviseddescent_tpu_torch.io.tiff import encode_tiff
    magic = {".jpg": "JPEG", ".png": "PNG", ".bmp": "BMP", ".ppm": "PPM",
             ".tif": "TIFF"}
    encoders = {".png": encode_png, ".bmp": encode_bmp, ".ppm": encode_pnm,
                ".tif": encode_tiff}
    out = {}
    for still in IMAGEIO_DETECT:
        image = os.path.join(IMAGEIO_DIR, still)
        for ext in IMAGEIO_OUTPUTS:
            target = os.path.join(root, f"detect_{still[:3]}{ext}")
            fits = []
            zero_counts()
            with recorded(DetectionModel, "detect", fits,
                          lambda a, lms: (np.asarray(lms.coordinates),
                                          a[2])):
                rc, text, wall = run_app_main(rcr_detect, [
                    "-m", os.path.join(REPO, "pretrained",
                                       "rcr22_lfpw5.bin"),
                    "-i", image, "--pts", os.path.join(
                        REPO, ".synth120", IMAGEIO_POINTS + ".pts"),
                    "-o", target, "--device", "cuda"])
            torch.cuda.synchronize()
            check(rc == 0 and len(fits) == 1 and f"Wrote {target}" in text,
                  f"rcr_detect -i {still} -o {ext}:\n{text}")
            expect_counts(read_counts(), f"rcr_detect -i {still} -o {ext}",
                          jpeg_encode=int(ext == ".jpg"))
            coords, box = fits[0]
            with open(target, "rb") as fh:
                data = fh.read()
            check(sniff(data) == magic[ext], f"rcr_detect -o {target}: "
                  f"{sniff(data)} bytes")
            if ext == ".jpg":
                check(data == drawn_jpeg(image, coords, box),
                      f"rcr_detect -i {still} -o {ext}: the JPEG differs "
                      "from the CPU twins'")
            else:
                picture = drawn(image, coords, box)
                check(np.array_equal(read_rgb(target), picture),
                      f"rcr_detect -i {still} -o {ext}: the pixels differ "
                      "from the drawing")
                check(data == encoders[ext](picture),
                      f"rcr_detect -i {still} -o {ext}: the file differs "
                      "from the writer's bytes of the drawing")
            out[f"{still} {ext}"] = wall * 1e3
    log("[imageio] rcr_detect -o to .jpg / .png / .bmp / .ppm / .tif from a "
        "BMP, a PGM and a TIFF still (each file the writers' bytes of the "
        "drawing), ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out.items()))
    return out


def phase_imageio(torch, name, smi):
    """The image-io slice on the card: J2 against its twin and PIL's
    digests, the readers against PIL's digests, rcr_track -o on the JPEG
    clip, rcr_detect -o to four formats from three, the times."""
    import shutil
    import tempfile
    with open(os.path.join(IMAGEIO_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    with open(os.path.join(JPEG_DIR, "manifest.json")) as fh:
        jpeg_manifest = json.load(fh)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_imageio_")
    try:
        checked, files, worst = imageio_j2(torch, manifest)
        png_tiff = imageio_png_tiff(torch, manifest)
        readers = imageio_readers(torch, manifest)
        times = imageio_times(torch)
        track = imageio_track(torch, jpeg_manifest, root)
        detect = imageio_detect(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[imageio] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, j2_checked=checked,
                files_checked=files, png_tiff_checked=png_tiff,
                max_abs_err=worst, readers_ms=readers,
                times=times, track=track, detect=detect, seconds=seconds)



# GIF and WebP writing (phase_imagewrite): the repetitions of the host
# coders' timing on the clip frame (the Python twins run once: the WebP
# twin takes tens of seconds a frame)
IMAGEWRITE_REPS = 5


def imagewrite_inputs():
    """(manifest, make) with ``make(entry)`` the pixels of a write
    fixture through the port (``tests/torch_write_inputs.py``: numpy, the
    port's readers on the card, ``apps/_draw``)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_write_inputs import digest, make_pixels, port_readers
    with open(os.path.join(IMAGEIO_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    read, drawn_px = port_readers("cuda")

    def make(entry):
        px = make_pixels(entry["recipe"], read, drawn_px)
        check(digest(px.tobytes()) == entry["pixels_sha256"],
              f"{entry['name']}: the recipe's pixels differ from those "
              "PIL's digest was taken of")
        return px
    return manifest, make


def imagewrite_files(torch, manifest, make, root):
    """Every GIF and WebP write fixture written by ``write_image`` from a
    card tensor, as ``apps/_draw`` hands it (the host C++ coders), each
    file against PIL's committed digest; no kernel launched."""
    import hashlib
    from superviseddescent_tpu_torch.io.image import write_image
    checked = {}
    for key, ext in (("gif_writes", ".gif"), ("webp_writes", ".webp")):
        checked[key] = 0
        for e in manifest[key]:
            px = torch.from_numpy(make(e)).cuda()
            target = os.path.join(root, e["name"] + ext)
            zero_counts()
            check(write_image(target, px) == ext[1:].upper(),
                  f"write_image {target}: the format")
            expect_counts(read_counts(), f"write_image {target}")
            with open(target, "rb") as fh:
                data = fh.read()
            check(hashlib.sha256(data).hexdigest() == e["sha256"]
                  and len(data) == e["bytes"],
                  f"{e['name']}{ext} ({'x'.join(map(str, e['shape']))}): "
                  "the file differs from PIL's digest")
            checked[key] += 1
    log(f"[imagewrite] {checked['gif_writes']} GIF and "
        f"{checked['webp_writes']} WebP writes from card tensors equal to "
        "PIL's digests (the host C++ coders)")
    return checked


def imagewrite_detect(torch, manifest, root):
    """rcr_detect -i <still> --pts -o out.gif / out.webp on the card: each
    file the JAX app's (its digest from a CPU run); no kernel launched for
    a PNG still. Returns the wall ms of each."""
    import hashlib
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    out = {}
    for e in manifest["app_writes"]:
        image = os.path.join(REPO, e["image"])
        target = os.path.join(root, "detect" + e["ext"])
        fits = []
        zero_counts()
        with recorded(DetectionModel, "detect", fits,
                      lambda a, lms: np.asarray(lms.coordinates)):
            rc, text, wall = run_app_main(rcr_detect, [
                "-m", os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"),
                "-i", image, "--pts", image[:-4] + ".pts", "-o", target,
                "--device", "cuda"])
        torch.cuda.synchronize()
        check(rc == 0 and len(fits) == 1 and f"Wrote {target}" in text,
              f"rcr_detect -o {target}:\n{text}")
        expect_counts(read_counts(), f"rcr_detect -o {target}")
        with open(target, "rb") as fh:
            data = fh.read()
        check(hashlib.sha256(data).hexdigest() == e["sha256"],
              f"rcr_detect -i {e['image']} -o out{e['ext']}: the file "
              "differs from the JAX app's (the JAX run's drawn corners lie "
              f"{e['corner_margin']:.4f} px from the next integer at least)")
        out[e["ext"]] = wall * 1e3
    log("[imagewrite] rcr_detect -o .gif / .webp on the card equal to the "
        "JAX app's files, ms: " + ", ".join(
            f"{k} {v:.1f}" for k, v in out.items()))
    return out


def imagewrite_times(torch, manifest, make):
    """Host ms per 768 x 1024 RGB frame (the clip frame) of each writer's
    encoding: GIF and WebP through the C++ coders (best of
    IMAGEWRITE_REPS) and their Python twins (once), PNG, and JPEG through
    J2 and the host coder from a card tensor (best of IMAGEWRITE_REPS)."""
    from superviseddescent_tpu_torch.io.gif_write import encode_gif
    from superviseddescent_tpu_torch.io.jpeg_write import encode_jpeg
    from superviseddescent_tpu_torch.io.png import encode_png
    from superviseddescent_tpu_torch.io.vp8_write import encode_webp
    frame, = [e for e in manifest["webp_writes"] if e["name"] == "clip_frame"]
    px = make(frame)
    on_card = torch.from_numpy(px).cuda()

    def best(call, reps):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return min(times)
    encode_jpeg(on_card)                  # J2's first launch out of the way
    times = {
        "gif_cpp_ms": best(lambda: encode_gif(px, native=True),
                           IMAGEWRITE_REPS),
        "webp_cpp_ms": best(lambda: encode_webp(px, native=True),
                            IMAGEWRITE_REPS),
        "png_ms": best(lambda: encode_png(px), IMAGEWRITE_REPS),
        "jpeg_j2_ms": best(lambda: encode_jpeg(on_card), IMAGEWRITE_REPS),
        "gif_twin_ms": best(lambda: encode_gif(px), 1),
        "webp_twin_ms": best(lambda: encode_webp(px), 1)}
    log("[imagewrite] host ms per 768 x 1024 RGB frame: " + ", ".join(
        f"{k[:-3]} {v:.1f}" for k, v in times.items()))
    return times


def phase_imagewrite(torch, name, smi):
    """GIF and WebP writing on the card's path: every write fixture from a
    card tensor to PIL's digest through the host C++ coders, rcr_detect -o
    .gif / .webp to the JAX app's files, the host times beside PNG's and
    JPEG's."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    manifest, make = imagewrite_inputs()
    root = tempfile.mkdtemp(prefix="chip_smoke_imagewrite_")
    try:
        files = imagewrite_files(torch, manifest, make, root)
        detect = imagewrite_detect(torch, manifest, root)
        times = imagewrite_times(torch, manifest, make)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[imagewrite] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, files=files, detect=detect,
                times=times, seconds=seconds)

def imageio_entry(imageio):
    """The kernels line's entry of J2: device ms per 768 x 1024 RGB 4:2:0
    frame, launches of the rcr_track -o run."""
    source, replaces = SOURCES["jpeg_encode"]
    t = imageio["times"]
    return dict(
        name="jpeg_encode", route="cuda", source=source, replaces=replaces,
        replaces_note="no pallas_call: the JAX apps write their drawings "
        "with PIL's JPEG writer on the host; J2 is a hand kernel of the io "
        "slice", launches=imageio["track"]["launches"]["jpeg_encode"],
        max_abs_err=imageio["max_abs_err"], ms=min(t["j2_device_ms"]),
        plain_ms=t["twin_device_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None, ms_source="torch.profiler")


# ---------------------------------------------------------------- #
# Every TIFF kind PIL reads, JPEG-in-TIFF (J1), PFM, lossless WebP
# ---------------------------------------------------------------- #
TIFFWEBP_GROUPS = ("tiff_kind", "tiff_more", "pfm", "webp", "clip",
                   "tiff_remainder")
# the committed 768 x 1024 files of the clip frame's pixels: a lossless
# WebP, JPEG-in-TIFF as PIL's writer lays it out (RGB, 32 strips of 32
# rows) and as libtiff's does (YCbCr 4:2:0, 64 strips of 16 rows), one J1
# launch each; J1 is also timed on 4:2:0 strips of 80 rows, the worst case
# of two launches (a batch of 12 and a short last strip)
TIFFWEBP_COMMITTED = {"webp": "f04_clip.webp",
                      "jpeg_tiff_pil": "f06_clip_rgb_pil.tif",
                      "jpeg_tiff_libtiff": "f07_clip_ycbcr420_libtiff.tif"}
TIFFWEBP_J1 = dict(TIFFWEBP_COMMITTED, jpeg_tiff_worst="f05_clip_ycbcr420.tif")
del TIFFWEBP_J1["webp"]
# the rest of the TIFF files PIL reads, on the clip frame: PIL's
# JPEG-in-TIFF (f06) re-laid as BigTIFF (one J1 launch), PIL's Zstandard
# (predictor 2) and libtiff's YCbCr 2x2 units under LZW (strips of 16
# rows); a CCITT RLE TIFF is coded here (tiff_ccitt_rle)
TIFF_REMAINDER_COMMITTED = {"jpeg_tiff_big": "f09_clip_bigtiff_jpeg.tif",
                            "zstd_tiff": "f10_clip_zstd.tif",
                            "ycbcr_tiff": "f11_clip_ycbcr22_lzw.tif"}
TIFFWEBP_REPS = 5


def tiffwebp_readers(torch, manifest):
    """Every new fixture read on the card (``read_gray`` / ``read_rgb``
    with the card as the device: JPEG-compressed TIFFs through J1, WebP
    through the C++ decoder, the rest on the host) to PIL's digests; a
    kind PIL cannot read raises. J1 on each JPEG-compressed
    TIFF's batch of strips or tiles against its twin on the same
    coefficients; the C++ WebP decoder against the Python twin on the
    small WebP fixtures; the C++ CCITT and Zstandard decoders against
    their twins. Returns (files checked, J1's largest difference from its
    twin)."""
    import hashlib
    import numpy as np
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.image import read_gray, read_rgb
    from superviseddescent_tpu_torch.io.tiff import (
        NATIVE, compression as tiff_compression, decode_tiff, jpeg_chunks)
    from superviseddescent_tpu_torch.io.webp import (
        compose, decode_vp8l, decode_vp8l_native)
    from superviseddescent_tpu_torch.ops.jpeg import (
        entropy_decode_native, jpeg_pixels)
    names = sorted(n for g in TIFFWEBP_GROUPS for n in manifest["groups"][g])
    refused = worst = 0
    for name in names:
        want, path = manifest["files"][name], os.path.join(IMAGEIO_DIR, name)
        if "pil_error" in want:
            try:
                read_rgb(path)
            except ValueError as e:
                refused += 1
                check("not a kind PIL reads" in str(e),
                      f"{name}: refused as {e}")
                continue
            check(False, f"{name}: read, where it must be refused by name")
        for read, key in ((read_gray, "grey_sha256"), (read_rgb,
                                                       "rgb_sha256")):
            got = read(path)
            check(hashlib.sha256(got.tobytes()).hexdigest() == want[key],
                  f"{name}: the port's {key[:-7]} on the card differs from "
                  "PIL's")
        with open(path, "rb") as fh:
            data = fh.read()
        if name.endswith(".tif") and tiff_compression(data) == 7:
            page = jpeg_chunks(data)
            frames = [jpeg.parse_jpeg(st) for st in page.streams]
            f = frames[0]
            same = [g for g in frames if (g.width, g.height) == (f.width,
                                                                 f.height)]
            coef = torch.stack([entropy_decode_native(g) for g in same]
                               ).cuda()
            for channels in (1, 3):
                got = jpeg_pixels(coef, f, channels)
                worst = max(worst, int((got.int() - jpeg.pixels_reference(
                    coef, f, channels).int()).abs().max()))
        if name.startswith("w"):
            check(np.array_equal(compose(data, decode_vp8l_native),
                                 compose(data, decode_vp8l)),
                  f"{name}: the C++ decoder differs from the Python twin")
        if name.endswith(".tif") and tiff_compression(data) in NATIVE:
            check(np.array_equal(decode_tiff(data, native=True),
                                 decode_tiff(data)),
                  f"{name}: the C++ TIFF decoder differs from the twin")
    check(worst == 0, f"J1 on the TIFF batches differs from its twin by "
          f"{worst}")
    log(f"[tiffwebp] {len(names)} fixtures on the card ({refused} refused "
        "by name as PIL refuses them), the rest equal to PIL's "
        "grey and RGB digests; J1 on every JPEG-in-TIFF batch (BigTIFF's "
        "too) equal to its twin; the C++ WebP, CCITT and Zstandard decoders "
        "equal to their Python twins")
    return len(names), worst


def tiff_bytes(samples, bits: int, sample_format: int) -> bytes:
    """An uncompressed little-endian TIFF of one strip of grey ``samples``
    (photometric 1): PIL's I;16 (16 bits, 1) or F (32 bits, 3)."""
    import struct
    h, w = samples.shape
    body = samples.astype("<u2" if bits == 16 else "<f4").tobytes()
    tags = [(256, 4, w), (257, 4, h), (258, 3, bits), (259, 3, 1),
            (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 4, h),
            (279, 4, len(body)), (339, 3, sample_format)]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, k, 1) + struct.pack(
            "<I" if k == 4 else "<H2x", v) for t, k, v in tags) + bytes(4)
    return b"II*\x00" + struct.pack("<I", 8 + len(body)) + body + ifd


def tiff_ccitt_rle(black) -> bytes:
    """Bilevel rows (True black) as a CCITT RLE TIFF (compression 2,
    white-is-zero, one strip): each row's runs in modified Huffman codes
    from white (io/ccitt.py's tables), the row padded to a byte."""
    import struct
    import numpy as np
    from superviseddescent_tpu_torch.io import ccitt
    h, w = black.shape

    def run(n, colour):
        codes = ccitt.BLACK_CODES if colour else ccitt.WHITE_CODES
        makeup = ccitt.BLACK_MAKEUP if colour else ccitt.WHITE_MAKEUP
        out = ""
        while n >= 2624:
            out += ccitt.EXTENDED_MAKEUP[-1]
            n -= 2560
        if n >= 64:
            m = n // 64
            out += makeup[m - 1] if m <= 27 else ccitt.EXTENDED_MAKEUP[m - 28]
            n -= 64 * m
        return out + codes[n]
    body = bytearray()
    for row in black.astype(np.int8):
        changes = (np.flatnonzero(np.diff(row)) + 1).tolist()
        bounds = [0] + [0] * int(row[0]) + changes + [w]
        code = "".join(run(b - a, k & 1)
                       for k, (a, b) in enumerate(zip(bounds, bounds[1:])))
        code += "0" * (-len(code) % 8)
        body += int(code, 2).to_bytes(len(code) // 8, "big")
    tags = [(256, 4, w), (257, 4, h), (258, 3, 1), (259, 3, 2), (262, 3, 0),
            (273, 4, 8), (277, 3, 1), (278, 4, h), (279, 4, len(body))]
    ifd = struct.pack("<H", len(tags)) + b"".join(
        struct.pack("<HHI", t, k, 1) + struct.pack(
            "<I" if k == 4 else "<H2x", v) for t, k, v in tags) + bytes(4)
    return b"II*\x00" + struct.pack("<I", 8 + len(body)) + bytes(body) + ifd


def tiffwebp_files(torch, manifest, root):
    """The clip frame's pixels in every new kind, as files under ``root``,
    and the grey that ``load_gray_image`` must give for each: the
    committed lossless WebP (the clip frame's grey) and JPEG-in-TIFFs
    (the grey of their RGB read on the card, both digests PIL's), and
    built here from the clip frame's grey (the card has no PIL) an I;16
    TIFF (twice the grey: clipped past 127), an F TIFF (the grey plus 0.7:
    truncated back), a PFM (1.5 times less 20, rows bottom up:
    truncated and clipped) and a CCITT RLE TIFF (the grey below 128
    black, white-is-zero: 0 and 255); the rest of the TIFF kinds' files
    (``TIFF_REMAINDER_COMMITTED``) as the JPEG-in-TIFFs. Returns (paths,
    greys) by kind."""
    import hashlib
    import shutil
    import numpy as np
    from superviseddescent_tpu_torch.io.image import read_rgb
    from superviseddescent_tpu_torch.ops.jpeg import read_jpeg
    from superviseddescent_tpu_torch.ops.patches import rgb_to_gray_u8

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    grey = read_jpeg(os.path.join(JPEG_DIR, J2_TIME_FRAME), 1).cpu().numpy()
    check(digest(grey) == manifest["files"][TIFFWEBP_COMMITTED["webp"]][
        "grey_sha256"], "the clip frame's grey differs from PIL's grey of "
        "its lossless WebP")
    g = grey.astype("<f4")
    paths, greys = {}, {"webp": grey}
    for kind, name in {**TIFFWEBP_COMMITTED,
                       **TIFF_REMAINDER_COMMITTED}.items():
        paths[kind] = os.path.join(root, name)
        shutil.copy(os.path.join(IMAGEIO_DIR, name), paths[kind])
        if kind != "webp":
            want = manifest["files"][name]
            rgb = read_rgb(paths[kind])
            check(digest(rgb) == want["rgb_sha256"], f"{name}: RGB on the "
                  "card differs from PIL's")
            greys[kind] = rgb_to_gray_u8(rgb)
            check(digest(greys[kind]) == want["grey_sha256"],
                  f"{name}: grey differs from PIL's")
    built = {"i16_tiff.tif": (tiff_bytes(grey.astype("<u2") * 2, 16, 1),
                              np.clip(2 * grey.astype(np.int32), 0, 255)),
             "f_tiff.tif": (tiff_bytes(g + 0.7, 32, 3), grey),
             "ccitt_tiff.tif": (tiff_ccitt_rle(grey < 128),
                                np.where(grey < 128, 0, 255)),
             "pfm.pfm": (b"Pf\n%d %d\n-1.0\n" % (g.shape[1], g.shape[0])
                         + (g * 1.5 - 20)[::-1].astype("<f4").tobytes(),
                         np.clip(np.trunc(g * 1.5 - 20), 0, 255))}
    for name, (data, want) in built.items():
        kind = name.split(".")[0]
        paths[kind] = os.path.join(root, name)
        greys[kind] = want.astype(np.uint8)
        with open(paths[kind], "wb") as fh:
            fh.write(data)
    return paths, greys


def tiffwebp_k3(torch, data, paths, greys, root):
    """The slice's main path: each kind's file through
    ``load_gray_image`` on the card, each frame equal to the grey the kind
    holds, then ``make_fused_detector`` (K3) on the 4,096 faces' boxes
    over that one frame; the rows equal those from the same grey written
    as PNG and read back. Counts from 0 before, read after: J1 once per
    JPEG-in-TIFF (every strip full: one batch), K3 once per kind. Returns
    the launches and the PNG paths."""
    import numpy as np
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    model = data["model"]
    det = model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    idx = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    zero_counts()
    frames = {kind: load_gray_image(p) for kind, p in paths.items()}
    rows = {kind: det(torch.from_numpy(f.astype("uint8"))[None].cuda(),
                      data["boxes"], image_indices=idx)
            for kind, f in frames.items()}
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(launches, "the new kinds through load_gray_image and K3",
                  jpeg_decode=sum(k.startswith("jpeg_tiff") for k in paths),
                  cascade_fused_frames=len(paths))
    pngs = {}
    for kind, f in frames.items():
        check(np.array_equal(f, greys[kind]), f"{kind}: load_gray_image on "
              "the card differs from the pixels the file holds")
        pngs[kind] = os.path.join(root, f"{kind}.png")
        write_png(pngs[kind], greys[kind])
        png_rows = det(torch.from_numpy(load_gray_image(pngs[kind]).astype(
            "uint8"))[None].cuda(), data["boxes"], image_indices=idx)
        check(rows[kind].shape == (BATCH, 2 * len(model.landmark_ids))
              and bool(torch.isfinite(rows[kind]).all()),
              f"{kind}: non-finite or misshapen rows")
        check(torch.equal(rows[kind], png_rows), f"{kind}: K3's rows from "
              "the frame differ from those from its pixels as PNG")
    log(f"[tiffwebp] the clip frame as {', '.join(paths)}: load_gray_image "
        "equal to the pixels each holds, then K3 on "
        f"{BATCH} faces, rows equal to the PNG of the same pixels; "
        f"launches {launches}")
    return launches, pngs


def tiffwebp_times(torch, paths, pngs):
    """Each new reader's ``load_gray_image`` ms on the 768 x 1024 frame
    (host clock, the kinds in turns, TIFFWEBP_REPS rounds) beside the PNG
    of the WebP's pixels; J1's device ms per page (torch.profiler, every
    launch of a read) on each JPEG-in-TIFF layout of ``TIFFWEBP_J1``, its
    twin's and its bound."""
    from superviseddescent_tpu_torch.io import jpeg
    from superviseddescent_tpu_torch.io.tiff import jpeg_chunks
    from superviseddescent_tpu_torch.ops import jpeg as ops_jpeg
    from superviseddescent_tpu_torch.ops.jpeg import (
        jpeg_pixels, read_tiff_jpeg)
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    order = dict(paths, png=pngs["webp"])
    ms = {kind: [] for kind in order}
    for _ in range(TIFFWEBP_REPS):
        for kind, p in order.items():
            t0 = time.perf_counter()
            load_gray_image(p)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
    j1 = {}
    for kind, name in TIFFWEBP_J1.items():
        with open(os.path.join(IMAGEIO_DIR, name), "rb") as fh:
            data = fh.read()
        # J1's launches of one read, caught with their inputs and replayed:
        # the profiled calls hold J1 alone, not the host's entropy stage
        # between its launches (the profiler lost every launch of three
        # such sessions in a row late in a run)
        launched = []
        launch_j1 = ops_jpeg._launch_j1

        def spy(symbol, values, dtype, f, channels, tile):
            launched.append((values, f, channels))
            return launch_j1(symbol, values, dtype, f, channels, tile)
        before = jpeg_pixels.launches
        ops_jpeg._launch_j1 = spy
        try:
            read_tiff_jpeg(data, 1)
        finally:
            ops_jpeg._launch_j1 = launch_j1
        per_call = jpeg_pixels.launches - before
        check(per_call == len(launched), f"J1 on {name}: {per_call} "
              f"launches counted, {len(launched)} caught")

        def replay(kernel):
            return lambda: [kernel(c, f, ch) for c, f, ch in launched]
        # a read's launches are one kernel by name: its mean over the
        # session times the launches a read counts (the profiler may miss
        # some of a session's launches, which rounding per read would halve)
        j1_ms = []
        for _ in range(2):
            found = device_kernels(torch, replay(jpeg_pixels), reps=10,
                                   match="jpeg_pixels",
                                   launches_per_call=per_call)
            check(len(found) == 1, f"J1 on {name}: kernels {found}")
            j1_ms.append(per_call * found[0][2] / 1e3)
        frames = [jpeg.parse_jpeg(st) for st in jpeg_chunks(data).streams]
        # the twin runs some 10^5 small operations a page: two reps, or
        # the profiler's records take minutes to sum
        twin_ms = device_ms(torch, replay(jpeg.pixels_reference), reps=2,
                            one_kernel=False)
        bounds = [jpeg_bound(g, 1) for g in frames]
        bound = {k: sum(b[k] for b in bounds) for k in bounds[0]}
        j1[kind] = dict(
            file=name, strips=len(frames), launches=per_call,
            device_ms=j1_ms, twin_device_ms=twin_ms,
            bound_ms=max(bound["bytes_ms"], bound["ops_ms"]),
            bound_by=("bytes" if bound["bytes_ms"] >= bound["ops_ms"]
                      else "operations"), bound=bound)
    log("[tiffwebp] load_gray_image of the 768 x 1024 frame, ms (host "
        "clock, best of " + str(TIFFWEBP_REPS) + ", the kinds in turns): "
        + ", ".join(f"{k} {min(v):.2f}" for k, v in ms.items()))
    for kind, t in j1.items():
        log(f"[tiffwebp] J1 on {t['file']} ({t['strips']} strips, "
            f"{t['launches']} launches): "
            + " / ".join(f"{v:.5f}" for v in t["device_ms"])
            + f" ms (device, torch.profiler), bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}), twin {t['twin_device_ms']:.4f} ms device")
    return dict(load_gray_ms=ms, j1=j1)


def tiff_decoder_times(paths, name, smi):
    """The host TIFF decoders' ms on the 768 x 1024 frame (host clock):
    ``decode_tiff`` of the Zstandard and CCITT RLE frames through the C++
    decoders (best of TIFFWEBP_REPS) and through their Python twins (best
    of 2: the Zstandard twin takes seconds a frame), and of the YCbCr 2x2
    LZW frame (LZW and the colour conversion in numpy on the host, no C++
    form)."""
    from superviseddescent_tpu_torch.io.tiff import decode_tiff
    ways = {"zstd_tiff": {"cpp": True, "twin": False},
            "ccitt_tiff": {"cpp": True, "twin": False},
            "ycbcr_tiff": {"host": False}}
    out = {}
    for kind, by in ways.items():
        with open(paths[kind], "rb") as fh:
            data = fh.read()
        for way, native in by.items():
            ms = []
            for _ in range(2 if way == "twin" else TIFFWEBP_REPS):
                t0 = time.perf_counter()
                decode_tiff(data, native)
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"{kind}_{way}"] = ms
    log("[tiffwebp] decode_tiff of the 768 x 1024 frame, host ms (best of "
        f"{TIFFWEBP_REPS}, twins of 2): " + ", ".join(
            f"{k} {min(v):.2f}" for k, v in out.items()) + f" ({name}; {smi})")
    return out


def tiffwebp_entry(tiffwebp):
    """J1's entry of a ``--tiffwebp`` run: launches and device ms per 768
    x 1024 JPEG-in-TIFF page as PIL's writer lays it out, the other
    layouts beside."""
    source, replaces = SOURCES["jpeg_decode"]
    t = tiffwebp["times"]["j1"]
    main = t["jpeg_tiff_pil"]
    return dict(
        name="jpeg_decode", route="cuda", source=source, replaces=replaces,
        launches=tiffwebp["launches"]["jpeg_decode"],
        max_abs_err=tiffwebp["max_abs_err"], ms=min(main["device_ms"]),
        plain_ms=main["twin_device_ms"], bound_ms=main["bound_ms"],
        bound_by=main["bound_by"], library_ms=None,
        ms_source="torch.profiler", **tiff_page_times(t))


def tiff_page_times(j1):
    """J1's ms per JPEG-in-TIFF page by layout, for the kernels line."""
    return {f"ms_tiff_page_{kind[len('jpeg_tiff_'):]}": min(v["device_ms"])
            for kind, v in j1.items()}


def phase_tiffwebp(torch, data, name, smi):
    """The TIFF kinds (BigTIFF, CCITT, Zstandard and YCbCr too),
    JPEG-in-TIFF (J1), PFM and lossless WebP on the card: every new
    fixture to PIL's digests, J1's TIFF batches and the C++ TIFF and WebP
    decoders against their twins, the clip frame in each new kind through
    load_gray_image and K3 (rows equal to its PNG's), the readers', the
    host decoders' and J1's times."""
    import shutil
    import tempfile
    with open(os.path.join(IMAGEIO_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_tiffwebp_")
    try:
        checked, worst = tiffwebp_readers(torch, manifest)
        paths, greys = tiffwebp_files(torch, manifest, root)
        launches, pngs = tiffwebp_k3(torch, data, paths, greys, root)
        times = tiffwebp_times(torch, paths, pngs)
        decoders = tiff_decoder_times(paths, name, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[tiffwebp] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, files_checked=checked,
                max_abs_err=worst, launches=launches, times=times,
                host_decoders_ms=decoders, seconds=seconds)


# ---------------------------------------------------------------- #
# Lossy WebP: the host entropy stage and kernels W1, W2, W3
# ---------------------------------------------------------------- #
WEBP_LOSSY_FRAME = "f08_clip_lossy.webp"     # the clip frame, PIL's q75
WEBP_LOSSY_REPS = 5
# W1 and W2 also run at these rows in flight (the plan's otherwise), each
# warp then taking several macroblock rows: the planes must not change
WEBP_FORCED_ROWS = (1, 2, 5)
WEBP_KERNELS = ("vp8_reconstruct", "vp8_filter", "vp8_colour")
# W1's and W2's integer operations per macroblock, W3's per output sample
# (counted from csrc/vp8_pixels.cu: the WHT and 24 inverse DCTs with their
# adds and clips, and the prediction of 384 samples; at most 8 luma and 6
# chroma edges of 16 and 8 lines of up to 40 operations; two chroma
# interpolations and the fixed-point colour of one sample)
W1_OPS_PER_MB, W2_OPS_PER_MB, W3_OPS_PER_PIXEL = 6000, 10000, 60


def vp8_bounds(f, channels=3):
    """W1, W2 and W3's least times on frame ``f`` (an io/vp8 Vp8Frame):
    each input read once and each output written once at the memory rate,
    or their integer operations at 67 TOP/s (J1's yardstick), whichever is
    longer; and the wavefront's critical path of W1 and W2 in dependent
    macroblock steps."""
    mbs = f.mb_w * f.mb_h
    planes = 384 * mbs
    out = f.width * f.height * channels
    work = {
        "vp8_reconstruct": (mbs * (800 + 20) + planes, mbs * W1_OPS_PER_MB),
        "vp8_filter": (mbs * 4 + 2 * planes,
                       mbs * W2_OPS_PER_MB if f.filter_type else 0),
        "vp8_colour": (f.width * f.height * 3 // 2 + out,
                       f.width * f.height * W3_OPS_PER_PIXEL)}
    bounds = {}
    for name, (nbytes, ops) in work.items():
        b_ms, o_ms = nbytes / MEM_BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
        bounds[name] = dict(bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                            bound_ms=max(b_ms, o_ms),
                            bound_by="bytes" if b_ms >= o_ms else "operations")
    steps = f.mb_w + 2 * (f.mb_h - 1)
    for name in WEBP_KERNELS[:2]:
        bounds[name]["critical_path_steps"] = steps
    return bounds


def vp8_stages(torch, payload):
    """A VP8 payload through the card's path stage by stage, each kernel
    against its twin on the same inputs (the twins as plain PyTorch on the
    card), W1 and W2 also at WEBP_FORCED_ROWS rows in flight, their planes
    equal to those at the plan's, W3 also at COLOUR_SWEEP rows a band.
    Returns (frame, planes after W2, the largest difference of any kernel
    from its twin, RGB, grey)."""
    import numpy as np
    from superviseddescent_tpu_torch.io.vp8 import decode_vp8
    from superviseddescent_tpu_torch.ops import webp as W
    f, coeffs, modes, filters = W.vp8_frame(payload, torch.device("cuda"))
    twin = decode_vp8(payload)
    check(all(np.array_equal(np.asarray(getattr(f, k)), getattr(twin, k))
              for k in ("coeffs", "modes", "filters"))
          and f.info == twin.info,
          "the C++ entropy stage differs from the Python twin")
    worst = 0

    def diff(a, b):
        return max(int((x.int() - y.int()).abs().max()) for x, y in zip(a, b))
    unfiltered = W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h)
    worst = max(worst, diff(unfiltered, W.reconstruct_reference(
        coeffs, modes, f.mb_w, f.mb_h)))
    want = W.filter_reference(*unfiltered, filters, f.filter_type, f.mb_w,
                              f.mb_h)
    planes = W.vp8_filter(*(p.clone() for p in unfiltered), filters,
                          f.filter_type, f.mb_w, f.mb_h)
    worst = max(worst, diff(planes, want))
    for rows in WEBP_FORCED_ROWS:
        again = W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h, grid=rows)
        check(all(torch.equal(a, b) for a, b in zip(again, unfiltered)),
              f"W1 at {rows} rows in flight differs from W1 at the plan's")
        again = W.vp8_filter(*again, filters, f.filter_type, f.mb_w, f.mb_h,
                             grid=rows)
        check(all(torch.equal(a, b) for a, b in zip(again, planes)),
              f"W2 at {rows} rows in flight differs from W2 at the plan's")
    out = {}
    for channels in (3, 1):
        out[channels] = W.vp8_colour(*planes, f.width, f.height, channels)
        want = W.colour_reference(*planes, f.width, f.height, channels)
        worst = max(worst, diff([out[channels]], [want]))
        for rows in COLOUR_SWEEP:
            worst = max(worst, diff([W.vp8_colour(
                *planes, f.width, f.height, channels, rows=rows)], [want]))
    return f, planes, worst, out[3], out[1]


def webp_lossy_fixtures(torch, manifest):
    """Every committed lossy fixture on the card: the C++ entropy stage
    against the Python twin, W1, W2 and W3 each bit-equal to its twin on
    the same inputs (W1 and W2 also at WEBP_FORCED_ROWS rows in flight,
    equal to the plan's; W3 also at COLOUR_SWEEP rows a band), the planes
    after W2 equal to libwebp's ``WebPDecodeYUV`` digests, the RGB and
    grey of ``read_rgb`` / ``read_gray`` (every stage on the card) equal
    to PIL's, and an ALPH chunk's alpha (through the C++ VP8L decoder)
    equal to PIL's. Returns (files, largest kernel-twin difference)."""
    import hashlib
    import numpy as np
    from superviseddescent_tpu_torch.io import webp
    from superviseddescent_tpu_torch.io.image import read_gray, read_rgb

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(
            a.cpu().numpy() if hasattr(a, "cpu") else a).tobytes()
        ).hexdigest()
    names = manifest["groups"]["webp_lossy"]
    worst = 0
    for name in names:
        want, path = manifest["files"][name], os.path.join(IMAGEIO_DIR, name)
        with open(path, "rb") as fh:
            data = fh.read()
        seen = []

        def lossy(payload):
            f, planes, err, rgb, grey = vp8_stages(torch, payload)
            seen.append((f, planes, err, grey))
            return rgb
        rgb = webp.compose(data, webp.decode_vp8l_native, lossy)
        check(len(seen) == 1, f"{name}: {len(seen)} lossy frames")
        f, planes, err, grey = seen[0]
        worst = max(worst, err)
        check(digest(rgb) == want["rgb_sha256"],
              f"{name}: the card's RGB differs from PIL's")
        if "yuv_sha256" in want:
            uh, uw = (f.height + 1) // 2, (f.width + 1) // 2
            got = [digest(planes[0][:f.height, :f.width]),
                   digest(planes[1][:uh, :uw]), digest(planes[2][:uh, :uw])]
            check(got == want["yuv_sha256"], f"{name}: W1 + W2's planes "
                  "differ from libwebp's WebPDecodeYUV")
            check(digest(grey) == want["grey_sha256"],
                  f"{name}: W3's grey differs from PIL's")
        if "alpha_sha256" in want:
            chunks = {c: body for c, body, _ in webp._chunks(data, 12,
                                                             len(data))}
            alpha = webp.decode_alpha(chunks[b"ALPH"], f.width, f.height,
                                      webp.decode_vp8l_native)
            check(digest(alpha) == want["alpha_sha256"],
                  f"{name}: the ALPH chunk's alpha differs from PIL's")
        for read, key in ((read_gray, "grey_sha256"), (read_rgb,
                                                       "rgb_sha256")):
            check(digest(read(path)) == want[key], f"{name}: the port's "
                  f"{key[:-7]} on the card differs from PIL's")
    check(worst == 0, f"W1-W3 differ from their twins by {worst}")
    log(f"[webp] {len(names)} lossy fixtures on the card: the C++ entropy "
        "stage equal to the Python twin, W1, W2 and W3 each equal to its "
        "twin, the planes to libwebp's WebPDecodeYUV, RGB and grey to PIL's, "
        f"ALPH to PIL's alpha; W1 and W2 at {WEBP_FORCED_ROWS} rows in "
        "flight (a warp taking several rows) equal to the plan's, W3 at "
        f"{COLOUR_SWEEP} rows a band equal to its twin")
    return len(names), worst


def webp_lossy_k3(torch, data, manifest, root):
    """The slice's main path: the lossy clip frame through
    ``load_gray_image`` on the card (the host entropy stage, then W1, W2,
    W3 once each) and ``make_fused_detector`` (K3) on the 4,096 faces'
    boxes over it; the rows equal those from a PNG of the same pixels.
    Counts from 0 before, read after. Returns (launches, paths)."""
    import hashlib
    import shutil
    import numpy as np
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    model = data["model"]
    det = model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    idx = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    paths = {"webp_lossy": os.path.join(root, WEBP_LOSSY_FRAME)}
    shutil.copy(os.path.join(IMAGEIO_DIR, WEBP_LOSSY_FRAME),
                paths["webp_lossy"])
    zero_counts()
    frame = load_gray_image(paths["webp_lossy"])
    rows = det(torch.from_numpy(frame.astype("uint8"))[None].cuda(),
               data["boxes"], image_indices=idx)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(launches, "the lossy WebP frame through load_gray_image "
                  "and K3", vp8_reconstruct=1, vp8_filter=1, vp8_colour=1,
                  cascade_fused_frames=1)
    check(hashlib.sha256(frame.astype("uint8").tobytes()).hexdigest()
          == manifest["files"][WEBP_LOSSY_FRAME]["grey_sha256"],
          "load_gray_image of the lossy frame differs from PIL's grey")
    paths["png"] = os.path.join(root, "webp_lossy.png")
    write_png(paths["png"], frame.astype(np.uint8))
    png_rows = det(torch.from_numpy(load_gray_image(paths["png"]).astype(
        "uint8"))[None].cuda(), data["boxes"], image_indices=idx)
    check(rows.shape == (BATCH, 2 * len(model.landmark_ids))
          and bool(torch.isfinite(rows).all()), "non-finite or misshapen "
          "rows from the lossy frame")
    check(torch.equal(rows, png_rows), "K3's rows from the lossy WebP frame "
          "differ from those from its pixels as PNG")
    paths["jpeg"] = os.path.join(JPEG_DIR, J2_TIME_FRAME)
    log(f"[webp] the lossy clip frame through load_gray_image (W1, W2, W3 "
        f"once each) and K3 on {BATCH} faces: rows equal to the PNG of the "
        f"same pixels; launches {launches}")
    return launches, paths


def webp_lossy_detect(torch, root):
    """rcr_detect -i <lossy frame>.webp -f -o out.png on the card (W1-W3
    twice: grey for the fit, RGB for the drawing) and on a PNG of the same
    RGB pixels: the same landmarks and the same drawn file."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.io.image import read_rgb
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    image = os.path.join(IMAGEIO_DIR, WEBP_LOSSY_FRAME)
    png = os.path.join(root, "lossy_rgb.png")
    write_png(png, read_rgb(image))
    runs = {}
    for kind, src in (("webp", image), ("png", png)):
        out = os.path.join(root, f"detect_{kind}.png")
        argv = ["-m", os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"),
                "-i", src, "-f", "-o", out, "--device", "cuda"]
        fits = []
        zero_counts()
        with recorded(DetectionModel, "detect", fits,
                      lambda a, lms: np.asarray(lms.coordinates)):
            rc, text, wall = run_app_main(rcr_detect, argv)
        torch.cuda.synchronize()
        n = 2 if kind == "webp" else 0
        expect_counts(read_counts(), f"rcr_detect -i {kind} -f -o",
                      vp8_reconstruct=n, vp8_filter=n, vp8_colour=n)
        check(rc == 0 and len(fits) == 1 and f"Wrote {out}" in text,
              f"rcr_detect -i {os.path.basename(src)}:\n{text[-400:]}")
        with open(out, "rb") as fh:
            runs[kind] = (fits[0], wall, fh.read())
    check(np.array_equal(runs["webp"][0], runs["png"][0])
          and runs["webp"][2] == runs["png"][2], "rcr_detect on the lossy "
          "WebP: landmarks or drawing differ from those of its pixels as PNG")
    log(f"[webp] rcr_detect -i {WEBP_LOSSY_FRAME} -f -o: "
        f"{runs['webp'][1] * 1e3:.1f} ms on the card (W1-W3 twice; "
        f"{runs['png'][1] * 1e3:.1f} ms from the PNG), the landmarks and "
        "the drawn PNG equal to those from the PNG of the same pixels")
    return dict(ms=runs["webp"][1] * 1e3, png_ms=runs["png"][1] * 1e3)


def webp_lossy_times(torch, paths):
    """On the 768 x 1024 lossy frame: the host entropy stage's ms (host
    clock, best of WEBP_LOSSY_REPS), W1, W2 and W3's device ms
    (torch.profiler) beside their twins' and their bounds, and
    ``load_gray_image`` ms for the lossy WebP, the PNG of its pixels and
    the JPEG it was written from, in turns."""
    from superviseddescent_tpu_torch.io.vp8 import decode_vp8_native
    from superviseddescent_tpu_torch.io.webp import _chunks
    from superviseddescent_tpu_torch.ops import webp as W
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    with open(paths["webp_lossy"], "rb") as fh:
        data = fh.read()
    payload = {c: body for c, body, _ in _chunks(data, 12, len(data))}[
        b"VP8 "]
    host = []
    for _ in range(WEBP_LOSSY_REPS):
        t0 = time.perf_counter()
        decode_vp8_native(payload, pinned=True)
        host.append((time.perf_counter() - t0) * 1e3)
    f, coeffs, modes, filters = W.vp8_frame(payload, torch.device("cuda"))
    planes = W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h)
    filtered = W.vp8_filter(*(p.clone() for p in planes), filters,
                            f.filter_type, f.mb_w, f.mb_h)
    calls = {
        "vp8_reconstruct": (
            lambda: W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h),
            lambda: W.reconstruct_reference(coeffs, modes, f.mb_w, f.mb_h)),
        "vp8_filter": (
            lambda: W.vp8_filter(*(p.clone() for p in planes), filters,
                                 f.filter_type, f.mb_w, f.mb_h),
            lambda: W.filter_reference(*planes, filters, f.filter_type,
                                       f.mb_w, f.mb_h)),
        "vp8_colour": (
            lambda: W.vp8_colour(*filtered, f.width, f.height, 3),
            lambda: W.colour_reference(*filtered, f.width, f.height, 3))}
    bounds = vp8_bounds(f)
    kernels = {}
    for name, (kernel, twin) in calls.items():
        ms = [device_ms(torch, kernel, reps=10, match=name)
              for _ in range(2)]
        # the twins of W1 and W2 run ~10^5 small operations a frame: one
        # rep, or the profiler's records take minutes to sum
        twin_ms = device_ms(torch, twin, reps=1 if name != "vp8_colour"
                            else 5, one_kernel=False)
        kernels[name] = dict(device_ms=ms, twin_device_ms=twin_ms,
                             **bounds[name])
    order = {k: paths[k] for k in ("webp_lossy", "png", "jpeg")}
    load_ms = {k: [] for k in order}
    for _ in range(WEBP_LOSSY_REPS):
        for kind, p in order.items():
            t0 = time.perf_counter()
            load_gray_image(p)
            load_ms[kind].append((time.perf_counter() - t0) * 1e3)
    log(f"[webp] host entropy stage on the {f.width} x {f.height} lossy "
        f"frame ({f.mb_w * f.mb_h} macroblocks): {min(host):.3f} ms (host "
        f"clock, best of {WEBP_LOSSY_REPS})")
    for name, t in kernels.items():
        extra = (f", critical path {t['critical_path_steps']} macroblock "
                 "steps" if "critical_path_steps" in t else "")
        log(f"[webp] {name}: " + " / ".join(f"{v:.5f}" for v in
                                            t["device_ms"])
            + f" ms (device, torch.profiler), bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} ops){extra}, "
            f"twin {t['twin_device_ms']:.4f} ms device")
    log("[webp] load_gray_image of the 768 x 1024 frame, ms (host clock, "
        f"best of {WEBP_LOSSY_REPS}, in turns): " + ", ".join(
            f"{k} {min(v):.2f}" for k, v in load_ms.items()))
    return dict(host_entropy_ms=host, kernels=kernels, load_gray_ms=load_ms,
                frame=dict(width=f.width, height=f.height, mb_w=f.mb_w,
                           mb_h=f.mb_h, filter_type=f.filter_type))


# measurement builds of W1's and W2's source for ``webp_times``, never
# entry points: the wavefront with each macroblock's work removed (waits and
# publishes only), and the work with no waits and no publishes, every row
# at once (its planes are wrong; it is timed only)
WEBP_BUILDS = (("handoff_only", "VP8_HANDOFF_ONLY"),
               ("work_only", "VP8_WORK_ONLY"))
WEBP_TIME_REPS = 10
# W3's: the global stores behind a test that never passes (loads and
# arithmetic only), values made from the coordinates stored with no loads,
# and an empty kernel on the same grid (the launch floor)
COLOUR_BUILDS = (("no_store", "VP8_COLOUR_NO_STORE"),
                 ("no_load", "VP8_COLOUR_NO_LOAD"),
                 ("empty", "VP8_COLOUR_EMPTY"))
COLOUR_TIME_REPS = 20
# W3 at these rows a band beside the plan's (every fixture; ``--webp
# --sweep`` times them)
COLOUR_SWEEP = (2, 4, 8, 16, 32)
# W1 and W2 at these rows a CTA beside the plan's (``--webp --sweep``)
WEBP_SWEEP = (1, 2, 4, 8, 16)
# ... and at these rows in flight (the plan's: every row)
WEBP_IN_FLIGHT = (12, 24, 32, 48)
# csrc/vp8_pixels.cu of commit ceed2b4 (a CTA a macroblock row; this
# sha256) gains WEBP_BUILDS' defines through these lines, inserted after the
# original's line n (a normal diff, "nam,k" then the lines): ``webp_compare``
# times such a checkout through a copy of its package with them in
VP8_CTA_ROWS_SHA256 = ("7e2e565e3077bc0afc7a8c246ee2844165294feebcbf5d0d38b337"
                   "5562875ef8")
VP8_CTA_ROWS_SPLIT = """\
288a289
> #ifndef VP8_WORK_ONLY
289a291,292
> #endif
> #ifndef VP8_HANDOFF_ONLY
380a384,385
> #endif
> #ifndef VP8_WORK_ONLY
381a387,389
> #else
>       __syncthreads();
> #endif
474a483
> #ifndef VP8_WORK_ONLY
475a485,486
> #endif
> #ifndef VP8_HANDOFF_ONLY
493a505,506
> #endif
> #ifndef VP8_WORK_ONLY
494a508,510
> #else
>       __syncthreads();
> #endif
"""
# ... and that of commit eeb94ea (a warp a macroblock row; W3 a thread an
# output sample) gains COLOUR_BUILDS' defines through these
VP8_WARP_ROWS_SHA256 = ("ad62b694d117f73d964b9d360c0e4a529a156a9b5248cff357a5"
                        "96233a81743c")
VP8_WARP_ROWS_SPLIT = """\
1018a1019,1021
> #ifdef VP8_COLOUR_EMPTY
>   return;
> #endif
1021a1025,1034
> #ifdef VP8_COLOUR_NO_LOAD
>   if (channels == 1) {
>     out[i] = (uint8_t)(x + y);
>   } else {
>     out[3 * i + 0] = (uint8_t)x;
>     out[3 * i + 1] = (uint8_t)y;
>     out[3 * i + 2] = (uint8_t)(x + y);
>   }
>   return;
> #endif
1043a1057,1059
> #ifdef VP8_COLOUR_NO_STORE
>   if (width > 0) return;  // always: built, never run
> #endif
"""
SPLIT_PATCHES = {VP8_CTA_ROWS_SHA256: VP8_CTA_ROWS_SPLIT,
                 VP8_WARP_ROWS_SHA256: VP8_WARP_ROWS_SPLIT}
# the clip frame's macroblocks repeated side by side, a frame this many
# times as wide (7,680 x 1,024 pixels, ten times the widest fixture), W1
# and W2 also at WEBP_WIDE_PER_CTA rows a CTA (the most, one CTA's 1,024
# threads in W1)
WEBP_WIDE_COPIES = 10
WEBP_WIDE_PER_CTA = 16


def webp_time_inputs(torch):
    """WEBP_LOSSY_FRAME's VP8 frame on the card: (frame, coefficients,
    modes, filter bytes, W1's planes)."""
    from superviseddescent_tpu_torch.io.webp import _chunks
    from superviseddescent_tpu_torch.ops import webp as W
    with open(os.path.join(IMAGEIO_DIR, WEBP_LOSSY_FRAME), "rb") as fh:
        data = fh.read()
    payload = {c: body for c, body, _ in _chunks(data, 12, len(data))}[
        b"VP8 "]
    f, coeffs, modes, filters = W.vp8_frame(payload, torch.device("cuda"))
    planes = W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h)
    torch.cuda.synchronize()
    return f, coeffs, modes, filters, planes


def colour_times(torch, W, planes, f, source):
    """W3's device ms (torch.profiler) on WEBP_LOSSY_FRAME's filtered
    ``planes`` through the entry point of the package ``W``, RGB and grey,
    warm (each launch straight after the last, as after W2) and with the L2
    flushed before each launch, in the plain build ("whole") and in each of
    COLOUR_BUILDS that ``source`` has (``load_library`` made to hand the
    entry point that build); with the package's plan where it has one."""
    from superviseddescent_tpu_torch.ops import _build
    load = _build.load_library
    flush = l2_flusher(torch)
    out = {"rgb": {"warm": {}, "flushed": {}},
           "grey": {"warm": {}, "flushed": {}}}
    if hasattr(W, "vp8_colour_plan"):
        out["plan"] = W.vp8_colour_plan(
            f.width, f.height, W._sm_count(planes[0].device))._asdict()
    try:
        for build, define in (("whole", None),) + COLOUR_BUILDS:
            if define and define not in source:  # a source without it
                continue
            _build.load_library = load if define is None else (
                lambda name, defines=(), d=define: load(
                    name, (d,) if name == "vp8_pixels" else defines))
            for label, channels in (("rgb", 3), ("grey", 1)):
                def call():
                    return W.vp8_colour(*planes, f.width, f.height, channels)
                for heat, before in (("warm", None), ("flushed", flush)):
                    out[label][heat][build] = device_ms(
                        torch, call, reps=COLOUR_TIME_REPS,
                        match="vp8_colour", before=before)
    finally:
        _build.load_library = load
    return out


def webp_times(torch):
    """Device ms (torch.profiler) of W1 and W2 on WEBP_LOSSY_FRAME, from
    ``vp8_pixels`` of the package on ``sys.path`` launched as its entry
    points launch it (at ``vp8_launch_plan``'s plan where the package has
    one), in the plain build ("whole") and in each of WEBP_BUILDS that its
    source has (``load_library``'s defines, as J1's and J2's split); and
    W3's (``colour_times``) on W2's planes."""
    from superviseddescent_tpu_torch.ops import webp as W
    from superviseddescent_tpu_torch.ops._build import CSRC, load_library
    f, coeffs, modes, filters, planes = webp_time_inputs(torch)
    out = {"frame": dict(mb_w=f.mb_w, mb_h=f.mb_h,
                         steps=f.mb_w + 2 * (f.mb_h - 1))}
    extent = (0,)   # an older launcher's grid: every row
    if hasattr(W, "vp8_launch_plan"):
        plan = W.vp8_launch_plan(f.mb_w, f.mb_h,
                                 sms=W._sm_count(coeffs.device))
        extent = (plan.rows, plan.ctas)
        out["plan"] = {name: plan._asdict() for name in WEBP_KERNELS[:2]}
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def ptrs(*ts):
        return [ctypes.c_void_p(t.data_ptr()) for t in ts]

    def launch(lib, name):
        def call():
            progress = torch.zeros(f.mb_h, dtype=torch.int32, device="cuda")
            if name == "vp8_reconstruct":
                err = lib.vp8_reconstruct_launch(
                    *ptrs(coeffs, modes, *(torch.empty_like(p)
                                           for p in planes), progress),
                    f.mb_w, f.mb_h, *extent, stream)
            else:
                err = lib.vp8_filter_launch(
                    *ptrs(*(p.clone() for p in planes), filters, progress),
                    f.mb_w, f.mb_h, f.filter_type, *extent, stream)
            check(err == 0, f"{name}'s launch failed: CUDA error {err}")
        return call
    source = (CSRC / "vp8_pixels.cu").read_text()
    for name in WEBP_KERNELS[:2]:
        out[name] = {}
        for build, define in (("whole", None),) + WEBP_BUILDS:
            if define and define not in source:  # a source without the build
                continue
            lib = load_library("vp8_pixels", (define,) if define else ())
            out[name][build] = device_ms(torch, launch(lib, name),
                                         reps=WEBP_TIME_REPS, match=name)
    filtered = W.vp8_filter(*(p.clone() for p in planes), filters,
                            f.filter_type, f.mb_w, f.mb_h)
    out["vp8_colour"] = colour_times(torch, W, filtered, f, source)
    return out


def webp_sweep(torch):
    """This checkout's W1 and W2 on WEBP_LOSSY_FRAME through their entry
    points at WEBP_SWEEP rows a CTA (their planes equal to the plan's) and
    at WEBP_IN_FLIGHT rows in flight, and W3 at COLOUR_SWEEP rows a band
    (RGB and grey equal to the twin): device ms."""
    from superviseddescent_tpu_torch.ops import webp as W
    f, coeffs, modes, filters, planes = webp_time_inputs(torch)

    def w1(rows=0):
        return W.vp8_reconstruct(coeffs, modes, f.mb_w, f.mb_h, grid=rows)

    def w2(rows=0):
        return W.vp8_filter(*(p.clone() for p in planes), filters,
                            f.filter_type, f.mb_w, f.mb_h, grid=rows)
    calls = {"vp8_reconstruct": w1, "vp8_filter": w2}
    want = {name: call() for name, call in calls.items()}
    default = W.ROWS_PER_CTA
    out = {"rows_a_cta": {}, "in_flight": {}}
    try:
        for rows in WEBP_SWEEP:
            W.ROWS_PER_CTA = rows
            row = out["rows_a_cta"][rows] = {}
            for name, call in calls.items():
                check(all(torch.equal(a, b) for a, b in zip(
                    call(), want[name])), f"{name} at {rows} rows a CTA "
                      "differs from the plan's")
                row[name] = device_ms(torch, call, reps=WEBP_TIME_REPS,
                                      match=name)
            log(f"[webp] sweep {rows} rows a CTA: " + ", ".join(
                f"{name} {ms:.5f} ms" for name, ms in row.items())
                + " (device), planes equal to the plan's")
    finally:
        W.ROWS_PER_CTA = default
    for rows in WEBP_IN_FLIGHT:
        out["in_flight"][rows] = {
            name: device_ms(torch, lambda: call(rows), reps=WEBP_TIME_REPS,
                            match=name) for name, call in calls.items()}
    filtered = want["vp8_filter"]
    out["colour_rows"] = {}
    for rows in COLOUR_SWEEP:
        row = out["colour_rows"][rows] = {}
        for label, channels in (("rgb", 3), ("grey", 1)):
            def w3():
                return W.vp8_colour(*filtered, f.width, f.height, channels,
                                    rows=rows)
            check(torch.equal(w3(), W.colour_reference(
                *filtered, f.width, f.height, channels)),
                  f"W3 at {rows} rows a band differs from its twin")
            row[label] = device_ms(torch, w3, reps=COLOUR_TIME_REPS,
                                   match="vp8_colour")
        log(f"[webp] sweep W3 at {rows} rows a band "
            f"({-(-f.height // rows)} CTAs): RGB {row['rgb']:.5f} ms, grey "
            f"{row['grey']:.5f} ms (device), equal to the twin")
    return out


def webp_split(times):
    """The split of ``webp_times``' W1 and W2: us a step of the wavefront
    alone (hand-off only over the critical path's steps), us a macroblock
    of the work alone (work only over the macroblocks of a warp's rows, all
    in flight) and the critical-path bound (the steps times the hand-off
    step), where the source has those builds; W3's builds as
    ``colour_times`` timed them."""
    steps = times["frame"]["steps"]
    mbs = times["frame"]["mb_w"] * times["frame"]["mb_h"]
    out = {}
    for name in WEBP_KERNELS[:2]:
        plan = times.get("plan", {}).get(name)
        in_flight = (plan["rows"] * plan["ctas"] if plan
                     else times["frame"]["mb_h"])
        per_warp = -(-mbs // min(in_flight, times["frame"]["mb_h"]))
        t = times[name]
        out[name] = dict(whole_ms=t["whole"], step_us=t["whole"] / steps * 1e3)
        if "handoff_only" in t:
            step_us = t["handoff_only"] / steps * 1e3
            out[name].update(
                handoff_only_ms=t["handoff_only"], work_only_ms=t["work_only"],
                handoff_step_us=step_us,
                work_mb_us=t["work_only"] / per_warp * 1e3,
                critical_path_bound_ms=steps * step_us / 1e3)
    if "vp8_colour" in times:   # W3: whole and each build, as timed
        out["vp8_colour"] = {k: v for k, v in times["vp8_colour"].items()
                             if k != "plan"}
    return out


def with_split_builds(root, tmp, source="vp8_pixels.cu"):
    """``root``, or, where its ``source`` is one of SPLIT_PATCHES' (by
    sha256: vp8_pixels.cu of commit ceed2b4 or eeb94ea, j2k_pixels.cu of
    442eb6c), a copy of its package under ``tmp`` with that patch's lines
    in."""
    import hashlib
    import shutil
    package = os.path.join(root, "superviseddescent_tpu_torch")
    with open(os.path.join(package, "csrc", source), "rb") as fh:
        text = fh.read()
    patch = SPLIT_PATCHES.get(hashlib.sha256(text).hexdigest())
    if patch is None:
        return root
    lines = text.decode().split("\n")
    inserts = []
    for line in patch.splitlines():
        if line.startswith("> "):
            inserts[-1][1].append(line[2:])
        else:
            inserts.append((int(line.split("a")[0]), []))
    for after, new in reversed(inserts):
        lines[after:after] = new
    copy = os.path.join(tmp, "superviseddescent_tpu_torch")
    shutil.copytree(package, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(copy, "csrc", source), "w") as fh:
        fh.write("\n".join(lines))
    return tmp


def webp_compare(torch, root):
    """``--webp``: ``webp_times`` of this checkout's package and, with
    another checkout's (``root``; commit ceed2b4's or eeb94ea's through
    ``with_split_builds``), of that package (``other_runs``); W1, W2 and W3
    whole and split side by side (a split only where the package's source
    has the measurement builds)."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_split_")
    try:
        runs = other_runs(with_split_builds(root, tmp) if root != REPO
                          else root, lambda: webp_times(torch),
                          ["--webp-times"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    splits = {who: [webp_split(r) for r in rs] for who, rs in runs.items()}
    for name in WEBP_KERNELS[:2]:
        def text(who):
            return " / ".join(
                f"{sp[name]['whole_ms']:.5f} ms" + (
                    f" (hand-off only {sp[name]['handoff_only_ms']:.5f}: "
                    f"{sp[name]['handoff_step_us']:.3f} us a step; work only "
                    f"{sp[name]['work_only_ms']:.5f}: "
                    f"{sp[name]['work_mb_us']:.3f} us a macroblock)"
                    if "handoff_only_ms" in sp[name] else "")
                for sp in splits[who])
        line = f"[webp] {name} on {WEBP_LOSSY_FRAME}: this tree {text('this')}"
        if splits["other"]:
            ratio = (min(sp[name]["whole_ms"] for sp in splits["other"])
                     / max(sp[name]["whole_ms"] for sp in splits["this"]))
            line += f" | other {text('other')} (x{ratio:.2f})"
        log(line + " (device, torch.profiler)")
    for label in ("rgb", "grey"):
        for heat in ("warm", "flushed"):
            def w3(who):
                return " / ".join(", ".join(
                    f"{build} {ms:.5f}" for build, ms in
                    sp["vp8_colour"][label][heat].items())
                    for sp in splits[who])
            line = (f"[webp] vp8_colour {label} {heat} on {WEBP_LOSSY_FRAME}"
                    f": this tree {w3('this')} ms")
            if splits["other"]:
                ratio = (min(sp["vp8_colour"][label][heat]["whole"]
                             for sp in splits["other"])
                         / max(sp["vp8_colour"][label][heat]["whole"]
                               for sp in splits["this"]))
                line += f" | other {w3('other')} ms (x{ratio:.2f})"
            log(line + " (device, torch.profiler)")
    return dict(this=runs["this"], other=runs["other"], split=splits,
                package_root=root)


def webp_wide_frame(torch):
    """W1 and W2 on the clip frame's coefficients, modes and filter bytes
    repeated WEBP_WIDE_COPIES times side by side, each bit-equal to its
    twin at the plan's rows in flight, at WEBP_FORCED_ROWS and at
    WEBP_WIDE_PER_CTA rows a CTA."""
    from superviseddescent_tpu_torch.ops import webp as W
    f, coeffs, modes, filters, _ = webp_time_inputs(torch)
    n, mb_h = WEBP_WIDE_COPIES, f.mb_h
    mb_w = n * f.mb_w

    def wide(t):
        rows = t.reshape(mb_h, f.mb_w, -1).repeat(1, n, 1)
        return rows.reshape(mb_w * mb_h, *t.shape[1:]).contiguous()
    coeffs, modes, filters = wide(coeffs), wide(modes), wide(filters)
    unfiltered = W.reconstruct_reference(coeffs, modes, mb_w, mb_h)
    filtered = W.filter_reference(*unfiltered, filters, f.filter_type, mb_w,
                                  mb_h)
    default = W.ROWS_PER_CTA
    cases = ([(default, 0)] + [(default, r) for r in WEBP_FORCED_ROWS]
             + [(WEBP_WIDE_PER_CTA, 0)])
    try:
        for per_cta, rows in cases:
            W.ROWS_PER_CTA = per_cta
            what = f"{per_cta} rows a CTA, {rows or 'every'} rows in flight"
            got = W.vp8_reconstruct(coeffs, modes, mb_w, mb_h, grid=rows)
            check(all(torch.equal(a, b) for a, b in zip(got, unfiltered)),
                  f"W1 on the wide frame at {what} differs from its twin")
            got = W.vp8_filter(*got, filters, f.filter_type, mb_w, mb_h,
                               grid=rows)
            check(all(torch.equal(a, b) for a, b in zip(got, filtered)),
                  f"W2 on the wide frame at {what} differs from its twin")
    finally:
        W.ROWS_PER_CTA = default
    log(f"[webp] W1 and W2 on a {16 * mb_w} x {16 * mb_h} frame (the clip "
        f"frame's macroblocks {n} times side by side) equal to their twins "
        f"at (rows a CTA, rows in flight; 0 every row) {cases}")
    return dict(mb_w=mb_w, mb_h=mb_h, cases=cases)


def webp_lossy_entries(webp):
    """The kernels line's entries of W1, W2 and W3: device ms on the 768 x
    1024 lossy frame, launches of the main path's run; W1 and W2 with their
    split (``webp_split``), the critical-path bound and the plan; W3 with
    its split (RGB and grey, warm and flushed) and its plan."""
    out = []
    compare = webp["compare"]
    for name in WEBP_KERNELS:
        source, replaces = SOURCES[name]
        t = webp["times"]["kernels"][name]
        extra = {}
        if "critical_path_steps" in t:
            split = compare["split"]["this"][0][name]
            extra = dict(critical_path_steps=t["critical_path_steps"],
                         critical_path_bound_ms=split[
                             "critical_path_bound_ms"],
                         split=split, plan=compare["this"][0]["plan"][name])
            if compare["other"]:
                extra["other_package_ms"] = [
                    sp[name]["whole_ms"] for sp in compare["split"]["other"]]
        else:   # W3: its plan and its split on the same frame
            extra = dict(plan=compare["this"][0]["vp8_colour"].get("plan"),
                         split=compare["split"]["this"][0][name])
            if compare["other"]:
                extra["other_package_ms"] = [
                    sp[name]["rgb"]["warm"]["whole"]
                    for sp in compare["split"]["other"]]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            replaces_note="no pallas_call: the JAX package reads images with "
            "PIL on the host; W1-W3 are hand kernels of the io slice",
            launches=webp["launches"][name], max_abs_err=webp["max_abs_err"],
            ms=min(t["device_ms"]), plain_ms=t["twin_device_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            ms_source="torch.profiler", **extra))
    return out


def phase_webp_lossy(torch, data, name, smi, root=REPO, sweep=False):
    """Lossy WebP on the card: every committed lossy fixture through the
    C++ entropy stage and W1-W3 (each kernel against its twin, the planes
    against libwebp's, the pixels against PIL's), the lossy clip frame
    through load_gray_image and K3 (rows equal to its PNG's), rcr_detect
    -i on it, W1 and W2 on a wide frame (``webp_wide_frame``), and the
    times: ``webp_lossy_times``, and ``webp_compare``'s W1 and W2 with
    their split, beside the package of checkout ``root`` where it is
    another; with ``sweep`` ``webp_sweep``."""
    import shutil
    import tempfile
    with open(os.path.join(IMAGEIO_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_webp_")
    try:
        checked, worst = webp_lossy_fixtures(torch, manifest)
        launches, paths = webp_lossy_k3(torch, data, manifest, tmp)
        detect = webp_lossy_detect(torch, tmp)
        times = webp_lossy_times(torch, paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    wide = webp_wide_frame(torch)
    compare = webp_compare(torch, root)
    if sweep:
        compare["sweep"] = webp_sweep(torch)
    seconds = time.perf_counter() - t0
    log(f"[webp] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, files_checked=checked,
                max_abs_err=worst, launches=launches, detect=detect,
                wide_frame=wide, times=times, compare=compare,
                seconds=seconds)


# ---------------------------------------------------------------- #
# JPEG 2000 reading: the host stage, D1 and M1
# ---------------------------------------------------------------- #
J2K_DIR = os.path.join(REPO, "tests", "torch_j2k")
J2K_FRAME_97 = "f01_clip_97_rpcl.jp2"     # the clip frame, 9/7, RPCL
J2K_FRAME_53 = "f02_clip_53_tiles.jp2"    # the clip frame, 5/3, 12 tiles
# D1 and M1 against their twins on the card: both 768 x 1024 frames and
# the small tiled files with odd origins and subsampling
J2K_TWIN_FILES = (J2K_FRAME_97, J2K_FRAME_53, "k39_odd_tiles_97.j2k",
                  "k16_tiles_offset_97.jp2", "o24_subsampled_offset.j2k",
                  "e06_sycc.jp2", "k09_cmyk.jp2")
J2K_KERNELS = ("j2k_idwt", "j2k_colour")
J2K_REPS = 5
# rcr_detect's landmarks on the 9/7 frame against the JAX app's in the
# manifest (its CPU run): the card's and the CPU's float rounding, twice
# the apps phase's tolerance of the card against the port's CPU path
J2K_DETECT_PX = 2 * APP_DETECT_PX
# integer or float operations a sample of one D1 pass (5/3: two lifting
# steps of three operations over half the samples each, the load's
# interleave; 9/7: the scaling and four steps of three), of M1 a pixel a
# channel (the tile, the unpacker's index and component, the component
# transform, the shift and clamp, Pillow's shift, the colour)
J2K_D1_OPS_PER_SAMPLE = {1: 4, 0: 7}
J2K_M1_OPS_PER_PIXEL = 48


# measurement builds of D1's and M1's source for ``j2k_kernel_times``, never
# entry points: D1 staging and writing back with no lifting step, M1 with
# its stores behind a test that never passes, and both kernels returning
# at once on the same grids (the launch floor)
J2K_BUILDS = (("no_lift", "J2K_IDWT_NO_LIFT", ("j2k_idwt",)),
              ("no_store", "J2K_COLOUR_NO_STORE", ("j2k_colour",)),
              ("empty", "J2K_EMPTY", ("j2k_idwt", "j2k_colour")))
J2K_TIME_REPS = 20
# csrc/j2k_pixels.cu of commit 442eb6c (D1 a CTA a line, two launches a
# level; M1 a thread a pixel; this sha256) gains J2K_BUILDS' defines
# through these lines, inserted after the original's line n
J2K_LINE_A_CTA_SHA256 = ("ac3f231954123a84a7aa49441323527c08f20184f69719336b"
                         "6c1ac3eb1ed61c")
J2K_LINE_A_CTA_SPLIT = """\
50a51,53
> #ifdef J2K_EMPTY
>   return;
> #endif
73a77
> #ifndef J2K_IDWT_NO_LIFT
100a105
> #endif
164a170,172
> #ifdef J2K_EMPTY
>   return;
> #endif
248a257,259
> #ifdef J2K_COLOUR_NO_STORE
>   if (P.W > 0) return;  // always: built, never run
> #endif
"""
SPLIT_PATCHES[J2K_LINE_A_CTA_SHA256] = J2K_LINE_A_CTA_SPLIT


def j2k_frame(name):
    """(J2kFile, J2kFrame from the host C++ stage in pinned memory)."""
    from superviseddescent_tpu_torch.io import jp2 as J
    from superviseddescent_tpu_torch.ops import j2k as O
    with open(os.path.join(J2K_DIR, name), "rb") as fh:
        f = J.read_file(fh.read())
    return f, O.decode_native(f.codestream, pinned=True)


def j2k_bounds(frame, channels=3):
    """D1's and M1's least times on ``frame``: D1 reads and writes every
    coefficient once (the whole transform, all levels), M1 reads every
    coefficient once and writes the pixels; or their operations at 67
    TOP/s, whichever is longer."""
    from superviseddescent_tpu_torch.ops import j2k as O
    n = int(frame.coeffs.numel())
    ops = 0
    for level in range(int(frame.tcs[:, O.TC_LEVELS].max(initial=0))):
        for job in O.idwt_jobs(frame.tcs, level).tolist():
            ops += 2 * job[2] * job[3] * J2K_D1_OPS_PER_SAMPLE[job[8]]
    pixels = frame.width * frame.height
    work = {"j2k_idwt": (8 * n, ops),
            "j2k_colour": (4 * n + pixels * channels,
                           pixels * channels * J2K_M1_OPS_PER_PIXEL)}
    bounds = {}
    for name, (nbytes, nops) in work.items():
        b_ms, o_ms = nbytes / MEM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
        bounds[name] = dict(bytes=nbytes, ops=nops, bytes_ms=b_ms,
                            ops_ms=o_ms, bound_ms=max(b_ms, o_ms),
                            bound_by="bytes" if b_ms >= o_ms
                            else "operations")
    return bounds


def j2k_readers(torch, manifest):
    """Every committed fixture through the card's path (the host C++
    stage, D1, M1) in RGB and grey, to PIL's digests; each read launches
    D1 exactly its plan's count (``idwt_plan``), M1 once and nothing else;
    both of M1's paths (common, general) are taken; what PIL cannot read
    is refused. Returns (read, refused, M1's launches by path)."""
    from superviseddescent_tpu_torch.ops import j2k as O
    read = refused = 0
    O.j2k_colour.paths = dict.fromkeys(O.j2k_colour.paths, 0)
    for name, e in sorted(manifest["files"].items()):
        with open(os.path.join(J2K_DIR, name), "rb") as fh:
            data = fh.read()
        if "pil_error" in e:
            try:
                O.read_j2k(data, 3, "cuda")
            except ValueError:
                refused += 1
                continue
            raise SmokeFailure(f"{name}: PIL cannot read it, the port did")
        planned = len(O.idwt_plan(j2k_frame(name)[1].tcs).launches)
        for channels, key in ((3, "rgb_sha256"), (1, "grey_sha256")):
            zero_counts()
            px = O.read_j2k(data, channels, "cuda")
            torch.cuda.synchronize()
            expect_counts(read_counts(), f"{name}: a read",
                          j2k_idwt=planned, j2k_colour=1)
            check(px.is_cuda and sha256_of(px) == e[key], f"{name}: the "
                  f"card's {'RGB' if channels == 3 else 'grey'} differs "
                  "from PIL's")
        read += 1
    taken = dict(O.j2k_colour.paths)
    check(all(n > 0 for n in taken.values()),
          f"a path of M1 was never taken: {taken}")
    log(f"[j2k] {read} fixtures read on the card (host C++ stage, D1, M1) "
        f"to PIL's RGB and grey digests, D1 exactly its plan's launches and "
        f"M1 once a read; M1's launches by path {taken}; {refused} that PIL "
        "cannot read refused")
    return read, refused, taken


def j2k_twins(torch):
    """D1 and M1 against their twins (plain PyTorch on the card) on
    J2K_TWIN_FILES, and the host C++ stage against its Python twin on
    the two frames; returns the largest difference."""
    from superviseddescent_tpu_torch.ops import j2k as O
    worst = 0
    for name in J2K_TWIN_FILES:
        f, frame = j2k_frame(name)
        plan = O.colour_plan(f, frame)
        coeffs = frame.coeffs.to("cuda")
        card = O.j2k_idwt(coeffs.clone(), frame.tcs)
        twin = O.idwt_reference(coeffs, frame.tcs)
        ints = (card.long() - twin.long()).abs()
        fl = (card.view(torch.float32) - twin.view(torch.float32)).abs()
        check(torch.equal(card, twin), f"D1 differs from its twin on {name}"
              f" (int {int(ints.max())}, float {float(fl.max())})")
        for channels in (3, 1):
            px = O.j2k_colour(card, frame, plan, channels)
            want = O.colour_reference(twin, frame, plan, channels)
            d = int((px.int() - want.int()).abs().max())
            worst = max(worst, d)
            check(d == 0, f"M1 differs from its twin on {name} by {d}")
        if name in (J2K_FRAME_97, J2K_FRAME_53):
            py = O.decode_python(f.codestream)
            check(torch.equal(py.coeffs, frame.coeffs.cpu())
                  and (py.tcs == frame.tcs).all(), f"the host C++ stage "
                  f"differs from its Python twin on {name}")
    log(f"[j2k] D1 and M1 equal to their twins on {len(J2K_TWIN_FILES)} "
        "files (both 768 x 1024 frames among them); the host C++ stage "
        "equal to its Python twin on both frames")
    return worst


def j2k_k3(torch, data, manifest, root):
    """The slice's main path: the 9/7 clip frame through
    ``load_gray_image`` on the card (the host C++ stage, D1 in its plan's
    launches, M1 once) and ``make_fused_detector`` (K3) on the 4,096 faces' boxes
    over it; the rows equal those from a PNG of the same pixels. Counts
    from 0 before, read after. Returns (launches, paths)."""
    import shutil
    import numpy as np
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    model = data["model"]
    det = model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    idx = torch.zeros(BATCH, dtype=torch.int32, device="cuda")
    from superviseddescent_tpu_torch.ops.j2k import idwt_plan
    paths = {"j2k": os.path.join(root, J2K_FRAME_97)}
    shutil.copy(os.path.join(J2K_DIR, J2K_FRAME_97), paths["j2k"])
    planned = len(idwt_plan(j2k_frame(J2K_FRAME_97)[1].tcs).launches)
    zero_counts()
    frame = load_gray_image(paths["j2k"])
    rows = det(torch.from_numpy(frame.astype("uint8"))[None].cuda(),
               data["boxes"], image_indices=idx)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts(launches, "the 9/7 JP2 frame through load_gray_image and "
                  "K3", j2k_idwt=planned, j2k_colour=1,
                  cascade_fused_frames=1)
    check(sha256_of(torch.from_numpy(frame.astype(np.uint8)))
          == manifest["files"][J2K_FRAME_97]["grey_sha256"],
          "load_gray_image of the JP2 frame differs from PIL's grey")
    paths["png"] = os.path.join(root, "j2k_frame.png")
    write_png(paths["png"], frame.astype(np.uint8))
    png_rows = det(torch.from_numpy(load_gray_image(paths["png"]).astype(
        "uint8"))[None].cuda(), data["boxes"], image_indices=idx)
    check(rows.shape == (BATCH, 2 * len(model.landmark_ids))
          and bool(torch.isfinite(rows).all()), "non-finite or misshapen "
          "rows from the JP2 frame")
    check(torch.equal(rows, png_rows), "K3's rows from the JP2 frame differ "
          "from those from its pixels as PNG")
    paths["jpeg"] = os.path.join(JPEG_DIR, J2_TIME_FRAME)
    log(f"[j2k] the 9/7 clip frame through load_gray_image (D1 x "
        f"{planned}, M1 once) and K3 on {BATCH} faces: rows equal to "
        f"the PNG of the same pixels; launches {launches}")
    return launches, paths


def j2k_detect(torch, manifest, root):
    """rcr_detect -i <9/7 frame>.jp2 --facebox -o out.png on the card (D1
    and M1 for the grey and for the RGB) and on a PNG of the same RGB
    pixels: the same landmarks and drawn file, the landmarks within
    J2K_DETECT_PX of the JAX app's (the manifest's ``clip_detect``)."""
    import numpy as np
    from superviseddescent_tpu_torch.apps import rcr_detect
    from superviseddescent_tpu_torch.io.image import read_rgb
    from superviseddescent_tpu_torch.io.png import write_png
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    want = manifest["clip_detect"]
    from superviseddescent_tpu_torch.ops.j2k import idwt_plan
    image = os.path.join(J2K_DIR, J2K_FRAME_97)
    planned = len(idwt_plan(j2k_frame(J2K_FRAME_97)[1].tcs).launches)
    png = os.path.join(root, "j2k_rgb.png")
    write_png(png, read_rgb(image))
    box = ",".join(repr(v) for v in want["facebox"])
    runs = {}
    for kind, src in (("j2k", image), ("png", png)):
        out = os.path.join(root, f"detect_{kind}.png")
        argv = ["-m", os.path.join(REPO, "pretrained", "rcr22_lfpw5.bin"),
                "-i", src, "--facebox", box, "-o", out, "--device", "cuda"]
        fits = []
        zero_counts()
        with recorded(DetectionModel, "detect", fits,
                      lambda a, lms: np.asarray(lms.coordinates)):
            rc, text, wall = run_app_main(rcr_detect, argv)
        torch.cuda.synchronize()
        n = 2 if kind == "j2k" else 0
        expect_counts(read_counts(), f"rcr_detect -i {kind} --facebox -o",
                      j2k_idwt=n * planned, j2k_colour=n)
        check(rc == 0 and len(fits) == 1 and f"Wrote {out}" in text,
              f"rcr_detect -i {os.path.basename(src)}:\n{text[-400:]}")
        with open(out, "rb") as fh:
            runs[kind] = (fits[0], wall, fh.read())
    got = runs["j2k"][0]
    delta = float(np.abs(got - np.asarray(want["landmarks"])).max())
    check(np.array_equal(got, runs["png"][0])
          and runs["j2k"][2] == runs["png"][2], "rcr_detect on the JP2: "
          "landmarks or drawing differ from those of its pixels as PNG")
    check(delta <= J2K_DETECT_PX, f"rcr_detect on the JP2: {delta} px from "
          "the JAX app's landmarks")
    log(f"[j2k] rcr_detect -i {J2K_FRAME_97} --facebox -o: "
        f"{runs['j2k'][1] * 1e3:.1f} ms on the card (D1 and M1 twice; "
        f"{runs['png'][1] * 1e3:.1f} ms from the PNG), the landmarks "
        f"{delta:.2e} px from the JAX app's, equal to those from the PNG "
        "of the same pixels, the drawn PNG equal")
    return dict(ms=runs["j2k"][1] * 1e3, png_ms=runs["png"][1] * 1e3,
                jax_delta_px=delta)


def j2k_times(torch, paths):
    """On both 768 x 1024 frames: the host C++ stage's ms beside its Python
    twin's (host clock), D1 and M1's device ms (torch.profiler) warm and
    with the L2 flushed before each call, beside their twins' and their
    bounds; ``load_gray_image`` of the 9/7 JP2, the PNG of its pixels and
    the JPEG it was written from, in turns."""
    from superviseddescent_tpu_torch.ops import j2k as O
    from superviseddescent_tpu_torch.ops.patches import load_gray_image
    flush = l2_flusher(torch)
    out = {}
    for frame_name in (J2K_FRAME_97, J2K_FRAME_53):
        f, frame = j2k_frame(frame_name)
        host = []
        for _ in range(J2K_REPS):
            t0 = time.perf_counter()
            O.decode_native(f.codestream, pinned=True)
            host.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        O.decode_python(f.codestream)
        twin_host = (time.perf_counter() - t0) * 1e3
        plan = O.colour_plan(f, frame)
        coeffs = frame.coeffs.to("cuda")
        work = coeffs.clone()
        done = O.j2k_idwt(coeffs.clone(), frame.tcs)
        bounds = j2k_bounds(frame, 3)
        launches = len(O.idwt_plan(frame.tcs).launches)
        calls = {
            "j2k_idwt": (lambda: O.j2k_idwt(work, frame.tcs),
                         lambda: O.idwt_reference(coeffs, frame.tcs), False,
                         launches),
            "j2k_colour": (lambda: O.j2k_colour(done, frame, plan, 3),
                           lambda: O.colour_reference(done, frame, plan, 3),
                           True, 1)}
        kernels = {}
        for name, (kernel, twin, one, whole) in calls.items():
            ms = [device_ms(torch, kernel, reps=10, match=name,
                            one_kernel=one, whole=whole) for _ in range(2)]
            flushed = device_ms(torch, kernel, reps=10, match=name,
                                one_kernel=one, before=flush, whole=whole)
            twin_ms = device_ms(torch, twin, reps=2, one_kernel=False)
            kernels[name] = dict(device_ms=ms, flushed_ms=flushed,
                                 twin_device_ms=twin_ms, **bounds[name])
        out[frame_name] = dict(host_ms=host, twin_host_ms=twin_host,
                               kernels=kernels, tiles=len(frame.tiles),
                               levels=int(frame.tcs[:, O.TC_LEVELS].max()))
        log(f"[j2k] {frame_name}: host C++ stage {min(host):.3f} ms (host "
            f"clock, best of {J2K_REPS}), its Python twin {twin_host:.1f} ms")
        for name, t in kernels.items():
            log(f"[j2k] {frame_name} {name}: " + " / ".join(
                f"{v:.5f}" for v in t["device_ms"]) + f" ms warm, "
                f"{t['flushed_ms']:.5f} ms L2 flushed (device, "
                f"torch.profiler), bound {t['bound_ms']:.5f} ms "
                f"({t['bound_by']}: {t['bytes']} bytes, {t['ops']} ops), "
                f"twin {t['twin_device_ms']:.4f} ms device")
    order = {k: paths[k] for k in ("j2k", "png", "jpeg")}
    load_ms = {k: [] for k in order}
    for _ in range(J2K_REPS):
        for kind, p in order.items():
            t0 = time.perf_counter()
            load_gray_image(p)
            load_ms[kind].append((time.perf_counter() - t0) * 1e3)
    log("[j2k] load_gray_image of the 768 x 1024 frame, ms (host clock, "
        f"best of {J2K_REPS}, in turns): " + ", ".join(
            f"{k} {min(v):.2f}" for k, v in load_ms.items()))
    return dict(frames=out, load_gray_ms=load_ms)


def j2k_line_pass(torch, O, coeffs, tcs, vertical):
    """The rows (vertical 0) or the columns (1) of every level of a D1 of a
    line a CTA (commit 442eb6c's ``j2k_idwt_launch``), launched as its
    wrapper launches them: the pass timed apart."""
    import ctypes
    import numpy as np
    from superviseddescent_tpu_torch.ops._build import load_library
    lib = load_library("j2k_pixels")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for level in range(int(tcs[:, O.TC_LEVELS].max(initial=0))):
        jobs = O.idwt_jobs(tcs, level)
        longest = int(max(jobs[:, 2].max(initial=0), jobs[:, 3].max(
            initial=0)))
        lines = jobs[:, 3 - vertical].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(lines)]).astype(np.int64)
        if starts[-1] == 0:
            continue
        table = torch.from_numpy(np.concatenate(
            [jobs, starts[:-1, None].astype(np.int32)], axis=1).copy()).cuda()
        err = lib.j2k_idwt_launch(
            ctypes.c_void_p(coeffs.data_ptr()),
            ctypes.c_void_p(table.data_ptr()), len(jobs), int(starts[-1]),
            vertical, longest, stream)
        check(err == 0, f"D1's pass launch failed: CUDA error {err}")


def j2k_kernel_times(torch):
    """D1 and M1 of the package on ``sys.path`` on both clip frames
    through its entry points: D1 equal to its twin and M1's unequal
    entries against its twin (RGB), then device ms (torch.profiler) warm
    and with the L2 flushed before each call, in the plain build ("whole")
    and in each of J2K_BUILDS that its source has (``load_library`` made
    to hand the entry points that build); D1's launches by kernel name
    and, for a source of a line a CTA, its row
    and column passes apart."""
    from superviseddescent_tpu_torch.ops import _build
    from superviseddescent_tpu_torch.ops import j2k as O
    source = (_build.CSRC / "j2k_pixels.cu").read_text()
    load = _build.load_library
    flush = l2_flusher(torch)
    out = {}
    for frame_name in (J2K_FRAME_97, J2K_FRAME_53):
        f, frame = j2k_frame(frame_name)
        plan = O.colour_plan(f, frame)
        coeffs = frame.coeffs.to("cuda")
        twin = O.idwt_reference(coeffs, frame.tcs)
        done = O.j2k_idwt(coeffs.clone(), frame.tcs)
        check(torch.equal(done, twin), f"D1 differs from its twin on "
              f"{frame_name}")
        # D1's launches a call (a source of a line a CTA: two a level), so
        # that a profiler session that kept only some is taken again
        levels = int(frame.tcs[:, O.TC_LEVELS].max(initial=0))
        d1 = len(O.idwt_plan(frame.tcs).launches) if hasattr(
            O, "idwt_plan") else 2 * levels
        unequal = int((O.j2k_colour(done, frame, plan, 3) != O.
                       colour_reference(twin, frame, plan, 3)).sum())
        work = coeffs.clone()
        calls = {"j2k_idwt": lambda: O.j2k_idwt(work, frame.tcs),
                 "j2k_colour": lambda: O.j2k_colour(done, frame, plan, 3)}
        t = {name: {"warm": {}, "flushed": {}} for name in calls}
        try:
            for build, define, kernels in (("whole", None, J2K_KERNELS),) \
                    + J2K_BUILDS:
                if define and define not in source:
                    continue
                _build.load_library = load if define is None else (
                    lambda name, defines=(), d=define: load(
                        name, (d,) if name == "j2k_pixels" else defines))
                for name in kernels:
                    call = calls[name]
                    for heat, before in (("warm", None), ("flushed", flush)):
                        t[name][heat][build] = device_ms(
                            torch, call, reps=J2K_TIME_REPS, match=name,
                            one_kernel=name == "j2k_colour", before=before,
                            whole=d1 if name == "j2k_idwt" else None)
        finally:
            _build.load_library = load
        t["j2k_idwt"]["by_kernel"] = {
            key[:80]: dict(launches=per_call, us=us) for key, per_call, us
            in device_kernels(torch, calls["j2k_idwt"], J2K_TIME_REPS,
                              "j2k_idwt", None, d1, d1)}
        if not hasattr(O, "idwt_plan"):     # rows and columns apart
            for vertical, label in ((0, "rows"), (1, "columns")):
                t["j2k_idwt"][label] = device_ms(
                    torch, lambda: j2k_line_pass(torch, O, work, frame.tcs,
                                                 vertical),
                    reps=J2K_TIME_REPS, match="j2k_idwt", one_kernel=False,
                    whole=levels)
        t["j2k_colour"]["unequal"] = unequal
        out[frame_name] = t
    return out


def j2k_compare(torch, root):
    """``--j2k``: ``j2k_kernel_times`` of this checkout's package and, with
    another checkout's (``root``; commit 442eb6c's through
    ``with_split_builds``), of that package (``other_runs``), in the order
    other, this, this, other; D1 and M1 whole and split side by side."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_split_")
    try:
        runs = other_runs(with_split_builds(root, tmp, "j2k_pixels.cu")
                          if root != REPO else root,
                          lambda: j2k_kernel_times(torch), ["--j2k-times"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def text(who, frame_name, name, heat):
        return " / ".join(", ".join(
            f"{build} {ms:.5f}" for build, ms in
            r[frame_name][name][heat].items()) for r in runs[who])
    for frame_name in (J2K_FRAME_97, J2K_FRAME_53):
        for name in J2K_KERNELS:
            for heat in ("warm", "flushed"):
                line = (f"[j2k] {name} {heat} on {frame_name}: this tree "
                        f"{text('this', frame_name, name, heat)} ms")
                if runs["other"]:
                    ratio = (min(r[frame_name][name][heat]["whole"]
                                 for r in runs["other"])
                             / max(r[frame_name][name][heat]["whole"]
                                   for r in runs["this"]))
                    line += (f" | other {text('other', frame_name, name, heat)}"
                             f" ms (x{ratio:.2f})")
                log(line + " (device, torch.profiler)")
        for who in ("this", "other"):
            for r in runs[who]:
                d1 = r[frame_name]["j2k_idwt"]
                log(f"[j2k] j2k_idwt on {frame_name} ({who}) by kernel: "
                    + ", ".join(f"{k} x{v['launches']} {v['us']:.2f} us"
                                for k, v in d1["by_kernel"].items())
                    + (f"; rows {d1['rows']:.5f} ms, columns "
                       f"{d1['columns']:.5f} ms" if "rows" in d1 else "")
                    + f"; M1 unequal {r[frame_name]['j2k_colour']['unequal']}")
    return dict(this=runs["this"], other=runs["other"], package_root=root)


def j2k_entries(j2k):
    """The kernels line's entries of D1 and M1: device ms on the 9/7
    frame (D1: all its launches of one read), launches of the main path's
    run; the 5/3 tiled frame's beside them; with ``--j2k`` the other
    checkout's times and the split."""
    out = []
    compare = j2k.get("compare")
    for name in J2K_KERNELS:
        source, replaces = SOURCES[name]
        t = j2k["times"]["frames"][J2K_FRAME_97]["kernels"][name]
        tiled = j2k["times"]["frames"][J2K_FRAME_53]["kernels"][name]
        extra = {}
        if compare:
            extra["split"] = {f: r[name] for f, r in
                              compare["this"][0].items()}
            if compare["other"]:
                extra["other_package_ms"] = {
                    f: [r[f][name]["warm"]["whole"]
                        for r in compare["other"]]
                    for f in (J2K_FRAME_97, J2K_FRAME_53)}
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            replaces_note="no pallas_call: the JAX package reads images with "
            "PIL on the host; D1 and M1 are hand kernels of the io slice",
            launches=j2k["launches"][name], max_abs_err=j2k["max_abs_err"],
            ms=min(t["device_ms"]), plain_ms=t["twin_device_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            library_note="no nvJPEG2000 on the card, and it would not count",
            flushed_ms=t["flushed_ms"], ms_source="torch.profiler",
            tiled_frame=dict(ms=min(tiled["device_ms"]),
                             flushed_ms=tiled["flushed_ms"],
                             plain_ms=tiled["twin_device_ms"],
                             bound_ms=tiled["bound_ms"]),
            **(dict(taken=j2k["taken"]) if name == "j2k_colour" else {}),
            **extra))
    return out


def phase_j2k(torch, data, name, smi, root=REPO, compare=False):
    """JPEG 2000 on the card: every committed fixture through the host C++
    stage, D1 and M1 to PIL's digests (and the refusals), D1 and M1
    against their twins and the host stage against its Python twin, the
    9/7 clip frame through load_gray_image and K3 (the main path; rows
    equal to its PNG's), rcr_detect -i on it against the JAX app's
    landmarks, and the times (``j2k_times``); with ``compare``
    (``--j2k``) also ``j2k_compare``'s D1 and M1 whole and split, beside
    the package of checkout ``root`` where it is another."""
    import shutil
    import tempfile
    with open(os.path.join(J2K_DIR, "manifest.json")) as fh:
        manifest = json.load(fh)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_j2k_")
    try:
        read, refused, taken = j2k_readers(torch, manifest)
        worst = j2k_twins(torch)
        launches, paths = j2k_k3(torch, data, manifest, tmp)
        detect = j2k_detect(torch, manifest, tmp)
        times = j2k_times(torch, paths)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(device=name, nvidia_smi=smi, files_read=read,
               files_refused=refused, taken=taken, max_abs_err=worst,
               launches=launches,
               detect=detect, times=times)
    if compare:
        out["compare"] = j2k_compare(torch, root)
    out["seconds"] = time.perf_counter() - t0
    log(f"[j2k] {out['seconds']:.1f} s in all ({name}; {smi})")
    return out


# ---------------------------------------------------------------- #
# The last slice: dense training, data parallel, checkpoints
# ---------------------------------------------------------------- #
DENSE_SAMPLINGS = ("exact", "high", "fast")
# device memory that the dense sampler's images, tents and products may
# take at once; the chunk follows from it (``dense_chunk``)
DENSE_BUDGET_BYTES = 12 << 30
# the contracts of the dense sampler's precisions (the JAX package's
# ``sampling`` docstring): high within 0.006 grey levels of exact before
# rounding, fast within one; quantised, exact within one grey level of the
# gather sampler, whose truncating fixed-point shifts it does not copy
DENSE_HIGH_GREY = 0.006
DENSE_FAST_GREY = 1.0
DENSE_VS_GATHER_GREY = 1.0
# samples of each level on which those contracts are checked
DENSE_CONTRACT_SAMPLES = 256
# a dense-trained model's rows against the gather-trained model's on their
# training faces: the fused-vs-exact bound of the detectors
DENSE_VS_GATHER_PX = FUSED_WHOLE_MAX_PX
# tests/test_parallel.py:111-116: a mesh run's weights against the
# single-process run's; sharded fused rows against the single-process ones
MESH_RTOL, MESH_ATOL = 2e-2, 2e-4
SHARDED_PX = 1e-4
MESH_RANKS = 2
ALLREDUCE_REPS = 5


def dense_chunk(hog, factor):
    """Samples per dense chunk within DENSE_BUDGET_BYTES: per sample its
    gathered image, the row and column tents, the row products and the
    patches in float32 at the largest level, times ``factor`` for the
    bfloat16 parts of the high and fast products."""
    h, w = hog.images.shape[1:]
    l = len(hog.model_landmarks)
    s = max(p.patch_size for p in hog.hog_params)
    per = 4 * (h * w + l * s * (h + 2 * w) + l * s * s) * factor
    return max(1, DENSE_BUDGET_BYTES // per)


def dense_contracts(torch, hog, ids, x, li):
    """The dense sampler's precisions against each other and against the
    gather sampler at one level's rows (the first DENSE_CONTRACT_SAMPLES):
    high and fast against exact before rounding, exact against gather
    after it (max and share of unequal pixels) and before it."""
    from superviseddescent_tpu_torch.models.rcr import HogTransform
    n = min(DENSE_CONTRACT_SAMPLES, x.shape[0])
    x, idx = x[:n], hog.image_indices[:n]

    def patches(backend, sampling, quantize):
        t = HogTransform(hog.images, hog.hog_params, *ids,
                         image_indices=idx, quantize=quantize,
                         backend=backend, sampling=sampling)
        return t.sample_patches(x, li, idx)

    exact = patches("dense", "exact", False)
    out = dict(
        high=float((patches("dense", "high", False) - exact).abs().max()),
        fast=float((patches("dense", "fast", False) - exact).abs().max()),
        vs_gather_unquantised=float(
            (patches("gather", "exact", False) - exact).abs().max()))
    dq = patches("dense", "exact", True) - patches("gather", "exact", True)
    out["vs_gather"] = float(dq.abs().max())
    out["vs_gather_unequal"] = float((dq != 0).float().mean())
    check(out["high"] <= DENSE_HIGH_GREY and out["fast"] <= DENSE_FAST_GREY
          and out["vs_gather"] <= DENSE_VS_GATHER_GREY,
          f"level {li}: the dense sampler broke a contract: {out}")
    return out


def dense_replay(torch, label, prob, trained, epoch_rows, chunk, ids,
                 contracts):
    """Each level of a dense run replayed at its own rows: K1 against its
    twin on the level's own patches, timed beside the twin and its bound;
    the replayed rows against the run's on_epoch rows; with ``contracts``
    also the sampler's precision contracts at the level's rows."""
    from superviseddescent_tpu_torch.models.rcr import _with_bias
    from superviseddescent_tpu_torch.ops.hog_flat import (
        hog_descriptor_flat, hog_descriptor_flat_reference)
    from superviseddescent_tpu_torch.utils.timing import cuda_time_ms
    hog, x = prob.hog, prob.x0
    n = x.shape[0]
    idx = hog.image_indices
    levels = []
    for li, p in enumerate(hog.hog_params):
        s = p.patch_size
        level = dict(level=li)
        if contracts:
            level["contracts"] = dense_contracts(torch, hog, ids, x, li)
        patches = torch.cat([hog.sample_patches(x[a:a + chunk], li,
                                                idx[a:a + chunk])
                             for a in range(0, n, chunk)])
        flat = patches.reshape(-1, s * s)
        del patches
        kw = dict(size=s, cell_size=p.cell_size, num_orientations=p.num_bins,
                  variant=p.variant)
        desc = hog_descriptor_flat(flat, **kw)
        ref = hog_descriptor_flat_reference(flat, **kw)
        diff = (desc - ref).abs()
        err = float(diff.max())
        bad = int((diff > K1_ATOL + K1_RTOL * ref.abs()).sum())
        del ref, diff
        check(bad == 0, f"{label} level {li}: K1 disagrees with its twin "
              f"on the dense patches ({bad} outside)")
        ms, _ = cuda_time_ms(hog_descriptor_flat, flat, **kw, reps=10,
                             warmup=2)
        plain_ms, _ = cuda_time_ms(hog_descriptor_flat_reference, flat,
                                   **kw, reps=2, warmup=1)
        b_bytes, b_ops = k1_bound(flat.shape[0], p, 4)
        x = trained.sdo.step(li, x, _with_bias(desc.reshape(n, -1)))
        replay = float((x + prob.sample_shift - epoch_rows[li]).abs().max())
        check(replay <= 1e-3, f"{label} level {li}: the replay left the "
              f"run's rows by {replay} px")
        level.update(k1_err=err, k1_ms=ms, k1_plain_ms=plain_ms,
                     k1_bound_bytes_ms=b_bytes * 1e3,
                     k1_bound_ops_ms=b_ops * 1e3, replay_px=replay)
        log(f"[remainder] {label} level {li} S={s}: K1 on {flat.shape[0]} "
            f"dense patches vs twin max abs {err:.3e} (rtol {K1_RTOL} + atol "
            f"{K1_ATOL}); K1 {ms:.4f} ms (twin {plain_ms:.1f} ms, bound "
            f"{max(b_bytes, b_ops) * 1e3:.4f}); replay {replay:.2e} px"
            + ("" if not contracts else
               "; sampler contracts: high - exact {high:.2e}, fast - exact "
               "{fast:.3f} grey levels (limits {hl}, {fl}); exact - gather "
               "{vs_gather:.0f} quantised on {share:.2%} of pixels, "
               "{vs_gather_unquantised:.2e} unquantised".format(
                   hl=DENSE_HIGH_GREY, fl=DENSE_FAST_GREY,
                   share=level["contracts"]["vs_gather_unequal"],
                   **level["contracts"])))
        levels.append(level)
        del flat, desc
        torch.cuda.empty_cache()
    return levels


def remainder_dense(torch, data):
    """train_rcr with the dense sampler + K1 at full RCR-22 width on the
    1,408 samples of the window run, in exact, high and fast: launches,
    peak memory, cold and warm seconds, each level replayed (K1 against its
    twin, the sampler's contracts in the exact run), and the models against
    the gather-trained model and the pretrained one."""
    import numpy as np
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, normalised_landmark_errors, train_rcr,
        training_problem)
    model, frames = data["model"], data["frames"]
    ids = (model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
    eyes = (data["r_idx"], data["l_idx"])
    mean = model.mean.cpu().numpy()
    sel = np.arange(TRAIN_FACES_SMALL) % frames.shape[0]
    gt, bx = data["image_gt"][sel], data["image_boxes"][sel]
    boxes = torch.from_numpy(bx).cuda()
    gt_dev = torch.from_numpy(gt).cuda()
    images = frames[torch.from_numpy(sel).cuda()]
    levels = len(model.hog_params)

    def iod(m):
        rows = m.make_stepped_detector(
            TRAIN_FACES_SMALL, roi=ROI, sampling="exact",
            window_sampler=True, max_ied=data["max_ied"])(images, boxes)
        return rows, float(normalised_landmark_errors(
            rows, gt_dev, *eyes).mean())

    ref_rows, pretrained_iod = iod(model)
    gather = train_rcr(frames, gt, bx, *ids, mean, RcrTrainConfig(
        roi=ROI, patch_backend="gather", seed=0, solver_method="lu"),
        image_indices=sel)
    gather_rows, gather_iod = iod(gather)
    del gather
    out = dict(pretrained_iod=pretrained_iod, gather_iod=gather_iod,
               modes={})
    for sampling in DENSE_SAMPLINGS:
        cfg = RcrTrainConfig(roi=ROI, patch_backend="dense",
                             sampling=sampling, seed=0, solver_method="lu")
        prob = training_problem(frames, gt, bx, *ids, mean, cfg,
                                image_indices=sel)
        n = prob.x0.shape[0]
        chunk = min(n, dense_chunk(prob.hog, 1 if sampling == "exact"
                                   else 3))
        cfg.feature_chunk_size = chunk
        args = (frames, gt, bx, *ids, mean, cfg)
        epoch_rows = []
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        trained = train_rcr(*args, image_indices=sel,
                            on_epoch=epoch_rows.append)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_counts(launches, f"train_rcr(dense, {sampling})",
                      hog_flat=levels)
        t0 = time.perf_counter()
        train_rcr(*args, image_indices=sel)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        rows, err = iod(trained)
        vs_gather = float((rows - gather_rows).abs().max())
        log(f"[remainder] train_rcr(dense, {sampling}, roi {ROI}) on {n} "
            f"samples in chunks of {chunk}: launches {launches}; "
            f"{cold_s:.3f} s first call, {warm_s:.3f} s warm; peak memory "
            f"{peak / 2**30:.2f} GiB; IOD error on its {TRAIN_FACES_SMALL} "
            f"faces (exact stepped) {err:.6f} (gather-trained "
            f"{gather_iod:.6f}, pretrained {pretrained_iod:.6f}); rows vs "
            f"the gather-trained model's {vs_gather:.4f} px")
        check(err < pretrained_iod, f"the dense {sampling} model is no "
              "better than the pretrained one on its training faces")
        if sampling == "exact":
            check(vs_gather <= DENSE_VS_GATHER_PX, "the exact dense model "
                  f"detects {vs_gather} px from the gather model")
        replay = dense_replay(torch, f"train_rcr(dense, {sampling})",
                              prob, trained, epoch_rows, chunk, ids,
                              contracts=sampling == "exact")
        out["modes"][sampling] = dict(
            samples=n, chunk=chunk, launches=launches, cold_s=cold_s,
            warm_s=warm_s, peak_bytes=peak, iod=err,
            vs_gather_px=vs_gather, levels=replay)
        del prob, trained, epoch_rows
        torch.cuda.empty_cache()
    return out


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def allreduce_ms(torch, mesh, n_features):
    """Host-clock ms of one all_reduce of an (F, F) float32 matrix, the
    size of a level's AtA, over the mesh's group (synchronised before and
    after; the median of ALLREDUCE_REPS after one warm-up)."""
    import statistics
    import torch.distributed as dist
    ata = torch.ones((n_features, n_features), device=mesh.device)
    times = []
    for rep in range(ALLREDUCE_REPS + 1):
        dist.barrier(group=mesh.group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(ata, group=mesh.group)
        torch.cuda.synchronize()
        if rep:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_inputs(torch, data):
    """What every rank of the data-parallel runs trains and detects on."""
    import numpy as np
    model = data["model"]
    sel = np.arange(TRAIN_FACES_SMALL) % data["frames"].shape[0]
    return dict(
        frames=data["stack"], gt=data["image_gt"][sel],
        boxes=data["image_boxes"][sel], sel=sel,
        mean=model.mean.cpu().numpy(), det_boxes=data["boxes_np"],
        det_sel=data["sel"], max_ied=np.float64(data["max_ied"]))


def mesh_rank(rank, world, init, inputs, out):
    """One rank of the gloo group that shares cuda:0: train_rcr(mesh=) on
    the fused backend (K5 on this rank's shard), an all_reduce of AtA's
    size, train_rcr(mesh=) on the window backend (K2 + K1 on the shard),
    sharded_detect_fused over the 4,096 faces (K3 on this rank's shard).
    Writes its results to ``out % rank``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, REPO)
    from superviseddescent_tpu_torch.models.rcr import DetectionModel
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    from superviseddescent_tpu_torch.parallel import (
        make_mesh, sharded_detect_fused)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh(world, share_device=True)
        d = dict(np.load(inputs))
        frames = torch.from_numpy(d["frames"]).cuda()
        model = DetectionModel.load(os.path.join(REPO, "pretrained",
                                                 "rcr22_lfpw5.bin"))
        ids = (model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
        cfg = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                             solver_method="lu")
        args = (frames, d["gt"], d["boxes"], *ids, d["mean"], cfg)
        zero_counts()
        train_rcr(*args, image_indices=d["sel"], mesh=mesh)
        torch.cuda.synchronize()
        train_launches = read_counts()
        dist.barrier()
        t0 = time.perf_counter()
        trained = train_rcr(*args, image_indices=d["sel"], mesh=mesh)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        ar_ms = allreduce_ms(torch, mesh, trained.sdo.regressors[0]
                             .weights.shape[0])
        # the window backend through ShardedHogTransform: K2 + K1 a level
        cfg_w = RcrTrainConfig(roi=ROI, patch_backend="window", seed=0,
                               solver_method="lu")
        zero_counts()
        window = train_rcr(*args[:-1], cfg_w, image_indices=d["sel"],
                           mesh=mesh)
        torch.cuda.synchronize()
        window_launches = read_counts()
        det = dict(roi=ROI, max_ied=float(d["max_ied"]),
                   image_indices=d["det_sel"])
        zero_counts()
        rows = sharded_detect_fused(model, frames, d["det_boxes"], mesh,
                                    **det)
        torch.cuda.synchronize()
        det_launches = read_counts()
        dist.barrier()
        t0 = time.perf_counter()
        sharded_detect_fused(model, frames, d["det_boxes"], mesh, **det)
        torch.cuda.synchronize()
        det_ms = (time.perf_counter() - t0) * 1e3
        np.savez(out % rank, rows=rows.cpu().numpy(),
                 allreduce_ms=ar_ms, train_s=train_s, detect_ms=det_ms,
                 train_launches=json.dumps(train_launches),
                 window_launches=json.dumps(window_launches),
                 detect_launches=json.dumps(det_launches),
                 **{f"w{i}": r.weights.cpu().numpy()
                    for i, r in enumerate(trained.sdo.regressors)},
                 **{f"window_w{i}": r.weights.cpu().numpy()
                    for i, r in enumerate(window.sdo.regressors)})
    finally:
        dist.destroy_process_group()


def remainder_parallel(torch, data):
    """Data parallel on the one card: the single-process fused run on the
    1,408 samples; the same through a 1-rank NCCL group (equal weights);
    two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one device):
    train_rcr(mesh=) with K5 on each rank's shard, and with the window
    backend (K2 + K1 through ShardedHogTransform), weights within
    tests/test_parallel.py's tolerance, and sharded_detect_fused with K3
    on each rank's 2,048 faces, rows within SHARDED_PX of the
    single-process fused detector's. The kernels were built before the
    ranks start. A correctness check: two ranks on one card do not scale."""
    import numpy as np
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    from superviseddescent_tpu_torch.parallel import make_mesh
    inputs = rank_inputs(torch, data)
    model = data["model"]
    ids = (model.landmark_ids, model.right_eye_ids, model.left_eye_ids)
    cfg = RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                         solver_method="lu")
    args = (data["frames"], inputs["gt"], inputs["boxes"], *ids,
            inputs["mean"], cfg)
    single = [r.weights for r in train_rcr(
        *args, image_indices=inputs["sel"]).sdo.regressors]
    single_window = [r.weights for r in train_rcr(
        *args[:-1], RcrTrainConfig(roi=ROI, patch_backend="window", seed=0,
                                   solver_method="lu"),
        image_indices=inputs["sel"]).sdo.regressors]
    det = model.make_fused_detector(roi=ROI, max_ied=data["max_ied"])
    single_rows = det(data["frames"], data["boxes"],
                      image_indices=data["sel_dev"])

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1)
        zero_counts()
        one = train_rcr(*args, image_indices=inputs["sel"], mesh=mesh)
        torch.cuda.synchronize()
        one_launches = read_counts()
        nccl_ms = allreduce_ms(torch, mesh, single[0].shape[0])
    finally:
        dist.destroy_process_group()
    one_delta = max(float((r.weights - w).abs().max())
                    for r, w in zip(one.sdo.regressors, single))
    expect_counts(one_launches, "train_rcr(mesh=1 rank, fused)",
                  features_fused_frames=len(single))
    log(f"[remainder] 1-rank NCCL group: train_rcr(mesh=) launches "
        f"{one_launches}; weights vs the single-process run max abs "
        f"{one_delta:.3e}; all_reduce of the {single[0].shape[0]}^2 float32 "
        f"AtA {nccl_ms:.3f} ms (one rank: nothing crosses a link)")
    check(one_delta == 0.0, "a 1-rank mesh trains other weights than the "
          "single-process run")

    build = os.path.join(REPO, "build")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "remainder_ranks.npz")
    np.savez(path, **inputs)
    out = os.path.join(build, "remainder_rank%d.npz")
    t0 = time.perf_counter()
    try:
        # join=True: a failed rank raises here, after the others are stopped
        mp.start_processes(mesh_rank, args=(
            MESH_RANKS, f"tcp://localhost:{free_port()}", path, out),
            nprocs=MESH_RANKS, join=True, start_method="spawn")
        wall = time.perf_counter() - t0
        ranks = [dict(np.load(out % r)) for r in range(MESH_RANKS)]
    finally:
        for f in [path] + [out % r for r in range(MESH_RANKS)]:
            if os.path.exists(f):
                os.remove(f)
    n_levels = len(single)
    for r, res in enumerate(ranks):
        expect_counts(json.loads(str(res["train_launches"])),
                      f"rank {r}: train_rcr(mesh=2 ranks, fused)",
                      features_fused_frames=n_levels)
        expect_counts(json.loads(str(res["window_launches"])),
                      f"rank {r}: train_rcr(mesh=2 ranks, window)",
                      patches_window=n_levels, hog_flat=n_levels)
        expect_counts(json.loads(str(res["detect_launches"])),
                      f"rank {r}: sharded_detect_fused",
                      cascade_fused_frames=1)
        for key in [f"{b}w{i}" for b in ("", "window_")
                    for i in range(n_levels)]:
            check(np.array_equal(res[key], ranks[0][key]),
                  f"rank {r} ends with other weights than rank 0 ({key})")
    errs = {}
    for backend, weights in (("", single), ("window_", single_window)):
        errs[backend] = 0.0
        for i, w in enumerate(weights):
            w = w.cpu().numpy()
            got = ranks[0][f"{backend}w{i}"]
            errs[backend] = max(errs[backend], float(np.abs(got - w).max()))
            check(np.allclose(got, w, rtol=MESH_RTOL, atol=MESH_ATOL),
                  f"level {i}: 2-rank {backend or 'fused '}weights outside "
                  f"rtol {MESH_RTOL} + atol {MESH_ATOL} of the "
                  "single-process run")
    w_err = errs[""]
    rows_err = float(np.abs(ranks[0]["rows"]
                            - single_rows.cpu().numpy()).max())
    check(rows_err <= SHARDED_PX, f"sharded fused rows {rows_err} px from "
          "the single-process detector's")
    res = ranks[0]
    log(f"[remainder] 2 gloo ranks sharing cuda:0 (a correctness check, not "
        f"a scaling number): train_rcr(mesh=) K5 {n_levels} launches a "
        f"rank, same weights on both ranks, max abs {w_err:.3e} from the "
        f"single-process run (rtol {MESH_RTOL} + atol {MESH_ATOL}); the "
        f"window backend K2 + K1 {n_levels} + {n_levels} launches a rank, "
        f"max abs {errs['window_']:.3e}; warm fused "
        f"train_rcr {float(res['train_s']):.3f} s; all_reduce of AtA over "
        f"gloo {float(res['allreduce_ms']):.3f} ms; sharded_detect_fused of "
        f"{BATCH} faces, K3 once a rank, {float(res['detect_ms']):.3f} ms "
        f"(host clock), rows {rows_err:.2e} px from make_fused_detector's; "
        f"the spawned ranks {wall:.1f} s wall")
    return dict(one_rank=dict(launches=one_launches, delta=one_delta,
                              nccl_allreduce_ms=nccl_ms),
                two_ranks=dict(weights_err=w_err,
                               window_weights_err=errs["window_"],
                               rows_err_px=rows_err,
                               gloo_allreduce_ms=float(res["allreduce_ms"]),
                               train_s=float(res["train_s"]),
                               detect_ms=float(res["detect_ms"]),
                               wall_s=wall))


def remainder_checkpoint(torch, data):
    """A checkpointed fused run of the 1,408 samples, its last two levels
    removed and resumed: the same weights as the uninterrupted run."""
    import shutil
    import tempfile
    from superviseddescent_tpu_torch.io.checkpoint import TrainCheckpointer
    from superviseddescent_tpu_torch.models.rcr_training import (
        RcrTrainConfig, train_rcr)
    inputs = rank_inputs(torch, data)
    model = data["model"]
    args = (data["frames"], inputs["gt"], inputs["boxes"], model.landmark_ids,
            model.right_eye_ids, model.left_eye_ids, inputs["mean"],
            RcrTrainConfig(roi=ROI, patch_backend="fused", seed=0,
                           solver_method="lu"))
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        full = train_rcr(*args, image_indices=inputs["sel"],
                         checkpointer=TrainCheckpointer(root))
        n = len(full.sdo.regressors)
        for lvl in (n - 2, n - 1):
            os.remove(os.path.join(root, f"level_{lvl:02d}.npz"))
        zero_counts()
        resumed = train_rcr(*args, image_indices=inputs["sel"],
                            checkpointer=TrainCheckpointer(root))
        launches = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    expect_counts(launches, "resumed train_rcr", features_fused_frames=2)
    delta = max(float((a.weights - b.weights).abs().max())
                for a, b in zip(full.sdo.regressors, resumed.sdo.regressors))
    log(f"[remainder] checkpointed fused train_rcr, levels {n - 2}-{n - 1} "
        f"removed and resumed (K5 {launches['features_fused_frames']} "
        f"launches): weights vs the uninterrupted run max abs {delta:.3e}")
    check(delta == 0.0, "the resumed run trained other weights")
    return dict(launches=launches, delta=delta)


def phase_remainder(torch, data, name, smi):
    """The last slice on the card: dense training (K1), rcr_train
    --patch-backend dense, data parallel on one card (K5 and K3 per rank)
    and a checkpointed resume."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    dense = remainder_dense(torch, data)
    root = tempfile.mkdtemp(prefix="chip_smoke_remainder_")
    try:
        app, _ = apps_train(torch, root, "cuda", backend="dense",
                            extra=("--sampling", "high"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    parallel = remainder_parallel(torch, data)
    checkpoint = remainder_checkpoint(torch, data)
    seconds = time.perf_counter() - t0
    log(f"[remainder] {seconds:.1f} s in all ({name}; {smi})")
    return dict(device=name, nvidia_smi=smi, dense=dense, app=app,
                parallel=parallel, checkpoint=checkpoint, seconds=seconds)


def main():
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the probes' inputs and the clip")
    parser.add_argument("--k3-batches", action="store_true",
                        help="only time K3 at the batch sizes K3_BATCHES "
                        "(RCR-22 and ibug-68) and print them as JSON")
    parser.add_argument("--plans", action="store_true",
                        help="with --k3-batches: also time K3_PLANS")
    parser.add_argument("--slices", default="",
                        help="with --k3-batches: also time builds with "
                        "these GEMV slice counts, e.g. 5,11")
    parser.add_argument("--k12", action="store_true",
                        help="only time K2 and K1 per level of the stepped "
                        "detector (RCR-22, COFW-29, ibug-68, exact and fast) "
                        "and, for this checkout's package, k12_split")
    parser.add_argument("--sweep", action="store_true",
                        help="with --k12: also time K2 and K1 at other "
                        "numbers of patches per block (RCR-22); with --k5: "
                        "K5 at other launch plans (K5_SWEEP); with --webp: "
                        "W1 and W2 at other rows a CTA (WEBP_SWEEP), W3 at "
                        "other rows a band (COLOUR_SWEEP)")
    parser.add_argument("--k5", action="store_true",
                        help="only time K5 and K6 per level of training "
                        "and K5 over the families' 4,096 faces, with the "
                        "warm train_rcr, and, for this checkout's package, "
                        "k5_split")
    parser.add_argument("--probes", action="store_true",
                        help="only time P1-P3 (every variant, G and pre) "
                        "and P5 through their entry points, with the split "
                        "of P1 full and the launch floor; with "
                        "--package-root also another checkout's package, "
                        "side by side")
    parser.add_argument("--apps", action="store_true",
                        help="only run the apps and examples phase "
                        "(phase_apps) after the builds")
    parser.add_argument("--jpeg", action="store_true",
                        help="only run the JPEG phase (phase_jpeg: the "
                        "committed fixtures through the host decoder and J1, "
                        "rcr_track on the progressive and baseline clips "
                        "against PNG frames of the same pixels, rcr_detect "
                        "on baseline, progressive and CMYK stills) after the "
                        "builds")
    parser.add_argument("--imageio", action="store_true",
                        help="only run the image-io phase (phase_imageio: "
                        "J2 against its twin and PIL's digests, the BMP / "
                        "PNM / TIFF / GIF readers, rcr_track -o on the JPEG "
                        "clip, rcr_detect -o to four formats) after the "
                        "builds")
    parser.add_argument("--imagewrite", action="store_true",
                        help="only GIF and WebP writing (the host C++ "
                        "coders against PIL's digests, rcr_detect -o .gif "
                        "/ .webp against the JAX app's files, the times)")
    parser.add_argument("--tiffwebp", action="store_true",
                        help="only the TIFF kinds, JPEG-in-TIFF (J1), PFM "
                        "and lossless WebP: every new fixture to PIL's "
                        "digests, the clip frame in each kind through K3, "
                        "the readers' times (the main run includes it)")
    parser.add_argument("--webp", action="store_true",
                        help="only lossy WebP: every lossy fixture through "
                        "the C++ entropy stage and W1-W3 against the twins, "
                        "libwebp's planes and PIL's digests, the lossy clip "
                        "frame through K3, rcr_detect -i on it, the times, "
                        "W1-W3's split; with --package-root W1-W3 "
                        "of another checkout in turns (the main run "
                        "includes it)")
    parser.add_argument("--j2k", action="store_true",
                        help="only JPEG 2000 reading: every fixture through "
                        "the host C++ stage, D1 and M1 to PIL's digests, D1 "
                        "and M1 against their twins, the 9/7 clip frame "
                        "through K3 and rcr_detect -i, the times (the main "
                        "run includes it), and D1 and M1 whole and split; "
                        "with --package-root also another checkout's D1 "
                        "and M1, in turns")
    parser.add_argument("--remainder", action="store_true",
                        help="only run the last slice's phase "
                        "(phase_remainder: dense training, data parallel "
                        "on one card, a checkpointed resume) after the "
                        "builds")
    parser.add_argument("--j1", action="store_true",
                        help="only time J1 on the baseline clip's first "
                        "frame, grey and RGB, with its split; with "
                        "--package-root also another checkout's package, "
                        "in turns; with --sweep also other tiles (J1_SWEEP)")
    parser.add_argument("--j2", action="store_true",
                        help="only time J2 on the baseline clip's first "
                        "frame as RGB 4:2:0 q75, with its split; with "
                        "--package-root also another checkout's package, "
                        "in turns; with --sweep also other strips "
                        "(J2_SWEEP)")
    parser.add_argument("--probe-times", action="store_true",
                        help=argparse.SUPPRESS)   # --probes' child process
    parser.add_argument("--jpeg-times", action="store_true",
                        help=argparse.SUPPRESS)   # --j1 / --j2's child
    parser.add_argument("--webp-times", action="store_true",
                        help=argparse.SUPPRESS)   # --webp's child
    parser.add_argument("--j2k-times", action="store_true",
                        help=argparse.SUPPRESS)   # --j2k's child
    parser.add_argument("--package-root", default=REPO,
                        help="with --k3-batches, --k12, --k5, --probes, "
                        "--j1, --j2, --webp or --j2k: the "
                        "checkout whose "
                        "superviseddescent_tpu_torch is timed (the data "
                        "stay this checkout's)")
    opts = parser.parse_args()
    seed = opts.seed
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(opts.package_root)
    if not all(os.path.isdir(os.path.join(d, "superviseddescent_tpu_torch"))
               for d in (REPO, root)):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, root if opts.k3_batches or opts.k12 or opts.k5
                    or opts.probe_times or opts.jpeg_times or opts.webp_times
                    or opts.j2k_times else REPO)
    if opts.webp_times:
        print(json.dumps(webp_times(torch)))
        return 0
    if opts.j2k_times:
        print(json.dumps(j2k_kernel_times(torch)))
        return 0
    if opts.probe_times:
        print(json.dumps(probe_times(torch, seed)))
        return 0
    if opts.jpeg_times:
        print(json.dumps(jpeg_times(torch)))
        return 0
    if opts.j1 or opts.j2:
        phase_device(torch)
        phase_build()
        which = ("j1",) * opts.j1 + ("j2",) * opts.j2
        result = {"times": jpeg_compare(torch, root, which),
                  "split": jpeg_split(torch),
                  "timeline": jpeg_timeline(torch), "package_root": root}
        if opts.sweep:
            result["sweep"] = jpeg_sweep(torch)
        print(json.dumps(result))
        return 0
    if opts.probes:
        phase_device(torch)
        from superviseddescent_tpu_torch.ops._build import build_all
        build_all(extra=PROBE_BUILDS)
        times = probe_levels(torch, seed, root, sweep=opts.sweep)
        print(json.dumps({"probes": times, "package_root": root}))
        return 0
    if opts.k5:
        phase_device(torch)
        own = root == REPO
        if own:
            from superviseddescent_tpu_torch.ops._build import build_all
            build_all(extra=K5_BUILDS)
        times = k5_levels(torch, load_data(torch), split=own,
                          sweep=own and opts.sweep)
        print(json.dumps({"k5": times, "package_root": root}))
        return 0
    if opts.k12:
        phase_device(torch)
        own = root == REPO
        if own:
            from superviseddescent_tpu_torch.ops._build import build_all
            build_all(extra=K12_BUILDS)
        times = k12_levels(torch, load_data(torch), split=own,
                           sweep=own and opts.sweep)
        print(json.dumps({"k12": times, "package_root": root}))
        return 0
    if opts.k3_batches:
        phase_device(torch)
        slices = [int(k) for k in opts.slices.split(",") if k]
        if slices:
            from superviseddescent_tpu_torch.ops._build import build_all
            build_all(extra=[("cascade_fused", (f"CASCADE_GEMV_SLICES={k}",))
                             for k in slices])
        times = k3_batches(torch, load_data(torch), (22, 29, 68),
                           K3_PLANS if opts.plans else (), slices)
        print(json.dumps({"k3_batches": times, "package_root": root}))
        return 0
    if opts.apps:
        name, smi = phase_device(torch)
        phase_build()
        apps = phase_apps(torch, load_data(torch), seed, name, smi)
        print(json.dumps({"apps": apps}))
        return 0
    if opts.jpeg:
        name, smi = phase_device(torch)
        phase_build()
        jpeg = phase_jpeg(torch, name, smi)
        print(json.dumps({"jpeg": jpeg, "kernels": [
            jpeg_entry(jpeg), jpeg_samples_entry(jpeg)]}))
        return 0
    if opts.imageio:
        name, smi = phase_device(torch)
        phase_build()
        imageio = phase_imageio(torch, name, smi)
        print(json.dumps({"imageio": imageio,
                          "kernels": [imageio_entry(imageio)]}))
        return 0
    if opts.imagewrite:
        name, smi = phase_device(torch)
        phase_build()
        print(json.dumps({"imagewrite": phase_imagewrite(torch, name, smi)}))
        return 0
    if opts.tiffwebp:
        name, smi = phase_device(torch)
        phase_build()
        tiffwebp = phase_tiffwebp(torch, load_data(torch), name, smi)
        print(json.dumps({"tiffwebp": tiffwebp,
                          "kernels": [tiffwebp_entry(tiffwebp)]}))
        return 0
    if opts.webp:
        name, smi = phase_device(torch)
        phase_build()
        webp = phase_webp_lossy(torch, load_data(torch), name, smi, root,
                                opts.sweep)
        print(json.dumps({"webp": webp,
                          "kernels": webp_lossy_entries(webp)}))
        return 0
    if opts.j2k:
        name, smi = phase_device(torch)
        phase_build(j2k=True)
        j2k = phase_j2k(torch, load_data(torch), name, smi, root,
                        compare=True)
        print(json.dumps({"j2k": j2k, "kernels": j2k_entries(j2k)}))
        return 0
    if opts.remainder:
        name, smi = phase_device(torch)
        phase_build()
        remainder = phase_remainder(torch, load_data(torch), name, smi)
        print(json.dumps({"remainder": remainder}))
        return 0
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
        torch, "exact stepped detect", f"{BATCH} faces",
        lambda: stepped(data["images"], data["boxes"]))
    del stepped
    fused = phase_fused(torch, data, exact_rows)
    del exact_rows
    train = phase_train(torch, data, dict(
        fused=fused["iod_err"], exact=results["exact"]["iod_err"]))
    torch.cuda.empty_cache()
    probes = phase_probes(torch, seed)
    families = phase_families(torch, data)
    tracking = phase_tracking(torch, data, seed)
    batches = k3_batches(torch, data)
    facedetect = phase_facedetect(torch, data)
    apps = phase_apps(torch, data, seed, name, smi)
    jpeg = phase_jpeg(torch, name, smi)
    imageio = phase_imageio(torch, name, smi)
    imagewrite = phase_imagewrite(torch, name, smi)
    tiffwebp = phase_tiffwebp(torch, data, name, smi)
    webp = phase_webp_lossy(torch, data, name, smi)
    j2k = phase_j2k(torch, data, name, smi)
    remainder = phase_remainder(torch, data, name, smi)
    entries = kernel_entries(results, k1_errs, k2_errs, fused, train, probes,
                             families, remainder) + [
        jpeg_entry(jpeg, tiffwebp), jpeg_samples_entry(jpeg),
        imageio_entry(imageio)] + webp_lossy_entries(webp) + j2k_entries(j2k)
    k3_shapes = {
        "rcr22_4096": fused["kernels"]["cascade_fused_frames"]["ms"],
        "rcr22_batch1": tracking["k3_batch1_ms"],
        "rcr29_4096": families["rcr29"]["k3_ms"],
        "rcr68_4096": families["rcr68"]["k3_ms"]}
    log("[K3] at the four shapes, ms (the times before the redesign in "
        "brackets): " + ", ".join(f"{shape} {ms:.4f} ({K3_BEFORE_MS[shape]})"
                    for shape, ms in k3_shapes.items()))
    for e in entries:
        if e["name"] == "cascade_fused_frames":
            e["ms_by_shape"] = k3_shapes
            bound1 = tracking["k3_batch1_bound"]
            e["batch1_bound_ms"] = max(bound1["bytes_ms"], bound1["ops_ms"])
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "chip_smoke.json"), "w") as f:
        json.dump(dict(device=name, nvidia_smi=smi, results=results,
                       fast_vs_exact_px=fast_vs_exact, profile=profile,
                       fused=fused, train=train, probes=probes,
                       families=families, tracking=tracking, seed=seed,
                       kernels=entries, k3_shapes=k3_shapes,
                       k3_batches=batches, facedetect=facedetect,
                       apps=apps, jpeg=jpeg, imageio=imageio,
                       imagewrite=imagewrite, tiffwebp=tiffwebp, webp=webp,
                       j2k=j2k, remainder=remainder,
                       profile_fallbacks=PROFILE_FALLBACKS,
                       seconds=time.perf_counter() - t0), f,
                  indent=1)
    check(all(math.isfinite(e["ms"]) for e in entries), "bad kernel times")
    if PROFILE_FALLBACKS:
        log(f"[profile] timed with CUDA events, no profiler session holding "
            f"a record (match, reps): {PROFILE_FALLBACKS}")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
