"""PyTorch + CUDA port of superviseddescent_tpu for NVIDIA Hopper (H100).

The JAX package ``superviseddescent_tpu`` is the reference this package is
held against; this package imports neither JAX nor that package. Entry
points run on CUDA unless the caller passes ``device="cpu"``, and never drop
to the CPU on their own.

First slice: batched RCR-22 detection through the stepped window detector
(``models.rcr.DetectionModel.make_stepped_detector``), with the HOG kernel
(``ops/hog_flat.py``, ``csrc/hog_flat.cu``) and the window patch sampler
(``ops/patches_window.py``, ``csrc/patches_window.cu``) written by hand in
CUDA C++ for ``sm_90a``. Second slice: the fused detector
(``models.rcr.DetectionModel.make_fused_detector`` and
``make_fused_tracker``), which runs the whole cascade per face in one launch
of a CUDA kernel (``ops/cascade_fused.py``, ``csrc/cascade_fused.cu``).
Third slice: RCR training, ``train_rcr`` (``models/rcr_training.py``), with
the ridge solvers (``ops/solver.py``) and the fused feature extractors
``extract_features_fused_frames`` / ``extract_features_fused``
(``csrc/features_fused.cu``, sharing the cascade kernel's per-landmark body
in ``csrc/cascade_body.cuh``). Later: the probes (``probes/``), the Haar
face detector (``models/facedetect.py``), the command-line apps
``rcr_train``, ``rcr_detect`` and ``rcr_track`` (``apps/``), pose estimation
(``models/pose.py``) and the examples (``examples/``). The last slice: the
dense patch sampler (``ops/patches.extract_patches_dense``) and the HOG of
multi-channel, bilinear, transposed and polar inputs (``ops/hog.py``,
``ops/hog_viz.py``), data-parallel training and detection over
``torch.distributed`` (``parallel/``), model files and per-level training
checkpoints (``io/checkpoint.py``), the boost matrix archive
(``io/boost_mat.py``), profiling, timing and the float64 parity mode
(``utils/``).
"""

from superviseddescent_tpu_torch.core.cascade import (  # noqa: F401
    SupervisedDescentOptimiser)
from superviseddescent_tpu_torch.core.regressor import (  # noqa: F401
    LinearRegressor)
from superviseddescent_tpu_torch.core.regulariser import (  # noqa: F401
    RegularisationType, Regulariser)
from superviseddescent_tpu_torch.models import (  # noqa: F401
    DetectionModel, RcrTrainConfig, augment_initialisations,
    perturb_facebox, train_rcr)

__version__ = "0.1.0"
