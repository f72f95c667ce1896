from superviseddescent_tpu_torch.models.rcr import (  # noqa: F401
    RCR22_HOG_PARAMS, DetectionModel, HogParams, HogTransform,
    InterEyeDistanceNormalisation, align_mean)
from superviseddescent_tpu_torch.models.rcr_training import (  # noqa: F401
    RcrTrainConfig, augment_initialisations, normalised_landmark_errors,
    perturb_facebox, train_rcr)
