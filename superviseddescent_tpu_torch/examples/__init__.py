"""The examples of the port (``python -m
superviseddescent_tpu_torch.examples.<name>``): ``simple_function``,
``pose_estimation`` and ``landmark_detection``."""
