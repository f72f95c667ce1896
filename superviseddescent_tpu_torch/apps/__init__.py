"""The command-line apps of the port: ``rcr_train``, ``rcr_detect`` and
``rcr_track`` (``python -m superviseddescent_tpu_torch.apps.<name>``)."""
