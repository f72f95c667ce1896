"""``rcr_train``, the port's app against the JAX package's, on the CPU.

8 ``.synth120`` pairs of the 300 x 450 class, the 68-point mean, the 22-id
training config and the eye config written by the test
(``torch_apps_helpers``), ``--levels 2``, the default ``gather`` features.
``--num-perturbations 0`` makes the initialisations the mean aligned into
each box in both packages (their random streams cannot agree). Held: the
printed NLSR and IOD errors within 1e-4, the saved per-level weights within
the training tolerances of ``tests/test_torch_training.py`` (mean absolute
difference under 1e-3, and under 1e-3 of the mean magnitude), the same
``.error.txt`` columns within 1e-4; also with ``--mirror``.
"""

import os

import pytest

from superviseddescent_tpu.apps import rcr_train as jax_train
from superviseddescent_tpu_torch.apps import rcr_train
from superviseddescent_tpu_torch.models.rcr import DetectionModel
from torch_apps_helpers import (
    assert_same_training, run_app, train_argv, train_case)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return train_case(str(tmp_path_factory.mktemp("train")))


@pytest.mark.parametrize("extra", [[], ["--mirror"]],
                         ids=["plain", "mirror"])
def test_training_matches_jax(monkeypatch, case, tmp_path, extra):
    runs = {}
    for name, module, dev in (("jax", jax_train, []),
                              ("port", rcr_train, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.bin")
        rc, text = run_app(monkeypatch, module, train_argv(
            case, out, "-t", case["data"], *extra, *dev))
        assert rc == 0
        runs[name] = (text, out)
    (port_text, port_out), (jax_text, jax_out) = runs["port"], runs["jax"]
    assert "Kept 8 images." in port_text
    assert port_text.count("NLSR train:") == 2
    assert_same_training(port_text, jax_text, port_out, jax_out, [
        os.path.splitext(f)[0] + ".error.txt" for f in (port_out, jax_out)])
    model = DetectionModel.load(port_out, device="cpu")
    assert len(model.sdo.regressors) == 2 and len(model.landmark_ids) == 22
