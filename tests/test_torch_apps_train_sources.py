"""``rcr_train``'s facebox sources and refusals, the port's app against the
JAX package's, on the CPU (inputs and tolerances as in
``test_torch_apps_train.py``).

``--facebox-source cascade:<xml>`` with the stock cascade carried in the
port: the same images kept (``check_face`` on the first detection) and the
same trained model as JAX's; ``file:<json>`` with a null entry: the same
images dropped. Flag combinations the app cannot run exit by name
(``--mesh`` on the CPU without gloo or outside torchrun, ``--sampling high``
on the window sampler, an unknown facebox source), and ``--roi
--patch-backend window`` (K2 + K1, their plain twins here) trains.
"""

import glob
import json
import os

import numpy as np
import pytest

from superviseddescent_tpu.apps import rcr_train as jax_train
from superviseddescent_tpu_torch.apps import rcr_train
from superviseddescent_tpu_torch.io.haar import STOCK_FRONTAL_ALT2
from superviseddescent_tpu_torch.io.pts import read_pts_landmarks
from superviseddescent_tpu_torch.models.rcr import gt_facebox
from torch_apps_helpers import (
    assert_same_training, printed_numbers, run_app, train_argv, train_case)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return train_case(str(tmp_path_factory.mktemp("train_sources")))


def both(monkeypatch, case, tmp_path, *extra):
    runs = {}
    for name, module, dev in (("jax", jax_train, []),
                              ("port", rcr_train, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.bin")
        rc, text = run_app(monkeypatch, module,
                           train_argv(case, out, *extra, *dev))
        assert rc == 0
        runs[name] = (text, out)
    return runs


def test_cascade_facebox_source_matches_jax(monkeypatch, case, tmp_path):
    runs = both(monkeypatch, case, tmp_path,
                "--facebox-source", f"cascade:{STOCK_FRONTAL_ALT2}")
    (port_text, port_out), (jax_text, jax_out) = runs["port"], runs["jax"]
    assert "Kept" in port_text
    assert_same_training(port_text, jax_text, port_out, jax_out)


def test_file_facebox_source_matches_jax(monkeypatch, case, tmp_path):
    pts = sorted(glob.glob(os.path.join(case["data"], "*.pts")))
    boxes = [list(gt_facebox(read_pts_landmarks(p), margin=0.1))
             for p in pts]
    boxes[2] = None
    path = tmp_path / "boxes.json"
    path.write_text(json.dumps(boxes))
    runs = both(monkeypatch, case, tmp_path, "--facebox-source",
                f"file:{path}")
    (port_text, port_out), (jax_text, jax_out) = runs["port"], runs["jax"]
    assert f"Kept {len(pts) - 1} images." in port_text
    assert_same_training(port_text, jax_text, port_out, jax_out)


@pytest.mark.parametrize("extra,match", [
    (["--mesh", "2"], "--dist-backend gloo"),
    (["--mesh", "2", "--dist-backend", "gloo"], "torchrun"),
    (["--roi", "256", "--patch-backend", "window", "--sampling", "high"],
     "dense sampler"),
    (["--facebox-source", "boxes.json"], "unknown --facebox-source"),
])
def test_refused_flags_exit_by_name(case, tmp_path, extra, match):
    with pytest.raises(SystemExit, match=match):
        rcr_train.main(train_argv(case, str(tmp_path / "m.bin"), *extra,
                                  "--device", "cpu"))


def test_window_backend_trains(monkeypatch, case, tmp_path):
    rc, text = run_app(monkeypatch, rcr_train, train_argv(
        case, str(tmp_path / "w.bin"), "--roi", "256", "--patch-backend",
        "window", "--device", "cpu"))
    assert rc == 0
    numbers = printed_numbers(text)
    assert [n for n, _ in numbers] == ["NLSR train",
                                       "Normalised LM-error train"] * 2
    assert np.isfinite([v for _, v in numbers]).all()
    # the second level improves on the first
    assert numbers[3][1] < numbers[1][1]
