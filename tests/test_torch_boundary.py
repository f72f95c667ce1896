"""The port imports neither JAX nor the JAX package, nor an image library.

An AST scan (not a subprocess: an interpreter here may import jax at
start-up) of every module of ``superviseddescent_tpu_torch`` and of
``chip_smoke.py``. Module names are compared exactly, since the port's own
name starts with the JAX package's.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "superviseddescent_tpu")


def port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "superviseddescent_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and (
                getattr(node.func, "id", None) == "__import__"
                or getattr(node.func, "attr", None) == "import_module"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


def is_forbidden(module):
    top = module.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if is_forbidden(m)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# the port decodes images itself: the card has none of these
IMAGE_LIBRARIES = ("PIL", "torchvision", "cv2", "nvjpeg", "imageio",
                   "simplejpeg", "turbojpeg")


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_image_library(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_boundary_check_compares_names_exactly():
    assert is_forbidden("superviseddescent_tpu.ops.hog")
    assert is_forbidden("jax.numpy")
    assert not is_forbidden("superviseddescent_tpu_torch.ops.hog")
    assert not is_forbidden("jaxtyping_like_name")
