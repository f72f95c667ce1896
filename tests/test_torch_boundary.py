"""The port imports neither JAX nor the JAX package, nor an image library,
and loads no system libtiff or libzstd through ctypes.

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
                   "simplejpeg", "turbojpeg", "zstandard")


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_image_library(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in IMAGE_LIBRARIES]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


# system libraries the port must not load through ctypes: it decodes
# TIFF's codecs itself (csrc/tiff_decode.cu, io/ccitt.py, io/zstd.py)
SYSTEM_CODECS = ("tiff", "zstd")
LOADERS = ("find_library", "CDLL", "LoadLibrary", "PyDLL")


def loaded_libraries(path):
    """The string arguments of every ctypes loader call in a file
    (``ctypes.util.find_library(...)``, ``ctypes.CDLL(...)``,
    ``cdll.LoadLibrary(...)``), the strings inside f-strings and joins
    too."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and (
                getattr(node.func, "attr", None) in LOADERS
                or getattr(node.func, "id", None) in LOADERS):
            for arg in node.args:
                for leaf in ast.walk(arg):
                    if isinstance(leaf, ast.Constant) and isinstance(
                            leaf.value, str):
                        yield leaf.value


def loads_a_system_codec(path):
    return [name for name in loaded_libraries(path)
            if any(c in name.lower() for c in SYSTEM_CODECS)]


@pytest.mark.parametrize("path", port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_loads_no_system_tiff_or_zstd(path):
    bad = loads_a_system_codec(path)
    assert not bad, f"{os.path.relpath(path, REPO)} loads {bad}"


def test_codec_check_sees_the_loaders(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import ctypes, ctypes.util\n"
                     "ctypes.CDLL(ctypes.util.find_library('tiff'))\n"
                     "ctypes.cdll.LoadLibrary('libzstd.so.1')\n"
                     "ctypes.CDLL(str(path))\n")
    assert set(loads_a_system_codec(str(probe))) == {"tiff", "libzstd.so.1"}


def test_boundary_check_compares_names_exactly():
    assert is_forbidden("superviseddescent_tpu.ops.hog")
    assert is_forbidden("jax.numpy")
    assert not is_forbidden("superviseddescent_tpu_torch.ops.hog")
    assert not is_forbidden("jaxtyping_like_name")
