"""The port builds its native host libraries from its own sources: each C++
file under exsaddle_tpu_torch/host_src/ is byte for byte the JAX package's
exsaddle_tpu/native/ counterpart (this test reads that file; the port does
not), native.SRC_DIR lies inside the port, and no module of the port names
a path under the JAX package."""

import ast
import os

import pytest

from exsaddle_tpu_torch import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "exsaddle_tpu_torch")
JAX_NATIVE = os.path.join(ROOT, "exsaddle_tpu", "native")
SOURCES = ["ilu0.cpp", "ildl.cpp", "order.cpp"]


@pytest.mark.parametrize("name", SOURCES)
def test_host_source_is_a_copy(name):
    with open(os.path.join(native.SRC_DIR, name), "rb") as fh:
        ours = fh.read()
    with open(os.path.join(JAX_NATIVE, name), "rb") as fh:
        theirs = fh.read()
    assert ours == theirs


def test_every_native_source_is_copied():
    cpp = sorted(f for f in os.listdir(JAX_NATIVE) if f.endswith(".cpp"))
    assert cpp == sorted(SOURCES)
    assert sorted(f for f in os.listdir(native.SRC_DIR)
                  if f.endswith(".cpp")) == sorted(SOURCES)


def test_sources_and_builds_inside_the_port():
    src = os.path.realpath(native.SRC_DIR)
    assert os.path.commonpath([src, PORT]) == PORT
    for name in native._SIGNATURES:
        path = native.library_path(name)
        assert os.path.commonpath([os.path.realpath(path), PORT]) == PORT


def test_no_port_module_names_the_jax_package():
    """No module of the port imports exsaddle_tpu or holds a string that
    names it as a path (a component "exsaddle_tpu" or "exsaddle_tpu/...")."""
    hits = []
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                if any(n == "exsaddle_tpu" or n.startswith("exsaddle_tpu.")
                       for n in names):
                    hits.append((f, node.lineno))
                if isinstance(node, ast.Constant) and isinstance(
                        node.value, str) and (
                        node.value == "exsaddle_tpu"
                        or node.value.startswith("exsaddle_tpu/")):
                    hits.append((f, node.lineno))
    assert not hits, hits
