"""chip_kernel_bounds.py, the out-of-bounds check of the port's CUDA kernels,
runs only on the card (chip_smoke.py's phase 3 runs it there). Here: it
imports neither jax nor the JAX package, it refuses to run without a card,
and its ctypes mirrors of the driver's structs have the driver's layout."""
import ast
import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_kernel_bounds as kb  # noqa: E402


def test_imports_neither_jax_nor_the_jax_package():
    with open(os.path.join(REPO, "chip_kernel_bounds.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert "jax" not in roots and "paddle_tpu" not in roots, roots
    assert "paddle_tpu_torch" in roots


def test_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_kernel_bounds.py"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "FAIL" in r.stdout and "cuda" in r.stdout.lower()


def test_driver_structs_have_the_driver_layout():
    # CUmemLocation {int type; int id}, CUmemAllocationProp {type,
    # requestedHandleTypes, location, void *win32HandleMetaData, allocFlags
    # {u8, u8, u16, u8[4]}}, CUmemAccessDesc {location, flags} (cuda.h)
    assert ctypes.sizeof(kb._Loc) == 8
    assert ctypes.sizeof(kb._AllocFlags) == 8
    assert ctypes.sizeof(kb._Prop) == 32
    assert kb._Prop.win32HandleMetaData.offset == 16
    assert kb._Prop.allocFlags.offset == 24
    assert ctypes.sizeof(kb._Access) == 12
