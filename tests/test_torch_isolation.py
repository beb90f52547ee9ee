"""amgx_tpu_torch stands alone: it and chip_smoke.py import neither JAX
nor the JAX package, and its entry points run on the card unless the
caller asks for the CPU."""
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import pytest
import torch

import amgx_tpu_torch as pt
from amgx_tpu_torch import interop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "amgx_tpu_torch")
_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|amgx_tpu)(?:\.|\s|$)"
    r"|import_module\(\s*['\"](?:jax|amgx_tpu)(?:\.|['\"])"
    r"|__import__\(\s*['\"](?:jax|amgx_tpu)(?:\.|['\"])", re.M)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(PKG):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return out


def test_sources_import_no_jax():
    bad = []
    for path in _sources():
        with open(path) as f:
            bad += [f"{path}: {m.group(0).strip()}"
                    for m in _IMPORT.finditer(f.read())]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    mods = [m.name for m in pkgutil.walk_packages([PKG], "amgx_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import amgx_tpu_torch, chip_smoke\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'amgx_tpu' or "
        "m.startswith('amgx_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(mods) > 10


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card_or_repo(tmp_path, alone):
    """No CUDA device here, and no package beside a lone copy: either way
    the script exits non-zero and prints no result line."""
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("entry", ["create_solver", "gallery", "interop"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "create_solver":
            pt.create_solver(pt.Config.from_string(
                pt.presets.FLAGSHIP_TAIL_OFF))
        elif entry == "gallery":
            pt.gallery.poisson("7pt", 4, 4, 4)
        else:
            interop.matrix_from_numpy([0, 1], [0], [1.0], 1, 1)
