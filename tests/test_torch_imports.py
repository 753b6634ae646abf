"""The port stands alone: every ``repro_torch`` module imports with JAX
blocked, and loads nothing of the JAX package."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MODULES = sorted(
    ".".join(p.relative_to(SRC).with_suffix("").parts).removesuffix(".__init__")
    for p in (SRC / "repro_torch").rglob("*.py"))

# One interpreter with jax blocked imports every module in turn and reports,
# per module, the error or the JAX/reference modules loaded so far.
_PROBE = """
import importlib, json, sys
sys.modules["jax"] = None          # any import of jax now raises ImportError
report = {}
for mod in json.loads(sys.argv[1]):
    try:
        importlib.import_module(mod)
    except Exception as e:
        report[mod] = f"{type(e).__name__}: {e}"
        continue
    leaked = sorted(m for m, v in sys.modules.items() if v is not None and (
        m == "repro" or m.startswith(("repro.", "jax"))))
    report[mod] = leaked
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def import_report():
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(MODULES)],
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("mod", MODULES)
def test_module_imports_without_jax_or_reference(mod, import_report):
    assert import_report[mod] == [], import_report[mod]


def test_every_module_probed():
    assert "repro_torch.launch.serve" in MODULES
    assert "repro_torch.kernels.build" in MODULES
    assert len(MODULES) >= 25
