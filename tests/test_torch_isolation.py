"""The port stands alone: importing every ``repro_torch`` module loads no JAX
and nothing of the JAX package, its sources, ``chip_smoke.py`` and the
example twins (``examples/*_torch.py``) name neither, the twins load
neither when run with ``--help``, and ``chip_smoke.py`` refuses to report
without a card."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
TWINS = sorted((ROOT / "examples").glob("*_torch.py"))


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    mods = list(_modules())
    assert "repro_torch.runtime.engine" in mods and "repro_torch.interop" in mods
    assert "repro_torch.kernels.spmspv" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_name_no_jax_or_repro_import():
    pattern = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)(\.|\s))",
                         re.M)
    assert [p.name for p in TWINS] == ["quickstart_torch.py", "serve_decode_torch.py",
                                       "sparse_eigensolver_torch.py", "train_lm_torch.py"]
    for path in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py", *TWINS]:
        assert not pattern.search(path.read_text()), path


def test_example_twins_load_no_jax_and_no_repro():
    code = (
        "import json, runpy, sys\n"
        f"for path in {[str(p) for p in TWINS]!r}:\n"
        "    sys.argv = [path, '--help']\n"
        "    try:\n"
        "        runpy.run_path(path, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (path, e.code)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    import torch

    if torch.cuda.is_available():
        return  # on a card the script is run by itself, not from the tests
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
