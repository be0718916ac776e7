"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* every module of ``repro_torch`` imports in a fresh interpreter without
  pulling ``jax`` or ``repro`` into ``sys.modules``;
* no source line of the port or of ``chip_smoke.py`` imports either;
* an entry point called without ``device=`` on a host with no card raises
  instead of running on the CPU;
* the kernel wrappers catch nothing: a failed launch propagates;
* ``chip_smoke.py`` exits non-zero, printing no result, without a card
  and outside a checkout of the repository.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models.model import init_model
from repro_torch.serve import serving

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts[:-1]
             if p.name == "__init__.py"
             else p.relative_to(ROOT / "src").with_suffix("").parts)
    for p in PKG.rglob("*.py"))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(MODULES) >= 17


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path.name} imports {n}"


@pytest.mark.parametrize("sub", ["kernels", "attn", "serve", "models",
                                 "core"])
def test_no_exception_handler_on_the_path(sub):
    """Nothing on the serving path catches an error and carries on."""
    for path in (PKG / sub).glob("*.py"):
        tree = ast.parse(path.read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
            f"{path.name} has a try statement"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("rt-enwik8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.init_cache(cfg, 1, 64)
    params, kstate = init_model(cfg, device="cpu")
    assert params["embed"]["tok"].device.type == "cpu"
    assert kstate[0]["0"].shape == (cfg.num_layers, 2,
                                    cfg.routing.num_clusters, cfg.head_dim_)


def test_chip_smoke_fails_without_a_card_and_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, timeout=300,
                           cwd=tmp_path, env=env)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=300, cwd=ROOT))
    for out in runs:
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
