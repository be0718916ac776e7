"""The port stands alone: no JAX, no JAX package, no silent CPU fallback.

* every module of ``repro_torch`` imports in a fresh interpreter without
  pulling ``jax`` or ``repro`` into ``sys.modules``;
* no source line of the port or of ``chip_smoke.py`` imports either;
* an entry point called without ``device=`` on a host with no card raises
  instead of running on the CPU;
* the kernel wrappers catch nothing: a failed launch propagates;
* the backward wrappers check contiguity and shapes before they dispatch,
  so the CPU tests hold the call sites to what the kernels take;
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
from repro_torch.configs.base import RunConfig
from repro_torch.data.synthetic import SyntheticLoader
from repro_torch.kernels import flash_attention as flash_k
from repro_torch.kernels import local_attention as local_k
from repro_torch.kernels import routing_attention as routing_k
from repro_torch.kernels import routing_gathered as gathered_k
from repro_torch.models.model import init_model
from repro_torch.serve import serving
from repro_torch.train.train_step import init_train_state
from repro_torch.train.trainer import Trainer

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
                                 "core", "optim", "train", "data", "launch",
                                 "ckpt", "dist"])
def test_no_exception_handler_on_the_path(sub):
    """Nothing on the serving or training path catches an error and
    carries on. A try with only a finally catches nothing, unless its
    finally returns, breaks or continues: that drops the exception."""
    escapes = (ast.Return, ast.Break, ast.Continue)
    for path in (PKG / sub).glob("*.py"):
        tree = ast.parse(path.read_text())
        for n in ast.walk(tree):
            if not isinstance(n, ast.Try):
                continue
            assert not n.handlers, f"{path.name} has an exception handler"
            assert not any(isinstance(m, escapes) for f in n.finalbody
                           for m in ast.walk(f)), \
                f"{path.name} leaves a finally block early"


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced_config("rt-enwik8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.init_cache(cfg, 1, 64)
    run = RunConfig(model=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(run)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(run, SyntheticLoader("uniform", cfg.vocab_size, 1, 8))
    assert init_train_state(run, device="cpu").step == 0
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


def _bwd_calls(q, bad_lse=False):
    """One call of each backward wrapper on (B,H,N,dh) = q's shape;
    ``bad_lse`` cuts two rows off the lse."""
    B, H, N, dh = q.shape
    idx = torch.arange(N, dtype=torch.int32).reshape(1, 1, 2, N // 2).expand(
        B, H, 2, N // 2).contiguous()
    pos = torch.arange(N, dtype=torch.int32)[None].expand(B, N).contiguous()
    do_g = torch.zeros((B, H, 2, N // 2, dh))
    dsum, dsum_g = torch.zeros(B, H, N), torch.zeros(B, H, 2, N // 2)
    lse, lse_g = dsum.clone(), dsum_g.clone()
    if bad_lse:
        lse, lse_g = lse[..., :-2].contiguous(), lse_g[..., :-2].contiguous()
    # the gathered kernels' (n, w, dh) blocks: q's (B*H, N, dh) planes
    qf, lse_f, dsum_f = q.flatten(0, 1), lse.flatten(0, 1), dsum.flatten(0, 1)
    pos_f = torch.arange(N, dtype=torch.int32)[None].expand(
        B * H, N).contiguous()
    return [
        lambda: local_k.local_attention_bwd_dq(q, q, q, q, lse, dsum, 16),
        lambda: local_k.local_attention_bwd_dkv(q, q, q, q, lse, dsum, 16),
        lambda: routing_k.routed_attention_fused_bwd_dq(
            q, None, q, idx, idx, pos, do_g, lse_g, dsum_g),
        lambda: routing_k.routed_attention_fused_bwd_dkv(
            q, None, q, idx, idx, pos, do_g, lse_g, dsum_g),
        lambda: flash_k.flash_attention_bwd_dq(q, q, q, q, lse, dsum),
        lambda: flash_k.flash_attention_bwd_dkv(q, q, q, q, lse, dsum),
        lambda: gathered_k.routed_attention_blocks_bwd_dq(
            qf, qf, qf, pos_f, pos_f, qf, lse_f, dsum_f),
        lambda: gathered_k.routed_attention_blocks_bwd_dkv(
            qf, qf, qf, pos_f, pos_f, qf, lse_f, dsum_f),
    ]


@pytest.mark.parametrize("which", range(8), ids=[
    "local_dq", "local_dkv", "routing_dq", "routing_dkv", "flash_dq",
    "flash_dkv", "gathered_dq", "gathered_dkv"])
def test_backward_wrappers_check_before_dispatch(which):
    """Each backward wrapper refuses a non-contiguous tensor and an lse of
    the wrong shape already on the CPU, where it would then run its plain
    version; well-formed inputs go through."""
    B, H, N, dh = 1, 2, 32, 16
    _bwd_calls(torch.randn(B, H, N, dh))[which]()
    q_t = torch.randn(B, H, dh, N).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        _bwd_calls(q_t)[which]()
    with pytest.raises(ValueError, match="lse"):
        _bwd_calls(torch.randn(B, H, N, dh), bad_lse=True)[which]()
