"""The port's single-device training launcher against the JAX package's.

* it takes every flag of ``src/repro/launch/train.py`` with the same
  default (read from that file's source), plus ``--device``;
* at ``--reduced --steps 3 --device cpu`` it trains qwen2-0.5b, prints the
  JAX launcher's ``arch=... params=...M`` line (the same parameter count)
  and ``loss a -> b`` line, and returns `Trainer.fit`'s result with a
  finite loss;
* the meshes, checkpoint, compression and multi-process flags do what
  the JAX launcher does with the same argv: ``--mesh 2x4`` clamps to 1x1
  on one process, ``--ckpt-dir`` writes and resumes, ``--grad-compression
  int8_ef`` trains, ``--coordinator`` or ``--num-processes`` alone raise
  `detect`'s ValueError, ``--process-id`` alone runs as one process (the
  multi-process launch itself is held in `test_torch_dist.py`, the
  observability flags in `test_torch_obs.py`);
* ``--seq-parallel`` trains (on one process its model axis is one rank;
  the model axis itself is held in `test_torch_tp.py`), and beside
  ``--grad-compression int8_ef`` it and a model-axis mesh are refused with
  the JAX launcher's ``ap.error``;
* without ``--device``, on a host with no card, it raises instead of
  running on the CPU.
"""
import ast
import math
import os
import re
from pathlib import Path

import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro_torch.launch import train as launcher

JAX_LAUNCHER = (Path(__file__).resolve().parent.parent / "src" / "repro"
                / "launch" / "train.py")


def _jax_flags():
    """flag -> default of every ``ap.add_argument`` in the JAX launcher."""
    flags = {}
    for node in ast.walk(ast.parse(JAX_LAUNCHER.read_text())):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else False if "action" in kw else None)
            flags[node.args[0].value] = default
    return flags


def test_flags_and_defaults_match_the_jax_launcher():
    jax_flags = _jax_flags()
    assert {"--arch", "--steps", "--mesh", "--grad-compression"} <= \
        set(jax_flags)
    ours = {a.option_strings[0]: a.default
            for a in launcher.parser()._actions if a.option_strings
            and a.option_strings[0] != "-h"}
    assert ours.pop("--device") == "cuda"
    assert ours == jax_flags


def test_reduced_qwen2_trains_on_cpu_and_prints_the_jax_lines(capsys):
    out = launcher.main(["--reduced", "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    jcfg = jax_reduced_config("qwen2-0.5b")
    assert lines[0].startswith(
        f"arch=qwen2-0.5b params={jcfg.param_count()/1e6:.1f}M ")
    assert re.fullmatch(r"loss \d+\.\d{3} -> \d+\.\d{3}", lines[1])
    assert out["steps"] == 3 and not out["preempted"]
    assert math.isfinite(out["final_loss"])


def _mesh_line(capsys):
    line = capsys.readouterr().out.splitlines()[0]
    return re.search(r" mesh=\((\d+x\d+)\) devices=(\d+) process=(\S+) "
                     r"multi_host=(\S+) compression=(\S+) ", line).groups()


@pytest.mark.parametrize("flag", [
    ["--mesh", "2x4"], ["--ckpt-dir", "ckpt"],
    ["--grad-compression", "int8_ef"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"]], ids=lambda f: f[0])
def test_flags_do_what_the_jax_launcher_does(flag, tmp_path, capsys):
    argv = ["--reduced", "--steps", "1", "--device", "cpu", *flag]
    if flag[0] == "--ckpt-dir":
        argv[-1] = str(tmp_path / "ckpt")
    if flag[0] in ("--coordinator", "--num-processes"):
        with pytest.raises(ValueError, match="coordinator|explicit rank"):
            launcher.main(argv)
        return
    out = launcher.main(argv)
    assert out["steps"] == 1 and math.isfinite(out["final_loss"])
    comp = "int8_ef" if flag[0] == "--grad-compression" else "none"
    assert _mesh_line(capsys) == ("1x1", "1", "0/1", "False", comp)
    if flag[0] == "--ckpt-dir":
        assert os.listdir(argv[-1]) == ["step_00000001"]
        argv[2] = "2"
        assert launcher.main(argv)["steps"] == 2
        assert sorted(os.listdir(argv[-1])) == ["step_00000001",
                                                "step_00000002"]


@pytest.mark.parametrize("flag,world", [(["--seq-parallel"], 1),
                                        (["--mesh", "2x4"], 8)],
                         ids=["--seq-parallel", "--mesh model axis"])
def test_unported_flag_raises(flag, world, monkeypatch):
    """Both flags are ported: what still refuses them is the int8 exchange,
    data-parallel only (the JAX launcher's ``ap.error``); at one process
    ``--seq-parallel`` trains."""
    from repro_torch.dist import compression as comp
    if world == 1:
        out = launcher.main(["--reduced", "--steps", "1", "--device", "cpu",
                             *flag])
        assert out["steps"] == 1 and math.isfinite(out["final_loss"])
    monkeypatch.setattr(comp, "world_size", lambda group=None: world)
    with pytest.raises(SystemExit):
        launcher.main(["--reduced", "--steps", "1", "--device", "cpu",
                       *flag, "--grad-compression", "int8_ef"])


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--steps", "1"])
