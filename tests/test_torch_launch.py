"""The port's single-device training launcher against the JAX package's.

* it takes every flag of ``src/repro/launch/train.py`` with the same
  default (read from that file's source), plus ``--device``;
* at ``--reduced --steps 3 --device cpu`` it trains qwen2-0.5b, prints the
  JAX launcher's ``arch=... params=...M`` line (the same parameter count)
  and ``loss a -> b`` line, and returns `Trainer.fit`'s result with a
  finite loss;
* each flag whose subsystem is not ported raises when set, naming its
  ROADMAP item;
* without ``--device``, on a host with no card, it raises instead of
  running on the CPU.
"""
import ast
import math
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


@pytest.mark.parametrize("flag", [
    ["--mesh", "2x4"], ["--ckpt-dir", "ckpt"], ["--seq-parallel"],
    ["--grad-compression", "int8_ef"], ["--obs-jsonl", "obs.jsonl"],
    ["--routing-stats"], ["--profile-dir", "prof"],
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"]], ids=lambda f: f[0])
def test_unported_flag_raises(flag):
    with pytest.raises(NotImplementedError, match=f"{flag[0]} .*ROADMAP"):
        launcher.main(["--reduced", "--steps", "1", "--device", "cpu",
                       *flag])


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--reduced", "--steps", "1"])
