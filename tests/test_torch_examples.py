"""The port's examples (``examples/torch/``) run end to end on the CPU.

Each example's ``main`` runs with ``--device cpu`` at the smallest sizes:
flags where the example has them, its module constants where it has none
(the quickstart's fleet and pretraining sizes, the pipeline's IL sizes).
``fl_end_to_end.py --arch`` trains each served family's reduced LM as the
global model and refuses the families the port does not run yet.  No
example imports JAX or the JAX package.
"""
import ast
import importlib.util
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples" / "torch"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples run thousands of small steps. With the suite's workers
    sharing the cores, every intra-op thread team waits on descheduled
    threads (``fl_end_to_end --arch yi-6b`` took 427 s that way against 3 s
    alone); one thread keeps each example at its own cost.  The checks read
    the printed report, not its digits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _small_pipeline(mod, monkeypatch):
    monkeypatch.setattr(mod, "ROUNDS_PER_EXPERT", 1)
    monkeypatch.setattr(mod, "N_SYNTHETIC", 4)
    monkeypatch.setattr(mod, "IL_STEPS", 2)


@pytest.mark.parametrize("path", sorted(EXAMPLES.glob("*.py")), ids=lambda p: p.name)
def test_examples_import_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (path, mod)


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    mod = _load("quickstart")
    for name, value in (("N_SAMPLES", 800), ("N_DEVICES", 8), ("K", 2), ("ROUNDS", 1)):
        monkeypatch.setattr(mod, name, value)
    _small_pipeline(mod, monkeypatch)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "IL pretrain: pairwise ranking accuracy" in out
    assert "fedavg" in out and "fedrank " in out and "fedrank (async)" in out


@pytest.mark.parametrize("arch", [None, "yi-6b", "h2o-danube-3-4b", "hymba-1.5b",
                                  "rwkv6-3b"])
def test_fl_end_to_end_runs_on_the_cpu(arch, monkeypatch, capsys):
    mod = _load("fl_end_to_end")
    monkeypatch.setattr(mod, "N_SAMPLES", 800)
    monkeypatch.setattr(mod, "LM_TOKENS", 3000)
    _small_pipeline(mod, monkeypatch)
    argv = ["--device", "cpu", "--rounds", "1", "--devices", "6", "--k", "2"]
    mod.main(argv + (["--arch", arch] if arch else []))
    out = capsys.readouterr().out
    for name in mod.POLICY_NAMES:
        assert f"\n{name}" in out or out.startswith(name), name
    assert "time/energy to" in out


def test_fl_end_to_end_async_vmapped_on_the_cpu(monkeypatch, capsys):
    mod = _load("fl_end_to_end")
    monkeypatch.setattr(mod, "N_SAMPLES", 800)
    _small_pipeline(mod, monkeypatch)
    mod.main(["--device", "cpu", "--rounds", "1", "--devices", "6", "--k", "2",
              "--mode", "async", "--executor", "vmapped", "--scenario", "high-churn"])
    assert "fedrank" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe", "whisper-medium",
                                  "internvl2-76b"])
def test_fl_end_to_end_refuses_unported_families(arch, monkeypatch, capsys):
    """The MoE models run a round as the FL global model; whisper and
    InternVL2 are refused by name, since the synthetic LM data has no
    frontend embeddings for them (as in the reference's example)."""
    mod = _load("fl_end_to_end")
    if arch in ("whisper-medium", "internvl2-76b"):
        with pytest.raises(SystemExit, match="frontend embeddings"):
            mod.main(["--device", "cpu", "--arch", arch])
        return
    monkeypatch.setattr(mod, "N_SAMPLES", 800)
    monkeypatch.setattr(mod, "LM_TOKENS", 3000)
    _small_pipeline(mod, monkeypatch)
    mod.main(["--device", "cpu", "--rounds", "1", "--devices", "6", "--k", "2",
              "--arch", arch])
    out = capsys.readouterr().out
    for name in mod.POLICY_NAMES:
        assert f"\n{name}" in out or out.startswith(name), name
    assert "time/energy to" in out


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b", "hymba-1.5b", "olmoe-1b-7b",
                                  "whisper-medium", "internvl2-76b"])
def test_serve_lm_runs_on_the_cpu(arch, capsys):
    _load("serve_lm").main(["--device", "cpu", "--arch", arch, "--batch", "2",
                            "--prompt-len", "8", "--gen", "4"])
    assert "decode:" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-3b", "phi3.5-moe", "whisper-medium"])
def test_continuous_batching_runs_on_the_cpu(arch, capsys):
    _load("continuous_batching").main(["--device", "cpu", "--arch", arch, "--slots", "2",
                                       "--requests", "3", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "completed=3" in out and "tokens=9" in out


def test_train_lm_runs_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "step_100.ckpt")
    _load("train_lm").main(["--device", "cpu", "--steps", "100", "--batch", "8",
                            "--seq", "32", "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "OK: loss" in out and f"checkpoint -> {ckpt}" in out
