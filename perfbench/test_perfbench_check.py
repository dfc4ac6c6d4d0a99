"""The check that decides ``correct``, on the CPU at the smoke size: the
reference against the port in fp32, the fp8 control, and a run with the
timed path broken underneath."""
import math

import pytest
import torch

from perfbench import bench, check
from perfbench.calibrate import readings
from perfbench.smoke import smoke_spec

CELLS = ["yi6b-fl-fedrank", "olmoe-1b-7b-fl-fedrank", "yi6b-fl-fedavg"]
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_port_in_fp32(cell):
    """The port and the reference agree to fp32 rounding over the checked
    rounds (FedRank: five rounds, the TD steps of the fifth included)."""
    got = readings(cell, SEED, control=False, device="cpu", spec=smoke_spec(cell))
    nums = got["program"]
    for name, value in nums.items():
        # Adam's first steps divide by |g|: the Q-net's change follows fp32
        # round-off to a few 1e-4 of its norm
        assert value <= (2e-3 if name == "qnet" else 1e-5), (name, value)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference one precision below the configuration (fp8 weights and
    products, a bf16 Q-net) in the program's place is not correct."""
    wl, _, _ = bench.load_cell(cell)
    got = readings(cell, SEED, control=True, device="cpu", spec=smoke_spec(cell, "bfloat16"))
    assert not check.verdict(got["control"], wl["limits"]), got["control"]


def _state_unchanged(monkeypatch):
    from repro_torch.fl import client, engine
    monkeypatch.setattr(client, "_sgd_stacked", lambda lr: (lambda a, g: a))
    engine._bucket_step.cache_clear()


def _half_batch(monkeypatch):
    from repro_torch.fl.tasks import LMTask
    loss = LMTask.loss

    def half(self, p, batch):
        cut = {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v) for k, v in batch.items()}
        return loss(self, p, cut)
    monkeypatch.setattr(LMTask, "loss", half)


def _answer_altered(monkeypatch):
    from repro_torch.fl.server import FLServer
    evaluate = FLServer._evaluate

    def off(self):
        acc, loss = evaluate(self)
        return acc, loss * 1.01
    monkeypatch.setattr(FLServer, "_evaluate", off)


def _cohort_altered(monkeypatch):
    from repro_torch.core import fedrank
    pick = fedrank.select_topk

    def worst_cut(scores_fn, states, mask, k, **kw):
        idx, vals = pick(scores_fn, states, mask, len(states), **kw)
        return idx[::-1][:k].copy(), vals[::-1][:k].copy()
    monkeypatch.setattr(fedrank, "select_topk", worst_cut)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "cohort_altered": _cohort_altered}


# FedAvg's cohort is a random draw: it makes no cut that could be altered
RUNS = [(c, f) for c in CELLS for f in [None] + sorted(FAULTS)
        if not (f == "cohort_altered" and "fedavg" in c)]


@pytest.mark.parametrize("cell,fault", RUNS)
def test_run_with_broken_path_is_not_correct(cell, fault, monkeypatch):
    """A whole run past the look for a chip: correct when nothing is broken,
    not correct with each fault the cell can have planted underneath."""
    from repro_torch.fl import engine
    if fault is not None:
        FAULTS[fault](monkeypatch)
    try:
        out = bench.run(cell, SEED, 0.01, False, 0.0, device="cpu", spec=smoke_spec(cell))
    finally:
        engine._bucket_step.cache_clear()
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks"
    assert all(math.isfinite(r["value"]) or fault for r in out["checks"].values())
