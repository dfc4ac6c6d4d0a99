"""The one-pass SGD update op ``repro_torch::sgd_update`` on the CPU.

* On CPU tensors the op is the vmapped executor's update as it was before
  the kernel, bit for bit: fp32 and bf16, a broadcast ``a`` (an
  ``expand``, client stride 0) and a stacked one, leaves below and above
  ``STACKED_STEP_CHUNK`` (the client-by-client route);
* ``torch.library.opcheck`` passes; the fake implementation gives a fresh
  contiguous output of ``a``'s shape and dtype, and refuses what the CUDA
  wrapper refuses without data (a client block that is not contiguous);
* the op refuses mismatched shapes, dtypes and devices, and other dtypes;
* on the CPU no kernel launches, and an observed round records the update's
  counters (0 launches, no element on the kernel);
* the benchmark's "state unchanged" fault, ``client._sgd_stacked``
  replaced by an identity, still takes effect: the executor hands back the
  init params.

The CUDA launch is held bit-equal to the plain version on the card by
``chip_smoke.py``'s ``sgd_update`` step.
"""
import numpy as np
import pytest
import torch

import repro_torch.fl as tfl
import repro_torch.fl.client as client
from repro_torch.fl._tree import tree_leaves
from repro_torch.fl.engine import ClientRequest, VmappedExecutor
from repro_torch.kernels.sgd_update import ops, ref, sgd_update, sgd_update_cuda
from repro_torch.kernels.sgd_update.kernel import check_launch
from repro_torch.kernels.work import op_work
from repro_torch.obs import RunRecorder, clear_profiler, set_profiler

LR = 0.1


def _parent_sgd_stacked(lr, chunk):
    """The executor's update before the op (fl/client.py, unchanged but for
    the chunk as an argument): five fp32 passes, client by client past
    ``chunk`` elements."""
    step = lambda a, g: (a.float() - lr * g.float()).to(a.dtype)  # noqa: E731

    def one(a, g):
        if a.numel() <= chunk:
            return step(a, g)
        out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
        for j in range(a.shape[0]):
            out[j] = step(a[j], g[j])
        return out
    return one


def _leaf(kind, k, shape, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    g = (torch.randn((k,) + shape, generator=gen) * 3).to(dtype)
    if kind == "broadcast":
        a = torch.randn(shape, generator=gen).to(dtype).unsqueeze(0).expand((k,) + shape)
    else:
        a = torch.randn((k,) + shape, generator=gen).to(dtype)
    return a, g


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


CASES = [(kind, dtype, route)
         for kind in ("broadcast", "stacked")
         for dtype in (torch.bfloat16, torch.float32)
         for route in ("whole", "client_by_client")]


@pytest.mark.parametrize("kind,dtype,route", CASES,
                         ids=[f"{k}-{str(d)[6:]}-{r}" for k, d, r in CASES])
def test_op_on_cpu_is_the_parents_update_bit_for_bit(monkeypatch, kind, dtype, route):
    a, g = _leaf(kind, 5, (33, 24), dtype, seed=len(kind) + len(route))
    chunk = a.numel() if route == "whole" else a.numel() - 1
    monkeypatch.setattr(ref, "STACKED_STEP_CHUNK", chunk)
    for lr in (LR, 0.0123, 1.0):
        got = sgd_update(a, g, lr)
        want = _parent_sgd_stacked(lr, chunk)(a, g)
        assert got.dtype == dtype and got.shape == a.shape and got.is_contiguous()
        assert torch.equal(_bits(got), _bits(want.contiguous()))
        assert got.untyped_storage().data_ptr() not in (
            a.untyped_storage().data_ptr(), g.untyped_storage().data_ptr())


def test_default_chunk_is_the_parents():
    assert ref.STACKED_STEP_CHUNK == 1 << 26


@pytest.mark.parametrize("kind", ["broadcast", "stacked"])
def test_opcheck(kind):
    a, g = _leaf(kind, 3, (4, 8), torch.float32, seed=1)
    torch.library.opcheck(ops.OP, (a, g, LR))


@pytest.mark.parametrize("kind", ["broadcast", "stacked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_fake_gives_a_fresh_contiguous_leaf(kind, dtype):
    g = torch.empty(4, 6, 16, dtype=dtype, device="meta")
    a = (torch.empty(6, 16, dtype=dtype, device="meta").expand(4, 6, 16)
         if kind == "broadcast" else torch.empty_like(g))
    out = sgd_update(a, g, LR)
    assert out.device.type == "meta" and out.dtype == dtype and out is not a
    assert out.shape == a.shape and out.stride() == (96, 16, 1)


def test_fake_refuses_a_client_block_that_is_not_contiguous():
    a = torch.empty(3, 8, 4, device="meta")
    bad = torch.empty(3, 4, 8, device="meta").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        sgd_update(a, bad, LR)
    with pytest.raises(ValueError, match="contiguous"):
        sgd_update(bad, a, LR)
    # a client stride of its own is taken: a slice of a longer client axis
    wide = torch.empty(3, 8, 6, device="meta")
    check_launch(a, torch.empty(3, 40, device="meta")[:, :32].view(3, 8, 4))
    with pytest.raises(ValueError, match="contiguous"):
        check_launch(a, wide[:, :, :4])


@pytest.mark.parametrize("case", ["shape", "dtype", "device", "int", "scalar"])
def test_op_refuses_malformed_inputs(case):
    a = torch.zeros(2, 3)
    g = {"shape": torch.zeros(2, 4), "dtype": torch.zeros(2, 3, dtype=torch.bfloat16),
         "device": torch.zeros(2, 3, device="meta"), "int": torch.zeros(2, 3),
         "scalar": torch.zeros(())}[case]
    if case == "int":
        a, g = a.long(), g.long()
    if case == "scalar":
        a = torch.zeros(())
    with pytest.raises((ValueError, RuntimeError)):
        sgd_update(a, g, LR)
    with pytest.raises(ValueError):
        sgd_update_cuda(a, g, LR)


def test_wrapper_refuses_other_devices():
    a = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sgd_update_cuda(a, a, LR)


def test_work_formula_counts_two_operations_an_element():
    a, g = _leaf("broadcast", 4, (5, 6), torch.float32, seed=3)
    assert op_work("sgd_update", (a, g, LR)) == (2.0 * 4 * 5 * 6, 0.0)


def _requests(k=4, per=12, dim=8, classes=4, seed=0):
    """k clients of ``per`` samples each, two local epochs."""
    rng = np.random.default_rng(seed)
    return [ClientRequest(client_id=c, x=rng.normal(size=(per, dim)).astype(np.float32),
                          y=rng.integers(0, classes, size=per), epochs=2, seed=c)
            for c in range(k)]


def _run_executor(task, params):
    return VmappedExecutor().run(task, params, _requests(), lr=LR, batch_size=4,
                                 prox_mu=0.0)


def test_state_unchanged_fault_still_takes_effect(monkeypatch):
    task = tfl.MLPTask(dim=8, hidden=16, n_classes=4)
    params = task.init(0, device="cpu")
    trained = _run_executor(task, params)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(trained.params[0]), tree_leaves(params)))
    monkeypatch.setattr(client, "_sgd_stacked", lambda lr: (lambda a, g: a))
    out = _run_executor(task, params)
    for cid in range(4):
        for a, b in zip(tree_leaves(out.params[cid]), tree_leaves(params)):
            assert torch.equal(a, b)


def test_observed_step_records_the_update_counters():
    task = tfl.MLPTask(dim=8, hidden=16, n_classes=4)
    params = task.init(0, device="cpu")
    before = sgd_update_cuda.launches
    rec = RunRecorder(device_event=lambda: None)
    set_profiler(rec)
    try:
        out = _run_executor(task, params)
        rec.flush_round(round=0)
    finally:
        clear_profiler(rec)
    counters = rec.records[-1]["metrics"]["counters"]
    leaves = len(tree_leaves(params))
    steps = 2 * (16 // 4)                          # 2 epochs of 4 batches (cap 16)
    assert counters["sgd_update.launches"] == 0 == sgd_update_cuda.launches - before
    assert counters["sgd_update.kernel_elements"] == 0
    assert counters["sgd_update.elements"] == 4 * steps * sum(
        t.numel() for t in tree_leaves(params))
    assert len([s for s in rec.records[-1]["spans"] if s["span"].endswith("sgd_update")]) \
        == steps and leaves > 1
    assert out.params[0] is not None
