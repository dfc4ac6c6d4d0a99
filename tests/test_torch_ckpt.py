"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference's (``repro.checkpoint``), on the CPU: the same format byte for
byte.

Each package reads the other's files bit-equal (fp32, bf16, int32 0-d,
Python scalars, strings, tuples, lists, ``None``, nested dicts whose keys
are not in sorted order), both write byte-identical files for the same
tree, under zstd and under the zlib fallback, and ``latest_checkpoint``
picks the highest step.
"""
import collections
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint.msgpack_ckpt as JC
import repro_torch.checkpoint.msgpack_ckpt as PC
from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree
from repro_torch.convert import params_from_numpy

Pair = collections.namedtuple("Pair", "first second")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "h": rng.normal(size=(5,)).astype(np.float32).astype(ml_dtypes.bfloat16),
            "step": np.asarray(7, np.int32),
            "ids": rng.integers(0, 100, size=(2, 3)).astype(np.int32)}


def _trees(seed=0):
    """The same tree for both packages: jnp arrays for the reference,
    tensors for the port; dict keys deliberately out of order."""
    a = _arrays(seed)
    t = params_from_numpy(a, "cpu")

    def build(x):
        return {"zeta": {"w": x["w"], "b16": x["h"]},
                "alpha": [x["ids"], None, (x["step"], "hi"), Pair(3, 1.5)],
                "mid": {"step": x["step"], "flag": True}}

    return build({k: jnp.asarray(v) for k, v in a.items()}), build(t)


def _bits(x):
    if isinstance(x, torch.Tensor):
        t = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return str(x.dtype).replace("torch.", ""), t.numpy()
    x = np.asarray(x)
    return str(x.dtype), (x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x)


def _assert_same(got, want):
    """``got`` (a port load) equals ``want`` (a reference load or tree),
    leaf by leaf: dtype name and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is (tuple if isinstance(want, tuple) else list)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif want is None:
        assert got is None
    else:
        (gd, gb), (wd, wb) = _bits(got), _bits(want)
        assert gd == wd and gb.shape == wb.shape and np.array_equal(gb, wb), (gd, wd)


def test_port_round_trip(tmp_path):
    _, tree = _trees()
    path = str(tmp_path / "step_1.ckpt")
    save_pytree(tree, path)
    back = load_pytree(path)
    _assert_same(back, tree)
    assert back["zeta"]["b16"].dtype == torch.bfloat16
    assert back["mid"]["step"].dtype == torch.int32 and back["mid"]["step"].shape == ()
    assert back["alpha"][3] == (torch.tensor(3), torch.tensor(1.5, dtype=torch.float64))
    assert str(back["alpha"][2][1]) == "hi"


@pytest.mark.parametrize("zstd", [True, False])
def test_reference_and_port_read_each_other_and_write_the_same_bytes(tmp_path, monkeypatch,
                                                                    zstd):
    if not zstd:
        monkeypatch.setattr(JC, "zstandard", None)
        monkeypatch.setattr(PC, "zstandard", None)
    jtree, ttree = _trees(1)
    jpath, tpath = str(tmp_path / "ref.ckpt"), str(tmp_path / "port.ckpt")
    JC.save_pytree(jtree, jpath)
    save_pytree(ttree, tpath)
    jbytes, tbytes = open(jpath, "rb").read(), open(tpath, "rb").read()
    assert jbytes == tbytes
    assert (jbytes[:4] == PC._ZSTD_MAGIC) == zstd
    _assert_same(load_pytree(jpath), JC.load_pytree(jpath))
    _assert_same(load_pytree(jpath), ttree)
    _assert_same(PC.load_pytree(tpath), JC.load_pytree(tpath))
    assert not os.path.exists(tpath + ".tmp")


def test_a_zstd_file_without_zstandard_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "z.ckpt")
    save_pytree({"a": torch.ones(2)}, path)
    monkeypatch.setattr(PC, "zstandard", None)
    with pytest.raises(RuntimeError, match="zstandard"):
        load_pytree(path)


def test_train_state_round_trip(tmp_path):
    """A train state: bf16 params, fp32 moments, the int32 step."""
    from repro_torch.configs import get_model_config
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.models import transformer as T

    cfg = get_model_config("hymba-1.5b", smoke=True)
    params = {k: v for k, v in T.init_params(0, cfg, "cpu").items()}
    params["embed"] = params["embed"].to(torch.bfloat16)
    state = {"params": params, "opt": make_optimizer().init(params)}
    path = str(tmp_path / "step_3.ckpt")
    save_pytree(state, path)
    _assert_same(load_pytree(path), state)


def test_latest_checkpoint(tmp_path):
    d = str(tmp_path / "ckpts")
    assert latest_checkpoint(d) is None
    os.makedirs(d)
    for step in (5, 40, 12):
        save_pytree({"s": step}, os.path.join(d, f"step_{step}.ckpt"))
    open(os.path.join(d, "step_99.ckpt.tmp"), "wb").close()
    open(os.path.join(d, "other_100.ckpt"), "wb").close()
    assert latest_checkpoint(d) == os.path.join(d, "step_40.ckpt")
    assert latest_checkpoint(d) == JC.latest_checkpoint(d)
    assert latest_checkpoint(d, prefix="other_") == os.path.join(d, "other_100.ckpt")
