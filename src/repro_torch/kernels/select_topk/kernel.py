"""CUDA kernel for Hopper: fused Q-net scoring -> top-K cohort selection.

Replaces the TPU kernel ``src/repro/kernels/select_topk/kernel.py``
(``select_topk_pallas``).  The source is ``src/repro_torch/csrc/select_topk.cu``;
its header comment gives the bound on the card (fp32 FMAs: 2·N·(F·H + H² + H)
FLOPs against (F + 2)·4·N bytes) and the design: each tile of BM = 128 rows is
scored as a small register-tiled SGEMM (fp32 FMAs in a fixed order; for the
paths' Q-nets, H = 64 and F <= 32, the weights stay in shared memory and a
tile stages only its features; the first layer's activations stay in shared
memory up to H_pad = 320 and go through the scratch above), then

* ``K_pad <= 256`` ("carry"): a persistent grid, each CTA carrying its own
  top-K_pad in shared memory and letting in only rows that come before its
  K_pad-th entry; the last CTA of each group of 16, then the last group,
  merge the lists (integer tickets).  One launch at every N.
* ``K_pad > 256`` ("tree"): each tile's sorted best go to a scratch list,
  merged by a fixed tree of pairwise merges, one launch a level.

Any feature width F and hidden width H, 1 <= k <= N.  The result is exact
and deterministic: a row's score does not depend on the CTA, tile, path or
route that computes it.

``LIBRARY`` (:class:`~repro_torch.kernels._build.CudaLibrary`) compiles the
source with ``nvcc`` at first use into ``build/kernels/`` at the repository
root and binds it with ``ctypes``.  Nothing is built when this module is
imported.  The launch plan (:func:`launch_plan`: route, scoring path,
tiles, grid, shared memory and scratch bytes) is computed here from the source's
constants and the card's SM count and resident CTAs per SM; the C entry
checks it against its own formulas and refuses a mismatch.

Two entries launch the kernel, and both count into
``select_topk_cuda.launches`` (one per call, whatever the route):

* :func:`select_topk_cuda` takes device tensors and returns device tensors;
* :func:`select_topk_host` takes host arrays and returns host arrays: it
  packs states, mask and bias into one pinned record buffer
  (:func:`pack_records`), and one C call makes one upload, the launch, one
  download of the K_pad (value, index) pairs into pinned memory and one
  stream synchronise.  The buffers, the device scratch and the output live
  in a workspace kept per device and stream (:class:`Workspace`), and the Q-net's
  parameters are passed by pointer when they are contiguous fp32 on the
  card.  This is what the selection op calls every round.

Both take the plain version
(:func:`~repro_torch.kernels.select_topk.ref.select_topk_ref`) for CPU
tensors; any other device raises.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.select_topk.ref import select_topk_ref

# constants of csrc/select_topk.cu
THREADS = 256          # threads a CTA
BM = 128               # rows a tile
UC = 64                # hidden units a chunk: H is padded to a multiple
GROUP = 16             # CTAs a first-level merge group
CARRY_MAX = 256        # largest K_pad carried in shared memory
CAND = 256             # candidates merged at once
KC = 32                # k-rows a staged chunk
HP_SHARED = 320        # widest H_pad whose activations stay in shared memory
MAX_SMEM = 232448      # a CTA's shared memory on sm_90
TICKETS = 1024         # words of the carry route's ticket buffer
MAX_N = 2**31 - 1 - 256
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w3", "b3")


def _bind(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(i)
    lib.select_topk_smem_bytes.argtypes = [i, i, i]
    lib.select_topk_smem_bytes.restype = ll
    lib.select_topk_scratch_bytes.argtypes = [i, i, i, i, i]
    lib.select_topk_scratch_bytes.restype = ll
    lib.select_topk_path.argtypes = [i, i]
    lib.select_topk_path.restype = i
    lib.select_topk_occupancy.argtypes = [i, ll, ip, ip, ip]
    lib.select_topk_occupancy.restype = i
    lib.select_topk_launch.argtypes = [vp] * 9 + [i] * 5 + [vp, ll, vp, vp, vp, vp]
    lib.select_topk_launch.restype = i
    lib.select_topk_run.argtypes = [vp] * 8 + [i] * 5 + [vp, ll, vp, vp, vp, vp]
    lib.select_topk_run.restype = i


LIBRARY = CudaLibrary("select_topk", _bind)


def k_padded(k: int) -> int:
    return max(8, -(-int(k) // 8) * 8)


def hidden_padded(h: int) -> int:
    return -(-int(h) // UC) * UC


def route_of(k_pad: int) -> str:
    """``"carry"`` (one launch) for K_pad <= 256, else ``"tree"``."""
    return "carry" if k_pad <= CARRY_MAX else "tree"


PATHS = ("resident", "streamed", "global")   # the source's Path, in order


def path_of(f: int, h: int) -> str:
    """The scoring path: ``"resident"`` for H_pad = 64 and F <= 32 (the
    paths' Q-nets: w1 and w2 stay in shared memory for a CTA's life and a
    tile stages only its features); ``"streamed"`` for H_pad <= 320 (every
    operand staged, the first layer's activations in shared memory);
    ``"global"`` above (the activations through the CTA's slice of the
    scratch)."""
    hp = hidden_padded(h)
    if hp == UC and f <= KC:
        return "resident"
    return "streamed" if hp <= HP_SHARED else "global"


def smem_bytes(f: int, h: int, k_pad: int) -> int:
    """Shared memory of one CTA (``smem_words`` in the source, x 4)."""
    hp, path = hidden_padded(h), path_of(f, h)
    h1 = 0 if path == "global" else hp * BM
    operands = (2 * f * (BM + 4) + f * hp + hp * hp if path == "resident"
                else 2 * (KC * (BM + 4) + KC * UC))
    lists = 4 * k_pad if route_of(k_pad) == "carry" else 0
    return 4 * (h1 + operands + 3 * hp + lists + 4 * CAND + 16)


def tree_entries(n: int, k_pad: int) -> int:
    """Entries of each of the tree route's ping-pong list buffers: the
    largest level of the merge tree."""
    count, length = -(-n // BM), min(k_pad, BM)
    most = count * length
    while count > 1:
        count, length = (count + 1) // 2, min(2 * length, k_pad)
        most = max(most, count * length)
    return most


def scratch_bytes(n: int, f: int, h: int, k_pad: int, grid: int) -> int:
    """Carry: (grid + groups) lists of K_pad (value, index) pairs; tree: two
    ping-pong list buffers; then, on the global path, ``grid`` slices of
    [H_pad][BM] fp32 activations.  (The carry route's tickets live apart,
    in ``TICKETS`` words that stay zero between launches.)"""
    if route_of(k_pad) == "carry":
        sel = 8 * (grid + -(-grid // GROUP)) * k_pad
    else:
        sel = 16 * tree_entries(n, k_pad)
    h1 = 4 * grid * hidden_padded(h) * BM if path_of(f, h) == "global" else 0
    return sel + h1


@dataclass(frozen=True)
class Plan:
    """One launch's configuration."""

    route: str
    path: str          # scoring path: resident, streamed or global
    tiles: int
    grid: int          # CTAs
    groups: int        # first-level merge groups (carry)
    smem: int          # bytes a CTA
    scratch: int       # bytes
    launches: int      # kernels launched: 1, or 1 + ceil(log2(tiles)) for the tree


def launch_plan(n: int, f: int, h: int, k_pad: int, sms: int,
                per_sm: Union[int, Callable[[str, int], int]]) -> Plan:
    """The plan for N rows, F features, H hidden units and K_pad slots on a
    card of ``sms`` SMs; ``per_sm`` is the resident CTAs per SM (or a
    function of (scoring path, shared bytes) giving it)."""
    if not (1 <= n <= MAX_N and f >= 1 and 1 <= h <= 2**31 - 1 - UC
            and k_pad >= 8 and k_pad % 8 == 0 and k_pad <= k_padded(n)):
        raise ValueError(f"select_topk kernel does not take N={n}, F={f}, H={h}, "
                         f"K_pad={k_pad} (1 <= N < 2**31 - 256, F, H >= 1, "
                         f"K_pad a multiple of 8 up to N rounded up)")
    route, path = route_of(k_pad), path_of(f, h)
    tiles = -(-n // BM)
    smem = smem_bytes(f, h, k_pad)
    resident = per_sm(path, smem) if callable(per_sm) else per_sm
    grid = max(1, min(tiles, sms * max(1, resident), GROUP * (TICKETS - 1)))
    launches = 1 if route == "carry" else 1 + math.ceil(math.log2(tiles))
    return Plan(route, path, tiles, grid, -(-grid // GROUP), smem,
                scratch_bytes(n, f, h, k_pad, grid), launches)


# ---------------------------------------------------------------------------
# the record buffer: states, mask and bias in one upload
# ---------------------------------------------------------------------------


def record_floats(n: int, f: int) -> int:
    return n * (f + 2)


def pack_records(states: np.ndarray, mask: Optional[np.ndarray],
                 bias: Optional[np.ndarray], out: np.ndarray) -> np.ndarray:
    """Writes (N, F) states, then the (N,) mask, then the (N,) bias (zeros
    when None) as float32 into the first N·(F + 2) floats of ``out``; returns
    that view."""
    n, f = states.shape
    rec = out[:record_floats(n, f)]
    rec[:n * f].reshape(n, f)[...] = states
    rec[n * f:n * (f + 1)] = 1.0 if mask is None else mask
    rec[n * (f + 1):] = 0.0 if bias is None else bias
    return rec


def unpack_records(rec: np.ndarray, n: int, f: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Views (states (N, F), mask (N,), bias (N,)) of a record buffer."""
    return (rec[:n * f].reshape(n, f), rec[n * f:n * (f + 1)],
            rec[n * (f + 1):n * (f + 2)])


# ---------------------------------------------------------------------------
# the per-device workspace
# ---------------------------------------------------------------------------


def _grown(n: int) -> int:
    return 1 << max(10, (int(n) - 1).bit_length())


class Workspace:
    """What every launch on one card and stream reuses: the library, the
    card's SM count, resident CTAs per (path, shared bytes), plans, the
    device scratch, the ticket buffer (zeroed once; the kernel leaves it
    zero), the pinned and device record buffers and the device and pinned
    outputs.  Buffers grow to the next power of two and are kept.  Launches
    on one stream run one after another, so they may share the scratch and
    the tickets; another stream gets a workspace of its own."""

    def __init__(self, index: int):
        self.index = index
        self.device = torch.device("cuda", index)
        self.lib = LIBRARY.load()
        self.sms = torch.cuda.get_device_properties(index).multi_processor_count
        self._resident: Dict[Tuple[str, int], int] = {}
        self._plans: Dict[Tuple[int, int, int, int], Plan] = {}
        self._scratch: Optional[torch.Tensor] = None
        self.tickets = torch.zeros(TICKETS, dtype=torch.int32, device=self.device)
        self.tickets_ptr = self.tickets.data_ptr()
        self._rec: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self._out_views: Dict[int, Tuple[int, int, np.ndarray, np.ndarray]] = {}

    def occupancy(self, path: str, smem: int) -> Tuple[int, int, int]:
        """(resident CTAs per SM, registers a thread, local bytes a thread)
        of the kernel on scoring path ``path``."""
        per_sm, regs, local = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = call_on_device(self.index, self.lib.select_topk_occupancy, PATHS.index(path),
                             smem, ctypes.byref(per_sm), ctypes.byref(regs),
                             ctypes.byref(local))
        if err != 0:
            raise RuntimeError(f"select_topk occupancy query failed: CUDA error {err}")
        return per_sm.value, regs.value, local.value

    def resident(self, path: str, smem: int) -> int:
        key = (path, smem)
        if key not in self._resident:
            per_sm = self.occupancy(path, smem)[0]
            if per_sm < 1:
                raise RuntimeError(f"select_topk kernel does not fit an SM: {path} path, "
                                   f"{smem} bytes of shared memory")
            self._resident[key] = per_sm
        return self._resident[key]

    def plan(self, n: int, f: int, h: int, k_pad: int) -> Plan:
        key = (n, f, h, k_pad)
        p = self._plans.get(key)
        if p is None:
            p = launch_plan(n, f, h, k_pad, self.sms, self.resident)
            if (PATHS[self.lib.select_topk_path(f, h)] != p.path
                    or self.lib.select_topk_smem_bytes(f, h, k_pad) != p.smem
                    or self.lib.select_topk_scratch_bytes(n, f, h, k_pad, p.grid)
                    != p.scratch):
                raise RuntimeError("select_topk plan disagrees with the library's sizes")
            self._plans[key] = p
        return p

    def scratch(self, nbytes: int) -> int:
        if self._scratch is None or self._scratch.numel() < nbytes:
            self._scratch = torch.empty(_grown(nbytes), dtype=torch.uint8, device=self.device)
        return self._scratch.data_ptr()

    def records(self, nfloats: int) -> Tuple[np.ndarray, int, int]:
        """(pinned host view, its pointer, the device buffer's pointer)."""
        if self._rec is None or self._rec[0].numel() < nfloats:
            cap = _grown(nfloats)
            self._rec = (torch.empty(cap, dtype=torch.float32, pin_memory=True),
                         torch.empty(cap, dtype=torch.float32, device=self.device))
            self._rec_host = self._rec[0].numpy()
        host, dev = self._rec
        return self._rec_host, host.data_ptr(), dev.data_ptr()

    def outputs(self, k_pad: int) -> Tuple[int, int, np.ndarray, np.ndarray]:
        """(device pointer, pinned host pointer, host values view, host
        indices view): k_pad fp32 values, then k_pad int64 indices."""
        views = self._out_views.get(k_pad)
        if views is None:
            if self._out is None or self._out[0].numel() < 3 * k_pad:
                cap = _grown(3 * k_pad)
                self._out = (torch.empty(cap, dtype=torch.int32, pin_memory=True),
                             torch.empty(cap, dtype=torch.int32, device=self.device))
                self._out_views = {}
            host, dev = self._out
            hv = host.numpy()
            views = self._out_views[k_pad] = (
                dev.data_ptr(), host.data_ptr(), hv[:k_pad].view(np.float32),
                hv[k_pad:3 * k_pad].view(np.int64))
        return views


_WORKSPACES: Dict[Tuple[int, int], Workspace] = {}


def workspace(index: int, stream: int) -> Workspace:
    """The workspace of card ``index`` and raw stream handle ``stream``."""
    ws = _WORKSPACES.get((index, stream))
    if ws is None:
        ws = _WORKSPACES[index, stream] = Workspace(index)
    return ws


def launch_config(n: int, f: int, h: int, k: int, index: int = 0) -> dict:
    """The plan at these sizes on card ``index``, with the kernel's
    registers and local (spill) bytes a thread and resident CTAs per SM."""
    ws = workspace(index, stream_handle(index))
    p = ws.plan(n, f, h, k_padded(k))
    per_sm, regs, local = ws.occupancy(p.path, p.smem)
    return dict(route=p.route, path=p.path, tiles=p.tiles, grid=p.grid, groups=p.groups,
                smem=p.smem, scratch=p.scratch, resident_per_sm=per_sm, registers=regs,
                local_bytes=local, launches=p.launches)


# ---------------------------------------------------------------------------
# entries
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, feats on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _param_shapes(f: int, h: int):
    return ((f, h), (h,), (h, h), (h,), (h, 1), (1,))


def _hidden(params: Dict[str, torch.Tensor], f: int) -> int:
    w1 = params["w1"]
    h = int(w1.shape[1]) if w1.dim() == 2 else -1
    if f < 1 or h < 1:
        raise ValueError(f"select_topk kernel takes F >= 1 and H >= 1, got F={f}, H={h}")
    return h


def select_topk_cuda(params: Dict[str, torch.Tensor], feats: torch.Tensor,
                     mask: torch.Tensor, bias: torch.Tensor, *, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, F), mask (N,), bias (N,) float32 -> (values (k,) float32,
    indices (k,) int64), score descending, lowest-index ties, masked rows
    last.  Requires 1 <= k <= N; any F and H.

    CUDA tensors launch the kernel (and count the call); CPU tensors take
    the plain version; anything else raises.
    """
    if feats.device.type == "cpu":
        return select_topk_ref(params, feats, mask, bias, k=k)
    if feats.device.type != "cuda":
        raise ValueError(f"select_topk runs on cuda or cpu tensors, got "
                         f"{feats.device}")
    if feats.dim() != 2:
        raise ValueError(f"feats must be (N, F), got shape {tuple(feats.shape)}")
    n, f = feats.shape
    h = _hidden(params, f)
    if not 1 <= k <= n:
        raise ValueError(f"select_topk kernel takes 1 <= k <= N, got k={k}, N={n}")
    if n > MAX_N:
        raise ValueError(f"select_topk kernel takes N <= {MAX_N}, got {n}")
    dev = feats.device
    tensors = (feats, mask, bias) + tuple(params[name] for name in PARAM_NAMES)
    shapes = ((n, f), (n,), (n,)) + _param_shapes(f, h)
    for t, shape in zip(tensors, shapes):
        if (t.device != dev or t.dtype is not torch.float32 or t.shape != shape
                or not t.is_contiguous()):
            for name, tt, sh in zip(("feats", "mask", "bias") + PARAM_NAMES, tensors, shapes):
                _check(name, tt, sh, dev)

    stream = stream_handle(dev.index)
    ws = workspace(dev.index, stream)
    k_pad = k_padded(k)
    p = ws.plan(n, f, h, k_pad)
    out_v = torch.empty(k_pad, dtype=torch.float32, device=dev)
    out_i = torch.empty(k_pad, dtype=torch.int64, device=dev)
    err = call_on_device(
        ws.index, ws.lib.select_topk_launch, *(t.data_ptr() for t in tensors),
        n, f, h, k_pad, p.grid, ws.scratch(p.scratch), p.scratch, ws.tickets_ptr,
        out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error {err}")
    select_topk_cuda.launches += 1
    return out_v[:k], out_i[:k]


select_topk_cuda.launches = 0


def select_topk_host(params: Dict[str, torch.Tensor], states: np.ndarray,
                     mask: Optional[np.ndarray], bias: Optional[np.ndarray], *,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host states (N, F), mask (N,) (None: all valid) and bias (N,) (None:
    zeros) -> host (values (k,) float32, indices (k,) int64), fresh arrays,
    in the order of :func:`select_topk_cuda`.  Requires 1 <= k <= N.

    Parameters on the card: one C call (pinned upload, the launch, counted
    in ``select_topk_cuda.launches``, pinned download, one synchronise).
    Parameters on the CPU: the plain version.  Anything else raises.
    """
    dev = params["w1"].device
    states = np.asarray(states)
    n, f = states.shape
    if dev.type == "cpu":
        rec = pack_records(states, mask, bias, np.empty(record_floats(n, f), np.float32))
        x, m, b = (torch.from_numpy(a) for a in unpack_records(rec, n, f))
        plain = {name: params[name].detach().float() for name in PARAM_NAMES}
        vals, idx = select_topk_ref(plain, x, m, b, k=k)
        return vals.numpy(), idx.numpy()
    if dev.type != "cuda":
        raise ValueError(f"select_topk runs on cuda or cpu tensors, got {dev}")
    h = _hidden(params, f)
    if not 1 <= k <= n <= MAX_N:
        raise ValueError(f"select_topk kernel takes 1 <= k <= N <= {MAX_N}, "
                         f"got k={k}, N={n}")
    keep: List[torch.Tensor] = []          # converted parameters, alive for the call
    ptrs = []
    for name, shape in zip(PARAM_NAMES, _param_shapes(f, h)):
        t = params[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not (t.dtype == torch.float32 and t.device == dev and t.is_contiguous()):
            t = t.detach().to(dev, torch.float32).contiguous()
            keep.append(t)
        ptrs.append(t.data_ptr())
    stream = stream_handle(dev.index)
    ws = workspace(dev.index, stream)
    k_pad = k_padded(k)
    p = ws.plan(n, f, h, k_pad)
    host_rec, host_ptr, dev_ptr = ws.records(record_floats(n, f))
    pack_records(states, mask, bias, host_rec)
    dev_out, host_out, out_v, out_i = ws.outputs(k_pad)
    err = call_on_device(ws.index, ws.lib.select_topk_run, host_ptr, dev_ptr, *ptrs,
                         n, f, h, k_pad, p.grid, ws.scratch(p.scratch), p.scratch,
                         ws.tickets_ptr, dev_out, host_out, stream)
    if err != 0:
        raise RuntimeError(f"select_topk failed: CUDA error {err}")
    select_topk_cuda.launches += 1
    return out_v[:k].copy(), out_i[:k].copy()
