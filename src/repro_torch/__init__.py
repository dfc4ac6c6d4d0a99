"""repro_torch — the FedRank reproduction ported to PyTorch and CUDA (Hopper).

A self-contained package beside the JAX reference ``repro``: it imports
``torch`` and ``numpy`` and nothing of ``repro``, and mirrors its layout so
each counterpart is easy to find:

    configs     the model zoo's architectures and input shapes (data, the
                reference's copy)
    data        synthetic datasets + Dirichlet federated partitioning, the
                LM token stream (numpy)
    models      the layers the FL tasks use (``dense_init``, ``softmax_xent``)
                and the LM for the attention, SSM and hybrid families
                (``layers``, ``attention``, ``ssm``, ``transformer``)
    launch      LM serving: prefill + decode (``serve``), continuous
                batching (``scheduler``), step functions (``steps``)
    fl          device simulator, scenarios and trace replay, client
                training, the synchronous server and the asynchronous
                engine, aggregation and the policy registry
    core        features, the ranking Q-net, pairwise losses, double-Q
                learning, imitation-learning pretraining against the
                analytical experts, FedRank and the paper's baselines
    kernels     hand-written CUDA kernels with their plain PyTorch versions
    convert     parameter dicts between numpy (the reference's arrays) and
                torch

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise instead of falling back.
Parameters keep the reference's layout at public functions: dicts of
``w1, b1, w2, b2, w3, b3`` with every ``w`` shaped ``(in, out)``, and the
LM's nested dict with layer leaves stacked over L.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__version__ = "0.1.0"

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  A CUDA device that is not there raises: the
    port never quietly runs on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
