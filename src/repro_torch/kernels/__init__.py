"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

    select_topk    fused Q-net scoring -> top-K cohort selection (CUDA C++,
                   csrc/select_topk.cu); ops.select_topk is the port's
                   selection path
    pairwise_rank  masked pairwise RankNet loss and its score gradient in
                   one launch (CUDA C++, csrc/pairwise_rank.cu);
                   ops.pairwise_rank is the imitation-learning objective
    fleet_state    trace segment lookup, the state of every fleet device at
                   its time (CUDA C++, csrc/fleet_state.cu); ops.segment_index
                   is every trace scenario's mask and load query
    flash_attention
                   GQA prefill attention with causal and sliding-window
                   masks (CUDA C++, csrc/flash_attention.cu);
                   ops.flash_attention is the LM prefill's attention
    mamba          Mamba-1 selective scan, the state in registers (CUDA C++,
                   csrc/mamba.cu); ops.selective_scan is Hymba's Mamba heads'
                   prefill scan
    rwkv6          RWKV6 WKV recurrence with data-dependent decay (CUDA C++,
                   csrc/rwkv6.cu); ops.wkv6_heads is RWKV6's prefill WKV core

``_build`` compiles each source with ``nvcc`` at first use and binds it with
``ctypes``.
"""
