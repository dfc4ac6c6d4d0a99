"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

    select_topk  fused Q-net scoring -> top-K cohort selection (CUDA C++,
                 csrc/select_topk.cu); ops.select_topk is the port's
                 selection path
"""
