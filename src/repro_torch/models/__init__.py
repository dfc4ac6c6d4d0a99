from repro_torch.models.layers import dense_init, softmax_xent

__all__ = ["dense_init", "softmax_xent"]
