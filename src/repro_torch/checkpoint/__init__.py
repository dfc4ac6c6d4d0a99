from repro_torch.checkpoint.msgpack_ckpt import load_pytree, save_pytree, latest_checkpoint

__all__ = ["save_pytree", "load_pytree", "latest_checkpoint"]
