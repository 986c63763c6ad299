from repro_torch.checkpoint.store import PolicyStore, load_pytree, save_pytree

__all__ = ["PolicyStore", "save_pytree", "load_pytree"]
