"""PyTorch + CUDA port of the GEPO/HeteroRL system (``repro`` is the JAX
reference). Imports torch and numpy only: never jax, never ``repro``.

Slice 1 serves decoder-only attention models through the continuous
engine (``repro_torch.sampling``) with hand-written Hopper kernels for
paged decode and paged prefill (``repro_torch.kernels``). Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.
"""
