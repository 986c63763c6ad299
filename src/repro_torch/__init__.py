"""PyTorch + CUDA port of the GEPO/HeteroRL system (``repro`` is the JAX
reference). Imports torch and numpy only: never jax, never ``repro``.

It serves decoder-only attention models through the continuous engine
(``repro_torch.sampling``) with hand-written Hopper kernels for paged
decode and paged prefill, and trains them with the GEPO learner step
(``repro_torch.training``), whose token log-probs and their gradient run
through hand-written fused log-prob kernels (``repro_torch.kernels``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
