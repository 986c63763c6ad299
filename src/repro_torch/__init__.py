"""PyTorch + CUDA port of the GEPO/HeteroRL system (``repro`` is the JAX
reference). Imports torch and numpy only: never jax, never ``repro``.

It serves decoder-only attention models (Qwen3, Gemma2) through the
continuous engine, with hand-written Hopper kernels for paged decode and
paged prefill, and through the static engine, whose prefill runs the
hand-written dense flash kernel under ``attn_impl="pallas"``
(``repro_torch.sampling``). It trains them with the GEPO learner step
(``repro_torch.training``), whose token log-probs and their gradient run
through hand-written fused log-prob kernels (``repro_torch.kernels``).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
