"""Hand-written Hopper kernels of the port, their plain PyTorch twins, and
the entry points the model calls (``ops``). Kernels are built at first
use (``build``), never at import."""
