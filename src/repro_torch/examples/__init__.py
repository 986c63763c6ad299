"""The JAX package's examples on the port, one module each, run as
``python -m repro_torch.examples.<name>``: ``quickstart`` (SFT warm start
then GEPO online RL), ``hetero_train`` (HeteroRL: 1 learner, 4 samplers
over simulated WAN latency) and ``serve_batch`` (batched serving through
the launcher). Each runs on ``cuda`` unless ``--device cpu`` is given,
and keeps its constants in ``main``'s keyword arguments, so a caller can
run it at a cut."""
