"""Special token ids, shared with the JAX package's tokenizer
(``repro/data/tasks.py``)."""

PAD, BOS, EOS = 0, 1, 2
