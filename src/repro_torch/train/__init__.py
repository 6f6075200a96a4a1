"""Training: the optimizer, the step, synthetic data, checkpoints and the shard cache.

Counterpart of ``repro.train``, for the attention families (dense, moe,
vlm, encdec); see :mod:`.train_step`.
"""
