"""Training substrate: optimizer, train step, data pipeline, checkpoints
(counterpart of `repro.training`)."""
