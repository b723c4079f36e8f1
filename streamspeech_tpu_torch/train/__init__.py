"""Training: the criterion, LR schedules, the optimizer with optax's semantics,
the train step and synthetic batches (``streamspeech_tpu/train/``)."""
