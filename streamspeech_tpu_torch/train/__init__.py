"""Training: the criterion, LR schedules, the optimizer with optax's semantics,
the train step, synthetic batches and the fairseq checkpoint import and
export (``streamspeech_tpu/train/``)."""
