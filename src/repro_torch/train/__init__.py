"""Training: synthetic data, AdamW / Adafactor, the train step,
checkpoints and the supervised loop -- the counterpart of
``repro.train``."""
