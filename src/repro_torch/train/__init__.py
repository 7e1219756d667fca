"""Training: AdamW (``optim``) and the train-step builder (``step``)."""
