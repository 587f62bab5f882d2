"""Optimizers of the training path (AdamW, SGD) and their schedules."""
