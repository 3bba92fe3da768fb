"""LAMB's device span a step (the program's ``train_step.optimizer``
range)."""
from bench.core.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train_step.optimizer")
