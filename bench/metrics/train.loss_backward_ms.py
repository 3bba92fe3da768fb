"""The forward and backward's device span a step (the program's
``train_step.loss_backward`` range)."""
from bench.core.readers import span_ms


def read(ctx):
    return span_ms(ctx, "train_step.loss_backward")
