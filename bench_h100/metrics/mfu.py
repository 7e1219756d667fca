"""The whole step's share of the fp32 peak: model FLOPs of the tokens
processed in the window (prompts whose first token came in it at their
length, decoded tokens at their context; routed tokens at top-k, no
padding) over the window at 67 TFLOP/s."""


def read(run):
    return run.extra.get("mfu_pct")
