"""device_idle_pct (%): 100 x (1 - the union of the card's kernel and copy
intervals over the traced stretch of whole jobs); left out where the trace
shows no device work."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace["device_idle_pct"]
