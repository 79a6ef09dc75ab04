"""slot_efficiency (%): useful samples over the sample slots the adaptive
driver dispatched (``GenerateStats``)."""


def read(ctx):
    c = ctx.counters
    slots = c.get("slots_dispatched", 0)
    return 100.0 * c["samples_used"] / slots if slots > 0 else None
