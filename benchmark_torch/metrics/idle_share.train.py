"""Percent of the traced slice in which no kernel, copy or memset ran on
the card (``torch.profiler``'s trace)."""


def read(rec):
    return None if rec.slice is None else rec.slice.idle_share()
