"""Images served in the traced slice over the seconds in which the card was
busy in it (``torch.profiler``'s trace): the served forward's rate on the
card alone. ``serve_img_per_s`` follows the host's pace, which varies from
run to run; this rate moves only with the card's own work."""


def read(rec):
    images = rec.counters.get("slice_images")
    if rec.slice is None or not images or rec.slice.busy_s <= 0:
        return None
    return images / rec.slice.busy_s
