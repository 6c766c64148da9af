"""The share of the traced slice in which nothing ran on the device: 1
minus the union of the device operations' intervals over the slice's
wall, in %."""


def read(layers):
    sl = layers.slice
    if sl.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
