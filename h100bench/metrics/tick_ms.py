"""An engine tick: the traced slice's wall over the whole ticks in it."""


def read(layers):
    n = layers.counts.get('ticks', 0)
    return 1000.0 * layers.slice.window_s / n if n else None
