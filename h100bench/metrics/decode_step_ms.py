"""A decode step: all the window's decode time over its decode steps, on
the host clock ended by a device sync, the traced batch left out."""


def read(layers):
    n = layers.counts.get('decode_steps', 0)
    return 1000.0 * layers.counts['decode_s'] / n if n else None
