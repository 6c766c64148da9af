"""The whole step's share of the card's peak: the model's products of
the traced batch at their precision's peak (``roofline.shares``) over
the wall of the same prompts' batch run untraced in the window.  The
profiler's launch records lengthen a host-bound decode step, so the
traced batch's own wall would read the profiler as lost work."""
from roofline.shares import mfu


def read(layers):
    wall = layers.counts.get('untraced_wall_s')
    return mfu(layers, wall) if wall else None
