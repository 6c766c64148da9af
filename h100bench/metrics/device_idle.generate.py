"""The share of a batch's time in which nothing ran on the device: 1
minus the traced batch's busy device time (the union of its device
operations' intervals) over the wall of the same prompts' batch run
untraced in the window, in %.  The profiler's launch records lengthen a
host-bound decode step by about a quarter, which the traced batch's own
wall would read as idle device time."""


def read(layers):
    wall = layers.counts.get('untraced_wall_s')
    if not wall:
        return None
    return 100.0 * (1.0 - layers.slice.busy_s / wall)
