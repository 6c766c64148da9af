"""Admission: the median wait from submission to a slot
(``GenerationResult.queue_delay_s``) of the requests due in the window."""
from harness.common import nearest_rank


def read(layers):
    waits = layers.counts.get('queue_waits')
    return nearest_rank(waits, 0.5) if waits else None
