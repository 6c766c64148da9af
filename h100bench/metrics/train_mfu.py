"""The whole step's share of the card's peak: the model's products at
their precision's peak over the traced slice's wall (``roofline.shares``)."""
from roofline.shares import mfu


def read(layers):
    return mfu(layers)
