"""The benchmark harness of the PyTorch/CUDA port: what every cell shares.

``common`` finds a cell's files by name and holds the result line's
plumbing; ``weights`` makes a configuration's weights from the seed;
``traffic`` is the one generator every traffic mix is read by;
``trace`` reduces a ``torch.profiler`` trace to device busy time,
kernel time by name and named idle gaps; ``drivers/`` drive the port's
entry points (the diffusion engine, LM generation).
"""
