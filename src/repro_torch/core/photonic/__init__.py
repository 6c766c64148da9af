"""DiffLight's photonic model, port of ``repro/core/photonic``: the device
table and loss budget (``devices``), the architecture and its design
space (``arch``), a UNet's per-step operation counts (``workload``), the
performance/energy simulator (``simulator``), the published comparison
points (``baselines``) and the analog-noise model of the W8A8 datapath
(``noise``).  All but ``noise`` and ``workload`` are copies of the
reference's pure-Python modules."""
