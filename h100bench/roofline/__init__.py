"""The yardstick of the per-layer metrics: the H100's data-sheet peaks,
and the operations and bytes each kernel and each model step needs,
counted from the shapes a window ran."""
