"""Process-wide helpers of the campaign layers (this slice: the trace
digest that keys preprocessed windows)."""
