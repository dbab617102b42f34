"""shrewd_tpu_torch — the PyTorch/CUDA port of the fault-injection framework.

A second package beside the JAX reference ``shrewd_tpu``: the same per-trial
threefry keys, the same µop semantics and the same four outcome classes,
with the deviation-set fast pass and its chunk variant as CUDA kernels
written for Hopper (``csrc/taint_fast.cu``).  It imports torch and numpy, never jax and
nothing of ``shrewd_tpu``; ``compat`` carries the reference's inputs across.
The paths mirror the reference's:

- ``isa``    — the µop opcode/OpClass tables
- ``trace``  — the ``Trace`` window
- ``native`` — ctypes binding to the serial C++ runtime in ``csrc/``
- ``utils``  — config objects and the threefry PRNG
- ``models`` — the O3 fault-target model (regfile slice)
- ``ops``    — dense scan, deviation-set scans, the CUDA kernels, the
  trial runner ``TrialKernel``, and chunked replay (``window``,
  ``chunked.ChunkedCampaign``)
- ``parallel`` — the trace digest that keys preprocessed windows

Entry points run on the CUDA card unless the caller passes
``device="cpu"``.  The slices so far cover the regfile trial path end to
end and SimPoint-scale chunked replay.
"""

__version__ = "0.1.0"
