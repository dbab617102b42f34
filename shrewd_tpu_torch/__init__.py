"""shrewd_tpu_torch — the PyTorch/CUDA port of the fault-injection framework.

A second package beside the JAX reference ``shrewd_tpu``: the same per-trial
threefry keys, the same µop semantics and the same four outcome classes,
with the deviation-set fast pass and its chunk variant as CUDA kernels
written for Hopper (``csrc/taint_fast.cu``).  It imports torch and numpy, never jax and
nothing of ``shrewd_tpu``; ``compat`` carries the reference's inputs across.
The paths mirror the reference's:

- ``isa``    — the µop opcode/OpClass tables
- ``trace``  — the ``Trace`` window, its ``.npz`` format, the synthetic
  workload generator
- ``native`` — ctypes binding to the serial C++ runtime in ``csrc/``
- ``utils``  — config objects, the threefry PRNG, debug flags, probes
- ``models`` — the O3 fault targets, the timing model, SHREWD's FU pool,
  the in-order latches
- ``ops``    — dense scan, deviation-set scans, the CUDA kernels, the
  trial runner ``TrialKernel``, and chunked replay (``window``,
  ``chunked.ChunkedCampaign``)
- ``parallel`` — the sharded campaign step over a device mesh
  (``torch.distributed`` across processes), its interval and until-CI
  engines, the stopping rule, the elastic lease board, the multi-process
  launcher, the shared kernel registry
- ``resilience``, ``integrity``, ``chaos`` — the degradation ladder, the
  checked dispatch (canaries, invariants, audit) and the deterministic
  fault-injection plan that exercises both
- ``campaign``, ``stats``, ``obs``, ``sim``, ``main`` — plans, the
  orchestrator, its stats tree, tracing, exit events and the CLI
  (``python -m shrewd_tpu_torch run|resume``)

Entry points run on the CUDA cards (a mesh over every visible card) unless
the caller passes ``device="cpu"`` (the CLI: ``--platform cpu``).
"""

__version__ = "0.1.0"
