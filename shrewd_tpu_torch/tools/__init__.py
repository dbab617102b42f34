"""The port's command-line drivers (``python -m shrewd_tpu_torch.tools.…``):
``fleet`` (the multi-tenant fleet), ``scenario`` (the scenario matrix
with its closed Pareto loop), ``federation`` (the gateway over a
federation of fleet pods), ``graftlint`` and ``obs`` (static analysis and
the flight recorder), ``northstar`` and ``simpoint_avf`` (the north-star
sweep), the validation studies ``timing_validate``,
``timing_effect``, ``protect_validate``, ``strat_effect``,
``diff_artifacts`` and ``threeway_diff``, and the window-scale tools
``bigwindow`` (capture, lift and rate windows of a real binary, dense and
chunked) and ``window_scale`` (their collation)."""
