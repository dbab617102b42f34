"""The port's command-line drivers (``python -m shrewd_tpu_torch.tools.…``):
``fleet`` (the multi-tenant fleet), ``scenario`` (the scenario matrix
with its closed Pareto loop) and ``federation`` (the gateway over a
federation of fleet pods)."""
