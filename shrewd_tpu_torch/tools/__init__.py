"""The port's command-line drivers (``python -m shrewd_tpu_torch.tools.…``):
``fleet`` (the multi-tenant fleet) and ``scenario`` (the scenario matrix
with its closed Pareto loop)."""
