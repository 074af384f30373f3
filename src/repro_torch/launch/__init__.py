"""Drivers: ``python -m repro_torch.launch.serve``."""
