"""Launchers: `python -m repro_torch.launch.serve`."""
