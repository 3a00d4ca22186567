"""Command-line entry points of the port (``python -m
repro_torch.launch.serve``, ``python -m repro_torch.launch.train``)."""
