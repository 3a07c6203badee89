"""The port's command-line entry points (``python -m
surs_tpu_torch.apps.<name>``)."""
