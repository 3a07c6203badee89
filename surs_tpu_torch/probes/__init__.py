"""Measurement probes of the port, each an entry point of its own
(``python -m surs_tpu_torch.probes.<name>``)."""
