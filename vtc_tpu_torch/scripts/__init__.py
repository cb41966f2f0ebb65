"""The port's scripts, each run as ``python -m vtc_tpu_torch.scripts.<name>``."""
