"""Launchers on the port (counterpart of ``repro/launch``): the training
launcher, ``python -m repro_torch.launch.train``."""
