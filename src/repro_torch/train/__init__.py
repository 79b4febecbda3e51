"""Training on the port: the optimizers, the train step and host loop,
gradient compression and checkpoints (counterpart of ``repro/train``)."""
