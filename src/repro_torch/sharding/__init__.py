"""Sharding on the port (counterpart of ``repro/sharding``): the
logical-axis rules (:mod:`repro_torch.sharding.rules`) and the activation
context (:mod:`repro_torch.sharding.ctx`), over
:class:`torch.distributed.device_mesh.DeviceMesh` and DTensor
placements."""
