"""The device mesh of the port: one process per device over
``torch.distributed`` (:mod:`.mesh`) and the collectives every mesh engine
calls (:mod:`.collectives`)."""
