"""Checkpoints (port of ``repro/checkpoint``): the manager; the elastic
re-placement onto a mesh comes with the port's torch.distributed slice."""
