"""Checkpoints (port of ``repro/checkpoint``): the manager, and the
elastic re-placement of a checkpoint onto a mesh of another size."""
