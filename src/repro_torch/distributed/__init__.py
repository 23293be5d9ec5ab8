"""Distribution (port of ``repro/distributed``) over ``torch.distributed``:
the sharding rules and the ambient mesh (`sharding`), the SPMD collectives
(`collectives`: sequence-parallel decode attention, the quantized
all-reduce), the GPipe pipeline (`pipeline`) and the straggler monitor
that the train loop uses (`straggler`)."""
