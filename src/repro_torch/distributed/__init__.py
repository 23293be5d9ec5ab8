"""Distribution (port of ``repro/distributed``): so far only the straggler
monitor that the train loop uses; sharding, collectives and the pipeline
come with the port's ``torch.distributed`` slice."""
