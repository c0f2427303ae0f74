"""Several GPUs through torch.distributed: the (data, model) mesh, process
start-up and placement, data and tensor parallelism, the sharded serving
database."""
