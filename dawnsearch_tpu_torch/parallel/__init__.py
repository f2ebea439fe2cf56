"""Device-parallel execution: the mesh, the sharded index, the crew.

Port of dawnsearch_tpu/parallel. The reference replaces its peer fan-out
(one UDP datagram per peer, a host-side merge) with shards on the devices
of a JAX mesh and XLA collectives; here each shard is a set of tensors on
one torch device, the host launches every shard's search before it waits
on any, and the merge is a stable top-k on the mesh's first device
(plus an all_gather over torch.distributed when the shards span
processes, parallel/multihost.py).
"""
