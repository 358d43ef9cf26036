"""The parallel plane: the device mesh over ``torch.distributed`` ranks,
tensor-parallel sharding of the weights and the KV pool, and the
leader/follower protocol that lets one rank drive the others."""
