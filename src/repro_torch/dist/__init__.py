"""Distribution of the port: step builders (one device or a mesh of
ranks), sharding rules, gradient compression and the multicast
collectives on ``torch.distributed``."""
