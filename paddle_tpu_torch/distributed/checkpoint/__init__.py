"""Checkpoints of the port: the reference's sharded format
(``checkpoint.sharded``)."""
