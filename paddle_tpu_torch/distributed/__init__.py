"""Distributed tier of the port. So far only the sharded checkpoint
reader and writer, single device (``checkpoint.sharded``)."""
