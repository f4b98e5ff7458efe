"""``paddle.incubate.nn`` for the port (ported subset)."""
