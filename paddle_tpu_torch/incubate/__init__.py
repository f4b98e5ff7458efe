"""``paddle.incubate`` for the port (ported subset)."""
