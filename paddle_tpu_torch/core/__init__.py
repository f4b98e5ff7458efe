"""The port's ``Tensor``, its method surface and ``paddle.grad``."""
