"""``paddle.amp`` for the port: O2 bfloat16 ``auto_cast`` and ``decorate``."""
from .auto_cast import AmpState, GradScaler, auto_cast, decorate

__all__ = ["AmpState", "GradScaler", "auto_cast", "decorate"]
