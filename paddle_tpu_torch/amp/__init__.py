"""``paddle.amp`` for the port: ``auto_cast`` (O1, O2) and ``decorate`` in
bfloat16 or float16, and ``GradScaler``."""
from . import amp_lists
from .auto_cast import (AmpState, amp_guard, auto_cast, decorate,
                        get_amp_dtype, is_auto_cast_enabled)
from .grad_scaler import (GradScaler, check_finite_and_unscale,
                          update_loss_scaling)

AmpScaler = GradScaler

__all__ = ["AmpScaler", "AmpState", "GradScaler", "amp_guard", "amp_lists",
           "auto_cast", "check_finite_and_unscale", "decorate",
           "get_amp_dtype", "is_auto_cast_enabled", "update_loss_scaling"]
