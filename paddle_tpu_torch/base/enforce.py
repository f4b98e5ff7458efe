"""Structured errors (port of ``paddle_tpu/base/enforce.py``): the
reference's PADDLE_ENFORCE categories as exception classes, each message
prefixed with its category."""
from __future__ import annotations

__all__ = ["EnforceError", "InvalidArgumentError", "NotFoundError",
           "OutOfRangeError", "AlreadyExistsError", "PreconditionNotMetError",
           "UnimplementedError", "UnavailableError", "ExecutionTimeoutError",
           "enforce"]


class EnforceError(ValueError):
    category = "InvalidArgument"

    def __init__(self, message: str):
        super().__init__(f"({self.category}) {message}")


class InvalidArgumentError(EnforceError):
    category = "InvalidArgument"


class NotFoundError(EnforceError):
    category = "NotFound"


class OutOfRangeError(EnforceError):
    category = "OutOfRange"


class AlreadyExistsError(EnforceError):
    category = "AlreadyExists"


class PreconditionNotMetError(EnforceError):
    category = "PreconditionNotMet"


class UnimplementedError(EnforceError):
    category = "Unimplemented"


class UnavailableError(EnforceError):
    category = "Unavailable"


class ExecutionTimeoutError(EnforceError):
    category = "ExecutionTimeout"


def enforce(cond: bool, message: str,
            exc: type = InvalidArgumentError) -> None:
    if not cond:
        raise exc(message)
