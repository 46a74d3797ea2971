"""Result codes and exceptions for the public codec API.

The reference API is result-typed: every entry point validates its inputs
before any side effect and returns an ``AADApiResult`` (reference:
src/aad.h:25-33). This package keeps the same taxonomy, under the same
names as ``aad_tpu.codec.result``: an ``ApiResult`` enum for code that wants
codes, and an ``AadError`` exception carrying the enum for code that wants
exceptions.
"""

from __future__ import annotations

import enum


class ApiResult(enum.IntEnum):
    """Mirrors the reference result taxonomy (reference: src/aad.h:25-33)."""

    OK = 0
    INVALID_ARGUMENT = 1
    INVALID_FORMAT = 2
    INSUFFICIENT_BUFFER = 3
    INSUFFICIENT_DATA = 4
    PARAMETER_NOT_SET = 5
    NG = 6


class AadError(Exception):
    """Raised by the exception-style API; wraps an :class:`ApiResult`."""

    def __init__(self, result: ApiResult, message: str = ""):
        self.result = ApiResult(result)
        super().__init__(message or self.result.name)


class InvalidFormatError(AadError):
    def __init__(self, message: str = ""):
        super().__init__(ApiResult.INVALID_FORMAT, message)


class InvalidArgumentError(AadError):
    def __init__(self, message: str = ""):
        super().__init__(ApiResult.INVALID_ARGUMENT, message)


class InsufficientDataError(AadError):
    def __init__(self, message: str = ""):
        super().__init__(ApiResult.INSUFFICIENT_DATA, message)


class InsufficientBufferError(AadError):
    def __init__(self, message: str = ""):
        super().__init__(ApiResult.INSUFFICIENT_BUFFER, message)
