"""Exception hierarchy (counterpart of cusp_autotuned_tpu/utils/exceptions.py,
parity target cusp/exception.h)."""


class CuspException(Exception):
    """Base class for all framework exceptions."""


class FormatException(CuspException):
    pass


class FormatConversionException(FormatException):
    """Raised when a conversion is rejected (the DIA fill-ratio guard,
    cusp/system/detail/generic/conversions/coo_to_other.h:155-161)."""


class NotImplementedException(CuspException):
    pass


class InvalidInputException(CuspException):
    pass


class IOException(CuspException):
    """Raised by the readers on a malformed file (cusp::io_exception)."""


class RuntimeException(CuspException):
    pass
