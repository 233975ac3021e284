from .bitwriter import BitWriter  # noqa: F401
from .nal import NalUnitType, wrap_nal, annexb_stream  # noqa: F401
