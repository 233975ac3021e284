from .y4m import Y4MReader, Y4MWriter  # noqa: F401
from .yuv import YUVReader  # noqa: F401
