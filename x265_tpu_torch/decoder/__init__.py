from .decoder import decode_annexb, DecodedFrame  # noqa: F401
