from .encoder import IntraEncoder  # noqa: F401
