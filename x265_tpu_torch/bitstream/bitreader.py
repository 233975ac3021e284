"""Re-export: BitReader lives beside BitWriter."""
from .bitwriter import BitReader  # noqa: F401
