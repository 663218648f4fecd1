from .ops import ssd_chunked
from .ref import ssd_scan_ref

__all__ = ["ssd_chunked", "ssd_scan_ref"]
