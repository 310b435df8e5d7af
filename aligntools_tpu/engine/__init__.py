"""Device engines: JAX row-scan (scan.py), column-chunked (chunked.py),
banded (banded.py), device and host traceback (device_tb.py,
traceback.py)."""

from aligntools_tpu.engine.scan import scan_align

__all__ = ["scan_align"]
