from .ops import rwkv_scan, rwkv_scan_plain  # noqa: F401
