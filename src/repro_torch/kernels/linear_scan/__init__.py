from .ops import linear_scan, linear_scan_plain  # noqa: F401
