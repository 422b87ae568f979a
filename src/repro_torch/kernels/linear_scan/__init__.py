from .ops import (LinearScan, linear_scan, linear_scan_bwd,  # noqa: F401
                  linear_scan_bwd_plain, linear_scan_plain)
