from .ops import (RwkvScan, rwkv_scan, rwkv_scan_bwd,  # noqa: F401
                  rwkv_scan_bwd_plain, rwkv_scan_plain)
