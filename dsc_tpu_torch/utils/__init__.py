"""Debug helpers of dsc_tpu_torch (dsc_tpu/utils)."""

from .debug import enable_debug_logging, log_debug, nan_guard

__all__ = ['enable_debug_logging', 'log_debug', 'nan_guard']
