"""Debug helpers of dsc_tpu_torch (dsc_tpu/utils)."""
