"""Runtime checks of the port: the sanitizer (:mod:`.runtime`)."""
from repro_torch.check.runtime import (SanitizerStats, fetch,
                                       host_conversion_guard,
                                       sanitize_enabled, sanitized)

__all__ = ["SanitizerStats", "fetch", "host_conversion_guard",
           "sanitize_enabled", "sanitized"]
