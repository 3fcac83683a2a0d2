"""Checks of the port: the static lint and the runtime sanitizer.

The static half is the port of the reference's AST lint engine
(:mod:`repro_torch.check.engine`) with the rules that have a torch meaning
(:mod:`repro_torch.check.rules`):

- ``host-sync`` — implicit device→host transfers in block dispatch
- ``rng-order`` / ``global-rng`` — scheduler sampler surfaces, and no draw
  from NumPy's or torch's global generator
- ``missing-alias-break`` — carries fed to in-place blocks own their storage
- ``kernel-gate`` — a kernel's plain version only through its wrapper
- ``jit-in-loop`` — no compile / graph capture / kernel load in a loop

The reference's other four ids are listed, with their reasons, in
``rules.NOT_PORTED``.  Run it as ``python -m repro_torch.check src tests
benchmarks``.

The runtime half (:mod:`.runtime`) refuses implicit device→host
transfers inside a run and counts the explicit fetches.
"""
from repro_torch.check.engine import (CheckConfig, Finding, Rule, check_paths,
                                      check_source)
from repro_torch.check.runtime import (SanitizerStats, fetch,
                                       host_conversion_guard,
                                       sanitize_enabled, sanitized)

__all__ = ["CheckConfig", "Finding", "Rule", "SanitizerStats", "check_paths",
           "check_source", "fetch", "host_conversion_guard",
           "sanitize_enabled", "sanitized"]
