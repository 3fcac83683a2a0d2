"""CLI: ``python -m repro_torch.check [paths...]``.

The reference's ``python -m repro.check`` with the port's rules: the same
flags, default paths and reports.  Exit status 0 when clean, 1 when any
finding survives pragma filtering, 2 on usage errors.  ``--format json``
emits a machine-readable document.  It reads source only, so it takes no
``--device``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Sequence

from repro_torch.check.engine import CheckConfig, check_paths
from repro_torch.check.reporters import REPORTERS, report


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.check",
        description="repro_torch invariant lints (host-sync/rng-order/"
        "missing-alias-break/kernel-gate/jit-in-loop)",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["src", "tests", "benchmarks"],
        help="files or directories to lint (default: src tests benchmarks)",
    )
    parser.add_argument(
        "--format",
        choices=sorted(REPORTERS),
        default="text",
        help="report format (default: text)",
    )
    parser.add_argument(
        "--rules",
        default="",
        help="comma-separated rule ids to enable (default: all)",
    )
    parser.add_argument(
        "--include-fixtures",
        action="store_true",
        help="also lint tests/fixtures/ (excluded by default: the check "
        "fixtures are seeded violations)",
    )
    args = parser.parse_args(argv)

    config = CheckConfig(
        enabled_rules=tuple(r for r in args.rules.split(",") if r),
        exclude=() if args.include_fixtures else CheckConfig().exclude,
    )
    findings = check_paths(args.paths, config)
    report(findings, args.format, sys.stdout)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
