"""Finding reporters: human text and machine JSON (the reference's, byte for
byte: the same findings print the same report)."""
from __future__ import annotations

import json
from collections import Counter
from typing import IO, List, Sequence

from repro_torch.check.engine import Finding


def report_text(findings: Sequence[Finding], stream: IO[str]) -> None:
    """One `path:line:col: [rule] message` line per finding + a rule tally."""
    for f in findings:
        stream.write(f.format() + "\n")
    if findings:
        counts = Counter(f.rule for f in findings)
        tally = ", ".join(f"{rule}: {n}" for rule, n in sorted(counts.items()))
        stream.write(f"\n{len(findings)} finding(s)  ({tally})\n")
    else:
        stream.write("clean: no findings\n")


def report_json(findings: Sequence[Finding], stream: IO[str]) -> None:
    """A single JSON document: counts by rule + the full finding list."""
    counts = Counter(f.rule for f in findings)
    doc = {
        "findings": [f.to_json() for f in findings],
        "counts": dict(sorted(counts.items())),
        "total": len(findings),
    }
    json.dump(doc, stream, indent=2)
    stream.write("\n")


REPORTERS = {"text": report_text, "json": report_json}


def report(
    findings: List[Finding], fmt: str, stream: IO[str]
) -> None:
    REPORTERS[fmt](findings, stream)
