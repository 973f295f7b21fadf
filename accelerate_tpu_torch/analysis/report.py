"""Finding reporters: the ``path:line: TPUxxxx message`` text format that
editors and CI annotators parse, SARIF 2.1.0 for CI annotation, and the
exit-code contract (JSON is each record's ``as_dict``).

The port's copy of :mod:`accelerate_tpu.analysis.report` (the surfaces
the kernel analyzer and the ``fleet`` command use), formats unchanged:
:func:`render_sarif_run` is the shared reporter of CLI surfaces whose
results are not lint findings (``fleet price-handoff --format sarif``).
"""

from __future__ import annotations

import json

from .rules import ERROR, RULES, Finding

_NO_LOCATION = "<launch>"


def format_finding(f: Finding) -> str:
    loc = f.path or _NO_LOCATION
    if f.line is not None:
        loc = f"{loc}:{f.line}"
    return f"{loc}: {f.rule} {f.message}"


def render_text(findings: list, *, summary: bool = True) -> str:
    lines = [format_finding(f) for f in findings]
    if summary:
        n_err = sum(1 for f in findings if f.is_error)
        lines.append(f"{len(findings)} finding(s): {n_err} error(s), {len(findings) - n_err} warning(s)")
    return "\n".join(lines)


#: finding severity -> SARIF result level (everything else is "warning")
_SARIF_LEVELS = {ERROR: "error"}

SARIF_SCHEMA = "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/Schemata/sarif-schema-2.1.0.json"


def render_sarif(findings: list) -> str:
    """SARIF 2.1.0: one run whose tool's rule catalogue holds the rules
    used, one result per finding (a finding without a location anchors to
    ``<launch>`` line 1: SARIF requires a location)."""
    used = sorted({f.rule for f in findings})
    rule_index = {rid: i for i, rid in enumerate(used)}
    rules = [
        {
            "id": rid,
            "name": RULES[rid].name,
            "shortDescription": {"text": RULES[rid].summary},
            "defaultConfiguration": {"level": _SARIF_LEVELS.get(RULES[rid].severity, "warning")},
            "properties": {"tier": RULES[rid].tier},
        }
        for rid in used
    ]
    results = [
        {
            "ruleId": f.rule,
            "ruleIndex": rule_index[f.rule],
            "level": _SARIF_LEVELS.get(f.severity, "warning"),
            "message": {"text": f.message},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path or _NO_LOCATION},
                        "region": {"startLine": f.line or 1},
                    }
                }
            ],
        }
        for f in findings
    ]
    run = {
        "tool": {
            "driver": {
                "name": "accelerate-tpu-lint",
                "informationUri": "https://github.com/",
                "version": "0",
                "rules": rules,
            }
        },
        "results": results,
    }
    return json.dumps({"$schema": SARIF_SCHEMA, "version": "2.1.0", "runs": [run]}, indent=2)


def render_sarif_run(tool_name: str, entries: list, *, tool_version: str = "0") -> str:
    """One SARIF 2.1.0 document from ad-hoc entries: each
    ``{"rule_id", "name", "summary", "level", "message"}`` plus optional
    ``"uri"`` / ``"line"``. Rule descriptors are tool-local (SARIF scopes
    rules to their driver)."""
    used: dict = {}
    for e in entries:
        used.setdefault(
            e["rule_id"],
            {
                "id": e["rule_id"],
                "name": e.get("name", e["rule_id"]),
                "shortDescription": {"text": e.get("summary", e.get("name", e["rule_id"]))},
                "defaultConfiguration": {"level": e.get("level", "note")},
            },
        )
    rule_index = {rid: i for i, rid in enumerate(used)}
    results = [
        {
            "ruleId": e["rule_id"],
            "ruleIndex": rule_index[e["rule_id"]],
            "level": e.get("level", "note"),
            "message": {"text": e["message"]},
            "locations": [
                {
                    "physicalLocation": {
                        "artifactLocation": {"uri": e.get("uri") or f"<{tool_name}>"},
                        "region": {"startLine": e.get("line") or 1},
                    }
                }
            ],
        }
        for e in entries
    ]
    run = {
        "tool": {
            "driver": {
                "name": tool_name,
                "informationUri": "https://github.com/",
                "version": tool_version,
                "rules": list(used.values()),
            }
        },
        "results": results,
    }
    return json.dumps({"$schema": SARIF_SCHEMA, "version": "2.1.0", "runs": [run]}, indent=2)


def exit_code(findings: list, *, strict: bool = False) -> int:
    """CI contract: nonzero on any error-severity finding (on any finding
    at all under ``strict``)."""
    if strict:
        return 1 if findings else 0
    return 1 if any(f.severity == ERROR for f in findings) else 0
