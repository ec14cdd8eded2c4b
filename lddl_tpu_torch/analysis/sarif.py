"""SARIF 2.1.0 export so findings render inline in code-review tooling.

Only new (non-baselined, non-suppressed) findings become ``results`` —
the SARIF artifact answers "what does this change introduce", the same
contract as the exit code. Baselined findings are emitted with
``baselineState: "unchanged"`` so reviewers can still see the
grandfathered debt without it gating anything.
"""

SARIF_VERSION = "2.1.0"
_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
           "master/Schemata/sarif-schema-2.1.0.json")


def _result(finding, baseline_state=None):
    # Plain repo-relative URIs: consumers (GitHub code scanning, IDE
    # SARIF viewers) resolve them against the checkout they run in.
    r = {
        "ruleId": finding.rule,
        "level": "error" if baseline_state is None else "note",
        "message": {"text": finding.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": finding.path},
                "region": {"startLine": finding.line,
                           "startColumn": max(1, finding.col + 1)},
            },
        }],
    }
    if baseline_state is not None:
        r["baselineState"] = baseline_state
    return r


def to_sarif(report, rules):
    """SARIF log dict for a :class:`core.Report` under ``rules``."""
    return {
        "$schema": _SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "lddl-check",
                    "rules": [
                        {"id": r.id,
                         "shortDescription": {"text": r.doc}}
                        for r in sorted(rules, key=lambda r: r.id)
                    ],
                },
            },
            "results": (
                [_result(f) for f in report.new]
                + [_result(f, "unchanged") for f in report.baselined]
            ),
            "invocations": [{
                "executionSuccessful": report.ok,
            }],
        }],
    }
