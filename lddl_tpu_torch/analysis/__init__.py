"""Static analysis for the port's determinism & SPMD-safety invariants.

Counterpart of ``lddl_tpu/analysis/``, pointed at ``lddl_tpu_torch/``:
the same rules, with every path scope naming the port's own module.
Public API::

    from lddl_tpu_torch import analysis
    report = analysis.run_check(["lddl_tpu_torch"])
    assert report.ok, [f.format() for f in report.new]

CLI: ``python -m lddl_tpu_torch.tools.lddl_check [paths...] [--json]`` —
exits nonzero on any finding not in the checked-in baseline
(``lddl_tpu_torch/tools/lddl_check_baseline.json``) and not suppressed
inline with ``# lddl: disable=<rule>``. The analyzer parses source text
only: it imports neither torch nor any module it analyzes.
"""

from .core import (  # noqa: F401
    ANALYSIS_VERSION,
    DEFAULT_BASELINE,
    DEFAULT_CACHE,
    DEFAULT_SARIF,
    Finding,
    REPO_ROOT,
    Report,
    Rule,
    all_rules,
    analyze_source,
    baseline_entry,
    get_rules,
    iter_python_files,
    load_baseline,
    register,
    run_check,
    split_baselined,
)
from . import rules  # noqa: F401  (imports register the syntactic rules)
from . import flow_rules  # noqa: F401  (registers the flow rules)
from . import concurrency  # noqa: F401  (registers the concurrency rules)
from . import dataflow, project  # noqa: F401  (taint engine + model)
from .sarif import to_sarif  # noqa: F401

RULE_IDS = tuple(r.id for r in all_rules())
