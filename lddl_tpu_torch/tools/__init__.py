"""Operator tools over the port: ``pipeline_status`` (fleet health,
rollups, windowed rates, alert rules and the analyzer's verdict),
``trace_summary`` (per-stage span tables and the fleet's merged trace)
and ``lddl_check`` (the static analyzer's CLI; ``ci_check.sh`` wraps
it). Run each as ``python -m lddl_tpu_torch.tools.<name>``."""
