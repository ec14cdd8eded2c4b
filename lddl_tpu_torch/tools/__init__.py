"""Operator tools over the port's telemetry: ``pipeline_status`` (fleet
health, rollups, windowed rates and alert rules) and ``trace_summary``
(per-stage span tables and the fleet's merged trace). Run each as
``python -m lddl_tpu_torch.tools.<name>``."""
