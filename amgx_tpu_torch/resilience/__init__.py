"""Solve statuses (the port of amgx_tpu/resilience/status.py)."""
