"""Seconds of set-up in the program's cold compile and kernel.load spans
(DenseNet offline cell)."""
from perfbench.harness.program_trace import setup_program_s as read  # noqa: F401,E501
