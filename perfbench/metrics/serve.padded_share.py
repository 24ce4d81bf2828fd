"""Padded rows' share of the rows executed over the window."""
from perfbench.harness.readers import serve_padded_share as read  # noqa: F401
