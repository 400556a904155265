"""Diagnostic programs of the port (run with ``python3 -m``)."""
