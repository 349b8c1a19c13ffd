"""Command-line launchers of the port (mirrors :mod:`repro.launch`)."""
