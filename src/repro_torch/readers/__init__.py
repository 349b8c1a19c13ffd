"""repro_torch.readers — trace readers of the port (mirrors
:mod:`repro.readers`).  This slice carries the Pipit-native JSON-lines
format; importing the package registers it with ``Trace.open``."""

from .jsonl import read_jsonl, write_jsonl

__all__ = ["read_jsonl", "write_jsonl"]
