"""repro_torch.readers — trace readers of the port (mirrors
:mod:`repro.readers`): the Pipit-native JSON-lines format and the
columnar ``pipitpack`` store, plus the sharded parallel reader.
Importing the package registers both formats with ``Trace.open``."""

from .jsonl import read_jsonl, write_jsonl
from .pack import read_pack, write_pack
from .parallel import open_many, read_parallel, split_jsonl_by_process

__all__ = ["read_jsonl", "write_jsonl", "read_pack", "write_pack",
           "read_parallel", "open_many", "split_jsonl_by_process"]
