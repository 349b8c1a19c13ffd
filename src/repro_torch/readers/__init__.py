"""repro_torch.readers — trace readers of the port (mirrors
:mod:`repro.readers`), each into the uniform data model:

=================  ==========================================================
``csvreader``      the paper's Fig. 1 CSV
``jsonl``          Pipit-native JSON-lines (one event per line)
``chrome``         Chrome Trace Format (Nsight Systems / PyTorch profiler
                   exports use this envelope)
``otf2j``          schema-faithful OTF2 rendering (definitions + per-location
                   event streams), one file or a directory archive
``pack``           pipitpack, the columnar binary store
``hlo``            compiled XLA programs (post-SPMD HLO text) → modeled
                   per-device timelines
``parallel``       the sharded reader over per-location shards (paper §VI)
=================  ==========================================================

Importing the package registers every format with ``Trace.open``.
"""

from .chrome import read_chrome, write_chrome
from .csvreader import read_csv, write_csv
from .hlo import read_hlo, read_hlo_file
from .jsonl import read_jsonl, write_jsonl
from .otf2j import read_otf2_json, write_otf2_json
from .pack import PackWriter, read_pack, write_pack
from .parallel import (open_many, read_parallel, select_shards,
                       split_jsonl_by_process)

__all__ = ["read_csv", "write_csv", "read_jsonl", "write_jsonl",
           "read_chrome", "write_chrome", "read_otf2_json",
           "write_otf2_json", "read_hlo", "read_hlo_file", "read_pack",
           "write_pack", "PackWriter", "read_parallel", "open_many",
           "select_shards", "split_jsonl_by_process"]
