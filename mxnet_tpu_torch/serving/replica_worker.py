"""``python -m mxnet_tpu_torch.serving.replica_worker``: the replica
worker's entry point, apart from `supervisor` so runpy never re-executes a
module the serving package already imported."""
from __future__ import annotations

from .supervisor import worker_main

if __name__ == "__main__":
    import sys

    sys.exit(worker_main())
