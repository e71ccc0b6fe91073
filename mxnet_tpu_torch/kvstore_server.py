"""The parameter server's roles (counterpart of
`mxnet_tpu/kvstore_server.py`; reference: python/mxnet/kvstore_server.py,
the loop a ``DMLC_ROLE=server`` process runs, receiving pushes and pulls
and applying the pickled optimizer).

The port has no parameter server: the distributed kvstore is a sum over
the processes of `torch.distributed` (`kvstore._DistKVStore`), and every
process is a worker. A reference launch script that starts servers and a
scheduler beside its workers still runs: those processes exit 0 when the
package is imported (`_maybe_exit_non_worker`), so the workers' group
keeps its size.
"""
from __future__ import annotations

import logging
import os
import pickle

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]


class KVStoreServer:
    """reference: kvstore_server.py KVStoreServer."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def _controller(self):
        """The reference's command handler: command 0 installs a pickled
        optimizer (in the worker's own store here)."""

        def server_controller(cmd_id, cmd_body, _=None):
            if cmd_id == 0:
                self.kvstore.set_optimizer(pickle.loads(cmd_body))
            else:
                logging.warning("kvstore server: unknown command (%s)",
                                cmd_id)

        return server_controller

    def run(self):
        logging.info("kvstore server role: no parameter-server loop to run "
                     "(the dist kvstore sums over torch.distributed, every "
                     "process a worker); exiting")


def _init_kvstore_server_module():
    """Whether this process was launched as a server or the scheduler
    (reference: kvstore_server.py:79, which then blocks in the server
    loop)."""
    role = os.environ.get("DMLC_ROLE", "worker")
    if role == "server":
        # no store is made: it would join the workers' group
        KVStoreServer(None).run()
        return True
    if role == "scheduler":
        logging.info("kvstore scheduler role: rank 0's worker hosts the "
                     "rendezvous; exiting")
        return True
    return False


def _maybe_exit_non_worker():
    """Exit 0 in a server or scheduler process (the package's import calls
    it, as the reference's import runs the server loop)."""
    if _init_kvstore_server_module():
        raise SystemExit(0)
