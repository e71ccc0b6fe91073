"""Per-thread RNG state.

Counterpart of `mxnet_tpu/random.py`. The JAX package splits one threefry
key chain per thread (`next_key` hands each random op a subkey); here each
thread keeps one seeded `torch.Generator` per device (`generator`, the
role of `next_key`), and every random op draws from the generator of its
device. Threefry and Philox give different numbers from the same seed, so
only distributions (and greedy decoding) are comparable across the two
packages; one seed gives the same bits twice on one device.

``mx.random.uniform``, ``normal`` and the other draws of the reference's
``mx.random`` are the ``mx.nd.random`` functions, bound here by the
package's ``__init__`` (reference: python/mxnet/random.py).
"""
from __future__ import annotations

import threading

import torch

from .context import Context, resolve_device

__all__ = ["seed", "current_seed", "generator", "get_state", "set_state",
           "worker_seed"]

_state = threading.local()
_DEFAULT_SEED = 0


def _get():
    if not hasattr(_state, "seed_val"):
        _state.seed_val = _DEFAULT_SEED
        _state.generators = {}
    return _state


def seed(seed_state, ctx="all"):
    """Seed this thread's generators (reference: python/mxnet/random.py:38
    mx.random.seed): every device's with ``ctx="all"``, else only the
    generator of device ``ctx``."""
    st = _get()
    if ctx == "all":
        st.seed_val = int(seed_state)
        st.generators = {}
        return
    dev = resolve_device(ctx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed_state))
    st.generators[dev] = gen


def current_seed():
    return _get().seed_val


def generator(device):
    """This thread's generator for ``device``, seeded from `current_seed`
    at first use."""
    st = _get()
    dev = device.torch_device() if isinstance(device, Context) \
        else torch.device(device)
    gen = st.generators.get(dev)
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(st.seed_val)
        st.generators[dev] = gen
    return gen


def get_state():
    """This thread's seed and each made generator's state as plain host data
    (for checkpoints: a resumed run continues the same streams)."""
    st = _get()
    return {"seed": st.seed_val,
            "generators": {str(dev): gen.get_state().tolist()
                           for dev, gen in st.generators.items()}}


def set_state(state):
    """Restore a `get_state` snapshot."""
    st = _get()
    st.seed_val = int(state["seed"])
    st.generators = {}
    for dev, bits in state.get("generators", {}).items():
        gen = generator(dev)
        gen.set_state(torch.tensor(bits, dtype=torch.uint8))


def worker_seed(base_seed, pid, index):
    """Seed of a decode worker thread: the constructing thread's seed folded
    with the process id and a per-process scheduler index, so co-located
    schedulers and restarted workers decorrelate (the formula of
    `mxnet_tpu/serving/generate.py` GenerateScheduler)."""
    return (int(base_seed) * 1000003 + int(pid) * 10007
            + int(index)) % (1 << 31)
