"""mxnet_tpu_torch.data — the asynchronous input pipeline (counterpart of
`mxnet_tpu.data`).

The shared core (``PrefetchBuffer`` / ``DecodePool``) behind every
prefetching surface of the port, the device prefetcher (pinned staging and
copies on a stream of its own), and sharded RecordIO streaming with a
checkpointable cursor."""
from .core import DecodePool, PrefetchBuffer
from .device_prefetch import DevicePrefetcher, place_batch
from .sharded_stream import ShardedRecordStream, StreamDataIter

__all__ = ["PrefetchBuffer", "DecodePool", "DevicePrefetcher",
           "place_batch", "ShardedRecordStream", "StreamDataIter"]
