"""Ops of the port (counterpart of `mxnet_tpu.ops`: what the generation,
ResNet and BERT paths use)."""
