"""dvbs_tpu — a DVB-S / DVB-S2 receive framework for an accelerator.

A from-scratch reimplementation of the capabilities of
cropinghigh/sdrpp-dvbs-demodulator, built for a GPU:
frame/block-batched JAX + Pallas compute, feed-forward synchronization
anchored on the DVB-S2 physical-layer structure, and shard_map
channel/device parallelism — instead of the reference's per-sample C++
feedback loops.
"""

__version__ = "0.1.0"
