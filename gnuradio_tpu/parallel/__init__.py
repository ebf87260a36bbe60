"""Parallelism layer: time-axis sharding (sequence parallelism) with halo
exchange, channel-axis sharding, and mesh helpers — the compiled
replacement for the reference's scheduler pipelining and gr-zeromq
distribution (SURVEY.md §2.4)."""
from .halo import (left_halo, shard_offset, first_order_boundary,
                   replicate_from_last)
from .mesh import make_mesh, time_sharding
